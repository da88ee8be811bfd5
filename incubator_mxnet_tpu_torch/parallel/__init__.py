"""Parallelism of the port over ranks (JAX counterpart: ``parallel/``).

One process per rank under ``torch.distributed`` (NCCL on the card, gloo
on the CPU): :mod:`.dist` joins the processes, :mod:`.mesh` lays the ranks
out on named axes, :mod:`.sharding` maps parameter names to blocks,
:mod:`.collectives` runs the verbs over an axis's process group,
:mod:`.ring` is ring attention over ``sp`` on the flash kernels,
:mod:`.pipeline` the GPipe schedule over ``pp``, :mod:`.moe` the switch
mixture-of-experts over ``ep``, :mod:`.elastic` the lease-based membership
of the ranks, and :mod:`.trainer`'s ``ShardedTrainer`` trains over a mesh.
"""
from .mesh import (  # noqa: F401
    MeshConfig, make_mesh, default_mesh, set_default_mesh, local_mesh,
    AXIS_DP, AXIS_TP, AXIS_PP, AXIS_SP, AXIS_EP,
)
from .sharding import (  # noqa: F401
    ShardingRules, named_sharding, shard_array, replicate, data_sharding,
)
from . import collectives  # noqa: F401
from .collectives import (  # noqa: F401
    all_reduce, all_gather, reduce_scatter, broadcast, ppermute, all_to_all,
)
from .dist import (  # noqa: F401
    finalize, initialize, is_primary, process_count, process_index,
    process_namespace, world,
)
from .trainer import ShardedTrainer  # noqa: F401
from .ring import ring_attention, ring_attention_sharded  # noqa: F401
from . import elastic  # noqa: F401
from .elastic import HostLossError  # noqa: F401
from .pipeline import pipeline_apply, pipeline_sharded  # noqa: F401
from .moe import moe_dispatch, MoEFFN  # noqa: F401
