"""Parallelism of the port over ranks (JAX counterpart: ``parallel/``).

One process per rank under ``torch.distributed`` (NCCL on the card, gloo
on the CPU): :mod:`.dist` joins the processes, :mod:`.mesh` lays the ranks
out on named axes, :mod:`.sharding` maps parameter names to blocks,
:mod:`.collectives` runs the verbs over an axis's process group,
:mod:`.ring` is ring attention over ``sp`` on the flash kernels, and
:mod:`.trainer`'s ``ShardedTrainer`` trains over a mesh. Pipeline
parallelism, mixture-of-experts and the elastic control plane come with a
later slice.
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
