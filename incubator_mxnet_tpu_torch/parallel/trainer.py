"""Training step over a ``torch.nn.Module``: on one device fused into one
CUDA graph, on a mesh of ranks sharded by rule.

Counterpart: the JAX package's ``parallel/trainer.py`` (``ShardedTrainer``,
``:73-515``), the subset one device runs: forward on the data arguments,
``loss_fn`` on the outputs and labels, mean, backward, the global gradient
norm in fp32 (``:390-395``), the finite verdict (``:492-497``) and the
optimizer update, on an fp32 master copy where the weight is
float16/bfloat16 and ``multi_precision`` is set (``:471-481``); the learning
rate is the optimizer's before the step and its schedule position is the
step count less one (``:425-448``, ``:611-633``). The kvstore fallback
and numerics are not ported.

Autotune (JAX ``:596-605``): with ``MXTPU_AUTOTUNE_DIR`` set, the first
step consults the cache under ``autotune_key`` (default: the block's class
name, lower-cased) and every step, fused or eager, runs under
``autotune.applied`` of the entry (``autotune_entry``): the flash kernels
read their tiles at each launch, so the fused step captures the banked
tiles and an eager step launches with them too. A banked tile the kernels
do not take raises at that consult, before any capture.

Profiler (JAX ``:917``): each step publishes a ``step`` frame to
``mx.profiler`` with its ``step.place``, ``step.dispatch`` and, when the
step waits for the card, ``step.device_wait`` segments. A guarded step
waits for its guard's read; while ``mx.profiler`` runs, every step waits
for the card at its end, so its frame spans its device work.

Every parameter of the module goes through the optimizer, as in the JAX
trainer (its ``_params`` is the whole ``collect_params()``, ``:216-218``):
an aux parameter (BatchNorm's running statistics, ``requires_grad`` off)
takes a zero gradient, so weight decay and momentum move it when ``wd >
0`` and leave it alone when ``wd == 0``. Its running update happens in the
forward, in place, inside the fused step's graph too; the optimizer's
update follows it in the same step.

Two paths, as in the JAX package (``fused=``, ``:127-135``):

- **fused** (the default on the card; ``MXTPU_FUSED_STEP=0`` or
  ``fused=False`` opts out): the whole step is one function over static
  buffers (:class:`_FusedStep`): the batch copied into buffers of its
  signature (shapes and dtypes), ``lr`` and ``t`` device scalars written
  before each step, then forward under ``train_mode``, the mean loss,
  ``torch.autograd.grad``, the norm from one ``torch._foreach_norm``, the
  finite verdict and ``Optimizer.update_multi`` over every parameter, in
  place, its bias corrections and schedule computed on the device. The
  first step of a signature runs it eagerly on the capture stream (a real
  step, the counterpart of JAX's first trace), the second captures it into
  a CUDA graph and replays it, and every later step only replays it: one
  update per ``step()``. A new signature captures a new graph
  (:attr:`captures` counts them as JAX counts compiles); a capture error
  raises. After a step each parameter's ``.grad`` is the graph's gradient
  buffer, holding that step's gradient.
- **eager** (the CPU, or ``fused=False``): the same step in PyTorch's own
  way, ``loss.backward()`` and the per-parameter ``Optimizer.step``, the
  plain path the fused one is held against. Its ``t`` is a device scalar
  too, so both paths compute the same bias corrections: on the card, under
  ``torch.use_deterministic_algorithms``, they give the same bits.

``fused=None`` on a CPU device runs eagerly; ``fused=True`` there raises.
The CPU tests run the fused function without capture
(``_fused_step(..., capture=False)``). The port's parameters are the
module's own, updated in place, so :meth:`ShardedTrainer.sync_to_block`
has nothing to do. No unguarded step waits for the card: the loss, the
gradient norm and the finite verdict stay on the device until a caller
reads them.

Fault tolerance (``mx.fault``; JAX counterpart ``:733-796``, ``:953-1065``,
``:1172-1285``):

- ``guard=`` (a :class:`~..fault.StepGuard`): before a step, when the
  snapshot is ``snapshot_every`` steps old (or missing), the parameters,
  the optimizer states and the generators' states are copied into buffers
  made once (multi-tensor copies, outside any graph); after the step the
  loss, the gradient norm and the in-graph finite verdict are read in one
  host read, and a step the guard rejects under ``skip_and_rollback`` is
  undone by copying the snapshot back. The guard reads the same path's
  verdict: it never moves a step from the fused path to the eager one.
  Unguarded steps read nothing.
- ``watchdog=`` (a :class:`~..fault.Watchdog`) arms its deadline around
  each step, the guard's read included.
- chaos hooks (``fault.inject``): ``note_step``, ``nan_batch`` /
  ``grad_blowup`` / ``activation_drift`` on the batch as given,
  ``maybe_delay("slow_step")`` and ``maybe_leak("trainer.step")``.
- :meth:`ShardedTrainer.save_checkpoint` / :meth:`restore_checkpoint`: the
  JAX trainer's array names (``param:0000``, ``opt:0000:0``) and meta, so
  checkpoints move between the packages; the generators' states travel as
  ``rng:torch:<k>`` (the JAX package's threefry key, ``rng:base_key``,
  has no counterpart here and is not carried over).

The mesh (``mesh=``, ``rules=``, ``zero1=``, ``seq_axis=``; JAX counterpart
``:83-112``, ``:169-290``): one process per rank (:mod:`.dist`), the
default mesh a pure-``dp`` one over every rank. A one-rank mesh is the
mesh-less path above, bit for bit. On more ranks the step is the eager one
(``fused=None``; ``fused=True`` raises: captured NCCL collectives cannot be
verified on a one-card chip), and:

- every rank receives the global batch and takes its ``dp`` rows
  (``B % dp`` must be 0, as the JAX placement demands); the loss is the
  mean over the global batch (the ``dp`` mean of the ranks' means: exact
  for a loss that is a mean over rows of equal count), and the gradients
  are averaged over ``dp`` before the norm, so the guard sees the global
  norm;
- a parameter that a rule shards (:class:`~.sharding.ShardingRules`, first
  match) is **stored as this rank's block only**, in the module's own
  parameter, and so are its optimizer states; before the forward it is
  gathered over its axes by :func:`~.collectives.replicated_gather` (its
  gradient comes back as this rank's slice, without a sum) and handed to
  the block in its place (a Gluon block's alias table, else
  ``torch.func.functional_call``). The compute is replicated over ``tp``
  and ``sp``; under an ``sp`` axis attention lowers to ring attention
  (``ops/attention.py``). Two exceptions: a Gluon parameter whose
  ``local_axis`` is the one axis its rule cuts dimension 0 over (the
  stacked encoder's layers over ``pp``, the MoE experts over ``ep``) is
  handed over as this rank's block, ungathered, and its gradient stays
  this rank's; a rule over ``dp`` is gathered by
  :func:`~.collectives.varying_gather`, whose backward reduce-scatters the
  ranks' cotangents over ``dp`` into this rank's rows (then the ``dp``
  mean, as every gradient);
- ``zero1`` (default: on when ``dp > 1``) partitions the weight-shaped
  optimizer states and fp32 masters over ``dp`` on the first axis with
  room (JAX ``_zero1_spec``, ``:269-290``): the gradients are
  reduce-scattered into the rank's slice, the update runs on it, and the
  new weights are all-gathered;
- ``save_checkpoint``/``restore_checkpoint`` write and read the global
  arrays under the JAX keys (each rank writes a share of them as its
  shard of the multi-host layout; the primary commits), so a checkpoint
  moves between the packages and between meshes; the meta carries the
  elastic membership (``"elastic"``: generation and process count, JAX
  ``:1211-1214``).

Every ``step()`` begins with ``elastic.poll()`` (JAX ``:737-742``), on the
host, fused or eager: a host loss the lease watchdog detected since the
last step raises :class:`~.elastic.HostLossError` there.

Restore and rollback write into the live tensors (``copy_``), never
rebinding them: the captured graph updates the very parameters and
states it was captured over, and a parameter's new storage would only
make the next step capture again. A generator registered with a graph
draws, at the next replay, from the state it was last set to.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Dict, List, Optional, Union

import numpy as onp
import torch
from torch import nn

from .. import autograd, autotune
from .. import optimizer as opt_mod
from .. import profiler as _prof
from ..base import MXNetError, dtype_name
from ..context import resolve_device
from ..fault import checkpoint as ckpt
from ..fault import inject
from ..fault.checkpoint import array_dtype as _name
from ..ndarray import NDArray
from ..ndarray.serialization import from_host, to_host
from ..nn import Dropout, set_dropout_generator
from ..ops.cuda import graphs
from ..ops.optimizer_ops import sum_sq_total
from ..optimizer.optimizer import _uses_master
from ..util import getenv
from . import collectives, elastic
from .mesh import Mesh, active_mesh, default_mesh
from .sharding import NamedSharding, P, ShardingRules, data_sharding
from .sharding import spec_axes as _spec_axes

__all__ = ["ShardedTrainer"]


def _local_block(spec, axis: Optional[str], mesh: Mesh) -> bool:
    """Does a parameter whose block takes its own ``local_axis`` block
    (``axis``) get it ungathered under ``spec``: the spec cuts dimension 0
    over that axis alone, and no other dimension?"""
    if axis is None or mesh.axis_size(axis) == 1:
        return False
    cut = [(d, a) for d, e in enumerate(tuple(spec))
           for a in ((e,) if isinstance(e, str) else tuple(e or ()))
           if mesh.axis_size(a) > 1]
    return cut == [(0, axis)]


class _FusedStep:
    """The fused step of one batch signature: its static buffers, the
    function over them, and its graph once captured."""

    def __init__(self, trainer: "ShardedTrainer", vals):
        dev = trainer.device
        self.inputs = [torch.empty_like(v) for v in vals]
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph: Optional[graphs.Graph] = None
        self.out = None              # (loss, gnorm, finite, grads)

    def load(self, vals, lr: float, t: int) -> None:
        """Write the batch, ``lr`` and ``t`` into the static buffers (device
        copies and fills, no host sync)."""
        for dst, src in zip(self.inputs, vals):
            dst.copy_(src, non_blocking=True)
        self.lr.fill_(lr)
        self.t.fill_(t)

    def run(self, tr: "ShardedTrainer"):
        """The step of ``tr`` over the static buffers: ``(loss, gnorm,
        finite, grads)``, parameters and optimizer states updated in place.
        Reads no host value (JAX counterpart: ``_build_step``'s ``step``,
        ``parallel/trainer.py:441-508``)."""
        n_data = len(self.inputs) - tr._n_labels
        lr = self.lr
        sched = tr._optimizer.lr_scheduler
        if tr._lr_fold:
            # the schedule at this step's position t-1, scaled by the lr
            # input over the base rate baked in (``:441-448``)
            base = float(sched.base_lr or 0.0)
            scale = lr / base if base else 1.0
            lr = sched.torch_lr(self.t - 1) * scale
        with autograd.train_mode():
            out = tr._block(*self.inputs[:n_data])
            loss = torch.mean(tr._loss_fn(out, *self.inputs[n_data:]))
        diff = [p for p in tr._params if p.requires_grad]
        it = iter(torch.autograd.grad(loss, diff, allow_unused=True))
        grads = [next(it) if p.requires_grad else None for p in tr._params]
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, tr._params)]
        with torch.no_grad():
            gnorm = torch.sqrt(sum_sq_total(grads))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            tr._optimizer.update_multi(tr._indices, tr._params, grads,
                                       tr._states, lr=lr, t=self.t)
        return loss.detach(), gnorm, finite, grads


class ShardedTrainer:
    """Drives a module's training on one device (JAX counterpart:
    ``parallel/trainer.py:73``).

    ``optimizer`` is a registered name (``"adamw"``) or an
    :class:`~..optimizer.Optimizer`. ``device`` defaults to the card and
    raises without one; the module is moved there. The forward runs under
    ``autograd.train_mode()`` (Dropout active); every ``Dropout`` of the
    module draws from one generator on that device, seeded with ``seed``.
    ``fused`` picks the path (module docstring): ``None`` is the fused step
    on the card unless ``MXTPU_FUSED_STEP=0``, the eager one on the CPU.
    ``guard`` (a ``fault.StepGuard``) and ``watchdog`` (a
    ``fault.Watchdog``) are optional (module docstring). ``mesh``,
    ``rules``, ``zero1`` and ``seq_axis`` are the JAX trainer's (module
    docstring); ``seq_axis`` names the batch's sequence dimension, which
    must divide by ``sp`` (every rank keeps the whole sequence: the ring
    cuts its own blocks).
    """

    def __init__(self, block: nn.Module, loss_fn: Callable, optimizer,
                 optimizer_params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 n_labels: int = 1, seed: int = 0,
                 fused: Optional[bool] = None, guard=None, watchdog=None,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[ShardingRules] = None,
                 zero1: Optional[bool] = None,
                 seq_axis: Optional[int] = None,
                 autotune_key: Optional[str] = None):
        self._device = resolve_device(device)
        self._mesh = mesh if mesh is not None else default_mesh()
        self._rules = rules if rules is not None else ShardingRules()
        self._seq_axis = seq_axis
        #: ZeRO-1 (JAX ``:97-104``): on by default when ``dp > 1``
        self._zero1 = (self._mesh.axis_size("dp") > 1 if zero1 is None
                       else bool(zero1))
        #: more than one rank: the sharded eager step (module docstring)
        self._multi = self._mesh.size > 1
        if fused is None:
            fused = (getenv("MXTPU_FUSED_STEP") == "1"
                     and self._device.type == "cuda" and not self._multi)
        elif fused and self._device.type != "cuda":
            raise MXNetError("fused=True captures the step in a CUDA graph: "
                             f"it needs a card, not {self._device}; pass "
                             "fused=None or False on the CPU")
        elif fused and self._multi:
            raise MXNetError(
                f"fused=True on a mesh of {self._mesh.size} ranks would "
                "capture NCCL collectives in the step's CUDA graph, which "
                "cannot be verified on a one-card chip; pass fused=None "
                "(the eager step) on a mesh of more than one rank")
        self._fused = bool(fused)
        self._block = block.to(self._device)
        self._loss_fn = loss_fn
        self._optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._n_labels = n_labels
        self.generator = torch.Generator(device=self._device).manual_seed(seed)
        set_dropout_generator(block, self.generator)
        self._params: Optional[List[nn.Parameter]] = None
        self._indices: Optional[List[int]] = None
        self._states: Optional[list] = None
        self._mp: Optional[List[bool]] = None
        self._t = 0
        self._last = None            # (loss, grad norm, finite), device
        self._last_host = None       # the same read by a guarded step
        self._guard = guard
        self._watchdog = watchdog
        #: the rollback snapshot: buffers made once, refreshed in place
        self._snapshot: Optional[dict] = None
        #: the meta of the last restored checkpoint
        self.last_restore_meta: Optional[dict] = None
        #: the schedule is evaluated inside the fused step (``:435``)
        self._lr_fold = False
        self._steps: Dict[tuple, _FusedStep] = {}
        self._storage: tuple = ()    # the parameters' data_ptr at capture
        #: CUDA graphs captured so far (one per batch signature)
        self.captures = 0
        #: graphs the last ``step()`` replayed: 1 on a fused replay, else 0
        self.last_step_graphs = 0
        #: ``"fused"`` or ``"eager"``: the path the last ``step()`` took
        self.last_path: Optional[str] = None
        #: per parameter: its rule's sharding, the axis its ZeRO-1 slice
        #: cuts (or None), its global shape, which states are weight-shaped
        self._shardings: List[NamedSharding] = []
        self._zaxis: List[Optional[int]] = []
        self._full_shapes: List[tuple] = []
        self._wshaped: List[List[bool]] = []
        #: per parameter: handed to the block as this rank's block
        self._local: List[bool] = []
        #: the autotune key (module docstring) and the entry the first
        #: step's consult found (``{}``: consulted, nothing banked)
        self._autotune_key = autotune_key or type(block).__name__.lower()
        self._tuned: Optional[dict] = None
        self.autotune_entry: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def fused(self) -> bool:
        return self._fused

    @property
    def num_update(self) -> int:
        return self._t

    @property
    def guard(self):
        return self._guard

    @property
    def watchdog(self):
        return self._watchdog

    def _last_value(self, k: int):
        if self._last_host is not None:
            return self._last_host[k]
        return None if self._last is None else self._last[k].item()

    @property
    def last_loss(self) -> Optional[float]:
        """The last step's mean loss (unguarded, reading it waits for the
        card; a guarded step has read it already)."""
        return self._last_value(0)

    @property
    def last_grad_norm(self) -> Optional[float]:
        """The last step's global gradient norm, accumulated in fp32."""
        return self._last_value(1)

    @property
    def last_finite(self) -> Optional[bool]:
        """Were the last step's loss and gradient norm finite?"""
        v = self._last_value(2)
        return None if v is None else bool(v)

    def _init_state(self, data=None) -> None:
        """Parameters in the JAX trainer's order (``:217-218``): a Gluon
        block's sorted by their ``collect_params()`` names, a plain
        module's by torch's names; those names for the optimizer's
        ``idx2name``, the optimizer states, and which parameters update
        through an fp32 master (``_mp``). Checkpoints key arrays by this
        position, so it is the JAX trainer's.

        First, as the JAX trainer does (``:206-214``), one forward on the
        data arguments ``data`` in train mode, without gradients: it
        finishes deferred initialisation and moves BatchNorm's running
        statistics once, as there. It runs when a Gluon block has a
        parameter still uninitialised or an aux parameter
        (``grad_req="null"``); for any other block it would change nothing
        but the dropout stream, and is skipped."""
        if data is not None and self._needs_warmup():
            with torch.no_grad(), autograd.train_mode():
                self._block(*data)
        opt = self._optimizer
        if hasattr(self._block, "collect_params"):
            named, seen = [], set()
            for name, p in sorted(self._block.collect_params().items()):
                if id(p._var) not in seen:
                    seen.add(id(p._var))
                    named.append((name, p._var))
            # torch parameters of plain modules inside it, after them
            named += [(name, p) for name, p in
                      sorted(self._block.named_parameters())
                      if id(p) not in seen]
        else:
            named = sorted(self._block.named_parameters())
        self._params = [p for _, p in named]
        self._indices = list(range(len(self._params)))
        opt.idx2name = {i: name for i, (name, _) in enumerate(named)}
        self._shard_params(named)
        self._states = [opt.create_state_multi_precision(i, p.detach())
                        for i, p in enumerate(self._params)]
        #: which parameters update through an fp32 master
        self._mp = [_uses_master(opt.multi_precision, p, s)
                    for p, s in zip(self._params, self._states)]
        self._wshaped = [[tuple(a.shape) == tuple(p.shape) for a in st]
                         for p, st in zip(self._params, self._states)]
        if self._multi:
            # ZeRO-1: the weight-shaped states keep this rank's dp slice
            self._states = [tuple(self._zslice(i, a) if w else a
                                  for a, w in zip(st, ws))
                            for i, (st, ws) in enumerate(
                                zip(self._states, self._wshaped))]
        sched = opt.lr_scheduler
        self._lr_fold = bool(sched is not None and hasattr(sched, "torch_lr"))

    def _needs_warmup(self) -> bool:
        if not hasattr(self._block, "collect_params"):
            return False
        return any(not p._initialized or p.grad_req == "null"
                   for p in self._block.collect_params().values())

    # ------------------------------------------------------------------
    # the mesh (module docstring)
    # ------------------------------------------------------------------
    def _shard_params(self, named) -> None:
        """Each parameter's rule and ZeRO-1 layout; on a mesh of more than
        one rank, a rule-sharded parameter keeps only this rank's block."""
        mesh = self._mesh
        self._shardings, self._zaxis, self._full_shapes = [], [], []
        local_axis = {}
        if hasattr(self._block, "collect_params"):
            local_axis = {id(gp._var): gp.local_axis
                          for gp in self._block.collect_params().values()}
        self._local = []
        for name, p in named:
            shape = tuple(p.shape)
            sh = self._rules.sharding_for(name, mesh, shape)
            self._local.append(self._multi and _local_block(
                sh.spec, local_axis.get(id(p)), mesh))
            self._shardings.append(sh)
            self._full_shapes.append(shape)
            self._zaxis.append(self._zero1_axis(sh.spec, shape)
                               if self._zero1 else None)
            if self._multi and not sh.is_replicated():
                with torch.no_grad():
                    p.data = sh.local(p.data).contiguous().clone()

    def _zero1_spec(self, spec, shape):
        """A weight's spec with a ``dp`` factor on the first axis that has
        room: the optimizer-state layout of ZeRO stage 1 (JAX counterpart:
        ``:269-290``)."""
        mesh = self._mesh
        dp = mesh.axis_size("dp")
        if dp == 1:
            return spec
        entries = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
        for e in entries:
            used = e if isinstance(e, tuple) else ((e,) if e else ())
            if "dp" in used:
                return P(*entries)      # already dp-partitioned by rule
        for ax in range(len(shape)):
            e = entries[ax]
            used = tuple(e) if isinstance(e, tuple) else ((e,) if e else ())
            cur = 1
            for a in used:
                cur *= mesh.axis_size(a)
            if shape[ax] % (cur * dp) == 0:
                entries[ax] = used + ("dp",)
                return P(*entries)
        return spec                     # nothing divisible: stay replicated

    def _zero1_axis(self, spec, shape) -> Optional[int]:
        """The axis of ``shape`` whose ``dp`` factor :meth:`_zero1_spec`
        adds (None: no slice, or the rule already cuts over ``dp``)."""
        z = tuple(self._zero1_spec(spec, shape))
        for ax, e in enumerate(z):
            old = tuple(spec)[ax] if ax < len(tuple(spec)) else None
            if e != old:
                return ax
        return None

    def _zslice(self, i: int, a: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of a tensor of parameter ``i``'s local
        block (itself where the parameter has none)."""
        ax = self._zaxis[i]
        if ax is None or not self._multi:
            return a
        dp = self._mesh.axis_size("dp")
        n = a.shape[ax] // dp
        return a.narrow(ax, self._mesh.axis_index("dp") * n, n).clone()

    def step_shardings(self, batch_ndims):
        """``(in_shardings, out_shardings)`` of the step, laid out as the
        JAX trainer's (``:310-341``): ``in`` = (parameters, optimizer
        states, key, lr, t, *batch), ``out`` = (loss, grad norm,
        parameters, states, effects, t + 1[, finite]). Parameters carry
        their rule's spec, weight-shaped states the ZeRO-1 one, the batch
        ``dp`` rows (and ``sp`` on ``seq_axis``), scalars are replicated.
        Needs the trainer's state (one ``step()``)."""
        if self._params is None:
            raise MXNetError("step_shardings() needs the trainer's state: "
                             "run step() once first")
        mesh = self._mesh
        repl = NamedSharding(mesh, P())
        params = tuple(self._shardings)
        states = tuple(
            tuple(NamedSharding(mesh, self._zero1_spec(sh.spec, shape)
                                if self._zero1 else sh.spec)
                  if w else repl for w in ws)
            for sh, shape, ws in zip(self._shardings, self._full_shapes,
                                     self._wshaped))
        batch = tuple(data_sharding(mesh, 0, self._seq_axis, nd)
                      for nd in batch_ndims)
        ins = (params, states, repl, repl, repl) + batch
        outs = (repl, repl, params, states, repl, repl)
        if self._fused:
            outs = outs + (repl,)
        return ins, outs

    def _dp_rows(self, vals) -> tuple:
        """This rank's ``dp`` rows of every batch argument."""
        mesh = self._mesh
        dp, di = mesh.axis_size("dp"), mesh.axis_index("dp")
        sp = mesh.axis_size("sp")
        out = []
        for k, v in enumerate(vals):
            if v.dim() == 0:
                out.append(v)
                continue
            if v.shape[0] % dp:
                raise MXNetError(
                    f"batch argument {k} of shape {tuple(v.shape)}: its "
                    f"dimension 0 is sharded over dp={dp}, so its size "
                    f"should be divisible by {dp}, but it is {v.shape[0]}")
            ax = self._seq_axis
            if ax is not None and sp > 1 and ax < v.dim() \
                    and v.shape[ax] % sp:
                raise MXNetError(
                    f"batch argument {k} of shape {tuple(v.shape)}: its "
                    f"dimension {ax} is sharded over sp={sp}, so its size "
                    f"should be divisible by {sp}, but it is {v.shape[ax]}")
            n = v.shape[0] // dp
            out.append(v.narrow(0, di * n, n))
        return tuple(out)

    @contextlib.contextmanager
    def _gathered(self):
        """Inside: the mesh is active and the block computes on each
        rule-sharded parameter's global value, gathered from the blocks
        (its gradient comes back as this rank's slice; summed over ``dp``
        for a rule over ``dp``), or on this rank's block where the block
        takes it so (module docstring)."""
        mesh = self._mesh
        full = {}
        for i, p in enumerate(self._params):
            sh = self._shardings[i]
            if sh.is_replicated() or self._local[i]:
                continue
            x = p
            for d, e in enumerate(sh.spec):
                axes = (e,) if isinstance(e, str) else tuple(e or ())
                if any(mesh.axis_size(a) > 1 for a in axes):
                    x = collectives.varying_gather(x, axes, d, "dp",
                                                   mesh=mesh)
            full[id(p)] = x
        with active_mesh(mesh):
            if not full:
                yield self._block
            elif hasattr(self._block, "collect_params"):
                from ..gluon.block import _ALIASES
                prev = getattr(_ALIASES, "map", None)
                gps = self._block.collect_params().values()
                _ALIASES.map = {id(gp): full.get(id(gp._var), gp._var)
                                for gp in gps}
                try:
                    yield self._block
                finally:
                    _ALIASES.map = prev
            else:
                from torch.func import functional_call
                names = {id(p): n for n, p in self._block.named_parameters()}
                subs = {names[k]: v for k, v in full.items()}
                yield lambda *a: functional_call(self._block, subs, a)

    def _reduce_grads(self, loss, grads):
        """The exchange of a mesh of more than one rank (module docstring):
        the loss and the gradients averaged over ``dp`` (ZeRO-1: a
        gradient reduce-scattered into this rank's slice), and the global
        norm of the gradients; returns ``(loss, grads, gnorm)``."""
        mesh = self._mesh
        dp = mesh.axis_size("dp")
        params = self._params
        loss = collectives.all_reduce(loss, "dp", "mean", mesh=mesh)
        # a rule over dp: the gather's backward has summed over dp already
        summed = [dp > 1 and "dp" in _spec_axes(sh.spec)
                  for sh in self._shardings]
        for i in range(len(grads)):
            if summed[i]:
                grads[i] = grads[i] / dp
        flat = [i for i, z in enumerate(self._zaxis)
                if z is None and not summed[i]]
        if flat and dp > 1:
            # one all-reduce of every gradient without a ZeRO-1 slice
            buf = torch.cat([grads[i].float().reshape(-1) for i in flat])
            buf = collectives.all_reduce(buf, "dp", mesh=mesh) / dp
            off = 0
            for i in flat:
                n = grads[i].numel()
                grads[i] = buf[off:off + n].view_as(grads[i]).to(
                    grads[i].dtype)
                off += n
        sq = torch.zeros((), dtype=torch.float32, device=self._device)
        for i, z in enumerate(self._zaxis):
            blocks = 1
            for a in set(_spec_axes(self._shardings[i].spec)):
                blocks *= mesh.axis_size(a)
            if z is not None:
                grads[i] = collectives.reduce_scatter(
                    grads[i], "dp", scatter_axis=z, mesh=mesh) / dp
                blocks *= dp
            else:
                params[i].grad = grads[i]
            # each block of the gradient is held by size / blocks ranks
            sq = sq + grads[i].float().square().sum() * (blocks / mesh.size)
        gnorm = torch.sqrt(collectives.all_reduce(
            sq, tuple(mesh.axis_names), mesh=mesh))
        return loss, grads, gnorm

    def _zgather(self, i: int, w: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s new local block from this rank's ZeRO-1 slice
        of it (the inverse of :meth:`_zslice`; itself where there is no
        slice)."""
        ax = self._zaxis[i]
        if ax is None or not self._multi:
            return w
        return collectives.all_gather(w.contiguous(), "dp", gather_axis=ax,
                                      mesh=self._mesh)

    def place(self, *batch) -> tuple:
        """Batch arrays (numpy, tensors or NDArrays) as tensors on the
        device; tensors already there pass through. On the card a host
        array is staged in pinned memory and copied with
        ``non_blocking=True`` on the current stream (``io.PrefetchIter``
        runs this on a stream of its own): the staging buffer comes from
        PyTorch's pinned-memory cache, which keeps it from reuse until the
        copy that reads it has completed. Pinning raises without a card;
        nothing drops to a pageable copy."""
        out = []
        for a in batch:
            if isinstance(a, NDArray):
                t = a._data
            elif isinstance(a, torch.Tensor):
                t = a
            else:
                t = torch.from_numpy(onp.ascontiguousarray(a))
            if self._device.type == "cuda" and t.device.type == "cpu" \
                    and not t.is_pinned():
                t = t.pin_memory()
            out.append(t.to(self._device, non_blocking=True))
        return tuple(out)

    def _lr_input(self) -> float:
        """The ``lr`` the step reads: the optimizer's rate before the step
        (JAX ``_refresh_scalars``, ``:611``); with the schedule folded into
        the fused step, its base rate."""
        opt = self._optimizer
        if self._lr_fold:
            return float(opt.lr_scheduler.base_lr or 0.0)
        return float(opt.learning_rate)

    def step(self, *batch) -> torch.Tensor:
        """One training step on ``batch`` = data arguments then
        ``n_labels`` labels; returns the mean loss (a device scalar)."""
        n_data = len(batch) - self._n_labels
        if n_data < 1:
            raise MXNetError("step() needs at least one data argument")
        # a host loss the lease watchdog found since the last step raises
        # here (one list read while the pod is healthy); note_step drives
        # the host_kill/host_stall chaos knobs
        elastic.poll()
        t_step0 = time.perf_counter()
        step_no = self._t + 1
        inject.note_step(step_no)
        if inject.active() is not None:
            batch = self._chaos_batch(batch, n_data)
        vals = self.place(*batch)
        place_ms = (time.perf_counter() - t_step0) * 1e3
        if self._params is None:
            self._init_state(vals[:n_data])
        if self._guard is not None:
            self._maybe_snapshot()
        wd = self._watchdog
        # the step waits for the card when its guard reads it, or, while
        # mx.profiler runs, so that its frame spans its device work
        waits = self._guard is not None or (
            _prof.is_running() and self._device.type == "cuda")
        with wd.watch(step=step_no, block=self) if wd is not None \
                else contextlib.nullcontext():
            inject.maybe_delay("slow_step")
            inject.maybe_leak("trainer.step", self._device)
            t_disp0 = time.perf_counter()
            if self._fused:
                loss = self._fused_step(vals, capture=True)
            else:
                loss = self._eager_step(vals)
            t_disp1 = time.perf_counter()
            self._last_host = None
            if self._guard is not None:
                self._apply_guard()
            elif waits:
                torch.cuda.current_stream(self._device).synchronize()
        t_end = time.perf_counter()
        _prof.record_span("step.place", place_ms, parent="step",
                          step=step_no, t0=t_step0)
        _prof.record_span("step.dispatch", (t_disp1 - t_disp0) * 1e3,
                          parent="step", step=step_no, t0=t_disp0)
        if waits:
            _prof.record_span("step.device_wait", (t_end - t_disp1) * 1e3,
                              parent="step", step=step_no, t0=t_disp1)
        _prof.record_span("step", (t_end - t_step0) * 1e3, kind="frame",
                          step=step_no, t0=t_step0)
        return loss

    def _tuning(self):
        """The autotune overlay every step runs under (module docstring);
        the first call consults the cache."""
        if self._tuned is None:
            self._tuned = autotune.consult("trainer.step",
                                           self._autotune_key,
                                           mesh=self._mesh) or {}
            self.autotune_entry = self._tuned or None
        return autotune.applied(self._tuned)

    def _eager_step(self, vals) -> torch.Tensor:
        with self._tuning():
            return self._eager_step_tuned(vals)

    def _eager_step_tuned(self, vals) -> torch.Tensor:
        """The step in PyTorch's own way, each parameter updated by
        ``Optimizer.step`` (JAX counterpart: the same ``step`` math,
        ``:463-481``), on the host's learning rate and, as in the JAX
        step, a device step count ``t`` (``:631-632``). On a mesh of more
        than one rank (module docstring): this rank's ``dp`` rows, the
        rule-sharded parameters gathered for the forward, the exchange of
        :meth:`_reduce_grads`, the update on this rank's blocks and, under
        ZeRO-1, the new weights gathered over ``dp``."""
        multi = self._multi
        if multi:
            vals = self._dp_rows(vals)
        n_data = len(vals) - self._n_labels
        opt, params = self._optimizer, self._params
        lr = float(opt.learning_rate)
        self._t += 1
        t = torch.full((), self._t, dtype=torch.int32, device=self._device)
        for p in params:
            p.grad = None
        fwd_ctx = (self._gathered() if multi
                   else contextlib.nullcontext(self._block))
        with fwd_ctx as fwd, autograd.train_mode():
            out = fwd(*vals[:n_data])
            loss = torch.mean(self._loss_fn(out, *vals[n_data:]))
        loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if multi:
                loss, grads, gnorm = self._reduce_grads(loss, grads)
            else:
                gnorm = torch.sqrt(sum_sq_total(grads))
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            for i, (p, g) in enumerate(zip(params, grads)):
                s = self._states[i]
                lr_i = lr * opt._mult(i, "lr_mult", opt.lr_mult)
                wd_i = opt._get_wd(i)
                if self._mp[i]:
                    master, rest = opt.step(s[0], g.float(), s[1:], lr_i,
                                            wd_i, t)
                    new_w, new = master, (master,) + tuple(rest)
                else:
                    new_w, rest = opt.step(self._zslice(i, p.detach()),
                                           g.to(p.dtype), s, lr_i, wd_i, t)
                    new = tuple(rest)
                p.copy_(self._zgather(i, new_w))
                # states are written in place, as the fused step writes
                # them: each lives as long as the trainer (restore and
                # rollback copy into it)
                for dst, src in zip(s, new):
                    dst.copy_(src)
        opt.num_update = self._t
        self._last = (loss, gnorm, finite)
        self.last_path, self.last_step_graphs = "eager", 0
        return loss

    def _fused_step(self, vals, capture: bool) -> torch.Tensor:
        """The fused step (module docstring); ``capture=False`` runs its
        function eagerly every time, on the current stream (the CPU
        tests)."""
        with self._tuning():
            return self._fused_step_tuned(vals, capture)

    def _fused_step_tuned(self, vals, capture: bool) -> torch.Tensor:
        storage = tuple(p.data_ptr() for p in self._params)
        if storage != self._storage:
            # parameters re-initialised or moved since the graphs were
            # captured: they read the old storage, so they all go
            self._steps, self._storage = {}, storage
        sig = tuple((tuple(v.shape), v.dtype) for v in vals)
        entry = self._steps.get(sig)
        if entry is None:
            entry = self._steps[sig] = _FusedStep(self, vals)
        lr = self._lr_input()
        self._t += 1
        entry.load(vals, lr, self._t)
        self.last_step_graphs = 0
        if not capture:
            entry.out = entry.run(self)
        elif entry.out is None:
            # first step of this signature: a real step, run eagerly on
            # the capture stream (initialises what the capture needs)
            entry.out = graphs.run_on_capture_stream(
                self._device, lambda: entry.run(self))
        else:
            if entry.graph is None:
                entry.graph = graphs.Graph(self._device, self._generators())
                entry.out = entry.graph.capture(lambda: entry.run(self))
                self.captures += 1
            entry.graph.replay()
            self.last_step_graphs = 1
        loss, gnorm, finite, grads = entry.out
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p.grad = g
        self._optimizer.num_update = self._t
        # the graph rewrites its loss buffer on the next replay
        loss = loss.clone()
        self._last = (loss, gnorm, finite)
        self.last_path = "fused"
        return loss

    def _generators(self) -> List[torch.Generator]:
        """The generators the step draws from: the trainer's, any other
        a Dropout of the module was given, and the optimizer's (SGLD's
        noise)."""
        gens = [self.generator] + self._optimizer.generators()
        for m in self._block.modules():
            if isinstance(m, Dropout) and m.generator is not None:
                gens.append(m.generator)
        return gens

    def sync_to_block(self) -> None:
        """Nothing to write back: the parameters are the module's own (on a
        mesh of more than one rank a rule-sharded one holds this rank's
        block; ``save_checkpoint`` writes the global values)."""

    # ------------------------------------------------------------------
    # fault tolerance (``mx.fault``)
    # ------------------------------------------------------------------
    @staticmethod
    def _chaos_batch(batch, n_data: int):
        """Chaos hook (JAX counterpart: ``:953-980``): when the monkey draws
        ``nan_batch``, the first float data argument becomes NaNs; the
        ``grad_blowup`` / ``activation_drift`` ramps scale the float data
        arguments instead. Numpy arrays and tensors alike, each where it
        lies."""
        scale = (inject.scale_ramp("grad_blowup")
                 * inject.scale_ramp("activation_drift"))
        nan = inject.should("nan_batch")
        if not nan and scale == 1.0:
            return batch
        out = list(batch)
        poisoned = False
        for i in range(n_data):
            a = out[i]
            if isinstance(a, torch.Tensor):
                if not a.is_floating_point():
                    continue
            else:
                a = onp.asarray(a)
                if a.dtype.kind != "f":
                    continue
            if nan and not poisoned:
                out[i] = inject.poison(a)
                poisoned = True
            elif scale != 1.0:
                out[i] = (a * scale).astype(a.dtype, copy=False) \
                    if isinstance(a, onp.ndarray) else a * scale
        return tuple(out)

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every optimizer state tensor, in index order."""
        return [s for st in self._states for s in st
                if isinstance(s, torch.Tensor)]

    def _live_by_dtype(self) -> Dict[torch.dtype, List[torch.Tensor]]:
        """The parameters and optimizer states grouped by dtype: one
        multi-tensor copy per group (a list of mixed dtypes takes one
        copy kernel per tensor)."""
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in [p.detach() for p in self._params] + self._state_tensors():
            groups.setdefault(t.dtype, []).append(t)
        return groups

    def _maybe_snapshot(self) -> None:
        """Refresh the rollback snapshot when it is ``snapshot_every``
        steps old or missing (JAX counterpart: ``:982-991``): multi-tensor
        copies of the parameters and states into buffers made on the first
        snapshot, and the generators' states (so a retried step draws the
        rolled-back step's dropout masks, as the JAX step's key is a
        function of ``t``)."""
        snap = self._snapshot
        if snap is not None \
                and self._t - snap["t"] < self._guard.snapshot_every:
            return
        live = self._live_by_dtype()
        if snap is None:
            snap = self._snapshot = {"buffers": {
                dt: [torch.empty_like(t) for t in ts]
                for dt, ts in live.items()}}
        with torch.no_grad():
            for dt, ts in live.items():
                torch._foreach_copy_(snap["buffers"][dt], ts)
        snap["generators"] = [g.get_state() for g in self._generators()]
        snap["t"] = self._t
        snap["num_update"] = self._optimizer.num_update

    def _apply_guard(self) -> None:
        """Read the step's loss, gradient norm and finite verdict in one
        host read and apply the guard, rolling the step back when it says
        so (JAX counterpart: ``:993-1065``)."""
        g = self._guard
        loss, gnorm, finite = self._last
        lf, gn, ok = torch.stack([loss.float().reshape(()), gnorm.float(),
                                  finite.float()]).tolist()
        self._last_host = (lf, gn, bool(ok))
        reason = g.is_bad(bool(ok), gn)
        if reason is None:
            g.good_step()
        elif g.decide(self._t, reason, detail=f"loss={lf:g}, "
                      f"grad_norm={gn:g}") == "rollback":
            self._rollback()

    def _rollback(self) -> None:
        """Copy the snapshot back into the live parameters, states and
        generators; the step count goes back with them."""
        snap = self._snapshot
        with torch.no_grad():
            for dt, ts in self._live_by_dtype().items():
                torch._foreach_copy_(ts, snap["buffers"][dt])
        for gen, state in zip(self._generators(), snap["generators"]):
            gen.set_state(state)
        self._t = snap["t"]
        self._optimizer.num_update = snap["num_update"]

    _CKPT_FORMAT = 1

    def save_checkpoint(self, root: str, keep: Optional[int] = 3,
                        data_state: Optional[dict] = None) -> str:
        """Write one atomic checkpoint directory under ``root`` (JAX
        counterpart: ``:1172-1221``): the parameters (``param:<i>``), the
        optimizer states (``opt:<i>:<j>``), the generators' states
        (``rng:torch:<k>``), the step count and the learning rate, under
        the step count; retention keeps the newest ``keep``.
        ``data_state`` rides in the meta. Returns the directory."""
        if self._params is None:
            raise MXNetError("nothing to checkpoint: run step() at least "
                             "once so the parameter state exists")
        opt = self._optimizer
        arrays: Dict[str, onp.ndarray] = {}
        from . import dist
        rank, count = dist.world()
        for i, p in enumerate(self._params):
            # on a mesh every rank gathers every array (collectives), and
            # writes a share of them: its shard of the multi-host layout
            mine = not self._multi or i % count == rank
            v = self._global_param(i)
            if mine:
                arrays[f"param:{i:04d}"] = to_host(v)
            for j, s in enumerate(self._states[i]):
                v = self._global_state(i, j)
                if mine:
                    arrays[f"opt:{i:04d}:{j}"] = to_host(v)
        gens = self._generators()
        if not self._multi or rank == 0:
            for k, gen in enumerate(gens):
                arrays[f"rng:torch:{k}"] = gen.get_state().numpy().copy()
        meta = {
            "trainer": "ShardedTrainer", "format": self._CKPT_FORMAT,
            "t": self._t, "num_update": opt.num_update,
            "lr": float(opt.learning_rate), "zero1": self._zero1,
            "optimizer": type(opt).__name__, "rng_impl": "torch",
            "param_names": [opt.idx2name[i]
                            for i in range(len(self._params))],
            "opt_state_sizes": [len(s) for s in self._states],
        }
        if data_state is not None:
            meta["data_state"] = dict(data_state)
        _, count = elastic.membership()
        meta["elastic"] = {"generation": elastic.generation(),
                           "process_count": count}
        path = ckpt.save_checkpoint(root, arrays, meta, step=self._t,
                                    keep=keep)
        if self._multi:
            # the primary has committed when every rank returns
            collectives.all_reduce(torch.zeros((), device=self._device),
                                   tuple(self._mesh.axis_names),
                                   mesh=self._mesh)
        return path

    def _global_param(self, i: int) -> torch.Tensor:
        """Parameter ``i``'s global value (gathered from the rule's
        blocks on a mesh)."""
        p = self._params[i].detach()
        return self._shardings[i].gather(p) if self._multi else p

    def _global_state(self, i: int, j: int) -> torch.Tensor:
        """State ``j`` of parameter ``i``, global: the ZeRO-1 slices and
        the rule's blocks gathered."""
        s = self._states[i][j]
        if not (self._multi and self._wshaped[i][j]):
            return s
        if self._zaxis[i] is not None:
            s = collectives.all_gather(s, "dp", gather_axis=self._zaxis[i],
                                       mesh=self._mesh)
        return self._shardings[i].gather(s)

    def _local_of(self, i: int, v, zero1: bool):
        """This rank's block of a global array of parameter ``i``'s shape
        (``zero1``: its ZeRO-1 slice of that block)."""
        if not self._multi:
            return v
        v = self._shardings[i].local(v)
        if zero1 and self._zaxis[i] is not None:
            ax, di = self._zaxis[i], self._mesh.axis_index("dp")
            n = v.shape[ax] // self._mesh.axis_size("dp")
            v = onp.take(v, range(di * n, (di + 1) * n), axis=ax)
        return onp.ascontiguousarray(v)

    def restore_checkpoint(self, root: str,
                           step: Optional[int] = None) -> int:
        """Restore the newest verified checkpoint under ``root`` (or
        ``step``), written by either package (JAX counterpart:
        ``:1223-1285``), into the live parameters, states and generators,
        in place. The trainer must have its state (one ``step()``), as in
        the JAX package. Returns the restored step."""
        if self._params is None:
            raise MXNetError("call step() once before restore_checkpoint "
                             "so the parameter set exists")
        if step is None:
            arrays, meta, step = ckpt.load_latest(root)
        else:
            arrays, meta, step = ckpt.load_checkpoint(root, step)
        if meta.get("trainer") != "ShardedTrainer" \
                or meta.get("format") != self._CKPT_FORMAT:
            raise MXNetError(
                f"checkpoint step {step} was not written by "
                f"ShardedTrainer.save_checkpoint (meta: {meta.get('trainer')!r}"
                f" format {meta.get('format')!r})")
        opt = self._optimizer
        names = [opt.idx2name[i] for i in range(len(self._params))]
        saved_names = meta.get("param_names", [])
        if len(saved_names) != len(names):
            raise MXNetError(
                "checkpoint parameter set does not match this block: "
                f"saved {len(saved_names)} parameters, live {len(names)}")
        if saved_names != names:
            # Gluon prefixes count up within a process: shapes and dtypes
            # below are the binding contract
            warnings.warn(f"checkpoint parameter names differ from the live "
                          f"block ({saved_names[:2]}... vs {names[:2]}...); "
                          "restoring by position")
        sizes = meta.get("opt_state_sizes", [])
        dev = self._device
        staged = []
        for i, p in enumerate(self._params):
            try:
                v = arrays[f"param:{i:04d}"]
                st = [arrays[f"opt:{i:04d}:{j}"] for j in range(sizes[i])]
            except (KeyError, IndexError) as e:
                raise MXNetError(f"checkpoint step {step} is missing "
                                 f"array {e}") from e
            if tuple(v.shape) != self._full_shapes[i] \
                    or _name(v) != dtype_name(p.dtype):
                raise MXNetError(
                    f"checkpoint array for parameter {names[i]!r} is "
                    f"{_name(v)}{tuple(v.shape)}, live parameter is "
                    f"{dtype_name(p.dtype)}{self._full_shapes[i]}")
            live = self._states[i]
            v = self._local_of(i, v, False)
            if len(st) == len(live):
                st = [self._local_of(i, a, True) if w else a
                      for a, w in zip(st, self._wshaped[i])]
            if len(st) != len(live) or any(
                    tuple(a.shape) != tuple(s.shape)
                    or _name(a) != dtype_name(s.dtype)
                    for a, s in zip(st, live)):
                raise MXNetError(
                    f"checkpoint optimizer state of parameter {names[i]!r} "
                    f"({[(_name(a), a.shape) for a in st]}) does not match "
                    f"this optimizer's ({[(dtype_name(s.dtype), tuple(s.shape)) for s in live]})")
            staged.append((v, st))
        with torch.no_grad():
            for (v, st), p, live in zip(staged, self._params, self._states):
                p.copy_(from_host(v, dev))
                for a, s in zip(st, live):
                    s.copy_(from_host(a, dev))
        gens = self._generators()
        if "rng:torch:0" in arrays:
            saved = sorted(k for k in arrays if k.startswith("rng:torch:"))
            if len(saved) != len(gens):
                raise MXNetError(
                    f"checkpoint step {step} holds {len(saved)} generator "
                    f"states, this trainer draws from {len(gens)}")
            for k, gen in enumerate(gens):
                gen.set_state(torch.from_numpy(
                    onp.ascontiguousarray(arrays[f"rng:torch:{k}"])))
        elif "rng:base_key" in arrays:
            warnings.warn(f"checkpoint step {step} carries the JAX package's "
                          "threefry key (rng:base_key); torch generators "
                          "draw other streams, so it is not carried over "
                          "and dropout masks start from this trainer's own "
                          "generator state")
        self._t = int(meta["t"])
        opt.num_update = int(meta["num_update"])
        self._snapshot = None
        self.last_restore_meta = dict(meta)
        return step

