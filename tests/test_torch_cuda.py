"""PyTorch port: the CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the JAX package, so they also run on a
machine that has only PyTorch and the CUDA toolkit. Without a card they skip
themselves. On the card, from the root of a checkout::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's ``conftest.py`` sets JAX up.)
``chip_smoke.py`` covers every sequence bucket; this file is the quick check,
with one Gluon step of a small BERT on the card, then the CUDA graphs: the
fused ``ShardedTrainer`` step against the eager one, dropout under replay,
one graph per batch shape, launch counts with replays, and a hybridized
block's forward and backward against the eager ones; the vision path:
float32 convolutions without TF32, a hybridized BatchNorm net against the
eager one (running statistics moved once per call), and the fused step
over a BatchNorm net against the eager step; and the NMT path: the three
kernels at masked cross-length shapes, and the decode engine's captured
step against the same step run eagerly; int8 and mixed precision: the
int8 ops on the card (``torch._int_mm``) bitwise against their plain
versions (padded row counts, ragged inner sizes), calibration of a
hybridized net, and the fused step under ``amp.init("bfloat16")`` against
the eager one; fault tolerance: a checkpoint restored in place into a
trainer whose step is captured, and a guarded step rolled back in place,
each resuming bitwise without a new capture; data: batches placed by
``io.PrefetchIter`` on its own stream while the captured step replays,
bitwise those placed on the main thread, and a multi-worker pinned
``DataLoader`` made after CUDA is initialised; serving: a
``serve.CompiledModel`` bucket's graph replay bitwise the eager forward at
two buckets, a returned output untouched by the next replay, and
``refresh_params`` capturing nothing after an in-place ``set_data`` and
once after new storage, and two models warming up from two threads at
once, each bucket's graph holding exactly its own launches; the symbolic
API: an Executor's replayed forward+backward bitwise its eager run (and
with ``grad_req="add"``), and negative-step indexing card = CPU; the
deploy path: an artifact exported on the card launching the forward kernel
through ``mxtpu::flash_attention_fwd`` (eager and in a ``CompiledModel``'s
graphs, bitwise the eager forward, weights from ``set_weights`` with no
capture), and one exported on the CPU moved to the card; several ranks:
``flash_block`` (the ring's hop) on the card against its plain version
under both cotangents, and a one-rank NCCL group carrying the collectives,
``mx.kv``'s ``nccl`` store and a ``ShardedTrainer`` on a one-rank mesh
bitwise the mesh-less one.
Tolerances as ``chip_smoke.py``, the same for the forward and the backward:
float32 (1e-4, 1e-4), since every kernel's products run in 3xTF32 on the
tensor cores (about fp32 accuracy) and sum in another order than the plain
version's GEMMs; bfloat16 (1e-2, 1.6e-2) for the output's rounding (one ulp
is 2**-8 relative). The forward's lse within 1e-4 on rows that see a key.
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops.cuda import flash_attention as fa

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The flash-attention kernel against its plain version at BERT's
    shapes: key mask with an empty row (the mean of V), causal, causal +
    window."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (atol, rtol) in TOL.items():
        for L in (8, 77, 512):
            q, k, v = (torch.randn(4, 12, L, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(3))
            vl = torch.tensor([0, 1, L // 2, L], device="cuda")
            km = (torch.arange(L, device="cuda")[None] < vl[:, None]).int()
            for causal, window in ((False, None), (True, None), (True, 5)):
                before = fa.launches[fa.KERNEL]
                o, lse = fa._fwd(q, k, v, km, causal, 0.125, window)
                torch.cuda.synchronize()
                assert fa.launches[fa.KERNEL] == before + 1
                ro, _ = fa.flash_attention_reference(q, k, v, km, causal,
                                                     0.125, window)
                torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                           rtol=rtol)
                mean_v = v[0].float().mean(dim=-2, keepdim=True)
                torch.testing.assert_close(
                    o[0].float(), mean_v.to(dtype).float().expand(o[0].shape),
                    atol=atol, rtol=rtol)
    with pytest.raises(MXNetError, match="does not take"):
        fa._fwd(q.transpose(2, 3), k, v, None, False, 0.125)


def _mask(valid, L):
    """(B, L) int32 key mask keeping the first ``valid[b]`` keys."""
    vl = torch.tensor(valid, device="cuda")
    return (torch.arange(L, device="cuda")[None] < vl[:, None]).int()


def _fwd_case(g, dtype, B, Lq, Lk, D, causal, window, km):
    """The forward kernel against its plain version on one case (``km``: a
    (B, Lk) key mask or None): o within the dtype's tolerance, lse within
    1e-4 on rows that see a key, at most -1e29 on the others, whose o is
    the mean of V."""
    q = torch.randn(B, 12, Lq, D, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(B, 12, Lk, D, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    scale = D ** -0.5
    before = fa.launches[fa.KERNEL]
    o, lse = fa._fwd(q, k, v, km, causal, scale, window)
    torch.cuda.synchronize()
    assert fa.launches[fa.KERNEL] == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, km, causal, scale, window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    seen = rlse > -1e29
    torch.testing.assert_close(lse[seen], rlse[seen], atol=1e-4, rtol=0)
    assert (lse[~seen] <= -1e29).all()
    return o, v


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 16, 32, 128])
def test_forward_kernel_head_dims_on_card(D):
    """Each head dim has its own fragment layout (bf16 D = 8 runs its k16
    products over zeroed padding): a key mask with an empty row and a
    ragged length, and causal + window across lengths over a key mask, in
    both dtypes."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(10 + D)
    for dtype in TOL:
        _fwd_case(g, dtype, 4, 77, 77, D, False, None,
                  _mask([0, 1, 38, 77], 77))
        _fwd_case(g, dtype, 2, 100, 160, D, True, 24, _mask([160, 130], 160))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_training_shape_on_card(dtype):
    """The training path's shape (8, 12, 512, 64), every key valid."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    _fwd_case(g, dtype, 8, 512, 512, 64, False, None, _mask([512] * 8, 512))


@pytest.mark.cuda
def test_forward_kernel_skips_hidden_key_tiles_on_card():
    """A key mask that is not a prefix: batch 0 keeps only the keys of the
    middle tile (64..127 of 192), batch 1 none (its rows give the mean of
    V), batch 2 two keys at the far ends; alone and under causal + window,
    so that the mask's and the band's key ranges narrow each other."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(6)
    km = torch.zeros(3, 192, dtype=torch.int32, device="cuda")
    km[0, 64:128] = 1
    km[2, 0] = km[2, 191] = 1
    for dtype in TOL:
        o, v = _fwd_case(g, dtype, 3, 192, 192, 64, False, None, km)
        mean_v = v[1].float().mean(dim=-2, keepdim=True).to(dtype).float()
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(o[1].float(), mean_v.expand(o[1].shape),
                                   atol=atol, rtol=rtol)
        _fwd_case(g, dtype, 3, 192, 192, 64, True, 40, km)


@pytest.mark.cuda
def test_forward_tile_override_on_card(monkeypatch):
    """``MXTPU_FLASH_BQ/BK`` = 16/48 set the forward's logical tiles inside
    its 64-row ones: the same result, many K/V tiles and a ragged last one."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(7)
    monkeypatch.setenv("MXTPU_FLASH_BQ", "16")
    monkeypatch.setenv("MXTPU_FLASH_BK", "48")
    km = _mask([0, 150], 200)
    km[1, 60:100] = 0                        # a hole of its own
    for dtype in TOL:
        _fwd_case(g, dtype, 2, 200, 200, 64, False, None, km)
        _fwd_case(g, dtype, 2, 200, 200, 64, True, 50, km)


@pytest.mark.cuda
def test_backward_kernels_match_plain_version_on_card():
    """The dK/dV and dQ kernels against the plain backward: key mask with
    an empty row and a ragged length, causal + window across lengths; and
    grads flow through ``flash_attention`` on the kernels."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for Lq, Lk, causal, window in ((77, 77, False, None),
                                       (100, 160, True, 24)):
            q, do = (torch.randn(4, 12, Lq, 64, device="cuda",
                                 generator=g).to(dtype) for _ in range(2))
            k, v = (torch.randn(4, 12, Lk, 64, device="cuda",
                                generator=g).to(dtype) for _ in range(2))
            vl = torch.tensor([0, 1, Lk // 2, Lk], device="cuda")
            km = (torch.arange(Lk, device="cuda")[None] < vl[:, None]).int()
            o, lse = fa.flash_attention_reference(q, k, v, km, causal, 0.125,
                                                  window)
            delta = fa._delta(o, do)
            before = dict(fa.launches)
            dk, dv = fa._bwd_dkv_cuda(q, k, v, km, causal, 0.125, window, lse,
                                      do, delta)
            dq = fa._bwd_dq_cuda(q, k, v, km, causal, 0.125, window, lse, do,
                                 delta)
            torch.cuda.synchronize()
            assert fa.launches[fa.KERNEL_BWD_DKV] == \
                before[fa.KERNEL_BWD_DKV] + 1
            assert fa.launches[fa.KERNEL_BWD_DQ] == \
                before[fa.KERNEL_BWD_DQ] + 1
            want = fa.flash_attention_bwd_reference(q, k, v, km, causal,
                                                    0.125, window, o, lse, do,
                                                    delta)
            for got, ref in zip((dq, dk, dv), want):
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=atol, rtol=rtol)
            assert (dq[0] == 0).all()           # a row that sees no key
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    before = dict(fa.launches)
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert all(fa.launches[n] == before[n] + 1 for n in fa.KERNELS)
    with pytest.raises(MXNetError, match="dO must be"):
        fa._bwd_dq_cuda(q, k, v, km, False, 0.125, None, lse, do.float(),
                        delta)


def _bwd_case(g, dtype, B, Lq, Lk, D, causal, window, valid):
    """Both backward kernels against the plain backward on one case; the
    key mask holds the valid lengths ``valid`` (None: no mask)."""
    q, do = (torch.randn(B, 12, Lq, D, device="cuda", generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, 12, Lk, D, device="cuda", generator=g).to(dtype)
            for _ in range(2))
    km = None if valid is None else _mask(valid, Lk)
    scale = D ** -0.5
    o, lse = fa.flash_attention_reference(q, k, v, km, causal, scale, window)
    delta = fa._delta(o, do)
    args = (q, k, v, km, causal, scale, window, lse, do, delta)
    dk, dv = fa._bwd_dkv_cuda(*args)
    dq = fa._bwd_dq_cuda(*args)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, km, causal, scale,
                                            window, o, lse, do, delta)
    atol, rtol = TOL[dtype]
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 16, 32, 128])
def test_backward_kernels_head_dims_on_card(D):
    """Each head dim has its own fragment layout (bf16 D = 8 runs its k16
    products over zeroed padding; D = 128 streams 32-row query tiles): a key
    mask with an empty row and a ragged length, and causal + window across
    lengths, in both dtypes."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(D)
    for dtype in (torch.float32, torch.bfloat16):
        dq = _bwd_case(g, dtype, 4, 77, 77, D, False, None, [0, 1, 38, 77])
        assert (dq[0] == 0).all()
        _bwd_case(g, dtype, 2, 100, 160, D, True, 24, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_training_shape_on_card(dtype):
    """The training path's shape (8, 12, 512, 64), every key valid."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    _bwd_case(g, dtype, 8, 512, 512, 64, False, None, [512] * 8)


@pytest.mark.cuda
def test_backward_tile_override_on_card(monkeypatch):
    """``MXTPU_FLASH_BQ/BK`` below the kernels' tiles give the same result;
    a tile above a kernel's own raises."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    monkeypatch.setenv("MXTPU_FLASH_BQ", "16")
    monkeypatch.setenv("MXTPU_FLASH_BK", "48")
    for dtype in (torch.float32, torch.bfloat16):
        _bwd_case(g, dtype, 2, 200, 200, 64, True, 50, [0, 150])
    monkeypatch.setenv("MXTPU_FLASH_BQ", "64")
    with pytest.raises(MXNetError, match="launch failed"):
        _bwd_case(g, torch.float32, 1, 64, 64, 128, False, None, None)


@pytest.mark.cuda
def test_ndarray_autograd_on_card():
    """``mx.nd`` on ``gpu(0)``: a recorded op's gradient lands on the card
    by ``grad_req`` ('write' once, 'add' twice over two backwards)."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd
    for req, times in (("write", 1), ("add", 2)):
        x = nd.array([[1.0, -2.0], [3.0, 0.5]], ctx=mx.gpu(0))
        x.attach_grad(req)
        for _ in range(2):
            with autograd.record():
                y = (x * x).sum()
            y.backward()
        assert x.grad.context == mx.gpu(0)
        torch.testing.assert_close(x.grad._data, times * 2 * x._data)


@pytest.mark.cuda
def test_gluon_step_on_card(tmp_path):
    """One Gluon step of a 2-layer BERT on the card: the forward and both
    backward kernels launch once per layer, the loss is finite, and a
    ``.params`` round trip into a fresh model gives a bitwise-equal
    forward."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, bench, gluon, models, nd
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    kw = dict(vocab_size=100, max_length=64, dropout=0.1)
    net = models.get_bert("bert_2_128_2", **kw)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    batch = [nd.array(a, ctx=mx.gpu(0))
             for a in bench.make_batch(2, 64, vocab=100)]
    cuda_ops.reset_launches()
    with autograd.record():
        loss = models.bert_pretrain_loss(net(*batch[:4]), *batch[4:])
    loss.backward()
    trainer.step(1)
    torch.cuda.synchronize()
    assert cuda_ops.launch_counts() == {n: 2 for n in cuda_ops.KERNELS}
    assert loss.context == mx.gpu(0) and bool(torch.isfinite(loss._data))
    path = str(tmp_path / "bert.params")
    net.save_parameters(path)
    fresh = models.get_bert("bert_2_128_2", generator=torch.Generator()
                            .manual_seed(3), **kw)
    fresh.load_parameters(path)
    with autograd.predict_mode():
        for a, b in zip(net(*batch[:4]), fresh(*batch[:4])):
            assert torch.equal(a._data, b._data)


def _bert(dropout=0.0, seed=0, **kw):
    """A small BERT on the card, its weights drawn from ``seed``."""
    from incubator_mxnet_tpu_torch import models
    return models.get_bert("bert_2_128_2", vocab_size=100, max_length=64,
                           dropout=dropout, device="cuda",
                           generator=torch.Generator().manual_seed(seed),
                           **kw)


def _trainer(net, fused, optimizer="adamw", params=None):
    from incubator_mxnet_tpu_torch import models, parallel
    return parallel.ShardedTrainer(
        net, models.bert_pretrain_loss, optimizer,
        params or {"learning_rate": 1e-3}, device="cuda", n_labels=3,
        fused=fused)


def _close_params(a, b, rel=1e-5):
    """Every parameter of ``a`` within ``rel`` of ``b``'s largest value."""
    pb = dict(b.named_parameters())
    for name, p in a.named_parameters():
        want = pb[name].detach().float()
        err = (p.detach().float() - want).abs().max().item()
        assert err <= rel * max(want.abs().max().item(), 1e-30), name


@pytest.fixture
def deterministic(monkeypatch):
    """``torch.use_deterministic_algorithms`` for one test: the embedding
    and gather backwards otherwise add in another order on every run, and
    Adam turns that noise in a gradient that is 0 in exact arithmetic (a
    key bias) into a full step either way."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_fused_step_matches_eager_on_card(deterministic):
    """Five fused steps (eager first step, capture, replays) against five
    eager ones at dropout 0: losses to rtol 1e-5, every weight within
    1e-5 of its largest value; one capture, one replay per step."""
    _card()
    from incubator_mxnet_tpu_torch import bench
    batch = bench.make_batch(2, 64, vocab=100)
    fused, eager = _bert(), _bert()
    tf, te = _trainer(fused, None), _trainer(eager, False)
    assert tf.fused and not te.fused
    lf, le = [], []
    for i in range(5):
        lf.append(float(tf.step(*batch)))
        le.append(float(te.step(*batch)))
        assert tf.last_path == "fused" and te.last_path == "eager"
        assert tf.last_step_graphs == (0 if i == 0 else 1)
    assert tf.captures == 1 and tf.num_update == 5
    torch.testing.assert_close(lf, le, rtol=1e-5, atol=0)
    _close_params(fused, eager)
    assert tf.last_finite and abs(tf.last_grad_norm - te.last_grad_norm) \
        <= 1e-5 * te.last_grad_norm
    for (n, p), q in zip(fused.named_parameters(), eager.parameters()):
        assert p.grad is not None and p.grad.shape == p.shape, n


@pytest.mark.cuda
def test_fused_step_draws_new_dropout_masks_on_card():
    """At learning rate 0 only the dropout masks move the loss: every
    replay draws its own."""
    _card()
    from incubator_mxnet_tpu_torch import bench
    batch = bench.make_batch(2, 64, vocab=100)
    tr = _trainer(_bert(dropout=0.3), None, "sgd", {"learning_rate": 0.0})
    losses = [float(tr.step(*batch)) for _ in range(4)]
    assert tr.last_step_graphs == 1
    assert len(set(losses[1:])) == 3, losses


@pytest.mark.cuda
def test_fused_step_new_shape_captures_new_graph_on_card():
    _card()
    from incubator_mxnet_tpu_torch import bench
    tr = _trainer(_bert(), None)
    for L in (64, 32, 64, 32):
        tr.step(*bench.make_batch(2, L, vocab=100))
        tr.step(*bench.make_batch(2, L, vocab=100))
    assert tr.captures == 2 and tr.num_update == 8


@pytest.mark.cuda
def test_fused_step_follows_new_parameter_storage_on_card():
    """Re-initialising the parameters gives them new storage: the graphs
    that read the old one are dropped and the next steps warm up and
    capture again."""
    _card()
    from incubator_mxnet_tpu_torch import bench
    net = _bert()
    tr = _trainer(net, None)
    batch = bench.make_batch(2, 64, vocab=100)
    for _ in range(3):
        tr.step(*batch)
    assert tr.captures == 1 and tr.last_step_graphs == 1
    net.initialize(force_reinit=True)
    tr.step(*batch)
    assert tr.last_step_graphs == 0
    tr.step(*batch)
    assert tr.captures == 2 and tr.last_step_graphs == 1
    assert tr.last_finite


@pytest.mark.cuda
def test_launch_counts_with_replays_on_card():
    """12 layers: each kernel counted 12 times per step, on the eager
    first step, the capture step and the replays alike."""
    _card()
    from incubator_mxnet_tpu_torch import bench
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    tr = _trainer(_bert(num_layers=12), None)
    batch = bench.make_batch(2, 64, vocab=100)
    for _ in range(4):
        cuda_ops.reset_launches()
        tr.step(*batch)
        torch.cuda.synchronize()
        assert cuda_ops.launch_counts() == {n: 12 for n in cuda_ops.KERNELS}


@pytest.mark.cuda
def test_hybridized_forward_backward_match_eager_on_card():
    """A hybridized BERT (eager call, capture, replays) against an
    un-hybridized twin: outputs, every gradient after ``loss.backward()``
    and the weights after ``Trainer.step``; a gradient read after a
    backward keeps its value through the next forward."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, bench, gluon, models, nd
    nets = [_bert(), _bert()]
    nets[0].hybridize()
    trainers = [gluon.Trainer(n.collect_params(), "adam",
                              {"learning_rate": 1e-3}) for n in nets]
    for step in range(4):
        batch = [nd.array(a, ctx=mx.gpu(0)) for a in bench.make_batch(
            2, 64 if step < 3 else 32, vocab=100)]
        outs, losses = [], []
        for net in nets:
            with autograd.record():
                out = net(*batch[:4])
                loss = models.bert_pretrain_loss(out, *batch[4:])
            loss.backward()
            outs.append(out)
            losses.append(loss)
        for a, b in zip(*outs):
            torch.testing.assert_close(a._data, b._data, atol=1e-5,
                                       rtol=1e-5)
        pa, pb = (n._collect_params_with_prefix() for n in nets)
        for k in pa.keys():
            torch.testing.assert_close(pa[k].grad()._data, pb[k].grad()._data,
                                       atol=1e-5, rtol=1e-4)
        kept = {k: pa[k].grad()._data.clone() for k in pa.keys()}
        with autograd.predict_mode():
            nets[0](*batch[:4])
        for k in pa.keys():
            assert torch.equal(pa[k].grad()._data, kept[k]), k
        for tr in trainers:
            tr.step(1)
    assert len(nets[0]._cached_ops) >= 2
    nets[0].hybridize(False)
    assert not nets[0]._cached_ops


@pytest.mark.cuda
def test_hybridized_dropout_draws_new_masks_on_card():
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dropout(0.5))
    net.hybridize()
    x = nd.ones((64, 64), ctx=mx.gpu(0))
    with autograd.train_mode():
        ys = [net(x)._data.clone() for _ in range(4)]
    assert not torch.equal(ys[2], ys[3]) and not torch.equal(ys[1], ys[2])
    assert {v for y in ys for v in y.unique().tolist()} == {0.0, 2.0}


def _bn_net(seed=0):
    """A small conv net with BatchNorm (float32, 10 classes), its shapes
    deferred, Xavier from ``seed``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    n = gluon.nn
    net = n.HybridSequential()
    with net.name_scope():
        net.add(n.Conv2D(16, 3, padding=1, use_bias=False), n.BatchNorm(),
                n.Activation("relu"), n.MaxPool2D(3, 2, 1),
                n.Conv2D(16, 3, padding=1), n.BatchNorm(),
                n.Activation("relu"), n.GlobalAvgPool2D(), n.Dense(10))
    net.initialize(mx.init.Xavier(
        generator=torch.Generator().manual_seed(seed)), ctx=mx.gpu(0))
    return net


def _images(B=8, side=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 3, side, side, generator=g),
            torch.randint(0, 10, (B,), generator=g).float())


@pytest.mark.cuda
def test_float32_convolution_is_ieee_on_card():
    """The port's float32 convolutions, forward and backward, run without
    TF32 whatever ``torch.backends.cudnn.allow_tf32`` says: against a
    float64 convolution they are within float32 rounding, where TF32
    would be ~1e-3 off."""
    _card()
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 64, 28, 28, device="cuda", generator=g,
                    requires_grad=True)
    w = torch.randn(32, 64, 3, 3, device="cuda", generator=g,
                    requires_grad=True)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = tnn.convolution(x, w, None, pad=(1, 1))
        gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    xd, wd = (t.detach().double().requires_grad_() for t in (x, w))
    yd = torch.nn.functional.conv2d(xd, wd, padding=1)
    gxd, gwd = torch.autograd.grad(yd.square().sum(), (xd, wd))
    for got, want in ((y, yd), (gx, gxd), (gw, gwd)):
        err = (got.double() - want).abs().max() / want.abs().max()
        assert err < 1e-5, err


@pytest.mark.cuda
def test_hybridized_batchnorm_net_matches_eager_on_card():
    """A hybridized conv net with BatchNorm (eager call, capture, replays)
    against its un-hybridized twin under ``autograd.record()``: outputs,
    gradients and the running statistics, moved once per call (the
    capture's warm run is undone); then ``predict_mode`` replays a graph
    that reads the statistics."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    nets = [_bn_net(), _bn_net()]
    x, y = (nd.array(t, ctx=mx.gpu(0)) for t in _images())
    for net in nets:
        with autograd.predict_mode():
            net(x)                      # finishes deferred init
    nets[0].hybridize()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(4):
        for net in nets:
            with autograd.record():
                loss = ce(net(x), y).mean()
            loss.backward()
        pa, pb = (n.collect_params() for n in nets)
        for (k, a), b in zip(pa.items(), pb.values()):
            torch.testing.assert_close(a.data()._data, b.data()._data,
                                       atol=1e-6, rtol=1e-5)
            if a.grad_req != "null":
                torch.testing.assert_close(a.grad()._data, b.grad()._data,
                                           atol=1e-5, rtol=1e-4)
    assert any(op.bwd is not None for op in nets[0]._cached_ops.values())
    outs = []
    for net in nets:
        with autograd.predict_mode():
            outs.append([net(x)._data for _ in range(3)][-1])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    assert len(nets[0]._cached_ops) == 2


@pytest.mark.cuda
def test_fused_step_with_batchnorm_matches_eager_on_card(deterministic):
    """``ShardedTrainer``'s fused step over a net with BatchNorm (shapes
    deferred to the trainer's warm-up) against the eager step, under
    deterministic algorithms: losses, weights and running statistics
    after 4 steps at ``wd`` 1e-3 (so the optimizer moves the statistics
    too), one graph replayed per step."""
    _card()
    from incubator_mxnet_tpu_torch import gluon, parallel
    x, y = _images()
    nets, trainers = [_bn_net(), _bn_net()], []
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    for net, fused in zip(nets, (True, False)):
        trainers.append(parallel.ShardedTrainer(
            net, lambda o, l: ce(o, l), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
            device="cuda", n_labels=1, fused=fused))
    losses = [[float(tr.step(x, y)) for _ in range(4)] for tr in trainers]
    assert trainers[0].captures == 1 and trainers[0].last_step_graphs == 1
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    pa, pb = (n.collect_params() for n in nets)
    for (k, a), b in zip(pa.items(), pb.values()):
        torch.testing.assert_close(a.data()._data, b.data()._data,
                                   atol=1e-6, rtol=1e-5)
    rm = [p for k, p in pa.items() if k.endswith("running_mean")][0]
    assert rm.data()._data.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk", [(112, 128), (128, 96)])
def test_kernels_masked_cross_length_on_card(lq, lk):
    """The three kernels at the NMT training's cross-attention shapes
    (target 112 over source 128, 128 over 96; 16 heads of 64) under a
    ragged key mask with a row that sees no key, against their plain
    versions."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype, (atol, rtol) in TOL.items():
        q, do = (torch.randn(4, 16, lq, 64, device="cuda",
                             generator=g).to(dtype) for _ in range(2))
        k, v = (torch.randn(4, 16, lk, 64, device="cuda",
                            generator=g).to(dtype) for _ in range(2))
        km = _mask([0, 1, lk // 2, lk], lk)
        o, lse = fa._fwd(q, k, v, km, False, 0.125)
        ro, rlse = fa.flash_attention_reference(q, k, v, km, False, 0.125)
        torch.testing.assert_close(o.float(), ro.float(), atol=atol,
                                   rtol=rtol)
        seen = rlse > -1e29
        torch.testing.assert_close(lse[seen], rlse[seen], atol=1e-4,
                                   rtol=0)
        args = (q, k, v, km, False, 0.125, None, rlse, do, fa._delta(ro, do))
        got = fa._bwd_dkv_cuda(*args) + (fa._bwd_dq_cuda(*args),)
        want = fa.flash_attention_bwd_dkv_reference(*args) + (
            fa.flash_attention_bwd_dq_reference(*args),)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                       rtol=rtol)
        assert bool((got[2][0] == 0).all())


@pytest.mark.cuda
def test_decode_step_graph_replay_matches_eager_on_card():
    """``serve.DecodeEngine`` on the card: ``warmup()`` captures the decode
    step once; a replayed step's logits equal the same step run eagerly on
    the same inputs, and serving ragged requests captures nothing more."""
    _card()
    import numpy as onp
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import models, serve
    net = models.NMTModel(50, 50, units=64, hidden_size=128, num_layers=2,
                          num_heads=4, dropout=0.0, max_length=64)
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(0)),
                   ctx=mx.gpu(0))
    engine = serve.DecodeEngine(
        net, serve.BucketTable({"batch": (1, 1), "src": (4, 16)}),
        max_batch=4, block_size=4, max_target_len=16, hbm_budget=None)
    engine.warmup()
    assert engine._graph is not None and engine.decode_stats["compiles"] == 1
    rng = onp.random.RandomState(0)
    for row in range(2):
        table = engine.pool.alloc_sequence(f"s{row}")
        cross, lp = engine.prefill_request(rng.randint(3, 50, 7 + row))
        engine.bind_row(row, cross, lp)
        engine.set_row_table(row, table)
    pos = onp.zeros(4, "int32")
    tok = onp.full(4, 1, "int32")
    replayed = torch.from_numpy(engine.run_step(pos, tok))
    eager = engine._step().float().cpu()
    torch.testing.assert_close(replayed, eager, atol=1e-6, rtol=1e-6)
    for row in range(2):
        engine.pool.free_sequence(f"s{row}")
        engine.clear_row(row)
    batcher = serve.DecodeBatcher(engine).start()
    try:
        streams = [batcher.submit(rng.randint(3, 50, int(rng.randint(2, 16))),
                                  max_new_tokens=int(rng.randint(1, 15)))
                   for _ in range(6)]
        assert all(len(s.result(timeout=120)) >= 1 for s in streams)
    finally:
        batcher.stop()
    st = engine.stats()
    assert st["decode"]["post_warmup_compiles"] == 0
    assert st["prefill"]["post_warmup_compiles"] == 0


def _det_inputs(seed=0):
    """Seeded detection inputs on the CPU: an SSD batch, a Faster-RCNN
    batch (images, im_info, gt), RPN maps with a uniform half (tied
    scores), and NMS rows with tied scores."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(2, 3, 64, 64, generator=g)
    x[:, :, 40:] = 0.5
    lab = torch.full((2, 2, 5), -1.0)
    lab[:, 0] = torch.tensor([[1, 0.1, 0.2, 0.5, 0.6],
                              [0, 0.4, 0.3, 0.9, 0.8]])
    gt = torch.full((2, 3, 5), -1.0)
    gt[0, 0] = torch.tensor([1, 8, 8, 31, 35])
    gt[0, 1] = torch.tensor([2, 30, 20, 60, 50])
    gt[1, 0] = torch.tensor([0, 4, 30, 40, 62])
    info = torch.tensor([[64, 64, 1.0], [64, 64, 1.0]])
    logits = torch.randn(2, 2, 9, 16, 16, generator=g)
    logits[..., 8:] = 0.3
    prob = torch.softmax(logits, 1).reshape(2, 18, 16, 16)
    bbox = 0.1 * torch.randn(2, 36, 16, 16, generator=g)
    bbox[..., 8:] = 0.0
    N = 3000
    xy = torch.rand(2, N, 2, generator=g) * 0.7
    rows = torch.cat([torch.randint(0, 4, (2, N, 1), generator=g).float(),
                      (torch.rand(2, N, 1, generator=g) * 10).round() / 10,
                      xy, xy + 0.1 + torch.rand(2, N, 2, generator=g) * 0.3],
                     -1)
    return x, lab, gt, info, prob, bbox, rows


@pytest.mark.cuda
def test_detection_ties_and_scatters_match_cpu_on_card():
    """The detection ops' integer answers on the card equal the CPU's on
    inputs built with ties: NMS rows kept and their order (stable sort),
    the RPN's top-k and NMS picks on a uniform half (the picked scores are
    gathers of the input, so equal picks give equal bits), MultiBoxTarget's
    forced matches (``scatter_reduce`` "amax" with a padding gt) and hard
    negatives among equal losses, AnchorTarget's labels."""
    _card()
    from incubator_mxnet_tpu_torch.ops import detection as det
    x, lab, gt, info, prob, bbox, rows = _det_inputs()
    for topk in (-1, 400):
        got = det.box_nms(rows.cuda(), overlap_thresh=0.45, topk=topk,
                          id_index=0, valid_thresh=0.05)
        want = det.box_nms(rows, overlap_thresh=0.45, topk=topk, id_index=0,
                           valid_thresh=0.05)
        assert torch.equal(got.cpu(), want)
    kw = dict(rpn_pre_nms_top_n=500, rpn_post_nms_top_n=64, threshold=0.7,
              rpn_min_size=4, scales=(4, 8, 16), ratios=(0.5, 1, 2),
              feature_stride=4, output_score=True)
    (rois, sc), (wrois, wsc) = (det.multi_proposal(
        *[t.to(d) for t in (prob, bbox, info)], **kw)
        for d in ("cuda", "cpu"))
    assert torch.equal(sc.cpu(), wsc)
    torch.testing.assert_close(rois.cpu(), wrois, atol=1e-4, rtol=1e-5)
    anchors = torch.cat([det.multibox_prior(torch.zeros(1, 1, h, h),
                                            sizes=(0.2, 0.3),
                                            ratios=(1, 2, 0.5))
                         for h in (16, 8)], 1)
    anchors = torch.cat([anchors, anchors], 1)            # equal IoUs
    pred = torch.zeros(2, 3, anchors.shape[1])             # equal losses
    for d in ("cuda", "cpu"):
        out = det.multibox_target(anchors.to(d), lab.to(d), pred.to(d),
                                  negative_mining_ratio=3.0)
        if d == "cuda":
            card = [o.cpu() for o in out]
    for a, b in zip(card[1:], out[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(card[0], out[0], atol=1e-5, rtol=1e-5)
    assert (out[2] == -1).any() and (out[2] > 0).any()
    labels = [det.rpn_target(prob.to(d), gt.to(d), info.to(d),
                             feature_stride=4, scales=(4, 8, 16))[0].cpu()
              for d in ("cuda", "cpu")]
    assert torch.equal(*labels)


def _det_gluon(kind, x, info):
    """A small SSD or Faster-RCNN on the card with its loss and an SGD
    ``gluon.Trainer``; the weights drawn from the seeded CPU stream by a
    first forward here (their shapes are deferred), so two builds are
    equal."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, models
    mx.random.seed(0)
    if kind == "ssd":
        net = models.SSD(num_classes=2, filters=(8, 8, 8, 8, 8))
        loss = models.SSDTargetLoss()
    else:
        net = models.FasterRCNN(num_classes=3, rpn_pre_nms_top_n=32,
                                rpn_post_nms_top_n=8, output_rpn=True)
        loss = models.FasterRCNNTargetLoss(num_classes=3)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(x) if kind == "ssd" else net(x, info)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    return net, loss, trainer


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ssd", "frcnn"])
def test_hybridized_detection_step_matches_eager_on_card(kind,
                                                         deterministic):
    """A hybridized SSD / Faster-RCNN Gluon step (eager call, capture,
    replays) against an un-hybridized twin under deterministic
    algorithms: outputs, loss and gradients bitwise, weights after
    ``Trainer.step``. Faster-RCNN alternates its two call signatures,
    ``(x, info, gt)`` under ``record()`` and ``(x, info)`` in predict mode:
    one graph each, never the other's."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd
    x, lab, gt, info = (nd.array(t.numpy(), ctx=mx.gpu(0))
                        for t in _det_inputs()[:4])
    nets = [_det_gluon(kind, x, info), _det_gluon(kind, x, info)]
    nets[0][0].hybridize()
    for step in range(4):
        outs, grads = [], []
        for net, loss_fn, trainer in nets:
            with autograd.record():
                if kind == "ssd":
                    out = net(x)
                    loss = loss_fn(*out, lab)
                else:
                    out = net(x, info, gt)
                    loss = loss_fn(*out, gt, info)
            loss.backward()
            grads.append({k: p.grad()._data.clone() for k, p in
                          net._collect_params_with_prefix().items()})
            if kind == "frcnn":
                with autograd.predict_mode():
                    plain = net(x, info)
                assert plain[0].shape == (2, 8, 4)
                out = list(out) + list(plain)
            outs.append([o._data for o in out] + [loss._data])
            trainer.step(1)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        for k in grads[0]:
            assert torch.equal(grads[0][k], grads[1][k]), k
    cached = nets[0][0]._cached_ops
    assert len(cached) == (1 if kind == "ssd" else 2)
    assert all(op.fwd is not None for op in cached.values())
    _close_params(nets[0][0], nets[1][0], rel=0.0)


@pytest.mark.cuda
def test_int8_ops_match_plain_versions_on_card():
    """The int8 ops on the card (``torch._int_mm`` for the products) against
    their plain versions on the CPU, bitwise: quantize, and
    ``quantized_fully_connected`` with a bias at row counts that
    ``_int_mm`` refuses (1, 8, 16: padded to its shape rules) and at inner
    and outer sizes that are not multiples of 8; ``quantized_conv`` over
    27 inner elements (3 channels x 3x3) with stride, padding and
    dilation; ``quantized_pooling``, max and avg."""
    _card()
    from incubator_mxnet_tpu_torch.ops import quantization as tq
    g = torch.Generator().manual_seed(0)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8)

    def same(fn, *args, **kw):
        cpu = fn(*args, **kw)
        card = fn(*[a.cuda() if isinstance(a, torch.Tensor) else a
                    for a in args], **kw)
        for c, d in zip(cpu, card):
            if isinstance(c, torch.Tensor):
                assert torch.equal(d.cpu(), c), fn.__name__
        return card

    rng = (-2.5, 3.0, -0.7, 0.6, -0.2, 0.1)
    x = torch.randn(40, 100, generator=g) * 3
    same(tq.quantize, x, -4.0, 4.0)
    for m, k, n in ((1, 768, 2304), (8, 768, 768), (16, 3072, 768),
                    (17, 13, 6), (40, 100, 30)):
        acc = same(tq.quantized_fully_connected, int8(m, k), int8(n, k),
                   int8(n), *rng, num_hidden=n)
        assert acc[0].shape == (m, n) and acc[0].dtype == torch.int32
        same(lambda *a: (tq.dequantize(*a),), acc[0].cpu(), acc[1], acc[2])
    for kw in (dict(stride=(1, 1), pad=(0, 0)),
               dict(stride=(2, 1), pad=(1, 2), dilate=(2, 1))):
        same(tq.quantized_conv, int8(2, 3, 17, 15), int8(5, 3, 3, 3),
             int8(5), *rng, **kw)
    for pool in ("max", "avg"):
        same(tq.quantized_pooling, int8(2, 4, 9, 8), -1.0, 1.0,
             kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool)


@pytest.mark.cuda
def test_quantize_net_on_hybridized_net_on_card():
    """Calibration of a hybridized net whose cached op has captured its
    graphs (a replay runs no pre-hook) sees every layer's input, the
    same ranges as the plain net's; ``quantize_model`` over it leaves its
    graphs and outputs as they were; the swapped net then runs on the
    card (JAX counterpart: ``tests/test_quantization.py:164``)."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, nd, quantization, serve
    x = nd.array(torch.randn(2, 1, 12, 12).numpy(), ctx=mx.gpu(0))
    nets = []
    for hybrid in (False, True):
        mx.random.seed(43)
        net = gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(gluon.nn.Conv2D(4, 3, activation="relu",
                                    in_channels=1),
                    gluon.nn.Flatten(), gluon.nn.Dense(3, in_units=400))
        net.initialize(ctx=mx.gpu(0))
        if hybrid:
            net.hybridize()
        for _ in range(3):                      # eager, capture, replay
            net(x)
        nets.append(net)
    assert any(op.fwd is not None for op in nets[1]._cached_ops.values())
    ranges = [quantization.observe_net(n, [x]).ranges() for n in nets]
    assert ranges[0] == ranges[1] and len(ranges[1]) == 2
    # quantize_model copies the hybridized block without its graphs, which
    # the original keeps, serving as before
    want = nets[1](x)._data.clone()
    cm = serve.CompiledModel(nets[1], serve.BucketTable({"batch": (2, 2)}),
                             [{0: "batch"}], example_args=[x])
    qcm = quantization.quantize_model(
        cm, quantization.observe_net(nets[1], [x]))
    assert nets[1]._cached_ops and not qcm._block._cached_ops
    assert torch.equal(nets[1](x)._data, want)
    assert bool(torch.isfinite(qcm.predict(x)._data).all())
    quantization.quantize_net(nets[1], calib_data=[x])
    out = nets[1](x)
    assert out.context == mx.gpu(0) and bool(torch.isfinite(out._data).all())


@pytest.mark.cuda
def test_amp_fused_step_matches_eager_on_card(deterministic):
    """Under ``amp.init("bfloat16")`` (float32 weights) three fused steps
    against three eager ones: losses to rtol 1e-5, every weight within
    1e-5 of its largest value; the kernels took bfloat16 q, k and v."""
    _card()
    from incubator_mxnet_tpu_torch import amp, bench
    batch = bench.make_batch(2, 64, vocab=100)
    amp.init("bfloat16")
    seen = []
    orig = fa._launch

    def spy(name, q, *a, **k):
        seen.append(q.dtype)
        return orig(name, q, *a, **k)

    fa._launch = spy
    try:
        fused, eager = _bert(), _bert()
        tf, te = _trainer(fused, None), _trainer(eager, False)
        lf = [float(tf.step(*batch)) for _ in range(3)]
        le = [float(te.step(*batch)) for _ in range(3)]
    finally:
        fa._launch = orig
        amp.reset()
    assert tf.captures == 1 and tf.last_step_graphs == 1
    assert seen and set(seen) == {torch.bfloat16}
    torch.testing.assert_close(lf, le, rtol=1e-5, atol=0)
    _close_params(fused, eager)
    assert all(p.grad.dtype == torch.float32 for p in fused.parameters())


def _state_of(tr):
    return [t.detach().clone() for t in list(tr._params)
            + tr._state_tensors()]


def _ptrs(tr):
    return [t.data_ptr() for t in list(tr._params) + tr._state_tensors()]


@pytest.mark.cuda
def test_fused_restore_in_place_resumes_bitwise_on_card(deterministic,
                                                        tmp_path):
    """A trainer whose fused step is already captured restores a
    checkpoint in place (the same storage, no new capture) and, its
    generator set back, replays the uninterrupted run's steps bitwise:
    bfloat16 weights with fp32 masters, dropout 0.1."""
    _card()
    import warnings
    from incubator_mxnet_tpu_torch import bench
    batch = bench.make_batch(2, 64, vocab=100)
    opt = {"learning_rate": 1e-3, "multi_precision": True}
    u = _trainer(_bert(dropout=0.1, dtype="bfloat16"), None, "adamw", opt)
    ref = []
    for t in range(6):
        ref.append(float(u.step(*batch)))
        if t == 2:
            u.save_checkpoint(str(tmp_path), keep=1)
    r = _trainer(_bert(dropout=0.1, dtype="bfloat16", seed=5), None,
                 "adamw", opt)
    for _ in range(3):
        r.step(*batch)                  # eager run, capture, replay
    assert r.captures == 1
    ptrs = _ptrs(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert r.restore_checkpoint(str(tmp_path)) == 3
    assert _ptrs(r) == ptrs
    got = [float(r.step(*batch)) for _ in range(3)]
    assert got == ref[3:]
    assert r.captures == 1 and r.last_step_graphs == 1
    for a, b in zip(_state_of(u), _state_of(r)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_rollback_in_place_on_card(deterministic):
    """``StepGuard("skip_and_rollback")`` over a captured fused step: a
    poisoned step (NaN MLM weights) is rolled back into the same storage
    bitwise, with no new capture, and the next clean step equals a clean
    twin's bitwise (dropout 0.1: the generator is rolled back too)."""
    _card()
    import warnings
    from incubator_mxnet_tpu_torch import bench, fault
    batch = bench.make_batch(2, 64, vocab=100)
    guard = fault.StepGuard("skip_and_rollback")
    g = _trainer(_bert(dropout=0.1), None)
    g._guard = guard
    c = _trainer(_bert(dropout=0.1), None)
    placed = g.place(*batch)
    for tr in (g, c):
        for _ in range(3):
            tr.step(*placed)
    bad = list(placed)
    bad[5] = torch.full_like(placed[5], float("nan"))
    before, ptrs = _state_of(g), _ptrs(g)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.step(*bad)
    assert guard.tripped == guard.skipped == 1 and g.num_update == 3
    assert _ptrs(g) == ptrs and g.captures == 1
    for a, b in zip(before, _state_of(g)):
        assert torch.equal(a, b)
    assert float(g.step(*placed)) == float(c.step(*placed))
    for a, b in zip(_state_of(c), _state_of(g)):
        assert torch.equal(a, b)
    assert g.captures == 1 and g.last_step_graphs == 1


def _pipeline_data(n=48):
    rng = onp.random.RandomState(5)
    return (rng.randint(0, 100, (n, 64)).astype("int32"),
            rng.rand(n, 64).astype("float32"))


@pytest.mark.cuda
def test_prefetch_place_under_replay_matches_sync_on_card(deterministic):
    """``io.PrefetchIter(place=trainer.place)`` over a ``DataLoader``
    while the captured BERT step replays (the copies on the iterator's
    stream, the step waiting on its event): every batch the step received
    (its static input buffers after each load) and every loss bitwise
    equal to a twin run placing each batch on the main thread."""
    _card()
    from incubator_mxnet_tpu_torch import bench, io
    from incubator_mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    ids, noise = _pipeline_data()
    rest = bench.make_batch(4, 64, vocab=100)[1:]

    def batchify(samples):
        x = onp.stack([s[0] for s in samples])
        return [x] + [r[:len(samples)] for r in rest]

    runs = []
    for prefetch in (True, False):
        tr = _trainer(_bert(), None)
        loader = DataLoader(ArrayDataset(ids, noise), batch_size=4,
                            batchify_fn=batchify)
        onp.random.seed(0)
        if prefetch:
            it = io.PrefetchIter(loader, place=lambda b: tr.place(*b))
        else:
            src = iter(loader)
            it = (tr.place(*b) for b in src)
        losses, seen = [], []
        for _ in range(8):
            losses.append(tr.step(*next(it)))
            entry = next(iter(tr._steps.values()))
            seen.append([t.clone() for t in entry.inputs])
        if prefetch:
            it.close()
        assert tr.captures == 1 and tr.last_step_graphs == 1
        runs.append(([float(x) for x in losses], seen))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_dataloader_workers_pin_and_place_on_card(monkeypatch):
    """A ``DataLoader(num_workers=2, pin_memory=True)`` made after CUDA is
    initialised: its forked workers run (numpy only), each batch goes
    through pinned memory to the card, equal to the numpy batch; the
    same through the pipe."""
    _card()
    from incubator_mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    torch.ones(1, device="cuda").sum().item()     # CUDA initialised
    ids, noise = _pipeline_data(20)
    pins = []
    orig = torch.Tensor.pin_memory

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        pins.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    for shm in ("1", "0"):
        monkeypatch.setenv("MXTPU_DATALOADER_SHM", shm)
        pins.clear()
        loader = DataLoader(ArrayDataset(ids, noise), batch_size=6,
                            num_workers=2, pin_memory=True, timeout=30)
        got = list(loader)
        loader.close()
        assert len(got) == 4 and len(pins) == 8 and all(pins)
        for k, (x, y) in enumerate(got):
            assert x._data.is_cuda and y._data.is_cuda
            assert torch.equal(x._data.cpu(),
                               torch.from_numpy(ids[6 * k:6 * k + 6]))
            assert torch.equal(y._data.cpu(),
                               torch.from_numpy(noise[6 * k:6 * k + 6]))


def _served_bert(table):
    """A 2-layer BERT encoder on the card and its ``CompiledModel``."""
    from incubator_mxnet_tpu_torch import models, serve
    net = _bert(use_decoder=False, use_classifier=False)
    spec = models.serve_spec("bert_encoder")
    example = (onp.zeros((1, 8), "int32"), onp.zeros((1, 8), "int32"),
               onp.zeros((1,), "float32"))
    cm = serve.CompiledModel(net, serve.BucketTable(table),
                             spec["input_axes"], example,
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    return net, cm


def _bert_request(rng, B, L):
    return (rng.randint(1, 100, (B, L)).astype("int32"),
            (onp.arange(L)[None] >= L // 2).repeat(B, 0).astype("int32"),
            rng.randint(1, L + 1, B).astype("float32"))


def _eager(net, args):
    with torch.inference_mode():
        return net(*(torch.from_numpy(a).cuda() for a in args))


@pytest.mark.cuda
def test_compiled_model_replays_equal_eager_on_card(deterministic):
    """One CUDA graph per bucket, captured at ``warmup``: a replay at two
    buckets equals the eager forward bitwise, with the forward kernel's
    launches counted through the replays, and an output already returned
    keeps its value through the next replay of its bucket."""
    _card()
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    net, cm = _served_bert({"batch": (1, 2), "seq": (8, 16)})
    assert cm.warmup()["compiled"] == 4 and len(cm._graphs) == 4
    rng = onp.random.RandomState(0)
    for B, L in ((1, 8), (2, 16)):
        args = _bert_request(rng, B, L)
        cuda_ops.reset_launches()
        got = cm.predict(*args)
        assert cuda_ops.launch_counts()[fa.KERNEL] == 2
        for g, w in zip(got, _eager(net, args)):
            assert g.context.device_type == "gpu"
            assert torch.equal(g._data, w)
    first = cm.predict(*_bert_request(rng, 2, 16))
    kept = [o._data.clone() for o in first]
    cm.predict(*_bert_request(rng, 2, 16))
    assert all(torch.equal(o._data, k) for o, k in zip(first, kept))
    info = cm.cache_info()
    assert info["compiles"] == 4 and info["post_warmup_compiles"] == 0


@pytest.mark.cuda
def test_compiled_model_refresh_params_on_card(deterministic):
    """``refresh_params``: weights written in place (``set_data``) are
    served with no capture; a parameter given new storage captures the
    bucket again, counted as a post-warmup compile."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    net, cm = _served_bert({"batch": (2, 2), "seq": (16, 16)})
    cm.warmup()
    args = _bert_request(onp.random.RandomState(1), 2, 16)
    before = cm.predict(*args)[0]._data.clone()
    for p in net.collect_params().values():
        p.set_data(p.data() * 0.9)
    cm.refresh_params()
    assert cm.cache_info()["compiles"] == 1
    got = cm.predict(*args)[0]._data
    assert not torch.equal(got, before)
    assert torch.equal(got, _eager(net, args)[0])
    net.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(7)),
                   ctx=mx.gpu(0), force_reinit=True)
    cm.refresh_params()
    info = cm.cache_info()
    assert info["compiles"] == 2 and info["post_warmup_compiles"] == 1
    assert torch.equal(cm.predict(*args)[0]._data, _eager(net, args)[0])


@pytest.mark.cuda
def test_compiled_models_warm_up_together_on_card(deterministic):
    """Two ``CompiledModel``s warm up from two threads at once (two
    replicas loading on one card): every warm run and capture holds the
    capture stream alone, so each bucket graph's tally is exactly its own
    forward's launches (one per layer), the warm runs' launches are all
    counted, and every replay equals its model's eager forward."""
    _card()
    import threading
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    table = {"batch": (1, 2), "seq": (8, 16)}
    pairs = [_served_bert(table) for _ in range(2)]
    barrier, errors = threading.Barrier(2), []

    def warm(cm):
        try:
            barrier.wait(60)
            cm.warmup()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    cuda_ops.reset_launches()
    ts = [threading.Thread(target=warm, args=(cm,)) for _, cm in pairs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not errors and not any(t.is_alive() for t in ts)
    torch.cuda.synchronize()
    # 2 models x 4 buckets x 2 layers, each a warm run outside any graph
    assert cuda_ops.launch_counts()[fa.KERNEL] == 16
    rng = onp.random.RandomState(2)
    for net, cm in pairs:
        assert len(cm._graphs) == 4 and cm.cache_info()["compiles"] == 4
        assert all(bg.graph.tally == {fa.KERNEL: 2}
                   for bg in cm._graphs.values())
        for B, L in ((1, 8), (2, 16)):
            args = _bert_request(rng, B, L)
            for g, w in zip(cm.predict(*args), _eager(net, args)):
                assert torch.equal(g._data, w)


@pytest.mark.cuda
def test_executor_replay_matches_eager_on_card(deterministic):
    """A ``simple_bind`` Executor of ``lenet_symbol`` on the card: its
    captured forward+backward (one CUDA graph) replayed on two batches
    equals its eager forward and backward on each bitwise, with one
    capture; ``grad_req="add"`` adds the replayed gradients; a scoring
    forward captures a second graph."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import models
    sym = models.lenet_symbol()
    names = sym.list_arguments()
    shapes, _, _ = sym.infer_shape(data=(8, 1, 28, 28), softmax_label=(8,))
    exe = sym.simple_bind(ctx=mx.gpu(0), data=(8, 1, 28, 28),
                          softmax_label=(8,))
    rng = onp.random.RandomState(0)
    for _ in range(2):
        vals = {n: rng.rand(*s).astype("float32") for n, s in
                zip(names, shapes)}
        vals["softmax_label"] = rng.randint(0, 10, (8,)).astype("float32")
        runs = []
        for graphed in (False, True):
            exe._graphed = graphed
            exe.copy_params_from(vals)
            out = exe.forward(is_train=True)[0]._data.clone()
            exe.backward()
            runs.append([out] + [exe.grad_dict[n]._data.clone()
                                 for n in names])
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    assert exe.captures == 1
    add = sym.simple_bind(ctx=mx.gpu(0), grad_req="add",
                          data=(8, 1, 28, 28), softmax_label=(8,))
    add.copy_params_from(vals)
    for _ in range(2):
        add.forward(is_train=True)
        add.backward()
    for n in names:
        assert torch.equal(add.grad_dict[n]._data, 2 * runs[1][
            1 + names.index(n)])
    exe.forward(is_train=False)
    assert exe.captures == 2


@pytest.mark.cuda
def test_negative_step_indexing_on_card():
    """``x[:, ::-1]`` and its gradient, and ``x[::-1] = v``, on a CUDA
    NDArray equal the CPU's."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd
    host = onp.random.RandomState(1).randn(4, 7).astype("float32")
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        x = nd.array(host, ctx=ctx)
        x.attach_grad()
        with autograd.record():
            y = (x[:, ::-1] * x[:, ::-1]).sum()
        y.backward()
        z = nd.zeros((4, 7), ctx=ctx)
        z[::-1] = nd.array(host, ctx=ctx)
        got.append((x[:, ::-3].asnumpy(), x.grad.asnumpy(), z.asnumpy()))
    for a, b in zip(*got):
        assert onp.array_equal(a, b)


def _flash_nodes(blk) -> int:
    return sum(str(n.target).startswith("mxtpu.flash_attention_fwd")
               for ep in blk._loaded.values() for n in ep.graph.nodes)


@pytest.mark.cuda
def test_exported_artifact_launches_the_kernel_on_card(deterministic,
                                                       tmp_path):
    """A 2-layer BERT exported on the card for a 2x2 bucket table (one
    program, two ``mxtpu::flash_attention_fwd`` nodes) and imported as a
    ``SymbolBlock``: its forward launches the forward kernel once per layer
    and equals the eager forward bitwise; a ``CompiledModel`` over it
    captures the 4 buckets and its replays equal the eager forward with 2
    launches a batch; weights written in place by ``set_weights`` reach
    the replays with no capture."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, models, nd, serve
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    net = _bert(use_decoder=False, use_classifier=False)
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable({"batch": (1, 2), "seq": (8, 16)})
    rng = onp.random.RandomState(3)
    args = _bert_request(rng, 2, 16)
    net(*(nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in args))
    prefix = str(tmp_path / "bert")
    sym_file, params_file = serve.export_for_serving(
        net, prefix, table, spec["input_axes"])
    blk = gluon.SymbolBlock.imports(sym_file, ["ids", "types", "valid"],
                                    params_file, ctx=mx.gpu(0))
    assert len(blk._loaded) == 1 and _flash_nodes(blk) == 2
    cuda_ops.reset_launches()
    got = blk(*(nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in args))
    assert cuda_ops.launch_counts()[fa.KERNEL] == 2
    for g, w in zip(got, _eager(net, args)):
        assert torch.equal(g._data, w)
    cm = serve.CompiledModel(blk, table, spec["input_axes"],
                             output_axes=spec["output_axes"],
                             pad_values=spec["pad_values"])
    assert cm.warmup()["compiled"] == 4 and len(cm._graphs) == 4
    for B, L in ((1, 8), (2, 16)):
        args = _bert_request(rng, B, L)
        cuda_ops.reset_launches()
        got = cm.predict(*args)
        assert cuda_ops.launch_counts()[fa.KERNEL] == 2
        for g, w in zip(got, _eager(net, args)):
            assert torch.equal(g._data, w)
    new = {k: p.data().asnumpy() * 1.5
           for k, p in net._collect_params_with_prefix().items()}
    assert blk.set_weights(new) == len(new)
    serve.apply_weights(net, new)
    cm.refresh_params()
    for g, w in zip(cm.predict(*args), _eager(net, args)):
        assert torch.equal(g._data, w)
    assert cm.cache_info()["compiles"] == 4


@pytest.mark.cuda
def test_cpu_export_loads_on_card(tmp_path):
    """A program exported on the CPU with ``platforms=["cpu", "cuda"]`` is
    moved to the card when its parameters are there
    (``move_to_device_pass``): it launches the forward kernel once per
    layer and equals the eager forward on the card within the float32
    tolerance; one exported for the CPU alone raises, naming ``cuda``."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, models, nd
    from incubator_mxnet_tpu_torch.ops import cuda as cuda_ops
    with mx.cpu():
        net = models.get_bert("bert_2_128_2", vocab_size=100, max_length=64,
                              dropout=0.0, device="cpu",
                              use_decoder=False, use_classifier=False)
    args = _bert_request(onp.random.RandomState(4), 2, 16)
    net(*(nd.array(a, ctx=mx.cpu(), dtype=a.dtype) for a in args))
    both = net.export(str(tmp_path / "both"), platforms=["cpu", "cuda"])
    cpu_only = net.export(str(tmp_path / "cpu"))
    card = models.get_bert("bert_2_128_2", vocab_size=100, max_length=64,
                           dropout=0.0, device="cuda",
                           use_decoder=False, use_classifier=False)
    card.load_parameters(both[1], ctx=mx.gpu(0))
    blk = gluon.SymbolBlock.imports(both[0], ["a", "b", "c"], both[1],
                                    ctx=mx.gpu(0))
    cuda_ops.reset_launches()
    got = blk(*(nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in args))
    assert cuda_ops.launch_counts()[fa.KERNEL] == 2
    rtol, atol = TOL[torch.float32]
    for g, w in zip(got, _eager(card, args)):
        torch.testing.assert_close(g._data, w, rtol=rtol, atol=atol)
    only = gluon.SymbolBlock.imports(cpu_only[0], ["a", "b", "c"],
                                     cpu_only[1], ctx=mx.gpu(0))
    with pytest.raises(MXNetError, match="'cuda'"):
        only(*(nd.array(a, ctx=mx.gpu(0), dtype=a.dtype) for a in args))


@pytest.mark.cuda
def test_flash_block_matches_plain_version_on_card():
    """``flash_block``'s ``o`` and ``lse`` and its gradients under an lse
    cotangent (``delta - dlse`` into the two backward kernels) against the
    plain versions, at a hop of a ragged key mask with a row that has no
    key in the block; each kernel launches once per call."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, (atol, rtol) in TOL.items():
        q, k, v, do = (torch.randn(2, 4, 128, 64, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        dlse = torch.randn(2, 4, 128, device="cuda", generator=g)
        km = (torch.rand(2, 128, device="cuda", generator=g) > 0.5).int()
        km[1] = 0
        for causal in (False, True):
            outs = []
            for dev in ("cuda", "cpu"):
                a, b, c = (t.detach().to(dev).requires_grad_(True)
                           for t in (q, k, v))
                before = dict(fa.launches)
                o, lse = fa.flash_block(a, b, c, km.to(dev), causal, 0.125)
                ((o.float() * do.to(dev).float()).sum()
                 + (lse * dlse.to(dev)).sum()).backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    assert all(fa.launches[n] == before[n] + 1
                               for n in fa.KERNELS)
                outs.append([t.detach().float().cpu() for t in
                             (o, lse, a.grad, b.grad, c.grad)])
            live = km.cpu()[:, None, :].any(-1).expand(2, 4)
            for i, (got, want) in enumerate(zip(*outs)):
                if i == 1:
                    got, want = got[live], want[live]
                    assert (outs[0][1][~live] < -1e29).all()
                torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_one_rank_nccl_group_on_card():
    """``parallel.dist.initialize(backend="nccl")`` makes a one-rank group:
    the collectives over it run on CUDA tensors, a ``nccl`` store pushes
    and pulls through it, and a ``ShardedTrainer`` on a one-rank mesh
    takes the fused step, bitwise the mesh-less one (at one rank
    ``rules`` and ``zero1`` keep every parameter and state whole: no
    multi-rank step runs here)."""
    _card()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import bench, models, parallel
    parallel.initialize(backend="nccl")
    try:
        x = torch.arange(6.0, device="cuda")
        assert torch.equal(parallel.all_reduce(x, None), x)
        assert torch.equal(parallel.all_gather(x, None), x)
        kv = mx.kv.create("nccl")
        kv.init(0, mx.nd.zeros((6,), ctx=mx.gpu(0)))
        kv.push(0, [mx.nd.array(x.cpu().numpy(), ctx=mx.gpu(0))] * 2)
        assert torch.equal(kv.pull(0)._data, 2 * x)
        batch = bench.make_batch(2, 64, vocab=100)
        losses = []
        for mesh in (None, parallel.make_mesh()):
            net = models.get_bert("bert_2_128_2", vocab_size=100,
                                  max_length=64, dropout=0.0, device="cuda",
                                  generator=torch.Generator().manual_seed(0))
            kw = {} if mesh is None else dict(
                mesh=mesh, rules=models.bert_sharding_rules(), zero1=True)
            tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss,
                                         "adam", {"learning_rate": 1e-3},
                                         n_labels=3, **kw)
            losses.append([tr.step(*batch).item() for _ in range(3)])
            assert tr.last_path == "fused" and tr.last_step_graphs == 1
        assert losses[0] == losses[1]
    finally:
        parallel.finalize()
