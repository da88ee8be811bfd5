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
step against the same step run eagerly.
Tolerances as ``chip_smoke.py``, the same for the forward and the backward:
float32 (1e-4, 1e-4), since every kernel's products run in 3xTF32 on the
tensor cores (about fp32 accuracy) and sum in another order than the plain
version's GEMMs; bfloat16 (1e-2, 1.6e-2) for the output's rounding (one ulp
is 2**-8 relative). The forward's lse within 1e-4 on rows that see a key.
"""
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
