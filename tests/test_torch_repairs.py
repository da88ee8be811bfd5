"""PyTorch port: five behaviours of the Gluon core held against the JAX
package on the CPU.

- ``Trainer.load_states`` restores ``num_update`` only, so a fresh trainer
  starts Adam's bias correction again, as the JAX package's does
  (``gluon/trainer.py:243-249``): weights after a save, a load and one more
  step agree to rtol 1e-6 (float32; the same Adam arithmetic in both).
- ``.states`` files are the JAX package's pickle of numpy arrays and move
  both ways (bfloat16 states as ``.params`` files carry them).
- In-place mutation of an array on the autograd tape raises ``MXNetError``
  while recording; the arrays the JAX package allows stay allowed
  (``ndarray/ndarray.py:184-189``).
- A second ``backward()`` on the same graph leaves each gradient as the
  first left it, under ``grad_req`` ``'write'`` and ``'add'``.
- ``mx.cpu(99)`` builds, and raises "device_id out of range" on first use
  (``context.py:121-127``).
"""
import numpy as onp
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXNetError

PKGS = {"port": mx, "jax": jmx}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread so these small tests do not crowd the others' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


X = onp.arange(12, dtype="float32").reshape(4, 3) / 10


def _dense(pkg, prefix):
    net = pkg.gluon.nn.Dense(2, in_units=3, prefix=prefix)
    net.initialize(init=pkg.init.One(), ctx=pkg.cpu())
    return net


def _adam_step(pkg, net, trainer):
    x = pkg.nd.array(X, ctx=pkg.cpu())
    with pkg.autograd.record():
        loss = (net(x) * net(x)).sum()
    loss.backward()
    trainer.step(4)


def _trainer(pkg, net, **kw):
    return pkg.gluon.Trainer(net.collect_params(), "adam",
                             dict({"learning_rate": 0.1}, **kw))


def _resumed_weights(saver, loader, tmp_path, multi_precision=False):
    """3 Adam steps in ``saver``'s package, ``save_states``, then a fresh
    trainer of ``loader``'s package on the same weights loads the file and
    takes one more step: that step's weights and ``num_update``."""
    src = _dense(saver, f"{saver.__name__[-5:]}s_")
    tr = _trainer(saver, src)
    for _ in range(3):
        _adam_step(saver, src, tr)
    tmp_path.mkdir(exist_ok=True)
    sfile = str(tmp_path / "resume.states")
    tr.save_states(sfile)
    dst = _dense(loader, f"{loader.__name__[-5:]}l_")
    for (_, a), (_, b) in zip(sorted(dst.collect_params().items()),
                              sorted(src.collect_params().items())):
        a.set_data(loader.nd.array(b.data().asnumpy(), ctx=loader.cpu()))
    fresh = _trainer(loader, dst)
    fresh.load_states(sfile)
    n = fresh.optimizer.num_update
    _adam_step(loader, dst, fresh)
    return dst.weight.data().asnumpy(), n


def test_load_states_resumes_with_the_reference_numbers(tmp_path):
    """3 Adam steps on ``Dense(2, in_units=3)`` from ones, save, load into a
    fresh trainer, one more step: the same weights in both packages."""
    got, n_port = _resumed_weights(mx, mx, tmp_path / "p")
    want, n_jax = _resumed_weights(jmx, jmx, tmp_path / "j")
    assert n_port == n_jax == 3
    onp.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("saver,loader", [("port", "jax"), ("jax", "port")])
def test_states_files_move_both_ways(tmp_path, saver, loader):
    """A ``.states`` file of either package loads into the other and the
    next step gives the reference's weights."""
    got, n = _resumed_weights(PKGS[saver], PKGS[loader], tmp_path / "a")
    want, _ = _resumed_weights(jmx, jmx, tmp_path / "b")
    assert n == 3
    onp.testing.assert_allclose(got, want, rtol=1e-6)


def test_states_file_carries_bfloat16(tmp_path):
    """bfloat16 states: the JAX package's file loads into the port with the
    same bits, and the port's round trip keeps them (as
    :data:`BFLOAT16`, the ``.params`` stand-in)."""
    import pickle
    from incubator_mxnet_tpu_torch.ndarray.serialization import BFLOAT16
    jnet = jmx.gluon.nn.Dense(2, in_units=3, prefix="bfj_", dtype="bfloat16")
    jnet.initialize(init=jmx.init.One(), ctx=jmx.cpu())
    jtr = _trainer(jmx, jnet)
    x = jmx.nd.array(X, dtype="bfloat16")
    with jmx.autograd.record():
        loss = (jnet(x) * jnet(x)).sum()
    loss.backward()
    jtr.step(4)
    sfile = str(tmp_path / "bf16.states")
    jtr.save_states(sfile)
    want = {i: [onp.asarray(s, dtype="float32") for s in st]
            for i, st in jtr._states.items()}
    net = mx.gluon.nn.Dense(2, in_units=3, prefix="bfp_", dtype="bfloat16")
    net.initialize(ctx=mx.cpu())
    tr = _trainer(mx, net)
    tr.load_states(sfile)
    for i, st in tr._states.items():
        assert all(s.dtype == torch.bfloat16 for s in st)
        for s, w in zip(st, want[i]):
            onp.testing.assert_array_equal(s.float().numpy(), w)
    pfile = str(tmp_path / "port.states")
    tr.save_states(pfile)
    with open(pfile, "rb") as f:
        blob = pickle.load(f)
    assert all(a.dtype == BFLOAT16 for st in blob["states"].values()
               for a in st)
    back = _trainer(mx, net)
    back.load_states(pfile)
    for i, st in back._states.items():
        for a, b in zip(st, tr._states[i]):
            assert torch.equal(a, b)


def _inplace_outcomes(pkg):
    """Which in-place mutations each package refuses, by case name."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001  (the outcome is the check)
            out[name] = type(e).__name__

    ctx = pkg.cpu()
    x = pkg.nd.array([1.0, 2.0, 3.0], ctx=ctx)
    x.attach_grad()
    const = pkg.nd.array([4.0, 5.0, 6.0], ctx=ctx)
    with pkg.autograd.record():
        y = x * 2
        z = const + 1            # recorded, from no variable
        attempt("setitem_recorded", lambda: y.__setitem__(slice(None), 5.0))
        attempt("iadd_recorded", lambda: y.__iadd__(1.0))
        attempt("imul_recorded", lambda: z.__imul__(2.0))
        attempt("setitem_partial", lambda: y.__setitem__(0, 7.0))
        attempt("copyto_recorded", lambda: const.copyto(y))
        attempt("setitem_variable", lambda: x.__setitem__(0, 1.5))
        attempt("iadd_constant", lambda: const.__iadd__(1.0))
    attempt("setitem_after_record", lambda: y.__setitem__(slice(None), 5.0))
    with pkg.autograd.record():
        w = x * 3
    w.backward()
    with pkg.autograd.record():
        attempt("setitem_after_backward", lambda: w.__setitem__(0, 1.0))
    return out


def test_inplace_under_record_matches_reference():
    """The same cases refused (``MXNetError``) and allowed in both."""
    got, want = _inplace_outcomes(mx), _inplace_outcomes(jmx)
    assert got == want
    assert got["setitem_recorded"] == "MXNetError"
    assert got["setitem_variable"] == "ok"
    assert got["setitem_after_backward"] == "ok"


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_second_backward_keeps_gradients(grad_req):
    """``backward()`` twice on one recorded graph: each variable keeps the
    first backward's gradient, in both packages."""
    grads = {}
    for name, pkg in PKGS.items():
        x = pkg.nd.array([1.0, 2.0, 3.0], ctx=pkg.cpu())
        x.attach_grad(grad_req)
        with pkg.autograd.record():
            y = (x * x * x).sum()
        y.backward()
        first = x.grad.asnumpy().copy()
        y.backward()
        grads[name] = (first, x.grad.asnumpy().copy())
    for name, (first, second) in grads.items():
        onp.testing.assert_array_equal(second, first, err_msg=name)
    onp.testing.assert_allclose(grads["port"][1], grads["jax"][1],
                                rtol=1e-6)


def test_second_backward_of_a_gluon_loss():
    """A Gluon loss's second ``backward()`` deposits nothing new, and a
    retained graph's second backward adds under ``'add'``, as the JAX
    package's does."""
    for pkg in (mx, jmx):
        net = _dense(pkg, f"db{pkg.__name__[-5:]}_")
        for p in net.collect_params().values():
            p.grad_req = "add"
        x = pkg.nd.array(X, ctx=pkg.cpu())
        with pkg.autograd.record():
            loss = net(x).sum()
        loss.backward(retain_graph=True)
        once = net.weight.grad().asnumpy().copy()
        loss.backward()
        onp.testing.assert_allclose(net.weight.grad().asnumpy(), 2 * once,
                                    rtol=1e-6)
        loss.backward()
        onp.testing.assert_allclose(net.weight.grad().asnumpy(), 2 * once,
                                    rtol=1e-6)


def test_cpu_context_out_of_range():
    """``cpu(99)`` is a context; using it raises in both packages, with the
    reference's message."""
    for pkg in PKGS.values():
        ctx = pkg.cpu(99)
        assert str(ctx) == "cpu(99)"
        with pytest.raises(pkg.MXNetError if hasattr(pkg, "MXNetError")
                           else Exception, match="device_id out of range"):
            pkg.nd.zeros((2,), ctx=ctx)
    with pytest.raises(MXNetError, match="device_id out of range"):
        mx.nd.array([1.0], ctx=mx.cpu(99))
    assert mx.nd.zeros((2,), ctx=mx.cpu(0)).context == mx.cpu(0)
