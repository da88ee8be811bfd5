"""PyTorch port: ``serve.Server`` and its JSON-lines wire protocol on the
CPU, held against the JAX package's server and clients.

- Wire parity both ways: the JAX ``client_call`` against the port's
  ``Server`` and the port's ``client_call`` against the JAX ``Server``
  give replies with the same keys (predict, a pinned version, a carried
  trace context, ``models``, ``metrics``, an error), and outputs within
  1e-5 of each other (float32; the two packages sum in another order).
  The JAX server's head sampling is off here, so an untraced request
  carries no ``trace_id`` from either (the port's tracer waits for the
  telemetry port).
- ``prometheus`` and ``telemetry`` reply with a structured error naming
  ROADMAP item 8; a router-backed server answers with the replica's
  name, refuses a pinned version, and sheds with ``retry_after``; a
  timeout is a structured ``deadline_exceeded`` reply.
- ``generate`` over TCP (either package's ``client_generate``) gives the
  in-process ``DecodeBatcher``'s tokens; a ``TokenRateBudget`` sheds an
  over-budget tenant on the wire; ``decode_replica_death`` fails every
  active and queued stream with ``ReplicaUnavailable`` and the next
  request is served (the JAX ``tests/test_decode.py:390-460``).
"""
import threading

import numpy as onp
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.telemetry import trace as jtrace

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, nd, serve
from incubator_mxnet_tpu_torch.convert import params_from_jax
from incubator_mxnet_tpu_torch.fault import inject

from test_torch_nmt_common import (  # noqa: F401  (fixtures)
    engine, one_torch_thread, prompt)

HOST = "127.0.0.1"
ATOL = 1e-5
TOKENS = [5, 9, 3, 11, 4]


def _mlp(pkg, prefix):
    net = pkg.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.nn.Dense(16, activation="relu", in_units=8))
        net.add(pkg.nn.Dense(4, in_units=16))
    return net


@pytest.fixture(scope="module")
def wire():
    """The same MLP weights behind a JAX and a port registry server."""
    jmx.random.seed(0)
    jnet = _mlp(jgluon, "wire_")
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jnd.array(onp.zeros((2, 8), "float32")))
    with mx.cpu():
        net = _mlp(gluon, "wire_")
        net.initialize()
        net(nd.array(onp.zeros((2, 8), "float32")))
    params_from_jax(net, {k: p.data().asnumpy()
                          for k, p in jnet.collect_params().items()})
    kw = dict(input_axes=[{0: "batch"}], output_axes=[{0: "batch"}])
    jreg = jserve.ModelRegistry()
    jreg.load("mlp", table=jserve.BucketTable({"batch": (1, 2)}),
              factory=lambda: jnet, analyze=False, **kw)
    reg = serve.ModelRegistry()
    reg.load("mlp", table=serve.BucketTable({"batch": (1, 2)}),
             factory=lambda: net, **kw)
    jtrace.set_sample_rate(0.0)
    jsrv = jserve.Server(jreg, max_delay_ms=2).start()
    srv = serve.Server(reg, max_delay_ms=2).start()
    yield {"net": net, "reg": reg, "jsrv": jsrv, "srv": srv}
    srv.stop()
    jsrv.stop()
    jtrace.set_sample_rate(None)


def test_wire_parity_both_ways(wire):
    rng = onp.random.RandomState(0)
    x = rng.randn(8).astype("float32")
    port, jax_port = wire["srv"].port, wire["jsrv"].port
    trace = {"trace_id": "ab" * 16, "span_id": "cd" * 8, "sampled": False}
    cases = [
        {"model": "mlp", "inputs": [x.tolist()]},
        {"model": "mlp", "inputs": [x.tolist()], "dtypes": ["float32"],
         "version": 1},
        {"model": "mlp", "inputs": [x.tolist()], "trace": trace},
        {"model": "ghost", "inputs": []},
        {"cmd": "models"},
        {"cmd": "metrics", "model": "mlp"},
    ]
    for payload in cases:
        a = jserve.client_call(HOST, port, payload)       # JAX -> port
        b = serve.client_call(HOST, jax_port, payload)    # port -> JAX
        assert set(a) == set(b), (payload, a, b)
        assert a["ok"] == b["ok"]
        if "inputs" in payload and a["ok"]:
            got, want = (onp.asarray(r["outputs"][0], "float32")
                         for r in (a, b))
            assert got.shape == want.shape == (4,)
            onp.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        if "trace" in payload:
            assert a["trace_id"] == b["trace_id"] == trace["trace_id"]
        if payload.get("cmd") == "models":
            assert a == b == {"ok": True, "models": {"mlp": [1]}}
        if payload.get("cmd") == "metrics":
            assert set(a["metrics"]) == set(b["metrics"])
            assert a["metrics"]["compile_cache"]["post_warmup_compiles"] \
                == 0
    with mx.cpu():
        want = wire["net"](nd.array(x[None])).asnumpy()[0]
    got = serve.client_call(HOST, port, cases[0])["outputs"][0]
    onp.testing.assert_allclose(got, want, rtol=1e-6)


def test_deferred_and_unknown_commands_reply_structurally(wire):
    port = wire["srv"].port
    for cmd in ("prometheus", "telemetry"):
        r = serve.client_call(HOST, port, {"cmd": cmd})
        assert r["ok"] is False and "item 8" in r["error"]
    r = serve.client_call(HOST, port, {"cmd": "nope"})
    assert r["ok"] is False and "unknown cmd" in r["error"]


def test_timeout_is_a_structured_reply(wire, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_REQUEST_TIMEOUT_S", "0.2")
    cm = wire["reg"].get("mlp")
    real, release = cm.predict, threading.Event()

    def wedged(*args):
        release.wait(10)
        return real(*args)

    cm.predict = wedged
    try:
        r = serve.client_call(HOST, wire["srv"].port,
                              {"model": "mlp", "inputs": [[0.0] * 8]})
    finally:
        release.set()
        cm.predict = real
    assert r["ok"] is False and r["error"] == "deadline_exceeded"
    assert r["timeout_s"] == 0.2 and r["retry_after"] > 0


def test_router_backed_server(wire):
    net = wire["net"]

    def loader(rep):
        rep.load("mlp", table=serve.BucketTable({"batch": (1, 2)}),
                 input_axes=[{0: "batch"}], factory=lambda: net)

    reps = [serve.Replica(f"r{i}", loader, max_delay_ms=2) for i in (0, 1)]
    router = serve.Router(reps, heartbeat_ms=40, tenant_inflight=1).start()
    srv = serve.Server(router=router).start()
    x = onp.ones((8,), "float32")
    try:
        r = serve.client_call(HOST, srv.port,
                              {"model": "mlp", "inputs": [x.tolist()]})
        assert r["ok"] and r["replica"] in ("r0", "r1")
        with mx.cpu():
            want = net(nd.array(x[None])).asnumpy()[0]
        onp.testing.assert_allclose(r["outputs"][0], want, rtol=1e-6)
        r = serve.client_call(HOST, srv.port, {"model": "mlp", "version": 1,
                                               "inputs": [x.tolist()]})
        assert r["ok"] is False and "version pinning" in r["error"]
        with router._lock:
            router._inflight["t0"] = 1
        r = jserve.client_call(HOST, srv.port, {"model": "mlp",
                                                "tenant": "t0",
                                                "inputs": [x.tolist()]})
        assert r["ok"] is False and r["error"].startswith("ShedError")
        assert r["retry_after"] > 0
        m = serve.client_call(HOST, srv.port, {"cmd": "models"})
        assert m["models"]["router"]["stats"]["shed"] == 1
    finally:
        srv.stop()
        router.stop()


def test_generate_over_tcp_gives_the_in_process_tokens(engine):
    batcher = serve.DecodeBatcher(engine).start()
    srv = serve.Server(serve.ModelRegistry()).start()
    try:
        srv.attach_decoder("nmt", batcher)
        want = batcher.submit(onp.asarray(TOKENS, "int32"),
                              max_new_tokens=6).result(timeout=60)
        payload = {"model": "nmt", "tokens": TOKENS, "max_new_tokens": 6}
        for client in (serve.client_generate, jserve.client_generate):
            docs = list(client(HOST, srv.port, payload))
            assert all(d["ok"] for d in docs) and docs[-1]["done"]
            assert [d["token"] for d in docs[:-1]] == want
            assert [d["i"] for d in docs[:-1]] == list(range(len(want)))
            assert docs[-1]["tokens"] == want
            assert docs[-1]["reason"] in ("eos", "length")
        r = serve.client_call(HOST, srv.port, {"cmd": "generate",
                                               "model": "ghost",
                                               "tokens": TOKENS})
        assert r["ok"] is False and "attach_decoder" in r["error"]
    finally:
        srv.stop()
        batcher.stop()


def test_token_budget_sheds_on_the_wire(engine):
    qos = serve.TokenRateBudget(tokens_per_s=1, burst=8)
    batcher = serve.DecodeBatcher(engine, qos=qos).start()
    srv = serve.Server(serve.ModelRegistry()).start()
    try:
        srv.attach_decoder("nmt", batcher)
        payload = {"model": "nmt", "tokens": TOKENS, "max_new_tokens": 8,
                   "tenant": "t1"}
        first = list(serve.client_generate(HOST, srv.port, payload))
        assert first[-1]["done"]
        shed = list(serve.client_generate(HOST, srv.port, payload))
        assert len(shed) == 1 and shed[0]["ok"] is False
        assert shed[0]["error"].startswith("ShedError")
        assert shed[0]["retry_after"] > 0
        other = list(serve.client_generate(
            HOST, srv.port, dict(payload, tenant="t2", max_new_tokens=4)))
        assert other[-1]["done"]
        assert batcher.metrics.snapshot()["shed"] == 1
    finally:
        srv.stop()
        batcher.stop()


def test_decode_replica_death_fails_streams_then_serves(engine):
    engine.reset_cache()
    rng = onp.random.RandomState(3)
    batcher = serve.DecodeBatcher(engine)
    # two streams take the batch rows, the third waits in the queue
    streams = [batcher.submit(prompt(rng), max_new_tokens=10)
               for _ in range(3)]
    with inject.chaos(seed=7, decode_replica_death=1.0):
        batcher.start()
        for s in streams:
            with pytest.raises(serve.ReplicaUnavailable):
                s.result(timeout=30)
    try:
        assert batcher.active_sequences() == 0 and batcher.depth() == 0
        assert engine.pool.active_sequences() == 0
        nxt = batcher.submit(prompt(rng), max_new_tokens=4).result(timeout=60)
        assert 1 <= len(nxt) <= 4
        assert batcher.metrics.snapshot()["failed"] == 3
    finally:
        batcher.stop()
