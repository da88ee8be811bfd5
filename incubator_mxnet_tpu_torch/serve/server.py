"""Server: in-process and TCP front ends over the registry or the router.

Counterpart: the JAX package's ``serve/server.py`` (``Server`` ``:75``,
``client_call`` ``:381``, ``client_generate`` ``:407``). The wire protocol
is the JAX package's, byte for byte: newline-delimited JSON over TCP, one
object per request, so either package's client talks to either server::

    {"model": "bert", "inputs": [[...nested lists...], ...],
     "dtypes": ["int32", ...], "version": 2}        # version optional
    -> {"ok": true, "outputs": [...], "latency_ms": 1.8}

    {"cmd": "metrics", "model": "bert"}  -> {"ok": true, "metrics": {...}}
    {"cmd": "models"}                    -> {"ok": true, "models": {...}}

Generation streams one reply line per token from an attached
:class:`~.decode.DecodeBatcher` (:meth:`Server.attach_decoder`), then a
terminal ``done`` line::

    {"cmd": "generate", "model": "nmt", "tokens": [5, 9, 3],
     "max_new_tokens": 16, "tenant": "t1"}
    -> {"ok": true, "token": 7, "i": 0}
    -> {"ok": true, "done": true, "reason": "eos", "tokens": [7, 2],
        "latency_ms": 12.1}

Errors are structured replies (``{"ok": false, "error": "Type: msg"}``),
with ``retry_after`` on a shed or a timeout. A :class:`Server` fronts one
:class:`~.registry.ModelRegistry` (one ``DynamicBatcher`` per model whose
thunk resolves through the registry at flush time, so a version swap
redirects the next batch), or, with ``router=``, the HA tier: predicts go
through :meth:`Router.call_detailed` (failover, hedging, admission), and a
version-pinned request is refused. A request's ``trace`` context comes
back as the reply's ``trace_id``; the spans under it, and the
``prometheus`` and ``telemetry`` commands, wait for the ``telemetry`` port
(ROADMAP queue A, item 8): those commands reply with a structured error
naming it.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Dict, Optional

import numpy as onp

from ..base import MXNetError
from ..lockcheck import make_lock
from ..util import getenv
from .batcher import DynamicBatcher, ServeFuture, make_registry_batcher
from .registry import ModelRegistry

__all__ = ["Server", "client_call", "client_generate"]

_TELEMETRY_LATER = ("waits for the port's telemetry subsystem (ROADMAP "
                    "queue A, item 8)")


class Server:
    """Serve every model of ``registry``: in-process through
    :meth:`submit`, over TCP after :meth:`start` (``port=0`` picks a free
    port; read it back from ``server.port``). With ``router=`` the predict
    path goes through the HA tier instead of a local batcher (JAX
    counterpart: ``serve/server.py:75``)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1",
                 port: int = 0, max_delay_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None, router=None):
        if registry is None and router is None:
            raise MXNetError("Server needs a registry or a router")
        self.registry = registry
        self.router = router
        self.host = host
        self.port = port
        self._batcher_kw = dict(max_delay_ms=max_delay_ms,
                                queue_limit=queue_limit)
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._decoders: Dict[str, object] = {}
        self._lock = make_lock("Server._lock")
        self._tcp: Optional[socketserver.ThreadingTCPServer] = None
        self._tcp_thread: Optional[threading.Thread] = None

    # -- in-process path ------------------------------------------------
    def batcher(self, name: str) -> DynamicBatcher:
        if self.registry is None:
            raise MXNetError(
                "router-backed Server has no local batchers — submit "
                "through the wire protocol or Router.call instead")
        with self._lock:
            b = self._batchers.get(name)
            if b is None:
                b = make_registry_batcher(self.registry, name,
                                          **self._batcher_kw)
                self._batchers[name] = b
        return b

    def submit(self, name: str, *arrays) -> ServeFuture:
        """Enqueue one single-example request for ``name``'s active
        version; returns the future."""
        return self.batcher(name).submit(*arrays)

    def attach_decoder(self, name: str, batcher) -> None:
        """Expose a started :class:`~.decode.DecodeBatcher` as model
        ``name`` for the ``generate`` command (a decoder wraps a live model
        and engine, so it attaches instead of loading through the
        registry)."""
        with self._lock:
            self._decoders[name] = batcher

    def decoder(self, name: str):
        with self._lock:
            b = self._decoders.get(name)
        if b is None:
            raise MXNetError(
                f"no decoder attached for model {name!r}; call "
                "Server.attach_decoder(name, DecodeBatcher) first")
        return b

    def metrics(self, name: str) -> dict:
        b = self.batcher(name)
        return b.metrics.snapshot(self.registry.get(name))

    # -- TCP front end --------------------------------------------------
    def start(self) -> "Server":
        if self._tcp is not None:
            return self
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        reply = outer._handle_line(line)
                    except Exception as e:  # noqa: BLE001 — wire boundary
                        reply = {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"}
                        # shed and overload errors carry a backoff hint
                        retry_after = getattr(e, "retry_after", None)
                        if retry_after is not None:
                            reply["retry_after"] = retry_after
                        trace_id = getattr(e, "trace_id", None)
                        if trace_id is not None:
                            reply["trace_id"] = trace_id
                    # a generate stream is an iterator of replies, each
                    # written and flushed as its token lands
                    replies = [reply] if isinstance(reply, dict) else reply
                    for doc in replies:
                        self.wfile.write(
                            (json.dumps(doc) + "\n").encode("utf-8"))
                        self.wfile.flush()

        class TCP(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # socketserver's backlog of 5 drops the connects of a burst of
            # clients, which then wait out TCP's SYN retries (1 s, 3 s ...)
            request_queue_size = 128

        self._tcp = TCP((self.host, self.port), Handler)
        self.port = self._tcp.server_address[1]
        self._tcp_thread = threading.Thread(
            target=self._tcp.serve_forever, name="mx-serve-tcp", daemon=True)
        self._tcp_thread.start()
        return self

    def stop(self) -> None:
        if self._tcp is not None:
            self._tcp.shutdown()
            self._tcp.server_close()
            self._tcp = None
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
            # attached decoders belong to their caller: detach only
            self._decoders.clear()
        for b in batchers:
            b.stop()

    # -- protocol -------------------------------------------------------
    def _handle_line(self, line: bytes):
        msg = json.loads(line.decode("utf-8"))
        cmd = msg.get("cmd")
        if cmd == "models":
            if self.registry is None:
                return {"ok": True,
                        "models": {"router": self.router.snapshot()}}
            return {"ok": True, "models": self.registry.models()}
        if cmd == "metrics":
            if self.registry is None:
                return {"ok": True,
                        "metrics": {"router": self.router.snapshot()}}
            return {"ok": True, "metrics": self.metrics(msg["model"])}
        if cmd in ("prometheus", "telemetry"):
            return {"ok": False, "cmd": cmd,
                    "error": f"the {cmd} command {_TELEMETRY_LATER}"}
        if cmd == "generate":
            return self._generate(msg)
        if cmd is not None:
            raise MXNetError(f"unknown cmd {cmd!r}")
        # a carried trace context is echoed as the reply's trace_id (the
        # JAX server's spans under it wait for the telemetry port)
        trace = msg.get("trace")
        tid = trace.get("trace_id") if isinstance(trace, dict) else None
        try:
            reply = self._predict(msg)
        except Exception as e:
            if isinstance(tid, str) and tid:
                e.trace_id = tid
            raise
        if isinstance(tid, str) and tid:
            reply.setdefault("trace_id", tid)
        return reply

    def _generate(self, msg: dict):
        """One generation stream: submit to the attached decoder and return
        a generator of wire replies, one per token as it lands, then a
        terminal ``done`` doc. Submit-time sheds (a full queue, a tenant
        over its tokens/sec budget) raise here and reach the client as the
        usual structured error with ``retry_after``."""
        name = msg["model"]
        b = self.decoder(name)
        stream = b.submit(
            onp.asarray(msg["tokens"], "int32"),
            valid_len=msg.get("valid"),
            max_new_tokens=msg.get("max_new_tokens"),
            tenant=msg.get("tenant"))
        timeout_s = float(getenv("MXTPU_SERVE_REQUEST_TIMEOUT_S"))
        t0 = time.perf_counter()

        def _replies():
            i = 0
            try:
                while True:
                    tok = stream.next_token(timeout=timeout_s)
                    if tok is None:
                        break
                    yield {"ok": True, "token": tok, "i": i}
                    i += 1
            except Exception as e:  # noqa: BLE001 — wire boundary
                doc = {"ok": False, "error": f"{type(e).__name__}: {e}",
                       "model": name}
                retry_after = getattr(e, "retry_after", None)
                if retry_after is None:
                    retry_after = b.retry_after_s()
                doc["retry_after"] = retry_after
                yield doc
                return
            yield {"ok": True, "done": True,
                   "reason": stream.finish_reason(),
                   "tokens": stream.tokens(),
                   "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)}

        return _replies()

    def _predict(self, msg: dict) -> dict:
        name = msg["model"]
        version = msg.get("version")
        dtypes = msg.get("dtypes")
        t0 = time.perf_counter()
        if self.registry is None:
            # HA mode: the router owns placement, failover and shedding.
            # Wire floats default to float32 (no model signature to read
            # here; float64 would miss every bucket)
            if version is not None:
                raise MXNetError(
                    f"version pinning (version={version!r}) is not "
                    "supported by the router-backed tier; replicas "
                    "serve the active version only")
            arrays = []
            for i, payload in enumerate(msg["inputs"]):
                dtype = dtypes[i] if dtypes and i < len(dtypes) else None
                a = onp.asarray(payload, dtype=dtype)
                if dtype is None and a.dtype == onp.float64:
                    a = a.astype(onp.float32)
                arrays.append(a)
            val, info = self.router.call_detailed(name, *arrays,
                                                  tenant=msg.get("tenant"))
            result = val if isinstance(val, tuple) else (val,)
            return {"ok": True,
                    "outputs": [onp.asarray(r).tolist() for r in result],
                    "replica": info["replica"],
                    "latency_ms": round((time.perf_counter() - t0) * 1e3,
                                        3)}
        model = self.registry.get(name, version)
        arrays = []
        for i, payload in enumerate(msg["inputs"]):
            dtype = (dtypes[i] if dtypes and i < len(dtypes)
                     else model._in_avals[i][1])
            arrays.append(onp.asarray(payload, dtype=dtype))
        if version is not None:
            # a pinned request bypasses the shared batcher (which serves
            # the active version)
            outs = model.predict(*[a[None] for a in arrays])
            outs = outs if isinstance(outs, tuple) else (outs,)
            result = tuple(o.asnumpy()[0] for o in outs)
        else:
            b = self.batcher(name)
            fut = b.submit(*arrays)
            timeout_s = float(getenv("MXTPU_SERVE_REQUEST_TIMEOUT_S"))
            try:
                result = fut.result(timeout=timeout_s)
            except TimeoutError:
                # a structured, retryable reply: a deadline miss is an
                # operational state, not a stack trace
                return {"ok": False, "error": "deadline_exceeded",
                        "model": name, "timeout_s": timeout_s,
                        "retry_after": b.retry_after_s()}
            if not isinstance(result, tuple):
                result = (result,)
        return {"ok": True,
                "outputs": [r.tolist() for r in result],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 3)}


def client_call(host: str, port: int, payload: dict,
                timeout: float = 30.0) -> dict:
    """A blocking client for the JSON-lines protocol: one request, one
    reply (JAX counterpart: ``serve/server.py:381``)."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError(
                    f"server closed the connection before a complete "
                    f"reply ({len(buf)} bytes received)")
            buf += chunk
    return json.loads(buf.decode("utf-8"))


def client_generate(host: str, port: int, payload: dict,
                    timeout: float = 60.0):
    """A streaming client for ``generate``: yields the server's reply
    lines, one ``{"ok": true, "token": t, "i": n}`` per token as it
    arrives, then the terminal ``done`` doc (or one structured error).
    ``payload`` needs ``model`` and ``tokens``; ``cmd`` is filled in (JAX
    counterpart: ``serve/server.py:407``)."""
    payload = dict(payload)
    payload.setdefault("cmd", "generate")
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        with sock.makefile("rb") as rf:
            for line in rf:
                doc = json.loads(line.decode("utf-8"))
                yield doc
                if not doc.get("ok") or doc.get("done"):
                    return
    raise ConnectionError("server closed the generate stream before the "
                          "terminal done/error line")
