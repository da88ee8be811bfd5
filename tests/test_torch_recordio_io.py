"""PyTorch port: ``recordio``, ``native``, ``tools.im2rec`` and the rest of
``mx.io``, held against the JAX package on the CPU.

Every comparison is exact: bytes of files, values of batches
(``numpy.testing.assert_array_equal``), draws of the chaos monkey. The JAX
``ImageRecordIter`` draws its crop and mirror from its decode threads, so
its order with two threads depends on scheduling; the port's batches are
held, with one thread and with two, against the JAX iterator with one.
"""
import filecmp
import glob
import hashlib
import os
import struct
import threading
import time

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import native as jnative
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.fault import inject as jinject
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import io as mio
from incubator_mxnet_tpu_torch import native, recordio
from incubator_mxnet_tpu_torch.fault import inject
from incubator_mxnet_tpu_torch.tools import im2rec
from tools import im2rec as jim2rec

cv2 = pytest.importorskip("cv2")

MAGIC = struct.pack("<I", 0xCED7230A)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_native(monkeypatch):
    """``MXTPU_NO_NATIVE`` set or not, in both packages."""
    def set_(on: bool):
        if on:
            monkeypatch.setenv("MXTPU_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("MXTPU_NO_NATIVE", raising=False)
    return set_


def _nd(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x.data) == len(y.data)
        for u, v in zip(x.data + (x.label or []), y.data + (y.label or [])):
            onp.testing.assert_array_equal(_nd(u), _nd(v))
        assert x.pad == y.pad


def _records():
    """Payloads: plain, one holding the magic (split by the native writer)
    twice, and an empty one; headers single- and multi-label."""
    rng = onp.random.RandomState(0)
    payloads = [b"hello", b"abc" + MAGIC + b"defgh" + MAGIC + b"!",
                rng.bytes(1001), b""]
    labels = [3.0, [1.0, 2.5, -4.0], 7.0, [0.5]]
    return payloads, labels


def test_rec_files_cross_packages_byte_identical(tmp_path, no_native):
    """``.rec``/``.idx`` written by either package are byte-identical, on
    the native writer and on the pure-Python one, and each package reads
    the other's (split records reassembled); ``pack``/``unpack`` with
    multi-label headers and ``pack_img``/``unpack_img`` agree."""
    payloads, labels = _records()
    for pure in (False, True):
        no_native(pure)
        files = {}
        for tag, mod in (("port", recordio), ("jax", jrec)):
            rec, idx = str(tmp_path / f"{tag}{pure}.rec"), \
                str(tmp_path / f"{tag}{pure}.idx")
            w = mod.MXIndexedRecordIO(idx, rec, "w")
            assert (w._nat is None) == pure
            for i, (p, lab) in enumerate(zip(payloads, labels)):
                w.write_idx(i, mod.pack(mod.IRHeader(0, lab, i, 9), p))
            w.close()
            files[tag] = (rec, idx)
        for a, b in zip(files["port"], files["jax"]):
            assert filecmp.cmp(a, b, shallow=False), (pure, a)
        for reader, (rec, idx) in ((recordio, files["jax"]),
                                   (jrec, files["port"])):
            r = reader.MXIndexedRecordIO(idx, rec, "r")
            for i in (3, 1, 0, 2):
                h, s = reader.unpack(r.read_idx(i))
                assert s == payloads[i] and h.id == i and h.id2 == 9
                onp.testing.assert_array_equal(h.label, labels[i])
            r.close()
    # the native writer split the payload holding the magic: the pure
    # writer's file is longer by nothing but the two files differ
    assert not filecmp.cmp(str(tmp_path / "portFalse.rec"),
                           str(tmp_path / "portTrue.rec"), shallow=False)
    img = onp.random.RandomState(1).randint(0, 255, (20, 30, 3)).astype(
        "uint8")
    for fmt in (".jpg", ".png"):
        head = recordio.IRHeader(0, [1.0, 2.0], 5, 0)
        s = recordio.pack_img(head, img, quality=90, img_fmt=fmt)
        assert s == jrec.pack_img(head, img, quality=90, img_fmt=fmt)
        (h1, i1), (h2, i2) = recordio.unpack_img(s), jrec.unpack_img(s)
        onp.testing.assert_array_equal(i1, i2)
        onp.testing.assert_array_equal(h1.label, h2.label)


def test_im2rec_matches_jax_tool(tmp_path, monkeypatch):
    """The port's ``im2rec`` against the JAX tool on a PNG folder: the
    shuffled train/val ``.lst`` files, and ``.rec``/``.idx`` packed with
    ``--resize`` on the native packer and on the Python one, all
    byte-identical (and the two packers' files equal)."""
    root = tmp_path / "images"
    rng = onp.random.RandomState(2)
    for c in ("cat", "dog"):
        (root / c).mkdir(parents=True)
        for k in range(4):
            img = rng.randint(0, 255, (rng.randint(18, 40),
                                       rng.randint(18, 40), 3)).astype("uint8")
            cv2.imwrite(str(root / c / f"{k}.png"), img)
    out = {}
    for tag, tool in (("port", im2rec), ("jax", jim2rec)):
        d = tmp_path / tag
        d.mkdir()
        prefix = str(d / "data")
        assert tool.main(["--list", "--shuffle", "--train-ratio", "0.75",
                          prefix, str(root)]) == 0
        for nat in ("1", "0"):
            monkeypatch.setenv("MXTPU_IM2REC_NATIVE", nat)
            for part in (prefix, prefix + "_val"):
                tool.main([part, str(root), "--resize", "16",
                           "--quality", "90"])
                for ext in (".rec", ".idx"):
                    os.replace(part + ext, f"{part}{nat}{ext}")
        out[tag] = sorted(os.listdir(d))
    assert out["port"] == out["jax"] and len(out["port"]) == 10
    for name in out["port"]:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    for part in ("data", "data_val"):
        for ext in (".rec", ".idx"):
            assert filecmp.cmp(tmp_path / "port" / f"{part}1{ext}",
                               tmp_path / "port" / f"{part}0{ext}",
                               shallow=False)
    r = recordio.MXIndexedRecordIO(str(tmp_path / "port" / "data1.idx"),
                                   str(tmp_path / "port" / "data1.rec"), "r")
    h, img = recordio.unpack_img(r.read_idx(r.keys[0]))
    assert min(img.shape[:2]) == 16 and h.label in (0.0, 1.0)
    r.close()


def test_file_iterators_match_jax(tmp_path):
    """``CSVIter``, ``LibSVMIter``, ``MNISTIter`` (idx files, one gzipped),
    ``ResizeIter`` and ``PrefetchingIter``: every batch, label and pad
    equal to the JAX iterator's (shuffles under one numpy seed)."""
    import gzip
    rng = onp.random.RandomState(3)
    data, label = tmp_path / "d.csv", tmp_path / "l.csv"
    onp.savetxt(data, rng.randn(10, 6), delimiter=",")
    onp.savetxt(label, rng.randint(0, 3, (10, 1)), delimiter=",")
    svm = tmp_path / "d.svm"
    svm.write_text("1 0:0.5 3:-1.25\n0 2:2.0\n\n1 1:1e-3 0:4\n")
    imgs, labs = tmp_path / "img-idx3-ubyte.gz", tmp_path / "lab-idx1-ubyte"
    with gzip.open(imgs, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 28, 28))
        f.write(rng.randint(0, 255, 6 * 28 * 28).astype("uint8").tobytes())
    with open(labs, "wb") as f:
        f.write(struct.pack(">II", 2049, 6))
        f.write(rng.randint(0, 10, 6).astype("uint8").tobytes())
    cases = [
        lambda io: io.CSVIter(str(data), (2, 3), label_csv=str(label),
                              batch_size=4),
        lambda io: io.CSVIter(str(data), (6,), batch_size=3, shuffle=True,
                              last_batch_handle="roll_over"),
        lambda io: io.LibSVMIter(str(svm), (4,), batch_size=2),
        lambda io: io.MNISTIter(str(imgs), str(labs), batch_size=4,
                                shuffle=True),
        lambda io: io.MNISTIter(str(imgs), str(labs), batch_size=3,
                                flat=True),
        lambda io: io.ResizeIter(io.NDArrayIter(
            onp.arange(20.0).reshape(10, 2), batch_size=4), 7),
        lambda io: io.PrefetchingIter(io.NDArrayIter(
            onp.arange(20.0).reshape(10, 2), onp.arange(10.0),
            batch_size=3)),
    ]
    with mx.cpu():
        for make in cases:
            got = []
            for io in (mio, jio):
                onp.random.seed(11)
                it = make(io)
                got.append([b for b in it])
                it.reset()
                got[-1] += [b for b in it]
            _same_batches(*got)
        with pytest.raises(mx.MXNetError, match="out of range"):
            mio.LibSVMIter(str(svm), (2,))


def _jpeg_rec(tmp_path, n=10):
    rec, idx = str(tmp_path / "im.rec"), str(tmp_path / "im.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = onp.random.RandomState(4)
    for i in range(n):
        img = rng.randint(0, 255, (rng.randint(20, 44), rng.randint(20, 44),
                                   3)).astype("uint8")
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 5), i, 0),
                                     img, quality=95))
    w.close()
    return rec, idx


def test_image_record_iter_matches_jax(tmp_path):
    """``ImageRecordIter`` with ``shuffle``, ``rand_crop``,
    ``rand_mirror``, ``resize`` and mean/std under one seed, two epochs:
    the port's batches with one and two threads equal the JAX iterator's
    with one (and, without ``resize``, undersized images resized)."""
    rec, _ = _jpeg_rec(tmp_path)
    kw = dict(data_shape=(3, 24, 24), batch_size=4, shuffle=True,
              rand_crop=True, rand_mirror=True, mean_r=120.0, mean_g=110.0,
              mean_b=100.0, std_r=60.0, std_g=55.0, std_b=50.0, seed=7)
    with mx.cpu():
        for resize in (28, -1):
            def run(io, threads):
                it = io.ImageRecordIter(rec, resize=resize,
                                        preprocess_threads=threads, **kw)
                out = list(it)
                it.reset()
                return out + list(it)
            want = run(jio, 1)
            assert len(want) == 4
            for threads in (1, 2):
                _same_batches(run(mio, threads), want)


def _stream(io, n=48, bs=4):
    """An iterator whose batch ``g`` holds ``g * bs`` in its first row."""
    return io.NDArrayIter(onp.arange(n, dtype="float32").reshape(n, 1),
                          batch_size=bs, last_batch_handle="discard")


def _globals(it, bs=4):
    return [int(_nd(b.data[0]).reshape(-1)[0]) // bs for b in it]


def test_prefetch_iter_order_errors_reset_close():
    """Strict order, ``place`` on the worker thread
    (``mx-io-device-prefetch``, the construction's context), an exception
    of ``place`` re-raised at the batch it hit and after, ``reset``,
    ``set_depth``, ``close`` joining the worker; a ``DataLoader`` as the
    wrapped iterable."""
    from incubator_mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    with mx.cpu():
        threads, ctxs = set(), set()

        def place(b):
            threads.add(threading.current_thread().name)
            ctxs.add(mx.current_context())
            return int(_nd(b.data[0])[0, 0]) // 4

        it = mio.PrefetchIter(_stream(mio), place=place, depth=3)
        assert list(it) == list(range(12))
        assert threads == {"mx-io-device-prefetch"} and ctxs == {mx.cpu()}
        assert it.set_depth(1) == 3 and it.depth == 1
        it.reset()
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        worker = it._worker
        it.close()
        assert not worker.is_alive()
        with pytest.raises(mx.MXNetError, match="closed"):
            next(it)

        def bad(b):
            g = int(_nd(b.data[0])[0, 0]) // 4
            if g == 2:
                raise ValueError("bad batch 2")
            return g

        it = mio.PrefetchIter(_stream(mio), place=bad)
        assert [next(it), next(it)] == [0, 1]
        for _ in range(2):
            with pytest.raises(ValueError, match="bad batch 2"):
                next(it)
        it.close()
        loader = DataLoader(ArrayDataset(onp.arange(10.0)), batch_size=4)
        with mio.PrefetchIter(loader) as it:
            got = [_nd(b).tolist() for b in it]
            it.reset()
            assert [_nd(b).tolist() for b in it] == got
        assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_prefetch_iter_shards_match_jax():
    """``shard``, ``shard_state`` and ``restore_shard`` (a 2-host pod
    restored on 1 host, and on its saved membership) against the JAX
    ``PrefetchIter`` on the same stream: the same batches and states."""
    def run(io):
        out = {}
        h0 = io.PrefetchIter(_stream(io)).shard(0, 2)
        h1 = io.PrefetchIter(_stream(io)).shard(1, 2)
        out["h0"] = [_globals([next(h0)])[0] for _ in range(3)]
        out["h1"] = [_globals([next(h1)])[0] for _ in range(3)]
        state = h0.shard_state()
        out["state"] = (state, h1.shard_state())
        h0.close(), h1.close()
        one = io.PrefetchIter(_stream(io)).restore_shard(state, 0, 1)
        out["one"] = _globals(one)
        out["one_state"] = one.shard_state()
        again = io.PrefetchIter(_stream(io)).restore_shard(state)
        out["again"] = _globals(again)
        again.reset()
        out["reset"] = _globals(again)
        with pytest.raises(Exception, match="invalid shard view"):
            again.shard(2, 2)
        return out
    with mx.cpu():
        got = run(mio)
    assert got == run(jio)
    assert got["one"] == list(range(6, 12))


@pytest.mark.chaos
def test_prefetch_iter_slow_input_chaos():
    """The ``slow_input`` chaos site delays the worker before each pull:
    the monkey's draws equal the JAX monkey's under one seed, and every
    fired draw shows as the consumer's wait."""
    logs, waits = [], []
    for io, inj in ((mio, inject), (jio, jinject)):
        with mx.cpu(), inj.chaos(seed=3, slow_input=0.5,
                                 delay_s=0.05) as monkey:
            it = io.PrefetchIter(_stream(io, n=24), depth=1)
            w = []
            for _ in range(6):
                t0 = time.perf_counter()
                next(it)
                w.append(time.perf_counter() - t0)
            it.close()
        logs.append([e for e in monkey.log if e[0] == "slow_input"])
        waits.append(w)
    assert logs[0] == logs[1]
    fired = [f for _, f in logs[0]]
    assert 0 < sum(fired) < len(fired)
    assert waits[0][0] >= 0.04 if fired[0] else True
    assert sum(waits[0]) >= 0.04 * sum(fired[:6])


def test_native_shim_builds_in_build_dir_and_matches_jax(tmp_path):
    """The shim builds into ``build/native/`` (``native/libmxtpu_native.so``
    left byte-unchanged); ``ShmSegment`` across handles (an attached
    handle unlinks); ``NativeEngine`` ordering, concurrency and a task's
    exception at ``wait_all``; ``index_build``; ``.params`` containers
    read by the JAX shim."""
    committed = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "libmxtpu_native.so")

    def digest():
        if not os.path.exists(committed):
            return None
        with open(committed, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    assert native.available()
    path = native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build" and path.is_file()
    assert digest() == before
    cases = {}
    name = f"/mxtpu_t_{os.getpid()}_{time.time_ns() % 10**9}"
    seg = native.ShmSegment(name, 4096)
    seg.as_numpy((32,), "float32")[:] = onp.arange(32)
    other = native.ShmSegment(name, 4096, create=False)
    cases["shm"] = (other.as_numpy((32,), "float32") == onp.arange(32)).all()
    other.close(unlink=True)
    cases["unlinked"] = not os.path.exists("/dev/shm" + name)
    seg.close()
    eng = native.NativeEngine(4)
    v = eng.new_var()
    out = []
    for i in range(50):
        eng.push(lambda i=i: out.append(i), write_vars=[v])
    log = []
    for i in range(2):
        eng.push(lambda i=i: (time.sleep(0.05), log.append(("r", i))),
                 read_vars=[v])
    eng.push(lambda: log.append(("w", 0)), write_vars=[v])
    t0 = time.time()
    for _ in range(4):
        eng.push(lambda: time.sleep(0.15), write_vars=[eng.new_var()])
    eng.wait_all()
    cases["write_order"] = out == list(range(50))
    cases["writer_after_readers"] = log[2] == ("w", 0)
    cases["independent_parallel"] = time.time() - t0 < 0.45

    def boom():
        raise RuntimeError("kaboom-async")
    eng.push(boom, write_vars=[v])
    eng.push(lambda: out.append("after"), write_vars=[v])
    with pytest.raises(RuntimeError, match="kaboom-async"):
        eng.wait_all()
    cases["dependents_ran"] = out[-1] == "after"
    eng.close()
    rec = str(tmp_path / "n.rec")
    w = native.NativeRecordWriter(rec)
    offs = [w.write(b"one"), w.write(b"x" + MAGIC + b"y"), w.write(b"")]
    w.close()
    cases["index_build"] = native.index_build(rec) == \
        jnative.index_build(rec) == offs
    arrays = [onp.arange(6, dtype="float32").reshape(2, 3),
              onp.arange(4, dtype="int32")]
    params = str(tmp_path / "p.params")
    native.params_save(params, arrays, ["a", "b"], [0, 4])
    got = jnative.params_load(params)
    cases["params"] = got == native.params_load(params) and \
        got[1] == ["a", "b"] and got[0][0] == ((2, 3), arrays[0].tobytes())
    assert all(cases.values()), cases
    assert not glob.glob("/dev/shm" + name + "*")
