"""PyTorch port: ``gluon.data`` (datasets, samplers, transforms, the
``DataLoader``), the vision datasets, ``image``'s ``path_imgrec``, the
image-classification example's ``--rec`` and the bucketed BERT loop,
held against the JAX package on the CPU.

Comparisons are bitwise (``numpy.testing.assert_array_equal``): both
packages compute these on numpy in the same order. The JAX
``RecordFileDataset`` and ``ImageRecordDataset`` raise ``AttributeError``
(they call ``recordio.IndexedRecordIO``, which the JAX ``recordio`` does
not have); the port's are held against what the JAX
``MXIndexedRecordIO.read_idx`` and ``recordio.unpack_img`` give for the
same records, and the JAX error is pinned, so the day it is repaired the
comparison can become direct. The example's loss is checked finite; the
bucketed BERT resume is bitwise against a run never interrupted.
"""
import glob
import os
import random as pyrandom
import signal
import struct
import threading

import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import image as jimage
from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu.gluon.data.vision import transforms as jT
import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import image, io, models, parallel
from incubator_mxnet_tpu_torch.gluon import data as gdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as T
from incubator_mxnet_tpu_torch.models import bert_pretraining as bp
from incubator_mxnet_tpu_torch.models import image_classification as ic

cv2 = pytest.importorskip("cv2")
jdata = jgluon.data


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six pytest workers side by side: keep PyTorch to one
    intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(a, b):
    """Equal trees of arrays (lists, tuples, NDArrays, numpy, scalars)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    onp.testing.assert_array_equal(_np(a), _np(b))


def _write_rec(path, n, size=(20, 44), det=False, seed=0):
    """A JPEG ``.rec``/``.idx`` written by the JAX package; with ``det``,
    header labels in the flat detection format."""
    rec, idx = str(path / "r.rec"), str(path / "r.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = onp.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 255, (rng.randint(*size), rng.randint(*size),
                                   3)).astype("uint8")
        if det:
            boxes = onp.sort(rng.rand(2, 2, 2), axis=-1)
            lab = [2.0, 5.0] + sum(([float(i % 3), b[0, 0], b[1, 0], b[0, 1],
                                     b[1, 1]] for b in boxes), [])
        else:
            lab = float(i % 4)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, lab, i, 0), img))
    w.close()
    return rec, idx


def test_datasets_match_jax(tmp_path):
    """``Dataset`` operations (``filter``, ``shard``, ``take``, lazy and
    eager ``transform``, ``transform_first``), ``SimpleDataset`` and
    ``ArrayDataset`` against the JAX ones; ``RecordFileDataset`` against
    the JAX ``MXIndexedRecordIO.read_idx`` of the same file, with the JAX
    constructors' ``AttributeError`` pinned."""
    rng = onp.random.RandomState(0)
    x = rng.randn(11, 3).astype("float32")
    y = onp.arange(11)

    def views(d):
        return [list(d), list(d.filter(lambda s: s[1] % 3 == 0)),
                list(d.shard(3, 1)), list(d.shard(3, 2)), list(d.take(4)),
                list(d.transform(lambda a, b: a * b)),
                list(d.transform(lambda a, b: (a + 1, b), lazy=False)),
                list(d.transform_first(lambda a: -a)),
                [len(d), len(d.take(40))]]

    _same(views(gdata.ArrayDataset(x, y)), views(jdata.ArrayDataset(x, y)))
    with mx.cpu():
        _same(views(gdata.ArrayDataset(mx.nd.array(x), y)),
              views(jdata.ArrayDataset(x, y)))
    _same(list(gdata.SimpleDataset([3, 1, 2]).transform(lambda v: v * 2)),
          list(jdata.SimpleDataset([3, 1, 2]).transform(lambda v: v * 2)))
    with pytest.raises(ValueError, match="same length"):
        gdata.ArrayDataset(x, y[:3])
    rec, idx = _write_rec(tmp_path, 6)
    ds = gdata.RecordFileDataset(rec)
    ref = jrec.MXIndexedRecordIO(idx, rec, "r")
    assert len(ds) == len(ref.keys) == 6
    for i in (4, 0, 5, 2):
        assert ds[i] == ref.read_idx(ref.keys[i])
    for cls in (jdata.RecordFileDataset, jdata.vision.ImageRecordDataset):
        with pytest.raises(AttributeError, match="IndexedRecordIO"):
            cls(rec)


def test_samplers_match_jax():
    """``SequentialSampler``, ``RandomSampler``, ``BatchSampler`` (keep,
    discard, rollover over two passes) and ``FixedBucketSampler``
    (``bucket_keys``, ``ratio``, default keys, ``shuffle``, ``stats``)
    against the JAX ones under one ``numpy.random.seed``."""
    lengths = onp.random.RandomState(1).randint(3, 40, 50)

    def run(d):
        onp.random.seed(5)
        out = [list(d.SequentialSampler(5, start=2)),
               list(d.RandomSampler(9)), list(d.RandomSampler(9))]
        for last in ("keep", "discard", "rollover"):
            bs = d.BatchSampler(d.RandomSampler(10), 4, last)
            out += [list(bs), len(bs), list(bs), len(bs)]
        for kw in ({"bucket_keys": [10, 20, 40]}, {"ratio": 0.5},
                   {"num_buckets": 4, "shuffle": True},
                   {"bucket_keys": [15, 40], "shuffle": True}):
            s = d.FixedBucketSampler(lengths, 6, **kw)
            out += [list(s), list(s), len(s), s.bucket_keys, s.stats()]
        return out

    assert run(gdata) == run(jdata)
    with pytest.raises(ValueError, match="last_batch"):
        list(gdata.BatchSampler(gdata.SequentialSampler(5), 2, "drop"))


def test_transforms_match_jax():
    """Each of the 14 transforms (and ``Compose`` of them) on an image
    under one numpy seed: output and dtype equal to the JAX transform's;
    an ``NDArray`` input read to the host."""
    img = onp.random.RandomState(2).randint(0, 255, (30, 26, 3)).astype(
        "uint8")
    chw = onp.random.RandomState(3).rand(3, 8, 8).astype("float32")

    def cases(t):
        return [
            (t.Cast("float16"), img), (t.ToTensor(), img),
            (t.ToTensor(), onp.stack([img, img])),
            (t.Normalize([0.1, 0.2, 0.3], [0.5, 0.6, 0.7]), chw),
            (t.Normalize(0.5, 2.0), chw), (t.Resize(16), img),
            (t.Resize((20, 12)), img), (t.CenterCrop(12), img),
            (t.CenterCrop((40, 10)), img), (t.RandomCrop(12), img),
            (t.RandomCrop((10, 14), pad=3), img),
            (t.RandomResizedCrop(16), img),
            (t.RandomResizedCrop((12, 18), scale=(0.5, 0.9)), img),
            (t.RandomFlipLeftRight(), img), (t.RandomFlipTopBottom(), img),
            (t.RandomBrightness(0.4), img), (t.RandomContrast(0.3), img),
            (t.RandomSaturation(0.3), img), (t.RandomLighting(0.1), img),
            (t.Compose([t.RandomResizedCrop(16), t.RandomFlipLeftRight(),
                        t.ToTensor(), t.Normalize(0.4, 0.2),
                        lambda v: v * 2]), img)]

    def run(t, wrap=lambda a: a):
        onp.random.seed(9)
        out = []
        for tr, x in cases(t):
            for _ in range(3):
                out.append(tr(wrap(x)))
        return out

    want = run(jT)
    got = run(T)
    assert all(isinstance(g, onp.ndarray) for g in got)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    _same(got, want)
    with mx.cpu():
        _same(run(T, mx.nd.array), want)


class _Dies:
    """A dataset whose sample 5 kills the process reading it."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return onp.float32(i)


def _pairs(samples):
    """A custom batchify: numpy arrays, the labels doubled."""
    return [onp.stack([s[0] for s in samples]),
            onp.array([s[1] * 2 for s in samples])]


def _segments(pids):
    return [p for pid in pids for p in glob.glob(f"/dev/shm/mxtpu_dl_{pid}_*")]


def test_dataloader_matches_jax(monkeypatch):
    """The ``DataLoader`` with 0 workers, 2 forked workers over shared
    memory and over the pipe, a thread pool, a custom ``batchify_fn``,
    ``shuffle`` and each ``last_batch``: batches equal to the JAX loader's
    with 0 workers. An abandoned multi-worker iterator leaves no segment,
    and a loader closed under an abandoned pass over the pipe stops; a
    worker that dies raises instead of hanging."""
    rng = onp.random.RandomState(4)
    imgs = rng.randint(0, 255, (22, 8, 8, 3)).astype("uint8")
    labels = onp.arange(22).astype("float32")

    def dataset(d, t):
        return d.ArrayDataset(imgs, labels).transform_first(
            t.Compose([t.CenterCrop(6), t.ToTensor(),
                       t.Normalize([0.5, 0.4, 0.3], [0.2, 0.2, 0.3])]))

    def passes(d, t, **kw):
        loader = d.DataLoader(dataset(d, t), **kw)
        out = []
        for _ in range(2):
            onp.random.seed(3)
            out.append(list(loader))
        if hasattr(loader, "close"):
            loader.close()
        return out

    configs = [dict(batch_size=5, shuffle=True),
               dict(batch_size=5, last_batch="discard"),
               dict(batch_size=5, last_batch="rollover", shuffle=True),
               dict(batch_size=4, batchify_fn=_pairs)]
    with mx.cpu():
        for cfg in configs:
            want = passes(jdata, jT, **cfg)
            for extra, shm in (({}, "1"), ({"num_workers": 2}, "1"),
                               ({"num_workers": 2}, "0"),
                               ({"num_workers": 2, "thread_pool": True}, "1"),
                               ({"pin_memory": True, "prefetch": 1}, "1")):
                monkeypatch.setenv("MXTPU_DATALOADER_SHM", shm)
                _same(passes(gdata, T, timeout=30, **cfg, **extra), want)
        monkeypatch.setenv("MXTPU_DATALOADER_SHM", "1")
        loader = gdata.DataLoader(dataset(gdata, T), batch_size=2,
                                  num_workers=2, timeout=30)
        pids = [p.pid for p in loader._procs]
        it = iter(loader)
        next(it)
        del it
        assert _segments(pids) == []
        loader.close()
        # an abandoned pass over the pipe, batches of 1 MB: closing the
        # loader waits for the batches in flight and stops the pool
        monkeypatch.setenv("MXTPU_DATALOADER_SHM", "0")
        big = gdata.ArrayDataset(onp.zeros((64, 256, 256), "float32"))
        loader = gdata.DataLoader(big, batch_size=4, num_workers=2,
                                  timeout=30)
        it = iter(loader)
        next(it)
        closer = threading.Thread(target=loader.close)
        closer.start()
        closer.join(timeout=60)
        assert not closer.is_alive()
        del it
        loader = gdata.DataLoader(_Dies(), batch_size=2, num_workers=2,
                                  timeout=30)
        with pytest.raises(mx.MXNetError, match="worker died"):
            list(loader)
        loader.close()


def _idx_files(root, n, seed):
    rng = onp.random.RandomState(seed)
    root.mkdir(parents=True)
    for prefix in ("train", "t10k"):
        with open(root / f"{prefix}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(rng.randint(0, 255, n * 784).astype("uint8").tobytes())
        with open(root / f"{prefix}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(rng.randint(0, 10, n).astype("uint8").tobytes())


def test_vision_datasets_match_jax(tmp_path):
    """``MNIST`` from idx files and ``FashionMNIST`` from its synthetic
    stand-in (bit for bit), ``CIFAR10`` from bin files and without them
    (10,000 samples), ``CIFAR100``'s stand-in, ``ImageFolderDataset``
    (PNG and ``.npy``), each with a ``transform``, against the JAX ones;
    ``ImageRecordDataset`` against the JAX ``unpack_img`` of the same
    records (RGB)."""
    _idx_files(tmp_path / "mnist", 7, 5)
    cifar = tmp_path / "cifar" / "cifar-10-batches-bin"
    cifar.mkdir(parents=True)
    rng = onp.random.RandomState(6)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rng.randint(0, 255, (3, 3073)).astype("uint8").tofile(cifar / name)
    folder = tmp_path / "folder"
    for c in ("b", "a"):
        (folder / c).mkdir(parents=True)
        for k in range(2):
            cv2.imwrite(str(folder / c / f"{k}.png"), rng.randint(
                0, 255, (9, 7, 3)).astype("uint8"))
    onp.save(folder / "a" / "z.npy", rng.rand(4, 4, 3))
    empty = str(tmp_path / "none")

    def flip(x, y):
        return x[::-1], y + 1

    def sets(v):
        return [v.MNIST(str(tmp_path / "mnist")),
                v.MNIST(str(tmp_path / "mnist"), train=False,
                        transform=flip),
                v.FashionMNIST(empty, train=False),
                v.CIFAR10(str(tmp_path / "cifar")),
                v.CIFAR10(str(tmp_path / "cifar"), train=False,
                          transform=flip),
                v.CIFAR10(empty), v.CIFAR100(empty, train=False),
                v.ImageFolderDataset(str(folder), transform=flip)]

    for got, want in zip(sets(gdata.vision), sets(jdata.vision)):
        assert len(got) == len(want)
        idx = sorted({0, 1, len(got) // 2, len(got) - 1})
        _same([got[i] for i in idx], [want[i] for i in idx])
    assert len(gdata.vision.CIFAR10(empty)) == 10000
    full = gdata.vision.FashionMNIST(empty, train=False)
    jfull = jdata.vision.FashionMNIST(empty, train=False)
    _same(full._data, jfull._data)
    rec, idx = _write_rec(tmp_path, 5)
    ds = gdata.vision.ImageRecordDataset(rec)
    ref = jrec.MXIndexedRecordIO(idx, rec, "r")
    for i in range(len(ds)):
        img, lab = ds[i]
        h, want = jrec.unpack_img(ref.read_idx(ref.keys[i]), 1)
        _same((img, lab), (cv2.cvtColor(want, cv2.COLOR_BGR2RGB), h.label))
    gray, _ = gdata.vision.ImageRecordDataset(rec, flag=0)[1]
    assert gray.ndim == 2


def test_image_iters_path_imgrec_match_jax(tmp_path):
    """``ImageIter(path_imgrec=)`` (random crop, mirror, mean and std)
    and ``ImageDetIter(path_imgrec=)`` (flat detection labels, random
    crop and mirror) against the JAX iterators under one ``random``
    seed."""
    (tmp_path / "c").mkdir()
    (tmp_path / "d").mkdir()
    rec, _ = _write_rec(tmp_path / "c", 8, size=(18, 30), seed=1)
    det, _ = _write_rec(tmp_path / "d", 6, size=(18, 30), det=True, seed=2)

    def run(img_mod):
        out = []
        pyrandom.seed(8)
        it = img_mod.ImageIter(4, (3, 16, 16), path_imgrec=rec,
                               shuffle=True, resize=18, rand_crop=True,
                               rand_mirror=True, mean=True, std=True)
        for _ in range(2):
            out += [(b.data[0], b.label[0]) for b in it]
            it.reset()
        it = img_mod.ImageDetIter(2, (3, 16, 16), path_imgrec=det,
                                  shuffle=True, rand_crop=0.5,
                                  rand_mirror=True)
        out += [(b.data[0], b.label[0]) for b in it]
        return out

    with mx.cpu():
        got = run(image)
    want = run(jimage)
    assert len(got) == len(want) == 7
    _same(got, want)


def test_example_rec_trains_and_reads_as_jax(tmp_path):
    """The image-classification example's ``--rec`` at tier-1 size
    (resnet18_v1, 16x16, 4 classes, batch 8): it runs and its losses are
    finite; the iterator it reads (``record_iter``) gives the JAX
    example's ``ImageRecordIter`` batches."""
    rec, _ = _write_rec(tmp_path, 16, size=(16, 24))
    with mx.cpu():
        out = ic.image_classification_example(
            model="resnet18_v1", classes=4, image_size=16, epochs=1,
            batch_size=8, rec=rec, ctx=mx.cpu(), seed=0)
        assert len(out["losses"]) == 2
        assert all(onp.isfinite(out["losses"]))
        it = ic.record_iter(rec, 8, 16)
        got = [(b.data[0], b.label[0]) for b in it]
    ref = jio.ImageRecordIter(path_imgrec=rec, batch_size=8,
                              data_shape=(3, 16, 16), shuffle=True)
    _same(got, [(b.data[0], b.label[0]) for b in ref])


BUCKETS, N_SEQ, B, VOCAB = (16, 32), 64, 4, 400


def _bucketed_run(steps, save_at=None, root=None, restore=False):
    """The bucketed loop at ``bert_2_128_2``: ``FixedBucketSampler`` ->
    ``DataLoader`` (2 forked workers, ``BucketBatchify``) ->
    ``PrefetchIter(place=trainer.place)`` -> ``ShardedTrainer`` (eager,
    dropout 0.1). Returns each step's loss and batch."""
    lengths = bp.bucket_lengths(N_SEQ, BUCKETS, B, low=8, seed=0)
    corpus = bp.SyntheticCorpus(lengths, VOCAB, BUCKETS[-1], seed=1)
    sampler = gdata.FixedBucketSampler(lengths, B, bucket_keys=BUCKETS,
                                       shuffle=True)
    loader = gdata.DataLoader(corpus, batch_sampler=sampler,
                              batchify_fn=bp.BucketBatchify(BUCKETS),
                              num_workers=2, timeout=30)
    net = models.get_bert("bert_2_128_2", vocab_size=VOCAB,
                          max_length=BUCKETS[-1], dropout=0.1, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr = parallel.ShardedTrainer(net, models.bert_pretrain_loss, "adamw",
                                 {"learning_rate": 1e-3}, device="cpu",
                                 n_labels=3, seed=2)
    first = 0
    if restore:
        tr.step(*bp.BucketBatchify(BUCKETS)([corpus[i] for i in range(B)]))
        first = tr.restore_checkpoint(root)
    out = []
    with mx.cpu():          # the loader's and the iterator's context
        onp.random.seed(7)
        it = io.PrefetchIter(loader, place=lambda b: tr.place(*b))
        if restore:
            onp.random.seed(7)
            it.restore_shard(tr.last_restore_meta["data_state"])
        for t in range(first + 1, steps + 1):
            batch = next(it)
            out.append((float(tr.step(*batch)), [b.numpy() for b in batch]))
            if t == save_at:
                tr.save_checkpoint(root, data_state=it.shard_state())
                break
        it.close()
    loader.close()
    return out


def test_bucketed_bert_resumes_bitwise(tmp_path):
    """Run U takes 6 steps; run K saves at step 3 with
    ``data_state=shard_state()``; a new loader, iterator, model and
    trainer restore (the trainer with ``restore_checkpoint``, the stream
    with ``restore_shard``) and run steps 4-6: losses and batches bitwise
    equal to U's, no sample replayed or dropped; each batch padded to its
    bucket."""
    root = str(tmp_path / "ckpt")
    u = _bucketed_run(6)
    k = _bucketed_run(6, save_at=3, root=root)
    r = _bucketed_run(6, root=root, restore=True)
    assert [x[0] for x in k] == [x[0] for x in u[:3]]
    assert len(r) == 3
    assert [x[0] for x in r] == [x[0] for x in u[3:]]
    for (_, got), (_, want) in zip(r, u[3:]):
        _same(got, want)
    shapes = {b[1][0].shape[1] for b in u}
    assert shapes <= set(BUCKETS) and all(b[1][0].shape[0] == B for b in u)
    seen = [tuple(map(tuple, b[1][0])) for b in k + r]
    assert len(set(seen)) == len(seen) == 6
