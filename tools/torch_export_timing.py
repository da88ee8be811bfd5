#!/usr/bin/env python3
"""Two layouts of a serving artifact of the PyTorch port, timed on one
NVIDIA card: BERT-base exported for every bucket of the serving tier's
table ``{"batch": (1, 8), "seq": (8, 512)}`` (28 signatures).

Run from the root of a checkout::

    python3 tools/torch_export_timing.py [--out timing.json]

- ``dynamic``: what ``HybridBlock.export`` writes (through
  ``serve.export_for_serving``): one ``torch.export`` program traced with
  ``Dim``\\ s over the batch and sequence axes, named by all 28 manifest
  entries;
- ``static``: one program per signature, each traced at its own shapes.

For each: export seconds (host clock; each trace runs the forward on fake
tensors, so no kernel runs), the programs' bytes, the seconds to load
every program back (``torch.export.load`` and ``.module()``), the
``mxtpu::flash_attention_fwd`` nodes per program and whether any archive
holds a tensor file (a copy of the weights). The two run in turns
(dynamic, static, dynamic).

Then where a replica's load goes, from the factory and from the dynamic
artifact, in turns (factory, artifact, factory, artifact): building the
model (``models.get_bert``, its one recorded forward) against the
artifact's pieces (the CRC-32 of every file as ``serve.ArtifactCache``
checks it, ``torch.export.load``, ``.module()``, reading the ``.params``
file, ``SymbolBlock.imports`` whole), then ``CompiledModel.warmup`` over
the 28 buckets (a first run and a capture each). It prints one JSON
object and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TABLE = {"batch": (1, 8), "seq": (8, 512)}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _model():
    import numpy as onp
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import models, nd
    net = models.get_bert("bert_12_768_12", vocab_size=30522,
                          max_length=512, use_decoder=False,
                          use_classifier=False, device="cuda")
    ids = nd.array(onp.zeros((1, 8), "int32"), ctx=mx.gpu(0), dtype="int32")
    net(ids, ids, nd.array([8.0], ctx=mx.gpu(0)))
    return net


def _programs(files) -> dict:
    """Bytes, load seconds, flash nodes per program and tensor files."""
    import torch
    unique = sorted(set(files))
    t0 = time.perf_counter()
    eps = [torch.export.load(f) for f in unique]
    mods = [ep.module() for ep in eps]
    load_s = time.perf_counter() - t0
    nodes = [sum("flash_attention_fwd" in str(n.target)
                 for n in ep.graph.nodes) for ep in eps]
    tensor_files = []
    for f in unique:
        with zipfile.ZipFile(f) as z:
            tensor_files += [i.filename for i in z.infolist()
                             if "/data/" in i.filename and i.file_size > 64]
    del mods
    return {"programs": len(unique),
            "bytes": sum(os.path.getsize(f) for f in unique),
            "load_s": load_s, "flash_nodes": sorted(set(nodes)),
            "tensor_files": tensor_files}


def dynamic(net, spec, table, root) -> dict:
    from incubator_mxnet_tpu_torch import serve
    prefix = os.path.join(root, "dyn", "bert")
    os.makedirs(os.path.dirname(prefix))
    t0 = time.perf_counter()
    sym_file, _ = serve.export_for_serving(net, prefix, table,
                                           spec["input_axes"])
    export_s = time.perf_counter() - t0
    with open(sym_file) as f:
        arch = json.load(f)
    files = [os.path.join(os.path.dirname(prefix), e["pt2"])
             for e in arch["signatures"]]
    return dict({"export_s": export_s, "signatures": len(files)},
                **_programs(files))


def static(net, spec, table, root) -> dict:
    import torch
    from incubator_mxnet_tpu_torch.gluon import block as B
    skeleton, n_in, in_avals, ctx = net._last_sig
    params = [p for _, p in sorted(net.collect_params().items())]
    pvals = [p._tensor().detach() for p in params]
    pure = B._PureInfer(net, skeleton, n_in, params, {})
    d = os.path.join(root, "static")
    os.makedirs(d)
    files, per = [], []
    t0 = time.perf_counter()
    for i, assignment in enumerate(table.assignments()):
        sig = []
        for (shape, dtype), axes in zip(in_avals, spec["input_axes"]):
            s = list(shape)
            for axis, name in axes.items():
                s[axis] = assignment[name]
            sig.append((tuple(s), dtype))
        t1 = time.perf_counter()
        ep = B._trace(pure, sig, pvals, ctx.torch_device, None)
        f = os.path.join(d, f"bert-symbol.{i}.pt2")
        torch.export.save(ep, f)
        per.append(time.perf_counter() - t1)
        files.append(f)
    return dict({"export_s": time.perf_counter() - t0,
                 "signatures": len(files),
                 "per_signature_s": [min(per), max(per)]},
                **_programs(files))


def _crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def load_split(spec, table, root) -> dict:
    """One replica load's pieces from the factory and from the artifact,
    in turns; each ends in a synchronised card."""
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, nd, serve
    prefix = os.path.join(root, "art", "bert")
    os.makedirs(os.path.dirname(prefix))
    sym_file, params_file = serve.export_for_serving(
        _model(), prefix, table, spec["input_axes"])
    kw = dict(output_axes=spec["output_axes"],
              pad_values=spec["pad_values"])
    res = {"factory": [], "artifact": []}
    for kind in ("factory", "artifact", "factory", "artifact"):
        rec = {}
        t0 = time.perf_counter()
        if kind == "factory":
            block = _model()
            torch.cuda.synchronize()
            rec["build_s"] = time.perf_counter() - t0
        else:
            for f in sorted(os.listdir(os.path.dirname(prefix))):
                _crc(os.path.join(os.path.dirname(prefix), f))
            rec["crc_s"] = time.perf_counter() - t0
            with open(sym_file) as f:
                pt2 = os.path.join(os.path.dirname(prefix),
                                   json.load(f)["pt2"])
            t1 = time.perf_counter()
            ep = torch.export.load(pt2)
            rec["export_load_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            ep.module()
            rec["module_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            nd.load(params_file)
            rec["params_read_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            block = gluon.SymbolBlock.imports(
                sym_file, ["ids", "token_types", "valid_length"],
                params_file, ctx=mx.gpu(0))
            torch.cuda.synchronize()
            rec["imports_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        cm = serve.CompiledModel(block, table, spec["input_axes"], **kw)
        cm.warmup()
        rec["warmup_s"] = time.perf_counter() - t1
        rec["total_s"] = time.perf_counter() - t0
        res[kind].append(rec)
        print(kind, json.dumps(rec), flush=True)
        del cm, block
        gc.collect()
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs on the card")
    from incubator_mxnet_tpu_torch import models, serve
    card = _card()
    net = _model()
    spec = models.serve_spec("bert_encoder")
    table = serve.BucketTable(TABLE)
    res = {"card": card, "torch": torch.__version__,
           "buckets": table.num_buckets(), "static": [], "dynamic": []}
    for kind in ("dynamic", "static", "dynamic"):
        root = tempfile.mkdtemp(prefix="mx-export-")
        try:
            fn = static if kind == "static" else dynamic
            res[kind].append(fn(net, spec, table, root))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(kind, json.dumps(res[kind][-1]), flush=True)
    del net
    root = tempfile.mkdtemp(prefix="mx-export-")
    try:
        res["load"] = load_split(spec, table, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
