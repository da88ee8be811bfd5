"""Model zoo of the port (JAX counterpart: ``models/__init__.py``): the
models, their serving specs, and the smoke instances of the quantizable
serving families (:func:`hlo_smoke`, :func:`calib_args`,
:func:`quantized_smoke`)."""
from . import (  # noqa: F401
    bert, bert_pretraining, dcgan, image_classification, lenet, nmt, rcnn,
    ssd, transformer, word_language_model,
)
from .bert import (  # noqa: F401
    BERT_CONFIGS, BERTEncoder, BERTModel, bert_pretrain_loss,
    bert_sharding_rules, get_bert,
)
from .lenet import (  # noqa: F401
    LeNet, lenet_symbol, mlp_symbol, mnist_example, serving_example,
)
from .nmt import (  # noqa: F401
    NMTModel, TransformerDecoder, TransformerEncoder, beam_search,
    beam_search_reference, transformer_sharding_rules,
)
from .rcnn import FasterRCNN, FasterRCNNTargetLoss, RPN  # noqa: F401
from .ssd import SSD, SSDTargetLoss, ssd_300  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, PositionwiseFFN, StackedTransformerEncoder,
    TransformerEncoderCell,
)
from .word_language_model import RNNModel  # noqa: F401
import numpy as onp

from ..gluon.block import HybridBlock

#: Serving axis specs per model family: the ``input_axes``/``output_axes``/
#: ``pad_values`` a ``serve.CompiledModel`` needs to bucket each input
#: (JAX counterpart: ``models/__init__.py:33``). ``valid_length`` pads with
#: 0 so attention masks the fake rows and positions.
SERVE_SPECS = {
    # BERTModel(ids, token_types, valid_length, masked_positions)
    "bert": {
        "input_axes": [{0: "batch", 1: "seq"}, {0: "batch", 1: "seq"},
                       {0: "batch"}, {0: "batch"}],
        "output_axes": [{0: "batch", 1: "seq"}, {0: "batch"},
                        {0: "batch"}, {0: "batch"}],
        "pad_values": [0, 0, 0, 0],
    },
    # BERTModel(ids, token_types, valid_length) with use_decoder=False,
    # use_classifier=False: encoder + pooler serving
    "bert_encoder": {
        "input_axes": [{0: "batch", 1: "seq"}, {0: "batch", 1: "seq"},
                       {0: "batch"}],
        "output_axes": [{0: "batch", 1: "seq"}, {0: "batch"}],
        "pad_values": [0, 0, 0],
    },
    # LeNet(images): fixed spatial dims, bucketed batch only
    "lenet": {
        "input_axes": [{0: "batch"}],
        "output_axes": [{0: "batch"}],
        "pad_values": [0],
    },
    # StackedTransformerEncoder(x), served unmasked
    "transformer_encoder": {
        "input_axes": [{0: "batch", 1: "seq"}],
        "output_axes": [{0: "batch", 1: "seq"}],
        "pad_values": [0],
    },
    # NMTModel.encode(src_ids, src_len): the beam-search entry's encoder
    # (_NMTEncodeEntry)
    "nmt_encoder": {
        "input_axes": [{0: "batch", 1: "seq"}, {0: "batch"}],
        "output_axes": [{0: "batch", 1: "seq"}],
        "pad_values": [0, 0],
    },
}


#: Families whose smoke model holds quantizable layers (``nn.Dense`` /
#: ``nn.Conv2D`` children the int8 pass swaps) (JAX counterpart:
#: ``models/__init__.py:78``); ``transformer_encoder`` has none (its
#: stacked parameters are no Dense children)
QUANT_FAMILIES = ("bert", "bert_encoder", "lenet", "nmt_encoder")


def serve_spec(family: str) -> dict:
    """Copy of the named serving spec (JAX counterpart:
    ``models/__init__.py:81``)."""
    if family not in SERVE_SPECS:
        raise KeyError(f"no serving spec for {family!r}; known: "
                       f"{sorted(SERVE_SPECS)}")
    spec = SERVE_SPECS[family]
    return {"input_axes": [dict(a) for a in spec["input_axes"]],
            "output_axes": [dict(a) for a in spec["output_axes"]],
            "pad_values": list(spec["pad_values"])}


class _NMTEncodeEntry(HybridBlock):
    """The ``nmt_encoder`` serving entry: the embed -> masked-encoder half
    of ``NMTModel.encode``, built without the decoder, so the serving
    signature carries no decoder parameters (JAX counterpart:
    ``models/__init__.py:92``)."""

    def __init__(self, src_vocab=100, units=32, hidden_size=64,
                 num_layers=2, num_heads=2, max_length=32, **kw):
        super().__init__(**kw)
        from ..nn import Embedding
        with self.name_scope():
            self.src_embed = Embedding(src_vocab, units, prefix="src_embed_")
            self.encoder = TransformerEncoder(units, hidden_size,
                                              num_layers, num_heads, 0.1,
                                              max_length, prefix="enc_")

    def hybrid_forward(self, F, src, src_len):
        B, L = src.shape
        return self.encoder(self.src_embed(src),
                            nmt.source_mask(src_len, B, L))


def hlo_smoke(family: str, batch: int = None, seq: int = None,
              device=None) -> dict:
    """A small live instance of one serving family (JAX counterpart:
    ``models/__init__.py:118``, whose name it keeps; the port has no HLO
    analysis): ``{"block", "example_args", "table", "spec",
    "compiled"}``, ``compiled`` the un-warmed ``serve.CompiledModel`` over
    the block, built on ``device`` (default: the card). ``batch``/``seq``
    make the bucket table one bucket of that size; by default it is batch
    (1, 4) and sequence (8, 16), the example arguments (2, 16)."""
    from .. import serve
    from ..context import Context, resolve_device
    from ..ndarray import array

    dev = resolve_device(device)
    ctx = Context.from_device(dev)
    spec = serve_spec(family)
    B = int(batch) if batch else 2
    batch_lad = (int(batch), int(batch)) if batch else (1, 4)
    L = int(seq) if seq else 16
    seq_lad = (int(seq), int(seq)) if seq else (8, 16)
    if family in ("bert", "bert_encoder", "nmt_encoder") and L > 32:
        raise ValueError(f"hlo_smoke({family!r}) probe caps seq at 32 "
                         f"(position table), got {L}")
    if family in ("bert", "bert_encoder"):
        net = get_bert("bert_2_128_2", vocab_size=1000, max_length=32,
                       dropout=0.1, use_decoder=(family == "bert"),
                       use_classifier=(family == "bert"), device=dev)
        args = [onp.ones((B, L), "int32"), onp.zeros((B, L), "int32"),
                onp.full((B,), L, "float32")]
        if family == "bert":
            args.append(onp.zeros((B, 4), "int32"))
        table = serve.BucketTable({"batch": batch_lad, "seq": seq_lad})
    elif family == "lenet":
        net = LeNet()
        net.initialize(ctx=ctx)
        args = [onp.zeros((B, 1, 28, 28), "float32")]
        table = serve.BucketTable({"batch": batch_lad})
    elif family == "transformer_encoder":
        net = StackedTransformerEncoder(num_layers=2, units=32,
                                        hidden_size=64, num_heads=2)
        net.initialize(ctx=ctx)
        args = [onp.zeros((B, L, 32), "float32")]
        table = serve.BucketTable({"batch": batch_lad, "seq": seq_lad})
    elif family == "nmt_encoder":
        net = _NMTEncodeEntry()
        net.initialize(ctx=ctx)
        args = [onp.ones((B, L), "int32"), onp.full((B,), L, "float32")]
        table = serve.BucketTable({"batch": batch_lad, "seq": seq_lad})
    else:
        raise KeyError(f"no smoke model for {family!r}; known: "
                       f"{sorted(SERVE_SPECS)}")
    net.hybridize()
    args = tuple(array(a, ctx=ctx) for a in args)
    net(*args)
    compiled = serve.CompiledModel(net, table, spec["input_axes"],
                                   example_args=args,
                                   output_axes=spec["output_axes"],
                                   pad_values=spec["pad_values"])
    return {"block": net, "example_args": args, "table": table,
            "spec": spec, "compiled": compiled}


def calib_args(family: str, batch: int = None, seq: int = None,
               seed: int = 0, device=None) -> tuple:
    """Seeded inputs for ``family``'s serving signature, the calibration
    batch of :func:`quantized_smoke` (JAX counterpart:
    ``models/__init__.py:196``): float tensors N(0, 1), ids uniform over
    the probe vocabulary, valid lengths full; ``NDArray``\\ s on
    ``device``."""
    from ..context import Context, resolve_device
    from ..ndarray import array

    ctx = Context.from_device(resolve_device(device))
    sm_args = hlo_smoke(family, batch=batch, seq=seq,
                        device=ctx.torch_device)["example_args"]
    rs = onp.random.RandomState(seed)
    out = []
    for a in sm_args:
        arr = a.asnumpy()
        if arr.dtype.kind == "f":
            if arr.ndim == 1:          # valid_length-style: keep full
                out.append(array(arr, ctx=ctx))
            else:
                out.append(array(rs.randn(*arr.shape).astype(arr.dtype),
                                 ctx=ctx))
        else:                          # ids: uniform over the probe vocab
            hi = max(int(arr.max()) + 1, 32)
            out.append(array(rs.randint(0, hi, arr.shape).astype(arr.dtype),
                             ctx=ctx))
    return tuple(out)


def quantized_smoke(family: str, batch: int = None, seq: int = None,
                    percentile: float = None, device=None) -> dict:
    """The quantized twin of :func:`hlo_smoke` (JAX counterpart:
    ``models/__init__.py:227``): the family's smoke model calibrated on
    :func:`calib_args` through ``quantization.observe_net`` and lowered by
    ``quantization.quantize_model`` into a quantized ``CompiledModel`` on
    the float model's buckets, axes and pad values. Returns ``{"block",
    "example_args", "table", "spec", "compiled", "observer", "f32"}``,
    ``f32`` the float :func:`hlo_smoke` dict."""
    from .. import quantization as _quant

    sm = hlo_smoke(family, batch=batch, seq=seq, device=device)
    cargs = calib_args(family, batch=batch, seq=seq, device=device)
    observer = _quant.observe_net(sm["block"], [cargs])
    qcm = _quant.quantize_model(sm["compiled"], observer,
                                percentile=percentile)
    return {"block": qcm._block, "example_args": sm["example_args"],
            "table": sm["table"], "spec": sm["spec"], "compiled": qcm,
            "observer": observer, "f32": sm}
