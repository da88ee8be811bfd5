"""Model zoo of the port (JAX counterpart: ``models/__init__.py``)."""
from . import bert, lenet, nmt, rcnn, ssd, transformer  # noqa: F401
from .bert import (  # noqa: F401
    BERT_CONFIGS, BERTEncoder, BERTModel, bert_pretrain_loss, get_bert,
)
from .lenet import LeNet  # noqa: F401
from .nmt import (  # noqa: F401
    NMTModel, TransformerDecoder, TransformerEncoder, beam_search,
    beam_search_reference,
)
from .rcnn import FasterRCNN, FasterRCNNTargetLoss, RPN  # noqa: F401
from .ssd import SSD, SSDTargetLoss, ssd_300  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, PositionwiseFFN, TransformerEncoderCell,
)
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
    # NMTModel.encode(src_ids, src_len): the beam-search entry's encoder
    # (_NMTEncodeEntry)
    "nmt_encoder": {
        "input_axes": [{0: "batch", 1: "seq"}, {0: "batch"}],
        "output_axes": [{0: "batch", 1: "seq"}],
        "pad_values": [0, 0],
    },
}


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
