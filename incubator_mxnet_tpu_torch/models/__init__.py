"""Model zoo of the port (JAX counterpart: ``models/__init__.py``)."""
from . import bert, transformer  # noqa: F401
from .bert import (  # noqa: F401
    BERT_CONFIGS, BERTEncoder, BERTModel, bert_pretrain_loss, get_bert,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention, PositionwiseFFN, TransformerEncoderCell,
)

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
