"""BERT encoder, pooler and heads, as Gluon blocks.

Counterpart: the JAX package's ``models/bert.py``. Same forward contract
as GluonNLP's BERTModel::

    seq, pooled, nsp, mlm = model(ids, token_types, valid_length, positions)

Children, prefixes and parameter names are the JAX ones: structural names
such as ``encoder.layer0.attention.qkv.weight``, ``classifier.weight`` and
the shared ``decoder_tied_weight``, prefix names such as
``bertmodel0_encoder_layer0_attn_qkv_weight`` and ``bertmodel0_nsp_weight``;
so ``.params`` files move between the two packages and
``convert.params_from_jax`` maps weights one to one. The model runs on
tensors (serving, ``ShardedTrainer``) or on NDArrays (the Gluon loop).
:func:`bert_pretrain_loss` is the MLM + NSP loss of the pretraining step;
:func:`bert_sharding_rules` is the JAX package's tensor-parallel table for
``parallel.ShardedTrainer``. Remat is not ported.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..context import Context, resolve_device
from ..gluon.block import HybridBlock
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..initializer import Xavier
from ..ndarray.op import _nd_op
from ..nn import Dense, Dropout, Embedding, LayerNorm
from .transformer import TransformerEncoderCell

__all__ = ["BERTEncoder", "BERTModel", "get_bert", "bert_pretrain_loss",
           "BERT_CONFIGS", "bert_sharding_rules"]

#: GluonNLP model-name convention: bert_<layers>_<units>_<heads>
#: (JAX counterpart: ``models/bert.py:28``)
BERT_CONFIGS = {
    "bert_2_128_2": dict(num_layers=2, units=128, hidden_size=512,
                         num_heads=2),          # tiny (tests)
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),       # base
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),      # large
}


class BERTEncoder(HybridBlock):
    """Stack of post-LN transformer encoder cells, children ``layer0`` ...
    (JAX counterpart: ``models/bert.py:38``, without remat)."""

    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.1, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.layers = []
            for i in range(num_layers):
                cell = TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    dtype=dtype, prefix=f"layer{i}_",
                    weight_initializer=weight_initializer)
                self.register_child(cell, f"layer{i}")
                self.layers.append(cell)

    def hybrid_forward(self, F, x, mask=None):
        for cell in self.layers:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT with optional pooler, MLM decoder and NSP classifier (JAX
    counterpart: ``models/bert.py:109``). ``forward(inputs, token_types,
    valid_length=None, masked_positions=None)`` returns ``seq`` |
    ``(seq, pooled)`` | ``(seq, pooled, nsp)`` | ``(seq, pooled, nsp, mlm)``
    by the ``use_*`` flags. The MLM output projection is tied to the word
    embedding."""

    def __init__(self, vocab_size: int, units: int = 768,
                 hidden_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 512,
                 token_type_vocab_size: int = 2, dropout: float = 0.1,
                 use_pooler: bool = True, use_decoder: bool = True,
                 use_classifier: bool = True, dtype="float32",
                 embed_initializer=None, **kwargs):
        super().__init__(**kwargs)
        if use_classifier and not use_pooler:
            raise ValueError("use_classifier=True requires use_pooler=True "
                             "(the NSP head reads the pooled [CLS] vector)")
        self._vocab_size = vocab_size
        self._units = units
        self._max_length = max_length
        self.use_pooler = use_pooler
        self.use_decoder = use_decoder
        self.use_classifier = use_classifier
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units, dtype=dtype,
                                        prefix="word_embed_",
                                        weight_initializer=embed_initializer)
            self.token_type_embed = Embedding(
                token_type_vocab_size, units, dtype=dtype,
                prefix="token_type_embed_",
                weight_initializer=embed_initializer)
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units), dtype=dtype,
                init=embed_initializer)
            self.embed_ln = LayerNorm(epsilon=1e-12, in_channels=units,
                                      prefix="embed_ln_")
            self.embed_dropout = Dropout(dropout) if dropout else None
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout=dropout,
                                       dtype=dtype, prefix="encoder_")
            if use_pooler:
                self.pooler = Dense(units, flatten=False, in_units=units,
                                    activation="tanh", prefix="pooler_",
                                    dtype=dtype)
            if use_classifier:
                self.classifier = Dense(2, flatten=False, in_units=units,
                                        prefix="nsp_", dtype=dtype)
            if use_decoder:
                self.decoder_transform = Dense(
                    units, flatten=False, in_units=units, activation="gelu",
                    prefix="decoder_transform_", dtype=dtype)
                self.decoder_ln = LayerNorm(epsilon=1e-12, in_channels=units,
                                            prefix="decoder_ln_")
                # the output projection is TIED to the word embedding: one
                # Parameter, one torch tensor, two structural names
                self.decoder_tied_weight = self.word_embed.weight
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init="zeros",
                    dtype=dtype)

    @staticmethod
    def _attn_mask(valid_length, B, L):
        """(B, 1, 1, L) key mask ``arange(L) < valid_length``, compared in
        float32 (JAX counterpart: ``models/bert.py:172``)."""
        if valid_length is None:
            return None
        steps = torch.arange(L, dtype=torch.float32,
                             device=valid_length.device).reshape(1, L)
        mask = steps < valid_length.to(torch.float32).reshape(B, 1)
        return mask.reshape(B, 1, 1, L)

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None,
                       masked_positions=None, position_weight=None,
                       decoder_tied_weight=None, decoder_bias=None):
        """JAX counterpart: ``models/bert.py:179``."""
        B, L = inputs.shape[0], inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = x + position_weight[:L].reshape(1, L, self._units)
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        seq = self.encoder(x, self._attn_mask(valid_length, B, L))
        outputs = [seq]
        pooled = None
        if self.use_pooler:
            pooled = self.pooler(seq[:, 0].reshape(B, self._units))
            outputs.append(pooled)
        if self.use_classifier:
            outputs.append(self.classifier(pooled))
        if self.use_decoder and masked_positions is not None:
            P = masked_positions.shape[1]
            flat = seq.reshape(B * L, self._units)
            offsets = torch.arange(B, device=seq.device).reshape(B, 1) * L
            idx = (masked_positions.to(torch.int64) + offsets).reshape(B * P)
            # take(mode="clip"), as the JAX op
            h = flat[idx.clamp(0, B * L - 1)].reshape(B, P, self._units)
            h = self.decoder_ln(self.decoder_transform(h))
            outputs.append(F.FullyConnected(h, decoder_tied_weight,
                                            decoder_bias, flatten=False))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


def get_bert(name_or_cfg="bert_12_768_12", vocab_size: int = 30522,
             max_length: int = 512, dropout: float = 0.1, dtype="float32",
             device: Optional[Union[str, torch.device]] = None,
             generator: Optional[torch.Generator] = None,
             **overrides) -> BERTModel:
    """Model-zoo constructor (JAX counterpart: ``models/bert.py:215``).

    Unlike the JAX zoo, the model comes initialised on ``device`` (default:
    the card; on a machine without one, pass ``device="cpu"``): ``Xavier``
    weights drawn from ``generator`` (a CPU generator, seeded with 0 by
    default) in parameter order, zero biases, unit LayerNorm gains. A
    later ``net.initialize()`` leaves them unless ``force_reinit``."""
    dev = resolve_device(device)
    cfg = dict(BERT_CONFIGS[name_or_cfg]) if isinstance(name_or_cfg, str) \
        else dict(name_or_cfg)
    cfg.update(overrides)
    model = BERTModel(vocab_size=vocab_size, max_length=max_length,
                      dropout=dropout, dtype=dtype, **cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.initialize(Xavier(generator=generator),
                     ctx=Context.from_device(dev))
    return model


def bert_sharding_rules(extra=()):
    """Megatron-style ``tp`` rules for ``parallel.ShardedTrainer`` (JAX
    counterpart: ``models/bert.py:226-242``): dense weights are (out, in);
    qkv and ffn1 split the output dim, proj and ffn2 the input dim, the
    word embedding its vocabulary dim. Each rank stores its block; the
    port's compute stays replicated over ``tp``."""
    from ..parallel.sharding import P, ShardingRules
    return ShardingRules(list(extra) + [
        (r".*qkv_weight", P("tp", None)),
        (r".*qkv_bias", P("tp")),
        (r".*(proj|ffn2)_weight", P(None, "tp")),
        (r".*ffn1_weight", P("tp", None)),
        (r".*ffn1_bias", P("tp")),
        (r".*word_embed_weight", P("tp", None)),
        (r".*decoder_bias", P("tp")),
    ])


@_nd_op
def bert_pretrain_loss(outputs, mlm_labels, mlm_weights, nsp_labels):
    """Combined MLM + NSP loss (JAX counterpart: ``models/bert.py:245``).

    ``outputs`` is the BERTModel 4-tuple; ``mlm_labels``/``mlm_weights``
    (B, P) with weight 0 on padding positions; ``nsp_labels`` (B,). Labels
    are class indices given as float. Given NDArrays it returns an NDArray
    (recorded under ``autograd.record()``), given tensors a tensor."""
    _, _, nsp_scores, mlm_scores = outputs
    ce = SoftmaxCrossEntropyLoss()
    mlm = ce(mlm_scores, mlm_labels, mlm_weights.unsqueeze(-1))
    denom = mlm_weights.mean() + 1e-8
    nsp = ce(nsp_scores, nsp_labels)
    return mlm.mean() / denom + nsp.mean()
