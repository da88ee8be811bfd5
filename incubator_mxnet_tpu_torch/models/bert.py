"""BERT encoder, pooler and heads.

Counterpart: the JAX package's ``models/bert.py``. Same forward contract
as GluonNLP's BERTModel::

    seq, pooled, nsp, mlm = model(ids, token_types, valid_length, positions)

Module and parameter names follow the JAX prefixes (``word_embed``,
``encoder.layer0.attn.qkv.weight`` for ``encoder_layer0_attn_qkv_weight``,
``nsp`` for the NSP classifier) so that ``convert.params_from_jax`` maps
them one to one. :func:`bert_pretrain_loss` is the MLM + NSP loss of the
pretraining step. Remat and the sharding rules come with later slices.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..base import torch_dtype
from ..context import resolve_device
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..initializer import initialize
from ..nn import Dense, Dropout, Embedding, LayerNorm
from ..ops.nn import fully_connected
from .transformer import TransformerEncoderCell

__all__ = ["BERTEncoder", "BERTModel", "get_bert", "bert_pretrain_loss",
           "BERT_CONFIGS"]

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


class BERTEncoder(nn.Module):
    """Stack of post-LN transformer encoder cells, children ``layer0`` ...
    (JAX counterpart: ``models/bert.py:38``, without remat)."""

    def __init__(self, num_layers: int, units: int, hidden_size: int,
                 num_heads: int, dropout: float = 0.1, dtype="float32"):
        super().__init__()
        self._num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout, dtype=dtype))

    def forward(self, x, mask=None):
        for i in range(self._num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        return x


class BERTModel(nn.Module):
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
                 use_classifier: bool = True, dtype="float32"):
        super().__init__()
        if use_classifier and not use_pooler:
            raise ValueError("use_classifier=True requires use_pooler=True "
                             "(the NSP head reads the pooled [CLS] vector)")
        self._vocab_size = vocab_size
        self._units = units
        self._max_length = max_length
        self.use_pooler = use_pooler
        self.use_decoder = use_decoder
        self.use_classifier = use_classifier
        dt = torch_dtype(dtype)
        self.word_embed = Embedding(vocab_size, units, dtype=dt)
        self.token_type_embed = Embedding(token_type_vocab_size, units,
                                          dtype=dt)
        self.position_weight = nn.Parameter(
            torch.zeros(max_length, units, dtype=dt))
        self.embed_ln = LayerNorm(epsilon=1e-12, in_channels=units)
        self.embed_dropout = Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout=dropout, dtype=dt)
        if use_pooler:
            self.pooler = Dense(units, flatten=False, in_units=units,
                                activation="tanh", dtype=dt)
        if use_classifier:
            self.nsp = Dense(2, flatten=False, in_units=units, dtype=dt)
        if use_decoder:
            self.decoder_transform = Dense(units, flatten=False,
                                           in_units=units, activation="gelu",
                                           dtype=dt)
            self.decoder_ln = LayerNorm(epsilon=1e-12, in_channels=units)
            self.decoder_bias = nn.Parameter(torch.zeros(vocab_size,
                                                         dtype=dt))

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

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        """JAX counterpart: ``models/bert.py:179``."""
        B, L = inputs.shape[0], inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = x + self.position_weight[:L].reshape(1, L, self._units)
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
            outputs.append(self.nsp(pooled))
        if self.use_decoder and masked_positions is not None:
            P = masked_positions.shape[1]
            flat = seq.reshape(B * L, self._units)
            offsets = torch.arange(B, device=seq.device).reshape(B, 1) * L
            idx = (masked_positions.to(torch.int64) + offsets).reshape(B * P)
            # take(mode="clip"), as the JAX op
            h = flat[idx.clamp(0, B * L - 1)].reshape(B, P, self._units)
            h = self.decoder_ln(self.decoder_transform(h))
            outputs.append(fully_connected(h, self.word_embed.weight,
                                           self.decoder_bias, flatten=False))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


def get_bert(name_or_cfg="bert_12_768_12", vocab_size: int = 30522,
             max_length: int = 512, dropout: float = 0.1, dtype="float32",
             device: Optional[Union[str, torch.device]] = None,
             generator: Optional[torch.Generator] = None,
             **overrides) -> BERTModel:
    """Model-zoo constructor (JAX counterpart: ``models/bert.py:215``).

    Unlike the JAX zoo, the model comes initialised (``Xavier`` weights,
    zero biases, unit LayerNorm gains drawn from ``generator``, a CPU
    generator seeded with 0 by default) and placed on ``device``, which
    defaults to the card; on a machine without one, pass
    ``device="cpu"``."""
    dev = resolve_device(device)
    cfg = dict(BERT_CONFIGS[name_or_cfg]) if isinstance(name_or_cfg, str) \
        else dict(name_or_cfg)
    cfg.update(overrides)
    model = BERTModel(vocab_size=vocab_size, max_length=max_length,
                      dropout=dropout, dtype=dtype, **cfg)
    initialize(model, generator=generator)
    return model.to(dev)


def bert_pretrain_loss(outputs, mlm_labels, mlm_weights, nsp_labels):
    """Combined MLM + NSP loss (JAX counterpart: ``models/bert.py:245``).

    ``outputs`` is the BERTModel 4-tuple; ``mlm_labels``/``mlm_weights``
    (B, P) with weight 0 on padding positions; ``nsp_labels`` (B,). Labels
    are class indices given as float."""
    _, _, nsp_scores, mlm_scores = outputs
    ce = SoftmaxCrossEntropyLoss()
    mlm = ce(mlm_scores, mlm_labels, mlm_weights.unsqueeze(-1))
    denom = mlm_weights.mean() + 1e-8
    nsp = ce(nsp_scores, nsp_labels)
    return mlm.mean() / denom + nsp.mean()
