"""Weight bridge: load the JAX package's parameters into a port block.

The JAX package names a parameter by its Gluon prefix chain, e.g.
``bertmodel0_encoder_layer0_attn_qkv_weight``, where the leading instance
prefix (``bertmodel0_``, ``bertmodel1_`` ...) comes from a process-wide
counter. The port's blocks carry the same prefix chains, so a port
parameter's name without its model's instance prefix
(``encoder_layer0_attn_qkv_weight``) is the JAX structural suffix; matching
is on that suffix. Aux parameters travel like the others (a vision net's
BatchNorm ``running_mean``/``running_var``), each converted to the port
parameter's own dtype: a ``cast("bfloat16")`` net takes bf16 weights and
float32 BatchNorm parameters. (A ``.params`` file moves weights too:
``Block.save_parameters``/``load_parameters`` in either package.)
"""
from __future__ import annotations

from typing import Dict, List

import numpy as onp
import torch

from .base import MXNetError
from .gluon.block import Block

__all__ = ["params_from_jax", "jax_suffixes"]


def jax_suffixes(model: Block) -> Dict[str, str]:
    """Each parameter's torch name (``model.named_parameters()``, the
    structural name) -> its JAX suffix: ``encoder.layer0.attention.qkv.
    weight`` -> ``encoder_layer0_attn_qkv_weight``."""
    n = len(model.prefix)
    return {name: p.name[n:]
            for name, p in model._collect_params_with_prefix().items()}


def _instance_prefix(keys: List[str], suffixes: List[str]) -> str:
    """The prefix the JAX keys share before their structural suffix:
    of the prefixes the first key allows, the one that pairs the most
    keys with a known suffix."""
    known = set(suffixes)
    first = keys[0]
    score = {}
    for s in known:
        if first == s or first.endswith("_" + s):
            prefix = first[:len(first) - len(s)]
            score[prefix] = sum(k.startswith(prefix)
                                and k[len(prefix):] in known for k in keys)
    best = max(score.values(), default=0)
    winners = [p for p, n in score.items() if n == best]
    if best == 0 or len(winners) != 1:
        raise MXNetError(
            f"cannot pair the JAX parameter names with this module "
            f"(first name {first!r}; candidate prefixes {sorted(score)})")
    return winners[0]


def params_from_jax(model: Block, arrays: Dict[str, onp.ndarray]) -> Block:
    """Copy ``arrays`` (JAX ``net.collect_params()`` names -> numpy values)
    into ``model``'s parameters, converting to each parameter's dtype and
    device. Refuses a name missing on either side and any shape mismatch.
    A tied weight (BERT's decoder reuses ``word_embed_weight``, the NMT
    model's output projection ``tgt_embed_weight``) is one parameter on
    both sides and maps once.

    Counterpart: the JAX package's ``Block.load_parameters``
    (``gluon/block.py:313``), keyed by prefix names instead of a
    ``.params`` file."""
    n = len(model.prefix)
    by_suffix = {p.name[n:]: p for p in model.collect_params().values()}
    if not arrays:
        raise MXNetError("no JAX parameters given")
    keys = list(arrays)
    prefix = _instance_prefix(keys, list(by_suffix))
    got = {k[len(prefix):]: k for k in keys if k.startswith(prefix)
           and k[len(prefix):] in by_suffix}
    leftover = sorted(set(keys) - set(got.values()))
    if leftover:
        raise MXNetError(f"JAX parameters with no port counterpart: "
                         f"{leftover}")
    missing = sorted(set(by_suffix) - set(got))
    if missing:
        raise MXNetError(f"JAX parameters missing for {missing}")
    with torch.no_grad():
        for suffix, key in got.items():
            p = by_suffix[suffix]._tensor()
            a = onp.asarray(arrays[key])
            if tuple(a.shape) != tuple(p.shape):
                raise MXNetError(
                    f"{key}: JAX shape {tuple(a.shape)} != port shape "
                    f"{tuple(p.shape)} ({by_suffix[suffix].name})")
            # via float32: numpy has no native bfloat16, and bf16 -> f32 ->
            # bf16 is exact
            src = torch.from_numpy(onp.ascontiguousarray(
                a.astype(onp.float32) if p.is_floating_point() else a))
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model
