"""Checkpoint helpers of the Module API and the batch-callback record.

Counterpart: the JAX package's ``model.py`` (a copy over the port's
``mx.nd``): ``save_checkpoint``/``load_checkpoint`` write and read
``prefix-symbol.json`` and ``prefix-%04d.params`` with ``arg:``/``aux:``
key prefixes, the files the JAX package reads and writes, and
``BatchEndParam``, the record passed to batch callbacks.
"""
from __future__ import annotations

import json
from collections import namedtuple
from typing import Dict, Optional, Tuple

from . import ndarray as nd

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix: str, epoch: int, symbol=None,
                    arg_params: Optional[Dict] = None,
                    aux_params: Optional[Dict] = None,
                    remove_amp_cast: bool = True) -> None:
    """``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params`` with ``arg:``/``aux:`` keys."""
    if symbol is not None:
        sym_json = symbol.tojson() if hasattr(symbol, "tojson") else \
            json.dumps({"symbol": str(symbol)})
        with open(f"{prefix}-symbol.json", "w") as f:
            f.write(sym_json)
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix: str, epoch: int) -> Tuple[Dict, Dict]:
    """``(arg_params, aux_params)`` of ``prefix-%04d.params`` (arrays on
    the CPU, as ``nd.load`` puts them); a key without a prefix is an
    argument."""
    loaded = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int):
    """``(symbol, arg_params, aux_params)``; ``symbol`` is None when no
    symbol file loads (a Gluon-era checkpoint)."""
    try:
        from . import symbol as sym_mod
        symbol = sym_mod.load(f"{prefix}-symbol.json")
    except Exception:
        symbol = None
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
