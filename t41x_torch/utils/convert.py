"""Carry parameters and state between `t41x` and the port.

`t41x` keeps `ChannelParams` and `RxState` as NamedTuples of NumPy (or
JAX) arrays; the port keeps the same fields as tensors.  These helpers
convert leaf by leaf, so a stream can start in one package and continue
in the other mid-way.  Nothing here imports `t41x`: a state going back
keeps the port's NamedTuple types with NumPy leaves, which `t41x`'s
chain reads by field name like its own.
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch.chain.rx import ChannelParams, RxState
from t41x_torch.dsp.agc import AGCState


def _map(fn, tree):
    """Apply `fn` to every array leaf of nested (named) tuples, keeping
    each tuple's own type; () stays ()."""
    if isinstance(tree, tuple):
        vals = [_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def _to_tensor(device):
    return lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def params_from_numpy(params, device="cpu") -> ChannelParams:
    """t41x `ChannelParams` (array leaves) -> the port's, on `device`."""
    return ChannelParams(*_map(_to_tensor(device), tuple(params)))


def state_from_numpy(state, device="cpu") -> RxState:
    """t41x `RxState` (NumPy leaves, or arrays `np.asarray` accepts) ->
    the port's `RxState` of tensors on `device`."""
    leaves = dict(zip(RxState._fields,
                      _map(_to_tensor(device), tuple(state))))
    leaves["agc"] = AGCState(*leaves["agc"])
    return RxState(**leaves)


def state_to_numpy(state):
    """The port's state (any NamedTuple tree of tensors) -> the same
    tree with NumPy leaves, ready for `t41x`'s chain."""
    return _map(_to_numpy, state)
