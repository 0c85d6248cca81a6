"""Carry parameters and state between `t41x` and the port.

`t41x` keeps `ChannelParams` and `RxState` as NamedTuples of NumPy (or
JAX) arrays; the port keeps the same fields as tensors.  These helpers
convert leaf by leaf, so a stream can start in one package and continue
in the other mid-way.  Every nested state (AGC, SAM, Kim/spectral/LMS NR,
notch, CW detector, zoom 2^z panadapter) is rebuilt as the port's
NamedTuple of the same field names.
Nothing here imports `t41x`: a state going back keeps the port's
NamedTuple types with NumPy leaves, which `t41x`'s chain reads by field
name like its own.
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch.chain.rx import ChannelParams, RxState
from t41x_torch.demod.cw import CWState
from t41x_torch.demod.sam import SAMState
from t41x_torch.dsp.agc import AGCState
from t41x_torch.dsp.nr import KimState, SpectralState, XanrState
from t41x_torch.dsp.spectrum import ZoomState

# the port's nested state types, by their field names
_STATE_TYPES = {T._fields: T for T in (AGCState, SAMState, KimState,
                                       SpectralState, XanrState, CWState,
                                       ZoomState)}


def _map(fn, tree, types=None):
    """Apply `fn` to every array leaf of nested (named) tuples; () stays
    ().  A NamedTuple keeps its own type, or becomes `types[fields]`
    where `types` names one for its field names."""
    if isinstance(tree, tuple):
        vals = [_map(fn, v, types) for v in tree]
        if not hasattr(tree, "_fields"):
            return tuple(vals)
        return (types or {}).get(tree._fields, type(tree))(*vals)
    return fn(tree)


def _to_tensor(device):
    return lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def params_from_numpy(params, device="cuda") -> ChannelParams:
    """t41x `ChannelParams` (array leaves) -> the port's, on `device`."""
    return ChannelParams(*_map(_to_tensor(device), tuple(params)))


def state_from_numpy(state, device="cuda") -> RxState:
    """t41x `RxState` (NumPy leaves, or arrays `np.asarray` accepts) ->
    the port's `RxState` of tensors on `device`, every nested state as
    the port's type."""
    return RxState(*_map(_to_tensor(device), tuple(state), _STATE_TYPES))


def state_to_numpy(state):
    """The port's state (any NamedTuple tree of tensors) -> the same
    tree with NumPy leaves, ready for `t41x`'s chain."""
    return _map(_to_numpy, state)
