"""K8: the Kim NR gain recursion for n hops — wrapper, plain version,
CUDA kernel.

Port of `t41x.kernels.nr_gain_pallas.kim_gains_pallas`: every hop's ring
writes, minimum statistics, psi rule, VAD mask, time EMA and 3-bin
smoothing in one launch (`t41x_torch/csrc/nr_gain.cu`), the X/E rings
read and written once.  The plain version is
`t41x_torch.dsp.nr.kim_gains_scan`, in the TPU kernel's arithmetic, so
the two agree bit for bit.  The gains returned are the half-spectrum
smoothed gains: the mirror map stays with the caller.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from t41x_torch.dsp.nr import HOP, KimParams, kim_consts, kim_gains_scan
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P] * 5 + [_I] * 2 + [_FLOATS] + [_I] * 2 + [_P] * 5


def kim_gains_plain(p: KimParams, gst, powers: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return kim_gains_scan(p, gst, powers)


def kim_gains(p: KimParams, gst, powers: torch.Tensor):
    """gst: (X (..., 3, HOP), E (..., 15, HOP), Gts (..., HOP), idx (...,)
    int32); powers: (n_hops, ..., HOP).  Returns ((X', E', Gts',
    idx + n_hops), gains (n_hops, ..., HOP)).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if not powers.is_cuda:
        return kim_gains_plain(p, gst, powers)
    return _launch(p, gst, powers)


def _launch(p: KimParams, gst, powers: torch.Tensor):
    X, E, Gts, idx = gst
    dev, n_hops = powers.device, powers.shape[0]
    lead = tuple(Gts.shape[:-1])
    c = math.prod(lead)
    f32, cin = torch.float32, _build.cuda_input
    powers = cin("powers", powers, f32, (n_hops,) + lead + (HOP,), dev)
    X = cin("X", X, f32, lead + (3, HOP), dev)
    E = cin("E", E, f32, lead + (15, HOP), dev)
    Gts = cin("Gts", Gts, f32, lead + (HOP,), dev)
    idx = cin("idx", idx, torch.int32, lead, dev)
    gains = torch.empty_like(powers)
    X_out, E_out, G_out = (torch.empty_like(t) for t in (X, E, Gts))
    fparams = np.asarray(kim_consts(p), np.float32)
    _build.launch(
        "t41x_kim_gains", _ARGS, dev, powers, X, E, Gts, idx, c, n_hops,
        fparams.ctypes.data_as(_FLOATS), p.vad_low, p.vad_high, gains,
        X_out, E_out, G_out)
    kim_gains.launches += 1
    return (X_out, E_out, G_out, idx + n_hops), gains


kim_gains.launches = 0  # CUDA kernel launches
