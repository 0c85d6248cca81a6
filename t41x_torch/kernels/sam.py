"""K6: the SAM PLL over one block — wrapper, plain version, CUDA kernel.

Port of `t41x.kernels.sam_pallas.sam_block_pallas`: the synchronous-AM
phase-locked loop (`t41x_torch.demod.sam.sam_step`) run serially over
the block's samples in one launch (`t41x_torch/csrc/sam.cu`): a lane per
channel runs the phase loop two steps at a time with its three loop
states in registers; the audio and the fade-leveler trackers follow
from the stored phases.  The plain version is the per-sample torch loop
`t41x_torch.demod.sam.sam_scan`; the kernel equals it bit for bit.

`sam_block_phases` launches the same kernel with `clock64` stamps per
phase, for measurement (`t41x_torch.kernels._build.phase_split`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from t41x_torch.demod.sam import (_ATAN_COEF, _HALF_PI, _PI, _TWO_PI,
                                  SAMParams, SAMState, sam_scan)
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P] * 6 + [_I] * 2 + [_FLOATS] * 2 + [_I] * 2 + [_P] * 7
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]  # a stamps buffer before the stream
_MAX_N = 1613  # (4 N + 2) x 9 floats of shared memory must fit 227 KB
_CB = 8        # channels per thread block (sam.cu)
# what each row of stamps holds: clock64 cycles per phase, then the
# block's total cycles and nanoseconds (sam.cu)
K6_PHASES = ("staging", "phase loop", "audio and trackers", "store")


def sam_block_plain(p: SAMParams, st: SAMState, y: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return sam_scan(p, st, y)


def sam_block(p: SAMParams, st: SAMState, y: torch.Tensor):
    """st: SAMState of (...,) float32; y: (..., N) complex64 baseband.
    Returns (new SAMState, audio (..., N) float32).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not y.is_cuda:
        return sam_block_plain(p, st, y)
    return _launch(p, st, y)


def _launch(p: SAMParams, st: SAMState, y: torch.Tensor, stamps=None):
    n, dev = y.shape[-1], y.device
    if n > _MAX_N:
        raise ValueError(f"sam_block: blocks of at most {_MAX_N} samples "
                         f"(got {n})")
    lead = tuple(y.shape[:-1])
    f32, cin = torch.float32, _build.cuda_input
    y = cin("y", y, torch.complex64, lead + (n,), dev)
    states = [cin(f, s, f32, lead, dev) for f, s in zip(st._fields, st)]
    audio = torch.empty(lead + (n,), dtype=f32, device=dev)
    outs = [torch.empty(lead, dtype=f32, device=dev) for _ in range(5)]
    fparams = np.asarray(list(p[:8]) + [_HALF_PI, _PI, _TWO_PI], np.float32)
    coef = np.ascontiguousarray(_ATAN_COEF, np.float32)
    name, args, extra = (("t41x_sam_block", _ARGS, ()) if stamps is None else
                         ("t41x_sam_block_phases", _PHASE_ARGS, (stamps,)))
    _build.launch(
        name, args, dev, y, *states, math.prod(lead), n,
        fparams.ctypes.data_as(_FLOATS), coef.ctypes.data_as(_FLOATS),
        len(coef), int(bool(p.fade_leveler)), audio, *outs, *extra)
    sam_block.launches += 1
    return SAMState(*outs), audio


sam_block.launches = 0  # CUDA kernel launches


def sam_block_phases(p: SAMParams, st: SAMState, y: torch.Tensor):
    """K6 on CUDA tensors with its phase split: (new SAMState, audio,
    stamps), stamps (blocks, 6) as `phase_split` reads them with
    `K6_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(y.shape[:-1]), _CB,
                                 len(K6_PHASES) + 2, y.device)
    new_st, audio = _launch(p, st, y, stamps)
    return new_st, audio, stamps


def loop_ops(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(sin x, cos x, a / b) as the kernel's phase loop forms them, for
    their check against torch.sin, torch.cos and torch's division: x
    float32 in [0, 2 pi], 0 <= a <= b.  CPU tensors take those torch
    ops."""
    if not x.is_cuda:
        return torch.sin(x), torch.cos(x), a / b
    n, f32 = x.numel(), torch.float32
    x, a, b = (_build.cuda_input(nm, t, f32, (n,), x.device)
               for nm, t in (("x", x), ("a", a), ("b", b)))
    s, c, q = (torch.empty_like(x) for _ in range(3))
    _build.launch("t41x_sam_loop_ops", [_P] * 3 + [_I] + [_P] * 4,
                  x.device, x, a, b, n, s, c, q)
    return s, c, q
