"""K6: the SAM PLL over one block — wrapper, plain version, CUDA kernel.

Port of `t41x.kernels.sam_pallas.sam_block_pallas`: the synchronous-AM
phase-locked loop (`t41x_torch.demod.sam.sam_step`) run serially over
the block's samples in one launch (`t41x_torch/csrc/sam.cu`), one
thread per channel with its five loop states in registers.  The plain
version is the per-sample torch loop `t41x_torch.demod.sam.sam_scan`.
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
_MAX_N = 880  # 2 x N x 33 floats of staging must fit 227 KB of shared memory


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


def _launch(p: SAMParams, st: SAMState, y: torch.Tensor):
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
    _build.launch(
        "t41x_sam_block", _ARGS, y.data_ptr(),
        *(s.data_ptr() for s in states), math.prod(lead), n,
        fparams.ctypes.data_as(_FLOATS), coef.ctypes.data_as(_FLOATS),
        len(coef), int(bool(p.fade_leveler)), audio.data_ptr(),
        *(o.data_ptr() for o in outs), _build.stream_of(y))
    sam_block.launches += 1
    return SAMState(*outs), audio


sam_block.launches = 0  # CUDA kernel launches
