"""C1: the mic compressor's envelope — CUDA kernel launch.

`t41x.chain.compressor.compress` runs its envelope as a `lax.scan`; no
TPU kernel replaces it, but on the card the plain per-sample loop
launches ~5 small ops for each of a block's 2048 samples, far beyond a
block's 10.667 ms budget, and the default SSB transmit path runs it.  C1
(`t41x_torch/csrc/compressor.cu`) computes the level, the envelope
recurrence and the gain in one launch, in the plain version's float32
order.  The dispatch (CPU tensors to the plain version
`t41x_torch.chain.compressor.compress_plain`, CUDA tensors here) is
`t41x_torch.chain.compressor.compress`.

`compress_phases` launches the same kernel with `clock64` stamps per
phase, for measurement (`_build.phase_split` with `C1_PHASES`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from t41x_torch.chain.compressor import (CompressorParams, CompressorState,
                                         gain_consts)
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P, _P, _I, _I, _FLOATS, _P, _P, _P]
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]   # the stamps buffer before the stream
# what each row of stamps holds: clock64 cycles per phase, summed over
# the block's chunks, then the block's total cycles and nanoseconds
C1_PHASES = ("levels", "envelope", "gain and output")
_CH = 8  # channels a thread block (compressor.cu)


def launch(p: CompressorParams, st: CompressorState, x: torch.Tensor,
           stamps: torch.Tensor | None = None):
    """C1 on CUDA tensors: x (..., N) float32, st.env_db (...,).  Returns
    (state, y); raises if the kernel cannot build or launch, or on
    tensors it does not take."""
    dev, n = x.device, x.shape[-1]
    lead = tuple(x.shape[:-1])
    c = math.prod(lead)
    x = _build.cuda_input("x", x, torch.float32, lead + (n,), dev)
    env = _build.cuda_input("env_db", st.env_db, torch.float32, lead, dev)
    y = torch.empty_like(x)
    env_out = torch.empty_like(env)
    consts = gain_consts(p)
    name, args, extra = (("t41x_compress", _ARGS, ()) if stamps is None
                         else ("t41x_compress_phases", _PHASE_ARGS,
                               (stamps.data_ptr(),)))
    _build.launch(name, args, x.data_ptr(), env.data_ptr(), c, n,
                  consts.ctypes.data_as(_FLOATS), y.data_ptr(),
                  env_out.data_ptr(), *extra, _build.stream_of(x))
    launch.launches += 1
    return CompressorState(env_out), y


launch.launches = 0  # CUDA kernel launches


def compress_phases(p: CompressorParams, st: CompressorState,
                    x: torch.Tensor):
    """C1 on CUDA tensors with its phase split: (state, y, stamps),
    stamps (blocks, 5) as `_build.phase_split` reads them with
    `C1_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(x.shape[:-1]), _CH,
                                 len(C1_PHASES) + 2, x.device)
    new_st, y = launch(p, st, x, stamps)
    return new_st, y, stamps
