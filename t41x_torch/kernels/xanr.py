"""K7: the variable-leak LMS (Xanr) over one block — wrapper, plain
version, CUDA kernel.

Port of `t41x.kernels.xanr_pallas.xanr_block_pallas`: the whole
per-sample recurrence of `t41x_torch.dsp.nr.xanr` in one launch
(`t41x_torch/csrc/xanr.cu`), 8 lanes a channel with the weights in
registers and the regressor buffer in shared memory.  It serves NR mode
3 (prediction) and the automatic notch (error).  The kernel reads the
newest-first state (`dline`, `w`) as it is and writes the new one, so
this wrapper only allocates.  The plain version is
`t41x_torch.dsp.nr.xanr_scan`; on the card the kernel equals it bit for
bit.

`xanr_block_phases` launches the same kernel with `clock64` stamps per
phase, for measurement (`t41x_torch.kernels._build.phase_split`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from t41x_torch.dsp.nr import XanrParams, XanrState, xanr_scan
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P] * 5 + [_I] * 4 + [_FLOATS] + [_I] + [_P] * 6
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]  # a stamps buffer before the stream
_TAPS = 64  # the kernel's taps (xanr.cu)
_CB = 8     # channels per thread block (xanr.cu)
# what each row of stamps holds: clock64 cycles per phase, then the
# block's total cycles and nanoseconds (xanr.cu)
K7_PHASES = ("staging", "input-only factors", "loop", "store")


def xanr_block_plain(p: XanrParams, st: XanrState, x: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return xanr_scan(p, st, x)


def xanr_block(p: XanrParams, st: XanrState, x: torch.Tensor):
    """st: XanrState (newest-first); x: (..., N) float32 audio.  Returns
    (new XanrState, y).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not x.is_cuda:
        return xanr_block_plain(p, st, x)
    return _launch(p, st, x)


def _launch(p: XanrParams, st: XanrState, x: torch.Tensor, stamps=None):
    if p.taps != _TAPS:
        raise ValueError(f"xanr_block: the kernel runs {_TAPS} taps "
                         f"(got {p.taps})")
    n, dev = x.shape[-1], x.device
    lead = tuple(x.shape[:-1])
    hd = p.taps + p.delay
    f32, cin = torch.float32, _build.cuda_input
    x = cin("x", x, f32, lead + (n,), dev)
    dline = cin("dline", st.dline, f32, lead + (hd,), dev)
    w = cin("w", st.w, f32, lead + (p.taps,), dev)
    lidx = cin("lidx", st.lidx, f32, lead, dev)
    ngamma = cin("ngamma", st.ngamma, f32, lead, dev)
    y = torch.empty_like(x)
    new = XanrState(torch.empty_like(dline), torch.empty_like(w),
                    torch.empty_like(lidx), torch.empty_like(ngamma))
    fparams = np.asarray(
        [p.two_mu, p.gamma, p.den_mult, p.lidx_min, p.lidx_max, p.lincr,
         p.ldecr, 1.0 if p.notch else p.post_gain], np.float32)
    name, args, extra = (("t41x_xanr_block", _ARGS, ()) if stamps is None
                         else ("t41x_xanr_block_phases", _PHASE_ARGS,
                               (stamps,)))
    _build.launch(
        name, args, dev, x, dline, w, lidx, ngamma, math.prod(lead), n,
        p.taps, hd, fparams.ctypes.data_as(_FLOATS), int(bool(p.notch)), y,
        *new, *extra)
    xanr_block.launches += 1
    return new, y


xanr_block.launches = 0  # CUDA kernel launches


def xanr_block_phases(p: XanrParams, st: XanrState, x: torch.Tensor):
    """K7 on CUDA tensors with its phase split: (new XanrState, y,
    stamps), stamps (blocks, 6) as `phase_split` reads them with
    `K7_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(x.shape[:-1]), _CB,
                                 len(K7_PHASES) + 2, x.device)
    new_st, y = _launch(p, st, x, stamps)
    return new_st, y, stamps
