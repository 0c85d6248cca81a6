"""K7: the variable-leak LMS (Xanr) over one block — wrapper, plain
version, CUDA kernel.

Port of `t41x.kernels.xanr_pallas.xanr_block_pallas`: the whole
per-sample recurrence of `t41x_torch.dsp.nr.xanr` in one launch
(`t41x_torch/csrc/xanr.cu`), one warp per channel with the weights in
registers and the regressor buffer in shared memory.  It serves NR mode
3 (prediction) and the automatic notch (error).  The public state is
newest-first (`dline`, `w`) and the recurrence runs oldest-first: the
reversals and the new delay line are formed here, as the TPU wrapper
does.  The plain version is `t41x_torch.dsp.nr.xanr_scan`.
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
_ARGS = [_P] * 5 + [_I] * 4 + [_FLOATS] + [_I] + [_P] * 5
_TAPS = 64  # the kernel's 2 taps per lane


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


def _launch(p: XanrParams, st: XanrState, x: torch.Tensor):
    if p.taps != _TAPS:
        raise ValueError(f"xanr_block: the kernel runs {_TAPS} taps "
                         f"(got {p.taps})")
    n, dev = x.shape[-1], x.device
    lead = tuple(x.shape[:-1])
    hd = p.taps + p.delay
    f32, cin = torch.float32, _build.cuda_input
    x = cin("x", x, f32, lead + (n,), dev)
    dline = cin("dline", st.dline, f32, lead + (hd,), dev)
    hist = dline.flip(-1).contiguous()                # oldest-first
    w = cin("w", st.w, f32, lead + (p.taps,), dev).flip(-1).contiguous()
    lidx = cin("lidx", st.lidx, f32, lead, dev)
    ngamma = cin("ngamma", st.ngamma, f32, lead, dev)
    y = torch.empty_like(x)
    w_out = torch.empty_like(w)
    lidx_out, ng_out = torch.empty_like(lidx), torch.empty_like(ngamma)
    fparams = np.asarray(
        [p.two_mu, p.gamma, p.den_mult, p.lidx_min, p.lidx_max, p.lincr,
         p.ldecr, 1.0 if p.notch else p.post_gain], np.float32)
    _build.launch(
        "t41x_xanr_block", _ARGS, x.data_ptr(), hist.data_ptr(),
        w.data_ptr(), lidx.data_ptr(), ngamma.data_ptr(), math.prod(lead),
        n, p.taps, hd, fparams.ctypes.data_as(_FLOATS), int(bool(p.notch)),
        y.data_ptr(), w_out.data_ptr(), lidx_out.data_ptr(),
        ng_out.data_ptr(), _build.stream_of(x))
    xanr_block.launches += 1
    new_dline = torch.cat([hist, x], dim=-1)[..., -hd:].flip(-1)
    return XanrState(new_dline, w_out.flip(-1), lidx_out, ng_out), y


xanr_block.launches = 0  # CUDA kernel launches
