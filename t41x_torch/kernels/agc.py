"""K2: one whole AGC block — wrapper, plain version, CUDA kernel.

Port of `t41x.kernels.agc_pallas.agc_block_pallas`: |x|, look-ahead
delay, sliding-window peak, the WDSP gain recurrence, gain curve and
delayed multiply in one launch (`t41x_torch/csrc/agc.cu`).  The plain
version is the scan form of `t41x_torch.dsp.agc.agc_apply`.  The new
delay line and its magnitudes are formed here, as the TPU wrapper does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from t41x_torch.dsp.agc import AGCParams, AGCState, agc_apply
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_ARGS = [_P] * 10 + [_I] * 3 + [ctypes.POINTER(ctypes.c_float)] + [_I] * 2 \
    + [_P] * 9
_FLOAT_FIELDS = ("attack_mult", "decay_mult", "fast_decay_mult",
                 "fast_backmult", "onemfast_backmult", "hang_backmult",
                 "onemhang_backmult", "hang_decay_mult", "out_target",
                 "min_volts", "slope_constant", "inv_max_input", "hang_level",
                 "pop_ratio")  # order of AgcP in agc.cu


def agc_block_plain(p: AGCParams, st: AGCState, x: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return agc_apply(p, st, x)


def agc_block(p: AGCParams, st: AGCState, x: torch.Tensor):
    """Whole-block AGC for a block at least one delay line long
    (N >= attack_buffsize).  st: AGCState; x: (..., N) complex64.
    Returns (new AGCState, y).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    n, b = x.shape[-1], p.attack_buffsize
    if n < b:
        raise ValueError(f"agc_block needs N >= attack_buffsize ({n} < {b})")
    if p.mode == 0:
        raise ValueError("agc_block: AGC mode 0 (off) is a fixed gain, "
                         "use agc_apply")
    if not x.is_cuda:
        return agc_block_plain(p, st, x)
    return _launch(p, st, x)


def _launch(p: AGCParams, st: AGCState, x: torch.Tensor):
    n, b = x.shape[-1], p.attack_buffsize
    dev = x.device
    lead = tuple(x.shape[:-1])
    c = math.prod(lead)
    f32, i32, c64 = torch.float32, torch.int32, torch.complex64
    cin = _build.cuda_input
    x = cin("x", x, c64, lead + (n,), dev)
    ring = cin("ring", st.ring, c64, lead + (b,), dev)
    abs_ring = cin("abs_ring", st.abs_ring, f32, lead + (b,), dev)
    fs = [cin(f, getattr(st, f), f32, lead, dev)
          for f in ("volts", "save_volts", "fast_backaverage",
                    "hang_backaverage")]
    ints = [cin(f, getattr(st, f), i32, lead, dev)
            for f in ("hang_counter", "decay_type", "state")]

    y = torch.empty_like(x)
    outs = [torch.empty(lead, dtype=f32, device=dev) for _ in range(4)] \
        + [torch.empty(lead, dtype=i32, device=dev) for _ in range(3)]
    fparams = (ctypes.c_float * len(_FLOAT_FIELDS))(
        *(getattr(p, f) for f in _FLOAT_FIELDS))
    _build.launch(
        "t41x_agc_block", _ARGS, x.data_ptr(), ring.data_ptr(),
        abs_ring.data_ptr(), *(t.data_ptr() for t in fs + ints), c, n, b,
        fparams, p.hang_counter_init, p.hang_enable, y.data_ptr(),
        *(t.data_ptr() for t in outs), _build.stream_of(x))
    agc_block.launches += 1
    new_ring = x[..., n - b:].contiguous()
    return AGCState(new_ring, new_ring.abs(), *outs), y


agc_block.launches = 0  # CUDA kernel launches
