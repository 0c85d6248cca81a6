"""K2 and K5: the AGC kernels — wrappers, plain versions, CUDA kernels.

K2 ports `t41x.kernels.agc_pallas.agc_block_pallas`: |x|, look-ahead
delay, sliding-window peak, the WDSP gain recurrence, gain curve and
delayed multiply in one launch (`t41x_torch/csrc/agc.cu`), which also
writes the new delay line and its magnitudes.  Its plain version is the
scan form of `t41x_torch.dsp.agc.agc_apply`.

K5 ports `agc_scan_pallas`: the gain recurrence alone over precomputed
ring-max and |out| streams, which `agc_apply` runs for blocks shorter
than the delay line.  Its plain version is `dsp.agc.gain_scan`.

`agc_block_phases` and `agc_scan_phases` launch the same kernels with
`clock64` stamps per phase, for measurement (`phase_split`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from t41x_torch.dsp.agc import AGCParams, AGCState, agc_apply, gain_scan
from t41x_torch.kernels import _build
# chip_smoke.py reads phase_split here, as in trees before it moved
from t41x_torch.kernels._build import phase_split  # noqa: F401

_P, _I = _build.PTR, _build.INT
_FPARAMS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P] * 10 + [_I] * 3 + [_FPARAMS] + [_I] * 2 + [_P] * 11
_SCAN_ARGS = [_P] * 9 + [_I] * 2 + [_FPARAMS] + [_I] * 2 + [_P] * 9
# the phases variants: a stamps buffer before the stream
_PHASE_ARGS, _SCAN_PHASE_ARGS = _ARGS + [_P], _SCAN_ARGS + [_P]
# what each row of stamps holds: clock64 cycles per phase, then the
# block's total cycles and nanoseconds (agc.cu)
K2_PHASES = ("staging", "window peak", "recurrence",
             "gain curve and output")
K5_PHASES = ("staging", "recurrence", "store")
_CB, _SCAN_CB = 8, 8  # channels per thread block of K2, K5 (agc.cu)
_FLOAT_FIELDS = ("attack_mult", "decay_mult", "fast_decay_mult",
                 "fast_backmult", "onemfast_backmult", "hang_backmult",
                 "onemhang_backmult", "hang_decay_mult", "out_target",
                 "min_volts", "slope_constant", "inv_max_input", "hang_level",
                 "pop_ratio")  # order of AgcP in agc.cu


def _fparams(p: AGCParams):
    return (ctypes.c_float * len(_FLOAT_FIELDS))(
        *(getattr(p, f) for f in _FLOAT_FIELDS))


def agc_block_plain(p: AGCParams, st: AGCState, x: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return agc_apply(p, st, x)


def agc_block(p: AGCParams, st: AGCState, x: torch.Tensor):
    """Whole-block AGC for a block at least one delay line long
    (N >= attack_buffsize).  st: AGCState; x: (..., N) complex64.
    Returns (new AGCState, y).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check_block(p, x)
    if not x.is_cuda:
        return agc_block_plain(p, st, x)
    return _launch(p, st, x)


def _check_block(p: AGCParams, x: torch.Tensor):
    n, b = x.shape[-1], p.attack_buffsize
    if n < b:
        raise ValueError(f"agc_block needs N >= attack_buffsize ({n} < {b})")
    if p.mode == 0:
        raise ValueError("agc_block: AGC mode 0 (off) is a fixed gain, "
                         "use agc_apply")


def _launch(p: AGCParams, st: AGCState, x: torch.Tensor, stamps=None):
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
    new_ring = torch.empty(lead + (b,), dtype=c64, device=dev)
    new_abs = torch.empty(lead + (b,), dtype=f32, device=dev)
    outs = [torch.empty(lead, dtype=f32, device=dev) for _ in range(4)] \
        + [torch.empty(lead, dtype=i32, device=dev) for _ in range(3)]
    name, args, extra = (("t41x_agc_block", _ARGS, ()) if stamps is None else
                         ("t41x_agc_block_phases", _PHASE_ARGS, (stamps,)))
    _build.launch(
        name, args, dev, x, ring, abs_ring, *fs, *ints, c, n, b,
        _fparams(p), p.hang_counter_init, p.hang_enable, y, new_ring,
        new_abs, *outs, *extra)
    agc_block.launches += 1
    return AGCState(new_ring, new_abs, *outs), y


agc_block.launches = 0  # CUDA kernel launches


def agc_scan_plain(p: AGCParams, carry, rm_t: torch.Tensor,
                   ao_t: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return gain_scan(p, carry, rm_t, ao_t)


def agc_scan(p: AGCParams, carry, rm_t: torch.Tensor, ao_t: torch.Tensor):
    """K5, the gain recurrence alone, for AGC blocks shorter than the
    delay line (`t41x.kernels.agc_pallas.agc_scan_pallas`).

    carry: 7 (...,) states (4 float32, then 3 int32); rm_t/ao_t: (N, ...)
    time-major ring-max and |out| streams.  Returns (final carry,
    volts_seq (N, ...)).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if p.mode == 0:
        raise ValueError("agc_scan: AGC mode 0 (off) has no recurrence")
    if not rm_t.is_cuda:
        return agc_scan_plain(p, carry, rm_t, ao_t)
    return _scan_launch(p, carry, rm_t, ao_t)


def _scan_launch(p: AGCParams, carry, rm_t: torch.Tensor,
                 ao_t: torch.Tensor, stamps=None):
    n, lead = rm_t.shape[0], tuple(rm_t.shape[1:])
    dev = rm_t.device
    c = math.prod(lead)
    f32, i32 = torch.float32, torch.int32
    cin = _build.cuda_input
    rm = cin("rm_t", rm_t, f32, (n,) + lead, dev)
    ao = cin("ao_t", ao_t, f32, (n,) + lead, dev)
    names = ("volts", "save_volts", "fast_backaverage", "hang_backaverage",
             "hang_counter", "decay_type", "state")
    ins = [cin(f, s, f32 if i < 4 else i32, lead, dev)
           for i, (f, s) in enumerate(zip(names, carry))]
    vseq = torch.empty((n,) + lead, dtype=f32, device=dev)
    outs = [torch.empty(lead, dtype=f32 if i < 4 else i32, device=dev)
            for i in range(7)]
    name, args, extra = (("t41x_agc_scan", _SCAN_ARGS, ()) if stamps is None
                         else ("t41x_agc_scan_phases", _SCAN_PHASE_ARGS,
                               (stamps,)))
    _build.launch(
        name, args, dev, rm, ao, *ins, c, n, _fparams(p),
        p.hang_counter_init, p.hang_enable, vseq, *outs, *extra)
    agc_scan.launches += 1
    return tuple(outs), vseq


agc_scan.launches = 0  # CUDA kernel launches


def agc_block_phases(p: AGCParams, st: AGCState, x: torch.Tensor):
    """K2 on CUDA tensors with its phase split: (new AGCState, y, stamps),
    stamps (blocks, 6) as `phase_split` reads them with `K2_PHASES`."""
    _check_block(p, x)
    stamps = _build.stamp_buffer(math.prod(x.shape[:-1]), _CB,
                                 len(K2_PHASES) + 2, x.device)
    new_st, y = _launch(p, st, x, stamps)
    return new_st, y, stamps


def agc_scan_phases(p: AGCParams, carry, rm_t: torch.Tensor,
                    ao_t: torch.Tensor):
    """K5 on CUDA tensors with its phase split: (final carry, volts_seq,
    stamps), stamps (blocks, 5) as `phase_split` reads them with
    `K5_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(rm_t.shape[1:]), _SCAN_CB,
                                 len(K5_PHASES) + 2, rm_t.device)
    new_carry, vseq = _scan_launch(p, carry, rm_t, ao_t, stamps)
    return new_carry, vseq, stamps
