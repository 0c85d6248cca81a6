"""S1: the spectral NR gain recursion for n hops — CUDA kernel launch.

`t41x.dsp.nr.spectral_nr_batch` runs the per-hop gain recursion of
UHSDR's spectral-subtraction NR as a `lax.scan` (`spectral_nr` calls its
body twice); no TPU kernel replaces it, but on the card the plain
version (`t41x_torch.dsp.nr.spectral_gains_scan`) launches ~75 small
ops a hop.  S1 (`t41x_torch/csrc/spectral_nr.cu`) computes every hop of
a call in one launch, one warp a channel: the noise tracking, the
gains, the in-band power sums, the NN choice and the box smoothing.
The gains returned are the half-spectrum gains: the mirror map and the
inverse transform stay with the caller.  The dispatch is `t41x_torch.dsp.nr.spectral_nr` /
`spectral_nr_batch` with `use_kernels`.

S1 sums the in-band powers in another order than torch, so a hop whose
power ratio lies within float32 rounding of an NN boundary may take
the other width (`t41x_torch.dsp.nr.spectral_decision_margin` gives the
plain version's margins; `parity.nr_decisions` compares); its state
recursion is elementwise in torch's rounding.  `spectral_gains_phases`
launches the same kernel with `clock64` stamps per phase
(`_build.phase_split` with `S1_PHASES`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from t41x_torch.dsp.nr import HOP, SpectralParams, spectral_consts, \
    spectral_gains_scan
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = [_P] * 5 + [_I] * 2 + [_FLOATS] + [_I] * 3 + [_P] * 8  # + stream
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]   # the stamps buffer before the stream
# what each row of stamps (one a channel) holds: clock64 cycles of the
# state load, then summed over the hops the recursion up to hk_old, the
# in-band sums and the barrier, the NN choice and the box, the stores;
# then the channel's total cycles and nanoseconds
S1_PHASES = ("state load", "recursion", "sums", "box", "stores")


def spectral_gains_plain(p: SpectralParams, gst, powers: torch.Tensor):
    """The same function in plain torch ops (any device)."""
    return spectral_gains_scan(p, gst, powers)


def spectral_gains(p: SpectralParams, gst, powers: torch.Tensor,
                   nn: torch.Tensor | None = None):
    """gst: (xt, pslp, hk_old (..., HOP) float32, frames (...,) int32);
    powers: (n_hops, ..., HOP) float32.  Returns ((xt', pslp', hk_old',
    frames + n_hops), gains (n_hops, ..., HOP), initializing (n_hops, ...,
    1) bool), as `spectral_gains_scan`.  CPU tensors take the plain
    version; CUDA tensors launch S1, which also writes each hop's NN
    choice (0..4, int32) into `nn` (n_hops, ...) when it is given."""
    if not powers.is_cuda:
        return spectral_gains_plain(p, gst, powers)
    return _launch(p, gst, powers, nn)


def spectral_gains_phases(p: SpectralParams, gst, powers: torch.Tensor):
    """S1 on CUDA tensors with its phase split: (gst', gains,
    initializing, stamps), stamps as `_build.phase_split` reads them with
    `S1_PHASES`."""
    c = math.prod(powers.shape[1:-1])
    stamps = _build.stamp_buffer(c, 1, len(S1_PHASES) + 2, powers.device)
    return (*_launch(p, gst, powers, None, stamps), stamps)


def _launch(p: SpectralParams, gst, powers: torch.Tensor, nn, stamps=None):
    xt, pslp, hk, frames = gst
    dev, n_hops = powers.device, powers.shape[0]
    if n_hops == 0:
        raise ValueError("S1: no hops to run")
    lead = tuple(xt.shape[:-1])
    c = math.prod(lead)
    f32, cin = torch.float32, _build.cuda_input
    al = _build.aligned   # S1 reads the float planes as 16-byte vectors
    powers = al(cin("powers", powers, f32, (n_hops,) + lead + (HOP,), dev))
    xt = al(cin("xt", xt, f32, lead + (HOP,), dev))
    pslp = al(cin("pslp", pslp, f32, lead + (HOP,), dev))
    hk = al(cin("hk_old", hk, f32, lead + (HOP,), dev))
    frames = cin("frames", frames, torch.int32, lead, dev)
    if nn is not None and not (
            nn.device == dev and nn.dtype == torch.int32
            and nn.is_contiguous() and tuple(nn.shape) == (n_hops,) + lead):
        raise ValueError(f"S1: nn must be a contiguous int32 tensor of "
                         f"shape {(n_hops,) + lead} on {dev}")
    gains = torch.empty_like(powers)
    inits = torch.empty((n_hops,) + lead + (1,), dtype=torch.bool,
                        device=dev)
    xt_o, pslp_o, hk_o = (torch.empty_like(t) for t in (xt, pslp, hk))
    frames_o = torch.empty_like(frames)
    fparams = np.asarray(spectral_consts(p), np.float32)
    name, args, extra = (
        ("t41x_spectral_gains", _ARGS, ()) if stamps is None
        else ("t41x_spectral_gains_phases", _PHASE_ARGS, (stamps,)))
    if c:
        _build.launch(
            name, args, dev, powers, xt, pslp, hk, frames, c, n_hops,
            fparams.ctypes.data_as(_FLOATS), p.init_frames, p.vad_low,
            p.vad_high, gains, inits, xt_o, pslp_o, hk_o, frames_o, nn,
            *extra)
        spectral_gains.launches += 1
    return (xt_o, pslp_o, hk_o, frames_o), gains, inits


spectral_gains.launches = 0  # CUDA kernel launches


def arith_probe(a: torch.Tensor, b: torch.Tensor):
    """S1's branch-free IEEE division and square root on the card, for
    its tests: (a / b, sqrt(|a|)) for float32 CUDA tensors a, b of one
    shape with a multiple of 4 elements, b > 0.  Not on any main path."""
    dev = a.device
    if not (a.is_cuda and a.shape == b.shape and a.numel() % 4 == 0):
        raise ValueError("arith_probe: two CUDA tensors of one shape, a "
                         "multiple of 4 elements")
    a = _build.aligned(_build.cuda_input("a", a, torch.float32, a.shape, dev))
    b = _build.aligned(_build.cuda_input("b", b, torch.float32, a.shape, dev))
    q, r = torch.empty_like(a), torch.empty_like(a)
    _build.launch("t41x_spectral_arith", [_P, _P, _I, _P, _P, _P], dev, a, b,
                  a.numel(), q, r)
    return q, r
