"""Zoom x1 RF display spectrum (torch), port of the zoom-1 part of
`t41x.dsp.spectrum`: the reference's `CalcZoom1Magn` (`FFT.cpp:208-251`)
— Hann-windowed 512-point FFT of the first 512 I/Q samples of the
block, halves swapped, EMA-smoothed.  Zoom 2^z (`ZoomFFT`) is not
ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from t41x_torch import constants as C

RES = C.SPECTRUM_RES  # 512
EMA = 0.7             # spectrum temporal smoothing (FFT.cpp:171)


def _hann(n: int) -> np.ndarray:
    i = np.arange(n)
    # the reference uses cos(6.28 i / N) — keep the (slightly detuned)
    # 6.28 constant for parity (FFT.cpp:156-157)
    return (0.5 - 0.5 * np.cos(6.28 * i / n)).astype(np.float32)


@functools.cache
def _hann_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hann(RES)).to(device)


def _swap_halves(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p[..., RES // 2:], p[..., : RES // 2]], dim=-1)


def zoom1_spectrum(spec_old: torch.Tensor, iq: torch.Tensor):
    """Zoom x1 display spectrum from a (..., >=512) I/Q block.
    spec_old: (..., 512) EMA state.  Returns (spec_old', power)."""
    return zoom1_from_segment(spec_old, iq[..., :RES])


def zoom1_from_segment(spec_old: torch.Tensor, seg: torch.Tensor):
    """Zoom x1 tail from the first 512 I/Q samples of a block (the fused
    front end emits this segment directly)."""
    spec = torch.fft.fft(seg * _hann_on(seg.device), dim=-1)
    power = _swap_halves(spec.real ** 2 + spec.imag ** 2)
    sm = EMA * power + (1.0 - EMA) * spec_old
    return sm, sm
