"""Frequency translation (torch), port of `t41x.dsp.nco`.

* `fs4_shift` — multiplication-free +Fs/4 translation (reference
  `FreqShift1`, `Freq_Shift.cpp:42-65`): x[n] * j**n, exact.
* `nco_mix` — fine-tune mix DOWN by the NCO frequency with the phase
  carried across blocks (reference `FreqShift2`, `Freq_Shift.cpp:94-141`),
  closed-form phase ramp exp(-i(phi0 + (n+1)w)).
"""

from __future__ import annotations

import functools
import math

import torch

from t41x_torch import constants as C

# The reference scales the mixed signal by this fudge factor
# (`Freq_Shift.cpp:137` freqAdjFactor); kept for parity.
FREQ_ADJ_FACTOR = 1.1


@functools.cache
def _fs4_pattern(n: int, device: torch.device) -> torch.Tensor:
    """j**n for n < N, made once per block length and device (a host
    tensor uploaded on every call would wait for the stream)."""
    return torch.tensor([1, 1j, -1, -1j], dtype=torch.complex64).repeat(
        n // 4).to(device)


def fs4_shift(x: torch.Tensor) -> torch.Tensor:
    """Multiply by j**n along the last axis (block length divisible by 4)."""
    n = x.shape[-1]
    assert n % 4 == 0
    return x * _fs4_pattern(n, x.device)


def nco_phase_inc(freq_hz: torch.Tensor, fs: float = C.SAMPLE_RATE):
    """Per-sample NCO phase increment (reference `NCO_INC`,
    `Freq_Shift.cpp:121`), float32."""
    return 2.0 * math.pi * freq_hz.to(torch.float32) / fs


def nco_mix(phase: torch.Tensor, x: torch.Tensor, freq_hz: torch.Tensor,
            fs: float = C.SAMPLE_RATE, gain: float = FREQ_ADJ_FACTOR):
    """Mix x DOWN by freq_hz with carried phase.

    phase: (...,) radians; x: (..., N) complex64; freq_hz: (...,).
    Returns (new_phase, y).
    """
    n = x.shape[-1]
    w = nco_phase_inc(freq_hz, fs)
    steps = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    theta = phase[..., None] + w[..., None] * steps
    y = (gain * x) * torch.complex(torch.cos(theta), -torch.sin(theta))
    new_phase = torch.remainder(phase + w * n, 2.0 * math.pi)
    return new_phase, y
