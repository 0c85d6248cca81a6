"""Synchronous AM (SAM) PLL demodulation (torch), port of
`t41x.demod.sam`.

WDSP-style PLL phase detector with a 2nd-order loop filter and
fade-leveler DC insertion (reference `AMDecodeSAM` `Demod.cpp:40-139`).
The plain form is a per-sample loop over the block with channels on the
leading axes; with `use_kernels` the whole block runs in one CUDA
launch (`t41x_torch.kernels.sam`, K6).  Loop constants follow
`Demod.cpp:13-23`: zeta = 0.65, omegaN 200, pll_fmax 4000.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C


class SAMParams(NamedTuple):
    g1: float
    g2: float
    omega_min: float
    omega_max: float
    mtauR: float
    onem_mtauR: float
    mtauI: float
    onem_mtauI: float
    fade_leveler: int


def sam_params(omega_n: float = 200.0, pll_fmax: float = 4000.0,
               zeta: float = 0.65, rate: float = C.AUDIO_RATE,
               fade_leveler: int = 1) -> SAMParams:
    dt = 1.0 / rate
    g1 = 1.0 - np.exp(-2.0 * omega_n * zeta * dt)
    g2 = -g1 + 2.0 * (1.0 - np.exp(-omega_n * zeta * dt)
                      * np.cos(omega_n * dt * np.sqrt(1.0 - zeta * zeta)))
    # the reference's tauR/tauI decay constants use integer division
    # (exp(0) == 1, frozen trackers); the intended exp(-dt/tau) is used
    tauR, tauI = 0.02, 1.4
    mtauR = np.exp(-dt / tauR)
    mtauI = np.exp(-dt / tauI)
    return SAMParams(float(g1), float(g2),
                     float(-2.0 * np.pi * pll_fmax * dt),
                     float(2.0 * np.pi * pll_fmax * dt),
                     float(mtauR), float(1 - mtauR),
                     float(mtauI), float(1 - mtauI), fade_leveler)


class SAMState(NamedTuple):
    phzerror: torch.Tensor
    fil_out: torch.Tensor
    omega2: torch.Tensor
    dc: torch.Tensor          # fade-leveler audio DC tracker
    dc_insert: torch.Tensor   # fade-leveler carrier-level tracker


def sam_state(channels: tuple[int, ...] = (), device=None) -> SAMState:
    return SAMState(*(torch.zeros(channels, dtype=torch.float32,
                                  device=device) for _ in range(5)))


# atan(sqrt(u))/sqrt(u) on u in [0, 1] as a Chebyshev series, converted
# to a power series: a ~1e-7-rad atan2 from multiplies and adds only
_ATAN_COEF = np.polynomial.chebyshev.Chebyshev.interpolate(
    lambda u: np.arctan(np.sqrt(np.maximum(u, 1e-30)))
    / np.sqrt(np.maximum(u, 1e-30)), 14, domain=[0.0, 1.0]
).convert(kind=np.polynomial.Polynomial).coef.astype(np.float32)

_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))
_TWO_PI = 2.0 * math.pi


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent, |err| ~ 1e-7 rad, branchless."""
    ay, ax = y.abs(), x.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp(hi, min=1e-30)      # in [0, 1]
    u = z * z
    acc = u * float(_ATAN_COEF[-1]) + float(_ATAN_COEF[-2])
    for c in _ATAN_COEF[-3::-1]:
        acc = acc * u + float(c)
    t = z * acc                               # atan(z)
    t = torch.where(ay > ax, _HALF_PI - t, t)
    t = torch.where(x < 0, _PI - t, t)
    return torch.where(y < 0, -t, t)


def sam_step(p: SAMParams, carry, i: torch.Tensor, q: torch.Tensor):
    """One PLL sample update on (...,) channel tensors; every product and
    sum in the order of `t41x.demod.sam.sam_step` (the CUDA kernel
    rounds the same operations the same way)."""
    phz0, fil, om2, dc, dci = carry
    s, co = torch.sin(phz0), torch.cos(phz0)
    ai, bi = co * i, s * i
    aq, bq = co * q, s * q
    corr_re = ai + bq
    corr_im = aq - bi
    audio = (ai - bi) + (aq + bq)
    if p.fade_leveler:
        dc = p.mtauR * dc + p.onem_mtauR * audio
        dci = p.mtauI * dci + p.onem_mtauI * corr_re
        audio = audio + dci - dc
    det = atan2_poly(corr_im, corr_re)
    del_out = fil
    om2 = torch.clamp(om2 + p.g2 * det, p.omega_min, p.omega_max)
    fil = p.g1 * det + om2
    phz = torch.remainder(phz0 + del_out, _TWO_PI)
    return (phz, fil, om2, dc, dci), audio


def sam_scan(p: SAMParams, st: SAMState, y: torch.Tensor):
    """The block's PLL as a per-sample loop.  y: (..., N) complex64.
    Returns (new SAMState, audio (..., N))."""
    yr, yi = y.real, y.imag
    carry = tuple(st)
    audio = []
    for n in range(y.shape[-1]):
        carry, a = sam_step(p, carry, yr[..., n], yi[..., n])
        audio.append(a)
    return SAMState(*carry), torch.stack(audio, dim=-1)


def sam_demod(params: SAMParams, st: SAMState, y: torch.Tensor,
              use_kernels: bool = False):
    """y: (..., N) complex filtered baseband.  Returns (new_state, audio,
    carrier_offset_hz).  The fade-leveler trackers carry across blocks
    (the intended WDSP behaviour)."""
    if use_kernels:
        from t41x_torch.kernels.sam import sam_block
        new_st, audio = sam_block(params, st, y)
    else:
        new_st, audio = sam_scan(params, st, y)
    carrier_hz = new_st.omega2 * C.AUDIO_RATE / (2.0 * math.pi)
    return new_st, audio, carrier_hz
