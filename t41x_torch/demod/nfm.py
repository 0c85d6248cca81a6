"""Narrow-band FM quadrature-discriminator demodulation (torch), port of
`t41x.demod.nfm`.

y[n] = K * (q[n] i[n-1] - i[n] q[n-1]) / (i[n]^2 + q[n]^2), then a hard
limiter to [-1, 1] (reference `nfmdemod` `Demod.cpp:220-235` and limiter
`Process.cpp:719-727`).  One complex sample of carried state.
"""

from __future__ import annotations

import torch

# csdr's discriminator gain (reference `Demod.h:7`).
FMDEMOD_QUADRI_K = 0.3404475502381010


def nfm_state(channels: tuple[int, ...] = (), device=None) -> torch.Tensor:
    """(...,) complex64 carried last sample, zero."""
    return torch.zeros(channels, dtype=torch.complex64, device=device)


def nfm_demod(last: torch.Tensor, z: torch.Tensor, limit: bool = True):
    """last: (...,) complex; z: (..., N) complex baseband at audio rate.
    Returns (new_last, audio) with audio real (..., N)."""
    zprev = torch.cat([last[..., None], z[..., :-1]], dim=-1)
    i, q = z.real, z.imag
    il, ql = zprev.real, zprev.imag
    power = i * i + q * q
    out = FMDEMOD_QUADRI_K * (q * il - i * ql) / torch.clamp(power,
                                                             min=1e-20)
    if limit:
        out = torch.clamp(out, -1.0, 1.0)
    return z[..., -1], out
