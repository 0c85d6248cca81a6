"""SSB demodulation (torch), port of `t41x.demod.ssb`.

USB and LSB share one code path: the overlap-save band-pass mask has
already selected the sideband, so demodulation is just the real part of
the filtered analytic signal (reference `Process.cpp:616-695`).
"""

from __future__ import annotations

import torch


def ssb_demod(y: torch.Tensor) -> torch.Tensor:
    """y: (..., N) complex filtered baseband -> (..., N) real audio."""
    return y.real
