"""AM envelope demodulation (torch), port of `t41x.demod.am`.

alpha-max + beta-min magnitude approximation followed by a one-pole DC
removal and a biquad lowpass (reference `Process.cpp:697-707`,
`AlphaBetaMag` `Utility.cpp:269-285`), the two filters as one
chunk-parallel 2-stage `iir.BiquadChunked` cascade.
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch.dsp import iir

ALPHA = 0.960433870103
BETA = 0.397824734759


def alpha_beta_mag(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """|i + jq| approximated as alpha*max(|i|,|q|) + beta*min(|i|,|q|)."""
    ai, aq = i.abs(), q.abs()
    return ALPHA * torch.maximum(ai, aq) + BETA * torch.minimum(ai, aq)


def am_post_cascade(lp_b, lp_a, pole: float = 0.99):
    """(b, a) for the 2-stage post-detector cascade: the one-pole DC
    removal (`wold` recurrence, Process.cpp:700-704 — expressed as the
    equivalent biquad b=[1,-1,0], a=[1,-pole,0]) followed by the audio
    lowpass (NumPy, design time)."""
    b = np.vstack([[1.0, -1.0, 0.0], np.reshape(lp_b, (3,))])
    a = np.vstack([[1.0, -pole, 0.0], np.reshape(lp_a, (3,))])
    return b.astype(np.float32), a.astype(np.float32)


def am_demod(bq_state: torch.Tensor, y: torch.Tensor,
             op: iir.BiquadChunked):
    """y: (..., N) complex filtered baseband; bq_state: (..., 2, 2)
    cascade state.  Returns (bq_state, audio)."""
    return op.apply(bq_state, alpha_beta_mag(y.real, y.imag))
