"""Stateful streaming FIR stages (torch).

Port of `t41x.dsp.fir`: the CMSIS streaming FIR primitives the reference
uses (`arm_fir_decimate_f32`, `arm_fir_interpolate_f32`,
`Process.cpp:474-479,917-920`) as `(state, block) -> (state, out)`
functions whose state is the filter history, so blocks chain exactly.
Channels ride the leading axes; taps are real and complex inputs are
filtered as two real streams sharing the taps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fir_state(taps: int, channels: tuple[int, ...] = (),
              dtype=torch.float32, device=None) -> torch.Tensor:
    """Zero history for a streaming FIR with `taps` coefficients."""
    return torch.zeros(channels + (taps - 1,), dtype=dtype, device=device)


def _real_pair(x: torch.Tensor) -> torch.Tensor:
    """(..., N) complex -> (2 * prod(...), N) float rows [re | im]."""
    return torch.cat([x.real.reshape(-1, x.shape[-1]),
                      x.imag.reshape(-1, x.shape[-1])])


def _from_pair(y: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    re, im = y.chunk(2)
    return torch.complex(re, im).reshape(lead + (y.shape[-1],))


def fir_decimate(state: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                 factor: int):
    """Streaming FIR decimator (CMSIS `arm_fir_decimate_f32` semantics:
    causal filter over the continued stream, keeping every `factor`-th
    output, newest-sample phase).

    state: (..., T-1) history (same dtype as x); x: (..., N), N divisible
    by factor; h: (T,) real taps.  Returns (new_state, y (..., N/factor)).
    """
    taps = h.shape[0]
    xc = torch.cat([state, x], dim=-1)                 # (..., T-1+N)
    new_state = xc[..., -(taps - 1):]
    lead = x.shape[:-1]
    rows = (_real_pair(xc) if xc.is_complex()
            else xc.reshape(-1, xc.shape[-1]))
    # out[n] = sum_k xc[n*factor + factor-1 + k] * h[T-1-k]
    y = F.conv1d(rows[:, None, factor - 1:], h.flip(0)[None, None],
                 stride=factor)[:, 0]
    y = _from_pair(y, lead) if xc.is_complex() else y.reshape(
        lead + (y.shape[-1],))
    return new_state, y


def fir_apply(state: torch.Tensor, x: torch.Tensor, h: torch.Tensor):
    """Streaming FIR filter (CMSIS `arm_fir_f32`): decimation by 1."""
    return fir_decimate(state, x, h, 1)


def fir_interpolate(state: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                    factor: int):
    """Streaming FIR interpolator (CMSIS `arm_fir_interpolate_f32`
    semantics: zero-stuff by `factor` then filter; no gain compensation —
    the caller scales by `factor`, `Process.cpp:929`).

    state: (..., T/factor - 1) history of input-rate samples (real);
    x: (..., N) real; h: (T,) taps, T divisible by factor.
    Returns (new_state, y (..., N*factor)).
    """
    taps = h.shape[0]
    assert taps % factor == 0, "interpolator taps must divide by factor"
    sub = taps // factor
    xc = torch.cat([state, x], dim=-1)                 # (..., sub-1+N)
    new_state = xc[..., -(sub - 1):]
    lead = x.shape[:-1]
    # polyphase: y[n*L + p] = sum_m h[m*L + p] * x[n - m]
    hp = h.reshape(sub, factor)
    out = F.conv1d(xc.reshape(-1, 1, xc.shape[-1]),
                   hp.flip(0).T[:, None, :])           # (rows, L, N)
    y = out.transpose(1, 2).reshape(lead + (-1,))      # interleave phases
    return new_state, y


def decimate_reference(x: np.ndarray, h: np.ndarray, factor: int) -> np.ndarray:
    """NumPy oracle for tests: one-shot decimation of a zero-history
    stream with the same phase convention (`t41x.dsp.fir`'s, copied)."""
    taps = len(h)
    xc = np.concatenate([np.zeros(taps - 1, x.dtype), x])
    n_out = len(x) // factor
    y = np.empty(n_out, dtype=np.result_type(x, h))
    for n in range(n_out):
        seg = xc[n * factor + factor - 1: n * factor + factor - 1 + taps]
        y[n] = np.dot(seg, h[::-1])
    return y
