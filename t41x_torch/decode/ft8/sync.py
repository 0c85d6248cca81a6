"""FT8 Costas sync search (torch, device side), port of
`t41x.decode.ft8.sync`.

Re-expression of the reference's `find_sync` (tmr4/T41_SDR
`ft8.cpp:337-422`) as a fully vectorized score tensor: instead of the
reference's triple loop + min-heap of 20 candidates, the sync score
  score(dt, ts, fs, df) = mean over the 21 sync symbols of
                          (8*P[tone] - sum_j P[j])
is computed for ALL (time offset, time_sub, freq_sub, freq offset)
at once, and candidates come from one `torch.topk`.

The 8-bin sum is a difference of a float32 running sum over the 512 dB
bins, as in t41x: its rounding differs from t41x's by ~1e-3 of a score.
Time padding is NaN and is masked out of the mean before the top-k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from t41x_torch.decode.ft8.tables import COSTAS, NN


class Candidates(NamedTuple):
    score: torch.Tensor       # (K,)
    time_offset: torch.Tensor  # (K,) symbol slots (may be negative)
    time_sub: torch.Tensor
    freq_sub: torch.Tensor
    freq_offset: torch.Tensor  # (K,) 6.25 Hz bins


_SYM_OFFSETS = np.asarray([m + k for m in (0, 36, 72) for k in range(7)])
_TONE_OF_SYM = np.asarray([COSTAS[k] for _ in (0, 36, 72)
                           for k in range(7)])


def sync_scores(wf: torch.Tensor, max_time_pad: int = 7):
    """wf: (n_slots, 2, 2, n_bins) waterfall in dB.
    Returns scores (n_dt, 2, 2, n_df) where dt index 0 corresponds to
    time_offset = -max_time_pad and df spans bins 0..n_bins-8."""
    n_slots, _, _, n_bins = wf.shape
    pad, dev = max_time_pad, wf.device
    # pad time with NaN so out-of-range sync symbols drop out of the mean
    nan = wf.new_full((1,) + wf.shape[1:], float("nan"))
    wfp = torch.cat([nan.expand(pad, -1, -1, -1), wf,
                     nan.expand(pad + NN, -1, -1, -1)])

    n_dt = max(n_slots - NN + 2 * pad + 1, 0)
    n_df = n_bins - 8

    # gather P for all sync symbols: (n_dt, 21, 2, 2, n_bins)
    slot_idx = (torch.arange(n_dt, device=dev)[:, None]
                + torch.from_numpy(_SYM_OFFSETS).to(dev)[None, :])
    P = wfp[slot_idx]

    # power at the expected Costas tone bin, for every df at once
    tone_bin = (torch.arange(n_df, device=dev)[None, :]
                + torch.from_numpy(_TONE_OF_SYM).to(dev)[:, None])
    p_tone = torch.gather(P, -1, tone_bin[None, :, None, None, :].expand(
        n_dt, -1, 2, 2, -1))                              # (dt,21,2,2,n_df)

    # sum of the 8 bins starting at df
    csum = torch.cumsum(torch.nn.functional.pad(P, (1, 0)), dim=-1)
    p_sum8 = (csum[..., 8:] - csum[..., :-8])[..., :n_df]

    per_sym = 8.0 * p_tone - p_sum8
    valid = ~torch.isnan(per_sym)
    per_sym = torch.where(valid, per_sym, 0.0)
    n_valid = torch.clamp_min(valid.sum(dim=1), 1)
    return per_sym.sum(dim=1) / n_valid  # (n_dt, 2, 2, n_df)


def top_candidates(scores: torch.Tensor, k: int = 20,
                   max_time_pad: int = 7) -> Candidates:
    if k > scores.numel():
        raise ValueError(f"top_candidates: k={k} is more than the "
                         f"{scores.numel()} scores of {tuple(scores.shape)}")
    vals, idx = torch.topk(scores.reshape(-1), k)
    n_dt, nts, nfs, n_df = scores.shape
    dt = idx // (nts * nfs * n_df) - max_time_pad
    rem = idx % (nts * nfs * n_df)
    ts = rem // (nfs * n_df)
    rem = rem % (nfs * n_df)
    fs = rem // n_df
    df = rem % n_df
    return Candidates(vals, dt, ts, fs, df)


def find_candidates(wf: torch.Tensor, k: int = 20) -> Candidates:
    """Waterfall -> top-k sync candidates."""
    return top_candidates(sync_scores(wf), k)
