"""LPC impulse noise blanker (torch), port of `t41x.dsp.nb`.

The reference's noise blanker (tmr4/T41_SDR `AltNoiseBlanking`
`DSP_Fn.cpp:137-362`, by Michael Wild), per 256-sample audio frame:

  1. order-10 LPC via autocorrelation + Levinson-Durbin,
  2. inverse filtering (whitening) then matched filtering to enhance
     impulses,
  3. threshold at NB_thresh * sqrt(var * lpc_power) to locate impulses,
  4. replace a +-PL window around each impulse with linearly weighted
     forward/backward LPC predictions.

As in `t41x`, detection yields a blank MASK (dilated +-PL); the forward
and backward predictors free-run inside masked regions and track the
input outside, then blend with linear cross-fades.  In
`noise_blanker_plain` the two predictor recurrences are serial over the
frame and stay a loop of torch ops, as `t41x` leaves them to `lax.scan`;
the cross-fade distances are a cumulative max of reset indices, equal to
the scan exactly.  On a CUDA tensor `noise_blanker` launches the
hand-written kernel N1 (`t41x_torch/kernels/nb.py`), the whole blanker
a frame in one launch, unless the caller asks for the plain version
(`use_kernel=False`, as `ChainSpec(use_kernels=False)` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ORDER = 10            # NB_taps (DSP_Fn.cpp:26)
IMPULSE_LEN = 7       # NB_impulse_samples
PL = (IMPULSE_LEN - 1) // 2
NB_THRESH = 2.5       # DSP_Fn.cpp:138


def levinson(r: torch.Tensor) -> torch.Tensor:
    """Levinson-Durbin: autocorrelation (..., ORDER+1) -> LPC
    coefficients (..., ORDER+1) with leading 1 (DSP_Fn.cpp:246-275)."""
    alfa = r[..., 0] * (1.0 + 1e-9)
    lpcs = torch.zeros(r.shape[:-1] + (ORDER + 1,), dtype=r.dtype,
                       device=r.device)
    lpcs[..., 0] = 1.0
    idx = torch.arange(1, ORDER + 1, device=r.device)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for m in range(1, ORDER + 1):
        below = idx < m
        back = (m - idx).clamp(0, ORDER)
        # s = sum_{u=1}^{m-1} lpcs[u] * r[m-u]
        ru = torch.where(below, r[..., back], zero)
        lu = torch.where(below, lpcs[..., 1:], zero)
        s = torch.sum(lu * ru, dim=-1)
        k = -(r[..., m] + s) / torch.clamp(alfa, min=1e-30)
        # lpcs[v] += k * lpcs[m-v]  for v in 1..m-1;  lpcs[m] = k
        lrev = torch.where(below, lpcs[..., back], zero)
        upd = torch.where(below, lpcs[..., 1:] + k[..., None] * lrev,
                          lpcs[..., 1:])
        upd = torch.where(idx == m, k[..., None], upd)
        lpcs = torch.cat([lpcs[..., :1], upd], dim=-1)
        alfa = alfa * (1.0 - k * k)
    return lpcs


def _run_pred(sig: torch.Tensor, mask: torch.Tensor, a: torch.Tensor):
    """LPC predictor over the frame: y[t] = sum_j a[j] y[t-1-j] where
    `mask` is set, the input elsewhere (zero history)."""
    n = sig.shape[-1]
    buf = torch.zeros(sig.shape[:-1] + (ORDER + n,), dtype=sig.dtype,
                      device=sig.device)
    a_rev = a.flip(-1)          # a_rev[i] multiplies y[t - ORDER + i]
    for t in range(n):
        pred = torch.sum(a_rev * buf[..., t:t + ORDER], dim=-1)
        buf[..., ORDER + t] = torch.where(mask[..., t], pred, sig[..., t])
    return buf[..., ORDER:]


def _distance_from_start(mask: torch.Tensor) -> torch.Tensor:
    """Run length of set samples up to and including each sample (0 where
    unset): t minus the index of the latest unset sample at or before t."""
    t = torch.arange(mask.shape[-1], device=mask.device)
    last_reset = torch.cummax(torch.where(mask, -1, t), dim=-1).values
    return torch.where(mask, t - last_reset, 0).to(torch.float32)


def blank_runs(mask: torch.Tensor) -> list[tuple[int, int]]:
    """One frame's blanked runs [start, end), in order, from its mask
    (n,) bool."""
    m = mask.to(torch.int8)
    edge = torch.diff(m, prepend=m.new_zeros(1), append=m.new_zeros(1))
    starts = torch.nonzero(edge == 1).flatten().tolist()
    ends = torch.nonzero(edge == -1).flatten().tolist()
    return list(zip(starts, ends))


def run_groups(runs: list[tuple[int, int]], gap: int = ORDER):
    """The runs chained into groups: a run joins its predecessor's group
    when fewer than `gap` unset samples lie between them, since a
    predictor's history (ORDER samples) then reaches into that run's
    outputs; the first run of a group depends on the input alone."""
    groups = []
    for s, e in runs:
        if groups and s - groups[-1][-1][1] < gap:
            groups[-1].append((s, e))
        else:
            groups.append([(s, e)])
    return groups


def walk_by_runs(x: torch.Tensor, mask: torch.Tensor, a: torch.Tensor,
                 gap: int = ORDER):
    """The predictors and the cross-fade weights as N1 computes them (one
    frame at a time, used by no main path): the mask's runs
    (`blank_runs`) in groups (`run_groups`), each group walked alone, as
    a lane pair of N1 walks it, from a copy of the input that holds no
    other group's outputs: the forward predictor over its runs in order,
    each run's history the ORDER samples before it, the backward one
    over them in reverse from the ORDER after.  Each prediction is
    `_run_pred`'s own sum of the same 10 values; the weights come from
    the runs' bounds: w_bw = d_fw / max(d_fw + d_bw, 1) with d_fw = t - s
    + 1, d_bw = e - t for t in [s, e).  x, mask (..., n), a (..., ORDER);
    the mask must stay ORDER samples clear of the frame's edges.
    Returns (fwd, bwd, w_bw), each (..., n): fwd and bwd equal to
    `_run_pred`'s outputs, w_bw to the plain version's weights, where
    `gap` is ORDER."""
    n = x.shape[-1]
    xs, ms = x.reshape(-1, n), mask.reshape(-1, n)
    a_rev = a.reshape(-1, ORDER).flip(-1)
    fwd, bwd = xs.clone(), xs.clone()
    w_bw = torch.zeros_like(xs)
    for f in range(xs.shape[0]):
        for group in run_groups(blank_runs(ms[f]), gap):
            yf, yb = xs[f].clone(), xs[f].clone()
            for s, e in group:
                if s < ORDER or e > n - ORDER:
                    raise ValueError("walk_by_runs: a run within ORDER of "
                                     "the frame's edge")
                for t in range(s, e):
                    yf[t] = torch.sum(a_rev[f] * yf[t - ORDER:t], dim=-1)
            for s, e in reversed(group):
                for t in range(e - 1, s - 1, -1):
                    yb[t] = torch.sum(
                        a_rev[f] * yb[t + 1:t + 1 + ORDER].flip(-1), dim=-1)
            for s, e in group:
                fwd[f, s:e], bwd[f, s:e] = yf[s:e], yb[s:e]
                t = torch.arange(s, e, dtype=torch.float32)
                d_fw, d_bw = t - s + 1, e - t
                w_bw[f, s:e] = d_fw / torch.clamp(d_fw + d_bw, min=1.0)
    return (fwd.reshape(x.shape), bwd.reshape(x.shape),
            w_bw.reshape(x.shape))


def _detect(x: torch.Tensor, thresh: float):
    """The detection half of the blanker: (lpcs, temp, threshold,
    mask), temp the matched filter's output and mask the dilated blank
    mask."""
    n = x.shape[-1]
    r = torch.stack([torch.sum(x[..., : n - i] * x[..., i:], dim=-1)
                     for i in range(ORDER + 1)], dim=-1)
    lpcs = levinson(r)

    def fir(sig, taps):
        # causal FIR with per-channel taps (..., ORDER+1)
        out = torch.zeros_like(sig)
        for i in range(ORDER + 1):
            out = out + taps[..., i: i + 1] * F.pad(sig, (i, 0))[..., :n]
        return out

    # whitening (reversed-LPC FIR) then matched filter (LPC FIR)
    temp = fir(fir(x, lpcs.flip(-1)), lpcs)

    sigma2 = torch.var(temp, dim=-1, keepdim=True, correction=0)
    lpc_power = torch.sum(lpcs[..., :ORDER] ** 2, dim=-1, keepdim=True)
    threshold = thresh * torch.sqrt(sigma2 * lpc_power)

    # impulse mask, corrected by the filter delay (DSP_Fn.cpp:296) and
    # dilated +-PL
    hits = torch.roll(temp.abs() > threshold, -ORDER, dims=-1)
    guard = torch.arange(n, device=x.device)
    hits = hits & (guard >= ORDER + PL) & (guard < n - 14)
    mask = hits
    for s in range(1, PL + 1):
        mask = mask | torch.roll(hits, s, dims=-1) \
            | torch.roll(hits, -s, dims=-1)
    return lpcs, temp, threshold, mask


def noise_blanker_plain(x: torch.Tensor, thresh: float = NB_THRESH):
    """x: (..., N) real audio frame(s).  Returns the blanked frames, in
    plain torch ops (any device).

    Stateless per frame like the reference; detections within ORDER+PL
    of the frame edges are skipped, as in `t41x`."""
    lpcs, _, _, mask = _detect(x, thresh)
    a = -lpcs[..., 1:]  # prediction coefficients
    fwd = _run_pred(x, mask, a)
    bwd = _run_pred(x.flip(-1), mask.flip(-1), a).flip(-1)

    # linear cross-fade inside each blanked region: weight by distance
    # to the region edges (the reference's Wfw/Wbw ramps)
    d_fw = _distance_from_start(mask)
    d_bw = _distance_from_start(mask.flip(-1)).flip(-1)
    w_bw = d_fw / torch.clamp(d_fw + d_bw, min=1.0)
    blended = (1.0 - w_bw) * fwd + w_bw * bwd
    return torch.where(mask, blended, x)


def noise_blanker(x: torch.Tensor, thresh: float = NB_THRESH,
                  use_kernel: bool = True):
    """x: (..., N) real audio frame(s).  Returns the blanked frames.
    CPU tensors, or `use_kernel=False`, take `noise_blanker_plain`; CUDA
    tensors launch N1 (`t41x_torch.kernels.nb.launch`), which raises if
    it cannot build or launch."""
    if not (x.is_cuda and use_kernel):
        return noise_blanker_plain(x, thresh)
    from t41x_torch.kernels import nb as knb

    return knb.launch(x.contiguous(), thresh)


def decision_margin(x: torch.Tensor, thresh: float = NB_THRESH):
    """The plain version's blank mask (..., N) and how near each decision
    came to going the other way: at each guarded sample t,
    | |temp[t + ORDER]| - threshold | / threshold (the hit test that
    sample's bit comes from, shifted by the filter delay), inf at the
    unguarded samples and where the threshold is 0.  A version that sums
    in another order may decide otherwise only where the margin is of
    the order of float32 rounding."""
    n = x.shape[-1]
    _, temp, threshold, mask = _detect(x, thresh)
    margin = torch.roll((temp.abs() - threshold).abs() / threshold, -ORDER,
                        dims=-1)
    guard = torch.arange(n, device=x.device)
    keep = (guard >= ORDER + PL) & (guard < n - 14) & (threshold > 0)
    return mask, torch.where(keep, margin, torch.inf)
