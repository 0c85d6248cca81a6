"""Noise reduction (torch), port of `t41x.dsp.nr`.

Three NR algorithms and the automatic notch, the reference's set
(tmr4/T41_SDR `Noise.cpp`):

  * `kim_nr` — Kim & Ruwisch 2002 spectral NR (`Kim1_NR`,
    `Noise.cpp:108-311`): 256-point frames, 50% overlap, Hann analysis,
    3-frame energy average, 15-frame minimum statistics, time and
    frequency smoothing, overlap-add.  With `use_kernels` the per-hop
    gain recursion runs in the CUDA kernel K8 (`kernels.nr_gain`).
  * `spectral_nr` — UHSDR spectral-subtraction NR
    (`SpectralNoiseReduction`, `Noise.cpp:379-645`), with t41x's single
    musical-noise pass after all gains.  With `use_kernels` the per-hop
    gain recursion runs in the CUDA kernel S1 (`kernels.spectral_nr`);
    its plain version is `spectral_gains_scan`.
  * `xanr` — WDSP variable-leak LMS predictor (`Xanr`,
    `Noise.cpp:322-370`): prediction = NR mode 3, error = the notch.  With
    `use_kernels` the per-sample recurrence runs in K7 (`kernels.xanr`).

The forward and inverse transforms are `torch.fft.rfft`/`irfft` (cuFFT
on the card), where t41x uses DFT matmuls for the TPU: the half-spectrum
inverse `irdft_half_real` equals `irfft(n=256)` because the imaginary
parts at DC and Nyquist are zero.  States keep t41x's fields and
layouts, so `t41x_torch.utils.convert` carries them across.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C

NR_FFT_L = 256
HOP = NR_FFT_L // 2  # 128


def _vad_bins(f_lo: float, f_hi: float, rate: float = C.AUDIO_RATE):
    """Voice-activity band limits in NR bins (reference
    `Noise.cpp:144-173`)."""
    if f_lo <= 0 and f_hi >= 0:
        lf, uf = 0.0, max(-f_lo, f_hi)
    elif f_lo > 0:
        lf, uf = f_lo, f_hi
    else:
        lf, uf = -f_hi, -f_lo
    bin_bw = rate / NR_FFT_L
    lo, hi = int(lf / bin_bw), int(uf / bin_bw)
    if lo == hi:
        hi += 1
    lo = min(max(lo, 1), HOP - 2)
    hi = min(max(hi, 1), HOP)
    return lo, hi


def _hann() -> np.ndarray:
    i = np.arange(NR_FFT_L)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (NR_FFT_L - 1)))
            ).astype(np.float32)


def _sqrt_hann() -> np.ndarray:
    # sqrt-Hann as tabulated in the reference (Noise.cpp:55-89,
    # endpoint-zero symmetric variant)
    i = np.arange(NR_FFT_L)
    return np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * i / (NR_FFT_L - 1)))
                   ).astype(np.float32)


@functools.cache
def _window_on(fn, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(fn()).to(device)


def _window(fn, like: torch.Tensor) -> torch.Tensor:
    """`fn()`'s window on `like`'s device, copied there once: a copy from
    pageable host memory every block would wait for the card's stream."""
    return _window_on(fn, like.device)


def _in_band(lo: int, hi: int, device) -> torch.Tensor:
    bins = torch.arange(HOP, device=device)
    return (bins >= lo) & (bins < hi)


def _half_spectra(frames: torch.Tensor):
    """(..., 256) real frames -> (sr, si) bins 0..128 and the powers of
    bins 0..127."""
    s = torch.fft.rfft(frames)
    sr, si = s.real, s.imag
    return sr, si, (sr * sr + si * si)[..., :HOP]


def _mirror_inverse(sr, si, gs):
    """Inverse transform of the half spectrum under the reference's
    mirrored gains (Noise.cpp:265-270 applies G[i] to bins i and 255-i):
    for a symmetric spectrum the exact half-spectrum gain is the mean of
    neighbouring gains, G[0] at DC and G[127] at Nyquist."""
    mid = 0.5 * (gs[..., 1:] + gs[..., :-1])
    fg = torch.cat([gs[..., :1], mid, gs[..., HOP - 1: HOP]], dim=-1)
    return torch.fft.irfft(torch.complex(sr * fg, si * fg), n=NR_FFT_L)


def _hop_frames(st_last: torch.Tensor, xs: torch.Tensor):
    """xs: (B, ..., 256) blocks -> (2B, ..., HOP) hop halves in stream
    order and the (2B, ..., 256) frames over [previous half | half]."""
    B, ch = xs.shape[0], tuple(xs.shape[1:-1])
    halves = xs.reshape((B,) + ch + (2, HOP)).movedim(-2, 1)
    halves = halves.reshape((2 * B,) + ch + (HOP,))
    prev = torch.cat([st_last[None], halves[:-1]], dim=0)
    return halves, torch.cat([prev, halves], dim=-1)


def _overlap_add(last_ifft: torch.Tensor, outs: torch.Tensor):
    """(2B, ..., 256) inverse frames -> (2B, ..., HOP) output hops."""
    second = torch.cat([last_ifft[None], outs[:-1, ..., HOP:]], dim=0)
    return outs[..., :HOP] + second


def _join_hops(hops: torch.Tensor) -> torch.Tensor:
    """(2B, ..., HOP) hops in stream order -> (B, ..., 256) blocks."""
    B, ch = hops.shape[0] // 2, tuple(hops.shape[1:-1])
    audio = hops.reshape((B, 2) + ch + (HOP,)).movedim(1, -2)
    return audio.reshape((B,) + ch + (2 * HOP,))


# ----------------------------------------------------------------------
# Kim & Ruwisch 2002
# ----------------------------------------------------------------------

class KimParams(NamedTuple):
    alpha: float = 0.95    # time smoothing (gwv.cpp:62)
    beta: float = 0.85     # frequency smoothing (gwv.cpp:63)
    psi: float = 2.5       # min-statistics threshold (upstream
    #                        Convolution-SDR value)
    vad_low: int = 1
    vad_high: int = HOP
    post_gain: float = 30.0  # Process.cpp:846 output scale


def kim_params(f_lo: float = 200.0, f_hi: float = 3000.0,
               **kw) -> KimParams:
    lo, hi = _vad_bins(f_lo, f_hi)
    return KimParams(vad_low=lo, vad_high=hi, **kw)


class KimState(NamedTuple):
    last_sample: torch.Tensor   # (..., 128) input history
    last_ifft: torch.Tensor     # (..., 128) overlap-add tail
    X: torch.Tensor             # (..., 3, 128) power ring (order-free)
    E: torch.Tensor             # (..., 15, 128) 3-frame-average ring
    Gts: torch.Tensor           # (..., 128) time-smoothed gain
    idx: torch.Tensor           # (...,) int32 frame counter (ring cursor)


def kim_state(channels: tuple[int, ...] = (), device=None) -> KimState:
    def z(*s):
        return torch.zeros(channels + s, dtype=torch.float32, device=device)

    return KimState(z(HOP), z(HOP), z(3, HOP), z(15, HOP), z(HOP),
                    torch.zeros(channels, dtype=torch.int32, device=device))


def ring_slot(idx: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """(1,) int64 ring slot (channel 0's cursor + offset) mod size, on the
    device: the lockstep invariant of `t41x.dsp.nr.kim_nr` (every channel
    of a batch advances one hop per call), read without a host sync."""
    return torch.remainder(idx.reshape(-1)[:1].long() + offset, size)


def kim_consts(p: KimParams):
    """(psi, alpha, 1 - alpha, beta, 1 - 2 beta) formed in float32, as
    the TPU kernel forms them."""
    f = np.float32
    return (float(f(p.psi)), float(f(p.alpha)), float(f(1.0) - f(p.alpha)),
            float(f(p.beta)), float(f(1.0 - 2.0 * p.beta)))


def kim_gains_scan(p: KimParams, gst, powers: torch.Tensor):
    """The per-hop gain recursion of `t41x.dsp.nr._kim_gain`, hop by hop
    in the arithmetic of the TPU kernel `t41x.kernels.nr_gain_pallas`
    (E_new = (X0 + X1 + X2) / 3, float32 EMA weights), so that K8 can
    match it bit for bit.  gst: (X (..., 3, HOP), E (..., 15, HOP), Gts
    (..., HOP), idx (...,) int32); powers: (n_hops, ..., HOP).  Returns
    ((X', E', Gts', idx + n_hops), half-spectrum smoothed gains
    (n_hops, ..., HOP)).  The X/E histories are rings: overwriting the
    oldest slot is exact because every consumer (mean, min) is
    order-free."""
    X, E, Gts, idx = gst
    psi, alpha, oma, beta, omb = kim_consts(p)
    # the reference computes gains inside the VAD band only
    # (Noise.cpp:241-255); out-of-band gains stay at their zero init
    in_band = _in_band(p.vad_low, p.vad_high, X.device)
    # a tensor divisor: torch divides by a Python scalar as a multiply by
    # its reciprocal on the card, the kernel (and t41x) truly divide
    three = torch.full((), 3.0, device=X.device)
    gs = []
    for h in range(powers.shape[0]):
        power = powers[h]
        X = X.index_copy(-2, ring_slot(idx, h, 3), power[..., None, :])
        E_new = (X[..., 0, :] + X[..., 1, :] + X[..., 2, :]) / three
        E = E.index_copy(-2, ring_slot(idx, h, 15), E_new[..., None, :])
        M = E.amin(dim=-2)
        T = power / torch.clamp(M, min=1e-30)
        lam = torch.where(T > psi, M, E_new)
        G = torch.clamp(1.0 - lam / torch.clamp(E_new, min=1e-30), min=0.0)
        G = torch.where(in_band, G, 0.0)
        Gts = alpha * Gts + oma * G
        # 3-bin frequency smoothing, edge bins replicated
        # (Noise.cpp:258-263)
        left = torch.cat([Gts[..., :1], Gts[..., :-1]], dim=-1)
        right = torch.cat([Gts[..., 1:], Gts[..., -1:]], dim=-1)
        gs.append(beta * left + omb * Gts + beta * right)
    return (X, E, Gts, idx + powers.shape[0]), torch.stack(gs, dim=0)


def _kim_gains(p: KimParams, st: KimState, powers: torch.Tensor,
               use_kernels: bool):
    """All hops' gains: powers (n_hops, ..., HOP) -> ((X, E, Gts, idx),
    gains (n_hops, ..., HOP))."""
    gst = (st.X, st.E, st.Gts, st.idx)
    if use_kernels:
        from t41x_torch.kernels.nr_gain import kim_gains
        return kim_gains(p, gst, powers)
    return kim_gains_scan(p, gst, powers)


def kim_nr(p: KimParams, st: KimState, x: torch.Tensor,
           use_kernels: bool = False):
    """x: (..., 256) audio block at 24 kHz.  Returns (state, y).  Both
    hops' forward transforms run as one batch (hop 2's frame is the
    block itself), the gain recursions chain, both inverses batch."""
    window = _window(_hann, x)
    frame0 = torch.cat([st.last_sample, x[..., :HOP]], dim=-1)
    frames = torch.stack([frame0 * window, x * window], dim=0)
    sr, si, powers = _half_spectra(frames)
    # NOTE lockstep invariant: the ring cursor is channel 0's counter, so
    # do not merge per-channel states stepped different numbers of times
    (X, E, Gts, idx), gs = _kim_gains(p, st, powers, use_kernels)
    outs = _mirror_inverse(sr, si, gs)
    a0 = outs[0][..., :HOP] + st.last_ifft
    a1 = outs[1][..., :HOP] + outs[0][..., HOP:]
    new_st = KimState(x[..., HOP:], outs[1][..., HOP:], X, E, Gts, idx)
    return new_st, torch.cat([a0, a1], dim=-1) * p.post_gain


def kim_nr_batch(p: KimParams, st: KimState, xs: torch.Tensor,
                 use_kernels: bool = False):
    """The batched form of B sequential `kim_nr` calls: every hop frame
    depends on the input halves alone, so one forward transform over
    all 2B frames, one gain pass over the 2B hops (one K8 launch with
    `use_kernels`), one inverse and a vectorised overlap-add.
    xs: (B, ..., 256).  Returns (state, (B, ..., 256))."""
    halves, frames = _hop_frames(st.last_sample, xs)
    sr, si, powers = _half_spectra(frames * _window(_hann, xs))
    (X, E, Gts, idx), gs = _kim_gains(p, st, powers, use_kernels)
    outs = _mirror_inverse(sr, si, gs)
    audio = _join_hops(_overlap_add(st.last_ifft, outs)) * p.post_gain
    new_st = KimState(xs[-1, ..., HOP:], outs[-1, ..., HOP:], X, E, Gts,
                      idx)
    return new_st, audio


# ----------------------------------------------------------------------
# UHSDR spectral subtraction
# ----------------------------------------------------------------------

class SpectralParams(NamedTuple):
    alpha: float = 0.95
    asnr_db: float = 20.0
    vad_low: int = 1
    vad_high: int = HOP
    width: int = 4
    power_threshold: float = 0.4
    tinc: float = HOP / C.AUDIO_RATE
    tax: float = 0.0239
    tap: float = 0.05062
    psthr: float = 0.99
    pnsaf: float = 0.01
    pspri: float = 0.5
    psini: float = 0.5
    snr_prio_min_db: float = -20.0
    init_frames: int = 20


def spectral_params(f_lo: float = 200.0, f_hi: float = 3000.0,
                    **kw) -> SpectralParams:
    lo, hi = _vad_bins(f_lo, f_hi)
    return SpectralParams(vad_low=lo, vad_high=hi, **kw)


class SpectralState(NamedTuple):
    last_sample: torch.Tensor  # (..., 128)
    last_ifft: torch.Tensor    # (..., 128)
    xt: torch.Tensor           # (..., 128) noise estimate
    pslp: torch.Tensor         # (..., 128) smoothed speech probability
    hk_old: torch.Tensor       # (..., 128)
    frames: torch.Tensor       # (...,) int32 frame counter


def spectral_state(channels: tuple[int, ...] = (),
                   device=None) -> SpectralState:
    def z(v=0.0):
        return torch.full(channels + (HOP,), v, dtype=torch.float32,
                          device=device)

    return SpectralState(z(), z(), z(1e-6), z(0.5), z(1.0),
                         torch.zeros(channels, dtype=torch.int32,
                                     device=device))


def spectral_consts(p: SpectralParams):
    """The scalars of `_spectral_gain` as torch rounds them to float32
    (each Python double once; a division by a Python scalar is, on the
    card, a product with its float32 reciprocal): 0.05 psini, xih1r,
    pfac, ap, 1 - ap, psthr, 1 - pnsaf, ax, 1 - ax, the a-priori SNR
    floor, alpha, 1 - alpha, power_threshold, 1 / power_threshold,
    width, and the box filters' 1/3, 1/5, 1/7, 1/9."""
    f = np.float32
    ax = np.exp(-p.tinc / p.tax)
    ap = np.exp(-p.tinc / p.tap)
    xih1 = 10.0 ** (p.asnr_db / 10.0)
    return tuple(float(v) for v in (
        f(0.05 * p.psini), f(1.0 / (1.0 + xih1) - 1.0),
        f((1.0 / p.pspri - 1.0) * (1.0 + xih1)), f(ap), f(1.0 - ap),
        f(p.psthr), f(1.0 - p.pnsaf), f(ax), f(1.0 - ax),
        f(10.0 ** (p.snr_prio_min_db / 20.0)), f(p.alpha),
        f(1.0 - p.alpha), f(p.power_threshold),
        f(1.0) / f(p.power_threshold), f(p.width),
        *(f(1.0) / f(nn) for nn in (3, 5, 7, 9))))


def _nn_choice(p: SpectralParams, ratio: torch.Tensor) -> torch.Tensor:
    """The musical-noise pass's averaging window from the in-band power
    ratio: an index 0..4 into the widths NN = 1, 3, 5, 7, 9 (int32)."""
    nn_f = torch.where(ratio > p.power_threshold, 0.0,
                       torch.round(p.width * (1.0 - ratio
                                              / p.power_threshold)))
    return torch.clamp(nn_f, 0, 4).to(torch.int32)


def _spectral_ratio(p: SpectralParams, gst, X: torch.Tensor,
                    in_band: torch.Tensor):
    """The recursion of `_spectral_gain` up to the musical-noise pass:
    (state', unsmoothed gain, initializing, in-band power ratio)."""
    xt_c, pslp_c, hk_old_c, frames_c = gst
    ax = np.exp(-p.tinc / p.tax)
    ap = np.exp(-p.tinc / p.tap)
    xih1 = 10.0 ** (p.asnr_db / 10.0)
    xih1r = 1.0 / (1.0 + xih1) - 1.0
    pfac = (1.0 / p.pspri - 1.0) * (1.0 + xih1)
    snr_prio_min = 10.0 ** (p.snr_prio_min_db / 20.0)

    initializing = frames_c[..., None] < p.init_frames
    # init phase: accumulate the noise estimate over the first frames
    xt_init = xt_c + 0.05 * p.psini * X

    # running phase: speech-presence-probability noise tracking
    ph1y = 1.0 / (1.0 + pfac * torch.exp(torch.clamp(
        xih1r * X / torch.clamp(xt_c, min=1e-30), -50.0, 50.0)))
    pslp = ap * pslp_c + (1.0 - ap) * ph1y
    ph1y = torch.where(pslp > p.psthr, 1.0 - p.pnsaf,
                       torch.clamp(ph1y, max=1.0))
    xtr = (1.0 - ph1y) * X + ph1y * xt_c
    xt_run = ax * xt_c + (1.0 - ax) * xtr

    xt = torch.where(initializing, xt_init, xt_run)
    pslp = torch.where(initializing, pslp_c, pslp)

    snr_post = torch.clamp(X / torch.clamp(xt, min=1e-30), snr_prio_min,
                           1000.0)
    snr_prio = torch.clamp(
        p.alpha * hk_old_c
        + (1.0 - p.alpha) * torch.clamp(snr_post - 1.0, min=0.0), min=0.0)

    v = snr_prio * snr_post / (1.0 + snr_prio)
    G = torch.sqrt(torch.clamp(0.7212 * v + v * v, min=0.0)) / snr_post
    hk_old = snr_post * G * G

    # musical-noise treatment: a dynamic averaging window NN from the
    # in-band power ratio (one pass after all gains, as t41x)
    pre = torch.where(in_band, X, 0.0).sum(dim=-1)
    post = torch.where(in_band, G * G * X, 0.0).sum(dim=-1)
    ratio = post / torch.clamp(pre, min=1e-30)
    return (xt, pslp, hk_old, frames_c + 1), G, initializing, ratio


def _spectral_gain(p: SpectralParams, gst, X: torch.Tensor):
    """Per-hop gain update of `t41x.dsp.nr._spectral_gain`: (xt, pslp,
    hk_old, frames) x bin powers -> (state', gain, initializing)."""
    in_band = _in_band(p.vad_low, p.vad_high, X.device)
    gst, G, initializing, ratio = _spectral_ratio(p, gst, X, in_band)

    # NN in {1,3,5,7,9}: box filters of edge-replicated G, all from one
    # cumulative sum padded by 4 on each side
    gp = torch.cat([G[..., :1].expand(G.shape[:-1] + (4,)), G,
                    G[..., -1:].expand(G.shape[:-1] + (4,))], dim=-1)
    c = torch.cumsum(gp, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)

    def box(nn):
        off = 4 - nn // 2
        return (c[..., off + nn: off + nn + HOP] - c[..., off: off + HOP]
                ) / nn

    G3, G5, G7, G9 = (box(nn) for nn in (3, 5, 7, 9))
    nn_idx = _nn_choice(p, ratio)[..., None]
    G_sm = torch.where(
        nn_idx == 0, G, torch.where(
            nn_idx == 1, G3, torch.where(
                nn_idx == 2, G5, torch.where(nn_idx == 3, G7, G9))))
    G = torch.where(in_band, G_sm, G)
    return gst, G, initializing


def spectral_gains_scan(p: SpectralParams, gst, powers: torch.Tensor):
    """The per-hop gain recursion of `t41x.dsp.nr.spectral_nr_batch`'s
    `lax.scan`, hop by hop (the plain version of S1).  gst: (xt, pslp,
    hk_old (..., HOP), frames (...,) int32); powers: (n_hops, ..., HOP).
    Returns ((xt', pslp', hk_old', frames + n_hops), gains (n_hops, ...,
    HOP), initializing (n_hops, ..., 1) bool)."""
    gs, inits = [], []
    for pw in powers:
        gst, g, init = _spectral_gain(p, gst, pw)
        gs.append(g)
        inits.append(init)
    return gst, torch.stack(gs, dim=0), torch.stack(inits, dim=0)


def nn_boundaries(p: SpectralParams) -> np.ndarray:
    """The in-band power ratios at which the NN choice changes: where
    width (1 - ratio / power_threshold) crosses k + 1/2 (the choice is 0
    on both sides of power_threshold itself)."""
    k = np.arange(min(int(p.width), 4))
    return p.power_threshold * (1.0 - (k + 0.5) / p.width)


def spectral_decision_margin(p: SpectralParams, gst, powers: torch.Tensor):
    """The plain version's NN choices over the hops of `powers` from
    state `gst` (as `spectral_gains_scan` takes them), and how near each
    came to going the other way: |ratio - b| / b for the nearest
    boundary b of `nn_boundaries`.  Returns (nn (n_hops, ...) int32,
    margin (n_hops, ...) float32).  A version that sums the in-band
    powers in another order may choose otherwise only where the margin
    is of the order of float32 rounding."""
    bounds = torch.as_tensor(nn_boundaries(p), dtype=torch.float32,
                             device=powers.device)
    in_band = _in_band(p.vad_low, p.vad_high, powers.device)
    nns, margins = [], []
    for pw in powers:
        gst, _, _, ratio = _spectral_ratio(p, gst, pw, in_band)
        nns.append(_nn_choice(p, ratio))
        margins.append(((ratio[..., None] - bounds).abs() / bounds
                        ).amin(dim=-1))
    return torch.stack(nns, dim=0), torch.stack(margins, dim=0)


def _spectral_gains(p: SpectralParams, st: SpectralState,
                    powers: torch.Tensor, use_kernels: bool):
    gst = (st.xt, st.pslp, st.hk_old, st.frames)
    if use_kernels:
        from t41x_torch.kernels.spectral_nr import spectral_gains
        return spectral_gains(p, gst, powers)
    return spectral_gains_scan(p, gst, powers)


def spectral_nr(p: SpectralParams, st: SpectralState, x: torch.Tensor,
                use_kernels: bool = False):
    """x: (..., 256) audio block.  Returns (state, y).  During the first
    `init_frames` hops the audio passes through untouched.  With
    `use_kernels`, CUDA tensors run both hops' gain recursion in one S1
    launch."""
    window = _window(_sqrt_hann, x)
    frame0 = torch.cat([st.last_sample, x[..., :HOP]], dim=-1)
    frames = torch.stack([frame0 * window, x * window], dim=0)
    sr, si, powers = _half_spectra(frames)
    (xt, pslp, hk_old, frames_n), gs, inits = _spectral_gains(
        p, st, powers, use_kernels)
    outs = _mirror_inverse(sr, si, gs) * window
    a0 = outs[0][..., :HOP] + st.last_ifft
    a1 = outs[1][..., :HOP] + outs[0][..., HOP:]
    a0 = torch.where(inits[0], x[..., :HOP], a0)
    a1 = torch.where(inits[1], x[..., HOP:], a1)
    new_st = SpectralState(x[..., HOP:], outs[1][..., HOP:], xt, pslp,
                           hk_old, frames_n)
    return new_st, torch.cat([a0, a1], dim=-1)


def spectral_nr_batch(p: SpectralParams, st: SpectralState,
                      xs: torch.Tensor, use_kernels: bool = False):
    """The batched form of B sequential `spectral_nr` calls (the
    factorisation of `kim_nr_batch`; one S1 launch over the 2B hops with
    `use_kernels`).  xs: (B, ..., 256).  Returns (state, (B, ..., 256))."""
    window = _window(_sqrt_hann, xs)
    halves, frames = _hop_frames(st.last_sample, xs)
    sr, si, powers = _half_spectra(frames * window)
    (xt, pslp, hk_old, frames_n), gs, inits = _spectral_gains(
        p, st, powers, use_kernels)
    outs = _mirror_inverse(sr, si, gs) * window
    hops = _overlap_add(st.last_ifft, outs)
    hops = torch.where(inits, halves, hops)   # init phase: passthrough
    new_st = SpectralState(xs[-1, ..., HOP:], outs[-1, ..., HOP:], xt,
                           pslp, hk_old, frames_n)
    return new_st, _join_hops(hops)


# ----------------------------------------------------------------------
# WDSP variable-leak LMS (NR + automatic notch)
# ----------------------------------------------------------------------

class XanrParams(NamedTuple):
    taps: int = 64
    delay: int = 16
    two_mu: float = 1e-4
    gamma: float = 0.1
    den_mult: float = 6.25e-10
    lidx_min: float = 120.0
    lidx_max: float = 200.0
    lincr: float = 1.0
    ldecr: float = 3.0
    notch: bool = False
    post_gain: float = 1.5  # Process.cpp:855


class XanrState(NamedTuple):
    dline: torch.Tensor  # (..., taps+delay) delay line, newest first
    w: torch.Tensor      # (..., taps) adaptive weights, newest first
    lidx: torch.Tensor   # (...,)
    ngamma: torch.Tensor


def xanr_state(p: XanrParams, channels: tuple[int, ...] = (),
               device=None) -> XanrState:
    f32 = torch.float32
    return XanrState(
        dline=torch.zeros(channels + (p.taps + p.delay,), dtype=f32,
                          device=device),
        w=torch.zeros(channels + (p.taps,), dtype=f32, device=device),
        lidx=torch.full(channels, 120.0, dtype=f32, device=device),
        ngamma=torch.full(channels, 0.001, dtype=f32, device=device),
    )


def xanr_scan(p: XanrParams, st: XanrState, x: torch.Tensor):
    """The LMS as a per-sample loop over the block (the form of t41x's
    scan).  The regressor windows are slices of one oldest-first
    [history | block] buffer; weights run oldest-first inside and are
    stored newest-first.  Returns (state, y)."""
    T, D = p.taps, p.delay
    padded = torch.cat([st.dline.flip(-1), x], dim=-1)
    w, lidx, ngamma = st.w.flip(-1), st.lidx, st.ngamma
    ys = []
    for n in range(x.shape[-1]):
        xn = x[..., n]
        # reg[k] = x[n - D - (T-1) + k]  (oldest-first window of T samples)
        reg = padded[..., n + 1: n + 1 + T]
        y = (w * reg).sum(dim=-1)
        sigma = (reg * reg).sum(dim=-1)
        inv_sigp = 1.0 / (sigma + 1e-10)
        error = xn - y
        ys.append(error if p.notch else y)

        nel = (error * (1.0 - p.two_mu * sigma * inv_sigp)).abs()
        nev = (xn - (1.0 - p.two_mu * ngamma) * y
               - p.two_mu * error * sigma * inv_sigp).abs()
        # reference quirk (Noise.cpp:353-358): on nev<nel, lidx+lincr is
        # tried; if it would exceed max it clamps there, OTHERWISE lidx
        # moves by (lincr - ldecr) net, clamped at min
        over = (lidx + p.lincr) > p.lidx_max
        lidx_new = torch.where(
            over, p.lidx_max,
            torch.clamp(lidx + p.lincr - p.ldecr, min=p.lidx_min))
        lidx = torch.where(nev < nel, lidx_new, lidx)
        l2 = lidx * lidx
        ngamma = p.gamma * (l2 * l2) * p.den_mult

        c0 = 1.0 - p.two_mu * ngamma
        c1 = p.two_mu * error * inv_sigp
        w = c0[..., None] * w + c1[..., None] * reg
    new_dline = padded[..., -(T + D):].flip(-1)
    out = torch.stack(ys, dim=-1) * (1.0 if p.notch else p.post_gain)
    return XanrState(new_dline, w.flip(-1), lidx, ngamma), out


def xanr(p: XanrParams, st: XanrState, x: torch.Tensor,
         use_kernels: bool = False):
    """Variable-leak LMS: x (..., N) real audio -> (state, y), y the
    prediction (NR) or the prediction error (notch)."""
    if use_kernels:
        from t41x_torch.kernels.xanr import xanr_block
        return xanr_block(p, st, x)
    return xanr_scan(p, st, x)
