"""The North-star parity measures, one definition for the tests and
`chip_smoke.py` (formulas of `bench.py`'s on-chip parity check).

* `snr_db` — audio SNR of `got` against `ref` in dB; the bound is 55 dB.
* `spectrum_err_db` — the largest displayed-spectrum error in dB within
  the panadapter's ~60 dB range (bins below peak - 60 dB clip to the
  display floor); the bound is 0.5 dB, below the display's ~1-2 dB per
  pixel.
* `psd_err_db` — the steady-state audio power-spectrum error of an
  adaptive stage (LMS NR, notch, SAM PLL), whose waveform trajectories
  diverge between any two arithmetic orders; the bound is 3 dB
  (`tools/chipcheck.py`'s "spectral" rows).
* `nb_decisions` — a noise blanker's blank mask and output against the
  plain version's: the masks may differ only at decisions whose margin
  to the threshold is below `NB_MARGIN_MAX` (float32 rounding of sums
  taken in another order), the output outside its own mask is the input
  bit for bit, and on frames with equal masks the audio is within the
  55 dB bound.
* `nr_decisions` — spectral NR's per-hop gains and averaging-width (NN)
  choices against the plain version's: a choice may differ only where
  the plain version's power ratio lies within `NR_MARGIN_MAX` of an NN
  boundary (its in-band sums taken in another order), and the gains of
  every hop whose choice is equal lie within `NR_GAIN_RTOL` /
  `NR_GAIN_ATOL` (the box filters' sums: direct against a cumulative
  sum's differences, gains up to ~3).
"""

from __future__ import annotations

import numpy as np

AUDIO_SNR_MIN_DB = 55.0
SPECTRUM_ERR_MAX_DB = 0.5
PSD_ERR_MAX_DB = 3.0
NB_MARGIN_MAX = 1e-4
NR_MARGIN_MAX = 1e-4
NR_GAIN_RTOL, NR_GAIN_ATOL = 1e-5, 3e-5
# S1's carried state (xt, pslp, hk_old) against the plain version's: its
# recursion is elementwise in torch's rounding
NR_STATE_RTOL = 1e-5
# E1 against the plain EQ on the card: both fp32, sums in other orders
EQ_SNR_MIN_DB = 100.0


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def snr_db(ref, got) -> float:
    r = _np(ref).astype(np.complex128)
    g = _np(got).astype(np.complex128)
    err = np.mean(np.abs(r - g) ** 2)
    sig = np.mean(np.abs(r) ** 2)
    return float("inf") if err == 0.0 else float(10.0 * np.log10(sig / err))


def spectrum_err_db(ref, got) -> float:
    r = _np(ref).astype(np.float64)
    g = _np(got).astype(np.float64)
    fl = max(r.max(), g.max()) * 1e-6
    return float(np.max(np.abs(10 * np.log10(np.maximum(g, fl))
                               - 10 * np.log10(np.maximum(r, fl)))))


def psd_err_db(ref, got, last: int = 2) -> float:
    """Largest dB difference of the Hann-windowed power spectra of the
    last `last` blocks, per channel, over the bins within 40 dB of the
    reference's peak.  ref/got: (n_blocks, ..., N) block-major streams."""
    def psd(a):
        a = np.moveaxis(_np(a).astype(np.float64)[-last:], 0, -2)
        a = a.reshape(a.shape[:-2] + (-1,))
        w = np.hanning(a.shape[-1])
        return 10 * np.log10(np.abs(np.fft.rfft(a * w)) ** 2 + 1e-12)

    pr, pg = psd(ref), psd(got)
    mask = pr > pr.max() - 40.0
    return float(np.max(np.abs(pg[mask] - pr[mask])))


def nb_decisions(x, y_k, mask_k, y_p, mask_p, margin_p, pl: int = 3) -> dict:
    """Frames x (..., n); the blanker under test's output y_k and blank
    mask mask_k; the plain version's y_p, mask_p and decision margins
    margin_p (`t41x_torch.dsp.nb.decision_margin`), all torch tensors on
    one device.  A decision whose margin is below NB_MARGIN_MAX may go
    either way, and with it the +-`pl` samples it blanks.  Returns the
    counts and `ok`: no other sample's decision differs, y_k equals x
    bit for bit outside mask_k, every value is finite, and the frames
    whose masks are equal are >= AUDIO_SNR_MIN_DB from y_p."""
    import torch

    near_hit = margin_p < NB_MARGIN_MAX
    near = near_hit.clone()
    for s in range(1, pl + 1):
        near |= torch.roll(near_hit, s, -1) | torch.roll(near_hit, -s, -1)
    differ = mask_k ^ mask_p
    same = ~differ.any(dim=-1)
    out = {
        "frames": int(same.numel()),
        "blanked_samples": int(mask_p.sum()),
        "near_threshold": int(near_hit.sum()),
        "mask_samples_differ": int(differ.sum()),
        "frames_differ": int((~same).sum()),
        "unexplained": int((differ & ~near).sum()),
        "passthrough_exact": bool(torch.equal(y_k[~mask_k], x[~mask_k])),
        "finite": bool(torch.isfinite(y_k).all()),
        "snr_db": snr_db(y_p[same], y_k[same]) if bool(same.any())
        else float("inf"),
    }
    out["ok"] = (out["unexplained"] == 0 and out["passthrough_exact"]
                 and out["finite"] and out["snr_db"] >= AUDIO_SNR_MIN_DB)
    return out


def nr_decisions(g_k, nn_k, g_p, nn_p, margin_p) -> dict:
    """Spectral NR gains g_k (n_hops, ..., 128) and NN choices nn_k
    (n_hops, ...) of the version under test against the plain version's
    g_p, nn_p and its margins margin_p
    (`t41x_torch.dsp.nr.spectral_decision_margin`), torch tensors on one
    device.  Returns the counts and `ok`: every differing choice has a
    margin below NR_MARGIN_MAX, every gain is finite, and the gains of
    the hops whose choices are equal are within NR_GAIN_RTOL and
    NR_GAIN_ATOL of the plain version's."""
    import torch

    differ = nn_k != nn_p
    same = ~differ
    d = (g_k - g_p).abs()[same]
    tol = NR_GAIN_ATOL + NR_GAIN_RTOL * g_p.abs()[same]
    out = {
        "hops": int(nn_p.numel()),
        "near_boundary": int((margin_p < NR_MARGIN_MAX).sum()),
        "choices_differ": int(differ.sum()),
        "unexplained": int((differ & (margin_p >= NR_MARGIN_MAX)).sum()),
        "gains_out_of_tolerance": int((d > tol).sum()),
        "max_abs_err": float(d.max()) if d.numel() else 0.0,
        "finite": bool(torch.isfinite(g_k).all()),
    }
    out["ok"] = (out["unexplained"] == 0 and out["finite"]
                 and out["gains_out_of_tolerance"] == 0)
    return out
