"""Design-time FIR/IIR designers (NumPy), the part the ported chain uses.

A copy of the matching functions of `t41x.dsp.firdesign`, so the port
never imports JAX; `tests/test_torch_design.py` pins every designed
coefficient equal to `t41x`'s.  They re-express the reference's
designers:
  * Kaiser windowed-sinc low-pass  (tmr4/T41_SDR `FIR.cpp:908-980`)
  * complex band-pass prototype for the overlap-save mask (`FIR.cpp:1008-1065`)
  * RBJ biquad coefficients (`FIR.cpp:1076-1116`)
  * frequency-domain filter mask (`Filter.cpp:260-284`)
  * interpolation prototypes (`Filter.cpp:396-438`)
  * the narrow CW audio low-pass and the zoom-FFT anti-alias IIR
    (`FIR.cpp:15-66, 582-885`), designed with scipy inside the function
"""

from __future__ import annotations

import numpy as np

from t41x_torch import constants as C
from t41x_torch.utils import windows as W


def _kaiser_w(x: np.ndarray, beta: float) -> np.ndarray:
    return W.izero(beta * np.sqrt(np.clip(1.0 - x * x, 0.0, None))) / W.izero(beta)


def _msinc(m: np.ndarray, fc: float) -> np.ndarray:
    """sin(pi/2 * m * fc) / (pi/2 * m * fc), =1 at m=0
    (reference `Utility.cpp:197-203`)."""
    x = m * (np.pi / 2.0) * fc
    out = np.ones_like(x)
    nz = m != 0
    out[nz] = np.sin(x[nz]) / (fc * m[nz] * (np.pi / 2.0))
    return out


def fir_kaiser(num_taps: int, fc: float, astop_db: float,
               fs: float = C.SAMPLE_RATE) -> np.ndarray:
    """Kaiser windowed-sinc low-pass FIR, matching the reference
    designer's conventions (`CalcFIRCoeffs`, `FIR.cpp:908-980`).
    Returns float64 taps of length num_taps."""
    beta = W.kaiser_beta(astop_db)
    fcf, nc = 2.0 * (fc / fs), num_taps
    ii = np.arange(-nc, nc, 2, dtype=np.float64)
    h = fcf * _msinc(ii, fcf) * _kaiser_w(ii / nc, beta)
    if len(h) >= num_taps:
        return h[:num_taps]
    return np.pad(h, (0, num_taps - len(h)))


def complex_bandpass(num_taps: int, f_lo: float, f_hi: float, fs: float,
                     window: str = "blackman_harris4") -> np.ndarray:
    """Complex band-pass FIR: windowed-sinc LP prototype of width
    (f_hi-f_lo)/2, shifted in frequency by (f_hi+f_lo)/2
    (reference `CalcCplxFIRCoeffs`, `FIR.cpp:1008-1065`).

    Cutoffs may be negative (LSB filters).  Returns complex128 taps.
    """
    n_fl = f_lo / fs
    n_fh = f_hi / fs
    n_fc = (n_fh - n_fl) / 2.0  # prototype LP cutoff
    n_fs = np.pi * (n_fh + n_fl)  # frequency-shift phase slope
    center = 0.5 * (num_taps - 1)

    i = np.arange(num_taps, dtype=np.float64)
    x = i - center
    w = W.WINDOWS[window](num_taps)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.sin(2.0 * np.pi * x * n_fc) / (np.pi * x) * w
    z[np.abs(x) < 0.01] = 2.0 * n_fc  # sinc singularity at center tap
    return z * np.exp(1j * n_fs * x)


def os_filter_mask(taps: np.ndarray, fft_length: int = C.FFT_LENGTH) -> np.ndarray:
    """Frequency-domain mask for overlap-save fast convolution: zero-pad the
    (complex) band-pass taps to fft_length and FFT
    (reference `InitFilterMask`, `Filter.cpp:260-284`).
    """
    assert len(taps) <= fft_length
    buf = np.zeros(fft_length, dtype=np.complex128)
    buf[: len(taps)] = taps
    return np.fft.fft(buf)


def bandpass_mask(f_lo: float, f_hi: float, fs: float = C.AUDIO_RATE,
                  fft_length: int = C.FFT_LENGTH,
                  window: str = "blackman_harris4") -> np.ndarray:
    """Overlap-save mask for a variable audio band-pass.  m_NumTaps =
    fft_length/2 + 1 (reference `Filter.cpp:18`)."""
    taps = complex_bandpass(fft_length // 2 + 1, f_lo, f_hi, fs, window)
    return os_filter_mask(taps, fft_length)


def biquad_rbj(f0: float, q: float, fs: float, ftype: str = "lowpass"):
    """RBJ audio-EQ-cookbook biquad (reference `SetIIRCoeffs`,
    `FIR.cpp:1076-1116`).  Returns (b, a) with a = [1, a1, a2] in the
    standard sign convention  y = b·x - a1·y1 - a2·y2.
    """
    f0 = min(f0, fs / 2.0)
    w0 = 2.0 * np.pi * f0 / fs
    sw, cw = np.sin(w0), np.cos(w0)
    alpha = sw / (2.0 * q)
    a0 = 1.0 + alpha
    if ftype == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2]) / a0
        a = np.array([1.0, -2 * cw / a0, (1 - alpha) / a0])
    elif ftype == "notch":
        b = np.array([1.0, -2 * cw, 1.0]) / a0
        a = np.array([1.0, -2 * cw / a0, (1 - alpha) / a0])
    elif ftype == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]) / a0
        a = np.array([1.0, -2 * cw / a0, (1 - alpha) / a0])
    elif ftype == "peak":
        A = 1.0  # placeholder gain; EQ bands use precomputed tables instead
        b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A]) / a0
        a = np.array([1.0, -2 * cw / a0, (1 - alpha) / a0])
    else:
        raise ValueError(ftype)
    return b, a


def dc_block_biquad():
    """The RX DC-removal high-pass butterworth biquad (reference table
    `HP_DC_Filter_Coeffs2`, `FIR.cpp:87-91`, applied `Process.cpp:127-128`):
    a ~10 Hz 2nd-order butterworth HP at 192 kHz, as the RBJ cookbook
    high-pass (`SetIIRCoeffs`, `FIR.cpp:1076-1116`).  Returns (b, a) with
    a = [1, a1, a2]."""
    f0, q, fs = 10.0, 1.0 / np.sqrt(2.0), C.SAMPLE_RATE
    w0 = 2.0 * np.pi * f0 / fs
    sw, cw = np.sin(w0), np.cos(w0)
    alpha = sw / (2.0 * q)
    a0 = 1.0 + alpha
    b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]) / a0
    a = np.array([1.0, -2 * cw / a0, (1 - alpha) / a0])
    return b, a


def interpolation_prototypes(lp_hz: float | None = None):
    """LP prototypes for the x2 and x4 interpolators back to 192 kHz
    (reference `Filter.cpp:415-416`, `T41_SDR.ino:595-616`)."""
    lp = C.N_DESIRED_BW * 1000.0 if lp_hz is None else min(lp_hz, 10_000.0)
    h1 = fir_kaiser(C.INT1_TAPS, lp, C.N_ATT, fs=C.SAMPLE_RATE / C.DF1)
    h2 = fir_kaiser(C.INT2_TAPS, lp, C.N_ATT, fs=C.SAMPLE_RATE)
    return h1, h2


def _tune_neg3db(make_sos, target_hz: float, fs: float) -> np.ndarray:
    """Bisect a lowpass design's band-edge parameter so its -3 dB point
    lands on `target_hz` (the reference publishes its IIR cutoffs as
    -3 dB frequencies, e.g. '840HZ Fc' `FIR.cpp:15`, '12kHz' per-zoom
    `FIR.cpp:588`).  make_sos(wn_hz) -> scipy sos."""
    from scipy import signal

    def mag_at_target(sos):
        _, h = signal.sosfreqz(sos, worN=[target_hz], fs=fs)
        return 20.0 * np.log10(max(abs(h[0]), 1e-12))

    lo, hi = target_hz * 0.5, min(target_hz * 1.5, fs * 0.499)
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        if mag_at_target(make_sos(mid)) < -3.0:
            lo = mid
        else:
            hi = mid
    return make_sos(0.5 * (lo + hi))


def cw_audio_lpf(fc_3db_hz: float, fs: float = C.AUDIO_RATE) -> np.ndarray:
    """Narrow CW audio low-pass: 12-pole Chebyshev type I, 0.02 dB
    passband ripple, -3 dB at fc — the design family of the reference's
    five shipped coefficient sets (`FIR.cpp:15-66`: 840/1080/1320/1800/
    2000 Hz at 24 kS/s).  Returns scipy sos (6 stages)."""
    from scipy import signal

    return _tune_neg3db(
        lambda wn: signal.cheby1(12, 0.02, wn, fs=fs, output="sos"),
        fc_3db_hz, fs)


# published cutoffs of the five shipped CW filters (FIR.cpp:15-66); the
# last table's actual -3 dB point is 2038 Hz, though labeled "2.0KHZ Fc"
CW_FILTER_FC_HZ = (840.0, 1080.0, 1320.0, 1800.0, 2038.12)


def zoom_antialias_iir(zoom: int, fs: float = C.SAMPLE_RATE) -> np.ndarray:
    """Zoom-FFT anti-alias low-pass for decimation by 2^zoom: 8th-order
    elliptic, 0.02 dB ripple, 60 dB stopband, -3 dB at the decimated
    Nyquist — the design family of the reference's per-zoom `mag_coeffs`
    biquad tables (`FIR.cpp:582-885`).  Returns scipy sos (4 stages)."""
    from scipy import signal

    fc = fs / (2.0 * (1 << zoom))
    return _tune_neg3db(
        lambda wn: signal.ellip(8, 0.02, 60.0, wn, fs=fs, output="sos"),
        fc, fs)
