"""IQ calibration loopback (host-driven, device-measured).

Re-expression of the reference's calibration mini-pipeline
(tmr4/T41_SDR `Process2.cpp:52-399`, `MenuProc.cpp:491`): a known cal
tone is generated through the TX IQ-correction path, observed through
the RX path, and the IQ amplitude/phase correction factors are adjusted
to minimize the opposite-sideband image.  Where the reference has the
operator turn an encoder while watching the spectrum
(`GetEncoderValueLive`), t41x runs the same loop programmatically:
coordinate descent on (iq_amp, iq_phase) against a jitted image-power
measurement.

A copy of `t41x.chain.cal`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

from t41x_torch import constants as C


def tone_powers_db(iq: np.ndarray, tone_hz: float,
                   rate: float = C.SAMPLE_RATE) -> tuple[float, float]:
    """(signal_db, image_db): power at +tone and -tone in a complex
    capture, via matched DFT bins."""
    iq = np.asarray(iq)
    n = len(iq)
    t = np.arange(n) / rate
    sig = np.abs(np.mean(iq * np.exp(-2j * np.pi * tone_hz * t))) ** 2
    img = np.abs(np.mean(iq * np.exp(+2j * np.pi * tone_hz * t))) ** 2
    return 10 * np.log10(sig + 1e-30), 10 * np.log10(img + 1e-30)


def image_rejection_db(iq: np.ndarray, tone_hz: float,
                       rate: float = C.SAMPLE_RATE) -> float:
    s, i = tone_powers_db(iq, tone_hz, rate)
    return s - i


def calibrate_iq(measure, amp0: float = 1.0, phase0: float = 0.0,
                 steps: int = 24) -> tuple[float, float, float]:
    """Coordinate descent: `measure(amp, phase) -> image_rejection_db`
    (higher is better).  Returns (amp, phase, rejection_db).

    Mirrors the reference's manual flow: alternate amplitude and phase
    adjustments with shrinking step size (`DoXmitCalibrate`
    `Process2.cpp:226-293`).
    """
    amp, phase = amp0, phase0
    best = measure(amp, phase)
    d_amp, d_phase = 0.05, 0.05
    for _ in range(steps):
        improved = False
        for da, dp in ((d_amp, 0.0), (-d_amp, 0.0),
                       (0.0, d_phase), (0.0, -d_phase)):
            r = measure(amp + da, phase + dp)
            if r > best:
                amp, phase, best = amp + da, phase + dp, r
                improved = True
        if not improved:
            d_amp *= 0.5
            d_phase *= 0.5
            if d_amp < 1e-4:
                break
    return amp, phase, best
