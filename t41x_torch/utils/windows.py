"""Window functions and Bessel helpers (trace-time, NumPy).

Covers the window family the reference designers use
(tmr4/T41_SDR `FIR.cpp:1029-1059`, `Noise.cpp:55-89`, `ft8.cpp:168-178`)
plus the Kaiser machinery of `CalcFIRCoeffs` (`FIR.cpp:908-980`,
`Utility.cpp:197-230`).  Everything here runs at design time, in NumPy;
a copy of `t41x.utils.windows` so the port never imports JAX
(`tests/test_torch_design.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np


def izero(x: np.ndarray | float) -> np.ndarray:
    """Zeroth-order modified Bessel function I0 via its power series
    (the reference's `Izero`, `Utility.cpp:213-230`)."""
    x = np.asarray(x, dtype=np.float64)
    x2 = x / 2.0
    total = np.ones_like(x)
    term = np.ones_like(x)
    for i in range(1, 64):
        term = term * (x2 / i) ** 2
        total = total + term
        if np.all(term < 1e-12 * total):
            break
    return total


def kaiser_beta(astop_db: float) -> float:
    """Kaiser shape parameter from stopband attenuation
    (reference `FIR.cpp:923-932`)."""
    if astop_db < 20.96:
        return 0.0
    if astop_db >= 50.0:
        return 0.1102 * (astop_db - 8.71)
    return 0.5842 * (astop_db - 20.96) ** 0.4 + 0.07886 * (astop_db - 20.96)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window of length n."""
    x = 2.0 * np.arange(n) / max(n - 1, 1) - 1.0
    return izero(beta * np.sqrt(np.clip(1.0 - x * x, 0.0, None))) / izero(beta)


def _cosine_sum(n: int, coeffs: tuple[float, ...]) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for k, c in enumerate(coeffs):
        w += c * np.cos(2.0 * np.pi * k * i / (n - 1)) * (-1.0 if k % 2 else 1.0)
    return w


def blackman_harris4(n: int) -> np.ndarray:
    """4-term Blackman-Harris — the reference's default FIR design window
    (`FIR.cpp:1030-1035`)."""
    return _cosine_sum(n, (0.35875, 0.48829, 0.14128, 0.01168))


def blackman_nuttall(n: int) -> np.ndarray:
    return _cosine_sum(n, (0.3635819, 0.4891775, 0.1365995, 0.0106411))


def nuttall_like(n: int) -> np.ndarray:
    """The reference's "sine" variant table (`FIR.cpp:1037-1042`)."""
    return _cosine_sum(n, (0.355768, 0.487396, 0.144232, 0.012604))


def cosine(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.cos(np.pi * i / (n - 1))


def hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / (n - 1)))


def sqrt_hann_periodic(n: int) -> np.ndarray:
    """sqrt-Hann analysis/synthesis window used by the NR overlap-add
    frames (reference `Noise.cpp:55-89`)."""
    i = np.arange(n, dtype=np.float64)
    return np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * i / n)))


def blackman_ft8(n: int) -> np.ndarray:
    """Blackman window with the FT8 front-end's alpha
    (reference `ft8.cpp:168-178` `ft_blackman_i`)."""
    alpha = 0.16
    a0, a1, a2 = (1.0 - alpha) / 2.0, 0.5, alpha / 2.0
    i = np.arange(n, dtype=np.float64)
    x1 = np.cos(2.0 * np.pi * i / n)
    x2 = 2.0 * x1 * x1 - 1.0
    return a0 - a1 * x1 + a2 * x2


WINDOWS = {
    "blackman_harris4": blackman_harris4,
    "blackman_nuttall": blackman_nuttall,
    "nuttall_like": nuttall_like,
    "cosine": cosine,
    "hann": hann,
}
