"""Synthetic signal generators (host side, NumPy).

The reference has no signal generators beyond its calibration tone
(`Process2.cpp:295` 3 kHz quadrature cal tone) and relies on recorded WAVs;
t41x generates every mode's stimulus programmatically so the test pyramid
can assert end-to-end demod/decode correctness without fixtures.

Frequency plan (matches the reference RX chain, `Process.cpp:70-944`):
the chain applies a +Fs/4 shift then mixes DOWN by the NCO frequency, so a
signal whose post-shift frequency is +nco lands at DC.  In the raw capture
a USB audio tone f_a therefore sits at (nco - fs/4 + f_a).

A copy of `t41x.io.signals`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

from t41x_torch import constants as C


def _t(n: int, fs: float) -> np.ndarray:
    return np.arange(n, dtype=np.float64) / fs


def tone_iq(freq: float, n: int, fs: float = C.SAMPLE_RATE,
            amp: float = 1.0, phase: float = 0.0) -> np.ndarray:
    """Complex exponential at `freq` Hz in the capture spectrum."""
    return (amp * np.exp(1j * (2.0 * np.pi * freq * _t(n, fs) + phase))
            ).astype(np.complex64)


def usb_signal(audio_freqs, n: int, amps=None, nco: float = 0.0,
               fs: float = C.SAMPLE_RATE, fs4_offset: bool = True) -> np.ndarray:
    """USB SSB signal: audio tones f_a appear at capture freq
    (nco - fs/4 + f_a)."""
    audio_freqs = np.atleast_1d(audio_freqs).astype(np.float64)
    amps = np.ones_like(audio_freqs) if amps is None else np.atleast_1d(amps)
    base = nco - (fs / 4.0 if fs4_offset else 0.0)
    out = np.zeros(n, dtype=np.complex128)
    for f, a in zip(audio_freqs, amps):
        out += tone_iq(base + f, n, fs, a).astype(np.complex128)
    return out.astype(np.complex64)


def lsb_signal(audio_freqs, n: int, amps=None, nco: float = 0.0,
               fs: float = C.SAMPLE_RATE) -> np.ndarray:
    """LSB SSB signal: audio tones f_a appear at (nco - fs/4 - f_a)."""
    audio_freqs = -np.atleast_1d(audio_freqs).astype(np.float64)
    return usb_signal(audio_freqs, n, amps, nco, fs)


def am_signal(mod_freq: float, n: int, depth: float = 0.5, nco: float = 0.0,
              fs: float = C.SAMPLE_RATE, amp: float = 0.5) -> np.ndarray:
    """AM: carrier at (nco - fs/4) with sinusoidal envelope."""
    t = _t(n, fs)
    env = 1.0 + depth * np.sin(2.0 * np.pi * mod_freq * t)
    return (amp * env * np.exp(1j * 2.0 * np.pi * (nco - fs / 4.0) * t)
            ).astype(np.complex64)


def nfm_signal(mod_freq: float, n: int, deviation: float = 3000.0,
               nco: float = 0.0, fs: float = C.SAMPLE_RATE,
               amp: float = 0.5) -> np.ndarray:
    """Narrow-band FM: carrier at (nco - fs/4), sinusoidal modulation."""
    t = _t(n, fs)
    phase = (deviation / mod_freq) * np.sin(2.0 * np.pi * mod_freq * t)
    carrier = 2.0 * np.pi * (nco - fs / 4.0) * t
    return (amp * np.exp(1j * (carrier + phase))).astype(np.complex64)


def cw_keying_envelope(pattern: str, wpm: float, n: int,
                       fs: float = C.SAMPLE_RATE,
                       rise_ms: float = 5.0) -> np.ndarray:
    """On/off keying envelope from a dit/dah pattern string.

    pattern chars: '.' dit, '-' dah, ' ' inter-character gap, '/' word gap.
    PARIS timing: dit = 1.2/wpm seconds.
    """
    dit = 1.2 / wpm
    env = np.zeros(n, dtype=np.float64)
    pos = 0.0

    def mark(start_s: float, dur_s: float):
        a, b = int(start_s * fs), int((start_s + dur_s) * fs)
        env[max(a, 0): min(b, n)] = 1.0

    for ch in pattern:
        if ch == ".":
            mark(pos, dit); pos += 2 * dit
        elif ch == "-":
            mark(pos, 3 * dit); pos += 4 * dit
        elif ch == " ":
            pos += 2 * dit  # total 3 dits including trailing element gap
        elif ch == "/":
            pos += 6 * dit
    # raised-cosine edges to bound key clicks
    k = max(int(rise_ms * 1e-3 * fs), 1)
    ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(k) / k))
    kernel = np.ones(k) / k
    env = np.convolve(env, kernel, mode="same")
    del ramp
    return env


MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..", "0": "-----", "1": ".----", "2": "..---",
    "3": "...--", "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.", ".": ".-.-.-", ",": "--..--", "?": "..--..",
    "/": "-..-.", "=": "-...-",
}


def text_to_morse_pattern(text: str) -> str:
    """Convert text to a dit/dah pattern with letter/word gaps."""
    out = []
    for word in text.upper().split():
        letters = [MORSE[c] for c in word if c in MORSE]
        out.append(" ".join(letters))
    return "/".join(out)


def cw_signal(text: str, wpm: float, n: int, tone_offset: float = 750.0,
              nco: float = 0.0, fs: float = C.SAMPLE_RATE,
              amp: float = 0.5) -> np.ndarray:
    """CW keyed carrier.  In CW-USB reception with a 750 Hz sidetone the
    carrier sits `tone_offset` above the (shifted) tuning point."""
    env = cw_keying_envelope(text_to_morse_pattern(text), wpm, n, fs)
    return (amp * env * tone_iq(nco - fs / 4.0 + tone_offset, n, fs)
            ).astype(np.complex64)


def awgn(n: int, sigma: float, seed: int = 0, complex_: bool = True):
    rng = np.random.default_rng(seed)
    if complex_:
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        return (sigma / np.sqrt(2.0) * z).astype(np.complex64)
    return (sigma * rng.standard_normal(n)).astype(np.float32)


def voice_proxy(n_audio: int, fs_audio: float = C.AUDIO_RATE,
                seed: int = 1, f_lo: float = 300.0,
                f_hi: float = 2700.0) -> np.ndarray:
    """Speech-band noise proxy: pink-ish noise band-limited to
    [f_lo, f_hi] with syllabic (4 Hz) amplitude modulation — a stand-in
    for voice in SSB TX/RX round-trip tests."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n_audio)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n_audio, 1.0 / fs_audio)
    shape = np.where((f > f_lo) & (f < f_hi),
                     1.0 / np.sqrt(np.maximum(f, f_lo)), 0.0)
    x = np.fft.irfft(X * shape, n_audio)
    t = np.arange(n_audio) / fs_audio
    x *= 0.6 + 0.4 * np.sin(2.0 * np.pi * 4.0 * t)
    return (x / (np.max(np.abs(x)) + 1e-12)).astype(np.float32)


def tone_fit_snr(audio: np.ndarray, freqs, fs: float) -> float:
    """SNR of `audio` against a best-fit (amplitude+phase per tone) sum of
    sinusoids at `freqs` — gain/phase/delay invariant golden metric for
    demodulated multi-tone test signals."""
    audio = np.asarray(audio, np.float64)
    t = np.arange(len(audio)) / fs
    cols = []
    for f in np.atleast_1d(freqs):
        cols.append(np.cos(2 * np.pi * f * t))
        cols.append(np.sin(2 * np.pi * f * t))
    A = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(A, audio, rcond=None)
    fit = A @ coef
    p_sig = np.mean(fit ** 2)
    p_err = np.mean((audio - fit) ** 2) + 1e-30
    return 10.0 * np.log10(p_sig / p_err)


def snr_db(signal: np.ndarray, reference: np.ndarray) -> float:
    """SNR of `signal` against `reference` after optimal scalar gain fit."""
    signal = np.asarray(signal, np.float64)
    reference = np.asarray(reference, np.float64)
    g = np.dot(signal, reference) / (np.dot(reference, reference) + 1e-30)
    err = signal - g * reference
    p_sig = np.mean((g * reference) ** 2)
    p_err = np.mean(err ** 2) + 1e-30
    return 10.0 * np.log10(p_sig / p_err)
