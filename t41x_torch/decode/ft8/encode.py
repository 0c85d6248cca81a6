"""FT8 encoder: message -> tones -> synthetic I/Q waveform (host side).

The reference is receive-only; t41x adds the encode path both as the TX
data-mode exciter and as the test-signal source for decoder golden tests
(SURVEY.md §4: synthetic-signal decode tests).

Symbol layout (FT8 spec / `ft8_constants.cpp:33-47`): 79 symbols of
0.16 s at 6.25 baud; Costas 7x7 sync at symbol offsets 0, 36, 72; the 58
data symbols carry 174 codeword bits, 3 bits/symbol via the Gray map.

A copy of `t41x.decode.ft8.encode`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import numpy as np

from t41x_torch import constants as C
from t41x_torch.decode.ft8 import crc, message as msg_mod
from t41x_torch.decode.ft8.tables import COSTAS, GP, GRAY, NN

TONE_SPACING = 6.25       # Hz
SYMBOL_SECONDS = 0.16


def encode_bits(payload77: np.ndarray) -> np.ndarray:
    """77 payload bits -> 174-bit LDPC codeword."""
    a91 = crc.add_crc(payload77)
    parity = (GP @ a91) % 2
    return np.concatenate([a91, parity]).astype(np.uint8)


def tones_from_bits(codeword: np.ndarray) -> np.ndarray:
    """174 codeword bits -> 79 tone indices (0..7)."""
    codeword = np.asarray(codeword).astype(int)
    data_syms = []
    for k in range(58):
        b = codeword[3 * k: 3 * k + 3]
        val = (b[0] << 2) | (b[1] << 1) | b[2]
        data_syms.append(GRAY[val])
    tones = np.zeros(NN, np.int8)
    tones[0:7] = COSTAS
    tones[36:43] = COSTAS
    tones[72:79] = COSTAS
    tones[7:36] = data_syms[:29]
    tones[43:72] = data_syms[29:]
    return tones


def encode(message: str) -> np.ndarray:
    """Message text -> 79 tones."""
    return tones_from_bits(encode_bits(msg_mod.pack77(message)))


def synth_audio(tones: np.ndarray, base_freq: float = 1000.0,
                rate: float = C.AUDIO_RATE, amp: float = 0.5,
                gfsk: bool = True, drift_hz: float = 0.0) -> np.ndarray:
    """Tones -> real audio waveform (continuous-phase 8-FSK; optional
    Gaussian-smoothed frequency transitions like WSJT-X GFSK).

    drift_hz: linear transmitter frequency drift across the 12.64 s
    transmission (an off-air impairment: a warming crystal drifts a few
    Hz per slot) — the tone track slides from base_freq to
    base_freq + drift_hz over the 79 symbols."""
    sps = int(round(SYMBOL_SECONDS * rate))
    freq_per_sym = (base_freq + np.asarray(tones, float) * TONE_SPACING
                    + drift_hz * np.linspace(0.0, 1.0, len(tones)))
    inst_freq = np.repeat(freq_per_sym, sps)
    if gfsk:
        # smooth tone transitions with a ~2 ms gaussian
        sigma = 0.002 * rate
        k = int(6 * sigma) | 1
        x = np.arange(k) - k // 2
        g = np.exp(-0.5 * (x / sigma) ** 2)
        g /= g.sum()
        inst_freq = np.convolve(inst_freq, g, mode="same")
    phase = 2.0 * np.pi * np.cumsum(inst_freq) / rate
    return (amp * np.sin(phase)).astype(np.float32)


def apply_sample_rate_offset(audio: np.ndarray, ppm: float,
                             rate: float = C.AUDIO_RATE) -> np.ndarray:
    """Resample `audio` as if the capture clock ran `ppm` parts-per-
    million fast (ppm > 0 -> the decoder, assuming the nominal rate,
    sees a slightly slow/compressed signal).  Models the cheap-TCXO
    sound-card clock error every off-air capture carries."""
    n = len(audio)
    t_nominal = np.arange(n) / rate
    t_actual = t_nominal * (1.0 + ppm * 1e-6)
    return np.interp(t_nominal, t_actual, audio,
                     left=0.0, right=0.0).astype(np.float32)


def apply_fading(audio: np.ndarray, doppler_hz: float = 0.2,
                 rate: float = C.AUDIO_RATE, seed: int = 0,
                 floor: float = 0.05) -> np.ndarray:
    """Rayleigh-ish flat fading: multiply the analytic signal by a
    complex Gaussian process low-pass filtered to `doppler_hz` (the
    ionospheric Doppler-spread scale for quiet HF paths), then take the
    real part.  `floor` keeps a small direct component so the deepest
    nulls are finite (Rician-like, as over a real path)."""
    from scipy import signal as ss

    n = len(audio)
    rng = np.random.default_rng(seed)
    # complex Gaussian at a low internal rate, interpolated up
    sub = max(int(rate / (doppler_hz * 64.0)), 1)
    m = n // sub + 8
    g = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    # 2nd-order butterworth at the doppler spread (sub-rate domain)
    b, a = ss.butter(2, min(doppler_hz / (rate / sub / 2.0), 0.99))
    g = ss.lfilter(b, a, g)
    g /= np.sqrt(np.mean(np.abs(g) ** 2)) + 1e-12
    t_sub = np.arange(m) * sub
    gain = (np.interp(np.arange(n), t_sub, g.real)
            + 1j * np.interp(np.arange(n), t_sub, g.imag))
    gain = floor + (1.0 - floor) * gain
    analytic = ss.hilbert(np.asarray(audio, np.float64))
    return np.real(analytic * gain).astype(np.float32)


def synth_iq(message: str, base_freq: float = 1000.0,
             rate: float = C.SAMPLE_RATE, nco: float = 0.0,
             amp: float = 0.5, pad_start_s: float = 0.5,
             pad_end_s: float = 0.5) -> np.ndarray:
    """Message -> 192 kHz I/Q capture: the FT8 signal appears as a USB
    audio signal at `base_freq` Hz above the tuning point."""
    tones = encode(message)
    sps = int(round(SYMBOL_SECONDS * rate))
    freq_per_sym = base_freq + np.asarray(tones, float) * TONE_SPACING
    inst = np.repeat(freq_per_sym, sps)
    sigma = 0.002 * rate
    k = int(6 * sigma) | 1
    x = np.arange(k) - k // 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    inst = np.convolve(inst, g, mode="same")
    inst = np.concatenate([
        np.full(int(pad_start_s * rate), base_freq),
        inst,
        np.full(int(pad_end_s * rate), base_freq),
    ])
    amp_env = np.ones_like(inst)
    n_sig = len(inst)
    pad_a = int(pad_start_s * rate)
    pad_b = int(pad_end_s * rate)
    amp_env[:pad_a] = 0.0
    amp_env[n_sig - pad_b:] = 0.0
    phase = 2.0 * np.pi * np.cumsum(nco - rate / 4.0 + inst) / rate
    return (amp * amp_env * np.exp(1j * phase)).astype(np.complex64)
