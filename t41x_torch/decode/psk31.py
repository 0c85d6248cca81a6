"""PSK31 decoder: DBPSK demodulation + varicode text decode.

Re-expression of the reference's PSK31 path (tmr4/T41_SDR `psk31.cpp`,
csdr-derived): 31.25-baud BPSK at an audio tone offset; differential
phase between symbols carries the bits (phase reversal = 0, no reversal
= 1), characters are varicode separated by "00".

t41x split:
  * device (`symbol_phases`): batched mix-to-baseband + integrate&dump to
    SAMPLES_PER_SYMBOL-oversampled symbol phases — dense math, one
    matmul-shaped reduction per block.
  * host (`Psk31Decoder`): timing-phase pick, differential slicing, and
    the varicode shift-register FSM (reference
    `psk31_varicode_decoder_push` `psk31.cpp:235-264`).

Also provides an encoder (`encode_psk31`) used by tests to synthesize
compliant signals (reference `psk31_varicode_encoder_u8_u8`
`psk31.cpp:266-290`).

Port of `t41x.decode.psk31`: `symbol_phases` runs in torch on the
capture's device, in float32 like t41x's (the time axis and the mixing
phase; in float64 they would drift ~0.03 rad from t41x's at 60 s); the
host side is t41x's code.
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.decode.psk31_varicode import VARICODE, VARICODE_REVERSE

BAUD = 31.25
SAMPLES_PER_SYMBOL = 16  # oversampling of the symbol integrator


def symbol_phases(iq_baseband: torch.Tensor, tone_hz: float = 0.0,
                  rate: float = C.AUDIO_RATE):
    """Device-side: reduce a (..., N) complex baseband capture to
    oversampled symbol-integrator phases.

    Returns (..., N // sps_in) phases where sps_in = rate/BAUD/OVERSAMPLE
    (one integrate-and-dump per 1/OVERSAMPLE symbol), and their
    magnitudes.
    """
    n, dev = iq_baseband.shape[-1], iq_baseband.device
    # a divisor on the device: a Python scalar divisor becomes a product
    # with its reciprocal on CUDA, off t41x's rounding
    t = torch.arange(n, dtype=torch.float32, device=dev) / torch.full(
        (), rate, dtype=torch.float32, device=dev)
    theta = float(np.float32(-2.0 * np.pi * tone_hz)) * t
    z = iq_baseband * torch.complex(torch.cos(theta), torch.sin(theta))
    chunk = int(round(rate / BAUD / SAMPLES_PER_SYMBOL))  # 48 @ 24 kHz
    m = n // chunk
    z = z[..., : m * chunk].reshape(z.shape[:-1] + (m, chunk))
    acc = z.sum(dim=-1)  # integrate & dump
    return torch.angle(acc), torch.abs(acc)


class Psk31Decoder:
    """Host-side streaming decoder over oversampled symbol phases."""

    def __init__(self):
        self.shift = ""
        self.text: list[str] = []

    def _push_bit(self, bit: int) -> None:
        self.shift += "1" if bit else "0"
        if self.shift.endswith("00"):
            code = self.shift[:-2].lstrip("0")
            if code:
                a = VARICODE_REVERSE.get(code)
                if a is not None:
                    self.text.append(chr(a))
            self.shift = ""
        elif len(self.shift) > 16:
            self.shift = self.shift[-12:]

    def decode(self, phases: np.ndarray, mags: np.ndarray) -> str:
        """One-shot decode of an oversampled phase stream."""
        phases = np.asarray(phases)
        mags = np.asarray(mags)
        sps = SAMPLES_PER_SYMBOL
        n_sym = len(phases) // sps
        if n_sym < 3:
            return ""
        ph = phases[: n_sym * sps].reshape(n_sym, sps)
        # timing recovery: pick the sub-symbol phase with the most stable
        # differential decisions (max mean |cos dphi|)
        dph = np.angle(np.exp(1j * (ph[1:] - ph[:-1])))
        score = np.abs(np.cos(dph)).mean(axis=0)
        k = int(np.argmax(score))
        d = dph[:, k]
        bits = (np.abs(d) < np.pi / 2).astype(int)  # reversal -> 0
        start = len(self.text)
        for b in bits:
            self._push_bit(int(b))
        return "".join(self.text[start:])


def encode_psk31(text: str) -> np.ndarray:
    """Text -> bit array (1 = keep phase, 0 = reverse phase), with the
    inter-character "00" separators and idle preamble/postamble."""
    bits = [0] * 32  # idle: continuous phase reversals
    for ch in text:
        code = VARICODE.get(ord(ch))
        if code is None:
            continue
        bits.extend(int(b) for b in code)
        bits.extend([0, 0])
    bits.extend([0] * 32)
    return np.asarray(bits, np.int8)


def synth_psk31(text: str, tone_hz: float = 1000.0,
                rate: float = C.SAMPLE_RATE, nco: float = 0.0,
                amp: float = 0.5, shaped: bool = True) -> np.ndarray:
    """Synthesize a 192 kHz I/Q PSK31 capture for tests: the BPSK tone
    appears `tone_hz` above the (shifted) tuning point, like a USB audio
    tone."""
    bits = encode_psk31(text)
    sps = int(round(rate / BAUD))
    n = len(bits) * sps
    # phase per symbol: cumulative pi flips on 0-bits
    sym_phase = np.cumsum(bits == 0) * np.pi
    phase = np.repeat(sym_phase, sps)
    if shaped:
        # cosine amplitude shaping through reversals (PSK31 envelope)
        env = np.ones(n)
        half = sps // 2
        ramp = 0.5 * (1.0 - np.cos(np.pi * np.arange(half) / half))
        for i, b in enumerate(bits):
            if b == 0:
                s = i * sps
                env[max(s - half, 0): s] = ramp[::-1][: min(half, s)]
                env[s: s + half] = ramp[: min(half, n - s)]
    else:
        env = 1.0
    t = np.arange(n) / rate
    carrier = 2.0 * np.pi * (nco - rate / 4.0 + tone_hz) * t
    return (amp * env * np.exp(1j * (carrier + phase))).astype(np.complex64)


def decode_capture(iq_baseband, tone_hz: float = 0.0,
                   rate: float = C.AUDIO_RATE, device="cuda") -> str:
    """Convenience: baseband I/Q (audio rate) -> text; the symbol
    integrator runs on `device`."""
    z = torch.as_tensor(np.asarray(iq_baseband, np.complex64)).to(device)
    ph, mag = symbol_phases(z, tone_hz, rate)
    return Psk31Decoder().decode(ph.cpu().numpy(), mag.cpu().numpy()).strip()
