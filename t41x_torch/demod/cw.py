"""CW tone detection (torch), port of `t41x.demod.cw`.

The reference's CW receive processing (tmr4/T41_SDR
`DoCWReceiveProcessing` `CWProcessing.cpp:322-373`): a 64-tap band-pass
FIR at the sidetone, the cross-correlation against a reference sine (max
over all 511 lags, EMA 0.7/0.3) times the Goertzel magnitude at the
sidetone (`goertzel_mag` `CWProcessing.cpp:830-857`), a combined
coefficient and a keying decision against a decaying peak and the
absolute threshold 50.  The correlation is one product against a bank
of shifted reference sines, the Goertzel bin two dot products; all in
full fp32 (`t41x` asks the TPU for bf16 there, which is fp32 on the CPU
the port is held against).  The per-block keyed envelope feeds the host
Morse decoder (`t41x.decode.cw_text`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.dsp import fir

TONE_HZ = 750.0
BLOCK = 256  # audio samples per block at 24 kHz
THRESHOLD = 50.0


def design_cw_fir(num_taps: int = 64, tone: float = TONE_HZ,
                  rate: float = C.AUDIO_RATE) -> np.ndarray:
    """Equiripple band-pass around the sidetone (the reference ships a
    fixed Park-McClellan design, `FIR.cpp:93-175`)."""
    from scipy import signal

    bands = [0, tone - 300, tone - 120, tone + 120, tone + 300, rate / 2]
    h = signal.remez(num_taps, bands, [0, 1, 0], fs=rate)
    return h.astype(np.float32)


def reference_sine(n: int = BLOCK, tone: float = TONE_HZ,
                   rate: float = C.AUDIO_RATE) -> np.ndarray:
    """Sidetone reference (8 whole cycles of 750 Hz in 256 samples —
    `sineTone`, `Utility.cpp:66-83`)."""
    t = np.arange(n)
    return np.sin(2.0 * np.pi * tone * t / rate).astype(np.float32)


class CWState(NamedTuple):
    fir: torch.Tensor       # (..., 63) band-pass history
    ave_corr: torch.Tensor  # (...,)
    peak: torch.Tensor      # (...,) decaying peak of the combined value


class CWDetector:
    """Designed detector; `block` over (state, audio)."""

    def __init__(self, tone: float = TONE_HZ, rate: float = C.AUDIO_RATE):
        self.h = design_cw_fir(tone=tone, rate=rate)
        self.ref = reference_sine(tone=tone, rate=rate)
        k = int(0.5 + BLOCK * tone / rate)
        w = 2.0 * np.pi * k / BLOCK
        n = np.arange(BLOCK)
        self.goertzel_cos = np.cos(w * n).astype(np.float32)
        self.goertzel_sin = np.sin(w * n).astype(np.float32)
        # all 511 lags of the full cross-correlation as one product:
        # corr[l] = sum_n x[n] ref[n - l + 255]
        R = np.zeros((2 * BLOCK - 1, BLOCK), np.float32)
        for lag in range(2 * BLOCK - 1):
            shift = lag - (BLOCK - 1)
            idx = np.arange(BLOCK) - shift
            valid = (idx >= 0) & (idx < BLOCK)
            R[lag, valid] = self.ref[idx[valid]]
        self.corr_matrix = R  # (511, 256)
        self._on_device = {}

    def init_state(self, channels: tuple[int, ...] = (),
                   device=None) -> CWState:
        return CWState(
            fir=fir.fir_state(len(self.h), channels, device=device),
            ave_corr=torch.zeros(channels, device=device),
            peak=torch.zeros(channels, device=device))

    def _ops(self, device):
        if device not in self._on_device:
            self._on_device[device] = [
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.h, self.corr_matrix.T, self.goertzel_cos,
                          self.goertzel_sin)]
        return self._on_device[device]

    def block(self, st: CWState, audio: torch.Tensor):
        """audio: (..., 256) demodulated CW audio at 24 kHz.
        Returns (state, keyed (...,) bool, combined (...,))."""
        h, corr_t, gcos, gsin = self._ops(audio.device)
        fir_st, x = fir.fir_apply(st.fir, audio, h)
        corr_max = torch.amax(x @ corr_t, dim=-1)       # (..., 511) lags
        ave_corr = 0.7 * corr_max + 0.3 * st.ave_corr
        real = x @ gcos
        imag = x @ gsin
        mag = torch.sqrt(real * real + imag * imag) / (BLOCK / 2.0)
        combined = 10.0 * corr_max * 100.0 * mag
        # t41x keys against a decaying peak tracker (level-independent
        # detection) with the reference's absolute floor
        peak = torch.maximum(combined, st.peak * 0.995)
        keyed = (combined > 0.4 * peak) & (combined > THRESHOLD)
        return CWState(fir_st, ave_corr, peak), keyed, combined
