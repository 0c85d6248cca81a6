"""RF display spectrum and S-meter (torch), port of `t41x.dsp.spectrum`
(the reference display DSP, tmr4/T41_SDR `FFT.cpp`):

  * `zoom1_spectrum` — zoom x1: Hann-windowed 512-point FFT of the first
    512 I/Q samples of the block, halves swapped, EMA-smoothed
    (`CalcZoom1Magn`, `FFT.cpp:208-251`).
  * `ZoomFFT` — zoom 2^z: anti-alias IIR low-pass + FIR decimate by 2^z
    into a 512-sample ring, Hann window, 512-point FFT, power, halves
    swapped, EMA (`ZoomFFTExe`, `FFT.cpp:67-196`; filter prep
    `ZoomFFTPrep`, `:35-55`).  The RF-rate half (`prefilter`) is what
    the fused front end's zoom variant computes in its kernel.
  * `pixels_db` / `smeter_dbm` — log scaling to display pixels and the
    S-meter dBm formula (`Display.cpp:978-982`).

The FFTs are `torch.fft.fft` where `t41x` calls its TPU matmul FFT.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.dsp import fir, firdesign as fd, iir

RES = C.SPECTRUM_RES  # 512
EMA = 0.7             # spectrum temporal smoothing (FFT.cpp:171)


def _hann(n: int) -> np.ndarray:
    i = np.arange(n)
    # the reference uses cos(6.28 i / N) — keep the (slightly detuned)
    # 6.28 constant for parity (FFT.cpp:156-157)
    return (0.5 - 0.5 * np.cos(6.28 * i / n)).astype(np.float32)


@functools.cache
def _hann_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hann(RES)).to(device)


def _swap_halves(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p[..., RES // 2:], p[..., : RES // 2]], dim=-1)


def zoom1_spectrum(spec_old: torch.Tensor, iq: torch.Tensor):
    """Zoom x1 display spectrum from a (..., >=512) I/Q block.
    spec_old: (..., 512) EMA state.  Returns (spec_old', power)."""
    return zoom1_from_segment(spec_old, iq[..., :RES])


def zoom1_from_segment(spec_old: torch.Tensor, seg: torch.Tensor):
    """Zoom x1 tail from the first 512 I/Q samples of a block (the fused
    front end emits this segment directly)."""
    spec = torch.fft.fft(seg * _hann_on(seg.device), dim=-1)
    power = _swap_halves(spec.real ** 2 + spec.imag ** 2)
    sm = EMA * power + (1.0 - EMA) * spec_old
    return sm, sm


class ZoomState(NamedTuple):
    iir: torch.Tensor       # (..., 2, stages, 2) anti-alias IIR, I and Q
    dec: torch.Tensor       # (..., taps-1) complex decimator history
    ring: torch.Tensor      # (..., 512) complex, newest decimated samples
    spec_old: torch.Tensor  # (..., 512) EMA state


def zoom_prefilter(iir_op: iir.BiquadChunked, h: torch.Tensor, factor: int,
                   iir_state: torch.Tensor, dec_state: torch.Tensor,
                   iq: torch.Tensor):
    """Anti-alias IIR then decimate-by-`factor` over (..., N) complex
    I/Q, I and Q as two real streams.  Returns (iir_state, dec_state,
    decimated (..., N/factor))."""
    iir_state, xi = iir_op.apply(iir_state,
                                 torch.stack([iq.real, iq.imag], dim=-2))
    dec_state, x = fir.fir_decimate(
        dec_state, torch.complex(xi[..., 0, :], xi[..., 1, :]), h, factor)
    return iir_state, dec_state, x


class ZoomFFT:
    """Configured zoom-FFT display tap for one zoom level (2^z)."""

    def __init__(self, zoom: int, rate: float = C.SAMPLE_RATE):
        assert 1 <= zoom <= 7
        self.zoom = zoom
        self.factor = 1 << zoom
        f_stop = 0.5 * rate / self.factor
        # 4-tap FIR decimator prototype, Astop 60 (ZoomFFTPrep FFT.cpp:41)
        self.h = fd.fir_kaiser(4, f_stop, 60.0, fs=rate).astype(np.float32)
        # anti-alias IIR: 8th-order elliptic, -3 dB at the decimated
        # Nyquist (mag_coeffs, FIR.cpp:582-885)
        sos = fd.zoom_antialias_iir(zoom, fs=rate)
        self.iir_b = sos[:, :3].astype(np.float32)
        self.iir_a = sos[:, 3:].astype(np.float32)
        self.iir_op = iir.BiquadChunked(self.iir_b, self.iir_a, chunk=128)
        # display scaling multiplier (FFT.cpp:148-151)
        self.multiplier = float(zoom if zoom <= 3 else self.factor)
        self._h_on = {}

    def init_state(self, channels: tuple[int, ...] = (),
                   device=None) -> ZoomState:
        def z(shape, dtype=torch.float32):
            return torch.zeros(channels + shape, dtype=dtype, device=device)

        return ZoomState(iir=z((2, self.iir_b.shape[0], 2)),
                         dec=z((len(self.h) - 1,), torch.complex64),
                         ring=z((RES,), torch.complex64),
                         spec_old=z((RES,)))

    def block(self, st: ZoomState, iq: torch.Tensor):
        """iq: (..., BLOCK) Fs/4-shifted I/Q.  Returns (state, power)."""
        st, x = self.prefilter(st, iq)
        return self.spectrum_from_decimated(st, x)

    def prefilter(self, st: ZoomState, iq: torch.Tensor):
        """Anti-alias IIR + decimate-by-2^zoom (the RF-rate half of the
        tap).  Returns (state with new iir/dec, decimated I/Q)."""
        if iq.device not in self._h_on:
            self._h_on[iq.device] = torch.from_numpy(self.h).to(iq.device)
        iir_st, dec_st, x = zoom_prefilter(
            self.iir_op, self._h_on[iq.device], self.factor, st.iir, st.dec,
            iq)
        return ZoomState(iir_st, dec_st, st.ring, st.spec_old), x

    def spectrum_from_decimated(self, st: ZoomState, x: torch.Tensor):
        """Ring update + Hann/FFT/power/EMA over the decimated zoom
        stream (the display-rate half of the tap)."""
        n_new = x.shape[-1]
        if n_new >= RES:
            ring = x[..., -RES:]
        else:
            ring = torch.cat([st.ring[..., n_new:], x], dim=-1)
        spec = torch.fft.fft(ring * (self.multiplier * _hann_on(x.device)),
                             dim=-1)
        power = _swap_halves(spec.real ** 2 + spec.imag ** 2)
        sm = EMA * power + (1.0 - EMA) * st.spec_old
        return ZoomState(st.iir, st.dec, ring, sm), sm


def pixels_db(power: torch.Tensor, db_scale: float = 10.0,
              base_offset: float = 0.0, pixel_offset: float = 0.0):
    """Spectrum power -> display pixel heights (FFT.cpp:185)."""
    return (base_offset + pixel_offset
            + db_scale * torch.log10(torch.clamp(power, min=1e-30)))


def smeter_dbm(audio_max_squared_ave: torch.Tensor,
               gain_correction: float = 0.0, attenuator: float = 0.0,
               rf_gain: float = 1.0, rf_gain_all: float = 0.0):
    """S-meter formula (reference `DrawSmeterBar`, `Display.cpp:978-982`):
    dbm = 22 + gainCorrection + attenuator + 10 log10(audioMaxSquaredAve)
    - 92 - RFgain*1.5 - rfGainAllBands."""
    return (22.0 + gain_correction + attenuator
            + 10.0 * torch.log10(torch.clamp(audio_max_squared_ave,
                                             min=1e-30))
            - 92.0 - rf_gain * 1.5 - rf_gain_all)
