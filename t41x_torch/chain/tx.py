"""Transmit chains (torch), port of `t41x.chain.tx`.

Re-expression of the reference exciters:

  * SSB (`ExciterIQData`, tmr4/T41_SDR `Exciter.cpp:46-169`): mic audio
    at 192 kHz -> optional mic compressor -> x4 + x2 decimation to 24
    kHz -> optional TX EQ -> Hilbert-pair quadrature split ->
    sideband-select IQ combine -> IQ corrections -> x2 + x4
    interpolation back to 192 kHz -> drive scale.  The reference uses
    two fixed 100-tap +-45 deg FIR designs (`FIR.cpp:373-580`); t41x
    designs an equivalent delay + type-III Hilbert transformer pair
    (`scipy.signal.remez`, on the host, the same taps as t41x's).
  * CW (`CW_ExciterIQData`, `CW_Excite.cpp:66-118`): keyed quadrature
    sidetone with shaped edges, generated in closed form at the RF rate.

Both are `(params, state, block) -> (state, iq)` functions, channel
batched like the receive chain, on the exciter's device (the card
unless the caller passes `device="cpu"`).  The FIR stages are the
port's `dsp.fir`; on the card the compressor launches the kernel C1
unless `TxSpec.use_kernels` is False (a field t41x's spec lacks).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain import compressor as comp_mod
from t41x_torch.dsp import eq as eq_mod
from t41x_torch.dsp import fir, firdesign as fd

TX_SCALE = 20.0  # output drive scale (Exciter.cpp:153)


@dataclasses.dataclass(frozen=True)
class TxSpec:
    sideband: str = "usb"      # 'usb' | 'lsb'
    eq_on: bool = False
    hilbert_taps: int = 101
    compressor_on: bool = False
    sample_rate: float = C.SAMPLE_RATE
    use_kernels: bool = True   # C1 on the card (the plain loop if False)


class TxParams(NamedTuple):
    iq_amp: torch.Tensor     # TX IQ amplitude correction
    iq_phase: torch.Tensor   # TX IQ phase correction
    drive: torch.Tensor      # power scale 0..1
    eq_gains: torch.Tensor   # (..., 14)


def default_tx_params(channels: tuple[int, ...] = (),
                      device="cuda") -> TxParams:
    f = lambda v: torch.full(channels, v, dtype=torch.float32,  # noqa: E731
                             device=device)
    return TxParams(f(1.0), f(0.0), f(1.0),
                    torch.ones(channels + (eq_mod.NUM_BANDS,),
                               dtype=torch.float32, device=device))


class SSBState(NamedTuple):
    dec1: torch.Tensor
    dec2: torch.Tensor
    delay: torch.Tensor     # matched delay line for the I branch
    hilb: torch.Tensor      # hilbert FIR history for the Q branch
    int1_i: torch.Tensor    # interpolator histories, I branch
    int2_i: torch.Tensor
    int1_q: torch.Tensor    # interpolator histories, Q branch
    int2_q: torch.Tensor
    eq: object
    comp: object            # mic compressor state (or ())


class SSBExciter:
    def __init__(self, spec: TxSpec = TxSpec(), device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        h1, h2 = fd.decimation_prototypes(3000.0)
        self.h1 = h1.astype(np.float32)
        self.h2 = h2.astype(np.float32)
        i1, i2 = fd.interpolation_prototypes(3000.0)
        self.hi1 = i1.astype(np.float32)
        self.hi2 = i2.astype(np.float32)
        from scipy import signal
        nt = spec.hilbert_taps | 1
        self.hilbert = signal.remez(
            nt, [250.0, 11750.0], [1.0],
            fs=spec.sample_rate / C.DF, type="hilbert").astype(np.float32)
        # matched delay for the in-phase branch: (nt-1)/2 samples
        d = np.zeros(nt, np.float32)
        d[(nt - 1) // 2] = 1.0
        self.delay_taps = d
        self.eq = (eq_mod.EQDesign(spec.sample_rate / C.DF)
                   if spec.eq_on else None)
        # mic compressor at the RF input rate (SetupMyCompressors,
        # T41_SDR.ino:1105-1113 defaults: -10 dB knee, 5:1)
        self.comp = (comp_mod.compressor_params(rate=spec.sample_rate)
                     if spec.compressor_on else None)
        self.taps = {k: torch.from_numpy(getattr(self, k)).to(self.device)
                     for k in ("h1", "h2", "hi1", "hi2", "hilbert",
                               "delay_taps")}

    def init_state(self, channels: tuple[int, ...] = ()) -> SSBState:
        nt, dev = len(self.hilbert), self.device

        def hist(n):
            return torch.zeros(channels + (n,), dtype=torch.float32,
                               device=dev)

        return SSBState(
            dec1=fir.fir_state(len(self.h1), channels, device=dev),
            dec2=fir.fir_state(len(self.h2), channels, device=dev),
            delay=fir.fir_state(nt, channels, device=dev),
            hilb=fir.fir_state(nt, channels, device=dev),
            int1_i=hist(len(self.hi1) // C.DF2 - 1),
            int2_i=hist(len(self.hi2) // C.DF1 - 1),
            int1_q=hist(len(self.hi1) // C.DF2 - 1),
            int2_q=hist(len(self.hi2) // C.DF1 - 1),
            eq=(self.eq.init_state(channels, dev) if self.eq else ()),
            comp=(comp_mod.compressor_state(channels, dev) if self.comp
                  else ()),
        )

    def block(self, params: TxParams, st: SSBState, mic: torch.Tensor):
        """mic: (..., BLOCK) float32 at 192 kHz.  Returns (state, iq)."""
        t = self.taps
        comp_state = st.comp
        if self.comp:
            comp_state, mic = comp_mod.compress(self.comp, comp_state, mic,
                                                self.spec.use_kernels)
        dec1, x = fir.fir_decimate(st.dec1, mic, t["h1"], C.DF1)
        dec2, x = fir.fir_decimate(st.dec2, x, t["h2"], C.DF2)
        eq_state = st.eq
        if self.eq:
            eq_state, x = self.eq.apply(eq_state, x, params.eq_gains)

        delay_st, i_part = fir.fir_apply(st.delay, x, t["delay_taps"])
        hilb_st, q_part = fir.fir_apply(st.hilb, x, t["hilbert"])
        # scipy's remez hilbert convention yields the LOWER sideband for
        # i + j*q; negate q for USB
        if self.spec.sideband == "usb":
            q_part = -q_part

        # TX IQ corrections (Exciter.cpp:119-129): the amplitude-corrected
        # i_c feeds q_c on the negative-phase branch
        i_c = i_part * params.iq_amp[..., None]
        ph = params.iq_phase[..., None]
        pos = ph >= 0
        i_c = torch.where(pos, i_c + ph * q_part, i_c)
        q_c = torch.where(pos, q_part, q_part + ph * i_c)

        int1_i, i_up = fir.fir_interpolate(st.int1_i, i_c, t["hi1"], C.DF2)
        int2_i, i_up = fir.fir_interpolate(st.int2_i, i_up, t["hi2"], C.DF1)
        int1_q, q_up = fir.fir_interpolate(st.int1_q, q_c, t["hi1"], C.DF2)
        int2_q, q_up = fir.fir_interpolate(st.int2_q, q_up, t["hi2"], C.DF1)

        gain = (C.DF * TX_SCALE * params.drive)[..., None]
        iq = torch.complex(i_up * gain, q_up * gain)
        new_state = SSBState(dec1, dec2, delay_st, hilb_st,
                             int1_i, int2_i, int1_q, int2_q, eq_state,
                             comp_state)
        return new_state, iq


class CWState(NamedTuple):
    phase: torch.Tensor   # (...,) tone phase
    env: torch.Tensor     # (...,) current envelope level (for shaping)


class CWExciter:
    """Keyed quadrature sidetone at the RF rate (reference
    `CW_ExciterIQData` + keyed state machines `T41_SDR.ino:1179-1295`)."""

    def __init__(self, tone_hz: float = 750.0,
                 rate: float = C.SAMPLE_RATE, rise_ms: float = 5.0,
                 device="cuda"):
        self.tone_hz = tone_hz
        self.rate = rate
        self.device = torch.device(device)
        self.rise_per_block = min(
            1.0, C.BLOCK_SIZE / (rise_ms * 1e-3 * rate))
        self.amp = 0.127 * TX_SCALE  # CW_Excite.cpp:69 x Exciter scale

    def init_state(self, channels: tuple[int, ...] = ()) -> CWState:
        z = torch.zeros(channels, dtype=torch.float32, device=self.device)
        return CWState(z, z.clone())

    def block(self, st: CWState, key_down, drive=1.0):
        """key_down: (...,) bool/0-1 keying for this block.
        Returns (state, iq) with shaped raised-cosine edges."""
        n, dev = C.BLOCK_SIZE, self.device
        target = torch.as_tensor(key_down, dtype=torch.float32, device=dev)
        # first-order envelope ramp toward the key state over the block
        t_frac = torch.arange(1, n + 1, dtype=torch.float32,
                              device=dev) / n
        env = (st.env[..., None]
               + (target - st.env)[..., None]
               * torch.clamp_max(t_frac / max(self.rise_per_block, 1e-6),
                                 1.0))
        w = 2.0 * np.pi * self.tone_hz / self.rate
        theta = st.phase[..., None] + w * torch.arange(
            1, n + 1, dtype=torch.float32, device=dev)
        a = self.amp * torch.as_tensor(drive, dtype=torch.float32,
                                       device=dev) * env
        iq = torch.complex(a * torch.cos(theta), a * torch.sin(theta))
        new_phase = torch.remainder(st.phase + w * n, 2.0 * np.pi)
        return CWState(new_phase, env[..., -1]), iq


def cw_power_scale(power_watts, cal: float = 1.0):
    """TX power polynomial (reference `T41_SDR.ino:1180`):
    powerOutCW = (-0.0133 p^2 + 0.7884 p + 4.5146) * cal."""
    p = power_watts
    return (-0.0133 * p * p + 0.7884 * p + 4.5146) * cal
