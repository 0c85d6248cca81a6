"""Tuning / local-oscillator frequency plan (host side).

Re-expression of the reference's tuning math (tmr4/T41_SDR `Tune.cpp`):
the T41 hardware mixes with a quadrature sampling detector clocked at
4x the center frequency (`MASTER_CLK_MULT`, `MyConfigurationFile.h:14`),
with the receive LO offset so the tuned signal lands at -Fs/4 in the
capture — which is exactly the +Fs/4 shift the RX chain undoes
(t41x_torch.dsp.nco.fs4_shift).  TX CW shifts the carrier by the sidetone.

t41x has no Si5351 to program, but the frequency plan is part of the
framework contract: any SDR front end feeding t41x must place the tuned
signal per `rx_capture_offset_hz`, and these helpers are what a
hardware driver would program.

A copy of `t41x.chain.tune`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass

from t41x_torch import constants as C

MASTER_CLK_MULT = 4  # QSD clock multiple (MyConfigurationFile.h:14)


@dataclass
class LOPlan:
    rx_lo_hz: float       # QSD clock = 4 x effective center
    tx_lo_hz: float
    capture_offset_hz: float  # where the tuned signal sits in the capture


def rx_capture_offset_hz(nco_freq: float = 0.0,
                         fs: float = C.SAMPLE_RATE) -> float:
    """Capture-domain frequency of the tuned signal: nco - fs/4
    (see t41x_torch.io.signals frequency plan)."""
    return nco_freq - fs / 4.0


def lo_plan(center_freq_hz: float, nco_freq: float = 0.0,
            cw_mode: bool = False, cw_sidetone_hz: float = 750.0,
            lsb: bool = False, freq_cal_factor: float = 1.0) -> LOPlan:
    """LO programming values (reference `SetFreq` `Tune.cpp:198-232`):
    RX clock at 4x center (adjusted by the crystal cal factor); TX
    carrier shifted by -+sidetone in CW (sideband dependent,
    `Tune.cpp:205-215`)."""
    rx = center_freq_hz * MASTER_CLK_MULT * freq_cal_factor
    shift = (cw_sidetone_hz if lsb else -cw_sidetone_hz) if cw_mode else 0.0
    tx = (center_freq_hz + nco_freq + shift) * freq_cal_factor
    return LOPlan(rx_lo_hz=rx, tx_lo_hz=tx,
                  capture_offset_hz=rx_capture_offset_hz(nco_freq))
