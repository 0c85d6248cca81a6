"""Digitizer auto-gain — the reference's `Codec_gain` state machine
(tmr4/T41_SDR `Process.cpp:979-1027`, called at the end of every
`ProcessIQData` pass, `Process.cpp:939`).

Per block the hardware path raises `half_clip` when any raw ADC sample
exceeded half of full scale and `quarter_clip` above a quarter (UHSDR
heritage); the control loop then steps the per-band RF gain
`bands[].RFgain` down one step when clipping nearly occurred (holdoff
20 blocks) and up one step when a 50-block window stayed below quarter
scale, clamped to [0, 15].  t41x gets the flags from the chain's
`clip_taps` outputs (`adc_half_clip` / `adc_quarter_clip`, computed on
the raw pre-gain samples) and runs this same state machine on the host
between blocks.

A copy of `t41x.chain.codec_gain`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

GAIN_MAX = 15          # Process.cpp:1008
DECREASE_HOLDOFF = 20  # blocks between gain decreases (Process.cpp:988)
INCREASE_HOLDOFF = 50  # quiet blocks before an increase (Process.cpp:1002)


class CodecGain:
    def __init__(self):
        self.timer = 0
        self.changes = 0

    def step(self, half_clip: bool, quarter_clip: bool,
             rf_gain: int) -> int:
        """One block: feed the clip flags, get the (possibly stepped)
        RF gain back.  Mirrors Codec_gain() exactly, including the
        timer saturation and the no-step-at-zero rule."""
        self.timer = min(self.timer + 1, 10000)
        if half_clip:
            if self.timer >= DECREASE_HOLDOFF and rf_gain != 0:
                rf_gain = max(rf_gain - 1, 0)
                self.timer = 0
                self.changes += 1
        elif not quarter_clip:
            if self.timer >= INCREASE_HOLDOFF:
                rf_gain = min(rf_gain + 1, GAIN_MAX)
                self.timer = 0
                self.changes += 1
        return rf_gain
