"""Radio configuration: the `config_t` equivalent with persistence.

Re-expression of the reference's three-tier config system (SURVEY.md §5):
EEPROM-persisted `config_t` (tmr4/T41_SDR `EEPROM.h:11-93`,
`EEPROM.cpp`), the per-band `struct band` table (`SDT.h:179-193`,
`T41_SDR.ino:145-168`), and SD text import/export
(`CopySDToEEPROM:870` / `CopyEEPROMToSD:1493`) — as one typed dataclass
tree serialized to JSON, versioned like the reference's struct-size
check (`EEPROMStartup` `EEPROM.cpp:1920-1946`): on version mismatch the
defaults are restored.

A copy of `t41x.config`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

CONFIG_VERSION = 2

# center-tune / fine-tune step tables (reference `ChangeFreqIncrement` /
# `ChangeFtIncrement` `ButtonProc.cpp:470-508`)
FREQ_INCREMENTS = (10, 50, 100, 250, 1000, 10_000, 100_000, 1_000_000)
FT_INCREMENTS = (10, 50, 250, 500)


@dataclass
class BandConfig:
    """Per-band settings (reference `struct band`)."""
    name: str
    freq: int               # current frequency, Hz
    band_low: int
    band_high: int
    mode: str               # demod mode
    f_hi_cut: int
    f_lo_cut: int
    rf_gain: int = 1
    gain_correction: float = 0.0
    agc_thresh: int = 20
    pixel_offset: int = 20
    iq_amp_correction: float = 1.0
    iq_phase_correction: float = 0.0
    iq_amp_correction_tx: float = 1.0
    iq_phase_correction_tx: float = 0.0
    noise_floor: int = 0    # spectrum noise-floor offset (currentNoiseFloor)


# 80M/40M upper band edges per ITU region (reference `T41_SDR.ino:148-162`
# `#if ITU_REGION` conditionals); regions differ only in those limits.
_REGION_EDGES = {1: (3_800_000, 7_200_000),
                 2: (4_000_000, 7_300_000),
                 3: (3_900_000, 7_200_000)}


def default_bands(itu_region: int = 2) -> list[BandConfig]:
    """Band table for an ITU region (reference `T41_SDR.ino:145-168`).

    The reference fixes the region at compile time
    (`MyConfigurationFile.h:27-29`); here it's a constructor argument.
    """
    hi80, hi40 = _REGION_EDGES.get(itu_region, _REGION_EDGES[2])
    mk = BandConfig
    return [
        mk("80M", 3_700_000, 3_500_000, hi80, "lsb", -200, -3000,
           gain_correction=-2.0),
        mk("40M", 7_150_000, 7_000_000, hi40, "lsb", -200, -3000,
           gain_correction=-2.0),
        mk("20M", 14_200_000, 14_000_000, 14_350_000, "usb", 3000, 200,
           gain_correction=2.0),
        mk("17M", 18_100_000, 18_068_000, 18_168_000, "usb", 3000, 200,
           gain_correction=2.0),
        mk("15M", 21_200_000, 21_000_000, 21_450_000, "usb", 3000, 200,
           gain_correction=5.0),
        mk("12M", 24_920_000, 24_890_000, 24_990_000, "usb", 3000, 200,
           gain_correction=6.0),
        mk("10M", 28_350_000, 28_000_000, 29_700_000, "usb", 3000, 200,
           gain_correction=8.5),
    ]


@dataclass
class RadioConfig:
    """The persisted radio state (reference `config_t`)."""
    version: int = CONFIG_VERSION
    current_band: int = 2           # 20M
    op_mode: str = "ssb"            # operating mode ssb/cw/data (xmtMode)
    audio_volume: int = 50
    agc_mode: int = 2
    nr_mode: int = 0
    notch_on: bool = False
    nb_on: bool = False
    spectrum_zoom: int = 1
    rf_gain_all_bands: float = 0.0
    auto_rf_gain: bool = False      # digitizer auto-gain (Codec_gain)
    center_freq: int = 14_200_000
    center_freq_b: int = 7_150_000   # VFO B (split operation, Tune.cpp:251)
    active_vfo: str = "A"
    split_on: bool = False
    nco_freq: float = 0.0
    fine_tune_step: int = 50
    # center/fine tune increment tables (ButtonProc.cpp:470-508)
    tune_index: int = 4             # -> FREQ_INCREMENTS[tune_index]
    ft_index: int = 1               # -> FT_INCREMENTS[ft_index]
    fine_tune_active: bool = True   # CAT FS / SetFtActive
    live_noise_floor: bool = False  # CAT NG / liveNoiseFloorFlag
    transmit_power: float = 20.0    # watts (transmitPowerLevel)
    cw_wpm: int = 18
    cw_sidetone_hz: float = 750.0
    cw_filter_index: int = 5
    cw_power: float = 10.0
    mic_gain: int = 10
    mic_compression: float = -10.0
    receive_eq_on: bool = False
    xmit_eq_on: bool = False
    equalizer_rec: list[int] = field(default_factory=lambda: [100] * 14)
    equalizer_xmt: list[int] = field(default_factory=lambda: [100] * 14)
    nr_alpha: float = 0.95
    nr_beta: float = 0.85
    nr_psi: float = 2.5
    omega_n: float = 200.0
    pll_fmax: float = 4000.0
    my_call: str = "N0CALL"
    my_grid: str = "AA00aa"
    freq_cal_factor: float = 1.0
    itu_region: int = 2
    bands: list[BandConfig] = field(default_factory=default_bands)
    favorites: list[int] = field(default_factory=list)

    def __post_init__(self):
        if self.itu_region != 2 and self.bands == default_bands():
            self.bands = default_bands(self.itu_region)

    # ------------------------------------------------------------------
    @property
    def band(self) -> BandConfig:
        return self.bands[self.current_band]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RadioConfig":
        bands = [BandConfig(**b) for b in d.pop("bands", [])]
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in known and k != "bands"})
        if bands:
            cfg.bands = bands
        return cfg

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RadioConfig":
        """Load config; restore defaults on version mismatch (the
        reference's struct-size versioning, `EEPROMStartup`)."""
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        if d.get("version") != CONFIG_VERSION:
            return cls()
        try:
            return cls.from_dict(d)
        except (TypeError, KeyError):
            return cls()
