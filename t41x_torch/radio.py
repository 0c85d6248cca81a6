"""High-level radio API: port of `t41x.radio`.

The user-facing surface: a `Radio` holds a `RadioConfig` (persistable),
builds the matching receive chain on its device, and exposes the
reference's control operations (band/mode/tune/volume — the encoder and
button semantics of tmr4/T41_SDR `ButtonProc.cpp`/`Encoders.cpp`) as
methods, plus capture-level receive/decode entry points.

Control mutations are staged between processing calls: changing
band/mode swaps in a different chain; changing dynamic parameters just
updates the `ChannelParams` tensors.  The control surface is
`t41x.radio.Radio`'s, line for line.  The radio runs on the card unless
the caller passes `device="cpu"`; on the card the chain's stages take
their CUDA kernels (`ChainSpec.use_kernels`), on the CPU their plain
torch versions.  The FT8 and PSK31 decoders and the transmit chains are
not in the port yet: those entry points raise `NotImplementedError`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, ChannelParams, RxChain, default_params
from t41x_torch.config import RadioConfig

DECODERS_TODO = ("not in t41x_torch yet: the FT8 and PSK31 decoders come "
                 "with the decoder slice (ROADMAP.md Queue 1, item 4)")
TX_TODO = ("not in t41x_torch yet: the transmit chains come with the TX "
           "slice (ROADMAP.md Queue 1, item 3)")


class Radio:
    def __init__(self, config: RadioConfig | None = None, device="cuda"):
        self.config = config or RadioConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Radio: no CUDA card is visible; pass device=\"cpu\" to run "
                "the chain's plain torch versions on the CPU")
        self._chain: RxChain | None = None
        self._chain_spec: ChainSpec | None = None
        self.metrics: dict = {}

    # --- control surface (reference: buttons/encoders/menus) ----------
    def set_band(self, index_or_name) -> None:
        cfg = self.config
        if isinstance(index_or_name, str):
            names = [b.name for b in cfg.bands]
            index_or_name = names.index(index_or_name.upper())
        cfg.current_band = int(index_or_name)
        cfg.center_freq = cfg.band.freq
        self._chain = None

    def set_mode(self, mode: str) -> None:
        self.config.band.mode = mode
        # SetupMode defaults (Filter.cpp:341-385)
        if mode in ("usb", "ft8", "psk31", "nfm", "cw"):
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = 200, 3000
        elif mode == "lsb":
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = -3000, -200
        elif mode in ("am", "sam"):
            self.config.band.f_lo_cut, self.config.band.f_hi_cut = -3000, 3000
        self._chain = None

    def set_filter(self, f_lo: float, f_hi: float) -> None:
        self.config.band.f_lo_cut = int(f_lo)
        self.config.band.f_hi_cut = int(f_hi)
        self._chain = None

    def set_fine_tune(self, hz: float) -> None:
        """NCO fine tune with band-edge recentering (reference
        `SetNCOFreq` `Tune.cpp:141-172`): when the tuned signal would
        leave the visible zoomed spectrum, fold the offset into the
        center frequency and reset the NCO."""
        cfg = self.config
        nco = float(hz)
        zoom = max(cfg.spectrum_zoom, 0)
        if zoom != 0:
            edge = 96_000 / (1 << zoom)
            if (nco + cfg.band.f_hi_cut) >= edge \
                    or (nco + cfg.band.f_lo_cut) <= -edge:
                cfg.center_freq = int(cfg.center_freq + nco)
                cfg.nco_freq = 0.0
                return
        elif nco > 142_000 or nco < -43_000:
            cfg.center_freq = int(cfg.center_freq + nco)
            cfg.nco_freq = 0.0
            return
        cfg.nco_freq = nco

    def toggle_vfo(self) -> None:
        """Swap VFO A/B (reference split-VFO handling, `Tune.cpp:251`)."""
        cfg = self.config
        cfg.center_freq, cfg.center_freq_b = (cfg.center_freq_b,
                                              cfg.center_freq)
        cfg.active_vfo = "B" if cfg.active_vfo == "A" else "A"

    def set_split(self, on: bool) -> None:
        self.config.split_on = bool(on)

    def set_volume(self, vol: int) -> None:
        self.config.audio_volume = int(np.clip(vol, 0, 100))

    def set_agc(self, mode: int) -> None:
        self.config.agc_mode = int(mode)
        self._chain = None

    def set_nr(self, mode: int) -> None:
        self.config.nr_mode = int(mode)
        self._chain = None

    def set_zoom(self, zoom: int) -> None:
        self.config.spectrum_zoom = int(zoom)
        self._chain = None

    def change_freq_increment(self, steps: int = 1) -> int:
        """Cycle the center-tune step table (reference
        `ChangeFreqIncrement` `ButtonProc.cpp:470`); returns the new
        increment in Hz."""
        from t41x_torch.config import FREQ_INCREMENTS
        cfg = self.config
        cfg.tune_index = (cfg.tune_index + steps) % len(FREQ_INCREMENTS)
        return FREQ_INCREMENTS[cfg.tune_index]

    def change_ft_increment(self, steps: int = 1) -> int:
        """Cycle the fine-tune step table (reference `ChangeFtIncrement`
        `ButtonProc.cpp:494`); returns the new increment in Hz."""
        from t41x_torch.config import FT_INCREMENTS
        cfg = self.config
        cfg.ft_index = (cfg.ft_index + steps) % len(FT_INCREMENTS)
        cfg.fine_tune_step = FT_INCREMENTS[cfg.ft_index]
        return cfg.fine_tune_step

    def set_noise_floor(self, value: int) -> None:
        """Per-band spectrum noise floor (reference CAT NF,
        `currentNoiseFloor[currentBand]`)."""
        self.config.band.noise_floor = int(value)

    def set_eq(self, which: str, on: bool) -> None:
        """Enable/disable the 14-band receive or transmit EQ (reference
        `MenuProc.cpp:318/:348` EQ set menus)."""
        if which == "rx":
            self.config.receive_eq_on = bool(on)
            self._chain = None   # static graph change
        elif which == "tx":
            self.config.xmit_eq_on = bool(on)
        else:
            raise ValueError("which must be 'rx' or 'tx'")

    def set_eq_band(self, which: str, band_idx: int, gain: int) -> None:
        """Set one EQ band gain, 0..100 (the reference edits
        `equalizerRec/Xmt[14]` live from the EQ menus).  Receive gains
        are dynamic params — they take effect next block without a
        chain swap."""
        if not 0 <= band_idx < 14:
            raise ValueError("EQ band index 0..13")
        gains = (self.config.equalizer_rec if which == "rx"
                 else self.config.equalizer_xmt if which == "tx"
                 else None)
        if gains is None:
            raise ValueError("which must be 'rx' or 'tx'")
        gains[band_idx] = int(np.clip(gain, 0, 100))

    def set_mic_gain(self, gain: int) -> None:
        """Mic gain, dB (reference `MenuProc.cpp:436` mic menu ->
        `currentMicGain`)."""
        self.config.mic_gain = int(np.clip(gain, -40, 30))

    def set_mic_compression(self, ratio: float) -> None:
        """Mic compression control (reference `currentMicCompRatio`;
        negative = compressor off, matching `SetupMyCompressors`
        `DSP_Fn.cpp:83-103`)."""
        self.config.mic_compression = float(ratio)

    def save_favorite(self, slot: int) -> int:
        """Store the current center frequency in a favorites slot
        (reference `EEPROMData.favoriteFreqs[13]`, set via the EEPROM
        menu)."""
        if not 0 <= slot < 13:
            raise ValueError("favorite slot 0..12")
        favs = self.config.favorites
        while len(favs) < 13:
            favs.append(0)
        favs[slot] = int(self.config.center_freq)
        return favs[slot]

    def recall_favorite(self, slot: int) -> int:
        """Tune to a stored favorite (reference `GetFavoriteFrequency`,
        band auto-switch included)."""
        favs = self.config.favorites
        if not 0 <= slot < len(favs) or not favs[slot]:
            raise ValueError(f"favorite slot {slot} is empty")
        freq = favs[slot]
        # auto-switch to the band containing the frequency
        for i, b in enumerate(self.config.bands):
            if b.band_low <= freq <= b.band_high:
                if i != self.config.current_band:
                    self.set_band(i)
                break
        self.config.center_freq = freq
        self.config.nco_freq = 0.0
        return freq

    def set_transmit_power(self, watts: float) -> None:
        self.config.transmit_power = float(np.clip(watts, 0.0, 20.0))

    def set_auto_rf_gain(self, on: bool) -> None:
        """Digitizer auto-gain (Codec_gain, Process.cpp:979-1027): the
        chain emits ADC clip taps and the runner steps band.rf_gain."""
        self.config.auto_rf_gain = bool(on)
        self._chain = None   # static graph change (clip_taps)

    # --- chain management ---------------------------------------------
    @property
    def chain(self) -> RxChain:
        if self._chain is None:
            cfg = self.config
            spec = ChainSpec(
                mode=cfg.band.mode,
                f_lo=float(cfg.band.f_lo_cut),
                f_hi=float(cfg.band.f_hi_cut),
                agc_mode=cfg.agc_mode,
                agc_thresh_db=float(cfg.band.agc_thresh),
                nr_mode=cfg.nr_mode,
                notch_on=cfg.notch_on,
                eq_on=cfg.receive_eq_on,
                spectrum_zoom=cfg.spectrum_zoom,
                clip_taps=cfg.auto_rf_gain,
                cw_filter_index=cfg.cw_filter_index,
                cw_tone_hz=cfg.cw_sidetone_hz,
                interpolate_out=False,
                # the CUDA kernels on the card, their plain versions on
                # the CPU (t41x keys `use_pallas` on a TPU backend)
                use_kernels=self.device.type == "cuda",
            )
            self._chain = RxChain(spec, device=self.device)
            self._chain_spec = spec
        return self._chain

    def params(self, channels: tuple[int, ...] = ()) -> ChannelParams:
        """The dynamic per-channel parameters, tensors on the radio's
        device."""
        cfg = self.config
        channels = tuple(channels)

        def full(v):
            return torch.full(channels, v, dtype=torch.float32,
                              device=self.device)

        p = default_params(channels, nco_freq=cfg.nco_freq,
                           volume=cfg.audio_volume, device=self.device)
        eq = torch.tensor(cfg.equalizer_rec, dtype=torch.float32,
                          device=self.device) / 100.0
        return p._replace(
            rf_gain_db=full(cfg.rf_gain_all_bands),
            band_gain=full(float(cfg.band.rf_gain)),
            iq_amp=full(cfg.band.iq_amp_correction),
            iq_phase=full(cfg.band.iq_phase_correction),
            eq_gains=eq.repeat(channels + (1,)),
        )

    # --- capture processing -------------------------------------------
    def receive(self, iq: np.ndarray) -> dict:
        """Run a capture through the configured chain.  iq: (..., N)
        complex64 at 192 kHz.  Returns the chain outputs (NumPy) plus
        metrics."""
        ch = iq.shape[:-1]
        t0 = time.perf_counter()
        out = self.chain.run(iq, params=self.params(ch))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        dt = time.perf_counter() - t0
        n_samples = int(np.prod(iq.shape))
        self.metrics = {
            "wall_s": dt,
            "input_samples": n_samples,
            "samples_per_sec": n_samples / dt,
            "realtime_channels": n_samples / dt / C.SAMPLE_RATE,
            "mode": self.config.band.mode,
        }
        return out

    def receive_wav(self, path: str) -> dict:
        from t41x_torch.io import wav

        iq, rate = wav.read_iq_wav(path)
        if rate != C.SAMPLE_RATE:
            raise ValueError(f"{path}: expected {C.SAMPLE_RATE} Hz I/Q, "
                             f"got {rate}")
        return self.receive(iq)

    # --- decoders ------------------------------------------------------
    def decode_ft8(self, iq: np.ndarray) -> list:
        raise NotImplementedError(f"Radio.decode_ft8: {DECODERS_TODO}")

    def decode_cw(self, iq: np.ndarray) -> str:
        self.set_mode("cw")
        out = self.receive(iq)
        from t41x_torch.decode import cw_text

        return cw_text.decode_envelope(out["cw_keyed"].astype(bool))

    def decode_psk31(self, iq: np.ndarray, tone_hz: float = 1000.0) -> str:
        raise NotImplementedError(f"Radio.decode_psk31: {DECODERS_TODO}")

    # --- transmit ------------------------------------------------------
    def transmit_ssb(self, mic: np.ndarray) -> np.ndarray:
        raise NotImplementedError(f"Radio.transmit_ssb: {TX_TODO}")

    def transmit_cw(self, text: str, wpm: float | None = None) -> np.ndarray:
        raise NotImplementedError(f"Radio.transmit_cw: {TX_TODO}")

    def transmit_ft8(self, message: str,
                     base_freq: float = 1200.0) -> np.ndarray:
        raise NotImplementedError(f"Radio.transmit_ft8: {DECODERS_TODO}")
