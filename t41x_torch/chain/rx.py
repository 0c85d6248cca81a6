"""The receive chain in torch: port of `t41x.chain.rx`.

One block of the reference's per-block hot path (`ProcessIQData`,
tmr4/T41_SDR `Process.cpp:70-944`):

    q15->f32, RF gain, DC block, IQ correction, zoom x1 or 2^z
    panadapter tap, Fs/4 shift, NCO mix, x4 + x2 decimation,
    overlap-save band-pass (+ audio-spectrum / S-meter tap), AGC, demod
    (SSB/CW/AM/SAM/NFM), receive EQ, noise reduction, automatic notch,
    noise blanker, CW detection and narrow CW filter, x2 + x4
    interpolation, volume

as `block(params, state, iq) -> (state, outputs)` with every per-channel
state carried explicitly (`RxState`, the same fields and layouts as
`t41x`'s, so `t41x_torch.utils.convert` moves a stream between the two
mid-way) and channels on the leading axes.  `ChainSpec.use_kernels`
routes the front end (with its zoom x1 or 2^z tap), AGC, SAM PLL, Kim
and spectral NR gains, LMS/notch, receive EQ, noise blanker,
interpolation and the display-free OS filter through the hand-written CUDA kernels of `t41x_torch.kernels` (their
plain torch versions on CPU tensors).  Every `ChainSpec` that `t41x`
accepts runs here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.demod import am as am_mod, cw as cw_mod, nfm as nfm_mod
from t41x_torch.demod import sam as sam_mod, ssb as ssb_mod
from t41x_torch.dsp import agc as agc_mod, eq as eq_mod
from t41x_torch.dsp import fir, firdesign as fd, iir, nb as nb_mod, nco
from t41x_torch.dsp import nr as nr_mod, osfilter
from t41x_torch.dsp import spectrum as spectrum_mod
from t41x_torch.utils.tracing import setup_span, stage

SSB_FAMILY = ("usb", "lsb", "ft8", "cw")
MODES = SSB_FAMILY + ("am", "sam", "nfm", "psk31")


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static chain configuration (`t41x.chain.rx.ChainSpec`, with
    `use_pallas` renamed `use_kernels`)."""
    mode: str = "usb"
    f_lo: float = 200.0        # band-pass low cut, Hz (audio domain)
    f_hi: float = 3000.0       # band-pass high cut, Hz
    agc_mode: int = 2          # 0 off / 1 long / 2 slow / 3 med / 4 fast
    agc_thresh_db: float = 20.0
    nfm_bw: float = 12000.0    # NFM decimator design BW (Filter.cpp:16)
    nr_mode: int = 0           # 0 off / 1 Kim / 2 spectral / 3 LMS
    nb_on: bool = False        # LPC impulse noise blanker
    cw_decode: bool = True     # CW tone detection taps (mode 'cw' only)
    cw_filter_index: int = 5   # 0..4 narrow audio LPF, 5 = off
    cw_tone_hz: float = 750.0
    notch_on: bool = False     # automatic notch (Xanr error output)
    eq_on: bool = False        # 14-band receive EQ
    spectrum_zoom: int = -1    # -1 off / 0 zoom x1 / 1..7 zoom x2^z
    interpolate_out: bool = True
    use_matmul_osfilter: bool = True
    use_kernels: bool = True   # CUDA kernels (plain versions on CPU)
    q15_input: bool = False    # ingest ADC q15 int16 (i, q) pairs
    spectrum_taps: bool = True  # emit audio-spectrum + S-meter taps
    clip_taps: bool = False    # emit ADC half/quarter-clip flags
    sample_rate: float = C.SAMPLE_RATE
    fft_length: int = C.FFT_LENGTH

    def __post_init__(self):
        assert self.mode in MODES, self.mode


class ChannelParams(NamedTuple):
    """Dynamic per-channel parameters, (...,) tensors for a channel batch."""
    nco_freq: torch.Tensor       # fine-tune NCO, Hz
    rf_gain_db: torch.Tensor     # rfGainAllBands (dB, Process.cpp:117)
    band_gain: torch.Tensor      # bands[].RFgain linear scale
    iq_amp: torch.Tensor         # IQAmpCorrectionFactor
    iq_phase: torch.Tensor       # IQPhaseCorrectionFactor
    volume: torch.Tensor         # 0..100
    eq_gains: torch.Tensor       # (..., 14) EQ band gains 0..1


def default_params(channels: tuple[int, ...] = (), nco_freq: float = 0.0,
                   volume: float = 50.0, device="cuda") -> ChannelParams:
    def f(v):
        return torch.full(channels, v, dtype=torch.float32, device=device)

    return ChannelParams(f(nco_freq), f(0.0), f(1.0), f(1.0), f(0.0),
                         f(volume),
                         torch.ones(channels + (eq_mod.NUM_BANDS,),
                                    device=device))


class RxState(NamedTuple):
    """Carried DSP state between blocks (leading dims = channels); the
    fields and layouts of `t41x.chain.rx.RxState`.  Fields of stages the
    spec leaves out hold zeros of the same layout, or ()."""
    dc_bq: torch.Tensor      # (..., 2, 1, 2) DC-block biquad state (I,Q)
    nco_phase: torch.Tensor  # (...,)
    dec1: torch.Tensor       # (..., T1-1) complex
    dec2: torch.Tensor       # (..., T2-1) complex
    osf: torch.Tensor        # (..., F/2) complex overlap-save history
    agc: agc_mod.AGCState
    am_bq: torch.Tensor      # (..., 2, 2) AM DC-block + lowpass cascade
    sam: sam_mod.SAMState
    nfm_last: torch.Tensor   # (...,) complex
    int1: torch.Tensor       # (..., T/2-1) interpolation histories (real)
    int2: torch.Tensor
    smeter_avg: torch.Tensor  # (...,) audioMaxSquaredAve EMA
    nr: object               # NR state for the configured nr_mode (or ())
    cw: object               # CWState (or ())
    cw_lp: object            # (..., 6, 2) narrow CW filter state (or ())
    notch: object            # Xanr notch state (or ())
    eq: object               # (..., 14, S, 2) EQ band states (or ())
    zoom: object             # ZoomState, or the zoom1 EMA (..., 512)


class RxChain:
    """Configured receive chain: the spec, the designed filters (NumPy,
    plus tensors on `device`), and `block` over (params, state, iq).
    It runs on the card unless the caller passes `device="cpu"`; with no
    card visible that default raises (there is no fallback)."""

    @setup_span("design")
    def __init__(self, spec: ChainSpec = ChainSpec(), device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RxChain: no CUDA card is visible; pass device=\"cpu\" to "
                "run the chain's plain torch versions on the CPU")
        lp = min(max(spec.f_hi, -spec.f_lo), 10_000.0)
        # NFM refits the decimators to the demod bandwidth
        # (Process.cpp:259, SetDecIntFilters(nfmFilterBW))
        dec_bw = spec.nfm_bw if spec.mode == "nfm" else lp
        self.h1 = fd.fir_kaiser(C.dec1_taps(), dec_bw, C.N_ATT,
                                fs=spec.sample_rate).astype(np.float32)
        self.h2 = fd.fir_kaiser(C.dec2_taps(), dec_bw, C.N_ATT,
                                fs=spec.sample_rate / C.DF1
                                ).astype(np.float32)
        i1, i2 = fd.interpolation_prototypes(lp)
        self.hi1 = i1.astype(np.float32)
        self.hi2 = i2.astype(np.float32)

        mask = fd.bandpass_mask(spec.f_lo, spec.f_hi,
                                spec.sample_rate / C.DF, spec.fft_length)
        self.mask = mask.astype(np.complex64)
        self.os_W = osfilter.os_matmul_operator(mask)
        self.os_F, self.os_W2, self.os_mask_sq = \
            osfilter.os_spectrum_operators(mask)

        # DC-block biquad at RF rate (Process.cpp:127), chunk-parallel
        b, a = fd.dc_block_biquad()
        self.dc_b = np.asarray([b], np.float32)
        self.dc_a = np.asarray([a], np.float32)
        self.dc_op = iir.BiquadChunked(self.dc_b, self.dc_a, chunk=128)

        # AM audio lowpass, SetIIRCoeffs(FHiCut, 1.3, fs/DF)
        # (T41_SDR.ino:563), fused with the one-pole DC removal into one
        # chunk-parallel 2-stage cascade
        bb, aa = fd.biquad_rbj(abs(spec.f_hi), 1.3, spec.sample_rate / C.DF,
                               "lowpass")
        self.am_b = np.asarray([bb], np.float32)
        self.am_a = np.asarray([aa], np.float32)
        self.am_op = iir.BiquadChunked(*am_mod.am_post_cascade(bb, aa),
                                       chunk=64)

        self.agc_params = agc_mod.agc_params(spec.agc_mode,
                                             spec.agc_thresh_db,
                                             spec.sample_rate / C.DF)
        self.sam_params = sam_mod.sam_params(rate=spec.sample_rate / C.DF)
        # SSB level adjust (Process.cpp:482-492)
        f_cut_khz = (-spec.f_lo if spec.mode == "lsb" else spec.f_hi) * 1e-3
        self.vol_scale = float(7.0874 * abs(f_cut_khz) ** -1.232)

        # post-demod stages
        self.kim_params = nr_mod.kim_params(spec.f_lo, spec.f_hi)
        self.spectral_nr_params = nr_mod.spectral_params(spec.f_lo, spec.f_hi)
        self.xanr_params = nr_mod.XanrParams(notch=False)
        self.notch_params = nr_mod.XanrParams(notch=True)
        rate = spec.sample_rate / C.DF
        self.eq = eq_mod.EQDesign(rate) if spec.eq_on else None
        self.cw = (cw_mod.CWDetector(spec.cw_tone_hz, rate)
                   if spec.mode == "cw" and spec.cw_decode else None)
        if spec.mode == "cw" and spec.cw_filter_index < 5:
            # the narrow CW audio low-pass (FIR.cpp:15-66, applied
            # Process.cpp:882-912): 12-pole Chebyshev I, chunk-parallel
            sos = fd.cw_audio_lpf(fd.CW_FILTER_FC_HZ[spec.cw_filter_index],
                                  fs=rate)
            self.cw_lp_b = sos[:, :3].astype(np.float32)
            self.cw_lp_a = sos[:, 3:].astype(np.float32)
            self.cw_lp_op = iir.BiquadChunked(self.cw_lp_b, self.cw_lp_a,
                                              chunk=64)
        else:
            self.cw_lp_b = None
        self.zoomfft = (spectrum_mod.ZoomFFT(spec.spectrum_zoom,
                                             spec.sample_rate)
                        if spec.spectrum_zoom >= 1 else None)

        # the designs the plain stages use, on the chain's device
        self.tensors = {
            k: torch.from_numpy(getattr(self, k)).to(self.device)
            for k in ("h1", "h2", "hi1", "hi2", "mask", "os_W", "os_F",
                      "os_W2", "os_mask_sq")}

        if spec.use_kernels:
            from t41x_torch.kernels.frontend import FusedFrontEnd
            from t41x_torch.kernels.interp import FusedInterp
            from t41x_torch.kernels.os_filter import pack_w
            from t41x_torch.kernels.os_spectrum import tables
            # K4 reads W as k-major real and imaginary planes
            self.tensors["os_Wp"] = pack_w(self.tensors["os_W"])
            if spec.spectrum_taps:
                # B1's twiddles and mask, designed in float64
                self.tensors["os_tab"] = torch.from_numpy(
                    tables(mask)).to(self.device)
            if self.zoomfft is not None:
                zkw = dict(zoom=spec.spectrum_zoom,
                           zoom_sos=(self.zoomfft.iir_b,
                                     self.zoomfft.iir_a),
                           zoom_h=self.zoomfft.h)
            else:
                zkw = dict(zoom=0 if spec.spectrum_zoom == 0 else None)
            self.fused_fe = FusedFrontEnd(
                self.h1, self.h2, self.dc_b[0], self.dc_a[0],
                spec.sample_rate, **zkw)
            self.fused_interp = (FusedInterp(self.hi1, self.hi2)
                                 if spec.interpolate_out else None)
        else:
            self.fused_fe = None
            self.fused_interp = None

    # ------------------------------------------------------------------
    def init_state(self, channels: tuple[int, ...] = (),
                   device=None) -> RxState:
        dev = self.device if device is None else torch.device(device)
        spec = self.spec
        f32, c64 = torch.float32, torch.complex64

        def z(shape=(), dtype=f32):
            return torch.zeros(channels + shape, dtype=dtype, device=dev)

        return RxState(
            dc_bq=z((2, 1, 2)),
            nco_phase=z(),
            dec1=z((len(self.h1) - 1,), c64),
            dec2=z((len(self.h2) - 1,), c64),
            osf=osfilter.os_state(channels, spec.fft_length, dev),
            agc=agc_mod.agc_state(self.agc_params, channels, dev),
            am_bq=iir.biquad_state(channels, stages=2, device=dev),
            sam=sam_mod.sam_state(channels, dev),
            nfm_last=z(dtype=c64),
            int1=z((len(self.hi1) // C.DF2 - 1,)),
            int2=z((len(self.hi2) // C.DF1 - 1,)),
            smeter_avg=z(),
            nr=(nr_mod.kim_state(channels, dev) if spec.nr_mode == 1
                else nr_mod.spectral_state(channels, dev)
                if spec.nr_mode == 2
                else nr_mod.xanr_state(self.xanr_params, channels, dev)
                if spec.nr_mode == 3 else ()),
            notch=(nr_mod.xanr_state(self.notch_params, channels, dev)
                   if spec.notch_on else ()),
            cw=(self.cw.init_state(channels, dev) if self.cw else ()),
            cw_lp=(iir.biquad_state(channels, self.cw_lp_b.shape[0], dev)
                   if self.cw_lp_b is not None else ()),
            eq=(self.eq.init_state(channels, dev) if self.eq else ()),
            zoom=(self.zoomfft.init_state(channels, dev) if self.zoomfft
                  else z((spectrum_mod.RES,)) if spec.spectrum_zoom == 0
                  else ()),
        )

    # ------------------------------------------------------------------
    def block(self, params: ChannelParams, state: RxState, iq):
        """Process one block.

        iq: (..., BLOCK) complex64 at the RF rate — or, with
        spec.q15_input, a pair of int16 tensors (i, q) in the
        reference's ADC q15 format (Process.cpp:102-111).
        Returns (new_state, outputs: dict of tensors).
        """
        with stage("frontend"):
            x, outputs, fe_upd = self._front(params, state, iq)
        return self._post_frontend(params, state._replace(**fe_upd), x,
                                   outputs)

    def _post_frontend(self, params, state, x, outputs):
        """The audio-rate tail of the chain (band-pass, AGC, demod, EQ,
        NR, notch, NB, CW, interpolation) over x, the (..., 256) complex
        24 kHz front-end output; `state`'s front-end fields pass through.
        `block` runs it after the front end, and the time-sharded chain
        (`t41x_torch.mesh.timeshard`) over the output of its sharded front
        end, so that both run one code path."""
        state, audio, outputs = self._tail_pre_nr(params, state, x, outputs)
        nr_state = state.nr
        if self.spec.nr_mode:
            with stage("nr"):
                nr_state, audio = self._apply_nr(nr_state, audio)
        return self._tail_post_nr(params, state._replace(nr=nr_state),
                                  audio, outputs)

    def _block_pre_nr(self, params, state, iq):
        """One block through the front end and the pre-NR tail; returns
        (state with the pre-NR fields updated, audio, outputs)."""
        with stage("frontend"):
            x, outputs, fe_upd = self._front(params, state, iq)
        return self._tail_pre_nr(params, state._replace(**fe_upd), x,
                                 outputs)

    def _apply_nr(self, nr_state, audio):
        """Per-block noise reduction (Process.cpp:841-858); `block_batch`
        has the cross-block batched form."""
        spec = self.spec
        if spec.nr_mode == 1:
            return nr_mod.kim_nr(self.kim_params, nr_state, audio,
                                 use_kernels=spec.use_kernels)
        if spec.nr_mode == 2:
            return nr_mod.spectral_nr(self.spectral_nr_params, nr_state,
                                      audio, use_kernels=spec.use_kernels)
        if spec.nr_mode == 3:
            return nr_mod.xanr(self.xanr_params, nr_state, audio,
                               use_kernels=spec.use_kernels)
        return nr_state, audio

    def _front(self, params, state, iq):
        """RF-rate front end; returns (x at 24 kHz, outputs, front-end
        state updates)."""
        spec = self.spec
        outputs = {}

        if spec.clip_taps:
            # ADC clip statistics on the RAW samples, pre-gain
            # (Codec_gain, Process.cpp:979-1027)
            if spec.q15_input:
                i16, q16 = iq
                mag = torch.maximum(i16.to(torch.int32).abs(),
                                    q16.to(torch.int32).abs())
                outputs["adc_half_clip"] = (mag >= 16384).any(dim=-1)
                outputs["adc_quarter_clip"] = (mag >= 8192).any(dim=-1)
            else:
                mag = torch.maximum(iq.real.abs(), iq.imag.abs())
                outputs["adc_half_clip"] = (mag >= 0.5).any(dim=-1)
                outputs["adc_quarter_clip"] = (mag >= 0.25).any(dim=-1)

        if self.fused_fe is not None:
            st4 = (state.dc_bq, state.nco_phase, state.dec1, state.dec2)
            zoom_state = state.zoom
            if spec.spectrum_zoom == 0:
                (dc_bq, nco_phase, dec1, dec2), x, seg = \
                    self.fused_fe.block(params, st4, iq)
                with stage("rf_tap"):
                    zoom_state, outputs["rf_spectrum"] = \
                        spectrum_mod.zoom1_from_segment(zoom_state, seg)
            elif self.zoomfft is not None:
                (dc_bq, nco_phase, dec1, dec2), x, zdec, z_iir, z_dec = \
                    self.fused_fe.block(params, st4, iq,
                                        (zoom_state.iir, zoom_state.dec))
                with stage("rf_tap"):
                    zoom_state, outputs["rf_spectrum"] = \
                        self.zoomfft.spectrum_from_decimated(
                            zoom_state._replace(iir=z_iir, dec=z_dec), zdec)
            else:
                (dc_bq, nco_phase, dec1, dec2), x = self.fused_fe.block(
                    params, st4, iq)
            return x, outputs, dict(dc_bq=dc_bq, nco_phase=nco_phase,
                                    dec1=dec1, dec2=dec2, zoom=zoom_state)

        if spec.q15_input:
            i16, q16 = iq
            iq = torch.complex(i16.to(torch.float32),
                               q16.to(torch.float32)) * (1.0 / 32768.0)

        # --- front end: RF gain, DC block, IQ correction ----------------
        g = (10.0 ** (params.rf_gain_db / 20.0) * params.band_gain
             ).to(torch.float32)
        x = iq * g[..., None]
        dc_bq, xi = self.dc_op.apply(
            state.dc_bq, torch.stack([x.real, x.imag], dim=-2))
        x = iq_correction(xi[..., 0, :], xi[..., 1, :], params.iq_amp,
                          params.iq_phase)

        # --- RF spectrum tap: zoom x1 on the un-shifted data ------------
        zoom_state = state.zoom
        if spec.spectrum_zoom == 0:
            with stage("rf_tap"):
                zoom_state, outputs["rf_spectrum"] = \
                    spectrum_mod.zoom1_spectrum(zoom_state, x)

        # --- frequency translation, decimation x4 then x2 ---------------
        x = nco.fs4_shift(x)
        if self.zoomfft is not None:
            # zoom x2^z taps the Fs/4-shifted data (Process.cpp:212-215)
            with stage("rf_tap"):
                zoom_state, outputs["rf_spectrum"] = self.zoomfft.block(
                    zoom_state, x)
        nco_phase, x = nco.nco_mix(state.nco_phase, x, params.nco_freq,
                                   spec.sample_rate)
        dec1, x = fir.fir_decimate(state.dec1, x, self.tensors["h1"], C.DF1)
        dec2, x = fir.fir_decimate(state.dec2, x, self.tensors["h2"], C.DF2)
        return x, outputs, dict(dc_bq=dc_bq, nco_phase=nco_phase,
                                dec1=dec1, dec2=dec2, zoom=zoom_state)

    def _tail_pre_nr(self, params, state, x, outputs):
        """Band-pass, AGC and demod, with the audio-spectrum and S-meter
        taps.  Returns (state with those fields updated, audio,
        outputs)."""
        spec = self.spec
        upd = {}
        spectrum = None
        if spec.mode == "psk31":
            # the decimated I/Q is the product; audio is its real part
            audio = x.real
            outputs["iq_baseband"] = x
        else:
            if spec.mode == "nfm":
                with stage("demod"):
                    nfm_last, audio = nfm_mod.nfm_demod(state.nfm_last, x)
                    upd["nfm_last"] = nfm_last
                    # post-demod shaping: OS filter + AGC on the real
                    # audio (Process.cpp:765-816)
                    x = audio.to(torch.complex64)
            with stage("bandpass"):
                scale = 1.0 if spec.mode == "nfm" else self.vol_scale
                osf, y, spectrum = self._os_filter(state.osf, x, scale)
            with stage("agc"):
                agc_state, y = agc_mod.agc_apply(
                    self.agc_params, state.agc, y,
                    use_kernels=spec.use_kernels)
            upd.update(osf=osf, agc=agc_state)
            with stage("demod"):
                if spec.mode == "am":
                    upd["am_bq"], audio = am_mod.am_demod(state.am_bq, y,
                                                          self.am_op)
                elif spec.mode == "sam":
                    upd["sam"], audio, outputs["sam_carrier_hz"] = \
                        sam_mod.sam_demod(self.sam_params, state.sam, y,
                                          use_kernels=spec.use_kernels)
                else:  # SSB family and NFM
                    audio = ssb_mod.ssb_demod(y)

        if spectrum is not None and spec.spectrum_taps:
            outputs["audio_spectrum"] = spectrum
            with stage("smeter"):
                upd["smeter_avg"] = smeter_avg = (
                    0.5 * spectrum.amax(dim=-1) + 0.5 * state.smeter_avg)
            outputs["smeter_avg"] = smeter_avg

        if spec.eq_on:  # receive EQ (Process.cpp:828-831)
            with stage("eq"):
                upd["eq"], audio = self.eq.apply(
                    state.eq, audio, params.eq_gains,
                    use_kernels=spec.use_kernels)
        return state._replace(**upd), audio, outputs

    def _os_filter(self, osf, x, scale: float = 1.0):
        """The overlap-save band-pass of `scale * x` (x as it is where the
        scale is 1); returns (osf, y, audio spectrum or None)."""
        spec = self.spec
        t = self.tensors
        if spec.use_matmul_osfilter and spec.spectrum_taps \
                and spec.use_kernels:
            # B1 scales x in the launch
            from t41x_torch.kernels.os_spectrum import os_spectrum
            return os_spectrum(osf, x, t["os_F"], t["os_W2"],
                               t["os_mask_sq"], t["os_tab"], scale)
        if scale != 1.0:
            x = x * scale
        if not spec.use_matmul_osfilter:
            return osfilter.os_filter(osf, x, t["mask"], return_spectrum=True)
        if spec.spectrum_taps:
            return osfilter.os_filter_matmul_spectrum(
                osf, x, t["os_F"], t["os_W2"], t["os_mask_sq"])
        if spec.use_kernels:
            from t41x_torch.kernels.os_filter import os_filter_matmul_kernel
            return (*os_filter_matmul_kernel(osf, x, t["os_W"], t["os_Wp"]),
                    None)
        return (*osfilter.os_filter_matmul(osf, x, t["os_W"]), None)

    def _tail_post_nr(self, params, state, audio, outputs):
        """Automatic notch, noise blanker, CW detection and filter,
        interpolation back to 192 kHz and volume.  `state` carries current
        values for every field; only the post-NR fields are replaced."""
        spec = self.spec
        notch_state = state.notch
        if spec.notch_on:  # Process.cpp:862-866
            with stage("notch"):
                notch_state, audio = nr_mod.xanr(
                    self.notch_params, notch_state, audio,
                    use_kernels=spec.use_kernels)
        if spec.nb_on:  # Process.cpp:873-876
            with stage("nb"):
                audio = nb_mod.noise_blanker(audio,
                                             use_kernel=spec.use_kernels)
        cw_state, cw_lp_state = state.cw, state.cw_lp
        if self.cw is not None:  # Process.cpp:878-913
            with stage("cw"):
                cw_state, outputs["cw_keyed"], outputs["cw_combined"] = \
                    self.cw.block(cw_state, audio)
        if self.cw_lp_b is not None:
            with stage("cw"):
                cw_lp_state, audio = self.cw_lp_op.apply(cw_lp_state, audio)
        outputs["audio_24k"] = audio
        int1, int2 = state.int1, state.int2
        with stage("interp"):
            vol = volume_to_amplification(params.volume)
            if spec.interpolate_out and self.fused_interp is not None:
                int1, int2, outputs["audio"] = self.fused_interp.apply(
                    audio, int1, int2, C.DF * vol)
            elif spec.interpolate_out:
                t = self.tensors
                int1, a = fir.fir_interpolate(int1, audio, t["hi1"], C.DF2)
                int2, a = fir.fir_interpolate(int2, a, t["hi2"], C.DF1)
                outputs["audio"] = a * (C.DF * vol[..., None])
            else:
                outputs["audio"] = audio * vol[..., None]
        return state._replace(int1=int1, int2=int2, notch=notch_state,
                              cw=cw_state, cw_lp=cw_lp_state), outputs

    # ------------------------------------------------------------------
    def block_batch(self, params: ChannelParams, state: RxState, blocks):
        """Process (B, ..., BLOCK) blocks in one call, with the same result
        as B calls of `block` (`t41x.chain.rx.RxChain.block_batch`).
        Spectral NR (nr_mode 2) runs batched across the blocks: the pre-NR
        tail block by block, one `spectral_nr_batch`, then the post-NR
        tail block by block.  Every other spec loops `block`.  Returns
        (state, outputs stacked on a leading (B,) axis)."""
        if self.spec.nr_mode != 2:
            outs = []
            for blk in blocks:
                state, out = self.block(params, state, blk)
                outs.append(out)
        else:
            audios, pre_outs = [], []
            for blk in blocks:
                state, audio, out = self._block_pre_nr(params, state, blk)
                audios.append(audio)
                pre_outs.append(out)
            with stage("nr"):
                nr_state, audio = nr_mod.spectral_nr_batch(
                    self.spectral_nr_params, state.nr, torch.stack(audios),
                    use_kernels=self.spec.use_kernels)
            state = state._replace(nr=nr_state)
            outs = []
            for a, out in zip(audio, pre_outs):
                state, out = self._tail_post_nr(params, state, a, out)
                outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs])
                       for k in outs[0]}

    # ------------------------------------------------------------------
    def run(self, iq, params: ChannelParams | None = None):
        """Stream the chain over a whole capture.

        iq: (..., n_blocks*BLOCK) complex (NumPy or tensor); leading
        dims are channels.  Returns a dict of streamed outputs, time
        axis last.
        """
        iq = torch.as_tensor(iq, device=self.device)
        ch = tuple(iq.shape[:-1])
        n_blocks = iq.shape[-1] // C.BLOCK_SIZE
        blocks = iq[..., : n_blocks * C.BLOCK_SIZE].reshape(
            ch + (n_blocks, C.BLOCK_SIZE)).movedim(-2, 0)
        if params is None:
            params = default_params(ch, device=self.device)
        st = self.init_state(ch)
        outs = []
        for b in range(n_blocks):
            st, out = self.block(params, st, blocks[b].contiguous())
            outs.append(out)
        return join_blocks(outs, len(ch))


def join_blocks(outs: list, n_lead: int) -> dict:
    """Per-block output dicts -> streamed outputs, time axis last: a
    (...ch, N) output a block becomes a (...ch, n_blocks*N) sample
    stream, a (...ch) one a (...ch, n_blocks) per-block series; n_lead
    is the number of channel axes."""
    def join(vals):
        if vals[0].ndim == n_lead + 1:
            return torch.cat(vals, dim=-1)
        return torch.stack(vals, dim=-1)

    return {k: join([o[k] for o in outs]) for k in outs[0]}


def iq_correction(i_part: torch.Tensor, q_part: torch.Tensor,
                  amp: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Manual IQ amplitude + phase correction (Process.cpp:163-175,
    Utility.cpp:178-187): scale I, then mix factor*Q into I (positive
    factor) or factor*I into Q (negative factor).

    i_part/q_part: (..., N);  amp/phase: (...,).  Returns complex64.
    """
    amp = amp[..., None]
    ph = phase[..., None]
    i_c = i_part * amp
    pos = ph >= 0
    i_c = torch.where(pos, i_c + ph * q_part, i_c)
    q_c = torch.where(pos, q_part, q_part + ph * i_c)
    return torch.complex(i_c, q_c)


def volume_to_amplification(volume: torch.Tensor) -> torch.Tensor:
    """0..100 -> amplitude, x^5 taper (reference `VolumeToAmplification`,
    `Process.cpp:955-967`)."""
    x = volume / 100.0
    return 5.0 * x ** 5
