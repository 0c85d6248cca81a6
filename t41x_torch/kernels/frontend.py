"""K1: the fused RF front end — wrapper, plain version, CUDA kernel.

Port of `t41x.kernels.frontend_pallas.FusedFrontEnd`, complex64 and
q15 input: RF gain, DC-block biquad (chunk operator), IQ correction,
exact Fs/4 shift, NCO mix, x4 then x2 decimation; for zoom 0 the first
512 IQ-corrected samples for the zoom-x1 display; for zoom 1..7 (K1z)
the zoom 2^z panadapter tap (anti-alias IIR, 4-tap FIR, decimate by
2^z) as one composed chunk operator, with its state converted to and
from `ZoomState`'s per-stage layout as the TPU wrapper does.  The CUDA
kernel is `t41x_torch/csrc/frontend.cu`; the plain version is the
unfused torch stages of `t41x_torch.dsp` composed the same way (for the
zoom tap, `ZoomFFT`'s per-stage prefilter).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain.rx import iq_correction
from t41x_torch.dsp import fir, iir, nco
from t41x_torch.dsp.chunk_ops import zoom_chunk_ops
from t41x_torch.dsp.spectrum import zoom_prefilter
from t41x_torch.kernels import _build

_K = 128     # DC-biquad chunk length
_ZRES = 512  # zoom-1 display segment length (SPECTRUM_RES)
_N = C.BLOCK_SIZE         # the kernel's block length
_TAPS = (28, 46)          # the kernel's x4 and x2 decimator tap counts
_ARGS = [_build.PTR] * 8 + [_build.INT] * 6 + [_build.FLOAT] \
    + [_build.PTR] * 6 + [_build.INT] + [_build.PTR] * 4 \
    + [_build.INT] * 2 + [_build.PTR] * 3


def dc_taps(op: iir.BiquadChunked) -> np.ndarray:
    """The 127 taps h of the DC biquad's in-chunk operator, which is
    Toeplitz: L[n, j] = h[n-1-j] for j < n (`iir.BiquadChunked`)."""
    return np.ascontiguousarray(op.L[0][1:, 0])


def zoom_taps(Wy: np.ndarray, K: int = _K):
    """(hz, Rz) of the zoom tap's output operator Wy (K+S, K/zf): its x
    part is Toeplitz, Wy[i, r] = hz[(r+1) zf - 1 - i] for i <= (r+1) zf
    - 1 (else 0), read off the last column; Rz = Wy[K:].T (K/zf, S)."""
    return (np.ascontiguousarray(Wy[K - 1::-1, -1]),
            np.ascontiguousarray(Wy[K:].T))


class FusedFrontEnd:
    """Designed front end for one chain.

    zoom: None (no display tap), 0 (zoom-x1 segment tap), or 1..7
    (zoom 2^z tap; pass zoom_sos — the (S,3), (S,3) anti-alias biquad
    cascade — and zoom_h, the short FIR decimator taps, both from
    `t41x_torch.dsp.spectrum.ZoomFFT`)."""

    launches = 0  # CUDA kernel launches, counted in `block`

    def __init__(self, h1: np.ndarray, h2: np.ndarray, dc_b: np.ndarray,
                 dc_a: np.ndarray, sample_rate: float = C.SAMPLE_RATE,
                 nco_gain: float = nco.FREQ_ADJ_FACTOR,
                 zoom: int | None = None, zoom_sos=None,
                 zoom_h: np.ndarray | None = None):
        self.h1 = np.asarray(h1, np.float32)
        self.h2 = np.asarray(h2, np.float32)
        self.t1, self.t2 = len(self.h1), len(self.h2)
        self.fs = float(sample_rate)
        self.nco_gain = float(nco_gain)
        self.zoom = zoom
        self.dc_op = iir.BiquadChunked(dc_b, dc_a, chunk=_K)
        self._consts = {}
        op = self.dc_op
        # the kernel's constant block (its FeConst, field by field): the
        # DC taps with a leading 0, R, G, AK, b0, the reversed decimator
        # taps; passed by value at every launch
        self.kernel_consts = np.concatenate([
            [0.0], dc_taps(op), op.R[0].ravel(), op.G[0].ravel(),
            op.AK[0].ravel(), op.b0[:1], self.h1[::-1], self.h2[::-1]
        ]).astype(np.float32)
        self.zoomed = zoom is not None and zoom >= 1  # the 2^z tap (K1z)
        if self.zoomed:
            zb, za = zoom_sos
            self.z_stages = np.atleast_2d(zb).shape[0]
            self.zoom_h = np.asarray(zoom_h, np.float32)
            self.zt = len(self.zoom_h)
            self.zfactor = 1 << zoom
            assert _K % self.zfactor == 0, zoom
            Wy, Ws, S = zoom_chunk_ops(zb, za, self.zoom_h, self.zfactor, _K)
            self.z_states = S                       # 2*stages + taps - 1
            self.Wy = Wy.astype(np.float32)         # (K+S, K/m)
            self.Ws = Ws.astype(np.float32)         # (K+S, S)
            # the plain version's per-stage cascade (ZoomFFT.prefilter)
            self.zoom_op = iir.BiquadChunked(zb, za, chunk=_K)

    def _on(self, device):
        """Operators and taps as tensors on `device` (made once)."""
        if device not in self._consts:
            arrays = dict(h1=self.h1, h2=self.h2)
            if self.zoomed:
                hz, Rz = zoom_taps(self.Wy)
                arrays.update(hz=hz, Rz=Rz, Ws=self.Ws, zh=self.zoom_h)
            self._consts[device] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}
        return self._consts[device]

    def init_state(self, channels: tuple[int, ...], device=None):
        """(dc_bq, nco_phase, dec1, dec2), the unfused chain's layout."""
        return (torch.zeros(channels + (2, 1, 2), device=device),
                torch.zeros(channels, device=device),
                fir.fir_state(self.t1, channels, torch.complex64, device),
                fir.fir_state(self.t2, channels, torch.complex64, device))

    def _gain(self, params, q15: bool) -> torch.Tensor:
        g = (10.0 ** (params.rf_gain_db / 20.0) * params.band_gain
             ).to(torch.float32)
        return g * (1.0 / 32768.0) if q15 else g

    def block(self, params, state, iq, zoom_state=None):
        """params: ChannelParams (nco_freq, rf_gain_db, band_gain, iq_amp,
        iq_phase as (...,) tensors); state: the 4-tuple of `init_state`;
        iq: (..., N) complex64, or an (i, q) pair of int16 q15 tensors.

        Returns (new_state, x) with x (..., N/8) complex64 at 24 kHz; with
        zoom 0 (new_state, x, seg), seg the (..., 512) IQ-corrected
        display segment; with zoom >= 1, pass zoom_state = (iir
        (..., 2, stages, 2) float32, dec (..., taps-1) complex64) and get
        (new_state, x, zdec, new_iir, new_dec), zdec the (..., N/2^zoom)
        decimated zoom stream.  CPU tensors take the plain version; CUDA
        tensors launch the kernel."""
        ref = iq[0] if isinstance(iq, (tuple, list)) else iq
        if ref.is_cuda:
            return self._launch(params, state, iq, zoom_state)
        return self.plain(params, state, iq, zoom_state)

    def plain(self, params, state, iq, zoom_state=None):
        """The same function in plain torch ops (any device)."""
        dc_bq, nco_phase, dec1, dec2 = state
        q15 = isinstance(iq, (tuple, list))
        g = self._gain(params, q15)[..., None]
        if q15:
            xr, xi = iq[0].to(torch.float32), iq[1].to(torch.float32)
        else:
            xr, xi = iq.real, iq.imag
        dc_bq, xs = self.dc_op.apply(dc_bq, torch.stack([xr * g, xi * g],
                                                        dim=-2))
        x = iq_correction(xs[..., 0, :], xs[..., 1, :], params.iq_amp,
                          params.iq_phase)
        seg = x[..., :_ZRES]
        x = nco.fs4_shift(x)
        k = self._on(x.device)
        if self.zoomed:
            z_iir, z_dec, zdec = zoom_prefilter(
                self.zoom_op, k["zh"], self.zfactor, *zoom_state, x)
        nco_phase, x = nco.nco_mix(nco_phase, x, params.nco_freq, self.fs,
                                   self.nco_gain)
        dec1, x = fir.fir_decimate(dec1, x, k["h1"], C.DF1)
        dec2, x = fir.fir_decimate(dec2, x, k["h2"], C.DF2)
        new_state = (dc_bq, nco_phase, dec1, dec2)
        if self.zoom == 0:
            return new_state, x, seg
        if self.zoomed:
            return new_state, x, zdec, z_iir, z_dec
        return new_state, x

    def _launch(self, params, state, iq, zoom_state=None):
        dc_bq, nco_phase, dec1, dec2 = state
        q15 = isinstance(iq, (tuple, list))
        ref = iq[0] if q15 else iq
        dev = ref.device
        lead, n = tuple(ref.shape[:-1]), ref.shape[-1]
        c = math.prod(lead)
        if n != _N or (self.t1, self.t2) != _TAPS:
            raise ValueError(
                f"FusedFrontEnd: the kernel takes blocks of {_N} samples and "
                f"{_TAPS} decimator taps, got {n} and {(self.t1, self.t2)}")
        f32, c64 = torch.float32, torch.complex64
        cin = _build.cuda_input
        if q15:
            # read as pairs of int16: 4-byte aligned
            xi_, xq_ = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (
                cin("iq[0]", iq[0], torch.int16, lead + (n,), dev),
                cin("iq[1]", iq[1], torch.int16, lead + (n,), dev)))
            x_ = None
        else:
            x_ = cin("iq", iq, c64, lead + (n,), dev)
            if x_.data_ptr() % 16:  # read as float4
                x_ = x_.clone()
            xi_ = xq_ = None
        g = self._gain(params, q15)
        w = 2.0 * math.pi * params.nco_freq.to(f32) / self.fs
        pp = torch.stack([g, params.iq_amp, params.iq_phase, w, nco_phase],
                         dim=-1)
        pp = cin("params", pp, f32, lead + (5,), dev)
        dcs = cin("dc_bq", dc_bq, f32, lead + (2, 1, 2), dev)
        h1s = cin("dec1", dec1, c64, lead + (self.t1 - 1,), dev)
        h2s = cin("dec2", dec2, c64, lead + (self.t2 - 1,), dev)
        k = self._on(dev)

        n2 = n // C.DF
        y = torch.empty(lead + (n2,), dtype=c64, device=dev)
        ndcs = torch.empty(lead + (2, 1, 2), dtype=f32, device=dev)
        nph = torch.empty(lead, dtype=f32, device=dev)
        nd1 = torch.empty(lead + (self.t1 - 1,), dtype=c64, device=dev)
        nd2 = torch.empty(lead + (self.t2 - 1,), dtype=c64, device=dev)
        seg = (torch.empty(lead + (_ZRES,), dtype=c64, device=dev)
               if self.zoom == 0 else None)
        S = self.z_states if self.zoomed else 0
        zs = zdec = nzs = None
        if self.zoomed:
            zs = self._zoom_state_in(zoom_state, lead, dev)
            zdec = torch.empty(lead + (n // self.zfactor,), dtype=c64,
                               device=dev)
            nzs = torch.empty(lead + (2 * S,), dtype=f32, device=dev)
        # tensors pass as their pointers, None as a null pointer
        _build.launch(
            "t41x_frontend", _ARGS, dev, self.kernel_consts.ctypes.data, x_,
            xi_, xq_, pp, dcs, h1s, h2s, c, n, self.t1, self.t2, C.DF1,
            C.DF2, self.nco_gain, y, ndcs, nph, nd1, nd2, seg, _ZRES,
            k.get("hz"), k.get("Rz"), k.get("Ws"), zs, S,
            self.zfactor if self.zoomed else 0, zdec, nzs)
        FusedFrontEnd.launches += 1
        new_state = (ndcs, nph, nd1, nd2)
        if self.zoom == 0:
            return new_state, y, seg
        if self.zoomed:
            return (new_state, y, zdec) + self._zoom_state_out(nzs, lead)
        return new_state, y

    def _zoom_state_in(self, zoom_state, lead, dev):
        """ZoomState's (iir, dec) -> the kernel's composed state (..., 2S):
        per stream the per-stage normal-form states, then the decimator
        history reversed (newest first); streams [I | Q]."""
        z_iir, z_dec = zoom_state
        st, zt = self.z_stages, self.zt
        cin = _build.cuda_input
        z_iir = cin("zoom iir", z_iir, torch.float32, lead + (2, st, 2), dev)
        z_dec = cin("zoom dec", z_dec, torch.complex64, lead + (zt - 1,), dev)
        return torch.cat([z_iir[..., 0, :, :].flatten(-2),
                          z_dec.real.flip(-1),
                          z_iir[..., 1, :, :].flatten(-2),
                          z_dec.imag.flip(-1)], dim=-1).contiguous()

    def _zoom_state_out(self, nzs, lead):
        """The kernel's composed state -> ZoomState's (iir, dec)."""
        S, S2 = self.z_states, 2 * self.z_stages
        sI, sQ = nzs[..., :S], nzs[..., S:]
        new_iir = torch.stack([sI[..., :S2], sQ[..., :S2]], dim=-2).reshape(
            lead + (2, self.z_stages, 2))
        new_dec = torch.complex(sI[..., S2:].flip(-1), sQ[..., S2:].flip(-1))
        return new_iir, new_dec
