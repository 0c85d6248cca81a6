"""K1: the fused RF front end — wrapper, plain version, CUDA kernel.

Port of `t41x.kernels.frontend_pallas.FusedFrontEnd` for zoom None and
0, complex64 and q15 input: RF gain, DC-block biquad (chunk operator),
IQ correction, exact Fs/4 shift, NCO mix, x4 then x2 decimation, and
for zoom 0 the first 512 IQ-corrected samples for the zoom-x1 display.
The CUDA kernel is `t41x_torch/csrc/frontend.cu`; the plain version is
the unfused torch stages of `t41x_torch.dsp` composed the same way.
The zoom 2^z variant (zoom >= 1) is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain.rx import iq_correction
from t41x_torch.dsp import fir, iir, nco
from t41x_torch.kernels import _build

_K = 128     # DC-biquad chunk length
_ZRES = 512  # zoom-1 display segment length (SPECTRUM_RES)
_ARGS = [_build.PTR] * 11 + [_build.FLOAT] + [_build.PTR] * 2 \
    + [_build.INT] * 6 + [_build.FLOAT] + [_build.PTR] * 6 + [_build.INT] \
    + [_build.PTR]


class FusedFrontEnd:
    """Designed front end for one chain.

    zoom: None (no display tap) or 0 (zoom-x1 segment tap)."""

    launches = 0  # CUDA kernel launches, counted in `block`

    def __init__(self, h1: np.ndarray, h2: np.ndarray, dc_b: np.ndarray,
                 dc_a: np.ndarray, sample_rate: float = C.SAMPLE_RATE,
                 nco_gain: float = nco.FREQ_ADJ_FACTOR,
                 zoom: int | None = None):
        if zoom not in (None, 0):
            raise NotImplementedError(
                "the fused front end's zoom 2^z tap (zoom >= 1) is not "
                "ported yet (ROADMAP.md Queue 1 item 12)")
        self.h1 = np.asarray(h1, np.float32)
        self.h2 = np.asarray(h2, np.float32)
        self.t1, self.t2 = len(self.h1), len(self.h2)
        self.fs = float(sample_rate)
        self.nco_gain = float(nco_gain)
        self.zoom = zoom
        self.dc_op = iir.BiquadChunked(dc_b, dc_a, chunk=_K)
        self._consts = {}

    def _on(self, device):
        """Operators and taps as tensors on `device` (made once)."""
        if device not in self._consts:
            op = self.dc_op
            arrays = dict(Lt=op.L[0].T, R=op.R[0], G=op.G[0], AK=op.AK[0],
                          h1=self.h1, h2=self.h2, h1r=self.h1[::-1],
                          h2r=self.h2[::-1])
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

    def block(self, params, state, iq):
        """params: ChannelParams (nco_freq, rf_gain_db, band_gain, iq_amp,
        iq_phase as (...,) tensors); state: the 4-tuple of `init_state`;
        iq: (..., N) complex64, or an (i, q) pair of int16 q15 tensors.

        Returns (new_state, x) with x (..., N/8) complex64 at 24 kHz, or
        with zoom 0 (new_state, x, seg), seg the (..., 512) IQ-corrected
        display segment.  CPU tensors take the plain version; CUDA
        tensors launch the kernel."""
        ref = iq[0] if isinstance(iq, (tuple, list)) else iq
        if ref.is_cuda:
            return self._launch(params, state, iq)
        return self.plain(params, state, iq)

    def plain(self, params, state, iq):
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
        nco_phase, x = nco.nco_mix(nco_phase, x, params.nco_freq, self.fs,
                                   self.nco_gain)
        k = self._on(x.device)
        dec1, x = fir.fir_decimate(dec1, x, k["h1"], C.DF1)
        dec2, x = fir.fir_decimate(dec2, x, k["h2"], C.DF2)
        new_state = (dc_bq, nco_phase, dec1, dec2)
        return (new_state, x, seg) if self.zoom == 0 else (new_state, x)

    def _launch(self, params, state, iq):
        dc_bq, nco_phase, dec1, dec2 = state
        q15 = isinstance(iq, (tuple, list))
        ref = iq[0] if q15 else iq
        dev = ref.device
        lead, n = tuple(ref.shape[:-1]), ref.shape[-1]
        c = math.prod(lead)
        if n % _K or n % C.DF or n < _ZRES:
            raise ValueError(f"FusedFrontEnd: block length {n} must be a "
                             f"multiple of {_K} and at least {_ZRES}")
        f32, c64 = torch.float32, torch.complex64
        cin = _build.cuda_input
        if q15:
            xi_ = cin("iq[0]", iq[0], torch.int16, lead + (n,), dev)
            xq_ = cin("iq[1]", iq[1], torch.int16, lead + (n,), dev)
            x_ = None
        else:
            x_ = cin("iq", iq, c64, lead + (n,), dev)
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
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.launch(
            "t41x_frontend", _ARGS, p(x_), p(xi_), p(xq_), p(pp), p(dcs),
            p(h1s), p(h2s), p(k["Lt"]), p(k["R"]), p(k["G"]), p(k["AK"]),
            float(self.dc_op.b0[0]), p(k["h1r"]), p(k["h2r"]), c, n,
            self.t1, self.t2, C.DF1, C.DF2, self.nco_gain, p(y), p(ndcs),
            p(nph), p(nd1), p(nd2), p(seg), _ZRES, _build.stream_of(ref))
        FusedFrontEnd.launches += 1
        new_state = (ndcs, nph, nd1, nd2)
        return (new_state, y, seg) if self.zoom == 0 else (new_state, y)
