"""K3: fused x2 + x4 output interpolation — wrapper, plain version,
CUDA kernel.

Port of `t41x.kernels.interp_pallas.FusedInterp`: both zero-stuff
polyphase stages and the per-channel volume scale in one launch
(`t41x_torch/csrc/interp.cu`); the plain version is two
`t41x_torch.dsp.fir.fir_interpolate` calls and the scale.  Histories
stay interchangeable with the unfused path: int1 is the last sub1-1
input samples (formed here), int2 the stage-1 output tail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.dsp import fir
from t41x_torch.kernels import _build

_ARGS = [_build.PTR] * 6 + [_build.INT] * 6 + [_build.PTR] * 3


class FusedInterp:
    launches = 0  # CUDA kernel launches, counted in `apply`

    def __init__(self, h1: np.ndarray, h2: np.ndarray):
        self.h1 = np.asarray(h1, np.float32)     # x2 stage (C.DF2)
        self.h2 = np.asarray(h2, np.float32)     # x4 stage (C.DF1)
        self.sub1 = len(self.h1) // C.DF2
        self.sub2 = len(self.h2) // C.DF1
        # hp_rev[j, p] = h[(sub-1-j)*L + p]  (window oldest-first)
        self.hp1 = self.h1.reshape(self.sub1, C.DF2)[::-1].copy()
        self.hp2 = self.h2.reshape(self.sub2, C.DF1)[::-1].copy()
        self._consts = {}

    def _on(self, device):
        if device not in self._consts:
            self._consts[device] = {
                k: torch.from_numpy(v).to(device) for k, v in
                dict(h1=self.h1, h2=self.h2, hp1=self.hp1,
                     hp2=self.hp2).items()}
        return self._consts[device]

    def apply(self, audio: torch.Tensor, int1: torch.Tensor,
              int2: torch.Tensor, vol: torch.Tensor):
        """audio: (..., N) float32; int1/int2: fir_interpolate histories;
        vol: (...,) per-channel output scale (DF * volume taper).
        Returns (int1', int2', y (..., N*8) scaled).  CPU tensors take
        the plain version; CUDA tensors launch the kernel."""
        if not audio.is_cuda:
            return self.plain(audio, int1, int2, vol)
        return self._launch(audio, int1, int2, vol)

    def _launch(self, audio, int1, int2, vol):
        dev = audio.device
        lead, n = tuple(audio.shape[:-1]), audio.shape[-1]
        f32, cin = torch.float32, _build.cuda_input
        audio = cin("audio", audio, f32, lead + (n,), dev)
        int1 = cin("int1", int1, f32, lead + (self.sub1 - 1,), dev)
        int2 = cin("int2", int2, f32, lead + (self.sub2 - 1,), dev)
        vol = cin("vol", vol, f32, lead, dev)
        k = self._on(dev)
        y = torch.empty(lead + (n * C.DF,), dtype=f32, device=dev)
        nint2 = torch.empty(lead + (self.sub2 - 1,), dtype=f32, device=dev)
        _build.launch(
            "t41x_interp", _ARGS, audio.data_ptr(), int1.data_ptr(),
            int2.data_ptr(), vol.data_ptr(), k["hp1"].data_ptr(),
            k["hp2"].data_ptr(), math.prod(lead), n, self.sub1, C.DF2,
            self.sub2, C.DF1, y.data_ptr(), nint2.data_ptr(),
            _build.stream_of(audio))
        FusedInterp.launches += 1
        return audio[..., -(self.sub1 - 1):].contiguous(), nint2, y

    def plain(self, audio, int1, int2, vol):
        """The same function in plain torch ops (any device)."""
        k = self._on(audio.device)
        int1, a = fir.fir_interpolate(int1, audio, k["h1"], C.DF2)
        int2, a = fir.fir_interpolate(int2, a, k["h2"], C.DF1)
        return int1, int2, a * vol[..., None]
