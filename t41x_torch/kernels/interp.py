"""K3: fused x2 + x4 output interpolation — wrapper, plain version,
CUDA kernel.

Port of `t41x.kernels.interp_pallas.FusedInterp`: both zero-stuff
polyphase stages and the per-channel volume scale in one launch
(`t41x_torch/csrc/interp.cu`), which also writes both histories; the
plain version is two `t41x_torch.dsp.fir.fir_interpolate` calls and the
scale.  Histories stay interchangeable with the unfused path: int1 is
the last sub1-1 input samples, int2 the stage-1 output tail.

The kernel reads the audio at any element stride of 1 or 2 (a real row,
or the real part of a complex64 row, as the chain's `y.real`), so the
wrapper copies nothing on the chain's path.  It takes the chain's shapes
only: 48 x2 taps and 32 x4 taps.  `interp_phases` launches it with
`clock64` stamps per phase, for measurement
(`t41x_torch.kernels._build.phase_split`).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.dsp import fir
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_FLOATS = ctypes.POINTER(ctypes.c_float)
_ARGS = ([_P, ctypes.c_longlong, _I] + [_P] * 3 + [_FLOATS] * 2 + [_I] * 4
         + [_P] * 4)
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]  # a stamps buffer before the stream
_SUB1, _SUB2 = 24, 8  # taps a phase the kernel is built for (interp.cu)
# what each row of stamps holds: clock64 cycles per phase, then the
# block's total cycles and nanoseconds (interp.cu; a block per channel)
K3_PHASES = ("staging", "stage 1", "stage 2 and store")


class FusedInterp:
    launches = 0  # CUDA kernel launches, counted in `_launch`

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
                dict(h1=self.h1, h2=self.h2).items()}
        return self._consts[device]

    def apply(self, audio: torch.Tensor, int1: torch.Tensor,
              int2: torch.Tensor, vol: torch.Tensor):
        """audio: (..., N) float32, N >= 1, any element stride;
        int1/int2: fir_interpolate histories; vol: (...,) per-channel
        output scale (DF * volume taper).  Returns (int1', int2', y (...,
        N*8) scaled).  CPU tensors take the plain version; CUDA tensors
        launch the kernel."""
        if not audio.is_cuda:
            return self.plain(audio, int1, int2, vol)
        return self._launch(audio, int1, int2, vol)

    def _launch(self, audio, int1, int2, vol, stamps=None):
        if (self.sub1, self.sub2) != (_SUB1, _SUB2):
            raise ValueError(
                f"FusedInterp: the kernel takes {_SUB1 * C.DF2} x2 taps and "
                f"{_SUB2 * C.DF1} x4 taps, got {len(self.h1)} and "
                f"{len(self.h2)}")
        dev, f32 = audio.device, torch.float32
        lead, n = tuple(audio.shape[:-1]), audio.shape[-1]
        if audio.dtype != f32 or n < 1:
            raise ValueError(f"audio: expected float32 (..., N >= 1), got "
                             f"{audio.dtype} {tuple(audio.shape)}")
        rows = audio.reshape(-1, n)  # a view wherever the layout allows
        if rows.stride(-1) not in (1, 2):
            rows = rows.contiguous()
        cin = _build.cuda_input
        int1 = cin("int1", int1, f32, lead + (_SUB1 - 1,), dev)
        int2 = cin("int2", int2, f32, lead + (_SUB2 - 1,), dev)
        vol = cin("vol", vol, f32, lead, dev)
        y = torch.empty(lead + (n * C.DF,), dtype=f32, device=dev)
        nint1 = torch.empty(lead + (_SUB1 - 1,), dtype=f32, device=dev)
        nint2 = torch.empty(lead + (_SUB2 - 1,), dtype=f32, device=dev)
        name, args, extra = (("t41x_interp", _ARGS, ()) if stamps is None
                             else ("t41x_interp_phases", _PHASE_ARGS,
                                   (stamps,)))
        _build.launch(
            name, args, dev, rows, rows.stride(0), rows.stride(1), int1,
            int2, vol, self.hp1.ctypes.data_as(_FLOATS),
            self.hp2.ctypes.data_as(_FLOATS), self.sub1, self.sub2,
            math.prod(lead), n, y, nint1, nint2, *extra)
        FusedInterp.launches += 1
        return nint1, nint2, y

    def plain(self, audio, int1, int2, vol):
        """The same function in plain torch ops (any device)."""
        k = self._on(audio.device)
        int1, a = fir.fir_interpolate(int1, audio, k["h1"], C.DF2)
        int2, a = fir.fir_interpolate(int2, a, k["h2"], C.DF1)
        return int1, int2, a * vol[..., None]


def interp_phases(fi: FusedInterp, audio, int1, int2, vol):
    """K3 on CUDA tensors with its phase split: (int1', int2', y,
    stamps), stamps (channels, 5) as `phase_split` reads them with
    `K3_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(audio.shape[:-1]), 1,
                                 len(K3_PHASES) + 2, audio.device)
    return (*fi._launch(audio, int1, int2, vol, stamps), stamps)
