"""K4: the overlap-save band-pass matmul — wrapper, plain version, CUDA
kernel.

Port of `t41x.kernels.os_filter_pallas.os_filter_matmul_pallas`:
y = [history | x] @ W.T as a hand-written fp32 complex GEMM
(`t41x_torch/csrc/os_filter.cu`), the new history being x.  The plain
version is `t41x_torch.dsp.osfilter.os_filter_matmul`.  The chain uses
it when `spectrum_taps=False`.
"""

from __future__ import annotations

import math

import torch

from t41x_torch.dsp.osfilter import os_filter_matmul
from t41x_torch.kernels import _build

_ARGS = [_build.PTR] * 3 + [_build.INT] * 2 + [_build.PTR] * 2


def os_filter_matmul_kernel(state: torch.Tensor, x: torch.Tensor,
                            W: torch.Tensor):
    """state, x: (..., F/2) complex64; W: (F/2, F) complex64 from
    `os_matmul_operator`.  Returns (new_state, y).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return os_filter_matmul(state, x, W)
    return _launch(state, x, W)


def _launch(state: torch.Tensor, x: torch.Tensor, W: torch.Tensor):
    dev = x.device
    lead, half = tuple(x.shape[:-1]), x.shape[-1]
    c64, cin = torch.complex64, _build.cuda_input
    x = cin("x", x, c64, lead + (half,), dev)
    state = cin("state", state, c64, lead + (half,), dev)
    W = cin("W", W, c64, (half, 2 * half), dev)
    y = torch.empty_like(x)
    _build.launch("t41x_os_filter", _ARGS, state.data_ptr(), x.data_ptr(),
                  W.data_ptr(), math.prod(lead), half, y.data_ptr(),
                  _build.stream_of(x))
    os_filter_matmul_kernel.launches += 1
    return x, y


os_filter_matmul_kernel.launches = 0  # CUDA kernel launches
