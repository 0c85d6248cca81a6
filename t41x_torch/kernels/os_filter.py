"""K4: the overlap-save band-pass matmul — wrapper, plain version, CUDA
kernel.

Port of `t41x.kernels.os_filter_pallas.os_filter_matmul_pallas`:
y = [history | x] @ W.T as a hand-written fp32 complex GEMM
(`t41x_torch/csrc/os_filter.cu`), the new history being x.  The plain
version is `t41x_torch.dsp.osfilter.os_filter_matmul`.  The chain uses
it when `spectrum_taps=False`.  The kernel reads W as k-major real and
imaginary planes (`pack_w`), which the owner of W packs once (the chain
does so when it is built) and passes beside W.
"""

from __future__ import annotations

import math

import torch

from t41x_torch.dsp.osfilter import os_filter_matmul
from t41x_torch.kernels import _build

_ARGS = [_build.PTR] * 3 + [_build.INT] * 2 + [_build.PTR] * 2


def pack_w(W: torch.Tensor) -> torch.Tensor:
    """W (N, K) complex64 -> (2, K, N) float32: the real and imaginary
    planes of W.T, each k-major (a row of N columns is contiguous)."""
    Wt = W.transpose(0, 1)
    return torch.stack([Wt.real, Wt.imag]).contiguous()


def os_filter_matmul_kernel(state: torch.Tensor, x: torch.Tensor,
                            W: torch.Tensor, Wp: torch.Tensor | None = None):
    """state, x: (..., F/2) complex64; W: (F/2, F) complex64 from
    `os_matmul_operator`; Wp: `pack_w(W)`, packed here when None.
    Returns (new_state, y).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not x.is_cuda:
        return os_filter_matmul(state, x, W)
    return _launch(state, x, W, Wp)


def _aligned(name, t, dtype, shape, dev):
    # cp.async copies 16-byte pieces: a view off a 16-byte boundary is
    # copied to a fresh tensor
    t = _build.cuda_input(name, t, dtype, shape, dev)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(state: torch.Tensor, x: torch.Tensor, W: torch.Tensor,
            Wp: torch.Tensor | None):
    dev = x.device
    lead, half = tuple(x.shape[:-1]), x.shape[-1]
    c64 = torch.complex64
    x = _aligned("x", x, c64, lead + (half,), dev)
    state = _aligned("state", state, c64, lead + (half,), dev)
    W = _build.cuda_input("W", W, c64, (half, 2 * half), dev)
    if half % 64:
        raise ValueError(f"os_filter: F/2 = {half} must be a multiple "
                         "of 64")
    Wp = _aligned("Wp", pack_w(W) if Wp is None else Wp, torch.float32,
                  (2, 2 * half, half), dev)
    y = torch.empty_like(x)
    _build.launch("t41x_os_filter", _ARGS, dev, state, x, Wp,
                  math.prod(lead), half, y)
    os_filter_matmul_kernel.launches += 1
    return x, y


os_filter_matmul_kernel.launches = 0  # CUDA kernel launches
