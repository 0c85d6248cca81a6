"""Overlap-save fast-convolution band-pass filter (torch), port of
`t41x.dsp.osfilter`.

The core filter of the RX chain (reference `Process.cpp:498-595`):
512-point complex FFT of [previous half | new half], complex multiply
with a frequency-domain mask, inverse FFT, keep the second half.  State
is the previous half-block of samples.

* `os_filter` — on `torch.fft` (cuFFT on the card).
* `os_filter_matmul` — the whole FFT->mask->iFFT->keep-half pipeline as
  one dense complex operator, `out = xw @ W.T`.  The hand-written CUDA
  version is `t41x_torch.kernels.os_filter`.
* `os_filter_matmul_spectrum` — the same as two complex matmuls that
  also yield the audio-spectrum tap.

The operator constructors are a copy of `t41x`'s (float64 design, pinned
equal by `tests/test_torch_design.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch import constants as C


def os_state(channels: tuple[int, ...] = (), fft_length: int = C.FFT_LENGTH,
             device=None) -> torch.Tensor:
    """Zero history: the previous fft_length/2 complex samples."""
    return torch.zeros(channels + (fft_length // 2,), dtype=torch.complex64,
                       device=device)


def os_filter(state: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
              return_spectrum: bool = False):
    """One overlap-save block.

    state, x: (..., F/2) complex64; mask: (F,) complex64.
    Returns (new_state, y[, spec]) with spec the (..., F) |product|^2
    audio-spectrum tap (reference `Process.cpp:550-570`).
    """
    xw = torch.cat([state, x], dim=-1)
    Y = torch.fft.fft(xw, dim=-1) * mask
    y = torch.fft.ifft(Y, dim=-1)[..., xw.shape[-1] // 2:]
    if return_spectrum:
        return x, y, Y.real ** 2 + Y.imag ** 2
    return x, y


def os_matmul_operator(mask: np.ndarray) -> np.ndarray:
    """W such that out = xw @ W.T == ifft(fft(xw)*mask)[F/2:].
    W = (F^-1 diag(mask) F)[F/2:, :], (F/2, F) complex64, built in float64."""
    F = len(mask)
    dft = np.fft.fft(np.eye(F))
    idft = np.conj(dft).T / F
    W = (idft * mask[None, :]) @ dft
    return W[F // 2:, :].astype(np.complex64)


def os_filter_matmul(state: torch.Tensor, x: torch.Tensor, W: torch.Tensor):
    """Overlap-save block as one complex matmul: out = [state | x] @ W.T."""
    xw = torch.cat([state, x], dim=-1)
    return x, xw @ W.T


def os_spectrum_operators(mask: np.ndarray):
    """Split-form operators (F_op, W2, mask_sq):
      X    = xw @ F_op.T          — the full F-point DFT
      y    = X @ W2.T             — iFFT(mask * X)[F/2:]
      spec = |X|^2 * mask_sq      — the post-mask |Y|^2 spectrum tap
    """
    F = len(mask)
    dft = np.fft.fft(np.eye(F))
    idft = np.conj(dft).T / F
    W2 = idft[F // 2:, :] * mask[None, :]
    mask_sq = (np.abs(mask.astype(np.complex128)) ** 2).astype(np.float32)
    return dft.astype(np.complex64), W2.astype(np.complex64), mask_sq


def os_filter_matmul_spectrum(state: torch.Tensor, x: torch.Tensor,
                              F_op: torch.Tensor, W2: torch.Tensor,
                              mask_sq: torch.Tensor):
    """Overlap-save block + audio-spectrum tap as two complex matmuls.
    Returns (new_state, y, spec) like `os_filter(return_spectrum=True)`."""
    xw = torch.cat([state, x], dim=-1)
    X = xw @ F_op.T
    y = X @ W2.T
    spec = (X.real ** 2 + X.imag ** 2) * mask_sq
    return x, y, spec
