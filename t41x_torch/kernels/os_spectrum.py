"""B1: the overlap-save band-pass with the audio-spectrum tap — wrapper,
plain version, and the CUDA kernel's tables and exchange layout.

One launch of `t41x_torch/csrc/os_spectrum.cu` computes, for every
channel, from its history h and new samples x (both F/2 complex64):

    xs   = scale * x                         (the new history)
    X    = FFT_F([h | xs])
    spec = |X|^2 * |mask|^2                  (the audio-spectrum tap)
    y    = IFFT_F(X * mask)[F/2:]

the outputs of `t41x_torch.dsp.osfilter.os_filter_matmul_spectrum` on
`[h | scale * x]`, with the same shapes, layouts and meaning.  That
plain version (two dense complex GEMMs, the form `t41x` took because the
TPU has no FFT) is what CPU tensors get; CUDA tensors launch the kernel
or raise.  The chain folds its SSB level scale (`vol_scale`) into the
launch; `nfm` passes 1.0.

The kernel is built for F = 512 only (`constants.FFT_LENGTH`, fixed by
`BLOCK_SIZE` = 2048): 512 = 8 x 8 x 8, 64 threads a channel, each
holding 8 complex points in registers; three radix-8 passes a
transform, with a twiddle multiply between passes and an exchange
through shared memory before each of the second and third.  `tables`
builds its constants (twiddles and the mask, designed in float64, then
rounded to float32); `EXCHANGES` gives each exchange's shared-memory
addresses, thread by thread, as the kernel computes them.  The CPU
tests (`tests/test_torch_os_spectrum.py`) run the kernel's pass schedule
on NumPy arrays from those two alone and hold it against `np.fft`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from t41x_torch.dsp.osfilter import os_filter_matmul_spectrum
from t41x_torch.kernels import _build

F = 512              # transform length the kernel is built for
HALF = F // 2
TPC = 64             # threads a channel
R = 8                # points a thread, and the radix of every pass

_P = _build.PTR
# the C entry point's parameters, the stream last
_ARGS = [_P] * 3 + [_build.FLOAT, _build.INT] + [_P] * 4

# the tables' layout in float2 slots (os_spectrum.cu reads the same)
T1_AT, T2_AT, MASK_AT, MSQ_AT = 0, R * TPC, R * TPC + R * R, \
    R * TPC + R * R + F
TABLE_FLOATS = 2 * MSQ_AT + F


def _exchanges():
    u = np.arange(TPC)[:, None]       # the thread in its channel
    i = np.arange(R)[None, :]         # the register
    lo, hi = u % R, u // R
    # (buffer, padded size in float2, write[u, i], read[u, i])
    return (
        # 1: thread t = u holds A[t][k1 = i] | reads t1 = lo, t2 = i at
        #    k1 = hi
        ("a", 8 * 72, i * 72 + u, hi * 72 + lo + 8 * i),
        # 2: thread (k1 = hi, t1 = lo) holds m1 = i | reads t1 = i at
        #    (k1 = lo, m1 = hi)
        ("b", 8 * 88, i * 88 + lo * 10 + hi, hi * 88 + i * 10 + lo),
        # 3: thread k' = u holds p1 = i | reads m1 = i at (k1 = lo,
        #    p1 = hi)
        ("a", 8 * 72, i * 72 + u, hi * 72 + i * 8 + lo),
        # 4: thread (k1 = lo, p1 = hi) holds q1 = i | reads k1 = i at
        #    (p1 = lo, q1 = hi)
        ("b", 8 * 88, lo * 66 + hi + 8 * i, i * 66 + u),
    )


# The four exchanges through a channel's shared memory: (buffer, its
# size in float2, write, read), where thread u of the channel stores its
# register i at write[u, i] and, after the channel's barrier, loads its
# register i from read[u, i].  Exchanges 1 and 3 use buffer "a", 2 and 4
# buffer "b", so one barrier an exchange is enough.  The strides (72,
# 88 with 10, 66) keep every half-warp's 8-byte accesses on distinct
# banks.
EXCHANGES = _exchanges()


def tables(mask: np.ndarray) -> np.ndarray:
    """The kernel's constants for the band-pass `mask` (F,), designed in
    float64 and rounded to float32 once: a (TABLE_FLOATS,) float32 array
    of float2 slots.  T1[k][t] = W512^(k t) (8 x 64) twiddles the first
    pass of each transform (conjugated in the inverse), T2[m][t] =
    W64^(m t) (8 x 8) the second; then mask / F (the inverse's 1/F folded
    in: a power of two, exact), then |mask|^2 as plain floats.
    W_N = exp(-2 pi i / N)."""
    mask = np.asarray(mask, np.complex128)
    if mask.shape != (F,):
        raise ValueError(f"os_spectrum: the kernel takes a mask of {F} "
                         f"points, got {mask.shape}")
    d = design(mask)
    c = np.concatenate([d["t1"].ravel(), d["t2"].ravel(), d["mask"]])
    out = np.empty(TABLE_FLOATS, np.float32)
    out[:2 * MSQ_AT:2] = c.real
    out[1:2 * MSQ_AT:2] = c.imag
    out[2 * MSQ_AT:] = d["mask_sq"]
    return out


def design(mask: np.ndarray) -> dict:
    """The tables in float64, before rounding: t1 (8, 64), t2 (8, 8),
    mask / F (F,) complex128; mask_sq (F,) float64."""
    mask = np.asarray(mask, np.complex128)
    k, t = np.arange(R)[:, None], np.arange(TPC)[None, :]
    return dict(t1=np.exp(-2j * np.pi * k * t / F),
                t2=np.exp(-2j * np.pi * k * t[:, :R] / (F // R)),
                mask=mask / F, mask_sq=np.abs(mask) ** 2)


def os_spectrum_plain(state: torch.Tensor, x: torch.Tensor,
                      F_op: torch.Tensor, W2: torch.Tensor,
                      mask_sq: torch.Tensor, scale: float = 1.0):
    """The plain version: `os_filter_matmul_spectrum` on `scale * x` (x
    as it is where the scale is 1)."""
    if scale != 1.0:
        x = x * scale
    return os_filter_matmul_spectrum(state, x, F_op, W2, mask_sq)


def os_spectrum(state: torch.Tensor, x: torch.Tensor, F_op: torch.Tensor,
                W2: torch.Tensor, mask_sq: torch.Tensor,
                tab: torch.Tensor | None, scale: float = 1.0):
    """state, x: (..., F/2) complex64; F_op, W2, mask_sq: the chain's
    `os_spectrum_operators` (the plain version's); tab: `tables(mask)`
    on x's card (the kernel's).  Returns (new_state, y, spec) like
    `os_filter_matmul_spectrum` on `scale * x`.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if not x.is_cuda:
        return os_spectrum_plain(state, x, F_op, W2, mask_sq, scale)
    return _launch(state, x, tab, scale)


def _launch(state: torch.Tensor, x: torch.Tensor, tab: torch.Tensor,
            scale: float):
    dev = x.device
    lead, half = tuple(x.shape[:-1]), x.shape[-1]
    if half != HALF:
        raise ValueError(f"os_spectrum: the kernel is built for F = {F} "
                         f"(F/2 = {HALF} new samples), got F/2 = {half}")
    if tab is None:
        raise ValueError("os_spectrum: a CUDA launch needs the kernel's "
                         "tables (`tables(mask)` on the card)")
    c64, f32 = torch.complex64, torch.float32
    cin = _build.cuda_input
    x = cin("x", x, c64, lead + (HALF,), dev)
    state = cin("state", state, c64, lead + (HALF,), dev)
    tab = cin("tab", tab, f32, (TABLE_FLOATS,), dev)
    new_state = torch.empty_like(x)
    y = torch.empty_like(x)
    spec = torch.empty(lead + (F,), dtype=f32, device=dev)
    _build.launch("t41x_os_spectrum", _ARGS, dev, state, x, tab,
                  float(scale), math.prod(lead), new_state, y, spec)
    os_spectrum.launches += 1
    return new_state, y, spec


os_spectrum.launches = 0  # CUDA kernel launches
