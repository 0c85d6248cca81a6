"""E1: the 14-band EQ — CUDA kernel launch.

`t41x.dsp.eq.EQDesign.apply` runs the EQ as a `lax.scan` of two dense
products a 32-sample chunk and a gain-weighted band sum; no TPU kernel
replaces it, but on the card the plain version
(`t41x_torch.dsp.eq.EQDesign.apply_plain`) launches ~30 ops a 256-sample
block and writes a (C, 14, n) band tensor to device memory.  E1
(`t41x_torch/csrc/eq.cu`) runs the same chunk recurrence from the
operators' nonzero blocks (`EQDesign.kernel_consts`) in one launch, the
signed gains folded into the band sum in registers.  The state keeps
its layout (..., 14, S, 2), the concatenated normal-form states of
`dsp.chunk_ops.compose_cascade_ops`, so states pass to and from t41x
and the plain version mid-stream.  The dispatch is `EQDesign.apply`
with `use_kernels`.

E1 sums in another order than the plain version's cuBLAS products: the
two agree to within float32 rounding (>= 100 dB), not bit for bit.
"""

from __future__ import annotations

import math

import torch

from t41x_torch.dsp.eq import NUM_BANDS
from t41x_torch.kernels import _build

_P, _I = _build.PTR, _build.INT
_ARGS = [_P] * 4 + [_I] * 3 + [_P] * 3   # the last: the stream
CHUNK, STAGES = 32, 2   # the chunk and the stages a band E1 is built for


def eq_block(design, state: torch.Tensor, x: torch.Tensor,
             gains: torch.Tensor):
    """`design.apply(state, x, gains)`: x (..., n) float32 audio with n a
    multiple of 32, state (..., 14, 2, 2), gains broadcastable to
    (..., 14).
    Returns (state, y).  CPU tensors take the plain version; CUDA tensors
    launch E1.  Raises on what E1 does not take, before any launch."""
    if not x.is_cuda:
        return design.apply_plain(state, x, gains)
    return _launch(design, state, x, gains)


def _launch(design, state, x, gains):
    if design.chunk != CHUNK or design.stages != STAGES:
        raise ValueError(f"E1: built for chunks of {CHUNK} and {STAGES} "
                         f"stages a band, not {design.chunk} and "
                         f"{design.stages}")
    dev = x.device
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    if n == 0 or n % CHUNK:
        raise ValueError(f"E1: block length {n} is not a positive "
                         f"multiple of {CHUNK}")
    f32, cin = torch.float32, _build.cuda_input
    x = cin("x", x, f32, lead + (n,), dev)
    state = cin("state", state, f32, lead + (NUM_BANDS, STAGES, 2), dev)
    try:
        gains = torch.broadcast_to(gains, lead + (NUM_BANDS,))
    except RuntimeError as e:
        raise ValueError(f"E1: gains of shape {tuple(gains.shape)} for "
                         f"channels {lead}") from e
    gains = cin("gains", gains, f32, lead + (NUM_BANDS,), dev)
    ops = design.kernel_ops(dev)
    c = math.prod(lead)
    y = torch.empty_like(x)
    state_out = torch.empty_like(state)
    if c:
        _build.launch("t41x_eq", _ARGS, dev, x, state, gains, ops,
                      ops.numel(), c, n, y, state_out)
        eq_block.launches += 1
    return state_out, y


eq_block.launches = 0  # CUDA kernel launches
