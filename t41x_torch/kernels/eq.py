"""E1: the 14-band EQ — CUDA kernel launch.

`t41x.dsp.eq.EQDesign.apply` runs the EQ as a `lax.scan` of two dense
products a 32-sample chunk and a gain-weighted band sum; no TPU kernel
replaces it, but on the card the plain version
(`t41x_torch.dsp.eq.EQDesign.apply_plain`) launches ~30 ops a 256-sample
block and writes a (C, 14, n) band tensor to device memory.  E1
(`t41x_torch/csrc/eq.cu`) runs the same chunk recurrence from the
operators' nonzero blocks (`EQDesign.kernel_consts`) in one launch, the
signed gains folded into one response a channel: the input terms of
every chunk at once, then the serial 4 x 4 state scan a band, then
every chunk's output at once.  The state keeps its layout (..., 14, S,
2), the concatenated normal-form states of
`dsp.chunk_ops.compose_cascade_ops`, so states pass to and from t41x
and the plain version mid-stream.  The dispatch is `EQDesign.apply`
with `use_kernels`; `eq_phases` launches the same kernel with `clock64`
stamps per phase (`_build.phase_split` with `E1_PHASES`).

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
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]   # the stamps buffer before the stream
# eq.cu's thread blocks: a channel each up to FEW channels, else
# MANY_PER_BLOCK each (its WARPS / W_MANY)
FEW, MANY_PER_BLOCK = 132, 4
# what each row of stamps (one a thread block) holds: clock64 cycles of
# the constants, the effective response and the first pass's input,
# then summed over the passes of up to 8 chunks the input terms G^T x,
# the state scan, the outputs, and the later passes' input staging with
# the state's store; then the block's total cycles and nanoseconds
E1_PHASES = ("constants", "input terms", "scan", "outputs", "staging")
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


def eq_phases(design, state: torch.Tensor, x: torch.Tensor,
              gains: torch.Tensor):
    """E1 on CUDA tensors with its phase split: (state, y, stamps),
    stamps as `_build.phase_split` reads them with `E1_PHASES`."""
    c = math.prod(x.shape[:-1])
    stamps = _build.stamp_buffer(c, 1 if c <= FEW else MANY_PER_BLOCK,
                                 len(E1_PHASES) + 2, x.device)
    state, y = _launch(design, state, x, gains, stamps)
    return state, y, stamps


def _launch(design, state, x, gains, stamps=None):
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
    x = _build.aligned(cin("x", x, f32, lead + (n,), dev))
    state = _build.aligned(
        cin("state", state, f32, lead + (NUM_BANDS, STAGES, 2), dev))
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
    name, args, extra = (("t41x_eq", _ARGS, ()) if stamps is None
                         else ("t41x_eq_phases", _PHASE_ARGS, (stamps,)))
    if c:
        _build.launch(name, args, dev, x, state, gains, ops, ops.numel(), c,
                      n, y, state_out, *extra)
        eq_block.launches += 1
    return state_out, y


eq_block.launches = 0  # CUDA kernel launches
