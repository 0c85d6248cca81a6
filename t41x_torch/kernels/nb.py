"""N1: the LPC noise blanker — CUDA kernel launch.

`t41x.dsp.nb.noise_blanker` runs its recurrences (Levinson-Durbin, the
forward and backward predictors, the cross-fade distances) as
`lax.scan`s; no TPU kernel replaces them, but on the card the plain
version's per-sample loop launches ~2,300 small ops a 256-sample block,
about half of a block's 10.667 ms budget at 1024 channels, and the
chain's `nb_on` path runs it.  N1 (`t41x_torch/csrc/nb.cu`) computes the
whole blanker in one launch, one warp a frame with its samples in
registers, the predictors walked by groups of runs (the walk that
`t41x_torch.dsp.nb.walk_by_runs` states in plain torch).  The dispatch (CPU
tensors, or `use_kernel=False`, to the plain version
`t41x_torch.dsp.nb.noise_blanker_plain`; CUDA tensors here) is
`t41x_torch.dsp.nb.noise_blanker`.

N1 sums the autocorrelation, the variance and the predictions in
another order than torch, so a sample whose |temp| lies within float32
rounding of the threshold may be decided the other way
(`t41x_torch.dsp.nb.decision_margin` gives the plain version's
margins); outside its blank mask the output is the input, bit for bit.
`launch(..., masks=...)` also writes the mask, for comparison, and
`nb_phases` launches the same kernel with `clock64` stamps per phase
(`_build.phase_split` with `N1_PHASES`).
"""

from __future__ import annotations

import math

import torch

from t41x_torch.dsp.nb import NB_THRESH, ORDER
from t41x_torch.kernels import _build

N_MIN, N_MAX = ORDER + 1, 1024   # frame lengths N1 stages (nb.cu)
_P, _I = _build.PTR, _build.INT
_ARGS = [_P, _I, _I, _build.FLOAT, _P, _P, _P]
_PHASE_ARGS = _ARGS[:-1] + [_P, _P]   # the stamps buffer before the stream
# what each row of stamps (one a frame) holds: clock64 cycles of the
# frame's loads (until its samples are in shared memory), the lags and
# Levinson-Durbin, the two FIRs, the detection (variance, threshold,
# hits, dilation, the run list), the predictors, the cross-fade and the
# frame's store, then the frame's total cycles and nanoseconds
N1_PHASES = ("load", "lpc", "filters", "detect", "predict", "cross-fade",
             "store")


def mask_words(n: int) -> int:
    """32-bit words of a frame's blank mask."""
    return -(-n // 32)


def launch(x: torch.Tensor, thresh: float = NB_THRESH,
           masks: torch.Tensor | None = None,
           stamps: torch.Tensor | None = None) -> torch.Tensor:
    """N1 on a CUDA tensor: x (..., n) float32, contiguous, N_MIN <= n
    <= N_MAX.  Returns the blanked frames.  With `masks`, an int32
    (frames, mask_words(n)) tensor on x's card, it also writes each
    frame's blank mask there (sample t: bit t % 32 of word t // 32).
    With `stamps` (`nb_phases`) it launches the stamped variant.
    Raises on what it does not take, before any launch, and if the
    kernel cannot build or launch."""
    dev, n = x.device, x.shape[-1] if x.dim() else 0
    if x.dtype != torch.float32:
        raise ValueError(f"N1: expected float32 frames, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("N1: expected contiguous frames")
    if not N_MIN <= n <= N_MAX:
        raise ValueError(f"N1: frame length {n} outside [{N_MIN}, {N_MAX}]")
    frames = math.prod(x.shape[:-1])
    if masks is not None and not (
            masks.dtype == torch.int32 and masks.is_contiguous()
            and tuple(masks.shape) == (frames, mask_words(n))):
        raise ValueError(f"N1: masks must be a contiguous int32 tensor of "
                         f"shape {(frames, mask_words(n))}")
    y = torch.empty_like(x)
    name, args, extra = (("t41x_nb", _ARGS, ()) if stamps is None
                         else ("t41x_nb_phases", _PHASE_ARGS, (stamps,)))
    if frames:
        _build.launch(name, args, dev, x, frames, n, float(thresh), y,
                      masks, *extra)
        launch.launches += 1
    return y


launch.launches = 0  # CUDA kernel launches


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """(frames, mask_words(n)) int32 words -> (frames, n) bool."""
    t = torch.arange(n, device=words.device)
    return ((words[:, t // 32] >> (t % 32)) & 1).bool()


def launch_with_mask(x: torch.Tensor, thresh: float = NB_THRESH):
    """N1 with its blank mask: (y, mask), mask (..., n) bool."""
    n = x.shape[-1]
    words = torch.empty(math.prod(x.shape[:-1]), mask_words(n),
                        dtype=torch.int32, device=x.device)
    y = launch(x, thresh, words)
    return y, unpack_mask(words, n).reshape(x.shape)


def nb_phases(x: torch.Tensor, thresh: float = NB_THRESH):
    """N1 on a CUDA tensor with its phase split: (y, stamps), stamps
    (frames, 9) as `_build.phase_split` reads them with `N1_PHASES`."""
    stamps = _build.stamp_buffer(math.prod(x.shape[:-1]), 1,
                                 len(N1_PHASES) + 2, x.device)
    return launch(x, thresh, stamps=stamps), stamps
