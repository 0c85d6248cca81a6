"""The card's peaks and the work counts of the hand-written kernels the
benchmark holds to a roofline, at a cell's shapes.

Copied from the port's `chip_smoke.py` (`PEAK_FP32`, `PEAK_HBM`,
`bound`, `k1_flops`, `k4_flops`), so that a later change to the program
leaves this yardstick as it is.  The work is counted as the function
needs it, not as a kernel does it: K1's operations are those of the
sample-by-sample recurrences and filters, not of its chunk form; the
bytes count each input byte read once and each output byte written once.
"""

from __future__ import annotations

from sdrbench.references.ssb_chain import decimator_taps

# NVIDIA H100 SXM data sheet, 700 W: fp32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12   # flop/s
PEAK_HBM = 3.35e12  # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM rate."""
    return max(flops / PEAK_FP32, nbytes / PEAK_HBM)


def k1_work(channels: int, zoom: int, q15: bool, n: int = 2048) -> tuple:
    """(operations, bytes) of the fused front end (K1) for one block:
    RF gain and IQ correction, the DC biquad (5 FMAs a sample, I and Q),
    the NCO (8 a sample), the x4 and x2 decimators; an FMA counts 2,
    `sincosf` not at all.  Bytes: the input (q15 pairs or complex64),
    five parameters, the state read and written (DC biquad 4, NCO phase
    1, decimator histories as complex), the 24 kHz output and, with the
    zoom-x1 tap, its 512-sample segment."""
    if zoom not in (-1, 0):
        raise ValueError("k1_work: the zoom 2^z tap (K1z) is not counted")
    t1, t2 = decimator_taps()
    ops = n * (2 + 3) + n * 2 * 5 * 2 + n * 8 \
        + (n // 4) * t1 * 2 * 2 + (n // 8) * t2 * 2 * 2
    state = (4 + 1) * 4 + ((t1 - 1) + (t2 - 1)) * 8
    nbytes = (n * (4 if q15 else 8) + 5 * 4 + 2 * state + (n // 8) * 8
              + (512 * 8 if zoom == 0 else 0))
    return ops * channels, nbytes * channels


def k4_work(channels: int, half: int = 256) -> tuple:
    """(operations, bytes) of the overlap-save band-pass as one complex
    product y = [h | x] @ W.T (K4): 4 real FMAs a complex multiply-add;
    bytes: the history and the block read, W read once, y written."""
    ops = 8 * channels * half * 2 * half
    nbytes = channels * (2 * half * 8 + half * 8) + half * 2 * half * 8
    return ops, nbytes
