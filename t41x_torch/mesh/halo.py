"""Time-block sharding with halo exchange (torch), port of
`t41x.mesh.halo`.

The reference carries filter state between consecutive 2048-sample blocks
(overlap-save history `Process.cpp:498-522`, decimator states
`T41_SDR.ino:388-397`).  When a long capture is sharded in TIME, each
shard holding a contiguous segment, that carried state becomes a halo:
each shard needs the last `halo` samples of its LEFT neighbour's segment
before filtering.  `t41x` moves it with one `ppermute` inside
`shard_map`; here a sharded signal is the list of its segments along the
`t` axis, each on its shard's device, and the halo is a copy of the
neighbour's tail to the shard's device (a peer copy between cards).

For 192 kHz / 24 kHz chains the halo is ~300 samples (256 OS history +
decimator tails), thousands of times smaller than a segment.
"""

from __future__ import annotations

import torch

from t41x_torch import constants as C
from t41x_torch.dsp import fir, osfilter


def left_halo(shards: list, halo: int) -> list:
    """The trailing `halo` samples of each shard's left neighbour.

    shards: per-shard segments (..., N), in `t` order.  Shard 0 receives
    zeros (stream start).  Returns a list of (..., halo) on each shard's
    device."""
    out = [torch.zeros_like(shards[0][..., -halo:])]
    for left, seg in zip(shards[:-1], shards[1:]):
        out.append(left[..., -halo:].to(seg.device))
    return out


def sharded_fir_decimate(shards: list, h: torch.Tensor,
                         factor: int) -> list:
    """Streaming FIR decimation of a time-sharded signal: the same output
    as the unsharded stream, each shard's (taps-1)-sample history from
    its left neighbour.  shards: (..., N) segments, N divisible by
    factor."""
    halos = left_halo(shards, h.shape[0] - 1)
    return [fir.fir_decimate(st, seg, h.to(seg.device), factor)[1]
            for st, seg in zip(halos, shards)]


def sharded_os_filter(shards: list, mask: torch.Tensor,
                      fft_length: int = C.FFT_LENGTH) -> list:
    """Overlap-save filtering of a time-sharded stream: each shard starts
    from its left neighbour's last fft_length/2 samples and runs its own
    blocks.  shards: (..., N) segments, N divisible by fft_length/2."""
    half = fft_length // 2
    out = []
    for hist, seg in zip(left_halo(shards, half), shards):
        m = mask.to(seg.device)
        ys = []
        for i in range(seg.shape[-1] // half):
            hist, y = osfilter.os_filter(hist, seg[..., i * half:
                                                   (i + 1) * half], m)
            ys.append(y)
        out.append(torch.cat(ys, dim=-1))
    return out
