"""The one traffic generator: a seeded band mix per channel, made on the
device, from a traffic mix's parameters (`sdrbench/traffic/*.json`).

Each channel gets complex white noise, 1 to `carriers` carriers at audio
offsets drawn over `offset_hz` (across and beyond the pass-band), levels
drawn over `level_dbfs`, each keyed on and off (a square wave whose on
and off times are drawn over `key_ms`, from a random phase), all
quantised to the codec's q15 (Process.cpp:102-111).  The channel's
parameters are drawn too: the NCO tuning over `nco_hz` (each carrier is
placed relative to it), the IQ amplitude and phase corrections, and the
volume.  The same seed gives the same blocks and parameters; every seed
gives the same sizes.
"""

from __future__ import annotations

import math

import torch

RATE = 192_000.0
BLOCK = 2048


def _uniform(g, n: int, lo_hi, device, shape=()) -> torch.Tensor:
    lo, hi = map(float, lo_hi)
    u = torch.rand((n,) + shape, generator=g, device=device,
                   dtype=torch.float64)
    return lo + (hi - lo) * u


def make(sig: dict, channels: int, n_blocks: int, seed: int, device):
    """(i, q, params): i and q (n_blocks, channels, 2048) int16 at 192 kHz,
    consecutive blocks of one stream; params a dict of (channels,)
    float32 tensors."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    c, k = channels, int(sig["carriers"])
    nco = _uniform(g, c, sig["nco_hz"], dev)
    params = {
        "nco_freq": nco,
        "iq_amp": _uniform(g, c, sig["iq_amp"], dev),
        "iq_phase": _uniform(g, c, sig["iq_phase"], dev),
        "volume": torch.full((c,), float(sig["volume"]), dtype=torch.float64,
                             device=dev),
    }
    params["rf_gain_db"] = torch.zeros(c, dtype=torch.float64, device=dev)
    params["band_gain"] = torch.ones(c, dtype=torch.float64, device=dev)
    params = {k_: v.to(torch.float32) for k_, v in params.items()}
    # carriers: how many a channel (1..k), offset, level, keying, phase;
    # placed at -Fs/4 + NCO + offset, where the chain takes them to audio
    n_on = torch.randint(1, k + 1, (c, 1), generator=g, device=dev)
    on = torch.arange(k, device=dev)[None, :] < n_on               # (C, k)
    freq = (-RATE / 4 + params["nco_freq"].double()[:, None]
            + _uniform(g, c, sig["offset_hz"], dev, (k,)))
    amp = 10.0 ** (_uniform(g, c, sig["level_dbfs"], dev, (k,)) / 20.0)
    amp = amp * on
    t_on = _uniform(g, c, sig["key_ms"], dev, (k,)) * 1e-3 * RATE
    t_off = _uniform(g, c, sig["key_ms"], dev, (k,)) * 1e-3 * RATE
    key0 = _uniform(g, c, (0.0, 1.0), dev, (k,)) * (t_on + t_off)
    ph0 = _uniform(g, c, (0.0, 2 * math.pi), dev, (k,))
    sigma = 10.0 ** (float(sig["noise_dbfs"]) / 20.0) / math.sqrt(2.0)

    i_out = torch.empty((n_blocks, c, BLOCK), dtype=torch.int16, device=dev)
    q_out = torch.empty_like(i_out)
    for b in range(n_blocks):
        n = (torch.arange(BLOCK, device=dev, dtype=torch.float64)
             + b * BLOCK)                                          # (N,)
        x = torch.randn((c, BLOCK), generator=g, device=dev,
                        dtype=torch.float32) * sigma
        y = torch.randn((c, BLOCK), generator=g, device=dev,
                        dtype=torch.float32) * sigma
        for j in range(k):
            cyc = torch.remainder(freq[:, j:j + 1] * n / RATE, 1.0)
            phase = 2 * math.pi * cyc + ph0[:, j:j + 1]
            keyed = torch.remainder(n + key0[:, j:j + 1],
                                    (t_on + t_off)[:, j:j + 1]) \
                < t_on[:, j:j + 1]
            a = (amp[:, j:j + 1] * keyed)
            x += (a * torch.cos(phase)).float()
            y += (a * torch.sin(phase)).float()
        for src, dst in ((x, i_out), (y, q_out)):
            dst[b] = torch.clamp(torch.round(src * 32768.0), -32768,
                                 32767).to(torch.int16)
    return i_out, q_out, params
