"""Per-stage / per-variant timing of the receive chain on the card, port
of `tools/stagebench.py`.

Times `ChainSpec` variants (full chain, AGC off, NR on, FFT vs matmul
overlap-save filter, ...) at a fixed channel count by the method of
`t41x_torch.tools.bench`: one dispatch is a CUDA graph replay of
`--blocks` blocks over device-resident inputs, every output in the
checksum, `repeats` replays ended by the checksum's fetch and scaled to
--min-ms; µs a block is (time - dispatch floor) / blocks, so a stage
costs the difference between two variants.  `_batched` variants capture
`block_batch` over the buffer instead.

The variants are the reference's, by name.  t41x's `ChainSpec` defaults
to `use_pallas=False`, the port's to `use_kernels=True`: a variant
without `use_pallas=True` there runs here with `use_kernels=False` (the
plain torch versions, on the card), and every `pallas_*` variant with
`use_kernels=True`.

It runs on the card unless --device cpu is given (eager, for the tests);
with no card visible the default raises.

Usage: python -m t41x_torch.tools.stagebench [--channels 1024]
    [--min-ms 150] [--variants full,pallas,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from t41x_torch import constants as C
from t41x_torch.tools import bench

PLAIN, KERNELS = dict(use_kernels=False), dict(use_kernels=True)

VARIANTS = {
    "full": dict(**PLAIN),
    "agc_off": dict(agc_mode=0, **PLAIN),
    "fft_osfilter": dict(use_matmul_osfilter=False, **PLAIN),
    "no_spectrum_taps": dict(spectrum_taps=False, **PLAIN),
    "no_interp": dict(interpolate_out=False, **PLAIN),
    "front_end_only": dict(mode="psk31", interpolate_out=False, **PLAIN),
    "nr_spectral": dict(nr_mode=2, **PLAIN),
    "nr_lms": dict(nr_mode=3, **PLAIN),
    "sam": dict(mode="sam", **PLAIN),
    "nfm": dict(mode="nfm", **PLAIN),
    "pallas": dict(**KERNELS),
    "pallas_nospec": dict(spectrum_taps=False, **KERNELS),
    "pallas_agc_off": dict(agc_mode=0, **KERNELS),
    "pallas_no_interp": dict(interpolate_out=False, **KERNELS),
    "pallas_fe_only": dict(mode="psk31", interpolate_out=False, **KERNELS),
    "pallas_nr_lms": dict(nr_mode=3, **KERNELS),
    "pallas_sam": dict(mode="sam", **KERNELS),
    "pallas_nfm": dict(mode="nfm", **KERNELS),
    "pallas_nr_spectral": dict(nr_mode=2, **KERNELS),
    "pallas_nr_kim": dict(nr_mode=1, **KERNELS),
    "pallas_notch": dict(notch_on=True, **KERNELS),
    "pallas_eq": dict(eq_on=True, **KERNELS),
    "pallas_cw": dict(mode="cw", **KERNELS),
    "pallas_q15": dict(q15_input=True, **KERNELS),
    "pallas_q15_fe_only": dict(q15_input=True, mode="psk31",
                               interpolate_out=False, **KERNELS),
    "zoom2": dict(spectrum_zoom=1, **PLAIN),
    # cross-block NR batching (chain.block_batch): the NR stage lifts out
    # and runs once a batch of --blocks blocks
    "pallas_nr_kim_batch": dict(nr_mode=1, _batched=True, **KERNELS),
    "pallas_nr_spectral_batch": dict(nr_mode=2, _batched=True, **KERNELS),
    "pallas_zoom1": dict(spectrum_zoom=0, **KERNELS),
    "pallas_zoom2": dict(spectrum_zoom=1, **KERNELS),
    "pallas_zoom8": dict(spectrum_zoom=3, **KERNELS),
    "pallas_zoom128": dict(spectrum_zoom=7, **KERNELS),
}


def time_variant(kw: dict, n_ch: int, n_blocks: int, min_ms: float, dev,
                 floor_s: float, iq) -> dict:
    """One variant's µs a block and complex samples/s.  `iq`: the
    (n_blocks, n_ch, BLOCK) complex64 buffer on `dev` made from seed 0; a
    q15 variant makes its int16 pair from the same seed."""
    from t41x_torch.chain import ChainSpec, RxChain, default_params

    kw = dict(kw)
    batched = kw.pop("_batched", False)
    spec = ChainSpec(**{**dict(interpolate_out=True), **kw})
    chain = RxChain(spec, device=dev)
    params = default_params((n_ch,), device=dev)
    if spec.q15_input:
        iq = bench.make_blocks(spec, n_ch, n_blocks, seed=0, device=dev)
    if batched:
        def fn(p, st, blocks):
            st, outs = chain.block_batch(p, st, blocks)
            return st, bench.checksum(outs)
    else:
        def fn(p, st, blocks):
            return bench.run_blocks(chain, p, st, blocks)
    d = bench.dispatch(fn, params, chain.init_state((n_ch,)), iq)
    d.replay()
    repeats = bench.calibrate(d, floor_s, min_ms)
    t = bench.timed(d, repeats, 3)
    n_blk = repeats * n_blocks
    return {"us_per_block": (t - floor_s) / n_blk * 1e6,
            "rate": n_blk * n_ch * C.BLOCK_SIZE / (t - floor_s),
            "repeats": repeats, "graphed": d.graphed}


def main(argv=None) -> dict:
    """Time the variants; print one row each and return {name: row or
    {"failed": reason}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=1024)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--min-ms", type=float, default=150.0)
    ap.add_argument("--variants", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (eager)")
    args = ap.parse_args(argv)
    dev = bench.require_device(args.device, "stagebench")
    from t41x_torch.chain import ChainSpec

    variants = VARIANTS
    if args.variants:
        keep = args.variants.split(",")
        variants = {k: v for k, v in VARIANTS.items() if k in keep}
    n_ch = args.channels
    iq = bench.make_blocks(ChainSpec(), n_ch, args.blocks, seed=0,
                           device=dev)
    floor_s = bench.dispatch_floor(dev)
    print(f"# dispatch floor {floor_s * 1e3:.3f} ms on "
          f"{bench.device_name(dev)}", file=sys.stderr)

    rows, base_us = {}, None
    for name, kw in variants.items():
        t0 = time.perf_counter()
        try:
            r = time_variant(kw, n_ch, args.blocks, args.min_ms, dev, floor_s,
                             iq)
        except Exception as e:  # a row, as the reference prints it
            rows[name] = {"failed": f"{type(e).__name__}: {e}"}
            print(f"{name:28s} FAILED: {rows[name]['failed']}", flush=True)
            continue
        r["wall_s"] = time.perf_counter() - t0
        rows[name] = r
        us = r["us_per_block"]
        delta = "" if base_us is None else f"  (vs base {us - base_us:+.0f} us)"
        if base_us is None:
            base_us = us
        print(f"{name:28s} {us:8.1f} us/block/{n_ch}ch  "
              f"{r['rate'] / 1e9:7.2f} Gs/s{delta}", flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(1 if any("failed" in r for r in main().values()) else 0)
