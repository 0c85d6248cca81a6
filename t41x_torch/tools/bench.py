"""The port's headline benchmark, port of `bench.py`: complex input
samples/s per card through the full decimate + overlap-save filter + AGC
+ demod chain.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "config": {...}}

vs_baseline is relative to the reference radio's real-time envelope: one
receiver at 192_000 complex samples/s on its MCU (BASELINE.md), i.e. the
number of simultaneous real-time 192 kHz channels the card sustains.

Method (`bench.py`'s, on the card):

* One dispatch is one replay of a CUDA graph holding `--blocks` calls of
  the chain's `block` over a device-resident block buffer, the carried
  state threaded from block to block and written over the graph's static
  state at the end, so each replay continues the stream.  The kernels
  are built and the chain warmed on a clone of the state, on a side
  stream, before the capture (`t41x_torch.runner._Graph`'s order).
* Every output feeds a checksum accumulated on the device:
  sum(audio_24k^2) plus 1e-6 x the sum of every output (the real part of
  complex ones); the exciter's is sum(|iq|^2).  Before timing, one replay
  from the initial state must give the eager loop's checksum bit for
  bit: a capture that skipped or reordered work fails here.
* The timed region is `repeats` replays ended by a host fetch of the
  checksum (`.item()`, which waits for the card); `repeats` is scaled
  until it takes >= --min-ms against the measured dispatch floor (one
  replay of a one-kernel graph plus the fetch).  A linearity check
  doubles `repeats` and records the time ratio (~2): the median over
  pairs of a 1x and a 2x region timed back to back, in turns (1x 2x,
  2x 1x, ...), so that a change of the card's clock between the two
  cancels within a pair and one disturbed pair does not decide.
* The eager rate, the same loop without the graph, is reported beside
  the graphed one.
* --check (default on): before timing, the exact timed spec streams a
  seeded tone in noise (256 channels x 8 blocks) with kernels and with
  the plain torch versions, both on the card; audio and audio_24k must
  be >= 55 dB apart from each other's error and rf_spectrum within 0.5
  dB (bench.py's formulas).  A failed bound raises.

`config` drops bench.py's `xla_flops_per_pass`, `achieved_tflops` and
`util_vs_bf16_peak`: they come from XLA's cost model and a TPU peak
table, which have no counterpart here.  It adds the card's power limit,
the eager rate and whether the rate is graphed.

It runs on the card unless --device cpu is given (the plain versions,
eager, for the tests); with no card visible the default raises.

Usage: python -m t41x_torch.tools.bench [--channels N] [--blocks N]
    [--config rx|rx_nodisplay|cw|nfm|nr|beacon|channelizer|tx]
    [--q15] [--no-kernels] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from t41x_torch import constants as C

CONFIGS = ("rx", "rx_nodisplay", "cw", "nfm", "nr", "beacon", "channelizer",
           "tx")
BASELINE_RATE = 192000.0


def cfg_map(mode: str = "usb") -> dict:
    """The ChainSpec keywords of each --config (bench.py's `cfg_map`)."""
    return {
        # flagship: the zoom x1 RF panadapter tap the reference computes
        # on every pass (CalcZoom1Magn, Process.cpp:185-187)
        "rx": dict(mode=mode, spectrum_zoom=0),
        # the display-free chain (headless deployments)
        "rx_nodisplay": dict(mode=mode),
        "cw": dict(mode="cw", spectrum_zoom=2, cw_filter_index=1,
                   nr_mode=2),
        "nfm": dict(mode="nfm"),
        "nr": dict(mode=mode, nr_mode=2, spectrum_zoom=0),
        "beacon": dict(mode="usb", spectrum_zoom=1),
        "channelizer": dict(mode="usb"),
        "tx": dict(mode="usb"),  # spec unused: tx benches the exciter
    }


def q15(a: np.ndarray) -> np.ndarray:
    """float -> the reference's ADC int16 (bench.py:262-268)."""
    return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)


def make_blocks(spec_or_config, n_ch: int, n_blocks: int, seed: int = 0,
                k: int = 16, device="cpu"):
    """bench.py's seeded block buffer, blocks on the leading axis, on
    `device`.  "tx": (n_blocks, n_ch, BLOCK) float32 mic audio;
    "channelizer": (n_blocks, n_ch / k, k * BLOCK) complex64 wideband
    captures; a ChainSpec: (n_blocks, n_ch, BLOCK) complex64, or with
    `q15_input` the (i, q) pair of int16 arrays of that shape."""
    rng = np.random.default_rng(seed)
    if isinstance(spec_or_config, str) and spec_or_config == "tx":
        mic = rng.standard_normal(
            (n_blocks, n_ch, C.BLOCK_SIZE)).astype(np.float32) * 0.1
        return torch.from_numpy(mic).to(device)
    wide = isinstance(spec_or_config, str)
    if wide and spec_or_config != "channelizer":
        raise ValueError(f"make_blocks: {spec_or_config!r}")
    shape = ((n_blocks, n_ch // k, k * C.BLOCK_SIZE) if wide
             else (n_blocks, n_ch, C.BLOCK_SIZE))
    iq = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
          ).astype(np.complex64) * 0.1
    if not wide and spec_or_config.q15_input:
        return tuple(torch.from_numpy(q15(a)).to(device)
                     for a in (iq.real, iq.imag))
    return torch.from_numpy(iq).to(device)


def checksum(out) -> torch.Tensor:
    """The dead-work guard on one call's outputs, a float32 scalar on
    their device: for the receive chain's dict, sum(audio_24k^2) + 1e-6 x
    the sum of every output (real part of complex ones, bools as 0/1);
    for the exciter's I/Q tensor, sum(|iq|^2).  One reduction an output
    and four scalar ops: on the card each op is a kernel of its own."""
    if isinstance(out, torch.Tensor):
        return torch.view_as_real(out).square().sum()
    sums = torch.stack([(v.real if v.is_complex() else v.to(torch.float32))
                        .sum() for v in out.values()])
    return out["audio_24k"].square().sum() + sums.sum() * 1e-6


def n_blocks_of(blocks) -> int:
    return (blocks[0] if isinstance(blocks, tuple) else blocks).shape[0]


def run_blocks(chain, params, state, blocks):
    """One dispatch's body, eager: every block of `blocks` (leading axis;
    a q15 pair of such arrays) through `chain.block`, the state carried.
    Returns (state, the checksum summed over the blocks)."""
    e = None
    for b in range(n_blocks_of(blocks)):
        blk = (tuple(a[b] for a in blocks) if isinstance(blocks, tuple)
               else blocks[b])
        state, out = chain.block(params, state, blk)
        e = checksum(out) if e is None else e + checksum(out)
    return state, e


class Channelized:
    """The channelizer config's block: `Channelizer.block` splits each
    wideband capture into its K channels, which run through the chain
    (bench.py:219-221).  State: (chain state, channelizer state)."""

    def __init__(self, cz, chain):
        self.cz, self.chain = cz, chain

    def init_state(self, channels: tuple[int, ...]):
        return (self.chain.init_state(channels),
                self.cz.init_state((channels[0] // self.cz.K,)))

    def block(self, params, state, blk):
        st, cz_st = state
        cz_st, chans = self.cz.block(cz_st, blk)
        st, out = self.chain.block(
            params, st, chans.reshape(-1, blk.shape[-1] // self.cz.K))
        return (st, cz_st), out


class Eager:
    """A dispatch run eagerly: `fn(params, state, blocks) -> (state, e)`,
    the state carried from call to call, e added to `acc` on the
    device."""

    graphed = False

    def __init__(self, fn, params, state, blocks):
        self.fn, self.params, self.state, self.blocks = \
            fn, params, state, blocks
        self.acc = torch.zeros((), dtype=torch.float32,
                               device=_device_of(blocks))

    def replay(self) -> None:
        self.state, e = self.fn(self.params, self.state, self.blocks)
        self.acc.add_(e)


class Graphed:
    """A dispatch captured as one CUDA graph over static params, state and
    blocks (`t41x_torch.runner.capture`, warm-up first): each replay runs
    `fn` once, adds its checksum to `acc` and writes the new state over
    the static state's leaves.  A host read inside `fn` makes the capture
    raise (there is no eager fallback)."""

    graphed = True

    def __init__(self, fn, params, state, blocks):
        from t41x_torch.runner import _leaves, capture

        dev = _device_of(blocks)
        self.state = state
        self.acc = torch.zeros((), dtype=torch.float32, device=dev)

        def step(st):
            st, e = fn(params, st, blocks)
            self.acc.add_(e)
            return st, {}

        with torch.cuda.device(dev):
            self.graph, _ = capture(step, state, _leaves(blocks), dev)
        self.acc.zero_()   # of the warm-up's checksum

    def replay(self) -> None:
        self.graph.replay()


def _device_of(blocks) -> torch.device:
    return (blocks[0] if isinstance(blocks, tuple) else blocks).device


def dispatch(fn, params, state, blocks):
    """A `Graphed` dispatch on the card, an `Eager` one on the CPU."""
    if _device_of(blocks).type == "cuda":
        return Graphed(fn, params, state, blocks)
    return Eager(fn, params, state, blocks)


def timed(d, repeats: int, reps: int) -> float:
    """Best of `reps` wall times of `repeats` dispatches ended by the
    host fetch of the checksum."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(repeats):
            d.replay()
        d.acc.item()
        best = min(best, time.perf_counter() - t0)
    return best


def linearity(d, repeats: int, pairs: int) -> float:
    """Median over `pairs` of the time ratio of 2 x `repeats` dispatches
    to `repeats`, the two of a pair timed back to back, in turns (1x 2x,
    2x 1x, ...)."""
    ratios = []
    for i in range(pairs):
        t = {k: timed(d, k * repeats, 1) for k in ((1, 2), (2, 1))[i % 2]}
        ratios.append(t[2] / t[1])
    return float(np.median(ratios))


def dispatch_floor(device) -> float:
    """Seconds of one trivial dispatch and its fetch: the replay of a
    one-kernel graph on the card, one op on the CPU (best of 10)."""
    dev = torch.device(device)
    v = torch.ones((), dtype=torch.float32, device=dev)
    # the dispatch's one kernel is its checksum's add
    d = dispatch(lambda _p, st, _b: (st, st), None, v, v)
    d.replay()
    return timed(d, 1, 10)


def calibrate(d, floor_s: float, min_ms: float) -> int:
    """Repeats so that the timed region takes >= min_ms of compute above
    the dispatch floor (bench.py's rule)."""
    t1 = timed(d, 1, 2)
    per_rep = max(t1 - floor_s, t1 / 10, 1e-5)
    return max(1, int(np.ceil(min_ms / 1e3 / per_rep)))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit_w(dev: torch.device):
    """The card's power limit in W from nvidia-smi (None on the CPU)."""
    if dev.type != "cuda":
        return None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def require_device(device, tool: str) -> torch.device:
    """The tool's device; raises for a card that is not there (no
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA card is visible; pass --device "
                           "cpu to run the plain versions on the CPU")
    return dev


def parity_check(spec, device, n_ch: int = 256, n_blocks: int = 8) -> dict:
    """The exact timed spec with kernels against the same spec with the
    plain torch versions, both streaming the same seeded blocks through
    `device` (bench.py's `parity_check`): audio and audio_24k SNR in dB
    (> 55 required) and rf_spectrum's largest displayed error in dB
    within the 60 dB range (< 0.5 required).  Raises on a failed bound."""
    from t41x_torch.chain import RxChain, default_params
    from t41x_torch.utils import parity

    rng = np.random.default_rng(7)
    t = np.arange(n_blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    tone = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
    iq = (tone + (rng.standard_normal((n_ch, t.size))
                  + 1j * rng.standard_normal((n_ch, t.size))) * 0.05
          ).astype(np.complex64)
    if spec.q15_input:
        data = tuple(torch.from_numpy(q15(a)).to(device)
                     for a in (iq.real, iq.imag))
    else:
        data = (torch.from_numpy(iq).to(device),)
    params = default_params((n_ch,), device=device)

    def stream(s):
        chain = RxChain(s, device=device)
        st = chain.init_state((n_ch,))
        outs = {}
        for b in range(n_blocks):
            blk = tuple(a[..., b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
                        .contiguous() for a in data)
            st, out = chain.block(params, st,
                                  blk if spec.q15_input else blk[0])
            for k in ("audio", "audio_24k", "rf_spectrum"):
                if k in out:
                    outs.setdefault(k, []).append(out[k])
        return {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}

    got = stream(spec)
    ref = stream(dataclasses.replace(spec, use_kernels=False))
    out = {}
    for k, r in ref.items():
        if k == "rf_spectrum":
            d = parity.spectrum_err_db(r, got[k])
            out["rf_spectrum_max_err_db"] = round(d, 3)
            if not d < parity.SPECTRUM_ERR_MAX_DB:
                raise RuntimeError(f"parity: rf_spectrum {d} dB")
            continue
        db = parity.snr_db(r.astype(np.float64), got[k].astype(np.float64))
        out[k] = round(db, 1) if np.isfinite(db) else db
        if not db > parity.AUDIO_SNR_MIN_DB:
            raise RuntimeError(f"parity: {k} {db} dB")
    print(f"# parity on {device} (kernels vs plain, {n_ch} ch x {n_blocks} "
          "blocks): " + ", ".join(f"{k}={v}" for k, v in out.items()),
          file=sys.stderr)
    return out


def build(config: str, spec, n_ch: int, n_blocks: int, dev,
          channelizer_k: int = 16):
    """(fn, params, initial state, blocks) of one dispatch of `config` at
    `n_ch` channels, inputs on `dev`."""
    if config == "tx":
        from t41x_torch.chain.tx import SSBExciter, TxSpec, default_tx_params

        chain = SSBExciter(TxSpec(sideband="usb", eq_on=True), device=dev)
        params = default_tx_params((n_ch,), device=dev)
    else:
        from t41x_torch.chain import RxChain, default_params

        chain = RxChain(spec, device=dev)
        params = default_params((n_ch,), device=dev)
        if config == "channelizer":
            from t41x_torch.mesh.channelizer import Channelizer

            chain = Channelized(Channelizer(channelizer_k, device=dev), chain)
    blocks = make_blocks("tx" if config == "tx" else
                         "channelizer" if config == "channelizer" else spec,
                         n_ch, n_blocks, seed=0, k=channelizer_k, device=dev)
    return (lambda p, s, b: run_blocks(chain, p, s, b), params,
            chain.init_state((n_ch,)), blocks)


def checked_dispatch(fn, params, state, blocks):
    """The timed dispatch, after checking on the card that one replay
    from `state` gives the eager loop's checksum bit for bit.  Returns
    (dispatch, the eager checksum, whether they were equal: None on the
    CPU, where the dispatch is the eager loop)."""
    from t41x_torch.runner import _clone

    _, e_eager = fn(params, _clone(state), blocks)
    d = dispatch(fn, params, state, blocks)
    equal = None
    if d.graphed:
        d.replay()
        equal = bool(torch.equal(d.acc, e_eager))
        if not equal:
            raise RuntimeError(f"graphed checksum {d.acc.item()!r} != eager "
                               f"{e_eager.item()!r}")
        d.acc.zero_()
    return d, float(e_eager.item()), equal


def measure(config: str, spec, n_ch: int, args, dev, floor_s: float) -> dict:
    fn, params, state, blocks = build(config, spec, n_ch, args.blocks, dev,
                                      args.channelizer_k)
    d, e_eager, equal = checked_dispatch(fn, params, state, blocks)
    repeats = calibrate(d, floor_s, args.min_ms)
    t = timed(d, repeats, args.reps)
    lin_ratio = None
    if not args.no_linearity:
        lin_ratio = linearity(d, repeats, max(3, args.reps))
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            timed(d, repeats, 1)
        prof.export_chrome_trace(f"{args.profile}/bench_{config}_{n_ch}.json")

    if d.graphed:   # the same loop without the graph, from the live state
        from t41x_torch.runner import _clone

        eager = Eager(fn, params, _clone(d.state), blocks)
        eager.replay()
        t_eager = timed(eager, repeats, max(1, args.reps - 1))
    else:
        t_eager = t
    samples = repeats * args.blocks * n_ch * C.BLOCK_SIZE
    out = {"rate": samples / t, "eager_rate": samples / t_eager,
           "time_s": t, "eager_time_s": t_eager, "repeats": repeats,
           "blocks": args.blocks, "channels": n_ch,
           "linearity_2x": (round(lin_ratio, 3) if lin_ratio is not None
                            else None),
           "dispatch_floor_us": round(floor_s * 1e6, 1),
           "checksum": e_eager, "checksum_graph_equals_eager": equal,
           "graphed": d.graphed}
    print(f"# {config} channels={n_ch}: {out['rate'] / 1e6:.1f} Msamples/s "
          f"({out['rate'] / BASELINE_RATE:.0f} real-time channels; eager "
          f"{out['eager_rate'] / 1e6:.1f}), t={t * 1e3:.1f} ms over "
          f"{repeats}x{args.blocks} blocks, 2x-work time ratio="
          f"{out['linearity_2x']} ({device_name(dev)})", file=sys.stderr)
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=0,
                    help="0 = try 1024 and 4096, keep the best")
    ap.add_argument("--blocks", type=int, default=8,
                    help="blocks a dispatch (the buffer size)")
    ap.add_argument("--min-ms", type=float, default=500.0,
                    help="scale the replays until the timed region takes "
                         "at least this long")
    ap.add_argument("--mode", default="usb")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--interpolate", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="use the CUDA kernels")
    ap.add_argument("--spectrum", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="emit audio-spectrum + S-meter taps")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace to this directory")
    ap.add_argument("--q15", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="ingest ADC q15 int16 (i, q) pairs")
    ap.add_argument("--no-linearity", action="store_true", default=False)
    ap.add_argument("--channelizer-k", type=int, default=16,
                    help="channelizer bank size K (--config channelizer)")
    ap.add_argument("--check", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="before timing, hold the exact timed spec with "
                         "kernels against the plain versions on the same "
                         "device and record the parity in the JSON")
    ap.add_argument("--config", default="rx", choices=list(CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions, eager)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; print and return its JSON line's object."""
    args = parse(argv)
    dev = require_device(args.device, "bench")
    from t41x_torch.chain import ChainSpec

    spec = None
    if args.config != "tx":
        spec = ChainSpec(spectrum_taps=args.spectrum,
                         use_matmul_osfilter=True,
                         use_kernels=args.kernels,
                         interpolate_out=args.interpolate,
                         q15_input=args.q15 and args.config != "channelizer",
                         **cfg_map(args.mode)[args.config])

    floor_s = dispatch_floor(dev)
    print(f"# dispatch floor: {floor_s * 1e6:.0f} us", file=sys.stderr)
    parity = None
    if args.check and spec is not None and spec.use_kernels:
        parity = parity_check(spec, dev)

    best = None
    for n_ch in [args.channels] if args.channels else [1024, 4096]:
        try:
            m = measure(args.config, spec, n_ch, args, dev, floor_s)
        except torch.OutOfMemoryError as e:
            print(f"# channels={n_ch} failed: {e}", file=sys.stderr)
            continue
        if best is None or m["rate"] > best["rate"]:
            best = m
    if best is None:
        print(json.dumps({"metric": "bench_failed", "value": 0, "unit": "",
                          "vs_baseline": 0}))
        raise SystemExit(1)

    cfg = {
        "mode": spec.mode if spec else "tx_ssb",
        "bench": args.config,
        "q15": spec.q15_input if spec else False,
        "kernels": args.kernels, "spectrum_taps": args.spectrum,
        "interpolate_out": args.interpolate,
        "zoom": spec.spectrum_zoom if spec else None,
        "channels": best["channels"],
        "blocks": best["blocks"], "repeats": best["repeats"],
        "timed_step_ms": round(best["time_s"] * 1e3, 2),
        "linearity_2x_time_ratio": best["linearity_2x"],
        "dispatch_floor_us": best["dispatch_floor_us"],
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": device_name(dev),
        "power_limit_w": power_limit_w(dev),
        "graphed": best["graphed"],
        "eager_rate": round(best["eager_rate"], 1),
        "checksum": best["checksum"],
        "checksum_graph_equals_eager": best["checksum_graph_equals_eager"],
    }
    if parity is not None:
        cfg["parity_db"] = parity
    tx = args.config == "tx"
    result = {
        "metric": ("mic_samples_per_sec_per_chip_full_tx_chain" if tx else
                   f"iq_samples_per_sec_per_chip_full_{args.config}_chain"),
        "value": round(best["rate"], 1),
        "unit": "real samples/s" if tx else "complex samples/s",
        "vs_baseline": round(best["rate"] / BASELINE_RATE, 2),
        "config": cfg,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
