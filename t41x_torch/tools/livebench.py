"""Live pacing with the device in the loop, port of `tools/livebench.py`.

The reference's one real-time metric is the load on its processor
(`InfoBox.cpp:341-371`): mean block-processing time over the 10.667 ms
budget, with the audio queues absorbing jitter (`Process.cpp:93-153`).
This tool measures the same for the port on its device: a pacing thread
pushes channel-batched I/Q blocks into the ring at rate_factor x real
time (the acquisition interrupt's analogue), and the runner drains it
with `StreamRunner.step_batch`, batch_blocks blocks a call (one CUDA
graph replay on the card).

It reports the load %, dispatch-time percentiles, end-to-end latency
(a batch's first block pushed -> its audio on the host), the deepest
ring backlog and overruns.  `sustained` is `t41x`'s verdict: every pushed
block processed but for two batches' worth, and no overrun (it sets no
latency bound).

    python -m t41x_torch.tools.livebench --channels 64 --batch-blocks 8
        --seconds 10 [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--batch-blocks", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate-factor", type=float, default=1.0)
    ap.add_argument("--mode", default="usb")
    ap.add_argument("--zoom", type=int, default=1,
                    help="spectrum zoom (display tap on, like the "
                         "reference's always-on panadapter)")
    ap.add_argument("--ring-capacity", type=int, default=192,
                    help="ring depth in blocks (absorbs dispatch jitter)")
    ap.add_argument("--device", default="cuda",
                    help="the radio's device (cpu: the plain versions, "
                         "eager)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from t41x_torch import constants as C
    from t41x_torch.io.runtime import BlockRing, LoadMeter
    from t41x_torch.radio import Radio
    from t41x_torch.runner import StreamRunner

    ch = (args.channels,) if args.channels > 1 else ()
    radio = Radio(device=args.device)
    radio.config.band.mode = args.mode
    radio.config.spectrum_zoom = args.zoom

    n_floats = 2 * C.BLOCK_SIZE * int(np.prod(ch, dtype=np.int64))
    ring = BlockRing(block_floats=n_floats, capacity=args.ring_capacity)
    runner = StreamRunner(radio, ring=ring, channels=ch,
                          batch_blocks=args.batch_blocks)
    t0 = time.perf_counter()
    runner.prime()
    prime_s = time.perf_counter() - t0
    print(f"# primed in {prime_s:.1f} s on {radio.device}", file=sys.stderr)

    # a short unique capture, cycled by the pacing thread
    rng = np.random.default_rng(0)
    n_uniq = 16
    shape = (n_uniq,) + ch + (C.BLOCK_SIZE,)
    cap = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
           * 0.1).astype(np.complex64)
    flat = [np.ascontiguousarray(cap[i]).view(np.float32).reshape(-1)
            for i in range(n_uniq)]

    # warm-up calls outside the paced window
    for i in range(2 * args.batch_blocks):
        runner.ring.push(flat[i % n_uniq])
    t0 = time.perf_counter()
    while runner.ring.available() >= args.batch_blocks:
        runner.step_batch()
    print(f"# warm-up calls in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    runner.load = LoadMeter(force_python=True)
    runner.blocks_processed = 0

    n_blocks = int(args.seconds / C.BLOCK_SECONDS)
    push_times: list[float] = []
    stop = threading.Event()

    def pace():
        nxt = time.monotonic()
        per = C.BLOCK_SECONDS / args.rate_factor
        for i in range(n_blocks):
            if stop.is_set():
                break
            nxt += per
            dt = nxt - time.monotonic()
            if dt > 0:
                time.sleep(dt)
            runner.ring.push(flat[i % n_uniq])
            push_times.append(time.perf_counter())

    th = threading.Thread(target=pace, daemon=True)
    start = time.perf_counter()
    th.start()

    dispatch_walls: list[float] = []
    depths: list[int] = []
    done_times: list[float] = []
    processed = 0
    deadline = start + args.seconds / args.rate_factor + 10.0
    while processed < n_blocks and time.perf_counter() < deadline:
        depths.append(runner.ring.available())
        t1 = time.perf_counter()
        r = runner.step_batch()
        if r is None:
            time.sleep(0.001)
            continue
        dispatch_walls.append(time.perf_counter() - t1)
        done_times.append(time.perf_counter())
        processed = runner.blocks_processed
    stop.set()
    th.join(timeout=5.0)

    # end-to-end latency: for each batch, audio-ready time minus the
    # arrival time of the batch's first block
    lat = [tdone - push_times[bi * args.batch_blocks]
           for bi, tdone in enumerate(done_times)
           if bi * args.batch_blocks < len(push_times)]
    walls = np.asarray(dispatch_walls) if dispatch_walls else np.asarray(
        [float("nan")])
    lat = np.asarray(lat) if lat else np.asarray([float("nan")])
    budget = args.batch_blocks * C.BLOCK_SECONDS
    result = {
        "device": (torch.cuda.get_device_name(radio.device)
                   if radio.device.type == "cuda" else "cpu"),
        "channels": args.channels,
        "batch_blocks": args.batch_blocks,
        "rate_factor": args.rate_factor,
        "mode": args.mode,
        "zoom": args.zoom,
        "graphs": runner.graphs,
        "blocks_pushed": len(push_times),
        "blocks_processed": processed,
        "ring_overruns": runner.ring.overruns,
        "load_percent": runner.load.percent,
        "dispatch_ms_p50": float(np.nanpercentile(walls, 50) * 1e3),
        "dispatch_ms_p95": float(np.nanpercentile(walls, 95) * 1e3),
        "dispatch_budget_ms": budget * 1e3,
        "latency_ms_p50": float(np.nanpercentile(lat, 50) * 1e3),
        "latency_ms_p95": float(np.nanpercentile(lat, 95) * 1e3),
        "max_ring_depth": int(max(depths, default=0)),
        "prime_s": prime_s,
        "realtime_iq_samples_per_sec": args.channels * C.SAMPLE_RATE,
        "sustained": (processed >= len(push_times) - 2 * args.batch_blocks
                      and runner.ring.overruns == 0),
    }
    print(f"load {result['load_percent']:.1f}%  dispatch p50 "
          f"{result['dispatch_ms_p50']:.1f} / budget {budget * 1e3:.1f} ms  "
          f"latency p50 {result['latency_ms_p50']:.0f} ms  "
          f"processed {processed}/{len(push_times)}  "
          f"overruns {result['ring_overruns']}  "
          f"sustained={result['sustained']}", file=sys.stderr)
    print("RESULT " + json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
