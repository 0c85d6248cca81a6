"""Run one cell of the port's benchmark once and print its result line.

    python3 -m sdrbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds `BENCHMARK.json`, `sdrbench/` and
the port (`t41x_torch/`), on a machine with the CUDA cards the cell asks
for.  The cell's configuration, traffic mix and metrics are found by
name (`sdrbench.spec`).  A run:

1. set-up (`setup_s`, from process start to the first measured
   dispatch): makes the inputs and the channels' parameters on the card
   from the seed (`sdrbench.traffic`), builds or loads the kernels (the
   port's fixed build directory inside the checkout), designs the
   chain, captures its dispatches as CUDA graphs (`t41x_torch.runner.
   capture`) and replays each a few times; the first replay's outputs
   are kept for the check;
2. the window: a closed loop (`"loop": "closed"`: one graph of
   `blocks_per_dispatch` blocks over device-resident blocks, replayed
   with `IN_FLIGHT` dispatches outstanding, for `--seconds`) or an open
   loop (`"loop": "open"`: one block a dispatch, due every 2048 / 192 kHz
   from a ring of `resident_blocks` graphs, whatever the card does, the
   blocks due in `--seconds` drained at the end); the window's last
   `FOLLOWED` dispatches are kept for the check: the state carried into
   the first of them and each one's outputs, copied on the card's stream;
3. with `--trace 1` the window (at most the mix's `trace_seconds`) runs
   under `torch.profiler`, and the per-layer metrics are read from it;
   with `--trace 0` the end-to-end metrics are read from the window;
4. the check (`sdrbench.check`), once the window has closed, the peak
   memory read and the program freed: the plain reference of the
   configuration (`references/<name>.py`, float64) over the first pass
   and the window's last `FOLLOWED` dispatches.

It prints the compared numbers with their limits as its last lines on
standard error, and as its last line on standard output one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device`, (with a trace)
`breakdown`, then `card` and `checks`.  With no CUDA card, or fewer than
the cell asks for, it prints no result and exits 2; if JAX or the JAX
package was loaded, 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from sdrbench import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "t41x"}
BLOCK, RATE = 2048, 192_000.0
BUDGET_S = BLOCK / RATE
DRAIN_S = 60.0
POLL_S = 5e-5   # how often the open loop asks the card what completed
WARM_ROUNDS = 3  # replays of every dispatch after the first, in set-up
IN_FLIGHT = 2    # dispatches outstanding in a closed loop
FOLLOWED = 2     # the window's last dispatches the check follows: a state
#                  leaf not carried from one to the next shows in the second
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def log(msg: str) -> None:
    print(f"# {time.perf_counter() - T_START:8.2f} s  {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`t41x_torch` is not `t41x`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class _Event:
    """A CUDA event, or on the CPU (eager, synchronous) one that is done."""

    def __init__(self, cuda: bool):
        import torch
        self.ev = torch.cuda.Event() if cuda else None

    def record(self):
        if self.ev is not None:
            self.ev.record()

    def synchronize(self):
        if self.ev is not None:
            self.ev.synchronize()

    def query(self) -> bool:
        return self.ev is None or self.ev.query()


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Tail:
    """The window's last `FOLLOWED` dispatches, as the check needs them:
    the state carried into the first (copied before it) and the outputs
    of each (copied after it), all on the card's stream, in order."""

    def __init__(self, prog):
        self.prog, self.state, self.ds, self.outs = prog, None, [], []

    def around(self, d) -> None:
        if self.state is None:
            self.state = {k: v.clone()
                          for k, v in self.prog.state_leaves().items()}
        d.replay()
        self.ds.append(d)
        self.outs.append({k: v.clone() for k, v in d.out.items()})


def closed_loop(d, seconds: float, tail: Tail, dev) -> dict:
    """Replay `d` with `IN_FLIGHT` dispatches outstanding until `seconds`
    have passed, then `FOLLOWED` more through `tail`; the window runs from
    the first submission to the last completion."""
    cuda = dev.type == "cuda"
    pending, spans, acts = collections.deque(), [], []
    n, left = 0, None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        if left is None and time.perf_counter() >= t_end:
            left = FOLLOWED
        a = time.perf_counter()
        if left:
            tail.around(d)
        else:
            d.replay()
        b = time.perf_counter()
        ev = _Event(cuda)
        ev.record()
        pending.append(ev)
        spans.append(b - a)
        acts.append(("replay", a - t0, b - t0))
        n += 1
        if left:
            left -= 1
            if not left:
                break
        if len(pending) >= IN_FLIGHT:
            a = time.perf_counter()
            pending.popleft().synchronize()
            acts.append(("wait", a - t0, time.perf_counter() - t0))
    a = time.perf_counter()
    _sync(dev)
    t1 = time.perf_counter()
    acts.append(("drain", a - t0, t1 - t0))
    return dict(dispatches=n, window_s=t1 - t0, spans=spans, acts=acts)


def open_loop(ds: list, seconds: float, tail: Tail, dev) -> dict:
    """One block a dispatch, block i due at t0 + i budgets, replayed from
    the ring `ds` (block i on ds[i % len(ds)]) when due whatever the card
    does, the last `FOLLOWED` through `tail`; completions stamped when the
    host sees them, the blocks due in the window drained at its end."""
    cuda = dev.type == "cuda"
    n = max(FOLLOWED, int(seconds / BUDGET_S))
    lag, done = [math.nan] * n, [math.nan] * n
    pending, spans, acts = collections.deque(), [], []
    t0 = time.perf_counter() + 1e-3
    due = [t0 + i * BUDGET_S for i in range(n)]
    i, polled = 0, 0.0
    while i < n or pending:
        now = time.perf_counter()
        if now - polled >= POLL_S:   # a query a poll, not a query a spin
            polled = now
            while pending and pending[0][1].query():
                done[pending.popleft()[0]] = time.perf_counter()
        if i < n and now >= due[i]:
            a = time.perf_counter()
            d = ds[i % len(ds)]
            if i >= n - FOLLOWED:
                tail.around(d)
            else:
                d.replay()
            b = time.perf_counter()
            ev = _Event(cuda)
            ev.record()
            pending.append((i, ev))
            lag[i], i = a - due[i], i + 1
            spans.append(b - a)
            acts.append(("replay", a - t0, b - t0))
            continue
        if i >= n and now > due[-1] + BUDGET_S + DRAIN_S:
            break   # never completed: counted as failed
        # spin: a sleep's wake-up comes a fraction of a ms late
    t1 = max((x for x in done if not math.isnan(x)),
             default=time.perf_counter())
    acts.append(("poll", 0.0, t1 - t0))   # what the host does between
    return dict(dispatches=n, window_s=t1 - t0, spans=spans, acts=acts,
                lag_s=lag, latency_s=[d - u for d, u in zip(done, due)],
                missing=sum(math.isnan(x) for x in done))


def card() -> dict:
    """The card's name, power limit and SM clocks, as nvidia-smi reads
    them (for the record beside every number; the query of the port's
    `chip_smoke.py` `card_line` and `tools/bench.py` `power_limit_w`)."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"failed: {e}"}
    line = res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""
    return dict(zip(q.split(","), (v.strip() for v in line.split(","))))


def _reference(name: str):
    path = spec.HERE / "references" / f"{name}.py"
    s = importlib.util.spec_from_file_location(f"sdrbench_ref_{name}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _as_input(blk, q15: bool):
    import torch
    if q15:
        return blk
    i, q = blk
    return torch.complex(i.float(), q.float()) * (1.0 / 32768.0)


def judge(config: dict, dev, params: dict, first: dict, last: dict) -> tuple:
    """The check: the configuration's reference, in float64, over the
    first pass over the resident blocks and the window's last dispatches.
    `first` / `last`: dict(blocks = their (i, q) pairs, out = the
    program's outputs keyed `name.b`, and for `last` also state = the
    state carried into its first block and final = the state carried out
    of its last, as named leaves).  Returns (checks {name: (value,
    limit)}, blocks compared, blocks failed)."""
    import torch

    from sdrbench import check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = _reference(config["reference"]).Reference(
        config["chain"], dev, torch.float64)
    limits, compare = config["limits"], config["compare"]
    values, failed, compared = {}, 0, 0

    def blocks_of(d, st):
        outs = []
        for blk in d["blocks"]:
            st, o = ref.block(params, st, *blk)
            outs.append(o)
        return st, outs

    def take(rows):
        nonlocal failed, compared
        for row in rows:
            compared += 1
            failed += not check.passed(check.verdict(
                row, {k: limits[k] for k in row}))
            for k, v in row.items():
                values[k] = max(values.get(k, -math.inf), v)

    channels = int(next(iter(params.values())).shape[0])
    _, outs = blocks_of(first, ref.init_state(channels))
    take(check.outputs(compare, first["out"], outs))
    st, outs = blocks_of(last, ref.state_from(last["state"]))
    take(check.outputs(compare, last["out"], outs))
    sv = check.state(last["final"], st, ref.DECISIONS, ref.COMPLEX,
                     ref.ANGLES)
    log("state: " + " ".join(f"{k} {v:.3g}"
                             for k, v in sorted(sv["leaves"].items())))
    log(f"state: worst {sv['worst_leaf']} {sv['state']:.3g}")
    log("decisions, share of channels differing: " + " ".join(
        f"{k} {check.share_differing(last['final'][k], st[k]):.4g}"
        for k in sorted(ref.DECISIONS)))
    values["state"] = sv["state"]
    # the carried state is the last dispatch's product too
    if not sv["state"] <= limits["state"]:
        failed += len(last["blocks"])
    return check.verdict(values, limits), compared, failed


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        t_start: float = T_START) -> dict:
    """One run of `workload`; returns the result line's object.  `device`
    and `overrides` (keys of the traffic mix) serve the CPU tests."""
    import torch

    from sdrbench import check
    from sdrbench import trace as tr
    from sdrbench import traffic as gen
    from sdrbench.program import Program

    cell = spec.Cell(workload)
    mix = {**cell.traffic, **(overrides or {})}
    dev = torch.device(device)
    q15 = bool(cell.config["chain"].get("q15_input", False))
    channels, per = int(mix["channels"]), int(mix["blocks_per_dispatch"])
    resident = int(mix["resident_blocks"])
    i16, q16, params = gen.make(mix["signal"], channels, resident, seed, dev)
    pairs = [(i16[r], q16[r]) for r in range(resident)]
    _sync(dev)
    log(f"inputs: {resident} blocks x {channels} channels")
    prog = Program(cell.config["chain"], channels, params, dev)
    groups = [pairs[r:r + per] for r in range(0, resident, per)]
    ds = [prog.dispatch([_as_input(b, q15) for b in g]) for g in groups]
    _sync(dev)
    log(f"chain designed and {len(ds)} dispatch(es) captured")

    # warm-up: every dispatch replayed; the outputs of the first pass over
    # the resident blocks kept, block b of it as `name.b`
    first = dict(blocks=pairs, out={})
    for g, d in enumerate(ds):
        d.replay()
        for k, v in d.out.items():
            name, b = k.rsplit(".", 1)
            first["out"][f"{name}.{g * per + int(b)}"] = v.clone()
    for _ in range(WARM_ROUNDS):
        for d in ds:
            d.replay()
    _sync(dev)
    tail = Tail(prog)
    window_s = min(seconds, float(mix["trace_seconds"])) if trace else seconds
    setup_s = time.perf_counter() - t_start
    log(f"warm; set-up {setup_s:.3f} s; window {window_s} s")
    gc.collect()
    gc.disable()   # no collector pause inside the window
    with (tr.session(dev) if trace else contextlib.nullcontext([])) as found:
        with (tr.window() if trace else contextlib.nullcontext()):
            if mix["loop"] == "closed":
                w = closed_loop(ds[0], window_s, tail, dev)
                blocks = w["dispatches"] * per
            else:
                w = open_loop(ds, window_s, tail, dev)
                blocks = w["dispatches"]
    gc.enable()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    last = dict(blocks=[], state=tail.state, out={},
                final={k: v.clone() for k, v in prog.state_leaves().items()})
    for d, out in zip(tail.ds, tail.outs):
        b0 = len(last["blocks"])
        for k, v in out.items():
            name, b = k.rsplit(".", 1)
            last["out"][f"{name}.{b0 + int(b)}"] = v
        last["blocks"] += groups[ds.index(d)]
    del prog, ds, tail
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log(f"window closed: {w['dispatches']} dispatches in "
        f"{w['window_s']:.4f} s; peak {peak / 2**30:.2f} GiB")
    checks, compared, failed = judge(cell.config, dev, params, first, last)
    log(f"checked {compared} blocks against the reference")
    failed += w.get("missing", 0)
    # what a metric's reader reads: the window's record holds `dispatches`,
    # `window_s`, `spans` (host seconds of each replay's launch) and in an
    # open loop `lag_s` and `latency_s` a block; `trace` is the `Trace`
    ctx = types.SimpleNamespace(cell=cell, mix=mix, setup_s=setup_s,
                                blocks=blocks, channels=channels, window=w,
                                trace=found[0] if trace else None)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": failed == 0 and check.passed(checks),
        "attempted": blocks, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        t = found[0]
        result["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = breakdown(t, w["acts"])
    result["compared_blocks"] = compared
    result["card"] = card() if dev.type == "cuda" else {}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def breakdown(t, acts: list) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing (the harness's own spans)."""
    def doing(us):
        rel = (us - t.w0) * 1e-6
        for name, a, b in acts:
            if a <= rel <= b:
                return name
        return "harness"
    gaps = t.gaps()[:10]
    return {"device_ops": [[n, s] for n, s in t.by_name()[:10]],
            "idle_gaps": [[f"host {doing(g)} at {(g - t.w0) * 1e-6:.6f} s",
                           s] for g, s in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(spec.ROOT / ".sdrbench_cache" / sub)
    cell = spec.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sdrbench: the cell needs {cell.chips} CUDA card(s); {seen} "
              "visible", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"sdrbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
