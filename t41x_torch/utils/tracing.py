"""The port's tracer: chain stages mapped onto CUDA-graph replays, graph
launches as spans, and set-up spans.

**Stages.**  `RxChain.block` marks its stages with `stage(name)` where
their work is launched; a device op belongs to the innermost open
stage, in this order along a block:

    frontend (rf_tap inside it), bandpass, agc, demod, smeter, eq, nr,
    notch, nb, cw, interp

and `runner.capture` adds `writeback` (its clones and state copy-back).
Ops launched with no stage open belong to `unstaged`.  A mark does one
of three things:

* tracing off and no capture running: nothing but a flag check;
* the profiler on (`torch.profiler`): a `record_function` range
  `rx.<stage>`, so an eager run's trace shows its stages directly (the
  profiler mirrors each range onto the device: leave those out of the
  ops given to `attribute`);
* inside `capturing()` (which `runner.capture` always enters): it reads
  how many device-op nodes (kernel, memcpy, memset) the capturing
  stream's graph holds so far (`csrc/graph_map.cu`), adding no node.

Each capture leaves a `StageMap` in a bounded registry (`maps()`):
plain data that outlives its graph.  `attribute(ops)` cuts the device
ops of a trace into replays by the maps' op counts and sums each
stage's device time.

**Launches.**  `runner.capture` returns a `Graph`, whose `replay()` is
the program's launch span: with the profiler off one flag check, with
it on the launch's `perf_counter_ns` bounds in a bounded record
(`launches()`).  No `record_function` range: the profiler mirrors a
range onto the device as an op spanning the kernels launched inside it,
which a reader that sums device ops would count twice.
`launch_idle(ops, w0, w1)` places the spans on the trace's clock by
anchoring launch k to the first device op of replay k (`anchor`).

**Set-up.**  `setup_span(name)` times `kernel_load` (the kernel
library's build or load), `design` (`RxChain.__init__`) and `capture`
(`runner.capture`: warm-up run and capture), each without the spans
nested in it (`setup_seconds()`).

The registries are the process's, like the profiler's own state, and
meant for one thread: the one that captures and replays.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import time
from typing import NamedTuple

from torch.autograd import profiler as _prof

UNSTAGED = "unstaged"
KINDS = "kcs"          # a device-op node: kernel, memcpy, memset
MAX_MAPS = 8           # stage maps kept, the newest last
LAUNCH_RECORD = 1 << 16  # launch spans kept, the newest last


class StageMap(NamedTuple):
    """One captured graph: `segments` ((stage, device ops), ...) in launch
    order, summing to `nodes`, its device-op nodes; `chain` whether the
    graph is one chain of nodes (else its replays are not attributed);
    `kinds` one letter of `KINDS` a device-op node along the chain."""
    segments: tuple
    nodes: int
    chain: bool
    kinds: str

    def stage_of_op(self) -> list:
        """The stage of each device op of a replay, in order."""
        return [st for st, n in self.segments for _ in range(n)]


_maps: collections.deque = collections.deque(maxlen=MAX_MAPS)
_launches: collections.deque = collections.deque(maxlen=LAUNCH_RECORD)
_setup: dict = {}
_setup_open: list = []   # [start, seconds of nested spans] of open spans
_capture = None          # the _Capture in progress


def reset() -> None:
    """Empty every registry (and take up a changed `MAX_MAPS` or
    `LAUNCH_RECORD`)."""
    global _maps, _launches
    _maps = collections.deque(maxlen=MAX_MAPS)
    _launches = collections.deque(maxlen=LAUNCH_RECORD)
    _setup.clear()


def maps() -> list:
    return list(_maps)


def launches() -> list:
    return list(_launches)


def setup_seconds() -> dict:
    return dict(_setup)


# ---------------------------------------------------------------- stages
_OFF = contextlib.nullcontext()


class _Stage:
    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def __enter__(self):
        if _prof._is_profiler_enabled:
            self.rf = _prof.record_function("rx." + self.name)
            self.rf.__enter__()
        if _capture is not None:
            _capture.enter(self.name)

    def __exit__(self, *exc):
        if _capture is not None:
            _capture.exit()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def stage(name: str):
    """Mark the work launched inside the `with` block as stage `name`."""
    if _capture is None and not _prof._is_profiler_enabled:
        return _OFF
    return _Stage(name)


class _Capture:
    """The stage boundaries of one capture: (device ops so far, the stage
    open from there on)."""

    def __init__(self, count):
        self.count, self.open, self.marks = count, [], [(0, UNSTAGED)]

    def enter(self, name: str) -> None:
        self.open.append(name)
        self.marks.append((self.count(), name))

    def exit(self) -> None:
        self.open.pop()
        self.marks.append((self.count(),
                           self.open[-1] if self.open else UNSTAGED))

    def segments(self, total: int) -> tuple:
        segs = []
        bounds = self.marks + [(total, None)]
        for (a, st), (b, _) in zip(bounds, bounds[1:]):
            if b == a:
                continue
            if segs and segs[-1][0] == st:
                segs[-1] = (st, segs[-1][1] + b - a)
            else:
                segs.append((st, b - a))
        return tuple(segs)


def _capture_nodes_fn():
    """The kernel library's `t41x_capture_nodes`, typed."""
    from t41x_torch.kernels import _build
    fn = _build.library().t41x_capture_nodes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class _Nodes:
    """The device-op nodes of the graph `stream` is capturing into, read
    by `fn`, the kernel library's `t41x_capture_nodes`."""

    def __init__(self, fn, stream: int):
        self.fn, self.stream = fn, stream

    def _read(self, kinds=None, cap: int = 0):
        out = (ctypes.c_longlong * 4)()
        rc = self.fn(out, kinds, cap, self.stream)
        if rc != 0:
            raise RuntimeError(f"t41x_capture_nodes: CUDA error {rc}")
        if out[0] != 1:
            raise RuntimeError("tracing: the stream is not capturing")
        return out

    def count(self) -> int:
        return self._read()[1]

    def final(self) -> tuple:
        """(device-op nodes, one chain?, their kinds along it)."""
        n = self.count()
        kinds = (ctypes.c_int * max(n, 1))()
        out = self._read(kinds, n)
        chain = bool(out[3])
        return (out[1], chain,
                "".join(KINDS[k] for k in kinds[:out[1]]) if chain else "")


class capturing:
    """Record the stage map of the capture in progress on `device`'s
    current stream; the map goes to the registry.  Make it before the
    capture begins (it loads the kernel library), enter it inside
    `torch.cuda.graph` and leave it before the capture ends.  `nodes`
    stands in for the graph's reader (an object with `count()` and
    `final()`, as `_Nodes`), for tests without a card."""

    def __init__(self, device=None, nodes=None):
        self.device, self.nodes = device, nodes
        self.fn = _capture_nodes_fn() if nodes is None else None

    def __enter__(self):
        global _capture
        if _capture is not None:
            raise RuntimeError("tracing: a capture is already recording")
        if self.fn is not None:
            import torch
            self.nodes = _Nodes(self.fn, torch.cuda.current_stream(
                self.device).cuda_stream)
        _capture = _Capture(self.nodes.count)
        return self

    def __exit__(self, exc_type, *exc):
        global _capture
        cap, _capture = _capture, None
        if exc_type is None:
            total, chain, kinds = self.nodes.final()
            _register(StageMap(cap.segments(total), total, chain, kinds))
        return False


def _register(m: StageMap) -> None:
    """Add `m`, newest last; an equal map already there moves to the
    end (a ring of identical graphs leaves one)."""
    if m in _maps:
        _maps.remove(m)
    _maps.append(m)


# -------------------------------------------------------------- launches
class Graph:
    """A captured `torch.cuda.CUDAGraph` whose `replay()` is the program's
    launch span."""

    __slots__ = ("graph",)

    def __init__(self, graph):
        self.graph = graph

    def replay(self) -> None:
        if not _prof._is_profiler_enabled:
            self.graph.replay()
            return
        t0 = time.perf_counter_ns()
        self.graph.replay()
        _launches.append((t0, time.perf_counter_ns()))


# ----------------------------------------------------------------- set-up
class setup_span(contextlib.ContextDecorator):
    """Time a piece of set-up as `name` (a `with` block or a decorator),
    less the set-up spans nested in it."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _setup_open.append([time.perf_counter(), 0.0])

    def __exit__(self, *exc):
        t0, inner = _setup_open.pop()
        dt = time.perf_counter() - t0
        _setup[self.name] = _setup.get(self.name, 0.0) + dt - inner
        if _setup_open:
            _setup_open[-1][1] += dt
        return False


# --------------------------------------------------------- reading traces
def _kind(name: str) -> str:
    low = name.lower()
    return "c" if "memcpy" in low else "s" if "memset" in low else "k"


def attribute(ops: list, stage_maps: list | None = None) -> dict:
    """Device time by stage in a trace.

    `ops`: the trace's device ops as (name, start_us, end_us), in start
    order; `stage_maps`: the maps to cut by (the registry's by default).
    For each map, the first whole replay is the first run of the map's
    op count whose kinds (kernel, memcpy, memset by name) follow the
    map's; it is the template, and from there a replay is a run of ops
    equal to a template name for name.  Every other op (clipped edge
    replays, foreign ops between replays) is unattributed.  Maps that
    are not one chain cut nothing.

    Returns dict(stages = {stage: device seconds}, replays = replays
    matched, spans = [(first op's start, last op's end) µs of each],
    attributed_s, unattributed_s)."""
    stage_maps = list(_maps) if stage_maps is None else stage_maps
    names = [o[0] for o in ops]
    kinds = "".join(map(_kind, names))
    templates = []
    for m in stage_maps:
        if not (m.chain and m.nodes and len(m.kinds) == m.nodes):
            continue
        i = kinds.find(m.kinds)
        if i >= 0:
            templates.append((i, names[i:i + m.nodes], m.stage_of_op()))
    stages, spans, attributed = {}, [], 0.0
    p = min((i for i, _, _ in templates), default=len(ops))
    while p < len(ops):
        for _, tmpl, per_op in templates:
            n = len(tmpl)
            if names[p:p + n] == tmpl:
                for (_, s, t), st in zip(ops[p:p + n], per_op):
                    stages[st] = stages.get(st, 0.0) + (t - s) * 1e-6
                    attributed += (t - s) * 1e-6
                spans.append((ops[p][1], ops[p + n - 1][2]))
                p += n
                break
        else:
            p += 1
    total = sum(t - s for _, s, t in ops) * 1e-6
    return dict(stages=stages, replays=len(spans), spans=spans,
                attributed_s=attributed, unattributed_s=total - attributed)


def anchor(launch_spans: list, replay_spans: list):
    """Place host launch spans on the trace's clock: launch k submits
    replay k, whose first op starts only once the launch call has
    returned (under `torch.profiler` on an H100 a graph launch's host
    call ranged 125-917 µs while its replay's first op followed the
    call's end within ~20 µs), so the offset is the smallest (first op -
    launch end) over the replays.  Returns (offset_us, residual_us), or
    None where the counts differ (a launch whose replay was clipped or
    lost).  The residual is the median, over the replays whose launch
    found the card idle (the replay before it done by the launch's
    anchored end), of how far the first op lies after that end: near
    zero when one offset fits them all."""
    if not launch_spans or len(launch_spans) != len(replay_spans):
        return None
    lag = [f - b * 1e-3 for (_, b), (f, _) in zip(launch_spans,
                                                   replay_spans)]
    off = min(lag)
    idle = sorted(d - off for k, d in enumerate(lag)
                  if k == 0 or replay_spans[k - 1][1]
                  <= launch_spans[k][1] * 1e-3 + off)
    return off, idle[len(idle) // 2]


def _merged(spans) -> list:
    out = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        elif t > s:
            out.append([s, t])
    return out


def launch_idle(ops: list, w0: float, w1: float,
                stage_maps: list | None = None,
                launch_spans: list | None = None):
    """The card's idle time inside launch spans in the window [w0, w1]
    (µs, the trace's clock): the launch spans (the record's by default)
    anchored by `anchor` to the replays `attribute` finds.  Returns
    dict(idle_in_launch = share of the window with no device op while a
    launch span was open, offset_us, residual_us, launches) or None
    where the spans cannot be anchored."""
    launch_spans = list(_launches) if launch_spans is None else launch_spans
    a = anchor(launch_spans, attribute(ops, stage_maps)["spans"])
    if a is None or w1 <= w0:
        return None
    off, residual = a
    spans = _merged((max(w0, s * 1e-3 + off), min(w1, t * 1e-3 + off))
                    for s, t in launch_spans)
    busy = _merged((s, t) for _, s, t in ops)
    inside, j = 0.0, 0
    for s, t in spans:
        inside += t - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < t:
            inside -= min(t, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return dict(idle_in_launch=inside / (w1 - w0), offset_us=off,
                residual_us=residual, launches=len(launch_spans))
