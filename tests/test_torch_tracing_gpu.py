"""The port's tracer on the card: stage maps of captured graphs against
the profiler.

Every case needs a CUDA card and skips without one; the file imports
nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_gpu.py

At 256 channels, for the benchmark's two chain specs (`ssb_pan`, with
the display taps, and `ssb_headless`), a graph of two blocks captured by
`runner.capture`:

* a replay's device ops, in the profiler's trace, are the map's nodes,
  in number and in kind (kernel, memcpy, memset), and `attribute` finds
  every replay whole; the launch spans anchor to them;
* the same two blocks run eagerly under the profiler launch as many
  device ops as the graph holds outside `writeback`, and each op gets
  the same stage from the graph's map as from the eager run's
  `rx.<stage>` ranges (the range open when its launch was called).
"""

import json
import time
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.runner import _clone, capture
from t41x_torch.utils import tracing

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parent.parent / "sdrbench" / "configs"
CHANNELS, BLOCKS, REPLAYS = 256, 2, 3
SPIN = "spin_kernel"   # torch.cuda._sleep, which takes the profiler's loss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tracing.reset()
    yield torch.device("cuda")
    tracing.reset()


def _dispatch(config: str, dev):
    """(fn, state, inputs): `BLOCKS` blocks of seeded q15 I/Q through the
    configuration's chain, the state carried."""
    spec = json.loads((CONFIGS / f"{config}.json").read_text())["chain"]
    chain = RxChain(ChainSpec(**spec), device=dev)
    params = default_params((CHANNELS,), device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    blocks = [tuple(torch.randint(-8000, 8000, (CHANNELS, 2048),
                                  dtype=torch.int16, device=dev, generator=g)
                    for _ in range(2)) for _ in range(BLOCKS)]

    def fn(st):
        outs = {}
        for b, blk in enumerate(blocks):
            st, o = chain.block(params, st, blk)
            outs.update({f"{k}.{b}": v for k, v in o.items()})
        return st, outs

    return fn, chain.init_state((CHANNELS,)), [t for b in blocks for t in b]


def _profiled(dev, work):
    """Run `work()` under the profiler after spin kernels that take the
    session's dropped first records; returns the profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        time.sleep(0.01)
        work()
        torch.cuda.synchronize(dev)
    return prof


def _device_ops(prof) -> list:
    """The device ops as FunctionEvents, in start order: not the spin
    kernels, nor the device mirrors of the `rx.<stage>` ranges."""
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and SPIN not in e.name and not e.name.startswith("rx.")]
    return sorted(ops, key=lambda e: e.time_range.start)


def _captured(config: str, dev):
    fn, state, inputs = _dispatch(config, dev)
    with torch.cuda.device(dev):
        graph, _ = capture(fn, state, inputs, dev)
    torch.cuda.synchronize(dev)
    m = tracing.maps()[-1]
    assert m.chain and m.nodes == len(m.kinds) == sum(n for _, n in
                                                      m.segments)
    return fn, state, graph, m


@pytest.mark.parametrize("config", ["ssb_pan", "ssb_headless"])
def test_replay_ops_are_the_maps_nodes(cuda, config):
    _, _, graph, m = _captured(config, cuda)
    graph.replay()    # the first launch uploads the graph

    def replays():
        for _ in range(REPLAYS):
            graph.replay()

    ops = _device_ops(_profiled(cuda, replays))
    assert len(ops) == REPLAYS * m.nodes, (len(ops), m.nodes)
    kinds = "".join(tracing._kind(e.name) for e in ops)
    assert kinds == m.kinds * REPLAYS
    trace = [(e.name, e.time_range.start, e.time_range.end) for e in ops]
    r = tracing.attribute(trace, [m])
    assert r["replays"] == REPLAYS and r["unattributed_s"] < 1e-12
    assert set(r["stages"]) == {st for st, _ in m.segments}
    assert r["attributed_s"] == pytest.approx(
        sum(t - s for _, s, t in trace) * 1e-6)
    launches = tracing.launches()
    assert len(launches) == REPLAYS
    w0, w1 = trace[0][1] - 100.0, trace[-1][2] + 100.0
    idle = tracing.launch_idle(trace, w0, w1, [m], launches)
    assert idle is not None and 0.0 <= idle["idle_in_launch"] < 1.0
    assert idle["residual_us"] >= 0.0


def _eager_stages(prof, ops) -> list:
    """The stage of each device op of an eager run: the innermost
    `rx.<stage>` range open when its launch was called (the runtime
    call of the same correlation id, or else the op it is linked to)."""
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    by_id = {e.id: e for e in cpu if not e.name.startswith("cu")}
    ranges = [e.time_range for e in cpu if e.name.startswith("rx.")]
    names = {(e.time_range.start, e.time_range.end): e.name[3:]
             for e in cpu if e.name.startswith("rx.")}
    out = []
    for op in ops:
        host = runtime.get(op.id) or by_id.get(
            getattr(op, "linked_correlation_id", -1))
        assert host is not None, op.name
        t = host.time_range.start
        inside = [r for r in ranges if r.start <= t <= r.end]
        inner = max(inside, key=lambda r: r.start, default=None)
        out.append(tracing.UNSTAGED if inner is None
                   else names[(inner.start, inner.end)])
    return out


@pytest.mark.parametrize("config", ["ssb_pan", "ssb_headless"])
def test_graph_map_agrees_with_the_eager_profile(cuda, config):
    fn, state, _, m = _captured(config, cuda)
    fn(_clone(state))    # eager warm-up: plans and handles made
    st = _clone(state)   # copied outside the profiled run
    torch.cuda.synchronize(cuda)
    prof = _profiled(cuda, lambda: fn(st))
    ops = _device_ops(prof)
    eager = _eager_stages(prof, ops)
    graph = [s for s in m.stage_of_op() if s != "writeback"]
    assert len(ops) == len(graph), (len(ops), len(graph))
    bad = [(i, op.name, e, g) for i, (op, e, g) in
           enumerate(zip(ops, eager, graph)) if e != g]
    assert not bad, bad[:10]
