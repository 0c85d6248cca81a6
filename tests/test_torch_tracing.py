"""The port's tracer (`t41x_torch.utils.tracing`) on the CPU: stage maps
cut synthetic device-op streams into replays, launch spans anchored to a
trace's clock, the chain's `rx.<stage>` ranges under the profiler, the
launch span's record and the set-up spans.  The card's side (the graph's
node counts against an eager profile) is `test_torch_tracing_gpu.py`."""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.utils import tracing

CONFIGS = Path(__file__).resolve().parent.parent / "sdrbench" / "configs"


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


# a graph of two blocks: per block frontend 2 ops, bandpass 3 (one a
# memset), then writeback's 2 copies
MAP = tracing.StageMap(
    segments=(("frontend", 2), ("bandpass", 3), ("frontend", 2),
              ("bandpass", 3), ("writeback", 2)),
    nodes=12, chain=True, kinds="kkksk" "kkksk" "cc")
NAMES = ["fe_kernel", "zoom_kernel", "gemm_tn", "Memset (Device)", "mask_sq",
         "fe_kernel", "zoom_kernel", "gemm_tn", "Memset (Device)", "mask_sq",
         "Memcpy DtoD (Device -> Device)", "Memcpy DtoD (Device -> Device)"]
DUR = [3.0, 1.0, 7.0, 0.5, 2.0, 3.0, 1.0, 7.0, 0.5, 2.0, 0.25, 0.25]
PER_REPLAY = {"frontend": 8.0e-6, "bandpass": 19.0e-6, "writeback": 0.5e-6}


def stream(replays: int, t0: float = 100.0, foreign=(), gap: float = 1.0):
    """`replays` replays of MAP back to back (`gap` µs between ops), each
    followed by the `foreign` ops named; returns (ops, their spans)."""
    ops, spans, t = [], [], t0
    for _ in range(replays):
        first = t
        for name, d in zip(NAMES, DUR):
            ops.append((name, t, t + d))
            t += d + gap
        spans.append((first, t - gap))
        for name in foreign:
            ops.append((name, t, t + 4.0))
            t += 4.0 + gap
    return ops, spans


def approx(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-15), k


def test_attribute_whole_replays():
    ops, spans = stream(3)
    r = tracing.attribute(ops, [MAP])
    assert r["replays"] == 3 and r["spans"] == spans
    approx(r["stages"], {k: 3 * v for k, v in PER_REPLAY.items()})
    assert r["unattributed_s"] == pytest.approx(0.0, abs=1e-15)


@pytest.mark.parametrize("edge", ["start", "end", "both"])
def test_attribute_clipped_edges(edge):
    """A replay cut by the window's start (its first ops lost, its first
    kept op clipped) or end (its last ops lost) goes unattributed."""
    ops, _ = stream(4)
    n, clipped = len(NAMES), 0.0
    if edge in ("start", "both"):
        name, s, t = ops[n - 7]
        ops = [(name, s + 0.5, t)] + ops[n - 6:]
        clipped += sum(t - s for _, s, t in ops[:7])
    if edge in ("end", "both"):
        clipped += sum(t - s for _, s, t in ops[-n:-n + 5])
        ops = ops[:-n + 5]
    whole = 4 - (edge == "both") - 1
    r = tracing.attribute(ops, [MAP])
    assert r["replays"] == whole
    approx(r["stages"], {k: whole * v for k, v in PER_REPLAY.items()})
    assert r["unattributed_s"] == pytest.approx(clipped * 1e-6, rel=1e-12)


def test_attribute_foreign_ops_between_replays():
    """Copies the caller makes between replays (a harness's state and
    output clones) are not the graph's: unattributed."""
    foreign = ("Memcpy DtoD (Device -> Device)", "elementwise_kernel")
    ops, spans = stream(3, foreign=foreign)
    r = tracing.attribute(ops, [MAP])
    assert r["replays"] == 3 and r["spans"] == spans
    approx(r["stages"], {k: 3 * v for k, v in PER_REPLAY.items()})
    assert r["unattributed_s"] == pytest.approx(3 * 2 * 4.0e-6, rel=1e-12)


def test_attribute_reports_nothing_for_a_map_that_is_not_a_chain():
    ops, _ = stream(2)
    r = tracing.attribute(ops, [MAP._replace(chain=False, kinds="")])
    assert r["stages"] == {} and r["replays"] == 0 and r["spans"] == []
    assert r["unattributed_s"] == pytest.approx(2 * sum(DUR) * 1e-6)


def test_attribute_empty():
    r = tracing.attribute([], [MAP])
    assert r["stages"] == {} and r["replays"] == 0
    assert tracing.attribute(stream(1)[0], [])["replays"] == 0


def test_anchor_and_idle_in_launch():
    """Launch spans of 50 µs on a host clock 7 s behind the trace's: a
    replay's first op starts 3 µs after its launch call returned when
    the card is idle; replay 1 is launched while replay 0 runs and waits
    for it.  The idle time inside launch spans is known exactly."""
    ops, spans = stream(3, t0=1000.0, gap=0.0)   # replays of 27.5 µs
    n = len(NAMES)
    ops = ops[:2 * n] + [(nm, s + 148.0, t + 148.0) for nm, s, t in
                         ops[2 * n:]]
    spans = tracing.attribute(ops, [MAP])["spans"]
    assert spans == [(1000.0, 1027.5), (1027.5, 1055.0), (1203.0, 1230.5)]
    starts = [947.0, 960.0, 1150.0]              # on the trace's clock
    launch = [(round((a - 7e6) * 1e3), round((a + 50.0 - 7e6) * 1e3))
              for a in starts]
    off, residual = tracing.anchor(launch, spans)
    assert off == pytest.approx(7e6 + 3.0)       # trace µs - host µs
    # replays 0 and 2 found the card idle, both 3 µs after their launch
    assert residual == pytest.approx(0.0, abs=1e-6)
    r = tracing.launch_idle(ops, 900.0, 1400.0, [MAP], launch)
    # anchored spans [950, 1000], [963, 1013], [1153, 1203]; busy
    # [1000, 1055] and [1203, 1230.5]: idle inside 50 + 50 µs
    assert r["idle_in_launch"] == pytest.approx(100.0 / 500.0)
    assert r["offset_us"] == pytest.approx(7e6 + 3.0)
    assert r["residual_us"] == pytest.approx(0.0, abs=1e-6)
    assert r["launches"] == 3
    # one more µs of lag on replay 2: the residual is the median of 0, 1
    late = launch[:2] + [(launch[2][0] - 1000, launch[2][1] - 1000)]
    assert tracing.anchor(late, spans)[1] == pytest.approx(1.0, abs=1e-6)
    # a launch whose replay was not found: no anchor, no number
    assert tracing.anchor(launch[:2], spans) is None
    assert tracing.launch_idle(ops, 900.0, 1400.0, [MAP], launch[1:]) is None
    assert tracing.launch_idle(ops, 900.0, 1400.0, [], launch) is None


class FakeNodes:
    """Stands in for the graph's node reader: `launch(n)` adds n device
    ops to the 'graph'."""

    def __init__(self, chain=True):
        self.n, self.kinds, self.chain = 0, "", chain

    def launch(self, kinds: str):
        self.n += len(kinds)
        self.kinds += kinds

    def count(self):
        return self.n

    def final(self):
        return self.n, self.chain, self.kinds if self.chain else ""


def _capture_stages(nodes):
    with tracing.capturing(nodes=nodes):
        nodes.launch("k")                    # before any stage
        with tracing.stage("frontend"):
            nodes.launch("kk")
            with tracing.stage("rf_tap"):
                nodes.launch("kck")
            nodes.launch("k")
            with tracing.stage("rf_tap"):
                pass                         # no op: no segment
        with tracing.stage("bandpass"):
            nodes.launch("ks")
        with tracing.stage("writeback"):
            nodes.launch("cc")


def test_capture_map_innermost_stage_and_registry():
    _capture_stages(FakeNodes())
    m, = tracing.maps()
    assert m == tracing.StageMap(
        (("unstaged", 1), ("frontend", 2), ("rf_tap", 3), ("frontend", 1),
         ("bandpass", 2), ("writeback", 2)), 11, True, "kkkkckkkscc")
    assert m.stage_of_op()[:4] == ["unstaged", "frontend", "frontend",
                                   "rf_tap"]
    # the same graph again (a ring of equal dispatches) leaves one map;
    # a failed capture leaves none; the registry is bounded
    with tracing.capturing(nodes=FakeNodes()) as c:
        c.nodes.launch("k")
    _capture_stages(FakeNodes())
    assert tracing.maps()[-1] == m and len(tracing.maps()) == 2
    with pytest.raises(ValueError), tracing.capturing(nodes=FakeNodes()):
        raise ValueError
    assert len(tracing.maps()) == 2 and tracing._capture is None
    for n in range(tracing.MAX_MAPS + 3):
        with tracing.capturing(nodes=FakeNodes()) as c:
            c.nodes.launch("k" * (n + 2))
    assert len(tracing.maps()) == tracing.MAX_MAPS
    assert tracing.maps()[-1].nodes == tracing.MAX_MAPS + 4
    with tracing.capturing(nodes=FakeNodes(chain=False)) as c:
        c.nodes.launch("kk")
    assert not tracing.maps()[-1].chain


def _chain(config: str):
    chain = json.loads((CONFIGS / f"{config}.json").read_text())["chain"]
    return RxChain(ChainSpec(**chain), device="cpu")


def _block_inputs(ch: int = 4):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.randint(-3000, 3000, (ch, 2048), dtype=torch.int16,
                               generator=g) for _ in range(2))


@pytest.mark.parametrize("config, order", [
    ("ssb_pan", ["frontend", "rf_tap", "bandpass", "agc", "demod", "smeter",
                 "interp"]),
    ("ssb_headless", ["frontend", "bandpass", "agc", "demod", "interp"]),
])
def test_block_emits_stage_ranges_under_the_profiler(config, order):
    chain = _chain(config)
    params = default_params((4,), device="cpu")
    state = chain.init_state((4,))
    iq = _block_inputs()
    before = tracing.setup_seconds()
    # profiler off: a mark is the shared no-op, and nothing is recorded
    assert tracing.stage("frontend") is tracing._OFF
    state, _ = chain.block(params, state, iq)
    assert tracing.maps() == [] and tracing.launches() == []
    assert tracing.setup_seconds() == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chain.block(params, state, iq)
    ranges = sorted((e for e in prof.events() if e.name.startswith("rx.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in ranges] == ["rx." + s for s in order]
    spans = {e.name: e.time_range for e in ranges}
    if "rf_tap" in order:   # nested: the innermost open stage wins
        assert spans["rx.frontend"].start <= spans["rx.rf_tap"].start
        assert spans["rx.rf_tap"].end <= spans["rx.frontend"].end
    # ranges that hold ops: an aten op inside each stage
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    for name, tr in spans.items():
        assert any(tr.start <= o.time_range.start <= tr.end for o in ops), name


def test_design_span():
    assert "design" not in tracing.setup_seconds()
    _chain("ssb_headless")
    assert tracing.setup_seconds()["design"] > 0


def test_setup_spans_exclude_nested_spans(monkeypatch):
    now = iter([0.0, 1.0, 4.0, 10.0, 10.0, 12.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(now))
    with tracing.setup_span("capture"):           # 0 .. 10
        with tracing.setup_span("kernel_load"):   # 1 .. 4
            pass
    with tracing.setup_span("capture"):           # 10 .. 12
        pass
    assert tracing.setup_seconds() == {"kernel_load": 3.0, "capture": 9.0}

    @tracing.setup_span("design")
    def f(x):
        return 2 * x

    monkeypatch.setattr(tracing.time, "perf_counter", iter([20.0, 25.0]).__next__)
    assert f(3) == 6 and tracing.setup_seconds()["design"] == 5.0


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_span_records_only_under_the_profiler(monkeypatch):
    g = tracing.Graph(FakeGraph())
    for _ in range(5):
        g.replay()
    assert g.graph.replays == 5 and tracing.launches() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            g.replay()
    assert g.graph.replays == 8
    spans = tracing.launches()
    assert len(spans) == 3 and all(a <= b for a, b in spans)
    assert [a for a, _ in spans] == sorted(a for a, _ in spans)
    # no profiler range: its device mirror would be counted as an op
    assert not [e for e in prof.events() if "launch" in e.name]
    g.replay()
    assert len(tracing.launches()) == 3
    # bounded: the newest kept
    monkeypatch.setattr(tracing, "LAUNCH_RECORD", 4)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            g.replay()
    spans = tracing.launches()
    assert len(spans) == 4 and g.graph.replays == 19
