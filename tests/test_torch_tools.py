"""The port's measurement tools on the CPU: `t41x_torch.tools.bench`
(the twin of `bench.py`), `stagebench` (of `tools/stagebench.py`) and
`ft8_sensitivity`'s device rule.

The reference files' configs, spec keywords and variants are read with
`ast`, without importing them, and must equal the port's (t41x's
`use_pallas` mapped to the port's `use_kernels`).  The slice as a whole:
bench's seeded buffer through the port's `run_blocks` on the CPU against
t41x's plain chain (or exciter) on the same buffer, at the North-star
bounds (audio >= 55 dB, displayed spectrum <= 0.5 dB) with the checksums
within rtol 1e-4."""

import ast
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.chain import default_params as jparams
from t41x.chain import tx as jtx
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.chain import tx as ttx
from t41x_torch.tools import bench, ft8_sensitivity, stagebench
from t41x_torch.utils import parity

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return ast.parse(f.read())


def _assigned(tree, name):
    """The value node of the (one) assignment of a dict display to
    `name`."""
    found = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict)
             and any(isinstance(t, ast.Name) and t.id == name
                     for t in n.targets)]
    assert len(found) == 1, name
    return found[0]


def _eval(node, **names):
    return eval(compile(ast.Expression(node), "<ref>", "eval"),
                {"dict": dict, **names})


def _map_pallas(kw):
    kw = dict(kw)
    pallas = kw.pop("use_pallas", False)
    return {**kw, "use_kernels": bool(pallas)}


def test_configs_and_cfg_map_equal_bench_py():
    tree = _tree("bench.py")
    choices = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and n.args and isinstance(n.args[0], ast.Constant)
               and n.args[0].value == "--config"]
    assert len(choices) == 1
    kws = {k.arg: k.value for k in choices[0].keywords}
    assert tuple(_eval(kws["choices"])) == bench.CONFIGS
    assert _eval(kws["default"]) == "rx"
    for mode in ("usb", "lsb"):
        ref = _eval(_assigned(tree, "cfg_map"),
                    args=SimpleNamespace(mode=mode))
        assert ref == bench.cfg_map(mode)


def test_variants_equal_stagebench_py():
    ref = _eval(_assigned(_tree("tools/stagebench.py"), "variants"))
    assert list(ref) == list(stagebench.VARIANTS)
    assert {k: _map_pallas(v) for k, v in ref.items()} == stagebench.VARIANTS
    assert len(ref) == 32


def test_make_blocks_is_bench_py_buffer():
    """bench.py's build_rx / build_tx buffers, seed for seed."""
    rng = np.random.default_rng(3)
    shape = (2, 5, 2048)
    iq = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
          ).astype(np.complex64) * 0.1
    got = bench.make_blocks(ChainSpec(), 5, 2, seed=3)
    np.testing.assert_array_equal(got.numpy(), iq)
    i16, q16 = bench.make_blocks(ChainSpec(q15_input=True), 5, 2, seed=3)
    for g, a in ((i16, iq.real), (q16, iq.imag)):
        assert g.dtype == torch.int16
        np.testing.assert_array_equal(g.numpy(), np.clip(
            np.round(a * 32768.0), -32768, 32767).astype(np.int16))
    wide = bench.make_blocks("channelizer", 32, 2, seed=4, k=16)
    assert wide.shape == (2, 2, 16 * 2048) and wide.dtype == torch.complex64
    rng = np.random.default_rng(6)
    mic = rng.standard_normal((2, 5, 2048)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(bench.make_blocks("tx", 5, 2, seed=6)
                                  .numpy(), mic)


def _ref_checksum(out) -> float:
    """bench.py's checksum in float64 on t41x's outputs."""
    if not isinstance(out, dict):
        iq = np.asarray(out)
        return float(np.sum(iq.real.astype(np.float64) ** 2
                            + iq.imag.astype(np.float64) ** 2))
    e = float(np.sum(np.asarray(out["audio_24k"], np.float64) ** 2))
    for v in out.values():
        v = np.asarray(v)
        if np.iscomplexobj(v):
            v = v.real
        e += float(np.sum(v.astype(np.float64))) * 1e-6
    return e


@pytest.mark.parametrize("config", ["rx", "rx_nodisplay", "q15", "cw", "tx"])
def test_slice_matches_t41x(config):
    """bench's buffer (numpy seed 0, 4 channels x 2 blocks) through the
    port's `run_blocks` against t41x's plain chain scanned over it."""
    ch, n_blocks = 4, 2
    if config == "tx":
        kw = dict(sideband="usb", eq_on=True)
        j = jtx.SSBExciter(jtx.TxSpec(**kw))
        t = ttx.SSBExciter(ttx.TxSpec(**kw), device="cpu")
        jp, tp = jtx.default_tx_params((ch,)), ttx.default_tx_params(
            (ch,), device="cpu")
        blocks = bench.make_blocks("tx", ch, n_blocks)
    else:
        kw = dict(spectrum_taps=True, use_matmul_osfilter=True,
                  interpolate_out=True, q15_input=config == "q15",
                  **bench.cfg_map()["rx" if config == "q15" else config])
        j = JChain(JSpec(use_pallas=False, **kw))
        t = RxChain(ChainSpec(**kw), device="cpu")
        jp, tp = jparams((ch,)), default_params((ch,), device="cpu")
        blocks = bench.make_blocks(t.spec, ch, n_blocks)

    step = jax.jit(j.block)
    js, ts = j.init_state((ch,)), t.init_state((ch,))
    ref_e, e_loop, outs = 0.0, None, []
    for b in range(n_blocks):
        blk = (tuple(a[b] for a in blocks) if isinstance(blocks, tuple)
               else blocks[b])
        js, jo = step(jp, js, jax.tree.map(lambda a: a.numpy(), blk))
        ts, to = t.block(tp, ts, blk)
        ref_e += _ref_checksum(jo)
        e_b = bench.checksum(to)
        e_loop = e_b if e_loop is None else e_loop + e_b
        outs.append((jo, to))
    _, e = bench.run_blocks(t, tp, t.init_state((ch,)), blocks)
    assert e.dtype == torch.float32 and e.shape == ()
    assert torch.equal(e, e_loop)
    assert float(e) == pytest.approx(ref_e, rel=1e-4)

    keys = ["iq"] if config == "tx" else ["audio", "audio_24k"] + (
        ["rf_spectrum"] if kw.get("spectrum_zoom", -1) >= 0 else [])
    for k in keys:
        ref = np.stack([np.asarray(jo if k == "iq" else jo[k])
                        for jo, _ in outs])
        got = torch.stack([to if k == "iq" else to[k] for _, to in outs])
        if k == "rf_spectrum":
            assert parity.spectrum_err_db(ref, got) \
                <= parity.SPECTRUM_ERR_MAX_DB
        else:
            assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, k


def test_bench_main_prints_one_json_line(capsys):
    res = bench.main(["--device", "cpu", "--channels", "4", "--blocks", "2",
                      "--min-ms", "1", "--reps", "1", "--no-linearity"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == json.loads(json.dumps(res))
    assert set(got) == {"metric", "value", "unit", "vs_baseline", "config"}
    assert got["metric"] == "iq_samples_per_sec_per_chip_full_rx_chain"
    assert got["vs_baseline"] == round(got["value"] / 192000.0, 2)
    cfg = got["config"]
    assert cfg["platform"] == "cpu" and cfg["device"] == "cpu"
    assert cfg["graphed"] is False and cfg["power_limit_w"] is None
    assert cfg["channels"] == 4 and cfg["blocks"] == 2
    # bench.py's config keys, less the XLA cost-model ones, `pallas`
    # renamed `kernels`, plus the port's own
    tree = _tree("bench.py")
    node = _assigned(tree, "cfg")
    ref = {k.value for k in node.keys}
    ref |= {n.slice.value for n in ast.walk(tree)
            if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
            and n.value.id == "cfg" and isinstance(n.ctx, ast.Store)}
    want = (ref - {"achieved_tflops", "util_vs_bf16_peak", "pallas"}) | {
        "kernels", "power_limit_w", "eager_rate", "graphed", "checksum",
        "checksum_graph_equals_eager"}
    assert set(cfg) == want
    assert cfg["parity_db"]["audio"] == float("inf")


class _ClockedDispatch:
    """A dispatch on a fake clock: each replay advances it by `cost(i)`
    seconds, i the index of the timed region (one `acc.item()` a region)."""

    def __init__(self, cost):
        self.now, self.region, self.cost = 0.0, 0, cost
        self.acc = SimpleNamespace(item=self._end_region)

    def _end_region(self):
        self.region += 1
        return 0.0

    def replay(self):
        self.now += self.cost(self.region)


@pytest.mark.parametrize("case,want", [
    # one region of the six 10% fast (a clock step): the median drops it
    ("one_fast_region", 2.0),
    # the clock 10% faster from the fourth region on: each pair's two
    # regions on one clock but the straddling one
    ("clock_step", 2.0),
    # a dispatch that skips half its work in every 2x region still shows
    ("skips_work", 1.0)])
def test_linearity_is_the_median_of_interleaved_pairs(case, want,
                                                      monkeypatch):
    # regions in order: 1x 2x, 2x 1x, 1x 2x
    twice = (1, 2, 5)
    cost = {"one_fast_region": lambda r: 0.9 if r == 3 else 1.0,
            "clock_step": lambda r: 0.9 if r >= 3 else 1.0,
            "skips_work": lambda r: 0.5 if r in twice else 1.0}[case]
    d = _ClockedDispatch(cost)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: d.now)
    assert bench.linearity(d, 5, 3) == pytest.approx(want)
    assert d.region == 6
    assert d.now == pytest.approx(sum(cost(r) * (10 if r in twice else 5)
                                      for r in range(6)))


def test_stagebench_prints_a_row_a_variant(capsys):
    rows = stagebench.main(["--device", "cpu", "--channels", "2",
                            "--blocks", "1", "--min-ms", "0.001"])
    out = capsys.readouterr().out.strip().splitlines()
    assert list(rows) == list(stagebench.VARIANTS)
    assert [ln.split()[0] for ln in out] == list(stagebench.VARIANTS)
    assert not [ln for ln in out if "FAILED" in ln]
    assert all(r["us_per_block"] > 0 and r["graphed"] is False
               for r in rows.values())


@pytest.mark.parametrize("tool", [bench, stagebench, ft8_sensitivity])
def test_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])
