"""A run of the harness on the CPU: the shape of its result line, the
refusal without a card, and `correct` coming out false with the timed
path broken underneath.

`run.run` is the whole run but the look for a card (the CLI's), at a
tiny size: 4 channels, the chain's plain versions on CPU tensors, the
dispatches eager in place of CUDA graphs.
"""

import json
import math
import subprocess
import sys

import pytest
import torch

from sdrbench import run, spec

TINY = {
    "ssb_pan.bulk4k": {"channels": 4, "blocks_per_dispatch": 2,
                       "resident_blocks": 2},
    "ssb_headless.bulk4k": {"channels": 4, "blocks_per_dispatch": 2,
                            "resident_blocks": 2},
    "ssb_pan.live80": {"channels": 4, "resident_blocks": 2},
}


@pytest.fixture(autouse=True)
def one_warm_round(monkeypatch):
    monkeypatch.setattr(run, "WARM_ROUNDS", 1)


def tiny_run(workload, seed=2**31 + 11, seconds=0.05):
    return run.run(workload, seed, seconds, False, device="cpu",
                   overrides=TINY[workload])


@pytest.mark.parametrize("workload", sorted(TINY))
def test_result_line_shape(workload):
    r = tiny_run(workload)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = spec.Cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert set(r["metrics"]) == names
    for m in cell.end_to_end:
        v = r["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and math.isfinite(v["value"])
        assert v["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert set(r["checks"]) == set(cell.config["limits"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(r))


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command prints nothing on stdout and exits
    non-zero (skipped where a card is visible)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    res = subprocess.run(
        [sys.executable, "-m", "sdrbench.run", "--workload",
         "ssb_pan.bulk4k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert res.returncode == 2 and res.stdout == ""


def _broken(monkeypatch, fault):
    """Break `RxChain.block`, the timed path, by one fault."""
    from t41x_torch.chain import rx

    block = rx.RxChain.block

    def broken(self, params, state, iq):
        new, out = block(self, params, state, iq)
        if fault == "state_unchanged":
            return state, out
        if fault == "half_the_channels":
            half = out["audio"].shape[0] // 2
            out = {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                   for k, v in out.items()}
            return new, out
        if fault == "one_answer_altered":   # one channel's block, +1 dB
            out = dict(out)
            a = out["audio"].clone()
            a[1] *= 10 ** (1 / 20)
            out["audio"] = a
            return new, out
        raise ValueError(fault)

    monkeypatch.setattr(rx.RxChain, "block", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_channels",
                                   "one_answer_altered"])
@pytest.mark.parametrize("workload", ["ssb_pan.bulk4k", "ssb_pan.live80"])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    _broken(monkeypatch, fault)
    r = tiny_run(workload)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


@pytest.mark.parametrize("leaf", ["agc.volts", "int2", "smeter_avg",
                                  "nco_phase", "dc_bq"])
@pytest.mark.parametrize("workload", ["ssb_pan.bulk4k", "ssb_pan.live80"])
def test_a_leaf_not_carried_is_not_correct(monkeypatch, workload, leaf):
    """One state leaf not carried from one dispatch to the next (each
    dispatch's new value of it dropped): the check follows the window's
    last two dispatches, so the second starts where the reference does
    not, and the leaf carried out differs."""
    from sdrbench import program

    replay = program.Dispatch.replay

    def not_carried(self):
        kept = program.leaves(self.state)[leaf].clone()
        replay(self)
        program.leaves(self.state)[leaf].copy_(kept)

    monkeypatch.setattr(program.Dispatch, "replay", not_carried)
    r = tiny_run(workload)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "t41x_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "t41x.chain", sys)
    assert run.forbidden_modules() == ["t41x"]
