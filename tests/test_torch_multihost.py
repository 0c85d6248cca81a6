"""The port's multi-process path on the CPU: two real processes (gloo,
a file rendezvous) through `t41x_torch.tools.multihost_bench`.

Each rank owns 16 channels (`shard_local_channels`), runs the chain
channel-sharded over 2 CPU shards and joins the fleet summary (gloo
all-reduces).  The gathered audio equals the single-process chain over
the same 32 channels, and the summary equals a torch reduction of the
gathered energies.  The scaling efficiency is printed, not asserted: a
wall-clock bound would make the test depend on the machine's load.
"""

import types

import numpy as np
import torch

from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.tools import multihost_bench as mh


def _args(out_audio):
    return types.SimpleNamespace(
        device="cpu", procs=2, channels_per_host=16, blocks=2, repeats=1,
        devices_per_host=2, timing_reps=1, out_audio=str(out_audio))


def test_two_process_run_matches_one_process(tmp_path):
    r1 = mh.launch(1, _args(tmp_path / "one.npz"), timeout=300)
    r2 = mh.launch(2, _args(tmp_path / "two.npz"), timeout=300)
    assert (r1["num_processes"], r1["channels_total"]) == (1, 16)
    assert (r2["num_processes"], r2["channels_total"]) == (2, 32)
    assert r2["shards_per_process"] == 2 and r2["device"] == "cpu"
    mh.scaling([r1, r2])
    print(f"scaling efficiency at 2 processes (CPU, not asserted): "
          f"{r2['scaling_efficiency'] * 100:.1f}%")

    got = np.load(tmp_path / "two.npz")
    iq = np.concatenate([mh.local_iq(i, 16, 2) for i in range(2)])
    ref = RxChain(ChainSpec(**mh.SPEC), device="cpu").run(iq)["audio_24k"]
    np.testing.assert_allclose(got["audio"], ref.numpy(), rtol=1e-5)

    e = torch.from_numpy(got["energies"])
    assert e.shape == (32,)
    np.testing.assert_allclose(r2["fleet_summary_mean_energy"],
                               float(e.mean()), rtol=1e-6)
    assert r2["fleet_summary_max_energy"] == float(e.max())
    assert r2["fleet_summary_min_energy"] == float(e.min())
    # one process: the same first 16 channels, the same summary terms
    one = np.load(tmp_path / "one.npz")
    np.testing.assert_array_equal(one["audio"], got["audio"][:16])


def test_livebench_runs_on_the_cpu(capsys):
    """The live-pacing tool end to end on the CPU (eager runner), paced
    at a tenth of real time: its report's keys and block counts.  No
    time or verdict is asserted."""
    from t41x_torch.tools import livebench

    r = livebench.main(["--device", "cpu", "--channels", "2",
                        "--batch-blocks", "2", "--seconds", "0.05",
                        "--rate-factor", "0.1"])
    assert r["device"] == "cpu" and r["graphs"] is False
    assert r["blocks_pushed"] == 4
    assert 0 < r["blocks_processed"] <= r["blocks_pushed"] + 1
    assert isinstance(r["sustained"], bool)
    for k in ("load_percent", "dispatch_ms_p50", "dispatch_ms_p95",
              "latency_ms_p50", "latency_ms_p95", "max_ring_depth",
              "ring_overruns"):
        assert np.isfinite(r[k]), k
    assert capsys.readouterr().out.startswith("RESULT ")
