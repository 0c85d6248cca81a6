"""Multi-process scaling of the receive chain (torch.distributed), port
of `tools/multihost_bench.py`.

Measures aggregate receive-chain throughput at 1 to N processes and the
scaling efficiency.  Each process plays one host: it owns a DISJOINT set
of receiver channels (`t41x_torch.mesh.distributed.shard_local_channels`
records its global offset), runs the chain channel-sharded over its own
devices (`channel_sharded_stream`), and takes part in the one piece of
cross-process traffic, the fleet-wide summary of the per-channel audio
energies (`fleet_summary`, all-reduces), which is also the timing's
synchronisation point together with a barrier.

Processes are pinned to disjoint CPU sets (taskset) sized for the
largest run, so every host has the same compute at N=1 and N=2 and the
aggregate samples/s compare honestly.  Rendezvous is a `file://` store
in a fresh temporary directory (no fixed port).  On the card each
process takes the card of its rank (NCCL; `dist.initialize` makes it
current); `--device cpu` runs the
chain's plain versions on the CPU (gloo), with `--devices-per-host`
shards a process.

Launcher (runs N=1, then N=2..procs):

    python -m t41x_torch.tools.multihost_bench [--device cpu]
        [--channels-per-host 64] [--blocks 8] [--procs 2] [--out FILE]

One rank (what the launcher starts, from the repository root):

    python -m t41x_torch.tools.multihost_bench --process-id I
        --num-processes N --init-method file://... ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SPEC = dict(mode="usb", spectrum_taps=True, interpolate_out=True)


def local_iq(process_id: int, n_local: int, blocks: int) -> np.ndarray:
    """Process `process_id`'s channels: (n_local, blocks * BLOCK) complex64
    noise from the seed 100 + process_id."""
    from t41x_torch import constants as C

    rng = np.random.default_rng(100 + process_id)
    shape = (n_local, blocks * C.BLOCK_SIZE)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * 0.1).astype(np.complex64)


def rank_main(args) -> None:
    """One process: its channels through the channel-sharded chain, timed,
    then the fleet summary; rank 0 prints the RESULT line and, with
    `--out-audio`, writes every rank's audio and energies (gathered)."""
    import torch
    import torch.distributed as tdist

    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec, RxChain, default_params
    from t41x_torch.mesh import distributed as dist
    from t41x_torch.mesh.sharding import channel_sharded_stream

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    if args.device == "cpu":
        devices, backend = ["cpu"] * args.devices_per_host, "gloo"
    else:
        if args.process_id >= torch.cuda.device_count():
            raise RuntimeError(f"rank {args.process_id}: "
                               f"{torch.cuda.device_count()} cards visible")
        devices, backend = [f"cuda:{args.process_id}"], "nccl"
    dist.initialize(args.init_method, args.num_processes, args.process_id,
                    backend)
    mesh = dist.global_mesh(axis="ch", devices=devices)
    local = dist.shard_local_channels(
        mesh, local_iq(args.process_id, args.channels_per_host, args.blocks))
    n_local = local.iq.shape[0]
    home = mesh.devices.flat[0]
    chain = RxChain(ChainSpec(**SPEC), device=home)
    params = default_params((n_local,), device=home)

    def sync():
        if home.type == "cuda":
            torch.cuda.synchronize(home)

    def run():
        # per-channel energies; the state carries over the repeats
        st, e, first = None, torch.zeros(n_local, device=home), None
        for _ in range(args.repeats):
            st, audio = channel_sharded_stream(chain, mesh, params, local.iq,
                                               st)
            e = e + (audio ** 2).sum(dim=-1)
            first = audio if first is None else first
        sync()
        return e, first

    _, audio = run()                          # warm-up (kernel build)
    if tdist.is_initialized():
        tdist.barrier()
    times = []
    for _ in range(args.timing_reps):
        t0 = time.perf_counter()
        energies, _ = run()
        times.append(time.perf_counter() - t0)
    t = min(times)
    t0 = time.perf_counter()
    summary = dist.fleet_summary(energies)
    summary = {k: float(v) for k, v in summary.items()}
    fleet_s = time.perf_counter() - t0

    if args.out_audio:
        gathered = []
        for part in (audio, energies):
            if tdist.is_initialized():
                parts = [torch.empty_like(part)
                         for _ in range(args.num_processes)]
                tdist.all_gather(parts, part.contiguous())
                part = torch.cat(parts)
            gathered.append(part.cpu().numpy())
        if args.process_id == 0:
            np.savez(args.out_audio, audio=gathered[0],
                     energies=gathered[1])
    samples = n_local * args.num_processes * args.blocks * args.repeats \
        * C.BLOCK_SIZE
    result = {
        "num_processes": args.num_processes,
        "process_id": args.process_id,
        "device": (torch.cuda.get_device_name(home) if home.type == "cuda"
                   else "cpu"),
        "shards_per_process": len(devices),
        "channels_total": local.global_shape[0],
        "channel_offset": local.offset,
        "blocks": args.blocks,
        "repeats": args.repeats,
        "wall_s": t,
        "samples_per_sec": samples / t,
        "fleet_summary_mean_energy": summary["mean"],
        "fleet_summary_max_energy": summary["max"],
        "fleet_summary_min_energy": summary["min"],
        "fleet_summary_overhead_s": fleet_s,
    }
    if tdist.is_initialized():
        tdist.destroy_process_group()
    if args.process_id == 0:
        print("RESULT " + json.dumps(result), flush=True)


def cpu_sets(n_procs: int, max_procs: int) -> list[str]:
    """CPU sets for each simulated host, sized for `max_procs` hosts so
    every run (N=1..max) gives each host the same compute; past the CPU
    count the assignment wraps around (two hosts then share a core)."""
    n_cpu = os.cpu_count() or 1
    per = max(1, n_cpu // max_procs)
    return [",".join(str(c) for c in sorted({(i * per + j) % n_cpu
                                             for j in range(per)}))
            for i in range(n_procs)]


def launch(n_procs: int, args, timeout: float = 900.0) -> dict:
    """Start `n_procs` ranks pinned to their CPU sets, rendezvous through
    a file in a fresh temporary directory; returns rank 0's RESULT."""
    sets = cpu_sets(n_procs, args.procs)
    with tempfile.TemporaryDirectory(prefix="t41x_mh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = []
        try:
            for i in range(n_procs):
                cmd = ["taskset", "-c", sets[i], sys.executable, "-m",
                       "t41x_torch.tools.multihost_bench",
                       "--process-id", str(i),
                       "--num-processes", str(n_procs),
                       "--init-method", init, "--device", args.device,
                       "--channels-per-host", str(args.channels_per_host),
                       "--blocks", str(args.blocks),
                       "--repeats", str(args.repeats),
                       "--devices-per-host", str(args.devices_per_host),
                       "--timing-reps", str(args.timing_reps)]
                if getattr(args, "out_audio", None):
                    cmd += ["--out-audio", args.out_audio]
                procs.append(subprocess.Popen(
                    cmd, cwd=REPO, text=True,
                    stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
                    stderr=subprocess.STDOUT if i == 0
                    else subprocess.DEVNULL))
            out, _ = procs[0].communicate(timeout=timeout)
            for p in procs[1:]:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"no RESULT line from rank 0:\n{out}")


def scaling(results: list[dict]) -> None:
    """Add each multi-process run's efficiency against N x the one-process
    rate."""
    base = results[0]["samples_per_sec"]
    for r in results[1:]:
        r["scaling_efficiency"] = r["samples_per_sec"] / (
            r["num_processes"] * base)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--channels-per-host", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--devices-per-host", type=int, default=4,
                    help="shards a process with --device cpu")
    ap.add_argument("--timing-reps", type=int, default=3)
    ap.add_argument("--procs", type=int, default=2,
                    help="most processes (launcher mode)")
    ap.add_argument("--out-audio", default=None,
                    help="rank 0 writes the gathered audio and energies "
                         "to this .npz")
    ap.add_argument("--out", default=None,
                    help="write the scaling runs to this JSON file")
    args = ap.parse_args(argv)

    if args.process_id is not None:
        rank_main(args)
        return
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.procs:
            raise RuntimeError(f"{args.procs} processes need as many cards; "
                               f"{torch.cuda.device_count()} visible")
    results = []
    for n in range(1, args.procs + 1):
        r = launch(n, args)
        results.append(r)
        print(f"processes={n}: {r['samples_per_sec'] / 1e6:.3f} Msamples/s "
              f"aggregate ({r['channels_total']} channels, {r['device']})",
              flush=True)
    scaling(results)
    for r in results[1:]:
        print(f"scaling efficiency at {r['num_processes']} processes: "
              f"{r['scaling_efficiency'] * 100:.1f}%", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cpu_count": os.cpu_count(), "runs": results}, f,
                      indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
