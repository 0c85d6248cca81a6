"""The check's controls: the nearest precision below the one the chain
states (float32 with TF32 off) put in the program's place, at a cell's
own size, on several seeds.  The check has to call each not correct; its
readings set the upper end of each limit (PERF.md).

    python3 -m sdrbench.control --workload NAME --seeds 1,2,3 \\
        [--control reference|program]

* `reference`: the plain reference computed in float32 with TF32 matmuls.
  It drives what a run compares: the first pass over the resident blocks
  from the initial state, then `run.FOLLOWED` more dispatches from the
  state it carried out of it.
* `program`: the program's own TF32 path, a whole run (`run.run`, its
  window `run_seconds` long) with TF32 matmuls and convolutions switched
  on before the chain is built and captured: the step that would tempt
  a later change to the spectrum taps' cuBLAS GEMMs.  `ssb_headless`
  runs no cuBLAS GEMM, so there it reads as a sound run and the
  reference control stands alone.

One JSON line a seed with the compared numbers and the verdict.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def _tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_run(workload: str, seed: int, device: str = "cuda",
                  overrides: dict | None = None) -> dict:
    import torch

    from sdrbench import check, run, spec
    from sdrbench import traffic as gen

    cell = spec.Cell(workload)
    mix = {**cell.traffic, **(overrides or {})}
    dev = torch.device(device)
    channels, per = int(mix["channels"]), int(mix["blocks_per_dispatch"])
    resident = int(mix["resident_blocks"])
    i16, q16, params = gen.make(mix["signal"], channels, resident, seed, dev)
    pairs = [(i16[r], q16[r]) for r in range(resident)]
    groups = [pairs[r:r + per] for r in range(0, resident, per)]

    _tf32(True)
    low = run._reference(cell.config["reference"]).Reference(
        cell.config["chain"], dev, torch.float32)

    def dispatch(st, blocks):
        out = {}
        for b, blk in enumerate(blocks):
            st, o = low.block(params, st, *blk)
            out.update({f"{k}.{b}": v for k, v in o.items()})
        return st, out

    st, out1 = dispatch(low.init_state(channels), pairs)   # the first pass
    snap = {k: v.clone() for k, v in st.items()}
    tail = [pair for i in range(run.FOLLOWED)
            for pair in groups[i % len(groups)]]
    st, out2 = dispatch(st, tail)                            # and the end

    def named(s):   # the program's layout: complex leaves as complex
        return {k: (torch.view_as_complex(v.contiguous())
                    if v.is_floating_point() and k in low.COMPLEX else v)
                for k, v in s.items()}

    checks, compared, failed = run.judge(
        cell.config, dev, params,
        dict(blocks=pairs, out=out1),
        dict(blocks=tail, out=out2, state=named(snap), final=named(st)))
    return {"workload": workload, "seed": seed, "channels": channels,
            "control": "reference",
            "correct": failed == 0 and check.passed(checks),
            "failed": failed, "compared_blocks": compared,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def program_run(workload: str, seed: int, seconds: float | None = None,
                overrides: dict | None = None) -> dict:
    import t41x_torch  # noqa: F401  (pins TF32 off when imported)

    from sdrbench import run, spec

    _tf32(True)
    r = run.run(workload, seed, seconds or spec.benchmark()["run_seconds"],
                False, overrides=overrides)
    return {"workload": workload, "seed": seed,
            "control": "program", "correct": r["correct"],
            "failed": r["failed"], "compared_blocks": r["compared_blocks"],
            "checks": r["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=("reference", "program"),
                    default="reference")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        if args.control == "reference":
            r = reference_run(args.workload, int(s))
        else:
            r = program_run(args.workload, int(s))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
