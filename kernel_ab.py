#!/usr/bin/env python3
"""Every kernel row of `chip_smoke.py` for several checkouts of
t41x_torch, in turns on one card.

    python3 kernel_ab.py ROOT_A ROOT_B [ROOT_C ...]      (needs a card)

Each ROOT is a directory that holds a `t41x_torch/` package (for
example the parent commit unpacked with `git archive`).  For each, in
the order A, B, ..., ..., B, A (so that a drift of the card's clock or
of its neighbours shows as a difference between the two runs of one
tree), it runs `chip_smoke.py --kernels ROOT` in a process of its own:
that builds the tree's kernels, holds each against its plain version,
and times it at 1024 channels, C1 (the transmit chain's compressor,
phase 6 (a)), N1 (the noise blanker, on sparse impulses and on crowded
impulse noise: rows "N1 nb" and "N1 nb crowded"), S1 (spectral NR's
gains) and E1 (the EQ), where the tree has them, included.  It prints each run's log (its build, each
kernel's check and times, the phase split of K2, K5, K6, K7 and C1
where the tree has it) and JSON line, a table
of each row's device µs a launch (and, where the row has them, the
plain version's and the library call's) across the runs ("-" for a
tree without the row), the number of
device kernels a block on the rx and headless specs in each run, and
the card's name and power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().with_name("chip_smoke.py")


def main() -> int:
    roots = sys.argv[1:]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    order = roots + roots[::-1]
    runs, kernels = [], {}
    for root in order:
        out = subprocess.run([sys.executable, str(SMOKE), "--kernels", root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        *logs, line, card = out.stdout.strip().splitlines()
        print(f"# run {len(runs) + 1}: {root}", *logs, line, sep="\n",
              flush=True)
        runs.append({r["name"]: r for r in json.loads(line)["kernels"]})
        for log in logs:
            m = re.match(r"# profile (\w+): .* in (\d+) kernels", log)
            if m:
                kernels.setdefault(m.group(1), []).append(m.group(2))
    print(f"# device us a launch, {' / '.join(order)} ({card})")
    names = list(dict.fromkeys(name for r in runs for name in r))
    for name in names:
        for key, label in (("ms", ""), ("plain_device_ms", " plain"),
                           ("library_ms", " library")):
            vals = [r.get(name, {}).get(key) for r in runs]
            if any(v is not None for v in vals):
                print(f"#   {name + label:32s} " + " / ".join(
                    "-" if v is None else f"{v * 1e3:.2f}" for v in vals))
    for name, counts in kernels.items():
        print(f"# device kernels a block, {name}: {' / '.join(counts)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
