"""What a cell is, found by name: `BENCHMARK.json`'s workload entry, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the cell's own file if it has one
(`cells/<cell>.json`, whose keys override the mix's), and the metrics
it reports, each read by `metrics/<name>.py`.  A new configuration, mix,
cell or metric is a new file and a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


class Cell:
    """One workload: `config` (the configuration's file), `traffic` (the
    mix's parameters with the cell's overrides), `end_to_end` and
    `per_layer` (the metric entries it reports)."""

    def __init__(self, name: str):
        bench = benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = entries[name]
        self.name, self.chips = name, int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        self.config = _json(HERE / "configs" / f"{w['config']}.json")
        self.traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
        own = HERE / "cells" / f"{name}.json"
        if own.exists():
            self.traffic.update(_json(own))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]


def reader(metric: str):
    """The `read(ctx)` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "sdrbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
