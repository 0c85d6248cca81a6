"""Debug instrumentation (host side).

Re-expression of the reference's debug subsystem (tmr4/T41_SDR
`debug.cpp`): `EnterLoop/ExitLoop` config-diff tracing (`:18-329` —
snapshot every config global before a loop pass, print whatever changed)
and the memory/load telemetry (`memInfo:431`, `InfoBox.cpp:341-546`).

`ConfigTracer` diffs any dict-able config between steps;
`StageTimer` collects per-stage wall time (the jax.profiler complement
for quick printf-style perf work).

A copy of `t41x.utils.debugtrace`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager


def _to_dict(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    if isinstance(obj, dict):
        return dict(obj)
    return vars(obj)


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], dict):
            for i, item in enumerate(v):
                out.update(_flatten(item, f"{key}[{i}]"))
        else:
            out[key] = v
    return out


class ConfigTracer:
    """enter()/exit() around a processing pass; exit() returns the dict
    of config fields that changed (the reference's DEBUG_LOOP)."""

    def __init__(self, log=None):
        self._snap: dict | None = None
        self.log = log or (lambda s: None)
        self.history: list[dict] = []

    def enter(self, config) -> None:
        self._snap = _flatten(_to_dict(config))

    def exit(self, config) -> dict:
        if self._snap is None:
            return {}
        now = _flatten(_to_dict(config))
        diff = {}
        for k, v in now.items():
            old = self._snap.get(k, "<absent>")
            if old != v:
                diff[k] = (old, v)
                self.log(f"{k}: {old} -> {v}")
        self._snap = None
        if diff:
            self.history.append(diff)
        return diff


class StageTimer:
    """Accumulating per-stage timer: with timer.stage("decimate"): ..."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        return {
            name: {"total_s": t, "count": self.counts[name],
                   "mean_ms": 1e3 * t / self.counts[name]}
            for name, t in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1])
        }
