"""Debug instrumentation (host side).

Re-expression of the reference's debug subsystem (tmr4/T41_SDR
`debug.cpp`): `EnterLoop/ExitLoop` config-diff tracing (`:18-329` —
snapshot every config global before a loop pass, print whatever changed)
and the memory/load telemetry (`memInfo:431`, `InfoBox.cpp:341-546`).

`ConfigTracer` diffs any dict-able config between steps.

A copy of `t41x.utils.debugtrace`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal), less
`StageTimer`: host wall time around asynchronous GPU work measures the
launches, not the work.  The port's stage times come from
`t41x_torch.utils.tracing`.
"""

from __future__ import annotations

import dataclasses


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
