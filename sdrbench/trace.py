"""The device trace of a window: `torch.profiler` around it, read into
device operations on one clock with the window's own bounds.

The profiler drops a session's first device records, so each session
starts with spin kernels and a wait that take the loss (the handling of
`chip_smoke.py` `kernel_us`, copied: 256 `torch.cuda._sleep` spins and
10 ms).  The window is marked by a `record_function` range on the same
clock as the device records.
"""

from __future__ import annotations

import contextlib
import time

SPINS = 256
SPIN_WAIT_S = 0.01
SPIN_KERNEL = "spin_kernel"
WINDOW = "sdrbench.window"


@contextlib.contextmanager
def session(device):
    """Profile what runs inside; yields a list that holds, after the
    block, the `Trace` of the window the caller marked with `window()`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    found = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(device)
        time.sleep(SPIN_WAIT_S)
        yield found
    found.append(Trace.of(prof))


def window():
    """Mark the window (the caller's whole measured loop and its drain)."""
    from torch.profiler import record_function
    return record_function(WINDOW)


class Trace:
    """Device operations (kernels, copies, sets) as (name, start_us,
    end_us), clipped to the window [w0, w1] (µs, the profiler's clock)."""

    def __init__(self, ops: list, w0: float, w1: float):
        self.ops, self.w0, self.w1 = ops, w0, w1

    @classmethod
    def of(cls, prof) -> "Trace":
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        w = [e for e in prof.events() if e.name == WINDOW
             and e.device_type != cuda]
        if not w:
            raise RuntimeError("trace: the window's range is missing")
        w0, w1 = w[0].time_range.start, w[0].time_range.end
        ops = []
        for e in prof.events():
            if (e.device_type != cuda or SPIN_KERNEL in e.name
                    or e.name == WINDOW):   # the range's device mirror
                continue
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                ops.append((e.name, s, t))
        ops.sort(key=lambda o: o[1])
        return cls(ops, w0, w1)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran."""
        busy, end = 0.0, self.w0
        for _, s, t in self.ops:
            if t > end:
                busy += t - max(s, end)
                end = t
        return busy * 1e-6

    def device_s(self, match=None) -> float:
        """Summed seconds of the operations whose name holds any of the
        strings in `match` (all of them when None)."""
        return sum(t - s for n, s, t in self.ops
                   if match is None or any(m in n for m in match)) * 1e-6

    def by_name(self) -> list:
        tot = {}
        for n, s, t in self.ops:
            tot[n] = tot.get(n, 0.0) + (t - s) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def gaps(self) -> list:
        """Idle gaps as (start_us, seconds), longest first."""
        out, end = [], self.w0
        for _, s, t in self.ops:
            if s > end:
                out.append((end, (s - end) * 1e-6))
            end = max(end, t)
        if self.w1 > end:
            out.append((end, (self.w1 - end) * 1e-6))
        return sorted(out, key=lambda g: -g[1])
