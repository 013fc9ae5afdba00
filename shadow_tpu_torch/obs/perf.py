"""Wall-clock phase timers for the simulation drivers.

Reference: the `perf_timers` feature wrapping host execution and each
syscall (host.rs:721-729, handler/mod.rs:169-195). Here the interesting
phases are the driver's: device window execution, host-plane execution,
inject/drain staging — reported in sim-stats for perf debugging.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class PerfTimers:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, phase: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self) -> dict:
        return {
            phase: {
                "total_s": round(self.totals[phase], 4),
                "calls": self.counts[phase],
            }
            for phase in sorted(self.totals)
        }
