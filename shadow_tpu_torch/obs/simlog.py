"""Async simulation logger: sim-time-stamped, host-contexted records.

Reference: `src/main/core/logger/shadow_logger.rs:17-60` — producers send
records to per-thread channels; a dedicated flush thread writes; an async
flush kicks in at 100k queued lines and producers block (back-pressure) at
1M so an over-chatty simulation cannot exhaust memory. Every record carries
the SIMULATED time and the host context, so `tools/parse_shadow.py` can
attribute lines per host for debugging.

Record format (deterministic — no wall-clock content):

    HH:MM:SS.nnnnnnnnn [level] [host] message
"""

from __future__ import annotations

import threading
from collections import deque
from typing import IO

LEVELS = ("trace", "debug", "info", "warning", "error")
_LEVEL_NUM = {name: i for i, name in enumerate(LEVELS)}


def format_sim_time(t_ns: int) -> str:
    s, ns = divmod(max(int(t_ns), 0), 1_000_000_000)
    m, sec = divmod(s, 60)
    h, m = divmod(m, 60)
    return f"{h:02d}:{m:02d}:{sec:02d}.{ns:09d}"


class SimLogger:
    """Buffered async logger with a flush thread and bounded memory.

    `log()` never blocks below BACKPRESSURE_QLEN queued records; the flush
    thread drains opportunistically and is kicked eagerly once ASYNC_FLUSH
    records are pending (shadow_logger.rs's 100k/1M thresholds)."""

    ASYNC_FLUSH = 100_000
    BACKPRESSURE = 1_000_000

    def __init__(self, target: str | IO, level: str = "info"):
        if isinstance(target, str):
            self._fh: IO = open(target, "w")
            self._own = True
        else:
            self._fh = target
            self._own = False
        self.level = _LEVEL_NUM.get(level, 2)
        self._q: deque[str] = deque()
        self._cv = threading.Condition()
        self._stop = False
        self.records = 0
        self.dropped_backpressure_waits = 0
        self._thread = threading.Thread(
            target=self._flush_loop, name="shadow-logger", daemon=True
        )
        self._thread.start()

    # ---- producer side -----------------------------------------------------

    def log(self, t_ns: int, host: str, level: str, msg: str):
        if _LEVEL_NUM.get(level, 2) < self.level:
            return
        line = f"{format_sim_time(t_ns)} [{level}] [{host}] {msg}\n"
        with self._cv:
            while len(self._q) >= self.BACKPRESSURE:
                # sync back-pressure: the producer waits for the flush
                # thread instead of growing without bound
                self.dropped_backpressure_waits += 1
                self._cv.wait(timeout=1.0)
            self._q.append(line)
            self.records += 1
            if len(self._q) == 1 or len(self._q) >= self.ASYNC_FLUSH:
                self._cv.notify_all()

    def info(self, t_ns: int, host: str, msg: str):
        self.log(t_ns, host, "info", msg)

    def warning(self, t_ns: int, host: str, msg: str):
        self.log(t_ns, host, "warning", msg)

    # ---- flush thread ------------------------------------------------------

    def _flush_loop(self):
        while True:
            with self._cv:
                if not self._q and self._stop:
                    return
                if not self._q:
                    self._cv.wait(timeout=0.1)
                batch = list(self._q)
                self._q.clear()
                self._cv.notify_all()  # wake back-pressured producers
            if batch:
                self._fh.writelines(batch)
                self._fh.flush()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        if self._own:
            self._fh.close()


def parse_log(path: str) -> dict:
    """Summarize a shadow.log: record counts per host and per level (the
    parse-shadow.py consumption contract)."""
    per_host: dict[str, int] = {}
    per_level: dict[str, int] = {}
    n = 0
    with open(path) as f:
        for line in f:
            parts = line.split(" ", 3)
            if len(parts) < 4 or not parts[1].startswith("["):
                continue
            level = parts[1].strip("[]")
            host = parts[2].strip("[]")
            per_level[level] = per_level.get(level, 0) + 1
            per_host[host] = per_host.get(host, 0) + 1
            n += 1
    return {"records": n, "per_host": per_host, "per_level": per_level}
