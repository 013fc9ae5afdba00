"""The runtime observatory (port of shadow_tpu/obs/runtime.py): wall-clock
attribution and the kernel-build ledger (`observability.runtime`).
Host-side only: digests, events and drops are bit-identical on or off.

  `BuildLedger` is the JAX package's compile ledger recast for the port:
  the port compiles no programs at run time, but it builds its hand-written
  kernels (one `nvcc` per csrc/*.cu source, ops/cuda_build.py) on first use.
  Each source's load is one entry: the seconds it took, whether the
  library was already in the build directory (a hit: no `nvcc` ran) or was
  built (a miss), and its trigger (`cold_start`: the first launch of a run
  loaded it; `prebuilt`: it was loaded before the run). A build inside a
  chunk's dispatch is moved from the dispatch span to the compile span.

  `WallLedger` splits each chunk's wall into named spans (compile /
  dispatch / host_python / snapshot / replay / export) whose sum equals the
  chunk's wall exactly (the residual no span covered is host_python), with
  a per-chunk realtime factor (sim-seconds per wall-second) that the
  heartbeat's `rt=` field carries. Copied from the JAX package.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Any

# WallLedger span names. `host_python` is the residual: whatever part of a
# chunk's wall no explicit span covered (heartbeats, counter reads,
# controller bookkeeping)
SPAN_NAMES = (
    "compile", "dispatch", "host_python", "snapshot", "replay", "export",
)

# bounded in-memory series (overflow is counted, never silent)
MAX_CHUNK_RECORDS = 4096
# rt series entries exported into sim-stats (the newest are kept)
MAX_EXPORTED_SERIES = 512


# ---------------------------------------------------------------------------
# kernel-build ledger
# ---------------------------------------------------------------------------


class BuildLedger:
    """Per-source kernel-build accounting of one run.

    `attach()` (before the run loop) adopts the libraries this process
    already loaded (ops/cuda_build.py BUILD_LOG) as `prebuilt` entries;
    `collect()` (after each chunk's dispatch) adopts the ones loaded since
    as `cold_start` entries and moves their seconds from the chunk's
    dispatch span to its compile span (`wall`, a WallLedger)."""

    def __init__(self, wall: "WallLedger | None" = None):
        self.entries: list[dict] = []
        self.wall = wall
        self._seen = 0

    def attach(self) -> None:
        self._adopt("prebuilt")

    def collect(self) -> None:
        for rec in self._adopt("cold_start"):
            if self.wall is not None:
                self.wall.reattribute("dispatch", "compile", rec["seconds"])

    def _adopt(self, trigger: str) -> list[dict]:
        from shadow_tpu_torch.ops.cuda_build import BUILD_LOG

        new = [{**rec, "trigger": trigger} for rec in BUILD_LOG[self._seen:]]
        self._seen = len(BUILD_LOG)
        self.entries += new
        return new

    @property
    def cache_hits(self) -> int:
        return sum(1 for e in self.entries if e["hit"])

    def events(self) -> list[tuple[str, float, float]]:
        """(label, t0_monotonic, duration_s) per load: the Chrome trace's
        compile track (RoundTracer.note_compiles)."""
        return [(f"nvcc:{e['source']} ({e['trigger']})", e["t0"], max(e["seconds"], 1e-6))
                for e in self.entries]

    def summary(self) -> dict:
        by_trigger: dict[str, int] = {}
        for e in self.entries:
            by_trigger[e["trigger"]] = by_trigger.get(e["trigger"], 0) + 1
        built = [e for e in self.entries if not e["hit"]]
        return {
            "programs": len(self.entries),
            "cache_hits": self.cache_hits,
            "monitored": True,
            "compile_wall_s": round(sum(e["nvcc_s"] for e in self.entries), 4),
            "backend_compile_s": round(sum(e["nvcc_s"] for e in built), 4),
            "lower_s": 0.0,
            "cold_wall_s": round(sum(e["seconds"] for e in self.entries), 4),
            "by_trigger": by_trigger,
            "entries": [
                {"kind": "nvcc", "label": e["source"], "trigger": e["trigger"],
                 "compile_s": round(e["nvcc_s"], 4), "lower_s": 0.0,
                 "cold_s": round(e["seconds"], 4), "hits": int(e["hit"])}
                for e in self.entries
            ],
        }


# ---------------------------------------------------------------------------
# wall-clock attribution plane
# ---------------------------------------------------------------------------


def span_or_null(wall: "WallLedger | None", name: str):
    """`with span_or_null(wall, "dispatch"):` — nullcontext when the
    observatory is off, so driver loops carry one code path."""
    return wall.span(name) if wall is not None else nullcontext()


class WallLedger:
    """Per-chunk wall-clock attribution with a realtime-factor series.

    Protocol (driver loop):
        wall.sync_sim(int(state.now))          # once, before the loop
        ...
        wall.chunk_start()
        with wall.span("dispatch"): ...        # dispatch + block
        with wall.span("export"): ...          # drains/samples
        wall.chunk_end(int(state.now))         # closes the chunk

    Per-chunk exactness: chunk wall == sum of its spans, because the
    residual no span covered is folded into `host_python` at
    `chunk_end`. Overlapping attribution (a compile inside a dispatch,
    a snapshot inside a supervised dispatch) goes through
    `reattribute(frm, to, sec)`, which MOVES seconds between spans at
    chunk close (clamped at the source span's balance) instead of
    counting them twice.
    """

    def __init__(self, max_chunks: int = MAX_CHUNK_RECORDS):
        self.totals = {s: 0.0 for s in SPAN_NAMES}
        self.chunks: list[dict] = []
        self.chunks_total = 0
        self.chunks_dropped = 0
        self.max_chunks = int(max_chunks)
        self.rt_last: float | None = None
        self.wall0: float | None = None
        self._cur: dict | None = None
        self._t0: float | None = None
        self._moves: list[tuple[str, str, float]] = []
        self._last_sim_ns = 0

    def sync_sim(self, sim_ns: int) -> None:
        """Adopt the state's current sim time as the rt baseline, so a
        resumed/restored run's first chunk is not credited with the
        whole pre-restore horizon."""
        self._last_sim_ns = int(sim_ns)

    def chunk_start(self) -> None:
        self._cur = {s: 0.0 for s in SPAN_NAMES}
        self._t0 = time.monotonic()
        self._moves = []
        if self.wall0 is None:
            self.wall0 = self._t0

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sec = time.perf_counter() - t0
            if self._cur is not None:
                self._cur[name] = self._cur.get(name, 0.0) + sec
            else:
                # outside a chunk (warm-up work): totals-only accounting
                self.totals[name] = self.totals.get(name, 0.0) + sec

    def reattribute(self, frm: str, to: str, sec: float) -> None:
        """Move `sec` from span `frm` to span `to` inside the open chunk
        (applied clamped at chunk close). No-op outside a chunk."""
        if self._cur is not None and sec > 0:
            self._moves.append((frm, to, float(sec)))

    def pending_to(self, name: str) -> float:
        """Seconds already queued for reattribution INTO `name` in the
        open chunk — lets a caller measuring an enclosing interval
        subtract what an inner instrument already claimed."""
        return sum(s for _f, t, s in self._moves if t == name)

    def chunk_end(self, sim_ns: int) -> float | None:
        """Close the open chunk; returns its realtime factor."""
        if self._cur is None:
            return None
        t1 = time.monotonic()
        cur, self._cur = self._cur, None
        for frm, to, sec in self._moves:
            sec = min(sec, cur.get(frm, 0.0))
            cur[frm] = cur.get(frm, 0.0) - sec
            cur[to] = cur.get(to, 0.0) + sec
        self._moves = []
        wall = max(t1 - (self._t0 or t1), 0.0)
        cur["host_python"] += max(wall - sum(cur.values()), 0.0)
        for k, v in cur.items():
            self.totals[k] = self.totals.get(k, 0.0) + v
        sim_delta = max(int(sim_ns) - self._last_sim_ns, 0)
        self._last_sim_ns = int(sim_ns)
        rt = (sim_delta / 1e9) / max(wall, 1e-9)
        self.rt_last = rt
        self.chunks_total += 1
        rec = {
            "wall_s": wall, "sim_ns": sim_delta, "rt": rt,
            "spans": {k: v for k, v in cur.items() if v > 0},
        }
        if len(self.chunks) < self.max_chunks:
            self.chunks.append(rec)
        else:
            self.chunks_dropped += 1
        return rt

    # ---- exporters ---------------------------------------------------------

    def rt_series(self) -> list[float]:
        return [c["rt"] for c in self.chunks]

    def summary(self, total_wall_s: float | None = None) -> dict:
        attributed = sum(self.totals.values())
        rts = sorted(self.rt_series())
        chunk_walls = sum(c["wall_s"] for c in self.chunks)
        out: dict[str, Any] = {
            "spans_s": {k: round(v, 4) for k, v in self.totals.items()},
            "chunks": self.chunks_total,
            "chunks_recorded": len(self.chunks),
            "attributed_wall_s": round(attributed, 4),
            "chunk_wall_s": round(chunk_walls, 4),
        }
        if total_wall_s:
            out["total_wall_s"] = round(float(total_wall_s), 4)
            out["attributed_share"] = round(
                attributed / max(float(total_wall_s), 1e-9), 4
            )
        if attributed > 0:
            out["shares"] = {
                k: round(v / attributed, 4)
                for k, v in self.totals.items() if v > 0
            }
        if rts:
            series = self.rt_series()[-MAX_EXPORTED_SERIES:]
            out["realtime_factor"] = {
                "overall": round(
                    sum(c["sim_ns"] for c in self.chunks) / 1e9
                    / max(chunk_walls, 1e-9), 4,
                ),
                "last": round(self.rt_last or 0.0, 4),
                "p50": round(rts[len(rts) // 2], 4),
                "min": round(rts[0], 4),
                "max": round(rts[-1], 4),
                "series": [round(r, 4) for r in series],
                **(
                    {"series_dropped": self.chunks_total - len(series)}
                    if self.chunks_total > len(series) else {}
                ),
            }
        return out


def assemble_runtime_report(*, wall: WallLedger | None = None,
                            compiles: BuildLedger | None = None,
                            total_wall_s: float | None = None) -> dict:
    """The sim-stats `runtime{}` block: the wall ledger's summary (its
    `attributed_share` against `total_wall_s`, the run loop's wall) and
    the kernel-build ledger's under `compiles`."""
    out: dict[str, Any] = {}
    if wall is not None:
        out.update(wall.summary(total_wall_s))
    if compiles is not None:
        out["compiles"] = compiles.summary()
    return out
