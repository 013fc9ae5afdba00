"""The round trace ring (port of shadow_tpu/obs/tracer.py): a device ring
written by the round loop, and its host-side collector and exporters.

  device side: `TraceRing`, an int64 [1, R, F] tensor plus a [1] cursor in
  the state. The engine writes ONE row per completed round (kernel K27
  `trace_round`, ops/obs.py) recording what that round did: window bounds,
  events, microsteps, counter deltas, exchange traffic, the queue-occupancy
  high-water. The ring is an observer: rows are derived from values the
  round already computed and feed nothing back, so digests, event counts
  and drop counters are bit-identical with tracing on or off.

  host side: `RoundTracer` drains the ring at chunk boundaries, pairs
  rounds with wall-clock chunk spans, and exports a Chrome-trace/Perfetto
  JSON timeline, a Prometheus-style text metrics file and a summary dict
  for sim-stats.json.

Ring sizing: the driver sizes R = rounds_per_chunk, so a drain per chunk
can never wrap. A consumer that drains less often only loses the oldest
rows, counted in `RoundTracer.lost`, never silent. The collectors take the
ring as tensors or as numpy arrays already read to the host (the driver
reads the ring and the flow ledger in one device-to-host copy per chunk).
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple

import numpy as np

# one ring row per round; column order is the engine's write order
# (ops/obs.py trace_round, K27, writes the row by these indices)
TRACE_FIELDS = (
    "round",          # global round index at entry (== stats.rounds before)
    "window_start",   # completed-up-to time at round entry (ns)
    "window_end",     # this round's window end (ns)
    "events",         # events executed this round (this shard's hosts)
    "microsteps",     # queue dispatches this round (this shard)
    "popk_deferred",  # K-way batch events peeked but deferred (delta)
    "bq_rebuilds",    # wholesale block-cache rebuilds (delta)
    "ici_bytes",      # exchange-collective bytes (delta, this shard)
    "sends",          # outbox entries staged this round (this shard)
    "a2a_shed",       # all-to-all block-overflow sheds (delta)
    "occ_hwm",        # max per-host queue occupancy after the exchange
    "next_time",      # min queue head after the round (TIME_MAX if empty)
    "ob_hwm",         # max sends any ONE host staged this round (gear signal)
    "gear",           # active merge gear (outbox columns sorted; B = full)
    "faults_dropped", # fault-plane drops this round (delta, this shard)
    "faults_delayed", # fault-plane delays this round (delta, this shard)
    "hosts_down",     # hosts inside a crash window at this round's end
    "cap",            # active per-host queue capacity (pressure plane)
    # network observatory (obs/netobs.py; zero unless observability.network)
    "ec_timer",       # timer-class events executed this round (delta)
    "ec_pkt",         # packet-class events executed this round (delta)
    "ec_app",         # app-class events executed this round (delta)
    "flows",          # flows completed this round (delta, this shard)
    "bind_shard",     # shard whose local min bound the barrier this round
    # hierarchical exchange tiers of a multi-device mesh: zero on one
    # device, kept so that rows stay positional
    "xw_intra",       # intra-shard compaction staging bytes (delta)
    "xw_inter",       # inter-shard wire bytes (delta, this shard)
)
TRACE_COLS = len(TRACE_FIELDS)
(
    COL_ROUND,
    COL_WINDOW_START,
    COL_WINDOW_END,
    COL_EVENTS,
    COL_MICROSTEPS,
    COL_POPK_DEFERRED,
    COL_BQ_REBUILDS,
    COL_ICI_BYTES,
    COL_SENDS,
    COL_A2A_SHED,
    COL_OCC_HWM,
    COL_NEXT_TIME,
    COL_OB_HWM,
    COL_GEAR,
    COL_FAULTS_DROPPED,
    COL_FAULTS_DELAYED,
    COL_HOSTS_DOWN,
    COL_CAP,
    COL_EC_TIMER,
    COL_EC_PKT,
    COL_EC_APP,
    COL_FLOWS,
    COL_BIND_SHARD,
    COL_XW_INTRA,
    COL_XW_INTER,
) = range(TRACE_COLS)


# flow-track export cap (note_flows): complete events drawn per trace
MAX_FLOW_EVENTS = 20_000


class TraceRing(NamedTuple):
    """The device half: a bounded record buffer in the state. `rows` is
    [1, R, F] (the leading axis is the JAX package's shard axis, 1 on one
    device), `cursor` is [1]. The cursor counts rounds recorded since
    simulation start and is NEVER reset: writes land at `cursor % R`, and
    the host-side drain reconstructs the new rows from (previous cursor,
    current cursor), which keeps the drain read-only."""

    rows: Any  # i64[1, R, F]
    cursor: Any  # i64[1] rounds recorded since start (monotone)


def make_trace_ring(rounds: int, device) -> TraceRing:
    import torch

    return TraceRing(
        rows=torch.zeros((1, rounds, TRACE_COLS), dtype=torch.int64, device=device),
        cursor=torch.zeros((1,), dtype=torch.int64, device=device),
    )


def host_array(x) -> np.ndarray:
    """A tensor (any device) or an array, as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class RoundTracer:
    """Host-side collector/exporter for the device trace ring.

    Usage (the drivers wire this up when `observability.trace` is on):

        tracer = RoundTracer(ring_rounds=cfg.rounds_per_chunk)
        ...
        state = engine.run_chunk(state, params)   # rounds recorded by K27
        tracer.drain(state.trace, wall_t0=t0, wall_t1=t1)
        ...
        tracer.write_chrome_trace("trace.json")
        tracer.write_metrics("metrics.prom")
    """

    def __init__(self, ring_rounds: int):
        if ring_rounds <= 0:
            raise ValueError(f"ring_rounds must be > 0, got {ring_rounds}")
        self.ring_rounds = int(ring_rounds)
        self._cursor = 0  # rounds drained so far (device-cursor value)
        self._origin = 0  # device-cursor value when this tracer started
        self.lost = 0  # rounds overwritten before a drain reached them
        self._chunks: list[dict] = []  # wall spans paired with round counts
        self._rows: list[np.ndarray] = []  # [world, n, F] per drain
        self._wall0: float | None = None  # wall origin for the trace
        # wall-clock HBM samples (obs/memory.py MemoryMonitor, sampled at
        # chunk boundaries): (wall_t, (per-shard bytes,)) — exported as a
        # counter track on the wall-clock timeline + Prometheus gauges
        self._memory: list[tuple[float, tuple[int, ...]]] = []
        # drained flow-ledger records (obs/netobs.py FlowCollector rows,
        # [n, FLOW_COLS]) — exported as a sim-time flow track. Bounded:
        # beyond MAX_FLOW_EVENTS the newest records are counted, not drawn
        # (a million-flow run must not grow a GB-scale trace JSON).
        self._flows: list[np.ndarray] = []
        self._flows_seen = 0
        # integrity-sentinel violation notes (core/integrity.py): the
        # deterministic-abort naming dicts the driver hands over. A SIDE
        # channel, not a ring column: a violating chunk records at most
        # ONE violating round per attempt (the loop stops there), so
        # per-abort notes are complete.
        self._violations: list[dict] = []
        # runtime-observatory kernel-build records (obs/runtime.BuildLedger
        # .events(): (label, t0_monotonic, duration_s)), exported as a
        # compile track on the wall-clock timeline: builds happen on the
        # host, never inside the ring.
        self._compiles: list[tuple[str, float, float]] = []

    # ---- collection --------------------------------------------------------

    def sync_cursor(self, ring: TraceRing) -> int:
        """Adopt the ring's CURRENT cursor as the drain origin without
        exporting anything. Drivers call this once before their loop so a
        state restored from a checkpoint (or re-run after a prior loop)
        does not replay rows recorded before this tracer existed — those
        would otherwise be mis-read as fresh rounds and mis-counted as
        ring losses."""
        self._cursor = int(np.max(host_array(ring.cursor)))
        self._origin = self._cursor
        return self._cursor

    def drain(self, ring: TraceRing, *, wall_t0: float | None = None,
              wall_t1: float | None = None) -> int:
        """Pull rounds recorded since the last drain; returns how many."""
        cur = int(np.max(host_array(ring.cursor)))
        n = cur - self._cursor
        lost = max(0, n - self.ring_rounds) if n > 0 else 0
        if n > 0:
            self.lost += lost
            rows = host_array(ring.rows)  # [world, R, F]
            idx = [i % self.ring_rounds
                   for i in range(self._cursor + lost, cur)]
            self._rows.append(rows[:, idx, :])
            self._cursor = cur
        if wall_t0 is not None and wall_t1 is not None:
            if self._wall0 is None:
                self._wall0 = wall_t0
            # chunk records count EXPORTED rows only, so chunk totals always
            # reconcile with the round events in the trace (overwritten rows
            # are accounted in `lost`, not smeared into a chunk)
            self._chunks.append(
                {"t0": wall_t0, "t1": wall_t1, "rounds": max(n, 0) - lost}
            )
        return max(n, 0) - lost

    def truncate_to_round(self, rounds: int) -> int:
        """Drop drained rows whose global round index is >= `rounds`.

        The graceful-abort path exports state rewound to the supervisor's
        last snapshot, but chunks that SUCCEEDED after that snapshot were
        already drained — without this, trace totals would cover rounds
        the exported sim-stats prefix does not, breaking trace-vs-stats
        reconciliation in exactly the artifacts the abort path exists to
        keep trustworthy. The drivers call it with the rewound state's
        `stats.rounds`. Chunk records give their round counts back
        newest-first so chunk totals keep reconciling too. Returns how
        many rounds were dropped."""
        dropped = 0
        kept: list[np.ndarray] = []
        for seg in self._rows:
            # COL_ROUND is the global (replicated) round counter at round
            # entry, so shard 0's column is canonical for every shard
            mask = seg[0, :, COL_ROUND] < rounds
            n_drop = int((~mask).sum())
            if n_drop:
                dropped += n_drop
                seg = seg[:, mask, :]
            if seg.shape[1]:
                kept.append(seg)
        if dropped:
            self._rows = kept
            self._cursor -= dropped  # keep `rounds`/future drains coherent
            left = dropped
            for c in reversed(self._chunks):
                take = min(c["rounds"], left)
                c["rounds"] -= take
                left -= take
                if left <= 0:
                    break
        return dropped

    def note_memory(self, wall_t: float, per_shard_bytes) -> None:
        """Record one live-memory sample (per-shard bytes_in_use) against
        the wall clock. Pure observation — feeds only the exporters."""
        self._memory.append(
            (float(wall_t), tuple(int(b) for b in per_shard_bytes))
        )

    def note_flows(self, records: np.ndarray) -> None:
        """Adopt a batch of drained flow-ledger records ([n, FLOW_COLS],
        obs/netobs.py column order) for the sim-time flow track. Records
        beyond the export cap are counted in otherData, never silent."""
        n = int(records.shape[0])
        if n == 0:
            return
        kept = sum(r.shape[0] for r in self._flows)
        room = max(0, MAX_FLOW_EVENTS - kept)
        if room:
            self._flows.append(np.asarray(records[:room], np.int64))
        self._flows_seen += n

    def note_compiles(self, events) -> None:
        """Adopt the runtime observatory's kernel-build records ((label, t0,
        duration_s) tuples against the monotonic clock) for the
        wall-clock compile track. Replaces any prior set — the drivers
        hand over the ledger's full event list at export time."""
        self._compiles = [
            (str(n), float(t0), float(d)) for n, t0, d in events
        ]

    def note_violation(self, info: dict) -> None:
        """Record a deterministic integrity violation (the controller's
        iv_deterministic dict: signature [(shard, round, mask)...] +
        detail text) for the exported trace — rendered as an instant
        event on the sim-time timeline and surfaced in summary()."""
        self._violations.append(dict(info))

    def reset_flows(self, records: np.ndarray) -> None:
        """Replace the flow track with exactly `records` — the abort
        paths call this with the FlowCollector's post-truncation record
        set so the drawn track covers exactly the exported prefix (the
        flow-track analogue of `truncate_to_round`; without it, flows
        drained from chunks the export rewound past would still be
        drawn)."""
        self._flows = []
        self._flows_seen = 0
        self.note_flows(np.asarray(records, np.int64))

    @property
    def rounds(self) -> int:
        return self._cursor - self._origin - self.lost

    def rows(self) -> np.ndarray:
        """All drained records, [world, N, F] (N = rounds traced)."""
        if not self._rows:
            return np.zeros((1, 0, TRACE_COLS), np.int64)
        return np.concatenate(self._rows, axis=1)

    # ---- exporters ---------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON (the `traceEvents` array format).

        Two timelines, distinguished by pid:
          pid 1 "sim-time"  — one complete ("X") event per ROUND, ts/dur in
            sim-time microseconds (1 sim ns -> 1 trace ns is too fine for
            the viewers; us keeps 120 sim-s runs navigable). Shard 0's row
            is the canonical record (cat "round", exactly one per completed
            round); other shards' rows ride on their own tids (cat
            "round_shard"). Rounds that staged exchange traffic add an
            instant event on the "exchange" track.
          pid 2 "wall-clock" — one X event per CHUNK dispatch, ts in
            wall microseconds since the first chunk.
        """
        ev: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "sim-time (rounds)"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "wall-clock (chunks)"}},
        ]
        rows = self.rows()
        world = rows.shape[0]
        for s in range(world):
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": s + 1, "args": {"name": f"rounds shard {s}"}})
        ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                   "tid": world + 1, "args": {"name": "exchange"}})
        if self._flows:
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": world + 2, "args": {"name": "flows"}})
        for s in range(world):
            for r in rows[s]:
                args = {f: int(v) for f, v in zip(TRACE_FIELDS, r)}
                ts = r[COL_WINDOW_START] / 1e3  # sim ns -> us
                dur = max(int(r[COL_WINDOW_END] - r[COL_WINDOW_START]), 1) / 1e3
                ev.append({
                    "name": f"round {int(r[COL_ROUND])}",
                    "cat": "round" if s == 0 else "round_shard",
                    "ph": "X", "ts": ts, "dur": dur,
                    "pid": 1, "tid": s + 1, "args": args,
                })
                if s == 0 and (r[COL_SENDS] > 0 or r[COL_A2A_SHED] > 0):
                    ev.append({
                        "name": f"exchange {int(r[COL_SENDS])} sends",
                        "cat": "exchange", "ph": "i", "s": "t",
                        "ts": r[COL_WINDOW_END] / 1e3,
                        "pid": 1, "tid": world + 1,
                        "args": {"sends": int(r[COL_SENDS]),
                                 "a2a_shed": int(r[COL_A2A_SHED]),
                                 "ici_bytes": int(r[COL_ICI_BYTES])},
                    })
        # flow track (obs/netobs.py ledger records): one complete event per
        # drained flow, spanning [t_start, t_end) on the sim-time timeline
        if self._flows:
            from shadow_tpu_torch.obs.netobs import (
                FCOL_BYTES, FCOL_DST, FCOL_FLOW, FCOL_RETRANSMITS,
                FCOL_SRC, FCOL_T_END, FCOL_T_START,
            )

            for rec in np.concatenate(self._flows, axis=0):
                ts = rec[FCOL_T_START] / 1e3  # sim ns -> us
                dur = max(int(rec[FCOL_T_END] - rec[FCOL_T_START]), 1) / 1e3
                ev.append({
                    "name": f"flow {int(rec[FCOL_SRC])}"
                            f"->{int(rec[FCOL_DST])}",
                    "cat": "flow", "ph": "X", "ts": ts, "dur": dur,
                    "pid": 1, "tid": world + 2,
                    "args": {
                        "flow": int(rec[FCOL_FLOW]),
                        "bytes": int(rec[FCOL_BYTES]),
                        "retransmits": int(rec[FCOL_RETRANSMITS]),
                    },
                })
        # wall-clock anchor: the earliest of the first chunk's start,
        # the first memory sample, and the first build's t0 — kernels
        # build BEFORE the first chunk dispatch, and an anchor after it
        # would put the compile track at negative ts
        wall0 = self._wall0
        if self._memory and wall0 is None:
            wall0 = self._memory[0][0]
        if self._compiles:
            c0 = min(t0 for _n, t0, _d in self._compiles)
            wall0 = c0 if wall0 is None else min(wall0, c0)
        for i, c in enumerate(self._chunks):
            ev.append({
                "name": f"chunk {i}", "cat": "chunk", "ph": "X",
                "ts": (c["t0"] - (wall0 or 0.0)) * 1e6,
                "dur": max((c["t1"] - c["t0"]) * 1e6, 1.0),
                "pid": 2, "tid": 1,
                "args": {"rounds": c["rounds"]},
            })
        # wall-clock HBM counter track (obs/memory.py samples): Chrome's
        # "C" events render a stacked per-shard area under the chunk track
        for t, shards in self._memory:
            ev.append({
                "name": "hbm_bytes", "cat": "memory", "ph": "C",
                "ts": (t - (wall0 or 0.0)) * 1e6,
                "pid": 2, "tid": 1,
                "args": {f"shard{s}": b for s, b in enumerate(shards)},
            })
        # runtime-observatory compile track (obs/runtime.BuildLedger):
        # one X event per recorded kernel build, under the chunk
        # track — a cold build inside a chunk's wall reads directly
        # against that chunk's span
        if self._compiles:
            ev.append({"ph": "M", "name": "thread_name", "pid": 2,
                       "tid": 2, "args": {"name": "compiles"}})
            for name, t0, dur in self._compiles:
                ev.append({
                    "name": name, "cat": "compile", "ph": "X",
                    "ts": (t0 - (wall0 or 0.0)) * 1e6,
                    "dur": max(dur * 1e6, 1.0),
                    "pid": 2, "tid": 2,
                })
        # integrity-violation track: one instant event per recorded
        # deterministic violation, anchored to the violating round's
        # window when its row was traced (violating attempts are usually
        # discarded pre-drain, so fall back to the last traced window)
        if self._violations:
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": world + 3, "args": {"name": "integrity"}})
            last_ts = (
                rows[0, -1, COL_WINDOW_END] / 1e3 if rows.shape[1] else 0.0
            )
            for v in self._violations:
                ts = last_ts
                for _shard, rnd, _mask in v.get("signature", []):
                    hit = rows[0][rows[0][:, COL_ROUND] == rnd]
                    if hit.shape[0]:
                        ts = hit[0][COL_WINDOW_START] / 1e3
                    break
                ev.append({
                    "name": "integrity violation", "cat": "integrity",
                    "ph": "i", "s": "g", "ts": ts,
                    "pid": 1, "tid": world + 3,
                    "args": {k: v[k] for k in ("signature", "detail")
                             if k in v},
                })
        other = {
            "rounds_traced": self.rounds,
            "rounds_lost": self.lost,
            "trace_fields": list(TRACE_FIELDS),
        }
        if self._flows_seen:
            drawn = sum(r.shape[0] for r in self._flows)
            other["flows_drawn"] = drawn
            other["flows_not_drawn"] = self._flows_seen - drawn
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def totals(self) -> dict:
        """Summed/maxed counters over every traced round (all shards).
        The empty-trace case returns zeros under the SAME keys, so the
        sim-stats `trace` block's schema never depends on whether any
        round was drained."""
        rows = self.rows()
        flat = rows.reshape(-1, TRACE_COLS)
        empty = flat.shape[0] == 0

        def _sum(col):
            return 0 if empty else int(flat[:, col].sum())

        def _max(col):
            return 0 if empty else int(flat[:, col].max())

        return {
            "events": _sum(COL_EVENTS),
            "microsteps": _sum(COL_MICROSTEPS),
            "popk_deferred": _sum(COL_POPK_DEFERRED),
            "bq_rebuilds": _sum(COL_BQ_REBUILDS),
            "ici_bytes": _sum(COL_ICI_BYTES),
            "sends": _sum(COL_SENDS),
            "a2a_shed": _sum(COL_A2A_SHED),
            "occ_hwm": _max(COL_OCC_HWM),
            "next_time": _max(COL_NEXT_TIME),
            "ob_hwm": _max(COL_OB_HWM),
            "faults_dropped": _sum(COL_FAULTS_DROPPED),
            "faults_delayed": _sum(COL_FAULTS_DELAYED),
            "hosts_down_max": _max(COL_HOSTS_DOWN),
            "cap_max": _max(COL_CAP),
            # network-observatory columns (zero on untraced-netobs runs)
            "ec_timer": _sum(COL_EC_TIMER),
            "ec_pkt": _sum(COL_EC_PKT),
            "ec_app": _sum(COL_EC_APP),
            "flows": _sum(COL_FLOWS),
        }

    def gear_histogram(self) -> dict:
        """Rounds traced per active merge gear, {gear_cols: rounds}.
        Shard 0's rows are the canonical record (the gear is a chunk-wide
        static, identical on every shard). Empty when nothing is traced."""
        rows = self.rows()
        if rows.shape[1] == 0:
            return {}
        gears, counts = np.unique(rows[0, :, COL_GEAR], return_counts=True)
        return {int(g): int(c) for g, c in zip(gears, counts)}

    def summary(self) -> dict:
        """Compact digest for sim-stats.json embedding."""
        chunks = [c for c in self._chunks if c["rounds"] > 0]
        wall = sum(c["t1"] - c["t0"] for c in chunks)
        t = self.totals()
        return {
            "rounds_traced": self.rounds,
            "rounds_lost": self.lost,
            "chunks": len(chunks),
            "rounds_per_chunk": round(
                self.rounds / max(len(chunks), 1), 2
            ),
            "wall_seconds_traced": round(wall, 4),
            "events": t["events"],
            "microsteps": t["microsteps"],
            "queue_occupancy_hwm": t["occ_hwm"],
            "ici_bytes": t["ici_bytes"],
            **(
                {"integrity_violations": [dict(v) for v in self._violations]}
                if self._violations else {}
            ),
        }

    def to_metrics_text(self, extra: dict | None = None) -> str:
        """Prometheus text exposition format (one final scrape's worth):
        counters totalled over the run, gauges for the high-water marks.
        `extra` adds flat {name: number} gauges (e.g. report fields)."""
        t = self.totals()
        rows = self.rows()
        lines: list[str] = []
        seen: set[str] = set()

        def metric(name, kind, value, help_txt, labels=""):
            if name in seen:  # one HELP/TYPE block per metric name, or the
                return  # exposition file is unscrapeable
            seen.add(name)
            lines.append(f"# HELP shadow_tpu_{name} {help_txt}")
            lines.append(f"# TYPE shadow_tpu_{name} {kind}")
            lines.append(f"shadow_tpu_{name}{labels} {value}")

        metric("rounds_total", "counter", self.rounds,
               "scheduling rounds traced")
        metric("rounds_lost_total", "counter", self.lost,
               "rounds overwritten in the ring before a drain")
        metric("events_total", "counter", t["events"],
               "events executed in traced rounds")
        metric("microsteps_total", "counter", t["microsteps"],
               "queue dispatches in traced rounds")
        metric("popk_deferred_total", "counter", t["popk_deferred"],
               "K-way batch events peeked but deferred")
        metric("bq_rebuilds_total", "counter", t["bq_rebuilds"],
               "wholesale bucket-cache rebuilds")
        metric("ici_bytes_total", "counter", t["ici_bytes"],
               "exchange-collective bytes moved")
        metric("exchange_sends_total", "counter", t["sends"],
               "outbox entries exchanged")
        metric("a2a_shed_total", "counter", t["a2a_shed"],
               "all-to-all block-overflow sheds")
        metric("queue_occupancy_hwm", "gauge", t["occ_hwm"],
               "max per-host queue occupancy observed after any exchange")
        metric("faults_dropped_total", "counter", t["faults_dropped"],
               "events/packets discarded by injected faults")
        metric("faults_delayed_total", "counter", t["faults_delayed"],
               "events/packets delayed by injected faults")
        metric("hosts_down_max", "gauge", t["hosts_down_max"],
               "max hosts simultaneously inside a crash window")
        if self._memory:
            last = self._memory[-1][1]
            peak = [
                max(s[i] for _, s in self._memory)
                for i in range(len(last))
            ]
            metric("hbm_bytes_in_use", "gauge", max(last),
                   "per-shard live bytes at the last memory sample (max)")
            metric("hbm_peak_bytes", "gauge", max(peak),
                   "per-shard HBM high-water across the run (max)")
            for s in range(len(last)):
                lines.append(
                    f'shadow_tpu_shard_hbm_bytes_in_use{{shard="{s}"}} '
                    f"{last[s]}"
                )
                lines.append(
                    f'shadow_tpu_shard_hbm_peak_bytes{{shard="{s}"}} '
                    f"{peak[s]}"
                )
        if rows.shape[1] > 0:
            metric("sim_time_ns", "gauge",
                   int(rows[0, -1, COL_WINDOW_END]),
                   "simulated time completed by the last traced round")
        for s in range(rows.shape[0]):
            if rows.shape[1] == 0:
                break
            lines.append(
                f'shadow_tpu_shard_events_total{{shard="{s}"}} '
                f"{int(rows[s, :, COL_EVENTS].sum())}"
            )
            lines.append(
                f'shadow_tpu_shard_occupancy_hwm{{shard="{s}"}} '
                f"{int(rows[s, :, COL_OCC_HWM].max())}"
            )
        for k, v in (extra or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                metric(k, "gauge", v, "driver-report field")
        return "\n".join(lines) + "\n"

    def write_metrics(self, path: str, extra: dict | None = None) -> str:
        with open(path, "w") as f:
            f.write(self.to_metrics_text(extra))
        return path

    def write_artifacts(self, data_dir: str, obs, report: dict | None = None):
        """Export everything `observability:` asked for into the data dir —
        the one code path both drivers (sim.py / cosim.py) share. `obs` is
        the ObservabilityOptions block; `report` feeds extra gauges into
        the metrics file (to_metrics_text keeps only the numeric fields)."""
        if obs.trace_file:
            self.write_chrome_trace(os.path.join(data_dir, obs.trace_file))
        if obs.metrics_file:
            self.write_metrics(
                os.path.join(data_dir, obs.metrics_file), extra=report
            )
