"""Network observatory (port of shadow_tpu/obs/netobs.py): the flow
ledger, event-class accounting, per-link counters and the safe-window
report.

Four instruments behind one knob (`observability.network`), all observers:
digests, events and every drop counter are bit-identical with the
observatory on or off.

  event-class accounting: every executed event is classified as timer /
  packet / app (packet = the engine's KIND_PKT flag; timer = the model's
  declared `timer_kinds`; app = the rest) into three i64 stats lanes and
  per-round trace-ring columns (a lane of kernel K10, ops/chain.py).

  flow ledger: `FlowLedger`, a fixed-size flow-record ring appended at
  model flow completion (tgen FIN-ACK: the record lanes come from K17,
  the append is K28 `flow_append`, ops/obs.py) and drained at chunk
  boundaries like the trace ring (monotone cursor, writes at cursor % R,
  overwrite-lost accounting, `sync_cursor` checkpoint semantics). Three
  stats lanes (fl_done/fl_bytes/fl_rtx) carry the cumulative totals
  independently of the ring, so reconciliation is exact across wraps.

  per-link / per-host counters: a host-side fold of the engine's per-host
  packet and drop lanes (plus the model's `per_host_network` hook) over
  the host -> graph-node map into sim-stats `network.links{}`.

  safe-window telemetry: per round, the shard whose local minimum bound
  the barrier; on one device that is shard 0 in every round.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from shadow_tpu_torch.obs.tracer import host_array

# one ledger row per completed flow; column order is the engine's write
# order (ops/obs.py flow_append, K28, writes rows by these indices).
# APPEND-ONLY, like TRACE_FIELDS: recorded ledgers index by position.
FLOW_FIELDS = (
    "src",          # completing (client) host's global id
    "dst",          # peer (server) host's global id
    "flow",         # model flow index (tgen: the completed phase)
    "t_start",      # flow start sim-time (ns)
    "t_end",        # completion sim-time (ns)
    "bytes",        # application payload bytes transferred
    "retransmits",  # segments retransmitted within this flow
)
FLOW_COLS = len(FLOW_FIELDS)
(
    FCOL_SRC,
    FCOL_DST,
    FCOL_FLOW,
    FCOL_T_START,
    FCOL_T_END,
    FCOL_BYTES,
    FCOL_RETRANSMITS,
) = range(FLOW_COLS)


class FlowLedger(NamedTuple):
    """The device half: a bounded flow-record ring in the state (`rows` is
    [1, R, F], the JAX package's shard axis being 1 on one device;
    `cursor` is [1]). The cursor counts completions since simulation start
    and is never reset: writes land at `cursor % R`, and the host drain
    reconstructs new rows from (previous cursor, current cursor)."""

    rows: Any  # i64[1, R, F]
    cursor: Any  # i64[1] flows recorded since start (monotone)


def make_flow_ledger(records: int, device) -> FlowLedger:
    import torch

    return FlowLedger(
        rows=torch.zeros((1, records, FLOW_COLS), dtype=torch.int64, device=device),
        cursor=torch.zeros((1,), dtype=torch.int64, device=device),
    )


class FlowCollector:
    """Host-side drain/accumulator for the device flow ledger.

    Mirrors RoundTracer's cursor contract per shard: `sync_cursor` adopts
    the ring's current cursors (checkpoint-resume never replays
    pre-snapshot records), `drain` pulls records appended since the last
    drain and counts wrap-overwritten ones in `lost` — never silently.
    The drivers drain at every chunk boundary with the ring sized so a
    typical chunk cannot wrap; a burst beyond capacity loses the OLDEST
    records and the stats lanes (fl_*) still carry exact totals."""

    def __init__(self, ring_records: int):
        if ring_records <= 0:
            raise ValueError(
                f"ring_records must be > 0, got {ring_records}"
            )
        self.ring_records = int(ring_records)
        self._cursor: np.ndarray | None = None  # i64[world]
        self._origin: np.ndarray | None = None
        self._lost: np.ndarray | None = None
        # per shard: (base_cursor, rows) segments — rows cover the global
        # cursor range [base, base + len). Bases make truncation exact:
        # a record's global index says whether an exported prefix saw it.
        self._rows: list[list[tuple[int, np.ndarray]]] | None = None
        # per shard: (start_cursor, n) wrap-loss ranges, same global
        # indexing — so truncation can recount losses within a prefix
        self._lost_ranges: list[list[tuple[int, int]]] | None = None
        self.last_drained = np.zeros((0, FLOW_COLS), np.int64)

    def _ensure(self, world: int):
        if self._cursor is None:
            self._cursor = np.zeros((world,), np.int64)
            self._origin = np.zeros((world,), np.int64)
            self._lost = np.zeros((world,), np.int64)
            self._rows = [[] for _ in range(world)]
            self._lost_ranges = [[] for _ in range(world)]

    def _cursors_of(self, ledger: FlowLedger) -> np.ndarray:
        cur = host_array(ledger.cursor)
        self._ensure(cur.shape[0])
        if cur.shape[0] != self._cursor.shape[0]:
            raise ValueError(
                f"ledger world {cur.shape[0]} != collector world "
                f"{self._cursor.shape[0]}"
            )
        return cur

    def sync_cursor(self, ledger: FlowLedger) -> np.ndarray:
        """Adopt each shard's current cursor as its drain origin without
        exporting anything (RoundTracer.sync_cursor contract, per shard:
        a restored checkpoint's pre-existing records are not fresh
        completions and must not be replayed or counted as losses)."""
        cur = self._cursors_of(ledger)
        self._cursor = cur.copy()
        self._origin = cur.copy()
        return cur

    def drain(self, ledger: FlowLedger) -> int:
        """Pull records appended since the last drain; returns how many
        (all shards, wrap losses excluded — those count in `lost`)."""
        cur = self._cursors_of(ledger)
        if not (cur > self._cursor).any():
            self.last_drained = np.zeros((0, FLOW_COLS), np.int64)
            return 0
        rows = host_array(ledger.rows)  # [world, R, F]
        pulled = 0
        new: list[np.ndarray] = []
        for s in range(cur.shape[0]):
            n = int(cur[s] - self._cursor[s])
            if n <= 0:
                continue
            lost = max(0, n - self.ring_records)
            if lost:
                self._lost[s] += lost
                self._lost_ranges[s].append((int(self._cursor[s]), lost))
            base = int(self._cursor[s]) + lost
            idx = np.arange(base, int(cur[s])) % self.ring_records
            self._rows[s].append((base, rows[s][idx, :]))
            new.append(rows[s][idx, :])
            self._cursor[s] = cur[s]
            pulled += n - lost
        # this drain's records (all shards), for exporters that stream
        # (the tracer's flow track) — records() keeps the full history
        self.last_drained = (
            np.concatenate(new, axis=0) if new
            else np.zeros((0, FLOW_COLS), np.int64)
        )
        return pulled

    def truncate_to_cursor(self, cursors) -> int:
        """Drop the NEWEST drained records of each shard beyond the given
        cursor values — the graceful-abort shape (RoundTracer.
        truncate_to_round's sibling): the exported state was rewound to a
        snapshot, and its OWN `flows.cursor` says exactly how many
        completions the exported prefix saw, so records drained from
        post-snapshot chunks must not outlive it. Returns the drop
        count."""
        if self._cursor is None:
            return 0
        cursors = np.asarray(cursors, np.int64)
        dropped = 0
        for s in range(self._cursor.shape[0]):
            # an export cursor below the sync origin cannot un-see the
            # origin (the collector never held those records)
            tc = max(int(cursors[s]), int(self._origin[s]))
            if tc >= int(self._cursor[s]):
                continue
            dropped += int(self._cursor[s]) - tc
            self._cursor[s] = tc
            # held rows: keep exactly the global indices < tc (segment
            # bases make this exact even across wrap-loss gaps)
            kept: list[tuple[int, np.ndarray]] = []
            for base, seg in self._rows[s]:
                if base >= tc:
                    continue
                keep_n = min(seg.shape[0], tc - base)
                kept.append((base, seg[:keep_n]))
            self._rows[s] = kept
            # recount wrap losses within the kept prefix (a loss range
            # past tc never happened as far as the exported state saw)
            kept_ranges: list[tuple[int, int]] = []
            lost_total = 0
            for start, ln in self._lost_ranges[s]:
                if start >= tc:
                    continue
                ln = min(ln, tc - start)
                kept_ranges.append((start, ln))
                lost_total += ln
            self._lost_ranges[s] = kept_ranges
            self._lost[s] = lost_total
        return dropped

    @property
    def lost(self) -> int:
        return int(self._lost.sum()) if self._lost is not None else 0

    @property
    def count(self) -> int:
        if self._cursor is None:
            return 0
        return int((self._cursor - self._origin - self._lost).sum())

    def records(self) -> np.ndarray:
        """All drained records, [N, FLOW_COLS] (shards concatenated)."""
        if not self._rows or not any(self._rows):
            return np.zeros((0, FLOW_COLS), np.int64)
        segs = [
            seg for shard in self._rows for _, seg in shard if seg.shape[0]
        ]
        if not segs:
            return np.zeros((0, FLOW_COLS), np.int64)
        return np.concatenate(segs, axis=0)

    def fct_ns(self) -> np.ndarray:
        r = self.records()
        return r[:, FCOL_T_END] - r[:, FCOL_T_START]

    def summary(self) -> dict:
        """The collector's contribution to the sim-stats
        `network.flows{}` block. Empty drains return zeros under the
        same keys (stable schema). The byte/retransmit sums carry
        `drained_` prefixes deliberately: the UNPREFIXED `bytes`/
        `retransmits` in the flows block are the exact fl_* stats-lane
        totals (exact across ring wraps), and the drained sums must
        never shadow them — when records_lost is 0 the two pairs agree
        exactly, which is the real ledger-vs-lanes cross-check
        net_report --check enforces."""
        r = self.records()
        out: dict[str, Any] = {
            "records_drained": int(r.shape[0]),
            "records_lost": self.lost,
            "drained_bytes": int(r[:, FCOL_BYTES].sum()),
            "drained_retransmits": int(r[:, FCOL_RETRANSMITS].sum()),
        }
        out["fct"] = fct_stats(self.fct_ns())
        return out


def fct_stats(fct_ns: np.ndarray) -> dict:
    """Flow-completion-time distribution figures (ms)."""
    if fct_ns.size == 0:
        return {"n": 0, "p50_ms": None, "p99_ms": None, "mean_ms": None,
                "max_ms": None}
    f = np.asarray(fct_ns, np.float64) / 1e6
    return {
        "n": int(fct_ns.size),
        "p50_ms": round(float(np.percentile(f, 50)), 3),
        "p99_ms": round(float(np.percentile(f, 99)), 3),
        "mean_ms": round(float(f.mean()), 3),
        "max_ms": round(float(f.max()), 3),
    }


def event_class_report(timer: int, pkt: int, app: int) -> dict:
    """The `network.event_classes{}` block — the timer-share number
    ROADMAP item 2's timer-wheel decision gates on."""
    total = timer + pkt + app
    return {
        "timer": int(timer),
        "packet": int(pkt),
        "app": int(app),
        "total": int(total),
        "timer_share": round(timer / total, 4) if total else None,
        "packet_share": round(pkt / total, 4) if total else None,
    }


def safe_window_report(win_bound, rounds: int) -> dict:
    """The `network.safe_window{}` block: which shard bound the
    all-reduce-min barrier, per round. `win_bound[s]` counts the rounds
    shard s was the argmin (ties to the lowest shard id); on world=1 the
    single shard trivially binds every round."""
    bound = [int(x) for x in np.asarray(win_bound).reshape(-1)]
    total = sum(bound)
    argmax = int(np.argmax(bound)) if bound else 0
    return {
        "rounds": int(rounds),
        "bound_rounds_per_shard": bound,
        "critical_shard": argmax,
        "critical_share": (
            round(bound[argmax] / total, 4) if total else None
        ),
    }


# engine per-host drop lanes folded into the per-link report, by cause
_LINK_ENGINE_LANES = (
    ("pkts_sent", "packets_sent"),
    ("pkts_delivered", "packets_delivered"),
    ("pkts_lost", "drops_path_loss"),
    ("pkts_unreachable", "drops_unreachable"),
    ("pkts_codel_dropped", "drops_codel"),
    ("pkts_budget_dropped", "drops_budget"),
    ("faults_dropped", "drops_faults"),
)


def links_report(
    node_of, stats, num_real: int, model_per_host: dict | None = None
) -> dict:
    """Fold the per-host engine lanes (and the model's per-host network
    counters) over the host->graph-node map into per-link aggregates —
    the device-plane sibling of the CPU plane's per-interface tracker.
    `node_of` is the [num_real] host->node index map; keys are node
    indices as strings (JSON-stable)."""
    node_of = np.asarray(node_of)[:num_real]
    nodes = np.unique(node_of)
    per_host: dict[str, np.ndarray] = {}
    for lane, out_name in _LINK_ENGINE_LANES:
        v = getattr(stats, lane)
        per_host[out_name] = (np.zeros(num_real, np.int64) if v is None
                              else host_array(v)[:num_real])
    for k, v in (model_per_host or {}).items():
        per_host[k] = np.asarray(v)[:num_real]
    links: dict[str, dict] = {}
    for n in nodes:
        m = node_of == n
        links[str(int(n))] = {
            "hosts": int(m.sum()),
            **{k: int(v[m].sum()) for k, v in per_host.items()},
        }
    return links


def link_hwm(links: dict) -> dict:
    """Hot-spot maxima over the per-link fold (the bench-diff figures):
    the busiest link's packet and byte counts."""
    if not links:
        return {"packets_sent": 0, "bytes": 0}
    return {
        "packets_sent": max(
            link.get("packets_sent", 0) for link in links.values()
        ),
        "bytes": max(link.get("bytes", 0) for link in links.values()),
    }


def network_report(
    *,
    ec_timer: int,
    ec_pkt: int,
    ec_app: int,
    win_bound,
    rounds: int,
    fl: tuple[int, int, int] | None = None,
    collector: FlowCollector | None = None,
    links: dict | None = None,
) -> dict:
    """Assemble the sim-stats `network{}` block from the observatory's stats
    lanes, the drained flow collector, and the host-side per-link fold. `fl` is
    (fl_done, fl_bytes, fl_rtx) when the flow ledger ran."""
    out: dict[str, Any] = {
        "event_classes": event_class_report(ec_timer, ec_pkt, ec_app),
        "safe_window": safe_window_report(win_bound, rounds),
    }
    if fl is not None:
        done, fbytes, frtx = fl
        flows: dict[str, Any] = {
            "completed": int(done),
            "bytes": int(fbytes),
            "retransmits": int(frtx),
        }
        if collector is not None:
            flows.update(collector.summary())
        out["flows"] = flows
    if links is not None:
        out["links"] = links
        out["link_hwm"] = link_hwm(links)
    return out


def node_map(specs, num_real: int) -> np.ndarray:
    """host -> graph-node index map from a list of HostSpecs (the links
    fold's key space)."""
    node_of = np.zeros((num_real,), np.int32)
    for spec in specs:
        if spec.host_id < num_real:
            node_of[spec.host_id] = spec.node_index
    return node_of


def assemble_network_report(
    *,
    stats,
    num_real: int,
    rounds: int,
    node_of,
    model=None,
    model_state=None,
    flow_ledger: bool = False,
    collector: FlowCollector | None = None,
) -> dict:
    """The driver-side assembly of the sim-stats `network{}` block. `stats`
    is a Stats tuple of tensors or host arrays (this helper reads the
    ec_*/fl_*/win_bound lanes and the per-host packet lanes);
    `model_state` is a host-side model dict (numpy arrays), read once by
    the caller."""
    model_ph = None
    if model is not None and model_state is not None and hasattr(
        model, "per_host_network"
    ):
        model_ph = model.per_host_network(model_state)
    fl = None
    if flow_ledger:
        fl = (
            int(host_array(stats.fl_done).sum()),
            int(host_array(stats.fl_bytes).sum()),
            int(host_array(stats.fl_rtx).sum()),
        )
    return network_report(
        ec_timer=int(host_array(stats.ec_timer).sum()),
        ec_pkt=int(host_array(stats.ec_pkt).sum()),
        ec_app=int(host_array(stats.ec_app).sum()),
        win_bound=host_array(stats.win_bound),
        rounds=int(rounds),
        fl=fl,
        collector=collector,
        links=links_report(node_of, stats, num_real, model_ph),
    )
