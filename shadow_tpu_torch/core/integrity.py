"""The integrity sentinel (B15): a copy of the host side of the JAX package's
`core/integrity.py` (invariant names, the dual-digest constants, the
violation signature and its classification), the per-round check's plain
PyTorch version and the wrapper of K24.

With `integrity.enabled` every round is judged against conservation laws
that every legal trajectory satisfies, whatever the workload (bit positions
in `stats.iv_mask`):

  IV_TIME     no slot holds a time below the round-entry raw minimum of the
              queue (and the wheel), and, under static runahead with strict
              time, the window never regresses below the committed time.
  IV_EC       event-class reconciliation: judged only with the network
              observatory, which the port does not run.
  IV_QFILL    a bucketed slab's live slots equal its fill caches (queue
              and wheel), judged before the exchange rebuilds the caches.
  IV_COUNTER  event, drop and fault counters never decrease within a round
              and are never negative; the wheel's drop lane stays 0.
  IV_OUTBOX   send cursors stay in [0, budget] and the count word in
              [0, H x budget].
  IV_DIGEST   a host with no executed event still holds both digest lanes'
              initial values.

The count of failed checks goes into `stats.integrity`, the bits into
`iv_mask` and the first violating round into `iv_round`, all zeroed on the
done-round. The chunk stops at the first violating round
(`Engine.run_chunk`); the run loop's controller (core/pressure.py) restores
the pre-chunk snapshot and replays: a violation that reproduces with the same
(shard, round, bitmask) signature raises `IntegrityAbort`, one that does not
is counted as transient.

`IntegrityCheck` runs the check in three stages (a chunk's entry, before the
exchange, after it): CPU states run `integrity_round_check_plain`, CUDA
states launch K24 (csrc/integrity.cu) once per stage. With the sentinel off
the engine builds no `IntegrityCheck` and allocates none of its lanes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.rng import u64
from shadow_tpu_torch.simtime import TIME_MAX

# invariant bit positions (stats.iv_mask); append-only — recorded masks
# in logs and artifacts are read by these positions
IV_TIME = 0
IV_EC = 1
IV_QFILL = 2
IV_COUNTER = 3
IV_OUTBOX = 4
IV_DIGEST = 5

IV_NAMES = (
    "time_monotonic",
    "event_class_reconcile",
    "queue_fill_cache",
    "counter_monotonic",
    "outbox_budget",
    "dual_digest_virgin",
)

# the second digest lane's fold constants: a different offset basis and
# an odd fold multiplier (an even one would shift one bit of history out
# of the fold per event)
DIGEST2_OFFSET = 0x9AE16A3B2F90404F
DIGEST2_PRIME = 0x5851F42D4C957F2D

_FNV_OFFSET_I64 = u64(0xCBF29CE484222325)
DIGEST2_OFFSET_I64 = u64(DIGEST2_OFFSET)


class IntegrityAbort(RuntimeError):
    """A deterministic invariant violation (reproduced at the same round
    with the same bitmask across a snapshot replay), or violations that
    persist without reproducing past `max_replays`. The driver exports
    the last good state; the report names the invariant, round and
    shard."""


def mask_names(mask: int) -> list[str]:
    """The invariant names a violation bitmask encodes."""
    out = [name for bit, name in enumerate(IV_NAMES) if mask & (1 << bit)]
    if mask >> len(IV_NAMES):
        out.append(f"unknown_bits=0x{mask >> len(IV_NAMES):x}")
    return out


def violation_total(state) -> int:
    """The cumulative violation count, read on the host (0 without the
    sentinel)."""
    lane = getattr(state.stats, "integrity", None)
    if lane is None:
        return 0
    return int(lane.max())


def violation_signature(state) -> tuple:
    """Canonical (shard, round, mask) tuple per violating shard (one shard
    on one device): the reproduction key the replay classifier compares."""
    masks = state.stats.iv_mask.cpu().numpy()
    first_round = state.stats.iv_round.cpu().numpy()
    return tuple(
        (int(shard), int(first_round[shard]), int(masks[shard]))
        for shard in range(masks.shape[0])
        if int(masks[shard]) != 0
    )


def describe_signature(sig: tuple) -> str:
    """Human-readable violation naming: invariant(s), round, shard."""
    if not sig:
        return "no violating shard recorded"
    return "; ".join(
        f"shard {shard}: invariant(s) {'+'.join(mask_names(mask))} "
        f"(mask 0x{mask:x}) at round {rnd}"
        for shard, rnd, mask in sig
    )


def raise_if_violated(state, baseline: int = 0, context: str = ""):
    """Loud stop on any violation past `baseline`."""
    total = violation_total(state)
    if total <= baseline:
        return
    sig = violation_signature(state)
    prefix = f"{context}: " if context else ""
    raise IntegrityAbort(
        f"integrity: {prefix}invariant violated ({total - baseline} new "
        f"violation(s)) — {describe_signature(sig)}"
    )


def classify_digest_pair(
    primary_a: int, dual_a: Any, primary_b: int, dual_b: Any
) -> str:
    """Classify two completed runs' (primary, dual) digest folds:

      "clean"        — both lanes agree: same trajectory.
      "digest-plane" — primary lanes disagree but the independently-
                       folded dual lanes agree: the trajectories were
                       identical and one primary digest plane was
                       scribbled.
      "divergent"    — the dual lanes disagree: the trajectories really
                       differed.

    Dual folds may be None (sentinel off): then only "clean"/"divergent"
    are distinguishable from the primary lane."""
    if dual_a is None or dual_b is None:
        return "clean" if primary_a == primary_b else "divergent"
    if int(dual_a) == int(dual_b):
        return "clean" if primary_a == primary_b else "digest-plane"
    return "divergent"


# --------------------------------------------------------------------------
# the per-round check
# --------------------------------------------------------------------------

# the stats counter lanes IV_COUNTER watches, events first (the fault
# lanes only where the fault plane is on)
_COUNTER_LANES = ("events", "pkts_sent", "pkts_lost", "pkts_unreachable", "pkts_codel_dropped",
                  "pkts_delivered", "pkts_budget_dropped")


def counter_lanes(state, stats=None) -> list[torch.Tensor]:
    """The i64[H] lanes IV_COUNTER holds monotone: the stats counters, the
    fault counters where present, the queue's drop lane and, with the
    wheel, its spill lane."""
    s = state.stats if stats is None else stats
    lanes = [getattr(s, f) for f in _COUNTER_LANES]
    if s.faults_dropped is not None:
        lanes += [s.faults_dropped, s.faults_delayed]
    lanes.append(state.queue.dropped)
    if state.wheel is not None:
        lanes.append(s.wheel_spilled)
    return lanes


class RoundEntry(NamedTuple):
    """A round's entry reads (stage 0's output on the CPU path)."""

    gmin_raw: torch.Tensor  # i64[]: raw minimum of the queue's (and wheel's) time plane
    counters: list  # i64[H] each, as counter_lanes orders them
    rounds: torch.Tensor  # i64[]


def round_entry_plain(state) -> RoundEntry:
    gmin = state.queue.t.min()
    if state.wheel is not None:
        gmin = torch.minimum(gmin, state.wheel.t.min())
    return RoundEntry(gmin, [x.clone() for x in counter_lanes(state)], state.stats.rounds.clone())


def _fill_mismatch(q) -> torch.Tensor:
    occ = (q.t != TIME_MAX).sum(dim=1, dtype=torch.int32)
    return (occ != q.bfill.sum(dim=1, dtype=torch.int32)).any()


def integrity_round_check_plain(cfg, entry: RoundEntry, st_m, st_x, stats, window_end: int,
                                done: bool, now0: int):
    """The round's guards (the JAX package's `_integrity_round_check`):
    `entry` holds the round-entry reads, `st_m` is the state after the
    microsteps (before the exchange), `st_x` after the exchange, `stats`
    its stats with the round's counters folded in. Returns (violations
    i64[], bitmask i64[]), zero on the done-round."""
    checks = []
    post_min = st_x.queue.t.min()
    if st_x.wheel is not None:
        post_min = torch.minimum(post_min, st_x.wheel.t.min())
    t_bad = post_min < entry.gmin_raw
    if cfg.integrity_strict_time and not cfg.use_dynamic_runahead:
        t_bad = t_bad | (window_end < now0)
    checks.append((IV_TIME, t_bad))
    if cfg.queue_block:
        checks.append((IV_QFILL, _fill_mismatch(st_m.queue)))
    if st_m.wheel is not None:
        checks.append((IV_QFILL, _fill_mismatch(st_m.wheel)))
    c_bad = torch.zeros((), dtype=torch.bool, device=post_min.device)
    for post, pre in zip(counter_lanes(st_x, stats), entry.counters):
        c_bad = c_bad | (post < pre).any() | (post < 0).any()
    if st_x.wheel is not None:
        c_bad = c_bad | (st_x.wheel.dropped != 0).any()
    checks.append((IV_COUNTER, c_bad))
    b = cfg.sends_per_host_round
    count = st_m.outbox.count[0].to(torch.int64)
    sr = st_m.sent_round
    checks.append((IV_OUTBOX, (sr.max() > b) | (sr.min() < 0) | (count < 0)
                   | (count > st_m.outbox.t.shape[0] * b)))
    virgin = stats.digest != _FNV_OFFSET_I64
    if cfg.integrity_dual:
        virgin = virgin | (stats.digest2 != DIGEST2_OFFSET_I64)
    checks.append((IV_DIGEST, ((stats.events == 0) & virgin).any()))
    mask = torch.zeros((), dtype=torch.int64, device=post_min.device)
    viol = torch.zeros((), dtype=torch.int64, device=post_min.device)
    for bit, bad in checks:
        bad = bad & (not done)
        mask = mask | torch.where(bad, 1 << bit, 0)
        viol = viol + bad.to(torch.int64)
    return viol, mask


def fold_violations(stats, entry_rounds, viol, mask):
    """The round's count and bits into the stats lanes; the first
    violating round (the entry round count) is kept."""
    return stats._replace(
        integrity=stats.integrity + viol,
        iv_mask=stats.iv_mask | mask,
        iv_round=torch.where((stats.iv_round < 0) & (mask != 0), entry_rounds, stats.iv_round),
    )


_check_k = CudaKernel("integrity", "integrity_round_check", ARG_BLOCK)


class IntegrityCheck:
    """The engine's per-round check, staged: `enter(state)` at a chunk's
    first round, `pre_exchange(st_m)` after the microsteps, and
    `post_exchange(st_x, stats, window_end, done, now0)` after the
    exchange, which returns the stats with the round's result folded in
    and makes the post-exchange reads the next round's entry. On CUDA each
    stage is one K24 launch over a scratch this object keeps; on the CPU
    the plain version runs at `post_exchange`."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._entry: RoundEntry | None = None
        self._st_m = None
        self._scratch: torch.Tensor | None = None

    # ---- CUDA ---------------------------------------------------------------

    def _launch(self, stage: int, st, stats=None, window_end: int = 0, done: bool = False,
                now0: int = 0) -> None:
        cfg = self.cfg
        s = st.stats if stats is None else stats
        q, w = st.queue, st.wheel
        h, c = q.t.shape
        lanes = counter_lanes(st, s)
        if self._scratch is None or self._scratch.shape[0] != 5 + len(lanes) * h:
            self._scratch = torch.zeros((5 + len(lanes) * h,), dtype=torch.int64,
                                        device=q.t.device)
            self._scratch[4] = TIME_MAX
        for x in lanes:
            check(x, torch.int64, (h,), "counter lane")
        for x, name in ((s.integrity, "integrity"), (s.iv_mask, "iv_mask"),
                        (s.iv_round, "iv_round")):
            check(x, torch.int64, (1,), name)
        check(s.digest, torch.int64, (h,), "digest")
        if s.digest2 is not None:
            check(s.digest2, torch.int64, (h,), "digest2")
        check(st.sent_round, torch.int32, (h,), "sent_round")
        check(q.t, torch.int64, (h, c), "queue t")
        bq = getattr(q, "bfill", None) if cfg.queue_block else None
        if bq is not None:
            check(bq, torch.int32, (h, bq.shape[1]), "queue bfill")
        sw = w.t.shape[1] if w is not None else 0
        if w is not None:
            check(w.t, torch.int64, (h, sw), "wheel t")
            check(w.bfill, torch.int32, (h, w.bfill.shape[1]), "wheel bfill")
        strict = int(cfg.integrity_strict_time and not cfg.use_dynamic_runahead)
        _check_k(arg_block([
            stage, h, c, sw, len(lanes), strict, int(done), cfg.sends_per_host_round,
            bq.shape[1] if bq is not None else 0, w.bfill.shape[1] if w is not None else 0,
            int(window_end), int(now0),
            addr(q.t), addr(w.t if w is not None else None), addr(bq),
            addr(w.bfill if w is not None else None),
            *(addr(x) for x in lanes),
            addr(w.dropped if w is not None else None), addr(st.sent_round),
            addr(st.outbox.count), addr(s.digest), addr(s.digest2), addr(s.rounds),
            addr(s.integrity), addr(s.iv_mask), addr(s.iv_round), addr(self._scratch),
        ]))

    # ---- the stages ---------------------------------------------------------

    def enter(self, st) -> None:
        """Stage 0: the entry reads of a chunk's first round."""
        if on_cpu(st.queue.t):
            self._entry = round_entry_plain(st)
        else:
            self._launch(0, st)

    def entry_min(self) -> torch.Tensor:
        """The round-entry raw time minimum (a 0-d device tensor), which a
        mesh reduces over its ranks before the round's guards read it."""
        if self._scratch is not None:
            return self._scratch[0]
        return self._entry.gmin_raw

    def set_entry_min(self, value: torch.Tensor) -> None:
        """Replace the round-entry minimum (with the mesh's)."""
        if self._scratch is not None:
            self._scratch[0] = value
        else:
            self._entry = self._entry._replace(gmin_raw=value)

    def pre_exchange(self, st_m) -> None:
        """Stage 1: the reads the exchange would erase (fill caches,
        outbox)."""
        if on_cpu(st_m.queue.t):
            # the plain check reads the pre-exchange state at stage 2 (on
            # the CPU the exchange makes new tensors and leaves it intact)
            self._st_m = st_m
        else:
            self._launch(1, st_m)

    def post_exchange(self, st_x, stats, window_end: int, done: bool, now0: int):
        """Stage 2: the post-exchange guards; returns `stats` with the
        round's result folded in."""
        if not on_cpu(st_x.queue.t):
            self._launch(2, st_x, stats, window_end, done, now0)
            return stats
        entry = self._entry
        viol, mask = integrity_round_check_plain(self.cfg, entry, self._st_m, st_x, stats,
                                                 window_end, done, now0)
        self._st_m = None
        stats = fold_violations(stats, entry.rounds, viol, mask)
        self._entry = round_entry_plain(st_x._replace(stats=stats))
        return stats


KERNELS = {"integrity_round_check": _check_k}

__all__ = [
    "DIGEST2_OFFSET",
    "DIGEST2_PRIME",
    "IV_NAMES",
    "IntegrityAbort",
    "IntegrityCheck",
    "classify_digest_pair",
    "describe_signature",
    "integrity_round_check_plain",
    "mask_names",
    "raise_if_violated",
    "violation_signature",
    "violation_total",
]
