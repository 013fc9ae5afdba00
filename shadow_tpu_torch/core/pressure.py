"""The run loop's snapshot-replay seam: merge-gear shifts, the pressure
plane's capacity escalation and the integrity sentinel's replays from one
pre-chunk snapshot (port of the JAX package's `core/pressure.py`
`ResilienceController`, with a copy of its `resolve_ladder`).

Every fixed-shape lane of the engine sheds under capacity pressure: a queue
push that finds no free slot and the exchange's overflow count into
`queue.dropped`, the send budget into `stats.pkts_budget_dropped`, the
outbox into `stats.ob_dropped`. The `pressure:` block makes that a policy:

  drop      — the default: drops are counted and the run goes on. No
              pressure code runs (no K26 launch, no stop lane).
  escalate  — drop-free. Each round after the exchange K26 writes the
              run's capacity-drop total into `stats.pressure`; the chunk
              stops after the first round where it grew (a lane of the
              window's read, no extra sync). The controller restores the
              pre-chunk snapshot, migrates the state to the next rung of
              the capacity ladder (queue slots, K25 `migrate_queue`)
              and/or of the outbox ladder (a fresh, wider outbox), and
              replays the chunk. Accepted chunks carry no drop, so the run
              equals one launched at the final shape with the pins of
              `Engine.resized_cfg`. Growth is also proactive: at a chunk
              boundary an occupancy high-water at `headroom` of the
              capacity, or an outbox high-water that filled the budget,
              grows the shape before anything drops.
  abort     — stop at the first dropping round: `PressureAbort`, with the
              dropping state kept for the report (`abort_export_state`).

When a grown shape's dispatch runs out of device memory
(`torch.OutOfMemoryError`, or "out of memory" in the message), every axis
above its base falls back one rung and the abandoned rungs are poisoned; a
queue shrink is taken only to a rung the live events fit
(`migration_fits`), otherwise the controller raises `PressureAbort`
(cornered) with the last good pre-chunk snapshot kept. With the memory
observatory on, `memory` (obs/memory.py `MemoryGuard`) admits a grown rung
BEFORE its dispatch only when its predicted extra bytes fit the measured
headroom: a refused reactive rung corners the escalation (`PressureAbort`),
a refused proactive one is trimmed to a single axis or skipped; the report
then carries `memory_refusals` and `headroom_bytes`, as the JAX package's
does. `wall` (obs/runtime.py `WallLedger`) receives the snapshot and
restore seconds, moved out of the dispatch span.

The other two branches, in the JAX package's order:

  integrity — a chunk whose per-round guards tripped (core/integrity.py;
              the chunk stopped at the violating round) is restored from
              the pre-chunk snapshot and replayed at the same shape. A
              violation that reproduces with the same (shard, round,
              bitmask) signature is deterministic: `IntegrityAbort`. One
              that does not is transient: counted, and the clean replay is
              accepted. `max_replays` bounds the replays of one chunk.
  gears     — a chunk that shed at a narrow merge gear is restored and
              replayed wider (core/gears.py).

Shapes are read from the STATE on every chunk, not from controller memory:
a supervisor rewind can hand back a pre-migration state. Decisions read
device counters between dispatches and feed deterministic replays; they can
cost replays, never change a result.

`test_scribble` (None in production) is a seam for the tests: a callable
(state, attempt) -> state applied after the pre-chunk snapshot and before
each dispatch attempt, so a one-shot change to the state does not survive
into the replay, as corruption of in-flight buffers would not.

The per-round signal the engine's chunk stop reads is K26
(`ops/pressure.py`).
"""

from __future__ import annotations

import math
import time
from typing import Any

import torch

from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
from shadow_tpu_torch.core.engine import make_empty_outbox
from shadow_tpu_torch.core.integrity import IntegrityAbort, describe_signature
from shadow_tpu_torch.ops.events import migrate_queue, migration_fits

DEFAULT_MAX_CAPACITY_FACTOR = 8  # auto max_capacity = 8x the base slab
DEFAULT_MAX_OUTBOX_FACTOR = 4  # auto max_outbox = 4x the base budget
_CATEGORIES = ("queue", "budget", "a2a", "outbox")


class PressureAbort(RuntimeError):
    """The pressure policy stopped the run: `abort` saw its first drop, or
    `escalate` was cornered (drops persist with no usable rung left).
    `ResilienceController.abort_export_state` names the state to report."""


def _is_oom(e: BaseException) -> bool:
    """A grown shape ran out of device memory: PyTorch's allocator error,
    or an out-of-memory message (CUDA's "CUDA out of memory"). Any other
    failure propagates to the supervisor and the run loop."""
    return isinstance(e, torch.OutOfMemoryError) or "out of memory" in str(e).lower()


def resolve_ladder(base: int, ceiling: int, growth: int) -> list[int]:
    """Geometric shape ladder [base, base*g, ...] bounded by `ceiling`
    (inclusive); the base rung is always present."""
    base, ceiling, growth = int(base), int(ceiling), int(growth)
    ladder = [base]
    while ladder[-1] * growth <= ceiling:
        ladder.append(ladder[-1] * growth)
    return ladder


def capacity_ladder(cap: int, pressure) -> list[int]:
    """The queue-capacity rungs of an escalate run launched at `cap`."""
    return resolve_ladder(cap, pressure.max_capacity or cap * DEFAULT_MAX_CAPACITY_FACTOR,
                          pressure.growth_factor)


def _category_lanes(state) -> list[torch.Tensor]:
    """The per-category drop totals as device scalars, in `_CATEGORIES`
    order (the all-to-all's is 0 on one device)."""
    s = state.stats
    q = state.queue.dropped.sum()
    return [q, s.pkts_budget_dropped.sum(), s.a2a_shed.sum(), s.ob_dropped.sum()]


def read_rows(engine, lanes: list[torch.Tensor]) -> list[list[int]]:
    """Device scalars as host ints in one device-to-host read, one row per
    rank (every rank's row across a mesh, so that every rank takes the same
    decision from them; counted in `engine.host_syncs`)."""
    v = torch.stack([x.to(torch.int64) for x in lanes])
    engine.host_syncs += 1
    coll = getattr(engine, "coll", None)
    if coll is None:
        return [v.tolist()]
    return coll.host_rows(v).tolist()


class ResilienceController:
    """The run loop's chunk step: gear shifts, capacity regrows and integrity
    replays from one snapshot.

    `gearctl` is a `core.gears.GearController` or None (full width always);
    `pressure` a `PressureOptions` with an active policy (escalate/abort)
    or None; `integrity` an `IntegrityOptions` (enabled) or None;
    `queue_block` the configured block of a bucketed queue (0 = flat), the
    layout a migrated queue keeps."""

    def __init__(self, *, gearctl=None, pressure=None, integrity=None, queue_block: int = 0,
                 log=None, memory=None, wall=None):
        self.gearctl = gearctl
        self.memory = memory  # obs.memory.MemoryGuard | None
        self.wall = wall  # obs.runtime.WallLedger | None
        self.memory_refusals = 0  # rungs the memory guard refused pre-dispatch
        self._proactive_refused = None  # the last skipped proactive regrow
        if pressure is not None and not getattr(pressure, "active", True):
            pressure = None  # policy drop: no pressure code runs
        self.pressure = pressure
        self.integrity = integrity
        self.integrity_on = bool(integrity is not None and getattr(integrity, "enabled", False))
        self.iv_transients = 0  # violations that did not reproduce
        self.iv_replays = 0  # chunk replays the sentinel forced
        self.iv_deterministic: dict | None = None  # the abort's naming
        self.test_scribble = None
        self.queue_block = int(queue_block)
        self._log = log
        self.policy = pressure.policy if pressure is not None else "drop"
        self.escalate = self.policy == "escalate"
        self.abort_on_drop = self.policy == "abort"
        # ladders resolve from the first state seen (the base shape lives
        # in the state)
        self._cap_ladder: list[int] | None = None
        self._box_ladder: list[int] | None = None
        self._cap_poisoned: set[int] = set()  # rungs that ran out of memory
        self._box_poisoned: set[int] = set()
        self.regrows = 0  # reactive migrations (drop -> replay)
        self.proactive_regrows = 0  # headroom-driven boundary migrations
        self.replays = 0  # chunks replayed after a pressure stop
        self.oom_fallbacks = 0  # grown shapes that ran out of memory
        self.aborted = False
        self.last_error: str | None = None
        self.syncs = 0  # device-to-host reads outside the engine's count
        self._abort_state = None  # abort policy: the dropping state
        self._last_snap = None

    # ---- the abort policy ---------------------------------------------------

    @staticmethod
    def _raise_dropped(cats: dict, baseline: dict | None = None):
        """Raise PressureAbort naming the categories that grew past
        `baseline` (None = zero)."""
        base = baseline or {k: 0 for k in cats}
        detail = ", ".join(f"{k}+{v - base[k]}" for k, v in sorted(cats.items()) if v > base[k])
        raise PressureAbort(f"pressure: abort policy hit its first capacity drop ({detail})")

    # ---- ladders -----------------------------------------------------------

    def _ensure_ladders(self, cap: int, budget: int):
        if self._cap_ladder is not None:
            return
        p = self.pressure
        self._cap_ladder = capacity_ladder(cap, p)
        self._box_ladder = resolve_ladder(
            budget, p.max_outbox or budget * DEFAULT_MAX_OUTBOX_FACTOR, p.growth_factor)

    @staticmethod
    def _next_rung(ladder: list[int], cur: int, poisoned=()) -> int | None:
        for rung in ladder:
            if rung > cur and rung not in poisoned:
                return rung
        return None

    def _say(self, msg: str):
        if self._log is not None:
            print(f"[pressure] {msg}", file=self._log)

    def _snap(self, state):
        """A pre-chunk snapshot, its seconds moved to the snapshot span."""
        t0 = time.perf_counter()
        snap = snapshot_state(state)
        if self.wall is not None:
            self.wall.reattribute("dispatch", "snapshot", time.perf_counter() - t0)
        return snap

    def _restore(self, snap):
        """A restored snapshot, its seconds moved to the replay span."""
        t0 = time.perf_counter()
        state = restore_snapshot(snap)
        if self.wall is not None:
            self.wall.reattribute("dispatch", "replay", time.perf_counter() - t0)
        return state

    # ---- migration ---------------------------------------------------------

    def migrate(self, state, new_cap: int, new_budget: int):
        """Re-seat `state` at (new_cap, new_budget): the queue through K25
        (then K8 for a bucketed one), a fresh empty outbox at the new width
        (migrations happen at chunk boundaries, where the exchange has just
        emptied the outbox; checked). The gear ladder follows a budget
        change: the new full width joins it, so the replay loop keeps a
        top gear that cannot shed."""
        cap = state.queue.t.shape[1]
        budget = state.outbox.t.shape[1]
        if new_cap != cap:
            state = state._replace(queue=migrate_queue(state.queue, new_cap, self.queue_block))
        if new_budget != budget:
            self.syncs += 1
            if int(state.outbox.count.sum()) != 0:
                raise AssertionError("outbox migration outside a chunk boundary")
            state = state._replace(outbox=make_empty_outbox(
                state.outbox.t.shape[0], new_budget, state.outbox.t.device))
            if self.gearctl is not None:
                g = self.gearctl
                g.ladder = sorted(set(g.ladder) | {int(new_budget)})
                if g.gear not in g.ladder:
                    g.gear = g.top
        return state

    # ---- the chunk loop ----------------------------------------------------

    def run_chunk(self, engine, state, params, rounds0=None):
        """One ACCEPTED chunk, with shed-exact gear replay, drop-exact
        capacity escalation (or the abort policy's stop) and the sentinel's
        replay classification, from one pre-chunk snapshot. With a pressure
        policy the engine runs each attempt at the state's shape
        (`run_chunk_resized`), otherwise at the base shape
        (`run_chunk_gear`). Each attempt costs one device-to-host
        read (the shed delta, the outbox high-water and the rounds; with
        the sentinel its count, bits and first round; with a pressure
        policy the four drop categories before and after, whose sums are
        the drop total's; under escalate the occupancy high-water too), counted in
        `engine.host_syncs`. Returns (state, accepted gear, chunk outbox
        high-water)."""
        gearctl = self.gearctl
        gear = gearctl.gear if gearctl is not None else 0
        pressured = self.pressure is not None
        if pressured:
            cap = state.queue.t.shape[1]
            budget = state.outbox.t.shape[1]
            if self.escalate:
                self._ensure_ladders(cap, budget)
        else:
            cap = budget = 0
        need_snap = (gearctl is not None and gear < gearctl.top) or self.escalate \
            or self.integrity_on
        snap = self._snap(state) if need_snap else None
        self._last_snap = snap
        iv_last_sig = None
        iv_attempts = 0
        attempt_i = 0
        while True:
            shed0 = state.stats.gear_shed.clone()
            iv0 = state.stats.integrity.clone() if self.integrity_on else None
            if pressured:
                cats0_lanes = _category_lanes(state)
            if self.test_scribble is not None:
                state = self.test_scribble(state, attempt_i)
            attempt_i += 1
            try:
                out = (engine.run_chunk_resized(state, params, gear, cap, budget)
                       if pressured else engine.run_chunk_gear(state, params, gear))
            except (KeyboardInterrupt, SystemExit, PressureAbort, IntegrityAbort):
                raise
            except Exception as e:
                if not (self.escalate and _is_oom(e)):
                    raise
                grown_cap = cap > self._cap_ladder[0]
                grown_box = budget > self._box_ladder[0]
                if not (grown_cap or grown_box):
                    raise
                state, cap, budget = self._oom_fallback(e, snap, cap, budget, grown_cap,
                                                        grown_box)
                snap = snapshot_state(state)
                self._last_snap = snap
                continue
            s = out.stats
            lanes = [(s.gear_shed - shed0).sum(), s.outbox_hwm.max(), s.rounds]
            if self.integrity_on:
                lanes += [(s.integrity - iv0).max(), s.iv_mask[0], s.iv_round[0]]
            if pressured:
                lanes += [*cats0_lanes, *_category_lanes(out)]
                if self.escalate:
                    lanes.append(s.q_occ_hwm.max())
            rows = read_rows(engine, lanes)
            # across ranks: the gear shed, the sentinel's count and the
            # rounds are global already, the high-waters are maxima and the
            # drop categories sums over the ranks
            cols = list(zip(*rows))
            shed, hwm, rounds = max(cols[0]), max(cols[1]), cols[2][0]
            at = 3
            if self.integrity_on:
                iv_vals = [max(cols[3]), cols[4], cols[5]]
                at = 6
            rest = [sum(c) for c in cols[at:]]
            if self.escalate:
                rest[-1] = max(cols[-1])
            if self.integrity_on:
                # integrity first: a violating attempt's other counters may
                # themselves be corrupt; it is discarded whole either way
                if iv_vals[0] > 0:
                    # the (shard, first round, bits) of every violating shard
                    sig = tuple((r, int(rnd), int(m)) for r, (m, rnd)
                                in enumerate(zip(iv_vals[1], iv_vals[2]))
                                if m or len(rows) == 1)
                    detail = describe_signature(sig)
                    if iv_last_sig is not None and sig == iv_last_sig:
                        self.aborted = True
                        self.iv_deterministic = {"signature": [list(x) for x in sig],
                                                 "detail": detail}
                        self.last_error = f"deterministic integrity violation: {detail}"
                        raise IntegrityAbort(
                            f"integrity: violation REPRODUCED across a snapshot replay "
                            f"(deterministic engine bug, not corruption) — {detail}")
                    if iv_last_sig is not None:
                        # the previous violation did not reproduce: transient
                        self.iv_transients += 1
                    iv_last_sig = sig
                    iv_attempts += 1
                    if iv_attempts > self.integrity.max_replays:
                        self.aborted = True
                        self.iv_deterministic = {"signature": [list(x) for x in sig],
                                                 "detail": detail, "nonreproducing": True}
                        self.last_error = (
                            f"integrity violations persist without reproducing after "
                            f"{iv_attempts - 1} replays; last: {detail}")
                        raise IntegrityAbort(f"integrity: cornered — {self.last_error}")
                    self.iv_replays += 1
                    self._say(
                        f"invariant violation ({detail}); restoring the pre-chunk snapshot "
                        f"and replaying to classify (attempt {iv_attempts}/"
                        f"{self.integrity.max_replays})")
                    state = self._restore(snap)
                    continue
                if iv_last_sig is not None:
                    # the replay came back clean: transient, counted, survived
                    self.iv_transients += 1
                    self._say("transient violation survived: it did not reproduce on replay")
                    iv_last_sig = None
            if shed > 0:
                # a gear problem: the discarded attempt's high-water names the
                # burst that shed it (read before the restore)
                gear = gearctl.note_shed(int(hwm))
                state = self._restore(snap)
                continue
            if pressured:
                n = len(_CATEGORIES)
                cats0 = dict(zip(_CATEGORIES, rest[:n]))
                cats1 = dict(zip(_CATEGORIES, rest[n:2 * n]))
                occ = rest[2 * n] if self.escalate else 0
                # the attempt's growth of the K26 total
                if sum(cats1.values()) > sum(cats0.values()):
                    if self.abort_on_drop:
                        # stop AT the drop: the reported state includes the
                        # dropping round, counters and all
                        self.aborted = True
                        self._abort_state = out
                        self._raise_dropped(cats1, cats0)
                    state, cap, budget, snap = self._escalate_replay(
                        cats1, cats0, snap, cap, budget)
                    continue
            break
        hwm = int(hwm)
        if gearctl is not None and (rounds0 is None or rounds > rounds0):
            gearctl.note_chunk(gear, hwm)
        out = out._replace(stats=s._replace(outbox_hwm=torch.zeros_like(s.outbox_hwm)))
        if self.escalate:
            out = self._proactive(out, hwm, int(occ))
        self._last_snap = None
        return out, gear, hwm

    def _oom_fallback(self, e, snap, cap, budget, grown_cap, grown_box):
        """A grown shape ran out of memory: every axis above its base falls
        back one rung and its abandoned rungs (and all above) are poisoned.
        The queue's shrink is checked against the restored snapshot: a rung
        the live events no longer fit would truncate them, so the
        controller is cornered instead. Returns (state, cap, budget)."""
        self.oom_fallbacks += 1
        self.last_error = f"{type(e).__name__}: {e}"
        restored = restore_snapshot(snap)
        lower_cap, lower_box = cap, budget
        if grown_cap:
            for rung in self._cap_ladder:
                if rung >= cap:
                    self._cap_poisoned.add(rung)
            lower_cap = None
            for r in sorted(self._cap_ladder, reverse=True):
                if r < cap and r not in self._cap_poisoned:
                    self.syncs += 1
                    if bool(migration_fits(restored.queue, r).all()):
                        lower_cap = r
                        break
            if lower_cap is None:
                self.aborted = True
                raise PressureAbort(
                    f"pressure: cornered — grown program failed at capacity {cap} "
                    f"({self.last_error}) and the live events no longer fit any usable "
                    f"lower rung (shrinking would silently truncate them)") from e
        if grown_box:
            for rung in self._box_ladder:
                if rung >= budget:
                    self._box_poisoned.add(rung)
            lower_box = max(r for r in self._box_ladder
                            if r < budget and r not in self._box_poisoned)
        self._say(
            f"grown program failed at (cap={cap}, outbox={budget}) ({self.last_error}); "
            f"falling back to (cap={lower_cap}, outbox={lower_box})")
        return self.migrate(restored, lower_cap, lower_box), lower_cap, lower_box

    def _escalate_replay(self, cats, cats0, snap, cap, budget):
        """A chunk attempt dropped: pick the grown shape from the attempt's
        per-category deltas, restore the pre-chunk snapshot, migrate, and
        hand the loop the new shape and snapshot. Raises PressureAbort when
        a dropping axis cannot grow."""
        queue_side = cats["queue"] > cats0["queue"]
        box_side = (cats["budget"] > cats0["budget"] or cats["a2a"] > cats0["a2a"]
                    or cats["outbox"] > cats0["outbox"])
        new_cap, new_budget = cap, budget
        if queue_side:
            up = self._next_rung(self._cap_ladder, cap, self._cap_poisoned)
            if up is None:
                self.aborted = True
                self.last_error = (
                    f"queue pressure at capacity {cap} with no usable rung left (ladder "
                    f"{self._cap_ladder}, poisoned {sorted(self._cap_poisoned)})")
                raise PressureAbort(f"pressure: cornered — {self.last_error}")
            new_cap = up
        if box_side:
            up = self._next_rung(self._box_ladder, budget, self._box_poisoned)
            if up is None:
                self.aborted = True
                self.last_error = (
                    f"outbox pressure at budget {budget} with no usable rung left (ladder "
                    f"{self._box_ladder}, poisoned {sorted(self._box_poisoned)})")
                raise PressureAbort(f"pressure: cornered — {self.last_error}")
            new_budget = up
        if (new_cap, new_budget) == (cap, budget):
            self.aborted = True
            raise PressureAbort("pressure: drop detected but no growth axis identified")
        self._admit_or_corner(cap, budget, new_cap, new_budget)
        self.regrows += 1
        self.replays += 1
        self._say(
            f"capacity drop at (cap={cap}, outbox={budget}); replaying chunk at "
            f"(cap={new_cap}, outbox={new_budget})")
        state = self.migrate(self._restore(snap), new_cap, new_budget)
        snap = self._snap(state)
        self._last_snap = snap
        return state, new_cap, new_budget, snap

    def _admit_or_corner(self, cap, budget, new_cap, new_budget):
        """The memory guard's admission of a reactive rung: refused, it and
        every rung above it on the grown axes are poisoned and the
        escalation is cornered (every higher rung needs more bytes). No-op
        without a guard or a measured limit."""
        if self.memory is None or (new_cap, new_budget) == (cap, budget):
            return
        ok, need, headroom = self.memory.admit(cap, budget, new_cap, new_budget)
        if ok:
            return
        self.memory_refusals += 1
        if new_cap != cap:
            self._cap_poisoned.update(r for r in self._cap_ladder if r >= new_cap)
        if new_budget != budget:
            self._box_poisoned.update(r for r in self._box_ladder if r >= new_budget)
        self.aborted = True
        self.last_error = (
            f"memory guard refused rung (cap={new_cap}, outbox={new_budget}) before dispatch: "
            f"predicted need {need} bytes (queue and outbox delta x replay concurrency x "
            f"safety {self.memory.safety_factor}) exceeds measured headroom {headroom} bytes")
        raise PressureAbort(f"pressure: cornered — {self.last_error}")

    def _admitted_proactive(self, cap, budget, new_cap, new_budget):
        """The memory guard's admission of a proactive regrow: when the
        combined growth does not fit, each single axis is tried alone; a
        full refusal skips the regrow (nothing has dropped yet), counted
        once per distinct (shape, headroom). Returns the admitted shape."""
        if self.memory is None or (new_cap, new_budget) == (cap, budget):
            return new_cap, new_budget
        candidates = [(new_cap, new_budget)]
        for cand in ((new_cap, budget), (cap, new_budget)):
            if cand != (cap, budget) and cand not in candidates:
                candidates.append(cand)
        need_all = headroom = None
        for i, cand in enumerate(candidates):
            ok, need, headroom = self.memory.admit(cap, budget, *cand)
            if i == 0:
                need_all = need
            if ok:
                if cand != (new_cap, new_budget):
                    self.memory_refusals += 1
                    self._say(
                        f"memory guard trimmed proactive regrow (cap={new_cap}, "
                        f"outbox={new_budget}) -> (cap={cand[0]}, outbox={cand[1]}): the "
                        f"combined growth exceeds measured headroom")
                return cand
        key = (new_cap, new_budget, headroom)
        if key != self._proactive_refused:
            self._proactive_refused = key
            self.memory_refusals += 1
            self._say(
                f"memory guard skipped proactive regrow to (cap={new_cap}, "
                f"outbox={new_budget}): predicted need {need_all} bytes > measured "
                f"headroom {headroom} bytes")
        return cap, budget

    def _proactive(self, state, chunk_hwm: int, occ: int):
        """Boundary regrow BEFORE anything drops: the occupancy high-water
        `occ` reaching ceil(headroom x capacity) grows the queue; a chunk
        whose outbox high-water filled the budget grows the outbox."""
        p = self.pressure
        if not p.headroom:
            return state
        cap = state.queue.t.shape[1]
        budget = state.outbox.t.shape[1]
        new_cap, new_budget = cap, budget
        if occ >= math.ceil(p.headroom * cap):
            up = self._next_rung(self._cap_ladder, cap, self._cap_poisoned)
            if up is not None:
                new_cap = up
        if chunk_hwm >= budget:
            up = self._next_rung(self._box_ladder, budget, self._box_poisoned)
            if up is not None:
                new_budget = up
        new_cap, new_budget = self._admitted_proactive(cap, budget, new_cap, new_budget)
        if (new_cap, new_budget) != (cap, budget):
            self.proactive_regrows += 1
            self._say(
                f"proactive regrow: occupancy hwm {occ}/{cap}, outbox hwm {chunk_hwm}/"
                f"{budget} -> (cap={new_cap}, outbox={new_budget})")
            state = self.migrate(state, new_cap, new_budget)
        return state

    # ---- abort/export ------------------------------------------------------

    def abort_export_state(self):
        """The state to report after a PressureAbort or an IntegrityAbort:
        under the abort policy the dropping state itself (it includes the
        drop that stopped the run); otherwise a fresh copy of the last good
        pre-chunk snapshot (the failed attempts are discarded); None when
        neither exists."""
        if self._abort_state is not None:
            return self._abort_state
        if self._last_snap is not None:
            return restore_snapshot(self._last_snap)
        return None

    def integrity_report(self) -> dict:
        """The report's integrity{} accounting: transients, replays and,
        after an IntegrityAbort, the deterministic violation's naming."""
        out: dict[str, Any] = {
            "transients": self.iv_transients,
            "replays": self.iv_replays,
            "max_replays": self.integrity.max_replays if self.integrity is not None else 0,
        }
        if self.iv_deterministic is not None:
            out["deterministic"] = self.iv_deterministic
        return out

    def report(self) -> dict:
        """The report's pressure{} accounting (the JAX package's keys)."""
        out: dict[str, Any] = {
            "policy": self.policy,
            "regrows": self.regrows,
            "proactive_regrows": self.proactive_regrows,
            "replays": self.replays,
            "oom_fallbacks": self.oom_fallbacks,
        }
        if self.memory_refusals:
            out["memory_refusals"] = self.memory_refusals
        if self.memory is not None and self.memory.monitor is not None:
            hb = self.memory.monitor.headroom_bytes()
            if hb is not None:
                out["headroom_bytes"] = hb
        if self._cap_ladder is not None:
            out["capacity_ladder"] = list(self._cap_ladder)
            out["outbox_ladder"] = list(self._box_ladder)
        if self._cap_poisoned:
            out["capacity_poisoned"] = sorted(self._cap_poisoned)
        if self._box_poisoned:
            out["outbox_poisoned"] = sorted(self._box_poisoned)
        if self.aborted:
            out["aborted"] = True
        if self.last_error:
            out["last_error"] = self.last_error
        return out

