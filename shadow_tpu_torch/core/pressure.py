"""The run loop's snapshot-replay seam: merge-gear shifts and the integrity
sentinel's replays from one pre-chunk snapshot (port of the JAX package's
`core/pressure.py` `ResilienceController`; its pressure branch, the
capacity escalation and abort policies, is not ported).

Two arbitration branches, in the JAX package's order:

  integrity — a chunk whose per-round guards tripped (core/integrity.py;
              the chunk stopped at the violating round) is restored from
              the pre-chunk snapshot and replayed at the same gear. A
              violation that reproduces with the same (shard, round,
              bitmask) signature is deterministic: `IntegrityAbort`. One
              that does not is transient: counted, and the clean replay is
              accepted. `max_replays` bounds the replays of one chunk.
  gears     — a chunk that shed at a narrow merge gear is restored and
              replayed wider (core/gears.py); with the sentinel off this is
              all the controller does, and `core/gears.run_adaptive_chunk`
              is that case.

`test_scribble` (None in production) is a seam for the tests: a callable
(state, attempt) -> state applied after the pre-chunk snapshot and before
each dispatch attempt, so a one-shot change to the state does not survive
into the replay, as corruption of in-flight buffers would not.
"""

from __future__ import annotations

from typing import Any

import torch

from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
from shadow_tpu_torch.core.integrity import IntegrityAbort, describe_signature


class PressureAbort(RuntimeError):
    """The pressure plane stopped the run (its policies are not ported;
    the class exists so the supervisor lets such a decision through)."""


class ResilienceController:
    """The driver's chunk loop: gear shifts and integrity replays from one
    snapshot.

    `gearctl` is a `core.gears.GearController` or None (full width always);
    `integrity` an `IntegrityOptions` (enabled) or None. `pressure` must be
    None or a policy-off block: the capacity plane is not ported."""

    def __init__(self, *, gearctl=None, pressure=None, integrity=None, log=None):
        if pressure is not None and getattr(pressure, "active", True):
            raise NotImplementedError(
                "the pressure plane (escalate/abort) is not yet ported to the PyTorch port"
            )
        self.gearctl = gearctl
        self.integrity = integrity
        self.integrity_on = bool(integrity is not None and getattr(integrity, "enabled", False))
        self.iv_transients = 0  # violations that did not reproduce
        self.iv_replays = 0  # chunk replays the sentinel forced
        self.iv_deterministic: dict | None = None  # the abort's naming
        self.test_scribble = None
        self._log = log
        self._last_snap = None

    def _say(self, msg: str):
        if self._log is not None:
            print(f"[pressure] {msg}", file=self._log)

    def run_chunk(self, engine, state, params, rounds0=None):
        """One ACCEPTED chunk at the controller's gear (the engine's
        `run_chunk_gear`), with shed-exact gear replay and the sentinel's
        replay classification. Each attempt costs one device-to-host read
        (the shed delta, the outbox high-water and the rounds; with the
        sentinel its count, bits and first round too), counted in
        `engine.host_syncs`. Returns (state, accepted gear, chunk outbox
        high-water)."""
        gearctl = self.gearctl
        gear = gearctl.gear if gearctl is not None else 0
        need_snap = (gearctl is not None and gear < gearctl.top) or self.integrity_on
        snap = snapshot_state(state) if need_snap else None
        self._last_snap = snap
        iv_last_sig = None
        iv_attempts = 0
        attempt_i = 0
        while True:
            shed0 = state.stats.gear_shed.clone()
            iv0 = state.stats.integrity.clone() if self.integrity_on else None
            if self.test_scribble is not None:
                state = self.test_scribble(state, attempt_i)
            attempt_i += 1
            out = engine.run_chunk_gear(state, params, gear)
            s = out.stats
            lanes = [(s.gear_shed - shed0).sum(), s.outbox_hwm.max(), s.rounds]
            if self.integrity_on:
                lanes += [(s.integrity - iv0).max(), s.iv_mask[0], s.iv_round[0]]
            vals = torch.stack(lanes).tolist()
            engine.host_syncs += 1
            shed, hwm, rounds = vals[:3]
            if self.integrity_on:
                # integrity first: a violating attempt's other counters may
                # themselves be corrupt; it is discarded whole either way
                if vals[3] > 0:
                    sig = ((0, int(vals[5]), int(vals[4])),)
                    detail = describe_signature(sig)
                    if iv_last_sig is not None and sig == iv_last_sig:
                        self.iv_deterministic = {"signature": [list(x) for x in sig],
                                                 "detail": detail}
                        raise IntegrityAbort(
                            f"integrity: violation REPRODUCED across a snapshot replay "
                            f"(deterministic engine bug, not corruption) — {detail}")
                    if iv_last_sig is not None:
                        # the previous violation did not reproduce: transient
                        self.iv_transients += 1
                    iv_last_sig = sig
                    iv_attempts += 1
                    if iv_attempts > self.integrity.max_replays:
                        self.iv_deterministic = {"signature": [list(x) for x in sig],
                                                 "detail": detail, "nonreproducing": True}
                        raise IntegrityAbort(
                            f"integrity: cornered — violations persist without reproducing "
                            f"after {iv_attempts - 1} replays; last: {detail}")
                    self.iv_replays += 1
                    self._say(
                        f"invariant violation ({detail}); restoring the pre-chunk snapshot "
                        f"and replaying to classify (attempt {iv_attempts}/"
                        f"{self.integrity.max_replays})")
                    state = restore_snapshot(snap)
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
                state = restore_snapshot(snap)
                continue
            break
        hwm = int(hwm)
        if gearctl is not None and (rounds0 is None or rounds > rounds0):
            gearctl.note_chunk(gear, hwm)
        out = out._replace(stats=s._replace(outbox_hwm=torch.zeros_like(s.outbox_hwm)))
        self._last_snap = None
        return out, gear, hwm

    def abort_export_state(self):
        """The state to report after an IntegrityAbort: a fresh copy of the
        last good pre-chunk snapshot (the violating attempts are
        discarded); None when there is none."""
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
