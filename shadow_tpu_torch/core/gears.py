"""Merge gears: the ladder of exchange widths and the chunk controller
(a copy of the JAX package's host-side `core/gears.py`, which the port
does not import).

The exchange merge reads the [H, B] outbox in full every round, though most
rounds carry far fewer than B sends per host. With gears `Simulation.run` runs
each chunk at a column width g from a small ladder ("gears",
`Engine.run_chunk_gear`): the merge reads only the first g columns of each
host's outbox row. That is exact while no host staged more than g sends in
a round (host h's k-th send sits in column k); a round where one did is
counted exactly into `stats.gear_shed` (`ops.merge.gear_shed_count`), the
chunk stops after it, and the run loop restores its pre-chunk snapshot
(`core.checkpoint.snapshot_state`) and replays the chunk at a wider gear.
The top gear is the full send budget and cannot shed, so every accepted
chunk equals the full-width run: digests, events and drops.

The controller picks the next chunk's gear from the accepted chunk's
outbox high-water (`stats.outbox_hwm`, the most sends one host staged in a
round):
  - shift up at once (on a shed, or when the high-water reaches the
    current gear's width);
  - shift down only after `down_lag` chunks in a row whose high-water fits
    a lower gear.
Gear choices change which width runs, never what it computes.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state

DOWN_LAG = 2  # chunks of low occupancy before shifting down


def resolve_gear_ladder(spec, send_budget: int) -> list[int]:
    """`experimental.merge_gears` -> sorted ladder of outbox column widths.

    Accepted specs:
      0 / None / False / "off"  -> []  (gears disabled, full width always)
      "auto" / True             -> ~{B/8, B/4, B/2, B} (deduped, >= 1)
      [ints]                    -> explicit widths, validated against the
                                   send budget; the full width B is always
                                   appended so the replay loop terminates.
    """
    if not spec or (isinstance(spec, str) and spec.lower() == "off"):
        return []
    b = int(send_budget)
    if spec is True or (isinstance(spec, str) and spec.lower() == "auto"):
        ladder = sorted({max(1, b // 8), max(1, b // 4), max(1, b // 2), b})
    else:
        if isinstance(spec, int):
            spec = [spec]
        try:
            gears = sorted({int(g) for g in spec})
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"merge_gears must be 'auto', an int, or a list of ints, "
                f"got {spec!r}"
            ) from e
        for g in gears:
            if g < 1 or g > b:
                raise ValueError(
                    f"merge gear {g} out of range [1, sends_per_host_round"
                    f"={b}]"
                )
        ladder = gears if gears[-1] == b else gears + [b]
    return [] if ladder == [b] else ladder


class GearController:
    """Per-run gear state: pick next chunk's gear, account replays.

    Callers, per chunk:
        gear = ctl.gear                       # width to dispatch at
        ... run, on shed: gear = ctl.note_shed(); restore + replay ...
        ctl.note_chunk(gear, ob_hwm)          # accepted chunk's signal
    """

    def __init__(self, ladder: list[int], down_lag: int = DOWN_LAG):
        if not ladder:
            raise ValueError("GearController needs a non-empty ladder")
        self.ladder = list(ladder)
        # start at the TOP gear: the boot chunk's occupancy is unknown and
        # a replay costs a whole chunk; the first observation adapts down
        self.gear = self.ladder[-1]
        self.down_lag = int(down_lag)
        self.replays = 0  # chunks re-run one gear up after a shed
        self.chunks: dict[int, int] = {}  # accepted chunks per gear
        self._low_streak = 0

    @property
    def top(self) -> int:
        return self.ladder[-1]

    def _fit(self, hwm: int) -> int:
        """Smallest ladder gear with headroom over the observed high-water
        (strictly greater: hwm == gear means the width was exactly filled,
        one more send next chunk would shed — step up preemptively)."""
        for g in self.ladder:
            if hwm < g:
                return g
        return self.top

    def note_shed(self, observed_hwm: int | None = None) -> int:
        """A chunk shed at the current gear: pick the replay gear and
        reset the downshift streak. With `observed_hwm` (the ABORTED
        chunk's outbox high-water, read before the snapshot restore) the
        replay jumps straight to a gear that fits the burst it actually
        saw — one replay instead of walking the ladder rung by rung when
        traffic jumped several gears at once. The jump is a floor, not a
        guarantee: the aborted chunk stopped at its first shedding round,
        so later rounds may burst higher and shed again — each replay
        still moves strictly up the ladder, so the loop terminates."""
        self.replays += 1
        self._low_streak = 0
        idx = self.ladder.index(self.gear)
        up = self.ladder[min(idx + 1, len(self.ladder) - 1)]
        if observed_hwm is not None:
            up = max(up, self._fit(observed_hwm))
        self.gear = up
        return self.gear

    def note_chunk(self, gear: int, ob_hwm: int) -> int:
        """Record an ACCEPTED chunk run at `gear` whose outbox high-water
        was `ob_hwm`; returns the gear for the next chunk."""
        self.chunks[gear] = self.chunks.get(gear, 0) + 1
        want = self._fit(ob_hwm)
        if want > self.gear:
            self.gear = want  # headroom exhausted: step up before a shed
            self._low_streak = 0
        elif want < self.gear:
            self._low_streak += 1
            if self._low_streak >= self.down_lag:
                self.gear = want
                self._low_streak = 0
        else:
            self._low_streak = 0
        return self.gear

    def report(self) -> dict:
        """JSON-able summary for sim-stats / BENCH rows."""
        return {
            "ladder": list(self.ladder),
            "chunks_per_gear": {str(g): n for g, n in sorted(self.chunks.items())},
            "replays": self.replays,
        }


def run_adaptive_chunk(ctl: GearController, engine, state, params, rounds0=None):
    """One ACCEPTED chunk at the controller's gear, with shed-exact replay
    (the gears-only reduction of the JAX package's
    `core/pressure.py ResilienceController.run_chunk`).

    Below the top gear the pre-chunk state is snapshotted (a deep copy: the
    kernels write the state in place) and the chunk runs at the gear
    (`engine.run_chunk_gear`). If it shed, the aborted attempt's outbox
    high-water is read BEFORE the restore, `note_shed` picks the replay
    gear, the snapshot is restored (copied again) and the same chunk
    replays; the top gear cannot shed, so this ends. Each attempt costs one
    device-to-host read (shed delta, outbox high-water and rounds together),
    counted in `engine.host_syncs`.

    On accept the controller is fed the chunk's high-water, unless
    `rounds0` (the chunk-entry round count) is given and the chunk retired
    no round, and `stats.outbox_hwm` is reset to 0 so the next chunk
    measures afresh (the caller folds the returned high-water into its
    run-wide maximum). Returns (state, accepted gear, chunk high-water)."""
    gear = ctl.gear
    snap = snapshot_state(state) if gear < ctl.top else None
    while True:
        shed0 = state.stats.gear_shed.clone()
        out = engine.run_chunk_gear(state, params, gear)
        s = out.stats
        shed, hwm, rounds = torch.stack(
            [(s.gear_shed - shed0).sum(), s.outbox_hwm.max(), s.rounds]).tolist()
        engine.host_syncs += 1
        if shed > 0:
            gear = ctl.note_shed(int(hwm))
            state = restore_snapshot(snap)
            continue
        break
    hwm = int(hwm)
    if rounds0 is None or rounds > rounds0:
        ctl.note_chunk(gear, hwm)
    out = out._replace(stats=s._replace(outbox_hwm=torch.zeros_like(s.outbox_hwm)))
    return out, gear, hwm
