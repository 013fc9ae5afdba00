"""The conservative-PDES round engine, single device (port of the
single-device subset of shadow_tpu/core/engine.py).

One round advances every host through the safe window [now, window_end):

  1. barrier: the minimum over hosts of the next event time (K1, over the
     slab or the bucketed queue's block caches);
  2. window_end = min(gmin + runahead, stop_time);
  3. microsteps, while any host has an event before window_end: every host
     pops its earliest event (K2; K5 + K6 on the bucketed queue), packet
     arrivals pass ingress shaping (CoDel + downlink token bucket, K10), one
     vectorized model handler runs for all hosts, sends pass egress shaping
     (budget, uplink bucket, loss/jitter draws, routing, K11) into the
     [H, B] outbox (K9), local pushes land in the queue (K3; K7 bucketed);
  4. exchange: the outbox merges into the destination queues (K4, or K13
     with `merge_scatter`), and a bucketed queue's block caches are rebuilt
     (K8). A round known to have sent nothing skips both, as the JAX
     package's `has_sends` cond does.

With `microstep_events` K > 1 a microstep peeks each host's K earliest
in-window events (K5), runs them through the handler in turn as long as no
push of this microstep would pop before the next one, clears the executed
prefix (K6) and applies all pushes in one pass (K3/K7), each holding back a
reserve so that drops equal the one-event microstep's.

With the timer wheel (`wheel_slots` S > 0, K = 1) the model's timer events
live in a second bucketed slab, [H, S] (ops/wheel.py): the microstep pops
the (time, order) minimum of queue and wheel, timer pushes go to the wheel
while it has room and spill to the queue when it does not, and the wheel's
heads fold into every next-event minimum. Dispatch order, digests, events
and drops equal the wheel-off path's.

With a merge gear (`gear_cols` g, `Engine.run_chunk_gear`) the exchange
reads only the first g columns of each host's outbox row, in place. Sends
beyond them are counted exactly into `stats.gear_shed`, and the chunk stops
before its next round (`Simulation.run` replays it at a wider gear from a
pre-chunk snapshot, core/gears.py); the shed test rides in the window's
device-to-host read, so a round gains no sync.

The slice is the JAX package's single-device path: flat or bucketed queue,
K >= 1, the timer wheel, merge gears, the scatter merge, world 1.
`lax.while_loop` becomes a Python loop; each loop condition is one
device-to-host read, counted in `Engine.host_syncs`. The window itself is
computed on the device and read back with the `done` flag in the same
read.

Determinism: pops follow the packed (time, order) key; RNG lanes advance
only under masks; the merge orders rows by (dst, time, order). Per-host
digests, event counts and drop counters equal the JAX engine's bit for bit
(tests/test_torch_engine.py).

State is NamedTuples of tensors. The queue kernels update the slab planes in
place on CUDA (a state's queue is consumed by the step that takes it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.ops.chain import (
    event_egress,
    event_ingress,
    outbox_append_multi,
)
from shadow_tpu_torch.models.base import KIND_MASK, KIND_PKT, HandlerCtx
from shadow_tpu_torch.net import CodelState, TBParams, TBState, codel_init, tb_init
from shadow_tpu_torch.ops.events import (
    _LOCAL_SHIFT,
    _SRC_SHIFT,
    EVENT_PAYLOAD_WORDS,
    ORDER_MAX,
    SEQ_MASK,
    BucketQueue,
    Event,
    EventQueue,
    Push,
    as_flat,
    bucket_rebuild,
    check_order_limits,
    clear_popped,
    pop_k,
    q_head,
    q_len,
    q_next_time,
    q_pop_min,
    q_push_many,
)
from shadow_tpu_torch.ops.merge import gear_shed_count, merge_flat_events, merge_scatter_free
from shadow_tpu_torch.ops.rng import RngState, rng_init, u64
from shadow_tpu_torch.ops.wheel import (
    TimerWheel,
    resolve_wheel_block,
    wheel_free,
    wheel_next_time,
    wheel_pop_min,
    wheel_push_many,
)
from shadow_tpu_torch.simtime import TIME_MAX

_FNV_OFFSET = u64(0xCBF29CE484222325)


class Outbox(NamedTuple):
    """This round's staged sends, [H, B]: host h's k-th send in column k."""

    dst: torch.Tensor  # i32[H, B]
    t: torch.Tensor  # i64[H, B] arrival time; TIME_MAX = empty
    order: torch.Tensor  # i64[H, B]
    kind: torch.Tensor  # i32[H, B]
    payload: torch.Tensor  # i32[H, B, P]
    count: torch.Tensor  # i32[1] entries appended this round


class Stats(NamedTuple):
    """The counters the report reads (the JAX Stats lanes of this slice)."""

    events: torch.Tensor  # i64[H]
    pkts_sent: torch.Tensor  # i64[H]
    pkts_lost: torch.Tensor  # i64[H]
    pkts_unreachable: torch.Tensor  # i64[H]
    pkts_codel_dropped: torch.Tensor  # i64[H]
    pkts_delivered: torch.Tensor  # i64[H]
    monotonic_violations: torch.Tensor  # i64[H]
    pkts_budget_dropped: torch.Tensor  # i64[H]
    ob_dropped: torch.Tensor  # i64[1]
    microsteps: torch.Tensor  # i64[1]
    bq_rebuilds: torch.Tensor  # i64[1] wholesale block-cache rebuilds
    popk_deferred: torch.Tensor  # i64[1] K-way batch events peeked but deferred
    q_occ_hwm: torch.Tensor  # i64[H]
    outbox_hwm: torch.Tensor  # i64[1]
    digest: torch.Tensor  # i64[H] (uint64 FNV fold, bit pattern)
    rounds: torch.Tensor  # i64[]
    # cumulative sends beyond the active merge gear's columns; an accepted
    # chunk never adds to it (a shedding chunk is replayed wider)
    gear_shed: Any = None  # i64[1]
    # timer-wheel lanes, None unless the wheel is on: timer pushes spilled
    # to the queue because the wheel was full (never a loss), and the
    # per-host wheel-occupancy high-water
    wheel_spilled: Any = None  # i64[H] | None
    wheel_occ_hwm: Any = None  # i64[H] | None


class SimState(NamedTuple):
    now: int  # completed-up-to time (host scalar)
    done: bool
    queue: EventQueue | BucketQueue
    rng: RngState
    seq: torch.Tensor  # i64[H] per-host emission counter
    sent_round: torch.Tensor  # i32[H] sends staged this round
    tb_egress: TBState
    tb_ingress: TBState
    codel: CodelState
    min_used_lat: torch.Tensor  # i64[] min latency seen (dynamic runahead)
    model: Any
    outbox: Outbox
    stats: Stats
    wheel: Any = None  # TimerWheel | None (the [H, S] timer slab)


class EngineParams(NamedTuple):
    node_of: torch.Tensor  # i32[H] host -> graph node
    lat_ns: torch.Tensor  # i64[N, N] path latency; <0 = unreachable
    loss: torch.Tensor  # f32[N, N]
    jitter_ns: torch.Tensor  # i64[N, N]
    eg_tb: TBParams
    in_tb: TBParams
    model: Any
    # per-host rows of the path tables (lat_rows[h] = lat_ns[node_of[h]]),
    # built by init_state for multi-node graphs of moderate size
    lat_rows: Any = None  # i64[H, N] | None
    loss_rows: Any = None  # f32[H, N] | None
    jit_rows: Any = None  # i64[H, N] | None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration (the JAX EngineConfig fields of this slice)."""

    num_hosts: int
    stop_time: int
    bootstrap_end_time: int = 0
    runahead_floor: int = 1_000_000
    static_min_latency: int = 1_000_000
    use_dynamic_runahead: bool = False
    tb_interval_ns: int = 1_000_000
    use_codel: bool = True
    # no bandwidth limit anywhere: shaping is an exact no-op and is skipped
    shaping: bool = True
    # exchange-merge overflow shed by outbox position instead of urgency
    cheap_shed: bool = False
    use_jitter: bool = False
    queue_capacity: int = 64
    # slots per block of the bucketed queue; 0 = flat queue
    queue_block: int = 0
    sends_per_host_round: int = 8
    max_round_inserts: int = 64
    microstep_limit: int = 0  # 0 -> 2 * queue_capacity
    # events folded per host per microstep (K)
    microstep_events: int = 1
    rounds_per_chunk: int = 64
    # host->node map is contiguous uniform blocks (node = host // g)
    hosts_per_node: int = 0
    # timer wheel: slots per host (0 = off) and slots per block of its
    # caches (0 = auto, ops/wheel.py resolve_wheel_block)
    wheel_slots: int = 0
    wheel_block: int = 0
    # active merge gear: the exchange reads the first gear_cols outbox
    # columns (0 = full width). The simulation's config keeps 0; the gear
    # programs run under a copy (Engine.run_chunk_gear).
    gear_cols: int = 0
    # the sort-free exchange merge (ops/merge.py merge_scatter_free, K13)
    merge_scatter: bool = False

    def __post_init__(self):
        check_order_limits(self.num_hosts)
        if self.queue_block < 0 or (
            self.queue_block and self.queue_capacity % self.queue_block
        ):
            raise ValueError(
                f"queue_block={self.queue_block} must be 0 (flat) or divide "
                f"queue_capacity={self.queue_capacity} evenly"
            )
        if self.microstep_events < 1:
            raise ValueError(f"microstep_events={self.microstep_events} must be >= 1")
        if self.wheel_slots < 0:
            raise ValueError(f"wheel_slots={self.wheel_slots} must be >= 0 (0 = off)")
        if self.wheel_block < 0 or (
            self.wheel_slots and self.wheel_block and self.wheel_slots % self.wheel_block
        ):
            raise ValueError(
                f"wheel_block={self.wheel_block} must be 0 (auto) or divide "
                f"wheel_slots={self.wheel_slots} evenly"
            )
        if self.gear_cols < 0 or self.gear_cols > self.sends_per_host_round:
            raise ValueError(
                f"gear_cols={self.gear_cols} must be in "
                f"[0, sends_per_host_round={self.sends_per_host_round}]"
            )
        if self.wheel_slots and self.microstep_events > 1:
            raise ValueError(
                f"unsupported knob pair: wheel_slots={self.wheel_slots} x "
                f"microstep_events={self.microstep_events} (the wheel's pop merges one "
                f"wheel candidate against the queue head per microstep; run the wheel "
                f"at microstep_events=1)"
            )

    @property
    def wheel_active(self) -> bool:
        return self.wheel_slots > 0

    @property
    def gear_active(self) -> bool:
        """A merge gear narrower than the send budget: the sliced exchange
        and the gear-abort chunk test are on."""
        return 0 < self.gear_cols < self.sends_per_host_round

    @property
    def effective_rounds_per_chunk(self) -> int:
        """The chunk's round bound: `rounds_per_chunk`, clamped to the
        microstep valve above 2^19 hosts as the JAX package clamps it (the
        bound changes how rounds group into chunks, never a result)."""
        if self.num_hosts <= 1 << 19:
            return self.rounds_per_chunk
        return min(self.rounds_per_chunk, max(self.effective_microstep_limit, 1))

    @property
    def effective_microstep_limit(self) -> int:
        """The per-round livelock valve: for K = 1 it bounds microsteps; for
        K > 1 it bounds each host's executed events in the round (the round
        loop stops when any host's count reaches it), so the same number
        denominates an event budget either way."""
        return self.microstep_limit or 2 * self.queue_capacity

    @property
    def effective_microstep_events(self) -> int:
        """K clamped to the queue capacity."""
        return min(self.microstep_events, self.queue_capacity)


def _init_stats(cfg: EngineConfig, device) -> Stats:
    h = cfg.num_hosts

    def zi():
        return torch.zeros((h,), dtype=torch.int64, device=device)

    def z1():
        return torch.zeros((1,), dtype=torch.int64, device=device)

    return Stats(
        events=zi(), pkts_sent=zi(), pkts_lost=zi(), pkts_unreachable=zi(),
        pkts_codel_dropped=zi(), pkts_delivered=zi(), monotonic_violations=zi(),
        pkts_budget_dropped=zi(), ob_dropped=z1(), microsteps=z1(),
        bq_rebuilds=z1(), popk_deferred=z1(), q_occ_hwm=zi(), outbox_hwm=z1(),
        digest=torch.full((h,), _FNV_OFFSET, dtype=torch.int64, device=device),
        rounds=torch.zeros((), dtype=torch.int64, device=device),
        gear_shed=z1(),
        wheel_spilled=zi() if cfg.wheel_active else None,
        wheel_occ_hwm=zi() if cfg.wheel_active else None,
    )


def make_empty_outbox(num_hosts: int, send_budget: int, device) -> Outbox:
    h, b = num_hosts, send_budget
    return Outbox(
        dst=torch.zeros((h, b), dtype=torch.int32, device=device),
        t=torch.full((h, b), TIME_MAX, dtype=torch.int64, device=device),
        order=torch.zeros((h, b), dtype=torch.int64, device=device),
        kind=torch.zeros((h, b), dtype=torch.int32, device=device),
        payload=torch.zeros((h, b, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=device),
        count=torch.zeros((1,), dtype=torch.int32, device=device),
    )


def seed_queue(cfg: EngineConfig, initial_events, device, timer_kinds: tuple = ()):
    """The t=0 queue from (host_id, t_ns, kind, payload) events (bucketed
    when `queue_block`), the t=0 timer wheel (None unless the wheel is on:
    seeded events of a kind in `timer_kinds` land in the wheel while it has
    room, the rest in the queue), and the per-host seq counters advanced
    past them in event-list order wherever each one lands."""
    h, c = cfg.num_hosts, cfg.queue_capacity
    s = cfg.wheel_slots if timer_kinds else 0
    kinds = set(timer_kinds)

    def planes(width):
        return {"t": np.full((h, width), TIME_MAX, np.int64),
                "order": np.full((h, width), ORDER_MAX, np.int64),
                "kind": np.zeros((h, width), np.int32),
                "payload": np.zeros((h, width, EVENT_PAYLOAD_WORDS), np.int32),
                "fill": np.zeros((h,), np.int32)}

    q, w = planes(c), planes(s)
    seq = np.zeros((h,), np.int64)
    for host, t_ns, k, pl in initial_events:
        okey = (1 << _LOCAL_SHIFT) | (host << _SRC_SHIFT) | (int(seq[host]) & SEQ_MASK)
        seq[host] += 1
        dest = w if s and k in kinds and w["fill"][host] < s else q
        slot = dest["fill"][host]
        if dest is q and slot >= c:
            raise ValueError(f"host {host}: {slot + 1} initial events exceed queue capacity {c}")
        dest["t"][host, slot] = t_ns
        dest["order"][host, slot] = okey
        dest["kind"][host, slot] = k
        dest["payload"][host, slot, : len(pl)] = pl
        dest["fill"][host] += 1

    def flat(p):
        return EventQueue(*(torch.as_tensor(p[f], device=device)
                            for f in ("t", "order", "kind", "payload")),
                          dropped=torch.zeros((h,), dtype=torch.int64, device=device))

    queue = flat(q)
    if cfg.queue_block:
        queue = bucket_rebuild(queue, cfg.queue_block)
    wheel = bucket_rebuild(flat(w), resolve_wheel_block(s, cfg.wheel_block)) if s else None
    return queue, wheel, torch.as_tensor(seq, device=device)


class _EvCarry(NamedTuple):
    stats: Stats
    rng: RngState
    seq: torch.Tensor
    sent_round: torch.Tensor
    tb_egress: TBState
    tb_ingress: TBState
    codel: CodelState
    model: Any


def _ev_carry_of(st: SimState) -> _EvCarry:
    return _EvCarry(st.stats, st.rng, st.seq, st.sent_round, st.tb_egress,
                    st.tb_ingress, st.codel, st.model)


def _lex_less(at, ao, bt, bo):
    """(at, ao) < (bt, bo) on the (time, order) total key."""
    return (at < bt) | ((at == bt) & (ao < bo))


class Engine:
    """Runs the round loop for a fixed (config, model) on one device.

    `run_chunk(state, params)` runs up to `rounds_per_chunk` rounds and
    returns the new state; the driver (`shadow_tpu_torch.sim`) calls it
    until `state.done`. `host_syncs` counts the device-to-host reads the
    loop conditions cost."""

    def __init__(self, cfg: EngineConfig, model, device):
        if cfg.wheel_active and not tuple(getattr(model, "timer_kinds", ())):
            raise ValueError(
                f"timer wheel enabled (wheel_slots={cfg.wheel_slots}) but model "
                f"{getattr(model, 'name', model)!r} declares no timer_kinds: nothing "
                f"would ever route to the wheel"
            )
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.host_syncs = 0
        self._host_gid = torch.arange(cfg.num_hosts, dtype=torch.int64, device=self.device)

    # ---- build -------------------------------------------------------------

    def init_state(self, params: EngineParams, model_state, initial_events, seed: int):
        """(state, params): the t=0 state, and params with the per-host
        routing rows materialized for multi-node graphs."""
        cfg, dev = self.cfg, self.device
        n_nodes = params.lat_ns.shape[0]
        if n_nodes > 1:
            node_np = params.node_of.cpu().numpy()
            counts = np.bincount(node_np, minlength=n_nodes)
            g = int(counts[0])
            if g > 0 and (counts == g).all() and (node_np == np.arange(node_np.shape[0]) // g).all():
                self.cfg = cfg = dataclasses.replace(cfg, hosts_per_node=g)
        rows_ok = cfg.num_hosts * n_nodes <= 32 << 20
        if tuple(params.lat_ns.shape) != (1, 1) and rows_ok and params.lat_rows is None:
            node = params.node_of.to(torch.int64)
            params = params._replace(
                lat_rows=params.lat_ns[node].contiguous(),
                loss_rows=params.loss[node].contiguous(),
                jit_rows=params.jitter_ns[node].contiguous(),
            )
        queue, wheel, seq = seed_queue(
            cfg, initial_events, dev, tuple(getattr(self.model, "timer_kinds", ()))
        )
        h = cfg.num_hosts
        state = SimState(
            now=0,
            done=False,
            queue=queue,
            rng=rng_init(h, seed, dev),
            seq=seq,
            sent_round=torch.zeros((h,), dtype=torch.int32, device=dev),
            tb_egress=tb_init(params.eg_tb),
            tb_ingress=tb_init(params.in_tb),
            codel=codel_init(h, dev),
            min_used_lat=torch.tensor(cfg.static_min_latency, dtype=torch.int64, device=dev),
            model=model_state,
            outbox=make_empty_outbox(h, cfg.sends_per_host_round, dev),
            stats=_init_stats(cfg, dev),
            wheel=wheel,
        )
        return state, params

    # ---- the round loop ------------------------------------------------------

    def run_chunk(self, st: SimState, params: EngineParams) -> SimState:
        """Up to `effective_rounds_per_chunk` rounds. Under a merge gear the
        chunk stops before the first round that follows a shed (the JAX
        chunk loop's gear abort)."""
        cfg = self.cfg
        shed0 = st.stats.gear_shed.clone() if cfg.gear_active else None
        for _ in range(cfg.effective_rounds_per_chunk):
            if st.done:
                break
            window_end, done, shed = self.compute_window(st, shed0)
            if shed:
                break
            st = self.window_step(st, params, window_end, done)
        return st

    def run_chunk_gear(self, st: SimState, params: EngineParams, gear_cols: int) -> SimState:
        """One chunk at merge gear `gear_cols` (the exchange reads that many
        outbox columns); 0 or the full send budget is the full-width
        chunk. State shapes are the same at every gear."""
        if gear_cols <= 0 or gear_cols >= self.cfg.sends_per_host_round:
            return self.run_chunk(st, params)
        base = self.cfg
        self.cfg = dataclasses.replace(base, gear_cols=gear_cols)
        try:
            return self.run_chunk(st, params)
        finally:
            self.cfg = base

    @staticmethod
    def next_times(st: SimState) -> torch.Tensor:
        """Per-host next event time: the queue's head, and the wheel's where
        there is one (a due timer is as executable as a due queue event)."""
        nt = q_next_time(st.queue)
        if st.wheel is not None:
            nt = torch.minimum(nt, wheel_next_time(st.wheel))
        return nt

    def compute_window(self, st: SimState, shed0=None) -> tuple[int, bool, bool]:
        """Barrier + window: (window_end, done, shed), one device-to-host
        read. `shed` is whether `stats.gear_shed` grew past `shed0` (the
        chunk-entry value; False without one)."""
        cfg = self.cfg
        gmin = self.next_times(st).min()
        done = gmin >= cfg.stop_time
        gmin_safe = torch.clamp_max(gmin, cfg.stop_time)
        if cfg.use_dynamic_runahead:
            runahead = torch.clamp_min(st.min_used_lat, max(cfg.runahead_floor, 1))
        else:
            runahead = max(cfg.runahead_floor, cfg.static_min_latency, 1)
        window_end = torch.clamp_max(gmin_safe + runahead, cfg.stop_time)
        lanes = [window_end, done.to(torch.int64)]
        if shed0 is not None:
            lanes.append((st.stats.gear_shed[0] > shed0[0]).to(torch.int64))
        vals = torch.stack(lanes).tolist()
        self.host_syncs += 1
        return int(vals[0]), bool(vals[1]), shed0 is not None and bool(vals[2])

    def round_step(self, st: SimState, params: EngineParams) -> SimState:
        window_end, done, _ = self.compute_window(st)
        return self.window_step(st, params, window_end, done)

    def window_step(self, st: SimState, params: EngineParams, window_end: int, done: bool) -> SimState:
        cfg = self.cfg
        limit = cfg.effective_microstep_limit
        steps = 0
        # whether the round staged any send, read with the loop test that
        # ends the microsteps (unknown, so merged, when the valve ends them)
        has_sends = True
        if cfg.effective_microstep_events > 1:
            # the valve is a per-host executed-event vector bounded by its
            # max, read in the same device-to-host read as the loop test
            valve = torch.zeros((cfg.num_hosts,), dtype=torch.int64, device=self.device)
            while True:
                pending = (self.next_times(st) < window_end).any().to(torch.int64)
                go, vmax, sent = torch.stack(
                    [pending, valve.max(), st.outbox.count[0].to(torch.int64)]).tolist()
                self.host_syncs += 1
                if not go or vmax >= limit:
                    has_sends = sent > 0
                    break
                st, executed = self.microstep_k(st, params, window_end)
                valve = valve + executed
                steps += 1
        else:
            while steps < limit:
                pending = (self.next_times(st) < window_end).any().to(torch.int64)
                go, sent = torch.stack([pending, st.outbox.count[0].to(torch.int64)]).tolist()
                self.host_syncs += 1
                if not go:
                    has_sends = sent > 0
                    break
                st = self.microstep(st, params, window_end)
                steps += 1
        st_m = st
        st_x = self.exchange(st_m, has_sends)
        occ = q_len(st_x.queue).to(torch.int64)
        ob_hwm = st_m.sent_round.max().to(torch.int64)
        s = st_x.stats
        stats = s._replace(
            rounds=s.rounds + (0 if done else 1),
            microsteps=s.microsteps + steps,
            q_occ_hwm=torch.maximum(s.q_occ_hwm, occ),
            outbox_hwm=torch.maximum(s.outbox_hwm, ob_hwm[None]),
        )
        if st_x.wheel is not None:
            # the exchange never touches the wheel: the post-exchange sample
            # is the round's post-push peak
            stats = stats._replace(wheel_occ_hwm=torch.maximum(
                stats.wheel_occ_hwm, q_len(st_x.wheel).to(torch.int64)))
        return st_x._replace(
            now=st.now if done else window_end, done=done, stats=stats
        )

    def microstep(self, st: SimState, params: EngineParams, window_end: int) -> SimState:
        """The one-event microstep: pop, execute, push, append."""
        wheel = st.wheel
        if wheel is None:
            queue, ev, active = q_pop_min(st.queue, window_end)
        else:
            queue, wheel, ev, active = pop_min_merged(st.queue, wheel, window_end)
        c, push_list, entries, used_min = self.event_body(
            _ev_carry_of(st), params, window_end, ev, active,
        )
        if wheel is not None and push_list:
            push_list, push_w, spilled = self._route_timer_pushes(wheel, push_list)
            if push_w:
                wheel = wheel_push_many(wheel, push_w)
            c = c._replace(stats=c.stats._replace(
                wheel_spilled=c.stats.wheel_spilled + spilled))
        if push_list:
            queue = q_push_many(queue, push_list)
        st = self._finish_microstep(st, c, queue, [entries] if entries is not None else [],
                                    [used_min] if used_min is not None else [])
        return st if wheel is None else st._replace(wheel=wheel)

    def _route_timer_pushes(self, wheel: TimerWheel, push_list: list[Push]):
        """Split a microstep's pushes into queue-bound and wheel-bound ones.
        A push goes to the wheel iff it is a model timer event (no packet
        flag, its kind in the model's `timer_kinds`) and the wheel still has
        a free slot after this microstep's earlier wheel pushes; a timer
        that finds the wheel full spills to the queue and is counted. The
        ingress requeue (a packet) and push ports outside the model's
        `timer_push_ports` are known never to carry a timer and skip the
        test. Returns (queue pushes, wheel pushes, spilled i64[H])."""
        model = self.model
        n_req = 1 if self.cfg.shaping else 0
        tports = getattr(model, "timer_push_ports", None)
        timer_kinds = tuple(model.timer_kinds)
        free = wheel_free(wheel)
        taken = torch.zeros_like(free)
        spilled = torch.zeros(free.shape, dtype=torch.int64, device=free.device)
        push_q, push_w = [], []
        for i, push in enumerate(push_list):
            if i < n_req or (tports is not None and (i - n_req) not in tports):
                push_q.append(push)
                continue
            kind = push.kind.to(torch.int32)
            is_kind = functools.reduce(
                torch.logical_or, [(kind & KIND_MASK) == k for k in timer_kinds])
            is_timer = push.mask & ((kind & KIND_PKT) == 0) & is_kind
            fits = is_timer & (taken < free)
            taken = taken + fits.to(torch.int32)
            spilled = spilled + (is_timer & ~fits)
            push_w.append(push._replace(mask=fits))
            push_q.append(push._replace(mask=push.mask & ~fits))
        return push_q, push_w, spilled

    def microstep_k(self, st: SimState, params: EngineParams, window_end: int):
        """The K-way microstep: peek each host's K earliest in-window events
        (K5), fold them through the handler in turn, clear the executed
        prefix (K6) and apply every push in one pass. Returns (state',
        executed[H]).

        Exactness guard: batch event j+1 of a host executes only if no push
        this host emitted so far in this microstep (model pushes and ingress
        requeues) has an earlier (time, order) key — with one event per
        microstep that push would pop first. Deferral is monotone, so the
        executed events are a prefix of the batch; the rest stay in the
        slab. Drop exactness: the pushes run after the clear, in one-event
        chronological order (requeue_0, pushes_0, requeue_1, ...), each
        holding a reserve of the batch events that executed after it."""
        cfg = self.cfg
        k = cfg.effective_microstep_events
        h = cfg.num_hosts
        dev = self.device
        popped = pop_k(st.queue, window_end, k)
        c = _ev_carry_of(st)
        deferred = torch.zeros((h,), dtype=torch.bool, device=dev)
        pm_t = torch.full((h,), TIME_MAX, dtype=torch.int64, device=dev)
        pm_o = torch.full((h,), ORDER_MAX, dtype=torch.int64, device=dev)
        cons_ks, push_lists, entries, used_mins = [], [], [], []
        for j in range(popped.t.shape[1]):
            ev = popped.event(j)
            if j > 0:
                deferred = deferred | _lex_less(pm_t, pm_o, ev.t, ev.order)
            cons_j = popped.active[:, j] & ~deferred
            c, push_list, ents, used_min = self.event_body(c, params, window_end, ev, cons_j)
            # an event's own pushes cannot defer it: fold them in after
            for push in push_list:
                better = push.mask & _lex_less(push.t, push.order, pm_t, pm_o)
                pm_t = torch.where(better, push.t, pm_t)
                pm_o = torch.where(better, push.order, pm_o)
            cons_ks.append(cons_j.to(torch.int32))
            push_lists.append(push_list)
            if ents is not None:
                entries.append(ents)
                used_mins.append(used_min)
        m = functools.reduce(torch.add, cons_ks)
        queue = clear_popped(st.queue, popped, m)
        all_pushes = []
        for j, push_list in enumerate(push_lists):
            reserve = (functools.reduce(torch.add, cons_ks[j + 1 :]) if j + 1 < len(cons_ks)
                       else torch.zeros_like(m))
            all_pushes += [p._replace(reserve=reserve) for p in push_list]
        if all_pushes:
            queue = q_push_many(queue, all_pushes)
        n_deferred = popped.active.sum() - m.sum()
        c = c._replace(stats=c.stats._replace(
            popk_deferred=c.stats.popk_deferred + n_deferred
        ))
        return self._finish_microstep(st, c, queue, entries, used_mins), m

    def _finish_microstep(self, st: SimState, c: "_EvCarry", queue, entries, used_mins):
        """Apply the microstep's outbox appends (its events' entry stacks in
        one K9 pass), fold the used-latency lookahead, and reassemble the
        state."""
        outbox, min_used = st.outbox, st.min_used_lat
        stats = c.stats
        if entries:
            outbox, ob_dropped = outbox_append_multi(outbox, entries, stats.ob_dropped)
            used = used_mins[0] if len(used_mins) == 1 else torch.stack(used_mins)
            min_used = torch.minimum(min_used, used.min())
            stats = stats._replace(ob_dropped=ob_dropped)
        return st._replace(
            queue=queue, rng=c.rng, seq=c.seq, sent_round=c.sent_round,
            tb_egress=c.tb_egress, tb_ingress=c.tb_ingress, codel=c.codel,
            model=c.model, outbox=outbox, min_used_lat=min_used, stats=stats,
        )

    def event_body(self, c: _EvCarry, params: EngineParams, window_end: int, ev, active):
        """Execute one event per active host: ingress (digest, shaping,
        dispatch; K10), the model's handler, egress (pushes and sends; K11).
        Returns (carry', pushes, outbox entry stack | None, per-host
        used-latency minimum | None)."""
        cfg = self.cfg
        c, ing = event_ingress(c, params, cfg, ev, active)
        out = self.model.handle(HandlerCtx(
            t=ev.t,
            window_end=window_end,
            kind=ing.kind,
            payload=ev.payload,
            active=ing.dispatch,
            is_packet=ing.is_pkt,
            src=ing.src,
            host_id=self._host_gid,
            state=c.model,
            params=params.model,
            rng=c.rng,
        ))
        c = c._replace(model=out.state, rng=out.rng)
        c, pushes, entries, used_min = event_egress(
            c, params, cfg, ev.t, ing.dispatch, window_end, out)
        push_list = ([ing.requeue] if ing.requeue is not None else []) + pushes
        return c, push_list, entries, used_min

    def exchange(self, st: SimState, has_sends: bool = True) -> SimState:
        """World-1 exchange: merge the outbox, host-major, into the queues
        (K4, or K13 with `merge_scatter`; under a merge gear only its first
        `gear_cols` columns, read in place, with the sends beyond them
        counted into `stats.gear_shed`); a bucketed queue then gets its
        block caches rebuilt (counted in rounds that sent anything, as the
        reference counts them). With `has_sends` False (the round staged
        nothing) the merge and the rebuild are skipped: they would not
        change the queue. The timer wheel is not touched."""
        cfg, ob = self.cfg, st.outbox
        queue, stats = st.queue, st.stats
        gc = cfg.gear_cols if cfg.gear_active else 0
        if gc:
            stats = stats._replace(
                gear_shed=stats.gear_shed + gear_shed_count(st.sent_round, gc))
        if has_sends:
            merge = merge_scatter_free if cfg.merge_scatter else merge_flat_events
            queue = merge(
                as_flat(st.queue), ob.dst, ob.t, ob.order, ob.kind, ob.payload, None,
                cfg.max_round_inserts, shed_urgency=not cfg.cheap_shed, cols=gc,
            )
            if isinstance(st.queue, BucketQueue):
                queue = bucket_rebuild(queue, st.queue.block)
                stats = stats._replace(bq_rebuilds=stats.bq_rebuilds + (ob.count > 0))
        return st._replace(
            queue=queue,
            stats=stats,
            outbox=make_empty_outbox(cfg.num_hosts, cfg.sends_per_host_round, ob.t.device),
            sent_round=torch.zeros_like(st.sent_round),
        )


def pop_min_merged(queue, wheel: TimerWheel, limit: int):
    """Pop each host's earliest event from queue and wheel under the
    (time, order) key: compare the two heads, then each structure pops with
    the limit masked to the hosts it won (an [H] limit, 0 where it lost),
    so exactly one event pops per active host — the one the wheel-off path
    would pop from its single queue. Live keys never tie; the all-empty tie
    on the sentinels goes to the wheel, whose pop then finds nothing.
    Returns (queue', wheel', event, active)."""
    qt, qo = q_head(queue)
    wt, wo = q_head(wheel)
    q_wins = _lex_less(qt, qo, wt, wo)
    zero = torch.zeros_like(qt)
    lim = torch.full_like(qt, limit)
    queue, ev_q, act_q = q_pop_min(queue, torch.where(q_wins, lim, zero))
    wheel, ev_w, act_w = wheel_pop_min(wheel, torch.where(q_wins, zero, lim))
    ev = Event(
        t=torch.where(act_w, ev_w.t, ev_q.t),
        order=torch.where(act_w, ev_w.order, ev_q.order),
        kind=torch.where(act_w, ev_w.kind, ev_q.kind),
        payload=torch.where(act_w[:, None], ev_w.payload, ev_q.payload),
    )
    return queue, wheel, ev, act_q | act_w
