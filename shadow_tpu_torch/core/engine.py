"""The conservative-PDES round engine, single device (port of the
single-device subset of shadow_tpu/core/engine.py).

One round advances every host through the safe window [now, window_end):

  1. barrier: the minimum over hosts of the next event time (K1, over the
     slab or the bucketed queue's block caches);
  2. window_end = min(gmin + runahead, stop_time);
  3. microsteps, while any host has an event before window_end: every host
     pops its earliest event (K2; K5 + K6 on the bucketed queue), one
     vectorized model handler runs for all hosts, packet arrivals pass
     ingress shaping (CoDel + downlink token bucket), sends pass egress
     shaping (budget, uplink bucket, loss/jitter draws, routing) into the
     [H, B] outbox, local pushes land in the queue (K3; K7 bucketed);
  4. exchange: the outbox merges into the destination queues (K4), and a
     bucketed queue's block caches are rebuilt (K8).

With `microstep_events` K > 1 a microstep peeks each host's K earliest
in-window events (K5), runs them through the handler in turn as long as no
push of this microstep would pop before the next one, clears the executed
prefix (K6) and applies all pushes in one pass (K3/K7), each holding back a
reserve so that drops equal the one-event microstep's.

The slice is the JAX package's single-device path: flat or bucketed queue,
K >= 1, world 1. `lax.while_loop` becomes a Python loop; each loop
condition is one device-to-host read, counted in `Engine.host_syncs`. The
window itself is computed on the device and read back with the `done` flag
in the same read.

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

from shadow_tpu_torch.models.base import (
    KIND_INGRESS_DONE,
    KIND_MASK,
    KIND_PKT,
    PAYLOAD_SIZE_WORD,
    HandlerCtx,
)
from shadow_tpu_torch.net import (
    CodelState,
    TBParams,
    TBState,
    codel_init,
    codel_on_packet,
    tb_conforming_remove,
    tb_init,
)
from shadow_tpu_torch.ops.events import (
    _LOCAL_SHIFT,
    _SRC_SHIFT,
    EVENT_PAYLOAD_WORDS,
    ORDER_MAX,
    SEQ_MASK,
    BucketQueue,
    EventQueue,
    Push,
    as_flat,
    bucket_rebuild,
    check_order_limits,
    clear_popped,
    pack_order,
    pop_k,
    q_len,
    q_next_time,
    q_pop_min,
    q_push_many,
    unpack_order_src,
)
from shadow_tpu_torch.ops.merge import merge_flat_events
from shadow_tpu_torch.ops.rng import RngState, rng_init, rng_uniform, u64
from shadow_tpu_torch.simtime import TIME_MAX

_FNV_PRIME = u64(1099511628211)
_FNV_OFFSET = u64(0xCBF29CE484222325)
_MIX1 = u64(0x9E3779B97F4A7C15)
_MIX2 = u64(0xC2B2AE3D27D4EB4F)


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


def digest_update(digest, active, t, kind, order):
    """One FNV-1a-style fold of (t, kind, order) into each active host's
    digest, in uint64 arithmetic carried as int64."""
    x = t * _MIX1
    x = x ^ (kind.to(torch.int64) * _MIX2)
    x = x ^ order
    return torch.where(active, (digest ^ x) * _FNV_PRIME, digest)


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


def seed_queue(cfg: EngineConfig, initial_events, device):
    """The t=0 queue from (host_id, t_ns, kind, payload) events (bucketed
    when `queue_block`), and the per-host seq counters advanced past
    them."""
    h, c = cfg.num_hosts, cfg.queue_capacity
    t = np.full((h, c), TIME_MAX, np.int64)
    order = np.full((h, c), ORDER_MAX, np.int64)
    kind = np.zeros((h, c), np.int32)
    payload = np.zeros((h, c, EVENT_PAYLOAD_WORDS), np.int32)
    fill = np.zeros((h,), np.int32)
    seq = np.zeros((h,), np.int64)
    for host, t_ns, k, pl in initial_events:
        slot = fill[host]
        if slot >= c:
            raise ValueError(f"host {host}: {slot + 1} initial events exceed queue capacity {c}")
        t[host, slot] = t_ns
        order[host, slot] = (1 << _LOCAL_SHIFT) | (host << _SRC_SHIFT) | (int(seq[host]) & SEQ_MASK)
        kind[host, slot] = k
        payload[host, slot, : len(pl)] = pl
        seq[host] += 1
        fill[host] += 1
    queue = EventQueue(
        t=torch.as_tensor(t, device=device),
        order=torch.as_tensor(order, device=device),
        kind=torch.as_tensor(kind, device=device),
        payload=torch.as_tensor(payload, device=device),
        dropped=torch.zeros((h,), dtype=torch.int64, device=device),
    )
    if cfg.queue_block:
        queue = bucket_rebuild(queue, cfg.queue_block)
    return queue, torch.as_tensor(seq, device=device)


def outbox_append_multi(ob: Outbox, entries) -> tuple[Outbox, torch.Tensor]:
    """Write every entry (mask, col, dst, t, order, kind, payload) into its
    host's lane at column `col` (one-hot writes); col >= B is counted lost."""
    h, b = ob.t.shape
    cols = torch.arange(b, dtype=torch.int32, device=ob.t.device)[None, :]
    dst_n, t_n, order_n, kind_n, payload_n = ob.dst, ob.t, ob.order, ob.kind, ob.payload
    lost = torch.zeros((h,), dtype=torch.int64, device=ob.t.device)
    total = torch.zeros((h,), dtype=torch.int32, device=ob.t.device)
    for mask, col, dst, t, order, kind, payload in entries:
        oh = mask[:, None] & (cols == col[:, None])
        dst_n = torch.where(oh, dst.to(torch.int32)[:, None], dst_n)
        t_n = torch.where(oh, t[:, None], t_n)
        order_n = torch.where(oh, order[:, None], order_n)
        kind_n = torch.where(oh, kind.to(torch.int32)[:, None], kind_n)
        payload_n = torch.where(oh[:, :, None], payload.to(torch.int32)[:, None, :], payload_n)
        lost = lost + (mask & (col >= b))
        total = total + mask
    return (
        Outbox(dst_n, t_n, order_n, kind_n, payload_n,
               ob.count + total.sum(dtype=torch.int32)[None]),
        lost.sum(),
    )


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
        queue, seq = seed_queue(cfg, initial_events, dev)
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
        )
        return state, params

    # ---- the round loop ------------------------------------------------------

    def run_chunk(self, st: SimState, params: EngineParams) -> SimState:
        for _ in range(self.cfg.rounds_per_chunk):
            if st.done:
                break
            st = self.round_step(st, params)
        return st

    def compute_window(self, st: SimState) -> tuple[int, bool]:
        """Barrier + window: (window_end, done), one device-to-host read."""
        cfg = self.cfg
        gmin = q_next_time(st.queue).min()
        done = gmin >= cfg.stop_time
        gmin_safe = torch.clamp_max(gmin, cfg.stop_time)
        if cfg.use_dynamic_runahead:
            runahead = torch.clamp_min(st.min_used_lat, max(cfg.runahead_floor, 1))
        else:
            runahead = max(cfg.runahead_floor, cfg.static_min_latency, 1)
        window_end = torch.clamp_max(gmin_safe + runahead, cfg.stop_time)
        we, dn = torch.stack([window_end, done.to(torch.int64)]).tolist()
        self.host_syncs += 1
        return int(we), bool(dn)

    def round_step(self, st: SimState, params: EngineParams) -> SimState:
        window_end, done = self.compute_window(st)
        return self.window_step(st, params, window_end, done)

    def window_step(self, st: SimState, params: EngineParams, window_end: int, done: bool) -> SimState:
        cfg = self.cfg
        limit = cfg.effective_microstep_limit
        steps = 0
        if cfg.effective_microstep_events > 1:
            # the valve is a per-host executed-event vector bounded by its
            # max, read in the same device-to-host read as the loop test
            valve = torch.zeros((cfg.num_hosts,), dtype=torch.int64, device=self.device)
            while True:
                pending = (q_next_time(st.queue) < window_end).any().to(torch.int64)
                go, vmax = torch.stack([pending, valve.max()]).tolist()
                self.host_syncs += 1
                if not go or vmax >= limit:
                    break
                st, executed = self.microstep_k(st, params, window_end)
                valve = valve + executed
                steps += 1
        else:
            while steps < limit:
                pending = bool((q_next_time(st.queue) < window_end).any())
                self.host_syncs += 1
                if not pending:
                    break
                st = self.microstep(st, params, window_end)
                steps += 1
        st_m = st
        st_x = self.exchange(st_m)
        occ = q_len(st_x.queue).to(torch.int64)
        ob_hwm = st_m.sent_round.max().to(torch.int64)
        s = st_x.stats
        stats = s._replace(
            rounds=s.rounds + (0 if done else 1),
            microsteps=s.microsteps + steps,
            q_occ_hwm=torch.maximum(s.q_occ_hwm, occ),
            outbox_hwm=torch.maximum(s.outbox_hwm, ob_hwm[None]),
        )
        return st_x._replace(
            now=st.now if done else window_end, done=done, stats=stats
        )

    def microstep(self, st: SimState, params: EngineParams, window_end: int) -> SimState:
        """The one-event microstep: pop, execute, push, append."""
        queue, ev, active = q_pop_min(st.queue, window_end)
        c, push_list, entries, used_lats = self.event_body(
            _ev_carry_of(st), params, window_end, ev, active,
        )
        if push_list:
            queue = q_push_many(queue, push_list)
        return self._finish_microstep(st, c, queue, entries, used_lats)

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
        cons_ks, push_lists, entries, used_lats = [], [], [], []
        for j in range(popped.t.shape[1]):
            ev = popped.event(j)
            if j > 0:
                deferred = deferred | _lex_less(pm_t, pm_o, ev.t, ev.order)
            cons_j = popped.active[:, j] & ~deferred
            c, push_list, ents, lats = self.event_body(c, params, window_end, ev, cons_j)
            # an event's own pushes cannot defer it: fold them in after
            for push in push_list:
                better = push.mask & _lex_less(push.t, push.order, pm_t, pm_o)
                pm_t = torch.where(better, push.t, pm_t)
                pm_o = torch.where(better, push.order, pm_o)
            cons_ks.append(cons_j.to(torch.int32))
            push_lists.append(push_list)
            entries += ents
            used_lats += lats
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
        return self._finish_microstep(st, c, queue, entries, used_lats), m

    def _finish_microstep(self, st: SimState, c: "_EvCarry", queue, entries, used_lats):
        """Apply the microstep's outbox appends, fold the used-latency
        lookahead, and reassemble the state."""
        outbox, min_used = st.outbox, st.min_used_lat
        stats = c.stats
        if entries:
            outbox, n_lost = outbox_append_multi(outbox, entries)
            min_used = torch.minimum(min_used, torch.stack([u.min() for u in used_lats]).min())
            stats = stats._replace(ob_dropped=stats.ob_dropped + n_lost)
        return st._replace(
            queue=queue, rng=c.rng, seq=c.seq, sent_round=c.sent_round,
            tb_egress=c.tb_egress, tb_ingress=c.tb_ingress, codel=c.codel,
            model=c.model, outbox=outbox, min_used_lat=min_used, stats=stats,
        )

    def event_body(self, c: _EvCarry, params: EngineParams, window_end: int, ev, active):
        """Execute one event per active host: digest, ingress shaping, model
        dispatch, egress staging. Returns (carry', pushes, outbox entries,
        used latencies)."""
        cfg, model, host_gid = self.cfg, self.model, self._host_gid
        stats = c.stats
        stats = stats._replace(
            events=stats.events + active,
            digest=digest_update(stats.digest, active, ev.t, ev.kind, ev.order),
        )
        is_pkt = (ev.kind & KIND_PKT) != 0

        if cfg.shaping:
            needs_ingress = active & is_pkt & ((ev.kind & KIND_INGRESS_DONE) == 0)
            size_bits = ev.payload[:, PAYLOAD_SIZE_WORD].to(torch.int64) * 8
            _, depart_probe = tb_conforming_remove(
                c.tb_ingress, params.in_tb, cfg.tb_interval_ns, ev.t, size_bits,
                torch.zeros_like(needs_ingress),
            )
            sojourn = depart_probe - ev.t
            if cfg.use_codel:
                codel, codel_drop = codel_on_packet(c.codel, ev.t, sojourn, needs_ingress)
            else:
                codel, codel_drop = c.codel, torch.zeros_like(needs_ingress)
            tb_in, depart = tb_conforming_remove(
                c.tb_ingress, params.in_tb, cfg.tb_interval_ns, ev.t, size_bits,
                needs_ingress & ~codel_drop,
            )
            delay = needs_ingress & ~codel_drop & (depart > ev.t)
            # the bucket-delayed packet goes back into the queue past shaping;
            # it is the FIRST push of the microstep (slot order is part of
            # the contract)
            requeue = Push(delay, depart, ev.order, ev.kind | KIND_INGRESS_DONE, ev.payload)
            stats = stats._replace(pkts_codel_dropped=stats.pkts_codel_dropped + codel_drop)
            dispatch = active & ~(needs_ingress & (codel_drop | delay))
        else:
            codel, tb_in = c.codel, c.tb_ingress
            requeue = None
            dispatch = active

        stats = stats._replace(pkts_delivered=stats.pkts_delivered + (dispatch & is_pkt))
        out = model.handle(HandlerCtx(
            t=ev.t,
            window_end=window_end,
            kind=ev.kind & KIND_MASK,
            payload=ev.payload,
            active=dispatch,
            is_packet=is_pkt,
            src=unpack_order_src(ev.order),
            host_id=host_gid,
            state=c.model,
            params=params.model,
            rng=c.rng,
        ))
        rng, seq, sent_round, tb_eg = out.rng, c.seq, c.sent_round, c.tb_egress

        push_list = [requeue] if requeue is not None else []
        for p in out.pushes:
            mask = p.mask & dispatch
            stats = stats._replace(
                monotonic_violations=stats.monotonic_violations + (mask & (p.t < ev.t))
            )
            push_list.append(Push(
                mask, torch.maximum(p.t, ev.t), pack_order(1, host_gid, seq),
                p.kind.to(torch.int32) & KIND_MASK, p.payload.to(torch.int32),
            ))
            seq = seq + mask

        # sends: each port may carry a burst of up to count_max segments to
        # one destination, sharing the route lookup; each segment has its
        # own budget slot, bandwidth charge, loss draw and order key
        entries, used_lats = [], []
        for s in out.sends:
            mask0 = s.mask & dispatch
            # gate on count is None: count=None with count_max > 1 is legal,
            # and an explicit count of 0 suppresses the send
            if s.count is None:
                counts = mask0.to(torch.int32)
            else:
                counts = torch.where(mask0, s.count.to(torch.int32), 0)
            sz = s.size_bytes.to(torch.int32)
            bad_dst = mask0 & ((s.dst < 0) | (s.dst >= cfg.num_hosts))
            dst = torch.clamp(s.dst, 0, cfg.num_hosts - 1)
            lat, lossp, jit = self._route(params, dst)
            lat_bound0 = lat - jit if cfg.use_jitter else lat
            port_kind = s.kind.to(torch.int32) | KIND_PKT
            for j in range(s.count_max):
                mask = mask0 & (counts > j)
                over_budget = sent_round >= cfg.sends_per_host_round
                if cfg.shaping:
                    tb_eg, eg_depart = tb_conforming_remove(
                        tb_eg, params.eg_tb, cfg.tb_interval_ns, ev.t,
                        sz.to(torch.int64) * 8, mask & ~over_budget,
                    )
                else:
                    eg_depart = ev.t
                lat_j = lat
                if cfg.use_jitter:
                    rng, uj = rng_uniform(rng, mask)
                    lat_j = lat + ((uj * 2.0 - 1.0) * jit.to(torch.float32)).to(torch.int64)
                unreachable = mask & ((lat_bound0 < 0) | bad_dst)
                rng, u = rng_uniform(rng, mask)
                lost = mask & (u < lossp) & (ev.t >= cfg.bootstrap_end_time)
                send_ok = mask & ~lost & ~unreachable & ~over_budget
                budget_dropped = mask & ~lost & ~unreachable & over_budget
                ob_col = sent_round
                sent_round = sent_round + send_ok.to(torch.int32)
                arrive = torch.clamp_min(eg_depart + torch.clamp_min(lat_j, 0), window_end)
                order = pack_order(0, host_gid, seq)
                seq = seq + mask
                payload = s.payload.to(torch.int32)
                if j > 0 and s.payload_inc is not None:
                    payload = payload + j * s.payload_inc.to(torch.int32)
                payload = payload.clone()
                payload[:, PAYLOAD_SIZE_WORD] = sz
                entries.append((send_ok, ob_col, dst, arrive, order, port_kind, payload))
                used_lats.append(torch.where(send_ok, lat_bound0, TIME_MAX))
                stats = stats._replace(
                    pkts_sent=stats.pkts_sent + mask,
                    pkts_lost=stats.pkts_lost + lost,
                    pkts_unreachable=stats.pkts_unreachable + unreachable,
                    pkts_budget_dropped=stats.pkts_budget_dropped + budget_dropped,
                )
        carry = _EvCarry(stats, rng, seq, sent_round, tb_eg, tb_in, codel, out.state)
        return carry, push_list, entries, used_lats

    def _route(self, params: EngineParams, dst: torch.Tensor):
        """(latency, loss, jitter) from each sender to `dst`, in the three
        forms of the reference: a constant for single-node graphs, a row
        lookup (affine or node_of destination node) when the per-host rows
        exist, else a 2-D table gather."""
        cfg = self.cfg
        h = dst.shape[0]
        if tuple(params.lat_ns.shape) == (1, 1):
            return (params.lat_ns[0, 0].expand(h), params.loss[0, 0].expand(h),
                    params.jitter_ns[0, 0].expand(h))
        if cfg.hosts_per_node > 0:
            dst_node = torch.div(dst, cfg.hosts_per_node, rounding_mode="floor")
            src_node = torch.div(self._host_gid, cfg.hosts_per_node, rounding_mode="floor")
        else:
            dst_node = params.node_of[dst].to(torch.int64)
            src_node = params.node_of.to(torch.int64)
        if params.lat_rows is not None:
            col = dst_node[:, None]
            return (params.lat_rows.gather(1, col)[:, 0], params.loss_rows.gather(1, col)[:, 0],
                    params.jit_rows.gather(1, col)[:, 0])
        return (params.lat_ns[src_node, dst_node], params.loss[src_node, dst_node],
                params.jitter_ns[src_node, dst_node])

    def exchange(self, st: SimState) -> SimState:
        """World-1 exchange: merge the outbox, host-major, into the queues;
        a bucketed queue then gets its block caches rebuilt (counted in
        rounds that sent anything, as the reference counts them — its
        skipped rebuild of an unchanged slab gives the same caches)."""
        cfg, ob = self.cfg, st.outbox
        dst_f = ob.dst.reshape(-1)
        t_f = ob.t.reshape(-1)
        valid = (t_f != TIME_MAX) & (dst_f >= 0) & (dst_f < cfg.num_hosts)
        queue = merge_flat_events(
            as_flat(st.queue), dst_f, t_f, ob.order.reshape(-1), ob.kind.reshape(-1),
            ob.payload.reshape(-1, ob.payload.shape[-1]), valid,
            cfg.max_round_inserts, shed_urgency=not cfg.cheap_shed,
        )
        stats = st.stats
        if isinstance(st.queue, BucketQueue):
            queue = bucket_rebuild(queue, st.queue.block)
            stats = stats._replace(bq_rebuilds=stats.bq_rebuilds + (ob.count > 0))
        return st._replace(
            queue=queue,
            stats=stats,
            outbox=make_empty_outbox(cfg.num_hosts, cfg.sends_per_host_round, ob.t.device),
            sent_round=torch.zeros_like(st.sent_round),
        )
