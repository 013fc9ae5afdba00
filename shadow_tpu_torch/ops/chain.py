"""The per-event chain of a microstep (B5) with the outbox append (B4): port
of shadow_tpu/core/engine.py `_event_body` and `_outbox_append_multi`.

One executed event per host runs in three steps:

  1. ingress (`event_ingress`, K10): under the CPU model (`cpu_delay_ns` >
     0) the event moves to its execution time max(t, busy_until) and the
     host's busy horizon to that plus the delay, and under queue-hold
     crash faults to the restart of a crash window containing it (counted
     in `faults_delayed`); under queue-clear faults an event executing in
     a crash window is consumed, not dispatched (`faults_dropped`); events
     and the digest fold (with the integrity sentinel's dual digest, a
     second fold); for a packet that has not passed shaping, CoDel at the router
     queue and the downlink token bucket — a CoDel drop is counted, a
     bucket delay requeues the packet past shaping; what remains is
     dispatched;
  2. the model's handler (its kernel, K17-K22; `handle_plain` on the CPU);
  3. egress (`event_egress`, K11): the model's local pushes get their
     order keys; every send port and burst segment passes the send budget,
     the uplink token bucket, the jitter and loss draws and the route
     lookup, and a send that lands is appended to the [H, B] outbox at the
     host's send cursor (B4; past B it is counted lost in `ob_dropped`),
     its pre-jitter latency folded into `min_used_lat`. With the fluid
     plane on (net/fluid.py) the round's per-host `fluid_fx` = (extra loss,
     latency x1000) adds a counter-hash loss draw (when `fluid_loss_max` >
     0) and inflates the jittered latency; the lookahead keeps the
     pre-inflation bound. With link-fault windows (core/faults.py) one
     more loss draw follows the path-loss draw and the latency is
     inflated by the windows' multiplier first.

On a flat queue the one-event microstep pops and runs step 1 in one kernel
(`pop_ingress`, K36): the pop of ops/events.py `pop_min` (one limit, or
one per host) followed by the ingress, with no [H] event lanes written
by one launch and read back by the next. Its plain version is
`pop_min_plain` followed by `event_ingress_plain`.

The plain egress (`event_egress_plain`) returns the event's [E, H] entry
stack and per-host used latency, as the reference's `_event_body` does;
`event_egress_append_plain` then appends that stack
(`outbox_append_multi_plain`, the reference's one-hot writes) and folds the
latency: that composite is K11's plain version. The carry holds the outbox
and `min_used_lat` (`_EvCarry.outbox`, `.min_used_lat`).

Replicas (the ensemble plane, `EngineConfig.replicas` R > 1): the H rows
are R replicas of `hosts_per_shard` hosts. The outbox's `count`, the
`ob_dropped` lane and `min_used_lat` are then [R], one per replica; egress
uses each host's id within its replica, a destination range of one
replica's hosts, the replica's window end (`window_end` an i64[R] lane) and
link-fault windows ([R, L]), and reads per-host route rows held once for
all replicas or per row. Ingress reads no host id and no window.

This module holds the hand-written CUDA kernels (csrc/event.cu) and their
plain PyTorch versions beside them. As in ops/events.py, each public
function dispatches on where its tensors live: CPU tensors run the plain
version, CUDA tensors launch the kernel; there is no fallback. On CUDA the
kernels update the carry's lanes (stats, RNG, token buckets, CoDel, seq,
send cursor), its outbox and its `min_used_lat` IN PLACE: a carry is
consumed by the step that takes it. The plain versions are functional.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from shadow_tpu_torch.models.base import (
    KIND_INGRESS_DONE,
    KIND_MASK,
    KIND_PKT,
    PAYLOAD_SIZE_WORD,
)
from shadow_tpu_torch.net import codel_on_packet, tb_conforming_remove
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.events import (
    Event,
    Push,
    _check_slab,
    pack_order,
    pop_min_plain,
    unpack_order_src,
)
from shadow_tpu_torch.ops.rng import rng_uniform, u64
from shadow_tpu_torch.simtime import TIME_MAX

_FNV_PRIME = u64(1099511628211)
_MIX1 = u64(0x9E3779B97F4A7C15)
_MIX2 = u64(0xC2B2AE3D27D4EB4F)
# the integrity sentinel's second fold (core/integrity.py DIGEST2_PRIME)
_MIX3 = u64(0xD6E8FEB86659FD93)
_MIX4 = u64(0xA0761D6478BD642F)
_DIGEST2_PRIME = u64(0x5851F42D4C957F2D)
MAX_PUSH_PORTS = 8  # model push ports per event (K11 limit)
MAX_SEND_PORTS = 8  # model send ports per event (K11 limit)


class EntryStack(NamedTuple):
    """One event's outbox entries, a row per send segment: [E, H] per
    field (payload [E, H, P]); row e of host h goes to outbox column
    col[e, h] where mask[e, h]."""

    mask: torch.Tensor  # bool[E, H]
    col: torch.Tensor  # i32[E, H]
    dst: torch.Tensor  # i32[E, H]
    t: torch.Tensor  # i64[E, H] arrival time
    order: torch.Tensor  # i64[E, H]
    kind: torch.Tensor  # i32[E, H]
    payload: torch.Tensor  # i32[E, H, P]


class Ingress(NamedTuple):
    """What the handler and egress read from the ingress step (all [H])."""

    dispatch: torch.Tensor  # bool: the host's handler runs this event
    is_pkt: torch.Tensor  # bool
    kind: torch.Tensor  # i32 model kind (engine flags stripped)
    src: torch.Tensor  # i64 sending host (valid for packets)
    requeue: Any  # Push | None: bucket-delayed packets, past shaping
    # the execution time every later step reads: the event's time, moved
    # to the busy horizon under the CPU model (on CUDA the event's own
    # lane, rewritten in place)
    t: torch.Tensor  # i64


def digest_update(digest, active, t, kind, order):
    """One FNV-1a-style fold of (t, kind, order) into each active host's
    digest, in uint64 arithmetic carried as int64."""
    x = t * _MIX1
    x = x ^ (kind.to(torch.int64) * _MIX2)
    x = x ^ order
    return torch.where(active, (digest ^ x) * _FNV_PRIME, digest)


# --------------------------------------------------------------------------
# K10 event_ingress
# --------------------------------------------------------------------------

_ingress_k = CudaKernel("event", "event_ingress", ARG_BLOCK)


def digest2_update(digest2, active, t, kind, order):
    """The integrity sentinel's second fold: the same inputs, no constant
    shared with `digest_update`, and the order (not the time) carries the
    first multiplier."""
    x = order * _MIX3
    x = x ^ (t * _MIX4)
    x = x ^ kind.to(torch.int64)
    return torch.where(active, (digest2 ^ x) * _DIGEST2_PRIME, digest2)


def timer_kind_mask(timer_kinds) -> int:
    """The model's timer kinds as the bitmask K10's class lane takes."""
    mask = 0
    for k in timer_kinds:
        if not 0 <= int(k) < 63:
            raise ValueError(f"timer kind {k}: the event-class lane takes kinds 0..62")
        mask |= 1 << int(k)
    return mask


def event_classes_plain(stats, active, kind, timer_mask: int):
    """The network observatory's event-class lane: each executed event
    counts once as timer (a model kind in `timer_mask`, no packet flag),
    packet or app into the [1] ec_* lanes."""
    is_pkt = (kind & KIND_PKT) != 0
    mk = (kind & KIND_MASK).to(torch.int64)
    in_mask = (mk < 63) & (((torch.full_like(mk, timer_mask) >> torch.clamp_max(mk, 62)) & 1) != 0)
    timer = active & ~is_pkt & in_mask
    return stats._replace(
        ec_timer=stats.ec_timer + timer.sum(),
        ec_pkt=stats.ec_pkt + (active & is_pkt).sum(),
        ec_app=stats.ec_app + (active & ~is_pkt & ~timer).sum(),
    )


def event_ingress_plain(c, params, cfg, ev, active, timer_mask: int = 0):
    """The execution time (the CPU model's busy horizon; under queue-hold
    crash faults the restart of the window containing it), the queue-clear
    fault drop, the digests, the event classes (with the network
    observatory; `timer_mask` is the model's timer kinds), ingress shaping
    and dispatch for one event per active host. Returns (carry',
    Ingress)."""
    from shadow_tpu_torch.core.faults import down_and_resume_plain

    stats = c.stats
    if cfg.cpu_delay_ns > 0 or cfg.fault_hold:
        exec_t = ev.t
        if cfg.cpu_delay_ns > 0:
            exec_t = torch.maximum(exec_t, c.cpu_busy_until)
        if cfg.fault_hold:
            # the down check reads the busy-floored time (the candidate
            # execution time); an event executing at a restart is delayed
            down, resume = down_and_resume_plain(params.faults, exec_t)
            exec_t = torch.maximum(exec_t, resume)
            stats = stats._replace(faults_delayed=stats.faults_delayed + (active & down))
        ev = ev._replace(t=torch.where(active, exec_t, ev.t))
        if cfg.cpu_delay_ns > 0:
            c = c._replace(cpu_busy_until=torch.where(active, exec_t + cfg.cpu_delay_ns,
                                                      c.cpu_busy_until))
    if cfg.fault_clear:
        # consumed but never dispatched: no digest, no pushes, no sends
        down, _ = down_and_resume_plain(params.faults, ev.t)
        fdrop = active & down
        active = active & ~fdrop
        stats = stats._replace(faults_dropped=stats.faults_dropped + fdrop)
    stats = stats._replace(
        events=stats.events + active,
        digest=digest_update(stats.digest, active, ev.t, ev.kind, ev.order),
    )
    if cfg.integrity_dual:
        stats = stats._replace(
            digest2=digest2_update(stats.digest2, active, ev.t, ev.kind, ev.order))
    if cfg.netobs:
        stats = event_classes_plain(stats, active, ev.kind, timer_mask)
    is_pkt = (ev.kind & KIND_PKT) != 0
    codel, tb_in, requeue, dispatch = c.codel, c.tb_ingress, None, active
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
            codel_drop = torch.zeros_like(needs_ingress)
        tb_in, depart = tb_conforming_remove(
            c.tb_ingress, params.in_tb, cfg.tb_interval_ns, ev.t, size_bits,
            needs_ingress & ~codel_drop,
        )
        delay = needs_ingress & ~codel_drop & (depart > ev.t)
        # the bucket-delayed packet goes back into the queue past shaping;
        # it is the FIRST push of the event (slot order is part of the
        # contract)
        requeue = Push(delay, depart, ev.order, ev.kind | KIND_INGRESS_DONE, ev.payload)
        stats = stats._replace(pkts_codel_dropped=stats.pkts_codel_dropped + codel_drop)
        dispatch = active & ~(needs_ingress & (codel_drop | delay))
    stats = stats._replace(pkts_delivered=stats.pkts_delivered + (dispatch & is_pkt))
    ing = Ingress(dispatch, is_pkt, ev.kind & KIND_MASK, unpack_order_src(ev.order), requeue,
                  ev.t)
    return c._replace(stats=stats, tb_ingress=tb_in, codel=codel), ing


def _event_stride(ev, h: int, p: int) -> int:
    """Host stride of an event's [H] lanes: 1 for a popped event, K for a
    column of the K-way peek; payload rows must be contiguous words."""
    es = ev.t.stride(0) if h > 1 else 1
    for x, dt, name in ((ev.t, torch.int64, "t"), (ev.order, torch.int64, "order"),
                        (ev.kind, torch.int32, "kind")):
        if not x.is_cuda or x.dtype != dt or tuple(x.shape) != (h,):
            raise ValueError(f"event {name}: expected a CUDA {dt} [{h}] tensor")
        if h > 1 and x.stride(0) != es:
            raise ValueError(f"event {name}: host stride {x.stride(0)}, expected {es}")
    pl = ev.payload
    if not pl.is_cuda or pl.dtype != torch.int32 or tuple(pl.shape) != (h, p):
        raise ValueError(f"event payload: expected a CUDA int32 [{h}, {p}] tensor")
    if (h > 1 and pl.stride(0) != es * p) or (p > 1 and pl.stride(1) != 1):
        raise ValueError(f"event payload: strides {pl.stride()}, expected ({es * p}, 1)")
    return es


def _ingress_block(c, params, cfg, ev, active, timer_mask: int, es: int):
    """K10's argument block for event `ev` (host stride `es`) and `active`
    (K36: its outputs), with the Ingress outputs it writes allocated."""
    h = active.shape[0]
    p = ev.payload.shape[1]
    dev = ev.t.device
    s, tb, cd = c.stats, c.tb_ingress, c.codel
    check(active, torch.bool, (h,), "active")
    for x, dt, name in (
        (s.events, torch.int64, "events"), (s.digest, torch.int64, "digest"),
        (s.pkts_codel_dropped, torch.int64, "pkts_codel_dropped"),
        (s.pkts_delivered, torch.int64, "pkts_delivered"),
        (tb.tokens, torch.int64, "tb tokens"), (tb.last_itv, torch.int64, "tb last_itv"),
        (params.in_tb.capacity, torch.int64, "tb capacity"),
        (params.in_tb.refill, torch.int64, "tb refill"),
        (cd.first_above, torch.int64, "codel first_above"),
        (cd.drop_next, torch.int64, "codel drop_next"),
        (cd.count, torch.int32, "codel count"), (cd.dropping, torch.bool, "codel dropping"),
    ):
        check(x, dt, (h,), name)
    busy = c.cpu_busy_until if cfg.cpu_delay_ns > 0 else None
    if busy is not None:
        check(busy, torch.int64, (h,), "cpu_busy_until")
    fault_mode = 1 if cfg.fault_hold else 2 if cfg.fault_clear else 0
    crash = (params.faults.down_t, params.faults.up_t) if fault_mode else (None, None)
    nw = crash[0].shape[1] if fault_mode else 0
    if fault_mode:
        for x, name in zip(crash, ("fault down_t", "fault up_t")):
            check(x, torch.int64, (h, nw), name)
        check(s.faults_delayed if fault_mode == 1 else s.faults_dropped, torch.int64, (h,),
              "faults_delayed" if fault_mode == 1 else "faults_dropped")
    d2 = s.digest2 if cfg.integrity_dual else None
    if d2 is not None:
        check(d2, torch.int64, (h,), "digest2")
    ec = (s.ec_timer, s.ec_pkt, s.ec_app) if cfg.netobs else (None, None, None)
    if cfg.netobs:
        for x, name in zip(ec, ("ec_timer", "ec_pkt", "ec_app")):
            check(x, torch.int64, (1,), name)
    ing = Ingress(
        dispatch=torch.empty((h,), dtype=torch.bool, device=dev),
        is_pkt=torch.empty((h,), dtype=torch.bool, device=dev),
        kind=torch.empty((h,), dtype=torch.int32, device=dev),
        src=torch.empty((h,), dtype=torch.int64, device=dev),
        requeue=Push(
            torch.empty((h,), dtype=torch.bool, device=dev),
            torch.empty((h,), dtype=torch.int64, device=dev),
            ev.order,
            torch.empty((h,), dtype=torch.int32, device=dev),
            ev.payload,
        ) if cfg.shaping else None,
        t=ev.t,
    )
    rq = ing.requeue
    block = [
        h, p, es, int(cfg.shaping), int(cfg.use_codel), int(cfg.tb_interval_ns),
        addr(ev.t), addr(ev.order), addr(ev.kind), addr(ev.payload), addr(active),
        addr(s.events), addr(s.digest), addr(s.pkts_codel_dropped), addr(s.pkts_delivered),
        addr(tb.tokens), addr(tb.last_itv), addr(params.in_tb.capacity), addr(params.in_tb.refill),
        addr(cd.first_above), addr(cd.drop_next), addr(cd.count), addr(cd.dropping),
        addr(ing.dispatch), addr(ing.is_pkt), addr(ing.kind), addr(ing.src),
        addr(rq and rq.mask), addr(rq and rq.t), addr(rq and rq.kind),
        int(cfg.cpu_delay_ns), addr(busy),
        fault_mode, nw, addr(crash[0]), addr(crash[1]),
        addr(s.faults_delayed if fault_mode == 1 else None),
        addr(s.faults_dropped if fault_mode == 2 else None), addr(d2),
        timer_mask if cfg.netobs else 0, *(addr(x) for x in ec),
    ]
    return block, ing


def event_ingress(c, params, cfg, ev, active, timer_mask: int = 0):
    """`event_ingress_plain` as one kernel (K10) on CUDA, updating the
    carry's events, digest, CoDel, downlink bucket, codel-dropped and
    delivered lanes in place; under the CPU model also the busy horizon,
    under the CPU model or queue-hold faults the event's time lane (its
    execution time), and the fault counters, the second digest and the
    event-class counters where their planes are on."""
    if on_cpu(ev.t):
        return event_ingress_plain(c, params, cfg, ev, active, timer_mask)
    es = _event_stride(ev, active.shape[0], ev.payload.shape[1])
    block, ing = _ingress_block(c, params, cfg, ev, active, timer_mask, es)
    _ingress_k(arg_block(block))
    return c, ing


# --------------------------------------------------------------------------
# K36 pop_ingress
# --------------------------------------------------------------------------

_pop_ingress_k = CudaKernel("event", "pop_ingress", ARG_BLOCK)


def pop_ingress_plain(c, params, cfg, q, limit, timer_mask: int = 0):
    """`pop_min_plain` followed by `event_ingress_plain`: the one-event
    microstep's pop and ingress. The event comes back with its time
    rewritten to the execution time, as the ingress gives it. Returns
    (queue', carry', event, active, Ingress)."""
    q, ev, active = pop_min_plain(q, limit)
    c, ing = event_ingress_plain(c, params, cfg, ev, active, timer_mask)
    return q, c, ev._replace(t=ing.t), active, ing


def pop_ingress(c, params, cfg, q, limit, timer_mask: int = 0):
    """Pop each host's earliest event below `limit` (an int, or an i64[H]
    of per-host limits: the CPU model's or queue hold's held hosts, the
    ensemble plane's per-row window ends) from the flat queue `q` and run
    the ingress on it: `pop_ingress_plain` on the CPU, one kernel (K36) on
    CUDA. On CUDA the popped slots' (t, order) are cleared and the carry's
    lanes updated in place, as K2 and K10 do. Returns (queue', carry',
    event, active, Ingress)."""
    if on_cpu(q.t):
        return pop_ingress_plain(c, params, cfg, q, limit, timer_mask)
    h, cap, p = _check_slab(q)
    dev = q.t.device
    limits = None
    if isinstance(limit, torch.Tensor):
        check(limit, torch.int64, (h,), "pop limits")
        limits, limit = limit, 0
    ev = Event(
        t=torch.empty((h,), dtype=torch.int64, device=dev),
        order=torch.empty((h,), dtype=torch.int64, device=dev),
        kind=torch.empty((h,), dtype=torch.int32, device=dev),
        payload=torch.empty((h, p), dtype=torch.int32, device=dev),
    )
    active = torch.empty((h,), dtype=torch.bool, device=dev)
    block, ing = _ingress_block(c, params, cfg, ev, active, timer_mask, 1)
    _pop_ingress_k(arg_block(block + [
        addr(q.t), addr(q.order), addr(q.kind), addr(q.payload), cap, int(limit), addr(limits),
    ]))
    return q, c, ev, active, ing


# --------------------------------------------------------------------------
# K11 event_egress
# --------------------------------------------------------------------------

_egress_k = CudaKernel("event", "event_egress", ARG_BLOCK)


def route_plain(params, cfg, host_gid: torch.Tensor, dst: torch.Tensor):
    """(latency, loss, jitter) from each sender to `dst`, in the three
    forms of the reference: a constant for single-node graphs, a row
    lookup (affine or node_of destination node) when the per-host rows
    exist (rows held once for all replicas are read at row % their
    count), else a 2-D table gather."""
    h = dst.shape[0]
    if tuple(params.lat_ns.shape) == (1, 1):
        return (params.lat_ns[0, 0].expand(h), params.loss[0, 0].expand(h),
                params.jitter_ns[0, 0].expand(h))
    if cfg.hosts_per_node > 0:
        dst_node = torch.div(dst, cfg.hosts_per_node, rounding_mode="floor")
        src_node = torch.div(host_gid, cfg.hosts_per_node, rounding_mode="floor")
    else:
        dst_node = params.node_of[dst].to(torch.int64)
        src_node = params.node_of[host_gid].to(torch.int64)
    if params.lat_rows is not None:
        col = dst_node[:, None]
        tables = (params.lat_rows, params.loss_rows, params.jit_rows)
        if tables[0].shape[0] != h:
            row = torch.arange(h, device=dst.device) % tables[0].shape[0]
            tables = tuple(x[row] for x in tables)
        return tuple(x.gather(1, col)[:, 0] for x in tables)
    return (params.lat_ns[src_node, dst_node], params.loss[src_node, dst_node],
            params.jitter_ns[src_node, dst_node])


def event_egress_plain(c, params, cfg, ev_t, dispatch, window_end, out, fluid_fx=None):
    """The model's pushes and sends for one event per dispatched host.
    `c.rng` is the handler's RNG state; `fluid_fx` is the round's (bg_loss
    f32[H], bg_lat i64[H]) when the fluid plane is on; `window_end` is an
    int, or the replicas' i64[R] lane. Returns (carry',
    pushes, entries, used_min): `entries` is None when the model has no
    send port; `used_min[h]` is the least pre-jitter latency among the
    host's sends that landed (TIME_MAX where none), None without send
    ports."""
    from shadow_tpu_torch.core.faults import LAT_SCALE, window_effects_plain
    from shadow_tpu_torch.net.fluid import fluid_send_uniform

    h = dispatch.shape[0]
    # global host ids: the shard's rows start at cfg.host_base; a replica's
    # rows count from its first row
    hr = cfg.hosts_per_shard
    host_gid = cfg.host_base + torch.arange(h, dtype=torch.int64, device=dispatch.device) % hr
    if isinstance(window_end, torch.Tensor):
        window_end = window_end.repeat_interleave(hr)
    stats, rng, seq, sent_round, tb_eg = c.stats, c.rng, c.seq, c.sent_round, c.tb_egress
    pushes = []
    for p in out.pushes:
        mask = p.mask & dispatch
        stats = stats._replace(
            monotonic_violations=stats.monotonic_violations + (mask & (p.t < ev_t))
        )
        pushes.append(Push(
            mask, torch.maximum(p.t, ev_t), pack_order(1, host_gid, seq),
            p.kind.to(torch.int32) & KIND_MASK, p.payload.to(torch.int32),
        ))
        seq = seq + mask

    if fluid_fx is not None:
        bg_loss, bg_lat = fluid_fx
        # inflation honours bootstrap_end_time like the loss draws
        bg_inflate = (bg_lat > LAT_SCALE) & (ev_t >= cfg.bootstrap_end_time)
    if cfg.fault_loss_windows:
        # the link-fault windows active at the event's time, shared by
        # every port and segment below
        f_loss, f_lat = window_effects_plain(params.faults, ev_t)
        f_inflate = (f_lat > LAT_SCALE) & (ev_t >= cfg.bootstrap_end_time)

    # sends: each port may carry a burst of up to count_max segments to one
    # destination, sharing the route lookup; each segment has its own
    # budget slot, bandwidth charge, loss draw and order key
    rows, used = [], []
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
        lat, lossp, jit = route_plain(params, cfg, host_gid, dst)
        lat_bound0 = lat - jit if cfg.use_jitter else lat
        port_kind = s.kind.to(torch.int32) | KIND_PKT
        for j in range(s.count_max):
            mask = mask0 & (counts > j)
            over_budget = sent_round >= cfg.sends_per_host_round
            if cfg.shaping:
                tb_eg, eg_depart = tb_conforming_remove(
                    tb_eg, params.eg_tb, cfg.tb_interval_ns, ev_t,
                    sz.to(torch.int64) * 8, mask & ~over_budget,
                )
            else:
                eg_depart = ev_t
            lat_j = lat
            if cfg.use_jitter:
                rng, uj = rng_uniform(rng, mask)
                lat_j = lat + ((uj * 2.0 - 1.0) * jit.to(torch.float32)).to(torch.int64)
            unreachable = mask & ((lat_bound0 < 0) | bad_dst)
            rng, u = rng_uniform(rng, mask)
            lost = mask & (u < lossp) & (ev_t >= cfg.bootstrap_end_time)
            send_ok = mask & ~lost & ~unreachable & ~over_budget
            budget_dropped = mask & ~lost & ~unreachable & over_budget
            flost = None
            if cfg.fault_loss_windows:
                # fault loss draws after the path-loss draw (a fixed place
                # in the host's stream); then the fault inflation. A
                # fault-inflated send counts as delayed before the fluid
                # draw
                rng, uf = rng_uniform(rng, mask)
                flost = (mask & ~lost & ~unreachable & (uf < f_loss)
                         & (ev_t >= cfg.bootstrap_end_time))
                lat_j = torch.where(
                    f_inflate, torch.div(lat_j * f_lat, LAT_SCALE, rounding_mode="floor"),
                    lat_j)
                send_ok = send_ok & ~flost
                budget_dropped = budget_dropped & ~flost
                stats = stats._replace(
                    faults_dropped=stats.faults_dropped + flost,
                    faults_delayed=stats.faults_delayed + (send_ok & f_inflate),
                )
            if fluid_fx is not None:
                if cfg.fluid_loss_max > 0.0:
                    # fluid loss after the path and fault draws (precedence:
                    # path loss > unreachable > fault loss > fluid loss >
                    # budget), keyed on the pre-increment seq; it never
                    # advances the RNG lanes
                    ub = fluid_send_uniform(cfg.fluid_seed, host_gid, seq)
                    bglost = (mask & ~lost & ~unreachable & (ub < bg_loss)
                              & (ev_t >= cfg.bootstrap_end_time))
                    if flost is not None:
                        bglost = bglost & ~flost
                    send_ok = send_ok & ~bglost
                    budget_dropped = budget_dropped & ~bglost
                    lost = lost | bglost
                lat_j = torch.where(
                    bg_inflate, torch.div(lat_j * bg_lat, LAT_SCALE, rounding_mode="floor"),
                    lat_j)
            ob_col = sent_round
            sent_round = sent_round + send_ok.to(torch.int32)
            arrive = eg_depart + torch.clamp_min(lat_j, 0)
            arrive = (torch.maximum(arrive, window_end) if isinstance(window_end, torch.Tensor)
                      else torch.clamp_min(arrive, window_end))
            order = pack_order(0, host_gid, seq)
            seq = seq + mask
            payload = s.payload.to(torch.int32)
            if j > 0 and s.payload_inc is not None:
                payload = payload + j * s.payload_inc.to(torch.int32)
            payload = payload.clone()
            payload[:, PAYLOAD_SIZE_WORD] = sz
            rows.append((send_ok, ob_col, dst.to(torch.int32), arrive, order, port_kind, payload))
            used.append(torch.where(send_ok, lat_bound0, TIME_MAX))
            stats = stats._replace(
                pkts_sent=stats.pkts_sent + mask,
                pkts_lost=stats.pkts_lost + lost,
                pkts_unreachable=stats.pkts_unreachable + unreachable,
                pkts_budget_dropped=stats.pkts_budget_dropped + budget_dropped,
            )
    entries = EntryStack(*(torch.stack(f) for f in zip(*rows))) if rows else None
    used_min = torch.stack(used).min(dim=0).values if used else None
    carry = c._replace(stats=stats, rng=rng, seq=seq, sent_round=sent_round, tb_egress=tb_eg)
    return carry, pushes, entries, used_min


def outbox_append_multi_plain(ob, stacks, ob_dropped: torch.Tensor):
    """The reference's chained one-hot writes, one entry row at a time, over
    a microstep's entry stacks (one per event, in event order); a row with
    col >= B is counted lost, into its replica's lane (`ob.count` and
    `ob_dropped` hold one per replica). Returns (outbox', ob_dropped')."""
    if not stacks:
        return ob, ob_dropped
    b = ob.t.shape[1]
    cols = torch.arange(b, dtype=torch.int32, device=ob.t.device)[None, :]
    dst_n, t_n, order_n, kind_n, payload_n = ob.dst, ob.t, ob.order, ob.kind, ob.payload
    total = lost = 0
    for entries in stacks:
        for mask, col, dst, t, order, kind, payload in zip(*entries):
            oh = mask[:, None] & (cols == col[:, None])
            dst_n = torch.where(oh, dst.to(torch.int32)[:, None], dst_n)
            t_n = torch.where(oh, t[:, None], t_n)
            order_n = torch.where(oh, order[:, None], order_n)
            kind_n = torch.where(oh, kind.to(torch.int32)[:, None], kind_n)
            payload_n = torch.where(oh[:, :, None], payload.to(torch.int32)[:, None, :],
                                    payload_n)
        # integer sums: per stack, not per row (the same totals)
        total = total + entries.mask.sum(0)
        lost = lost + (entries.mask & (entries.col >= b)).sum(0)
    reps = ob.count.shape[0]
    return (
        type(ob)(dst_n, t_n, order_n, kind_n, payload_n,
                 ob.count + total.view(reps, -1).sum(1, dtype=torch.int32)),
        ob_dropped + lost.view(reps, -1).sum(1),
    )


def event_egress_append_plain(c, params, cfg, ev_t, dispatch, window_end, out, fluid_fx=None):
    """K11's plain version: `event_egress_plain`, then its entry stack
    appended to `c.outbox` (`outbox_append_multi_plain`, losses into
    `c.stats.ob_dropped`) and its used latencies folded into
    `c.min_used_lat`, per replica. Returns (carry', pushes)."""
    c, pushes, entries, used_min = event_egress_plain(
        c, params, cfg, ev_t, dispatch, window_end, out, fluid_fx)
    if entries is None:
        return c, pushes
    if c.outbox is None:
        raise ValueError("event_egress: a model with send ports needs the carry's outbox")
    ob, ob_dropped = outbox_append_multi_plain(c.outbox, [entries], c.stats.ob_dropped)
    reps = ob.count.shape[0]
    used = used_min.min() if reps == 1 else used_min.view(reps, -1).amin(1)
    return c._replace(outbox=ob, min_used_lat=torch.minimum(c.min_used_lat, used),
                      stats=c.stats._replace(ob_dropped=ob_dropped)), pushes


def _route_args(params, cfg) -> list[int]:
    """(mode, hosts_per_node, n_nodes, node_of, lat, loss, jit, rows of the
    mode-1 tables) for K11."""
    if tuple(params.lat_ns.shape) == (1, 1):
        mode, tables = 0, (params.lat_ns, params.loss, params.jitter_ns)
    elif params.lat_rows is not None:
        mode, tables = 1, (params.lat_rows, params.loss_rows, params.jit_rows)
    else:
        mode, tables = 2, (params.lat_ns, params.loss, params.jitter_ns)
    rows, n = tables[0].shape
    for x, dt, name in zip(tables, (torch.int64, torch.float32, torch.int64),
                           ("latency", "loss", "jitter")):
        check(x, dt, (rows, n), f"route {name}")
    check(params.node_of, torch.int32, (cfg.num_hosts,), "node_of")
    return [mode, cfg.hosts_per_node, n, addr(params.node_of), *(addr(x) for x in tables), rows]


def _lane(x: torch.Tensor, dt: torch.dtype, h: int, keep: list) -> tuple[int, int]:
    """(pointer, host stride) of a model port's [H] field, as the handler
    made it: a column of the K-way peek or a broadcast is passed with its
    stride, not copied. A field of another dtype is converted (a copy, kept
    alive in `keep`); the port's models emit the kernel's dtypes."""
    if x.dtype != dt:
        x = x.to(dt)
        keep.append(x)
    if not x.is_cuda or x.shape != (h,):
        raise ValueError(f"port field: expected a CUDA [{h}] tensor, got {x.device} "
                         f"{tuple(x.shape)}")
    return x.data_ptr(), x.stride(0)


def _rows(x: torch.Tensor, h: int, p: int, keep: list) -> tuple[int, int]:
    """(pointer, row stride) of a port's i32[H, P] payload field; its words
    must be contiguous, else it is copied."""
    if x.dtype != torch.int32 or (p > 1 and x.stride(1) != 1):
        x = x.to(torch.int32).contiguous()
        keep.append(x)
    if not x.is_cuda or x.shape != (h, p):
        raise ValueError(f"port payload: expected a CUDA [{h}, {p}] tensor, got {x.device} "
                         f"{tuple(x.shape)}")
    return x.data_ptr(), x.stride(0)


def event_egress(c, params, cfg, ev_t, dispatch, window_end, out, fluid_fx=None):
    """`event_egress_append_plain` as one kernel (K11) on CUDA, updating the
    carry's seq, send cursor, RNG, uplink bucket and packet-counter lanes in
    place (with link-fault windows also the fault counters), and appending
    the landed sends to `c.outbox` in place (its count, `ob_dropped` and
    `min_used_lat` too); the pushes' mask/t/order/kind are the kernel's
    outputs. Returns (carry', pushes)."""
    if on_cpu(ev_t):
        return event_egress_append_plain(c, params, cfg, ev_t, dispatch, window_end, out,
                                         fluid_fx)
    h = dispatch.shape[0]
    n_push, n_send = len(out.pushes), len(out.sends)
    if n_push > MAX_PUSH_PORTS or n_send > MAX_SEND_PORTS:
        raise ValueError(
            f"event_egress: {n_push} push / {n_send} send ports exceed the kernel's "
            f"{MAX_PUSH_PORTS} / {MAX_SEND_PORTS}"
        )
    if not (n_push or n_send):
        return c, []
    dev = ev_t.device
    es = ev_t.stride(0) if h > 1 else 1
    if not ev_t.is_cuda or ev_t.dtype != torch.int64 or tuple(ev_t.shape) != (h,):
        raise ValueError(f"event t: expected a CUDA int64 [{h}] tensor")
    check(dispatch, torch.bool, (h,), "dispatch")
    s = c.stats
    for x, dt, name in (
        (c.seq, torch.int64, "seq"), (c.sent_round, torch.int32, "sent_round"),
        (c.tb_egress.tokens, torch.int64, "tb tokens"),
        (c.tb_egress.last_itv, torch.int64, "tb last_itv"),
        (params.eg_tb.capacity, torch.int64, "tb capacity"),
        (params.eg_tb.refill, torch.int64, "tb refill"),
        (s.pkts_sent, torch.int64, "pkts_sent"), (s.pkts_lost, torch.int64, "pkts_lost"),
        (s.pkts_unreachable, torch.int64, "pkts_unreachable"),
        (s.pkts_budget_dropped, torch.int64, "pkts_budget_dropped"),
        (s.monotonic_violations, torch.int64, "monotonic_violations"),
    ):
        check(x, dt, (h,), name)
    check(c.rng.s, torch.int64, (h, 4), "rng")
    hr = cfg.hosts_per_shard
    reps = h // hr
    wend = None
    if isinstance(window_end, torch.Tensor):
        check(window_end, torch.int64, (reps,), "replica window ends")
        wend, window_end = window_end, 0
    elif reps != 1:
        raise ValueError(f"event_egress: {reps} replicas need an i64[{reps}] window end lane")
    nl = cfg.fault_loss_windows
    fp = params.faults if nl else None
    if nl:
        for x, dt, name in ((fp.win_start, torch.int64, "win_start"),
                            (fp.win_end, torch.int64, "win_end"),
                            (fp.win_loss, torch.float32, "win_loss"),
                            (fp.win_lat, torch.int64, "win_lat")):
            check(x, dt, (nl,) if reps == 1 else (reps, nl), f"fault {name}")
        check(s.faults_dropped, torch.int64, (h,), "faults_dropped")
        check(s.faults_delayed, torch.int64, (h,), "faults_delayed")
    bg_loss = bg_lat = None
    if fluid_fx is not None:
        bg_loss, bg_lat = fluid_fx
        check(bg_loss, torch.float32, (h,), "fluid bg_loss")
        check(bg_lat, torch.int64, (h,), "fluid bg_lat")
    ob = c.outbox
    ob_args = [0] * 9
    if n_send:
        if ob is None:
            raise ValueError("event_egress: a model with send ports needs the carry's outbox")
        b = ob.t.shape[1]
        check(ob.dst, torch.int32, (h, b), "outbox dst")
        check(ob.t, torch.int64, (h, b), "outbox t")
        check(ob.order, torch.int64, (h, b), "outbox order")
        check(ob.kind, torch.int32, (h, b), "outbox kind")
        check(ob.payload, torch.int32, (h, b, ob.payload.shape[2]), "outbox payload")
        check(ob.count, torch.int32, (reps,), "outbox count")
        check(s.ob_dropped, torch.int64, (reps,), "ob_dropped")
        check(c.min_used_lat, torch.int64, (reps,) if reps > 1 else (), "min_used_lat")
        ob_args = [b, *(addr(x) for x in ob), addr(s.ob_dropped), addr(c.min_used_lat)]
    keep = []  # converted port fields, alive until the launch returns
    push_args = []
    for p in out.pushes:
        push_args += [*_lane(p.mask, torch.bool, h, keep), *_lane(p.t, torch.int64, h, keep),
                      *_lane(p.kind, torch.int32, h, keep)]
    op = [torch.empty((n_push, h), dtype=dt, device=dev)
          for dt in (torch.bool, torch.int64, torch.int64, torch.int32)] if n_push else [None] * 4
    n_words = None
    send_args = []
    for sp in out.sends:
        n_words = sp.payload.shape[1]
        send_args += [
            int(sp.count_max), *_lane(sp.mask, torch.bool, h, keep),
            *_lane(sp.dst, torch.int64, h, keep), *_lane(sp.size_bytes, torch.int32, h, keep),
            *_lane(sp.kind, torch.int32, h, keep), *_rows(sp.payload, h, n_words, keep),
            *((0, 0) if sp.count is None else _lane(sp.count, torch.int32, h, keep)),
            *((0, 0) if sp.payload_inc is None else _rows(sp.payload_inc, h, n_words, keep)),
        ]
    if n_send and ob.payload.shape[2] != n_words:
        raise ValueError(f"event_egress: {n_words} payload words for an outbox of "
                         f"{ob.payload.shape[2]}")
    route = _route_args(params, cfg)
    _egress_k(arg_block([
        h, n_words or 1, es, cfg.sends_per_host_round, int(cfg.shaping), int(cfg.use_jitter),
        *route[:3], int(window_end), cfg.bootstrap_end_time, cfg.tb_interval_ns,
        addr(ev_t), addr(dispatch), *route[3:7],
        addr(params.eg_tb.capacity), addr(params.eg_tb.refill),
        addr(c.seq), addr(c.sent_round), addr(c.rng.s), addr(c.tb_egress.tokens),
        addr(c.tb_egress.last_itv), addr(s.pkts_sent), addr(s.pkts_lost), addr(s.pkts_unreachable),
        addr(s.pkts_budget_dropped), addr(s.monotonic_violations),
        addr(bg_loss), addr(bg_lat), u64(cfg.fluid_seed) if bg_lat is not None else 0,
        int(bg_lat is not None and cfg.fluid_loss_max > 0.0),
        n_push, *push_args, *(addr(x) for x in op),
        n_send, *send_args, *ob_args,
        nl, *(addr(getattr(fp, f, None)) for f in ("win_start", "win_end", "win_loss", "win_lat")),
        addr(s.faults_dropped if nl else None), addr(s.faults_delayed if nl else None),
        cfg.host_base, cfg.num_hosts, hr, addr(wend), route[7],
    ]))
    del keep
    pushes = [Push(op[0][i], op[1][i], op[2][i], op[3][i], p.payload.to(torch.int32))
              for i, p in enumerate(out.pushes)]
    return c, pushes


KERNELS = {
    "event_ingress": _ingress_k,
    "event_egress": _egress_k,
    "pop_ingress": _pop_ingress_k,
}
