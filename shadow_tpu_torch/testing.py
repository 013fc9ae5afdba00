"""Seeded inputs and helpers for checking kernels against their plain
versions: `chain_case` builds one event per host through ingress, a
synthetic handler output and egress (K10, K11); `merge_case` builds a queue
and a round's [H, B] outbox for the exchange merges (K4, K13);
`fluid_case` builds the fluid plane's inputs (K14-K16, fluid-on K11);
`handler_case` builds a model handler's context (K17-K22), `clone_ctx`
copies its state and RNG lanes and `handler_tensors` lists a handler's
outputs; `clone_carry` deep-copies a carry (the kernels update carries in
place); `flat_tensors` lists a nested tuple's tensors for comparison;
`cfg7_config` and `cfg10_config` build bench configs 7 (PHOLD under host
churn, a lossy window and the supervisor) and 10 (tgen-TCP on a torus with
the integrity sentinel) at any size, `fault_case` the fault plane's and
`integrity_case` the sentinel's kernel inputs (K23, K24 and the lanes of
K1, K10, K11), and `scribble_hook` a state change for the sentinel's replay
seam; `outbox_case` a shard's outbox for the exchange's pack (K29), and
`mesh_runs` one rank's part of a series of runs across ranks
(core/mesh.py); `hybrid_case`, `mixed_case` and `guarded_case` the
co-simulation bridge's kernel inputs (K33, K34, K35). Used by chip_smoke.py and the tests; nothing on the
simulation path imports it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.models.base import KIND_INGRESS_DONE, KIND_PKT
from shadow_tpu_torch.simtime import TIME_MAX


def chain_case(seed: int, h: int, dev, *, n_push: int, sends: tuple, route: str,
               shaping: bool = True, jitter: bool = False, n_nodes: int = 4,
               budget: int = 8, stride: int = 1, cpu_delay: int = 0,
               restart_queue: str | None = None, loss_windows: int = 0,
               dual_digest: bool = False, netobs: bool = False,
               ob_cols: int | None = None) -> dict:
    """Random inputs of one event per host through ingress (K10), the
    handler's outputs (a synthetic HandlerOut) and egress (K11): a carry
    with every lane seeded, an event with packets, requeued packets and
    local events, CoDel states about to drop, token buckets short of
    tokens, sends with out-of-range destinations and hosts at or past the
    send budget. `sends` lists (count_max, has_count, has_inc) per send
    port; `route` is "const" (one graph node), "affine" (per-host rows,
    node = host // g), "node_of" (per-host rows, irregular map) or "table"
    (2-D gather); `stride` > 1 makes the event a column of a K-way peek;
    `cpu_delay` > 0 turns the CPU model on, with busy horizons before, at
    and after the events' times; `restart_queue` ("hold" or "clear") adds
    crash windows (two per host, from `fault_case`, so that the events'
    times fall at their edges, inside and outside), `loss_windows` > 0
    link-fault windows around the events' times, `dual_digest` the
    integrity sentinel's second digest, and `netobs` the network
    observatory's event-class lanes (model kinds 1 and 3 are the timers:
    `timer_mask` in the returned dict). The carry's outbox, which egress
    appends to, is `ob_cols` columns wide (the send budget by default; a
    narrower one loses the sends past it) and holds random rows and a
    random count; its `min_used_lat` is above every route latency. The
    extra lanes come from their own generators: the other inputs do not
    change."""
    from shadow_tpu_torch.core.engine import (
        EngineConfig,
        EngineParams,
        Outbox,
        Stats,
        _EvCarry,
    )
    from shadow_tpu_torch.models.base import HandlerOut, LocalPush, PacketSend
    from shadow_tpu_torch.net import CodelState, TBParams, TBState
    from shadow_tpu_torch.ops.events import Event
    from shadow_tpu_torch.ops.rng import RngState

    r = np.random.default_rng(seed)
    rb = np.random.default_rng([seed, 20])  # the busy horizons' own draws

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ms = 1_000_000
    n = 1 if route == "const" else n_nodes
    g = -(-h // n) if route == "affine" else 0
    node_of = (np.arange(h) // max(g, 1) if route == "affine"
               else r.integers(0, n, h)).astype(np.int32)
    if route == "const":
        node_of[:] = 0
    lat = r.integers(5, 60, (n, n)) * ms
    lat[r.random((n, n)) < 0.1] = -1  # unreachable pairs
    loss = np.where(r.random((n, n)) < 0.7, r.random((n, n)) * 0.3, 0.0).astype(np.float32)
    jit = (r.integers(0, 6, (n, n)) * ms) if jitter else np.zeros((n, n), np.int64)
    rows = route in ("affine", "node_of")
    params = EngineParams(
        node_of=T(node_of), lat_ns=T(lat), loss=T(loss), jitter_ns=T(jit),
        eg_tb=TBParams(T(r.integers(12_000, 40_000, h)), T(r.choice([0, 100, 300, 1_000], h))),
        in_tb=TBParams(T(r.integers(12_000, 40_000, h)), T(r.choice([0, 100, 300, 1_000], h))),
        model=None,
        lat_rows=T(lat[node_of]) if rows else None,
        loss_rows=T(loss[node_of]) if rows else None,
        jit_rows=T(jit[node_of]) if rows else None,
    )
    cfg = EngineConfig(num_hosts=h, stop_time=60 * 10**9, shaping=shaping, use_jitter=jitter,
                       sends_per_host_round=budget, hosts_per_node=g,
                       bootstrap_end_time=int(r.integers(0, 2)) * 900 * ms,
                       cpu_delay_ns=cpu_delay,
                       fault_crash_windows=2 if restart_queue else 0,
                       fault_loss_windows=loss_windows,
                       fault_queue_clear=restart_queue == "clear",
                       integrity=dual_digest, integrity_dual=dual_digest, netobs=netobs)
    t = r.integers(1_000, 1_200, h) * ms
    itv = t // ms
    active = r.random(h) < 0.85
    t = np.where(active, t, TIME_MAX)

    def lanes(lo, hi):
        return T(r.integers(lo, hi, h))

    stats = Stats(*(T(r.integers(0, 1 << 40, h)) for _ in range(8)),
                  ob_dropped=T(np.zeros(1, np.int64)), microsteps=T(np.zeros(1, np.int64)),
                  bq_rebuilds=T(np.zeros(1, np.int64)), popk_deferred=T(np.zeros(1, np.int64)),
                  q_occ_hwm=lanes(0, 10), outbox_hwm=T(np.zeros(1, np.int64)),
                  digest=T(r.integers(-(1 << 63), (1 << 63) - 1, h)),
                  rounds=T(np.zeros((), np.int64)))
    fa = np.where(r.random(h) < 0.3, 0, t - r.integers(-50, 200, h) * ms)
    carry = _EvCarry(
        stats=stats,
        rng=RngState(T(r.integers(-(1 << 63), (1 << 63) - 1, (h, 4)))),
        seq=lanes(0, 1 << 39),
        sent_round=T(r.integers(0, budget + 2, h).astype(np.int32)),
        tb_egress=TBState(lanes(0, 20_000), T(itv - r.integers(0, 3, h))),
        tb_ingress=TBState(lanes(0, 20_000), T(itv - r.integers(0, 3, h))),
        codel=CodelState(
            first_above=T(np.where(active, fa, 0)),
            drop_next=T(np.where(active, t - r.integers(-300, 300, h) * ms, 0)),
            count=T(r.integers(0, 12, h).astype(np.int32)),
            dropping=T(r.random(h) < 0.5),
        ),
        model=None,
        cpu_busy_until=T(np.select([rb.random(h) < 0.3, rb.random(h) < 0.5], [0, t],
                                   np.minimum(t, 1 << 50) + rb.integers(-40, 40, h) * ms))
        if cpu_delay else None,
    )
    ro = np.random.default_rng([seed, 50])  # the outbox's own draws
    b = budget if ob_cols is None else ob_cols
    carry = carry._replace(
        outbox=Outbox(
            T(ro.integers(0, h, (h, b)).astype(np.int32)), T(ro.integers(0, 1 << 40, (h, b))),
            T(ro.integers(0, 1 << 62, (h, b))), T(ro.integers(0, 9, (h, b)).astype(np.int32)),
            T(ro.integers(-(1 << 31), 1 << 31, (h, b, 4)).astype(np.int32)),
            T(ro.integers(0, 100, 1).astype(np.int32))),
        min_used_lat=torch.tensor(int(lat.max()) + ms, device=dev),  # every landed send lowers it
    )
    kind = r.integers(0, 4, h) | np.where(r.random(h) < 0.7, KIND_PKT, 0)
    kind |= np.where(r.random(h) < 0.2, KIND_INGRESS_DONE, 0)
    payload = r.integers(-(1 << 31), 1 << 31, (h, 4))
    payload[:, 0] = r.integers(40, 1_500, h)
    order = ((r.integers(0, 2, h) << 62) | (r.integers(0, h, h) << 40)
             | r.integers(0, 1 << 39, h))
    cols = [(t, np.int64), (order, np.int64), (kind, np.int32)]
    # a K-way peek column: the lanes live in column `stride - 1` of [H, K]
    wide = [np.zeros((h, stride), dt) for _, dt in cols]
    wpay = np.zeros((h, stride, 4), np.int32)
    for (a, dt), w in zip(cols, wide):
        w[:, -1] = a.astype(dt)
    wpay[:, -1] = payload.astype(np.int32)
    wide = [T(w) for w in wide]
    wpay = T(wpay)
    ev = Event(wide[0][:, -1], wide[1][:, -1], wide[2][:, -1], wpay[:, -1])

    pushes = tuple(LocalPush(
        mask=T(r.random(h) < 0.6),
        t=T(t + r.integers(-20, 100, h) * ms),
        kind=T(r.integers(0, 1 << 18, h).astype(np.int32)),
        payload=T(r.integers(-(1 << 31), 1 << 31, (h, 4)).astype(np.int32)),
    ) for _ in range(n_push))
    sends_out = tuple(PacketSend(
        mask=T(r.random(h) < 0.8),
        dst=T(r.integers(-2, h + 2, h)),
        size_bytes=T(r.integers(40, 1_500, h).astype(np.int32)),
        kind=T(r.integers(0, 4, h).astype(np.int32)),
        payload=T(r.integers(-(1 << 31), 1 << 31, (h, 4)).astype(np.int32)),
        count=T(r.integers(0, cmax + 2, h).astype(np.int32)) if has_count else None,
        payload_inc=T(r.integers(0, 3000, (h, 4)).astype(np.int32)) if has_inc else None,
        count_max=cmax,
    ) for cmax, has_count, has_inc in sends)
    out = HandlerOut(state=None, rng=carry.rng, pushes=pushes, sends=sends_out)
    if cfg.faults_active or dual_digest:
        params, carry = _fault_lanes(seed, h, dev, cfg, params, carry, t)
    if netobs:
        re = np.random.default_rng([seed, 23])  # the class lanes' own draws
        carry = carry._replace(stats=carry.stats._replace(**{
            k: T(re.integers(0, 1 << 40, 1)) for k in ("ec_timer", "ec_pkt", "ec_app")}))
    return dict(cfg=cfg, params=params, carry=carry, ev=ev, active=T(active),
                dispatch=T(active & (r.random(h) < 0.9)), out=out,
                window_end=int(t[active].min()) + 2 * ms if active.any() else 0,
                timer_mask=0b1010)


POP_LIMITS = ("scalar", "host", "row")


def pop_ingress_case(seed: int, h: int, cap: int, dev, *, limits: str = "scalar",
                     reps: int = 4, **chain_kw) -> dict:
    """Random inputs of the one-event microstep's pop and ingress (K36):
    `chain_case`'s config, params and carry (with `limits` "row", the
    carry and config of `replica_chain_case` over `reps` replicas of h /
    reps hosts, the third frozen) and a flat [h, cap] queue whose live
    slots sit around each host's event time, with many exact time ties
    (the order key decides), empty and full rows and hosts whose events
    all lie past the limit. `limits`: "scalar" one limit for every host;
    "host" an i64[h] with held hosts at 0, others at one of three window
    ends or TIME_MAX; "row" an i64[h] that is one window end per replica
    (0 on the frozen one). Returns a dict with cfg, params, carry, queue,
    limit, timer_mask."""
    from shadow_tpu_torch.ops.events import ORDER_MAX, EventQueue

    if limits == "row":
        h = reps * (h // reps)
        case = replica_chain_case(seed, reps, h // reps, dev, frozen=(2,), **chain_kw)
    else:
        case = chain_case(seed, h, dev, **chain_kw)
    r = np.random.default_rng([seed, 60])  # the queue's own draws
    ms = 1_000_000
    # each host's least time is its chain_case event's (the carry's CoDel,
    # bucket and crash-window states sit around it)
    t_ev = case["ev"].t.cpu().numpy()
    t_host = np.where(t_ev != TIME_MAX, t_ev, r.integers(1_000, 1_200, h) * ms)
    fill = r.integers(0, cap + 1, h)
    fill[r.random(h) < 0.15] = cap
    fill[r.random(h) < 0.1] = 0
    live = r.random((h, cap)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    rows = np.nonzero(live)[0]
    # a third of the live slots at exactly the host's least time: ties
    qt = np.full((h, cap), TIME_MAX, np.int64)
    qt[live] = t_host[rows] + np.where(r.random(n) < 0.35, 0, r.integers(0, 60, n) * ms)
    qo = np.full((h, cap), ORDER_MAX, np.int64)
    qo[live] = ((r.integers(0, 2, n) << 62) | (r.integers(0, h, n) << 40)
                | r.permutation(n).astype(np.int64))
    kind = (r.integers(0, 4, (h, cap)) | np.where(r.random((h, cap)) < 0.7, KIND_PKT, 0)
            | np.where(r.random((h, cap)) < 0.2, KIND_INGRESS_DONE, 0)).astype(np.int32)
    payload = r.integers(-(1 << 31), 1 << 31, (h, cap, 4)).astype(np.int32)
    payload[:, :, 0] = r.integers(40, 1_500, (h, cap))
    queue = EventQueue(*(torch.as_tensor(a, device=dev) for a in (
        qt, qo, kind, payload, r.integers(0, 5, h).astype(np.int64))))
    if limits == "scalar":
        limit = 1_100 * ms
    elif limits == "host":
        lim = r.choice([0, 1_050 * ms, 1_100 * ms, 1_150 * ms, TIME_MAX], h)
        limit = torch.as_tensor(lim.astype(np.int64), device=dev)
    else:
        lim = np.repeat([1_050 * ms, 1_150 * ms, 0, TIME_MAX, 1_100 * ms][:reps], h // reps)
        limit = torch.as_tensor(lim.astype(np.int64), device=dev)
    return dict(cfg=case["cfg"], params=case["params"], carry=case["carry"], queue=queue,
                limit=limit, timer_mask=case["timer_mask"])


def _fault_lanes(seed: int, h: int, dev, cfg, params, carry, t: np.ndarray):
    """chain_case's fault windows, fault counters and second digest, from
    their own generator: crash windows whose edges sit at the events' times
    (and 1 ms either side), link-fault windows covering some of them."""
    from shadow_tpu_torch.core.faults import FaultParams

    rf = np.random.default_rng([seed, 30])
    ms = 1_000_000

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    down = up = ws = we = wl = wlat = None
    if cfg.fault_crash_windows:
        live = np.where(t == TIME_MAX, 1_000 * ms, t)
        shift = rf.integers(-1, 2, h) * ms  # the window starts at, before or after t
        d0 = np.where(rf.random(h) < 0.7, live + shift, live + 500 * ms)
        u0 = d0 + rf.integers(1, 300, h) * ms
        d1, u1 = u0 + rf.integers(1, 100, h) * ms, u0 + rf.integers(100, 200, h) * ms
        down = np.stack([d0, d1], axis=1)
        up = np.stack([u0, u1], axis=1)
        unused = rf.random(h) < 0.2
        down[unused, 1] = up[unused, 1] = TIME_MAX
        down, up = T(down), T(up)
    if cfg.fault_loss_windows:
        n = cfg.fault_loss_windows
        ws = T(np.sort(rf.integers(900, 1_150, n)) * ms)
        we = T(ws.cpu().numpy() + rf.integers(10, 150, n) * ms)
        wl = T(rf.random(n).astype(np.float32))
        wlat = T(rf.integers(1000, 2600, n))
    if cfg.faults_active:
        params = params._replace(faults=FaultParams(down, up, ws, we, wl, wlat))
    s = carry.stats
    s = s._replace(
        faults_dropped=T(rf.integers(0, 1 << 40, h)) if cfg.faults_active else None,
        faults_delayed=T(rf.integers(0, 1 << 40, h)) if cfg.faults_active else None,
        digest2=(T(rf.integers(-(1 << 63), (1 << 63) - 1, h)) if cfg.integrity_dual
                 else None),
    )
    return params, carry._replace(stats=s)


def clone_carry(c):
    """A deep copy of a carry (the kernels update carries in place)."""
    def cl(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(*(cl(v) for v in x))
    return cl(c)


def flat_tensors(x) -> list:
    """Every tensor of a nested tuple/NamedTuple/list, in order (None left
    out)."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in flat_tensors(v)]


MERGE_LOADS = ("fit", "hot", "full", "empty")


def merge_case(seed: int, h: int, cap: int, b: int, gc: int, load: str, p: int = 4):
    """numpy (queue planes (t, order, kind, payload, dropped), outbox planes
    (dst, t, order, kind, payload)) for one exchange merge: host h staged
    sent[h] <= gc sends in outbox columns 0..sent[h]-1 (so a gear of gc
    columns sheds nothing), about 5% of them to out-of-range destinations.
    Loads: `fit` — sparse queues and sends, every destination's rows fit
    (the scatter merge's fast path), with hosts 0 and 1 both sending to host
    7, the lower row the more urgent (so the fast path and the sort place
    them in different slots); `hot` — half the hosts send every row to host
    3, past the insert cap; `full` — queues with 0-1 free slots; `empty` —
    no sends at all."""
    r = np.random.default_rng(seed)
    fill = (cap - r.integers(0, 2, h)) if load == "full" else r.integers(0, cap // 2, h)
    qt = np.full((h, cap), TIME_MAX, np.int64)
    qo = np.full((h, cap), np.iinfo(np.int64).max, np.int64)
    live = r.random((h, cap)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    qt[live] = r.integers(0, 50, n) * 1_000_000
    qo[live] = (np.nonzero(live)[0].astype(np.int64) << 40) | np.arange(n)
    queue = (qt, qo, r.integers(0, 1 << 18, (h, cap)).astype(np.int32),
             r.integers(-(1 << 31), 1 << 31, (h, cap, p)).astype(np.int32),
             r.integers(0, 5, h).astype(np.int64))

    sent = np.zeros(h, np.int64) if load == "empty" else r.integers(0, gc + 1, h)
    if load == "fit":
        sent = sent * (r.random(h) < 0.3)
        sent[:2] = np.maximum(sent[:2], 1)
    col = np.arange(b)[None, :]
    dst = r.integers(0, h, (h, b)).astype(np.int32)
    if load == "hot":
        dst[: h // 2, :] = 3
    dst[r.random((h, b)) < 0.05] = h + 2  # out of range: never inserted
    t = r.integers(50, 90, (h, b)) * 1_000_000
    if load == "fit":
        dst[:2, 0] = 7
        t[:2, 0] = (40_000_000, 45_000_000)
    t = np.where(col < sent[:, None], t, TIME_MAX).astype(np.int64)
    order = (np.arange(h)[:, None].astype(np.int64) << 40) | (col + 64 * np.arange(h)[:, None])
    outbox = (dst, t, order.astype(np.int64), r.integers(0, 1 << 18, (h, b)).astype(np.int32),
              r.integers(-(1 << 31), 1 << 31, (h, b, p)).astype(np.int32))
    return queue, outbox


def merge_fits(queue, outbox, gc: int, r_cap: int) -> bool:
    """Whether every destination's valid rows among the first gc columns
    fit min(its free slots, r_cap): the scatter merge's fast path."""
    h = queue[0].shape[0]
    dst, t = outbox[0][:, :gc].reshape(-1), outbox[1][:, :gc].reshape(-1)
    ok = (t != TIME_MAX) & (dst >= 0) & (dst < h)
    cnt = np.bincount(dst[ok], minlength=h)
    return bool((cnt <= np.minimum((queue[0] == TIME_MAX).sum(axis=1), r_cap)).all())


def fluid_case(seed: int, h: int, n_links: int, k_classes: int, dev, *, b: int = 24,
               affine: bool = True, dt_zero: bool = False, done: bool = False,
               loss_max: float = 0.3) -> dict:
    """Random inputs of the fluid plane: a config with `k_classes` classes
    on `n_links` links (some classes on one link at both ends, some with
    zero demand or a window already past, links over capacity), a state of
    rates and utilizations, a round's [H, b] outbox with empty rows and
    out-of-range destinations, the host -> link map (affine, or an
    irregular `node_of`), the round's window (`dt_zero`: an empty one), and
    for fluid-on K11 a `chain_case` with per-host coupling factors
    (`fluid_fx`, some hosts at exactly 1.0x). Returns a dict of them."""
    from shadow_tpu_torch.core.engine import EngineConfig
    from shadow_tpu_torch.net.fluid import FluidParams, FluidState

    r = np.random.default_rng(seed)

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    k, n = k_classes, n_links
    g = -(-h // n) if affine else 0
    node_of = (np.minimum(np.arange(h) // max(g, 1), n - 1) if affine
               else r.integers(0, n, h)).astype(np.int32)
    cfg = EngineConfig(
        num_hosts=h, stop_time=60 * 10**9, sends_per_host_round=b, hosts_per_node=g,
        fluid_classes=k, fluid_links=n, fluid_tau_ns=int(r.integers(1, 200)) * 1_000_000,
        fluid_util_threshold=float(r.choice([0.0, 0.5, 0.7, r.random() * 0.95])),
        fluid_loss_max=loss_max, fluid_lat_max_x1000=int(r.integers(1000, 3000)),
        fluid_seed=int(r.integers(0, 1 << 62)),
    )
    now = int(r.integers(1, 20)) * 1_000_000_000
    window_end = now if dt_zero else now + int(r.integers(1, 80_000_000))
    src = r.integers(0, n, k)
    dst = np.where(r.random(k) < 0.25, src, r.integers(0, n, k))
    demand = r.random(k) * 10.0 ** r.integers(5, 9, k)
    demand[r.random(k) < 0.15] = 0.0
    ws = now - r.integers(-2, 5, k) * 1_000_000_000  # some windows not yet open
    we = np.where(r.random(k) < 0.2, ws + 1, TIME_MAX)  # some already past
    capacity = r.random(n) * 10.0 ** r.integers(6, 9, n)
    capacity[r.random(n) < 0.2] *= 1e-3  # links far over capacity
    fp = FluidParams(T(src.astype(np.int32)), T(dst.astype(np.int32)), T(demand),
                     T(ws.astype(np.int64)), T(we.astype(np.int64)), T(capacity))
    rates = r.random(k) * 10.0 ** r.integers(4, 9, k)
    rates[r.random(k) < 0.2] = 0.0
    st = FluidState(T(rates), T(r.random(n) * 3.0))
    valid = r.random((h, b)) < 0.5
    ob_t = np.where(valid, now + r.integers(0, 10**8, (h, b)), TIME_MAX).astype(np.int64)
    ob_dst = r.integers(-2, h + 2, (h, b)).astype(np.int32)
    ob_payload = r.integers(-(1 << 31), 1 << 31, (h, b, 4)).astype(np.int32)
    ob_payload[:, :, 0] = r.integers(40, 1_500, (h, b))
    fg = r.integers(0, 10**7, n)
    fg[r.random(n) < 0.3] = 0
    chain = chain_case(seed, h, dev, n_push=2, sends=((2, True, True), (1, False, False)),
                       route="affine" if affine else "node_of", n_nodes=n, budget=b)
    loss = np.where(r.random(h) < 0.3, 0.0, r.random(h) * loss_max).astype(np.float32)
    lat = np.where(r.random(h) < 0.3, 1000, r.integers(1000, 3000, h)).astype(np.int64)
    chain["cfg"] = dataclasses.replace(chain["cfg"], fluid_classes=k, fluid_links=n,
                                       fluid_loss_max=loss_max, fluid_seed=cfg.fluid_seed)
    chain["fluid_fx"] = (T(loss), T(lat))
    return dict(cfg=cfg, fp=fp, st=st, node_of=T(node_of), ob_dst=T(ob_dst), ob_t=T(ob_t),
                ob_payload=T(ob_payload), fg=T(fg.astype(np.int64)), now=now,
                window_end=window_end, done=done,
                bg_bytes=torch.tensor(int(r.integers(0, 1 << 40)), device=dev),
                bg_dropped=torch.tensor(int(r.integers(0, 1 << 40)), device=dev), chain=chain)


HANDLER_MODELS = ("tgen_tcp", "phold", "udp_echo", "timer", "gossip", "circuit")
# the hosts at the front of every gossip and circuit case, each forced into
# one branch: (kind, what it drives)
GOSSIP_FORCED = (
    ("pub", "publish: a fresh generation and the re-armed publish"),
    ("msg", "fresh message: adoption and the start-forward push"),
    ("msg", "stale message: nothing"),
    ("fwd", "current continuation: a send and the next continuation"),
    ("fwd", "superseded continuation: nothing"),
    ("fwd", "last continuation: a send, no further continuation"),
)
CIRCUIT_FORCED = (
    ("tick", "idle client: a cell launched, the tick re-armed"),
    ("tick", "busy client: only the tick re-armed"),
    ("cell", "cell at a relay: the processing-delay push"),
    ("cell", "cell back at its client: RTT and completion"),
    ("fwd", "forward out of the guard (hop 0, outbound)"),
    ("fwd", "forward out of the middle (hop 1, outbound)"),
    ("fwd", "turn at the exit (hop 2, outbound)"),
    ("fwd", "forward back through the middle (hop 1, inbound)"),
    ("fwd", "forward back through the guard (hop 0, inbound)"),
)


def _gossip_case(r, h: int, payload: np.ndarray):
    """Gossip params, state, kinds and payload words: neighbor rows of
    width 8 with fanouts 0-8, generations and forward cursors near the
    int32 limits (the wrapping adds), message generations below, at and
    above the host's; GOSSIP_FORCED at the front."""
    i32 = np.int32
    k = 8
    params = {"neighbors": r.integers(0, h, (h, k)), "size": r.integers(40, 1_500, h).astype(i32),
              "fanout": r.integers(0, k + 1, h).astype(i32),
              "interval": np.where(r.random(h) < 0.3, 0, r.integers(1, 5_000, h) * 1_000_000)}
    big = np.iinfo(i32).max
    gen = np.where(r.random(h) < 0.1, big, r.integers(0, 50, h))
    idx = np.select([r.random(h) < 0.1, r.random(h) < 0.1], [big, -r.integers(1, 5, h)],
                    r.integers(0, k + 2, h))
    st = {"gen": gen.astype(i32), "recv_time": r.integers(-1, 1 << 40, h),
          "hops": r.integers(-1, 30, h).astype(i32), "fwd_idx": idx.astype(i32),
          "adopted": r.integers(0, 1 << 40, h)}
    kind = r.integers(0, 4, h)
    payload[:, 2] = np.where(r.random(h) < 0.8, gen + r.integers(-1, 2, h), payload[:, 2])
    payload[:, 1] = np.where(r.random(h) < 0.1, big, payload[:, 1])
    # GOSSIP_FORCED as (kind, params, state lanes, payload word 2: the
    # message's or continuation's generation, None for the host's own)
    forced = [(2, {"interval": 7_000_000}, {"gen": 1}, None), (0, {}, {"gen": 3}, 4),
              (0, {}, {"gen": 9}, 9), (1, {"fanout": 8}, {"fwd_idx": 2}, None),
              (1, {}, {"gen": 5}, 4), (1, {"fanout": 4}, {"fwd_idx": 3}, None)]
    for i, (kd, prm, lanes, word2) in enumerate(forced[:h]):
        kind[i] = kd
        for key, v in prm.items():
            params[key][i] = v
        for key, v in lanes.items():
            st[key][i] = v
        payload[i, 2] = st["gen"][i] if word2 is None else word2
    return params, st, kind, payload


def _circuit_case(r, h: int, payload: np.ndarray, is_pkt: np.ndarray):
    """Circuit params, state, kinds, payload words and host ids: routes and
    host ids of 16-bit hosts (half of them 32,768 and above, so the u32
    shifts matter), launch times before and after the event (RTTs of
    either sign), and CIRCUIT_FORCED at the front."""
    ms = 1_000_000
    params = {"role": r.integers(0, 2, h).astype(np.int32),
              "route": r.integers(0, 1 << 16, (h, 3)).astype(np.int32),
              "interval": r.integers(1, 1_000, h) * ms, "proc": r.integers(0, 10, h) * ms,
              "size": r.integers(40, 1_500, h).astype(np.int32)}
    st = {"outstanding": r.random(h) < 0.5, "launch_t": r.integers(0, 1 << 50, h),
          **{k: r.integers(0, 1 << 40, h) for k in ("cells_done", "rtt_sum", "fwd")}}
    kind = r.integers(0, 4, h)
    host_id = r.integers(0, 1 << 16, h)
    forced = [(0, 1, False, 0), (0, 1, False, 1), (1, 0, True, 0), (1, 1, True, 1)]
    for i, (kd, role, pkt, out) in enumerate(forced[: min(h, 4)]):
        kind[i], params["role"][i], is_pkt[i], st["outstanding"][i] = kd, role, pkt, bool(out)
    for i, (hop, dn) in enumerate(((0, 0), (1, 0), (2, 0), (1, 1), (0, 1))):
        if 4 + i < h:
            kind[4 + i], is_pkt[4 + i] = 2, False
            payload[4 + i, 3] = (payload[4 + i, 3] & ~0x1FF) | hop | (dn << 8)
    return params, st, kind, payload, is_pkt, host_id


# tgen-TCP hosts with a fixed scenario at the front of every case, so that
# each case runs these branches whatever the seed: (event, what it drives)
TGEN_FORCED = (
    ("ack", "fast retransmit: third duplicate ACK outside recovery"),
    ("rto", "timeout of an established flow with data in flight"),
    ("finack", "flow complete"),
    ("data", "duplicate segment below rcv_nxt"),
    ("syn", "new connection, SYN-ACK out"),
    ("tick", "flow start, SYN out"),
    ("ack", "partial ACK in NewReno recovery"),
    ("ack", "last data acknowledged, FIN out"),
    ("data", "in-order segment held for the delayed ACK"),
    ("data", "out-of-order segment, ACK out"),
    ("fin", "FIN accepted, FIN-ACK out"),
    ("tx", "TX continuation, DATA burst out"),
    ("rto", "SYN timeout"),
    ("synack", "SYN-ACK in, established"),
    ("data", "in-order segment filling a full bitmap (a 33-segment advance)"),
    ("data", "out-of-order segment at the window's edge (rel 32)"),
    ("ack", "ACK of everything in flight, timer cleared"),
)
_TGEN_EVENTS = ("tick", "tx", "rto", "delack", "syn", "data", "fin", "synack", "ack", "finack")


def _tgen_case(r, h: int, t: np.ndarray):
    """tgen-TCP params, state and one coherent event per host: each host
    draws an event type, and its lanes are drawn around it (a client in the
    state the segment addresses, ACK words at, past and below snd_una,
    sequence words in and out of the reassembly window, deadlines armed
    and expired, bitmaps empty, full and with holes), with some segments
    from the wrong peer or phase; the hosts of TGEN_FORCED come first."""
    from shadow_tpu_torch.models.tgen import TgenTcpModel

    if h < len(TGEN_FORCED):
        raise ValueError(f"a tgen-TCP case needs at least {len(TGEN_FORCED)} hosts")
    ms = 1_000_000
    i32, i64 = np.int32, np.int64

    def pick(p, a, b):
        return np.where(r.random(h) < p, a, b)

    flows = r.integers(1, 5, h).astype(i32)
    seg_l = r.integers(4, 80, h).astype(i32)
    params = {
        "flow_segs": seg_l, "mss": r.choice([536, 1460, 9000], h).astype(i32), "flows": flows,
        "cwnd_init": r.integers(1, 11, h).astype(i32),
        "cwnd_cap": r.integers(1, 65, h).astype(i32),
        "rto_init": (r.integers(200, 3_000, h) * ms).astype(i64),
        "rto_min": (r.integers(1, 300, h) * ms).astype(i64),
        "rto_max": (r.integers(1_000, 120_000, h) * ms).astype(i64),
        "flow_gap": (r.integers(0, 100, h) * ms).astype(i64),
        "delack": pick(0.3, 0, r.integers(1, 80, h) * ms).astype(i64),
        "num_hosts": np.full(h, h, i32),
    }
    n = len(TGEN_FORCED)
    ev = np.array([_TGEN_EVENTS.index(e) for e, _ in TGEN_FORCED]
                  + list(r.integers(0, len(_TGEN_EVENTS), h - n)))
    is_ev = {e: ev == i for i, e in enumerate(_TGEN_EVENTS)}
    una = r.integers(0, 60, h)
    c_state = r.integers(0, 5, h)
    for e, cs in (("synack", 1), ("ack", 2), ("finack", 3), ("tx", 2), ("tick", 0)):
        c_state = np.where(is_ev[e] & (r.random(h) < 0.8), cs, c_state)
    c_state = np.where(is_ev["rto"] & (r.random(h) < 0.8), r.integers(1, 4, h), c_state)
    sv_state = np.where(is_ev["data"] | is_ev["fin"], pick(0.85, 1, 0), r.integers(0, 2, h))
    sv_state = np.where(is_ev["syn"], pick(0.6, 0, 1), sv_state)
    bm = r.integers(0, 1 << 32, h, dtype=np.uint64)
    bm = np.where(r.random(h) < 0.3, 0, bm)
    bm = np.where(r.random(h) < 0.1, 0xFFFFFFFF, bm)
    bm = np.where(r.random(h) < 0.15, (1 << r.integers(0, 33, h).astype(np.uint64)) - 1, bm)
    state = {
        "c_state": c_state, "c_phase": r.integers(0, 5, h), "c_peer": r.integers(0, h, h),
        "snd_una": una, "snd_nxt": una + r.integers(0, 12, h),
        "cwnd_x": pick(0.8, r.integers(1 << 10, 40 << 10, h), r.integers(-5, 1 << 10, h)),
        "ssth_x": pick(0.5, 0x7FFFFFFF, r.integers(2 << 10, 40 << 10, h)),
        "dup": r.integers(0, 4, h),
        "recover": pick(0.5, -1, una + r.integers(0, 12, h)),
        "srtt": pick(0.3, 0, r.integers(1, 500, h) * ms),
        "rttvar": r.integers(0, 200, h) * ms,
        "rto": r.integers(200, 4_000, h) * ms,
        "rtt_seq": pick(0.4, -1, una + r.integers(-2, 8, h)),
        "rtt_t0": t - r.integers(0, 500, h) * ms,
        "deadline": pick(0.3, TIME_MAX, t + r.integers(-500, 500, h) * ms),
        "timer_alive": r.random(h) < 0.5, "tx_alive": r.random(h) < 0.5,
        "flow_t0": t - r.integers(0, 5_000, h) * ms,
        "sv_state": sv_state, "sv_peer": r.integers(0, h, h), "sv_phase": r.integers(0, 5, h),
        "rcv_nxt": r.integers(0, 80, h), "sv_bm": bm.astype(i64),
        "da_pend": r.random(h) < 0.5,
        "da_t": pick(0.3, TIME_MAX, t + r.integers(-50, 50, h) * ms),
        "da_alive": r.random(h) < 0.5,
        **{k: r.integers(0, 1 << 40, h) for k in (
            "d_sent", "d_rtx", "fast_rtx", "timeouts", "flows_done", "flow_rtx0", "fct_sum",
            "segs_rcvd", "dup_segs", "bytes_rcvd", "done_t")},
    }
    # the wrong peer or phase now and then
    client = is_ev["synack"] | is_ev["ack"] | is_ev["finack"]
    src = np.where(client, state["c_peer"], state["sv_peer"])
    src = np.where(r.random(h) < 0.15, r.integers(0, h, h), src)
    ph = np.where(client, state["c_phase"], state["sv_phase"])
    ph = np.where(r.random(h) < 0.15, r.integers(0, 5, h), ph)
    ack = np.select([r.random(h) < 0.4, r.random(h) < 0.7, r.random(h) < 0.5],
                    [una, una + r.integers(1, 10, h), una - 1], state["recover"])
    rel = np.select([r.random(h) < 0.35, r.random(h) < 0.6, r.random(h) < 0.5],
                    [0, r.integers(1, 33, h), -r.integers(1, 4, h)], 33 + r.integers(0, 9, h))
    w_seq = np.where(is_ev["data"], state["rcv_nxt"] + rel, r.integers(-5, 100, h))
    w_seq = np.where(is_ev["fin"] & (r.random(h) < 0.7), state["rcv_nxt"], w_seq)
    ftype = np.select([is_ev[e] for e in ("syn", "synack", "data", "ack", "fin", "finack")],
                      [1, 2, 3, 4, 5, 6], 0)

    # the forced scenarios, host by host
    def put(i, **lanes):
        for k, v in lanes.items():
            tgt = {"src": src, "ph": ph, "ack": ack, "w_seq": w_seq}.get(k)
            (state[k] if tgt is None else tgt)[i] = v

    forced = [
        dict(c_state=2, snd_nxt=una[0] + 5, dup=2, recover=-1, ack=una[0]),
        dict(c_state=2, snd_nxt=una[1] + 3, deadline=t[1] - ms),
        dict(c_state=3, c_phase=0),
        dict(w_seq=state["rcv_nxt"][3] - 2),
        dict(sv_state=0),
        dict(c_state=0, c_phase=0),
        dict(c_state=2, snd_nxt=una[6] + 10, recover=una[6] + 8, ack=una[6] + 3),
        dict(c_state=2, snd_una=seg_l[7] - 2, snd_nxt=seg_l[7], recover=-1, ack=seg_l[7]),
        dict(w_seq=state["rcv_nxt"][8], da_pend=False, sv_bm=0, delack=40 * ms),
        dict(w_seq=state["rcv_nxt"][9] + 5),
        dict(w_seq=state["rcv_nxt"][10]),
        dict(c_state=2, snd_una=0, snd_nxt=0, cwnd_x=8 << 10),
        dict(c_state=1, deadline=t[12] - ms),
        dict(c_state=1),
        dict(w_seq=state["rcv_nxt"][14], sv_bm=0xFFFFFFFF),
        dict(w_seq=state["rcv_nxt"][15] + 32),
        dict(c_state=2, snd_una=0, snd_nxt=4, recover=-1, ack=4),
    ]
    for i, lanes in enumerate(forced):
        if "delack" in lanes:
            params["delack"][i] = lanes.pop("delack")
        put(i, **lanes)
    for i in range(n):  # client events for the client's own peer and phase
        if TGEN_FORCED[i][0] in ("ack", "synack", "finack"):
            put(i, src=state["c_peer"][i], ph=state["c_phase"][i])
        elif TGEN_FORCED[i][0] in ("data", "fin"):
            put(i, src=state["sv_peer"][i], ph=state["sv_phase"][i], sv_state=1)
    for i in (11, 16):  # room for a burst; an ACK short of the flow's end
        params["flow_segs"][i] = max(params["flow_segs"][i], 8)
    params["flows"][2] = max(params["flows"][2], 2)  # a next flow to start

    np_dtype = {torch.int32: i32, torch.int64: i64, torch.bool: bool}
    state = {k: state[k].astype(np_dtype[dt]) for k, dt in TgenTcpModel.kernel_state}
    payload = np.stack([r.integers(40, 1_540, h), w_seq, ack, ftype | (ph << 8)], axis=1)
    kind = np.select([ftype > 0] + [is_ev[e] for e in ("tick", "tx", "rto", "delack")],
                     [1, 0, 2, 3, 4])
    # past the forced hosts, a few unknown kinds and flipped packet flags
    noise = (np.arange(h) >= n) & (r.random(h) < 0.05)
    kind = np.where(noise & (r.random(h) < 0.5), 7, kind)
    return params, state, kind, (ftype > 0) ^ noise, src, payload


def handler_case(model: str, seed: int, h: int, dev, *, stride: int = 1) -> dict:
    """Random inputs of one handler call per host, for K17-K22 and their
    plain versions: a model (`model` is its config name), its params and
    state, RNG lanes, and an event per host with the engine's lanes (time,
    kind, payload, dispatch, is_packet, source, host id), some hosts not
    dispatched and some at TIME_MAX. PHOLD draws means down to 1 us (the
    1 us floor) and destinations over varied host counts; udp_echo mixes
    roles, kinds and response send times, and their first three hosts
    handle each of the model's kinds; tgen-TCP draws coherent connections
    (`_tgen_case`); gossip and circuit force GOSSIP_FORCED and
    CIRCUIT_FORCED at the front (`_gossip_case`, `_circuit_case`).
    `stride` > 1 makes the event time and payload a column of a K-way
    peek. Returns dict(model=the port's model, ctx=HandlerCtx on `dev`,
    np=the same inputs as numpy)."""
    from shadow_tpu_torch.models import get_model
    from shadow_tpu_torch.models.base import HandlerCtx
    from shadow_tpu_torch.ops.rng import RngState

    r = np.random.default_rng(seed)
    ms = 1_000_000
    t = r.integers(1_000, 60_000, h) * ms + r.integers(0, ms, h)
    active = r.random(h) < 0.85
    n_forced = {"tgen_tcp": len(TGEN_FORCED), "gossip": len(GOSSIP_FORCED),
                "circuit": len(CIRCUIT_FORCED)}.get(model, 3)
    active[:n_forced] = True
    t = np.where(~active & (r.random(h) < 0.5), TIME_MAX, t)
    payload = r.integers(-(1 << 31), 1 << 31, (h, 4))
    src = r.integers(0, h, h)
    is_pkt = r.random(h) < 0.5
    host_id = np.arange(h, dtype=np.int64)
    m = get_model(model)()
    if model == "tgen_tcp":
        m.tx_batch = int(r.integers(1, 5))
        params, st, kind, is_pkt, src, payload = _tgen_case(r, h, t)
    elif model == "phold":
        params = {"mean_delay": np.where(r.random(h) < 0.1, r.integers(1, 2_000, h),
                                         r.integers(1, 500, h) * ms).astype(np.int64),
                  "size": r.integers(40, 1_500, h).astype(np.int32),
                  "num_hosts": np.full(h, int(r.choice([h, 7, 10_000, 1 << 30])), np.int64)}
        st = {"handled": r.integers(0, 1 << 40, h)}
        kind = r.integers(0, 3, h)
    elif model == "udp_echo":
        params = {"role": r.integers(0, 2, h).astype(np.int32), "peer": r.integers(0, h, h),
                  "interval": (r.integers(1, 2_000, h) * ms).astype(np.int64),
                  "size": r.integers(40, 1_500, h).astype(np.int32)}
        st = {k: r.integers(0, 1 << 40, h) for k in ("sent", "rcvd", "rtt_sum", "rtt_max")}
        kind = r.integers(0, 4, h)
        t_sent = np.where(r.random(h) < 0.8, t - r.integers(0, 900, h) * ms,
                          r.integers(-(1 << 62), 1 << 62, h))
        payload[:, 1] = (t_sent & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        payload[:, 2] = t_sent >> 32
    elif model == "timer":
        params = {"interval": (r.integers(1, 2_000, h) * ms).astype(np.int64)}
        st = {"fires": r.integers(0, 1 << 40, h)}
        kind = r.integers(0, 2, h)
    elif model == "gossip":
        params, st, kind, payload = _gossip_case(r, h, payload)
    elif model == "circuit":
        params, st, kind, payload, is_pkt, host_id = _circuit_case(r, h, payload, is_pkt)
    else:
        raise ValueError(f"no handler case for model {model!r}")
    if model in ("phold", "udp_echo", "timer"):  # the first hosts take each kind
        n = min(h, n_forced)
        kind[:n] = {"phold": [1, 0, 1], "udp_echo": [0, 1, 2], "timer": [0, 0, 0]}[model][:n]
        if model == "phold":  # a hold at the 1 us floor
            params["mean_delay"][0] = 1
        if model == "udp_echo":
            params["role"][:n] = [0, 1, 0][:n]
            payload[2, 1] = (t[2] - 3 * ms) & 0xFFFFFFFF
            payload[2, 2] = (t[2] - 3 * ms) >> 32
    st = {k: np.ascontiguousarray(v) for k, v in st.items()}
    arrays = dict(
        t=t.astype(np.int64), kind=np.asarray(kind, np.int32),
        payload=np.asarray(payload).astype(np.int64).astype(np.int32), active=active,
        is_packet=np.asarray(is_pkt, bool), src=np.asarray(src, np.int64),
        host_id=np.asarray(host_id, np.int64), params=params, state=st,
        rng=r.integers(-(1 << 63), (1 << 63) - 1, (h, 4)),
    )

    return dict(model=m, ctx=_ctx_of(arrays, dev, stride, HandlerCtx, RngState), np=arrays)


def clone_ctx(ctx):
    """A context with its own copies of the state (nested dicts included)
    and RNG lanes (the handler kernels update them in place); the event
    lanes are shared."""
    return dataclasses.replace(ctx, state=_clone_tree(ctx.state),
                               rng=type(ctx.rng)(ctx.rng.s.clone()))


def _clone_tree(tree: dict) -> dict:
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def handler_steps(model: str, seed: int, h: int, dev, *, stride: int = 1, steps: int = 3):
    """Chained handler calls on the card: yields (kernel output, plain
    output) for `steps` calls of `handle` and `handle_plain`, each side
    carrying its own state and RNG lanes from call to call (the kernel's in
    place) with a fresh `handler_case` event each time. Compare each pair
    before asking for the next: the next kernel call overwrites the
    state."""
    case = handler_case(model, seed, h, dev, stride=stride)
    m, ck = case["model"], case["ctx"]
    cp = clone_ctx(ck)
    for step in range(steps):
        if step:
            ev = handler_case(model, seed * 1_000 + step, h, dev, stride=stride)["ctx"]
            ck = dataclasses.replace(ev, state=got.state, rng=got.rng)
            cp = dataclasses.replace(ev, state=want.state, rng=want.rng)
        got = m.handle(ck)
        want = m.handle_plain(cp)
        yield got, want


def _flat_state(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        out.update(_flat_state(v, f"{prefix}.{k}") if isinstance(v, dict)
                   else {f"{prefix}.{k}": v})
    return out


def handler_tensors(out) -> dict:
    """{name: array} over a handler's outputs (torch tensors, or the JAX
    package's arrays): every state lane (a nested dict's as
    "state.inner.lane"), the RNG lanes, and every field of every push and
    send port (a port field that is None is left out; the flow-record lanes
    a handler writes into `ctx.flow` are compared apart)."""
    got = _flat_state(out.state, "state")
    got["rng"] = out.rng.s
    for kind, ports in (("push", out.pushes), ("send", out.sends)):
        for i, port in enumerate(ports):
            for f, v in port._asdict().items():
                if hasattr(v, "shape"):
                    got[f"{kind}{i}.{f}"] = v
    return got


def handler_diff(got, want) -> list[str]:
    """The names of the handler outputs (`handler_tensors` of two
    HandlerOuts) that differ in the set of fields, dtype, shape or any
    value: empty when the two are bit for bit the same."""
    a, b = handler_tensors(got), handler_tensors(want)
    return sorted(set(a) ^ set(b)) + [
        k for k in b if k in a and (a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
                                    or not torch.equal(a[k], b[k]))]


# --------------------------------------------------------------------------
# the co-simulation bridge (K33-K35)
# --------------------------------------------------------------------------

COSIM_FILLS = ("empty", "partial", "full", "random")
NATIVE_PATTERNS = ("mixed", "all", "none")


def _ring_state(r, h: int, cap: int, fill: str) -> dict:
    """Random capture rings [h, cap] and counters: cap_n 0 everywhere
    (`empty`), below the capacity (`partial`), at it (`full`, so every
    delivery overflows into cap_lost) or anywhere in [0, cap] (`random`)."""
    n = {"empty": np.zeros(h, np.int64), "partial": r.integers(0, cap, h),
         "full": np.full(h, cap), "random": r.integers(0, cap + 1, h)}[fill]
    return {
        "cap_t": r.integers(0, 1 << 40, (h, cap)),
        "cap_src": r.integers(0, h, (h, cap)),
        "cap_key": r.integers(-(1 << 31), 1 << 31, (h, cap)).astype(np.int32),
        "cap_size": r.integers(0, 1 << 16, (h, cap)).astype(np.int32),
        "cap_flags": r.integers(-(1 << 31), 1 << 31, (h, cap)).astype(np.int32),
        "cap_n": n.astype(np.int32),
        "cap_lost": r.integers(0, 1 << 30, h),
    }


def _hybrid_event(r, h: int, t: np.ndarray, payload: np.ndarray):
    """The bridge's event lanes: send requests (local KIND_SENDREQ, the
    destination in word 1, some with the byte-store magic in word 3),
    deliveries (KIND_DATA packets) and foreign kinds."""
    kind = r.choice([0, 1, 1, 2, 2, 3], h).astype(np.int32)
    is_pkt = np.where(kind == 2, r.random(h) < 0.9, r.random(h) < 0.2)
    payload = payload.copy()
    payload[:, 1] = r.integers(0, h, h)
    payload[:, 3] = np.where(r.random(h) < 0.5, 0x53484457, payload[:, 3])
    return kind, is_pkt, payload


def hybrid_case(seed: int, h: int, dev, *, cap: int = 4, fill: str = "random",
                stride: int = 1) -> dict:
    """Random inputs of one hybrid handler call (K33): rings of `cap` slots
    filled as `fill` says (`_ring_state`), and one event per host. Returns
    dict(model, ctx, np) as `handler_case` does."""
    from shadow_tpu_torch.models.base import HandlerCtx
    from shadow_tpu_torch.models.hybrid import HybridModel
    from shadow_tpu_torch.ops.rng import RngState

    r = np.random.default_rng(seed)
    t = r.integers(1_000, 60_000, h) * 1_000_000
    active = r.random(h) < 0.85
    payload = r.integers(-(1 << 31), 1 << 31, (h, 4))
    kind, is_pkt, payload = _hybrid_event(r, h, t, payload)
    arrays = dict(t=t.astype(np.int64), kind=kind, payload=payload.astype(np.int32),
                  active=active, is_packet=is_pkt, src=r.integers(0, h, h).astype(np.int64),
                  host_id=np.arange(h, dtype=np.int64),
                  params={"_hosts": np.arange(h, dtype=np.int32)},
                  state=_ring_state(r, h, cap, fill),
                  rng=r.integers(-(1 << 63), (1 << 63) - 1, (h, 4)))
    ctx = _ctx_of(arrays, dev, stride, HandlerCtx, RngState)
    return dict(model=HybridModel(capture_cap=cap), ctx=ctx, np=arrays)


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict)
            else torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in tree.items()}


def _ctx_of(arrays: dict, dev, stride: int, ctx_cls, rng_cls):
    """A HandlerCtx on `dev` from numpy lanes (the window ends 5 ms after the
    earliest event), the event time and payload column `stride - 1` of a
    K-way peek when `stride` > 1."""
    h = arrays["t"].shape[0]
    wt = np.zeros((h, stride), np.int64)
    wt[:, -1] = arrays["t"]
    wp = np.zeros((h, stride, arrays["payload"].shape[1]), np.int32)
    wp[:, -1] = arrays["payload"]

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return ctx_cls(
        t=T(wt)[:, -1], window_end=int(arrays["t"].min()) + 5_000_000, kind=T(arrays["kind"]),
        payload=T(wp)[:, -1], active=T(arrays["active"]), is_packet=T(arrays["is_packet"]),
        src=T(arrays["src"]), host_id=T(arrays["host_id"]),
        state=_tree_to(arrays["state"], dev), params=_tree_to(arrays["params"], dev),
        rng=rng_cls(T(arrays["rng"])))


def mixed_case(inner: str, seed: int, h: int, dev, *, native: str = "mixed", cap: int = 8,
               stride: int = 1) -> dict:
    """Random inputs of one mixed-plane handler call (K34 around K33 and the
    inner model's kernel): the inner model's `handler_case`, a
    `global_is_native` table that is `mixed` (random), `all` or `none`
    native, hybrid rings of `cap` slots, and on native lanes the bridge's
    event kinds. Returns dict(model, ctx, np), `np` with the nested state
    and params."""
    from shadow_tpu_torch.models.base import HandlerCtx
    from shadow_tpu_torch.models.mixed import MixedModel
    from shadow_tpu_torch.ops.rng import RngState

    base = handler_case(inner, seed, h, "cpu")
    a = dict(base["np"])
    r = np.random.default_rng(seed + 7_919)
    table = {"mixed": r.random(h) < 0.4, "all": np.ones(h, bool),
             "none": np.zeros(h, bool)}[native]
    kind, is_pkt, payload = _hybrid_event(r, h, a["t"], a["payload"])
    a["kind"] = np.where(table, kind, a["kind"]).astype(np.int32)
    a["is_packet"] = np.where(table, is_pkt, a["is_packet"])
    a["payload"] = np.where(table[:, None], payload, a["payload"]).astype(np.int32)
    a["state"] = {**_ring_state(r, h, cap, "random"), "inner": a["state"]}
    a["params"] = {"_hosts": np.arange(h, dtype=np.int32), "inner": a["params"],
                   "global_is_native": table}
    ctx = _ctx_of(a, dev, stride, HandlerCtx, RngState)
    return dict(model=MixedModel(base["model"], inner), ctx=ctx, np=a)


def guarded_case(seed: int, h: int, dev, *, probe: str = "never", stops: int = 0) -> dict:
    """Random inputs of K35: effective next times (some hosts empty at
    TIME_MAX), cap_n all zero (`probe="never"`) or with deliveries waiting
    (`"first"`: the probe fires on the first round), and `stops` stop lanes
    of which the last has grown when `stops` > 1. Returns the keyword
    arguments of ops/cosim.py `guarded_window`."""
    r = np.random.default_rng(seed)
    ms = 1_000_000
    nt = r.integers(1_000, 9_000, h) * ms + r.integers(0, ms, h)
    nt = np.where(r.random(h) < 0.2, TIME_MAX, nt)
    cap_n = np.zeros(h, np.int32)
    if probe == "first":
        cap_n[r.integers(0, h, 3)] = r.integers(1, 128, 3)
    gmin = int(nt.min())

    def T(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    lanes = []
    for i in range(stops):
        v = int(r.integers(0, 100))
        lanes.append((T([v + (1 if i == stops - 1 and stops > 1 else 0)]), T([v])))
    return dict(next_t=T(nt), cap_n=T(cap_n), until=gmin + int(r.integers(-2, 3)) * ms,
                stop_time=int(r.integers(gmin // ms + 1, 20_000)) * ms,
                runahead=int(r.integers(1, 60)) * ms, stops=lanes)


# the co-simulation report's results (every key but its timings and the
# port's own counters), compared with the JAX package's
COSIM_KEYS = ("windows", "device_rounds", "events_processed", "packets_sent",
              "packets_delivered", "packets_lost", "packets_budget_dropped",
              "packets_codel_dropped", "faults_dropped", "faults_delayed",
              "queue_overflow_dropped", "queue_occupancy_hwm", "outbox_send_hwm",
              "unreachable_ips", "model_pkts_unrouted", "syscalls", "process_failures",
              "processes_exited", "determinism_digest", "model_report")


def _cosim_cfg(hosts: dict, stop: str = "3 s", seed: int = 7, **sections) -> dict:
    return {"general": {"stop_time": stop, "seed": seed, **sections.pop("general", {})},
            "network": {"graph": {"type": "1_gbit_switch"}}, "hosts": hosts, **sections}


def _ping_cfg(n: int, stop: str, count: int = 3, port: bool = True, **sections) -> dict:
    args = ["server=server", f"count={count}"] + (["port=9000"] if port else [])
    server = {"path": "udp_echo_server", **({"args": ["port=9000"]} if port else {})}
    client = {"path": "udp_ping", "args": args, "expected_final_state": {"exited": 0}}
    return _cosim_cfg({"server": {"network_node_id": 0, "processes": [server]},
                       "client": {"network_node_id": 0, "count": n, "processes": [client]}},
                      stop, **sections)


def _mixed_echo_cfg(client: dict, stop: str = "4 s", seed: int = 9, n: int = 3) -> dict:
    return _cosim_cfg({"server": {"network_node_id": 0, "processes": [
                           {"model": "udp_echo", "model_args": {"role": "server"}}]},
                       "client": {"network_node_id": 0, "count": n, "processes": [client]}},
                      stop, seed)


def cosim_small_configs() -> dict[str, dict]:
    """Small co-simulation configs: those of the JAX package's co-sim tests
    (tests/test_cosim.py: udp_ping, a tgen-TCP flow, the round-robin qdisc,
    the parallel host plane; tests/test_mixed.py: coroutine clients against
    a modeled udp_echo server, udp_blast into gossip lanes) and the
    send-budget case: 40 clients against one modeled server, whose budget
    of 32 sends a round drops echoes. The tgen run writes strace
    (deterministic), pcap and the log at level debug."""
    return {
        "udp_ping": _ping_cfg(2, "3 s", count=4),
        "tgen_tcp_flow": _cosim_cfg(
            {"server": {"network_node_id": 0, "processes": [
                {"path": "tgen_server", "args": ["port=8080", "conns=1"],
                 "expected_final_state": {"exited": 0}}]},
             "client": {"network_node_id": 0, "processes": [
                 {"path": "tgen_client",
                  "args": ["server=server", "port=8080", "size=200000"],
                  "expected_final_state": {"exited": 0}}]}},
            "10 s", general={"log_file": "sim.log", "log_level": "debug"},
            experimental={"strace_logging_mode": "deterministic"},
            host_option_defaults={"pcap_enabled": True}),
        "rr_qdisc": _ping_cfg(2, "1 s", port=False,
                              experimental={"interface_qdisc": "round-robin"}),
        "parallel_host_plane": _ping_cfg(30, "4 s", experimental={"host_workers": 4}),
        "mixed_coroutine_clients": _mixed_echo_cfg(
            {"path": "udp_ping", "args": ["server=server", "port=9000", "count=3"],
             "expected_final_state": {"exited": 0}}),
        "mixed_gossip_sanitised": _cosim_cfg(
            {"g": {"count": 4, "network_node_id": 0,
                   "processes": [{"model": "gossip", "model_args": {"fanout": 2}}]},
             "blaster": {"network_node_id": 0, "processes": [
                 {"path": "udp_blast", "args": ["server=g1", "port=9000", "count=5"],
                  "expected_final_state": {"exited": 0}}]}},
            "2 s", seed=3),
        "mixed_budget_drops": _mixed_echo_cfg(
            {"path": "udp_ping", "args": ["server=server", "port=9000", "count=2",
                                          "interval_ns=100000000", "size=512"],
             "expected_final_state": {"exited": 0}, "start_time": "100 ms"},
            stop="1 s", seed=42, n=40),
    }


def cosim_files(data_dir: str) -> dict[str, bytes]:
    """Every file a co-simulation wrote into `data_dir` but its report and
    processed config (which name the port and its devices), by relative
    path."""
    import os

    out = {}
    for root, _, files in os.walk(data_dir):
        for f in files:
            if f in ("sim-stats.json", "processed-config.yaml"):
                continue
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, data_dir)] = fh.read()
    return out


def cosim_final(report: dict, data_dir: str) -> dict:
    """What a co-simulation is held to: the report's results (COSIM_KEYS),
    the number of files it wrote (stdout, stderr, strace, pcap, the log,
    host-stats.json, hosts.txt) and one SHA-256 over them: of the canonical
    JSON of {relative path: the file's SHA-256}."""
    import hashlib
    import json

    files = {k: hashlib.sha256(v).hexdigest() for k, v in cosim_files(data_dir).items()}
    return {**{k: report.get(k) for k in COSIM_KEYS}, "files": len(files),
            "files_sha256": hashlib.sha256(
                json.dumps(files, sort_keys=True).encode()).hexdigest()}


def run_cosim(cfg_dict: dict, device, data_dir: str) -> tuple:
    """Build, run and write out one co-simulation of the port into
    `data_dir`: (report, cosim_final)."""
    import copy
    import io

    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.cosim import HybridSimulation

    cfg = ConfigOptions.from_dict(copy.deepcopy(cfg_dict))
    cfg.general.data_directory = data_dir
    sim = HybridSimulation(cfg, device=device)
    report = sim.run(progress=False, log=io.StringIO())
    sim.write_outputs(data_dir, report)
    return report, cosim_final(report, data_dir)


def cosim_mixed_config(fleet: int = 4096, clients: int = 32, stop: str = "6 s", *,
                       count: int = 50, seed: int = 42) -> dict:
    """The mixed co-simulation leg: examples/mixed.yaml's layout (a fleet of
    device-modeled udp_echo servers) with `fleet` servers and `clients`
    coroutine udp_ping clients, each sending `count` pings of 512 B at
    100 ms to fleet1 from 100 ms on. Past 32 clients the server's send
    budget (32 a round) drops echoes and the clients past it block."""
    return {
        "general": {"stop_time": stop, "seed": seed},
        "network": {"graph": {"type": "1_gbit_switch"}},
        "hosts": {
            "fleet": {"count": fleet, "network_node_id": 0,
                      "processes": [{"model": "udp_echo", "model_args": {"role": "server"}}]},
            "client": {"count": clients, "network_node_id": 0, "processes": [{
                "path": "udp_ping",
                "args": ["server=fleet1", f"count={count}", "interval_ns=100000000",
                         "size=512"],
                "start_time": "100 ms",
                "expected_final_state": {"exited": 0}}]},
        },
    }


# --------------------------------------------------------------------------
# the fault plane and the integrity sentinel (bench configs 7 and 10)
# --------------------------------------------------------------------------

PHOLD_GML = """
graph [
  directed 0
  node [
    id 0
    host_bandwidth_down "1 Gbit"
    host_bandwidth_up "1 Gbit"
  ]
  edge [ source 0 target 0 latency "50 ms" packet_loss 0.0 ]
]
"""


def torus_gml(side: int, lat_ms: int = 10) -> str:
    """The JAX repo's bench.py torus (a copy: bench.py imports JAX)."""
    lines = ["graph [", "  directed 0"]
    for i in range(side * side):
        lines.append(
            f'  node [ id {i} host_bandwidth_down "1 Gbit" '
            f'host_bandwidth_up "1 Gbit" ]'
        )
    for r in range(side):
        for c in range(side):
            i = r * side + c
            right = r * side + (c + 1) % side
            down = ((r + 1) % side) * side + c
            lines.append(f'  edge [ source {i} target {i} latency "{lat_ms} ms" ]')
            if right != i:
                lines.append(f'  edge [ source {i} target {right} latency "{lat_ms} ms" ]')
            if down != i:
                lines.append(f'  edge [ source {i} target {down} latency "{lat_ms} ms" ]')
    lines.append("]")
    return "\n".join(lines)


def cfg7_config(hosts: int = 4096, stop: str = "30 s", *, restart_queue: str = "hold",
                k: int = 1, block: int = 0, cpu_delay: str | None = None, wheel: int = 0,
                bootstrap: str | None = None, rounds_per_chunk: int = 128,
                snapshot_every: int = 4, backoff_ms: int = 50, **faults) -> dict:
    """bench.py baseline_config(7) (4,096 PHOLD hosts for 30 sim-s; 256
    small): ~30% of hosts crash once and restart (seed 7, a 2 s mean
    downtime), a 10-15 s window with 20% extra loss and 1.5x latency, the
    supervisor snapshotting every 4 chunks. The arguments vary the host
    count, the horizon, the restart policy, K and the queue block, the CPU
    delay, the timer wheel, `general.bootstrap_end_time`, the chunk length,
    the supervisor, and (`faults`) any other `faults:` key."""
    ex = {"event_queue_capacity": 16, "sends_per_host_round": 6,
          "rounds_per_chunk": rounds_per_chunk}
    if k > 1:
        ex["microstep_events"] = k
    if block:
        ex["event_queue_block"] = block
    if cpu_delay is not None:
        ex["cpu_delay"] = cpu_delay
    if wheel:
        ex["timer_wheel"] = wheel
    general = {"stop_time": stop, "seed": 1, "heartbeat_interval": None}
    if bootstrap is not None:
        general["bootstrap_end_time"] = bootstrap
    fb = {
        "seed": 7,
        "restart_queue": restart_queue,
        "host_churn": {"prob": 0.3, "mean_downtime": "2 s"},
        "loss_windows": [{"start": "10 s", "end": "15 s", "loss": 0.2, "latency_factor": 1.5}],
        "supervisor": {"snapshot_every_chunks": snapshot_every, "backoff_base_ms": backoff_ms},
        **faults,
    }
    return {
        "general": general,
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": ex,
        "faults": fb,
        "hosts": {"node": {"count": hosts, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64},
        }]}},
    }


def cfg10_config(side: int = 10, per_node: int = 100, stop: str = "5 s", *, k: int = 4,
                 block: int = 7, cap: int = 28, flows: int = 64, flow_segs: int = 100,
                 wheel: int = 0, rounds_per_chunk: int = 256) -> dict:
    """bench.py baseline_config(10): config 6 (tgen-TCP on the side x side
    torus at 50 ms, 10 x 10 with 100 hosts per node, K = 4, capacity 28 in
    blocks of 7, 24 sends per round) with `integrity: {enabled: true}`, cut
    to `stop`; the arguments size it down and vary K, the queue, the timer
    wheel and the chunk length."""
    ex = {"event_queue_capacity": cap, "microstep_events": k, "sends_per_host_round": 24,
          "rounds_per_chunk": rounds_per_chunk}
    if block:
        ex["event_queue_block"] = block
    if wheel:
        ex["timer_wheel"] = wheel
    return {
        "general": {"stop_time": stop, "seed": 1, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": torus_gml(side, lat_ms=50)}},
        "experimental": ex,
        "integrity": {"enabled": True},
        "hosts": {f"n{i:03d}": {"count": per_node, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": flows, "flow_segs": flow_segs, "cwnd_cap": 16, "mss": 1460,
                           "flow_gap": "50 ms", "tx_batch": 2},
        }]} for i in range(side * side)},
    }


# --------------------------------------------------------------------------
# the pressure plane (bench config 9) and capacity migration
# --------------------------------------------------------------------------


def cfg9_config(hosts: int = 4096, stop: str = "30 s", *, policy: str = "escalate",
                cap: int = 8, budget: int = 6, k: int = 1, block: int = 0,
                rounds_per_chunk: int = 128, supervisor: dict | None = None,
                **pressure) -> dict:
    """bench.py baseline_config(9) (4,096 PHOLD hosts for 30 sim-s; 256
    small): population 6 on an 8-slot queue with a send budget of 6,
    128-round chunks, `pressure: {policy: escalate, max_capacity: 64}`.
    The arguments vary the host count, the horizon, the policy, the
    launch shape (capacity, budget, K, queue block), the chunk length, add
    a `faults.supervisor` block, and (`pressure`) any other `pressure:`
    key."""
    ex = {"event_queue_capacity": cap, "sends_per_host_round": budget,
          "rounds_per_chunk": rounds_per_chunk}
    if k > 1:
        ex["microstep_events"] = k
    if block:
        ex["event_queue_block"] = block
    c = {
        "general": {"stop_time": stop, "seed": 1, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": ex,
        "pressure": {"policy": policy, "max_capacity": 64, **pressure},
        "hosts": {"node": {"count": hosts, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 6, "mean_delay": "200 ms", "size_bytes": 64},
        }]}},
    }
    if supervisor is not None:
        c["faults"] = {"supervisor": supervisor}
    return c


def tgen_pressure_config(k: int = 1, block: int = 0, cap: int = 6, stop: str = "1 s", *,
                         policy: str = "escalate", **pressure) -> dict:
    """A small tgen-TCP pressure case: 16 hosts on the 2 x 2 torus at 10 ms,
    three flows each, a 6-slot queue and a send budget of 4 under
    `pressure: {policy: escalate, max_capacity: 48}`, which regrows both;
    `k` and `block` set the microstep and the queue layout, `policy` and
    `pressure` the rest of the `pressure:` block."""
    ex = {"event_queue_capacity": cap, "sends_per_host_round": 4, "rounds_per_chunk": 16,
          "microstep_events": k}
    if block:
        ex["event_queue_block"] = block
    return {
        "general": {"stop_time": stop, "seed": 3, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": torus_gml(2, lat_ms=10)}},
        "experimental": ex,
        "pressure": {"policy": policy, "max_capacity": 48, **pressure},
        "hosts": {f"n{i}": {"count": 4, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 3, "flow_segs": 10, "cwnd_cap": 8, "mss": 1460,
                           "flow_gap": "20 ms", "tx_batch": 2},
        }]} for i in range(4)},
    }


def migrate_case(seed: int, h: int, cap: int, dev, *, fill: int | None = None,
                 p: int = 4) -> dict:
    """A random [h, cap] slab for the migration ops (K25 and its plain
    version): each host holds 0..`fill` live events (default: up to the
    whole row) at random columns, and the empty slots keep stale kind and
    payload words, as popped slots do. Returns dict(t, order, kind,
    payload, dropped)."""
    r = np.random.default_rng(seed)
    fill = cap if fill is None else fill
    n = r.integers(0, fill + 1, h)
    live = r.random((h, cap)).argsort(axis=1) < n[:, None]
    t = np.where(live, r.integers(0, 1 << 40, (h, cap)), TIME_MAX).astype(np.int64)
    order = np.where(live, r.integers(0, 1 << 62, (h, cap)), (1 << 63) - 1).astype(np.int64)
    kind = r.integers(0, 1 << 20, (h, cap)).astype(np.int32)
    payload = r.integers(-(1 << 31), (1 << 31) - 1, (h, cap, p)).astype(np.int32)
    dropped = r.integers(0, 100, h).astype(np.int64)

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return {"t": T(t), "order": T(order), "kind": T(kind), "payload": T(payload),
            "dropped": T(dropped)}


def scribble_hook(mode: str, at_round: int = 16, what: str = "time"):
    """A hook for the sentinel's replay seam (`Simulation._integrity_test_scribble`
    or `ResilienceController.test_scribble`): once the state has `at_round`
    rounds, set queue slot (0, 0)'s time to 0 (`what` "time"; a flat queue's
    slab: a bucketed queue's caches would not see it) or host 3's event
    count to -7 ("counter") — on the first attempt of that chunk only
    (`mode` "once": a transient the replay does not see), or on every
    attempt ("always": a violation that reproduces)."""
    fired = []

    def hook(st, attempt):
        if int(st.stats.rounds) < at_round:
            return st
        if mode == "once" and (attempt or fired):
            return st
        fired.append(1)
        if what == "time":
            st.queue.t[0, 0] = 0
        else:
            st.stats.events[3] = -7
        return st

    return hook


def fault_case(seed: int, h: int, w: int, n_win: int, dev, *, span: int = 10**9) -> dict:
    """Random fault-plane inputs: [h, w] disjoint crash windows per host
    (some slots unused), `n_win` link-fault windows, and per-host times
    drawn at window edges (down, up - 1, up), inside and between windows,
    and TIME_MAX."""
    r = np.random.default_rng(seed)
    down = np.full((h, w), TIME_MAX, np.int64)
    up = np.full((h, w), TIME_MAX, np.int64)
    edges = np.sort(r.integers(0, span, (h, 2 * w)), axis=1)
    used = r.integers(0, w + 1, h)
    for i in range(w):
        on = i < used
        down[on, i] = edges[on, 2 * i]
        up[on, i] = np.maximum(edges[on, 2 * i + 1], edges[on, 2 * i] + 1)
    pick = r.integers(0, 6, h)
    col = r.integers(0, w, h)
    rows = np.arange(h)
    d, u = down[rows, col], up[rows, col]
    t = np.select([pick == 0, pick == 1, pick == 2, pick == 3, pick == 4],
                  [d, np.where(u == TIME_MAX, u, u - 1), u, r.integers(0, span, h),
                   np.full(h, TIME_MAX)], r.integers(0, span, h))
    ws = np.sort(r.integers(0, span, n_win))
    we = ws + r.integers(1, span // 4, n_win)
    loss = r.random(n_win).astype(np.float32)
    lat = r.integers(1000, 3000, n_win)
    tw = np.select([pick == 0, pick == 1], [ws[r.integers(0, n_win, h)],
                                            we[r.integers(0, n_win, h)]], t)

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return {"down_t": T(down), "up_t": T(up), "t": T(t), "win_start": T(ws), "win_end": T(we),
            "win_loss": T(loss), "win_lat": T(lat), "t_win": T(tw)}


IV_CASES = (None, "time", "qfill", "wheel_qfill", "counter", "outbox", "digest", "done")


def integrity_case(seed: int, h: int, cap: int, block: int, dev, *, wheel: int = 0,
                   faults: bool = True, violate: str | None = None) -> dict:
    """One round's inputs to the sentinel's check (K24 and its plain
    version): the round-entry state `st0`, the state after the microsteps
    `st_m` and after the exchange `st_x` (queue slab and caches, the
    wheel's with `wheel` slots, the counter lanes with the fault counters
    where `faults`, send cursors, the outbox count, both digests), as a
    legal round leaves them, then changed so that the guard named by
    `violate` (one of IV_CASES; "done" makes it the done-round) trips.
    Returns dict(cfg, st0, st_m, st_x, window_end, done)."""
    from shadow_tpu_torch.core.engine import (
        EngineConfig,
        SimState,
        _init_stats,
        make_empty_outbox,
    )
    from shadow_tpu_torch.core.integrity import DIGEST2_OFFSET_I64
    from shadow_tpu_torch.ops.events import ORDER_MAX, EventQueue, bucket_rebuild
    from shadow_tpu_torch.ops.rng import u64

    r = np.random.default_rng(seed)
    ms = 1_000_000
    budget = 6
    cfg = EngineConfig(num_hosts=h, stop_time=60 * 10**9, queue_capacity=max(cap, 1),
                       queue_block=block, sends_per_host_round=budget, wheel_slots=wheel,
                       wheel_block=2 if wheel else 0, integrity=True, integrity_dual=True,
                       fault_crash_windows=1 if faults else 0)
    now0 = 1_000 * ms
    window_end = now0 + 50 * ms

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def slab(width, fill, lo):
        t = np.full((h, width), TIME_MAX, np.int64)
        live = r.random((h, width)).argsort(axis=1) < fill[:, None]
        t[live] = lo + r.integers(0, 200, int(live.sum())) * ms
        order = np.where(live, r.integers(0, 1 << 40, (h, width)), ORDER_MAX)
        return t, order

    def queue(t, order, b, dropped):
        q = EventQueue(T(t), T(order), T(np.zeros((h, t.shape[1]), np.int32)),
                       T(np.zeros((h, t.shape[1], 4), np.int32)), T(dropped))
        return bucket_rebuild(q, b) if b else q

    fill0 = r.integers(0, cap + 1, h)
    t0, o0 = slab(cap, fill0, now0)
    # the round pops some of each host's events and pushes later ones
    tm, om = t0.copy(), o0.copy()
    popped = (tm < window_end) & (r.random(tm.shape) < 0.5)
    tm[popped], om[popped] = TIME_MAX, ORDER_MAX
    add = (tm == TIME_MAX) & (r.random(tm.shape) < 0.2)
    tm[add] = now0 + r.integers(0, 400, int(add.sum())) * ms
    om[add] = r.integers(0, 1 << 40, int(add.sum()))
    tx, ox = tm.copy(), om.copy()
    arrive = (tx == TIME_MAX) & (r.random(tx.shape) < 0.3)
    tx[arrive] = window_end + r.integers(0, 300, int(arrive.sum())) * ms
    ox[arrive] = r.integers(0, 1 << 40, int(arrive.sum()))
    d0 = r.integers(0, 9, h)
    dx = d0 + r.integers(0, 3, h) * (r.random(h) < 0.3)
    q0, qm, qx = queue(t0, o0, block, d0), queue(tm, om, block, d0), queue(tx, ox, block, dx)
    w0 = wm = wx = None
    if wheel:
        wt0, wo0 = slab(wheel, r.integers(0, wheel + 1, h), now0)
        w0 = wm = wx = queue(wt0, wo0, 2, np.zeros(h, np.int64))

    stats0 = _init_stats(cfg, dev)
    events0 = r.integers(0, 50, h) * (r.random(h) < 0.8)
    lanes0 = {f: r.integers(0, 1 << 30, h) for f in (
        "pkts_sent", "pkts_lost", "pkts_unreachable", "pkts_codel_dropped", "pkts_delivered",
        "pkts_budget_dropped", "faults_dropped", "faults_delayed", "wheel_spilled")}
    d1 = r.integers(-(1 << 63), (1 << 63) - 1, h)
    d2 = r.integers(-(1 << 63), (1 << 63) - 1, h)
    stats0 = stats0._replace(
        events=T(events0), rounds=T(np.int64(r.integers(0, 1000))),
        digest=T(np.where(events0 == 0, u64(0xCBF29CE484222325), d1)),
        digest2=T(np.where(events0 == 0, DIGEST2_OFFSET_I64, d2)),
        **{f: T(v) for f, v in lanes0.items() if getattr(stats0, f) is not None})
    step = {f: r.integers(0, 4, h) for f in ("events", *lanes0)}
    events_x = events0 + step["events"]

    def later(s):
        return s._replace(
            events=T(events_x),
            digest=T(np.where(events_x == 0, u64(0xCBF29CE484222325), d1 ^ 5)),
            digest2=T(np.where(events_x == 0, DIGEST2_OFFSET_I64, d2 ^ 9)),
            **{f: T(lanes0[f] + step[f]) for f in lanes0 if getattr(s, f) is not None})

    sent = r.integers(0, budget + 1, h).astype(np.int32)
    ob = make_empty_outbox(h, budget, dev)
    ob = ob._replace(count=T(np.array([sent.sum()], np.int32)))
    base = SimState(now=now0, done=False, queue=q0, rng=None, seq=None,
                    sent_round=T(np.zeros(h, np.int32)), tb_egress=None, tb_ingress=None,
                    codel=None, min_used_lat=None, cpu_busy_until=None, model={},
                    outbox=make_empty_outbox(h, budget, dev), stats=stats0, wheel=w0)
    st_m = base._replace(queue=qm, wheel=wm, sent_round=T(sent), outbox=ob,
                         stats=later(stats0))
    st_x = base._replace(queue=qx, wheel=wx, stats=later(stats0)._replace(
        rounds=stats0.rounds + 1))
    done = violate == "done"
    host = int(r.integers(0, h))
    if violate in ("time", "done"):
        st_x.queue.t[host, 0] = now0 - 1  # a slot below the entry minimum
        if block:
            st_x.queue.bt[host, 0] = now0 - 1
    elif violate == "qfill":
        st_m.queue.bfill[host, 0] += 1
    elif violate == "wheel_qfill":
        st_m.wheel.bfill[host, 0] += 1
    elif violate == "counter":
        st_x.stats.pkts_lost[host] -= 5
    elif violate == "outbox":
        st_m.sent_round[host] = budget + 1
    elif violate == "digest":
        # a host that executed events shows none (a counter decrease too,
        # where it had some at entry)
        st_x.stats.events[int(np.flatnonzero(events_x)[0])] = 0
    return dict(cfg=cfg, st0=base, st_m=st_m, st_x=st_x, window_end=window_end, done=done)


def trace_case(seed: int, h: int, rounds: int, ring: int, dev, *, cap: int = 28,
               block: int = 7, windows: int = 0, netobs: bool = True,
               ledger: bool = True) -> dict:
    """Random inputs of `rounds` consecutive trace rows (K27): the
    cumulative counters at the first round's entry and after each round
    (events and, with `windows` > 0, the fault counters per host; the [1]
    lanes: popk_deferred, bq_rebuilds and, as the planes are on, ec_* and
    fl_done), and each round's `RoundInputs` (a queue-head plane of a flat
    [H, cap] slab or of a bucketed queue's [H, cap / block] minima with
    empty hosts, occupancies, crash windows around the windows' ends).
    Returns dict(stats=[rounds + 1 namespaces], inputs=[rounds], ring=R,
    new_ring=a function making an empty ring on `dev`)."""
    import types

    from shadow_tpu_torch.obs.tracer import TRACE_COLS, TraceRing
    from shadow_tpu_torch.ops.obs import RoundInputs

    r = np.random.default_rng([seed, 27])

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ms = 1_000_000
    lanes = {"events": r.integers(0, 1 << 40, h), "popk_deferred": r.integers(0, 1 << 30, 1),
             "bq_rebuilds": r.integers(0, 1 << 20, 1)}
    if windows:
        lanes.update(faults_dropped=r.integers(0, 1 << 30, h),
                     faults_delayed=r.integers(0, 1 << 30, h))
    if netobs:
        lanes.update({k: r.integers(0, 1 << 40, 1) for k in ("ec_timer", "ec_pkt", "ec_app")})
    if ledger:
        lanes["fl_done"] = r.integers(0, 1 << 30, 1)
    stats = [types.SimpleNamespace(**{k: T(v) for k, v in lanes.items()})]
    now = int(r.integers(0, 10**9))
    span = 400 * ms
    down = np.sort(r.integers(now, now + rounds * span, (h, max(windows, 1))), axis=1)
    up = down + r.integers(1, 3 * span, down.shape)
    inputs = []
    for i in range(rounds):
        lanes = {k: v + r.integers(0, 1 << 12, v.shape) for k, v in lanes.items()}
        stats.append(types.SimpleNamespace(**{k: T(v) for k, v in lanes.items()}))
        we = now + int(r.integers(1, span))
        width = cap // block if block else cap
        heads = np.where(r.random((h, width)) < 0.6, r.integers(we, we + span, (h, width)),
                         TIME_MAX)
        inputs.append(RoundInputs(
            rounds=torch.tensor(i + int(r.integers(0, 1 << 20)), dtype=torch.int64, device=dev),
            window_start=now,
            window_end=we, steps=int(r.integers(0, 64)),
            sends=T(r.integers(0, 1 << 30, 1).astype(np.int32)),
            occ=T(r.integers(0, cap + 1, h)), heads=T(heads),
            ob_hwm=torch.tensor(int(r.integers(0, 25)), dtype=torch.int64, device=dev),
            gear=int(r.integers(1, 25)), cap=cap,
            crash=(T(down), T(up)) if windows else None))
        now = we

    def new_ring():
        return TraceRing(torch.zeros((1, ring, TRACE_COLS), dtype=torch.int64, device=dev),
                         torch.zeros((1,), dtype=torch.int64, device=dev))

    return dict(stats=stats, inputs=inputs, ring=ring, new_ring=new_ring)


def flow_case(seed: int, h: int, e: int, records: int, dev, *,
              density: tuple = (0.05, 0.5, 0.0, 0.95)) -> dict:
    """Random inputs of one flow-ledger append (K28): a microstep's `e`
    event columns of FlowLanes (completion masks at the given densities,
    column by column; a dense column past `records` exercises the wrap
    rule), a ledger ring of `records` rows with stale rows and a cursor
    past zero, and the three fl_* totals. Returns dict(lanes, ledger,
    fl=[fl_done, fl_bytes, fl_rtx])."""
    from shadow_tpu_torch.obs.netobs import FLOW_COLS, FlowLedger
    from shadow_tpu_torch.ops.obs import FlowLanes

    r = np.random.default_rng([seed, 28])

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    dens = np.resize(np.asarray(density, np.float64), e)[:, None]
    lanes = FlowLanes(T(r.random((e, h)) < dens),
                      *(T(r.integers(0, 1 << 40, (e, h))) for _ in range(6)))
    ledger = FlowLedger(T(r.integers(0, 1 << 40, (1, records, FLOW_COLS))),
                        T(r.integers(0, 1 << 30, 1)))
    return dict(lanes=lanes, ledger=ledger,
                fl=[T(r.integers(0, 1 << 40, 1)) for _ in range(3)])


def outbox_case(seed: int, h_local: int, b: int, world: int, dev="cpu", *, fill: float = 0.6,
                shards=None, num_real: int | None = None) -> dict:
    """A shard's random [h_local, b] outbox for the exchange's pack (K29):
    a fraction `fill` of the slots valid (the rest t = TIME_MAX),
    destinations drawn over the shards `shards` (default all) and capped
    below `num_real` (padded hosts receive nothing), unique order keys and
    times with many ties. Returns dict(dst, t, order, kind, payload) of
    tensors on `dev`."""
    r = np.random.default_rng([seed, 29])
    shards = list(range(world)) if shards is None else list(shards)
    dst = r.choice(shards, (h_local, b)) * h_local + r.integers(0, h_local, (h_local, b))
    if num_real is not None:
        dst = np.minimum(dst, num_real - 1)
    valid = r.random((h_local, b)) < fill
    t = np.where(valid, 1_000 + r.integers(0, 40, (h_local, b)) * 1_000_000, TIME_MAX)
    src = np.arange(h_local)[:, None] + 3 * h_local
    order = (src << 40) | (r.permutation(h_local * b).reshape(h_local, b) + 7)
    arrays = {"dst": dst.astype(np.int32), "t": t.astype(np.int64),
              "order": order.astype(np.int64),
              "kind": r.integers(0, 1 << 17, (h_local, b)).astype(np.int32),
              "payload": r.integers(-(1 << 31), 1 << 31, (h_local, b, 4)).astype(np.int32)}
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def _time_collectives(coll, events: list) -> None:
    """Wrap `coll`'s collectives so that each call is bracketed by two CUDA
    events on the current stream, appended to `events` as a pair."""
    for name in ("pmin", "psum", "all_gather", "all_to_all"):
        def timed(x, _fn=getattr(coll, name)):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            y = _fn(x)
            b.record()
            events.append((a, b))
            return y
        setattr(coll, name, timed)


def mesh_runs(coll, cases: list) -> list | None:
    """One rank's part of a series of mesh runs (core/mesh.py launch
    calls it in every rank): each case is (config dict, `Simulation.run`
    keywords), built and run in turn over the rank's Collectives. Returns
    rank 0's reports (None elsewhere), each with the run's collective
    calls per kind in `mesh_calls` (the run loop's, the report's gather
    excluded), the bytes this rank sent into them in `mesh_bytes_sent` and
    the engine config as a dict in `engine_cfg`; on CUDA also
    `mesh_collective_ms`, the device ms between CUDA events around each of
    the run loop's collectives, summed (waits for the other ranks
    included)."""
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    dev = torch.device("cuda", coll.rank) if coll.device.type == "cuda" else coll.device
    events = [] if dev.type == "cuda" else None
    if events is not None:
        _time_collectives(coll, events)
    reports = []
    for cfg, run_kw in cases:
        sim = Simulation(ConfigOptions.from_dict(cfg), device=dev, coll=coll)
        calls0, bytes0 = dict(coll.calls), coll.bytes_sent
        n0 = len(events) if events is not None else 0
        rep = sim.run(progress=False, **run_kw)
        # the run loop's collectives (the report's own gather excluded)
        rep["mesh_calls"] = {k: v - calls0.get(k, 0) for k, v in sim.run_calls.items()
                             if v > calls0.get(k, 0)}
        rep["mesh_bytes_sent"] = sim.run_bytes_sent - bytes0
        rep["engine_cfg"] = dataclasses.asdict(sim.engine_cfg)
        if events is not None:
            torch.cuda.synchronize(dev)
            n = sum(rep["mesh_calls"].values())
            rep["mesh_collective_ms"] = sum(a.elapsed_time(b) for a, b in events[n0:n0 + n])
        reports.append(rep)
    return reports if coll.rank == 0 else None


# --------------------------------------------------------------------------
# the ensemble plane (K31, K32 and the replica lanes of K2, K4, K10, K11, K13)
# --------------------------------------------------------------------------


def ensemble_case(seed: int, reps: int, h: int, dev, *, fields: int = 11) -> dict:
    """Random inputs of the ensemble kernels over `reps` replicas of `h`
    rows: next times (replica 1 all empty, so done; the rest spread around
    a stop time with some rows right at it), used-latency minima, the lane
    block with replica `reps - 1` already done (frozen), per-row valves,
    outbox counts, a digest plane and `fields` counter planes."""
    from shadow_tpu_torch.ops.ensemble import WEND, make_lanes

    r = np.random.default_rng(seed)
    stop = 30 * 10**9

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    nt = r.integers(0, 2 * stop, (reps, h))
    nt[r.random((reps, h)) < 0.3] = TIME_MAX
    nt[min(1, reps - 1)] = TIME_MAX
    nt[0, : h // 7] = stop
    lanes = make_lanes([i == reps - 1 for i in range(reps)], dev)
    lanes[WEND, reps - 1] = 12_345
    return dict(
        nt=T(nt.reshape(-1)), stop=stop, lanes=lanes,
        min_used=T(r.integers(1, 90, reps) * 1_000_000),
        valve=T(r.integers(0, 40, reps * h)),
        ob_count=T(r.integers(0, 1_000, reps).astype(np.int32)),
        digest=T(r.integers(-(1 << 63), (1 << 63) - 1, reps * h)),
        fields=[T(r.integers(0, 1 << 40, reps * h)) for _ in range(fields)],
    )


def replica_chain_case(seed: int, reps: int, h: int, dev, *, frozen: tuple = (),
                       **chain_kw) -> dict:
    """`chain_case` over reps x h rows laid out as `reps` replicas of `h`
    hosts: the config's hosts per replica and replica count, `node_of` and
    the route rows held once (replica-local ids index them), destinations
    drawn around one replica's range, link-fault windows per replica
    ([reps, L], each replica's shifted), the window ends an i64[reps] lane,
    and the outbox counters and `min_used_lat` [reps]. Replicas in `frozen`
    have no active event and dispatch nothing: the kernels must leave their
    rows as they were."""
    from shadow_tpu_torch.core.faults import FaultParams

    case = chain_case(seed, reps * h, dev, **chain_kw)
    cfg, params, out = case["cfg"], case["params"], case["out"]
    n = params.lat_ns.shape[0]
    g = -(-h // n) if cfg.hosts_per_node else 0
    cfg = dataclasses.replace(cfg, num_hosts=h, replicas=reps, hosts_per_node=g)
    node_of = params.node_of[:h].contiguous()
    if g:
        node_of = (torch.arange(h, device=node_of.device) // g).to(torch.int32)
    params = params._replace(
        node_of=node_of,
        lat_rows=None if params.lat_rows is None else params.lat_rows[:h].contiguous(),
        loss_rows=None if params.loss_rows is None else params.loss_rows[:h].contiguous(),
        jit_rows=None if params.jit_rows is None else params.jit_rows[:h].contiguous(),
    )
    fp = params.faults
    if fp is not None and fp.win_start is not None:
        shift = torch.arange(reps, device=fp.win_start.device)[:, None] * 7_000_000
        params = params._replace(faults=FaultParams(
            fp.down_t, fp.up_t, fp.win_start[None] + shift, fp.win_end[None] + shift,
            fp.win_loss[None].repeat(reps, 1), fp.win_lat[None].repeat(reps, 1)))
    r = np.random.default_rng([seed, 40])
    sends = tuple(sp._replace(dst=torch.as_tensor(r.integers(-2, h + 2, reps * h),
                                                  device=sp.dst.device))
                  for sp in out.sends)
    keep = torch.ones((reps, h), dtype=torch.bool, device=case["active"].device)
    for i in frozen:
        keep[i] = False
    keep = keep.reshape(-1)
    we = case["window_end"]
    carry = case["carry"]
    ro = np.random.default_rng([seed, 41])  # the replicas' counter and latency lanes
    carry = carry._replace(
        stats=carry.stats._replace(
            ob_dropped=torch.zeros((reps,), dtype=torch.int64, device=keep.device)),
        outbox=carry.outbox._replace(count=torch.as_tensor(
            ro.integers(0, 100, reps).astype(np.int32), device=keep.device)),
        min_used_lat=torch.as_tensor(ro.integers(5, 60, reps) * 1_000_000, device=keep.device))
    return dict(case, cfg=cfg, params=params, out=out._replace(sends=sends), carry=carry,
                active=case["active"] & keep, dispatch=case["dispatch"] & keep,
                window_end=torch.as_tensor([we + i * 3_000_000 for i in range(reps)],
                                           device=keep.device))


def replica_merge_case(seed: int, reps: int, h: int, cap: int, b: int, gc: int, loads: tuple,
                       p: int = 4):
    """`merge_case` per replica (its load from `loads`; "empty" stages no
    send, so the replica's queue rows must come out unchanged), stacked
    into reps x h rows: numpy (queue planes, outbox planes) whose
    destinations are replica-local ids."""
    parts = [merge_case(seed + i, h, cap, b, gc, loads[i], p) for i in range(reps)]
    queue = tuple(np.concatenate([q[k] for q, _ in parts]) for k in range(5))
    outbox = tuple(np.concatenate([o[k] for _, o in parts]) for k in range(5))
    return queue, outbox


def cfg8_config(hosts: int = 4096, stop: str = "30 s", *, seeds=(1, 2, 3, 4),
                **campaign) -> dict:
    """bench.py baseline_config(8): a seed sweep of PHOLD replicas (4,096
    hosts each, 30 sim-s; the small form 8 hosts for 40 s) on the 50 ms
    graph, capacity 16, send budget 6, 64-round chunks, `campaign: {seeds:
    [1, 2, 3, 4], ledger_file: null}`. The arguments vary the host count,
    the horizon, the seeds and (`campaign`) any other campaign key."""
    return {
        "general": {"stop_time": stop, "seed": 1},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": {"event_queue_capacity": 16, "sends_per_host_round": 6,
                         "rounds_per_chunk": 64},
        "campaign": {"seeds": list(seeds), "ledger_file": None, **campaign},
        "hosts": {"node": {"count": hosts, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64},
        }]}},
    }


def campaign_base(campaign: dict, **general) -> dict:
    """The JAX repo's campaign smoke (tools/campaign.py `_smoke_base`): 8
    PHOLD hosts on the 50 ms graph for 2 sim-s, chunks of 8 rounds,
    capacity 16, budget 4, heartbeats every sim-second, with `campaign`
    (ledger file off unless given) and extra `general` keys."""
    return {
        "general": {"stop_time": "2 s", "seed": 1, "heartbeat_interval": "1 s", **general},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": {"event_queue_capacity": 16, "sends_per_host_round": 4,
                         "rounds_per_chunk": 8},
        "hosts": {"node": {"count": 8, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64}}]}},
        "campaign": {"ledger_file": None, **campaign},
    }


# campaigns of the CPU tests and the card-vs-CPU phase: two crash schedules
# under a repeated seed (an A/A pair, replicas 0 and 2, and a pair that
# diverges mid-run, 0 and 1); the same forced divergence alone; a
# fault-schedule sweep that pads crash windows and carries two loss windows
_CRASH_AB = [{"crashes": [{"host": 1, "down_at": "0.6 s", "up_at": "0.9 s"}]},
             {"crashes": [{"host": 1, "down_at": "1.4 s", "up_at": "1.7 s"}]}]
CAMPAIGNS = {
    "ab_pairs": {"seeds": [1, 1], "fault_schedules": _CRASH_AB,
                 "expect_identical": [[0, 2], [0, 1]]},
    "crash_ab": {"seeds": [1], "expect_identical": [[0, 1]], "fault_schedules": _CRASH_AB},
    "fault_sweep": {"seeds": [1, 2, 3], "fault_schedules": [
        {"crashes": [{"host": 2, "down_at": "0.1 s", "up_at": "0.25 s"},
                     {"host": 2, "down_at": "0.3 s", "up_at": "0.35 s"}],
         "loss_windows": [{"start": "0.05 s", "end": "0.2 s", "loss": 0.3}]},
        {"host_churn": {"prob": 0.5, "mean_downtime": "0.1 s"}, "seed": 9,
         "loss_windows": [{"start": "0.1 s", "end": "0.3 s", "loss": 0.1,
                           "latency_factor": 2.0},
                          {"start": "0.32 s", "end": "0.36 s", "loss": 0.5}]}]},
}
