"""Seeded inputs and helpers for checking kernels against their plain
versions: `chain_case` builds one event per host through ingress, a
synthetic handler output and egress (K9-K11); `merge_case` builds a queue
and a round's [H, B] outbox for the exchange merges (K4, K13);
`clone_carry` deep-copies a carry (the kernels update carries in place);
`flat_tensors` lists a nested tuple's tensors for comparison. Used by
chip_smoke.py and the tests; nothing on the simulation path imports it."""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.models.base import KIND_INGRESS_DONE, KIND_PKT
from shadow_tpu_torch.simtime import TIME_MAX


def chain_case(seed: int, h: int, dev, *, n_push: int, sends: tuple, route: str,
               shaping: bool = True, jitter: bool = False, n_nodes: int = 4,
               budget: int = 8, stride: int = 1) -> dict:
    """Random inputs of one event per host through ingress (K10), the
    handler's outputs (a synthetic HandlerOut) and egress (K11): a carry
    with every lane seeded, an event with packets, requeued packets and
    local events, CoDel states about to drop, token buckets short of
    tokens, sends with out-of-range destinations and hosts at or past the
    send budget. `sends` lists (count_max, has_count, has_inc) per send
    port; `route` is "const" (one graph node), "affine" (per-host rows,
    node = host // g), "node_of" (per-host rows, irregular map) or "table"
    (2-D gather); `stride` > 1 makes the event a column of a K-way peek."""
    from shadow_tpu_torch.core.engine import EngineConfig, EngineParams, Stats, _EvCarry
    from shadow_tpu_torch.models.base import HandlerOut, LocalPush, PacketSend
    from shadow_tpu_torch.net import CodelState, TBParams, TBState
    from shadow_tpu_torch.ops.events import Event
    from shadow_tpu_torch.ops.rng import RngState

    r = np.random.default_rng(seed)

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
                       bootstrap_end_time=int(r.integers(0, 2)) * 900 * ms)
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
    return dict(cfg=cfg, params=params, carry=carry, ev=ev, active=T(active),
                dispatch=T(active & (r.random(h) < 0.9)), out=out,
                window_end=int(t[active].min()) + 2 * ms if active.any() else 0)


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
