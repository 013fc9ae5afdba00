"""Per-host event queues as fixed-capacity SoA slabs (port of the flat and
bucketed queues in shadow_tpu/ops/events.py).

A queue is a `[H, C]` slab per field: times i64, order key i64, kind i32,
payload i32 x P. Empty slots hold TIME_MAX / ORDER_MAX. The total event
order is the lexicographic (time, order) pair; `order` packs
(is_local << 62) | (src_host << 40) | seq, so live keys are globally unique.

The bucketed queue (`BucketQueue`) adds per-block caches over C/B blocks of
B contiguous slots: the block's (time, order) minimum and its live count. Its
pops, pushes and drops are bit-identical to the flat queue's; the caches are
kept up incrementally by pops and pushes and rebuilt wholesale at the
exchange merge.

This module holds the queue's hand-written CUDA kernels (csrc/queue.cu):

  K1 `queue_next_time`   per-host row minimum (the time plane, or the
                         bucketed queue's block-minimum plane), floored
                         by the CPU model's busy horizon and moved past a
                         queue-hold crash window where given
  K2 `queue_pop_min`     per-host (time, order) minimum below a limit (one
                         scalar, or one per host), read out and cleared in
                         place (its device code also runs in K36, the
                         one-event microstep's pop and ingress)
  K3 `queue_push_many`   the k-th firing push lands in the k-th free slot,
                         each push holding back its reserve
  K5 `queue_pop_k`       peek each host's K earliest events below a limit
                         (one scalar, or one per host)
  K6 `queue_clear_popped`  clear the executed prefix of a peek (and the
                         victim blocks' caches)
  K7 `queue_push_many_bucketed`  K3 plus the block-cache update
  K8 `queue_block_minima`  every block's cache, from the slab
  K25 `queue_migrate`    re-seat the slab at a new capacity (pad, or stable
                         compaction and truncation) into new tensors
                         (`migrate_queue`), or count each host's live slots
                         (`migration_fits`)

Each public function dispatches on where its tensors live: CPU tensors run
the plain PyTorch version beside it (the same function, used by the tests
and as the reference the kernel is held against on the card); CUDA tensors
launch the kernel. There is no fallback from one to the other. On CUDA the
kernels that change a queue change its planes in place and return it;
K25 alone writes new tensors, so a migrated state never shares storage with
the snapshot it came from.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from shadow_tpu_torch.ops.cuda_build import CudaKernel, check, on_cpu, ptr
from shadow_tpu_torch.simtime import TIME_MAX

EVENT_PAYLOAD_WORDS = 4

_SEQ_BITS = 40
_SRC_SHIFT = _SEQ_BITS
_LOCAL_SHIFT = 62
SEQ_MASK = (1 << _SEQ_BITS) - 1
ORDER_MAX = (1 << 63) - 1  # empty-slot sentinel, compares after any real key
MAX_PUSH_PORTS = 32  # pushes per host per push_many call (kernel limit)
MAX_BATCH = 32  # K of pop_k / clear_popped (kernel limit)
MAX_CAPACITY = 32 * 32  # slots per host of the push and peek kernels (kernel limit)
MAX_BLOCKS = 32  # blocks per host of the bucketed kernels (kernel limit)


class EventQueue(NamedTuple):
    t: torch.Tensor  # i64[H, C] event time; TIME_MAX = empty
    order: torch.Tensor  # i64[H, C] secondary key; ORDER_MAX = empty
    kind: torch.Tensor  # i32[H, C]
    payload: torch.Tensor  # i32[H, C, P]
    dropped: torch.Tensor  # i64[H] events lost to capacity overflow


class BucketQueue(NamedTuple):
    """The flat planes plus per-block caches. Invariant: for every host h
    and block j, (bt, bo)[h, j] is the lexicographic (t, order) minimum over
    the block's slots (TIME_MAX/ORDER_MAX when empty) and bfill[h, j] its
    live slots."""

    t: torch.Tensor  # i64[H, C]
    order: torch.Tensor  # i64[H, C]
    kind: torch.Tensor  # i32[H, C]
    payload: torch.Tensor  # i32[H, C, P]
    dropped: torch.Tensor  # i64[H]
    bt: torch.Tensor  # i64[H, C/B] block-minimum time
    bo: torch.Tensor  # i64[H, C/B] order key at that minimum
    bfill: torch.Tensor  # i32[H, C/B] live slots per block

    @property
    def block(self) -> int:
        """Slots per block (B)."""
        return self.t.shape[1] // self.bt.shape[1]


class Event(NamedTuple):
    """One popped event per host (all [H])."""

    t: torch.Tensor  # i64[H]
    order: torch.Tensor  # i64[H]
    kind: torch.Tensor  # i32[H]
    payload: torch.Tensor  # i32[H, P]


class PoppedK(NamedTuple):
    """Each host's K earliest in-window events, PEEKED (still in the slab),
    sorted by (time, order); `active` is a prefix per host. `clear_popped`
    removes the prefix that was executed."""

    t: torch.Tensor  # i64[H, K] (TIME_MAX where inactive)
    order: torch.Tensor  # i64[H, K] (ORDER_MAX where inactive)
    kind: torch.Tensor  # i32[H, K] (0 where inactive)
    payload: torch.Tensor  # i32[H, K, P] (0 where inactive)
    active: torch.Tensor  # bool[H, K]
    idx: torch.Tensor  # i32[H, K] slab column of each event

    def event(self, j: int) -> Event:
        return Event(self.t[:, j], self.order[:, j], self.kind[:, j], self.payload[:, j])


class Push(NamedTuple):
    """One push port: at most one event per host, where `mask`. `reserve`
    (i32[H] or None) is the K-way microstep's capacity hold: free slots
    spoken for by batch events that executed after this push's event (in
    the one-event microstep they still sat in the queue when it landed)."""

    mask: torch.Tensor  # bool[H]
    t: torch.Tensor  # i64[H]
    order: torch.Tensor  # i64[H]
    kind: torch.Tensor  # i32[H]
    payload: torch.Tensor  # i32[H, P]
    reserve: Any = None  # i32[H] | None


def pack_order(is_local: int, src_host: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """The deterministic tiebreak key; src_host < 2^22, seq < 2^40."""
    return (is_local << _LOCAL_SHIFT) | (src_host << _SRC_SHIFT) | (seq & SEQ_MASK)


def unpack_order_src(order: torch.Tensor) -> torch.Tensor:
    """The sending host's global id from a packed order key."""
    return (order >> _SRC_SHIFT) & ((1 << (_LOCAL_SHIFT - _SRC_SHIFT)) - 1)


def check_order_limits(num_hosts: int) -> None:
    if num_hosts >= (1 << (_LOCAL_SHIFT - _SRC_SHIFT)):
        raise ValueError(
            f"num_hosts={num_hosts} exceeds the {1 << (_LOCAL_SHIFT - _SRC_SHIFT)}"
            " host limit of the packed event-order key"
        )


def make_queue(num_hosts: int, capacity: int, device) -> EventQueue:
    return EventQueue(
        t=torch.full((num_hosts, capacity), TIME_MAX, dtype=torch.int64, device=device),
        order=torch.full((num_hosts, capacity), ORDER_MAX, dtype=torch.int64, device=device),
        kind=torch.zeros((num_hosts, capacity), dtype=torch.int32, device=device),
        payload=torch.zeros(
            (num_hosts, capacity, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=device
        ),
        dropped=torch.zeros((num_hosts,), dtype=torch.int64, device=device),
    )


def as_flat(q) -> EventQueue:
    """The flat-slab view of either queue type (shared planes, no copy)."""
    if isinstance(q, BucketQueue):
        return EventQueue(q.t, q.order, q.kind, q.payload, q.dropped)
    return q


def queue_len(q: EventQueue) -> torch.Tensor:
    return (q.t != TIME_MAX).sum(dim=1, dtype=torch.int32)


def _check_slab(q) -> tuple[int, int, int]:
    h, c = q.t.shape
    p = q.payload.shape[2]
    check(q.t, torch.int64, (h, c), "t")
    check(q.order, torch.int64, (h, c), "order")
    check(q.kind, torch.int32, (h, c), "kind")
    check(q.payload, torch.int32, (h, c, p), "payload")
    check(q.dropped, torch.int64, (h,), "dropped")
    return h, c, p


def _check_caches(q: BucketQueue) -> int:
    h, c = q.t.shape
    nb = q.bt.shape[1]
    if c % nb:
        raise ValueError(f"{nb} blocks do not divide capacity {c}")
    check(q.bt, torch.int64, (h, nb), "bt")
    check(q.bo, torch.int64, (h, nb), "bo")
    check(q.bfill, torch.int32, (h, nb), "bfill")
    return c // nb


# --------------------------------------------------------------------------
# K1 queue_next_time
# --------------------------------------------------------------------------

_next_time_k = CudaKernel(
    "queue", "queue_next_time",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
)


def next_time_plain(t: torch.Tensor, floor: torch.Tensor | None = None,
                    crash=None) -> torch.Tensor:
    m = t.min(dim=1).values
    if floor is not None:
        m = torch.where(m == TIME_MAX, m, torch.maximum(m, floor))
    if crash is not None:
        from shadow_tpu_torch.core.faults import FaultParams, down_and_resume_plain

        _, resume = down_and_resume_plain(FaultParams(*crash, None, None, None, None), m)
        m = torch.where(m == TIME_MAX, m, torch.maximum(m, resume))
    return m


def row_min(t: torch.Tensor, floor: torch.Tensor | None = None, crash=None) -> torch.Tensor:
    """Per-row minimum of an i64[H, W] plane (K1 on CUDA); with an i64[H]
    `floor` (the CPU model's busy horizon), max(minimum, floor) wherever
    the row is not empty (TIME_MAX stays TIME_MAX); with `crash` = (down_t,
    up_t), the fault plane's i64[H, W'] crash windows under queue hold,
    that floored head moved on to the restart of the window containing it."""
    if on_cpu(t):
        return next_time_plain(t, floor, crash)
    h, w = t.shape
    check(t, torch.int64, (h, w), "t")
    if floor is not None:
        check(floor, torch.int64, (h,), "floor")
    nw = 0
    if crash is not None:
        nw = crash[0].shape[1]
        check(crash[0], torch.int64, (h, nw), "fault down_t")
        check(crash[1], torch.int64, (h, nw), "fault up_t")
    out = torch.empty((h,), dtype=torch.int64, device=t.device)
    none = ctypes.c_void_p(None)
    _next_time_k(ptr(t), none if floor is None else ptr(floor), ptr(out), h, w,
                 none if crash is None else ptr(crash[0]),
                 none if crash is None else ptr(crash[1]), nw)
    return out


def next_time(q: EventQueue, floor: torch.Tensor | None = None, crash=None) -> torch.Tensor:
    """Per-host earliest pending event time (i64[H], TIME_MAX = empty),
    floored by `floor` and moved past a crash window by `crash` where
    given (`row_min`)."""
    return row_min(q.t, floor, crash)


def bq_next_time(q: BucketQueue, floor: torch.Tensor | None = None,
                 crash=None) -> torch.Tensor:
    """The same from the [H, C/B] block caches alone (no slab read)."""
    return row_min(q.bt, floor, crash)


# --------------------------------------------------------------------------
# K2 queue_pop_min
# --------------------------------------------------------------------------

_pop_min_k = CudaKernel(
    "queue", "queue_pop_min",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int],
)


def pop_min_plain(q: EventQueue, limit: int) -> tuple[EventQueue, Event, torch.Tensor]:
    """Argmin-and-gather formulation (the JAX package's CPU path)."""
    tmin = q.t.min(dim=1).values
    active = tmin < limit
    at_min = (q.t == tmin[:, None]) & (q.t != TIME_MAX)
    cand_order = torch.where(at_min, q.order, ORDER_MAX)
    omin = cand_order.min(dim=1).values
    idx = cand_order.argmin(dim=1)
    hh = torch.arange(q.t.shape[0], device=q.t.device)
    ev = Event(
        t=torch.where(active, q.t[hh, idx], TIME_MAX),
        order=torch.where(active, q.order[hh, idx], ORDER_MAX),
        kind=torch.where(active, q.kind[hh, idx], 0),
        payload=torch.where(active[:, None], q.payload[hh, idx], 0),
    )
    clear = active[:, None] & at_min & (q.order == omin[:, None])
    return (
        q._replace(
            t=torch.where(clear, TIME_MAX, q.t),
            order=torch.where(clear, ORDER_MAX, q.order),
        ),
        ev,
        active,
    )


def pop_min(q: EventQueue, limit) -> tuple[EventQueue, Event, torch.Tensor]:
    """Pop each host's earliest event strictly before `limit` (an int, or
    an i64[H] tensor of per-host limits).

    Returns (queue', event, active[H]). Inactive hosts get a dummy event
    (t=TIME_MAX, order=ORDER_MAX, kind 0, payload 0). On CUDA the kernel
    clears the popped slot's time and order IN PLACE, so the returned queue
    shares (and the input queue sees) the updated planes; kind and payload
    stay as they were, exactly as in the reference. Per-host limits (the
    ensemble plane's per-replica window ends, the wheel merge's split) are
    read by K2 itself. The one-event microstep pops through K36
    (`ops/chain.py pop_ingress`), which runs this pop's device code."""
    if on_cpu(q.t):
        return pop_min_plain(q, limit)
    limits = None
    if isinstance(limit, torch.Tensor):
        check(limit, torch.int64, (q.t.shape[0],), "pop limits")
        limits, limit = limit, 0
    h, c, p = _check_slab(q)
    dev = q.t.device
    ev = Event(
        t=torch.empty((h,), dtype=torch.int64, device=dev),
        order=torch.empty((h,), dtype=torch.int64, device=dev),
        kind=torch.empty((h,), dtype=torch.int32, device=dev),
        payload=torch.empty((h, p), dtype=torch.int32, device=dev),
    )
    active = torch.empty((h,), dtype=torch.bool, device=dev)
    _pop_min_k(
        ptr(q.t), ptr(q.order), ptr(q.kind), ptr(q.payload), int(limit),
        None if limits is None else ptr(limits),
        ptr(ev.t), ptr(ev.order), ptr(ev.kind), ptr(ev.payload), ptr(active),
        h, c, p,
    )
    return q, ev, active


# --------------------------------------------------------------------------
# K3 queue_push_many / K7 queue_push_many_bucketed
# --------------------------------------------------------------------------

_push_many_k = CudaKernel(
    "queue", "queue_push_many",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4,
)
_bq_push_many_k = CudaKernel(
    "queue", "queue_push_many_bucketed",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5,
)


def push_many_plain(q, pushes: list[Push]):
    """Sequential-push semantics in one pass over either queue type: push k
    lands in the k-th free slot counting only earlier pushes that fired, if
    that count plus its reserve is below the row's free count; the rest add
    to `dropped`. A bucketed queue folds each landed push into its block's
    cache (a running lexicographic 2-way min, and bfill + 1)."""
    free = q.t == TIME_MAX
    free_rank = torch.cumsum(free.to(torch.int32), dim=1) - 1
    free_count = free.sum(dim=1, dtype=torch.int32)
    need = torch.zeros_like(free_count)
    new_t, new_order, new_kind, new_payload = q.t, q.order, q.kind, q.payload
    dropped = q.dropped
    bucketed = isinstance(q, BucketQueue)
    if bucketed:
        h, c = q.t.shape
        nb = q.bt.shape[1]
        bt, bo, bfill = q.bt, q.bo, q.bfill
    for push in pushes:
        avail = free_count if push.reserve is None else free_count - push.reserve
        ok = push.mask & (need < avail)
        oh = ok[:, None] & free & (free_rank == need[:, None])
        new_t = torch.where(oh, push.t[:, None], new_t)
        new_order = torch.where(oh, push.order[:, None], new_order)
        new_kind = torch.where(oh, push.kind.to(torch.int32)[:, None], new_kind)
        new_payload = torch.where(
            oh[:, :, None], push.payload.to(torch.int32)[:, None, :], new_payload
        )
        dropped = dropped + (push.mask & ~ok)
        need = need + ok.to(torch.int32)
        if bucketed:
            boh = oh.reshape(h, nb, c // nb).any(dim=2)
            pt, po = push.t[:, None], push.order[:, None]
            better = boh & ((pt < bt) | ((pt == bt) & (po < bo)))
            bt = torch.where(better, pt, bt)
            bo = torch.where(better, po, bo)
            bfill = bfill + boh.to(torch.int32)
    flat = (new_t, new_order, new_kind, new_payload, dropped)
    if bucketed:
        return BucketQueue(*flat, bt, bo, bfill)
    return EventQueue(*flat)


def _launch_push(q, pushes: list[Push]):
    """Launch K3/K7 over the pushes, MAX_PUSH_PORTS at a time: pushing A
    then B gives the slab, drops and caches that pushing A + B in one pass
    does (each push's rank and free count shift by A's landed pushes
    alike)."""
    if not pushes:
        raise ValueError("push_many needs at least one push port")
    for i in range(0, len(pushes), MAX_PUSH_PORTS):
        _launch_push_ports(q, pushes[i : i + MAX_PUSH_PORTS])
    return q


def _launch_push_ports(q, pushes: list[Push]):
    bucketed = isinstance(q, BucketQueue)
    h, c, p = _check_slab(q)
    n = len(pushes)
    if not 0 < n <= MAX_PUSH_PORTS:
        raise ValueError(f"push_many takes 1 to {MAX_PUSH_PORTS} push ports, got {n}")
    if c > MAX_CAPACITY:
        raise ValueError(f"push_many: capacity {c} exceeds the kernel's {MAX_CAPACITY} slots")
    mask = torch.stack([x.mask for x in pushes]).contiguous()
    pt = torch.stack([x.t for x in pushes]).contiguous()
    po = torch.stack([x.order for x in pushes]).contiguous()
    pk = torch.stack([x.kind for x in pushes]).to(torch.int32).contiguous()
    pp = torch.stack([x.payload for x in pushes]).to(torch.int32).contiguous()
    check(mask, torch.bool, (n, h), "push mask")
    check(pt, torch.int64, (n, h), "push t")
    check(po, torch.int64, (n, h), "push order")
    check(pp, torch.int32, (n, h, p), "push payload")
    if all(x.reserve is None for x in pushes):
        res = None
        res_ptr = ctypes.c_void_p(None)
    else:
        zero = torch.zeros((h,), dtype=torch.int32, device=q.t.device)
        res = torch.stack([zero if x.reserve is None else x.reserve.to(torch.int32)
                           for x in pushes]).contiguous()
        check(res, torch.int32, (n, h), "push reserve")
        res_ptr = ptr(res)
    slab = (ptr(q.t), ptr(q.order), ptr(q.kind), ptr(q.payload), ptr(q.dropped))
    fields = (ptr(mask), ptr(pt), ptr(po), ptr(pk), ptr(pp), res_ptr)
    if bucketed:
        b = _check_caches(q)
        _bq_push_many_k(*slab, ptr(q.bt), ptr(q.bo), ptr(q.bfill), *fields, h, c, p, n, b)
    else:
        _push_many_k(*slab, *fields, h, c, p, n)
    return q


def push_many(q: EventQueue, pushes: list[Push]) -> EventQueue:
    """Push up to len(pushes) events per host, in port order. On CUDA the
    kernel writes the slab and `dropped` IN PLACE."""
    if on_cpu(q.t):
        return push_many_plain(q, pushes)
    return _launch_push(q, pushes)


def push_one(q: EventQueue, mask, t, order, kind, payload) -> EventQueue:
    return push_many(q, [Push(mask, t, order, kind, payload)])


def bq_push_many(q: BucketQueue, pushes: list[Push]) -> BucketQueue:
    """`push_many` over the bucketed queue: the same slots, drops and slab
    as the flat op, plus the block-cache update. In place on CUDA."""
    if on_cpu(q.t):
        return push_many_plain(q, pushes)
    return _launch_push(q, pushes)


# --------------------------------------------------------------------------
# K5 queue_pop_k
# --------------------------------------------------------------------------

_pop_k_k = CudaKernel(
    "queue", "queue_pop_k",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4,
)


def pop_k_plain(q, limit, k: int) -> PoppedK:
    """k successive (time, order, slot) selections over the slots not yet
    taken, then row gathers for kind and payload. Live keys are unique, so
    on active columns this is the reference's `pop_k` under either of its
    formulations; the slot index only orders the empty sentinels."""
    qf = as_flat(q)
    h, c = qf.t.shape
    k = min(k, c)
    cols = torch.arange(c, device=qf.t.device)[None, :]
    taken = torch.zeros((h, c), dtype=torch.bool, device=qf.t.device)
    t_cols, o_cols, i_cols = [], [], []
    for _ in range(k):
        wt = torch.where(taken, TIME_MAX, qf.t)
        wo = torch.where(taken, ORDER_MAX, qf.order)
        tmin = wt.min(dim=1).values
        at_t = (wt == tmin[:, None]) & ~taken
        omin = torch.where(at_t, wo, ORDER_MAX).min(dim=1).values
        idx = (at_t & (wo == omin[:, None])).to(torch.int8).argmax(dim=1)
        taken = taken | (cols == idx[:, None])
        t_cols.append(tmin)
        o_cols.append(omin)
        i_cols.append(idx)
    ev_t = torch.stack(t_cols, dim=1)
    ev_o = torch.stack(o_cols, dim=1)
    idx = torch.stack(i_cols, dim=1)
    active = ev_t < (limit[:, None] if isinstance(limit, torch.Tensor) else limit)
    hh = torch.arange(h, device=qf.t.device)[:, None]
    return PoppedK(
        t=torch.where(active, ev_t, TIME_MAX),
        order=torch.where(active, ev_o, ORDER_MAX),
        kind=torch.where(active, qf.kind[hh, idx], 0),
        payload=torch.where(active[:, :, None], qf.payload[hh, idx], 0),
        active=active,
        idx=idx.to(torch.int32),
    )


def pop_k(q, limit, k: int) -> PoppedK:
    """PEEK each host's k earliest events strictly before `limit` (an int,
    or an i64[H] tensor of per-host limits), on either queue type. Column j
    equals the j-th successive pop_min. Nothing is written to the queue."""
    if on_cpu(q.t):
        return pop_k_plain(q, limit, k)
    h, c, p = _check_slab(as_flat(q))
    k = min(k, c)
    if not 0 < k <= MAX_BATCH or c > MAX_CAPACITY:
        raise ValueError(
            f"pop_k: k={k} must be in 1..{MAX_BATCH} and capacity {c} <= {MAX_CAPACITY}")
    dev = q.t.device
    out = PoppedK(
        t=torch.empty((h, k), dtype=torch.int64, device=dev),
        order=torch.empty((h, k), dtype=torch.int64, device=dev),
        kind=torch.empty((h, k), dtype=torch.int32, device=dev),
        payload=torch.empty((h, k, p), dtype=torch.int32, device=dev),
        active=torch.empty((h, k), dtype=torch.bool, device=dev),
        idx=torch.empty((h, k), dtype=torch.int32, device=dev),
    )
    if isinstance(limit, torch.Tensor):
        check(limit, torch.int64, (h,), "limit")
        scalar, limits = 0, ptr(limit)
    else:
        scalar, limits = int(limit), ctypes.c_void_p(None)
    _pop_k_k(
        ptr(q.t), ptr(q.order), ptr(q.kind), ptr(q.payload), scalar, limits,
        *(ptr(x) for x in out), h, c, p, k,
    )
    return out


# --------------------------------------------------------------------------
# K6 queue_clear_popped
# --------------------------------------------------------------------------

_clear_popped_k = CudaKernel(
    "queue", "queue_clear_popped",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4,
)


def _block_lexmin(t: torch.Tensor, order: torch.Tensor, nb: int):
    h, c = t.shape
    t3 = t.reshape(h, nb, c // nb)
    bt = t3.min(dim=2).values
    bo = torch.where(t3 == bt[:, :, None], order.reshape(h, nb, c // nb), ORDER_MAX)
    return bt, bo.min(dim=2).values


def clear_popped_plain(q, popped: PoppedK, m: torch.Tensor):
    qf = as_flat(q)
    h, c = qf.t.shape
    k = popped.idx.shape[1]
    take = popped.active & (torch.arange(k, device=qf.t.device)[None, :] < m[:, None])
    cols = torch.arange(c, device=qf.t.device)[None, :]
    clear = torch.zeros((h, c), dtype=torch.bool, device=qf.t.device)
    for j in range(k):
        clear = clear | (take[:, j, None] & (cols == popped.idx[:, j : j + 1]))
    new_t = torch.where(clear, TIME_MAX, qf.t)
    new_order = torch.where(clear, ORDER_MAX, qf.order)
    if not isinstance(q, BucketQueue):
        return q._replace(t=new_t, order=new_order)
    nb = q.bt.shape[1]
    cleared3 = clear.reshape(h, nb, c // nb)
    touched = cleared3.any(dim=2)
    nbt, nbo = _block_lexmin(new_t, new_order, nb)
    return q._replace(
        t=new_t,
        order=new_order,
        bt=torch.where(touched, nbt, q.bt),
        bo=torch.where(touched, nbo, q.bo),
        bfill=q.bfill - cleared3.sum(dim=2, dtype=torch.int32),
    )


def clear_popped(q, popped: PoppedK, m: torch.Tensor):
    """Remove the first m[h] (i32[H]) events of a `pop_k` peek from the
    slab; for a BucketQueue recompute the caches of the blocks that lost a
    slot (untouched blocks keep theirs bit for bit). In place on CUDA."""
    if on_cpu(q.t):
        return clear_popped_plain(q, popped, m)
    h, c, _ = _check_slab(as_flat(q))
    k = popped.idx.shape[1]
    if not 0 < k <= MAX_BATCH:
        raise ValueError(f"clear_popped: batch width {k} must be in 1..{MAX_BATCH}")
    check(popped.active, torch.bool, (h, k), "popped active")
    check(popped.idx, torch.int32, (h, k), "popped idx")
    check(m, torch.int32, (h,), "m")
    if isinstance(q, BucketQueue):
        b = _check_caches(q)
        caches = (ptr(q.bt), ptr(q.bo), ptr(q.bfill))
    else:
        b = 0
        caches = (ctypes.c_void_p(None),) * 3
    _clear_popped_k(
        ptr(q.t), ptr(q.order), *caches, ptr(popped.active), ptr(popped.idx), ptr(m),
        h, c, k, b,
    )
    return q


def bq_pop_min(q: BucketQueue, limit) -> tuple[BucketQueue, Event, torch.Tensor]:
    """`pop_min` over the bucketed queue (limit: an int or i64[H]): the
    same event, slot clear and `active` as the flat op, with the victim
    block's cache recomputed. It is `pop_k` at k = 1 followed by
    `clear_popped` of the active hosts."""
    popped = pop_k(q, limit, 1)
    active = popped.active[:, 0]
    return clear_popped(q, popped, active.to(torch.int32)), popped.event(0), active


# --------------------------------------------------------------------------
# K8 queue_block_minima
# --------------------------------------------------------------------------

_block_minima_k = CudaKernel(
    "queue", "queue_block_minima",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
)


def block_minima_plain(t: torch.Tensor, order: torch.Tensor, num_blocks: int):
    h, c = t.shape
    bt, bo = _block_lexmin(t, order, num_blocks)
    bfill = (t.reshape(h, num_blocks, c // num_blocks) != TIME_MAX).sum(dim=2, dtype=torch.int32)
    return bt, bo, bfill


def block_minima(t: torch.Tensor, order: torch.Tensor, num_blocks: int):
    """(bt, bo, bfill) of every block, recomputed from the slab."""
    if on_cpu(t):
        return block_minima_plain(t, order, num_blocks)
    h, c = t.shape
    check(t, torch.int64, (h, c), "t")
    check(order, torch.int64, (h, c), "order")
    if num_blocks <= 0 or c % num_blocks:
        raise ValueError(f"{num_blocks} blocks do not divide capacity {c}")
    bt = torch.empty((h, num_blocks), dtype=torch.int64, device=t.device)
    bo = torch.empty((h, num_blocks), dtype=torch.int64, device=t.device)
    bfill = torch.empty((h, num_blocks), dtype=torch.int32, device=t.device)
    _block_minima_k(ptr(t), ptr(order), ptr(bt), ptr(bo), ptr(bfill), h, c, c // num_blocks)
    return bt, bo, bfill


def bucket_rebuild(q, block: int) -> BucketQueue:
    """Wrap a flat queue (or refresh a bucketed one) with freshly computed
    block caches."""
    q = as_flat(q)
    c = q.t.shape[1]
    if block <= 0 or c % block:
        raise ValueError(f"block={block} must be positive and divide capacity {c}")
    return BucketQueue(*q, *block_minima(q.t, q.order, c // block))


def make_bucket_queue(num_hosts: int, capacity: int, block: int, device) -> BucketQueue:
    return bucket_rebuild(make_queue(num_hosts, capacity, device), block)


# --------------------------------------------------------------------------
# K25 queue_migrate: capacity migration (the pressure plane's escalation
# primitive and the cross-capacity checkpoint restore)
# --------------------------------------------------------------------------

_migrate_k = CudaKernel(
    "queue", "queue_migrate",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4,
)


def _check_migration(new_capacity: int, block: int) -> int:
    new_capacity = int(new_capacity)
    if new_capacity < 1:
        raise ValueError(f"new_capacity must be >= 1, got {new_capacity}")
    if block < 0 or (block and new_capacity % block):
        raise ValueError(
            f"block={block} must be 0 (flat) or divide new_capacity={new_capacity} evenly"
        )
    return new_capacity


def migrate_slab_plain(q: EventQueue, new_capacity: int) -> EventQueue:
    """The reference's re-seat of the flat planes: growth appends empty
    columns (TIME_MAX / ORDER_MAX, kind and payload 0); shrink sorts the
    columns stably on "slot is empty" (live slots first, each group in
    column order) and truncates. `dropped` is copied."""
    h, c = q.t.shape
    t, order, kind, payload = q.t, q.order, q.kind, q.payload
    if new_capacity < c:
        cols = torch.arange(c, dtype=torch.int64, device=t.device)[None, :].expand(h, c)
        key = torch.where(t != TIME_MAX, cols, c)
        idx = torch.argsort(key, dim=1, stable=True)[:, :new_capacity]
        t = torch.gather(t, 1, idx)
        order = torch.gather(order, 1, idx)
        kind = torch.gather(kind, 1, idx)
        payload = torch.gather(payload, 1, idx[:, :, None].expand(-1, -1, payload.shape[2]))
    elif new_capacity > c:
        pad = new_capacity - c
        dev = t.device
        t = torch.cat([t, torch.full((h, pad), TIME_MAX, dtype=torch.int64, device=dev)], 1)
        order = torch.cat([order, torch.full((h, pad), ORDER_MAX, dtype=torch.int64,
                                             device=dev)], 1)
        kind = torch.cat([kind, torch.zeros((h, pad), dtype=torch.int32, device=dev)], 1)
        payload = torch.cat([payload, torch.zeros((h, pad, payload.shape[2]),
                                                  dtype=torch.int32, device=dev)], 1)
    else:
        t, order, kind, payload = t.clone(), order.clone(), kind.clone(), payload.clone()
    return EventQueue(t, order, kind, payload, q.dropped.clone())


def migrate_slab(q: EventQueue, new_capacity: int) -> EventQueue:
    """K25 on CUDA: the re-seated flat planes, in new tensors; the plain
    version on the CPU."""
    if on_cpu(q.t):
        return migrate_slab_plain(q, new_capacity)
    h, c, p = _check_slab(q)
    dev = q.t.device
    out = EventQueue(
        t=torch.empty((h, new_capacity), dtype=torch.int64, device=dev),
        order=torch.empty((h, new_capacity), dtype=torch.int64, device=dev),
        kind=torch.empty((h, new_capacity), dtype=torch.int32, device=dev),
        payload=torch.empty((h, new_capacity, p), dtype=torch.int32, device=dev),
        dropped=q.dropped.clone(),
    )
    _migrate_k(ptr(q.t), ptr(q.order), ptr(q.kind), ptr(q.payload), ptr(out.t),
               ptr(out.order), ptr(out.kind), ptr(out.payload), ctypes.c_void_p(None), h, c,
               new_capacity, p)
    return out


def migrate_queue(q, new_capacity: int, block: int = 0):
    """Re-seat a queue's events into a slab of `new_capacity` slots per host
    (either queue type in; a `BucketQueue` with rebuilt caches out when
    `block` > 0, K8 on CUDA, else a flat `EventQueue`).

    Slot positions are unobservable (pops select by the (time, order) key
    over the whole slab, pushes and drops depend only on the free-slot
    count), so the result behaves exactly as a queue built at
    `new_capacity` with the same events. On shrink every live event must
    fit (`migration_fits`): the callers refuse before calling. The result
    never shares storage with `q`."""
    new_capacity = _check_migration(new_capacity, block)
    out = migrate_slab(as_flat(q), new_capacity)
    return bucket_rebuild(out, block) if block else out


def grow_queue(q: EventQueue, new_capacity: int) -> EventQueue:
    """`migrate_queue` restricted to growth on a flat queue."""
    if new_capacity <= q.t.shape[1]:
        raise ValueError(
            f"grow_queue: new_capacity={new_capacity} must exceed the current capacity "
            f"{q.t.shape[1]}"
        )
    return migrate_queue(q, new_capacity, block=0)


def grow_bucket_queue(q: BucketQueue, new_capacity: int, block: int = 0) -> BucketQueue:
    """`grow_queue` for the bucketed queue: pad, then rebuild the caches for
    the new block grid (`block` 0 keeps the queue's)."""
    if new_capacity <= q.t.shape[1]:
        raise ValueError(
            f"grow_bucket_queue: new_capacity={new_capacity} must exceed the current "
            f"capacity {q.t.shape[1]}"
        )
    return migrate_queue(q, new_capacity, block=block or q.block)


def migration_fits(q, new_capacity: int) -> torch.Tensor:
    """bool[H]: every live event of the host fits in `new_capacity` slots.
    On CUDA the count is K25's (count-only launch) over the slab."""
    qf = as_flat(q)
    if on_cpu(qf.t):
        return q_len(q) <= int(new_capacity)
    h, c, p = _check_slab(qf)
    live = torch.empty((h,), dtype=torch.int32, device=qf.t.device)
    none = ctypes.c_void_p(None)
    _migrate_k(ptr(qf.t), ptr(qf.order), ptr(qf.kind), ptr(qf.payload), none, none, none,
               none, ptr(live), h, c, 0, p)
    return live <= int(new_capacity)


# ---- queue-kind dispatchers ------------------------------------------------


def q_next_time(q, floor: torch.Tensor | None = None, crash=None) -> torch.Tensor:
    return (bq_next_time(q, floor, crash) if isinstance(q, BucketQueue)
            else next_time(q, floor, crash))


def q_pop_min(q, limit):
    return bq_pop_min(q, limit) if isinstance(q, BucketQueue) else pop_min(q, limit)


def q_head(q) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-host head key: the (time, order) pair `q_pop_min` would pop next,
    (TIME_MAX, ORDER_MAX) where the queue is empty. A bucketed queue reads
    its [H, C/B] caches (each block's `bo` is the order at its minimum
    time, so the least `bo` among blocks at the least time is the head's);
    a flat queue reads the slab."""
    t, o = (q.bt, q.bo) if isinstance(q, BucketQueue) else (q.t, q.order)
    tmin = t.min(dim=1).values
    omin = torch.where(t == tmin[:, None], o, ORDER_MAX).min(dim=1).values
    return tmin, omin


def q_len(q) -> torch.Tensor:
    """Per-host live-slot count; the bucketed queue sums its caches."""
    if isinstance(q, BucketQueue):
        return q.bfill.sum(dim=1, dtype=torch.int32)
    return queue_len(q)


def q_push_many(q, pushes: list[Push]):
    return bq_push_many(q, pushes) if isinstance(q, BucketQueue) else push_many(q, pushes)


KERNELS = {
    "queue_next_time": _next_time_k,
    "queue_pop_min": _pop_min_k,
    "queue_push_many": _push_many_k,
    "queue_pop_k": _pop_k_k,
    "queue_clear_popped": _clear_popped_k,
    "queue_push_many_bucketed": _bq_push_many_k,
    "queue_block_minima": _block_minima_k,
    "queue_migrate": _migrate_k,
}
