"""Deterministic exchange merge of a round's sent rows into the destination
queues (port of shadow_tpu/ops/merge.py `merge_flat_events`,
`merge_scatter_free` and `gear_shed_count`).

Rows. The rows are either N flat rows (dst, t, order, kind [N], payload
[N, P], valid [N]) or the first `cols` columns of the round's [H, B] outbox
(dst, t, order, kind [H, B], payload [H, B, P]), read in place: a
gear-sliced outbox is never copied. A row is valid where `valid` is set (by
default where its time is not TIME_MAX) and its destination is in range.

Contract of `merge_flat_events` (both shed modes): group the valid rows by
destination; destination h inserts r = min(seg_len, r_cap, free slots,
bound[h]) of its rows, the i-th of them into its i-th free slot (free
slots ranked by slot index), and adds seg_len - r to `dropped[h]`. The
`merge_rows` bound (0 = none) is the JAX package's positional truncation
of its sorted rows, where one token per host precedes the host's rows:
destination h's row of rank k sits at position before[h] + h + 1 + k
(before[h] = the valid rows of smaller destinations) and sheds at or past
`merge_rows`, so bound[h] = max(merge_rows - 1 - before[h] - h, 0).
Which rows, and in which order, is fixed by a per-row key:

  - `shed_urgency=True` (`overflow_shed: urgency`, the default): ascending
    (t, order) — the most urgent events win slots under overflow;
  - `shed_urgency=False` (`overflow_shed: append`): ascending row index
    (outbox position), the JAX package's `cheap_shed`. On a sliced outbox
    the kernel keys by the full-width index h * B + k, which orders rows as
    the JAX package's sliced index h * cols + k does.

Keys are unique among valid rows in both modes, so the result does not
depend on any sort's stability or on the order rows are visited.

Contract of `merge_scatter_free` (`experimental.merge_scatter`): when
every destination's count of valid rows is at most min(free slots, r_cap)
and, under a `merge_rows` bound, n_valid + H + 1 <= merge_rows (the JAX
package's conservative test), destination h places its rows in descending
row index, the row of rank i
into its i-th free slot, and `dropped` is unchanged; otherwise the result
is `merge_flat_events`'s. Both place the same events; the slots differ,
and slot positions are never observed, so digests agree either way.

Replicas (the ensemble plane): with `rows_per_rep` HR below the queue's H
rows, the queue is R = H / HR replicas of HR hosts and the rows are the
[H, B] outbox, whose row h belongs to replica h / HR. Destinations are
replica-local ids in [0, HR): a row lands in queue row (h / HR) * HR + dst,
and both contracts hold per replica (the `merge_rows` bound and K13's fits
test count within the replica), so each replica's result is its own merge's.

This module holds kernels K4 `merge_insert` and K13 `merge_scatter`
(csrc/merge.cu, sort-free bucket merges); `merge_flat_events_plain` and
`merge_scatter_free_plain` beside them are the plain PyTorch versions
(stable `torch.sort` passes), used for CPU tensors and as the kernels'
reference on the card.
"""

from __future__ import annotations

import ctypes

import torch

from shadow_tpu_torch.ops.cuda_build import CudaKernel, check, on_cpu, ptr
from shadow_tpu_torch.ops.events import EventQueue
from shadow_tpu_torch.simtime import TIME_MAX

_merge_k = CudaKernel(
    "merge", "merge_insert",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10,
)
_scatter_k = CudaKernel(
    "merge", "merge_scatter",
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10,
)


def gear_shed_count(sent_round: torch.Tensor, gear_cols: int) -> torch.Tensor:
    """Exact count of outbox entries a merge limited to the first
    `gear_cols` columns would miss: host h's sends fill columns 0 ..
    sent_round[h] - 1, so max(sent_round[h] - gear_cols, 0) of them lie
    beyond the limit. Zero iff the limit loses nothing. i64[]."""
    return torch.clamp_min(sent_round.to(torch.int64) - gear_cols, 0).sum()


def _flat_rows(dst, t, order, kind, payload, valid, cols: int, num_hosts: int):
    """The valid-row columns as flat [N] rows (the plain versions' view; a
    sliced outbox is copied here) with the destination range folded into
    `valid`."""
    if dst.dim() == 2:
        gc = cols or dst.shape[1]
        dst, t, order, kind = (x[:, :gc].reshape(-1) for x in (dst, t, order, kind))
        payload = payload[:, :gc].reshape(-1, payload.shape[-1])
        if valid is not None:
            valid = valid[:, :gc].reshape(-1)
    if valid is None:
        valid = t != TIME_MAX
    valid = valid & (dst >= 0) & (dst < num_hosts)
    return dst, t, order, kind, payload, valid


def _sort_perm(dst_key, t, order, shed_urgency: bool) -> torch.Tensor:
    """Row permutation ordering rows by (dst, key): stable LSD passes."""
    if shed_urgency:
        perm = torch.sort(order, stable=True).indices
        perm = perm[torch.sort(t[perm], stable=True).indices]
    else:
        perm = torch.arange(dst_key.shape[0], device=dst_key.device)
    return perm[torch.sort(dst_key[perm], stable=True).indices]


def _free_slots(q: EventQueue):
    """(slot_of_rank [H, C], free_count [H]): each host's free slots ranked
    by slot index."""
    num_hosts, cap = q.t.shape
    dev = q.t.device
    free = q.t == TIME_MAX
    free_rank = torch.cumsum(free.to(torch.int64), dim=1) - 1
    hh, cc = torch.nonzero(free, as_tuple=True)
    slot_of_rank = torch.full((num_hosts, cap), -1, dtype=torch.int64, device=dev)
    slot_of_rank[hh, free_rank[hh, cc]] = cc
    return slot_of_rank, free.sum(dim=1)


def _insert(q: EventQueue, slot_of_rank, perm, dst_key, n_take,
            t, order, kind, payload) -> EventQueue:
    """Write the rows `perm` (grouped by `dst_key`, each group in placement
    order) into their destinations' free slots: the group's i-th row into
    the i-th free slot while i < n_take[dst]; the rest add to `dropped`."""
    num_hosts, cap = q.t.shape
    dev = q.t.device
    n = perm.shape[0]
    s_dst = dst_key[perm]
    s_valid = s_dst < num_hosts
    seg_start = torch.searchsorted(s_dst, s_dst, right=False)
    rank = torch.arange(n, dtype=torch.int64, device=dev) - seg_start
    h_safe = torch.where(s_valid, s_dst, 0)
    ok = s_valid & (rank < n_take[h_safe])
    slot = slot_of_rank[h_safe, rank.clamp(max=cap - 1)]
    rows, hs, ss = perm[ok], h_safe[ok], slot[ok]
    new_t, new_order = q.t.clone(), q.order.clone()
    new_kind, new_payload = q.kind.clone(), q.payload.clone()
    new_t[hs, ss] = t[rows]
    new_order[hs, ss] = order[rows]
    new_kind[hs, ss] = kind[rows].to(torch.int32)
    new_payload[hs, ss] = payload[rows].to(torch.int32)
    lost = h_safe[s_valid & ~ok]
    dropped = q.dropped + torch.bincount(lost, minlength=num_hosts)
    return EventQueue(new_t, new_order, new_kind, new_payload, dropped)


def _per_replica(plain, q: EventQueue, dst, t, order, kind, payload, valid, max_inserts: int,
                 shed_urgency: bool, cols: int, merge_rows: int, rows_per_rep: int) -> EventQueue:
    """A plain merge run on each replica's rows of the queue and the [H, B]
    outbox, the results stacked back: replica r's merge sees only its own
    rows, as its solo run does."""
    outs = []
    for a in range(0, q.t.shape[0], rows_per_rep):
        sl = slice(a, a + rows_per_rep)
        outs.append(plain(EventQueue(*(x[sl] for x in q)), dst[sl], t[sl], order[sl], kind[sl],
                          payload[sl], None if valid is None else valid[sl], max_inserts,
                          shed_urgency, cols, merge_rows))
    return EventQueue(*(torch.cat(xs) for xs in zip(*outs)))


def _check_replicas(q: EventQueue, dst, rows_per_rep: int) -> bool:
    """Whether `rows_per_rep` splits the queue into replicas (False: one)."""
    h = q.t.shape[0]
    if not rows_per_rep or rows_per_rep == h:
        return False
    if h % rows_per_rep or dst.dim() != 2 or dst.shape[0] != h:
        raise ValueError(f"rows_per_rep={rows_per_rep}: the queue's {h} rows and the rows "
                         f"{tuple(dst.shape)} must be whole replicas of an [H, B] outbox")
    return True


def merge_flat_events_plain(
    q: EventQueue, dst, t, order, kind, payload, valid,
    max_inserts: int, shed_urgency: bool = True, cols: int = 0, merge_rows: int = 0,
    rows_per_rep: int = 0,
) -> EventQueue:
    if _check_replicas(q, dst, rows_per_rep):
        return _per_replica(merge_flat_events_plain, q, dst, t, order, kind, payload, valid,
                            max_inserts, shed_urgency, cols, merge_rows, rows_per_rep)
    num_hosts, cap = q.t.shape
    dst, t, order, kind, payload, valid = _flat_rows(
        dst, t, order, kind, payload, valid, cols, num_hosts)
    r_cap = min(max_inserts, cap)
    dst_key = torch.where(valid, dst.to(torch.int64), num_hosts)
    perm = _sort_perm(dst_key, t, order, shed_urgency)
    slot_of_rank, free_count = _free_slots(q)
    n_take = torch.clamp(free_count, max=r_cap)
    if merge_rows > 0:
        seg = torch.bincount(dst_key, minlength=num_hosts + 1)[:num_hosts]
        before = torch.cumsum(seg, 0) - seg
        hosts = torch.arange(num_hosts, device=seg.device)
        n_take = torch.minimum(n_take, torch.clamp_min(merge_rows - 1 - before - hosts, 0))
    return _insert(q, slot_of_rank, perm, dst_key, n_take, t, order, kind, payload)


def merge_scatter_free_plain(
    q: EventQueue, dst, t, order, kind, payload, valid,
    max_inserts: int, shed_urgency: bool = True, cols: int = 0, merge_rows: int = 0,
    rows_per_rep: int = 0,
) -> EventQueue:
    if _check_replicas(q, dst, rows_per_rep):
        return _per_replica(merge_scatter_free_plain, q, dst, t, order, kind, payload, valid,
                            max_inserts, shed_urgency, cols, merge_rows, rows_per_rep)
    num_hosts, cap = q.t.shape
    rows = _flat_rows(dst, t, order, kind, payload, valid, cols, num_hosts)
    dst, t, order, kind, payload, valid = rows
    r_cap = min(max_inserts, cap)
    dst_key = torch.where(valid, dst.to(torch.int64), num_hosts)
    cnt = torch.bincount(dst_key, minlength=num_hosts + 1)[:num_hosts]
    slot_of_rank, free_count = _free_slots(q)
    fits = bool((cnt <= torch.clamp(free_count, max=r_cap)).all())
    if merge_rows > 0:
        fits = fits and int(cnt.sum()) + num_hosts + 1 <= merge_rows
    if not fits:
        return merge_flat_events_plain(q, *rows, max_inserts, shed_urgency,
                                       merge_rows=merge_rows)
    # the fast path: rows grouped by destination, each group in descending
    # row index (a stable sort of the reversed rows)
    n = dst_key.shape[0]
    perm = (n - 1) - torch.sort(dst_key.flip(0), stable=True).indices
    return _insert(q, slot_of_rank, perm, dst_key, cnt, t, order, kind, payload)


def _launch(kernel, q: EventQueue, dst, t, order, kind, payload, valid,
            max_inserts: int, shed_urgency: bool, cols: int, scatter: bool,
            merge_rows: int, rows_per_rep: int) -> EventQueue:
    h, c = q.t.shape
    hr = rows_per_rep if _check_replicas(q, dst, rows_per_rep) else h
    p = q.payload.shape[2]
    if dst.dim() == 1:  # N flat rows: an [N, 1] outbox
        r, b, gc = dst.shape[0], 1, 1
        rows_shape = (r,)
    else:
        (r, b), gc = dst.shape, cols or dst.shape[1]
        rows_shape = (r, b)
        if not 0 < gc <= b:
            raise ValueError(f"cols={cols} must be in [1, {b}]")
    check(q.t, torch.int64, (h, c), "t")
    check(q.order, torch.int64, (h, c), "order")
    check(q.kind, torch.int32, (h, c), "kind")
    check(q.payload, torch.int32, (h, c, p), "payload")
    check(q.dropped, torch.int64, (h,), "dropped")
    check(dst, torch.int32, rows_shape, "rows dst")
    check(t, torch.int64, rows_shape, "rows t")
    check(order, torch.int64, rows_shape, "rows order")
    check(kind, torch.int32, rows_shape, "rows kind")
    check(payload, torch.int32, (*rows_shape, p), "rows payload")
    if valid is not None:
        check(valid, torch.bool, rows_shape, "rows valid")
    dev = q.t.device
    counts = torch.empty((h,), dtype=torch.int32, device=dev)
    offsets = torch.empty((h + 1,), dtype=torch.int32, device=dev)
    fill = torch.empty((h,), dtype=torch.int32, device=dev)
    bucket = torch.empty((max(r * gc, 1),), dtype=torch.int64, device=dev)
    args = [ptr(q.t), ptr(q.order), ptr(q.kind), ptr(q.payload), ptr(q.dropped),
            ptr(dst), ptr(t), ptr(order), ptr(kind), ptr(payload),
            None if valid is None else ptr(valid),
            ptr(counts), ptr(offsets), ptr(fill), ptr(bucket)]
    if scatter:
        args.append(ptr(torch.empty((h // hr,), dtype=torch.int32, device=dev)))
    if merge_rows < 0:
        raise ValueError(f"merge_rows={merge_rows} must be >= 0 (0 = none)")
    kernel(*args, h, hr, c, p, r, b, gc, min(max_inserts, c), int(bool(shed_urgency)),
           merge_rows)
    return q


def merge_flat_events(
    q: EventQueue, dst, t, order, kind, payload, valid,
    max_inserts: int, shed_urgency: bool = True, cols: int = 0, merge_rows: int = 0,
    rows_per_rep: int = 0,
) -> EventQueue:
    """Insert the rows (flat [N] or the first `cols` columns of an [H, B]
    outbox; `valid` may be None: time not TIME_MAX) into the [H, C] queue,
    under the `merge_rows` bound where it is > 0, per replica of
    `rows_per_rep` rows where it is given (0: one replica). On CUDA, K4
    updates the queue planes and `dropped` IN PLACE and returns the same
    queue."""
    if on_cpu(q.t):
        return merge_flat_events_plain(
            q, dst, t, order, kind, payload, valid, max_inserts, shed_urgency, cols, merge_rows,
            rows_per_rep)
    return _launch(_merge_k, q, dst, t, order, kind, payload, valid, max_inserts,
                   shed_urgency, cols, False, merge_rows, rows_per_rep)


def merge_scatter_free(
    q: EventQueue, dst, t, order, kind, payload, valid,
    max_inserts: int, shed_urgency: bool = True, cols: int = 0, merge_rows: int = 0,
    rows_per_rep: int = 0,
) -> EventQueue:
    """The scatter merge of the same rows (module docstring). On CUDA, K13
    decides between its fast path and K4's insert on the device, per
    replica, and updates the queue IN PLACE."""
    if on_cpu(q.t):
        return merge_scatter_free_plain(
            q, dst, t, order, kind, payload, valid, max_inserts, shed_urgency, cols, merge_rows,
            rows_per_rep)
    return _launch(_scatter_k, q, dst, t, order, kind, payload, valid, max_inserts,
                   shed_urgency, cols, True, merge_rows, rows_per_rep)


KERNELS = {"merge_insert": _merge_k, "merge_scatter": _scatter_k}
