"""Per-host timer wheel (port of shadow_tpu/ops/wheel.py).

The wheel keeps a model's timer events (TCP retransmit and delayed-ACK
timers, periodic ticks) out of the event queue: a per-host [H, S] slab with
per-block (time, order, fill) caches — a `BucketQueue` in every respect, so
its next time, push and pop are the bucketed queue's kernels on the wheel's
slab (K1 on the block caches, K7, K5 + K6). The engine pops the
lexicographic (time, order) minimum of queue and wheel, so where an event
sits is unobservable: dispatch, digests and drops equal the wheel-off
path's. A timer push that finds the wheel full spills to the queue (counted
in `Stats.wheel_spilled`), so the wheel itself never drops.

`wheel_cancel` removes a pending timer by its order key without firing it:
one masked compare over the [H, S] key plane and a recompute of the block
that lost the slot — kernel K12 (csrc/queue.cu) on CUDA, its plain PyTorch
version on the CPU. No engine path calls it (in the JAX package either);
it is exported for models that cancel timers.

`migrate_wheel` re-seats the wheel at another slot count (the checkpoint's
cross-shape restore): K25 on the wheel slab, then K8 for the caches.
"""

from __future__ import annotations

import ctypes

import torch

from shadow_tpu_torch.ops.cuda_build import CudaKernel, check, on_cpu, ptr
from shadow_tpu_torch.ops.events import (
    MAX_BLOCKS,
    MAX_CAPACITY,
    ORDER_MAX,
    BucketQueue,
    _check_caches,
    _check_slab,
    bq_next_time,
    bq_pop_min,
    bq_push_many,
    make_bucket_queue,
    migrate_queue,
    q_len,
)
from shadow_tpu_torch.simtime import TIME_MAX

# the wheel IS a bucketed queue: same planes, same caches, same kernels
TimerWheel = BucketQueue


def resolve_wheel_block(slots: int, block: int = 0) -> int:
    """The wheel's block size: an explicit divisor wins; 0 picks the divisor
    of `slots` nearest sqrt(slots), ties to the larger."""
    slots = int(slots)
    if slots < 1:
        raise ValueError(f"wheel slots must be >= 1, got {slots}")
    block = int(block)
    if block:
        if block < 1 or slots % block:
            raise ValueError(f"wheel block={block} must divide slots={slots} evenly")
        return block
    target = slots ** 0.5
    divisors = [b for b in range(1, slots + 1) if slots % b == 0]
    return min(divisors, key=lambda b: (abs(b - target), -b))


def make_wheel(num_hosts: int, slots: int, block: int = 0, device="cpu") -> TimerWheel:
    """An empty per-host timer wheel: [H, S] planes plus block caches."""
    return make_bucket_queue(num_hosts, slots, resolve_wheel_block(slots, block), device)


def wheel_next_time(w: TimerWheel, floor: torch.Tensor | None = None,
                    crash=None) -> torch.Tensor:
    """Per-host earliest pending timer (i64[H], TIME_MAX = none), from the
    block caches alone; floored by the CPU model's busy horizon and moved
    past a queue-hold crash window where given."""
    return bq_next_time(w, floor, crash)


def wheel_len(w: TimerWheel) -> torch.Tensor:
    """Per-host live timers (i32[H]), from the fill caches."""
    return q_len(w)


def wheel_free(w: TimerWheel) -> torch.Tensor:
    """Per-host free slots (i32[H]): the spill-routing input."""
    return w.t.shape[1] - q_len(w)


def wheel_push_many(w: TimerWheel, pushes) -> TimerWheel:
    """Push routed timer events; the caller masks away what does not fit
    (`wheel_free`), so the wheel never drops. In place on CUDA."""
    return bq_push_many(w, pushes)


def wheel_pop_min(w: TimerWheel, limit):
    """Pop each host's earliest timer strictly before `limit` (an int or
    i64[H]); the same semantics as `q_pop_min`. In place on CUDA."""
    return bq_pop_min(w, limit)


_cancel_k = CudaKernel(
    "queue", "queue_wheel_cancel", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3,
)


def wheel_cancel_plain(w: TimerWheel, mask: torch.Tensor, order: torch.Tensor):
    h, s = w.t.shape
    nb = w.bt.shape[1]
    b = s // nb
    hit = mask[:, None] & (w.order == order[:, None]) & (w.t != TIME_MAX)
    found = hit.any(dim=1)
    new_t = torch.where(hit, TIME_MAX, w.t)
    new_order = torch.where(hit, ORDER_MAX, w.order)
    hit3 = hit.reshape(h, nb, b)
    touched = hit3.any(dim=2)
    t3 = new_t.reshape(h, nb, b)
    nbt = t3.min(dim=2).values
    nbo = torch.where(t3 == nbt[:, :, None], new_order.reshape(h, nb, b), ORDER_MAX)
    nbo = nbo.min(dim=2).values
    return (
        w._replace(
            t=new_t,
            order=new_order,
            bt=torch.where(touched, nbt, w.bt),
            bo=torch.where(touched, nbo, w.bo),
            bfill=w.bfill - hit3.sum(dim=2, dtype=torch.int32),
        ),
        found,
    )


def wheel_cancel(w: TimerWheel, mask: torch.Tensor, order: torch.Tensor):
    """Cancel, for each host where `mask`, the pending timer whose packed
    order key equals `order[h]` (keys are unique: at most one slot
    matches). Returns (wheel', found bool[H]); a miss (the timer already
    fired, spilled to the queue, or never existed) leaves the host's slab
    as it was. In place on CUDA (K12)."""
    if on_cpu(w.t):
        return wheel_cancel_plain(w, mask, order)
    h, s, _ = _check_slab(w)
    b = _check_caches(w)
    if s > MAX_CAPACITY or s // b > MAX_BLOCKS:
        raise ValueError(f"wheel_cancel: {s} slots in blocks of {b} exceed the kernel's limits")
    check(mask, torch.bool, (h,), "mask")
    check(order, torch.int64, (h,), "order")
    found = torch.empty((h,), dtype=torch.bool, device=w.t.device)
    _cancel_k(ptr(w.t), ptr(w.order), ptr(w.bt), ptr(w.bo), ptr(w.bfill), ptr(mask),
              ptr(order), ptr(found), h, s, b)
    return w, found


def migrate_wheel(w: TimerWheel, new_slots: int, block: int = 0) -> TimerWheel:
    """Re-seat the wheel at `new_slots` slots per host (`migrate_queue` with
    the resolved block; the caller checks `migration_fits` before a
    shrink)."""
    return migrate_queue(w, new_slots, block=resolve_wheel_block(new_slots, block))


KERNELS = {"wheel_cancel": _cancel_k}

