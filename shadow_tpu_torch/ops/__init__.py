"""Device-side kernels and their plain PyTorch versions: event-queue slab
ops (K1-K3, K5-K8: flat and bucketed queues, the K-way peek and clear;
K25: the capacity migration), the
exchange merge (K4), the per-event chain with the outbox append (K10, K11), the
timer wheel's cancel (K12; its other ops are the bucketed queue's), the
pressure plane's drop total (K26), the observatories' trace row and flow
append (K27, K28), the cross-shard exchange's pack and unpack (K29, K30),
the ensemble plane's per-replica window and ledger fold (K31, K32), the
co-simulation bridge's guarded loop test (K35) and the per-host RNG
lanes."""

from shadow_tpu_torch.ops import (
    chain,
    cosim,
    ensemble,
    events,
    exchange,
    merge,
    obs,
    pressure,
    wheel,
)
from shadow_tpu_torch.ops.events import (
    EVENT_PAYLOAD_WORDS,
    ORDER_MAX,
    BucketQueue,
    Event,
    EventQueue,
    PoppedK,
    Push,
    bucket_rebuild,
    clear_popped,
    make_queue,
    next_time,
    pack_order,
    pop_k,
    pop_min,
    push_many,
    push_one,
    q_len,
    q_next_time,
    q_pop_min,
    q_push_many,
    queue_len,
    unpack_order_src,
)
from shadow_tpu_torch.ops.merge import merge_flat_events
from shadow_tpu_torch.ops.rng import RngState, rng_init, rng_next_u64, rng_uniform

# every hand-written kernel's launch wrapper, by kernel name
KERNELS = {**events.KERNELS, **merge.KERNELS, **chain.KERNELS, **wheel.KERNELS,
           **pressure.KERNELS, **obs.KERNELS, **exchange.KERNELS, **ensemble.KERNELS,
           **cosim.KERNELS}

__all__ = [
    "EVENT_PAYLOAD_WORDS",
    "KERNELS",
    "ORDER_MAX",
    "BucketQueue",
    "Event",
    "EventQueue",
    "PoppedK",
    "Push",
    "RngState",
    "bucket_rebuild",
    "clear_popped",
    "make_queue",
    "merge_flat_events",
    "next_time",
    "pack_order",
    "pop_k",
    "pop_min",
    "push_many",
    "push_one",
    "q_len",
    "q_next_time",
    "q_pop_min",
    "q_push_many",
    "queue_len",
    "rng_init",
    "rng_next_u64",
    "rng_uniform",
    "unpack_order_src",
]
