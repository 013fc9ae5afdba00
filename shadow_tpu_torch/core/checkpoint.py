"""In-memory pre-chunk snapshots (the JAX package's `core/checkpoint.py`
`snapshot_state` / `restore_snapshot`, which the merge gears, the integrity
sentinel's replays and the run supervisor restore from; on-disk checkpoints
are not ported).

The queue, wheel, merge and per-event chain kernels update the state's
tensors IN PLACE on CUDA (K3-K13). A snapshot that shared storage with the
live state would be overwritten by the very chunk it is meant to undo, so a
snapshot is a deep copy of every tensor: queue and wheel planes and caches,
outbox, RNG lanes, token buckets, CoDel, seq, `sent_round`,
`min_used_lat`, every stats lane (the fluid plane's byte counters, the
fault counters and the integrity sentinel's lanes too),
the fluid plane's rates and link utilization (K15 writes them in place, so
a replayed chunk restarts the ODE from the pre-chunk state and never
advances it twice) and the model's state dict. Restoring
copies again, so one snapshot survives any number of replays (a replay at
a middle gear can shed again and need another restore).
"""

from __future__ import annotations

from typing import Any

import torch


def clone_tree(x: Any) -> Any:
    """A deep copy of every tensor in a tree of NamedTuples, tuples, lists
    and dicts; other leaves (host ints and bools, None) are shared."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


def snapshot_state(state):
    """A device-resident copy of every tensor of `state` (a SimState)."""
    return clone_tree(state)


def restore_snapshot(snap):
    """A fresh copy of a snapshot, for the replay to consume in place; the
    snapshot itself stays intact for the next restore."""
    return clone_tree(snap)
