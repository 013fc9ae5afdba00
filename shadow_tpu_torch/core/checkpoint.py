"""Pre-chunk snapshots and on-disk checkpoints (port of the JAX package's
`core/checkpoint.py`: `snapshot_state` / `restore_snapshot`, which the merge
gears, the pressure plane, the integrity sentinel's replays and the run
supervisor restore from, `save_checkpoint` / `load_checkpoint` with the
cross-capacity restore, and the ensemble plane's `ensemble_fingerprint`,
`save_ensemble_checkpoint` and `load_ensemble_checkpoint`; its hybrid
functions are not ported).

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

A checkpoint is the port's own format: one .npz of numpy arrays (every
leaf of the state, the host scalars `now` and `done` included, or on an
ensemble state their [R] arrays) with a
guard record (a sha256 of the engine config, the state's structure and the
parameters; no device) and the state's shapes. A checkpoint whose config
differs only in the capacity shapes resumes through the pressure plane's
migration (K25), or is refused with `CheckpointError` where that would
lose events, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np
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


# --------------------------------------------------------------------------
# on-disk checkpoints
# --------------------------------------------------------------------------


class CheckpointError(Exception):
    pass


def _leaves(x: Any, path: str = ""):
    """(path, leaf) over a tree of NamedTuples and dicts (dict keys in sorted
    order); leaves are tensors, numpy arrays, host ints and bools, and
    None."""
    if x is None or isinstance(x, (torch.Tensor, np.ndarray, bool, int, np.integer, np.bool_)):
        yield path, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{path}.{f}" if path else f)
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}.{k}" if path else str(k))
    else:
        raise TypeError(f"{path}: {type(x).__name__} cannot be checkpointed")


def _kind(v: Any) -> str:
    if v is None:
        return "none"
    if isinstance(v, torch.Tensor):
        return "tensor"
    if isinstance(v, np.ndarray):
        return "array"
    return "bool" if isinstance(v, (bool, np.bool_)) else "int"


def _treedef(state) -> str:
    """The state's structure: every leaf's path and kind (not its shape, so
    the same config at another capacity has the same structure)."""
    return repr([(p, _kind(v)) for p, v in _leaves(state)])


def _rebuild(template: Any, values):
    """`template` with its leaves replaced, in `_leaves` order, from the
    iterator `values`."""
    if template is None or isinstance(template, (torch.Tensor, np.ndarray, bool, int,
                                                 np.integer, np.bool_)):
        return next(values)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), values)
                                for f in template._fields))
    return {k: _rebuild(template[k], values) for k in sorted(template)}


def _params_digest(params) -> str:
    """Digest of the model and routing parameters (the per-host routing rows
    are derived from the hashed tables and left out): same-shaped states
    driven by other parameters must not pass the guard."""
    params = params._replace(lat_rows=None, loss_rows=None, jit_rows=None)
    h = hashlib.sha256()
    for path, v in _leaves(params):
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            h.update(f"{path}:{a.dtype}:{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# EngineConfig fields that a checkpoint may differ in and still be re-seated
# through the migration ops (K25): the capacity shapes and the knobs derived
# from them. Everything else (model, parameters, policies, the queue layout
# kind, the wheel's presence) refuses.
_MIGRATABLE_CFG_FIELDS = ("queue_capacity", "queue_block", "sends_per_host_round",
                          "max_round_inserts", "microstep_limit", "wheel_slots", "wheel_block")


def _fingerprint(engine_cfg, treedef: str, params, migratable: bool = False) -> str:
    """sha256 of the whole EngineConfig, the state's structure and the
    parameters' digest; with `migratable`, the capacity-shape fields set
    to 0 (the cross-capacity guard). The device is not part of it: a
    checkpoint written on the card resumes on the CPU and back."""
    cfgd = dataclasses.asdict(engine_cfg)
    if migratable:
        for f in _MIGRATABLE_CFG_FIELDS:
            cfgd[f] = 0
    blob = json.dumps({"cfg": cfgd, "treedef": treedef, "params": _params_digest(params)},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _state_shape_meta(state) -> dict:
    """The state's actual shapes (escalation may have grown them past the
    configured ones)."""
    from shadow_tpu_torch.ops.events import BucketQueue

    q = state.queue
    meta = {
        "queue_capacity": int(q.t.shape[-1]),
        "queue_block": int(q.block) if isinstance(q, BucketQueue) else 0,
        "sends_per_host_round": int(state.outbox.t.shape[-1]),
    }
    if state.wheel is not None:
        meta["wheel_slots"] = int(state.wheel.t.shape[-1])
        meta["wheel_block"] = int(state.wheel.block)
    return meta


def _shaped_template(state, meta: dict):
    """`state` with the queue, outbox and wheel planes at the checkpoint's
    shapes: the reference the stored leaves are checked against."""
    from shadow_tpu_torch.core.engine import make_empty_outbox
    from shadow_tpu_torch.ops.events import BucketQueue, make_bucket_queue, make_queue
    from shadow_tpu_torch.ops.wheel import make_wheel

    if (meta["queue_block"] > 0) != isinstance(state.queue, BucketQueue):
        raise CheckpointError(
            "checkpoint queue layout (flat vs bucketed) does not match this simulation; "
            "migration cannot cross layout kinds")
    slots = int(meta.get("wheel_slots", 0))
    if (slots > 0) != (state.wheel is not None):
        raise CheckpointError(
            "checkpoint timer-wheel presence (on vs off) does not match this simulation; "
            "migration cannot cross the wheel boundary — rebuild with the same "
            "experimental.timer_wheel setting")
    h, dev = state.queue.t.shape[0], state.queue.t.device
    cap, block = meta["queue_capacity"], meta["queue_block"]
    queue = make_bucket_queue(h, cap, block, dev) if block else make_queue(h, cap, dev)
    state = state._replace(queue=queue,
                           outbox=make_empty_outbox(h, meta["sends_per_host_round"], dev))
    if slots:
        state = state._replace(wheel=make_wheel(h, slots, int(meta.get("wheel_block", 0)),
                                                dev))
    return state


def _restore_leaves(data, template):
    """The stored leaves, checked against `template`'s (shape and dtype),
    on the template's device, with the block caches of a bucketed queue
    and of the wheel rebuilt from the restored slabs (derived state is
    recomputed, never trusted from the file)."""
    from shadow_tpu_torch.ops.events import BucketQueue, bucket_rebuild

    values = []
    for i, (path, ref) in enumerate(_leaves(template)):
        key = f"leaf_{i}"
        if ref is None:
            values.append(None)
            continue
        if key not in data.files:
            raise CheckpointError(f"leaf {i} ({path}) missing from the checkpoint")
        arr = data[key]
        if isinstance(ref, torch.Tensor):
            want = (tuple(ref.shape), torch.empty(0, dtype=ref.dtype).numpy().dtype)
            if (arr.shape, arr.dtype) != want:
                raise CheckpointError(f"leaf {i} ({path}): shape/dtype mismatch")
            values.append(torch.from_numpy(np.array(arr)).to(ref.device))
        elif isinstance(ref, np.ndarray):
            if (arr.shape, arr.dtype) != (ref.shape, ref.dtype):
                raise CheckpointError(f"leaf {i} ({path}): shape/dtype mismatch")
            values.append(np.array(arr))
        else:
            values.append(type(ref)(arr.item()))
    out = _rebuild(template, iter(values))
    if isinstance(out.queue, BucketQueue):
        out = out._replace(queue=bucket_rebuild(out.queue, out.queue.block))
    if out.wheel is not None:
        out = out._replace(wheel=bucket_rebuild(out.wheel, out.wheel.block))
    return out


def _live_max(q) -> int:
    from shadow_tpu_torch.ops.events import q_len

    return int(q_len(q).max())


def _migrate_restored(state, sim):
    """Re-seat a restored state, at the checkpoint's shapes, at the target
    sim's through the migration ops (K25, then K8 for a bucketed queue).
    Refuses exactly where migration would lose information: live events
    that do not fit the target capacity, or outbox entries in flight.
    Under the escalate policy a checkpoint written at a grown shape
    resumes at that shape."""
    from shadow_tpu_torch.core.engine import make_empty_outbox
    from shadow_tpu_torch.ops.events import migrate_queue, migration_fits
    from shadow_tpu_torch.ops.wheel import migrate_wheel, resolve_wheel_block
    from shadow_tpu_torch.simtime import TIME_MAX

    cfg = sim.engine_cfg
    escalating = sim.cfg.pressure.policy == "escalate"
    cap = int(state.queue.t.shape[-1])
    budget = int(state.outbox.t.shape[-1])
    target_cap = max(cfg.queue_capacity, cap) if escalating else cfg.queue_capacity
    target_budget = (max(cfg.sends_per_host_round, budget) if escalating
                     else cfg.sends_per_host_round)
    if cap != target_cap or (getattr(state.queue, "block", 0) or 0) != cfg.queue_block:
        if cap > target_cap and not bool(migration_fits(state.queue, target_cap).all()):
            occ = _live_max(state.queue)
            raise CheckpointError(
                f"cannot resume at queue capacity {target_cap}: the checkpoint holds up to "
                f"{occ} live events per host (written at capacity {cap}) — resume at >= "
                f"{occ} slots")
        state = state._replace(queue=migrate_queue(state.queue, target_cap, cfg.queue_block))
    if budget != target_budget:
        if bool((state.outbox.t != TIME_MAX).any()):
            raise CheckpointError(
                "checkpoint carries in-flight outbox entries; a different send budget "
                "cannot re-seat them (this never happens for chunk-boundary checkpoints)")
        state = state._replace(outbox=make_empty_outbox(
            state.outbox.t.shape[0], target_budget, state.outbox.t.device))
    w = state.wheel
    if w is not None:
        slots = cfg.wheel_slots
        block = resolve_wheel_block(slots, cfg.wheel_block)
        if int(w.t.shape[-1]) != slots or int(w.block) != block:
            if int(w.t.shape[-1]) > slots and not bool(migration_fits(w, slots).all()):
                occ = _live_max(w)
                raise CheckpointError(
                    f"cannot resume at wheel_slots {slots}: the checkpoint holds up to "
                    f"{occ} live timers per host (written at {int(w.t.shape[-1])} slots) — "
                    f"resume at >= {occ} slots")
            state = state._replace(wheel=migrate_wheel(w, slots, cfg.wheel_block))
    return state


def save_checkpoint(path: str, sim, state=None) -> str:
    """Write `state` (default `sim.state`) of a `Simulation` as one .npz:
    every leaf as a numpy array (`leaf_<i>` in `_leaves` order), the exact
    guard (`__guard__`), the cross-capacity guard (`__guard_migrate__`) and
    the state's shapes (`__shape__`, JSON). Returns the file name (".npz"
    appended where missing)."""
    state = sim.state if state is None else state
    td = _treedef(state)
    arrays = {}
    for i, (_, v) in enumerate(_leaves(state)):
        if v is None:
            continue
        arrays[f"leaf_{i}"] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))

    def text(s: str) -> np.ndarray:
        return np.frombuffer(s.encode(), dtype=np.uint8)

    arrays["__guard__"] = text(_fingerprint(sim.engine_cfg, td, sim.params))
    arrays["__guard_migrate__"] = text(_fingerprint(sim.engine_cfg, td, sim.params, True))
    arrays["__shape__"] = text(json.dumps(_state_shape_meta(state), sort_keys=True))
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrays)
    return path


def load_checkpoint(path: str, sim) -> None:
    """Restore a checkpoint into a freshly built `Simulation` (on any
    device). The config must match exactly, except the capacity shapes
    (`_MIGRATABLE_CFG_FIELDS`): a checkpoint written at capacity C resumes
    into a simulation built at C' through the migration ops, refusing only
    where migration would lose information (live events past C', outbox
    entries in flight) or cross the queue's layout kind."""
    with np.load(path, allow_pickle=False) as data:
        td = _treedef(sim.state)
        got = bytes(data["__guard__"]).decode()
        meta = json.loads(bytes(data["__shape__"]).decode())
        if got == _fingerprint(sim.engine_cfg, td, sim.params) and \
                meta == _state_shape_meta(sim.state):
            sim.state = _restore_leaves(data, sim.state)
            return
        got_m = bytes(data["__guard_migrate__"]).decode()
        if got_m != _fingerprint(sim.engine_cfg, td, sim.params, True):
            raise CheckpointError(
                "checkpoint does not match this simulation (different config, model, or "
                "engine version — beyond the migratable capacity shapes)")
        restored = _restore_leaves(data, _shaped_template(sim.state, meta))
    sim.state = _migrate_restored(restored, sim)


# --------------------------------------------------------------------------
# ensemble checkpoints
# --------------------------------------------------------------------------


def ensemble_fingerprint(engine_cfg, state, params, replica_meta) -> str:
    """Guard record of a campaign checkpoint (the JAX package's): the
    reconciled EngineConfig, the folded state's structure, the folded
    params' digest and the replicas' metadata (labels, seeds, schedules),
    so a checkpoint of one campaign refuses to restore into a differently
    composed one even where the shapes match."""
    blob = json.dumps({
        "cfg": dataclasses.asdict(engine_cfg),
        "treedef": _treedef(state),
        "params": _params_digest(params),
        "replicas": replica_meta,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def save_ensemble_checkpoint(path: str, state, fingerprint: str) -> str:
    """Write a folded ensemble state as one .npz (the solo layout: every
    leaf as `leaf_<i>`) guarded by `ensemble_fingerprint`. Returns the file
    name (".npz" appended where missing)."""
    arrays = {}
    for i, (_, v) in enumerate(_leaves(state)):
        if v is None:
            continue
        arrays[f"leaf_{i}"] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    arrays["__guard__"] = np.frombuffer(fingerprint.encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrays)
    return path


def load_ensemble_checkpoint(path: str, state, fingerprint: str):
    """Restore a folded ensemble state saved by `save_ensemble_checkpoint`
    into a freshly built campaign of the same composition; `state` is its
    fresh folded state (the template). Bucket caches are rebuilt from the
    restored slabs, as on the solo path."""
    with np.load(path, allow_pickle=False) as data:
        if bytes(data["__guard__"]).decode() != fingerprint:
            raise CheckpointError(
                "ensemble checkpoint does not match this campaign (different "
                "config, replica composition, or engine version)")
        return _restore_leaves(data, state)
