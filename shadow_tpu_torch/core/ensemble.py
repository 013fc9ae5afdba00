"""The ensemble plane: R replicas of one configuration advanced as one folded
round loop (port of shadow_tpu/core/ensemble.py).

The JAX package stacks R replicas' state along a leading axis and vmaps its
chunk body. The port folds the replica axis into the host axis instead:
replica r's hosts are rows [r * H, (r + 1) * H) of every per-host plane
(queue, RNG, token buckets, CoDel, model state, outbox, per-host stats), so
each kernel of a round launches ONCE for all R x H rows, and one host read
per round and per loop test carries every replica's lanes (K31,
ops/ensemble.py). What amortizes is exactly the port's fixed cost per
launch and per host sync. Host ids stay replica-local, so replica r is bit
for bit its solo run: its digest, events, every drop and fault counter,
rounds and microsteps (core/engine.py, `EngineConfig.replicas`).

State: per-host leaves are concatenated ([R x H, ...]); the solo state's
[1] counters and its 0-d scalars (`stats.rounds`, `min_used_lat`) become
[R] lanes; `now` and `done` become int64 and bool numpy arrays [R].

Params (`stack_params`): the routing tables ([N, N], `node_of` and the
per-host route rows) are kept once: the kernels index them by the
replica-local id, and a replica whose tables differ is refused, naming the
leaf. The per-host leaves the kernels index by row (token-bucket params,
the model's param lanes) are laid out per row, R x H, identical or not.
Fault windows are reconciled to common dims as in the JAX package: crash
windows [H, W] concatenate to [R x H, W], link-fault windows [L] stack to
[R, L].

What may vary per replica: array values only (seeds, fault schedules,
model arguments and bandwidths). Every EngineConfig static must match, with
the JAX package's message. Scope: one device (world 1), and not the fluid
plane, the integrity sentinel, the pressure plane, merge gears or the
observatories (`EngineConfig.replicas` refuses them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from shadow_tpu_torch.config.options import ConfigError
from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
from shadow_tpu_torch.core.engine import Engine, EngineConfig, EngineParams, SimState
from shadow_tpu_torch.core.faults import LAT_SCALE, FaultParams
from shadow_tpu_torch.ops.ensemble import replica_fold
from shadow_tpu_torch.simtime import TIME_MAX

# fields EngineConfig may differ in across replicas before reconciliation
# (the JAX package's list): the fault dims, padded to a common maximum, and
# the restart-queue policy, which must agree among replicas with crashes
_RECONCILED_FIELDS = (
    "fault_crash_windows",
    "fault_loss_windows",
    "fault_queue_clear",
)

# the solo state's [1] counters (_LANE_LEAVES) and 0-d scalars
# (_SCALAR_LEAVES), which fold into [R] lanes; every other tensor is per host
_LANE_LEAVES = frozenset({"outbox.count"} | {f"stats.{f}" for f in (
    "ob_dropped", "microsteps", "bq_rebuilds", "popk_deferred", "outbox_hwm", "gear_shed",
    "integrity", "iv_mask", "iv_round", "pressure", "ec_timer", "ec_pkt", "ec_app", "fl_done",
    "fl_bytes", "fl_rtx", "win_bound", "a2a_shed", "ici_bytes", "ici_intra", "ici_inter")})
_SCALAR_LEAVES = frozenset({"min_used_lat", "stats.rounds", "stats.fl_bg_bytes",
                            "stats.fl_bg_dropped"})

# the per-host counters the ledger sums, in its row order, with the ledger key
_LEDGER_SUMS = (
    ("events_processed", "events"),
    ("packets_sent", "pkts_sent"),
    ("packets_delivered", "pkts_delivered"),
    ("packets_lost", "pkts_lost"),
    ("packets_unreachable", "pkts_unreachable"),
    ("packets_codel_dropped", "pkts_codel_dropped"),
    ("packets_budget_dropped", "pkts_budget_dropped"),
    ("queue_overflow_dropped", None),  # queue.dropped
    ("faults_dropped", "faults_dropped"),
    ("faults_delayed", "faults_delayed"),
    ("monotonic_violations", "monotonic_violations"),
)


# ------------------------------------------------------------ state layout


def _fold_tree(xs: list, path: str = ""):
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, torch.Tensor):
        return torch.stack(xs) if x0.dim() == 0 else torch.cat(xs)
    if isinstance(x0, tuple) and hasattr(x0, "_fields"):
        return type(x0)(*(_fold_tree([getattr(x, f) for x in xs], f"{path}.{f}" if path else f)
                          for f in x0._fields))
    if isinstance(x0, dict):
        return {k: _fold_tree([x[k] for x in xs], f"{path}.{k}") for k in x0}
    if all(x == x0 for x in xs):
        return x0
    raise ConfigError(f"ensemble replicas differ in the static state field {path}")


def fold_states(states: Sequence[SimState]) -> SimState:
    """R solo states -> one folded state (module docstring)."""
    folded = _fold_tree([s._replace(now=0, done=False) for s in states])
    return folded._replace(now=np.array([int(s.now) for s in states], np.int64),
                           done=np.array([bool(s.done) for s in states], bool))


def tree_index(state: SimState, r: int) -> SimState:
    """Replica r's solo view of a folded state (views, not copies): its
    rows of every per-host leaf, its [1] lane of each counter, its 0-d
    scalars, and `now` and `done` as host scalars."""
    reps = len(state.done)

    def walk(x, path):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            if path in _LANE_LEAVES:
                return x[r:r + 1]
            if path in _SCALAR_LEAVES:
                return x[r]
            h = x.shape[0] // reps
            return x[r * h:(r + 1) * h]
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(getattr(x, f), f"{path}.{f}" if path else f)
                             for f in x._fields))
        if isinstance(x, dict):
            return {k: walk(v, f"{path}.{k}") for k, v in x.items()}
        return x

    out = walk(state._replace(now=None, done=None), "")
    return out._replace(now=int(state.now[r]), done=bool(state.done[r]))


# ------------------------------------------------------------ params


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a.cpu(), b.cpu()))


def stack_params(params_list: Sequence[EngineParams], num_hosts: int, labels=None):
    """One EngineParams for R replicas (module docstring): the routing
    tables once (refused where a replica's differ), the token-bucket and
    model param lanes per row, the fault arrays per replica. `labels` name
    the replicas in a refusal."""
    p0 = params_list[0]

    def who(i):
        return f"replica {i}" + (f" ({labels[i]})" if labels else "")

    for i, p in enumerate(params_list[1:], start=1):
        for f in ("node_of", "lat_ns", "loss", "jitter_ns", "lat_rows", "loss_rows",
                  "jit_rows"):
            if not _equal(getattr(p0, f), getattr(p, f)):
                raise ConfigError(
                    f"ensemble replicas must share the routing tables: {who(i)} differs from "
                    f"replica 0 in EngineParams.{f} (the kernels read the tables by the "
                    f"replica-local host id; vary seeds, faults or per-host arguments, or run "
                    f"that override as its own campaign)")
    model = {}
    for k, v in p0.model.items():
        vs = [p.model[k] for p in params_list]
        if v.dim() >= 1 and v.shape[0] == num_hosts:
            model[k] = torch.cat(vs)
        elif all(_equal(v, x) for x in vs[1:]):
            model[k] = v
        else:
            bad = next(i for i, x in enumerate(vs) if not _equal(v, x))
            raise ConfigError(
                f"ensemble replicas differ in the model parameter {k!r} ({who(bad)}), which "
                f"has no host axis to lay out per row; run that override as its own campaign")
    faults = None
    if p0.faults is not None:
        fps = [p.faults for p in params_list]
        crash = [torch.cat([getattr(fp, f) for fp in fps]) if fps[0].down_t is not None
                 else None for f in ("down_t", "up_t")]
        wins = [torch.stack([getattr(fp, f) for fp in fps]) if fps[0].win_start is not None
                else None for f in ("win_start", "win_end", "win_loss", "win_lat")]
        faults = FaultParams(*crash, *wins)
    return p0._replace(
        eg_tb=type(p0.eg_tb)(*(torch.cat(xs) for xs in zip(*(p.eg_tb for p in params_list)))),
        in_tb=type(p0.in_tb)(*(torch.cat(xs) for xs in zip(*(p.in_tb for p in params_list)))),
        model=model,
        faults=faults,
    )


# ------------------------------------------------------ fault reconciliation


def _pad_fault_params(fp: FaultParams | None, w: int, l: int, num_hosts: int,
                      device) -> FaultParams | None:
    """Pad one replica's fault arrays to W crash windows and L loss windows
    (the JAX package's exact padding: a [TIME_MAX, TIME_MAX) crash window
    holds no time; a [0, 0) loss window is never active, with loss 0 and
    latency x1.0; the fault-loss draw count depends only on L > 0)."""
    if w == 0 and l == 0:
        return None
    down_t = up_t = win_start = win_end = win_loss = win_lat = None
    if w:
        if fp is not None and fp.down_t is not None:
            have = fp.down_t.shape[1]
            pad = torch.full((num_hosts, w - have), TIME_MAX, dtype=torch.int64, device=device)
            down_t = torch.cat([fp.down_t, pad], dim=1) if have < w else fp.down_t
            up_t = torch.cat([fp.up_t, pad], dim=1) if have < w else fp.up_t
        else:
            down_t = torch.full((num_hosts, w), TIME_MAX, dtype=torch.int64, device=device)
            up_t = torch.full((num_hosts, w), TIME_MAX, dtype=torch.int64, device=device)
    if l:
        # the mixing rule is enforced upstream: every replica has a window
        have = fp.win_start.shape[0]
        pad = l - have

        def fill(x, v, dt):
            return torch.cat([x, torch.full((pad,), v, dtype=dt, device=device)]) if pad else x

        win_start = fill(fp.win_start, 0, torch.int64)
        win_end = fill(fp.win_end, 0, torch.int64)
        win_loss = fill(fp.win_loss, 0.0, torch.float32)
        win_lat = fill(fp.win_lat, LAT_SCALE, torch.int64)
    return FaultParams(down_t, up_t, win_start, win_end, win_loss, win_lat)


def reconcile_fault_statics(
    cfgs: Sequence[EngineConfig], params_list: Sequence[EngineParams], device="cpu",
) -> tuple[EngineConfig, list[EngineParams]]:
    """One EngineConfig + per-replica padded params for a mixed-schedule
    campaign, with the JAX package's rules and messages: every other static
    must match; loss-window presence may not mix; replicas with crash
    windows share one restart_queue policy."""
    base = cfgs[0]
    for i, c in enumerate(cfgs[1:], start=1):
        norm = {f: 0 for f in _RECONCILED_FIELDS}
        if dataclasses.replace(c, **norm) != dataclasses.replace(base, **norm):
            diffs = [
                f.name
                for f in dataclasses.fields(base)
                if f.name not in _RECONCILED_FIELDS
                and getattr(c, f.name) != getattr(base, f.name)
            ]
            raise ConfigError(
                f"ensemble replicas must share every EngineConfig static "
                f"(replica {i} differs from replica 0 in {diffs}); "
                f"per-replica variation is array VALUES only — seeds, "
                f"fault schedules, numeric params"
            )
    ls = [c.fault_loss_windows for c in cfgs]
    if any(ls) and not all(ls):
        raise ConfigError(
            "ensemble replicas must agree on loss-window PRESENCE: "
            "fault_loss_windows > 0 traces one extra RNG draw per send, "
            "so mixing faulty and fault-free link schedules in one "
            "vmapped program would shift the fault-free replicas' RNG "
            "streams off their solo runs — split the campaign, or give "
            "every replica at least one loss window"
        )
    w = max(c.fault_crash_windows for c in cfgs)
    l = max(ls)
    clears = {c.fault_queue_clear for c in cfgs if c.fault_crash_windows > 0}
    if len(clears) > 1:
        raise ConfigError(
            "ensemble replicas with crash windows must share one "
            "restart_queue policy (hold vs clear is a trace-time static)"
        )
    clear = clears.pop() if clears else base.fault_queue_clear
    common = dataclasses.replace(
        base,
        fault_crash_windows=w,
        fault_loss_windows=l,
        fault_queue_clear=clear if w else base.fault_queue_clear,
    )
    h = common.hosts_per_shard
    padded = [p._replace(faults=_pad_fault_params(p.faults, w, l, h, device))
              for p in params_list]
    return common, padded


# ------------------------------------------------------------ the engine


class EnsembleEngine:
    """R replicas of one EngineConfig advanced by the folded round loop.
    Built via `build_ensemble`; `run_chunk(state)` advances every replica
    one chunk (frozen replicas keep their carries bit for bit)."""

    def __init__(self, cfg: EngineConfig, model, device="cpu"):
        if cfg.world != 1:
            raise ConfigError(
                f"the ensemble plane runs world=1 this round (got world="
                f"{cfg.world}): a replica axis over a device mesh is a 2-D "
                f"mesh program — shard the campaign across processes, or "
                f"drop general.parallelism to 1"
            )
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.num_replicas = 0
        self.engine: Engine | None = None
        self._params: EngineParams | None = None

    def build(self, states: Sequence[SimState], params_list: Sequence[EngineParams],
              labels=None) -> SimState:
        """Fold R per-replica (state, params) pairs; returns the folded
        state."""
        if len(states) != len(params_list) or not states:
            raise ConfigError("ensemble needs >= 1 (state, params) pair")
        self.num_replicas = len(states)
        try:
            self.engine = Engine(dataclasses.replace(self.cfg, replicas=self.num_replicas),
                                 self.model, self.device)
        except ValueError as e:
            raise ConfigError(f"ensemble: {e}") from e
        self._params = stack_params(params_list, self.cfg.hosts_per_shard, labels)
        return fold_states(states)

    @property
    def host_syncs(self) -> int:
        return self.engine.host_syncs

    def run_chunk(self, state: SimState) -> SimState:
        return self.engine.run_chunk(state, self._params)


def build_ensemble(model, replicas: Sequence[tuple[EngineConfig, SimState, EngineParams]],
                   device="cpu", labels=None) -> tuple[EnsembleEngine, SimState]:
    """(EnsembleEngine, folded state) from per-replica built sims: each
    tuple is one replica's (engine config, t = 0 state, params) exactly as
    `Engine.init_state` returns them for its solo run. Fault statics are
    reconciled here; every other static must already match."""
    cfgs = [c for c, _, _ in replicas]
    states = [s for _, s, _ in replicas]
    common, padded = reconcile_fault_statics(cfgs, [p for _, _, p in replicas], device)
    ens = EnsembleEngine(common, model, device)
    return ens, ens.build(states, padded, labels)


# ------------------------------------------------------------ ledger helpers


def _reps(state: SimState) -> int:
    return len(state.done)


def replica_digest_arrays(state: SimState, num_real: int | None = None) -> np.ndarray:
    """Per-replica per-host digest planes, np.uint64[R, n]."""
    r = _reps(state)
    d = state.stats.digest.cpu().numpy().view(np.uint64).reshape(r, -1)
    return d[:, : (num_real or d.shape[1])]


def replica_digest_sigs(state: SimState, num_real: int | None = None) -> np.ndarray:
    """Per-replica xor-folded digest signatures, np.uint64[R] (K32 over the
    digest plane; one launch and one read)."""
    out = replica_fold(state.stats.digest, [], _reps(state), num_real)
    return out[:, 0].cpu().numpy().view(np.uint64)


def replica_ledger(state: SimState, num_real: int | None = None, labels=None) -> list[dict]:
    """Per-replica ledger rows (the JAX package's keys): the digest and the
    per-host counters folded by K32 in one launch, with the [R] lanes and
    the host arrays, read in one copy each."""
    s = state.stats
    r_count = _reps(state)
    # the fault counters exist only with the fault plane on (0 otherwise)
    lanes = {k: state.queue.dropped if f is None else getattr(s, f) for k, f in _LEDGER_SUMS}
    lanes = {k: v for k, v in lanes.items() if v is not None}
    folded = replica_fold(s.digest, list(lanes.values()), r_count, num_real).cpu().numpy()
    rounds = s.rounds.cpu().numpy().reshape(r_count, -1).sum(1)
    msteps = s.microsteps.cpu().numpy().reshape(r_count, -1).sum(1)
    rows = []
    for r in range(r_count):
        sums = dict(zip(lanes, (int(v) for v in folded[r, 1:])))
        rows.append({
            "replica": r,
            **({"label": labels[r]} if labels else {}),
            "digest": f"{int(folded[r, 0]) & ((1 << 64) - 1):016x}",
            "rounds": int(rounds[r]),
            "done": bool(state.done[r]),
            "simulated_seconds": float(state.now[r]) / 1e9,
            **{k: sums.get(k, 0) for k, _ in _LEDGER_SUMS},
            "microsteps": int(msteps[r]),
        })
    return rows


# ------------------------------------------------------------ bisection


def pair_digests_equal(state: SimState, pair: tuple[int, int],
                       num_real: int | None = None) -> bool:
    """Full-array digest equality between two replicas (the authoritative
    expected-identical check, not the xor fold)."""
    d = replica_digest_arrays(state, num_real)
    i, j = pair
    return bool(np.array_equal(d[i], d[j]))


def bisect_divergence(run_chunk, state0: SimState, pair: tuple[int, int], *, hi: int,
                      num_real: int | None = None, log=None) -> int:
    """First chunk (1-based) after which replicas `pair` carry different
    digests, by binary search over chunk boundaries from a pre-run snapshot
    (the JAX package's `bisect_divergence`: the engine is deterministic, so
    re-running k chunks from the chunk-0 snapshot reproduces the prefix,
    and diverged digests never re-converge; the search keeps a snapshot at
    the highest chunk known equal, so replay work is at most 2 x hi
    chunks). Preconditions: the pair is equal in `state0` and divergent
    after `hi` chunks. `run_chunk` may consume its input."""
    if not pair_digests_equal(state0, pair, num_real):
        raise ValueError(f"bisect_divergence: pair {pair} already divergent at chunk 0")
    lo, hi_k = 0, int(hi)
    snap_lo = snapshot_state(state0)
    while hi_k - lo > 1:
        mid = (lo + hi_k) // 2
        st = restore_snapshot(snap_lo)
        for _ in range(mid - lo):
            st = run_chunk(st)
        if pair_digests_equal(st, pair, num_real):
            lo = mid
            snap_lo = snapshot_state(st)
        else:
            hi_k = mid
        if log is not None:
            print(f"[bisect] pair {pair}: chunk {mid} "
                  f"{'equal' if lo == mid else 'divergent'} (window now ({lo}, {hi_k}])",
                  file=log)
    return hi_k

