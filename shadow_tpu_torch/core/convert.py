"""State carried across from the JAX package (this system has no weights:
what carries over is the engine's parameters and its simulation state).

`from_jax_numpy` takes the JAX engine's `EngineParams` / `SimState` pytrees
with every leaf already a numpy array (`jax.device_get`) and returns the
port's `(params, state)` on the requested device; uint64 lanes (RNG state,
digests) are reinterpreted bit for bit as int64, and uint32 lanes (tgen's
reassembly bitmap) are widened to int64 holding 0..2^32-1. A flat queue
comes across as `EventQueue`, a bucketed one (with its bt/bo/bfill caches)
as `BucketQueue`, a timer wheel (with its `wheel_spilled` and
`wheel_occ_hwm` stats lanes) as the port's wheel, the fluid plane's
`FluidParams`, `FluidState` and `fl_bg_*` stats lanes as the port's, the
fault plane's `FaultParams` and counters, and the integrity sentinel's
lanes (`integrity`, `iv_mask`, `iv_round`, `digest2`, uint64 bit for bit)
the pressure plane's `pressure` lane, and the observatories' lanes
(`ec_*`, `fl_*`, `win_bound`) with the trace ring and the flow ledger
(`trace`, `flows`). Model params and state may nest (the mixed plane's
`inner` dict, its capture rings and `global_is_native` table come across
as they are). Queue and outbox planes come
across at whatever shape they have, so an escalated state keeps its grown
capacity and send budget.
`engine_config_from` maps a JAX `EngineConfig` onto the port's (merge gear,
scatter merge, merge-row bound, CPU delay, fluid, fault, integrity,
pressure and observatory knobs and the mesh's world and exchange
included), for one rank of its mesh.
`to_numpy` flattens either package's state into {"queue.t": array, ...} for a
field-by-field comparison; the fault counters, which the JAX package always
carries, read as zeros where the port's plane is off. Nothing here imports
JAX: the inputs are read by attribute name only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch.core.faults import FaultParams
from shadow_tpu_torch.core.engine import (
    EngineConfig,
    EngineParams,
    Outbox,
    SimState,
    Stats,
)
from shadow_tpu_torch.net import CodelState, TBParams, TBState
from shadow_tpu_torch.net.fluid import FluidParams, FluidState
from shadow_tpu_torch.obs.netobs import FlowLedger
from shadow_tpu_torch.obs.tracer import TraceRing
from shadow_tpu_torch.ops.events import BucketQueue, EventQueue
from shadow_tpu_torch.ops.rng import RngState

# stats lanes the JAX package carries (as zeros) with their plane off
_ZERO_WHEN_OFF = ("faults_dropped", "faults_delayed")


def engine_config_from(jcfg, rank: int = 0) -> EngineConfig:
    """The port's EngineConfig for a JAX EngineConfig of this slice (rank
    `rank` of its mesh: the JAX config has no rank; one replica: the JAX
    ensemble keeps its replicas outside the config)."""
    return EngineConfig(rank=rank, **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(EngineConfig)
        if f.name not in ("rank", "replicas")
    })


def _t(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def _opt(a, device):
    return None if a is None else _t(a, device)


def _bq(q, device) -> BucketQueue:
    return BucketQueue(*(_t(getattr(q, f), device) for f in BucketQueue._fields))


def _tree(x, device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _t(x, device)


def params_from_jax_numpy(engine_params, model_params=None, *, device) -> EngineParams:
    """The port's EngineParams from the JAX package's numpy `EngineParams`;
    `model_params` defaults to `engine_params.model`."""
    p = engine_params
    return EngineParams(
        node_of=_t(p.node_of, device),
        lat_ns=_t(p.lat_ns, device),
        loss=_t(p.loss, device),
        jitter_ns=_t(p.jitter_ns, device),
        eg_tb=TBParams(_t(p.eg_tb.capacity, device), _t(p.eg_tb.refill, device)),
        in_tb=TBParams(_t(p.in_tb.capacity, device), _t(p.in_tb.refill, device)),
        model=_tree(p.model if model_params is None else model_params, device),
        lat_rows=_tree(p.lat_rows, device),
        loss_rows=_tree(p.loss_rows, device),
        jit_rows=_tree(p.jit_rows, device),
        fluid=(None if getattr(p, "fluid", None) is None
               else FluidParams(*(_t(getattr(p.fluid, f), device) for f in FluidParams._fields))),
        faults=(None if getattr(p, "faults", None) is None
                else FaultParams(*(_opt(getattr(p.faults, f), device)
                                   for f in FaultParams._fields))),
    )


def state_from_jax_numpy(sim_state, model_state=None, *, device) -> SimState:
    """The port's SimState from the JAX package's numpy `SimState`;
    `model_state` defaults to `sim_state.model`."""
    s = sim_state
    queue = (_bq(s.queue, device) if hasattr(s.queue, "bt")
             else EventQueue(*(_t(getattr(s.queue, f), device) for f in EventQueue._fields)))
    return SimState(
        now=int(s.now),
        done=bool(s.done),
        queue=queue,
        rng=RngState(_t(s.rng.s, device)),
        seq=_t(s.seq, device),
        sent_round=_t(s.sent_round, device),
        tb_egress=TBState(_t(s.tb_egress.tokens, device), _t(s.tb_egress.last_itv, device)),
        tb_ingress=TBState(_t(s.tb_ingress.tokens, device), _t(s.tb_ingress.last_itv, device)),
        codel=CodelState(*(_t(getattr(s.codel, f), device) for f in CodelState._fields)),
        min_used_lat=_t(s.min_used_lat, device),
        cpu_busy_until=_t(s.cpu_busy_until, device),
        model=_tree(s.model if model_state is None else model_state, device),
        outbox=Outbox(*(_t(getattr(s.outbox, f), device) for f in Outbox._fields)),
        stats=Stats(*(_opt(getattr(s.stats, f, None), device) for f in Stats._fields)),
        wheel=None if getattr(s, "wheel", None) is None else _bq(s.wheel, device),
        fluid=(None if getattr(s, "fluid", None) is None
               else FluidState(*(_t(getattr(s.fluid, f), device) for f in FluidState._fields))),
        trace=(None if getattr(s, "trace", None) is None
               else TraceRing(_t(s.trace.rows, device), _t(s.trace.cursor, device))),
        flows=(None if getattr(s, "flows", None) is None
               else FlowLedger(_t(s.flows.rows, device), _t(s.flows.cursor, device))),
    )


def from_jax_numpy(engine_params, sim_state, model_params=None, model_state=None,
                   *, device) -> tuple[EngineParams, SimState]:
    """(params, state) of the port from the JAX package's numpy pytrees."""
    return (
        params_from_jax_numpy(engine_params, model_params, device=device),
        state_from_jax_numpy(sim_state, model_state, device=device),
    )


def _np(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    a = np.asarray(v)
    if a.dtype == np.uint32:
        return a.astype(np.int64)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten a port SimState — or a JAX SimState already fetched to numpy —
    into {"field.path": numpy array} over the fields this slice carries
    (lanes that are None, such as the wheel's when it is off, are left
    out)."""
    out: dict[str, np.ndarray] = {
        "now": np.int64(int(state.now)),
        "done": np.bool_(bool(state.done)),
        "rng.s": _np(state.rng.s),
        "seq": _np(state.seq),
        "sent_round": _np(state.sent_round),
        "min_used_lat": _np(state.min_used_lat),
        "cpu_busy_until": _np(state.cpu_busy_until),
    }
    groups = {
        "queue": (state.queue, BucketQueue._fields if hasattr(state.queue, "bt")
                  else EventQueue._fields),
        "tb_egress": (state.tb_egress, TBState._fields),
        "tb_ingress": (state.tb_ingress, TBState._fields),
        "codel": (state.codel, CodelState._fields),
        "outbox": (state.outbox, Outbox._fields),
        "stats": (state.stats, Stats._fields),
    }
    if getattr(state, "wheel", None) is not None:
        groups["wheel"] = (state.wheel, BucketQueue._fields)
    if getattr(state, "fluid", None) is not None:
        groups["fluid"] = (state.fluid, FluidState._fields)
    if getattr(state, "trace", None) is not None:
        groups["trace"] = (state.trace, TraceRing._fields)
    if getattr(state, "flows", None) is not None:
        groups["flows"] = (state.flows, FlowLedger._fields)
    for g, (obj, fields) in groups.items():
        for f in fields:
            v = getattr(obj, f, None)
            if v is None and g == "stats" and f in _ZERO_WHEN_OFF:
                v = np.zeros_like(_np(state.stats.events))
            if v is not None:
                out[f"{g}.{f}"] = _np(v)
    _flat_model(state.model, "model", out)
    return out


def _flat_model(tree: dict, prefix: str, out: dict) -> None:
    """Model state lanes into `out` as "model.lane", a nested dict's (the
    mixed plane's inner model) as "model.inner.lane"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat_model(v, f"{prefix}.{k}", out)
        else:
            out[f"{prefix}.{k}"] = _np(v)
