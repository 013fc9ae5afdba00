"""State carried across from the JAX package (this system has no weights:
what carries over is the engine's parameters and its simulation state).

`from_jax_numpy` takes the JAX engine's `EngineParams` / `SimState` pytrees
with every leaf already a numpy array (`jax.device_get`) and returns the
port's `(params, state)` on the requested device; uint64 lanes (RNG state,
digests) are reinterpreted bit for bit as int64, and uint32 lanes (tgen's
reassembly bitmap) are widened to int64 holding 0..2^32-1. A flat queue
comes across as `EventQueue`, a bucketed one (with its bt/bo/bfill caches)
as `BucketQueue`, and a timer wheel (with its `wheel_spilled` and
`wheel_occ_hwm` stats lanes) as the port's wheel. `engine_config_from` maps a
JAX `EngineConfig` onto the port's (merge gear and scatter merge included),
refusing any knob the port does not run.
`to_numpy` flattens either package's state into {"queue.t": array, ...} for a
field-by-field comparison. Nothing here imports JAX: the inputs are read by
attribute name only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch.config.options import ConfigError
from shadow_tpu_torch.core.engine import (
    EngineConfig,
    EngineParams,
    Outbox,
    SimState,
    Stats,
)
from shadow_tpu_torch.net import CodelState, TBParams, TBState
from shadow_tpu_torch.ops.events import BucketQueue, EventQueue
from shadow_tpu_torch.ops.rng import RngState

# JAX EngineConfig fields of planes this port does not run, with their "off"
# value
_OFF_FIELDS = {
    "world": 1,
    "trace_rounds": 0,
    "fault_crash_windows": 0,
    "fault_loss_windows": 0,
    "pressure_abort": False,
    "netobs": False,
    "integrity": False,
    "merge_rows": 0,
    "cpu_delay_ns": 0,
    "fluid_classes": 0,
}


def engine_config_from(jcfg) -> EngineConfig:
    """The port's EngineConfig for a JAX EngineConfig of this slice."""
    for name, off in _OFF_FIELDS.items():
        if getattr(jcfg, name, off) != off:
            raise ConfigError(
                f"EngineConfig.{name}={getattr(jcfg, name)!r} is not supported "
                f"by the PyTorch port yet"
            )
    return EngineConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(EngineConfig)
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
        model=_tree(s.model if model_state is None else model_state, device),
        outbox=Outbox(*(_t(getattr(s.outbox, f), device) for f in Outbox._fields)),
        stats=Stats(*(_opt(getattr(s.stats, f, None), device) for f in Stats._fields)),
        wheel=None if getattr(s, "wheel", None) is None else _bq(s.wheel, device),
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
    for g, (obj, fields) in groups.items():
        for f in fields:
            v = getattr(obj, f, None)
            if v is not None:
                out[f"{g}.{f}"] = _np(v)
    for k, v in state.model.items():
        out[f"model.{k}"] = _np(v)
    return out
