"""Vectorized host-model interface (port of shadow_tpu/models/base.py).

A model's `handle` runs once per microstep for ALL hosts, with per-host
masks selecting who is active. Its contract is the JAX package's:

  - RNG draws go through ops.rng with mask = the hosts consuming the draw;
  - state updates are masked by `ctx.active`;
  - at most one event per host per microstep; emission ports
    (`HandlerOut.pushes` / `.sends`) are a fixed tuple per model.

Model params and state are dicts of [H, ...] tensors on the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Protocol

import torch

from shadow_tpu_torch.ops.rng import RngState

# Event-kind space: models use kinds 0..KIND_MASK; the engine owns flag bits.
KIND_MASK = 0xFFFF
KIND_PKT = 1 << 16  # event is a packet arrival (set by the engine at send)
KIND_INGRESS_DONE = 1 << 17  # packet already passed ingress shaping

# Packet payload convention: word 0 = size in bytes (engine-owned); words
# 1..3 are model-defined.
PAYLOAD_SIZE_WORD = 0


@dataclasses.dataclass
class HandlerCtx:
    t: torch.Tensor  # i64[H] event time (valid where active)
    window_end: int  # current round end
    kind: torch.Tensor  # i32[H] model kind (engine flags stripped)
    payload: torch.Tensor  # i32[H, P]
    active: torch.Tensor  # bool[H] host handles an event this microstep
    is_packet: torch.Tensor  # bool[H]
    src: torch.Tensor  # i64[H] sending host's id (valid for packets)
    host_id: torch.Tensor  # i64[H]
    state: Any  # model state dict
    params: Any  # model param dict
    rng: RngState


class LocalPush(NamedTuple):
    """Schedule a future event on the host's own queue."""

    mask: torch.Tensor  # bool[H]
    t: torch.Tensor  # i64[H] absolute time, >= ctx.t
    kind: torch.Tensor  # i32[H]
    payload: torch.Tensor  # i32[H, P]


class PacketSend(NamedTuple):
    """Send packets to a (possibly remote) host through the egress pipeline
    (budget, token bucket, latency/loss, exchange).

    Burst sends (count_max > 1): one port emits up to `count_max`
    back-to-back packets to the SAME destination in one microstep; segment
    k (k < count[h]) carries payload + k * payload_inc and its own loss
    draw, bandwidth charge, order key and budget slot, while the route
    lookup runs once per port."""

    mask: torch.Tensor  # bool[H]
    dst: torch.Tensor  # i64[H] destination host id
    size_bytes: torch.Tensor  # i32[H]
    kind: torch.Tensor  # i32[H] model kind at the destination
    payload: torch.Tensor  # i32[H, P] (word 0 overwritten with size_bytes)
    count: Any = None  # i32[H] burst length (None -> mask as 0/1)
    payload_inc: Any = None  # i32[H, P] per-segment payload increment
    count_max: int = 1  # static burst width


class FlowDone(NamedTuple):
    """A flow-completion record for the JAX package's flow ledger (a
    network-observatory instrument). The port runs with the observatory off,
    so the engine accepts and ignores it, as the JAX engine does when its
    ledger is off."""

    mask: torch.Tensor  # bool[H] this host completed a flow at this event
    dst: torch.Tensor  # i32/i64[H] the peer (server) host id
    flow: torch.Tensor  # i32[H] model flow index
    t_start: torch.Tensor  # i64[H] flow start time (ns)
    bytes: torch.Tensor  # i64[H] application payload bytes transferred
    retransmits: torch.Tensor  # i64[H] retransmitted segments of this flow


class HandlerOut(NamedTuple):
    state: Any
    rng: RngState
    pushes: tuple[LocalPush, ...] = ()
    sends: tuple[PacketSend, ...] = ()
    flow: Any = None  # FlowDone | None


class Model(Protocol):
    name: str

    def build(self, hosts: list[dict], seed: int, device) -> tuple[Any, Any, list]:
        """(params, state, initial_events); events are
        (host_id, t_ns, kind, payload_tuple)."""
        ...

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        ...

    def report(self, state, hosts: list[dict]) -> dict:
        ...


MODEL_REGISTRY: dict[str, type] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.name] = cls
    return cls


def get_model(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
