"""Vectorized host-model interface (port of shadow_tpu/models/base.py).

A model's `handle` runs once per microstep for ALL hosts, with per-host
masks selecting who is active. Its contract is the JAX package's:

  - RNG draws go through ops.rng with mask = the hosts consuming the draw;
  - state updates are masked by `ctx.active`;
  - at most one event per host per microstep; emission ports
    (`HandlerOut.pushes` / `.sends`) are a fixed tuple per model.

Model params and state are dicts of [H, ...] tensors on the run's device.

Every model has two implementations of its handler, as every kernel of the
port does: `handle_plain`, plain PyTorch (functional), and a hand-written
CUDA kernel (csrc/models.cu, K17-K22). `handle` dispatches on where
`ctx.t` lives: a CPU tensor runs `handle_plain`, a CUDA tensor launches the
kernel, any other device is refused. There is no fallback: a kernel that
fails to build or launch raises, and nothing on a CUDA path calls
`handle_plain` (the tests and chip_smoke.py call it to compare). The
kernels update the state dict's lanes and the RNG lanes IN PLACE, as the
chain kernels update their carry lanes; the snapshot deep-copies them
(core/checkpoint.py). Their argument block starts with the context's
fields in the order `ctx_arg_block` gives; port fields that are constants
(kinds, zero payloads) are cached read-only tensors (`const_lane`,
`const_rows`), and a kernel's outputs are allocated per call, so a port
field written for one column of a K-way microstep stays intact while the
later columns run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Any, NamedTuple, Protocol

import torch

if TYPE_CHECKING:  # ops.chain imports this module's constants
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
    # the flow ledger's record lanes for this event column (ops/obs.py
    # FlowLanes row; None unless the ledger is on): a model with a flow
    # port writes them in place, its kernel and its plain handler alike
    flow: Any = None


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


class HandlerOut(NamedTuple):
    state: Any
    rng: RngState
    pushes: tuple[LocalPush, ...] = ()
    sends: tuple[PacketSend, ...] = ()
    flow: Any = None  # the FlowLanes row the handler wrote (ctx.flow) | None


class Model(Protocol):
    name: str

    def build(self, hosts: list[dict], seed: int, device) -> tuple[Any, Any, list]:
        """(params, state, initial_events); events are
        (host_id, t_ns, kind, payload_tuple)."""
        ...

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` on the CPU, the model's kernel on CUDA."""
        ...

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        ...

    def report(self, state, hosts: list[dict]) -> dict:
        ...


def ctx_arg_block(ctx: HandlerCtx) -> list[int]:
    """The context's part of a handler kernel's argument block, in the
    order csrc/models.cu `read_ctx` reads it: H, P, the event's host
    stride, then the event time, payload, kind, active, is_packet, src and
    host id. The time and payload may be a column of the K-way peek (host
    stride es, payload rows es * P words apart); every other lane is
    contiguous, as the ingress kernel writes it."""
    from shadow_tpu_torch.ops.cuda_build import addr, check

    h, p = ctx.payload.shape
    es = ctx.t.stride(0) if h > 1 else 1
    if not ctx.t.is_cuda or ctx.t.dtype != torch.int64 or tuple(ctx.t.shape) != (h,):
        raise ValueError(f"handler t: expected a CUDA int64 [{h}] tensor")
    pl = ctx.payload
    if not pl.is_cuda or pl.dtype != torch.int32:
        raise ValueError("handler payload: expected a CUDA int32 tensor")
    if (h > 1 and pl.stride(0) != es * p) or (p > 1 and pl.stride(1) != 1):
        raise ValueError(f"handler payload: strides {pl.stride()}, expected ({es * p}, 1)")
    for x, dt, name in ((ctx.kind, torch.int32, "kind"), (ctx.active, torch.bool, "active"),
                        (ctx.is_packet, torch.bool, "is_packet"), (ctx.src, torch.int64, "src"),
                        (ctx.host_id, torch.int64, "host_id")):
        check(x, dt, (h,), f"handler {name}")
    return [h, p, es, addr(ctx.t), addr(pl), addr(ctx.kind), addr(ctx.active),
            addr(ctx.is_packet), addr(ctx.src), addr(ctx.host_id)]


def check_lanes(lanes: dict, spec: tuple, h: int, what: str) -> list[int]:
    """Check each named [H] lane of `lanes` against its dtype in `spec`
    ((name, dtype) pairs) and return their addresses in that order."""
    from shadow_tpu_torch.ops.cuda_build import addr, check

    for name, dt in spec:
        check(lanes[name], dt, (h,), f"{what} {name}")
    return [addr(lanes[name]) for name, _ in spec]


@functools.lru_cache(maxsize=None)
def _const(value: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((1,), value, dtype=dtype, device=device)


def const_lane(value: int, dtype: torch.dtype, h: int, device) -> torch.Tensor:
    """A read-only [H] port field holding `value` everywhere: a broadcast
    view of one cached element (K11 reads it with host stride 0)."""
    return _const(value, dtype, torch.device(device)).expand(h)


@functools.lru_cache(maxsize=None)
def const_rows(h: int, p: int, device, word: int = -1, value: int = 0) -> torch.Tensor:
    """A read-only i32[H, P] payload, zeros but for `value` in word `word`
    (none for -1), cached per device and shape. Nothing writes a push or
    send payload in place."""
    rows = torch.zeros((h, p), dtype=torch.int32, device=device)
    if word >= 0:
        rows[:, word] = value
    return rows


MODEL_REGISTRY: dict[str, type] = {}


def register_model(cls):
    MODEL_REGISTRY[cls.name] = cls
    return cls


def get_model(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
