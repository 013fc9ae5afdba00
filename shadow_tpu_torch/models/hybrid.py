"""The hybrid host model: the device lane of a CPU-plane host (port of
shadow_tpu/models/hybrid.py), the device half of the co-simulation bridge
(cosim.py).

Each host of the CPU host plane owns one device lane. Two event kinds flow
through it:

  - KIND_SENDREQ (a local event the bridge injects): "this host's CPU plane
    emitted a packet at time t". The handler turns it into a `PacketSend`,
    so CPU-plane traffic goes through the device egress pipeline (send
    budget, token bucket, loss, latency, clamp, exchange) as modeled
    traffic does.
  - KIND_DATA (a packet event): a delivery for this host, appended (arrival
    time, source, payload key, size, flags) to the host's capture ring,
    which the bridge drains after every window and maps back to the bytes
    it holds by (source, key).

The handler is kernel K33 `hybrid_handle` (csrc/models.cu) on CUDA, writing
the rings and their counters in place, and `handle_plain` on the CPU
(models/base.py).
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.models.base import (
    HandlerCtx,
    HandlerOut,
    PacketSend,
    const_lane,
    ctx_arg_block,
    register_model,
)
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu

KIND_SENDREQ = 1  # bridge-injected send request (local event at the source)
KIND_DATA = 2  # packet delivery at the destination

# payload word layout (word 0 is the engine-owned size in bytes)
PW_SIZE = 0
PW_DST_OR_SRC = 1  # send request: the destination host id
PW_KEY = 2  # per-source payload key (the bridge's byte-store lookup)
PW_FLAGS = 3  # the bridge's byte-store magic on send requests

# the capture rings [H, C] and their counters [H], in the kernel's order
RING_LANES = (("cap_t", torch.int64), ("cap_src", torch.int64), ("cap_key", torch.int32),
              ("cap_size", torch.int32), ("cap_flags", torch.int32))
COUNTER_LANES = (("cap_n", torch.int32), ("cap_lost", torch.int64))

_handle_k = CudaKernel("models", "hybrid_handle", ARG_BLOCK)


@register_model
class HybridModel:
    """One device lane per CPU-plane host (see the module docstring)."""

    name = "hybrid"

    def __init__(self, capture_cap: int = 128):
        self.capture_cap = capture_cap

    def build(self, hosts, seed, device):
        h = len(hosts)
        c = self.capture_cap
        state = {name: torch.zeros((h, c), dtype=dt, device=device) for name, dt in RING_LANES}
        state["cap_n"] = torch.zeros((h,), dtype=torch.int32, device=device)
        state["cap_lost"] = torch.zeros((h,), dtype=torch.int64, device=device)
        params = {"_hosts": torch.as_tensor(np.arange(h, dtype=np.int32), device=device)}
        return params, state, []  # no initial device events: the CPU plane drives

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K33) on CUDA: the rings, cap_n and
        cap_lost are written in place; the send port's mask, destination,
        size and payload (a contiguous copy of the event's words) are the
        kernel's outputs."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        if p < 4:
            raise ValueError(f"hybrid: {p} payload words, the bridge's layout needs 4")
        st = ctx.state
        c = st["cap_t"].shape[1]
        for name, dt in RING_LANES:
            check(st[name], dt, (h, c), f"hybrid {name}")
        for name, dt in COUNTER_LANES:
            check(st[name], dt, (h,), f"hybrid {name}")
        mask = torch.empty((h,), dtype=torch.bool, device=dev)
        dst = torch.empty((h,), dtype=torch.int64, device=dev)
        size = torch.empty((h,), dtype=torch.int32, device=dev)
        payload = torch.empty((h, p), dtype=torch.int32, device=dev)
        _handle_k(arg_block([
            *ctx_arg_block(ctx), c, *(addr(st[name]) for name, _ in RING_LANES),
            *(addr(st[name]) for name, _ in COUNTER_LANES),
            addr(mask), addr(dst), addr(size), addr(payload)]))
        send = PacketSend(mask=mask, dst=dst, size_bytes=size,
                          kind=const_lane(KIND_DATA, torch.int32, h, dev), payload=payload)
        return HandlerOut(state=st, rng=ctx.rng, sends=(send,))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        st = ctx.state
        is_send = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_SENDREQ)
        is_data = ctx.active & ctx.is_packet & (ctx.kind == KIND_DATA)
        n = st["cap_n"]
        cap = st["cap_t"].shape[1]
        slot_ok = is_data & (n < cap)
        # slot cap_n where a delivery fits; elsewhere slot 0 keeps its value
        # (no data-dependent shapes: the plain version replays from a graph)
        slot = torch.where(slot_ok, n, 0).to(torch.int64)[:, None]
        new_state = {}
        for name, src in (("cap_t", ctx.t), ("cap_src", ctx.src),
                          ("cap_key", ctx.payload[:, PW_KEY]),
                          ("cap_size", ctx.payload[:, PW_SIZE]),
                          ("cap_flags", ctx.payload[:, PW_FLAGS])):
            ring = st[name]
            val = torch.where(slot_ok[:, None], src[:, None].to(ring.dtype), ring.gather(1, slot))
            new_state[name] = ring.scatter(1, slot, val)
        new_state["cap_n"] = n + slot_ok.to(torch.int32)
        new_state["cap_lost"] = st["cap_lost"] + (is_data & ~slot_ok)
        send = PacketSend(
            mask=is_send,
            dst=ctx.payload[:, PW_DST_OR_SRC].to(torch.int64),
            size_bytes=ctx.payload[:, PW_SIZE],
            kind=torch.full_like(ctx.kind, KIND_DATA),
            payload=ctx.payload,
        )
        return HandlerOut(state=new_state, rng=ctx.rng, sends=(send,))

    def report(self, state, hosts) -> dict:
        return {"capture_overflow_lost": int(np.asarray(state["cap_lost"]).sum())}


KERNELS = {"hybrid_handle": _handle_k}
