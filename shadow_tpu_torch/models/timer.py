"""Periodic-timer workload (port of shadow_tpu/models/timer.py): each host
fires every `interval`, counts the fire, and reschedules. No packets.

The handler is kernel K20 `timer_handle` (csrc/models.cu) on CUDA and
`handle_plain` on the CPU (models/base.py)."""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.config.units import TimeUnit, parse_time_ns
from shadow_tpu_torch.models.base import (
    HandlerCtx,
    HandlerOut,
    LocalPush,
    check_lanes,
    const_lane,
    const_rows,
    ctx_arg_block,
    register_model,
)
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, on_cpu
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS

KIND_FIRE = 0

_handle_k = CudaKernel("models", "timer_handle", ARG_BLOCK)


@register_model
class TimerModel:
    name = "timer"
    # the kinds the timer wheel takes (ops/wheel.py)
    timer_kinds = (KIND_FIRE,)
    # (name, dtype) of the params and state lanes the kernel reads, in its
    # order
    kernel_params = (("interval", torch.int64),)
    kernel_state = (("fires", torch.int64),)

    def build(self, hosts, seed, device):
        h = len(hosts)
        interval = np.array(
            [parse_time_ns(hh["model_args"].get("interval", "10 ms"), TimeUnit.MS) for hh in hosts],
            np.int64,
        )
        params = {"interval": torch.as_tensor(interval, device=device)}
        state = {"fires": torch.zeros((h,), dtype=torch.int64, device=device)}
        events = [(hh["host_id"], hh["start_time"], KIND_FIRE, ()) for hh in hosts]
        return params, state, events

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K20) on CUDA, counting the fires in
        place."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        args = [*ctx_arg_block(ctx),
                *check_lanes(ctx.params, self.kernel_params, h, "timer param"),
                *check_lanes(ctx.state, self.kernel_state, h, "timer state")]
        mask = torch.empty((h,), dtype=torch.bool, device=dev)
        t = torch.empty((h,), dtype=torch.int64, device=dev)
        _handle_k(arg_block([*args, addr(mask), addr(t)]))
        push = LocalPush(mask=mask, t=t, kind=const_lane(KIND_FIRE, torch.int32, h, dev),
                         payload=const_rows(h, ctx.payload.shape[1], dev))
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(push,))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        fire = ctx.active & (ctx.kind == KIND_FIRE)
        h = ctx.kind.shape[0]
        push = LocalPush(
            mask=fire,
            t=ctx.t + ctx.params["interval"],
            kind=torch.full((h,), KIND_FIRE, dtype=torch.int32, device=ctx.t.device),
            payload=torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=ctx.t.device),
        )
        return HandlerOut(
            state={"fires": ctx.state["fires"] + fire}, rng=ctx.rng, pushes=(push,)
        )

    def report(self, state, hosts):
        fires = np.asarray(state["fires"])
        return {
            "total_fires": int(fires.sum()),
            "min_fires": int(fires.min()),
            "max_fires": int(fires.max()),
        }


KERNELS = {"timer_handle": _handle_k}
