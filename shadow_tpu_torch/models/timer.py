"""Periodic-timer workload (port of shadow_tpu/models/timer.py): each host
fires every `interval`, counts the fire, and reschedules. No packets."""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.config.units import TimeUnit, parse_time_ns
from shadow_tpu_torch.models.base import HandlerCtx, HandlerOut, LocalPush, register_model
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS

KIND_FIRE = 0


@register_model
class TimerModel:
    name = "timer"
    # the kinds the timer wheel takes (ops/wheel.py)
    timer_kinds = (KIND_FIRE,)

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
