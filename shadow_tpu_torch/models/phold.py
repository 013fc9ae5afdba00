"""PHOLD, the classic PDES benchmark workload (port of
shadow_tpu/models/phold.py).

Each host starts with `population` jobs; a matured job sends a small packet
to a uniform random peer; an arrived packet is held for an exponential delay
and then matures into the next job. Event population is conserved.

The exponential draw is `-log(f32)`. `torch.log` and XLA-CPU's `jnp.log` do
not agree on every float32 input, and one ulp in the log changes the held
delay, so the port computes the logarithm with XLA-CPU's own algorithm
(Cephes/Eigen `plog`, with its fused multiply-adds) in plain PyTorch ops:
`log_f32` below. An FMA of float32 operands is computed as
float32(float64(a) * float64(b) + float64(c)); the product is exact in
float64, and each PyTorch op rounds on its own, so the CPU and CUDA results
are the same. tests/test_torch_phold_log.py checks all 2^24 inputs the model
can draw against `jnp.log`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.config.units import TimeUnit, parse_time_ns
from shadow_tpu_torch.models.base import (
    HandlerCtx,
    HandlerOut,
    LocalPush,
    PacketSend,
    register_model,
)
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS
from shadow_tpu_torch.ops.rng import rng_uniform

KIND_JOB = 0  # a held message matures: pick a peer, send
KIND_MSG = 1  # message arrives: hold it, then it matures

_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
)
_Q1 = -2.12194440e-4
_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


class _LogConsts(NamedTuple):
    p: tuple  # f64[] each, holding the float32 value
    sqrthf: torch.Tensor  # f32[]
    q1: torch.Tensor  # f32[]
    q2: torch.Tensor  # f64[], holding the float32 value
    floor: torch.Tensor  # f32[]


@functools.lru_cache(maxsize=None)
def _log_consts(device: torch.device) -> _LogConsts:
    """The log's float32 constants, made once per device. Those that only
    enter an FMA are kept widened to float64, so `_fma` casts nothing."""

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=device)

    return _LogConsts(
        p=tuple(f32(v).double() for v in _P), sqrthf=f32(_SQRTHF), q1=f32(_Q1),
        q2=f32(_Q2).double(), floor=f32(1e-7),
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float32 values, bit-identical to
    XLA-CPU's `jnp.log`."""
    k = _log_consts(x.device)
    p = k.p
    m, e_i = torch.frexp(x)  # m in [0.5, 1)
    e = e_i.to(torch.float32)
    mask = m < k.sqrthf
    x = (m - 1.0) + torch.where(mask, m, 0.0)
    e = e - torch.where(mask, 1.0, 0.0).to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * k.q1)
    x = (x - x2 * 0.5) + y
    return _fma(e, k.q2, x)


def exp_delay(u: torch.Tensor, mean_ns: torch.Tensor) -> torch.Tensor:
    """Exponential holding time, floored at 1 us so jobs always advance."""
    x = -log_f32(torch.maximum(1.0 - u, _log_consts(u.device).floor))
    d = (x * mean_ns.to(torch.float32)).to(torch.int64)
    return torch.clamp_min(d, 1_000)


@register_model
class PholdModel:
    name = "phold"
    # the kinds the timer wheel takes (ops/wheel.py)
    timer_kinds = (KIND_JOB,)

    def build(self, hosts, seed, device):
        h = len(hosts)
        mean_delay = np.array(
            [parse_time_ns(hh["model_args"].get("mean_delay", "100 ms"), TimeUnit.MS) for hh in hosts],
            np.int64,
        )
        size = np.array([int(hh["model_args"].get("payload_bytes", 64)) for hh in hosts], np.int32)
        params = {
            "mean_delay": torch.as_tensor(mean_delay, device=device),
            "size": torch.as_tensor(size, device=device),
            "num_hosts": torch.full((h,), h, dtype=torch.int64, device=device),
        }
        state = {"handled": torch.zeros((h,), dtype=torch.int64, device=device)}
        events = []
        for hh in hosts:
            for _ in range(int(hh["model_args"].get("population", 1))):
                events.append((hh["host_id"], hh["start_time"], KIND_JOB, ()))
        return params, state, events

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        job = ctx.active & (ctx.kind == KIND_JOB)
        arrived = ctx.active & (ctx.kind == KIND_MSG)
        zeros_payload = torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=dev)

        rng, u_hold = rng_uniform(ctx.rng, arrived)
        hold = exp_delay(u_hold, ctx.params["mean_delay"])
        push = LocalPush(
            mask=arrived,
            t=ctx.t + hold,
            kind=torch.full((h,), KIND_JOB, dtype=torch.int32, device=dev),
            payload=zeros_payload,
        )

        rng, u_dst = rng_uniform(rng, job)
        n = ctx.params["num_hosts"]
        dst = torch.minimum((u_dst * n.to(torch.float32)).to(torch.int64), n - 1)
        send = PacketSend(
            mask=job,
            dst=dst,
            size_bytes=ctx.params["size"],
            kind=torch.full((h,), KIND_MSG, dtype=torch.int32, device=dev),
            payload=zeros_payload,
        )
        state = {"handled": ctx.state["handled"] + ctx.active}
        return HandlerOut(state=state, rng=rng, pushes=(push,), sends=(send,))

    def report(self, state, hosts):
        handled = np.asarray(state["handled"])
        return {
            "total_events": int(handled.sum()),
            "min": int(handled.min()),
            "max": int(handled.max()),
        }
