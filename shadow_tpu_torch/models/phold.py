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

The handler is kernel K18 `phold_handle` (csrc/models.cu, with the same
log as scalar code) on CUDA and `handle_plain` on the CPU
(models/base.py); `exp_delay_kernel` runs the kernel's own `exp_delay` over
a flat array, so its log can be checked on every input.
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
    check_lanes,
    const_lane,
    const_rows,
    ctx_arg_block,
    register_model,
)
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS
from shadow_tpu_torch.ops.rng import rng_uniform

KIND_JOB = 0  # a held message matures: pick a peer, send
KIND_MSG = 1  # message arrives: hold it, then it matures

_handle_k = CudaKernel("models", "phold_handle", ARG_BLOCK)
_exp_delay_k = CudaKernel("models", "phold_exp_delay", ARG_BLOCK)

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


def exp_delay_kernel(u: torch.Tensor, mean_ns: torch.Tensor) -> torch.Tensor:
    """`exp_delay` through K18's own device function, on CUDA: u f32[N],
    mean_ns i64[N] (contiguous or a broadcast) -> delay i64[N]."""
    n = u.shape[0]
    check(u, torch.float32, (n,), "exp_delay u")
    if not mean_ns.is_cuda or mean_ns.dtype != torch.int64 or tuple(mean_ns.shape) != (n,):
        raise ValueError(f"exp_delay mean_ns: expected a CUDA int64 [{n}] tensor")
    out = torch.empty((n,), dtype=torch.int64, device=u.device)
    _exp_delay_k(arg_block([n, addr(u), addr(mean_ns), mean_ns.stride(0) if n > 1 else 0,
                            addr(out)]))
    return out


@register_model
class PholdModel:
    name = "phold"
    wire_kind = KIND_MSG  # cross-plane packets count as held messages (mixed sims)
    # the kinds the timer wheel takes (ops/wheel.py)
    timer_kinds = (KIND_JOB,)
    # (name, dtype) of the params and state lanes the kernel reads, in its
    # order (then the RNG lanes)
    kernel_params = (("mean_delay", torch.int64), ("num_hosts", torch.int64))
    kernel_state = (("handled", torch.int64),)

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
        """`handle_plain` as one kernel (K18) on CUDA, advancing the RNG
        lanes and the handled count in place."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        check(ctx.rng.s, torch.int64, (h, 4), "rng")
        args = [*ctx_arg_block(ctx), *check_lanes(ctx.params, self.kernel_params, h, "phold param"),
                *check_lanes(ctx.state, self.kernel_state, h, "phold state"), addr(ctx.rng.s)]
        arrived, job = (torch.empty((h,), dtype=torch.bool, device=dev) for _ in range(2))
        push_t, dst = (torch.empty((h,), dtype=torch.int64, device=dev) for _ in range(2))
        _handle_k(arg_block([*args, addr(arrived), addr(push_t), addr(job), addr(dst)]))
        zeros = const_rows(h, p, dev)
        push = LocalPush(mask=arrived, t=push_t, kind=const_lane(KIND_JOB, torch.int32, h, dev),
                         payload=zeros)
        send = PacketSend(mask=job, dst=dst, size_bytes=ctx.params["size"],
                          kind=const_lane(KIND_MSG, torch.int32, h, dev), payload=zeros)
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(push,), sends=(send,))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
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


KERNELS = {"phold_handle": _handle_k}
