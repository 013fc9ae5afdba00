"""The fault plane (B13, B14): a copy of the host-side half of the JAX
package's `core/faults.py` (schedule compilation, numpy only), the device
functions' plain PyTorch versions, and the wrapper of K23.

A `faults:` config block compiles, at build time on the host, into a few
device arrays (`FaultParams`) that the round reads:

  * per-host up/down windows (`down_t`/`up_t`, i64[H, W]): a host is DOWN
    while any window contains the event time. Under `restart_queue: hold`
    its pending events defer to the restart time (the CPU model's
    busy-floor mechanics: K1's fault lane for the barrier, K10's hold lane
    for the execution time, K23 for the K-way fold's deferral test); under
    `clear` every event whose execution time falls inside a down window is
    consumed but not dispatched (K10's clear lane, `stats.faults_dropped`).
  * link-fault windows (`win_start`/`win_end`, i64[L], with a loss
    probability and a latency multiplier x1000 each): while one is active,
    every send draws one extra loss uniform from the sender's RNG lane
    after the path-loss draw, and surviving packets have their latency
    multiplied (K11's fault lane; `faults_dropped`, `faults_delayed`).

The schedule is a pure function of (fault seed, host id, draw counter)
through splitmix64, so two runs with one seed get identical arrays. With the
block absent the engine runs no fault lane and allocates none.

`down_and_resume` and `window_effects` dispatch on where their tensors live:
CPU tensors run the plain version, CUDA tensors launch K23 (`down_and_resume`;
`window_effects` has no kernel of its own: it is a lane of K11, and the
plain version serves the CPU path and the tests).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.rng import u64
from shadow_tpu_torch.simtime import TIME_MAX

# latency multipliers are carried as parts-per-thousand integers so the
# inflation is integer math (the fault and fluid planes share the scale)
LAT_SCALE = 1000


class FaultParams(NamedTuple):
    """Device-side fault schedule (EngineParams.faults). Crash fields are
    None when no host ever crashes (W = 0); window fields are None when no
    link-fault window exists (L = 0)."""

    down_t: Any  # i64[H, W] crash times (TIME_MAX = unused slot) | None
    up_t: Any  # i64[H, W] restart times | None
    win_start: Any  # i64[L] link-fault window starts | None
    win_end: Any  # i64[L] | None
    win_loss: Any  # f32[L] extra loss probability while active | None
    win_lat: Any  # i64[L] latency multiplier x1000 (1000 = 1.0x) | None


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """compile_faults result: the static dims the EngineConfig needs plus
    the compiled arrays."""

    crash_windows: int  # W (0 = no crash lane)
    loss_windows: int  # L (0 = no link-fault lane)
    queue_clear: bool  # restart_queue == "clear"
    params: FaultParams | None  # None when nothing is scheduled

    @property
    def active(self) -> bool:
        return self.crash_windows > 0 or self.loss_windows > 0


INACTIVE_FAULTS = FaultSchedule(0, 0, False, None)

# ---------------------------------------------------------------- RNG
# Counter-based draws: u64(seed, host, ctr) is a pure function of its
# inputs, so the compiled schedule cannot depend on iteration order.

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_HOST_STRIDE = np.uint64(0xD1342543DE82EF95)  # same stride rng_init uses
_CTR_STRIDE = np.uint64(0xA0761D6478BD642F)
# the strides as int64 bit patterns, for draws carried in int64 tensors
# (the fluid plane's counter draw, net/fluid.py)
HOST_STRIDE_I64 = u64(int(_HOST_STRIDE))
CTR_STRIDE_I64 = u64(int(_CTR_STRIDE))


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _GOLDEN).astype(np.uint64)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)).astype(
        np.uint64
    )
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)).astype(
        np.uint64
    )
    return (z ^ (z >> np.uint64(31))).astype(np.uint64)


def fault_u64(seed: int, host, ctr) -> np.ndarray:
    """Counter-based u64 draw: pure in (seed, host, ctr)."""
    host = np.asarray(host, np.uint64)
    ctr = np.asarray(ctr, np.uint64)
    x = (np.uint64(seed & (2**64 - 1)) + host * _HOST_STRIDE
         + ctr * _CTR_STRIDE).astype(np.uint64)
    return _splitmix64(_splitmix64(x))


def fault_uniform(seed: int, host, ctr) -> np.ndarray:
    """float64 in [0, 1): top 53 bits of the counter draw."""
    return (fault_u64(seed, host, ctr) >> np.uint64(11)).astype(
        np.float64
    ) * (1.0 / (1 << 53))


# ---------------------------------------------------------------- compile


def _merge_windows(wins: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sort + coalesce overlapping/touching [down, up) windows per host —
    the containment test assumes disjoint windows (the resume time is the
    up of THE window containing t)."""
    out: list[tuple[int, int]] = []
    for d, u in sorted(wins):
        if out and d <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], u))
        else:
            out.append((d, u))
    return out


def compile_faults(
    fopts,
    *,
    num_hosts: int,
    num_real: int | None = None,
    stop_time: int,
    bootstrap_end: int = 0,
    default_seed: int = 1,
    name_to_id: dict[str, int] | None = None,
    device=None,
) -> FaultSchedule:
    """FaultOptions -> FaultSchedule, the arrays on `device`. Host-side,
    numpy, deterministic in the fault seed. Churn draws run over the
    `num_real` prefix only."""
    num_real = num_hosts if num_real is None else num_real
    if fopts.restart_queue not in ("hold", "clear"):
        raise ValueError(
            f"restart_queue must be hold|clear, got {fopts.restart_queue!r}"
        )
    seed = default_seed if fopts.seed is None else fopts.seed
    per_host: list[list[tuple[int, int]]] = [[] for _ in range(num_hosts)]

    # explicit crash entries (host by id or name)
    for c in fopts.crashes:
        hid = c.host
        if isinstance(hid, str):
            if name_to_id is None or hid not in (name_to_id or {}):
                raise ValueError(f"faults.crashes: unknown host {hid!r}")
            hid = name_to_id[hid]
        hid = int(hid)
        if not 0 <= hid < num_real:
            raise ValueError(
                f"faults.crashes: host id {hid} out of range [0, {num_real})"
            )
        if c.up_at <= c.down_at:
            raise ValueError(
                f"faults.crashes: up_at {c.up_at} <= down_at {c.down_at}"
            )
        per_host[hid].append((int(c.down_at), int(c.up_at)))

    # seeded churn: each real host crashes once with probability `prob`,
    # at a uniform time in [bootstrap_end, stop), down for an exponential
    # draw around mean_downtime (floored at 1 ms so a restart is distinct
    # from the crash)
    ch = fopts.host_churn
    if ch is not None and ch.prob > 0 and num_real > 0:
        hosts = np.arange(num_real)
        hit = fault_uniform(seed, hosts, 0) < ch.prob
        span = max(stop_time - bootstrap_end, 1)
        down_at = bootstrap_end + (
            fault_uniform(seed, hosts, 1) * span
        ).astype(np.int64)
        # inverse-CDF exponential; u is bounded away from 1 so log is finite
        u = np.minimum(fault_uniform(seed, hosts, 2), 1.0 - 2**-53)
        downtime = np.maximum(
            (-np.log1p(-u) * ch.mean_downtime).astype(np.int64), 1_000_000
        )
        for h in np.nonzero(hit)[0]:
            per_host[int(h)].append(
                (int(down_at[h]), int(down_at[h] + downtime[h]))
            )

    merged = [_merge_windows(w) for w in per_host]
    w_max = max((len(w) for w in merged), default=0)

    lws = list(fopts.loss_windows)
    for lw in lws:
        if not 0.0 <= lw.loss <= 1.0:
            raise ValueError(f"faults.loss_windows: loss {lw.loss} not in [0, 1]")
        if lw.latency_factor < 1.0:
            raise ValueError(
                f"faults.loss_windows: latency_factor {lw.latency_factor} < 1.0 "
                f"(deflation would break the conservative-lookahead bound)"
            )
        if lw.end <= lw.start:
            raise ValueError(
                f"faults.loss_windows: end {lw.end} <= start {lw.start}"
            )

    if w_max == 0 and not lws:
        return FaultSchedule(0, 0, fopts.restart_queue == "clear", None)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    if w_max:
        down = np.full((num_hosts, w_max), TIME_MAX, np.int64)
        up = np.full((num_hosts, w_max), TIME_MAX, np.int64)
        for h, wins in enumerate(merged):
            for i, (d, u_) in enumerate(wins):
                down[h, i] = d
                up[h, i] = u_
        down_t, up_t = t(down, np.int64), t(up, np.int64)
    else:
        down_t = up_t = None

    if lws:
        win_start = t([int(w.start) for w in lws], np.int64)
        win_end = t([int(w.end) for w in lws], np.int64)
        win_loss = t([float(w.loss) for w in lws], np.float32)
        win_lat = t([int(round(w.latency_factor * LAT_SCALE)) for w in lws], np.int64)
    else:
        win_start = win_end = win_loss = win_lat = None

    return FaultSchedule(
        crash_windows=w_max,
        loss_windows=len(lws),
        queue_clear=fopts.restart_queue == "clear",
        params=FaultParams(
            down_t=down_t, up_t=up_t,
            win_start=win_start, win_end=win_end,
            win_loss=win_loss, win_lat=win_lat,
        ),
    )


# ---------------------------------------------------------------- device side


def down_and_resume_plain(fp: FaultParams, t: torch.Tensor):
    """Per-host down mask and restart floor at times `t` (i64[H]):
    (down bool[H], resume i64[H]), resume the containing window's up time
    where down and 0 elsewhere, so callers fold it into an execution-time
    floor with a plain maximum."""
    in_w = (fp.down_t <= t[:, None]) & (t[:, None] < fp.up_t)  # [H, W]
    down = in_w.any(dim=1)
    resume = torch.where(in_w, fp.up_t, TIME_MAX).min(dim=1).values
    return down, torch.where(down, resume, 0)


_down_resume_k = CudaKernel("faults", "fault_down_resume", ARG_BLOCK)


def down_and_resume(fp: FaultParams, t: torch.Tensor):
    """`down_and_resume_plain` as one kernel (K23) on CUDA; `t` may be a
    column of a wider tensor (any host stride)."""
    if on_cpu(t):
        return down_and_resume_plain(fp, t)
    h, w = fp.down_t.shape
    check(fp.down_t, torch.int64, (h, w), "fault down_t")
    check(fp.up_t, torch.int64, (h, w), "fault up_t")
    if not t.is_cuda or t.dtype != torch.int64 or tuple(t.shape) != (h,):
        raise ValueError(f"fault t: expected a CUDA int64 [{h}] tensor")
    down = torch.empty((h,), dtype=torch.bool, device=t.device)
    resume = torch.empty((h,), dtype=torch.int64, device=t.device)
    _down_resume_k(arg_block([h, w, t.stride(0) if h > 1 else 1, addr(t), addr(fp.down_t),
                              addr(fp.up_t), addr(down), addr(resume)]))
    return down, resume


def window_effects_plain(fp: FaultParams, t: torch.Tensor):
    """Link-fault effects active at per-host times `t` (i64[H]): (loss f32[H],
    lat_x1000 i64[H]), the max loss probability and the max latency
    multiplier over the active windows (at least 1000). Replicas' windows
    ([R, L]) apply to their replica's rows, R equal blocks of `t`."""
    if fp.win_start.dim() == 2:
        per = t.shape[0] // fp.win_start.shape[0]
        ws, we, wl, wt = (x.repeat_interleave(per, 0) for x in (
            fp.win_start, fp.win_end, fp.win_loss, fp.win_lat))
    else:
        ws, we, wl, wt = (x[None, :] for x in (fp.win_start, fp.win_end, fp.win_loss,
                                                fp.win_lat))
    act = (ws <= t[:, None]) & (t[:, None] < we)  # [H, L]
    loss = torch.where(act, wl, torch.zeros((), dtype=torch.float32,
                                            device=t.device)).max(dim=1).values
    lat = torch.where(act, wt, LAT_SCALE).max(dim=1).values
    return loss, torch.clamp_min(lat, LAT_SCALE)


KERNELS = {"fault_down_resume": _down_resume_k}
