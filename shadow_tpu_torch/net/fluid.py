"""Fluid traffic plane: background-flow rate ODEs advanced once per round,
coupled to the packet engine (port of shadow_tpu/net/fluid.py).

A `fluid:` config block compiles background traffic classes (src-zone ->
dst-zone demand over an active [start, end) window) into per-link rate
state advanced once per round over the committed window [now, window_end):

    rate_k'  = rate_k + min(dt/tau, 1) * (demand_k(t) - rate_k)
    bg[n]    = sum_k rate_k' over classes whose src or dst zone is n
    avail[n] = max(capacity[n] - fg_rate[n], 0)       # packet plane first
    share[n] = min(1, avail[n] / bg[n])               # DropTail clip
    g_k      = min(share[src_k], share[dst_k])        # class bottleneck
    carried  = rate_k' * g_k                          # the new rate state
    util[n]  = (bg[n] + fg_rate[n]) / capacity[n]     # offered, may be > 1

`fg_rate[n]` is the packet plane's bytes on link n this round, folded from
the pre-exchange outbox. Carried bytes add to `stats.fl_bg_bytes`, the
clipped rest to `stats.fl_bg_dropped`. At round start each host's access
link utilization (from the previous round's state) gives its extra loss
probability and latency multiplier (x1000 integers, >= 1.0x: inflation
only), both zero-effect unless background load is present on the link; the
loss draw is a counter hash of (fluid seed, host, emission counter) that
never advances the RNG lanes (`fluid_send_uniform`; in K11 on the card).

Exactness. The f64 lanes equal the JAX package's on XLA-CPU bit for bit,
which fixes the arithmetic written out here and in csrc/fluid.cu:

  - sums over the K classes: one left fold for K <= 32; for 33 <= K <= 64
    a left fold over each half [0, ceil(K/2)) and [ceil(K/2), K), then
    their sum (XLA-CPU's tree-reduction split). For the link loads at
    28 <= K <= 32 XLA-CPU's vectorized code sums in an order not
    reproduced here, so `check_class_count` refuses those K and K > 64;
  - XLA-CPU contracts `rates + alpha * (demand - rates)` and
    `rates - rates * g` into fused multiply-adds, and folds the carried sum
    of K <= 32 classes as acc = fma(r_k, g_k, acc) (the products of
    33..64 classes are rounded before the halves are summed);
  - divisions by trace-time constants become multiplications by the
    reciprocal: alpha = min(f64(dt_ns) * (1e-9 * (1 / (tau_ns * 1e-9))), 1)
    and over = (util - thr) * (1 / max(1 - thr, 1e-9)), the constants
    computed in Python doubles;
  - `fg_bytes / max(dt_s, 1e-18)`, `avail / bg` and `(...) / capacity`
    are true divisions (never by a Python number in the plain versions:
    PyTorch's CUDA kernels turn that into a multiply by the reciprocal);
    `floor` goes to int64; `loss` rounds f64 -> f32 to nearest.

The plain versions get the fused multiply-adds from `fma_f64` (an exact
emulation in round-to-nearest arithmetic: Dekker's product, TwoSum and a
sum rounded to odd, Boldo and Melquiond 2008), so the CPU path and the
kernels (`__fma_rn`) agree bit for bit.

This module holds kernels K14 `fluid_fg_link_bytes`, K15 `fluid_advance`
and K16 `fluid_host_effects` (csrc/fluid.cu) with their plain PyTorch
versions beside them; each wrapper runs the plain version for CPU tensors
and launches its kernel for CUDA tensors, with no fallback. On CUDA, K15
writes the fluid state and the two stats lanes in place.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.core.faults import CTR_STRIDE_I64 as _CTR_STRIDE
from shadow_tpu_torch.core.faults import HOST_STRIDE_I64 as _HOST_STRIDE
from shadow_tpu_torch.core.faults import LAT_SCALE
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.rng import _splitmix64, lshr, u64
from shadow_tpu_torch.simtime import TIME_MAX

# class counts whose sums this port holds to XLA-CPU's order
MAX_CLASSES = 64
_VECTORIZED_K = range(28, 33)
_PAYLOAD_SIZE_WORD = 0


class FluidParams(NamedTuple):
    """The compiled schedule on the device (EngineParams.fluid)."""

    src_zone: torch.Tensor  # i32[K] class source link (graph-node index)
    dst_zone: torch.Tensor  # i32[K] class destination link
    demand: torch.Tensor  # f64[K] demand while active, bytes per second
    win_start: torch.Tensor  # i64[K] activity window start (ns)
    win_end: torch.Tensor  # i64[K] activity window end (ns)
    capacity: torch.Tensor  # f64[N] per-link capacity, bytes per second


@dataclasses.dataclass(frozen=True)
class FluidSchedule:
    """compile_fluid's result: the static knobs the EngineConfig needs plus
    the compiled arrays (None when no class is declared)."""

    classes: int  # K (0 = no fluid plane)
    links: int  # N
    tau_ns: int
    util_threshold: float
    loss_max: float
    lat_max_x1000: int
    seed: int
    params: FluidParams | None

    @property
    def active(self) -> bool:
        return self.classes > 0


# a fluid-off config: every knob at the EngineConfig defaults (not
# general.seed), so fluid-off configs differing only in seed give one
# EngineConfig, as in the JAX package
INACTIVE_SCHEDULE = FluidSchedule(0, 0, 50_000_000, 0.7, 0.0, 2000, 1, None)


class FluidState(NamedTuple):
    """The plane's carry lanes (SimState.fluid)."""

    rates: torch.Tensor  # f64[K] current per-class carried rate, bytes/s
    link_util: torch.Tensor  # f64[N] per-link offered utilization


def make_fluid_state(classes: int, links: int, device) -> FluidState:
    return FluidState(
        rates=torch.zeros((classes,), dtype=torch.float64, device=device),
        link_util=torch.zeros((links,), dtype=torch.float64, device=device),
    )


def check_class_count(classes: int) -> None:
    """Refuse a class count whose f64 sums this port cannot hold to the
    JAX package's order (module docstring)."""
    if classes > MAX_CLASSES or classes in _VECTORIZED_K:
        raise ValueError(
            f"{classes} fluid classes: the PyTorch port holds the class sums to the "
            f"JAX package's order for 1-27 and 33-{MAX_CLASSES} classes only"
        )


# ---------------------------------------------------------------- compile


def compile_fluid(fopts, *, num_links: int, default_seed: int = 1, zone_of=None,
                  device="cpu") -> FluidSchedule:
    """FluidOptions -> FluidSchedule (the JAX package's compile_fluid):
    deterministic in the config alone; `zone_of` maps a config zone id (GML
    node id) to a graph-node index, identity with a bounds check by
    default. Raises ValueError on an empty window or an unsupported class
    count."""
    if zone_of is None:
        def zone_of(z):
            z = int(z)
            if not 0 <= z < num_links:
                raise ValueError(f"fluid zone {z} out of range [0, {num_links})")
            return z

    seed = default_seed if fopts.seed is None else fopts.seed
    classes = list(fopts.classes)
    sched_kw = dict(
        links=num_links,
        tau_ns=int(fopts.tau),
        util_threshold=float(fopts.util_threshold),
        loss_max=float(fopts.loss_max),
        lat_max_x1000=int(round(fopts.latency_factor_max * LAT_SCALE)),
        seed=int(seed),
    )
    if not classes:
        return FluidSchedule(classes=0, params=None, **sched_kw)
    check_class_count(len(classes))
    k = len(classes)
    src = np.zeros((k,), np.int32)
    dst = np.zeros((k,), np.int32)
    dem = np.zeros((k,), np.float64)
    ws = np.zeros((k,), np.int64)
    we = np.zeros((k,), np.int64)
    for i, c in enumerate(classes):
        src[i] = zone_of(c.src_zone)
        dst[i] = zone_of(c.dst_zone)
        dem[i] = c.rate / 8.0  # bits/s -> bytes/s
        ws[i] = c.start
        # end 0 = open-ended: TIME_MAX keeps a window that starts past this
        # run's horizon legal (it never activates)
        we[i] = c.end if c.end else TIME_MAX
        if we[i] <= ws[i]:
            raise ValueError(f"fluid class {i}: window [{ws[i]}, {we[i]}) is empty")

    def T(a):
        return torch.as_tensor(a, device=device)

    return FluidSchedule(
        classes=k,
        params=FluidParams(
            src_zone=T(src), dst_zone=T(dst), demand=T(dem), win_start=T(ws),
            win_end=T(we),
            capacity=torch.full((num_links,), fopts.link_capacity / 8.0,
                                dtype=torch.float64, device=device),
        ),
        **sched_kw,
    )


def host_nodes(cfg, node_of: torch.Tensor, num_hosts: int, host_base: int = 0) -> torch.Tensor:
    """Graph-node index (the fluid link id) of hosts host_base ..
    host_base + num_hosts - 1, i64[num_hosts]: the affine divide when the
    host -> node map is uniform blocks, else the global `node_of`."""
    h = host_base + torch.arange(num_hosts, dtype=torch.int64, device=node_of.device)
    if cfg.hosts_per_node > 0:
        return torch.div(h, cfg.hosts_per_node, rounding_mode="floor")
    return node_of[h].to(torch.int64)


# ---------------------------------------------------------------- exact f64

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for float64


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to nearest-even, in float64, from separately
    rounded PyTorch ops: the exact product uh + ul (Dekker), the exact sum
    th + tl = c + uh (TwoSum), tl + ul rounded to odd, then th plus that
    rounded to nearest (Boldo and Melquiond's emulated FMA). No overflow or
    underflow occurs at the plane's magnitudes."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.float64, device=a.device)
                                        for x in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, e = _two_sum(tl, ul)
    toward0 = (e != 0) & ((e < 0) != (s < 0))
    rz = torch.where(toward0, torch.nextafter(s, torch.zeros_like(s)), s)
    v = torch.where(e != 0, (rz.view(torch.int64) | 1).view(torch.float64), s)
    return th + v


def _halves(k: int) -> int:
    """Where XLA-CPU splits a sum over k classes (k when it does not)."""
    return k if k <= 32 else -(-k // 2)


def class_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of [K, ...] f64 terms in XLA-CPU's order."""
    k = terms.shape[0]
    h = _halves(k)

    def fold(lo, hi):
        acc = torch.zeros_like(terms[0])
        for i in range(lo, hi):
            acc = acc + terms[i]
        return acc

    return fold(0, k) if h == k else fold(0, h) + fold(h, k)


def _link_load(fp: FluidParams, rates: torch.Tensor, links: int) -> torch.Tensor:
    """Per-link background load f64[N]: a class charges its source and its
    destination link (charge 2 when they are the same link)."""
    n = torch.arange(links, dtype=torch.int32, device=rates.device)[None, :]
    charge = ((fp.src_zone[:, None] == n).to(torch.float64)
              + (fp.dst_zone[:, None] == n).to(torch.float64))
    return class_sum(rates[:, None] * charge)


# ---------------------------------------------------------------- K14

def _as_i64(x: float) -> int:
    """A Python double's bit pattern as an int64 argument."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


_fg_k = CudaKernel("fluid", "fluid_fg_link_bytes", ARG_BLOCK)
_advance_k = CudaKernel("fluid", "fluid_advance", ARG_BLOCK)
_effects_k = CudaKernel("fluid", "fluid_host_effects", ARG_BLOCK)


def fluid_fg_link_bytes_plain(cfg, ob_dst, ob_t, ob_payload, node_of) -> torch.Tensor:
    """This round's foreground bytes per fluid link, i64[N], from the
    pre-exchange [H, B] outbox: each valid row's size charges its sender's
    access link and its destination's (JAX `_fluid_fg_link_bytes`)."""
    n, h = cfg.fluid_links, cfg.num_hosts
    size = torch.where(ob_t != TIME_MAX, ob_payload[:, :, _PAYLOAD_SIZE_WORD].to(torch.int64), 0)
    src = torch.clamp(host_nodes(cfg, node_of, ob_t.shape[0], cfg.host_base), 0, n - 1)
    dst = torch.clamp(ob_dst.reshape(-1).to(torch.int64), 0, h - 1)
    dnode = (torch.div(dst, cfg.hosts_per_node, rounding_mode="floor") if cfg.hosts_per_node > 0
             else node_of[dst].to(torch.int64))
    out = torch.zeros((n,), dtype=torch.int64, device=ob_t.device)
    out.index_add_(0, src, size.sum(dim=1))
    out.index_add_(0, torch.clamp(dnode, 0, n - 1), size.reshape(-1))
    return out


def fluid_fg_link_bytes(cfg, ob_dst, ob_t, ob_payload, node_of) -> torch.Tensor:
    """`fluid_fg_link_bytes_plain` as K14 on CUDA (integer atomics into a
    zeroed [N] accumulator: exact whatever their order)."""
    if on_cpu(ob_t):
        return fluid_fg_link_bytes_plain(cfg, ob_dst, ob_t, ob_payload, node_of)
    h, b = ob_t.shape
    p = ob_payload.shape[2]
    check(ob_dst, torch.int32, (h, b), "outbox dst")
    check(ob_t, torch.int64, (h, b), "outbox t")
    check(ob_payload, torch.int32, (h, b, p), "outbox payload")
    check(node_of, torch.int32, (cfg.num_hosts,), "node_of")
    out = torch.empty((cfg.fluid_links,), dtype=torch.int64, device=ob_t.device)
    _fg_k(arg_block([h, b, p, cfg.fluid_links, cfg.hosts_per_node, addr(ob_dst), addr(ob_t),
                      addr(ob_payload), addr(node_of), addr(out), cfg.host_base, cfg.num_hosts]))
    return out


# ---------------------------------------------------------------- K15

def _alpha_scale(cfg) -> float:
    """XLA folds dt_s / (tau_ns * 1e-9) with dt_s = dt_ns * 1e-9 into one
    multiply of f64(dt_ns) by this constant."""
    return 1e-9 * (1.0 / (cfg.fluid_tau_ns * 1e-9))


def fluid_advance_plain(cfg, fp: FluidParams, st: FluidState, fg_link_bytes, now: int,
                        window_end: int, done: bool, bg_bytes, bg_dropped):
    """One forward-Euler step over [now, window_end) (JAX `fluid_advance`).
    Returns (FluidState', bg_bytes', bg_dropped'); on the done-round or an
    empty window the state is held and the counters unchanged."""
    k = st.rates.shape[0]
    dt_ns = max(window_end - now, 0)
    dt_s = float(dt_ns) * 1e-9
    live = dt_s > 0.0
    if done or not live:
        return st, bg_bytes, bg_dropped
    active = (fp.win_start <= now) & (now < fp.win_end)
    demand = torch.where(active, fp.demand, 0.0)
    alpha = min(float(dt_ns) * _alpha_scale(cfg), 1.0)
    r = fma_f64(torch.full_like(st.rates, alpha), demand - st.rates, st.rates)
    # a true division: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, so the divisor is a tensor on the device
    fg_rate = fg_link_bytes.to(torch.float64) / torch.tensor(
        max(dt_s, 1e-18), dtype=torch.float64, device=fg_link_bytes.device)
    bg = _link_load(fp, r, cfg.fluid_links)
    avail = torch.clamp_min(fp.capacity - fg_rate, 0.0)
    share = torch.where(bg > avail, avail / torch.clamp_min(bg, 1e-18), 1.0)
    g = torch.minimum(share[fp.src_zone.to(torch.int64)], share[fp.dst_zone.to(torch.int64)])
    carried = r * g
    util = torch.where(fp.capacity > 0.0, (bg + fg_rate) / fp.capacity, 0.0)
    if k <= 32:
        delivered = torch.zeros_like(r[0])
        for i in range(k):
            delivered = fma_f64(r[i], g[i], delivered)
    else:
        delivered = class_sum(carried)
    dropped = class_sum(fma_f64(-r, g, r))
    return (
        FluidState(rates=carried, link_util=util),
        bg_bytes + torch.floor(delivered * dt_s).to(torch.int64),
        bg_dropped + torch.floor(dropped * dt_s).to(torch.int64),
    )


def fluid_advance(cfg, fp: FluidParams, st: FluidState, fg_link_bytes, now: int,
                  window_end: int, done: bool, bg_bytes, bg_dropped):
    """`fluid_advance_plain` as K15 on CUDA: one block, writing the state's
    rates and link_util and the two counters in place (`now`, `window_end`
    and `done` are launch arguments: no host sync)."""
    if on_cpu(st.rates):
        return fluid_advance_plain(cfg, fp, st, fg_link_bytes, now, window_end, done,
                                   bg_bytes, bg_dropped)
    k, n = cfg.fluid_classes, cfg.fluid_links
    for x, dt, shape, name in (
        (fp.src_zone, torch.int32, (k,), "src_zone"), (fp.dst_zone, torch.int32, (k,), "dst_zone"),
        (fp.demand, torch.float64, (k,), "demand"), (fp.win_start, torch.int64, (k,), "win_start"),
        (fp.win_end, torch.int64, (k,), "win_end"), (fp.capacity, torch.float64, (n,), "capacity"),
        (st.rates, torch.float64, (k,), "rates"), (st.link_util, torch.float64, (n,), "link_util"),
        (fg_link_bytes, torch.int64, (n,), "fg_link_bytes"),
        (bg_bytes, torch.int64, (), "fl_bg_bytes"), (bg_dropped, torch.int64, (), "fl_bg_dropped"),
    ):
        check(x, dt, shape, name)
    _advance_k(arg_block([
        k, n, int(now), int(window_end), int(bool(done)), _as_i64(_alpha_scale(cfg)),
        *(addr(x) for x in fp), addr(st.rates), addr(st.link_util), addr(fg_link_bytes),
        addr(bg_bytes), addr(bg_dropped),
    ]))
    return st, bg_bytes, bg_dropped


# ---------------------------------------------------------------- K16

def fluid_host_effects_plain(cfg, fp: FluidParams, st: FluidState, node_idx):
    """Per-host coupling at round start from the previous round's state
    (JAX `fluid_host_effects`): (loss f32[H], lat_x1000 i64[H]), both
    ramping from `util_threshold` to full overload and both gated on
    background load being present on the host's link."""
    n = cfg.fluid_links
    idx = torch.clamp(node_idx.to(torch.int64), 0, n - 1)
    bg_h = _link_load(fp, st.rates, n)[idx] > 0.0
    thr = cfg.fluid_util_threshold
    over = torch.clamp((st.link_util[idx] - thr) * (1.0 / max(1.0 - thr, 1e-9)), 0.0, 1.0)
    over = torch.where(bg_h, over, 0.0)
    loss = (over * cfg.fluid_loss_max).to(torch.float32)
    lat = LAT_SCALE + torch.floor(over * float(cfg.fluid_lat_max_x1000 - LAT_SCALE)).to(torch.int64)
    return loss, torch.clamp_min(lat, LAT_SCALE)


def fluid_host_effects(cfg, fp: FluidParams, st: FluidState, node_of):
    """`fluid_host_effects_plain` for every host (node by the affine divide
    or `node_of`) as K16 on CUDA, one thread per host."""
    h = cfg.hosts_per_shard
    if on_cpu(st.rates):
        return fluid_host_effects_plain(cfg, fp, st, host_nodes(cfg, node_of, h, cfg.host_base))
    k, n = cfg.fluid_classes, cfg.fluid_links
    check(node_of, torch.int32, (cfg.num_hosts,), "node_of")
    check(st.rates, torch.float64, (k,), "rates")
    check(st.link_util, torch.float64, (n,), "link_util")
    check(fp.src_zone, torch.int32, (k,), "src_zone")
    check(fp.dst_zone, torch.int32, (k,), "dst_zone")
    loss = torch.empty((h,), dtype=torch.float32, device=st.rates.device)
    lat = torch.empty((h,), dtype=torch.int64, device=st.rates.device)
    thr = cfg.fluid_util_threshold
    _effects_k(arg_block([
        h, k, n, cfg.hosts_per_node, _as_i64(thr), _as_i64(1.0 / max(1.0 - thr, 1e-9)),
        _as_i64(cfg.fluid_loss_max), _as_i64(float(cfg.fluid_lat_max_x1000 - LAT_SCALE)),
        addr(node_of), addr(fp.src_zone), addr(fp.dst_zone), addr(st.rates), addr(st.link_util),
        addr(loss), addr(lat), cfg.host_base,
    ]))
    return loss, lat


# ---------------------------------------------------------------- K11's draw

def fluid_send_uniform(seed: int, host_gid: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the counter draw keyed on (fluid seed, global host
    id, the host's emission counter), uint64 lanes carried as int64. K11
    computes it on the card (csrc/event_math.cuh fluid_uniform)."""
    x = u64(seed) + host_gid * _HOST_STRIDE + ctr * _CTR_STRIDE
    _, z = _splitmix64(x)
    _, u = _splitmix64(z)
    return lshr(u, 40).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------- reports

def assemble_fluid_report(*, stats, fluid_state, cfg) -> dict:
    """The sim-stats `fluid{}` block, in the JAX package's shape."""
    bg_bytes = int(stats.fl_bg_bytes)
    bg_dropped = int(stats.fl_bg_dropped)
    offered = bg_bytes + bg_dropped
    util = [round(float(u), 4) for u in fluid_state.link_util.cpu().numpy()]
    return {
        "classes": int(cfg.fluid_classes),
        "links": int(cfg.fluid_links),
        "bg_bytes": bg_bytes,
        "bg_dropped": bg_dropped,
        "delivered_share": round(bg_bytes / offered, 4) if offered else None,
        "link_util_final": util,
        "link_util_max": max(util) if util else 0.0,
        "loss_max": float(cfg.fluid_loss_max),
        "latency_factor_max": cfg.fluid_lat_max_x1000 / LAT_SCALE,
    }


KERNELS: dict[str, Any] = {
    "fluid_fg_link_bytes": _fg_k,
    "fluid_advance": _advance_k,
    "fluid_host_effects": _effects_k,
}
