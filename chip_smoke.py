"""Smoke run of the PyTorch port (`shadow_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. Phases, each printed as one JSON line; any failure exits
non-zero (on one H100 the whole script takes a few minutes):

  1. environment: torch/CUDA versions and the card's name and power limit;
     build the hand-written kernels (csrc/*.cu, one nvcc per source, in
     parallel) and report the build seconds;
  2. kernels K1-K4 against their plain PyTorch versions on the card, on
     seeded random inputs at the main path's shapes (H = 10,000 hosts,
     C = 64 slots, P = 4 payload words, N = 120,000 exchange rows) plus an
     overflow case (nearly full queues; one destination with more rows than
     the insert cap). All outputs are integers: exact equality is required.
     Each kernel's device time per call (torch.profiler) and call time
     (CUDA events around back-to-back calls, launch overhead included), its
     plain version's device time and a library yardstick where one exists;
  3. PHOLD's float32 log on the card against the CPU over all 2^24 inputs
     the model can draw (exact equality);
  4. the full-width main path: 10,000 PHOLD hosts for 4 simulated seconds
     (queue capacity 64, send budget 12, one device) through
     `shadow_tpu_torch.sim.Simulation`, which must reproduce the JAX
     reference's determinism digest d6c9a273e3a92bb7 and 668,614 events with
     every kernel's launch counter non-zero;
  5. where the anchor's time goes: one steady 16-round chunk under
     torch.profiler (device busy share, the port's kernels, top device ops);
  6. small configs (udp_echo with a server overflowing its queue, PHOLD on
     a two-node graph with loss and jitter): the card's report must equal
     the CPU path's;
  7. kernels K5-K8 (pop_k, clear_popped, the bucketed push, block_minima)
     and K3 with push reserves against their plain versions at bench
     config 6's shapes (H = 10,000, C = 28, block 7, K = 4, P = 4, the 12
     push ports of a K = 4 tgen microstep) on seeded slabs with empty hosts,
     full blocks, time ties, partial executed prefixes and reserves that
     force drops; exact equality, with the same timings as phase 2;
  8. the second main path: bench config 6 (10,000 tgen-TCP hosts on the
     10x10 torus at 50 ms, K = 4, bucketed queue of 28 slots in blocks of
     7, 24 sends per host per round) cut to 10 simulated seconds, which must
     reproduce the JAX package's digest, event count, drop counters and
     tgen report for that depth, with every kernel of the path launched;
  9. where its time goes: one steady 8-round chunk under torch.profiler
     (busy share, launches per microstep, the plain per-event chain B5 and
     outbox append B4 per microstep, the port's kernels);
 10. config 6 small (128 hosts on a 4x4 torus) for K in {1, 4} x {flat,
     bucketed}, a lossy torus and a tight capacity: card == CPU.

The last lines are the kernel table (one JSON object), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

ANCHOR_DIGEST = "d6c9a273e3a92bb7"
ANCHOR_EVENTS = 668_614
# bench config 6 at full width cut to TGEN_STOP: the JAX package's report on
# the CPU (digests, events, drops and the tgen report do not depend on K or
# the queue layout; microsteps and popk_deferred are those of K = 4)
TGEN_STOP = "10 s"
TGEN_REF = {
    "determinism_digest": "048dd065b5674234",
    "events_processed": 18_793_550,
    "rounds": 200,
    "packets_sent": 13_462_070,
    "packets_delivered": 13_382_220,
    "packets_lost": 0,
    "packets_unreachable": 0,
    "packets_codel_dropped": 0,
    "queue_overflow_dropped": 0,
    "packets_budget_dropped": 0,
    "outbox_overflow_dropped": 0,
    "queue_occupancy_hwm": 25,
    "outbox_send_hwm": 24,
    "monotonic_violations": 0,
    "bucket_cache_rebuilds": 199,
    "microsteps": 1406,
    "popk_deferred": 4322,
    "model_report": {
        "flows_completed": 79_740, "flows_expected": 640_000,
        "data_segments_sent": 8_748_800, "retransmits": 0, "fast_retransmits": 0,
        "timeouts": 110, "dup_segments": 0, "mean_fct_ms": 1101.755706044645,
        "payload_bytes_received": 12_772_780_800,
    },
}
# config 6's queue shapes: hosts, slots, block, K, push ports of a K = 4
# tgen microstep (ingress requeue + the model's two pushes, per event)
H6, C6, BLK6, K6, NP6 = 10_000, 28, 7, 4, 12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (fp32 table entry)
# NP: push ports per microstep on the anchor's path (ingress requeue + PHOLD's one
# local push); R_CAP: the anchor's insert cap, min(max_round_inserts, C)
H, C, P, NP, B, R_CAP = 10_000, 64, 4, 2, 12, 64
TIME_MAX = (1 << 63) - 1

PHOLD_GML = """
graph [
  directed 0
  node [
    id 0
    host_bandwidth_down "1 Gbit"
    host_bandwidth_up "1 Gbit"
  ]
  edge [ source 0 target 0 latency "50 ms" packet_loss 0.0 ]
]
"""

TWO_NODE_GML = """
graph [
  directed 1
  node [ id 0 host_bandwidth_down "100 Mbit" host_bandwidth_up "100 Mbit" ]
  node [ id 1 host_bandwidth_down "10 Mbit" host_bandwidth_up "10 Mbit" ]
  edge [ source 0 target 0 latency "20 ms" packet_loss 0.0 ]
  edge [ source 1 target 1 latency "25 ms" packet_loss 0.0 ]
  edge [ source 0 target 1 latency "40 ms" packet_loss 0.05 jitter "5 ms" ]
  edge [ source 1 target 0 latency "45 ms" packet_loss 0.02 ]
]
"""


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def torus_gml(side: int, lat_ms: int = 10) -> str:
    """The JAX repo's bench.py torus (a copy: bench.py imports JAX)."""
    lines = ["graph [", "  directed 0"]
    for i in range(side * side):
        lines.append(
            f'  node [ id {i} host_bandwidth_down "1 Gbit" '
            f'host_bandwidth_up "1 Gbit" ]'
        )
    for r in range(side):
        for c in range(side):
            i = r * side + c
            right = r * side + (c + 1) % side
            down = ((r + 1) % side) * side + c
            lines.append(f'  edge [ source {i} target {i} latency "{lat_ms} ms" ]')
            if right != i:
                lines.append(f'  edge [ source {i} target {right} latency "{lat_ms} ms" ]')
            if down != i:
                lines.append(f'  edge [ source {i} target {down} latency "{lat_ms} ms" ]')
    lines.append("]")
    return "\n".join(lines)


def tgen_config(small: bool, stop: str, k: int = 4, block: int = 7, cap: int = 28,
                loss: float = 0.0, rounds_per_chunk: int = 256) -> dict:
    """bench.py baseline_config(6, small) as built off the CPU (K = 4), with
    `stop` for its 120 s; the other arguments vary the queue shape, K, the
    torus's loss and the chunk length (which does not change results)."""
    side = 4 if small else 10
    per_node = 8 if small else 100
    gml = torus_gml(side, lat_ms=50)
    if loss:
        gml = gml.replace('latency "50 ms" ]', f'latency "50 ms" packet_loss {loss} ]')
    ex = {"event_queue_capacity": cap, "microstep_events": k, "sends_per_host_round": 24,
          "rounds_per_chunk": rounds_per_chunk}
    if block:
        ex["event_queue_block"] = block
    return {
        "general": {"stop_time": stop, "seed": 1},
        "network": {"graph": {"type": "gml", "inline": gml}},
        "experimental": ex,
        "hosts": {f"n{i:03d}": {"count": per_node, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 8 if small else 64, "flow_segs": 20 if small else 100,
                           "cwnd_cap": 16, "mss": 1460, "flow_gap": "50 ms", "tx_batch": 2},
        }]} for i in range(side * side)},
    }


def anchor_config() -> dict:
    """The full-width anchor: the JAX repo's 10k-host x 1-device PHOLD
    scaling leg (tools/bench_scale.py leg_config(10000, 1, 4)) without its
    digest-neutral gears and observability riders."""
    return {
        "general": {"stop_time": "4 s", "seed": 1, "heartbeat_interval": "1 s"},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": {"rounds_per_chunk": 16, "sends_per_host_round": 12},
        "hosts": {"node": {"count": 10_000, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64},
        }]}},
    }


def small_configs() -> dict[str, dict]:
    clients = {
        "client": {"count": 120, "network_node_id": 0, "processes": [{
            "model": "udp_echo",
            "model_args": {"role": "client", "peer": "server", "interval": "10 ms",
                           "size_bytes": 200},
        }]},
        "server": {"network_node_id": 0, "processes": [{
            "model": "udp_echo", "model_args": {"role": "server"},
        }]},
    }
    return {
        "echo_overflow": {
            "general": {"stop_time": "1 s", "seed": 7, "heartbeat_interval": None},
            "network": {"graph": {"type": "1_gbit_switch"}},
            "experimental": {"event_queue_capacity": 16, "sends_per_host_round": 4,
                             "max_round_inserts": 8},
            "hosts": clients,
        },
        "phold_two_node": {
            "general": {"stop_time": "3 s", "seed": 11, "heartbeat_interval": None},
            "network": {"graph": {"type": "gml", "inline": TWO_NODE_GML}},
            "experimental": {"event_queue_capacity": 8, "sends_per_host_round": 3},
            "hosts": {
                "a": {"count": 300, "network_node_id": 0, "processes": [{
                    "model": "phold", "model_args": {"population": 3, "mean_delay": "30 ms"}}]},
                "b": {"count": 200, "network_node_id": 1, "processes": [{
                    "model": "phold", "model_args": {"population": 2, "mean_delay": "30 ms"}}]},
            },
        },
    }


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def device_ms(fn, setup=None, reps: int = 20) -> tuple[float, float]:
    """(device ms, call ms) per call of `fn(*setup())`. Device ms: the
    summed duration of every kernel, memset and copy the calls ran on the
    card, from a torch.profiler (CUPTI) trace, per call. Call ms: CUDA
    events around `reps` back-to-back calls, per call — what a caller pays,
    launch overhead included. Inputs are prepared before either window."""
    from torch.profiler import ProfilerActivity, profile

    args = [setup() if setup else () for _ in range(2 * reps + 2)]
    for a in args[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[2 : 2 + reps]:
            fn(*a)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args[2 + reps :]:
        fn(*a)
    end.record()
    end.synchronize()
    call = start.elapsed_time(end) / reps
    return (dev_us / 1e3 / reps if dev_us > 0 else None), call


def time_ms(fn, setup=None) -> float:
    """Device ms per call, or the call ms where the profiler saw nothing."""
    dev, call = device_ms(fn, setup)
    return dev if dev is not None else call


def kernel_ms(fn, setup=None) -> dict:
    dev, call = device_ms(fn, setup)
    return {"ms": dev if dev is not None else call, "call_ms": call,
            "ms_source": "profiler" if dev is not None else "events"}


def bound(bytes_moved: float, int_ops: float) -> tuple[float, str]:
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = int_ops / INT_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# --------------------------------------------------------------------------
# phase 2 inputs (numpy-seeded, moved to the card)
# --------------------------------------------------------------------------


def random_queue(rng: np.random.Generator, fill: np.ndarray, dev, cap: int = C):
    """[H, cap] queue with fill[h] live slots at random positions; times
    drawn from a narrow range so equal times (order-key ties) are common."""
    from shadow_tpu_torch.ops.events import EventQueue, ORDER_MAX

    h = fill.shape[0]
    t = np.full((h, cap), TIME_MAX, np.int64)
    order = np.full((h, cap), ORDER_MAX, np.int64)
    live = rng.random((h, cap)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    t[live] = rng.integers(0, 50, n) * 1_000_000
    hosts = np.nonzero(live)[0]
    order[live] = ((rng.integers(0, 2, n) << 62) | (hosts.astype(np.int64) << 40)
                   | np.arange(n, dtype=np.int64))
    kind = rng.integers(0, 1 << 18, (h, cap)).astype(np.int32)
    payload = rng.integers(-(1 << 31), 1 << 31, (h, cap, P)).astype(np.int32)
    dropped = rng.integers(0, 5, h).astype(np.int64)
    return EventQueue(*(torch.as_tensor(a, device=dev)
                        for a in (t, order, kind, payload, dropped)))


def clone_q(q):
    return type(q)(*(x.clone() for x in q))


def max_abs_err(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(a, b))


def check_equal(name: str, got, want) -> float:
    for i, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{name}: output {i} differs from the plain version")
    return max_abs_err(got, want)


def phase_kernels(dev) -> dict[str, dict]:
    from shadow_tpu_torch.ops import events, merge

    rng = np.random.default_rng(1234)
    results: dict[str, dict] = {}
    cases = {
        "main": rng.integers(0, 8, H),
        "overflow": np.where(rng.random(H) < 0.5, C - rng.integers(0, 3, H), rng.integers(0, C, H)),
    }

    # K1 queue_next_time
    err = 0.0
    for case, fill in cases.items():
        q = random_queue(rng, fill, dev)
        err = max(err, check_equal(f"K1/{case}", [events.next_time(q)],
                                   [events.next_time_plain(q.t)]))
    q = random_queue(rng, cases["main"], dev)
    results["queue_next_time"] = dict(
        **kernel_ms(lambda: events.next_time(q)),
        plain_ms=time_ms(lambda: events.next_time_plain(q.t)),
        library_ms=time_ms(lambda: torch.amin(q.t, dim=1)),
        bound=bound(H * C * 8 + H * 8, H * C),
        max_abs_err=err,
    )

    # K2 queue_pop_min
    err = 0.0
    for case, fill in cases.items():
        q = random_queue(rng, fill, dev)
        limit = 30_000_000
        qa = clone_q(q)
        qa, ev_k, act_k = events.pop_min(qa, limit)
        qb, ev_p, act_p = events.pop_min_plain(clone_q(q), limit)
        err = max(err, check_equal(f"K2/{case}", [*qa, *ev_k, act_k], [*qb, *ev_p, act_p]))
    q = random_queue(rng, cases["main"], dev)
    # bytes this input needs: the whole time plane; order only where t ties
    # an in-window row minimum; the winner's kind/payload read and its slot
    # cleared; one event per host written
    row_min = q.t.min(dim=1, keepdim=True).values
    n_tie = int(((q.t == row_min) & (row_min < 30_000_000)).sum())
    n_act = int((row_min < 30_000_000).sum())
    results["queue_pop_min"] = dict(
        **kernel_ms(lambda qq: events.pop_min(qq, 30_000_000), lambda: (clone_q(q),)),
        plain_ms=time_ms(lambda qq: events.pop_min_plain(qq, 30_000_000), lambda: (clone_q(q),)),
        library_ms=None,
        bound=bound(H * C * 8 + n_tie * 8 + n_act * (4 + 4 * P + 16)
                    + H * (8 + 8 + 4 + 4 * P + 1), H * C + n_tie),
        max_abs_err=err,
    )

    # K3 queue_push_many: NP ports as on the anchor's path, and three ports
    # (requeue + two model ports) as an extra check of the port order
    def pushes_for(seed, n_ports=NP):
        r = np.random.default_rng(seed)
        return [events.Push(
            torch.as_tensor(r.random(H) < 0.6, device=dev),
            torch.as_tensor(r.integers(0, 1 << 40, H), device=dev),
            torch.as_tensor(r.integers(0, 1 << 62, H), device=dev),
            torch.as_tensor(r.integers(0, 1 << 18, H).astype(np.int32), device=dev),
            torch.as_tensor(r.integers(-(1 << 31), 1 << 31, (H, P)).astype(np.int32), device=dev),
        ) for _ in range(n_ports)]

    err = 0.0
    for n_ports in (NP, 3):
        for i, (case, fill) in enumerate(cases.items()):
            q = random_queue(rng, fill, dev)
            pushes = pushes_for(10 * n_ports + i, n_ports)
            qa = events.push_many(clone_q(q), pushes)
            qb = events.push_many_plain(clone_q(q), pushes)
            err = max(err, check_equal(f"K3/{case}/ports={n_ports}", list(qa), list(qb)))
    q = random_queue(rng, cases["main"], dev)
    pushes = pushes_for(99)
    # bytes this input needs: every mask; t/order/kind/payload of the pushes
    # that fire; the time plane of the hosts that receive one; one slot
    # written per landed push; dropped read and written where one overflows
    fired = torch.stack([p.mask for p in pushes]).sum(dim=0)
    free = (q.t == TIME_MAX).sum(dim=1)
    n_fired = int(fired.sum())
    n_recv = int((fired > 0).sum())
    n_landed = int(torch.minimum(fired, free).sum())
    n_over = int((fired > free).sum())
    results["queue_push_many"] = dict(
        **kernel_ms(lambda qq: events.push_many(qq, pushes), lambda: (clone_q(q),)),
        plain_ms=time_ms(lambda qq: events.push_many_plain(qq, pushes), lambda: (clone_q(q),)),
        library_ms=None,
        bound=bound(NP * H + n_fired * (8 + 8 + 4 + 4 * P) + n_recv * C * 8
                    + n_landed * (8 + 8 + 4 + 4 * P) + n_over * 16, n_recv * C + NP * H),
        max_abs_err=err,
    )

    # K4 merge_insert, both shed modes
    def rows(seed, n_valid, hot):
        r = np.random.default_rng(seed)
        n = H * B
        dst = r.integers(0, H, n).astype(np.int32)
        if hot:
            dst[: hot] = 17  # one destination far past the insert cap
        valid = np.zeros(n, bool)
        valid[r.permutation(n)[:n_valid]] = True
        valid[: hot] = True
        t = r.integers(50, 200, n) * 1_000_000
        order = (np.arange(n, dtype=np.int64) * 7919) % (1 << 40) | (r.integers(0, H, n) << 40)
        return [torch.as_tensor(a, device=dev) for a in (
            dst, t, order, r.integers(0, 1 << 18, n).astype(np.int32),
            r.integers(-(1 << 31), 1 << 31, (n, P)).astype(np.int32), valid)]

    err = 0.0
    for i, (case, fill) in enumerate(cases.items()):
        for urgency in (True, False):
            q = random_queue(rng, fill, dev)
            rr = rows(10 + i, 20_000 if case == "main" else 60_000, 0 if case == "main" else 5_000)
            qa = merge.merge_flat_events(clone_q(q), *rr, R_CAP, shed_urgency=urgency)
            qb = merge.merge_flat_events_plain(clone_q(q), *rr, R_CAP, shed_urgency=urgency)
            err = max(err, check_equal(f"K4/{case}/urgency={urgency}", list(qa), list(qb)))
    q = random_queue(rng, cases["main"], dev)
    rr = rows(42, 20_000, 0)
    # bytes this input needs: every valid flag; dst/t/order/kind/payload of
    # the valid rows; the time plane of the hosts that get a segment; one
    # slot written per inserted row; dropped read and written where rows shed
    seg = torch.bincount(rr[0][rr[5]].long(), minlength=H)
    free = (q.t == TIME_MAX).sum(dim=1)
    n_valid = int(seg.sum())
    n_seg = int((seg > 0).sum())
    n_ins = int(torch.minimum(seg, torch.clamp(free, max=R_CAP)).sum())
    n_shed = int((seg > torch.clamp(free, max=R_CAP)).sum())
    results["merge_insert"] = dict(
        **kernel_ms(lambda qq: merge.merge_flat_events(qq, *rr, R_CAP), lambda: (clone_q(q),)),
        plain_ms=time_ms(lambda qq: merge.merge_flat_events_plain(qq, *rr, R_CAP),
                         lambda: (clone_q(q),)),
        # no single PyTorch call computes the merge; the plain version is
        # the torch.sort formulation
        library_ms=None,
        bound=bound(H * B + n_valid * (4 + 8 + 8 + 4 + 4 * P) + n_seg * C * 8
                    + n_ins * (8 + 8 + 4 + 4 * P) + n_shed * 16, H * B + n_valid),
        max_abs_err=err,
    )
    return results


def phase_kernels_cfg6(dev) -> dict[str, dict]:
    """K5-K8, and K3 with push reserves, at config 6's queue shapes."""
    from shadow_tpu_torch.ops import events as ev

    rng = np.random.default_rng(6)
    nb = C6 // BLK6
    limit = 30_000_000

    def fills():
        f = rng.integers(0, C6 + 1, H6)
        f[rng.random(H6) < 0.1] = 0  # empty hosts
        f[rng.random(H6) < 0.1] = C6  # full rows: every block full
        return f

    def bucketed(q):
        return ev.BucketQueue(*q, *ev.block_minima_plain(q.t, q.order, nb))

    def clone_any(q):
        return type(q)(*(x.clone() for x in q))

    def pushes(seed, reserve_hi=5):
        r = np.random.default_rng(seed)
        hosts = np.arange(H6, dtype=np.int64)
        return [ev.Push(*(torch.as_tensor(a, device=dev) for a in (
            r.random(H6) < 0.6,
            r.integers(0, 50, H6) * 1_000_000 + 500,
            (1 << 62) | (hosts << 40) | ((1 << 39) + 64 * seed + port),
            r.integers(0, 1 << 18, H6).astype(np.int32),
            r.integers(-(1 << 31), 1 << 31, (H6, P)).astype(np.int32),
            r.integers(0, reserve_hi, H6).astype(np.int32),
        ))) for port in range(NP6)]

    err = {k: 0.0 for k in ("pop_k", "clear", "bq_push", "push_reserve", "block_minima")}
    n_over_seen = 0
    for case in range(2):
        q = random_queue(rng, fills(), dev, C6)
        got = ev.block_minima(q.t, q.order, nb)
        err["block_minima"] = max(err["block_minima"], check_equal(
            f"K8/{case}", list(got), list(ev.block_minima_plain(q.t, q.order, nb))))
        for lim in (limit, TIME_MAX):
            pk = ev.pop_k(q, lim, K6)
            err["pop_k"] = max(err["pop_k"], check_equal(
                f"K5/{case}", list(pk), list(ev.pop_k_plain(q, lim, K6))))
            m = torch.minimum(
                torch.as_tensor(rng.integers(0, K6 + 1, H6).astype(np.int32), device=dev),
                pk.active.sum(dim=1, dtype=torch.int32))
            for qq in (q, bucketed(q)):
                a = ev.clear_popped(clone_any(qq), pk, m)
                b = ev.clear_popped_plain(clone_any(qq), pk, m)
                err["clear"] = max(err["clear"], check_equal(f"K6/{case}", list(a), list(b)))
        ps = pushes(100 + case)
        a = ev.push_many(clone_any(q), ps)
        b = ev.push_many_plain(clone_any(q), ps)
        err["push_reserve"] = max(err["push_reserve"], check_equal(f"K3r/{case}", list(a), list(b)))
        bq = bucketed(q)
        a = ev.bq_push_many(clone_any(bq), ps)
        b = ev.push_many_plain(clone_any(bq), ps)
        err["bq_push"] = max(err["bq_push"], check_equal(f"K7/{case}", list(a), list(b)))
        n_over_seen += int((b.dropped - q.dropped).sum())
    if not n_over_seen:
        raise AssertionError("K3/K7 check: no push was dropped; the reserve path went untested")

    # timings on one slab, as on the tgen path (bucketed)
    q = random_queue(rng, fills(), dev, C6)
    bq = bucketed(q)
    results: dict[str, dict] = {}
    live = q.t != TIME_MAX
    pk = ev.pop_k_plain(q, limit, K6)
    n_act = int(pk.active.sum())
    # bytes this input needs: the time plane; order only where t equals a
    # selected event's time; the active events' kind/payload; [H, K] out
    n_tie = int((live & (q.t[:, :, None] == pk.t[:, None, :]).any(dim=2)).sum())
    results["queue_pop_k"] = dict(
        **kernel_ms(lambda: ev.pop_k(bq, limit, K6)),
        plain_ms=time_ms(lambda: ev.pop_k_plain(bq, limit, K6)),
        library_ms=None,
        library_why="no single PyTorch call: a top-K over two int64 keys (time, order)",
        bound=bound(H6 * C6 * 8 + n_tie * 8 + n_act * (4 + 4 * P)
                    + H6 * K6 * (8 + 8 + 4 + 4 * P + 1 + 4), H6 * C6 * K6),
        max_abs_err=err["pop_k"],
    )
    m = pk.active.sum(dim=1, dtype=torch.int32)
    after = ev.clear_popped_plain(clone_any(bq), pk, m)
    n_tb = int((after.bfill != bq.bfill).sum())
    # active/idx/m read, one slot cleared per executed event, the touched
    # blocks' slots read and their caches rewritten
    results["queue_clear_popped"] = dict(
        **kernel_ms(lambda qq: ev.clear_popped(qq, pk, m), lambda: (clone_any(bq),)),
        plain_ms=time_ms(lambda qq: ev.clear_popped_plain(qq, pk, m), lambda: (clone_any(bq),)),
        library_ms=None,
        library_why="no single PyTorch call: a scatter clear plus a per-block recompute",
        bound=bound(H6 * K6 * 5 + H6 * 4 + n_act * 16 + n_tb * (BLK6 * 16 + 4 + 20),
                    H6 * K6 + n_tb * BLK6),
        max_abs_err=err["clear"],
    )
    ps = pushes(7)
    fired = torch.stack([x.mask for x in ps]).sum(dim=0)
    free = (~live).sum(dim=1)
    n_fired, n_recv = int(fired.sum()), int((fired > 0).sum())
    flat_after = ev.push_many_plain(clone_any(q), ps)
    n_landed = int((flat_after.t != TIME_MAX).sum() - live.sum())
    n_over = int((flat_after.dropped != q.dropped).sum())
    bq_after = ev.push_many_plain(clone_any(bq), ps)
    n_tb = int((bq_after.bfill != bq.bfill).sum())
    # every mask; the fired pushes' fields and reserves; the time plane of
    # receiving hosts; one slot per landed push; dropped where one
    # overflows; (bucketed) the receiving blocks' caches read and written
    push_bytes = (NP6 * H6 + n_fired * (8 + 8 + 4 + 4 * P + 4) + n_recv * C6 * 8
                  + n_landed * (8 + 8 + 4 + 4 * P) + n_over * 16)
    results["queue_push_many_bucketed"] = dict(
        **kernel_ms(lambda qq: ev.bq_push_many(qq, ps), lambda: (clone_any(bq),)),
        plain_ms=time_ms(lambda qq: ev.push_many_plain(qq, ps), lambda: (clone_any(bq),)),
        library_ms=None,
        library_why="no single PyTorch call: ranked free-slot insertion with drops",
        bound=bound(push_bytes + n_tb * 40, n_recv * C6 + NP6 * H6),
        max_abs_err=err["bq_push"],
    )
    k3r = kernel_ms(lambda qq: ev.push_many(qq, ps), lambda: (clone_any(q),))
    results["queue_push_many_reserve"] = dict(
        ms=k3r["ms"], call_ms=k3r["call_ms"],
        plain_ms=time_ms(lambda qq: ev.push_many_plain(qq, ps), lambda: (clone_any(q),)),
        bound_ms=bound(push_bytes, n_recv * C6 + NP6 * H6)[0],
        ports=NP6, max_abs_err=err["push_reserve"],
    )
    bmin = ev.block_minima_plain(q.t, q.order, nb)[0]
    n_at_min = int((live & (q.t.view(H6, nb, BLK6) == bmin[:, :, None]).view(H6, C6)).sum())
    results["queue_block_minima"] = dict(
        **kernel_ms(lambda: ev.block_minima(q.t, q.order, nb)),
        plain_ms=time_ms(lambda: ev.block_minima_plain(q.t, q.order, nb)),
        library_ms=None,
        library_why="no single PyTorch call: amin gives bt only, not bo or bfill",
        bound=bound(H6 * C6 * 8 + n_at_min * 8 + H6 * nb * 20, H6 * C6),
        max_abs_err=err["block_minima"],
    )
    return results


def phase_log(dev) -> int:
    from shadow_tpu_torch.models.phold import log_f32

    u = torch.arange(1 << 24, dtype=torch.int64).to(torch.float32) * (1.0 / (1 << 24))
    x = torch.maximum(1.0 - u, torch.tensor(1e-7, dtype=torch.float32))
    cpu = log_f32(x)
    gpu = log_f32(x.to(dev)).cpu()
    return int((cpu.view(torch.int32) != gpu.view(torch.int32)).sum())


KERNEL_SYMBOLS = {
    "queue_next_time": ("next_time_kernel",),
    "queue_pop_min": ("pop_min_kernel",),
    "queue_push_many": ("push_many_kernel<false>",),
    "merge_insert": ("histogram_kernel", "scan_kernel", "scatter_kernel", "insert_kernel"),
    "queue_pop_k": ("pop_k_kernel",),
    "queue_clear_popped": ("clear_popped_kernel",),
    "queue_push_many_bucketed": ("push_many_kernel<true>",),
    "queue_block_minima": ("block_minima_kernel",),
}


def phase_anchor_profile() -> dict:
    """Where the anchor's time goes: two unprofiled 16-round chunks (the
    first carries first-use costs), then one chunk under torch.profiler —
    device busy time over wall time, the port's kernels' share, and the top
    device kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    sim = Simulation(ConfigOptions.from_dict(anchor_config()))
    eng, st = sim.engine, sim.state
    walls, advanced = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0, now0 = time.monotonic(), st.now
        st = eng.run_chunk(st, sim.params)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        advanced.append((st.now - now0) / 1e9)
    syncs0 = eng.host_syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        st = eng.run_chunk(st, sim.params)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ours = {
        k: sum(e.self_device_time_total for e in dev if any(t in e.key for t in tags)) / 1e3
        for k, tags in KERNEL_SYMBOLS.items()
    }
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "chunk_rounds": sim.engine_cfg.rounds_per_chunk,
        "chunk_wall_s": walls,
        "steady_sim_s_per_wall_s": advanced[1] / walls[1],
        "profiled_chunk_wall_s": wall,
        "profiled_chunk_host_syncs": eng.host_syncs - syncs0,
        "device_busy_ms": dev_ms,
        "device_busy_share": dev_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in dev),
        "port_kernels_ms": ours,
        "top_device_ops": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def phase_tgen_profile() -> dict:
    """Where config 6's time goes: 8-round chunks, two unprofiled, then one
    under torch.profiler, with the per-event chain (Engine.event_body, B5)
    and the outbox append (B4) marked as ranges so their device time and
    launches per microstep can be read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import shadow_tpu_torch.core.engine as engine_mod
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    # a range's own "kernel" is its span on the device timeline (idle gaps
    # included); its work is the kernels of the ops inside it
    def launches_in(e) -> int:
        return len(e.kernels) + sum(launches_in(c) for c in e.cpu_children)

    def kernel_us_in(e) -> float:
        return sum(k.duration for k in e.kernels) + sum(kernel_us_in(c) for c in e.cpu_children)

    sim = Simulation(ConfigOptions.from_dict(
        tgen_config(False, TGEN_STOP, rounds_per_chunk=8)))
    eng, st = sim.engine, sim.state
    for _ in range(2):
        st = eng.run_chunk(st, sim.params)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    st = eng.run_chunk(st, sim.params)
    torch.cuda.synchronize()
    wall_unprofiled, now0 = time.monotonic() - t0, st.now
    msteps0 = int(st.stats.microsteps.sum())
    syncs0 = eng.host_syncs
    orig_append = engine_mod.outbox_append_multi
    eng.event_body = ranged("B5_event_body", eng.event_body)
    engine_mod.outbox_append_multi = ranged("B4_outbox_append", orig_append)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            st = eng.run_chunk(st, sim.params)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        del eng.event_body
        engine_mod.outbox_append_multi = orig_append
    msteps = int(st.stats.microsteps.sum()) - msteps0
    names = ("B5_event_body", "B4_outbox_append")
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in names]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ranges = {}
    for name in names:
        evs = [e for e in prof.events() if e.name == name]
        ranges[name] = {
            "calls": len(evs),
            "device_ms_per_microstep": sum(
                kernel_us_in(c) for e in evs for c in e.cpu_children) / 1e3 / msteps,
            "launches_per_microstep": sum(
                launches_in(c) for e in evs for c in e.cpu_children) / msteps,
        }
    ours = {
        k: sum(e.self_device_time_total for e in dev if any(t in e.key for t in tags)) / 1e3
        for k, tags in KERNEL_SYMBOLS.items()
    }
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "chunk_rounds": 8,
        "chunk_sim_s": (st.now - now0) / 1e9,
        "unprofiled_chunk_wall_s": wall_unprofiled,
        "profiled_chunk_wall_s": wall,
        "microsteps": msteps,
        "host_syncs": eng.host_syncs - syncs0,
        "device_busy_ms": dev_ms,
        "device_busy_share": dev_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in dev),
        "device_launches_per_microstep": sum(e.count for e in dev) / msteps,
        "ranges": ranges,
        "port_kernels_ms": ours,
        "top_device_ops": [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in top],
    }


def tgen_small_configs() -> dict[str, dict]:
    """Config 6 small (bench.py baseline_config(6, small=True)) cut to 4
    simulated seconds, over K, the queue layout, a lossy torus and a tight
    capacity."""
    stop = "4 s"
    return {
        "k1_flat": tgen_config(True, stop, k=1, block=0),
        "k1_block7": tgen_config(True, stop, k=1, block=7),
        "k4_flat": tgen_config(True, stop, k=4, block=0),
        "k4_block7": tgen_config(True, stop, k=4, block=7),
        "lossy_k4_block7": tgen_config(True, stop, k=4, block=7, loss=0.02),
        "tight_k4_cap9_block3": tgen_config(True, stop, k=4, block=3, cap=9),
    }


def run_config(cfg_dict: dict, device) -> dict:
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    sim = Simulation(ConfigOptions.from_dict(cfg_dict), device=device)
    return sim.run(progress=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import shadow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    from shadow_tpu_torch.ops import KERNELS
    from shadow_tpu_torch.ops.cuda_build import build_all

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.monotonic()
    ptxas = build_all()
    emit("build", seconds=round(time.monotonic() - t0, 3),
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in ptxas.items()})

    kres = phase_kernels(dev)
    emit("kernels_vs_plain", ok=True, exact=True,
         **{k: {kk: vv for kk, vv in v.items() if kk != "bound"} for k, v in kres.items()})

    mism = phase_log(dev)
    emit("phold_log", mismatches=mism, inputs=1 << 24)
    if mism:
        raise AssertionError(f"PHOLD log: {mism} of 2^24 inputs differ between card and CPU")

    for k in KERNELS.values():
        k.launches = 0
    report = run_config(anchor_config(), None)
    launches = {k: v.launches for k, v in KERNELS.items()}
    anchor_path = ("queue_next_time", "queue_pop_min", "queue_push_many", "merge_insert")
    emit("anchor", digest=report["determinism_digest"], events=report["events_processed"],
         wall_seconds=report["wall_seconds"], sim_wall_ratio=report["sim_wall_ratio"],
         rounds=report["rounds"], microsteps=report["microsteps"],
         host_syncs=report["host_syncs"], launches=launches,
         queue_overflow_dropped=report["queue_overflow_dropped"],
         packets_budget_dropped=report["packets_budget_dropped"])
    if report["determinism_digest"] != ANCHOR_DIGEST or report["events_processed"] != ANCHOR_EVENTS:
        raise AssertionError(
            f"anchor: digest {report['determinism_digest']} / events "
            f"{report['events_processed']}, expected {ANCHOR_DIGEST} / {ANCHOR_EVENTS}"
        )
    if not all(launches[k] for k in anchor_path):
        raise AssertionError(f"anchor: a kernel of the main path never launched: {launches}")

    emit("anchor_profile", **phase_anchor_profile())

    keys = ("determinism_digest", "events_processed", "packets_sent", "packets_lost",
            "packets_codel_dropped", "queue_overflow_dropped", "packets_budget_dropped",
            "rounds", "microsteps")
    for name, cfg in small_configs().items():
        a = run_config(cfg, None)
        b = run_config(cfg, "cpu")
        same = {k: a[k] == b[k] for k in keys}
        emit("small_config", name=name, cuda={k: a[k] for k in keys}, equal_to_cpu=all(same.values()))
        if not all(same.values()):
            raise AssertionError(f"{name}: card and CPU reports differ: {same}")

    k6res = phase_kernels_cfg6(dev)
    emit("kernels_cfg6_vs_plain", ok=True, exact=True,
         **{k: {kk: vv for kk, vv in v.items() if kk != "bound"} for k, v in k6res.items()})
    kres["queue_push_many"]["reserve_timing"] = k6res.pop("queue_push_many_reserve")
    kres.update(k6res)

    for k in KERNELS.values():
        k.launches = 0
    report = run_config(tgen_config(False, TGEN_STOP), None)
    tgen_launches = {k: v.launches for k, v in KERNELS.items()}
    tgen_path = ("queue_next_time", "merge_insert", "queue_pop_k", "queue_clear_popped",
                 "queue_push_many_bucketed", "queue_block_minima")
    emit("tgen", **{k: report[k] for k in TGEN_REF}, wall_seconds=report["wall_seconds"],
         sim_wall_ratio=report["sim_wall_ratio"], host_syncs=report["host_syncs"],
         launches=tgen_launches)
    diff = {k: (report[k], v) for k, v in TGEN_REF.items() if report[k] != v}
    if diff:
        raise AssertionError(f"tgen: differs from the JAX reference (port, JAX): {diff}")
    if not all(tgen_launches[k] for k in tgen_path):
        raise AssertionError(f"tgen: a kernel of the path never launched: {tgen_launches}")

    emit("tgen_profile", **phase_tgen_profile())

    keys += ("bucket_cache_rebuilds", "popk_deferred", "model_report")
    prev_threads = torch.get_num_threads()
    for name, cfg in tgen_small_configs().items():
        a = run_config(cfg, None)
        torch.set_num_threads(1)  # tiny tensors: intra-op threads only cost
        try:
            b = run_config(cfg, "cpu")
        finally:
            torch.set_num_threads(prev_threads)
        same = {k: a[k] == b[k] for k in keys}
        emit("tgen_small", name=name, cuda={k: a[k] for k in keys}, equal_to_cpu=all(same.values()))
        if not all(same.values()):
            raise AssertionError(f"{name}: card and CPU reports differ: {same}")
        if name.startswith("lossy") and not (a["packets_lost"] and a["model_report"]["retransmits"]):
            raise AssertionError(f"{name}: no loss or retransmit was exercised")
        if name.startswith("tight") and not a["queue_overflow_dropped"]:
            raise AssertionError(f"{name}: no queue overflow drop was exercised")

    table = []
    sources = {"merge_insert": "shadow_tpu_torch/csrc/merge.cu"}
    replaces = {
        "queue_next_time": "shadow_tpu/ops/events.py:129",
        "queue_pop_min": "shadow_tpu/ops/events.py:138",
        "queue_push_many": "shadow_tpu/ops/events.py:342",
        "merge_insert": "shadow_tpu/ops/merge.py:240",
        "queue_pop_k": "shadow_tpu/ops/events.py:201",
        "queue_clear_popped": "shadow_tpu/ops/events.py:290",
        "queue_push_many_bucketed": "shadow_tpu/ops/events.py:616",
        "queue_block_minima": "shadow_tpu/ops/events.py:460",
    }
    for name, r in kres.items():
        b_ms, b_by = r["bound"]
        # launches: the run of the path the kernel was ported for (K1-K4
        # the PHOLD anchor, K5-K8 the tgen leg); both runs' counts beside
        table.append({
            "name": name, "route": "cuda",
            "source": sources.get(name, "shadow_tpu_torch/csrc/queue.cu"),
            "replaces": replaces[name],
            "launches": launches[name] if name in anchor_path else tgen_launches[name],
            "launches_by_path": {"anchor": launches[name], "tgen": tgen_launches[name]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
