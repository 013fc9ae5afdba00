"""Smoke run of the PyTorch port (`shadow_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit. Phases, each printed as one JSON line; any failure exits
non-zero (on one H100 the whole script takes several minutes; the `total`
line reports it):

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
     every kernel of its path (K1-K4, K9-K11) launched;
  5. where the anchor's time goes: one steady 16-round chunk under
     torch.profiler, with the per-event chain's ingress (K10), the model's
     handler, egress (K11) and the outbox append (K9) as ranges (device
     busy share, launches per microstep, each range's device time and
     launches, the port's kernels, top device ops);
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
  9. where its time goes: one steady 8-round chunk, profiled as in phase 5;
 10. config 6 small (128 hosts on a 4x4 torus) for K in {1, 4} x {flat,
     bucketed}, a lossy torus and a tight capacity: card == CPU;
 11. kernels K9-K11 (outbox append, event ingress, event egress) against
     their plain versions at the anchor's and config 6's shapes (random
     carries with CoDel states about to drop, buckets short of tokens,
     out-of-range destinations, hosts past the send budget, burst ports,
     the event a column of the K-way peek), and K12 (wheel_cancel) and K5
     with per-host limits at config 11's [10,000, 4] wheel and 14-slot
     queue; exact equality, with the timings of phase 2;
 12. the CoDel control law through K10 over every count 1..10^6, card
     against the CPU and against the law computed in Python (exact);
 13. the third path: bench config 11 (config 6 with the timer wheel, 4
     slots in blocks of 2, queue capacity 14 in blocks of 7, K = 1) at full
     width cut to 10 simulated seconds and without its network-observatory
     rider, which must reproduce the JAX package's digest, events, drop
     counters, tgen report, microsteps and wheel block;
 14. config 11 small (128 hosts) as configured, with one wheel slot
     (timers spill) and on a lossy torus: card == CPU;
 15. the exchange merges on a gear-sliced outbox: K4 with a column limit
     and K13 (merge_scatter) against their plain versions at bench config
     2's shape (H = 10,000, C = 16, a [10,000, 6] outbox read through 1, 3
     and 6 columns) and the anchor's (C = 64, a 12-wide outbox through 3
     and 12), on loads that fit, one destination past the insert cap,
     nearly full queues (K13's K4 branch) and a round with no sends, in
     both shed modes; exact equality, with the timings of phase 2;
 16. the anchor as configured: tools/bench_scale.py leg_config(10000, 1, 4)
     without only its observability rider, so merge gears are on; it must
     give the anchor's digest and events and the JAX gears block;
 17. the 40k-host world-1 scaling leg (leg_config(40000, 1, 2), the same
     cut): digest, events and gears block of the JAX package;
 18. bench config 2 at full width (10,000 PHOLD hosts, 100 per node on
     the 10x10 torus at 50 ms, capacity 16, send budget 6, 512 rounds per
     chunk, merge gears auto) cut to 60 simulated seconds (three chunks):
     the JAX package's report, gears block included; then again with
     merge_scatter on, which must give the same report through K13;
 19. bench config 5 at full width as configured: 1,000,000 timer hosts for
     30 simulated seconds, shapes auto-sized (capacity 4, budget 1, 8
     rounds per chunk), so the gear ladder is empty and gears turn
     themselves off: the JAX package's digest, events and drops, the wall
     time and the card's peak allocated memory;
 20. config 2 small and config 5 small as configured, config 2 small with
     the gear controller started at its lowest gear (forced replays) and
     config 2 small with merge_scatter on a lossy torus at capacity 4 (some
     rounds take K13's K4 branch): card == CPU, gears blocks included.

The phases run in the order 1-3, 7, 11, 12, 15, 4-6, 8-10, 13, 14, 16-20,
so that every kernel's bound is counted before the profiles (5, 9) hold
the kernels' in-path device times against it. A profiler reading below the
kernel's bound (the least time the card needs for the work) is a
misattributed trace: the kernel phases then take the queued timing, the
profiles report no time for that kernel.

The last lines are the kernel table (one JSON object), the card's
`nvidia-smi` name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

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
# bench config 11 (config 6 with the timer wheel: 4 slots in blocks of 2,
# capacity 14 in blocks of 7, K = 1) at full width cut to CFG11_STOP, without
# its network-observatory rider: the JAX package's report on the CPU
CFG11_STOP = "10 s"
CFG11_REF = {
    "determinism_digest": "35e000d62342a79f",
    "events_processed": 14_072_640,
    "rounds": 200,
    "packets_sent": 9_887_240,
    "packets_delivered": 9_756_750,
    "packets_lost": 0,
    "packets_unreachable": 0,
    "packets_codel_dropped": 0,
    "queue_overflow_dropped": 120_400,
    "packets_budget_dropped": 110,
    "outbox_overflow_dropped": 0,
    "queue_occupancy_hwm": 14,
    "outbox_send_hwm": 24,
    "monotonic_violations": 0,
    "bucket_cache_rebuilds": 200,
    "microsteps": 1942,
    "popk_deferred": 0,
    "model_report": {
        "flows_completed": 59_760, "flows_expected": 640_000,
        "data_segments_sent": 5_979_690, "retransmits": 119_920, "fast_retransmits": 59_870,
        "timeouts": 190, "dup_segments": 740, "mean_fct_ms": 1601.3935460133869,
        "payload_bytes_received": 8_728_931_200,
    },
    "wheel": {"slots": 4, "block": 2, "occupancy_hwm": 2, "spilled": 0, "dropped": 0},
}
# the scaling legs with their merge gears: the JAX package's gears blocks
# for the anchor (BENCH_r07_scale.json, the 10k x world-1 row) and the
# 40k-host world-1 leg (same file)
ANCHOR_GEARS = {"ladder": [1, 3, 6, 12], "chunks_per_gear": {"6": 3, "12": 3}, "replays": 0}
SCALE40K_REF = {
    "determinism_digest": "c2510c8c586dc77b", "events_processed": 1_395_073,
    "gears": {"ladder": [1, 3, 6, 12], "chunks_per_gear": {"12": 3}, "replays": 0},
}
# bench config 2 at full width cut to CFG2_STOP (three 512-round chunks):
# the JAX package's report on the CPU (the same with merge_scatter on). Its
# three chunks stay at the top gear: the 512-round high-water is 5 of 6
CFG2_STOP = "60 s"
CFG2_REF = {
    "determinism_digest": "1bfd7953b4bb5c1e",
    "events_processed": 5_342_188,
    "rounds": 1200,
    "microsteps": 6435,
    "packets_sent": 2_676_641,
    "packets_delivered": 2_665_547,
    "packets_lost": 0,
    "packets_unreachable": 0,
    "packets_codel_dropped": 0,
    "queue_overflow_dropped": 0,
    "packets_budget_dropped": 0,
    "outbox_overflow_dropped": 0,
    "queue_occupancy_hwm": 12,
    "outbox_send_hwm": 5,
    "monotonic_violations": 0,
    "bucket_cache_rebuilds": 0,
    "popk_deferred": 0,
    "model_report": {"total_events": 5_342_188, "min": 419, "max": 654},
    "gears": {"ladder": [1, 3, 6], "chunks_per_gear": {"6": 3}, "replays": 0},
}
# bench config 5 at full width as configured: the JAX package's report on
# the CPU (no gears block: a send budget of 1 leaves no ladder)
CFG5_REF = {
    "determinism_digest": "1754800000000000",
    "events_processed": 30_000_000,
    "rounds": 30,
    "microsteps": 30,
    "simulated_seconds": 29.05,
    "packets_sent": 0,
    "packets_delivered": 0,
    "packets_lost": 0,
    "packets_unreachable": 0,
    "packets_codel_dropped": 0,
    "queue_overflow_dropped": 0,
    "packets_budget_dropped": 0,
    "outbox_overflow_dropped": 0,
    "queue_occupancy_hwm": 1,
    "outbox_send_hwm": 0,
    "monotonic_violations": 0,
    "model_report": {"total_fires": 30_000_000, "min_fires": 30, "max_fires": 30},
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


def cfg11_config(small: bool, stop: str, wheel: int = 4, loss: float = 0.0) -> dict:
    """bench.py baseline_config(11, small) without its `observability:
    {network: true}` rider (the port has no network observatory; the rider
    changes no digest, tests/test_torch_wheel.py): config 6 with the timer
    wheel, capacity 14 in blocks of 7, K = 1, and `stop` for its 120 s."""
    c = tgen_config(small, stop, k=1, block=7, cap=14, loss=loss)
    c["experimental"]["timer_wheel"] = wheel
    return c


def anchor_config(gears: bool = False, hosts: int = 10_000, stop_s: int = 4) -> dict:
    """The full-width anchor: the JAX repo's 10k-host x 1-device PHOLD
    scaling leg (tools/bench_scale.py leg_config(10000, 1, 4)) without its
    observability rider, and unless `gears` without its merge gears too
    (both digest-neutral); `hosts` and `stop_s` give the other world-1
    legs (leg_config(hosts, 1, stop_s))."""
    ex = {"rounds_per_chunk": 16, "sends_per_host_round": 12}
    if gears:
        ex["merge_gears"] = "auto"
    return {
        "general": {"stop_time": f"{stop_s} s", "seed": 1, "heartbeat_interval": "1 s"},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": ex,
        "hosts": {"node": {"count": hosts, "network_node_id": 0, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64},
        }]}},
    }


def cfg2_config(small: bool, stop: str = "120 s", scatter: bool = False, loss: float = 0.0,
                cap: int = 16) -> dict:
    """bench.py baseline_config(2, small): PHOLD on the 10x10 torus at 50 ms
    (4x4 small), 100 hosts per node (8 small), capacity 16, send budget 6,
    512 rounds per chunk, merge gears auto; `stop` for its 120 s, and the
    scatter merge, a lossy torus or another capacity where asked."""
    side = 4 if small else 10
    per_node = 8 if small else 100
    gml = torus_gml(side, lat_ms=50)
    if loss:
        gml = gml.replace('latency "50 ms" ]', f'latency "50 ms" packet_loss {loss} ]')
    ex = {"event_queue_capacity": cap, "sends_per_host_round": 6, "rounds_per_chunk": 512,
          "merge_gears": "auto"}
    if scatter:
        ex["merge_scatter"] = True
    return {
        "general": {"stop_time": stop, "seed": 1},
        "network": {"graph": {"type": "gml", "inline": gml}},
        "experimental": ex,
        "hosts": {f"n{i:03d}": {"count": per_node, "network_node_id": i, "processes": [{
            "model": "phold",
            "model_args": {"population": 2, "mean_delay": "200 ms", "size_bytes": 64},
        }]} for i in range(side * side)},
    }


def cfg5_config(small: bool) -> dict:
    """bench.py baseline_config(5, small) as configured: timer hosts (4,096
    ticking every 100 ms small; 1,000,000 every second), 30 simulated
    seconds, shapes auto-sized, merge gears auto."""
    return {
        "general": {"stop_time": "30 s", "seed": 1},
        "network": {"graph": {"type": "gml", "inline": PHOLD_GML}},
        "experimental": {"merge_gears": "auto"},
        "hosts": {"t": {"count": 4096 if small else 1_000_000, "network_node_id": 0,
                        "processes": [{"model": "timer", "model_args": {
                            "interval": "100 ms" if small else "1 s"}}]}},
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


def device_ms(fn, setup=None, reps: int = 20, symbols=None):
    """(device ms, call ms, queued ms) per call of `fn(*setup())`; inputs
    are prepared before every window.

    Device ms: from a torch.profiler (CUPTI) trace, the summed duration per
    call of the kernels whose names contain one of `symbols` (every kernel,
    memset and copy when `symbols` is None); None when the trace holds none
    of them, or (with `symbols`) a count of them that is not a whole
    multiple of `reps` — the trace then missed some launches. Call ms:
    CUDA events around `reps` back-to-back calls — what a caller pays,
    launch overhead included. Queued ms: CUDA events around
    `reps` calls queued behind a sleep on the card, so that they run back
    to back on the device without waiting for the host: their device time,
    gaps between launches included."""
    from torch.profiler import ProfilerActivity, profile

    args = [setup() if setup else () for _ in range(3 * reps + 2)]
    for a in args[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[2 : 2 + reps]:
            fn(*a)
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (symbols is None or any(t in e.key for t in symbols))]
    dev_us = sum(e.self_device_time_total for e in seen)
    if symbols is not None and sum(e.count for e in seen) % reps:
        dev_us = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args[2 + reps : 2 + 2 * reps]:
        fn(*a)
    end.record()
    end.synchronize()
    call = start.elapsed_time(end) / reps
    # hold the card for 4x the host's enqueue time of the calls (~2 GHz)
    torch.cuda._sleep(int(4 * reps * call * 1e-3 * 2e9) + 1_000_000)
    start.record()
    for a in args[2 + 2 * reps :]:
        fn(*a)
    end.record()
    end.synchronize()
    queued = start.elapsed_time(end) / reps
    return (dev_us / 1e3 / reps if dev_us > 0 else None), call, queued


def time_ms(fn, setup=None) -> float:
    """Device ms per call of a plain version (all its kernels), or the
    queued ms where the profiler saw nothing."""
    dev, _, queued = device_ms(fn, setup)
    return dev if dev is not None else queued


def kernel_ms(name: str, fn, setup=None) -> dict:
    """Timings of one hand-written kernel's wrapper: `ms` is the kernel's
    own device time from the profiler, or the queued ms where the trace
    does not hold it (then the wrapper's other device work is included).
    `settle` then holds `ms` against the kernel's bound."""
    dev, call, queued = device_ms(fn, setup, symbols=KERNEL_SYMBOLS[name])
    return {"ms": dev if dev is not None else queued, "call_ms": call, "queued_ms": queued,
            "ms_source": "profiler" if dev is not None else "queued_events"}


def settle(name: str, r: dict, bound_ms: float) -> dict:
    """Hold a kernel's timing against its bound: a profiler reading below
    the least time the card needs for the work is a misattributed trace,
    so it is rejected (kept as `profiler_ms_rejected`) and the queued
    timing stands; a queued timing below the bound fails the run."""
    if r["ms_source"] == "profiler" and r["ms"] < bound_ms:
        r["profiler_ms_rejected"] = r["ms"]
        r["ms"], r["ms_source"] = r["queued_ms"], "queued_events"
    if r["ms"] < bound_ms:
        raise AssertionError(f"{name}: {r['ms']} ms per call is below its bound {bound_ms} ms")
    return r


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
        **kernel_ms("queue_next_time", lambda: events.next_time(q)),
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
        **kernel_ms("queue_pop_min", lambda qq: events.pop_min(qq, 30_000_000),
            lambda: (clone_q(q),)),
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
        **kernel_ms("queue_push_many", lambda qq: events.push_many(qq, pushes),
            lambda: (clone_q(q),)),
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
        **kernel_ms("merge_insert", lambda qq: merge.merge_flat_events(qq, *rr, R_CAP),
            lambda: (clone_q(q),)),
        plain_ms=time_ms(lambda qq: merge.merge_flat_events_plain(qq, *rr, R_CAP),
                         lambda: (clone_q(q),)),
        # no single PyTorch call computes the merge; the plain version is
        # the torch.sort formulation
        library_ms=None,
        bound=bound(H * B + n_valid * (4 + 8 + 8 + 4 + 4 * P) + n_seg * C * 8
                    + n_ins * (8 + 8 + 4 + 4 * P) + n_shed * 16, H * B + n_valid),
        max_abs_err=err,
    )
    for name, r in results.items():
        settle(name, r, r["bound"][0])
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
        **kernel_ms("queue_pop_k", lambda: ev.pop_k(bq, limit, K6)),
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
        **kernel_ms("queue_clear_popped", lambda qq: ev.clear_popped(qq, pk, m),
            lambda: (clone_any(bq),)),
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
        **kernel_ms("queue_push_many_bucketed", lambda qq: ev.bq_push_many(qq, ps),
            lambda: (clone_any(bq),)),
        plain_ms=time_ms(lambda qq: ev.push_many_plain(qq, ps), lambda: (clone_any(bq),)),
        library_ms=None,
        library_why="no single PyTorch call: ranked free-slot insertion with drops",
        bound=bound(push_bytes + n_tb * 40, n_recv * C6 + NP6 * H6),
        max_abs_err=err["bq_push"],
    )
    k3r = kernel_ms("queue_push_many", lambda qq: ev.push_many(qq, ps), lambda: (clone_any(q),))
    results["queue_push_many_reserve"] = dict(
        **k3r,
        plain_ms=time_ms(lambda qq: ev.push_many_plain(qq, ps), lambda: (clone_any(q),)),
        bound_ms=bound(push_bytes, n_recv * C6 + NP6 * H6)[0],
        ports=NP6, max_abs_err=err["push_reserve"],
    )
    bmin = ev.block_minima_plain(q.t, q.order, nb)[0]
    n_at_min = int((live & (q.t.view(H6, nb, BLK6) == bmin[:, :, None]).view(H6, C6)).sum())
    results["queue_block_minima"] = dict(
        **kernel_ms("queue_block_minima", lambda: ev.block_minima(q.t, q.order, nb)),
        plain_ms=time_ms(lambda: ev.block_minima_plain(q.t, q.order, nb)),
        library_ms=None,
        library_why="no single PyTorch call: amin gives bt only, not bo or bfill",
        bound=bound(H6 * C6 * 8 + n_at_min * 8 + H6 * nb * 20, H6 * C6),
        max_abs_err=err["block_minima"],
    )
    for name, r in results.items():
        settle(name, r, r["bound"][0] if "bound" in r else r["bound_ms"])
    return results


def phase_kernels_merge(dev) -> dict[str, dict]:
    """K4 with a column limit and K13 against their plain versions on the
    queues and [H, B] outboxes of `shadow_tpu_torch.testing.merge_case`, at
    config 2's shape (C = 16, B = 6, columns 1, 3, 6) and the anchor's (C =
    64, B = 12, columns 3, 12), every load, both shed modes; the insert cap
    is the capacity, as on both paths. Exact equality. Timings: K13 on the
    `fit` load at config 2's full width (its fast path, the path's common
    case), K4 through 3 of the 6 columns (a gear below the top)."""
    from shadow_tpu_torch.ops import merge
    from shadow_tpu_torch.ops.events import EventQueue
    from shadow_tpu_torch.testing import MERGE_LOADS, merge_case, merge_fits

    shapes = {"cfg2": (H, 16, 6, (1, 3, 6)), "anchor": (H, C, B, (3, 12))}
    kernels = {"merge_insert": (merge.merge_flat_events, merge.merge_flat_events_plain),
               "merge_scatter": (merge.merge_scatter_free, merge.merge_scatter_free_plain)}
    err = {k: 0.0 for k in kernels}
    branches = {"fast": 0, "k4": 0}

    def on_dev(arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    seed = 500
    for shape, (h, cap, b, gcs) in shapes.items():
        for gc in gcs:
            for load in MERGE_LOADS:
                seed += 1
                q, ob = merge_case(seed, h, cap, b, gc, load)
                branches["fast" if merge_fits(q, ob, gc, cap) else "k4"] += 1
                rows = on_dev(ob)
                for urgency in (True, False):
                    for name, (fn, plain) in kernels.items():
                        got = fn(EventQueue(*on_dev(q)), *rows, None, cap, urgency, cols=gc)
                        want = plain(EventQueue(*on_dev(q)), *rows, None, cap, urgency, cols=gc)
                        err[name] = max(err[name], check_equal(
                            f"{name}/{shape}/cols={gc}/{load}/urgency={urgency}",
                            list(got), list(want)))
    if not (branches["fast"] and branches["k4"]):
        raise AssertionError(f"K13 check: a branch went untested: {branches}")

    def bytes_needed(q, ob, gc, cap, scatter):
        """The row columns' dst and t; the valid rows' order, kind and
        payload; the time plane of the hosts that get rows; one slot per
        inserted row; dropped read and written where rows shed."""
        dst, t = ob[0][:, :gc].reshape(-1), ob[1][:, :gc].reshape(-1)
        h = q[0].shape[0]
        ok = (t != TIME_MAX) & (dst >= 0) & (dst < h)
        seg = np.bincount(dst[ok], minlength=h)
        room = np.minimum((q[0] == TIME_MAX).sum(axis=1), cap)
        ins = seg if scatter else np.minimum(seg, room)
        n_valid = int(ok.sum())
        return ((dst.size * (4 + 8) + n_valid * (8 + 4 + 4 * P) + int((seg > 0).sum()) * cap * 8
                 + int(ins.sum()) * (8 + 8 + 4 + 4 * P) + int((seg > ins).sum()) * 16),
                dst.size + n_valid)

    results = {}
    for name, gc, load, scatter in (("merge_scatter", 6, "fit", True),
                                    ("merge_insert_cols", 3, "fit", False)):
        q, ob = merge_case(42, H, 16, 6, gc, load)
        rows = on_dev(ob)
        fn, plain = kernels["merge_scatter" if scatter else "merge_insert"]
        r = kernel_ms("merge_scatter" if scatter else "merge_insert",
                      lambda qq: fn(qq, *rows, None, 16, True, cols=gc),
                      lambda: (EventQueue(*on_dev(q)),))
        r["plain_ms"] = time_ms(lambda qq: plain(qq, *rows, None, 16, True, cols=gc),
                                lambda: (EventQueue(*on_dev(q)),))
        r["bound"] = bound(*bytes_needed(q, ob, gc, 16, scatter))
        r["library_ms"] = None
        r["library_why"] = "no single PyTorch call computes the merge"
        r["shape"] = {"hosts": H, "capacity": 16, "outbox": [H, 6], "cols": gc, "load": load}
        r["max_abs_err"] = err["merge_scatter" if scatter else "merge_insert"]
        settle(name, r, r["bound"][0])
        results[name] = r
    results["merge_scatter"]["branches_checked"] = branches
    return results


def io_bytes(reads=(), writes=(), inplace=()) -> int:
    """Bytes a function must move: each input read once, each output
    written once, and each in-place lane read and written where it changed
    ((before, after) pairs)."""
    n = sum(x.numel() * x.element_size() for x in reads if x is not None)
    n += sum(x.numel() * x.element_size() for x in writes if x is not None)
    n += sum(2 * int((a != b).sum()) * a.element_size() for a, b in inplace)
    return n


def phase_kernels_chain(dev) -> dict[str, dict]:
    """K9-K11 against their plain versions at the anchor's shape (H =
    10,000, one push and one send port, one graph node; one event per
    microstep) and config 6's (two pushes, a two-segment burst port, affine
    rows over 100 nodes, the event a column of the K = 4 peek; K9 takes the
    K = 4 events' entry stacks of one microstep); K12 and K5 with per-host
    limits at config 11's [10,000, 4] wheel (blocks of 2) and its 14-slot
    queue. Exact equality on seeded inputs, two seeds each."""
    from shadow_tpu_torch.core.engine import make_empty_outbox
    from shadow_tpu_torch.ops import chain
    from shadow_tpu_torch.ops import events as ev
    from shadow_tpu_torch.ops import wheel as wh
    from shadow_tpu_torch.testing import chain_case, clone_carry, flat_tensors

    shapes = {
        "anchor": (1, dict(n_push=1, sends=((1, False, False),), route="const", budget=B)),
        "cfg6": (K6, dict(n_push=2, sends=((2, True, True),), route="affine", n_nodes=100,
                          budget=24, stride=K6)),
    }

    def microstep_stacks(c0, params, cfg, e, disp, we, out, n_events, budget):
        """The entry stacks of `n_events` events of one microstep (the carry
        threaded through egress), some columns moved past the outbox width."""
        cc, stacks = clone_carry(c0), []
        for _ in range(n_events):
            cc, _, ents, _ = chain.event_egress_plain(cc, params, cfg, e.t, disp, we, out)
            stacks.append(ents._replace(
                col=torch.where(ents.col % 7 == 0, ents.col + budget, ents.col)))
        return stacks

    err = {k: 0.0 for k in ("outbox_append", "event_ingress", "event_egress")}
    timing = {}
    for shape, (n_events, kw) in shapes.items():
        for seed in (1, 2):
            case = chain_case(seed, H, dev, **kw)
            cfg, params, e, act = case["cfg"], case["params"], case["ev"], case["active"]
            c0 = case["carry"]
            got = chain.event_ingress(clone_carry(c0), params, cfg, e, act)
            want = chain.event_ingress_plain(clone_carry(c0), params, cfg, e, act)
            err["event_ingress"] = max(err["event_ingress"], check_equal(
                f"K10/{shape}/{seed}", flat_tensors(got), flat_tensors(want)))
            out, disp, we = case["out"], case["dispatch"], case["window_end"]
            got = chain.event_egress(clone_carry(c0), params, cfg, e.t, disp, we, out)
            want = chain.event_egress_plain(clone_carry(c0), params, cfg, e.t, disp, we, out)
            err["event_egress"] = max(err["event_egress"], check_equal(
                f"K11/{shape}/{seed}", flat_tensors(got), flat_tensors(want)))
            stacks = microstep_stacks(c0, params, cfg, e, disp, we, out, n_events,
                                      kw["budget"])
            ob = make_empty_outbox(H, kw["budget"], dev)
            lost = torch.zeros((1,), dtype=torch.int64, device=dev)
            got = chain.outbox_append_multi(clone_carry(ob), stacks, lost.clone())
            want = chain.outbox_append_multi_plain(clone_carry(ob), stacks, lost.clone())
            err["outbox_append"] = max(err["outbox_append"], check_equal(
                f"K9/{shape}/{seed}", flat_tensors(got), flat_tensors(want)))
        # timings on the last case of the shape
        ing = chain.event_ingress_plain(clone_carry(c0), params, cfg, e, act)
        egr = chain.event_egress_plain(clone_carry(c0), params, cfg, e.t, disp, we, out)
        ents = egr[2]
        k10 = kernel_ms("event_ingress", lambda cc: chain.event_ingress(cc, params, cfg, e, act),
                        lambda: (clone_carry(c0),))
        k10["plain_ms"] = time_ms(lambda cc: chain.event_ingress_plain(cc, params, cfg, e, act),
                                  lambda: (clone_carry(c0),))
        c1, ing1 = ing
        k10["bound"] = bound(io_bytes(
            reads=[e.t, e.order, e.kind, e.payload[:, 0], act, params.in_tb.capacity,
                   params.in_tb.refill, c0.tb_ingress.tokens, c0.tb_ingress.last_itv],
            writes=[ing1.dispatch, ing1.is_pkt, ing1.kind, ing1.src,
                    *(ing1.requeue[i] for i in (0, 1, 3))],
            inplace=list(zip(flat_tensors([c0.stats, c0.tb_ingress, c0.codel]),
                             flat_tensors([c1.stats, c1.tb_ingress, c1.codel])))), 300 * H)
        k11 = kernel_ms("event_egress",
                        lambda cc: chain.event_egress(cc, params, cfg, e.t, disp, we, out),
                        lambda: (clone_carry(c0),))
        k11["plain_ms"] = time_ms(
            lambda cc: chain.event_egress_plain(cc, params, cfg, e.t, disp, we, out),
            lambda: (clone_carry(c0),))
        c2 = egr[0]
        route_bytes = len(out.sends) * H * (8 + 4 + 8)
        k11["bound"] = bound(io_bytes(
            reads=[e.t, disp, params.eg_tb.capacity, params.eg_tb.refill,
                   c0.tb_egress.tokens, c0.tb_egress.last_itv,
                   *[x for p in out.pushes for x in (p.mask, p.t, p.kind)],
                   *[x for sp in out.sends for x in (sp.mask, sp.dst, sp.size_bytes, sp.kind,
                                                     sp.payload, sp.count, sp.payload_inc)]],
            writes=[*[x for p in egr[1] for x in p[:4]], *ents, egr[3]],
            inplace=list(zip(flat_tensors([c0.stats, c0.rng, c0.seq, c0.sent_round,
                                           c0.tb_egress]),
                             flat_tensors([c2.stats, c2.rng, c2.seq, c2.sent_round,
                                           c2.tb_egress])))) + route_bytes, 600 * H)
        ob = make_empty_outbox(H, kw["budget"], dev)
        n_mask = sum(st.mask.numel() for st in stacks)
        n_m = sum(int(st.mask.sum()) for st in stacks)

        def ob_setup():
            return clone_carry(ob), torch.zeros((1,), dtype=torch.int64, device=dev)

        k9 = kernel_ms("outbox_append", lambda o, z: chain.outbox_append_multi(o, stacks, z),
                       ob_setup)
        k9["plain_ms"] = time_ms(lambda o, z: chain.outbox_append_multi_plain(o, stacks, z),
                                 ob_setup)
        # every mask read; the landed entries' fields read and written
        k9["bound"] = bound(n_mask + n_m * (44 + 40) + 12, n_mask)
        for name, r in (("outbox_append", k9), ("event_ingress", k10), ("event_egress", k11)):
            settle(f"{name}/{shape}", r, r["bound"][0])
        timing[shape] = {"outbox_append": k9, "event_ingress": k10, "event_egress": k11}

    results = {}
    for name in ("outbox_append", "event_ingress", "event_egress"):
        r = dict(timing["cfg6"][name])
        r["max_abs_err"] = err[name]
        r["library_ms"] = None
        r["library_why"] = "no single PyTorch call computes the function"
        a = timing["anchor"][name]
        r["anchor_shape"] = {"ms": a["ms"], "ms_source": a["ms_source"], "call_ms": a["call_ms"],
                             "plain_ms": a["plain_ms"], "bound_ms": a["bound"][0]}
        results[name] = r

    # K12 and K5 with per-host limits at config 11's shapes
    rng = np.random.default_rng(11)
    e12 = e5 = 0.0
    for case in range(2):
        fill = rng.integers(0, 5, H)
        fill[rng.random(H) < 0.2] = 4
        w = random_queue(rng, fill, dev, 4)
        w = ev.BucketQueue(*w, *ev.block_minima_plain(w.t, w.order, 2))
        live = (w.t != TIME_MAX)
        pick = torch.as_tensor(rng.integers(0, 4, H), device=dev)
        key = w.order.gather(1, pick[:, None])[:, 0]
        key = torch.where(torch.as_tensor(rng.random(H) < 0.2, device=dev), key + 1, key)
        mask = torch.as_tensor(rng.random(H) < 0.8, device=dev)
        got = wh.wheel_cancel(clone_q(w), mask, key)
        want = wh.wheel_cancel_plain(clone_q(w), mask, key)
        e12 = max(e12, check_equal(f"K12/{case}", flat_tensors(got), flat_tensors(want)))
        if not bool(got[1].any()):
            raise AssertionError("K12 check: no cancel hit")
        lim = torch.as_tensor(np.where(rng.random(H) < 0.3, 0, rng.integers(0, 50, H)
                                       * 1_000_000), device=dev)
        for q in (w, random_queue(rng, rng.integers(0, 15, H), dev, 14)):
            for k in (1, 4):
                e5 = max(e5, check_equal(f"K5-limits/{case}/{k}", list(ev.pop_k(q, lim, k)),
                                         list(ev.pop_k_plain(q, lim, k))))
    hit = live & (w.order == key[:, None]) & mask[:, None]
    n_hit = int(hit.sum())
    results["wheel_cancel"] = dict(
        **kernel_ms("wheel_cancel", lambda ww: wh.wheel_cancel(ww, mask, key),
            lambda: (clone_q(w),)),
        plain_ms=time_ms(lambda ww: wh.wheel_cancel_plain(ww, mask, key),
                         lambda: (clone_q(w),)),
        library_ms=None,
        library_why="no single PyTorch call: a keyed clear plus a per-block recompute",
        # mask; the key and order row of masked hosts; each hit cleared, its
        # block's 2 slots re-read and cache rewritten; found written
        bound=bound(H + int(mask.sum()) * (8 + 4 * 8) + n_hit * (16 + 2 * 16 + 20) + H,
                    int(mask.sum()) * 4),
        max_abs_err=e12,
    )
    settle("wheel_cancel", results["wheel_cancel"], results["wheel_cancel"]["bound"][0])
    pk = ev.pop_k_plain(w, lim, 1)
    n_tie = int(((w.t == pk.t[:, :1]) & (w.t != TIME_MAX)).sum())
    results["queue_pop_k_limits"] = dict(
        **kernel_ms("queue_pop_k", lambda: ev.pop_k(w, lim, 1)),
        plain_ms=time_ms(lambda: ev.pop_k_plain(w, lim, 1)),
        # the wheel's time plane and the limits; order where t equals the
        # selected time; the active events' kind/payload; the [H, 1] outputs
        bound_ms=bound(H * 4 * 8 + H * 8 + n_tie * 8 + int(pk.active.sum()) * (4 + 4 * P)
                       + H * (8 + 8 + 4 + 4 * P + 1 + 4), H * 4)[0],
        max_abs_err=e5, shape=[H, 4, 1],
    )
    settle("queue_pop_k/limits", results["queue_pop_k_limits"],
           results["queue_pop_k_limits"]["bound_ms"])
    return results


def phase_codel_law(dev) -> dict:
    """The CoDel control law through K10 over every count 1..10^6: one host
    per count, each dropping with count - 1 drops and due, its packet
    12 s behind a 1-bit-per-interval bucket, so the drop fires and
    drop_next advances by round_half_even(100 ms / sqrt(count)). Card
    against the plain version on the CPU, and against the law computed in
    Python (correctly rounded sqrt, half-to-even round)."""
    import math

    from shadow_tpu_torch.core.engine import EngineConfig, Stats, _EvCarry
    from shadow_tpu_torch.models.base import KIND_PKT
    from shadow_tpu_torch.net import CodelState, TBParams, TBState
    from shadow_tpu_torch.ops import chain
    from shadow_tpu_torch.ops.events import Event
    from shadow_tpu_torch.ops.rng import RngState

    n = 1_000_000
    now = 5_000_000_000

    def build(d):
        z = torch.zeros((n,), dtype=torch.int64, device=d)
        stats = Stats(*(z.clone() for _ in range(8)), *(torch.zeros((1,), dtype=torch.int64,
                      device=d) for _ in range(4)), z.clone(),
                      torch.zeros((1,), dtype=torch.int64, device=d), z.clone(),
                      torch.zeros((), dtype=torch.int64, device=d))
        counts = torch.arange(n, dtype=torch.int32, device=d)  # count - 1
        c = _EvCarry(
            stats=stats, rng=RngState(torch.zeros((n, 4), dtype=torch.int64, device=d)),
            seq=z.clone(), sent_round=torch.zeros((n,), dtype=torch.int32, device=d),
            tb_egress=TBState(z.clone(), z.clone()),
            tb_ingress=TBState(z.clone(), torch.full((n,), now // 1_000_000, device=d)),
            codel=CodelState(first_above=torch.full((n,), now - 1, device=d),
                             drop_next=torch.full((n,), now - 1, device=d),
                             count=counts, dropping=torch.ones((n,), dtype=torch.bool, device=d)),
            model=None,
        )
        params = types.SimpleNamespace(in_tb=TBParams(
            torch.full((n,), 12_000, device=d), torch.ones((n,), dtype=torch.int64, device=d)))
        payload = torch.zeros((n, 4), dtype=torch.int32, device=d)
        payload[:, 0] = 1500
        e = Event(torch.full((n,), now, device=d), torch.arange(n, device=d),
                  torch.full((n,), KIND_PKT, dtype=torch.int32, device=d), payload)
        return c, params, e, torch.ones((n,), dtype=torch.bool, device=d)

    cfg = EngineConfig(num_hosts=n, stop_time=10 * now)
    c, params, e, act = build(dev)
    gpu = chain.event_ingress(c, params, cfg, e, act)[0].codel.drop_next.cpu()
    c, params, e, act = build("cpu")
    cpu = chain.event_ingress_plain(c, params, cfg, e, act)[0].codel.drop_next
    want = torch.tensor([now - 1 + round(1e8 / math.sqrt(k)) for k in range(1, n + 1)])
    return {"counts": n, "card_vs_cpu_mismatches": int((gpu != cpu).sum()),
            "card_vs_python_mismatches": int((gpu != want).sum())}


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
    "merge_scatter": ("histogram_kernel", "scan_kernel", "scatter_kernel", "fits_kernel",
                      "insert_kernel"),
    "queue_pop_k": ("pop_k_kernel",),
    "queue_clear_popped": ("clear_popped_kernel",),
    "queue_push_many_bucketed": ("push_many_kernel<true>",),
    "queue_block_minima": ("block_minima_kernel",),
    "outbox_append": ("outbox_append_kernel",),
    "event_ingress": ("event_ingress_kernel",),
    "event_egress": ("event_egress_kernel",),
    "wheel_cancel": ("wheel_cancel_kernel",),
}
# the microstep's per-event steps, marked as profiler ranges in phases 5 and 9
RANGES = ("ingress", "handler", "egress", "outbox_append")


def phase_profile(cfg_dict: dict, floors: dict[str, float]) -> dict:
    """Where a leg's time goes: three unprofiled chunks (the first carries
    first-use costs; the third is timed), then one chunk under
    torch.profiler with the per-event chain's three steps — ingress (K10),
    the model's handler (plain PyTorch), egress (K11) — and the outbox
    append (K9) marked as ranges: device busy share, launches per
    microstep, each range's device time and launches per microstep, the
    port's kernels by name, and the top device ops.

    Each port kernel's device time per wrapper call inside the path is
    held against `floors[name]`, its least time per call at this path's
    shapes: a reading below it is a misattributed trace, is reported as
    `rejected_ms_per_call`, and leaves that kernel's time (and its range's)
    null."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import shadow_tpu_torch.core.engine as engine_mod
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.ops import KERNELS
    from shadow_tpu_torch.sim import Simulation

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    # a range's own "kernel" is its span on the device timeline (idle gaps
    # included): its work is every other kernel inside it, launched by the
    # ops within or directly (the ctypes launches of K9-K11)
    def kernels_in(e) -> list:
        return ([k for k in e.kernels if k.name not in RANGES]
                + [k for c in e.cpu_children for k in kernels_in(c)])

    sim = Simulation(ConfigOptions.from_dict(cfg_dict))
    eng, st = sim.engine, sim.state
    walls, advanced = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0, now0 = time.monotonic(), st.now
        st = eng.run_chunk(st, sim.params)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        advanced.append((st.now - now0) / 1e9)
    msteps0 = int(st.stats.microsteps.sum())
    syncs0 = eng.host_syncs
    patched = {n: getattr(engine_mod, n) for n in ("event_ingress", "event_egress",
                                                   "outbox_append_multi")}
    engine_mod.event_ingress = ranged("ingress", patched["event_ingress"])
    engine_mod.event_egress = ranged("egress", patched["event_egress"])
    engine_mod.outbox_append_multi = ranged("outbox_append", patched["outbox_append_multi"])
    eng.model.handle = ranged("handler", eng.model.handle)
    for k in KERNELS.values():
        k.launches = 0
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0, now0 = time.monotonic(), st.now
            st = eng.run_chunk(st, sim.params)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        for n, fn in patched.items():
            setattr(engine_mod, n, fn)
        del eng.model.handle
    msteps = int(st.stats.microsteps.sum()) - msteps0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in RANGES]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1e3
    ours = {}
    for k, tags in KERNEL_SYMBOLS.items():
        calls = KERNELS[k].launches
        if not calls:
            continue
        ms = sum(e.self_device_time_total for e in dev if any(t in e.key for t in tags)) / 1e3
        floor = floors.get(k)  # None: no bound counted at this path's shapes
        r = {"calls": calls, "device_launches": sum(e.count for e in dev
                                                    if any(t in e.key for t in tags)),
             "ms": ms, "ms_per_call": ms / calls, "bound_ms_per_call": floor}
        if floor is None or ms / calls < floor:
            r.update(ms=None, ms_per_call=None, rejected_ms_per_call=ms / calls)
        ours[k] = r
    # the trace does not tie a ctypes launch to the range around it: each
    # range gets its own kernel's launches and device time by name, plus
    # the PyTorch kernels of the ops inside it
    own = {"ingress": "event_ingress", "egress": "event_egress",
           "outbox_append": "outbox_append"}
    ranges = {}
    for name in RANGES:
        evs = [e for e in prof.events() if e.name == name]
        ks = [k for e in evs for k in kernels_in(e)]
        o = ours.get(own.get(name), {"device_launches": 0, "ms": 0.0})
        ranges[name] = {
            "calls": len(evs),
            "device_ms_per_microstep": None if o["ms"] is None else
            (sum(k.duration for k in ks) / 1e3 + o["ms"]) / max(msteps, 1),
            "launches_per_microstep": (len(ks) + o["device_launches"]) / max(msteps, 1),
        }
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "chunk_rounds": sim.engine_cfg.rounds_per_chunk,
        "chunk_wall_s": walls,
        "steady_sim_s_per_wall_s": advanced[2] / walls[2],
        "profiled_chunk_sim_s": (st.now - now0) / 1e9,
        "profiled_chunk_wall_s": wall,
        "microsteps": msteps,
        "host_syncs": eng.host_syncs - syncs0,
        "device_busy_ms": dev_ms,
        "device_busy_share": dev_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in dev),
        "device_launches_per_microstep": sum(e.count for e in dev) / max(msteps, 1),
        "ranges": ranges,
        "port_kernels": ours,
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


def cfg11_small_configs() -> dict[str, dict]:
    """Config 11 small (bench.py baseline_config(11, small=True), without
    the rider) cut to 4 simulated seconds: as configured, with one wheel
    slot (timers spill to the queue), and on a lossy torus."""
    stop = "4 s"
    return {
        "wheel4": cfg11_config(True, stop),
        "wheel1_spill": cfg11_config(True, stop, wheel=1),
        "lossy_wheel4": cfg11_config(True, stop, loss=0.02),
    }


def gear_small_configs() -> dict[str, tuple[dict, dict]]:
    """(config, run arguments): config 2 small (cut to 30 simulated seconds
    where a variant needs only two chunks) and config 5 small as
    configured, config 2 small with the controller started at gear 1, and
    config 2 small with the scatter merge on a 2%-loss torus at capacity 4."""
    return {
        "cfg2_small": (cfg2_config(True), {}),
        "cfg5_small": (cfg5_config(True), {}),
        "cfg2_small_from_gear1": (cfg2_config(True, "30 s"), {"start_gear": 1}),
        "cfg2_small_scatter_lossy_cap4": (cfg2_config(True, "30 s", scatter=True, loss=0.02,
                                                      cap=4), {}),
    }


def run_config(cfg_dict: dict, device, **run_kw) -> dict:
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    sim = Simulation(ConfigOptions.from_dict(cfg_dict), device=device)
    return sim.run(progress=False, **run_kw)


def card_vs_cpu(phase: str, configs: dict, keys: tuple) -> dict:
    """Run each config (a dict, or (dict, run arguments)) on the card and on
    the CPU (one intra-op thread: tiny tensors); their reports must agree
    on `keys`. Returns the card's reports."""
    out = {}
    prev_threads = torch.get_num_threads()
    for name, cfg in configs.items():
        cfg, run_kw = cfg if isinstance(cfg, tuple) else (cfg, {})
        a = run_config(cfg, None, **run_kw)
        torch.set_num_threads(1)
        try:
            b = run_config(cfg, "cpu", **run_kw)
        finally:
            torch.set_num_threads(prev_threads)
        same = {k: a.get(k) == b.get(k) for k in keys}
        emit(phase, name=name, cuda={k: a.get(k) for k in keys}, equal_to_cpu=all(same.values()))
        if not all(same.values()):
            raise AssertionError(f"{name}: card and CPU reports differ: {same}")
        out[name] = a
    return out


def run_leg(name: str, cfg_dict: dict, ref: dict, path: tuple) -> tuple[dict, dict]:
    """One full-width leg with every launch counter set to 0 just before
    and read just after: the report must equal the JAX constants `ref` and
    every kernel of `path` must have launched. Prints the run loop's wall
    (`wall_seconds`), the wall with the build (`build_and_run_seconds`) and
    the card's peak allocated memory. Returns (counts, report)."""
    from shadow_tpu_torch.ops import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    report = run_config(cfg_dict, None)
    total = time.monotonic() - t0
    launches = {k: v.launches for k, v in KERNELS.items()}
    emit(name, **{k: report.get(k) for k in (*ref, "rounds", "microsteps", "gears")},
         wall_seconds=report["wall_seconds"], build_and_run_seconds=total,
         sim_wall_ratio=report["sim_wall_ratio"], host_syncs=report["host_syncs"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    diff = {k: (report.get(k), v) for k, v in ref.items() if report.get(k) != v}
    if diff:
        raise AssertionError(f"{name}: differs from the JAX reference (port, JAX): {diff}")
    if not all(launches[k] for k in path):
        raise AssertionError(f"{name}: a kernel of the path never launched: {launches}")
    return launches, report


CHAIN_PATH = ("outbox_append", "event_ingress", "event_egress")
ANCHOR_PATH = ("queue_next_time", "queue_pop_min", "queue_push_many", "merge_insert",
               *CHAIN_PATH)
TGEN_PATH = ("queue_next_time", "merge_insert", "queue_pop_k", "queue_clear_popped",
             "queue_push_many_bucketed", "queue_block_minima", *CHAIN_PATH)
# the wheel path: the queue's and the wheel's pops are K5 (per-host
# limits) + K6, both slabs' pushes K7, next times K1 on the block caches
CFG11_PATH = TGEN_PATH
# config 2 is the anchor's kernels on the torus; with merge_scatter K13
# merges instead of K4. Config 5's timers never send: no merge, no append
CFG2_PATH = ANCHOR_PATH
CFG2_SCATTER_PATH = tuple("merge_scatter" if k == "merge_insert" else k for k in ANCHOR_PATH)
CFG5_PATH = ("queue_next_time", "queue_pop_min", "queue_push_many", "event_ingress",
             "event_egress")
SOURCES = {"merge_insert": "shadow_tpu_torch/csrc/merge.cu",
           "merge_scatter": "shadow_tpu_torch/csrc/merge.cu",
           **{k: "shadow_tpu_torch/csrc/event.cu" for k in CHAIN_PATH}}
REPLACES = {
    "queue_next_time": "shadow_tpu/ops/events.py:129",
    "queue_pop_min": "shadow_tpu/ops/events.py:138",
    "queue_push_many": "shadow_tpu/ops/events.py:342",
    "merge_insert": "shadow_tpu/ops/merge.py:240",
    "merge_scatter": "shadow_tpu/ops/merge.py:312",
    "queue_pop_k": "shadow_tpu/ops/events.py:201",
    "queue_clear_popped": "shadow_tpu/ops/events.py:290",
    "queue_push_many_bucketed": "shadow_tpu/ops/events.py:616",
    "queue_block_minima": "shadow_tpu/ops/events.py:460",
    "outbox_append": "shadow_tpu/core/engine.py:1126",
    "event_ingress": "shadow_tpu/core/engine.py:2280",
    "event_egress": "shadow_tpu/core/engine.py:2415",
    "wheel_cancel": "shadow_tpu/ops/wheel.py:123",
}
# the path whose run each kernel's `launches` is read from: the one it was
# ported for (wheel_cancel has no engine caller, in either package)
PORTED_FOR = {
    **{k: "anchor" for k in ("queue_next_time", "queue_pop_min", "queue_push_many",
                             "merge_insert")},
    **{k: "tgen" for k in ("queue_pop_k", "queue_clear_popped", "queue_push_many_bucketed",
                           "queue_block_minima", *CHAIN_PATH)},
    "wheel_cancel": "cfg11",
    "merge_scatter": "cfg2_scatter",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import shadow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    from shadow_tpu_torch.ops.cuda_build import build_all

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    t_start = time.monotonic()

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

    # the kernel phases 7, 11 and 12 run before the legs: the profiles (5,
    # 9) hold their in-path readings against the bounds these phases count
    k6res = phase_kernels_cfg6(dev)
    emit("kernels_cfg6_vs_plain", ok=True, exact=True,
         **{k: {kk: vv for kk, vv in v.items() if kk != "bound"} for k, v in k6res.items()})
    kres["queue_push_many"]["reserve_timing"] = k6res.pop("queue_push_many_reserve")
    kres.update(k6res)

    cres = phase_kernels_chain(dev)
    emit("kernels_chain_wheel_vs_plain", ok=True, exact=True,
         **{k: {kk: vv for kk, vv in v.items() if kk != "bound"} for k, v in cres.items()})
    kres["queue_pop_k"]["per_host_limits"] = cres.pop("queue_pop_k_limits")
    kres.update(cres)

    law = phase_codel_law(dev)
    emit("codel_law", **law)
    if law["card_vs_cpu_mismatches"] or law["card_vs_python_mismatches"]:
        raise AssertionError(f"CoDel control law differs: {law}")

    mres = phase_kernels_merge(dev)
    emit("kernels_merge_vs_plain", ok=True, exact=True,
         **{k: {kk: vv for kk, vv in v.items() if kk != "bound"} for k, v in mres.items()})
    kres["merge_insert"]["gear_width_timing"] = mres.pop("merge_insert_cols")
    kres.update(mres)

    # least device time per call at each path's shapes: the kernel phases'
    # bounds; K1 and K4 on the tgen path (block caches, 24-wide outbox) get
    # the bytes every call reads whatever the data (the caches' time plane
    # and the minima; the rows' valid flags)
    anchor_floors = {k: kres[k]["bound"][0] for k in ANCHOR_PATH if k not in CHAIN_PATH}
    anchor_floors.update({k: kres[k]["anchor_shape"]["bound_ms"] for k in CHAIN_PATH})
    tgen_floors = {k: kres[k]["bound"][0] for k in TGEN_PATH}
    tgen_floors["queue_next_time"] = bound(H6 * (C6 // BLK6) * 8 + H6 * 8, 0)[0]
    tgen_floors["merge_insert"] = bound(H6 * 24, 0)[0]

    launches = {"anchor": run_leg("anchor", anchor_config(), {
        "determinism_digest": ANCHOR_DIGEST, "events_processed": ANCHOR_EVENTS}, ANCHOR_PATH)[0]}

    emit("anchor_profile", **phase_profile(anchor_config(), anchor_floors))

    keys = ("determinism_digest", "events_processed", "packets_sent", "packets_lost",
            "packets_codel_dropped", "queue_overflow_dropped", "packets_budget_dropped",
            "rounds", "microsteps")
    card_vs_cpu("small_config", small_configs(), keys)

    launches["tgen"] = run_leg("tgen", tgen_config(False, TGEN_STOP), TGEN_REF, TGEN_PATH)[0]

    emit("tgen_profile", **phase_profile(tgen_config(False, TGEN_STOP, rounds_per_chunk=8),
                                         tgen_floors))

    keys += ("bucket_cache_rebuilds", "popk_deferred", "model_report")
    small = card_vs_cpu("tgen_small", tgen_small_configs(), keys)
    if not (small["lossy_k4_block7"]["packets_lost"]
            and small["lossy_k4_block7"]["model_report"]["retransmits"]):
        raise AssertionError("lossy_k4_block7: no loss or retransmit was exercised")
    if not small["tight_k4_cap9_block3"]["queue_overflow_dropped"]:
        raise AssertionError("tight_k4_cap9_block3: no queue overflow drop was exercised")

    launches["cfg11"] = run_leg("cfg11", cfg11_config(False, CFG11_STOP), CFG11_REF,
                                CFG11_PATH)[0]

    small = card_vs_cpu("cfg11_small", cfg11_small_configs(), keys + ("wheel",))
    if not small["wheel1_spill"]["wheel"]["spilled"]:
        raise AssertionError("wheel1_spill: no timer spilled to the queue")
    if not small["lossy_wheel4"]["model_report"]["retransmits"]:
        raise AssertionError("lossy_wheel4: no retransmit was exercised")

    # the merge gears and the scatter merge on the configured workloads
    launches["anchor_geared"] = run_leg("anchor_geared", anchor_config(gears=True), {
        "determinism_digest": ANCHOR_DIGEST, "events_processed": ANCHOR_EVENTS,
        "gears": ANCHOR_GEARS}, ANCHOR_PATH)[0]
    launches["scale40k"] = run_leg("scale40k", anchor_config(gears=True, hosts=40_000, stop_s=2),
                                   SCALE40K_REF, ANCHOR_PATH)[0]
    launches["cfg2"], rep2 = run_leg("cfg2", cfg2_config(False, CFG2_STOP), CFG2_REF, CFG2_PATH)
    launches["cfg2_scatter"], rep2s = run_leg(
        "cfg2_scatter", cfg2_config(False, CFG2_STOP, scatter=True), CFG2_REF, CFG2_SCATTER_PATH)
    skip = ("wall_seconds", "sim_wall_ratio", "host_syncs", "kernel_launches")
    diff = [k for k in rep2 if k not in skip and rep2[k] != rep2s.get(k)]
    if diff or launches["cfg2_scatter"]["merge_insert"]:
        raise AssertionError(f"cfg2 with merge_scatter: report differs on {diff} or K4 launched")
    launches["cfg5"], rep5 = run_leg("cfg5", cfg5_config(False), CFG5_REF, CFG5_PATH)
    if "gears" in rep5:
        raise AssertionError("cfg5: a gears block where the JAX report has none")

    small = card_vs_cpu("gears_small", gear_small_configs(), keys + ("outbox_send_hwm", "gears"))
    if not small["cfg2_small_from_gear1"]["gears"]["replays"]:
        raise AssertionError("cfg2_small_from_gear1: no chunk shed and replayed")
    if not small["cfg5_small"]["gears"]["chunks_per_gear"].get("1"):
        raise AssertionError("cfg5_small: the controller never settled at the bottom gear")
    if not small["cfg2_small_scatter_lossy_cap4"]["queue_overflow_dropped"]:
        raise AssertionError("cfg2_small_scatter_lossy_cap4: no round took K13's K4 branch")
    emit("total", seconds=round(time.monotonic() - t_start, 3))

    table = []
    for name, r in kres.items():
        b_ms, b_by = r["bound"]
        table.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "shadow_tpu_torch/csrc/queue.cu"),
            "replaces": REPLACES[name],
            "launches": launches[PORTED_FOR[name]][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
