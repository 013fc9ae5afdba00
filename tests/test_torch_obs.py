"""The observatories of the PyTorch port against the JAX package, on the
CPU, at zero tolerance with dtypes: the round trace ring (K27's plain
version against `_trace_round`), the flow ledger (K28's plain version
against `_flow_append`, wrap rule included), the event-class lanes and
`win_bound`, the `network{}` block, the memory and runtime observatories'
report keys, the `observability` options, and the build-time refusal of
configs the queue kernels cannot take on a CUDA device.

Whole runs (H <= 64) through the driver, each with the trace and the
network observatory on: PHOLD at K = 1 flat with merge gears (the gear
controller sheds and replays chunks from the pre-chunk snapshot, the ring
with them, as the JAX package's does), PHOLD at K = 4 bucketed, tgen-TCP at
K = 1 flat with a flow ledger small enough to wrap, and a small config 11
(tgen with the timer wheel). Each JAX reference runs once per module
(`jax_runs`); the memory and runtime blocks' keys come from the JAX
package's own assembly functions, without another JAX run.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ConfigError as JaxConfigError
from shadow_tpu.config.options import ConfigOptions as JaxConfigOptions
from shadow_tpu.config.options import ObservabilityOptions as JaxObs
from shadow_tpu.core import engine as jax_engine
from shadow_tpu.core.gears import GearController as JaxGearController
from shadow_tpu.obs.netobs import FlowLedger as JaxFlowLedger
from shadow_tpu.obs.tracer import TraceRing as JaxTraceRing
from shadow_tpu.ops.events import BucketQueue as JaxBucketQueue
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions, ObservabilityOptions
from shadow_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from shadow_tpu_torch.obs.memory import modeled_shard_bytes, tree_bytes
from shadow_tpu_torch.obs.netobs import FlowLedger
from shadow_tpu_torch.obs.tracer import TRACE_COLS, TraceRing
from shadow_tpu_torch.ops.obs import (
    FlowLanes,
    RoundInputs,
    flow_append_plain,
    make_trace_scratch,
    trace_enter,
    trace_round_plain,
)
from shadow_tpu_torch.sim import Simulation

H = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# K27's plain version against `_trace_round`
# --------------------------------------------------------------------------


def _jcounters(rng, h, events0=None, step=0):
    """Seeded cumulative counters for one state (JAX namespace of arrays)."""
    base = events0 if events0 is not None else np.zeros(h, np.int64)
    return {
        "rounds": np.int64(step),
        "events": base + rng.integers(0, 9, h),
        "popk_deferred": rng.integers(0, 99, 1), "bq_rebuilds": rng.integers(0, 9, 1),
        "ici_bytes": np.zeros(1, np.int64), "a2a_shed": np.zeros(1, np.int64),
        "faults_dropped": rng.integers(0, 5, h), "faults_delayed": rng.integers(0, 5, h),
        "ec_timer": rng.integers(0, 999, 1), "ec_pkt": rng.integers(0, 999, 1),
        "ec_app": rng.integers(0, 999, 1), "fl_done": rng.integers(0, 99, 1),
    }


@pytest.mark.parametrize("case", ["flat", "bucketed_faults_netobs"])
def test_trace_round_plain_matches_jax(case):
    """Three rounds into a 2-row ring (the third wraps): every column and
    the cursor equal JAX's, the counters' deltas carried by the scratch."""
    rng = np.random.default_rng(11)
    full = case != "flat"
    c, blk, w, r = 16, 4, 3, 2
    jcfg = jax_engine.EngineConfig(
        num_hosts=H, stop_time=10**10, queue_capacity=c, queue_block=blk if full else 0,
        trace_rounds=r, netobs=full, flow_records=8 if full else 0,
        fault_crash_windows=w if full else 0, sends_per_host_round=6, gear_cols=3)
    down = np.sort(rng.integers(0, 10**9, (H, w)), axis=1)
    up = down + rng.integers(1, 4 * 10**8, (H, w))
    faults = types.SimpleNamespace(down_t=jnp.asarray(down), up_t=jnp.asarray(up))
    jring = JaxTraceRing(rows=jnp.zeros((1, r, TRACE_COLS), jnp.int64),
                         cursor=jnp.zeros((1,), jnp.int64))
    ring = TraceRing(torch.zeros((1, r, TRACE_COLS), dtype=torch.int64),
                     torch.zeros((1,), dtype=torch.int64))
    scratch = make_trace_scratch("cpu")
    lanes = ("events", "popk_deferred", "bq_rebuilds", "faults_dropped", "faults_delayed",
             "ec_timer", "ec_pkt", "ec_app", "fl_done")

    def port_stats(cnt):
        return types.SimpleNamespace(**{
            k: (torch.as_tensor(cnt[k]) if full or k in ("events", "popk_deferred",
                                                           "bq_rebuilds") else None)
            for k in lanes})

    cnt0 = _jcounters(rng, H)
    trace_enter(scratch, port_stats(cnt0))
    now = 0
    for step in range(3):
        cnt1 = _jcounters(rng, H, cnt0["events"], step + 1)
        cnt0["rounds"] = np.int64(step)
        t_plane = np.where(rng.random((H, c)) < 0.5, rng.integers(now, now + 10**9, (H, c)),
                           np.iinfo(np.int64).max)
        bt = t_plane.reshape(H, c // blk, blk).min(axis=2)
        occ = (t_plane != np.iinfo(np.int64).max).sum(axis=1).astype(np.int64)
        sends = rng.integers(0, 99, 1).astype(np.int32)
        ob_hwm = np.int64(rng.integers(0, 6))
        we = now + int(rng.integers(10**6, 10**8))
        steps = int(rng.integers(1, 9))
        if full:
            q = JaxBucketQueue(jnp.asarray(t_plane), jnp.zeros((H, c), jnp.int64),
                               jnp.zeros((H, c), jnp.int32), jnp.zeros((H, c, 4), jnp.int32),
                               jnp.zeros(H, jnp.int64), jnp.asarray(bt),
                               jnp.zeros_like(jnp.asarray(bt)), jnp.zeros(bt.shape, jnp.int32))
        else:
            q = types.SimpleNamespace(t=jnp.asarray(t_plane))
        st0 = types.SimpleNamespace(now=jnp.int64(now), stats=types.SimpleNamespace(
            **{k: jnp.asarray(v) for k, v in cnt0.items()}))
        st_m = types.SimpleNamespace(outbox=types.SimpleNamespace(count=jnp.asarray(sends)))
        st_x = types.SimpleNamespace(queue=q, trace=jring, stats=types.SimpleNamespace(
            **{k: jnp.asarray(v) for k, v in cnt1.items()}))
        jring = jax_engine._trace_round(
            jcfg, st0, st_m, st_x, jnp.int64(we), jnp.bool_(False), jnp.int64(steps),
            jnp.asarray(occ), jnp.asarray(ob_hwm), faults if full else None,
            bind_shard=jnp.int64(0) if full else None)
        trace_round_plain(ring, scratch, port_stats(cnt1), RoundInputs(
            rounds=torch.tensor(step, dtype=torch.int64), window_start=now, window_end=we,
            steps=steps, sends=torch.as_tensor(sends), occ=torch.as_tensor(occ),
            heads=torch.as_tensor(bt if full else t_plane), ob_hwm=torch.tensor(ob_hwm),
            gear=jcfg.effective_gear_cols, cap=c,
            crash=(torch.as_tensor(down), torch.as_tensor(up)) if full else None))
        for got, want in ((ring.rows, jring.rows), (ring.cursor, jring.cursor)):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype == np.int64
            assert np.array_equal(got.numpy(), want)
        cnt0, now = cnt1, we
    if full:
        assert ring.rows[0, :, 16].max() > 0  # some host was down at a round's end


# --------------------------------------------------------------------------
# K28's plain version against `_flow_append`
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fr", [8, 256])
def test_flow_append_plain_matches_jax(fr):
    """Four entries (a K = 4 microstep's columns) of seeded completions;
    with fr = 8 one entry completes more flows than the ring holds (only
    the newest fr are written, the cursor counts all). Rows, cursor and the
    fl_* folds equal JAX's."""
    rng = np.random.default_rng(5)
    jcfg = jax_engine.EngineConfig(num_hosts=H, stop_time=10**10, netobs=True,
                                   flow_records=fr)
    cur0 = 5
    jled = JaxFlowLedger(rows=jnp.zeros((1, fr, 7), jnp.int64),
                         cursor=jnp.full((1,), cur0, jnp.int64))
    led = FlowLedger(torch.zeros((1, fr, 7), dtype=torch.int64),
                     torch.full((1,), cur0, dtype=torch.int64))
    e = 4
    masks = rng.random((e, H)) < np.array([[0.05], [0.4], [0.0], [0.9]])
    vals = [rng.integers(0, 10**9, (e, H)).astype(np.int64) for _ in range(6)]
    entries = [tuple(jnp.asarray(x) for x in (masks[j], *(v[j] for v in vals)))
               for j in range(e)]
    jled = jax_engine._flow_append(jcfg, jled, jnp.arange(H, dtype=jnp.int64), entries)
    fl = [torch.zeros((1,), dtype=torch.int64) for _ in range(3)]
    flow_append_plain(led, FlowLanes(torch.as_tensor(masks),
                                     *(torch.as_tensor(v) for v in vals)), *fl)
    for got, want in ((led.rows, jled.rows), (led.cursor, jled.cursor)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype == np.int64
        assert np.array_equal(got.numpy(), want)
    assert [int(x) for x in fl] == [int(masks.sum()), int(vals[4][masks].sum()),
                                   int(vals[5][masks].sum())]
    if fr == 8:
        assert masks[3].sum() > fr  # the wrap rule ran


def test_plain_flow_lanes_match_jax():
    """`handle_plain` writes the flow-record lanes K17 writes into
    `ctx.flow`: JAX's FlowDone record of the same event (mask, peer, flow,
    start, bytes, retransmits), ending at the event's time."""
    from shadow_tpu.models import get_model as jax_get_model
    from shadow_tpu.models.base import HandlerCtx as JaxCtx
    from shadow_tpu.ops.rng import RngState as JaxRng
    from shadow_tpu_torch.ops.obs import make_flow_lanes
    from shadow_tpu_torch.testing import handler_case

    case = handler_case("tgen_tcp", 0, H, "cpu")
    a, ctx = case["np"], case["ctx"]
    jm = jax_get_model("tgen_tcp")()
    jm.tx_batch = case["model"].tx_batch
    names = ("t", "kind", "payload", "active", "is_packet", "src", "host_id")

    @jax.jit
    def jax_flow(window_end, lanes, state, params, rng):
        return jm.handle(JaxCtx(window_end=window_end, state=state, params=params,
                                rng=JaxRng(rng), **dict(zip(names, lanes)))).flow

    f = jax_flow(jnp.asarray(ctx.window_end, jnp.int64), [jnp.asarray(a[k]) for k in names],
                 {k: jnp.asarray(v.astype(np.uint32) if k == "sv_bm" else v)
                  for k, v in a["state"].items()},
                 {k: jnp.asarray(v) for k, v in a["params"].items()},
                 jnp.asarray(a["rng"].view(np.uint64)))
    lanes = make_flow_lanes(1, H, "cpu")
    out = case["model"].handle_plain(dataclasses.replace(ctx, flow=lanes.row(0)))
    assert out.flow is not None and out.flow.mask.data_ptr() == lanes.mask.data_ptr()
    mask = np.asarray(f.mask) & a["active"]
    assert lanes.mask.dtype == torch.bool and mask.any()
    assert np.array_equal(lanes.mask[0].numpy(), mask)
    for got, want in ((lanes.dst, f.dst), (lanes.flow, f.flow), (lanes.t_start, f.t_start),
                      (lanes.t_end, a["t"]), (lanes.bytes, f.bytes),
                      (lanes.retransmits, f.retransmits)):
        assert got.dtype == torch.int64
        assert np.array_equal(got[0].numpy()[mask], np.asarray(want).astype(np.int64)[mask])


def test_device_memory_stats_headroom(monkeypatch):
    """On a CUDA device the monitor's limit is what the process could hold
    (the card's free bytes plus the allocator's reserved bytes), so its
    headroom is free + reserved - allocated: the CUDA context, kernel
    modules and other processes' bytes are outside it (faked allocator
    readings; no card needed)."""
    from shadow_tpu_torch.obs.memory import MemoryMonitor, device_memory_stats

    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": 3 * gib, "allocated_bytes.all.peak": 5 * gib,
        "reserved_bytes.all.current": 6 * gib})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (10 * gib, 80 * gib))
    st = device_memory_stats("cuda")
    assert st == {"bytes_in_use": 3 * gib, "peak_bytes_in_use": 5 * gib,
                  "bytes_limit": 16 * gib}
    mon = MemoryMonitor([torch.device("cuda")])
    mon.sample(modeled_bytes=1)
    assert mon.source == "device" and mon.headroom_bytes() == 13 * gib
    assert device_memory_stats("cpu") is None


# --------------------------------------------------------------------------
# whole runs against the JAX package
# --------------------------------------------------------------------------


def _torus(side: int, lat_ms: int = 20, loss: float = 0.0) -> str:
    nodes = "".join(f"node [ id {i} ]\n" for i in range(side * side))
    edges = []
    for i in range(side * side):
        x, y = i % side, i // side
        edges.append((i, i))
        edges.append((i, (x + 1) % side + y * side))
        edges.append((i, x + ((y + 1) % side) * side))
    lossf = f" packet_loss {loss}" if loss else ""
    es = "".join(f'edge [ source {a} target {b} latency "{lat_ms} ms"{lossf} ]\n'
                 for a, b in sorted(set(edges)))
    return f"graph [\ndirected 0\n{nodes}{es}]\n"


def _phold(k: int, block: int, gears: bool = False) -> dict:
    ex = {"event_queue_capacity": 8, "sends_per_host_round": 4, "rounds_per_chunk": 8,
          "microstep_events": k}
    if block:
        ex["event_queue_block"] = block
    if gears:
        ex["merge_gears"] = "auto"
    return {
        "general": {"stop_time": "1.5 s", "seed": 3, "heartbeat_interval": "1 s"},
        "network": {"graph": {"type": "gml", "inline": _torus(2, loss=0.05)}},
        "experimental": ex,
        "observability": {"trace": True, "network": True},
        "hosts": {f"n{i}": {"count": 12, "network_node_id": i, "processes": [{
            "model": "phold", "model_args": {"population": 2, "mean_delay": "30 ms"}}]}
            for i in range(4)},
    }


def _tgen(wheel: int) -> dict:
    ex = {"sends_per_host_round": 8, "rounds_per_chunk": 16}
    if wheel:
        ex.update(timer_wheel=wheel, timer_wheel_block=2, event_queue_capacity=14,
                  event_queue_block=7)
    else:
        ex["event_queue_capacity"] = 16
    return {
        "general": {"stop_time": "1.5 s", "seed": 2, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": _torus(2, lat_ms=10, loss=0.02)}},
        "experimental": ex,
        "observability": {"trace": True, "network": True, "network_flows": 8},
        "hosts": {f"n{i}": {"count": 8, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 3, "flow_segs": 8, "cwnd_cap": 8, "mss": 1460,
                           "flow_gap": "20 ms", "tx_batch": 2, "rto_min": "100 ms"}}]}
            for i in range(4)},
    }


RUNS = {
    "phold_k1_geared": _phold(1, 0, gears=True),
    "phold_k4_bucketed": _phold(4, 4),
    "tgen_k1": _tgen(0),
    "cfg11_wheel": _tgen(4),
}


# the geared case starts at the lowest gear (its chunks shed and replay)
GEARED = {"phold_k1_geared"}
# the port's run of this case has the memory and runtime observatories on
# too (host-side observers: the JAX reference runs without them)
PORT_ALL_OBS = "phold_k4_bucketed"


class _LowStartController(JaxGearController):
    """The JAX package's gear controller, started at its lowest gear (the
    port's `Simulation.run(start_gear=...)`)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gear = self.ladder[0]


@pytest.fixture(scope="module")
def jax_runs():
    """Each RUNS case's JAX run, computed once: (Simulation, report)."""
    import shadow_tpu.core.gears as jax_gears

    cache = {}

    def get(name):
        if name not in cache:
            sim = JaxSimulation(JaxConfigOptions.from_dict(copy.deepcopy(RUNS[name])), world=1)
            with pytest.MonkeyPatch.context() as mp:
                if name in GEARED:
                    mp.setattr(jax_gears, "GearController", _LowStartController)
                cache[name] = (sim, sim.run(progress=False))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_runs():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = copy.deepcopy(RUNS[name])
            if name == PORT_ALL_OBS:
                cfg["observability"].update(memory=True, runtime=True)
            sim = Simulation(ConfigOptions.from_dict(cfg), device="cpu")
            start = sim._gear_ladder[0] if name in GEARED else None
            cache[name] = (sim, sim.run(progress=False, start_gear=start))
        return cache[name]

    return get


_REPORT_KEYS = ("determinism_digest", "events_processed", "rounds", "microsteps",
                "popk_deferred", "packets_lost", "queue_overflow_dropped", "network", "trace")
_STATS_LANES = ("ec_timer", "ec_pkt", "ec_app", "fl_done", "fl_bytes", "fl_rtx", "win_bound")


@pytest.mark.parametrize("name", list(RUNS))
def test_observed_run_matches_jax(name, jax_runs, port_runs):
    jsim, jrep = jax_runs(name)
    psim, prep = port_runs(name)
    trace_keys = ("rounds_traced", "rounds_lost", "chunks", "events", "microsteps",
                  "queue_occupancy_hwm", "ici_bytes")
    for k in _REPORT_KEYS:
        if k == "trace":
            assert {x: prep[k][x] for x in trace_keys} == {x: jrep[k][x] for x in trace_keys}
        else:
            assert prep[k] == jrep[k], k
    assert prep["per_host"] == jrep["per_host"]
    rows, jrows = psim._tracer.rows(), jsim._tracer.rows()
    assert rows.dtype == jrows.dtype == np.int64 and np.array_equal(rows, jrows)
    assert rows.shape[1] == prep["rounds"]
    js = jax.device_get(jsim.state)
    for lane in _STATS_LANES:
        got, want = getattr(psim.state.stats, lane), getattr(js.stats, lane)
        if want is None:
            assert got is None, lane
            continue
        assert got.numpy().dtype == np.asarray(want).dtype == np.int64
        assert np.array_equal(got.numpy(), np.asarray(want)), lane
    ec = prep["network"]["event_classes"]
    assert ec["total"] == prep["events_processed"] and ec["timer"] > 0 and ec["packet"] > 0
    if psim.engine_cfg.flow_ledger_active:
        recs, jrecs = psim._flowcol.records(), jsim._flowcol.records()
        assert np.array_equal(recs, jrecs) and recs.shape[0] > 0
        assert prep["network"]["flows"]["records_lost"] > 0  # the 8-record ring wrapped
        for r, j in ((psim.state.flows, js.flows),):
            assert np.array_equal(r.rows.numpy(), np.asarray(j.rows))
            assert np.array_equal(r.cursor.numpy(), np.asarray(j.cursor))
    if name == "cfg11_wheel":
        assert prep["wheel"] == jrep["wheel"] and psim.state.wheel is not None
    if name == "phold_k1_geared":
        # chunks shed and replayed: the ring was restored with the state
        assert prep["gears"] == jrep["gears"] and prep["gears"]["replays"] > 0


def test_observers_change_nothing(port_runs):
    """Observability on versus off in the port: digest, events, every drop
    counter and the model report are equal."""
    keys = ("determinism_digest", "events_processed", "rounds", "microsteps", "packets_sent",
            "packets_lost", "packets_codel_dropped", "queue_overflow_dropped",
            "packets_budget_dropped", "outbox_overflow_dropped", "model_report")
    for name in ("tgen_k1",):
        _, on = port_runs(name)
        cfg = copy.deepcopy(RUNS[name])
        cfg.pop("observability")
        off = Simulation(ConfigOptions.from_dict(cfg), device="cpu").run(progress=False)
        assert {k: on[k] for k in keys} == {k: off[k] for k in keys}
        assert "network" not in off and "trace" not in off


def test_outputs_match_jax(jax_runs, port_runs, tmp_path):
    """write_outputs: the host stats with the network observatory's
    per-host counters equal JAX's, trace.json's sim-time rounds and flows
    and the sim-derived metrics lines too."""
    jsim, jrep = jax_runs("tgen_k1")
    psim, prep = port_runs("tgen_k1")
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jsim.write_outputs(str(jd), report=jrep)
    psim.write_outputs(str(pd), report=prep)
    for h in ("n01", "n32"):
        a = json.loads((pd / "hosts" / h / "host-stats.json").read_text())
        b = json.loads((jd / "hosts" / h / "host-stats.json").read_text())
        assert a == b and "bytes" in a and "packets_codel_dropped" in a

    def sim_events(d):
        ev = json.loads((d / "trace.json").read_text())["traceEvents"]
        return [e for e in ev if e.get("pid") == 1]

    assert sim_events(pd) == sim_events(jd)

    def metrics(d):
        keep = ("rounds", "events", "microsteps", "exchange", "queue", "sim_time", "shard")
        return [ln for ln in (d / "metrics.prom").read_text().splitlines()
                if ln.startswith("shadow_tpu_") and ln.split()[0][11:].startswith(keep)]

    assert metrics(pd) == metrics(jd) and metrics(pd)


def test_memory_and_runtime_blocks_have_jax_keys(jax_runs, port_runs):
    """memory{} and runtime{} carry the keys the JAX package's own assembly
    gives (`observatory_report` on a JAX run's state, `assemble_runtime_report`
    on its ledgers, each after one sampled chunk); the modeled bytes on the
    CPU are the state's and parameters' tensor bytes; the wall attribution
    covers the run loop."""
    from shadow_tpu.obs.memory import MemoryMonitor as JaxMonitor
    from shadow_tpu.obs.memory import modeled_shard_bytes as jax_modeled
    from shadow_tpu.obs.memory import observatory_report as jax_memory
    from shadow_tpu.obs.runtime import CompileLedger, WallLedger
    from shadow_tpu.obs.runtime import assemble_runtime_report as jax_runtime

    jsim, _ = jax_runs(PORT_ALL_OBS)
    mon = JaxMonitor([jax.devices()[0]])
    mon.sample(modeled_bytes=jax_modeled(jsim.state, jsim.params))
    jmem = jax_memory(jsim.engine, jsim.state, jsim.params, mon, ledger=False)
    wall = WallLedger()
    wall.chunk_start()
    wall.chunk_end(10**6)
    jrt = jax_runtime(wall=wall, compiles=CompileLedger(), total_wall_s=1.0)
    psim, prep = port_runs(PORT_ALL_OBS)
    assert prep["memory"].keys() == jmem.keys() | {"ledger"}
    assert prep["memory"]["model"].keys() == jmem["model"].keys()
    assert prep["memory"]["source"] == jmem["source"] == "modeled"
    assert prep["runtime"].keys() == jrt.keys()
    assert prep["runtime"]["compiles"].keys() == jrt["compiles"].keys()
    assert prep["runtime"]["attributed_share"] >= 0.85
    st, par = psim.state, psim.params
    nbytes = sum(x.numel() * x.element_size() for x in _tensors((st, par)))
    assert modeled_shard_bytes(st, par) == tree_bytes((st, par)) == nbytes
    assert prep["memory"]["per_shard_hwm_bytes"] == [modeled_shard_bytes(st, par)]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def test_checkpoint_resume_keeps_the_rings(port_runs, tmp_path):
    """A tgen run checkpointed after its second chunk and resumed in a
    fresh build: the final rings and report equal the uninterrupted run's,
    and the resumed collectors drain exactly the rows and records that
    follow the checkpoint."""
    full_sim, full = port_runs("tgen_k1")
    cfg = ConfigOptions.from_dict(copy.deepcopy(RUNS["tgen_k1"]))
    a = Simulation(cfg, device="cpu")
    for _ in range(2):
        a.state = a.engine.run_chunk(a.state, a.params)
    rounds_at, cursor_at = int(a.state.stats.rounds), int(a.state.flows.cursor)
    path = save_checkpoint(str(tmp_path / "obs.npz"), a)
    b = Simulation(ConfigOptions.from_dict(copy.deepcopy(RUNS["tgen_k1"])), device="cpu")
    load_checkpoint(path, b)
    rep = b.run(progress=False)
    for k in ("determinism_digest", "events_processed", "rounds", "microsteps"):
        assert rep[k] == full[k]
    assert rep["network"]["event_classes"] == full["network"]["event_classes"]
    for ring, full_ring in ((b.state.trace, full_sim.state.trace),
                            (b.state.flows, full_sim.state.flows)):
        assert all(torch.equal(x, y) for x, y in zip(ring, full_ring))
    assert np.array_equal(b._tracer.rows(), full_sim._tracer.rows()[:, rounds_at:])
    total = int(full_sim.state.flows.cursor)
    assert b._flowcol.count + b._flowcol.lost == total - cursor_at


# --------------------------------------------------------------------------
# options and build-time refusals
# --------------------------------------------------------------------------


OBS_CASES = [
    {}, {"trace": True, "trace_file": None, "metrics_file": "m.prom"},
    {"network": True, "network_flows": 0, "memory": 1, "runtime": "yes"},
    {"profile_dir": "prof", "memory_ledger": False},
    {"network_flows": -1}, {"trace_file": ""}, {"metrics_file": ""}, {"profile_dir": ""},
    {"tracer": True},
]


@pytest.mark.parametrize("i", range(len(OBS_CASES)))
def test_observability_options_parse_like_jax(i):
    d = OBS_CASES[i]
    try:
        want = JaxObs.from_dict(copy.deepcopy(d)).__dict__
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            ObservabilityOptions.from_dict(copy.deepcopy(d))
        assert str(got.value) == str(e)
        return
    assert ObservabilityOptions.from_dict(copy.deepcopy(d)).__dict__ == want


KERNEL_LIMIT_CASES = {
    "capacity": ({"event_queue_capacity": 1100}, "event_queue_capacity=1100"),
    "blocks": ({"event_queue_capacity": 66, "event_queue_block": 2}, "event_queue_block=2"),
    "microstep_events": ({"event_queue_capacity": 40, "microstep_events": 33},
                         "microstep_events=33"),
}


@pytest.mark.parametrize("case", list(KERNEL_LIMIT_CASES))
def test_kernel_limits_refused_on_cuda_only(case, monkeypatch):
    """On a CUDA device (faked: the check runs before any tensor is made)
    the build refuses a shape the queue kernels cannot take, naming the
    knob and the limit; the CPU path builds and runs it."""
    import shadow_tpu_torch.sim as sim_mod

    knobs, knob = KERNEL_LIMIT_CASES[case]
    cfg = _phold(1, 0)
    cfg.pop("observability")
    cfg["general"]["stop_time"] = "0.05 s"
    cfg["experimental"].update(knobs)
    monkeypatch.setattr(sim_mod, "resolve_device", lambda device=None: torch.device("cuda"))
    with pytest.raises(ConfigError, match=knob) as e:
        Simulation(ConfigOptions.from_dict(copy.deepcopy(cfg)))
    assert "limit" in str(e.value)
    monkeypatch.undo()
    rep = Simulation(ConfigOptions.from_dict(cfg), device="cpu").run(progress=False)
    assert rep["events_processed"] > 0
