"""PyTorch port vs JAX reference: merge gears with shed-exact replay.

The parity matrix runs the three workloads of tests/test_gears.py (phold,
udp_echo, tgen_tcp at H <= 8) for K in {1, 4} x {flat, bucketed queue}: a
geared port run started at the LOWEST gear (so chunks shed and replay)
must equal the port at full width and the JAX package's geared run (the
JAX `run_adaptive_chunk`, also started at the lowest gear). One JAX run per
(workload, K), on the bucketed queue, is the reference of both layouts: the
flat port run equals it on every lane the layouts share (the slab, every
counter, digests, the gears report), the block caches and their rebuild
count aside. The JAX engine runs on the CPU; the port runs its plain
PyTorch path. Then the units of
tests/test_gears.py against the port's copy of `core/gears.py`, the exact
`gear_shed_count`, the config parse, the snapshot's copy semantics, and
the simulation's report and heartbeat against the JAX package's.

Tolerance: exact equality everywhere — whole final states, per-host
digests, event counts, every drop counter, and the gears report.
"""

from __future__ import annotations

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.gears import GearController as JaxGearController
from shadow_tpu.core.gears import resolve_gear_ladder as jax_resolve
from shadow_tpu.core.gears import run_adaptive_chunk as jax_run_adaptive
from shadow_tpu_torch.config.options import ConfigError, ExperimentalOptions, load_config
from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
from shadow_tpu_torch.core.convert import engine_config_from, params_from_jax_numpy, to_numpy
from shadow_tpu_torch.core.engine import Engine, EngineConfig
from shadow_tpu_torch.core.gears import GearController, resolve_gear_ladder, run_adaptive_chunk
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.ops.merge import gear_shed_count


@pytest.fixture(autouse=True)
def _one_thread():
    """H <= 32: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# tests/test_gears.py's workload trio
CASES = {
    "phold": ("phold", mk_hosts(8, {"mean_delay": "20 ms", "population": 3}),
              300_000_000, dict(loss=0.1)),
    "echo": ("udp_echo",
             [dict(host_id=0, name="server", start_time=0, model_args={"role": "server"})]
             + [dict(host_id=i, name=f"c{i}", start_time=0,
                     model_args={"role": "client", "peer": "server",
                                 "interval": "4 ms", "size_bytes": 2000})
                for i in range(1, 5)],
             200_000_000, dict(bw_bits=2_000_000, loss=0.05)),
    "tgen": ("tgen_tcp",
             mk_hosts(5, {"flow_segs": 8, "flows": 1, "cwnd_cap": 8, "rto_min": "100 ms"}),
             1_500_000_000, dict(loss=0.05, latency=10_000_000, sends_budget=16)),
}


@pytest.fixture(scope="module")
def jax_geared():
    """`_jax_geared` computed once per (case, knobs) in this module and
    shared by the tests that read it (the port never writes JAX arrays)."""
    cache = {}

    def get(case, **kw):
        key = (case, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_geared(case, **kw)
        return cache[key]

    return get


def _jax_geared(case, **kw):
    """The JAX package's geared run from the lowest gear: final state and
    gears report."""
    model, hosts, stop, ckw = CASES[case]
    cfg, m, params, mstate, events = build_sim(model, hosts, stop, **ckw, **kw)
    eng = JaxEngine(cfg, m, None)
    st, par = eng.init_state(params, mstate, events, seed=1)
    ctl = JaxGearController(jax_resolve("auto", cfg.sends_per_host_round))
    ctl.gear = ctl.ladder[0]
    while not bool(st.done):
        st, _, _ = jax_run_adaptive(ctl, st, lambda s, g: eng.run_chunk_gear(s, par, g))
    return eng.cfg, params, st, ctl.report()


def _knobs(k, qb):
    """build_sim's knobs of a matrix point (the default K = 1 flat queue is
    the phold-k1-flat point)."""
    return {"queue_block": qb, "microstep_events": k}


def _port(jcfg, case, raw_params):
    model, hosts, _, _ = CASES[case]
    eng = Engine(engine_config_from(jcfg), get_model(model)(), "cpu")
    mparams, mstate, events = eng.model.build(hosts, 1, "cpu")
    p0 = params_from_jax_numpy(jax.device_get(raw_params), device="cpu")._replace(model=mparams)
    st, par = eng.init_state(p0, mstate, events, seed=1)
    return eng, st, par


def _port_geared(eng, st, par, start_low=True):
    ctl = GearController(resolve_gear_ladder("auto", eng.cfg.sends_per_host_round))
    if start_low:
        ctl.gear = ctl.ladder[0]
    while not st.done:
        st, _, _ = run_adaptive_chunk(ctl, eng, st, par)
    return st, ctl


def _identical(a, b, skip=()):
    a, b = to_numpy(a), to_numpy(b)
    assert a.keys() - set(skip) == b.keys() - set(skip)
    bad = [k for k in a if k not in skip and not np.array_equal(a[k], b[k])]
    assert not bad, bad


# the lanes only a bucketed queue has (or counts)
_BUCKET_LANES = ("queue.bt", "queue.bo", "queue.bfill", "stats.bq_rebuilds")


def _reference(jax_geared, case, k, qb):
    """The JAX geared run of (case, K) on the bucketed queue, with the
    config of the layout `qb` (0 = flat) and the lanes to leave out of the
    comparison for it."""
    jcfg, raw, jst, jrep = jax_geared(case, **_knobs(k, 8))
    if qb:
        return jcfg, raw, jst, jrep, ()
    return dataclasses.replace(jcfg, queue_block=0), raw, jst, jrep, _BUCKET_LANES


@pytest.mark.parametrize("qb", [0, 8], ids=["flat", "bucketed"])
@pytest.mark.parametrize("k", [1, 4], ids=["k1", "k4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_geared_run_matches_full_width_and_jax(case, k, qb, jax_geared):
    jcfg, raw, jst, jrep, skip = _reference(jax_geared, case, k, qb)
    eng, st, par = _port(jcfg, case, raw)
    st0 = snapshot_state(st)
    geared, ctl = _port_geared(eng, st, par)
    # the port's geared run equals the JAX package's, state for state
    # (outbox high-water included: both reset it per accepted chunk)
    _identical(jax.device_get(jst), geared, skip=skip)
    assert ctl.report() == jrep
    assert ctl.replays > 0 and int(geared.stats.gear_shed.sum()) == 0
    # and the port at full width, on every lane but the per-chunk high-water
    full = st0
    while not full.done:
        full = eng.run_chunk(full, par)
    _identical(full, geared, skip=("stats.outbox_hwm",))
    assert int(full.stats.outbox_hwm.max()) >= 2  # multi-send rounds: sheds at gear 1


def test_snapshot_survives_in_place_writes_and_repeated_restores(jax_geared):
    """The kernels write the state in place on the card: a snapshot must
    share no storage with the live state, and each restore must be a fresh
    copy (a second replay needs the snapshot intact)."""
    jcfg, raw, _, _, _ = _reference(jax_geared, "phold", 1, 0)
    eng, st, par = _port(jcfg, "phold", raw)
    st = eng.run_chunk(st, par)
    snap = snapshot_state(st)
    ref = to_numpy(snap)

    def scribble(s):  # what an in-place kernel does to the live planes
        s.queue.t.fill_(7)
        s.stats.digest.add_(1)
        s.rng.s.mul_(3)
        s.outbox.count.add_(5)
        s.sent_round.add_(2)
        s.min_used_lat.add_(1)
        for v in s.model.values():
            v.add_(1)

    scribble(st)
    r1 = restore_snapshot(snap)
    scribble(r1)
    r2 = restore_snapshot(snap)
    for x in (snap, r2):
        got = to_numpy(x)
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    # two replays from the same snapshot are identical
    a = eng.run_chunk(restore_snapshot(snap), par)
    b = eng.run_chunk(restore_snapshot(snap), par)
    _identical(a, b)


def test_resolve_gear_ladder():
    assert resolve_gear_ladder(0, 8) == []
    assert resolve_gear_ladder(None, 8) == []
    assert resolve_gear_ladder(False, 8) == []
    assert resolve_gear_ladder("off", 8) == []
    assert resolve_gear_ladder("auto", 8) == [1, 2, 4, 8]
    assert resolve_gear_ladder(True, 8) == [1, 2, 4, 8]
    assert resolve_gear_ladder("auto", 24) == [3, 6, 12, 24]
    assert resolve_gear_ladder("auto", 6) == [1, 3, 6]
    assert resolve_gear_ladder("auto", 12) == [1, 3, 6, 12]
    assert resolve_gear_ladder("auto", 1) == []
    assert resolve_gear_ladder("auto", 2) == [1, 2]
    assert resolve_gear_ladder([4, 1], 8) == [1, 4, 8]
    assert resolve_gear_ladder([8, 2], 8) == [2, 8]
    assert resolve_gear_ladder(2, 8) == [2, 8]
    assert resolve_gear_ladder([8], 8) == []
    for bad in ([0, 4], [9], "fast"):
        with pytest.raises(ValueError):
            resolve_gear_ladder(bad, 8)
    for spec in (0, "auto", True, [4, 1], 2, [8]):
        for b in (1, 2, 6, 8, 12, 24):
            try:
                want = jax_resolve(spec, b)
            except ValueError:
                with pytest.raises(ValueError):
                    resolve_gear_ladder(spec, b)
                continue
            assert resolve_gear_ladder(spec, b) == want


def test_gear_controller_policy():
    ctl = GearController([1, 2, 4, 8], down_lag=2)
    assert ctl.gear == 8
    assert ctl.note_chunk(8, 1) == 8
    assert ctl.note_chunk(8, 1) == 2
    assert ctl.note_chunk(2, 2) == 4
    ctl2 = GearController([1, 2, 4, 8])
    ctl2.gear = 1
    assert [ctl2.note_shed() for _ in range(4)] == [2, 4, 8, 8]
    assert ctl2.replays == 4
    ctl3 = GearController([1, 2, 4, 8])
    ctl3.gear = 1
    assert ctl3.note_shed(7) == 8 and ctl3.replays == 1
    ctl3.gear = 1
    assert ctl3.note_shed(2) == 4
    ctl2.note_chunk(8, 3)
    assert ctl2.report() == {"ladder": [1, 2, 4, 8], "chunks_per_gear": {"8": 1},
                             "replays": 4}
    # the same decisions as the JAX controller on a seeded hwm/shed sequence
    r = np.random.default_rng(3)
    a, b = GearController([1, 3, 6, 12]), JaxGearController([1, 3, 6, 12])
    for _ in range(200):
        hwm = int(r.integers(0, 13))
        if r.random() < 0.2:
            assert a.note_shed(hwm) == b.note_shed(hwm)
        else:
            assert a.note_chunk(a.gear, hwm) == b.note_chunk(b.gear, hwm)
    assert a.report() == b.report()


def test_adaptive_chunk_skips_controller_on_zero_round_window(jax_geared):
    """A dispatch that retired no round (given `rounds0`) does not feed the
    controller; one that did, does."""
    jcfg, raw, _, _, _ = _reference(jax_geared, "phold", 1, 0)
    eng, st, par = _port(jcfg, "phold", raw)

    class Idle:  # an engine whose chunk retires nothing
        host_syncs = 0

        @staticmethod
        def run_chunk_gear(s, p, g):
            return s

    ctl = GearController([1, 2, 4, 8], down_lag=1)
    _, gear, hwm = run_adaptive_chunk(ctl, Idle, st, par, rounds0=0)
    assert ctl.chunks == {} and ctl.gear == 8 and hwm == 0 and gear == 8
    st1 = eng.run_chunk(st, par)
    st1 = st1._replace(stats=st1.stats._replace(outbox_hwm=torch.zeros_like(st1.stats.outbox_hwm)))
    _, gear, _ = run_adaptive_chunk(ctl, Idle, st1, par, rounds0=0)
    assert ctl.chunks == {8: 1} and ctl.gear == 1 and Idle.host_syncs == 2


def test_engine_config_rejects_bad_gear():
    with pytest.raises(ValueError, match="gear_cols"):
        EngineConfig(num_hosts=4, stop_time=1, sends_per_host_round=4, gear_cols=5)
    with pytest.raises(ValueError, match="gear_cols"):
        EngineConfig(num_hosts=4, stop_time=1, gear_cols=-1)
    cfg = EngineConfig(num_hosts=4, stop_time=1, sends_per_host_round=4, gear_cols=2)
    assert cfg.gear_active
    assert not dataclasses.replace(cfg, gear_cols=4).gear_active


def test_merge_gears_config_parse():
    from shadow_tpu.config.options import ExperimentalOptions as JaxExperimental

    for spec in (None, "auto", "off", [2, 4], 2, 0, True):
        d = {} if spec is None else {"merge_gears": spec}
        assert ExperimentalOptions.from_dict(d).merge_gears == \
            JaxExperimental.from_dict(d).merge_gears
    assert ExperimentalOptions.from_dict({"merge_scatter": True}).merge_scatter is True
    for bad in ("fast", [2, "x"], [0], [-1, 2], 2.5):
        with pytest.raises(ConfigError, match="merge_gears"):
            ExperimentalOptions.from_dict({"merge_gears": bad})
    # an explicit gear wider than the resolved budget is refused at build
    from shadow_tpu_torch.sim import Simulation

    with pytest.raises(ConfigError, match="merge_gears"):
        Simulation(load_config(YAML.replace("merge_gears: auto", "merge_gears: [9]"),
                               is_text=True), device="cpu")


def test_gear_shed_count_exact():
    sent = torch.tensor([0, 1, 2, 5, 8], dtype=torch.int32)
    assert int(gear_shed_count(sent, 2)) == 0 + 0 + 0 + 3 + 6
    assert int(gear_shed_count(sent, 8)) == 0
    r = np.random.default_rng(1)
    from shadow_tpu.ops.merge import gear_shed_count as jax_count

    for _ in range(20):
        s = r.integers(0, 13, 64).astype(np.int32)
        g = int(r.integers(1, 13))
        assert int(gear_shed_count(torch.as_tensor(s), g)) == int(jax_count(s, g))


# a config-2-like PHOLD torus at 32 hosts (4 nodes), auto gears on a 6-wide
# budget, short chunks so the controller moves inside the run
YAML = """
general: {stop_time: 3 s, seed: 1, heartbeat_interval: 1 s}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        node [ id 1 host_bandwidth_down "1 Gbit" host_bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "50 ms" ]
        edge [ source 1 target 1 latency "50 ms" ]
        edge [ source 0 target 1 latency "50 ms" ]
      ]
experimental: {event_queue_capacity: 16, sends_per_host_round: 6, rounds_per_chunk: 8,
               merge_gears: auto}
hosts:
  a:
    count: 16
    network_node_id: 0
    processes: [{model: phold, model_args: {population: 2, mean_delay: 200 ms}}]
  b:
    count: 16
    network_node_id: 1
    processes: [{model: phold, model_args: {population: 2, mean_delay: 200 ms}}]
"""
TIMER_YAML = """
general: {stop_time: 3 s, seed: 1}
network: {graph: {type: 1_gbit_switch}}
experimental: {merge_gears: auto, rounds_per_chunk: 8}
hosts:
  t:
    count: 32
    processes: [{model: timer, model_args: {interval: 100 ms}}]
"""
REPORT_KEYS = ("determinism_digest", "events_processed", "rounds", "microsteps", "packets_sent",
               "packets_delivered", "packets_lost", "queue_overflow_dropped",
               "packets_budget_dropped", "outbox_overflow_dropped", "queue_occupancy_hwm",
               "outbox_send_hwm", "model_report")


@pytest.mark.parametrize("text", [YAML, TIMER_YAML], ids=["phold_torus", "timer"])
def test_simulation_report_and_heartbeat_match_jax(text):
    """Through `Simulation.run`: the report (gears block and run-wide outbox
    high-water included) equals the JAX package's, and the heartbeat
    carries gear= where the JAX package puts it."""
    from shadow_tpu.config.options import load_config as jax_load_config
    from shadow_tpu.sim import Simulation as JaxSimulation
    from shadow_tpu_torch.sim import Simulation

    plog, jlog = io.StringIO(), io.StringIO()
    prep = Simulation(load_config(text, is_text=True), device="cpu").run(
        progress=False, log=plog)
    jrep = JaxSimulation(jax_load_config(text, is_text=True), world=1).run(
        progress=False, log=jlog)
    assert {k: prep[k] for k in REPORT_KEYS} == {k: jrep[k] for k in REPORT_KEYS}
    assert prep["gears"] == jrep["gears"]
    if text is TIMER_YAML:  # nothing sends: the controller settles at the bottom
        assert jrep["gears"]["chunks_per_gear"].get("1", 0) > 0
    pg = [ln.split("gear=")[1].split()[0] for ln in plog.getvalue().splitlines()
          if ln.startswith("[heartbeat]")]
    jg = [ln.split("gear=")[1].split()[0] for ln in jlog.getvalue().splitlines()
          if ln.startswith("[heartbeat]")]
    assert pg and pg == jg
    line = next(ln for ln in plog.getvalue().splitlines() if ln.startswith("[heartbeat]"))
    assert line.index("q_hwm=") < line.index("gear=") < line.index("syncs=")


def test_gear_free_run_has_no_gears_block():
    """A send budget of 1 leaves no narrower width: gears turn themselves
    off and the report has no gears block, as in the JAX package."""
    from shadow_tpu_torch.sim import Simulation

    text = TIMER_YAML.replace("rounds_per_chunk: 8}", "rounds_per_chunk: 8, "
                              "sends_per_host_round: 1}")
    sim = Simulation(load_config(text, is_text=True), device="cpu")
    assert sim._gear_ladder == []
    assert "gears" not in sim.run(progress=False, log=io.StringIO())
