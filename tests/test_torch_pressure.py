"""PyTorch port vs JAX reference: the pressure plane (row B22, capacity
migration: K25 `queue_migrate`; row B24, the per-round drop total: K26
`pressure_total`), the escalate and abort policies, on-disk checkpoints with
the cross-capacity resume, and the supervisor's kill-and-resume.

- The migration ops (`migrate_queue`, `grow_queue`, `grow_bucket_queue`,
  `migration_fits`, `migrate_wheel`) against the JAX package's on
  numpy-seeded slabs (`shadow_tpu_torch.testing.migrate_case`, stale kind
  and payload words in empty slots): growth, shrink with compaction, the
  same capacity, flat and bucketed; the overfull refusal and the
  validation errors.
- Escalate on bench config 9 (`testing.cfg9_config`, 32 hosts, 3 sim-s)
  and on a tgen-TCP case (`testing.tgen_pressure_config`) at K = 1 on a
  flat queue: the whole report (pressure{} included) and the whole final
  state equal the JAX package's, also through the JAX -> port converter.
  At K = 4 on a bucketed queue the report's K- and layout-invariant keys and
  pressure{} equal the JAX K = 1 report, and at both points the escalated
  run equals a port run launched at the final shape with the escalation's
  pins (`Engine.resized_cfg`), state for state; PHOLD's K = 4 escalated
  state also equals the JAX package's K = 4 run at that final shape (the
  JAX package's tgen K = 4 programs compile for over a minute each on the
  CPU, so tgen at K = 4 is not held to a JAX K = 4 run).
- Merge gears under escalate (the ladder takes the regrown budget), the
  abort policy (report and dropping state equal the JAX package's) and a
  proactive regrow (`headroom: 0.5`).
- The out-of-memory fallback with an injected `torch.OutOfMemoryError`
  (rungs poisoned, cornered into `PressureAbort`, the last good state
  reported), the fits-checked shrink that corners instead of truncating,
  and a non-memory failure that propagates.
- The options' parse and the build refusals against the JAX package's
  messages, and the port's own refusal of a ladder past the queue
  kernels' limits.
- Checkpoints: save after escalating chunks -> load into a fresh
  simulation -> finish gives the JAX report; the cross-capacity resume
  down (32 -> 8 slots) and up (8 -> 16), each restored state equal to the
  JAX package's own save -> load and each finished run equal to a run
  built at the target; the overfull refusal in the JAX package's words;
  the other CheckpointError cases; and the supervisor killed by SIGKILL
  after its second checkpoint in a child process, resumed by another: the
  uninterrupted JAX digest.

Each JAX reference runs once per module. Tolerance: exact equality.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ConfigError as JaxConfigError
from shadow_tpu.config.options import ConfigOptions as JaxConfigOptions
from shadow_tpu.config.options import PressureOptions as JaxPressureOptions
from shadow_tpu.core.checkpoint import CheckpointError as JaxCheckpointError
from shadow_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from shadow_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from shadow_tpu.core.pressure import resolve_ladder as jax_resolve_ladder
from shadow_tpu.ops import events as jev
from shadow_tpu.ops import wheel as jwheel
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu.sim import heartbeat_line as jax_heartbeat_line
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions, PressureOptions
from shadow_tpu_torch.core.checkpoint import CheckpointError, load_checkpoint, save_checkpoint
from shadow_tpu_torch.core.convert import engine_config_from, state_from_jax_numpy, to_numpy
from shadow_tpu_torch.core.engine import EngineConfig, _init_stats
from shadow_tpu_torch.core.pressure import PressureAbort, ResilienceController, resolve_ladder
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import wheel as pwheel
from shadow_tpu_torch.ops.pressure import pressure_total
from shadow_tpu_torch.sim import Simulation, heartbeat_line
from shadow_tpu_torch.testing import cfg9_config, migrate_case, tgen_pressure_config

_NOT_RESULTS = ("wall_seconds", "sim_wall_ratio", "ici_bytes", "device", "host_syncs",
                "kernel_launches")
# report keys that do not depend on K or the queue layout
_INVARIANT = ("simulated_seconds", "rounds", "events_processed", "packets_sent",
              "packets_delivered", "packets_lost", "queue_overflow_dropped",
              "packets_budget_dropped", "outbox_overflow_dropped", "determinism_digest",
              "model_report", "pressure", "pressure_regrows", "pressure_replays")
CASES = {
    "phold": lambda **kw: cfg9_config(32, "3 s", rounds_per_chunk=16, **kw),
    "tgen": lambda **kw: tgen_pressure_config(**kw),
}
VARIANTS = {"k1_flat": {}, "k4_bucketed": {"k": 4}}
BLOCK = {"phold": 4, "tgen": 3}


def config(case: str, variant: str = "k1_flat", **kw) -> dict:
    v = dict(VARIANTS[variant])
    if variant == "k4_bucketed":
        v["block"] = BLOCK[case]
    return CASES[case](**v, **kw)


def results(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in _NOT_RESULTS}


def assert_states_equal(a: dict, b: dict, skip=()):
    assert set(a) - set(skip) == set(b) - set(skip)
    for k in a:
        if k not in skip:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """H <= 64: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's run of a named config, once per module: (report,
    final state as numpy copies, EngineConfig)."""
    cache = {}

    def get(name: str, cfg: dict):
        if name not in cache:
            sim = JaxSimulation(JaxConfigOptions.from_dict(cfg), world=1)
            rep = sim.run(progress=False)
            st = jax.tree.map(np.array, jax.device_get(sim.state))
            cache[name] = (rep, st, sim.engine.cfg)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_runs():
    """The port's run of (case, variant) on the CPU, once per module."""
    cache = {}

    def get(case: str, variant: str):
        if (case, variant) not in cache:
            sim = Simulation(ConfigOptions.from_dict(config(case, variant)), device="cpu")
            cache[case, variant] = (sim, sim.run(progress=False))
        return cache[case, variant]

    return get


# --------------------------------------------------------------------------
# the migration ops (B22) against the JAX package's
# --------------------------------------------------------------------------


def _queues(seed: int, h: int, cap: int, fill, block: int):
    c = migrate_case(seed, h, cap, "cpu", fill=fill)
    pq = pev.EventQueue(c["t"], c["order"], c["kind"], c["payload"], c["dropped"])
    jq = jev.EventQueue(*(jnp.asarray(c[f].numpy()) for f in
                          ("t", "order", "kind", "payload", "dropped")))
    if block:
        pq, jq = pev.bucket_rebuild(pq, block), jev.bucket_rebuild(jq, block)
    return pq, jq


def _assert_queue_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


MIGRATIONS = {
    "grow_flat": (8, 16, None, 0, 0),
    "grow_bucketed": (8, 16, None, 4, 4),
    "grow_rebucketed": (8, 32, None, 4, 8),
    "shrink_flat": (32, 8, 8, 0, 0),
    "shrink_bucketed_to_flat": (32, 16, 16, 4, 0),
    "same_flat": (16, 16, None, 0, 0),
    "wheel": (4, 8, None, 2, -1),
}


@pytest.mark.parametrize("name", list(MIGRATIONS))
def test_migrate_ops_match_jax(name):
    """`migrate_queue` (and `migrate_wheel`, `grow_queue`,
    `grow_bucket_queue` where they apply) equal the JAX package's on every
    plane, the caches of a bucketed result included; the input is left as
    it was."""
    cap, new_cap, fill, block, new_block = MIGRATIONS[name]
    pq, jq = _queues(7, 48, cap, fill, block)
    before = [x.clone() for x in pq]
    if new_block < 0:
        pairs = [(pwheel.migrate_wheel(pq, new_cap), jwheel.migrate_wheel(jq, new_cap)),
                 (pwheel.migrate_wheel(pwheel.migrate_wheel(pq, new_cap), cap),
                  jwheel.migrate_wheel(jwheel.migrate_wheel(jq, new_cap), cap))]
    else:
        pairs = [(pev.migrate_queue(pq, new_cap, new_block),
                  jev.migrate_queue(jq, new_cap, new_block))]
        if new_cap > cap and not block:
            pairs.append((pev.grow_queue(pq, new_cap), jev.grow_queue(jq, new_cap)))
        if new_cap > cap and block:
            pairs.append((pev.grow_bucket_queue(pq, new_cap), jev.grow_bucket_queue(jq, new_cap)))
    for got, want in pairs:
        _assert_queue_equal(got, want)
    for x, y in zip(pq, before):
        assert torch.equal(x, y)


def test_migration_fits_and_validation_match_jax():
    """`migration_fits` names the hosts whose live events do not fit, as
    the JAX package's does, on a flat and a bucketed overfull slab; the
    validation errors are the JAX package's."""
    for block in (0, 4):
        pq, jq = _queues(11, 64, 32, None, block)
        for k in (1, 8, 16, 32):
            assert np.array_equal(pev.migration_fits(pq, k).numpy(),
                                  np.asarray(jev.migration_fits(jq, k)))
        assert not pev.migration_fits(pq, 8).all()
    pq, jq = _queues(12, 8, 8, None, 0)
    for call in (lambda m, q: m.migrate_queue(q, 0), lambda m, q: m.migrate_queue(q, 8, 3),
                 lambda m, q: m.grow_queue(q, 8)):
        msgs = []
        for m, q in ((pev, pq), (jev, jq)):
            with pytest.raises(ValueError) as e:
                call(m, q)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_pressure_signal_and_drop_policy():
    """K26's plain version is the three sums; `resolve_ladder` is the JAX
    package's; the drop policy (the default) carries no pressure lane,
    builds no controller and launches no K26."""
    r = np.random.default_rng(3)
    d, b, ob = r.integers(0, 1 << 40, 64), r.integers(0, 1 << 40, 64), r.integers(0, 99, 1)
    got = pressure_total(*(torch.as_tensor(x) for x in (d, b, ob)))
    assert got.dtype == torch.int64 and got.tolist() == [int(d.sum() + b.sum() + ob[0])]
    for args in ((4, 64, 2), (4, 60, 2), (8, 8, 2), (3, 50, 4)):
        assert resolve_ladder(*args) == jax_resolve_ladder(*args)
    cfg = EngineConfig(num_hosts=4, stop_time=1)
    assert cfg.pressure_abort is False and _init_stats(cfg, "cpu").pressure is None
    sim = Simulation(ConfigOptions.from_dict(config("phold", policy="drop")), device="cpu")
    assert not sim.engine_cfg.pressure_abort and sim.state.stats.pressure is None
    rep = sim.run(progress=False)
    assert sim._resil is None and "pressure" not in rep
    assert rep["queue_overflow_dropped"] > 0  # the workload would drop


# --------------------------------------------------------------------------
# the escalate and abort policies against the JAX package's runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_escalate_k1_flat_matches_jax(case, jax_runs, port_runs):
    """The escalated run's whole report and final state equal the JAX
    package's (the JAX state also through the converter), with at least one
    regrow and no drop."""
    jrep, jst, jcfg = jax_runs(case, config(case))
    sim, rep = port_runs(case, "k1_flat")
    assert results(rep) == results(jrep)
    assert rep["pressure_regrows"] > 0 and rep["queue_overflow_dropped"] == 0
    assert_states_equal(to_numpy(sim.state), to_numpy(jst))
    conv = state_from_jax_numpy(jst, device="cpu")
    assert_states_equal(to_numpy(conv), to_numpy(sim.state))
    assert dataclasses.replace(engine_config_from(jcfg), hosts_per_node=0) == \
        dataclasses.replace(sim.engine_cfg, hosts_per_node=0)


def _final_shape_config(case: str, variant: str, base: EngineConfig, rep: dict) -> dict:
    """The case launched at the escalated run's final shape under drop,
    with the escalation's pins: the base's valve, and the insert cap
    following the capacity where the base left it auto."""
    cap, budget = rep["pressure"]["capacity"], rep["pressure"]["outbox"]
    c = config(case, variant, policy="drop")
    c["experimental"].update(event_queue_capacity=cap, sends_per_host_round=budget,
                             microstep_limit=base.effective_microstep_limit)
    return c


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(CASES))
def test_escalated_run_equals_final_shape(case, variant, jax_runs, port_runs):
    """The escalated run equals one launched at its final shape, state for
    state (the pressure lane and the per-chunk outbox high-water aside);
    at K = 4 bucketed its K- and layout-invariant report equals the JAX
    package's K = 1 report, pressure{} included. PHOLD at K = 4 bucketed is
    also held to the JAX package's K = 4 run at the final shape, state for
    state (the tgen case's JAX K = 4 programs compile for over a minute
    each on the CPU)."""
    sim, rep = port_runs(case, variant)
    c = _final_shape_config(case, variant, sim.engine_cfg, rep)
    ref = Simulation(ConfigOptions.from_dict(c), device="cpu")
    ref.run(progress=False)
    skip = ("stats.pressure", "stats.outbox_hwm")
    assert_states_equal(to_numpy(sim.state), to_numpy(ref.state), skip=skip)
    jrep = jax_runs(case, config(case))[0]
    assert {k: rep[k] for k in _INVARIANT} == {k: jrep[k] for k in _INVARIANT}
    if (case, variant) == ("phold", "k4_bucketed"):
        jrep4, jst4, _ = jax_runs("phold_k4_final", c)
        assert_states_equal(to_numpy(sim.state), to_numpy(jst4), skip=skip)
        assert jrep4["queue_overflow_dropped"] == 0


def test_gears_follow_an_escalated_budget(port_runs):
    """Merge gears and escalation share the controller: a geared escalate
    run gives the gear-free run's report, and the outbox's regrow puts its
    new width on the gear ladder, so the top gear still cannot shed."""
    ref = port_runs("phold", "k1_flat")[1]
    c = config("phold")
    c["experimental"]["merge_gears"] = "auto"
    rep = Simulation(ConfigOptions.from_dict(c), device="cpu").run(progress=False, start_gear=1)
    assert rep["gears"]["ladder"] == [1, 3, 6, 12] and rep["gears"]["replays"] > 0
    assert rep["pressure"]["outbox"] == 12
    assert {k: rep[k] for k in _INVARIANT} == {k: ref[k] for k in _INVARIANT}


def test_abort_policy_matches_jax(jax_runs):
    """`policy: abort` stops at the first dropping round and reports the
    dropping state: the JAX package's report and state."""
    c = config("phold", policy="abort")
    jrep, jst, _ = jax_runs("abort", c)
    sim = Simulation(ConfigOptions.from_dict(c), device="cpu")
    rep = sim.run(progress=False)
    assert results(rep) == results(jrep)
    assert rep["pressure_aborted"] and rep["aborted"] and rep["queue_overflow_dropped"] > 0
    assert_states_equal(to_numpy(sim.state), to_numpy(jst))


def test_proactive_regrow_matches_jax(jax_runs):
    """With `headroom: 0.5` a chunk boundary regrows before anything
    drops: the JAX package's report, proactive regrows counted."""
    c = config("phold", headroom=0.5)
    jrep = jax_runs("proactive", c)[0]
    rep = Simulation(ConfigOptions.from_dict(c), device="cpu").run(progress=False)
    assert results(rep) == results(jrep)
    assert rep["pressure"]["proactive_regrows"] > 0


def _oom_above(sim, cap0: int):
    """Make every dispatch at a capacity above `cap0` raise PyTorch's
    out-of-memory error (the allocator's failure on the card)."""
    run = sim.engine.run_chunk_resized

    def dispatch(st, params, gear, cap, budget):
        if cap > cap0:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return run(st, params, gear, cap, budget)

    sim.engine.run_chunk_resized = dispatch


@pytest.mark.parametrize("mode", ["corner", "no_fit", "other_error"])
def test_oom_fallback(mode):
    """corner: every grown capacity runs out of memory: each failure falls
    back and poisons its rungs until the drops persist with no usable rung,
    a graceful PressureAbort reporting the last good (drop-free) state.
    no_fit: a grown state whose live events no longer fit any lower rung
    corners at once instead of truncating them. other_error: a failure that
    is not out of memory propagates."""
    c = config("phold")
    sim = Simulation(ConfigOptions.from_dict(c), device="cpu")
    if mode == "corner":
        _oom_above(sim, 8)
        rep = sim.run(progress=False)
        p = rep["pressure"]
        assert rep["pressure_aborted"] and rep["aborted"] and p["aborted"]
        assert p["oom_fallbacks"] >= 1 and p["capacity_poisoned"] == [16, 32, 64]
        assert "no usable rung" in p["last_error"] and rep["queue_overflow_dropped"] == 0
        return
    if mode == "no_fit":
        st = sim.state._replace(queue=pev.grow_queue(sim.state.queue, 16))
        h = st.queue.t.shape[0]
        st.queue.t[:, 8:12] = 10**9 + torch.arange(4)[None, :]
        st.queue.order[:, 8:12] = torch.arange(h * 4).reshape(h, 4)
        rc = ResilienceController(pressure=PressureOptions(policy="escalate", max_capacity=64))
        rc._ensure_ladders(8, 6)
        _oom_above(sim, 0)
        with pytest.raises(PressureAbort, match="no longer fit"):
            rc.run_chunk(sim.engine, st, sim.params)
        good = rc.abort_export_state()
        assert rc.aborted and good.queue.t.shape[1] == 16
        assert int(pev.queue_len(good.queue).min()) == 10
        return

    def boom(*_):
        raise RuntimeError("kernel launch failed")

    sim.engine.run_chunk_resized = boom
    rc = ResilienceController(pressure=PressureOptions(policy="escalate"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        rc.run_chunk(sim.engine, sim.state, sim.params)
    assert rc.oom_fallbacks == 0


# --------------------------------------------------------------------------
# options and build refusals
# --------------------------------------------------------------------------


def test_options_and_build_refusals_match_jax():
    """The `pressure:` block parses to the JAX package's values and refuses
    the same values with the same messages; the build refuses escalate with
    merge_rows, an explicit a2a_block and ceilings below the base shape,
    as the JAX package does; and the port refuses a ladder whose top rung
    breaks the queue kernels' limits (1,024 slots, 32 blocks per host)."""
    for d in (None, {"policy": "escalate", "max_capacity": 128, "headroom": 0.5},
              {"policy": "abort", "max_outbox": 12, "growth_factor": 3}):
        assert dataclasses.asdict(PressureOptions.from_dict(d)) == \
            dataclasses.asdict(JaxPressureOptions.from_dict(d))
    for bad in ({"policy": "grow"}, {"max_capacity": -1}, {"growth_factor": 1},
                {"headroom": 1.5}, {"memory_safety_factor": 0.5}, {"unknown": 1}):
        with pytest.raises(JaxConfigError) as je:
            JaxPressureOptions.from_dict(bad)
        with pytest.raises(ConfigError, match=re.escape(str(je.value))):
            PressureOptions.from_dict(bad)
    refusals = {
        "merge_rows": ({"merge_rows": 64}, {}),
        "a2a_block": ({"a2a_block": 64}, {}),
        "max_capacity": ({}, {"max_capacity": 4}),
        "max_outbox": ({}, {"max_outbox": 3}),
    }
    for name, (ex, press) in refusals.items():
        c = config("phold", **press)
        c["experimental"].update(ex)
        with pytest.raises(JaxConfigError) as je:
            JaxSimulation(JaxConfigOptions.from_dict(c), world=1)
        with pytest.raises(ConfigError) as pe:
            Simulation(ConfigOptions.from_dict(c), device="cpu")
        assert str(pe.value) == str(je.value) and name in str(pe.value)
    for press, ex in (({"max_capacity": 2048}, {}),
                      ({"max_capacity": 0}, {"event_queue_capacity": 256}),
                      ({"max_capacity": 512}, {"event_queue_block": 4})):
        c = config("phold", **press)
        c["experimental"].update(ex)
        with pytest.raises(ConfigError, match="queue kernels' limit of 1024 slots"):
            Simulation(ConfigOptions.from_dict(c), device="cpu")


def test_heartbeat_cap_field_like_jax():
    """`cap=<capacity>` rides after `gear=`, as in the JAX package's line."""
    ours = heartbeat_line(10**9, 1.0, 5, 4, 3, 7, 9, gear=6, cap=32)
    theirs = jax_heartbeat_line(10**9, 1.0, 5, 4, 3, 0, 7, gear=6, cap=32)
    assert "gear=6 cap=32 " in ours and "gear=6 cap=32 " in theirs
    assert "cap=" not in heartbeat_line(10**9, 1.0, 5, 4, 3, 7, 9, gear=6)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _sim(c: dict) -> Simulation:
    return Simulation(ConfigOptions.from_dict(c), device="cpu")


def test_checkpoint_resume_after_escalation_matches_jax(tmp_path, jax_runs):
    """Two chunks under escalate (the slab regrows), save, load into a
    fresh simulation of the same config, finish: the JAX package's report
    and final state."""
    c = config("phold")
    jrep, jst, _ = jax_runs("phold", c)
    a = _sim(c)
    rc = ResilienceController(pressure=a.cfg.pressure, queue_block=0)
    for _ in range(2):
        a.state, _, _ = rc.run_chunk(a.engine, a.state, a.params)
    assert a.state.queue.t.shape[1] > 8
    path = save_checkpoint(str(tmp_path / "ck"), a)
    b = _sim(c)
    load_checkpoint(path, b)
    assert b.state.queue.t.shape == a.state.queue.t.shape
    rep = b.run(progress=False)
    # pressure{} and the run-wide outbox high-water are the resumed run's
    # own accounting (neither lives in the state), as in the JAX package
    keys = [k for k in results(jrep) if not k.startswith("pressure")
            and k != "outbox_send_hwm"]
    assert {k: rep[k] for k in keys} == {k: jrep[k] for k in keys}
    assert_states_equal(to_numpy(b.state), to_numpy(jst))


def test_checkpoint_cross_capacity_both_ways(tmp_path):
    """Under drop a t = 0 checkpoint written at 32 slots resumes into the
    8-slot build (K25's shrink) and one written at 8 into a 16-slot build
    (growth): the restored state equals the JAX package's own save -> load
    of the same state, and the resumed run equals a run built at the
    target. A state at 32 slots whose live events exceed 8 per host is
    refused with the JAX package's CheckpointError text; so is, in the same
    words, one written after a chunk at 32."""
    def drop(cap, budget=6, msl=16):  # config 9 at 32 hosts, cut to 1 sim-s
        c = cfg9_config(32, "1 s", policy="drop", cap=cap, budget=budget, rounds_per_chunk=16)
        c["experimental"]["microstep_limit"] = msl
        return c

    def jax_state(jsim) -> dict:
        return to_numpy(jax.tree.map(np.array, jax.device_get(jsim.state)))

    cfgs = {"32": drop(32, 12), "8": drop(8), "16": drop(16, msl=32)}
    port = {k: _sim(c) for k, c in cfgs.items()}
    jsims = {k: JaxSimulation(JaxConfigOptions.from_dict(c), world=1) for k, c in cfgs.items()}
    files = {}
    for k in ("32", "8"):
        assert_states_equal(to_numpy(port[k].state), jax_state(jsims[k]))
        files[k] = (save_checkpoint(str(tmp_path / f"p{k}"), port[k]),
                    jax_save_checkpoint(str(tmp_path / f"j{k}"), jsims[k]))
    for src, dst in (("32", "8"), ("8", "16")):
        b, jb = _sim(cfgs[dst]), jsims[dst]
        load_checkpoint(files[src][0], b)
        jax_load_checkpoint(files[src][1], jb)
        assert b.state.queue.t.shape == (32, int(dst))
        assert_states_equal(to_numpy(b.state), jax_state(jb))
        rep = b.run(progress=False)
        ref = port[dst]
        assert results(rep) == results(ref.run(progress=False))
        assert_states_equal(to_numpy(b.state), to_numpy(ref.state))

    # overfull: the same four extra live events per host in both t = 0 states
    a, ja = _sim(cfgs["32"]), jsims["32"]
    q = a.state.queue
    q.t[:, 8:12] = 10**9 + torch.arange(4)[None, :]
    q.order[:, 8:12] = torch.arange(32 * 4).reshape(32, 4)
    ja.state = ja.state._replace(queue=ja.state.queue._replace(
        t=jnp.asarray(q.t.numpy()), order=jnp.asarray(q.order.numpy())))
    assert_states_equal(to_numpy(a.state), jax_state(ja))
    with pytest.raises(JaxCheckpointError) as je:
        jax_load_checkpoint(jax_save_checkpoint(str(tmp_path / "jo"), ja), jsims["8"])
    with pytest.raises(CheckpointError) as pe:
        load_checkpoint(save_checkpoint(str(tmp_path / "po"), a), _sim(cfgs["8"]))
    assert str(pe.value) == str(je.value)
    assert "holds up to 10 live events per host" in str(pe.value)

    a = _sim(cfgs["32"])
    a.state = a.engine.run_chunk(a.state, a.params)
    p = save_checkpoint(str(tmp_path / "c1"), a)
    occ = int(pev.queue_len(a.state.queue).max())
    assert occ > 8
    with pytest.raises(CheckpointError) as pe1:
        load_checkpoint(p, _sim(cfgs["8"]))
    assert str(pe1.value) == str(pe.value).replace(" 10 ", f" {occ} ")


def test_checkpoint_errors(tmp_path):
    """Refused: another model parameter, another queue layout kind and the
    timer wheel's presence (each changes the guard), and a send-budget
    change with outbox entries in flight."""
    c = config("phold", policy="drop")
    a = _sim(c)
    p = save_checkpoint(str(tmp_path / "a"), a)
    other = config("phold", policy="drop")
    other["hosts"]["node"]["processes"][0]["model_args"]["mean_delay"] = "100 ms"
    with pytest.raises(CheckpointError, match="does not match"):
        load_checkpoint(p, _sim(other))
    bucketed = config("phold", policy="drop", block=4)
    with pytest.raises(CheckpointError, match="does not match"):
        load_checkpoint(p, _sim(bucketed))
    t = tgen_pressure_config(policy="drop")
    wheel = tgen_pressure_config(policy="drop")
    wheel["experimental"]["timer_wheel"] = 4
    with pytest.raises(CheckpointError):
        load_checkpoint(save_checkpoint(str(tmp_path / "t"), _sim(t)), _sim(wheel))
    ob = a.state.outbox
    ob.t[0, 0] = 5
    p = save_checkpoint(str(tmp_path / "b"), a, a.state._replace(outbox=ob))
    wide = config("phold", policy="drop")
    wide["experimental"]["sends_per_host_round"] = 12
    with pytest.raises(CheckpointError, match="in-flight outbox"):
        load_checkpoint(p, _sim(wide))


_CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core.checkpoint import load_checkpoint
from shadow_tpu_torch.sim import Simulation
with open(sys.argv[1]) as f:
    sim = Simulation(ConfigOptions.from_dict(json.load(f)), device="cpu")
if len(sys.argv) > 2:
    load_checkpoint(sys.argv[2], sim)
print(json.dumps(sim.run(progress=False)))
"""


def test_supervisor_kill_and_resume(tmp_path, jax_runs):
    """The supervisor writes a checkpoint after every chunk (atomically);
    a child process killed by SIGKILL right after its second one leaves it
    on disk, and a second child that resumes from it finishes with the
    uninterrupted run's JAX digest and counters."""
    jrep = jax_runs("phold", config("phold"))[0]
    ck = str(tmp_path / "ck.npz")
    c = config("phold", supervisor={"snapshot_every_chunks": 1, "checkpoint_file": ck})
    c["general"]["data_directory"] = str(tmp_path / "data")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(c))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    cmd = [sys.executable, "-c", _CHILD, str(cfg_file)]
    killed = subprocess.run(cmd, env={**env, "SHADOW_TPU_TORCH_TEST_KILL_AT_CHECKPOINT": "2"},
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9 and os.path.exists(ck), killed.stderr[-2000:]
    assert not os.path.exists(ck + ".tmp.npz")
    resumed = subprocess.run(cmd + [ck], env=env, capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    rep = json.loads(resumed.stdout.strip().splitlines()[-1])
    for k in ("determinism_digest", "events_processed", "rounds", "microsteps",
              "queue_overflow_dropped", "packets_budget_dropped"):
        assert rep[k] == jrep[k], k
    assert rep["supervisor"]["checkpoints"] >= 1
