"""PyTorch port vs JAX reference: the ensemble plane (B27).

The port folds R replicas into R x H rows of one round loop
(core/ensemble.py, `EngineConfig.replicas`); the JAX package vmaps its
chunk. The gates, on the CPU (the plain versions of every kernel):

  (a) a PHOLD seed sweep (flat queue, K = 1, seeds 1-3): each replica's
      gated stats, queue drops and rounds equal the JAX ensemble's, and the
      ledger rows and xor signatures (K32's plain version) equal JAX's
      `replica_ledger` and `replica_digest_sigs`;
  (b) the fault-schedule sweep of tests/test_ensemble.py (crash-window
      padding, two loss windows) against the JAX ensemble;
  (c) phold, udp_echo and tgen_tcp x flat/bucketed x K in {1, 4}, two
      seeds: replica r's whole final state equals the port's solo run of
      the same build
      (the port's solo runs are held to JAX by the other test files);
  (d) `run_campaign` against the JAX repo's tools/campaign.py on two crash
      schedules under a repeated seed (`testing.CAMPAIGNS["ab_pairs"]`: an
      A/A pair and a pair diverging mid-run): every ledger row, the
      per-chunk signatures, `identical` and the bisected
      `first_divergent_chunk`;
  (e) the refusals, with the JAX package's messages where it has them;
  (f) the ensemble checkpoint round trip, its fingerprint guard, and a
      campaign stopped after its first checkpoint and resumed;
  (g) `state_digest_sig` on [R] rounds;
  (h) K31's plain version against JAX's vmapped window arithmetic and a
      frozen replica's pop limits.

Each JAX reference is computed once per module. Tolerance: exact equality
throughout.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.config.options import ConfigError as JaxConfigError
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.ensemble import build_ensemble as jax_build_ensemble
from shadow_tpu.core.ensemble import replica_digest_sigs as jax_digest_sigs
from shadow_tpu.core.ensemble import replica_ledger as jax_replica_ledger
from shadow_tpu_torch.campaign import build_campaign, run_campaign
from shadow_tpu_torch.config.options import ConfigError
from shadow_tpu_torch.core.checkpoint import (
    CheckpointError,
    load_ensemble_checkpoint,
    save_ensemble_checkpoint,
    snapshot_state,
)
from shadow_tpu_torch.core.convert import engine_config_from, params_from_jax_numpy, to_numpy
from shadow_tpu_torch.core.engine import Engine
from shadow_tpu_torch.core.ensemble import (
    EnsembleEngine,
    build_ensemble,
    replica_digest_sigs,
    replica_ledger,
    tree_index,
)
from shadow_tpu_torch.core.supervisor import state_digest_sig
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.ops import ensemble as pens
from shadow_tpu_torch.simtime import TIME_MAX
from shadow_tpu_torch.testing import CAMPAIGNS, campaign_base

# the counters the gate compares per replica (tests/test_ensemble.py's)
_GATED_STATS = (
    "digest", "events", "pkts_sent", "pkts_lost", "pkts_delivered",
    "pkts_unreachable", "pkts_codel_dropped", "pkts_budget_dropped",
    "monotonic_violations", "faults_dropped", "faults_delayed",
    "popk_deferred",
)

# tests/test_ensemble.py's workloads, echo cut to 0.15 sim-s and tgen to 1
_CASES = {
    "phold": ("phold", mk_hosts(10, {"mean_delay": "20 ms", "population": 3}),
              400_000_000, dict(loss=0.1)),
    "echo": ("udp_echo",
             [dict(host_id=0, name="server", start_time=0, model_args={"role": "server"})]
             + [dict(host_id=i, name=f"c{i}", start_time=0,
                     model_args={"role": "client", "peer": "server",
                                 "interval": "4 ms", "size_bytes": 2000})
                for i in range(1, 5)],
             150_000_000, dict(bw_bits=2_000_000, loss=0.05, use_codel=True)),
    "tgen": ("tgen_tcp",
             mk_hosts(6, {"flow_segs": 12, "flows": 1, "cwnd_cap": 8, "rto_min": "100 ms"}),
             1_000_000_000, dict(loss=0.05, latency=10_000_000, sends_budget=16)),
}

_SCHEDS = [
    {"crashes": [{"host": 2, "down_at": "0.1 s", "up_at": "0.25 s"},
                 {"host": 2, "down_at": "0.3 s", "up_at": "0.35 s"}],
     "loss_windows": [{"start": "0.05 s", "end": "0.2 s", "loss": 0.3}]},
    {"host_churn": {"prob": 0.5, "mean_downtime": "0.1 s"}, "seed": 9,
     "loss_windows": [{"start": "0.1 s", "end": "0.3 s", "loss": 0.1,
                       "latency_factor": 2.0},
                      {"start": "0.32 s", "end": "0.36 s", "loss": 0.5}]},
]


@pytest.fixture(autouse=True)
def _one_thread():
    """H <= 16: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _builds(model_name, hosts, stop, specs, **kw):
    """Per (seed, faults) spec, one build_sim: the JAX (cfg, state, params)
    and the port's (engine, (cfg, state, params)) from the same inputs."""
    jreps, preps, jmodel = [], [], None
    for seed, faults in specs:
        jcfg, jmodel, params, mstate, events = build_sim(
            model_name, hosts, stop, world=1, seed=seed, faults=faults, **kw)
        raw = jax.device_get(params)
        jeng = JaxEngine(jcfg, jmodel, None)
        jst, jpar = jeng.init_state(params, mstate, events, seed=seed)
        jreps.append((jeng.cfg, jst, jpar))
        eng = Engine(engine_config_from(jcfg), get_model(model_name)(), "cpu")
        mp, ms, ev = eng.model.build(hosts, seed, "cpu")
        p0 = params_from_jax_numpy(raw, device="cpu")._replace(model=mp)
        st, par = eng.init_state(p0, ms, ev, seed=seed)
        preps.append((eng, (eng.cfg, st, par)))
    return jmodel, jreps, preps


def _run_jax(jmodel, jreps):
    ens, st = jax_build_ensemble(jmodel, jreps)
    while not bool(np.asarray(jax.device_get(st.done)).all()):
        st = ens.run_chunk(st)
    return ens, jax.device_get(st)


def _run_port(preps):
    ens, st = build_ensemble(preps[0][0].model, [rep for _, rep in preps], "cpu")
    n = 0
    while not st.done.all():
        st = ens.run_chunk(st)
        n += 1
        assert n < 200, "ensemble run failed to terminate"
    return ens, st


def _per_replica(x, r_count):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x).reshape(r_count, -1)


def _assert_matches_jax(pst, jst, r_count, ctx):
    for f in _GATED_STATS:
        want = np.asarray(getattr(jst.stats, f))
        want = _per_replica(want.view(np.int64) if want.dtype == np.uint64 else want, r_count)
        got = getattr(pst.stats, f)
        # the fault counters: the JAX package carries them (as zeros) with
        # the plane off, the port does not
        got = np.zeros_like(want) if got is None else _per_replica(got, r_count)
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: stats.{f}")
    np.testing.assert_array_equal(_per_replica(pst.queue.dropped, r_count),
                                  _per_replica(jst.queue.dropped, r_count), err_msg=ctx)
    np.testing.assert_array_equal(_per_replica(pst.stats.rounds, r_count)[:, 0],
                                  _per_replica(jst.stats.rounds, r_count)[:, 0], err_msg=ctx)
    np.testing.assert_array_equal(pst.now, np.asarray(jst.now))
    np.testing.assert_array_equal(pst.done, np.asarray(jst.done))


@pytest.fixture(scope="module")
def seed_sweep():
    """(a)'s builds and both packages' finished ensembles, once."""
    model, hosts, stop, kw = _CASES["phold"]
    jmodel, jreps, preps = _builds(model, hosts, stop, [(s, None) for s in (1, 2, 3)], **kw)
    _, jst = _run_jax(jmodel, jreps)
    _, pst = _run_port(preps)
    return jst, pst


def test_seed_sweep_matches_jax_ensemble(seed_sweep):
    jst, pst = seed_sweep
    _assert_matches_jax(pst, jst, 3, "phold seed sweep")


def test_ledger_and_sigs_match_jax(seed_sweep):
    """K32's plain version (replica_ledger, replica_digest_sigs) against the
    JAX package's helpers on the same finished campaign."""
    jst, pst = seed_sweep
    assert replica_ledger(pst, labels=["a", "b", "c"]) == \
        jax_replica_ledger(jst, labels=["a", "b", "c"])
    np.testing.assert_array_equal(replica_digest_sigs(pst), jax_digest_sigs(jst))
    # a prefix of real hosts (the ledger's num_real)
    assert replica_ledger(pst, 7) == jax_replica_ledger(jst, 7)


def test_fault_schedule_sweep_matches_jax_ensemble():
    """Crash windows padded 2 -> W, two loss windows on every replica."""
    hosts = mk_hosts(8, {"mean_delay": "20 ms", "population": 3})
    specs = [(1, _SCHEDS[0]), (2, _SCHEDS[1]), (3, _SCHEDS[0])]
    jmodel, jreps, preps = _builds("phold", hosts, 400_000_000, specs, loss=0.1)
    jens, jst = _run_jax(jmodel, jreps)
    pens_, pst = _run_port(preps)
    assert pens_.cfg.fault_loss_windows == jens.cfg.fault_loss_windows == 2
    assert pens_.cfg.fault_crash_windows == jens.cfg.fault_crash_windows
    _assert_matches_jax(pst, jst, 3, "fault sweep")
    assert int(pst.stats.faults_delayed.sum()) > 0


_GRID = [(0, 1), (0, 4), (8, 1), (8, 4)]


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("qb,k", _GRID, ids=lambda v: str(v))
def test_replica_equals_port_solo(case, qb, k):
    """Replica r's whole final state is the port's solo run of its build,
    across models x queue layouts x K (the folded rows, the [R] lanes and
    the per-replica window/done/microsteps all line up)."""
    model, hosts, stop, kw = _CASES[case]
    builds = []
    for seed in (1, 2):
        jcfg, _, params, _, _ = build_sim(model, hosts, stop, world=1, seed=seed,
                                          queue_block=qb, microstep_events=k, **kw)
        eng = Engine(engine_config_from(jcfg), get_model(model)(), "cpu")
        mp, ms, ev = eng.model.build(hosts, seed, "cpu")
        p0 = params_from_jax_numpy(jax.device_get(params), device="cpu")._replace(model=mp)
        st, par = eng.init_state(p0, ms, ev, seed=seed)
        builds.append((eng, st, par))
    ens, folded = build_ensemble(builds[0][0].model, [(e.cfg, s, p) for e, s, p in builds], "cpu")
    while not folded.done.all():
        folded = ens.run_chunk(folded)
    for r, (eng, st, par) in enumerate(builds):
        while not st.done:
            st = eng.run_chunk(st, par)
        a, b = to_numpy(tree_index(folded, r)), to_numpy(st)
        bad = [key for key in b if not np.array_equal(a[key], b[key])]
        assert not bad, f"{case} qb={qb} k={k} replica {r}: {bad}"
        assert tree_index(folded, r).now == st.now and tree_index(folded, r).done == st.done
    if k > 1:
        assert folded.stats.popk_deferred.shape == (2,)


# ------------------------------------------------------- the campaign driver

def test_run_campaign_matches_jax():
    """Two crash schedules under a repeated seed: an A/A pair and a pair
    that diverges mid-run, bisected; every ledger row, the per-chunk
    signatures, the pairs and the bisected chunk against the JAX repo's
    tools/campaign.py; each replica's solo run gives its digest, and the
    campaign's host reads are fewer than the solos' together."""
    from tools.campaign import run_campaign as jax_run_campaign

    from shadow_tpu_torch.campaign import expand_replicas, replica_config_dict
    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.sim import Simulation

    base = campaign_base(CAMPAIGNS["ab_pairs"])
    want = jax_run_campaign(copy.deepcopy(base), log=io.StringIO())
    got = run_campaign(base, log=io.StringIO(), device="cpu")
    for key in ("replicas", "chunk_digest_sigs", "expect_identical", "identical",
                "divergences"):
        assert got[key] == want[key], key
    for key in ("replicas", "labels", "seeds", "chunks", "rounds_per_chunk", "num_hosts"):
        assert got["campaign"][key] == want["campaign"][key], key
    assert got["identical"] == [[0, 2]]
    assert 1 < got["divergences"][0]["first_divergent_chunk"] < got["campaign"]["chunks"]
    solo = 0
    for spec in expand_replicas(ConfigOptions.from_dict(base)):
        cfg = ConfigOptions.from_dict(replica_config_dict(base, spec))
        rep = Simulation(cfg, device="cpu").run(progress=False, log=io.StringIO())
        assert rep["determinism_digest"] == got["replicas"][spec.index]["digest"]
        solo += rep["host_syncs"]
    assert got["campaign"]["host_syncs"] < solo


def test_campaign_heartbeat_carries_rep():
    log = io.StringIO()
    run_campaign(campaign_base({"seeds": [1, 2]}), log=log, device="cpu")
    beats = [ln for ln in log.getvalue().splitlines() if ln.startswith("[heartbeat]")]
    assert beats and "rep=2/2" in beats[-1] and "rep=0/2" in beats[0]


def _jax_refusal(d):
    from tools.campaign import build_campaign as jax_build_campaign

    with pytest.raises(JaxConfigError) as e:
        jax_build_campaign(copy.deepcopy(d))
    return str(e.value)


@pytest.mark.parametrize("knob", ["pressure", "gears", "integrity", "world"])
def test_campaign_refusals_match_jax(knob):
    d = campaign_base({"seeds": [1, 2]})
    if knob == "pressure":
        d["pressure"] = {"policy": "escalate"}
    elif knob == "gears":
        d["experimental"]["merge_gears"] = "auto"
    elif knob == "integrity":
        d["integrity"] = {"enabled": True}
    else:
        d["general"]["parallelism"] = 2
    want = _jax_refusal(d)
    with pytest.raises(ConfigError) as e:
        build_campaign(d, device="cpu")
    assert str(e.value) == want


@pytest.mark.parametrize("knob", ["trace", "network", "memory", "runtime"])
def test_campaign_refuses_observability_riders(knob):
    d = campaign_base({"seeds": [1, 2]})
    d["observability"] = {knob: True}
    with pytest.raises(ConfigError, match=f"observability.{knob}"):
        build_campaign(d, device="cpu")


def test_static_mismatch_and_loss_window_mixing_refused():
    """The JAX package's reconciliation messages: a K fold that differs,
    and loss windows on some replicas only; and world > 1."""
    hosts = mk_hosts(4, {"mean_delay": "20 ms", "population": 2})
    _, _, ka = _builds("phold", hosts, 200_000_000, [(1, None)], microstep_events=1)
    _, _, kb = _builds("phold", hosts, 200_000_000, [(2, None)], microstep_events=4)
    model = ka[0][0].model
    with pytest.raises(ConfigError, match="EngineConfig static"):
        build_ensemble(model, [ka[0][1], kb[0][1]], "cpu")
    lossy = {"loss_windows": [{"start": "0.05 s", "end": "0.1 s", "loss": 0.5}]}
    _, _, la = _builds("phold", hosts, 200_000_000, [(1, None), (1, lossy)])
    with pytest.raises(ConfigError, match="loss-window"):
        build_ensemble(model, [rep for _, rep in la], "cpu")
    with pytest.raises(ConfigError, match="world"):
        EnsembleEngine(dataclasses.replace(ka[0][1][0], world=2), model)


def test_differing_routing_table_refused():
    hosts = mk_hosts(4, {"mean_delay": "20 ms", "population": 2})
    _, _, a = _builds("phold", hosts, 200_000_000, [(1, None)])
    _, _, b = _builds("phold", hosts, 200_000_000, [(2, None)], latency=40_000_000)
    cfg_b, st_b, par_b = b[0][1]
    with pytest.raises(ConfigError, match="EngineParams.lat_ns"):
        build_ensemble(a[0][0].model, [a[0][1], (a[0][1][0], st_b, par_b)], "cpu",
                       labels=["seed=1", "seed=2,ov=1"])


# ------------------------------------------------------- checkpoints, digests


def test_ensemble_checkpoint_roundtrip_and_guard(tmp_path):
    hosts = mk_hosts(6, {"mean_delay": "20 ms", "population": 2})
    _, _, preps = _builds("phold", hosts, 300_000_000, [(1, None), (2, None)], queue_block=8)
    ens, st = build_ensemble(preps[0][0].model, [rep for _, rep in preps], "cpu")
    template = snapshot_state(st)
    while not st.done.all():
        st = ens.run_chunk(st)
    path = save_ensemble_checkpoint(str(tmp_path / "camp"), st, "fp-abc")
    restored = load_ensemble_checkpoint(path, template, "fp-abc")
    a = to_numpy(restored._replace(now=0, done=False))
    b = to_numpy(st._replace(now=0, done=False))
    assert not [k for k in a if not np.array_equal(a[k], b[k])]
    np.testing.assert_array_equal(restored.now, st.now)
    np.testing.assert_array_equal(restored.done, st.done)
    with pytest.raises(CheckpointError, match="does not match"):
        load_ensemble_checkpoint(path, template, "fp-other")


def test_campaign_resumes_from_its_checkpoint(tmp_path):
    """Stopped after its first chunk (the wall budget) with a checkpoint
    every chunk, then resumed: the uninterrupted campaign's rows."""
    camp = {"seeds": [1, 2]}
    full = run_campaign(campaign_base(camp), log=io.StringIO(), device="cpu")
    d = campaign_base(camp, data_directory=str(tmp_path))
    d["faults"] = {"supervisor": {"snapshot_every_chunks": 1, "checkpoint_file": "camp"}}
    cut = run_campaign(d, log=io.StringIO(), device="cpu", wall_budget_s=0.0)
    assert cut["campaign"]["truncated"] and cut["campaign"]["chunks"] == 1
    res = run_campaign(d, log=io.StringIO(), device="cpu", resume=True)
    assert res["replicas"] == full["replicas"]
    assert res["chunk_digest_sigs"] == full["chunk_digest_sigs"][1:]
    with pytest.raises(ConfigError, match="no ensemble checkpoint"):
        run_campaign(campaign_base(camp, data_directory=str(tmp_path / "x")),
                     log=io.StringIO(), device="cpu", resume=True)


def test_state_digest_sig_sums_replica_rounds(seed_sweep):
    _, pst = seed_sweep
    rounds, digest = state_digest_sig(pst)
    assert rounds == int(pst.stats.rounds.sum()) > 0
    want = 0
    for s in replica_digest_sigs(pst):
        want ^= int(s)
    assert digest == want


# ------------------------------------------------------- K31's plain version


def test_replica_window_plain_against_jax_vmap():
    r = np.random.default_rng(5)
    reps, h, stop = 4, 16, 10**9
    nt = r.integers(0, 2 * stop, (reps, h))
    nt[1] = TIME_MAX  # an empty replica: done
    nt[2, 3] = stop - 1
    used = r.integers(1, 80, reps) * 1_000_000
    for dynamic in (False, True):
        lanes = pens.make_lanes([False, False, False, True], "cpu")
        lanes[pens.WEND, 3] = 77
        pop = torch.empty((reps * h,), dtype=torch.int64)
        pens.replica_window(pens.ROUND, torch.as_tensor(nt.reshape(-1)), lanes, pop, rows=h,
                            stop=stop, runahead=50_000_000, floor=2_000_000, dynamic=dynamic,
                            min_used=torch.as_tensor(used), limit=3)

        def window(x, u):
            g = jnp.min(x)
            ra = jnp.maximum(u, 2_000_000) if dynamic else 50_000_000
            return jnp.minimum(jnp.minimum(g, stop) + ra, stop), g >= stop

        we, done = jax.vmap(window)(jnp.asarray(nt), jnp.asarray(used))
        np.testing.assert_array_equal(lanes[pens.WEND, :3].numpy(), np.asarray(we)[:3])
        assert lanes[pens.WEND, 3] == 77  # the frozen replica keeps its lanes
        np.testing.assert_array_equal(lanes[pens.DONE].numpy(),
                                      np.asarray(done) | np.array([0, 0, 0, 1], bool))
        np.testing.assert_array_equal(lanes[pens.LIVE].numpy(),
                                      ~np.asarray(done) & np.array([1, 1, 1, 0], bool))
        # the loop test: pending where live and some host is before the
        # window end, under the valve; pop limits 0 on the other rows
        valve = torch.as_tensor(r.integers(0, 3, reps * h))
        count = torch.as_tensor(r.integers(0, 9, reps).astype(np.int32))
        pens.replica_window(pens.LOOP, torch.as_tensor(nt.reshape(-1)), lanes, pop, rows=h,
                            stop=stop, runahead=50_000_000, floor=2_000_000, dynamic=dynamic,
                            min_used=torch.as_tensor(used), limit=3, valve=valve,
                            ob_count=count)
        we_np = lanes[pens.WEND].numpy()
        pend = (lanes[pens.LIVE].numpy() != 0) & (nt < we_np[:, None]).any(1)
        np.testing.assert_array_equal(lanes[pens.PENDING].numpy(), pend)
        np.testing.assert_array_equal(lanes[pens.STEPS].numpy(), pend)
        np.testing.assert_array_equal(lanes[pens.SENDS].numpy(), count.numpy())
        np.testing.assert_array_equal(pop.view(reps, h).numpy(),
                                      np.where(pend, we_np, 0)[:, None].repeat(h, 1))


def test_ensemble_cli_refuses_without_a_card(tmp_path, monkeypatch):
    """No `--device cpu` and no CUDA device: the entry point fails rather
    than running on the CPU."""
    import yaml

    from shadow_tpu_torch.campaign import main

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(campaign_base({"seeds": [1, 2]})))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([str(path)]) == 1
    out = tmp_path / "ledger.json"
    assert main([str(path), "--device", "cpu", "-o", str(out)]) == 0
    assert os.path.exists(out)
