"""PyTorch port vs JAX reference: the fault plane (B13, B14) and the run
supervisor.

Bench config 7 (`shadow_tpu_torch.testing.cfg7_config`: PHOLD under host
churn, a lossy and slow window, the supervisor) at 48 hosts, cut short,
through both packages' `Simulation`: the whole report must agree — digest,
events, rounds, microsteps, every drop counter with `faults_dropped` and
`faults_delayed`, the model report and the `supervisor{}` block — for
queue hold and queue clear, each at K = 1 on a flat queue and at K = 4 on
a bucketed one, with the CPU model, on the timer wheel, and with a loss
window that opens inside the bootstrap phase. Each JAX reference runs once
per module. The data directory (`write_outputs`: per-host host-stats.json,
sim-stats.json) equals the JAX package's. Then `compile_faults` against
the JAX package's arrays, the
plain device functions against the JAX package's on seeded inputs at the
windows' edges, the K1 fault floor by hand, the supervisor's retry (same
digest), bounded abort (last good state) and digest cross-check, and the
options' parse and refusals.

Tolerance: exact equality everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ConfigOptions as JaxConfigOptions
from shadow_tpu.config.options import FaultOptions as JaxFaultOptions
from shadow_tpu.core import faults as jax_faults
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions, FaultOptions
from shadow_tpu_torch.core import faults
from shadow_tpu_torch.core.supervisor import ChunkSupervisor, SupervisorAbort
from shadow_tpu_torch.ops.events import next_time_plain
from shadow_tpu_torch.sim import Simulation
from shadow_tpu_torch.simtime import TIME_MAX
from shadow_tpu_torch.testing import cfg7_config, fault_case

# report keys that are not results (timing, the port's own accounting)
_NOT_RESULTS = ("wall_seconds", "sim_wall_ratio", "ici_bytes", "device", "host_syncs",
                "kernel_launches")
_WINDOW = [{"start": "2 s", "end": "4 s", "loss": 0.3, "latency_factor": 1.5}]


def small7(**kw) -> dict:
    """Config 7 at 48 hosts to 6 sim-s (120 rounds of 50 ms; chunks of 16,
    a snapshot every 2), churn downtimes of 1 s and the lossy window at
    2-4 s."""
    kw = {"rounds_per_chunk": 16, "snapshot_every": 2, "backoff_ms": 1,
          "host_churn": {"prob": 0.3, "mean_downtime": "1 s"}, "loss_windows": _WINDOW, **kw}
    return cfg7_config(48, kw.pop("stop", "6 s"), **kw)


CASES = {
    # K = 1, flat queue; the CPU model; the window opens inside bootstrap
    "hold_k1_flat_cpu_delay_bootstrap": small7(cpu_delay="20 ms", bootstrap="3 s"),
    "hold_k4_bucketed": small7(k=4, block=4, stop="4 s"),
    "clear_k1_wheel": small7(restart_queue="clear", wheel=2),
    "clear_k4_bucketed_cpu_delay": small7(restart_queue="clear", k=4, block=4,
                                          cpu_delay="20 ms", stop="4 s"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """H <= 64: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_sims():
    """Each case's JAX simulation and report, run once."""
    out = {}
    for name, c in CASES.items():
        sim = JaxSimulation(JaxConfigOptions.from_dict(c), world=1)
        out[name] = (sim, sim.run(progress=False))
    return out


@pytest.fixture(scope="module")
def jax_reports(jax_sims):
    return {name: rep for name, (_, rep) in jax_sims.items()}


def results(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in _NOT_RESULTS}


@pytest.mark.parametrize("name", list(CASES))
def test_config7_small_matches_jax(name, jax_reports):
    rep = Simulation(ConfigOptions.from_dict(CASES[name]), device="cpu").run(progress=False)
    assert results(rep) == results(jax_reports[name])
    assert rep["faults_dropped"] > 0 and rep["faults_delayed"] > 0
    assert rep["supervisor"]["snapshots"] > 1
    if "k4" in name:
        assert rep["popk_deferred"] > 0


def test_outputs_match_jax(tmp_path, jax_sims):
    """`write_outputs` writes the JAX package's data directory: the same
    hosts/<name>/host-stats.json for every host, and sim-stats.json with
    every key of the JAX report (ici_bytes aside, which the port does not
    count)."""
    jsim, jrep = jax_sims["clear_k1_wheel"]
    sim = Simulation(ConfigOptions.from_dict(CASES["clear_k1_wheel"]), device="cpu")
    rep = sim.run(progress=False)
    jdir, pdir = jsim.write_outputs(str(tmp_path / "jax"), jrep), \
        sim.write_outputs(str(tmp_path / "port"), rep)
    hosts = sorted(os.listdir(os.path.join(jdir, "hosts")))
    assert hosts == sorted(os.listdir(os.path.join(pdir, "hosts"))) and len(hosts) == 48
    for name in hosts:
        with open(os.path.join(jdir, "hosts", name, "host-stats.json")) as f:
            want = json.load(f)
        with open(os.path.join(pdir, "hosts", name, "host-stats.json")) as f:
            assert json.load(f) == want, name
    with open(os.path.join(pdir, "sim-stats.json")) as f:
        keys = set(json.load(f))
    assert set(jrep) - {"ici_bytes"} <= keys
    assert {"faults_dropped", "faults_delayed", "alltoall_shed_dropped"} <= keys


def test_compile_faults_matches_jax():
    """Churn, explicit crashes (by id and by name, overlapping ones
    merged) and loss windows compile to the JAX package's arrays."""
    fo = {"seed": 3, "host_churn": {"prob": 0.5, "mean_downtime": "300 ms"},
          "crashes": [{"host": 1, "down_at": "1 s", "up_at": "2 s"},
                      {"host": "h1", "down_at": "1500 ms", "up_at": "3 s"},
                      {"host": 4, "down_at": "5 s", "up_at": "6 s"}],
          "loss_windows": [{"start": "1 s", "end": "2 s", "loss": 0.25},
                           {"start": "1500 ms", "end": "4 s", "latency_factor": 2.345}]}
    names = {f"h{i}": i for i in range(40)}
    for d in (fo, {**fo, "crashes": []}, {**fo, "loss_windows": [], "restart_queue": "clear"}):
        kw = dict(num_hosts=40, num_real=36, stop_time=8 * 10**9, bootstrap_end=10**9,
                  default_seed=5, name_to_id=names)
        got = faults.compile_faults(FaultOptions.from_dict(d), **kw, device="cpu")
        want = jax_faults.compile_faults(JaxFaultOptions.from_dict(d), **kw)
        assert (got.crash_windows, got.loss_windows, got.queue_clear) == \
            (want.crash_windows, want.loss_windows, want.queue_clear)
        for f in faults.FaultParams._fields:
            a, b = getattr(got.params, f), getattr(want.params, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == torch.from_numpy(np.array(b)).dtype, f
                assert np.array_equal(a.numpy(), np.asarray(b)), f
    assert faults.compile_faults(FaultOptions.from_dict({}), num_hosts=4, stop_time=1,
                                 device="cpu") == faults.INACTIVE_FAULTS
    with pytest.raises(ValueError, match="unknown host"):
        faults.compile_faults(FaultOptions.from_dict(
            {"crashes": [{"host": "nope", "down_at": 1, "up_at": 2}]}), num_hosts=4,
            stop_time=10**10, name_to_id={}, device="cpu")


@pytest.mark.parametrize("seed", [1, 2])
def test_device_functions_match_jax(seed):
    """`down_and_resume_plain` and `window_effects_plain` against the JAX
    functions at times on the windows' edges (down, up - 1, up), inside
    and between windows and at TIME_MAX, dtypes included."""
    c = fault_case(seed, 64, 3, 4, "cpu")
    fp = faults.FaultParams(*(c[k] for k in ("down_t", "up_t", "win_start", "win_end",
                                             "win_loss", "win_lat")))
    jfp = jax_faults.FaultParams(*(jnp.asarray(x.numpy()) for x in fp))
    for t in (c["t"], c["t_win"]):
        for got, want in ((faults.down_and_resume_plain(fp, t),
                           jax_faults.down_and_resume(jfp, jnp.asarray(t.numpy()))),
                          (faults.window_effects_plain(fp, t),
                           jax_faults.window_effects(jfp, jnp.asarray(t.numpy())))):
            for a, b in zip(got, want):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    down, _ = faults.down_and_resume_plain(fp, c["t"])
    assert down.any() and not down.all()


def test_fault_floor_in_next_times():
    """The barrier's view under queue hold (K1's fault lane): a head inside
    a crash window moves to its restart, after the busy floor; an empty
    host stays at TIME_MAX."""
    t = torch.tensor([[5, 9], [TIME_MAX, TIME_MAX], [30, 2], [7, TIME_MAX], [40, 41]])
    down = torch.tensor([[4], [0], [3], [8], [50]])
    up = torch.tensor([[10], [TIME_MAX], [20], [12], [60]])
    floor = torch.tensor([0, 0, 0, 8, 0])
    assert next_time_plain(t, None, (down, up)).tolist() == [10, TIME_MAX, 2, 7, 40]
    assert next_time_plain(t, floor, (down, up)).tolist() == [10, TIME_MAX, 2, 12, 40]


def test_supervisor_retry_abort_and_cross_check():
    """Injected dispatch failures (chunks 2 and 4) replay from the last
    snapshot and give the clean run's report with retries 2 and restores 2;
    a failure on every call aborts after max_retries, reporting the last
    good snapshot; a snapshot changed behind the supervisor's back fails
    its digest cross-check."""
    cfg = CASES["hold_k1_flat_cpu_delay_bootstrap"]
    clean = Simulation(ConfigOptions.from_dict(cfg), device="cpu")
    want = results(clean.run(progress=False))
    sim = Simulation(ConfigOptions.from_dict(cfg), device="cpu")
    sim._test_fail_dispatch = frozenset({2, 4})
    got = results(sim.run(progress=False))
    sup = got.pop("supervisor")
    assert {k: v for k, v in got.items()} == {k: v for k, v in want.items() if k != "supervisor"}
    assert (sup["retries"], sup["restores"], sup["aborted"]) == (2, 2, False)
    assert "injected dispatch failure" in sup["last_error"]

    sim = Simulation(ConfigOptions.from_dict(cfg), device="cpu")
    sim._test_fail_dispatch = frozenset(range(5, 100))
    rep = sim.run(progress=False)
    assert rep["aborted"] and rep["supervisor"]["aborted"]
    assert rep["supervisor"]["retries"] == 4  # max_retries 3: the 4th failure aborts
    # the report is the last good snapshot's: 4 accepted chunks of 16 rounds
    assert rep["rounds"] == 64 and 0 < rep["events_processed"] < want["events_processed"]

    sup = ChunkSupervisor(snapshot_every_chunks=1, backoff_base_s=0.0)
    st = Simulation(ConfigOptions.from_dict(cfg), device="cpu").state
    sup.note_state(st)
    sup._snap.stats.digest[3] ^= 1  # the snapshot silently changed

    def fail(_):
        raise RuntimeError("boom")

    with pytest.raises(SupervisorAbort, match="cross-check"):
        sup.run_chunk(st, fail)
    assert sup.poisoned and sup.last_good() is None and sup.abort_export_state() is not None


def test_options_parse_like_jax_and_refusals():
    """The `faults:` block parses to the JAX package's values (the YAML
    units included, an on-disk checkpoint file too); an empty checkpoint
    file name is refused by name, and a bad restart policy, as in the JAX
    package."""
    d = cfg7_config(48, "6 s")["faults"]
    assert dataclasses.asdict(FaultOptions.from_dict(d)) == \
        dataclasses.asdict(JaxFaultOptions.from_dict(d))
    sup = {"snapshot_every_chunks": 1, "checkpoint_file": "ck.npz"}
    assert dataclasses.asdict(FaultOptions.from_dict({**d, "supervisor": sup})) == \
        dataclasses.asdict(JaxFaultOptions.from_dict({**d, "supervisor": sup}))
    with pytest.raises(ConfigError, match="checkpoint_file"):
        ConfigOptions.from_dict(small7(supervisor={"snapshot_every_chunks": 1,
                                                   "checkpoint_file": ""}))
    with pytest.raises(ConfigError, match="restart_queue"):
        ConfigOptions.from_dict(small7(restart_queue="drop"))
    with pytest.raises(ConfigError):
        ConfigOptions.from_dict(small7(loss_windows=[{"start": "1 s", "end": "2 s",
                                                      "latency_factor": 0.5}]))
