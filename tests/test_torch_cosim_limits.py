"""PyTorch port vs JAX reference: the co-simulation bridge at its limits, on
the CPU. Whole runs, each report and every file it writes equal to the JAX
package's `HybridSimulation` on the same config (tests/test_overflow.py's
flood: clients that each ping one udp_echo_server twice):

  - staging carry-over: more sends in one window than the staging buffer
    holds (4 rows on both sides), so the prepare step merges several
    batches before the window's first device round;
  - capture-ring overflow: 150 clients, more same-window deliveries to the
    server than its 128-slot ring holds, the excess counted in
    capture_overflow_lost;
  - a bucketed queue with K = 4 events per host per microstep under the
    bridge (the prepare step's block rebuild, the guarded loop's K-way
    microsteps).

The file takes about 25 s in one process on a small CPU box, most of it the
JAX package's compiles.
"""

from __future__ import annotations

import copy
import os

import pytest
import torch

from shadow_tpu.config.options import ConfigOptions as JaxConfig
from shadow_tpu.cosim import HybridSimulation as JaxHybrid
from shadow_tpu_torch import cosim as cosim_mod
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.testing import cosim_files

# report keys that are timings, not results
TIMING_KEYS = ("wall_seconds", "sim_wall_ratio", "perf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flood(n_clients: int, **experimental) -> dict:
    ping = {"path": "udp_ping", "args": ["server=server", "port=9000", "count=2"],
            "expected_final_state": "running"}
    return {
        "general": {"stop_time": "4 s", "seed": 5},
        "network": {"graph": {"type": "1_gbit_switch"}},
        "experimental": experimental,
        "hosts": {
            "server": {"network_node_id": 0, "processes": [
                {"path": "udp_echo_server", "args": ["port=9000"]}]},
            "client": {"network_node_id": 0, "count": n_clients, "processes": [ping]},
        },
    }


# name: (config, staging rows per merge)
RUNS = {
    "staging_carry_over": (_flood(12), 4),
    "capture_ring_overflow": (_flood(150), cosim_mod.STAGING_CAP),
    "bucketed_k4": (_flood(12, event_queue_block=64, microstep_events=4),
                    cosim_mod.STAGING_CAP),
}


def _run(sim, data_dir: str):
    with open(os.devnull, "w") as devnull:
        report = sim.run(progress=False, log=devnull)
    sim.write_outputs(data_dir)
    return report, cosim_files(data_dir)


@pytest.mark.parametrize("name", list(RUNS))
def test_cosim_limit_run_matches_jax(tmp_path, monkeypatch, name):
    cfg, staging = RUNS[name]
    jcfg = JaxConfig.from_dict(copy.deepcopy(cfg))
    jcfg.general.data_directory = str(tmp_path / "jax")
    want, want_files = _run(JaxHybrid(jcfg, staging_cap=staging, world=1), str(tmp_path / "jax"))
    monkeypatch.setattr(cosim_mod, "STAGING_CAP", staging)
    pcfg = ConfigOptions.from_dict(copy.deepcopy(cfg))
    pcfg.general.data_directory = str(tmp_path / "port")
    sim = cosim_mod.HybridSimulation(pcfg, device="cpu")
    got, got_files = _run(sim, str(tmp_path / "port"))
    assert {k: got.get(k) for k in want if k not in TIMING_KEYS} == {
        k: v for k, v in want.items() if k not in TIMING_KEYS}
    assert sorted(got_files) == sorted(want_files)
    assert [f for f in want_files if got_files[f] != want_files[f]] == []
    if name == "staging_carry_over":
        # some window merged more than one batch before its first round
        assert sim._window_idx > got["windows"]
    if name == "capture_ring_overflow":
        assert got["model_report"]["capture_overflow_lost"] > 0
    if name == "bucketed_k4":
        assert sim.engine_cfg.queue_block == 64 and sim.engine_cfg.microstep_events == 4
