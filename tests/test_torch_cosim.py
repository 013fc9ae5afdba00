"""PyTorch port vs JAX reference: the co-simulation bridge (B25, B26) and
the CPU host plane it drives, on the CPU.

  - the handlers: the port's `HybridModel.handle_plain` (K33's plain
    version) against the JAX `HybridModel.handle` with rings of 4 slots
    (empty, partly full, full: overflow into cap_lost), and
    `MixedModel.handle_plain` (K34's plain versions around K33's and the
    inner model's) against the JAX `MixedModel.handle` over udp_echo (no
    sanitising) and gossip (sanitising), with native tables all, none and
    mixed; every output lane, zero tolerance (`testing.hybrid_case`,
    `mixed_case`);
  - the guarded round loop: `Engine.run_guarded_chunk` (K35's plain
    version) against the JAX `_run_guarded_chunk` on a bridge state carried
    across by core/convert.py, with an `until` that cuts the loop, a probe
    that fires after a delivery and one that fires before the first round;
  - whole runs of the JAX co-sim tests' configs (tests/test_cosim.py,
    tests/test_mixed.py) and the send-budget case (40 coroutine clients
    against one modeled udp_echo server, whose budget of 32 drops echoes):
    every report key but the wall times and phase timers, every process's
    stdout and stderr, and for the tgen run the strace, pcap, log and
    host-stats files byte for byte;
  - the co-sim refusals (each names its knob) and the CLI.

Each JAX reference runs once per module. The file takes about 45 s in one
process on a small CPU box, most of it the JAX package's compiles.
"""

from __future__ import annotations

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ConfigOptions as JaxConfig
from shadow_tpu.core import engine as jax_engine
from shadow_tpu.cosim import HybridSimulation as JaxHybrid
from shadow_tpu.models import get_model as jax_get_model
from shadow_tpu.models.base import HandlerCtx as JaxCtx
from shadow_tpu.models.hybrid import HybridModel as JaxHybridModel
from shadow_tpu.models.mixed import MixedModel as JaxMixedModel
from shadow_tpu.ops.rng import RngState as JaxRng
from shadow_tpu_torch.__main__ import main as port_main
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions, load_config
from shadow_tpu_torch.core.convert import from_jax_numpy, to_numpy
from shadow_tpu_torch.cosim import HybridSimulation, _capture_probe
from shadow_tpu_torch.testing import (
    COSIM_FILLS,
    NATIVE_PATTERNS,
    cosim_files,
    cosim_small_configs,
    handler_tensors,
    hybrid_case,
    mixed_case,
)

H = 32
MS = 1_000_000
# report keys that are timings, not results
TIMING_KEYS = ("wall_seconds", "sim_wall_ratio", "perf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNS = cosim_small_configs()


def _run(cls, cfg, data_dir: str, **kw):
    cfg.general.data_directory = data_dir
    sim = cls(cfg, **kw)
    with open(os.devnull, "w") as devnull:
        report = sim.run(progress=False, log=devnull)
    sim.write_outputs(data_dir)
    return report, cosim_files(data_dir)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    @functools.lru_cache(maxsize=None)
    def run(name: str):
        d = str(tmp_path_factory.mktemp(f"jax_{name}"))
        return _run(JaxHybrid, JaxConfig.from_dict(copy.deepcopy(RUNS[name])), d, world=1)

    return run


@pytest.mark.parametrize("name", list(RUNS))
def test_cosim_run_matches_jax(jax_runs, tmp_path, name):
    want, want_files = jax_runs(name)
    got, got_files = _run(HybridSimulation, ConfigOptions.from_dict(copy.deepcopy(RUNS[name])),
                          str(tmp_path), device="cpu")
    assert {k: got.get(k) for k in want if k not in TIMING_KEYS} == {
        k: v for k, v in want.items() if k not in TIMING_KEYS}
    assert sorted(got_files) == sorted(want_files)
    assert [f for f in want_files if got_files[f] != want_files[f]] == []
    if name == "tgen_tcp_flow":
        kinds = {os.path.splitext(f)[1] for f in got_files}
        assert {".strace", ".pcap", ".log", ".stdout", ".json"} <= kinds
        assert b"sent=200000" in b"".join(v for k, v in got_files.items()
                                          if k.endswith(".stdout"))
    if name == "mixed_budget_drops":
        # the modeled server's budget (32 sends a round) drops the echoes of
        # the clients past it, which then wait forever
        assert want["packets_budget_dropped"] > 0 and want["process_failures"] > 0
    if name == "mixed_gossip_sanitised":
        m = got["model_report"]["model_gossip"]
        assert got["packets_delivered"] >= 5 and m["generations"] == m["adoptions"] == 0


# --------------------------------------------------------------------------
# the handlers (K33, K34)
# --------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    a = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _jax_handle(model, a: dict, window_end: int) -> dict:
    ctx = JaxCtx(
        t=jnp.asarray(a["t"]), window_end=jnp.asarray(window_end, jnp.int64),
        kind=jnp.asarray(a["kind"]), payload=jnp.asarray(a["payload"]),
        active=jnp.asarray(a["active"]), is_packet=jnp.asarray(a["is_packet"]),
        src=jnp.asarray(a["src"]), host_id=jnp.asarray(a["host_id"]),
        state=_jtree(a["state"]), params=_jtree(a["params"]),
        rng=JaxRng(jnp.asarray(a["rng"].view(np.uint64))))
    return {k: _np(v) for k, v in handler_tensors(model.handle(ctx)).items()}


def _diff(got: dict, want: dict) -> list[str]:
    assert got.keys() == want.keys()
    return [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])]


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("fill", COSIM_FILLS)
def test_hybrid_handler_matches_jax(fill, stride):
    case = hybrid_case(5, H, "cpu", cap=4, fill=fill, stride=stride)
    got = {k: _np(v) for k, v in handler_tensors(case["model"].handle_plain(case["ctx"])).items()}
    want = _jax_handle(JaxHybridModel(capture_cap=4), case["np"], case["ctx"].window_end)
    assert _diff(got, want) == []
    if fill == "full":  # every delivery overflowed
        data = case["np"]["active"] & case["np"]["is_packet"] & (case["np"]["kind"] == 2)
        assert data.any() and (want["state.cap_lost"] - case["np"]["state"]["cap_lost"]
                               == data).all()


@pytest.mark.parametrize("native", NATIVE_PATTERNS)
@pytest.mark.parametrize("inner", ["udp_echo", "gossip"])
def test_mixed_handler_matches_jax(inner, native):
    case = mixed_case(inner, 2, H, "cpu", native=native, stride=4)
    got = {k: _np(v) for k, v in handler_tensors(case["model"].handle_plain(case["ctx"])).items()}
    jm = JaxMixedModel(jax_get_model(inner)(), inner)
    want = _jax_handle(jm, case["np"], case["ctx"].window_end)
    assert _diff(got, want) == []
    # the sends come hybrid first, then the inner model's
    assert len([k for k in want if k.endswith(".mask") and k.startswith("send")]) == (
        1 + {"udp_echo": 2, "gossip": 1}[inner])


# --------------------------------------------------------------------------
# the guarded round loop (K35)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bridge_state():
    """A JAX bridge state one prepare into the udp_ping run: the clients'
    first pings staged as send requests, not yet executed."""
    cfg = JaxConfig.from_dict(copy.deepcopy(RUNS["udp_ping"]))
    sim = JaxHybrid(cfg, world=1)
    runahead = max(sim.engine_cfg.runahead_floor, sim.engine_cfg.static_min_latency, 1)
    t_next = sim._cpu_min_next()  # the device queues start empty
    sim._execute_hosts(t_next + runahead)
    sim.state = sim._inject()
    state = jax.tree.map(np.array, jax.device_get(sim.state))
    params = jax.tree.map(np.array, jax.device_get(sim.params))
    return sim, state, params


@pytest.mark.parametrize("case", ["until_cuts", "probe_fires", "probe_first_round"])
def test_guarded_chunk_matches_jax(bridge_state, case):
    jsim, state, params = bridge_state
    t0 = int(np.asarray(state.queue.t).min())
    until = {"until_cuts": t0 + 1, "probe_fires": 3_000 * MS,
             "probe_first_round": 3_000 * MS}[case]
    jstate = jax.tree.map(jnp.asarray, state)
    if case == "probe_first_round":
        model = dict(jstate.model)
        model["cap_n"] = model["cap_n"].at[0].set(1)
        jstate = jstate._replace(model=model)
    want = jax.device_get(jax_engine._run_guarded_chunk(
        jsim.engine_cfg, jsim.model, None, lambda ms: jnp.any(ms["cap_n"] > 0), jstate,
        jax.tree.map(jnp.asarray, params), jnp.asarray(until, jnp.int64)))
    want = jax.tree.map(np.array, want)
    psim = HybridSimulation(ConfigOptions.from_dict(copy.deepcopy(RUNS["udp_ping"])),
                            device="cpu")
    p_params, p_state = from_jax_numpy(params, jax.tree.map(np.array, jax.device_get(jstate)),
                                       device="cpu")
    got = psim.engine.run_guarded_chunk(p_state, p_params, until, _capture_probe)
    g, w = to_numpy(got), to_numpy(want)
    assert sorted(g) == sorted(w)
    assert [k for k in w if not np.array_equal(g[k], w[k])] == []
    rounds = int(w["stats.rounds"]) - int(state.stats.rounds)
    assert rounds == {"until_cuts": 1, "probe_fires": 2, "probe_first_round": 0}[case]
    if case == "probe_fires":
        assert (w["model.cap_n"] > 0).any()


# --------------------------------------------------------------------------
# config: refusals, the modeled config's captures, the CLI
# --------------------------------------------------------------------------

REFUSED = {
    "binary": ("real binary", {"hosts": {"client": {"processes": [
        {"path": "./native/build/test_udp_client", "args": ["11.0.0.1", "9000", "1"]}]}}}),
    "parallelism": ("general.parallelism", {"general": {"parallelism": 2}}),
    "merge_gears": ("experimental.merge_gears", {"experimental": {"merge_gears": "auto"}}),
    "supervisor": ("faults.supervisor", {"faults": {"supervisor": {"snapshot_every_chunks": 2}}}),
    "integrity": ("integrity", {"integrity": {"enabled": True}}),
    "pressure_abort": ("pressure.policy=abort", {"pressure": {"policy": "abort"}}),
    "trace": ("observability.trace", {"observability": {"trace": True}}),
    "network": ("observability.network", {"observability": {"network": True}}),
    "memory": ("observability.memory", {"observability": {"memory": True}}),
    "runtime": ("observability.runtime", {"observability": {"runtime": True}}),
    "profile_dir": ("observability.profile_dir", {"observability": {"profile_dir": "prof"}}),
}


@pytest.mark.parametrize("knob", list(REFUSED))
def test_cosim_refusal_names_its_knob(knob):
    name, extra = REFUSED[knob]
    d = copy.deepcopy(RUNS["udp_ping"])
    for k, v in extra.items():
        d[k] = {**d.get(k, {}), **v} if k != "hosts" else {**d["hosts"], **v}
    if knob == "binary":
        d["hosts"]["client"]["network_node_id"] = 0
    with pytest.raises(ConfigError, match=name.replace(".", r"\.").replace("=", "=")):
        ConfigOptions.from_dict(d)


@pytest.mark.parametrize("knob", ["pcap_enabled", "general.log_file"])
def test_modeled_config_refuses_cpu_plane_captures(knob):
    yaml = ("general: {stop_time: 1 s}\nhosts:\n  a:\n    processes:\n"
            "      - {model: phold, model_args: {}}\n")
    extra = ("host_option_defaults: {pcap_enabled: true}\n" if knob == "pcap_enabled"
             else "")
    text = yaml.replace("general: {stop_time: 1 s}",
                        "general: {stop_time: 1 s, log_file: x.log}"
                        if knob == "general.log_file" else "general: {stop_time: 1 s}") + extra
    with pytest.raises(ConfigError, match=knob):
        load_config(text, is_text=True)


def test_cli_runs_a_cosim_config(tmp_path):
    import json

    import yaml

    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(RUNS["mixed_coroutine_clients"]))
    data = tmp_path / "data"
    assert port_main([str(path), "--device", "cpu", f"--general.data_directory={data}"]) == 0
    rep = json.loads((data / "sim-stats.json").read_text())
    assert rep["process_failures"] == 0 and rep["kernel_launches"]["hybrid_handle"] == 0
    assert sorted(p.name for p in (data / "hosts" / "client1").iterdir()) == [
        "host-stats.json", "udp_ping.1001.stderr", "udp_ping.1001.stdout"]
