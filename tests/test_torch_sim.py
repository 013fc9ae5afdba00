"""PyTorch port vs JAX reference: the YAML -> simulation driver, the port's
config surface, and the port's independence from JAX.

A small config runs through `shadow_tpu_torch.sim` (device="cpu") and
`shadow_tpu.sim`; the reports must agree exactly (determinism digest, event
count, every drop counter), and the port's own build must equal the JAX
initial state carried across with core/convert.py. Unsupported knobs raise
ConfigError, entry points refuse to run without a GPU unless asked for the
CPU, and no module of the port (nor chip_smoke.py) imports jax or
shadow_tpu (an AST scan).
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.config.options import ExperimentalOptions as JaxExperimental
from shadow_tpu.config.options import load_config as jax_load_config
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.__main__ import main as port_main
from shadow_tpu_torch.config.options import ConfigError, load_config, merge_cli_overrides
from shadow_tpu_torch.core.convert import from_jax_numpy, to_numpy
from shadow_tpu_torch.sim import Simulation, run_simulation

ROOT = pathlib.Path(__file__).resolve().parent.parent

YAML = """
general: {stop_time: "1500 ms", seed: 5, parallelism: 1, heartbeat_interval: null}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 host_bandwidth_down "20 Mbit" host_bandwidth_up "20 Mbit" ]
        node [ id 1 host_bandwidth_down "5 Mbit" host_bandwidth_up "5 Mbit" ]
        edge [ source 0 target 0 latency "15 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "15 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "30 ms" packet_loss 0.03 jitter "4 ms" ]
      ]
experimental: {event_queue_capacity: 12, sends_per_host_round: 3}
hosts:
  a:
    count: 20
    network_node_id: 0
    processes: [{model: phold, model_args: {population: 3, mean_delay: "25 ms"}}]
  b:
    count: 12
    network_node_id: 1
    processes: [{model: phold, model_args: {population: 2, mean_delay: "25 ms"}}]
"""

SHARED_KEYS = (
    "simulated_seconds", "rounds", "microsteps", "events_processed", "packets_sent",
    "packets_delivered", "packets_lost", "packets_unreachable", "packets_codel_dropped",
    "queue_overflow_dropped", "packets_budget_dropped", "outbox_overflow_dropped",
    "queue_occupancy_hwm", "outbox_send_hwm", "monotonic_violations", "determinism_digest",
    "model_report",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_yaml_run_matches_jax():
    jsim = JaxSimulation(jax_load_config(YAML, is_text=True), world=1)
    psim = Simulation(load_config(YAML, is_text=True), device="cpu")
    # the port's own build == the JAX initial state carried across
    j0 = jax.tree.map(np.array, jax.device_get(jsim.state))
    _, carried = from_jax_numpy(jax.device_get(jsim.params), j0, device="cpu")
    a, b = to_numpy(carried), to_numpy(psim.state)
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []
    jrep = jsim.run(progress=False)
    prep = psim.run(progress=False)
    assert {k: prep[k] for k in SHARED_KEYS} == {k: jrep[k] for k in SHARED_KEYS}
    assert np.array_equal(psim.host_digests(), np.asarray(jsim.host_digests()))
    assert prep["packets_lost"] > 0 and prep["events_processed"] > 1000
    assert prep["device"] == "cpu" and prep["host_syncs"] > prep["rounds"]
    assert prep["kernel_launches"] == {
        "queue_next_time": 0, "queue_pop_min": 0, "queue_push_many": 0, "merge_insert": 0,
        "queue_pop_k": 0, "queue_clear_popped": 0, "queue_push_many_bucketed": 0,
        "queue_block_minima": 0, "event_ingress": 0, "event_egress": 0,
        "wheel_cancel": 0, "merge_scatter": 0, "fluid_fg_link_bytes": 0, "fluid_advance": 0,
        "fluid_host_effects": 0, "tgen_handle": 0, "phold_handle": 0, "echo_handle": 0,
        "timer_handle": 0, "gossip_handle": 0, "circuit_handle": 0,
        "fault_down_resume": 0, "integrity_round_check": 0, "queue_migrate": 0,
        "pressure_total": 0, "trace_round": 0, "flow_append": 0, "dshard_pack": 0,
        "exchange_unpack": 0, "replica_window": 0, "replica_fold": 0,
        "hybrid_handle": 0, "mixed_plane": 0, "guarded_window": 0, "pop_ingress": 0,
    }  # the CPU path runs the plain versions, never a kernel


def test_anchor_shapes_resolve_like_jax():
    """The 10k-host anchor resolves to capacity 64, budget 12, 16 rounds per
    chunk in both packages."""
    kw = {"rounds_per_chunk": 16, "sends_per_host_round": 12}
    from shadow_tpu_torch.config.options import ExperimentalOptions

    for n in (10_000, 200_000, 1_000_000):
        assert ExperimentalOptions.from_dict(kw).resolve_shapes(n) == \
            JaxExperimental.from_dict(kw).resolve_shapes(n)
    assert ExperimentalOptions.from_dict(kw).resolve_shapes(10_000) == (64, 12, 16)


# knobs the port does not run yet, and (event_queue_block, microstep_events,
# timer_wheel, merge_gears, merge_scatter, merge_rows, cpu_delay, fluid,
# faults, pressure, integrity, observability) values the JAX package
# rejects too: a block
# that does not divide the capacity (12 here), K < 1, the wheel with K > 1, a
# gear of width 0; a fluid latency factor below 1.0; an empty checkpoint
# file name; a pressure policy that does not exist; a sentinel with no
# replay; an empty trace file name and a negative flow-ledger size; and a
# negative merge-row bound (also
# under the scatter merge) or CPU delay, which the JAX package reads as
# "off" and the port refuses
UNSUPPORTED = {
    # world > 1 runs (tests/test_torch_mesh.py), except the planes that run
    # on one rank only
    "world": "general: {parallelism: 2}\npressure: {policy: escalate}",
    "world_trace": "general: {parallelism: 2}\nobservability: {trace: true}",
    "world_network": "general: {parallelism: 4}\nobservability: {network: true}",
    "world_memory": "general: {parallelism: 2}\nobservability: {memory: true}",
    "world_runtime": "general: {parallelism: 2}\nobservability: {runtime: true}",
    "world_profile": "general: {parallelism: 2}\nobservability: {profile_dir: prof}",
    "world_checkpoint": ("general: {parallelism: 2}\nfaults: {supervisor: "
                         "{snapshot_every_chunks: 2, checkpoint_file: ck.npz}}"),
    "exchange": "experimental: {exchange: ring}",
    "event_queue_block": "experimental: {event_queue_block: 5}",
    "microstep_events": "experimental: {microstep_events: 0}",
    "merge_gears": "experimental: {merge_gears: [0]}",
    "timer_wheel": "experimental: {timer_wheel: 16, microstep_events: 4}",
    "merge_scatter": "experimental: {merge_scatter: true, merge_rows: -64}",
    "merge_rows": "experimental: {merge_rows: -1}",
    "cpu_delay": "experimental: {cpu_delay: -1}",
    "faults": "faults: {supervisor: {snapshot_every_chunks: 2, checkpoint_file: ''}}",
    "fluid": "fluid: {latency_factor_max: 0.5}",
    "pressure": "pressure: {policy: grow}",
    "integrity": "integrity: {enabled: true, max_replays: 0}",
    "observability_trace": "observability: {trace: true, trace_file: ''}",
    "observability_network": "observability: {network: true, network_flows: -1}",
    "pcap": "host_option_defaults: {pcap_enabled: true}",
}


def _with(section_yaml: str) -> str:
    import yaml

    base = yaml.safe_load(YAML)
    extra = yaml.safe_load(section_yaml)
    for k, v in extra.items():
        base[k] = {**base.get(k, {}), **v} if isinstance(v, dict) else v
    return yaml.safe_dump(base)


@pytest.mark.parametrize("knob", list(UNSUPPORTED))
def test_unsupported_knob_raises(knob):
    with pytest.raises(ConfigError):
        load_config(_with(UNSUPPORTED[knob]), is_text=True)


@pytest.mark.parametrize("override", [
    {"general.parallelism": "4", "observability.trace": "true"},
    {"experimental.microstep_events": "0"},
    {"experimental.merge_gears": "fast"},
])
def test_unsupported_cli_override_raises(override):
    with pytest.raises(ConfigError):
        merge_cli_overrides(load_config(YAML, is_text=True), override)


def test_cli_override_queue_knobs_resolve_like_jax():
    """`--experimental.microstep_events=2` and a dividing
    `--experimental.event_queue_block` are accepted and resolve to the same
    engine config as in the JAX package; a block that does not divide the
    auto-sized capacity (64) is refused when the simulation is built."""
    from shadow_tpu.config.options import merge_cli_overrides as jax_merge

    over = {"experimental.microstep_events": "2", "experimental.event_queue_block": "4"}
    cfg = merge_cli_overrides(load_config(YAML, is_text=True), over)
    jcfg = jax_merge(jax_load_config(YAML, is_text=True), over)
    assert (cfg.experimental.microstep_events, cfg.experimental.event_queue_block) == (2, 4)
    psim = Simulation(cfg, device="cpu")
    jsim = JaxSimulation(jcfg, world=1)
    for f in ("queue_capacity", "queue_block", "microstep_events", "effective_microstep_events",
              "effective_microstep_limit"):
        assert getattr(psim.engine_cfg, f) == getattr(jsim.engine_cfg, f), f
    assert type(psim.state.queue).__name__ == "BucketQueue"
    auto = load_config(YAML.replace("event_queue_capacity: 12, ", ""), is_text=True)
    with pytest.raises(ConfigError, match="event_queue_block"):
        Simulation(merge_cli_overrides(auto, {"experimental.event_queue_block": "7"}),
                   device="cpu")


def test_timer_wheel_accepted_and_matches_jax():
    """experimental.timer_wheel runs in the port (phold's jobs are its
    timers) and gives the JAX report, wheel block included."""
    text = YAML.replace("sends_per_host_round: 3}",
                        "sends_per_host_round: 3, timer_wheel: 2}")
    jrep = JaxSimulation(jax_load_config(text, is_text=True), world=1).run(progress=False)
    psim = Simulation(load_config(text, is_text=True), device="cpu")
    prep = psim.run(progress=False)
    assert psim.engine_cfg.wheel_slots == 2 and psim.state.wheel is not None
    keys = SHARED_KEYS + ("wheel",)
    assert {k: prep[k] for k in keys} == {k: jrep[k] for k in keys}
    assert prep["wheel"]["occupancy_hwm"] > 0


def test_timer_wheel_rejects_kway_and_models_without_timers(monkeypatch):
    from shadow_tpu_torch.core.engine import Engine, EngineConfig
    from shadow_tpu_torch.models.phold import PholdModel

    text = YAML.replace("sends_per_host_round: 3}", "sends_per_host_round: 3, timer_wheel: 4}")
    with pytest.raises(ConfigError, match="microstep_events"):
        load_config(text.replace("timer_wheel: 4", "timer_wheel: 4, microstep_events: 2"),
                    is_text=True)
    with pytest.raises(ValueError, match="microstep_events"):
        EngineConfig(num_hosts=4, stop_time=1, wheel_slots=4, microstep_events=2)
    with pytest.raises(ConfigError, match="timer_wheel_block"):
        load_config(text.replace("timer_wheel: 4", "timer_wheel: 4, timer_wheel_block: 3"),
                    is_text=True)
    monkeypatch.setattr(PholdModel, "timer_kinds", ())
    with pytest.raises(ConfigError, match="timer_kinds"):
        Simulation(load_config(text, is_text=True), device="cpu")
    with pytest.raises(ValueError, match="timer_kinds"):
        Engine(EngineConfig(num_hosts=4, stop_time=1, wheel_slots=4), PholdModel(), "cpu")


def test_world_accepted_and_too_many_cards_refused(monkeypatch, tmp_path):
    """`general.parallelism > 1` is accepted; more ranks than visible cards
    is the JAX package's ConfigError, raised before anything is built (by
    the Simulation, the run entry point and the CLI, exit code 2); an
    in-process Simulation is one rank and needs the mesh's Collectives."""
    cfg = load_config(_with("general: {parallelism: 4}"), is_text=True)
    assert cfg.general.parallelism == 4
    with pytest.raises(ValueError, match="Collectives"):
        Simulation(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ConfigError, match="parallelism=4 exceeds 2 available devices"):
        Simulation(cfg)
    with pytest.raises(ConfigError, match="exceeds 2"):
        run_simulation(cfg)
    path = tmp_path / "w.yaml"
    path.write_text(_with("general: {parallelism: 4}"))
    assert port_main([str(path)]) == 2


def test_default_parallelism_on_four_cards(monkeypatch):
    """`general.parallelism: 0` with four visible cards: an in-process
    Simulation is one device's run (its world comes from its Collectives,
    one without them), while `run_simulation` launches a rank on every
    card. The card is faked: the kernel-limit check, the build's first
    step on a card, reads the world and stops the build."""
    import shadow_tpu_torch.sim as sim_mod

    cfg = load_config(_with("general: {parallelism: 0}"), is_text=True)
    assert cfg.general.parallelism == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(sim_mod, "resolve_device", lambda device=None: torch.device("cuda"))
    seen = []

    class Built(Exception):
        pass

    def limits(self, qcap):
        seen.append(self.world)
        raise Built

    monkeypatch.setattr(Simulation, "_check_kernel_limits", limits)
    with pytest.raises(Built):
        Simulation(cfg)
    assert seen == [1]
    launched = []
    monkeypatch.setattr(sim_mod, "launch",
                        lambda fn, world, device_type, args: launched.append(
                            (world, device_type)) or [{"ranks": world}])
    assert run_simulation(cfg) == (None, {"ranks": 4})
    assert launched == [(4, "cuda")]


def test_unsupported_model_raises():
    cfg = load_config(YAML.replace("model: phold", "model: mixed"), is_text=True)
    with pytest.raises(ConfigError, match="mixed"):
        Simulation(cfg, device="cpu")


def test_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(YAML, is_text=True)
    with pytest.raises(RuntimeError, match="cpu"):
        Simulation(cfg)
    with pytest.raises(RuntimeError):
        run_simulation(cfg)
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    assert port_main([str(path)]) == 1
    assert port_main([str(path), "--experimental.timer_wheel=8",
                      "--experimental.microstep_events=2", "--device", "cpu"]) == 2


def test_cli_writes_sim_stats(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(YAML.replace("1500 ms", "300 ms"))
    data = tmp_path / "data"
    assert port_main([str(path), "--device", "cpu", f"--general.data_directory={data}"]) == 0
    import json

    rep = json.loads((data / "sim-stats.json").read_text())
    assert rep["simulated_seconds"] == 0.3 and len(rep["determinism_digest"]) == 16


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "shadow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    # the observatories are scanned too
    assert {"tracer.py", "netobs.py", "memory.py", "runtime.py", "perf.py"} <= {
        f.name for f in files if f.parent.name == "obs"}
    for f in files:
        for m in _imports(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "shadow_tpu"), f"{f}: imports {m}"
