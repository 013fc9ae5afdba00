"""PyTorch port vs JAX reference across ranks: the sharded round loop at
world 4 (core/mesh.py; four gloo processes on the CPU, one spawn for the
whole module), against the JAX package exactly.

Cases (the port's reports from one `launch` of 4 ranks, each rank running
every case in turn):

  - PHOLD on 33 hosts (padded to 36) under each exchange kind (gather,
    alltoall, hierarchical): JAX's world-1 report (digests are world- and
    exchange-invariant), and the ici counters equal to the cost model x
    exchanges x world;
  - the alltoall at an `a2a_block` small enough to shed: JAX's world-4
    report (`Simulation(..., world=4)` on four of the forced CPU devices),
    its `alltoall_shed_dropped` included;
  - bucketed tgen-TCP on 45 hosts over the alltoall at its auto block,
    which sheds: JAX's world-4 report, with the per-shard sums
    (`microsteps`, `bucket_cache_rebuilds`) and `alltoall_shed_dropped`;
  - the hierarchical exchange with merge gears started at the lowest gear
    (sheds force replays): JAX's world-4 report and gears block, JAX's
    controller started at the same gear;
  - tgen-TCP on a 17-host torus with the fluid plane; PHOLD under host
    churn, a lossy window and the supervisor with the integrity sentinel;
    PHOLD under `pressure: abort`: JAX's world-1 reports.

Each JAX reference runs once per module, three at a time beside the ranks.
Tolerance: exact equality of the
digest, the events, every drop counter and the report's blocks."""

import concurrent.futures
import dataclasses
import threading

import pytest
import yaml

from shadow_tpu.config.options import ConfigOptions as JaxConfig
from shadow_tpu.core.engine import exchange_ici_bytes_per_round, exchange_tier_bytes_per_round
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.core.mesh import launch
from shadow_tpu_torch.testing import cfg7_config, cfg9_config, mesh_runs, torus_gml
from test_torch_fluid import _torus

WORLD = 4

PHOLD = yaml.safe_load("""
general: {stop_time: "600 ms", seed: 5, heartbeat_interval: null}
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
experimental: {event_queue_capacity: 12, sends_per_host_round: 3, rounds_per_chunk: 16}
hosts:
  a:
    count: 21
    network_node_id: 0
    processes: [{model: phold, model_args: {population: 3, mean_delay: "25 ms"}}]
  b:
    count: 12
    network_node_id: 1
    processes: [{model: phold, model_args: {population: 2, mean_delay: "25 ms"}}]
""")


def _with(base: dict, **experimental) -> dict:
    d = yaml.safe_load(yaml.safe_dump(base))
    d["experimental"].update(experimental)
    return d


def _stop(cfg: dict, stop: str) -> dict:
    cfg["general"]["stop_time"] = stop
    return cfg


def _tgen_bucketed() -> dict:
    """Config 6's tgen-TCP (its flows, capacity 28 in blocks of 7, 24 sends
    per host and round) on a 3 x 3 torus of 45 hosts (padded to 48) over
    the alltoall at its auto block (2 x 12 x 24 / 4 = 144 rows): a shard's
    sends go mostly to itself (tgen's peers are the next host ids), so
    blocks overflow and rows shed, as config 6's do at full size. K = 1,
    not config 6's 4: JAX's world-4 program at K = 4 takes about 40 s to
    compile on a CPU, two thirds of the file's time budget."""
    return {
        "general": {"stop_time": "1 s", "seed": 1, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": torus_gml(3, lat_ms=50)}},
        "experimental": {"event_queue_capacity": 28, "event_queue_block": 7,
                         "microstep_events": 1, "sends_per_host_round": 24,
                         "rounds_per_chunk": 64, "exchange": "alltoall"},
        "hosts": {f"n{i}": {"count": 5, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 64, "flow_segs": 100, "cwnd_cap": 16, "mss": 1460,
                           "flow_gap": "50 ms", "tx_batch": 2}}]} for i in range(9)},
    }


def _faults() -> dict:
    d = cfg7_config(30, "4 s", snapshot_every=2, rounds_per_chunk=32,
                    loss_windows=[{"start": "1 s", "end": "3 s", "loss": 0.2,
                                   "latency_factor": 1.5}])
    d["integrity"] = {"enabled": True, "dual_digest": True}
    return d


# name: (config, port run keywords, JAX world, report keys beyond BASE_KEYS)
CASES = {
    "gather": (_with(PHOLD, exchange="gather"), {}, 1, ()),
    "alltoall": (_with(PHOLD, exchange="alltoall"), {}, 1, ()),
    "hierarchical": (_with(PHOLD, exchange="hierarchical"), {}, 1, ()),
    "alltoall_shed": (_with(PHOLD, exchange="alltoall", a2a_block=2), {}, WORLD,
                      ("alltoall_shed_dropped", "ici_bytes")),
    "hier_gears_low": (_with(PHOLD, exchange="hierarchical", merge_gears="auto",
                             sends_per_host_round=6), {"start_gear": 1}, WORLD,
                       ("gears", "exchange", "ici_bytes", "outbox_send_hwm")),
    "tgen_bucketed_shed": (_tgen_bucketed(), {}, WORLD,
                           ("microsteps", "bucket_cache_rebuilds", "alltoall_shed_dropped",
                            "ici_bytes")),
    "tgen_fluid": (_stop(yaml.safe_load(_torus((3, 5, 4, 5), 1, 0, 0.3)), "1 s"), {}, 1,
                   ("fluid",)),
    "faults_integrity": (_faults(), {}, 1,
                         ("faults_dropped", "faults_delayed", "integrity", "supervisor")),
    "pressure_abort": (cfg9_config(30, "3 s", policy="abort"), {}, 1,
                       ("pressure", "pressure_aborted", "aborted")),
}
for _c in CASES.values():
    _c[0]["general"]["parallelism"] = WORLD

BASE_KEYS = ("simulated_seconds", "rounds", "events_processed", "packets_sent",
             "packets_delivered", "packets_lost", "packets_unreachable",
             "packets_codel_dropped", "queue_overflow_dropped", "packets_budget_dropped",
             "outbox_overflow_dropped", "queue_occupancy_hwm", "monotonic_violations",
             "determinism_digest", "model_report")


@pytest.fixture(scope="module", autouse=True)
def port_reports():
    """Every case on 4 gloo ranks, in one spawn, started when the module
    starts and run beside the JAX references (a thread waits on the
    ranks; three more compute the references, `_jax`); the tests call the
    fixture's value to wait for the reports."""
    box: dict = {}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    for name in ("tgen_bucketed_shed", "hier_gears_low", "tgen_fluid", "alltoall_shed", "gather", "faults_integrity",
                 "pressure_abort"):
        _JAX[name] = pool.submit(_jax_run, name)

    def run():
        try:
            box["reports"] = launch(mesh_runs, WORLD, "cpu",
                                    ([(c[0], c[1]) for c in CASES.values()],))[0]
        except Exception as e:  # re-raised in the test thread
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def get() -> dict:
        th.join(timeout=600)
        if "error" in box:
            raise box["error"]
        assert not th.is_alive(), "the mesh ranks did not finish"
        return dict(zip(CASES, box["reports"]))

    yield get
    th.join(timeout=600)
    pool.shutdown()


_JAX: dict = {}


def _jax_run(name: str) -> dict:
    """The JAX package's report for a case. The only case with merge
    gears starts its controller at `start_gear` (no other case builds a
    GearController while it runs)."""
    cfg, kw, world, _ = CASES[name]
    jsim = JaxSimulation(JaxConfig.from_dict(yaml.safe_load(yaml.safe_dump(cfg))), world=world)
    if kw.get("start_gear"):
        import shadow_tpu.core.gears as jgears

        base = jgears.GearController

        class FromGear(base):
            def __init__(self, ladder, *a, **k):
                super().__init__(ladder, *a, **k)
                self.gear = kw["start_gear"]

        jgears.GearController = FromGear
        try:
            rep = jsim.run(progress=False)
        finally:
            jgears.GearController = base
    else:
        rep = jsim.run(progress=False)
    rep["_engine_cfg"] = jsim.engine_cfg
    return rep


def _jax(name: str) -> dict:
    """The JAX package's report for a case (computed once per module, three
    at a time, from the module's start)."""
    return _JAX[name].result(timeout=600)


@pytest.mark.parametrize("name", list(CASES))
def test_world4_matches_jax(name, port_reports):
    cfg, kw, world, extra = CASES[name]
    want = _jax("gather" if name in ("alltoall", "hierarchical") else name)
    got = port_reports()[name]
    keys = BASE_KEYS + extra
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}
    # the run went through the mesh: a barrier per round, an exchange
    calls = got["mesh_calls"]
    assert calls["pmin"] >= got["rounds"]
    if name in ("alltoall_shed", "tgen_bucketed_shed"):
        assert got["alltoall_shed_dropped"] > 0
    if name == "tgen_bucketed_shed":
        # the auto block sheds; a round with sends anywhere rebuilds every
        # shard's bucket cache
        assert got["engine_cfg"]["a2a_block"] == 0
        assert got["bucket_cache_rebuilds"] % WORLD == 0 < got["bucket_cache_rebuilds"]
    if name == "hier_gears_low":
        assert got["gears"]["replays"] > 0
    if name == "faults_integrity":
        assert got["faults_dropped"] and got["faults_delayed"]
    if name == "pressure_abort":
        assert got["aborted"] and got["queue_overflow_dropped"] > 0


@pytest.mark.parametrize("name", ["gather", "alltoall", "hierarchical"])
def test_ici_counters_follow_the_model(name, port_reports):
    """counter == model x exchanges x world (one exchange per round plus
    the round that finds the run done), with the JAX package's model."""
    jcfg = _jax("gather")["_engine_cfg"]
    got = port_reports()[name]
    jcfg = dataclasses.replace(jcfg, num_hosts=36, world=WORLD, exchange=name)
    exchanges = got["rounds"] + 1
    assert got["ici_bytes"] == exchange_ici_bytes_per_round(jcfg) * exchanges * WORLD > 0
    if name == "hierarchical":
        intra, inter = exchange_tier_bytes_per_round(jcfg)
        assert got["exchange"] == {
            "kind": "hierarchical", "block": jcfg.hier_block_size,
            "ici_intra_bytes": intra * exchanges * WORLD,
            "ici_inter_bytes": inter * exchanges * WORLD}
    # the run loop's collectives: one MIN per round, the exchange's one
    # (two on the hierarchical path), and on a flat queue with no plane
    # that sums, no SUM
    want = {"pmin": exchanges, **{"gather": {"all_gather": exchanges},
                                  "alltoall": {"all_to_all": exchanges},
                                  "hierarchical": {"all_to_all": 2 * exchanges}}[name]}
    assert got["mesh_calls"] == want
    assert got["alltoall_shed_dropped"] == 0
