"""PyTorch port vs JAX reference: the tgen-TCP model, burst sends, the
K-way microstep and the bucketed queue, end to end.

Configs are bench config 6 cut down: 16 hosts on a 2x2 torus at 10 ms, three
flows of ten segments per client, tx_batch 2 (two-segment bursts), queue
capacity 28. Three cases: the plain one; a lossy torus (5% loss per edge:
retransmits, RTO and fast retransmit); and a tight capacity of 6 slots,
where queue overflow drops through the K-way reserve path. The JAX engine
runs each case once at K = 1 on the flat queue, and once at K = 4 on the
bucketed queue (the config-6 shape); the port runs K in {1, 4} x {flat,
bucketed}. Digests, event counts, drop counters and the tgen report do not
depend on K or the queue layout in either package, so every port run is
held to the K = 1 flat reference; `popk_deferred` and `microsteps` depend on
K only, and `bucket_cache_rebuilds` on the layout only, so they are held to
the K = 4 bucketed reference. Tolerance: exact equality.

Also: the u32 reassembly-bitmap helpers against JAX on edge values, a
mid-run carry-over of a JAX BucketQueue and tgen state, and the YAML/CLI
driver with tgen_tcp.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bench import torus_gml
from shadow_tpu.config.options import ConfigOptions as JaxConfig
from shadow_tpu.models.tgen import _ctz32 as jax_ctz32
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.__main__ import main as port_main
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core.convert import engine_config_from, from_jax_numpy, to_numpy
from shadow_tpu_torch.models.tgen import _ctz32, _popcount32
from shadow_tpu_torch.sim import Simulation

# the report keys that do not depend on K or the queue layout
INVARIANT = (
    "simulated_seconds", "rounds", "events_processed", "packets_sent", "packets_delivered",
    "packets_lost", "packets_unreachable", "packets_codel_dropped", "queue_overflow_dropped",
    "packets_budget_dropped", "outbox_overflow_dropped", "queue_occupancy_hwm",
    "outbox_send_hwm", "monotonic_violations", "determinism_digest", "model_report",
)
CASES = {
    "plain": dict(loss=0.0, cap=28, block=7),
    "lossy": dict(loss=0.05, cap=28, block=7),
    "tight": dict(loss=0.0, cap=6, block=3),
}
VARIANTS = [(1, False), (1, True), (4, False), (4, True)]


def tgen_config(loss: float, cap: int, block: int, k: int, bucketed: bool) -> dict:
    gml = torus_gml(2, lat_ms=10)
    if loss:
        gml = gml.replace('latency "10 ms" ]', f'latency "10 ms" packet_loss {loss} ]')
    ex = {"event_queue_capacity": cap, "sends_per_host_round": 24, "rounds_per_chunk": 40,
          "microstep_events": k}
    if bucketed:
        ex["event_queue_block"] = block
    return {
        "general": {"stop_time": "2 s", "seed": 3, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": gml}},
        "experimental": ex,
        "hosts": {f"n{i}": {"count": 4, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 3, "flow_segs": 10, "cwnd_cap": 8, "mss": 1460,
                           "flow_gap": "20 ms", "tx_batch": 2},
        }]} for i in range(4)},
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapshot(sim):
    return jax.tree.map(np.array, jax.device_get(sim.state)), jax.device_get(sim.params)


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX report at (K = 1, flat) and at (K = 4, bucketed),
    the per-host digests of the first, and a mid-run snapshot (after two
    40-round chunks) of the second, with its final state."""
    out = {}
    for name, c in CASES.items():
        flat = JaxSimulation(JaxConfig.from_dict(tgen_config(**c, k=1, bucketed=False)), world=1)
        rep_flat = flat.run(progress=False)
        bq = JaxSimulation(JaxConfig.from_dict(tgen_config(**c, k=4, bucketed=True)), world=1)
        mid = None
        for i in range(2):
            bq.state = bq.engine.run_chunk(bq.state, bq.params)
            if i == 1:
                mid = _snapshot(bq)
        rep_bq = bq.run(progress=False)
        out[name] = dict(flat=rep_flat, digests=np.asarray(flat.host_digests()), bq=rep_bq,
                         mid=mid, final=jax.tree.map(np.array, jax.device_get(bq.state)),
                         jcfg=bq.engine.cfg)
    return out


@pytest.mark.parametrize("k,bucketed", VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_tgen_matches_jax(reference, case, k, bucketed):
    ref = reference[case]
    sim = Simulation(ConfigOptions.from_dict(tgen_config(**CASES[case], k=k, bucketed=bucketed)),
                     device="cpu")
    rep = sim.run(progress=False)
    assert {x: rep[x] for x in INVARIANT} == {x: ref["flat"][x] for x in INVARIANT}
    assert np.array_equal(sim.host_digests(), ref["digests"])
    assert rep["popk_deferred"] == (ref["bq"]["popk_deferred"] if k > 1 else 0)
    assert rep["microsteps"] == ref["bq" if k > 1 else "flat"]["microsteps"]
    assert rep["bucket_cache_rebuilds"] == (ref["bq"]["bucket_cache_rebuilds"] if bucketed else 0)
    m = rep["model_report"]
    assert m["flows_completed"] > 0 and m["data_segments_sent"] > 0
    if case == "lossy":
        assert rep["packets_lost"] > 0
        assert min(m["retransmits"], m["fast_retransmits"], m["timeouts"]) > 0
    if case == "tight":
        assert rep["queue_overflow_dropped"] > 0
    if bucketed:
        assert rep["bucket_cache_rebuilds"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_mid_run_carry_over(reference, case):
    """A JAX BucketQueue, tgen params and tgen state taken mid-run carry
    across with core/convert.py; the port continues at K = 4 to the JAX
    engine's final state, field by field."""
    ref = reference[case]
    mid_st, mid_par = ref["mid"]
    assert 0 < int(mid_st.now) < 2_000_000_000 and hasattr(mid_st.queue, "bt")
    assert mid_st.model["sv_bm"].dtype == np.uint32
    sim = Simulation(ConfigOptions.from_dict(tgen_config(**CASES[case], k=4, bucketed=True)),
                     device="cpu")
    eng = sim.engine
    assert eng.cfg == engine_config_from(ref["jcfg"])
    par, st = from_jax_numpy(mid_par, mid_st, device="cpu")
    a, b = to_numpy(mid_st), to_numpy(st)
    assert [x for x in a if not np.array_equal(a[x], b[x])] == []
    while not st.done:
        st = eng.run_chunk(st, par)
    a, b = to_numpy(ref["final"]), to_numpy(st)
    assert a.keys() == b.keys()
    assert [x for x in a if not np.array_equal(a[x], b[x])] == []


def test_cli_runs_tgen(reference, tmp_path):
    """`python -m shadow_tpu_torch cfg.yaml --device cpu` with tgen_tcp, K
    and the block given on the command line."""
    path = tmp_path / "tgen.yaml"
    path.write_text(yaml.safe_dump(tgen_config(**CASES["lossy"], k=1, bucketed=False)))
    data = tmp_path / "data"
    assert port_main([str(path), "--device", "cpu", f"--general.data_directory={data}",
                      "--experimental.microstep_events=4",
                      "--experimental.event_queue_block=7"]) == 0
    rep = json.loads((data / "sim-stats.json").read_text())
    ref = reference["lossy"]
    assert {x: rep[x] for x in INVARIANT} == {x: ref["flat"][x] for x in INVARIANT}
    assert rep["popk_deferred"] == ref["bq"]["popk_deferred"]
    assert rep["bucket_cache_rebuilds"] == ref["bq"]["bucket_cache_rebuilds"]


EDGES = sorted({0, 1, 2, 3, 5, 7, 0xFF, 0x100, 0xFFFF, 0x10000, 0x7FFFFFFF, 1 << 31,
                (1 << 31) + 1, 0xFFFFFFFE, 0xFFFFFFFF, 0xAAAAAAAA, 0x55555555, 0x80000001,
                *(1 << i for i in range(32)), *((1 << i) - 1 for i in range(33)),
                *((0xFFFFFFFF << i) & 0xFFFFFFFF for i in range(32))})


def test_u32_bitmap_helpers_match_jax():
    """_ctz32 (32 for 0), the complement/negate masks and the SWAR popcount
    over edge values and every single-bit and low-run value."""
    x = np.array(EDGES, np.uint32)
    xt = torch.as_tensor(x.astype(np.int64))
    assert np.array_equal(np.asarray(jax_ctz32(jnp.asarray(x))).astype(np.int64),
                          _ctz32(xt).numpy())
    assert np.array_equal(np.asarray(jax_ctz32(~jnp.asarray(x))).astype(np.int64),
                          _ctz32((~xt) & 0xFFFFFFFF).numpy())
    want = np.array([bin(int(v)).count("1") for v in x], np.int64)
    assert np.array_equal(_popcount32(xt).numpy(), want)
    assert _ctz32(torch.tensor([0])).item() == 32
