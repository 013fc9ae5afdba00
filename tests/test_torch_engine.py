"""PyTorch port vs JAX reference: the single-device round engine.

Inputs come from tests/engine_harness.py `build_sim` (H <= 64) for the
phold, udp_echo and timer models: a single-node graph, multi-node graphs
that drive the three routing forms (affine host->node rows, irregular
node_of rows, and the 2-D table gather), and an overflow case where queue
drops, send-budget drops and CoDel drops are all non-zero. The JAX engine
runs on the CPU; the port runs its plain PyTorch path (`device="cpu"`),
starting from its own `init_state`, which must equal the converted JAX
initial state field by field.

Tolerance: exact equality of the whole final state — per-host digests,
event counts, every drop counter, queue slabs, RNG lanes, model state. The
slice's float math is float32/float64 elementwise in the JAX op order, so
nothing is allowed to differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu_torch.core.convert import (
    engine_config_from,
    from_jax_numpy,
    params_from_jax_numpy,
    to_numpy,
)
from shadow_tpu_torch.core.engine import Engine
from shadow_tpu_torch.models import get_model

SEC = 1_000_000_000
MS = 1_000_000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def multi_node(cfg, params, node_of):
    """Swap build_sim's single-node tables for a 4-node graph with loss,
    jitter and one unreachable pair."""
    n = 4
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    lat = (20 + 7 * np.abs(i - j) + 3 * i).astype(np.int64) * MS
    lat[3, 0] = -1  # unreachable: counted, never delivered
    loss = np.where(i != j, 0.02 * (i + 1), 0.0).astype(np.float32)
    jit = np.where((i + j) % 2 == 1, 4 * MS, 0).astype(np.int64)
    jit[lat < 0] = 0
    min_lat = int((lat - jit)[lat >= 0].min())
    cfg = dataclasses.replace(cfg, static_min_latency=min_lat, use_jitter=True)
    params = params._replace(
        node_of=jnp.asarray(node_of, jnp.int32),
        lat_ns=jnp.asarray(lat), loss=jnp.asarray(loss), jitter_ns=jnp.asarray(jit),
    )
    return cfg, params


def run_jax(cfg, model, params, mstate, events, chunks=None):
    """(engine, initial state, initial params, final state) — the initial
    pytrees fetched to numpy BEFORE the run (the chunk donates its input)."""
    eng = JaxEngine(cfg, model, None)
    st, par = eng.init_state(params, mstate, events, seed=1)
    st0, par0 = jax.device_get(st), jax.device_get(par)
    n = 0
    while not bool(st.done) and (chunks is None or n < chunks):
        st = eng.run_chunk(st, par)
        n += 1
    return eng, st0, par0, st, par


def port_from_inputs(jcfg, model_name, hosts, raw_params):
    """The port's own build from the same inputs: model.build + init_state."""
    eng = Engine(engine_config_from(jcfg), get_model(model_name)(), "cpu")
    mparams, mstate, events = eng.model.build(hosts, 1, "cpu")
    p0 = params_from_jax_numpy(jax.device_get(raw_params), device="cpu")._replace(model=mparams)
    st, par = eng.init_state(p0, mstate, events, seed=1)
    return eng, st, par


def assert_states_equal(jst, pst):
    a, b = to_numpy(jax.device_get(jst)), to_numpy(pst)
    assert a.keys() == b.keys()
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


def echo_hosts(n_clients):
    hosts = [{"host_id": 0, "name": "server", "start_time": 0,
              "model_args": {"role": "server"}}]
    for i in range(n_clients):
        hosts.append({"host_id": i + 1, "name": f"c{i}", "start_time": (i % 5) * MS,
                      "model_args": {"role": "client", "peer": "server",
                                     "interval": "20 ms", "size_bytes": 400}})
    return hosts


CASES = {
    "phold_single_node": dict(
        model="phold", hosts=mk_hosts(32, {"population": 2, "mean_delay": "30 ms"}),
        stop=SEC, kw=dict(qcap=16, sends_budget=4, loss=0.05, bw_bits=2_000_000,
                              latency=10 * MS)),
    "timer": dict(
        model="timer",
        hosts=[{**h, "model_args": {"interval": f"{3 + i % 4} ms"}, "start_time": i * 100_000}
               for i, h in enumerate(mk_hosts(16))],
        stop=SEC // 2, kw=dict(qcap=4)),
    "echo_overflow": dict(
        model="udp_echo", hosts=echo_hosts(47), stop=SEC * 6 // 10,
        kw=dict(qcap=8, sends_budget=2, bw_bits=400_000, latency=5 * MS)),
    "phold_affine": dict(
        model="phold", hosts=mk_hosts(32, {"population": 3, "mean_delay": "40 ms"}),
        stop=SEC, kw=dict(qcap=8, sends_budget=3), node_of=np.arange(32) // 8),
    "phold_irregular": dict(
        model="phold", hosts=mk_hosts(30, {"population": 2, "mean_delay": "40 ms"}),
        stop=SEC, kw=dict(qcap=8, sends_budget=3, bw_bits=5_000_000),
        node_of=np.random.default_rng(5).integers(0, 4, 30)),
    "phold_table_gather": dict(
        model="phold", hosts=mk_hosts(30, {"population": 2, "mean_delay": "40 ms"}),
        stop=SEC, kw=dict(qcap=8, sends_budget=3),
        node_of=np.random.default_rng(6).integers(0, 4, 30), strip_rows=True),
}


def _build(case):
    cfg, model, params, mstate, events = build_sim(case["model"], case["hosts"], case["stop"],
                                                   **case["kw"])
    if "node_of" in case:
        cfg, params = multi_node(cfg, params, case["node_of"])
    return cfg, model, params, mstate, events


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(name):
    case = CASES[name]
    cfg, model, params, mstate, events = _build(case)
    jeng, jst0, jpar0, jst, _ = run_jax(cfg, model, params, mstate, events)
    peng, pst, ppar = port_from_inputs(jeng.cfg, case["model"], case["hosts"], params)
    # the port's own build equals the converted JAX initial state
    assert_states_equal(jst0, pst)
    assert peng.cfg == engine_config_from(jeng.cfg)
    if case.get("strip_rows"):
        assert ppar.lat_rows is not None
        ppar = ppar._replace(lat_rows=None, loss_rows=None, jit_rows=None)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    assert_states_equal(jst, pst)
    s = to_numpy(pst)
    assert s["stats.events"].sum() > 0
    if name == "echo_overflow":
        for k in ("queue.dropped", "stats.pkts_budget_dropped", "stats.pkts_codel_dropped"):
            assert s[k].sum() > 0, k
    if "node_of" in case:
        assert s["stats.pkts_unreachable"].sum() > 0 and s["stats.pkts_lost"].sum() > 0


def test_mid_run_carry_over():
    """Run the JAX engine for a few chunks, carry its state across with
    core/convert.py, and continue both engines to the end."""
    case = dict(CASES["phold_irregular"])
    case["kw"] = {**case["kw"], "rounds_per_chunk": 3}
    cfg, model, params, mstate, events = _build(case)
    jeng, _, _, jst, jpar = run_jax(cfg, model, params, mstate, events, chunks=4)
    mid_st, mid_par = jax.device_get(jst), jax.device_get(jpar)
    mid_st = jax.tree.map(np.array, mid_st)  # own copies: the next chunk donates
    assert 0 < int(mid_st.now) < case["stop"]
    peng = Engine(engine_config_from(jeng.cfg), get_model("phold")(), "cpu")
    ppar, pst = from_jax_numpy(mid_par, mid_st, device="cpu")
    assert_states_equal(mid_st, pst)
    while not bool(jst.done):
        jst = jeng.run_chunk(jst, jpar)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    assert_states_equal(jst, pst)
