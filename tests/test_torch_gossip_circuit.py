"""PyTorch port vs JAX reference: whole small simulations of bench config 3
(the gossip flood: one publisher flooding a fresh generation every
interval, fanout 8, capacity 32, 10 sends per host per round) and bench
config 4 (Tor-like relay circuits: relays and clients with one cell in
flight each, capacity 32, 8 sends per host per round), cut to H <= 64 on
tests/engine_harness.py's single-node graph; the gossip case with some
loss, the circuit case with a tight queue so that drops show.

The JAX engine runs on the CPU; the port runs its plain PyTorch path
(`handle_plain` of the gossip and circuit models, K21 and K22's plain
versions) from its own build and `init_state`. Tolerance: exact equality
of the whole final state (per-host digests, event counts, every drop
counter, queue slabs, model state) and of the model's report. The
handlers alone are held to JAX in tests/test_torch_handlers.py.
"""

import numpy as np
import pytest
import torch

from engine_harness import build_sim
from test_torch_engine import assert_states_equal, port_from_inputs, run_jax
from shadow_tpu_torch.core.convert import to_numpy

MS = 1_000_000


def gossip_hosts(n: int) -> list[dict]:
    pub = {"host_id": 0, "name": "pub", "start_time": 0,
           "model_args": {"fanout": 8, "publisher": True, "publish_interval": "300 ms"}}
    return [pub] + [{"host_id": i, "name": f"sub{i}", "start_time": 0,
                     "model_args": {"fanout": 8}} for i in range(1, n)]


def circuit_hosts(n_relays: int, n_clients: int) -> list[dict]:
    relays = [{"host_id": i, "name": f"r{i}", "start_time": 0,
               "model_args": {"role": "relay"}} for i in range(n_relays)]
    return relays + [{"host_id": n_relays + i, "name": f"c{i}", "start_time": (i % 4) * MS,
                      "model_args": {"role": "client", "interval": "400 ms"}}
                     for i in range(n_clients)]


CASES = {
    "cfg3_gossip": dict(model="gossip", hosts=gossip_hosts(48), stop=1_300 * MS,
                        kw=dict(qcap=32, sends_budget=10, loss=0.05)),
    "cfg4_circuit": dict(model="circuit", hosts=circuit_hosts(6, 40), stop=2_500 * MS,
                         kw=dict(qcap=4, sends_budget=8)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """H <= 64: PyTorch's intra-op threads only slow these tensors down."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(CASES))
def test_small_config_matches_jax(name):
    case = CASES[name]
    cfg, model, params, mstate, events = build_sim(case["model"], case["hosts"], case["stop"],
                                                   **case["kw"])
    jeng, jst0, _, jst, _ = run_jax(cfg, model, params, mstate, events)
    peng, pst, ppar = port_from_inputs(jeng.cfg, case["model"], case["hosts"], params)
    assert_states_equal(jst0, pst)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    assert_states_equal(jst, pst)
    jrep = model.report({k: np.asarray(v) for k, v in jst.model.items()}, case["hosts"])
    prep = peng.model.report({k: v.numpy() for k, v in pst.model.items()}, case["hosts"])
    assert prep == jrep
    s = to_numpy(pst)
    assert s["stats.pkts_sent"].sum() > 0
    if name == "cfg3_gossip":
        assert jrep["generations"] >= 4 and jrep["adoptions"] > 100
        assert s["stats.pkts_lost"].sum() > 0
    else:
        assert jrep["cells_completed"] > 0 and jrep["relay_forwards"] > 0
        assert s["queue.dropped"].sum() > 0
