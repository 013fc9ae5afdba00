"""PyTorch port vs JAX reference: the CPU model (`cpu_delay_ns`, B20).

Every executed event charges `cpu_delay_ns` of simulated CPU time: an
event that pops while its host is busy executes at the busy horizon, the
barrier and the microstep loop see each host's next event floored by that
horizon, and a host whose horizon has reached the window's end pops
nothing more in the round. Cases on tests/engine_harness.py's single-node
graph (H <= 64): PHOLD at K = 1 with the timer wheel, PHOLD at K = 4 on
the bucketed queue, and shaped udp_echo at K = 1 (the ingress requeue
under the delay). The delay is longer than a window (10 ms of lookahead,
12 ms of CPU time), so every executed event defers its host's next one
past `window_end`, and at K = 4 the busy test defers batch events.

The JAX engine runs on the CPU; the port runs its plain PyTorch path from
its own build and `init_state`. Tolerance: exact equality of the whole
final state, the busy horizon included.
"""

import pytest
import torch

from engine_harness import build_sim, mk_hosts
from test_torch_engine import assert_states_equal, port_from_inputs, run_jax
from test_torch_gossip_circuit import _one_thread  # noqa: F401  (fixture)
from shadow_tpu_torch.core.convert import to_numpy

MS = 1_000_000


def echo_hosts(n_clients):
    hosts = [{"host_id": 0, "name": "server", "start_time": 0,
              "model_args": {"role": "server"}}]
    return hosts + [{"host_id": i + 1, "name": f"c{i}", "start_time": (i % 5) * MS,
                     "model_args": {"role": "client", "peer": "server", "interval": "15 ms",
                                    "size_bytes": 400}} for i in range(n_clients)]


CASES = {
    "phold_k1_wheel": dict(
        model="phold", hosts=mk_hosts(32, {"population": 3, "mean_delay": "20 ms"}),
        stop=600 * MS, kw=dict(qcap=16, sends_budget=4, latency=10 * MS, wheel_slots=4)),
    "phold_k4_bucketed": dict(
        model="phold", hosts=mk_hosts(32, {"population": 3, "mean_delay": "20 ms"}),
        stop=600 * MS, kw=dict(qcap=16, sends_budget=4, latency=10 * MS, queue_block=4,
                               microstep_events=4)),
    "echo_k1_shaped": dict(
        model="udp_echo", hosts=echo_hosts(23), stop=500 * MS,
        kw=dict(qcap=8, sends_budget=3, latency=10 * MS, bw_bits=600_000)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_delay_matches_jax(name):
    case = CASES[name]
    cfg, model, params, mstate, events = build_sim(case["model"], case["hosts"], case["stop"],
                                                   cpu_delay_ns=12 * MS, **case["kw"])
    jeng, jst0, _, jst, _ = run_jax(cfg, model, params, mstate, events)
    peng, pst, ppar = port_from_inputs(jeng.cfg, case["model"], case["hosts"], params)
    assert peng.cfg.cpu_delay_ns == 12 * MS
    assert_states_equal(jst0, pst)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    assert_states_equal(jst, pst)
    s = to_numpy(pst)
    assert s["stats.events"].sum() > 0 and (s["cpu_busy_until"] > 0).any()
    if cfg.microstep_events > 1:
        assert s["stats.popk_deferred"].sum() > 0
    if name == "echo_k1_shaped":
        assert s["stats.pkts_delivered"].sum() > 0


def test_busy_floor_in_next_times():
    """The barrier's view: a busy host's head is floored at its horizon,
    an empty host stays at TIME_MAX, and K1's plain version is the floored
    row minimum."""
    from shadow_tpu_torch.ops.events import next_time_plain
    from shadow_tpu_torch.simtime import TIME_MAX

    t = torch.tensor([[5, 9], [TIME_MAX, TIME_MAX], [30, 2], [7, TIME_MAX]])
    floor = torch.tensor([8, 50, 1, 0])
    assert next_time_plain(t, floor).tolist() == [8, TIME_MAX, 2, 7]
    assert next_time_plain(t).tolist() == [5, TIME_MAX, 2, 7]


def test_knobs_parse_like_jax():
    """`experimental.cpu_delay` (a time; bare numbers are ms) and
    `merge_rows`, from the YAML and from the command line, give the JAX
    package's engine config, as the simulation builds it."""
    from shadow_tpu.config.options import load_config as jax_load_config
    from shadow_tpu.config.options import merge_cli_overrides as jax_merge
    from shadow_tpu.sim import Simulation as JaxSimulation
    from shadow_tpu_torch.config.options import load_config, merge_cli_overrides
    from shadow_tpu_torch.sim import Simulation
    from test_torch_sim import YAML

    text = YAML.replace("sends_per_host_round: 3}",
                        'sends_per_host_round: 3, cpu_delay: "3 ms", merge_rows: 40}')
    over = {"experimental.cpu_delay": "2", "experimental.merge_rows": "44"}
    for p, j in ((load_config(text, is_text=True), jax_load_config(text, is_text=True)),
                 (merge_cli_overrides(load_config(YAML, is_text=True), over),
                  jax_merge(jax_load_config(YAML, is_text=True), over))):
        psim, jsim = Simulation(p, device="cpu"), JaxSimulation(j, world=1)
        assert (psim.engine_cfg.cpu_delay_ns, psim.engine_cfg.merge_rows) == \
            (jsim.engine_cfg.cpu_delay_ns, jsim.engine_cfg.merge_rows)
    assert (psim.engine_cfg.cpu_delay_ns, psim.engine_cfg.merge_rows) == (2 * MS, 44)
