"""PyTorch port vs JAX reference: the exchange merge's positional row bound
(`merge_rows`, B21).

The JAX merge materializes only the first `merge_rows` rows of its sorted
exchange array, where one token per host precedes the host's rows; rows at
or past the bound shed into `queue.dropped`. The port's merges (K4, K13 and
their plain versions) give each destination the bound that position
implies. Cases: PHOLD on tests/engine_harness.py's single-node graph (H =
32, send budget 4) with a bound of 48 rows, so that JAX's `dropped` grows,
in both shed modes (`urgency`, and `append`: the engine's cheap_shed), at
full width and under merge gears started at the lowest gear (so chunks
shed at the gear, replay wider, and the bound applies to the gear-sliced
outbox), and with the scatter merge (whose fast path must step aside
whenever the bound could bind).

The JAX engine runs on the CPU; the port runs its plain PyTorch path.
Tolerance: exact equality of the whole final state and of the gears
report.
"""

import dataclasses

import jax
import pytest

from engine_harness import build_sim, mk_hosts
from test_torch_engine import assert_states_equal, port_from_inputs, run_jax
from test_torch_gossip_circuit import _one_thread  # noqa: F401  (fixture)
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.gears import GearController as JaxGearController
from shadow_tpu.core.gears import resolve_gear_ladder as jax_resolve
from shadow_tpu.core.gears import run_adaptive_chunk as jax_run_adaptive
from shadow_tpu_torch.core.convert import to_numpy
from shadow_tpu_torch.core.gears import GearController, resolve_gear_ladder, run_adaptive_chunk
from shadow_tpu_torch.ops import merge as pmerge

MS = 1_000_000
HOSTS = mk_hosts(32, {"population": 3, "mean_delay": "20 ms"})
STOP = 400 * MS
MERGE_ROWS = 48


def _build(cheap_shed: bool, scatter: bool = False):
    cfg, model, params, mstate, events = build_sim(
        "phold", HOSTS, STOP, qcap=16, sends_budget=4, latency=10 * MS,
        merge_rows=MERGE_ROWS, merge_scatter=scatter)
    return dataclasses.replace(cfg, cheap_shed=cheap_shed), model, params, mstate, events


@pytest.mark.parametrize("cheap_shed, scatter", [(False, False), (True, False), (False, True)],
                         ids=["urgency-sort", "append-sort", "urgency-scatter"])
def test_merge_rows_matches_jax(cheap_shed, scatter):
    cfg, model, params, mstate, events = _build(cheap_shed, scatter)
    jeng, _, _, jst, _ = run_jax(cfg, model, params, mstate, events)
    peng, pst, ppar = port_from_inputs(jeng.cfg, "phold", HOSTS, params)
    assert (peng.cfg.merge_rows, peng.cfg.cheap_shed) == (MERGE_ROWS, cheap_shed)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    assert_states_equal(jst, pst)
    assert to_numpy(pst)["queue.dropped"].sum() > 0


@pytest.mark.parametrize("cheap_shed", [False, True], ids=["urgency", "append"])
def test_merge_rows_geared_matches_jax(cheap_shed):
    cfg, model, params, mstate, events = _build(cheap_shed)
    jeng = JaxEngine(cfg, model, None)
    jst, jpar = jeng.init_state(params, mstate, events, seed=1)
    jctl = JaxGearController(jax_resolve("auto", cfg.sends_per_host_round))
    jctl.gear = jctl.ladder[0]
    while not bool(jst.done):
        jst, _, _ = jax_run_adaptive(jctl, jst, lambda s, g: jeng.run_chunk_gear(s, jpar, g))
    peng, pst, ppar = port_from_inputs(jeng.cfg, "phold", HOSTS, params)
    ctl = GearController(resolve_gear_ladder("auto", peng.cfg.sends_per_host_round))
    ctl.gear = ctl.ladder[0]
    while not pst.done:
        pst, _, _ = run_adaptive_chunk(ctl, peng, pst, ppar)
    assert_states_equal(jax.device_get(jst), pst)
    assert ctl.report() == jctl.report() and ctl.replays > 0
    assert to_numpy(pst)["queue.dropped"].sum() > 0


def test_plain_merge_bound_is_positional():
    """The bound by hand: 3 hosts, a row bound of 6 sorted positions. Host
    0's token sits at 0 and its rows at 1-3; host 1's token at 4, its rows
    at 5-6; host 2's token at 7. So host 0 keeps its 3 rows, host 1 keeps
    1 of 2, host 2 keeps none of 1; the scatter merge, whose fast path
    would place all 6, must fall back to the same result."""
    import torch

    from shadow_tpu_torch.ops.events import make_queue

    dst = torch.tensor([0, 1, 0, 2, 1, 0], dtype=torch.int32)
    t = torch.tensor([5, 6, 7, 8, 9, 10]) * MS
    order = torch.arange(6, dtype=torch.int64)
    kind = torch.zeros(6, dtype=torch.int32)
    payload = torch.zeros((6, 4), dtype=torch.int32)
    for fn in (pmerge.merge_flat_events_plain, pmerge.merge_scatter_free_plain):
        q = fn(make_queue(3, 4, "cpu"), dst, t, order, kind, payload, None, 4, merge_rows=6)
        assert q.dropped.tolist() == [0, 1, 1]
        assert (q.t < 1 << 62).sum(dim=1).tolist() == [3, 1, 0]
        assert sorted(q.t[1][q.t[1] < 1 << 62].tolist()) == [6 * MS]
        q = fn(make_queue(3, 4, "cpu"), dst, t, order, kind, payload, None, 4, merge_rows=10)
        assert q.dropped.tolist() == [0, 0, 0]
