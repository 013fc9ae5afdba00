"""PyTorch port vs JAX reference: the scatter merge (`merge_scatter_free`,
kernel K13's plain version) and the exchange merge on a gear-sliced outbox
(K4's plain version with a column limit).

Op level: numpy-seeded queues and outbox rows go through the JAX
`merge_scatter_free` / `merge_flat_events` (on the rows the JAX exchange
builds: the first `gc` columns of the [H, B] outbox, flattened host-major)
and through the port's plain versions (handed the [H, B] planes and the
column count). Loads that fit (the fast path), one destination past the
insert cap and nearly full queues (the sort-merge branch), a round with no
rows; both shed modes; full and sliced widths. Engine level: runs with
`merge_scatter` on, port against JAX, including a queue small enough that
rounds take the sort-merge branch, and merge gears on top.

Tolerance: exact equality of the queue planes (slot for slot: the fast
path places rows in descending row index, as the JAX peeling does) and of
`dropped`; engine runs compare the whole final state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.ops import events as jev
from shadow_tpu.ops import merge as jmerge
from shadow_tpu_torch.core.convert import engine_config_from, params_from_jax_numpy, to_numpy
from shadow_tpu_torch.core.engine import Engine
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.ops import merge as pmerge
from shadow_tpu_torch.ops.events import EventQueue
from shadow_tpu_torch.simtime import TIME_MAX
from shadow_tpu_torch.testing import MERGE_LOADS, merge_case, merge_fits

P = 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_rows(ob, gc, h):
    """The rows the JAX exchange hands its merge: the first gc columns,
    flattened host-major, valid = live and in range."""
    dst, t, order, kind, payload = (x[:, :gc] for x in ob)
    dst, t, order, kind = (x.reshape(-1) for x in (dst, t, order, kind))
    payload = payload.reshape(-1, P)
    valid = (t != TIME_MAX) & (dst >= 0) & (dst < h)
    return tuple(jnp.asarray(x) for x in (dst, t, order, kind, payload, valid))




@pytest.mark.parametrize("urgency", [True, False], ids=["urgency", "append"])
@pytest.mark.parametrize("gc", [1, 3, 6], ids=["gc1", "gc3", "full_width"])
@pytest.mark.parametrize("load", MERGE_LOADS)
@pytest.mark.parametrize("seed", [0, 1])
def test_merges_match_jax_plane_for_plane(seed, load, gc, urgency):
    h, cap, b = 48, 8, 6
    r_cap = 5  # max_inserts below the capacity: the insert cap binds
    q, ob = merge_case(1000 * seed + 10 * gc + MERGE_LOADS.index(load), h, cap, b, gc, load)
    jq = jev.EventQueue(*(jnp.asarray(x) for x in q))
    rows = jax_rows(ob, gc, h)
    jscat = jmerge.merge_scatter_free(jq, *rows, r_cap, shed_urgency=urgency)
    jsort = jmerge.merge_flat_events(jq, *rows, r_cap, shed_urgency=urgency)
    pob = [torch.as_tensor(x) for x in ob]
    pq = EventQueue(*(torch.as_tensor(x) for x in q))
    pscat = pmerge.merge_scatter_free_plain(pq, *pob, None, r_cap, urgency, cols=gc)
    psort = pmerge.merge_flat_events_plain(pq, *pob, None, r_cap, urgency, cols=gc)
    for name, j, p in (("scatter", jscat, pscat), ("sort", jsort, psort)):
        for f in EventQueue._fields:
            assert np.array_equal(np.asarray(getattr(j, f)), getattr(p, f).numpy()), (name, f)
    # the wrappers route CPU tensors to the plain versions
    for fn, want in ((pmerge.merge_scatter_free, pscat), (pmerge.merge_flat_events, psort)):
        got = fn(EventQueue(*(torch.as_tensor(x) for x in q)), *pob, None, r_cap, urgency,
                 cols=gc)
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    took_fast = merge_fits(q, ob, gc, r_cap)
    assert took_fast == (load in ("fit", "empty"))
    if took_fast:
        assert np.array_equal(pscat.dropped.numpy(), q[4])
        if load == "fit":  # the fast path places rows in other slots than the sort
            assert not np.array_equal(pscat.t.numpy(), psort.t.numpy())
    else:
        assert all(torch.equal(a, c) for a, c in zip(pscat, psort))
        assert int((psort.dropped.numpy() - q[4]).sum()) > 0
    if load == "empty":
        assert all(np.array_equal(getattr(pscat, f).numpy(), x)
                   for f, x in zip(EventQueue._fields, q))


@pytest.mark.parametrize("urgency", [True, False], ids=["urgency", "append"])
def test_flat_rows_match_jax(urgency):
    """N flat rows (the form the wrappers keep for flat callers): random
    destinations, a hot one and invalid rows, against the JAX ops."""
    rng = np.random.default_rng(7)
    h, cap, n = 32, 8, 120
    q = merge_case(7, h, cap, 1, 1, "fit")[0]
    dst = rng.integers(0, h, n).astype(np.int32)
    dst[:30] = 5
    t = rng.integers(50, 90, n).astype(np.int64) * 1_000_000
    order = (np.arange(n, dtype=np.int64) * 7919) | (rng.integers(0, h, n) << 40)
    kind = rng.integers(0, 9, n).astype(np.int32)
    payload = rng.integers(0, 100, (n, P)).astype(np.int32)
    valid = rng.random(n) < 0.8
    args = (dst, t, order, kind, payload, valid)
    jq = jev.EventQueue(*(jnp.asarray(x) for x in q))
    pq = EventQueue(*(torch.as_tensor(x) for x in q))
    for jf, pf in ((jmerge.merge_scatter_free, pmerge.merge_scatter_free_plain),
                   (jmerge.merge_flat_events, pmerge.merge_flat_events_plain)):
        j = jf(jq, *(jnp.asarray(x) for x in args), 8, shed_urgency=urgency)
        p = pf(pq, *(torch.as_tensor(x) for x in args), 8, urgency)
        for f in EventQueue._fields:
            assert np.array_equal(np.asarray(getattr(j, f)), getattr(p, f).numpy()), f


# ---- engine runs -------------------------------------------------------------

CASES = {
    "echo": ("udp_echo",
             [dict(host_id=0, name="server", start_time=0, model_args={"role": "server"})]
             + [dict(host_id=i, name=f"c{i}", start_time=0,
                     model_args={"role": "client", "peer": "server",
                                 "interval": "4 ms", "size_bytes": 2000})
                for i in range(1, 5)],
             200_000_000, dict(bw_bits=2_000_000, loss=0.05)),
    "phold": ("phold", mk_hosts(8, {"mean_delay": "20 ms", "population": 3}),
              300_000_000, dict(loss=0.1)),
    "tgen": ("tgen_tcp",
             mk_hosts(5, {"flow_segs": 8, "flows": 2, "cwnd_cap": 8, "rto_min": "100 ms"}),
             2_000_000_000, dict(loss=0.05, latency=10_000_000, sends_budget=16)),
    # the queue of tests/test_wheel.py's overflow-fallback case: rounds
    # where a destination's rows outnumber its free slots take K4's branch
    "tgen_overflow": ("tgen_tcp",
                      mk_hosts(5, {"flow_segs": 8, "flows": 2, "cwnd_cap": 8,
                                   "rto_min": "100 ms"}),
                      2_000_000_000, dict(loss=0.05, latency=10_000_000, sends_budget=16,
                                          qcap=4, microstep_limit=16)),
}


def run_both(case, **kw):
    model, hosts, stop, ckw = CASES[case]
    cfg, m, params, mstate, events = build_sim(model, hosts, stop, **ckw, **kw)
    jeng = JaxEngine(cfg, m, None)
    jst, jpar = jeng.init_state(params, mstate, events, seed=1)
    while not bool(jst.done):
        jst = jeng.run_chunk(jst, jpar)
    peng = Engine(engine_config_from(jeng.cfg), get_model(model)(), "cpu")
    mparams, pmstate, pevents = peng.model.build(hosts, 1, "cpu")
    p0 = params_from_jax_numpy(jax.device_get(params), device="cpu")._replace(model=mparams)
    pst, ppar = peng.init_state(p0, pmstate, pevents, seed=1)
    while not pst.done:
        pst = peng.run_chunk(pst, ppar)
    return jax.device_get(jst), pst, peng


def same_state(a, b):
    a, b = to_numpy(a), to_numpy(b)
    assert a.keys() == b.keys()
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, bad


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_with_merge_scatter_matches_jax(case):
    jst, pst, peng = run_both(case, merge_scatter=True)
    assert peng.cfg.merge_scatter
    same_state(jst, pst)
    if case == "tgen_overflow":  # the sort-merge branch ran and shed
        assert int(pst.queue.dropped.sum()) > 0


def test_merge_scatter_under_gears_matches_jax():
    """Scatter merge on a gear-sliced outbox: a geared run from the lowest
    gear equals the JAX package's."""
    from shadow_tpu.core.gears import GearController as JaxGearController
    from shadow_tpu.core.gears import run_adaptive_chunk as jax_run_adaptive
    from shadow_tpu_torch.core.gears import GearController, run_adaptive_chunk

    model, hosts, stop, ckw = CASES["tgen_overflow"]
    cfg, m, params, mstate, events = build_sim(model, hosts, stop, merge_scatter=True, **ckw)
    jeng = JaxEngine(cfg, m, None)
    jst, jpar = jeng.init_state(params, mstate, events, seed=1)
    jctl = JaxGearController([2, 4, 8, 16])
    jctl.gear = 2
    while not bool(jst.done):
        jst, _, _ = jax_run_adaptive(jctl, jst, lambda s, g: jeng.run_chunk_gear(s, jpar, g))
    peng = Engine(engine_config_from(jeng.cfg), get_model(model)(), "cpu")
    mparams, pmstate, pevents = peng.model.build(hosts, 1, "cpu")
    p0 = params_from_jax_numpy(jax.device_get(params), device="cpu")._replace(model=mparams)
    pst, ppar = peng.init_state(p0, pmstate, pevents, seed=1)
    ctl = GearController([2, 4, 8, 16])
    ctl.gear = 2
    while not pst.done:
        pst, _, _ = run_adaptive_chunk(ctl, peng, pst, ppar)
    same_state(jax.device_get(jst), pst)
    assert ctl.report() == jctl.report() and ctl.replays > 0
