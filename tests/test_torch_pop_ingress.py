"""PyTorch port vs JAX reference: the one-event microstep's pop and ingress,
`ops/chain.py pop_ingress` (the function CUDA kernel K36 computes in one
launch), on its CPU path: `pop_min_plain` followed by `event_ingress_plain`.

The reference is the JAX package run op by op on the CPU, on the same
numpy-seeded state: a flat [H, C] queue with many exact time ties, empty
and full rows, and the carry lanes of tests/test_torch_event.py's harness
(CoDel states around the drop law's thresholds, token buckets short of
tokens). Under one limit and under per-host limits (the CPU model's busy
horizon, queue-hold crash windows) it is JAX `_microstep`, whose pop runs
under the limit it derives from the floors; under per-row limits (the
ensemble plane's window end per replica, one replica frozen at 0) JAX
`pop_min` followed by `_event_body`. In both, the model's handler is a spy
that records its context and emits nothing, so the reference's carry
lanes, its queue after the ingress requeue and the handler's context are
exactly what the pop and the ingress produced. The port's side: the queue
after `pop_ingress` and the requeue push, every carry lane, and the
Ingress (execution time, model kind, dispatch, packet flag, source) and
the event's payload against the recorded context. Cases: shaping with
CoDel drops and bucket delays, unshaped, queue-clear crash faults, the
integrity sentinel's second digest, the network observatory's event
classes (under one limit); the CPU model and queue hold (per-host limits);
per-row limits. Beside it, without JAX, the pop of `pop_ingress` under
each limit form against K5 at k = 1 followed by K6 (plain versions).
Tolerance: exact equality — every value is an integer or a bool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.engine import _ev_carry_of as jax_carry_of
from shadow_tpu.core.engine import _event_body, _microstep
from shadow_tpu.models.base import HandlerOut as JaxOut
from shadow_tpu.ops.events import pop_min as jax_pop_min
from shadow_tpu_torch.core.convert import engine_config_from, from_jax_numpy
from shadow_tpu_torch.core.engine import Engine, _ev_carry_of
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.ops import chain as pchain
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.testing import POP_LIMITS, pop_ingress_case
from test_torch_event import _lanes

MS = 1_000_000
KIND_PKT, KIND_INGRESS_DONE = 1 << 16, 1 << 17
TIME_MAX = (1 << 63) - 1
H, C = 40, 12
WINDOW_END = 1_100 * MS

# limit form, build_sim keywords (`faults`: the restart mode of crash
# windows at the queue heads, `_crashes`)
CASES = {
    "shaping_codel": ("scalar", dict(bw_bits=200_000)),
    "unshaped": ("scalar", dict(bw_bits=0)),
    "clear": ("scalar", dict(bw_bits=200_000, faults="clear")),
    "digest2": ("scalar", dict(bw_bits=200_000, integrity=True, integrity_dual=True)),
    "event_classes": ("scalar", dict(bw_bits=200_000, netobs=True)),
    "cpu_model": ("host", dict(bw_bits=200_000, cpu_delay_ns=7 * MS)),
    "hold": ("host", dict(bw_bits=200_000, cpu_delay_ns=7 * MS, faults="hold")),
    "per_row": ("row", dict(bw_bits=200_000)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Spy:
    """A handler that records its context and emits nothing."""

    def __init__(self, model):
        self.inner = model
        self.timer_kinds = getattr(model, "timer_kinds", ())
        self.ctx = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def handle(self, ctx):
        self.ctx = ctx
        return JaxOut(state=ctx.state, rng=ctx.rng, pushes=(), sends=())


def _slab(r):
    """numpy (t, order, kind, payload) of a flat [H, C] queue."""
    fill = r.integers(0, C + 1, H)
    fill[:3] = (0, C, C)
    live = r.random((H, C)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    rows = np.nonzero(live)[0]
    t_host = r.integers(1_000, 1_200, H) * MS
    t = np.full((H, C), TIME_MAX, np.int64)
    t[live] = t_host[rows] + np.where(r.random(n) < 0.35, 0, r.integers(0, 60, n) * MS)
    order = np.full((H, C), TIME_MAX, np.int64)
    order[live] = ((r.integers(0, 2, n) << 62) | (r.integers(0, H, n) << 40)
                   | r.permutation(n).astype(np.int64))
    kind = (r.integers(0, 3, (H, C)) | np.where(r.random((H, C)) < 0.6, KIND_PKT, 0)
            | np.where(r.random((H, C)) < 0.2, KIND_INGRESS_DONE, 0)).astype(np.int32)
    payload = r.integers(0, 1 << 20, (H, C, 4)).astype(np.int32)
    payload[:, :, 0] = r.integers(40, 1_500, (H, C))
    return t, order, kind, payload


def _crashes(t, r):
    """A crash window on every third host that starts at its queue head,
    a millisecond before it or just after it, and lasts 20 ms."""
    head = np.where(t == TIME_MAX, 1_100 * MS, t).min(axis=1) // MS
    return [{"host": i, "down_at": f"{head[i] + r.integers(-1, 2)} ms",
             "up_at": f"{head[i] + 20} ms"} for i in range(0, H, 3)]


def _build(name: str, seed: int):
    """(JAX engine, spy, JAX params, JAX state, port engine, port params,
    port state) on one numpy-seeded queue and carry."""
    _, kw = CASES[name]
    r = np.random.default_rng(seed)
    t, order, kind, payload = _slab(r)
    if "faults" in kw:
        kw = dict(kw, faults={"crashes": _crashes(t, r), "restart_queue": kw["faults"]})
    hosts = mk_hosts(H, {"population": 2, "mean_delay": "30 ms"})
    cfg, model, params, mstate, events = build_sim(
        "phold", hosts, 10**10, sends_budget=5, qcap=C, latency=10 * MS, **kw)
    spy = Spy(model)
    jeng = JaxEngine(cfg, spy, None)
    st, par = jeng.init_state(params, mstate, events, seed=seed)
    st, par = jax.tree.map(np.array, jax.device_get(st)), jax.device_get(par)
    tt = np.where(t == TIME_MAX, 1_100 * MS, t).min(axis=1)
    s = st.stats
    st = st._replace(
        queue=st.queue._replace(t=t, order=order, kind=kind, payload=payload),
        stats=s._replace(**{f: r.integers(0, 1 << 40, H).astype(np.int64) for f in (
            "events", "pkts_codel_dropped", "pkts_delivered")},
            digest=r.integers(0, 1 << 63, H).astype(np.uint64) * np.uint64(3)),
        tb_ingress=st.tb_ingress._replace(
            tokens=r.integers(0, 3_000, H).astype(np.int64),
            last_itv=(tt // MS - r.integers(0, 3, H)).astype(np.int64)),
        codel=st.codel._replace(
            first_above=np.where(r.random(H) < 0.3, 0, tt - r.integers(-50, 200, H) * MS),
            drop_next=(tt - r.integers(-300, 300, H) * MS).astype(np.int64),
            count=r.integers(0, 12, H).astype(np.int32),
            dropping=r.random(H) < 0.5),
    )
    if cfg.cpu_delay_ns:
        # busy horizons before, at and after the heads, some past the window
        st = st._replace(cpu_busy_until=np.select(
            [r.random(H) < 0.3, r.random(H) < 0.3], [0, tt + 40 * MS],
            tt + r.integers(-20, 20, H) * MS).astype(np.int64))
    if cfg.integrity_dual:
        st = st._replace(stats=st.stats._replace(
            digest2=r.integers(0, 1 << 63, H).astype(np.uint64) * np.uint64(5)))
    pmodel = get_model("phold")()
    pmodel.build(hosts, 1, "cpu")
    peng = Engine(engine_config_from(jeng.cfg), pmodel, "cpu")
    ppar, pst = from_jax_numpy(par, st, device="cpu")
    return jeng, spy, jax.tree.map(jnp.asarray, par), jax.tree.map(jnp.asarray, st), peng, \
        ppar, pst


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_pop_ingress_matches_jax(name, seed):
    form, _ = CASES[name]
    jeng, spy, jpar, jst, peng, ppar, pst = _build(name, seed)
    host_gid = jnp.arange(H, dtype=jnp.int64)
    if form == "row":
        # two replicas' window ends, the second frozen (0: it pops nothing)
        lim = np.repeat([WINDOW_END, 0], H // 2).astype(np.int64)
        jq, jev, jact = jax_pop_min(jst.queue, jnp.asarray(lim))
        jc, jpush, _, _, _ = _event_body(jeng.cfg, spy, jax_carry_of(jst), jpar, host_gid,
                                         WINDOW_END, jev, jact)
        if jpush:
            from shadow_tpu.ops.events import push_many as jax_push_many

            jq = jax_push_many(jq, jpush)
        jlanes, jqueue = _lanes(jc), jq
        limit = torch.as_tensor(lim)
    else:
        jst1 = _microstep(jeng.cfg, spy, jst, jpar, host_gid, WINDOW_END)
        jlanes, jqueue = _lanes(jst1), jst1.queue
        jlanes["cpu_busy_until"] = np.asarray(jst1.cpu_busy_until)
        limit = peng._pop_limit(pst, WINDOW_END, ppar)
        assert isinstance(limit, torch.Tensor) == (form == "host")
    q, c, ev, active, ing = pchain.pop_ingress(
        _ev_carry_of(pst), ppar, peng.cfg, pst.queue, limit, peng._timer_mask)
    if ing.requeue is not None:
        q = pev.push_many_plain(q, [ing.requeue])

    for x, y in zip(jqueue, q):
        assert np.array_equal(np.asarray(x), y.numpy())
    plane = _lanes(c)
    if form != "row":
        plane["cpu_busy_until"] = (c.cpu_busy_until.numpy() if c.cpu_busy_until is not None
                                   else np.asarray(jlanes["cpu_busy_until"]))
    assert plane.keys() <= jlanes.keys() and len(plane) > 20
    assert [k for k in plane if not np.array_equal(np.asarray(jlanes[k]), plane[k])] == []
    ctx = spy.ctx
    for want, got in ((ctx.t, ing.t), (ctx.kind, ing.kind), (ctx.active, ing.dispatch),
                      (ctx.is_packet, ing.is_pkt), (ctx.src, ing.src),
                      (ctx.payload, ev.payload), (ctx.t, ev.t)):
        assert np.array_equal(np.asarray(want), got.numpy())
    # the case exercises what it is named for
    s0, s1 = _lanes(_ev_carry_of(pst)), plane
    assert active.any() and not active.all()
    if name == "shaping_codel":
        assert (s1["stats.pkts_codel_dropped"] != s0["stats.pkts_codel_dropped"]).any()
        assert ing.requeue.mask.any()
    if name in ("clear", "hold"):
        lane = "stats.faults_dropped" if name == "clear" else "stats.faults_delayed"
        assert (s1[lane] != s0[lane]).any()
    if name == "cpu_model":
        assert (limit == 0).any() and (ing.t != pst.queue.t.min(dim=1).values)[active].any()
    if name == "event_classes":
        assert all(s1[k] > s0[k] for k in ("stats.ec_timer", "stats.ec_pkt", "stats.ec_app"))


@pytest.mark.parametrize("form", POP_LIMITS)
def test_pop_ingress_pops_as_k5_k6(form):
    """`pop_ingress`'s pop under each limit form takes and clears the slot
    that K5 at k = 1 followed by K6 (their plain versions) takes and
    clears."""
    case = pop_ingress_case(3, 64, C, "cpu", limits=form, n_push=1, sends=((1, False, False),),
                            route="const", shaping=False)
    q0, limit = case["queue"], case["limit"]
    q, _, ev, active, _ = pchain.pop_ingress(case["carry"], case["params"], case["cfg"], q0,
                                             limit)
    popped = pev.pop_k_plain(q0, limit, 1)
    q_k = pev.clear_popped_plain(q0, popped, popped.active[:, 0].to(torch.int32))
    for x, y in zip([*q, *ev, active], [*q_k, *popped.event(0), popped.active[:, 0]]):
        assert torch.equal(x, y)
    assert active.any() and not active.all()
