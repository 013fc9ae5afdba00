"""PyTorch port vs JAX reference: the per-event chain (B5) and the outbox
append (B4), the functions the CUDA kernels K10 and K11 replace (K11 appends
its sends to the outbox itself).

`Engine.event_body` of the port — the ingress plain version, the model's
handler, K11's plain version (the egress plain version, then the append and
the used-latency fold), in turn — is held against JAX `_event_body` (run op
by op on the CPU, as a function of numpy data) on the same numpy-seeded
carry and event: every carry lane (stats, RNG, seq, send cursor, both token
buckets, CoDel, model state), every push, every outbox entry of the plain
egress and the per-host used-latency minimum; then the outbox, its count,
`ob_dropped` and `min_used_lat` against JAX's `_outbox_append_multi` of
those entries and the fold of `_finish_microstep`. Cases: phold with shaping
tight enough for CoDel drops and bucket delays; udp_echo on affine per-host
route rows with jitter and loss; tgen-TCP on the 2-D table gather with
loss; and a synthetic model (one flavour per package, fed the same numpy
ports) with three send ports of burst widths 1-3, counts, payload
increments, out-of-range destinations, hosts at and past the send budget,
irregular node_of rows and jitter, shaped and unshaped. The events mix
packets, requeued packets (ingress already done) and local events, at a
host stride of 1 and as a column of a K-way peek.

`outbox_append_multi_plain` is held against `_outbox_append_multi` on random
outboxes and entries, including entries whose column is past the outbox
width (counted lost). Tolerance: exact equality throughout — every output
is an integer, a bool, or an integer made from float32/float64 math.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_harness import build_sim, mk_hosts
from shadow_tpu.core import Engine as JaxEngine
from shadow_tpu.core.engine import Outbox as JaxOutbox
from shadow_tpu.core.engine import _event_body, _outbox_append_multi
from shadow_tpu.models.base import HandlerOut as JaxOut
from shadow_tpu.models.base import LocalPush as JaxPush
from shadow_tpu.models.base import PacketSend as JaxSend
from shadow_tpu.ops.events import Event as JaxEvent
from shadow_tpu_torch.core.convert import engine_config_from, from_jax_numpy
from shadow_tpu_torch.core.engine import Engine, Outbox, _ev_carry_of
from shadow_tpu_torch.models import base as pbase
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.ops import chain as pchain
from shadow_tpu_torch.ops.chain import EntryStack, outbox_append_multi_plain
from shadow_tpu_torch.ops.events import Event

MS = 1_000_000
KIND_PKT, KIND_INGRESS_DONE = 1 << 16, 1 << 17
H = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def multi_node(cfg, params, node_of, jitter: bool):
    """A 4-node graph with loss, optional jitter and one unreachable pair."""
    n = 4
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    lat = (20 + 7 * np.abs(i - j) + 3 * i).astype(np.int64) * MS
    lat[3, 0] = -1
    loss = np.where(i != j, 0.1 * (i + 1), 0.05).astype(np.float32)
    jit = np.where((i + j) % 2 == 1, 4 * MS, 0).astype(np.int64) if jitter else 0 * lat
    jit[lat < 0] = 0
    cfg = dataclasses.replace(cfg, use_jitter=jitter)
    return cfg, params._replace(
        node_of=jnp.asarray(node_of, jnp.int32), lat_ns=jnp.asarray(lat),
        loss=jnp.asarray(loss), jitter_ns=jnp.asarray(jit),
    )


class Synthetic:
    """A handler that emits fixed numpy-made ports, masked by the dispatch:
    three send ports (burst widths 1, 3, 2; counts and payload increments;
    destinations out of range on some hosts) and two push ports (times
    before the event on some hosts, kinds with high bits set)."""

    name = "synthetic"

    def __init__(self, xp, seed: int, h: int):
        r = np.random.default_rng(seed)
        self.xp = xp

        def a(x):
            return jnp.asarray(x) if xp == "jax" else torch.as_tensor(x)

        def pay():
            return a(r.integers(-(1 << 31), 1 << 31, (h, 4)).astype(np.int32))

        self.pushes = [dict(mask=a(r.random(h) < 0.7), dt=a(r.integers(-5, 50, h) * MS),
                            kind=a(r.integers(0, 1 << 18, h).astype(np.int32)), payload=pay())
                       for _ in range(2)]
        self.sends = []
        for cmax, has_count, has_inc in ((1, False, False), (3, True, True), (2, False, True)):
            self.sends.append(dict(
                mask=a(r.random(h) < 0.8), dst=a(r.integers(-3, h + 3, h)),
                size_bytes=a(r.integers(40, 1500, h).astype(np.int32)),
                kind=a(r.integers(0, 5, h).astype(np.int32)), payload=pay(),
                count=a(r.integers(0, cmax + 2, h).astype(np.int32)) if has_count else None,
                payload_inc=a(r.integers(0, 5000, (h, 4)).astype(np.int32)) if has_inc else None,
                count_max=cmax,
            ))

    def handle(self, ctx):
        if self.xp == "jax":
            push_t, send_t, out_t = JaxPush, JaxSend, JaxOut
        else:
            push_t, send_t, out_t = pbase.LocalPush, pbase.PacketSend, pbase.HandlerOut
        pushes = tuple(push_t(mask=p["mask"] & ctx.active, t=ctx.t + p["dt"], kind=p["kind"],
                              payload=p["payload"]) for p in self.pushes)
        sends = tuple(send_t(**s) for s in self.sends)
        return out_t(state=ctx.state, rng=ctx.rng, pushes=pushes, sends=sends)


def echo_hosts(n_clients):
    hosts = [{"host_id": 0, "name": "server", "start_time": 0, "model_args": {"role": "server"}}]
    for i in range(n_clients):
        hosts.append({"host_id": i + 1, "name": f"c{i}", "start_time": 0,
                      "model_args": {"role": "client", "peer": "server", "interval": "20 ms",
                                     "size_bytes": 400}})
    return hosts


TGEN_ARGS = {"flows": 3, "flow_segs": 10, "cwnd_cap": 8, "mss": 1460, "flow_gap": "20 ms",
             "tx_batch": 2}
# model, hosts, build_sim kwargs, route form, jitter, model kinds the events draw
CASES = {
    "phold_codel_delay": dict(
        model="phold", hosts=mk_hosts(H, {"population": 2, "mean_delay": "30 ms"}),
        kw=dict(bw_bits=200_000, latency=10 * MS), route="const", kinds=2),
    "echo_affine_jitter_loss": dict(
        model="udp_echo", hosts=echo_hosts(H - 1), kw=dict(bw_bits=2_000_000, latency=5 * MS),
        route="affine", jitter=True, kinds=3),
    "tgen_table_loss": dict(
        model="tgen_tcp", hosts=mk_hosts(H, TGEN_ARGS), kw=dict(bw_bits=1_000_000),
        route="table", kinds=6),
    "synthetic_shaped": dict(
        model="phold", hosts=mk_hosts(H, {"population": 1}), kw=dict(bw_bits=300_000),
        route="node_of", jitter=True, kinds=3, synthetic=True),
    "synthetic_unshaped": dict(
        model="phold", hosts=mk_hosts(H, {"population": 1}), kw=dict(bw_bits=0),
        route="affine", kinds=3, synthetic=True),
}


def _build(name: str, seed: int):
    """(JAX engine, JAX params, JAX carry, port engine, port params, port
    carry, JAX event, port event, active) with the carry and the event
    seeded from numpy."""
    case = CASES[name]
    r = np.random.default_rng(seed)
    cfg, model, params, mstate, events = build_sim(
        case["model"], case["hosts"], 10**10, sends_budget=5, qcap=16, **case["kw"])
    if case["route"] != "const":
        node_of = (np.arange(H) // (H // 4) if case["route"] == "affine"
                   else r.integers(0, 4, H))
        cfg, params = multi_node(cfg, params, node_of, case.get("jitter", False))
    jeng = JaxEngine(cfg, model, None)
    st, par = jeng.init_state(params, mstate, events, seed=seed)
    st, par = jax.tree.map(np.array, jax.device_get(st)), jax.device_get(par)
    if case["route"] == "table":
        par = par._replace(lat_rows=None, loss_rows=None, jit_rows=None)

    # the carry: every lane seeded; CoDel states around the drop law's
    # thresholds, token buckets short of tokens, send cursors at the budget
    t0 = 1_000 * MS
    t = t0 + r.integers(0, 200, H) * MS
    s = st.stats
    st = st._replace(
        stats=s._replace(**{f: r.integers(0, 1 << 40, H).astype(np.int64) for f in (
            "events", "pkts_sent", "pkts_lost", "pkts_unreachable", "pkts_codel_dropped",
            "pkts_delivered", "monotonic_violations", "pkts_budget_dropped")},
            digest=r.integers(0, 1 << 63, H).astype(np.uint64) * np.uint64(3)),
        rng=st.rng._replace(s=r.integers(0, 1 << 63, (H, 4)).astype(np.uint64) * np.uint64(5)),
        seq=r.integers(0, 1 << 39, H).astype(np.int64),
        sent_round=r.integers(0, 7, H).astype(np.int32),
        tb_egress=st.tb_egress._replace(tokens=r.integers(0, 30_000, H).astype(np.int64),
                                        last_itv=(t // MS - r.integers(0, 3, H)).astype(np.int64)),
        tb_ingress=st.tb_ingress._replace(
            tokens=r.integers(0, 30_000, H).astype(np.int64),
            last_itv=(t // MS - r.integers(0, 3, H)).astype(np.int64)),
        codel=st.codel._replace(
            first_above=np.where(r.random(H) < 0.3, 0, t - r.integers(-50, 200, H) * MS),
            drop_next=(t - r.integers(-300, 300, H) * MS).astype(np.int64),
            count=r.integers(0, 12, H).astype(np.int32),
            dropping=r.random(H) < 0.5),
    )
    pmodel = get_model(case["model"])()
    pmodel.build(case["hosts"], 1, "cpu")  # the model's static settings (tgen's tx_batch)
    if case.get("synthetic"):
        model, pmodel = Synthetic("jax", seed, H), Synthetic("torch", seed, H)
        jeng.model = model
    peng = Engine(engine_config_from(jeng.cfg), pmodel, "cpu")
    ppar, pst = from_jax_numpy(par, st, device="cpu")

    active = r.random(H) < 0.85
    kind = r.integers(0, case["kinds"], H) | np.where(r.random(H) < 0.6, KIND_PKT, 0)
    kind |= np.where(r.random(H) < 0.2, KIND_INGRESS_DONE, 0)
    payload = r.integers(0, 1 << 20, (H, 4)).astype(np.int32)
    payload[:, 0] = r.integers(40, 1500, H)
    order = ((r.integers(0, 2, H) << 62) | (r.integers(0, H, H) << 40)
             | r.integers(0, 1 << 39, H)).astype(np.int64)
    ev_np = (np.where(active, t, (1 << 63) - 1).astype(np.int64), order,
             np.where(active, kind, 0).astype(np.int32), np.where(active[:, None], payload, 0))
    jev = JaxEvent(*(jnp.asarray(x) for x in ev_np))
    # the port reads the event as column 2 of a K = 3 peek (host stride 3)
    wide = [np.zeros((H, 3) + x.shape[1:], x.dtype) for x in ev_np]
    for w, x in zip(wide, ev_np):
        w[:, 2] = x
    pev = Event(*(torch.as_tensor(w)[:, 2] for w in wide))
    carry = jax.tree.map(jnp.asarray, st)
    return (jeng, jax.tree.map(jnp.asarray, par), carry, peng, ppar, pst, jev, pev, active,
            int(t.min()) + 3 * MS)


def _lanes(c) -> dict:
    """{name: numpy} over a carry of either package (uint lanes as int64)."""
    def npy(x):
        a = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
        return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)

    out = {f"stats.{f}": npy(v) for f, v in c.stats._asdict().items() if v is not None}
    out.update({"rng": npy(c.rng.s), "seq": npy(c.seq), "sent_round": npy(c.sent_round)})
    for g in ("tb_egress", "tb_ingress", "codel"):
        out.update({f"{g}.{f}": npy(v) for f, v in getattr(c, g)._asdict().items()})
    if isinstance(c.model, dict):
        out.update({f"model.{k}": npy(v) for k, v in c.model.items()})
    return out


def event_body(eng, *args):
    """The port's `Engine.event_body` -> (carry', pushes, entry stack, used
    latency), the last two as the plain egress returned them before K11's
    plain version appended and folded them."""
    seen = []
    plain = pchain.event_egress_plain

    def spy(*a):
        out = plain(*a)
        seen.append(out[2:])
        return out

    pchain.event_egress_plain = spy
    try:
        pc, ppush = eng.event_body(*args)
    finally:
        pchain.event_egress_plain = plain
    (pents, pused), = seen
    return pc, ppush, pents, pused


def check_append(jst, jents, jused, pc):
    """The port's outbox, count, ob_dropped and min_used_lat after its event
    body against JAX's `_outbox_append_multi` of the event's entries and
    `_finish_microstep`'s fold, from the same state."""
    job, jlost, jmin = jst.outbox, 0, jst.min_used_lat
    if jents:
        job, jlost = _outbox_append_multi(jst.outbox, jents)
        jmin = jnp.minimum(jmin, jnp.min(jnp.stack([jnp.min(u) for u in jused])))
    for x, y in zip(job, pc.outbox):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(jst.stats.ob_dropped[0]) + int(jlost) == int(pc.stats.ob_dropped[0])
    assert int(jmin) == int(pc.min_used_lat)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CASES))
def test_event_body_matches_jax(name, seed):
    jeng, jpar, jst, peng, ppar, pst, jev, pev, active, window_end = _build(name, seed)
    host_gid = jnp.arange(H, dtype=jnp.int64)
    from shadow_tpu.core.engine import _ev_carry_of as jax_carry_of

    jc, jpush, jents, jused, _ = _event_body(
        jeng.cfg, jeng.model, jax_carry_of(jst), jpar, host_gid, window_end, jev,
        jnp.asarray(active))
    pc, ppush, pents, pused = event_body(
        peng, _ev_carry_of(pst), ppar, window_end, pev, torch.as_tensor(active))

    # every lane the port carries (the JAX Stats also has lanes of planes
    # the port does not run, untouched here; ob_dropped is the append's,
    # checked below)
    a, b = _lanes(jc), _lanes(pc)
    assert b.keys() <= a.keys() and len(b) > 25
    assert [k for k in b if k != "stats.ob_dropped" and not np.array_equal(a[k], b[k])] == []
    assert len(jpush) == len(ppush)
    for jp, pp in zip(jpush, ppush):
        for x, y in zip(jp, pp):
            assert np.array_equal(np.asarray(x), y.numpy())
    assert (jents == []) == (pents is None)
    if jents:
        assert len(jents) == pents.mask.shape[0]
        for e, je in enumerate(jents):
            for x, y in zip(je, pents):
                assert np.array_equal(np.asarray(x), y[e].numpy())
        assert np.array_equal(np.min(np.stack([np.asarray(u) for u in jused]), axis=0),
                              pused.numpy())
    check_append(jst, jents, jused, pc)
    # the case exercises what it is named for
    d = {k: b[k] - _lanes(_ev_carry_of(pst))[k] for k in b if k.startswith("stats.pkts")}
    if name == "phold_codel_delay":
        assert d["stats.pkts_codel_dropped"].sum() > 0 and ppush[0].mask.any()
    if name.startswith("synthetic"):
        assert d["stats.pkts_unreachable"].sum() > 0 and d["stats.pkts_budget_dropped"].sum() > 0
    if name in ("echo_affine_jitter_loss", "tgen_table_loss", "synthetic_shaped"):
        assert d["stats.pkts_lost"].sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_outbox_append_matches_jax(seed):
    """Random outboxes and a microstep's entry stacks (rows split over two
    events' stacks, in order), with columns past the width B."""
    r = np.random.default_rng(seed)
    h, b, e = 40, 6, 5
    ob_np = (r.integers(0, h, (h, b)).astype(np.int32), r.integers(0, 1 << 40, (h, b)),
             r.integers(0, 1 << 62, (h, b)), r.integers(0, 9, (h, b)).astype(np.int32),
             r.integers(-(1 << 31), 1 << 31, (h, b, 4)).astype(np.int32),
             np.array([r.integers(0, 100)], np.int32))
    cols = r.integers(-1, b + 3, (e, h)).astype(np.int32)
    ent_np = (r.random((e, h)) < 0.7, cols, r.integers(0, h, (e, h)).astype(np.int32),
              r.integers(0, 1 << 40, (e, h)), r.integers(0, 1 << 62, (e, h)),
              r.integers(0, 1 << 18, (e, h)).astype(np.int32),
              r.integers(-(1 << 31), 1 << 31, (e, h, 4)).astype(np.int32))
    jentries = [tuple(jnp.asarray(x[i]) for x in ent_np) for i in range(e)]
    job, jlost = _outbox_append_multi(JaxOutbox(*(jnp.asarray(x) for x in ob_np)), jentries)
    stacks = [EntryStack(*(torch.as_tensor(x[rows]) for x in ent_np))
              for rows in (slice(0, 2), slice(2, e))]
    pob, plost = outbox_append_multi_plain(
        Outbox(*(torch.as_tensor(x) for x in ob_np)), stacks,
        torch.zeros((1,), dtype=torch.int64))
    for x, y in zip(job, pob):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(jlost) == int(plost[0]) > 0
