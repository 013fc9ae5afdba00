"""PyTorch port vs JAX reference: the timer wheel (ops/wheel.py) and the
engine path that uses it (bench config 11's shape).

Ops: every function of the port's ops/wheel.py against the JAX one on
numpy-seeded slabs — the block rule, next time, occupancy and free slots,
pushes masked by the free count, pops below a scalar and below per-host
limits, cancels that hit, miss (another host's key, a stale key, a
masked-off host) and empty full blocks — plus the per-host-limit pops of
the queue (`pop_k`, `bq_pop_min`, flat `pop_min`) and `q_head`.

Engine: config 11 cut to 16 hosts (bench config 6's tgen-TCP on a 2x2
torus, wheel of 4 slots, queue capacity 14 in blocks of 7, K = 1): the
port's report equals the JAX package's — digest, events, every drop
counter, the tgen report and the wheel block — with 4 wheel slots and with
1 (timers spill to the queue); the wheel on and off give the same digest
in the port; a JAX state with a wheel carried across mid-run continues in
the port to the JAX final state; and the network-observatory rider that
bench config 11 carries leaves the JAX digest, events and drops unchanged
(the full-width leg on the card runs without it). Tolerance: exact
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import torus_gml
from shadow_tpu.config.options import ConfigOptions as JaxConfig
from shadow_tpu.ops import events as jev
from shadow_tpu.ops import wheel as jwheel
from shadow_tpu.sim import Simulation as JaxSimulation
from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.core.convert import from_jax_numpy, to_numpy
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import wheel as pwheel
from shadow_tpu_torch.ops.events import Push
from shadow_tpu_torch.sim import Simulation

TIME_MAX = (1 << 63) - 1
ORDER_MAX = (1 << 63) - 1
H, P = 12, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(np_arrays):
    """The same numpy arrays as a JAX tuple and a torch tuple."""
    return (tuple(jnp.asarray(a) for a in np_arrays),
            tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in np_arrays))


def assert_same(jx, px):
    jl, pl = jax.tree.leaves(jx), [x for x in jax.tree.leaves(px, is_leaf=torch.is_tensor)]
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert np.array_equal(np.asarray(a), b.numpy())


def random_wheel(r, slots: int, block: int):
    """A [H, slots] wheel, rows empty to full (full blocks included), with
    time ties; the same wheel in both packages."""
    fill = r.integers(0, slots + 1, H)
    fill[:3] = (0, slots, slots - 1)
    t = np.full((H, slots), TIME_MAX, np.int64)
    order = np.full((H, slots), ORDER_MAX, np.int64)
    live = r.random((H, slots)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    t[live] = r.integers(0, 8, n) * 1000
    order[live] = (1 << 62) | (np.nonzero(live)[0].astype(np.int64) << 40) | r.permutation(n)
    flat = (t, order, r.integers(0, 9, (H, slots)).astype(np.int32),
            r.integers(0, 99, (H, slots, P)).astype(np.int32), np.zeros(H, np.int64))
    jf, pf = both(flat)
    return (jev.bucket_rebuild(jev.EventQueue(*jf), block),
            pev.bucket_rebuild(pev.EventQueue(*pf), block))


def test_resolve_wheel_block_matches_jax():
    for slots, block in ((4, 0), (8, 0), (16, 0), (12, 6), (7, 0), (1, 0), (14, 7)):
        assert pwheel.resolve_wheel_block(slots, block) == jwheel.resolve_wheel_block(slots, block)
    assert pwheel.resolve_wheel_block(4) == 2  # bench config 11: S = 4, block 2
    for bad in ((8, 3), (0, 0)):
        with pytest.raises(ValueError):
            pwheel.resolve_wheel_block(*bad)
    w = pwheel.make_wheel(H, 4, device="cpu")
    assert_same(jwheel.make_wheel(H, 4), w)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("slots,block", [(4, 2), (8, 4), (6, 1)])
def test_wheel_ops_match_jax(seed, slots, block):
    r = np.random.default_rng(seed * 10 + slots)
    jw, pw = random_wheel(r, slots, block)
    for fj, fp in ((jwheel.wheel_next_time, pwheel.wheel_next_time),
                   (jwheel.wheel_len, pwheel.wheel_len), (jwheel.wheel_free, pwheel.wheel_free)):
        assert np.array_equal(np.asarray(fj(jw)), fp(pw).numpy())
    assert_same(jev.q_head(jw), pev.q_head(pw))

    # pushes, masked to the free slots as the engine's router masks them
    free = pwheel.wheel_free(pw).numpy()
    ports = []
    for i in range(2):
        ports.append(((r.random(H) < 0.8) & (free > i), r.integers(0, 9, H) * 1000 + 7,
                      (1 << 62) | (np.arange(H, dtype=np.int64) << 40) | (1 << 30) + i,
                      r.integers(0, 9, H).astype(np.int32),
                      r.integers(0, 99, (H, P)).astype(np.int32)))
    jpush = [both(p)[0] for p in ports]
    ppush = [Push(*both(p)[1]) for p in ports]
    jw = jwheel.wheel_push_many(jw, jpush)
    pw = pwheel.wheel_push_many(pw, ppush)
    assert_same(jw, pw)
    assert int(pw.dropped.sum()) == 0

    # pops below a scalar, then below per-host limits
    jw, jout, jact = jwheel.wheel_pop_min(jw, jnp.int64(4000))
    pw, pout, pact = pwheel.wheel_pop_min(pw, 4000)
    assert_same((jw, jout, jact), (pw, pout, pact))
    lim = np.where(r.random(H) < 0.3, 0, r.integers(0, 9, H) * 1000).astype(np.int64)
    jw, jout, jact = jwheel.wheel_pop_min(jw, jnp.asarray(lim))
    pw, pout, pact = pwheel.wheel_pop_min(pw, torch.as_tensor(lim))
    assert_same((jw, jout, jact), (pw, pout, pact))

    # cancels: a live key of the host, another host's key, a stale key
    order = pw.order.numpy()
    live = pw.t.numpy() != TIME_MAX
    keys = np.full(H, 12345, np.int64)
    for h in range(H):
        cols = np.nonzero(live[h])[0]
        pick = r.random()
        if len(cols) and pick < 0.6:
            keys[h] = order[h, r.choice(cols)]
        elif pick < 0.8:
            keys[h] = order[(h + 1) % H].min()
    mask = r.random(H) < 0.85
    (jm, jk), (pm, pk) = both((mask, keys))
    jw, jfound = jwheel.wheel_cancel(jw, jm, jk)
    pw, pfound = pwheel.wheel_cancel(pw, pm, pk)
    assert_same((jw, jfound), (pw, pfound))
    assert pfound.any() and not pfound.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_pops_with_host_limits_match_jax(seed):
    """pop_k, bq_pop_min and the flat pop_min below an i64[H] limit."""
    r = np.random.default_rng(seed)
    jq, pq = random_wheel(r, 14, 7)  # a queue of config 11's shape
    lim = np.where(r.random(H) < 0.3, 0, r.integers(0, 9, H) * 1000).astype(np.int64)
    jl, pl = jnp.asarray(lim), torch.as_tensor(lim)
    jp, pp = jev.pop_k(jq, jl, 3), pev.pop_k(pq, pl, 3)
    act = pp.active.numpy()
    for f in ("t", "order", "kind", "payload", "active"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(pp, f).numpy())
    # idx is defined on active columns only in the reference
    assert np.array_equal(np.asarray(jp.idx)[act], pp.idx.numpy()[act])
    assert_same(jev.bq_pop_min(jq, jl), pev.bq_pop_min(pq, pl))
    jf = jev.EventQueue(*jq[:5])
    pf = pev.as_flat(pq)
    assert_same(jev.pop_min(jf, jl), pev.pop_min(pf, pl))


def cfg11(wheel: int = 4, loss: float = 0.0, stop: str = "2 s", network: bool = False,
          rounds_per_chunk: int = 40) -> dict:
    """Bench config 11 (config 6 + the wheel, capacity 14 in blocks of 7,
    K = 1) at 16 hosts on a 2x2 torus."""
    gml = torus_gml(2, lat_ms=10)
    if loss:
        gml = gml.replace('latency "10 ms" ]', f'latency "10 ms" packet_loss {loss} ]')
    ex = {"event_queue_capacity": 14, "event_queue_block": 7, "microstep_events": 1,
          "sends_per_host_round": 24, "rounds_per_chunk": rounds_per_chunk}
    if wheel:
        ex["timer_wheel"] = wheel
    c = {
        "general": {"stop_time": stop, "seed": 3, "heartbeat_interval": None},
        "network": {"graph": {"type": "gml", "inline": gml}},
        "experimental": ex,
        "hosts": {f"n{i}": {"count": 4, "network_node_id": i, "processes": [{
            "model": "tgen_tcp",
            "model_args": {"flows": 4, "flow_segs": 12, "cwnd_cap": 8, "mss": 1460,
                           "flow_gap": "20 ms", "tx_batch": 2},
        }]} for i in range(4)},
    }
    if network:
        c["observability"] = {"network": True}
    return c


KEYS = (
    "simulated_seconds", "rounds", "microsteps", "events_processed", "packets_sent",
    "packets_delivered", "packets_lost", "packets_unreachable", "packets_codel_dropped",
    "queue_overflow_dropped", "packets_budget_dropped", "outbox_overflow_dropped",
    "queue_occupancy_hwm", "outbox_send_hwm", "monotonic_violations", "determinism_digest",
    "bucket_cache_rebuilds", "model_report", "wheel",
)
CASES = {"wheel4": dict(wheel=4, loss=0.05), "wheel1_spill": dict(wheel=1, loss=0.05)}


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX report, per-host digests, a mid-run snapshot (after
    one chunk) and the final state."""
    out = {}
    for name, kw in CASES.items():
        sim = JaxSimulation(JaxConfig.from_dict(cfg11(**kw)), world=1)
        sim.state = sim.engine.run_chunk(sim.state, sim.params)
        mid = (jax.tree.map(np.array, jax.device_get(sim.state)), jax.device_get(sim.params))
        rep = sim.run(progress=False)
        out[name] = dict(rep=rep, digests=np.asarray(sim.host_digests()), mid=mid,
                         final=jax.tree.map(np.array, jax.device_get(sim.state)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_config11_engine_matches_jax(reference, case):
    ref = reference[case]
    sim = Simulation(ConfigOptions.from_dict(cfg11(**CASES[case])), device="cpu")
    rep = sim.run(progress=False)
    assert {k: rep[k] for k in KEYS} == {k: ref["rep"][k] for k in KEYS}
    assert np.array_equal(sim.host_digests(), ref["digests"])
    w = rep["wheel"]
    assert w["occupancy_hwm"] > 0 and w["dropped"] == 0
    assert rep["packets_lost"] > 0 and rep["model_report"]["retransmits"] > 0
    if case == "wheel1_spill":
        assert w["slots"] == 1 and w["spilled"] > 0


def test_wheel_on_off_same_digest_in_port(reference):
    off = Simulation(ConfigOptions.from_dict(cfg11(wheel=0, loss=0.05)), device="cpu")
    rep = off.run(progress=False)
    on = reference["wheel4"]["rep"]
    same = ("determinism_digest", "events_processed", "packets_sent", "packets_lost",
            "queue_overflow_dropped", "model_report")
    assert {k: rep[k] for k in same} == {k: on[k] for k in same}
    assert "wheel" not in rep and off.state.wheel is None


@pytest.mark.parametrize("case", list(CASES))
def test_mid_run_carry_over_with_wheel(reference, case):
    """A JAX state with a wheel (and its stats lanes) carried across after
    one chunk: the port continues to the JAX final state, field by field."""
    ref = reference[case]
    mid_st, mid_par = ref["mid"]
    assert mid_st.wheel is not None and 0 < int(mid_st.now)
    sim = Simulation(ConfigOptions.from_dict(cfg11(**CASES[case])), device="cpu")
    # the port's own t=0 build carries the same seeded wheel as the JAX one
    first = JaxSimulation(JaxConfig.from_dict(cfg11(**CASES[case])), world=1)
    a = to_numpy(jax.tree.map(np.array, jax.device_get(first.state)))
    b = to_numpy(sim.state)
    assert "wheel.t" in b and [k for k in a if not np.array_equal(a[k], b[k])] == []
    par, st = from_jax_numpy(mid_par, mid_st, device="cpu")
    while not st.done:
        st = sim.engine.run_chunk(st, par)
    a, b = to_numpy(ref["final"]), to_numpy(st)
    assert a.keys() == b.keys() and "stats.wheel_spilled" in b
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []


def test_network_rider_leaves_jax_digest_unchanged(reference):
    """Bench config 11 carries `observability: {network: true}`. The rider
    is an observer: the port's run with it gives the JAX package's report
    without it (digest, events, every drop counter, the wheel block), held
    port against the JAX reference this module computes; the observed run
    itself is held to JAX's, network{} block included, in
    tests/test_torch_obs.py."""
    rep = Simulation(ConfigOptions.from_dict(cfg11(loss=0.05, network=True)),
                     device="cpu").run(progress=False)
    base = reference["wheel4"]["rep"]
    same = ("determinism_digest", "events_processed", "packets_sent", "packets_delivered",
            "packets_lost", "packets_codel_dropped", "queue_overflow_dropped",
            "packets_budget_dropped", "outbox_overflow_dropped", "wheel", "model_report")
    assert {k: rep[k] for k in same} == {k: base[k] for k in same}
    assert "network" in rep and "network" not in base  # the rider was on, and only there
    assert rep["network"]["event_classes"]["total"] == base["events_processed"]
