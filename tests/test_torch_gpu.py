"""The port's CUDA kernels K1-K13 against their plain PyTorch versions, on
the card. Marked `gpu`; without a CUDA device each test skips.

Run on a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: the repository's conftest imports JAX, which a GPU machine
may lack; this file imports neither JAX nor the JAX package.)

Small numpy-seeded slabs: empty, sparse, mixed, nearly full and full queues,
heavy time ties, merge segments past the insert cap; for the per-event chain
(K9-K11) the random carries, events and handler outputs of
`shadow_tpu_torch.testing.chain_case`, with port fields as the models hand
them over (columns of the K-way peek, broadcasts) and K9 taking several
events' entry stacks at once; for the exchange merges (K4, K13) the queues
and [H, B] outboxes of `shadow_tpu_torch.testing.merge_case` read through a
column limit. A geared run on the card (where the kernels write the state
in place) checks that a snapshot survives the chunk and repeated restores.
Tolerance: exact equality — every output is an
integer, a bool, or an integer made from float32/float64 math. chip_smoke.py
repeats the check at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.core.engine import make_empty_outbox
from shadow_tpu_torch.ops import chain as pchain
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import merge as pmerge
from shadow_tpu_torch.ops import wheel as pwheel
from shadow_tpu_torch.testing import (
    MERGE_LOADS,
    chain_case,
    clone_carry,
    flat_tensors,
    merge_case,
    merge_fits,
)

H, C, P = 24, 16, 4
TIME_MAX = (1 << 63) - 1
FILLS = {
    "empty": lambda r: np.zeros(H, int),
    "sparse": lambda r: r.integers(0, 4, H),
    "mixed": lambda r: r.integers(0, C + 1, H),
    "nearly_full": lambda r: C - r.integers(0, 3, H),
    "full": lambda r: np.full(H, C),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def slab(seed: int, fill_kind: str, dev) -> pev.EventQueue:
    r = np.random.default_rng(seed)
    fill = FILLS[fill_kind](r)
    t = np.full((H, C), TIME_MAX, np.int64)
    order = np.full((H, C), pev.ORDER_MAX, np.int64)
    live = r.random((H, C)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    t[live] = r.integers(0, 6, n) * 1000  # few distinct times: many ties
    hosts = np.nonzero(live)[0].astype(np.int64)
    order[live] = (r.integers(0, 2, n) << 62) | (hosts << 40) | r.permutation(n)
    kind = r.integers(0, 1 << 18, (H, C)).astype(np.int32)
    payload = r.integers(-(1 << 31), 1 << 31, (H, C, P)).astype(np.int32)
    dropped = r.integers(0, 3, H).astype(np.int64)
    return pev.EventQueue(*(torch.as_tensor(a, device=dev)
                            for a in (t, order, kind, payload, dropped)))


def clone(q: pev.EventQueue) -> pev.EventQueue:
    return pev.EventQueue(*(x.clone() for x in q))


def assert_all_equal(got, want):
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), f"output {i} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
def test_queue_kernels_match_plain(dev, fill):
    q = slab(3, fill, dev)
    assert torch.equal(pev.next_time(q), pev.next_time_plain(q.t))
    qa, eva, acta = pev.pop_min(clone(q), 2500)
    qb, evb, actb = pev.pop_min_plain(clone(q), 2500)
    assert_all_equal([*qa, *eva, acta], [*qb, *evb, actb])
    r = np.random.default_rng(5)
    for n_ports in (1, 2, 3):
        pushes = [pev.Push(*(torch.as_tensor(a, device=dev) for a in (
            r.random(H) < 0.7,
            r.integers(0, 1 << 40, H),
            r.integers(0, 1 << 62, H),
            r.integers(0, 1 << 18, H).astype(np.int32),
            r.integers(-(1 << 31), 1 << 31, (H, P)).astype(np.int32),
        ))) for _ in range(n_ports)]
        assert_all_equal(pev.push_many(clone(q), pushes), pev.push_many_plain(clone(q), pushes))


@pytest.mark.gpu
@pytest.mark.parametrize("shed_urgency", [True, False])
@pytest.mark.parametrize("fill,n_valid,hot", [
    ("mixed", 0, 0), ("sparse", 40, 60), ("full", 100, 0), ("nearly_full", 150, 20),
])
def test_merge_kernel_matches_plain(dev, fill, n_valid, hot, shed_urgency):
    q = slab(7, fill, dev)
    r = np.random.default_rng(n_valid + hot)
    n = H * 12
    dst = r.integers(0, H, n).astype(np.int32)
    dst[:hot] = 5
    valid = np.zeros(n, bool)
    valid[r.permutation(n)[:n_valid]] = True
    valid[:hot] = True
    rows = [torch.as_tensor(a, device=dev) for a in (
        dst, r.integers(10, 16, n) * 1000,
        r.permutation(n).astype(np.int64) | (r.integers(0, H, n) << 40),
        r.integers(0, 1 << 18, n).astype(np.int32),
        r.integers(-(1 << 31), 1 << 31, (n, P)).astype(np.int32), valid)]
    for max_inserts in (C, 5):
        got = pmerge.merge_flat_events(clone(q), *rows, max_inserts, shed_urgency=shed_urgency)
        want = pmerge.merge_flat_events_plain(clone(q), *rows, max_inserts,
                                              shed_urgency=shed_urgency)
        assert_all_equal(got, want)


def bucketed(q: pev.EventQueue, block: int) -> pev.BucketQueue:
    return pev.BucketQueue(*q, *pev.block_minima_plain(q.t, q.order, q.t.shape[1] // block))


def pushes_with_reserve(r, n_ports: int, dev, h: int = H, reserve_hi: int = 4):
    return [pev.Push(*(torch.as_tensor(a, device=dev) for a in (
        r.random(h) < 0.7,
        r.integers(0, 8, h) * 1000 + 500,
        (1 << 62) | (np.arange(h, dtype=np.int64) << 40) | r.integers(0, 1 << 30, h),
        r.integers(0, 1 << 18, h).astype(np.int32),
        r.integers(-(1 << 31), 1 << 31, (h, P)).astype(np.int32),
        r.integers(0, reserve_hi, h).astype(np.int32),
    ))) for _ in range(n_ports)]


def wide_slab(seed: int, cap: int, dev) -> pev.EventQueue:
    """A [H, cap] slab (rows empty to full) for the kernels' loops over
    capacities past one warp."""
    r = np.random.default_rng(seed)
    fill = r.integers(0, cap + 1, H)
    fill[:3] = (0, cap, cap - 1)
    t = np.full((H, cap), TIME_MAX, np.int64)
    order = np.full((H, cap), pev.ORDER_MAX, np.int64)
    live = r.random((H, cap)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    t[live] = r.integers(0, 6, n) * 1000
    order[live] = (np.nonzero(live)[0].astype(np.int64) << 40) | r.permutation(n)
    return pev.EventQueue(*(torch.as_tensor(a, device=dev) for a in (
        t, order, r.integers(0, 9, (H, cap)).astype(np.int32),
        r.integers(0, 9, (H, cap, P)).astype(np.int32), np.zeros(H, np.int64))))


@pytest.mark.gpu
@pytest.mark.parametrize("cap,block", [(C, 4), (28, 7), (64, 8), (128, 64)])
@pytest.mark.parametrize("fill", FILLS)
def test_batch_and_bucket_kernels_match_plain(dev, fill, cap, block):
    """K5 pop_k, K6 clear_popped (flat and bucketed), K7 bq_push_many, K8
    block_minima and K3 with reserves (past 32 ports too, where the wrapper
    launches in chunks)."""
    q = slab(11, fill, dev) if cap == C else wide_slab(11 + cap, cap, dev)
    r = np.random.default_rng(cap + block)
    for x, y in zip(pev.block_minima(q.t, q.order, cap // block),
                    pev.block_minima_plain(q.t, q.order, cap // block)):
        assert torch.equal(x, y)
    for k in (1, 4, min(cap, 32)):
        for limit in (2500, TIME_MAX):
            got = pev.pop_k(q, limit, k)
            assert_all_equal(got, pev.pop_k_plain(q, limit, k))
            m = torch.minimum(torch.as_tensor(r.integers(0, k + 1, H).astype(np.int32), device=dev),
                              got.active.sum(dim=1, dtype=torch.int32))
            for queue in (clone(q), bucketed(clone(q), block)):
                want = pev.clear_popped_plain(type(queue)(*(x.clone() for x in queue)), got, m)
                assert_all_equal(pev.clear_popped(queue, got, m), want)
    for n_ports in (1, 12, 40):
        pushes = pushes_with_reserve(r, n_ports, dev)
        assert_all_equal(pev.push_many(clone(q), pushes), pev.push_many_plain(clone(q), pushes))
        bq = bucketed(clone(q), block)
        want = pev.push_many_plain(type(bq)(*(x.clone() for x in bq)), pushes)
        assert_all_equal(pev.bq_push_many(bq, pushes), want)


@pytest.mark.gpu
@pytest.mark.parametrize("cap,block", [(C, 4), (4, 2), (14, 7)])
@pytest.mark.parametrize("fill", FILLS)
def test_per_host_limit_pop_matches_plain(dev, fill, cap, block):
    """K5 with an i64[H] limit (the wheel's merged pop), on both queue
    types, and the flat pop_min that runs as K5 + K6 under one."""
    q = slab(13, fill, dev) if cap == C else wide_slab(13 + cap, cap, dev)
    r = np.random.default_rng(cap)
    limits = torch.as_tensor(np.where(r.random(H) < 0.3, 0, r.integers(0, 7, H) * 1000),
                             device=dev)
    for k in (1, min(cap, 4)):
        assert_all_equal(pev.pop_k(q, limits, k), pev.pop_k_plain(q, limits, k))
    got = pev.pop_min(clone(q), limits)
    want = pev.pop_min_plain(clone(q), limits)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    bq = bucketed(clone(q), block)
    got = pev.bq_pop_min(type(bq)(*(x.clone() for x in bq)), limits)
    want = pev.bq_pop_min(type(bq)(*(x.cpu() for x in bq)), limits.cpu())
    assert_all_equal(flat_tensors(got), [x.to(dev) for x in flat_tensors(want)])


@pytest.mark.gpu
@pytest.mark.parametrize("slots,block", [(4, 2), (8, 4), (64, 8)])
@pytest.mark.parametrize("fill", FILLS)
def test_wheel_cancel_matches_plain(dev, fill, slots, block):
    """K12: hits, misses on live keys of other hosts, stale keys, masked-off
    hosts, full blocks."""
    q = slab(17, fill, dev) if slots == C else wide_slab(17 + slots, slots, dev)
    w = bucketed(q, block)
    r = np.random.default_rng(slots)
    live = (w.t != TIME_MAX).cpu().numpy()
    keys = np.full(H, -5, np.int64)
    order = w.order.cpu().numpy()
    for i in range(H):
        cols = np.nonzero(live[i])[0]
        if len(cols) and r.random() < 0.7:
            keys[i] = order[i, r.choice(cols)]
        elif r.random() < 0.5:
            keys[i] = order[(i + 1) % H, 0]  # another host's key: a miss
    mask = torch.as_tensor(r.random(H) < 0.8, device=dev)
    keys = torch.as_tensor(keys, device=dev)
    want = pwheel.wheel_cancel_plain(type(w)(*(x.clone() for x in w)), mask, keys)
    got = pwheel.wheel_cancel(w, mask, keys)
    assert_all_equal(flat_tensors(got), flat_tensors(want))


CHAIN_CASES = {
    "anchor": dict(n_push=1, sends=((1, False, False),), route="const"),
    "cfg6": dict(n_push=2, sends=((2, True, True),), route="affine", stride=4),
    "echo_jitter": dict(n_push=1, sends=((1, False, False), (1, False, False)),
                        route="node_of", jitter=True),
    "bursts_table": dict(n_push=3, sends=((1, False, False), (3, True, True), (2, False, True)),
                         route="table", jitter=True, budget=3),
    "unshaped": dict(n_push=2, sends=((2, True, False),), route="const", shaping=False),
    "strided_fields": dict(n_push=2, sends=((1, False, False), (2, True, True)),
                           route="affine", stride=3),
}


def strided(out, h: int):
    """The handler output with its port fields laid out as the models hand
    them over: [H] lanes as columns of a [H, 3] plane, a payload as rows of
    a wider plane, a broadcast size, and an int64 kind (converted)."""
    def col(x):
        wide = torch.zeros((h, 3) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        wide[:, 1] = x
        return wide[:, 1]

    pushes = tuple(p._replace(t=col(p.t), mask=col(p.mask), kind=p.kind.to(torch.int64))
                   for p in out.pushes)
    sends = tuple(sp._replace(dst=col(sp.dst), payload=col(sp.payload),
                              size_bytes=sp.size_bytes[:1].expand(h),
                              count=None if sp.count is None else col(sp.count))
                  for sp in out.sends)
    return out._replace(pushes=pushes, sends=sends)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_chain_kernels_match_plain(dev, name, seed):
    """K10 event_ingress, K11 event_egress and K9 outbox_append against
    their plain versions on the same card inputs (carries cloned: the
    kernels update them in place)."""
    case = chain_case(seed, 150, dev, **CHAIN_CASES[name])
    cfg, params, ev, active = case["cfg"], case["params"], case["ev"], case["active"]
    c_k, ing_k = pchain.event_ingress(clone_carry(case["carry"]), params, cfg, ev, active)
    c_p, ing_p = pchain.event_ingress_plain(clone_carry(case["carry"]), params, cfg, ev, active)
    assert_all_equal(flat_tensors([c_k, ing_k]), flat_tensors([c_p, ing_p]))

    out, dispatch, we = case["out"], case["dispatch"], case["window_end"]
    if name == "strided_fields":
        out = strided(out, 150)
        assert not out.pushes[0].t.is_contiguous()
    got = pchain.event_egress(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we, out)
    want = pchain.event_egress_plain(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we,
                                     out)
    assert_all_equal(flat_tensors(got), flat_tensors(want))

    # K9 on a microstep's entry stacks (three events, the carry threaded
    # through egress), with some columns moved past the outbox width
    # (counted lost) and an outbox already part filled
    b = cfg.sends_per_host_round
    stacks, cc = [], clone_carry(case["carry"])
    for _ in range(3):
        cc, _, entries, _ = pchain.event_egress_plain(cc, params, cfg, ev.t, dispatch, we, out)
        stacks.append(entries._replace(
            col=torch.where(entries.col % 5 == 0, entries.col + b, entries.col)))
    ob = make_empty_outbox(150, b, dev)
    filled = torch.as_tensor(np.random.default_rng(seed).random((150, b)) < 0.3, device=dev)
    ob = ob._replace(t=torch.where(filled, 7, ob.t))
    lost0 = torch.tensor([3], dtype=torch.int64, device=dev)
    got = pchain.outbox_append_multi(type(ob)(*(x.clone() for x in ob)), stacks, lost0.clone())
    want = pchain.outbox_append_multi_plain(ob, stacks, lost0)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    assert int(want[1]) > 3  # columns past the budget were counted lost


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_egress_without_send_ports_matches_plain(dev, seed):
    """A model with pushes only (the timer model's handler): K11 gets no
    send port, no entry stack and no used-latency lane, and equals its plain
    version."""
    case = chain_case(seed, 150, dev, n_push=1, sends=(), route="const")
    cfg, params, ev = case["cfg"], case["params"], case["ev"]
    out, dispatch, we = case["out"], case["dispatch"], case["window_end"]
    got = pchain.event_egress(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we, out)
    want = pchain.event_egress_plain(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we,
                                     out)
    assert got[2] is None and got[3] is None and want[2] is None
    assert_all_equal(flat_tensors(got), flat_tensors(want))


@pytest.mark.gpu
def test_outbox_append_chunks_past_16_stacks(dev):
    """K9 over more entry stacks than one launch takes (the wrapper
    launches per 16): the same outbox and loss count as the plain version,
    and one launch per chunk."""
    case = chain_case(5, 150, dev, **CHAIN_CASES["cfg6"])
    cfg, params, ev = case["cfg"], case["params"], case["ev"]
    stacks, cc = [], clone_carry(case["carry"])
    for _ in range(20):
        cc, _, entries, _ = pchain.event_egress_plain(cc, params, cfg, ev.t, case["dispatch"],
                                                      case["window_end"], case["out"])
        stacks.append(entries._replace(col=torch.where(entries.col % 3 == 0, entries.col + 8,
                                                       entries.col)))
    ob = make_empty_outbox(150, cfg.sends_per_host_round, dev)
    lost0 = torch.zeros((1,), dtype=torch.int64, device=dev)
    before = pchain.KERNELS["outbox_append"].launches
    got = pchain.outbox_append_multi(type(ob)(*(x.clone() for x in ob)), stacks, lost0.clone())
    assert pchain.KERNELS["outbox_append"].launches - before == 2
    want = pchain.outbox_append_multi_plain(ob, stacks, lost0)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    assert int(want[1]) > 0  # columns past the budget were counted lost


@pytest.mark.gpu
@pytest.mark.parametrize("urgency", [True, False], ids=["urgency", "append"])
@pytest.mark.parametrize("gc", [1, 3, 6])
@pytest.mark.parametrize("load", MERGE_LOADS)
def test_merge_kernels_on_sliced_outbox_match_plain(dev, load, gc, urgency):
    """K4 and K13 read the first gc columns of a [48, 6] outbox in place:
    the same queue planes and drops as their plain versions, and one K13
    launch per call whichever branch it takes."""
    q, ob = merge_case(31 + gc, 48, 8, 6, gc, load)
    rows = [torch.as_tensor(a, device=dev) for a in ob]
    for r_cap in (8, 5):
        for fn, plain in ((pmerge.merge_flat_events, pmerge.merge_flat_events_plain),
                          (pmerge.merge_scatter_free, pmerge.merge_scatter_free_plain)):
            queue = pev.EventQueue(*(torch.as_tensor(a, device=dev) for a in q))
            before = pmerge.KERNELS["merge_scatter"].launches
            got = fn(clone(queue), *rows, None, r_cap, urgency, cols=gc)
            want = plain(clone(queue), *rows, None, r_cap, urgency, cols=gc)
            assert_all_equal(got, want)
            assert pmerge.KERNELS["merge_scatter"].launches - before == (
                fn is pmerge.merge_scatter_free)
    assert merge_fits(q, ob, gc, 5) == (load in ("fit", "empty"))


@pytest.mark.gpu
def test_snapshot_survives_in_place_kernels_on_the_card(dev):
    """A chunk on the card writes the queue, outbox and carry lanes in place:
    the snapshot taken before it is intact afterwards, and two replays from
    it give the same state."""
    import yaml

    from shadow_tpu_torch.config.options import ConfigOptions
    from shadow_tpu_torch.core.checkpoint import restore_snapshot, snapshot_state
    from shadow_tpu_torch.core.convert import to_numpy
    from shadow_tpu_torch.sim import Simulation

    cfg = yaml.safe_load("""
general: {stop_time: 2 s, seed: 3}
network: {graph: {type: 1_gbit_switch}}
experimental: {event_queue_capacity: 8, sends_per_host_round: 6, rounds_per_chunk: 4,
               merge_gears: auto}
hosts:
  h:
    count: 40
    processes: [{model: phold, model_args: {population: 3, mean_delay: 30 ms}}]
""")
    sim = Simulation(ConfigOptions.from_dict(cfg), device=dev)
    eng, par = sim.engine, sim.params
    st = eng.run_chunk(sim.state, par)
    snap = snapshot_state(st)
    ref = to_numpy(snap)
    eng.run_chunk_gear(st, par, 1)  # consumes st in place
    a = eng.run_chunk_gear(restore_snapshot(snap), par, 3)
    b = eng.run_chunk_gear(restore_snapshot(snap), par, 3)
    got = to_numpy(snap)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    ta, tb = to_numpy(a), to_numpy(b)
    assert all(np.array_equal(ta[k], tb[k]) for k in ta)
