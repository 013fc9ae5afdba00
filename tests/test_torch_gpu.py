"""The port's CUDA kernels K1-K36 against their plain PyTorch versions, on
the card. Marked `gpu`; without a CUDA device each test skips.

Run on a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: the repository's conftest imports JAX, which a GPU machine
may lack; this file imports neither JAX nor the JAX package.)

Small numpy-seeded slabs: empty, sparse, mixed, nearly full and full queues,
heavy time ties, merge segments past the insert cap; for the per-event chain
(K10, K11; K11 appends its sends to the outbox) the random carries, events
and handler outputs of `shadow_tpu_torch.testing.chain_case`, with port
fields as the models hand them over (columns of the K-way peek, broadcasts),
K11 over four event columns in turn into one outbox (a K-way microstep),
narrower than the budget (sends lost past it); for the exchange merges (K4, K13) the queues
and [H, B] outboxes of `shadow_tpu_torch.testing.merge_case` read through a
column limit. A geared run on the card (where the kernels write the state
in place) checks that a snapshot survives the chunk and repeated restores.
The fluid plane's kernels (K14-K16) and fluid-on K11 take the random
inputs of `shadow_tpu_torch.testing.fluid_case` (class counts up to 64,
both host -> link maps, an empty window, the done-round); their float64
outputs are compared bit for bit. The model handlers' kernels (K17-K22)
take `shadow_tpu_torch.testing.handler_case` at full width (H = 10,000;
gossip at bench config 3's 100,000 hosts, circuit at config 4's 7,500),
the event also a column of a K = 4 peek, over several chained calls on
one state; the CPU model's lanes (K1's busy floor, K10's execution-time
rewrite and busy update) and the merge-row bound of K4 and K13 (rows
shed at several bounds, both shed modes, a sliced outbox) against their
plain versions; PHOLD's `exp_delay` through K18's device function is compared on
every one of the 2^24 inputs the model can draw. The fault plane: K23 on
`shadow_tpu_torch.testing.fault_case` windows (times at their edges, a
strided time lane), K1's fault floor, K10's hold and clear lanes with the
second digest and K11's link-fault lane on `chain_case` inputs with crash
and loss windows; the integrity sentinel's K24 on
`shadow_tpu_torch.testing.integrity_case` rounds that break each invariant
in turn (flat, bucketed, with the wheel). The pressure plane: K25
(`migrate_queue`, `migration_fits`, `migrate_wheel`) on
`shadow_tpu_torch.testing.migrate_case` slabs (growth, shrink with
compaction, flat and bucketed, wider than a warp), K26 (`pressure_total`)
on random lanes. The observatories: K27 (`trace_round`) on
`shadow_tpu_torch.testing.trace_case` rounds (flat and bucketed head
planes, crash windows, a ring that wraps), K28 (`flow_append`) on
`shadow_tpu_torch.testing.flow_case` columns (one denser than the ring:
the wrap rule), K10's event-class lane on `chain_case` inputs and K17's
flow-record lanes on `handler_case` inputs. The exchange across ranks: K29
(`dshard_pack`) on `shadow_tpu_torch.testing.outbox_case` outboxes (rows
that fit, a shed, empty shards, one shard, padded hosts, a gear slice, many
sort tiles, the 40k leg's shard width), K30 (`exchange_unpack`) on the
blocks of four shards and on a gather buffer, and K10, K11, K14 and K16 at
a shard whose hosts start past 0 (`host_base`). The ensemble plane: K31
(`replica_window`, one cluster of blocks per replica; round and loop-test
modes, static and dynamic runahead, with and without per-row valves, at
1 to 25,000 rows and 1 to 64 replicas, aligned and not) and K32
(`replica_fold`) on `shadow_tpu_torch.testing.ensemble_case` lanes, and K2
(per-row limits), K4, K10, K11 and K13 over replicas (`replica_chain_case`,
`replica_merge_case`; K11 also at 150 and 4,097 hosts per replica, warps
that straddle two replicas) with a frozen replica whose rows must come out
unchanged. The co-simulation bridge: K33 (`hybrid_handle`) on
`shadow_tpu_torch.testing.hybrid_case` rings that are empty, partly full,
full (overflow into cap_lost) and random, K34 (`mixed_plane`, both modes,
inside the mixed handler) on `mixed_case` with native tables all, none and
mixed over udp_echo (no sanitising) and gossip (sanitising), and K35
(`guarded_window`) on `guarded_case` lanes (a probe that fires on the first
round and one that never fires, stop lanes grown and not), at the mixed
leg's 4,096 hosts. The one-event microstep's pop and ingress, K36
(`pop_ingress`), on `shadow_tpu_torch.testing.pop_ingress_case` queues
(heavy time ties, empty and full rows, 13 to 1,024 slots, odd and even,
150 and 4,097 hosts) under one limit, per-host limits and per-row limits, with each
ingress lane on, against the plain pop followed by the plain ingress, and
per-host limits against K5 + K6 at k = 1.
Tolerance: exact equality — every output is an
integer, a bool, or an integer made from float32/float64 math. chip_smoke.py
repeats the check at the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shadow_tpu_torch.net import fluid as pfl
from shadow_tpu_torch.ops import chain as pchain
from shadow_tpu_torch.ops import ensemble as pens
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import merge as pmerge
from shadow_tpu_torch.ops import wheel as pwheel
from shadow_tpu_torch.testing import (
    MERGE_LOADS,
    chain_case,
    clone_carry,
    clone_ctx,
    flat_tensors,
    HANDLER_MODELS,
    COSIM_FILLS,
    NATIVE_PATTERNS,
    fluid_case,
    guarded_case,
    handler_diff,
    hybrid_case,
    mixed_case,
    handler_steps,
    merge_case,
    merge_fits,
    ensemble_case,
    replica_chain_case,
    replica_merge_case,
    POP_LIMITS,
    pop_ingress_case,
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
    types, and the flat pop_min under one (K2 reading the limits)."""
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
    """K10 event_ingress and K11 event_egress against their plain versions
    on the same card inputs (carries cloned: the kernels update them in
    place); K11 with its outbox append and used-latency fold, against the
    plain egress followed by the plain append and fold."""
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
    want = pchain.event_egress_append_plain(clone_carry(case["carry"]), params, cfg, ev.t,
                                            dispatch, we, out)
    assert_all_equal(flat_tensors(got), flat_tensors(want))


def egress_columns(case, n_cols: int, out=None):
    """K11 and its plain version over `n_cols` event columns in turn (a
    K-way microstep: the carry, its send cursor and its outbox threaded
    from one column to the next). Returns (kernel carry, plain carry)."""
    cfg, params, ev = case["cfg"], case["params"], case["ev"]
    out = case["out"] if out is None else out
    args = (params, cfg, ev.t, case["dispatch"], case["window_end"], out)
    c_k, c_p = clone_carry(case["carry"]), clone_carry(case["carry"])
    for _ in range(n_cols):
        c_k, _ = pchain.event_egress(c_k, *args)
        c_p, _ = pchain.event_egress_append_plain(c_p, *args)
    return c_k, c_p


@pytest.mark.gpu
@pytest.mark.parametrize("ob_cols", [None, 2], ids=["budget_wide", "past_b"])
@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_egress_append_columns_match_plain(dev, name, ob_cols):
    """Merged K11 over four event columns into one outbox (the carry's
    budget wide, or 2 columns wide, so that sends past it are counted lost)
    against the plain egress, append and fold per column: the outbox, its
    count, ob_dropped and min_used_lat."""
    case = chain_case(7, 150, dev, **CHAIN_CASES[name], ob_cols=ob_cols)
    out = strided(case["out"], 150) if name == "strided_fields" else None
    c_k, c_p = egress_columns(case, 4, out)
    assert_all_equal(flat_tensors(c_k), flat_tensors(c_p))
    c0 = case["carry"]
    assert int(c_p.outbox.count[0]) > int(c0.outbox.count[0])
    assert int(c_p.min_used_lat) < int(c0.min_used_lat)
    if ob_cols is not None:
        assert int(c_p.stats.ob_dropped[0]) > 0  # sends past B were counted lost
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_egress_without_send_ports_matches_plain(dev, seed):
    """A model with pushes only (the timer model's handler): K11 gets no
    send port, leaves the outbox, its counters and min_used_lat alone, and
    equals its plain version."""
    case = chain_case(seed, 150, dev, n_push=1, sends=(), route="const")
    cfg, params, ev = case["cfg"], case["params"], case["ev"]
    out, dispatch, we = case["out"], case["dispatch"], case["window_end"]
    got = pchain.event_egress(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we, out)
    want = pchain.event_egress_append_plain(clone_carry(case["carry"]), params, cfg, ev.t,
                                            dispatch, we, out)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    assert_all_equal(flat_tensors(got[0].outbox) + [got[0].min_used_lat],
                     flat_tensors(case["carry"].outbox) + [case["carry"].min_used_lat])


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


def bits(xs) -> list:
    """Tensors with every float viewed as the integer of its bits."""
    out = []
    for x in xs:
        if x.dtype == torch.float64:
            x = x.view(torch.int64)
        elif x.dtype == torch.float32:
            x = x.view(torch.int32)
        out.append(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,affine,dt_zero,done", [
    (4, 100, True, False, False),
    (1, 3, False, False, False),
    (27, 16, True, False, False),
    (33, 256, False, False, False),
    (64, 1024, True, False, False),
    (64, 40, True, True, False),
    (5, 9, False, False, True),
])
def test_fluid_kernels_match_plain(dev, k, n, affine, dt_zero, done):
    c = fluid_case(k * 100 + n, 64, n, k, dev, affine=affine, dt_zero=dt_zero, done=done)
    cfg, fp, st = c["cfg"], c["fp"], c["st"]
    ob = (c["ob_dst"], c["ob_t"], c["ob_payload"])
    got = pfl.fluid_fg_link_bytes(cfg, *ob, c["node_of"])
    want = pfl.fluid_fg_link_bytes_plain(cfg, *ob, c["node_of"])
    assert_all_equal([got], [want])
    args = (c["fg"], c["now"], c["window_end"], done)
    got = pfl.fluid_advance(cfg, fp, clone_carry(st), *args, c["bg_bytes"].clone(),
                            c["bg_dropped"].clone())
    want = pfl.fluid_advance_plain(cfg, fp, st, *args, c["bg_bytes"], c["bg_dropped"])
    assert_all_equal(bits(flat_tensors(got)), bits(flat_tensors(want)))
    nodes = pfl.host_nodes(cfg, c["node_of"], cfg.num_hosts)
    got = pfl.fluid_host_effects(cfg, fp, st, c["node_of"])
    want = pfl.fluid_host_effects_plain(cfg, fp, st, nodes)
    assert_all_equal(bits(got), bits(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("loss_max", [0.0, 0.3])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "node_of"])
def test_fluid_egress_matches_plain(dev, affine, loss_max):
    """K11 with the fluid lanes: the counter draw (loss_max > 0) and the
    latency inflation, against the plain egress."""
    case = fluid_case(7, 64, 6, 4, dev, affine=affine, loss_max=loss_max)["chain"]
    cfg, params, e, c0 = case["cfg"], case["params"], case["ev"], case["carry"]
    args = (params, cfg, e.t, case["dispatch"], case["window_end"], case["out"],
            case["fluid_fx"])
    got = pchain.event_egress(clone_carry(c0), *args)
    want = pchain.event_egress_append_plain(clone_carry(c0), *args)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    torch.cuda.synchronize()


# each model's full width: its bench config's host count
HANDLER_WIDTH = {"gossip": 100_000, "circuit": 7_500}


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("model", HANDLER_MODELS)
def test_handler_kernels_match_plain(dev, model, stride):
    """K17-K22 at full width (H = 10,000; gossip 100,000, circuit 7,500)
    against `handle_plain` on the card, bit for bit and dtype for dtype,
    over three chained calls: each call's state and RNG lanes (which the
    kernel updates in place) feed the next call of the same side, with a
    fresh event each time."""
    from shadow_tpu_torch.models import KERNELS

    n0 = {k: v.launches for k, v in KERNELS.items()}
    prev = None
    width = HANDLER_WIDTH.get(model, 10_000)
    for step, (got, want) in enumerate(handler_steps(model, 5, width, dev, stride=stride)):
        assert handler_diff(got, want) == [], step
        assert prev is None or (got.state is prev.state and got.rng.s is prev.rng.s)  # in place
        prev = got
    torch.cuda.synchronize()
    ran = {k: v.launches - n0[k] for k, v in KERNELS.items()}
    assert sum(ran.values()) == 3 and len([v for v in ran.values() if v]) == 1


@pytest.mark.gpu
def test_phold_exp_delay_kernel_on_every_input(dev):
    """K18's exponential draw on all 2^24 uniforms the model can draw, at a
    mean of 2^47 ns (each delay then holds every bit of the log: x * 2^47 is
    exact and integral) and at 100 ms, against `exp_delay` on the CPU."""
    from shadow_tpu_torch.models import phold

    u = torch.arange(1 << 24, dtype=torch.int64).to(torch.float32) * (1.0 / (1 << 24))
    for mean in (1 << 47, 100_000_000):
        want = phold.exp_delay(u, torch.full((1,), mean, dtype=torch.int64).expand(1 << 24))
        m = torch.full((1,), mean, dtype=torch.int64, device=dev).expand(1 << 24)
        got = phold.exp_delay_kernel(u.to(dev), m).cpu()
        assert int((got != want).sum()) == 0, mean


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
def test_busy_floor_next_time_matches_plain(dev, fill):
    """K1 with the CPU model's floor lane, over the slab and over the
    bucketed queue's block caches: max(row minimum, busy) where the row is
    not empty, TIME_MAX where it is."""
    q = slab(11, fill, dev)
    r = np.random.default_rng(12)
    floor = torch.as_tensor(np.select([r.random(H) < 0.3, r.random(H) < 0.5],
                                      [0, r.integers(0, 6, H) * 1000], 1 << 62), device=dev)
    assert torch.equal(pev.next_time(q, floor), pev.next_time_plain(q.t, floor))
    bq = pev.bucket_rebuild(q, 4)
    assert torch.equal(pev.bq_next_time(bq, floor), pev.next_time_plain(bq.bt, floor))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["anchor", "cfg6"])
def test_ingress_busy_lane_matches_plain(dev, name, seed):
    """K10 under the CPU model: the event's time lane rewritten in place to
    max(t, busy) where active (a column of the K-way peek on config 6's
    shape), the busy horizon moved to that plus the delay, and every other
    output as the plain version gives it."""
    from shadow_tpu_torch.ops.events import Event

    case = chain_case(seed, 150, dev, **CHAIN_CASES[name], cpu_delay=3_000_000)
    cfg, params, ev, active = case["cfg"], case["params"], case["ev"], case["active"]

    def fresh_event():  # K10 writes the time lane in place: a copy per side
        k = ev.t.stride(0)
        wide = torch.zeros((150, k), dtype=torch.int64, device=dev)
        wide[:, -1] = ev.t
        return Event(wide[:, -1], ev.order, ev.kind, ev.payload)

    got = pchain.event_ingress(clone_carry(case["carry"]), params, cfg, fresh_event(), active)
    want = pchain.event_ingress_plain(clone_carry(case["carry"]), params, cfg, fresh_event(),
                                      active)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    moved = want[1].t != ev.t
    assert bool(moved.any()) and bool((want[0].cpu_busy_until != case["carry"].cpu_busy_until)
                                      .any())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("urgency", [True, False], ids=["urgency", "append"])
@pytest.mark.parametrize("gc", [3, 6])
@pytest.mark.parametrize("load", MERGE_LOADS)
def test_merge_rows_kernels_match_plain(dev, load, gc, urgency):
    """K4 and K13 under the merge-row bound, on the first gc columns of a
    [48, 6] outbox: bounds that shed most rows, some rows and none, each
    the same queue planes and drops as the plain versions."""
    q, ob = merge_case(71 + gc, 48, 8, 6, gc, load)
    rows = [torch.as_tensor(a, device=dev) for a in ob]
    n_valid = int(((ob[1][:, :gc] != TIME_MAX) & (ob[0][:, :gc] < 48)).sum())
    shed = 0
    for merge_rows in (30, 49 + n_valid // 2, 49 + n_valid, 1 << 20):
        for fn, plain in ((pmerge.merge_flat_events, pmerge.merge_flat_events_plain),
                          (pmerge.merge_scatter_free, pmerge.merge_scatter_free_plain)):
            queue = pev.EventQueue(*(torch.as_tensor(a, device=dev) for a in q))
            got = fn(clone(queue), *rows, None, 8, urgency, cols=gc, merge_rows=merge_rows)
            want = plain(clone(queue), *rows, None, 8, urgency, cols=gc, merge_rows=merge_rows)
            assert_all_equal(got, want)
            shed += int((want.dropped - queue.dropped).sum())
    assert load == "empty" or shed > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_fault_down_resume_kernel_matches_plain(dev, seed, stride):
    """K23 against `down_and_resume_plain`: 3 crash windows per host (some
    slots unused), times at the windows' edges, inside, between and at
    TIME_MAX, the time lane also a column of a [H, 4] tensor."""
    from shadow_tpu_torch.core import faults
    from shadow_tpu_torch.testing import fault_case

    c = fault_case(seed, 3000, 3, 2, dev)
    fp = faults.FaultParams(c["down_t"], c["up_t"], None, None, None, None)
    wide = torch.zeros((3000, stride), dtype=torch.int64, device=dev)
    wide[:, -1] = c["t"]
    got = faults.down_and_resume(fp, wide[:, -1])
    want = faults.down_and_resume_plain(fp, c["t"])
    assert_all_equal(got, want)
    assert bool(want[0].any()) and not bool(want[0].all())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
def test_fault_floor_next_time_matches_plain(dev, fill):
    """K1's fault lane (queue hold), after the busy floor and without it,
    over the slab and the block caches: a floored head inside a crash
    window moves to its restart."""
    from shadow_tpu_torch.testing import fault_case

    q = slab(13, fill, dev)
    c = fault_case(14, H, 2, 1, dev, span=6000)
    crash = (c["down_t"], c["up_t"])
    r = np.random.default_rng(15)
    floor = torch.as_tensor(r.integers(0, 6, H) * 1000, device=dev)
    bq = pev.bucket_rebuild(q, 4)
    for fl in (None, floor):
        assert torch.equal(pev.next_time(q, fl, crash), pev.next_time_plain(q.t, fl, crash))
        assert torch.equal(pev.bq_next_time(bq, fl, crash),
                           pev.next_time_plain(bq.bt, fl, crash))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cpu_delay", [0, 3_000_000])
@pytest.mark.parametrize("restart", ["hold", "clear"])
@pytest.mark.parametrize("name", ["anchor", "cfg6"])
def test_ingress_fault_lanes_match_plain(dev, name, restart, cpu_delay):
    """K10's fault lanes and the second digest: under hold the execution
    time moves to the restart of a crash window containing it (after the
    busy floor), counted in faults_delayed; under clear an event executing
    in a crash window is consumed, not dispatched, and counted in
    faults_dropped; every executed event folds the second digest."""
    from shadow_tpu_torch.ops.events import Event

    case = chain_case(2, 150, dev, **CHAIN_CASES[name], cpu_delay=cpu_delay,
                      restart_queue=restart, dual_digest=True)
    cfg, params, ev, active = case["cfg"], case["params"], case["ev"], case["active"]

    def fresh_event():  # K10 writes the time lane in place: a copy per side
        k = ev.t.stride(0)
        wide = torch.zeros((150, k), dtype=torch.int64, device=dev)
        wide[:, -1] = ev.t
        return Event(wide[:, -1], ev.order, ev.kind, ev.payload)

    got = pchain.event_ingress(clone_carry(case["carry"]), params, cfg, fresh_event(), active)
    want = pchain.event_ingress_plain(clone_carry(case["carry"]), params, cfg, fresh_event(),
                                      active)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    s0, s1 = case["carry"].stats, want[0].stats
    lane = "faults_delayed" if restart == "hold" else "faults_dropped"
    assert bool((getattr(s1, lane) != getattr(s0, lane)).any())
    assert bool((s1.digest2 != s0.digest2).any())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_egress_fault_lane_matches_plain(dev, name, seed):
    """K11's link-fault lane: one more loss draw after the path-loss draw
    and the latency inflation (gated on bootstrap) from three windows
    around the events' times, counted in faults_dropped and
    faults_delayed."""
    case = chain_case(seed, 150, dev, **CHAIN_CASES[name], loss_windows=3)
    cfg, params, ev = case["cfg"], case["params"], case["ev"]
    out, dispatch, we = case["out"], case["dispatch"], case["window_end"]
    if name == "strided_fields":
        out = strided(out, 150)
    got = pchain.event_egress(clone_carry(case["carry"]), params, cfg, ev.t, dispatch, we, out)
    want = pchain.event_egress_append_plain(clone_carry(case["carry"]), params, cfg, ev.t,
                                            dispatch, we, out)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [(0, 0), (4, 0), (4, 4)], ids=["flat", "bucketed", "wheel"])
def test_integrity_check_kernel_matches_plain(dev, layout):
    """K24's three stages against the plain check, on every invariant's
    violation (and none, and the done-round), over two chained rounds (the
    second reads the first's post-exchange state as its entry): the
    integrity, iv_mask and iv_round lanes."""
    from shadow_tpu_torch.core.integrity import IntegrityCheck
    from shadow_tpu_torch.testing import IV_CASES, integrity_case

    block, wheel = layout

    def to(x, d):  # a copy: the kernel writes the sentinel's lanes in place
        if isinstance(x, torch.Tensor):
            return x.to(d, copy=True)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to(v, d) for v in x))
        return x

    for v in IV_CASES:
        if (v == "qfill" and not block) or (v == "wheel_qfill" and not wheel):
            continue
        c = integrity_case(7, 300, 16, block, dev, wheel=wheel, violate=v)
        lanes = []
        for d in (dev, torch.device("cpu")):
            chk = IntegrityCheck(c["cfg"])
            st0, st_m, st_x = (to(c[k], d) for k in ("st0", "st_m", "st_x"))
            chk.enter(st0)
            s = st_x.stats
            for _ in range(2):
                chk.pre_exchange(st_m._replace(stats=s))
                s = chk.post_exchange(st_x._replace(stats=s), s, c["window_end"], c["done"],
                                      st0.now)
            lanes.append([s.integrity.cpu(), s.iv_mask.cpu(), s.iv_round.cpu()])
        assert_all_equal(lanes[0], lanes[1])
        assert (int(lanes[1][0]) > 0) == (v not in (None, "done")), v
    torch.cuda.synchronize()


MIGRATIONS = [(16, 8, 0, 8), (16, 32, 0, None), (16, 16, 0, None), (16, 4, 0, 4),
              (16, 32, 4, None), (16, 8, 4, 8), (40, 1200, 0, None), (1200, 64, 0, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("cap,new_cap,block,fill", MIGRATIONS)
def test_migrate_queue_kernel_matches_plain(dev, cap, new_cap, block, fill):
    """K25 (then K8 for a bucketed target) against the plain re-seat:
    growth, the same capacity, shrinks with compaction where the live
    events fit (stale kind and payload in empty slots move as in the
    reference), a slab wider than one warp's 32 columns both ways; the
    input is unchanged and shares no storage with the output; the
    count-only launch (`migration_fits`) against the plain count on the
    unshrunk slab."""
    from shadow_tpu_torch.testing import migrate_case

    for seed in range(3):
        c = migrate_case(seed, 300, cap, dev, fill=fill)
        q = pev.EventQueue(c["t"], c["order"], c["kind"], c["payload"], c["dropped"])
        before = clone(q)
        got = pev.migrate_queue(q, new_cap, block)
        flat = pev.migrate_slab_plain(q, new_cap)
        want = (pev.BucketQueue(*flat, *pev.block_minima_plain(flat.t, flat.order,
                                                               new_cap // block))
                if block else flat)
        assert_all_equal(list(got), list(want))
        assert_all_equal(list(q), list(before))
        assert not {x.data_ptr() for x in got} & {x.data_ptr() for x in q}
        for k in (1, new_cap, cap):
            assert torch.equal(pev.migration_fits(q, k), pev.queue_len(q) <= k)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_migrate_wheel_kernel_matches_plain(dev):
    """`migrate_wheel` (K25 + K8) on a [300, 4] wheel in blocks of 2, to 8
    slots and back."""
    from shadow_tpu_torch.testing import migrate_case

    c = migrate_case(5, 300, 4, dev)
    q = pev.EventQueue(c["t"], c["order"], c["kind"], c["payload"], c["dropped"])
    w = pev.bucket_rebuild(q, 2)
    for slots, src in ((8, w), (4, pwheel.migrate_wheel(w, 8))):
        b = pwheel.resolve_wheel_block(slots, 0)
        flat = pev.migrate_slab_plain(pev.as_flat(src), slots)
        want = pev.BucketQueue(*flat, *pev.block_minima_plain(flat.t, flat.order, slots // b))
        assert_all_equal(list(pwheel.migrate_wheel(src, slots)), list(want))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 300, 4096, 100_003])
def test_pressure_total_kernel_matches_plain(dev, h):
    """K26 against the three sums in torch, on lanes up to 2^40 (no
    overflow) and a host count that is not a multiple of the block."""
    from shadow_tpu_torch.ops.pressure import pressure_total, pressure_total_plain

    r = np.random.default_rng(h)
    lanes = [torch.as_tensor(r.integers(0, 1 << 40, h), device=dev) for _ in range(2)]
    ob = torch.as_tensor(r.integers(0, 1 << 40, 1), device=dev)
    got = pressure_total(*lanes, ob)
    assert torch.equal(got, pressure_total_plain(*lanes, ob))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("windows,block,netobs", [(0, 0, False), (3, 7, True)],
                         ids=["flat", "bucketed_faults_netobs"])
def test_trace_round_kernel_matches_plain(dev, windows, block, netobs):
    """K27 (a chunk entry, then five rounds into a 3-row ring: it wraps)
    against the plain version run on the same card: rows, cursor and the
    scratch, every round."""
    from shadow_tpu_torch.ops import obs as pobs
    from shadow_tpu_torch.testing import trace_case

    c = trace_case(3, 10_000, 5, 3, dev, block=block, windows=windows, netobs=netobs,
                   ledger=netobs)
    ring_k, ring_p = c["new_ring"](), c["new_ring"]()
    sk, sp = pobs.make_trace_scratch(dev), pobs.make_trace_scratch(dev)
    n0 = pobs.KERNELS["trace_round"].launches
    pobs.trace_enter(sk, c["stats"][0])
    sp.copy_(pobs.counter_values_plain(c["stats"][0]))
    for st, ri in zip(c["stats"][1:], c["inputs"]):
        pobs.trace_round(ring_k, sk, st, ri)
        pobs.trace_round_plain(ring_p, sp, st, ri)
        assert_all_equal([*ring_k, sk], [*ring_p, sp])
    assert pobs.KERNELS["trace_round"].launches - n0 == 6
    if windows:
        assert int(ring_k.rows[0, :, 16].max()) > 0  # hosts down at a round's end
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("records", [8, 4096])
def test_flow_append_kernel_matches_plain(dev, records):
    """K28 on four event columns of 10,000 hosts (one 95% dense: past an
    8-record ring, the newest records win) against the plain version on
    the same card: ledger rows, cursor and the fl_* totals."""
    from shadow_tpu_torch.ops import obs as pobs
    from shadow_tpu_torch.testing import flow_case

    for seed in range(2):
        c = flow_case(seed, 10_000, 4, records, dev)
        k = {"ledger": type(c["ledger"])(*(x.clone() for x in c["ledger"])),
             "fl": [x.clone() for x in c["fl"]]}
        pobs.flow_append(k["ledger"], c["lanes"], *k["fl"])
        pobs.flow_append_plain(c["ledger"], c["lanes"], *c["fl"])
        assert_all_equal([*k["ledger"], *k["fl"]], [*c["ledger"], *c["fl"]])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["anchor", "cfg6"])
def test_ingress_event_classes_match_plain(dev, name):
    """K10's event-class lane (timer kinds as a bitmask, packets, the rest)
    against the plain version: the ec_* counters and every other lane."""
    case = chain_case(4, 10_000, dev, **CHAIN_CASES[name], netobs=True)
    cfg, params, ev, active = case["cfg"], case["params"], case["ev"], case["active"]
    got = pchain.event_ingress(clone_carry(case["carry"]), params, cfg, ev, active,
                               case["timer_mask"])
    want = pchain.event_ingress_plain(clone_carry(case["carry"]), params, cfg, ev, active,
                                      case["timer_mask"])
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    s0, s1 = case["carry"].stats, want[0].stats
    assert all(bool(getattr(s1, k) > getattr(s0, k)) for k in ("ec_timer", "ec_pkt", "ec_app"))
    torch.cuda.synchronize()


POP_INGRESS_LANES = {
    "shaping_codel": CHAIN_CASES["anchor"],
    "unshaped": CHAIN_CASES["unshaped"],
    "cpu_model": dict(CHAIN_CASES["anchor"], cpu_delay=3_000_000),
    "hold": dict(CHAIN_CASES["anchor"], cpu_delay=3_000_000, restart_queue="hold"),
    "clear": dict(CHAIN_CASES["anchor"], restart_queue="clear"),
    "digest2": dict(CHAIN_CASES["anchor"], dual_digest=True),
    "event_classes": dict(CHAIN_CASES["anchor"], netobs=True),
}
# the ensemble plane runs neither the sentinel nor the observatories
POP_INGRESS_PARAMS = [(lane, lim) for lane in POP_INGRESS_LANES for lim in POP_LIMITS
                      if not (lim == "row" and lane in ("digest2", "event_classes"))]


@pytest.mark.gpu
@pytest.mark.parametrize("h", [150, 4097])
@pytest.mark.parametrize("cap", [13, 14, 64, 65, 1024])
@pytest.mark.parametrize("lane,limits", POP_INGRESS_PARAMS)
def test_pop_ingress_matches_plain(dev, lane, limits, cap, h):
    """K36 (the pop and the ingress in one launch) against `pop_min_plain`
    followed by `event_ingress_plain`: the queue's planes, the event (its
    time the execution time), `active`, every carry lane and every Ingress
    field, under one limit, per-host limits and per-row limits (replicas,
    one frozen), with tail blocks and capacities of one and two passes,
    read 8 or 16 bytes a lane (odd or even)."""
    case = pop_ingress_case(7, h, cap, dev, limits=limits, **POP_INGRESS_LANES[lane])
    args = (case["params"], case["cfg"])
    got = pchain.pop_ingress(clone_carry(case["carry"]), *args, clone(case["queue"]),
                             case["limit"], case["timer_mask"])
    want = pchain.pop_ingress_plain(clone_carry(case["carry"]), *args, clone(case["queue"]),
                                    case["limit"], case["timer_mask"])
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    active = want[3]
    assert bool(active.any()) and not bool(active.all())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [14, 64, 1024])
def test_pop_ingress_per_host_limits_pop_as_k5_k6(dev, cap):
    """Per-host limits through K36 pop the event, and clear the slot, that
    K5 at k = 1 followed by K6 pops and clears."""
    case = pop_ingress_case(9, 4097, cap, dev, limits="host", **POP_INGRESS_LANES["unshaped"])
    q0, limit = case["queue"], case["limit"]
    q, _, ev, active, _ = pchain.pop_ingress(clone_carry(case["carry"]), case["params"],
                                             case["cfg"], clone(q0), limit)
    popped = pev.pop_k(q0, limit, 1)
    q_k = pev.clear_popped(clone(q0), popped, popped.active[:, 0].to(torch.int32))
    assert_all_equal([*q, *ev, active], [*q_k, *popped.event(0), popped.active[:, 0]])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 4])
def test_tgen_flow_lanes_match_plain(dev, stride):
    """K17's flow-record lanes against those `handle_plain` writes, over
    three chained calls; the other outputs stay equal."""
    import dataclasses

    from shadow_tpu_torch.ops.obs import make_flow_lanes
    from shadow_tpu_torch.testing import handler_case

    case = handler_case("tgen_tcp", 9, 10_000, dev, stride=stride)
    m, ck = case["model"], case["ctx"]
    cp = clone_ctx(ck)
    done = 0
    for step in range(3):
        if step:
            ev = handler_case("tgen_tcp", 9_000 + step, 10_000, dev, stride=stride)["ctx"]
            ck = dataclasses.replace(ev, state=got.state, rng=got.rng)
            cp = dataclasses.replace(ev, state=want.state, rng=want.rng)
        lanes, ref = make_flow_lanes(1, 10_000, dev), make_flow_lanes(1, 10_000, dev)
        got = m.handle(dataclasses.replace(ck, flow=lanes.row(0)))
        want = m.handle_plain(dataclasses.replace(cp, flow=ref.row(0)))
        assert got.flow is not None and handler_diff(got, want) == []
        assert_all_equal(list(lanes), list(ref))
        done += int(lanes.mask.sum())
    assert done > 0
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_memory_headroom_is_what_the_process_can_hold(dev):
    """The monitor's headroom on the card is its free bytes plus the
    allocator's reserved-but-unallocated bytes, and a live tensor of 1 GiB
    takes 1 GiB of it (and at most 64 MiB more: the driver's own page
    bookkeeping for a fresh allocation)."""
    from shadow_tpu_torch.obs.memory import MemoryMonitor

    mon = MemoryMonitor([dev])
    torch.cuda.synchronize()
    mon.sample()
    free, _ = torch.cuda.mem_get_info(dev)
    st = torch.cuda.memory_stats(dev)
    want = free + st["reserved_bytes.all.current"] - st["allocated_bytes.all.current"]
    assert mon.source == "device" and mon.headroom_bytes() == want
    before = mon.headroom_bytes()
    x = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    mon.sample()
    assert before - (1 << 30) - (64 << 20) <= mon.headroom_bytes() <= before - (1 << 30)
    del x


# --------------------------------------------------------------------------
# the exchange across ranks: K29 dshard_pack, K30 exchange_unpack, and the
# chain's and the fluid plane's kernels on a shard that does not start at
# host 0
# --------------------------------------------------------------------------

# (seed, h_local, budget, world, block, gear columns, outbox_case keywords):
# rows that fit, a block small enough to shed, empty shards, every row to
# one shard, padded hosts, a gear slice, and a sort over many 256-key tiles
# (24,000 rows: the merge passes run) at the 40k leg's shard width
PACK_GPU_CASES = {
    "fit": (0, 12, 6, 4, 72, 0, {}),
    "shed": (1, 12, 6, 4, 5, 0, {"fill": 0.9}),
    "empty_shards": (2, 10, 4, 4, 40, 0, {"shards": [1, 3]}),
    "all_to_one": (3, 16, 5, 4, 30, 0, {"shards": [2], "fill": 0.95}),
    "padded": (4, 8, 6, 4, 48, 0, {"num_real": 29}),
    "gear_slice": (5, 12, 8, 4, 24, 3, {"fill": 0.8}),
    "many_tiles": (6, 2_000, 12, 4, 6_000, 0, {"fill": 0.7}),
    "shard_width_40k": (7, 10_000, 12, 4, 30_000, 6, {"fill": 0.5}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PACK_GPU_CASES))
def test_dshard_pack_kernel_matches_plain(dev, case):
    from shadow_tpu_torch.ops import exchange as pex
    from shadow_tpu_torch.testing import outbox_case

    seed, h, b, world, k, cols, kw = PACK_GPU_CASES[case]
    ob = outbox_case(seed, h, b, world, dev, **kw)
    args = (ob["dst"], ob["t"], ob["order"], ob["kind"], ob["payload"], h, world, k, cols)
    got = pex.dshard_pack(*args)
    want = pex.dshard_pack_plain(*args)
    torch.cuda.synchronize()
    assert_all_equal(got, want)
    if case in ("shed", "all_to_one"):
        assert int(want[2]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("hier", [False, True], ids=["alltoall", "hierarchical"])
def test_exchange_unpack_kernel_matches_plain(dev, hier):
    """Four shards' blocks exchanged as the all-to-all moves them (with
    fill counts below the blocks' rows on the hierarchical path), and the
    gather path's buffer with its trailing count row."""
    from shadow_tpu_torch.ops import exchange as pex
    from shadow_tpu_torch.testing import outbox_case

    world, h, b, k = 4, 300, 6, 500
    packs = [pex.dshard_pack_plain(*outbox_case(10 + i, h, b, world, dev, fill=0.8).values(),
                                   h, world, k) for i in range(world)]
    for j in range(world):
        recv = torch.stack([packs[i][0][j] for i in range(world)])
        counts = None
        if hier:
            counts = torch.stack([torch.clamp_max(packs[i][1][j], k) for i in range(world)])
            counts = torch.clamp_min(counts - torch.arange(world, device=dev, dtype=torch.int32), 0)
        got = pex.exchange_unpack(recv, j * h, h, counts)
        want = pex.exchange_unpack_plain(recv, j * h, h, counts)
        assert_all_equal(got, want)
    buf = torch.cat([recv.reshape(world, k, -1), recv[:, :1]], dim=1)  # a trailing row
    assert_all_equal(pex.exchange_unpack(buf, 2 * h, h, n=k),
                     pex.exchange_unpack_plain(buf, 2 * h, h, n=k))
    torch.cuda.synchronize()


def _on_shard(cfg, params, world: int, rank: int):
    """A case's config and params as rank `rank` of `world` equal shards:
    the global host count, the host -> node map tiled over the shards (the
    affine divide off, so every shard's nodes exist)."""
    import dataclasses

    h = cfg.num_hosts
    cfg = dataclasses.replace(cfg, num_hosts=world * h, world=world, rank=rank,
                              hosts_per_node=0)
    return cfg, params._replace(node_of=params.node_of.repeat(world))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cfg6", "echo_jitter", "bursts_table"])
def test_chain_kernels_on_a_shard_match_plain(dev, name):
    """K10 and K11 at rank 2 of 4 (host_base = 300): order keys, route
    sources (the 2-D table's source node) and the destination range read
    global host ids."""
    case = chain_case(3, 150, dev, **CHAIN_CASES[name])
    cfg, params = _on_shard(case["cfg"], case["params"], 4, 2)
    ev, active = case["ev"], case["active"]
    got = pchain.event_ingress(clone_carry(case["carry"]), params, cfg, ev, active)
    want = pchain.event_ingress_plain(clone_carry(case["carry"]), params, cfg, ev, active)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    args = (params, cfg, ev.t, case["dispatch"], case["window_end"], case["out"])
    got = pchain.event_egress(clone_carry(case["carry"]), *args)
    want = pchain.event_egress_append_plain(clone_carry(case["carry"]), *args)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    entries = pchain.event_egress_plain(clone_carry(case["carry"]), *args)[2]
    src = (entries.order >> 40) & ((1 << 22) - 1)
    assert int(src.min()) == 300
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("loss_max", [0.0, 0.3])
def test_fluid_kernels_on_a_shard_match_plain(dev, loss_max):
    """K14 (foreground bytes per link: source links and the destination
    range global), K16 (per-host coupling at the shard's hosts) and K11's
    counter draw keyed on the global host id, at rank 1 of 4."""
    c = fluid_case(11, 64, 6, 4, dev, affine=False, loss_max=loss_max)
    ch = c["chain"]
    cfg, _ = _on_shard(c["cfg"], ch["params"], 4, 1)
    node_of = c["node_of"].repeat(4)
    ob = (c["ob_dst"], c["ob_t"], c["ob_payload"])
    assert_all_equal([pfl.fluid_fg_link_bytes(cfg, *ob, node_of)],
                     [pfl.fluid_fg_link_bytes_plain(cfg, *ob, node_of)])
    st, fp = c["st"], c["fp"]
    got = pfl.fluid_host_effects(cfg, fp, st, node_of)
    want = pfl.fluid_host_effects_plain(cfg, fp, st, pfl.host_nodes(cfg, node_of, 64, 64))
    assert_all_equal(bits(got), bits(want))
    ccfg, params = _on_shard(ch["cfg"], ch["params"], 4, 1)
    args = (params, ccfg, ch["ev"].t, ch["dispatch"], ch["window_end"], ch["out"],
            ch["fluid_fx"])
    got = pchain.event_egress(clone_carry(ch["carry"]), *args)
    want = pchain.event_egress_append_plain(clone_carry(ch["carry"]), *args)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the ensemble plane
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 33, 300, 4096, 4097, 25_000])
@pytest.mark.parametrize("reps", [1, 4, 64])
@pytest.mark.parametrize("dynamic", [False, True])
def test_replica_window_kernel_matches_plain(dev, h, reps, dynamic):
    """K31 (one cluster of `window_cluster(h)` blocks per replica) in both
    modes: the lane block and the pop limits equal the plain version's, a
    done replica stays frozen (its window end kept), and the valve is the
    microstep count or, given, the rows' largest count. At 4,097 rows the
    planes are also read and written 8 bytes off a 16-byte boundary (the
    slices' scalar heads and tails). One replica: live, not frozen."""
    case = ensemble_case(3, reps, h, dev)
    lanes = case["lanes"]
    nt, valve = case["nt"], case["valve"]
    if reps == 1:
        nt = torch.as_tensor(np.random.default_rng(h).integers(0, case["stop"], h),
                             device=dev)
        lanes = pens.make_lanes([False], dev)
    shift = h == 4097  # the planes as views one element into a buffer

    def plane(x):
        if not shift:
            return x.clone()
        buf = torch.zeros((x.numel() + 1,), dtype=x.dtype, device=dev)
        buf[1:] = x
        return buf[1:]

    kw = dict(rows=h, stop=case["stop"], runahead=50_000_000, floor=2_000_000,
              dynamic=dynamic, min_used=case["min_used"], limit=25)
    nt = plane(nt)
    lanes_k, lanes_p = lanes.clone(), lanes.clone()
    pop_k = plane(torch.full((reps * h,), -1, dtype=torch.int64, device=dev))
    pop_p = pop_k.clone()
    pens.replica_window(pens.ROUND, nt, lanes_k, pop_k, **kw)
    pens.replica_window_plain(pens.ROUND, nt, lanes_p, pop_p, **kw)
    assert torch.equal(lanes_k, lanes_p)
    if reps > 1:
        assert lanes_k[pens.WEND, reps - 1] == 12_345
    for v in (None, plane(valve)):
        for _ in range(3):  # chained tests: the microstep lane counts
            pens.replica_window(pens.LOOP, nt, lanes_k, pop_k, valve=v,
                                ob_count=case["ob_count"], **kw)
            pens.replica_window_plain(pens.LOOP, nt, lanes_p, pop_p, valve=v,
                                      ob_count=case["ob_count"], **kw)
            assert torch.equal(lanes_k, lanes_p) and torch.equal(pop_k, pop_p)
    if reps > 1:
        assert not bool(pop_k.view(reps, h)[reps - 1].any())  # the frozen replica pops nothing
    else:
        assert bool(lanes_p[pens.STEPS, 0] > 0)  # the live replica ran its loop tests
    assert pens.window_cluster(h) == (1 if h <= 512 else 8)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("h,n_real", [(1, 1), (300, 300), (4096, 4096), (4096, 4000)])
@pytest.mark.parametrize("fields", [0, 11])
def test_replica_fold_kernel_matches_plain(dev, h, n_real, fields):
    """K32: the xor of each replica's digest rows and the sums of its
    counter rows over its first n_real rows."""
    case = ensemble_case(4, 4, h, dev, fields=fields)
    got = pens.replica_fold(case["digest"], case["fields"], 4, n_real)
    want = pens.replica_fold_plain(case["digest"], case["fields"], 4, n_real)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("urgency", [True, False])
@pytest.mark.parametrize("merge_rows", [0, 40])
def test_replica_merge_kernels_match_plain(dev, urgency, merge_rows):
    """K4 and K13 with four replicas of 48 hosts (loads that fit, a hot
    destination, full queues; one replica frozen, with nothing sent): each
    replica's rows equal the plain version's, the frozen replica's are
    unchanged, and K13 decides its branch per replica."""
    q, ob = replica_merge_case(11, 4, 48, 8, 6, 6, ("fit", "hot", "full", "empty"))
    rows = [torch.as_tensor(a, device=dev) for a in ob]
    queue = pev.EventQueue(*(torch.as_tensor(a, device=dev) for a in q))
    for fn, plain in ((pmerge.merge_flat_events, pmerge.merge_flat_events_plain),
                      (pmerge.merge_scatter_free, pmerge.merge_scatter_free_plain)):
        got = fn(clone(queue), *rows, None, 8, urgency, merge_rows=merge_rows, rows_per_rep=48)
        want = plain(clone(queue), *rows, None, 8, urgency, merge_rows=merge_rows,
                     rows_per_rep=48)
        assert_all_equal(got, want)
        for x, y in zip(got, queue):
            assert torch.equal(x[3 * 48:], y[3 * 48:])


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["mixed", "full"])
def test_pop_min_per_row_limits_matches_plain(dev, fill):
    """K2 reading per-row limits (the ensemble's frozen replicas pop under
    0): the plain version's event, mask and slab."""
    q = slab(9, fill, dev)
    lim = torch.as_tensor(np.repeat([3000, 0, 6000, 0], H // 4), device=dev)
    got = pev.pop_min(clone(q), lim)
    want = pev.pop_min_plain(clone(q), lim)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    assert not bool(got[2].view(4, -1)[1].any())


REPLICA_CHAIN_CASES = {
    "anchor": CHAIN_CASES["anchor"],
    "echo_jitter": CHAIN_CASES["echo_jitter"],
    "cfg6": CHAIN_CASES["cfg6"],
    "faults": dict(CHAIN_CASES["anchor"], restart_queue="hold", loss_windows=2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(REPLICA_CHAIN_CASES))
def test_replica_chain_kernels_match_plain(dev, name):
    """K10 and K11 over four replicas of 75 hosts (replica-local ids and
    destinations, per-replica window ends and link-fault windows, route
    rows held once, per-replica outbox counters and used-latency lanes):
    the plain version's outputs, with replica 2 frozen, its carry rows and
    lanes unchanged."""
    from shadow_tpu_torch.ops.events import Event

    case = replica_chain_case(5, 4, 75, dev, frozen=(2,), **REPLICA_CHAIN_CASES[name])
    cfg, params, ev, active = case["cfg"], case["params"], case["ev"], case["active"]
    c0 = clone_carry(case["carry"])

    def fresh_event():  # K10's hold lane writes the time lane in place
        k = ev.t.stride(0)
        wide = torch.zeros((300, k), dtype=torch.int64, device=dev)
        wide[:, -1] = ev.t
        return Event(wide[:, -1], ev.order, ev.kind, ev.payload)

    c_k, ing_k = pchain.event_ingress(clone_carry(c0), params, cfg, fresh_event(), active)
    c_p, ing_p = pchain.event_ingress_plain(clone_carry(c0), params, cfg, fresh_event(), active)
    assert_all_equal(flat_tensors([c_k, ing_k]), flat_tensors([c_p, ing_p]))
    ev = ev._replace(t=ing_p.t)
    out, dispatch, we = case["out"], case["dispatch"], case["window_end"]
    got = pchain.event_egress(clone_carry(c_p), params, cfg, ev.t, dispatch, we, out)
    want = pchain.event_egress_append_plain(clone_carry(c_p), params, cfg, ev.t, dispatch, we,
                                            out)
    assert_all_equal(flat_tensors(got), flat_tensors(want))
    frozen = slice(2 * 75, 3 * 75)
    for x, y in zip(flat_tensors(got[0]), flat_tensors(c0)):
        if x.shape[:1] == (300,):
            assert torch.equal(x[frozen], y[frozen])
    assert int(got[0].outbox.count[2]) == int(c0.outbox.count[2])
    assert int(got[0].min_used_lat[2]) == int(c0.min_used_lat[2])
    assert int(got[0].stats.ob_dropped[2]) == 0
    assert int(got[0].outbox.count.sum()) > int(c0.outbox.count.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("hr", [150, 4097])
@pytest.mark.parametrize("name", ["anchor", "cfg6", "faults"])
def test_replica_egress_append_matches_plain(dev, name, hr):
    """Merged K11 over four replicas of `hr` hosts (150 and 4,097: warps
    that straddle two replicas) and four event columns, replica 2 frozen,
    an outbox narrower than the budget: each replica's outbox rows, count,
    ob_dropped and min_used_lat equal the plain append's, the frozen
    replica's unchanged."""
    case = replica_chain_case(8, 4, hr, dev, frozen=(2,), **REPLICA_CHAIN_CASES[name],
                              ob_cols=3)
    c_k, c_p = egress_columns(case, 4)
    assert_all_equal(flat_tensors(c_k), flat_tensors(c_p))
    c0 = case["carry"]
    assert int(c_k.outbox.count[2]) == int(c0.outbox.count[2])
    assert int(c_k.min_used_lat[2]) == int(c0.min_used_lat[2])
    assert int(c_k.stats.ob_dropped[2]) == 0 and int(c_k.stats.ob_dropped.sum()) > 0
    frozen = slice(2 * hr, 3 * hr)
    for x, y in zip(flat_tensors(c_k.outbox), flat_tensors(c0.outbox)):
        if x.shape[:1] == (4 * hr,):
            assert torch.equal(x[frozen], y[frozen])
    torch.cuda.synchronize()


COSIM_H = 4_096  # the mixed leg's host count


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("fill", COSIM_FILLS)
def test_hybrid_handle_kernel_matches_plain(dev, fill, stride):
    """K33 against `handle_plain` over two chained calls (the rings and
    counters the kernel writes in place feed the next call of each side)."""
    from shadow_tpu_torch.models import KERNELS

    n0 = KERNELS["hybrid_handle"].launches
    case = hybrid_case(3, COSIM_H, dev, cap=4, fill=fill, stride=stride)
    m, ck = case["model"], case["ctx"]
    cp = clone_ctx(ck)
    for step in range(2):
        if step:
            ev = hybrid_case(11, COSIM_H, dev, cap=4, fill=fill, stride=stride)["ctx"]
            ck = dataclasses.replace(ev, state=got.state, rng=got.rng)
            cp = dataclasses.replace(ev, state=want.state, rng=want.rng)
        got, want = m.handle(ck), m.handle_plain(cp)
        assert handler_diff(got, want) == [], step
        assert got.state is ck.state  # in place
    assert KERNELS["hybrid_handle"].launches - n0 == 2
    if fill == "full":
        assert int(got.state["cap_lost"].sum()) > int(case["np"]["state"]["cap_lost"].sum())


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("native", NATIVE_PATTERNS)
@pytest.mark.parametrize("inner", ["udp_echo", "gossip"])
def test_mixed_plane_kernels_match_plain(dev, inner, native, stride):
    """The mixed handler on the card (K34 in mode, K33, the inner model's
    kernel, K34 out mode) against its plain version, every lane."""
    from shadow_tpu_torch.models import KERNELS

    n0 = {k: v.launches for k, v in KERNELS.items()}
    case = mixed_case(inner, 4, COSIM_H, dev, native=native, stride=stride)
    got = case["model"].handle(clone_ctx(case["ctx"]))
    want = case["model"].handle_plain(clone_ctx(case["ctx"]))
    assert handler_diff(got, want) == []
    ran = {k: v.launches - n0[k] for k, v in KERNELS.items() if v.launches - n0[k]}
    assert ran == {"mixed_plane": 2, "hybrid_handle": 1,
                   {"udp_echo": "echo_handle", "gossip": "gossip_handle"}[inner]: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("stops", [0, 1, 2])
@pytest.mark.parametrize("probe", ["never", "first"])
def test_guarded_window_kernel_matches_plain(dev, probe, stops, seed):
    from shadow_tpu_torch.ops.cosim import guarded_window, guarded_window_plain

    for seed in range(4 * seed, 4 * seed + 4):
        kw = guarded_case(seed, COSIM_H, dev, probe=probe, stops=stops)
        got, want = guarded_window(**kw), guarded_window_plain(**kw)
        assert torch.equal(got, want), (seed, got.tolist(), want.tolist())
        assert bool(got[2]) == (probe == "first")
