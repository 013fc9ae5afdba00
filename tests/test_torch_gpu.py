"""The port's CUDA kernels K1-K8 against their plain PyTorch versions, on the
card. Marked `gpu`; without a CUDA device each test skips.

Run on a machine with a card, from the repository root:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: the repository's conftest imports JAX, which a GPU machine
may lack; this file imports neither JAX nor the JAX package.)

Small numpy-seeded slabs: empty, sparse, mixed, nearly full and full queues,
heavy time ties, merge segments past the insert cap. Tolerance: exact
equality — every output is an integer. chip_smoke.py repeats the check at
the main path's shapes.
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import merge as pmerge

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
