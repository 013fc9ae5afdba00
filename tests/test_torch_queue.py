"""PyTorch port vs JAX reference: the bucketed queue and the K-way batch ops
(K5 pop_k, K6 clear_popped, K7 bq_push_many, K8 block_minima, and K3's
reserve) on numpy-seeded random slabs, through the port's plain PyTorch
versions (the CPU path).

Slabs cover empty, sparse, mixed, nearly full and full rows with heavy time
ties; executed prefixes `m` are random; push reserves are large enough to
force drops. Every JAX op with two formulations runs under both
`force_path`s. Tolerance: exact equality — every output is an integer. A
peek's `idx` is compared on active columns only: on inactive columns it
names an empty slot, and which one is unspecified in the reference (its
two formulations disagree there) and never read.

The kernels themselves are checked against these plain versions on the
card by chip_smoke.py and tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.ops import events as jev
from shadow_tpu_torch.ops import events as pev

H, C, P, BLOCK = 24, 16, 4, 4
TIME_MAX = (1 << 63) - 1
ORDER_MAX = (1 << 63) - 1
FILLS = {
    "empty": lambda r: np.zeros(H, int),
    "sparse": lambda r: r.integers(0, 4, H),
    "mixed": lambda r: r.integers(0, C + 1, H),
    "nearly_full": lambda r: C - r.integers(0, 3, H),
    "full": lambda r: np.full(H, C),
}
CASES = [(s, k) for k in FILLS for s in (1, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slab(seed: int, fill_kind: str):
    r = np.random.default_rng(seed)
    fill = FILLS[fill_kind](r)
    t = np.full((H, C), TIME_MAX, np.int64)
    order = np.full((H, C), ORDER_MAX, np.int64)
    live = r.random((H, C)).argsort(axis=1) < fill[:, None]
    n = int(live.sum())
    t[live] = r.integers(0, 6, n) * 1000  # few distinct times: many ties
    hosts = np.nonzero(live)[0].astype(np.int64)
    order[live] = (r.integers(0, 2, n) << 62) | (hosts << 40) | r.permutation(n)
    kind = r.integers(0, 1 << 18, (H, C)).astype(np.int32)
    payload = r.integers(-(1 << 31), 1 << 31, (H, C, P)).astype(np.int32)
    dropped = r.integers(0, 3, H).astype(np.int64)
    return t, order, kind, payload, dropped


def queues(arrs, block):
    """(jax queue, port queue) from the same arrays; bucketed when block."""
    jq = jev.EventQueue(*(jnp.asarray(a) for a in arrs))
    pq = pev.EventQueue(*(torch.as_tensor(a) for a in arrs))
    if block:
        return jev.bucket_rebuild(jq, block), pev.bucket_rebuild(pq, block)
    return jq, pq


def same(j, p) -> bool:
    return np.array_equal(np.asarray(j), p.numpy())


def assert_queue_equal(jq, pq):
    assert type(jq).__name__ == type(pq).__name__
    for f in type(jq)._fields:
        assert same(getattr(jq, f), getattr(pq, f)), f


def pushes(seed: int, n: int, reserve_hi: int):
    """n push ports of random fields; reserves in [0, reserve_hi) (None when
    reserve_hi is 0)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = [r.random(H) < 0.7, r.integers(0, 8, H) * 1000 + 500,
             (np.int64(1) << 62) | (np.arange(H, dtype=np.int64) << 40) | r.integers(0, 1 << 30, H),
             r.integers(0, 1 << 18, H).astype(np.int32),
             r.integers(-(1 << 31), 1 << 31, (H, P)).astype(np.int32)]
        if reserve_hi:
            f.append(r.integers(0, reserve_hi, H).astype(np.int32))
        out.append(f)
    j = [tuple(jnp.asarray(x) for x in f) for f in out]
    p = [pev.Push(*(torch.as_tensor(x) for x in f)) for f in out]
    return j, p


@pytest.mark.parametrize("path", ["gather", "onehot"])
@pytest.mark.parametrize("block", [0, BLOCK])
@pytest.mark.parametrize("k", [1, 4, C])
@pytest.mark.parametrize("seed,fill", CASES)
def test_pop_k_and_clear_popped(seed, fill, k, block, path):
    """pop_k's peek, then clearing a random executed prefix (and, for the
    bucketed queue, the victim blocks' caches)."""
    jq, pq = queues(slab(seed, fill), block)
    for limit in (2500, TIME_MAX):
        jp = jev.pop_k(jq, limit, k, force_path=path)
        pp = pev.pop_k(pq, limit, k)
        for f in ("t", "order", "kind", "payload", "active"):
            assert same(getattr(jp, f), getattr(pp, f)), f
        act = pp.active.numpy()
        assert np.array_equal(np.asarray(jp.idx)[act], pp.idx.numpy()[act])
        r = np.random.default_rng(seed + k)
        m = np.minimum(r.integers(0, k + 1, H), act.sum(axis=1)).astype(np.int32)
        m[:3] = act.sum(axis=1)[:3]  # some hosts clear the whole prefix
        jc = jev.clear_popped(jq, jp, jnp.asarray(m))
        pc = pev.clear_popped(pq, pp, torch.as_tensor(m))
        assert_queue_equal(jc, pc)


@pytest.mark.parametrize("seed,fill", CASES)
def test_block_minima_and_rebuild(seed, fill):
    a = slab(seed, fill)
    for block in (1, 2, BLOCK, C):
        jbq, pbq = queues(a, block)
        assert_queue_equal(jbq, pbq)
        for x, y in zip(jev.block_minima(jnp.asarray(a[0]), jnp.asarray(a[1]), C // block),
                        pev.block_minima(torch.as_tensor(a[0]), torch.as_tensor(a[1]), C // block)):
            assert same(x, y)
        assert same(jev.bq_next_time(jbq), pev.bq_next_time(pbq))
        assert same(jev.q_len(jbq), pev.q_len(pbq))


@pytest.mark.parametrize("path", ["gather", "onehot"])
@pytest.mark.parametrize("seed,fill", CASES)
def test_bq_pop_min_is_pop_k_then_clear(seed, fill, path):
    """The bucketed K = 1 pop (K5 at k = 1, then K6 of the active hosts)
    against the reference's bq_pop_min, popped until every row is empty."""
    jq, pq = queues(slab(seed, fill), BLOCK)
    for limit in (0, 2500, 2500, 6000, TIME_MAX, TIME_MAX, TIME_MAX):
        jq, jevt, jact = jev.bq_pop_min(jq, limit, force_path=path)
        pq, pevt, pact = pev.bq_pop_min(pq, limit)
        assert same(jact, pact)
        for f in jev.Event._fields:
            assert same(getattr(jevt, f), getattr(pevt, f)), f
        assert_queue_equal(jq, pq)


@pytest.mark.parametrize("path", ["gather", "onehot"])
@pytest.mark.parametrize("n_ports,reserve_hi", [(3, 0), (5, 3), (12, C)])
@pytest.mark.parametrize("seed,fill", CASES)
def test_push_many_with_reserve(seed, fill, n_ports, reserve_hi, path):
    """Flat push_many and the bucketed bq_push_many with per-push reserves
    (reserve_hi = C forces drops on every row that fills); the bucketed
    slab must also equal the flat one."""
    a = slab(seed, fill)
    jp, pp = pushes(100 * seed + n_ports, n_ports, reserve_hi)
    jf = jev.push_many(queues(a, 0)[0], jp)
    pf = pev.push_many(queues(a, 0)[1], pp)
    assert_queue_equal(jf, pf)
    jbq, pbq = queues(a, BLOCK)
    jb = jev.bq_push_many(jbq, jp, force_path=path)
    pb = pev.bq_push_many(pbq, pp)
    assert_queue_equal(jb, pb)
    assert_queue_equal(jf, pev.as_flat(pb))
    if reserve_hi == C and fill in ("nearly_full", "full"):
        assert int((pf.dropped - torch.as_tensor(a[4])).sum()) > 0


def test_reserve_drop_exactness():
    """The reference's scenario (tests/test_popk.py): capacity 4, four
    events execute in one batch and the first pushes two; with the reserve
    of the three that executed after it, one lands and one drops."""
    h, c = 2, 4
    for block in (0, 2):
        q = pev.make_queue(h, c, "cpu")
        if block:
            q = pev.bucket_rebuild(q, block)
        ones = torch.ones(h, dtype=torch.bool)
        zp = torch.zeros((h, P), dtype=torch.int32)

        def order(s):
            return pev.pack_order(1, torch.arange(h), torch.full((h,), s))

        q = pev.q_push_many(q, [pev.Push(ones, torch.full((h,), 10 * (s + 1)), order(s),
                                         torch.ones(h, dtype=torch.int32), zp)
                                for s in range(4)])
        popped = pev.pop_k(q, TIME_MAX, 4)
        q = pev.clear_popped(q, popped, torch.full((h,), 4, dtype=torch.int32))
        res = torch.full((h,), 3, dtype=torch.int32)
        q = pev.q_push_many(q, [
            pev.Push(ones, torch.full((h,), 100), order(10), torch.ones(h, dtype=torch.int32), zp, res),
            pev.Push(ones, torch.full((h,), 101), order(11), torch.ones(h, dtype=torch.int32), zp, res),
        ])
        assert int((q.t == 100).sum()) == h and int((q.t == 101).sum()) == 0
        assert q.dropped.tolist() == [1, 1]
