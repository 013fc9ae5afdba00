"""PyTorch port vs JAX reference: the event-queue ops (K1-K3) and the
exchange merge (K4) on numpy-seeded random slabs, through the port's plain
PyTorch versions (the CPU path).

Cases cover nearly full and full queues, long merge segments past the insert
cap, empty rounds and heavy time ties. Tolerance: exact equality — every
output is an integer. The JAX ops run as the JAX package runs them on the
CPU; the merge is also held against its gather formulation.

The kernels themselves are checked against these plain versions on the card
by chip_smoke.py phase 2 and by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.ops import events as jev
from shadow_tpu.ops import merge as jmerge
from shadow_tpu_torch.ops import events as pev
from shadow_tpu_torch.ops import merge as pmerge

H, C, P = 24, 16, 4
TIME_MAX = (1 << 63) - 1
ORDER_MAX = (1 << 63) - 1
FILLS = {
    "empty": lambda r: np.zeros(H, int),
    "sparse": lambda r: r.integers(0, 4, H),
    "mixed": lambda r: r.integers(0, C + 1, H),
    "nearly_full": lambda r: C - r.integers(0, 3, H),
    "full": lambda r: np.full(H, C),
}


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


def jq(arrs):
    return jev.EventQueue(*(jnp.asarray(a) for a in arrs))


def pq(arrs):
    return pev.EventQueue(*(torch.as_tensor(a) for a in arrs))


def same(j, p) -> bool:
    return np.array_equal(np.asarray(j), p.numpy())


def assert_queue_equal(jqq, pqq):
    for f in jev.EventQueue._fields:
        assert same(getattr(jqq, f), getattr(pqq, f)), f


CASES = [(s, k) for k in FILLS for s in (1, 2)]


@pytest.mark.parametrize("seed,fill", CASES)
def test_next_time(seed, fill):
    a = slab(seed, fill)
    assert same(jev.next_time(jq(a)), pev.next_time(pq(a)))
    assert same(jev.queue_len(jq(a)), pev.queue_len(pq(a)))


@pytest.mark.parametrize("seed,fill", CASES)
def test_pop_min_sequence(seed, fill):
    a = slab(seed, fill)
    j, p = jq(a), pq(a)
    for limit in (0, 2500, 2500, 6000, 6000, TIME_MAX, TIME_MAX):
        j, jev_, jact = jev.pop_min(j, limit)
        p, pev_, pact = pev.pop_min(p, limit)
        assert same(jact, pact)
        for f in jev.Event._fields:
            assert same(getattr(jev_, f), getattr(pev_, f)), f
        assert_queue_equal(j, p)


@pytest.mark.parametrize("seed,fill", CASES)
def test_push_many(seed, fill):
    a = slab(seed, fill)
    r = np.random.default_rng(100 + seed)
    pushes = []
    for _ in range(3):
        pushes.append((
            r.random(H) < 0.7,
            r.integers(0, 1 << 40, H),
            r.integers(0, 1 << 62, H),
            r.integers(0, 1 << 18, H).astype(np.int32),
            r.integers(-(1 << 31), 1 << 31, (H, P)).astype(np.int32),
        ))
    j = jev.push_many(jq(a), [tuple(jnp.asarray(x) for x in pp) for pp in pushes])
    p = pev.push_many(pq(a), [pev.Push(*(torch.as_tensor(x) for x in pp)) for pp in pushes])
    assert_queue_equal(j, p)
    j1 = jev.push_one(jq(a), *(jnp.asarray(x) for x in pushes[0]))
    p1 = pev.push_one(pq(a), *(torch.as_tensor(x) for x in pushes[0]))
    assert_queue_equal(j1, p1)


def rows(seed: int, n_valid: int, hot: int):
    """Exchange rows: random destinations, `hot` extra rows to host 5."""
    r = np.random.default_rng(seed)
    n = H * 12
    dst = r.integers(0, H, n).astype(np.int32)
    dst[:hot] = 5
    valid = np.zeros(n, bool)
    valid[r.permutation(n)[:n_valid]] = True
    valid[:hot] = True
    t = r.integers(10, 16, n) * 1000  # ties on time, unique orders
    order = (r.permutation(n).astype(np.int64)) | (r.integers(0, H, n) << 40)
    kind = r.integers(0, 1 << 18, n).astype(np.int32)
    payload = r.integers(-(1 << 31), 1 << 31, (n, P)).astype(np.int32)
    return dst, t, order, kind, payload, valid


MERGE_CASES = [
    ("empty_round", "mixed", 0, 0),
    ("light", "sparse", 30, 0),
    ("long_segment", "sparse", 40, 60),
    ("full_queues", "full", 100, 0),
    ("nearly_full", "nearly_full", 150, 20),
    ("heavy", "mixed", H * 12, 0),
]


@pytest.mark.parametrize("shed_urgency", [True, False])
@pytest.mark.parametrize("name,fill,n_valid,hot", MERGE_CASES)
def test_merge_flat_events(name, fill, n_valid, hot, shed_urgency):
    a = slab(7, fill)
    rr = rows(len(name), n_valid, hot)
    for max_inserts in (C, 5):
        p = pmerge.merge_flat_events(pq(a), *(torch.as_tensor(x) for x in rr), max_inserts,
                                     shed_urgency=shed_urgency)
        for path in ("scatter", "gather"):
            j = jmerge.merge_flat_events(jq(a), *(jnp.asarray(x) for x in rr), max_inserts,
                                         shed_urgency=shed_urgency, force_path=path)
            assert_queue_equal(j, p)


def test_pack_order_roundtrip():
    src = torch.tensor([0, 1, 12345, (1 << 22) - 1])
    seq = torch.tensor([0, 5, (1 << 40) + 3, 77])
    o = pev.pack_order(1, src, seq)
    jo = jev.pack_order(1, jnp.asarray(src.numpy()), jnp.asarray(seq.numpy()))
    assert same(jo, o)
    assert torch.equal(pev.unpack_order_src(o), src)

