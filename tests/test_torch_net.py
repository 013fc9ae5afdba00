"""PyTorch port vs JAX reference: the token bucket and the CoDel control law
(shadow_tpu_torch/net vs shadow_tpu/net).

Tolerance: exact equality. Both are int64 state machines; CoDel's control
law is float64 `round(INTERVAL / sqrt(count))`, whose sqrt is not correctly
rounded on every backend, so the law is checked exhaustively over counts
1..10^6 (every count a run could reach).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.net import codel as jcodel
from shadow_tpu.net import tokenbucket as jtb
from shadow_tpu_torch.net import codel as pcodel
from shadow_tpu_torch.net import tokenbucket as ptb

H = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same(j, p) -> bool:
    return np.array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_token_bucket_sequence(seed):
    r = np.random.default_rng(seed)
    refill = np.where(r.random(H) < 0.2, 0, r.integers(1, 20_000, H)).astype(np.int64)
    cap = (refill + 12_000).astype(np.int64)
    jp = jtb.TBParams(jnp.asarray(cap), jnp.asarray(refill))
    pp = ptb.TBParams(torch.as_tensor(cap), torch.as_tensor(refill))
    js, ps = jtb.tb_init(jp), ptb.tb_init(pp)
    t = np.zeros(H, np.int64)
    for _ in range(60):
        t = t + r.integers(0, 3_000_000, H)
        size = r.integers(0, 200_000, H).astype(np.int64)
        mask = r.random(H) < 0.7
        js, jd = jtb.tb_conforming_remove(js, jp, 1_000_000, jnp.asarray(t), jnp.asarray(size),
                                          jnp.asarray(mask))
        ps, pd = ptb.tb_conforming_remove(ps, pp, 1_000_000, torch.as_tensor(t),
                                          torch.as_tensor(size), torch.as_tensor(mask))
        assert same(jd, pd)
        assert same(js.tokens, ps.tokens) and same(js.last_itv, ps.last_itv)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_codel_sequence(seed):
    r = np.random.default_rng(seed)
    js, ps = jcodel.codel_init(H), pcodel.codel_init(H, "cpu")
    now = np.zeros(H, np.int64)
    drops = 0
    for _ in range(300):
        now = now + r.integers(0, 40_000_000, H)
        sojourn = np.where(r.random(H) < 0.6, r.integers(5_000_000, 60_000_000, H), 0)
        mask = r.random(H) < 0.8
        js, jd = jcodel.codel_on_packet(js, jnp.asarray(now), jnp.asarray(sojourn),
                                        jnp.asarray(mask))
        ps, pd = pcodel.codel_on_packet(ps, torch.as_tensor(now), torch.as_tensor(sojourn),
                                        torch.as_tensor(mask))
        assert same(jd, pd)
        drops += int(pd.sum())
        for f in jcodel.CodelState._fields:
            assert same(getattr(js, f), getattr(ps, f)), f
    # the dropping state machine was exercised, re-entry decay included
    assert drops > 0 and int(ps.count.max()) >= 2


def test_control_law_exhaustive_counts():
    counts = np.arange(1, 1_000_001, dtype=np.int32)
    now = np.full(counts.shape, 123_456_789, np.int64)
    want = np.asarray(jcodel._control_law(jnp.asarray(now), jnp.asarray(counts)))
    got = pcodel.control_law(torch.as_tensor(now), torch.as_tensor(counts)).numpy()
    assert np.array_equal(want, got)
