"""PyTorch port vs JAX reference: the per-host xoshiro256++ lanes
(shadow_tpu_torch/ops/rng.py vs shadow_tpu/ops/rng.py).

Tolerance: exact equality. The lanes are uint64 in the reference and int64
bit patterns in the port; states and draws are compared bit for bit, and the
float32 uniforms are compared as bits too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.ops import rng as jrng
from shadow_tpu_torch.ops import rng as prng

H = 37


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int64) if a.dtype.itemsize == 8 else a.view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**63 + 12345])
def test_init_bit_identical(seed):
    js = jrng.rng_init(H, seed)
    ps = prng.rng_init(H, seed, "cpu")
    assert np.array_equal(_bits(js.s), _bits(ps.s))


@pytest.mark.parametrize("seed", [3, 99])
def test_masked_draw_sequence_bit_identical(seed):
    rng = np.random.default_rng(seed)
    js = jrng.rng_init(H, seed)
    ps = prng.rng_init(H, seed, "cpu")
    for step in range(40):
        mask = rng.random(H) < 0.5
        if step % 2:
            js, jx = jrng.rng_next_u64(js, jnp.asarray(mask))
            ps, px = prng.rng_next_u64(ps, torch.as_tensor(mask))
        else:
            js, jx = jrng.rng_uniform(js, jnp.asarray(mask))
            ps, px = prng.rng_uniform(ps, torch.as_tensor(mask))
            assert px.dtype == torch.float32
        assert np.array_equal(_bits(jx), _bits(px)), step
        assert np.array_equal(_bits(js.s), _bits(ps.s)), step


def test_lshr_and_rotl_are_logical():
    vals = np.array([0, 1, -1, -(2**63), 2**63 - 1, -123456789], np.int64)
    x = torch.as_tensor(vals)
    u = vals.view(np.uint64)
    for k in (1, 17, 23, 30, 40, 45, 63):
        assert np.array_equal(prng.lshr(x, k).numpy().view(np.uint64), u >> np.uint64(k))
        want = (u << np.uint64(k)) | (u >> np.uint64(64 - k))
        assert np.array_equal(prng.rotl(x, k).numpy().view(np.uint64), want)
