"""PyTorch port vs JAX reference: PHOLD's exponential draw.

`-log(f32)` decides every held delay, and `torch.log` differs from XLA-CPU's
`jnp.log` in the last bit on millions of float32 inputs, so the port carries
XLA-CPU's own log algorithm (shadow_tpu_torch/models/phold.py `log_f32`).
Tolerance: exact equality, checked over all 2^24 inputs the model can draw
(x = max(1e-7, 1 - u24 / 2^24)), and on the delays themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.models.phold import _exp_delay as j_exp_delay
from shadow_tpu_torch.models.phold import exp_delay, log_f32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, PyTorch's
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    u = np.arange(1 << 24, dtype=np.int64).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return u, np.maximum(np.float32(1e-7), np.float32(1.0) - u)


def test_log_bit_identical_on_all_2_24_inputs():
    _, x = _inputs()
    want = np.asarray(jnp.log(jnp.asarray(x))).view(np.int32)
    got = log_f32(torch.from_numpy(x)).numpy().view(np.int32)
    assert int((want != got).sum()) == 0


def test_exp_delay_bit_identical():
    u, _ = _inputs()
    u = u[::61]  # a strided sweep of the draw range, both ends included
    u = np.concatenate([u, [np.float32(1.0 - 2.0**-24)]])
    for mean_ns in (1_000_000, 200_000_000, 3_000_000_000):
        mean = np.full(u.shape, mean_ns, np.int64)
        want = np.asarray(j_exp_delay(jnp.asarray(u), jnp.asarray(mean)))
        got = exp_delay(torch.from_numpy(u), torch.from_numpy(mean)).numpy()
        assert np.array_equal(want, got), mean_ns
