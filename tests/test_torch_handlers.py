"""PyTorch port vs JAX reference: the model handlers (B18, B19), the
functions the CUDA kernels K17-K22 replace.

Each model's plain version (`handle_plain` of tgen_tcp, phold, udp_echo,
timer, gossip and circuit) is held against the JAX model's `handle`, run op by op on the CPU as
a function of numpy data, on the same numpy-seeded inputs
(`shadow_tpu_torch.testing.handler_case`: random params, state, RNG lanes
and one event per host, some hosts not dispatched, some at TIME_MAX; for
tgen-TCP coherent connections in every client and server state). Every
state lane, every field of every push and send port, and the RNG lanes
must be equal: tolerance zero, since every output is an integer, a bool,
or an integer made from float32/float64 math. The event is read at a host
stride of 1 and as a column of a K = 4 peek. A coverage test asserts the
cases drive the branches that matter (tgen's fast retransmits, timeouts,
retransmits, duplicate segments and completed flows, and every segment
type on the wire; PHOLD's two draws and its 1 us floor; each echo role;
gossip's publish, fresh and stale messages and current, superseded and
last continuations; circuit's idle and busy ticks, cells at a relay and
back home, and a forward on each hop and direction),
so that an untested branch cannot pass. The JAX reference runs once per
(model, seed) for the module.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.models import get_model as jax_get_model
from shadow_tpu.models.base import HandlerCtx as JaxCtx
from shadow_tpu.ops.rng import RngState as JaxRng
from shadow_tpu_torch.models import tgen
from shadow_tpu_torch.models.base import HandlerCtx
from shadow_tpu_torch.testing import HANDLER_MODELS, handler_case, handler_tensors

H = 64
SEEDS = (0, 1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_numpy(x) -> np.ndarray:
    """A JAX or torch output as numpy, with the reference's unsigned lanes
    (uint64 RNG, uint32 reassembly bitmap) as the port carries them."""
    a = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def jax_outputs(model: str, seed: int) -> tuple[dict, dict]:
    """(inputs as numpy, {name: numpy} of the JAX handler's outputs)."""
    case = handler_case(model, seed, H, "cpu")
    a = case["np"]
    m = jax_get_model(model)()
    if model == "tgen_tcp":
        m.tx_batch = case["model"].tx_batch
    ctx = JaxCtx(
        t=jnp.asarray(a["t"]), window_end=jnp.asarray(case["ctx"].window_end, jnp.int64),
        kind=jnp.asarray(a["kind"]), payload=jnp.asarray(a["payload"]),
        active=jnp.asarray(a["active"]), is_packet=jnp.asarray(a["is_packet"]),
        src=jnp.asarray(a["src"]), host_id=jnp.asarray(a["host_id"]),
        state={k: jnp.asarray(v.astype(np.uint32) if k == "sv_bm" else v)
               for k, v in a["state"].items()},
        params={k: jnp.asarray(v) for k, v in a["params"].items()},
        rng=JaxRng(jnp.asarray(a["rng"].view(np.uint64))),
    )
    return a, {k: as_numpy(v) for k, v in handler_tensors(m.handle(ctx)).items()}


@pytest.fixture(scope="module")
def jax_ref():
    return functools.lru_cache(maxsize=None)(jax_outputs)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model", HANDLER_MODELS)
def test_plain_handler_matches_jax(jax_ref, model, seed, stride):
    case = handler_case(model, seed, H, "cpu", stride=stride)
    assert case["ctx"].t.stride(0) == stride
    got = {k: as_numpy(v) for k, v in handler_tensors(case["model"].handle_plain(case["ctx"]))
           .items()}
    want = jax_ref(model, seed)[1]
    assert got.keys() == want.keys()
    assert [k for k in want if got[k].dtype != want[k].dtype
            or not np.array_equal(got[k], want[k])] == []


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model", HANDLER_MODELS)
def test_handler_case_covers_branches(jax_ref, model, seed):
    """The reference's outputs on each case move what the case is for."""
    a, out = jax_ref(model, seed)
    st = a["state"]
    if model == "tgen_tcp":
        for lane in ("fast_rtx", "timeouts", "d_rtx", "dup_segs", "flows_done", "segs_rcvd",
                     "bytes_rcvd", "fct_sum"):
            assert (out[f"state.{lane}"] != st[lane]).any(), lane
        sent = out["send0.mask"]
        types = set((out["send0.payload"][sent, tgen.PW_META] & 0xFF).tolist())
        assert types == {tgen.FT_SYN, tgen.FT_SYNACK, tgen.FT_DATA, tgen.FT_ACK, tgen.FT_FIN,
                         tgen.FT_FINACK}
        assert (out["send0.count"][sent] > 1).any()  # a DATA burst
        assert out["push0.mask"].any()  # the TX chain
        kinds = set(out["push1.kind"][out["push1.mask"]].tolist())
        assert kinds == {tgen.KIND_TICK, tgen.KIND_RTO, tgen.KIND_DELACK}
        for lane in ("rcv_nxt", "sv_bm", "cwnd_x", "ssth_x", "recover", "srtt", "rto",
                     "deadline", "da_t"):
            assert (out[f"state.{lane}"] != st[lane]).any(), lane
    elif model == "phold":
        assert out["push0.mask"].any() and out["send0.mask"].any()
        assert (out["push0.t"][out["push0.mask"]] - a["t"][out["push0.mask"]] == 1_000).any()
        assert (out["rng"] != a["rng"]).any()
    elif model == "udp_echo":
        assert out["push0.mask"].any() and out["send1.mask"].any()
        assert (out["state.rtt_sum"] != st["rtt_sum"]).any()
    elif model == "gossip":
        # GOSSIP_FORCED: publish, fresh and stale message, current,
        # superseded and last continuation
        assert out["push0.mask"][:6].tolist() == [True, True, False, False, False, False]
        assert out["push1.mask"][0] and out["send0.mask"][:6].tolist() == [
            False, False, False, True, False, True]
        assert out["push2.mask"][:6].tolist() == [False, False, False, True, False, False]
        assert (out["state.adopted"] != st["adopted"]).any()
        assert (out["state.fwd_idx"] != st["fwd_idx"]).any()
    elif model == "circuit":
        # CIRCUIT_FORCED: idle and busy tick, cell at a relay and back home,
        # a forward on each hop and direction (every next-hop branch)
        assert out["send0.mask"][:2].tolist() == [True, False]
        assert out["push0.mask"][:2].all() and out["push1.mask"][2]
        assert out["send1.mask"][4:9].all() and not out["send1.mask"][:4].any()
        assert (out["send1.payload"][4:9, 3] >> 8).tolist() == [0, 0, 1, 1, 1]
        for lane in ("cells_done", "rtt_sum", "fwd", "outstanding", "launch_t"):
            assert (out[f"state.{lane}"] != st[lane]).any(), lane
    else:
        assert out["push0.mask"].any() and (out["state.fires"] != st["fires"]).any()


@pytest.mark.parametrize("model", HANDLER_MODELS)
def test_handle_runs_plain_on_the_cpu(model):
    """`handle` on CPU tensors is `handle_plain`; a context on another
    device is refused, never run by the plain version."""
    case = handler_case(model, 7, H, "cpu", stride=2)
    m, ctx = case["model"], case["ctx"]
    got, want = handler_tensors(m.handle(ctx)), handler_tensors(m.handle_plain(ctx))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    meta = HandlerCtx(**{**ctx.__dict__, "t": torch.empty((H,), dtype=torch.int64,
                                                            device="meta")})
    with pytest.raises(ValueError, match="unsupported device"):
        m.handle(meta)
