"""PyTorch port vs JAX reference: the cross-shard exchange's pack and unpack
(B8 and the receive half of B12), the functions CUDA kernels K29 and K30
replace, and the per-event chain on a shard whose hosts do not start at 0.

`dshard_pack_plain` is held against JAX `_dshard_pack_blocks` (and its
grouping `dshard_segments`) slot for slot: blocks, per-shard counts and the
shed, on numpy-seeded outboxes whose rows fit, shed at a small block, leave
shards empty, all go to one shard, or address padded hosts, with invalid
rows between them and through a gear slice. `exchange_unpack_plain` is held
against the receive half of JAX `_exchange_alltoall` /
`_exchange_hierarchical` (the fill-count rule included) on the blocks of
four shards exchanged as the all-to-all moves them, and against the gather
path's rebase and validity on four shards' outboxes packed and gathered.
That receive half lives inside JAX's exchange functions, which run only
under the mesh, so `_jax_receive` restates its rebase, validity mask and
fill-count rule around JAX's own `_unpack_words_rows`: a copy of the
logic. What holds the port's receive half to JAX's own code is the world-4
runs of tests/test_torch_mesh.py (every exchange kind, a shedding block,
the hierarchical fill counts under gears), whose reports must equal
JAX's.
`Engine.event_body` at rank 2 of a world of 4 (hosts 2H .. 3H-1) is held
against JAX `_event_body` with the same `host_gid`: order keys, route
sources and the destination range are global. Tolerance: exact equality
throughout (integers and bools only).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core.engine import Outbox as JaxOutbox
from shadow_tpu.core.engine import _dshard_pack_blocks, _event_body, _unpack_words_rows
from shadow_tpu.core.engine import _ev_carry_of as jax_carry_of
from shadow_tpu.ops.merge import dshard_segments
from shadow_tpu.simtime import TIME_MAX
from shadow_tpu_torch.core.convert import engine_config_from
from shadow_tpu_torch.core.engine import Engine, _ev_carry_of
from shadow_tpu_torch.core.mesh import Collectives
from shadow_tpu_torch.ops.exchange import (
    ROW_WORDS,
    dshard_pack_plain,
    exchange_unpack_plain,
    pack_words,
)
from shadow_tpu_torch.testing import outbox_case
from test_torch_event import CASES, H, _build, _lanes, check_append, event_body

P = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: PyTorch's intra-op threads only add overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def outbox(seed: int, h_local: int, b: int, world: int, **kw) -> dict:
    """A shard's seeded outbox (`testing.outbox_case`) as numpy arrays."""
    return {k: v.numpy() for k, v in outbox_case(seed, h_local, b, world, **kw).items()}


def _jax_pack(ob: dict, h_local: int, world: int, k: int, cols: int):
    sl = {f: ob[f][:, :cols] for f in ("dst", "t", "order", "kind", "payload")}
    job = JaxOutbox(*(jnp.asarray(sl[f]) for f in ("dst", "t", "order", "kind", "payload")),
                    count=jnp.zeros((1,), jnp.int32))
    blocks, seg_len, shed = _dshard_pack_blocks(job, h_local, world, k)
    return np.asarray(blocks), np.asarray(seg_len), int(shed)


def _port_pack(ob: dict, h_local: int, world: int, k: int, cols: int):
    t = {f: torch.as_tensor(ob[f]) for f in ("dst", "t", "order", "kind", "payload")}
    blocks, seg_len, shed = dshard_pack_plain(t["dst"], t["t"], t["order"], t["kind"],
                                              t["payload"], h_local, world, k, cols)
    return blocks.numpy(), seg_len.numpy(), int(shed[0])


# (seed, h_local, budget, world, k, cols, outbox kwargs)
PACK_CASES = {
    "fit": (0, 12, 6, 4, 72, 0, {}),
    "shed_small_block": (1, 12, 6, 4, 5, 0, {"fill": 0.9}),
    "empty_shards": (2, 10, 4, 4, 40, 0, {"shards": [1, 3]}),
    "all_to_one_shard": (3, 16, 5, 4, 80, 0, {"shards": [2], "fill": 0.95}),
    "padded_hosts": (4, 8, 6, 4, 48, 0, {"num_real": 29}),
    "gear_slice": (5, 12, 8, 4, 24, 3, {"fill": 0.8}),
    "world_2_shed": (6, 20, 6, 2, 17, 0, {"fill": 0.7}),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_dshard_pack_plain_matches_jax(case):
    seed, h_local, b, world, k, cols, kw = PACK_CASES[case]
    ob = outbox(seed, h_local, b, world, **kw)
    want = _jax_pack(ob, h_local, world, k, cols or b)
    got = _port_pack(ob, h_local, world, k, cols)
    for x, y in zip(want[:2], got[:2]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)
    assert want[2] == got[2]
    # the grouping itself: JAX's segment counts, and the shed these cases aim at
    sl = slice(0, cols or b)
    t = ob["t"][:, sl].reshape(-1)
    ds = np.where(t != TIME_MAX, ob["dst"][:, sl].reshape(-1) // h_local, world)
    _, _, seg = dshard_segments(jnp.asarray(ds.astype(np.int32)), jnp.asarray(t),
                                jnp.asarray(ob["order"][:, sl].reshape(-1)), world)
    assert np.array_equal(np.asarray(seg), got[1])
    assert (got[2] > 0) == case.startswith(("shed", "world_2"))
    if case == "empty_shards":
        assert got[1][0] == got[1][2] == 0 < got[1][1]


def _jax_receive(recv: np.ndarray, my: int, h_local: int, counts=None):
    """The receive half of JAX's alltoall and hierarchical exchanges
    (shadow_tpu/core/engine.py, after each `lax.all_to_all`), restated
    around its `_unpack_words_rows`."""
    world, k = recv.shape[:2]
    flat = jnp.asarray(recv).reshape(world * k, -1)
    r_t, r_order, r_kind, r_payload = _unpack_words_rows(flat[:, 1:], P)
    local = flat[:, 0] - my * h_local
    valid = (r_t != TIME_MAX) & (local >= 0) & (local < h_local)
    if counts is not None:
        rr = jnp.arange(world * k, dtype=jnp.int32)
        valid = valid & ((rr % k) < jnp.asarray(counts)[rr // k])
    return [np.asarray(x) for x in (local, r_t, r_order, r_kind, r_payload, valid)]


@pytest.mark.parametrize("hier", [False, True])
def test_exchange_unpack_plain_matches_jax_alltoall(hier):
    """Four shards pack at a block that sheds on some of them; block j of
    shard i lands at row i of shard j's receive buffer (the all-to-all);
    every shard unpacks."""
    world, h_local, b, k = 4, 10, 6, 14
    packs = [_port_pack(outbox(10 + i, h_local, b, world, fill=0.7), h_local, world, k, 0)
             for i in range(world)]
    assert sum(p[2] for p in packs) > 0
    for j in range(world):
        recv = np.stack([packs[i][0][j] for i in range(world)])
        counts = (np.array([min(packs[i][1][j], k) for i in range(world)], np.int32)
                  if hier else None)
        if hier:
            # a fill count below the block's rows: the count rule, not the
            # invalid-row marker, drops the rest
            counts[1] = max(counts[1] - 2, 0)
        want = _jax_receive(recv, j, h_local, counts)
        got = exchange_unpack_plain(torch.as_tensor(recv), j * h_local, h_local,
                                    None if counts is None else torch.as_tensor(counts))
        for x, y in zip(want, got):
            assert np.array_equal(x, y.numpy()) and x.dtype == y.numpy().dtype


def test_exchange_unpack_plain_matches_jax_gather():
    """The gather path: four shards' outboxes (a gear slice of 3 columns)
    packed with a trailing count row, gathered rank-major and unpacked for
    shard 1, against JAX's flatten, rebase and validity of the gathered
    planes."""
    world, h_local, b, cols, me = 4, 9, 5, 3, 1
    obs = [outbox(20 + i, h_local, b, world) for i in range(world)]
    bufs = []
    for ob in obs:
        w = pack_words(*(torch.as_tensor(ob[f][:, :cols]) for f in
                         ("dst", "t", "order", "kind", "payload"))).reshape(-1, ROW_WORDS)
        bufs.append(torch.cat([w, torch.zeros((1, ROW_WORDS), dtype=torch.int32)]))
    got = exchange_unpack_plain(torch.stack(bufs), me * h_local, h_local, n=h_local * cols)
    g = {f: np.concatenate([ob[f][:, :cols] for ob in obs]) for f in
         ("dst", "t", "order", "kind", "payload")}
    local = g["dst"].reshape(-1) - me * h_local
    t = g["t"].reshape(-1)
    want = [local, t, g["order"].reshape(-1), g["kind"].reshape(-1), g["payload"].reshape(-1, P),
            (t != TIME_MAX) & (local >= 0) & (local < h_local)]
    for x, y in zip(want, got):
        assert np.array_equal(x, y.numpy()) and x.dtype == y.numpy().dtype


@pytest.mark.parametrize("name", [n for n in CASES if n != "phold_codel_delay"])
def test_event_body_on_a_shard_matches_jax(name):
    """The chain at rank 2 of 4: JAX `_event_body` with host_gid = 2H +
    arange(H) and the global host count, against the port's engine built
    for that rank (its `host_base`), on the same carry and event. The
    host -> node map is the global one (each shard's map tiled)."""
    world, rank = 4, 2
    jeng, jpar, jst, peng, ppar, pst, jev, pev, active, window_end = _build(name, 0)
    node_g = np.tile(np.asarray(jpar.node_of), world).astype(np.int32)
    jcfg = dataclasses.replace(jeng.cfg, num_hosts=world * H, world=world, hosts_per_node=0)
    jpar = jpar._replace(node_of=jnp.asarray(node_g))
    host_gid = rank * H + jnp.arange(H, dtype=jnp.int64)
    jc, jpush, jents, jused, _ = _event_body(
        jcfg, jeng.model, jax_carry_of(jst), jpar, host_gid, window_end, jev,
        jnp.asarray(active))
    pcfg = engine_config_from(jcfg, rank=rank)
    assert pcfg.host_base == rank * H
    eng = Engine(pcfg, peng.model, "cpu", Collectives(world, rank, torch.device("cpu")))
    pc, ppush, pents, pused = event_body(
        eng, _ev_carry_of(pst), ppar._replace(node_of=torch.as_tensor(node_g)), window_end, pev,
        torch.as_tensor(active))
    a, b = _lanes(jc), _lanes(pc)
    assert [k for k in b if k != "stats.ob_dropped" and not np.array_equal(a[k], b[k])] == []
    assert len(jpush) == len(ppush)
    for jp, pp in zip(jpush, ppush):
        for x, y in zip(jp, pp):
            assert np.array_equal(np.asarray(x), y.numpy())
    assert (jents == []) == (pents is None)
    if jents:
        assert len(jents) == pents.mask.shape[0]
        for e, je in enumerate(jents):
            for x, y in zip(je, pents):
                assert np.array_equal(np.asarray(x), y[e].numpy())
        assert np.array_equal(np.min(np.stack([np.asarray(u) for u in jused]), axis=0),
                              pused.numpy())
        # the sends' order keys carry the global source ids
        src = (pents.order.numpy() >> 40) & ((1 << 22) - 1)
        assert src.min() == rank * H and src.max() == rank * H + H - 1
    check_append(jst, jents, jused, pc)
