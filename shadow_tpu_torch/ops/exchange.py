"""The cross-shard exchange's pack and unpack (B8 and the receive half of
B12): port of shadow_tpu/ops/merge.py `dshard_segments`, `_pack_words`,
`_unpack_words` and shadow_tpu/core/engine.py `_dshard_pack_blocks`,
`_invalid_row` and the receive side of `_exchange_alltoall` /
`_exchange_hierarchical` / `_exchange`.

A wire row is `ROW_WORDS` int32 words: the destination host (a global id),
then the packed event — t and order as (low word, high word), kind, the P
payload words. `dshard_pack` groups a shard's (gear-sliced) outbox rows by
destination shard, each group in ascending (t, order) order (the row index
breaks ties, which unique order keys never need), and packs each group's
first k rows into block j of an i32[world, k, ROW_WORDS] buffer, the unused
slots holding the invalid row; it returns the blocks, each group's count
`seg_len` i32[world] and `shed` i64[1] = Σ max(seg_len - k, 0).
`exchange_unpack` turns received rows back into the merge's
(local, t, order, kind, payload, valid) planes.

This module holds kernels K29 `dshard_pack` and K30 `exchange_unpack`
(csrc/exchange.cu); `dshard_pack_plain` and `exchange_unpack_plain` beside
them are the plain PyTorch versions (stable `torch.sort` passes), used for
CPU tensors and as the kernels' reference on the card.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS, ORDER_MAX
from shadow_tpu_torch.simtime import TIME_MAX

ROW_WORDS = 1 + 2 + 2 + 1 + EVENT_PAYLOAD_WORDS  # dst word + the packed event

_pack_k = CudaKernel("exchange", "dshard_pack", ARG_BLOCK)
_unpack_k = CudaKernel("exchange", "exchange_unpack", ARG_BLOCK)


def pack_words(dst, t, order, kind, payload) -> torch.Tensor:
    """Rows (any leading shape) -> i32[..., ROW_WORDS]: the dst word, t and
    order as (low, high) int32 words, kind, payload."""
    lead = t.shape
    return torch.cat([
        dst.to(torch.int32).reshape(*lead, 1),
        t.to(torch.int64).contiguous().view(torch.int32).reshape(*lead, 2),
        order.to(torch.int64).contiguous().view(torch.int32).reshape(*lead, 2),
        kind.to(torch.int32).reshape(*lead, 1),
        payload.to(torch.int32).reshape(*lead, payload.shape[-1]),
    ], dim=-1)


def invalid_row(p_words: int = EVENT_PAYLOAD_WORDS, device="cpu") -> torch.Tensor:
    """The packed empty row: dst 0, t = TIME_MAX, order = ORDER_MAX."""
    one = torch.ones((1,), dtype=torch.int64, device=device)
    return pack_words(torch.zeros((1,), dtype=torch.int32, device=device), one * TIME_MAX,
                      one * ORDER_MAX, torch.zeros((1,), dtype=torch.int32, device=device),
                      torch.zeros((1, p_words), dtype=torch.int32, device=device))[0]


def _sliced(x: torch.Tensor, gc: int) -> torch.Tensor:
    return x[:, :gc].reshape(-1, *x.shape[2:])


def dshard_pack_plain(dst, t, order, kind, payload, h_local: int, world: int, k: int,
                      cols: int = 0):
    """The first `cols` columns (0 = all) of a shard's [H, B] outbox,
    grouped by destination shard dst // h_local in (t, order) order and
    packed into blocks. Returns (blocks i32[world, k, ROW_WORDS], seg_len
    i32[world], shed i64[1])."""
    gc = cols or dst.shape[1]
    dst_f, t_f, o_f, kind_f = (_sliced(x, gc) for x in (dst, t, order, kind))
    pay_f = _sliced(payload, gc)
    dev = t_f.device
    ds = torch.div(dst_f.to(torch.int64), h_local, rounding_mode="floor")
    ds = torch.where((t_f != TIME_MAX) & (ds >= 0) & (ds < world), ds, world)
    perm = torch.sort(o_f, stable=True).indices
    perm = perm[torch.sort(t_f[perm], stable=True).indices]
    perm = perm[torch.sort(ds[perm], stable=True).indices]
    seg_len = torch.bincount(ds, minlength=world + 1)[:world]
    first = torch.cumsum(seg_len, 0) - seg_len
    rr = torch.arange(k, device=dev)
    in_seg = rr[None, :] < torch.clamp_max(seg_len, k)[:, None]
    src = perm[torch.where(in_seg, first[:, None] + rr[None, :], 0).clamp_max(max(perm.numel() - 1, 0))]
    words = pack_words(dst_f, t_f, o_f, kind_f, pay_f)
    blocks = torch.where(in_seg[:, :, None], words[src],
                         invalid_row(pay_f.shape[-1], dev)[None, None, :])
    shed = torch.clamp_min(seg_len - k, 0).sum()[None]
    return blocks, seg_len.to(torch.int32), shed


def dshard_pack(dst, t, order, kind, payload, h_local: int, world: int, k: int, cols: int = 0):
    """`dshard_pack_plain` as K29 on CUDA (the outbox read in place; new
    output tensors)."""
    if on_cpu(t):
        return dshard_pack_plain(dst, t, order, kind, payload, h_local, world, k, cols)
    h, b = t.shape
    p = payload.shape[2]
    gc = cols or b
    if not 0 < gc <= b:
        raise ValueError(f"cols={cols} must be in [1, {b}]")
    if not (0 < world < 1024 and k > 0 and h_local > 0):
        raise ValueError(f"world={world}, k={k}, h_local={h_local} out of range")
    check(dst, torch.int32, (h, b), "outbox dst")
    check(t, torch.int64, (h, b), "outbox t")
    check(order, torch.int64, (h, b), "outbox order")
    check(kind, torch.int32, (h, b), "outbox kind")
    check(payload, torch.int32, (h, b, p), "outbox payload")
    dev = t.device
    m = h * gc
    keys_a = torch.empty((3 * m,), dtype=torch.int64, device=dev)
    keys_b = torch.empty((3 * m,), dtype=torch.int64, device=dev)
    first = torch.empty((world + 1,), dtype=torch.int32, device=dev)
    blocks = torch.empty((world, k, 6 + p), dtype=torch.int32, device=dev)
    seg_len = torch.empty((world,), dtype=torch.int32, device=dev)
    shed = torch.empty((1,), dtype=torch.int64, device=dev)
    _pack_k(arg_block([h, b, gc, p, world, k, h_local, addr(dst), addr(t), addr(order),
                       addr(kind), addr(payload), addr(keys_a), addr(keys_b), addr(first),
                       addr(blocks), addr(seg_len), addr(shed)]))
    return blocks, seg_len, shed


def exchange_unpack_plain(rows, base: int, h_local: int, counts=None, n: int | None = None):
    """Received rows i32[W, S, ROW_WORDS] (group w's first `n` rows are
    read; default all S) -> (local i32, t i64, order i64, kind i32, payload
    i32[., P], valid bool), W * n rows. `counts` i32[W]: group w's rows at
    index >= counts[w] are invalid (the hierarchical exchange's fill
    counters)."""
    w, s, words = rows.shape
    n = s if n is None else n
    g = rows[:, :n].reshape(w * n, words)
    t = g[:, 1:3].contiguous().view(torch.int64)[:, 0]
    order = g[:, 3:5].contiguous().view(torch.int64)[:, 0]
    local = g[:, 0] - int(base)
    valid = (t != TIME_MAX) & (local >= 0) & (local < h_local)
    if counts is not None:
        rr = torch.arange(w * n, device=rows.device)
        valid = valid & ((rr % max(n, 1)) < counts.to(torch.int64)[rr // max(n, 1)])
    return local, t, order, g[:, 5].contiguous(), g[:, 6:].contiguous(), valid


def exchange_unpack(rows, base: int, h_local: int, counts=None, n: int | None = None):
    """`exchange_unpack_plain` as K30 on CUDA (new output tensors)."""
    if on_cpu(rows):
        return exchange_unpack_plain(rows, base, h_local, counts, n)
    w, s, words = rows.shape
    n = s if n is None else n
    p = words - 6
    if p < 1 or not 0 <= n <= s:
        raise ValueError(f"rows of {words} words, n={n} of {s}: not a wire buffer")
    check(rows, torch.int32, (w, s, words), "rows")
    if counts is not None:
        check(counts, torch.int32, (w,), "counts")
    dev = rows.device
    r = w * n
    local = torch.empty((r,), dtype=torch.int32, device=dev)
    t = torch.empty((r,), dtype=torch.int64, device=dev)
    order = torch.empty((r,), dtype=torch.int64, device=dev)
    kind = torch.empty((r,), dtype=torch.int32, device=dev)
    payload = torch.empty((r, p), dtype=torch.int32, device=dev)
    valid = torch.empty((r,), dtype=torch.bool, device=dev)
    _unpack_k(arg_block([w, n, s, p, h_local, int(base), addr(rows), addr(counts), addr(local),
                         addr(t), addr(order), addr(kind), addr(payload), addr(valid)]))
    return local, t, order, kind, payload, valid


KERNELS = {"dshard_pack": _pack_k, "exchange_unpack": _unpack_k}
