"""The ensemble plane's per-replica kernels (csrc/ensemble.cu) and their plain
PyTorch versions: K31 `replica_window`, the barrier and microstep-loop test
of every replica at once, and K32 `replica_fold`, the per-replica xor of the
digest plane and sums of the ledger's counters.

R replicas are folded into R x H rows of every per-host plane (replica r
holds rows [r * H, (r + 1) * H)), so each kernel of the round runs once over
all R x H rows. K31 keeps the replicas' scalar lanes in one int64 [6, R]
block (`LANES`: window end, done, live, pending, microsteps this round,
sends this round), which the engine reads back in one copy per round and
per loop test. K31 runs one thread-block cluster per replica
(`window_cluster` blocks, sm_90). As elsewhere in ops/, CPU tensors run the plain version and
CUDA tensors launch the kernel; both update `lanes` and `pop_limit` in
place.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu

# the rows of the [6, R] lane block
WEND, DONE, LIVE, PENDING, STEPS, SENDS = range(6)
LANES = 6
ROUND, LOOP = 0, 1
MAX_FOLD_FIELDS = 16  # csrc/ensemble.cu kMaxFields
MAX_CLUSTER = 8  # K31's blocks per replica: the portable cluster size
ROWS_PER_BLOCK = 512  # K31: a block of 256 threads, one 16-byte load each

_window_k = CudaKernel("ensemble", "replica_window", ARG_BLOCK)
_fold_k = CudaKernel("ensemble", "replica_fold", ARG_BLOCK)


def make_lanes(done, device) -> torch.Tensor:
    """The [6, R] lane block with the replicas' done flags (a bool
    sequence) in row DONE and zeros elsewhere."""
    lanes = torch.zeros((LANES, len(done)), dtype=torch.int64)
    lanes[DONE] = torch.as_tensor(list(map(bool, done)), dtype=torch.int64)
    return lanes.to(device)


def window_cluster(rows: int) -> int:
    """K31's blocks per replica (one cluster): one per 512 rows, at most 8
    (config 8's 4,096 rows: 8)."""
    return max(1, min(MAX_CLUSTER, -(-rows // ROWS_PER_BLOCK)))


def replica_window_plain(mode: int, nt, lanes, pop_limit, *, rows: int, stop: int,
                         runahead: int, floor: int, dynamic: bool, min_used=None,
                         limit: int = 0, valve=None, ob_count=None) -> None:
    r_count = lanes.shape[1]
    ntr = nt.view(r_count, rows)
    if mode == ROUND:
        g = ntr.amin(1)
        was_done = lanes[DONE] != 0
        done = g >= stop
        gs = torch.clamp_max(g, stop)
        ra = torch.clamp_min(min_used, floor) if dynamic else torch.full_like(g, runahead)
        we = torch.where(ra > stop - gs, torch.full_like(gs, stop),
                         torch.clamp_max(gs + ra, stop))
        lanes[WEND] = torch.where(was_done, lanes[WEND], we)
        lanes[DONE] = (was_done | done).to(torch.int64)
        lanes[LIVE] = (~was_done & ~done).to(torch.int64)
        lanes[PENDING] = 0
        lanes[STEPS] = 0
        return
    we, live = lanes[WEND], lanes[LIVE] != 0
    any_ = (ntr < we[:, None]).any(1)
    v = valve.view(r_count, rows).amax(1) if valve is not None else lanes[STEPS]
    pend = live & any_ & (v < limit)
    lanes[PENDING] = pend.to(torch.int64)
    lanes[STEPS] = lanes[STEPS] + pend
    lanes[SENDS] = ob_count.to(torch.int64) if ob_count is not None else 0
    pop_limit.view(r_count, rows).copy_(torch.where(pend, we, 0)[:, None].expand(r_count, rows))


def replica_window(mode: int, nt, lanes, pop_limit, *, rows: int, stop: int, runahead: int,
                   floor: int, dynamic: bool, min_used=None, limit: int = 0, valve=None,
                   ob_count=None) -> None:
    """The replicas' barrier (`mode` ROUND: window end, done and live per
    replica from the R x `rows` next times `nt`, with the static `runahead`
    or, `dynamic`, each replica's `min_used` floored at `floor`; a replica
    already done stays frozen) or microstep-loop test (`mode` LOOP: pending
    where live, some host is before the window end and the valve — the
    replica's microsteps this round, or the largest of its rows' `valve`
    where given — is below `limit`; the microstep count and the sends lane
    (`ob_count`) updated; `pop_limit` [R x rows] set to the window end of
    pending replicas, 0 elsewhere). Updates `lanes` (i64[6, R]) and
    `pop_limit` in place; one K31 launch on CUDA, R clusters of
    `window_cluster(rows)` blocks."""
    if floor < 1 or runahead < 1:
        raise ValueError(f"runahead={runahead} and floor={floor} must be >= 1")
    if on_cpu(nt):
        return replica_window_plain(mode, nt, lanes, pop_limit, rows=rows, stop=stop,
                                    runahead=runahead, floor=floor, dynamic=dynamic,
                                    min_used=min_used, limit=limit, valve=valve,
                                    ob_count=ob_count)
    r_count = lanes.shape[1]
    n = r_count * rows
    check(nt, torch.int64, (n,), "next times")
    check(lanes, torch.int64, (LANES, r_count), "replica lanes")
    if dynamic:
        check(min_used, torch.int64, (r_count,), "min_used_lat")
    if mode == LOOP:
        check(pop_limit, torch.int64, (n,), "pop limit")
        if valve is not None:
            check(valve, torch.int64, (n,), "valve")
        if ob_count is not None:
            check(ob_count, torch.int32, (r_count,), "outbox count")
    _window_k(arg_block([
        r_count, rows, mode, int(dynamic), stop, runahead, floor, limit,
        addr(nt), addr(min_used if dynamic else None), addr(valve if mode == LOOP else None),
        addr(ob_count if mode == LOOP else None), addr(lanes),
        addr(pop_limit if mode == LOOP else None), window_cluster(rows),
    ]))


def replica_fold_plain(digest, fields, r_count: int, num_real: int) -> torch.Tensor:
    rows = digest.shape[0] // r_count
    x = digest.view(r_count, rows)[:, :num_real]
    while x.shape[1] > 1:  # xor the halves (an odd column waits a level)
        half = x.shape[1] // 2
        x = torch.cat([x[:, :half] ^ x[:, half:2 * half], x[:, 2 * half:]], dim=1)
    x = x[:, 0] if num_real else torch.zeros((r_count,), dtype=torch.int64, device=digest.device)
    sums = [f.view(r_count, rows)[:, :num_real].sum(1) for f in fields]
    return torch.stack([x, *sums], dim=1)


def replica_fold(digest, fields, r_count: int, num_real: int | None = None) -> torch.Tensor:
    """Per replica, the xor of the first `num_real` rows of the digest plane
    (i64[R x H], uint64 bit patterns) and the sums of each i64[R x H]
    plane of `fields` over the same rows: i64[R, 1 + len(fields)]. A new
    tensor; one K32 launch on CUDA."""
    rows = digest.shape[0] // r_count
    n = rows if num_real is None else num_real
    if len(fields) > MAX_FOLD_FIELDS or not 0 <= n <= rows:
        raise ValueError(f"replica_fold: {len(fields)} fields (max {MAX_FOLD_FIELDS}), "
                         f"{n} real hosts of {rows}")
    if on_cpu(digest):
        return replica_fold_plain(digest, fields, r_count, n)
    check(digest, torch.int64, (r_count * rows,), "digest")
    for f in fields:
        check(f, torch.int64, (r_count * rows,), "fold field")
    out = torch.empty((r_count, 1 + len(fields)), dtype=torch.int64, device=digest.device)
    _fold_k(arg_block([r_count, rows, n, len(fields), addr(digest), *(addr(f) for f in fields),
                       addr(out)]))
    return out


KERNELS = {"replica_window": _window_k, "replica_fold": _fold_k}
