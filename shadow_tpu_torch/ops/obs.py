"""The observatories' device programs: the round trace row (B16) as kernel
K27 `trace_round` and the flow-ledger append (B17) as kernel K28
`flow_append` (csrc/obs.cu), each with its plain PyTorch version beside
it. As in the other ops modules, each public function dispatches on where
its tensors live: CPU tensors run the plain version, CUDA tensors launch
the kernel, there is no fallback. Both versions write the ring, its cursor
and the counters they fold IN PLACE.

K27 ports `_trace_round` (shadow_tpu/core/engine.py:1971): one int64 row of
the 25 columns of obs/tracer.py TRACE_FIELDS per completed round, written
at `cursor % R`. Its counter columns are deltas over the round, so the
engine keeps the round-entry values of the cumulative counters in a small
scratch (`TraceScratch`): `trace_enter` fills it from the state at a
chunk's entry, and every round's launch makes its own post-round values
the next round's entry, so no round needs a host read.

K28 ports `_flow_append` (:2661): a microstep's flow-completion entries
(one per event column, in order; the record lanes K17 wrote) go to the
ledger ring with host-major slots from an exclusive prefix sum over the
completion mask, at `(cursor + offset) % R`; only the newest R completions
of one entry are written, the cursor advances by all of them, and the
fl_done / fl_bytes / fl_rtx totals fold the entry's completions as the
JAX package's `_event_body` does (:2391-2404).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow_tpu_torch.obs.netobs import FLOW_COLS
from shadow_tpu_torch.obs.tracer import (
    COL_BQ_REBUILDS,
    COL_CAP,
    COL_EC_APP,
    COL_EC_PKT,
    COL_EC_TIMER,
    COL_EVENTS,
    COL_FAULTS_DELAYED,
    COL_FAULTS_DROPPED,
    COL_FLOWS,
    COL_GEAR,
    COL_HOSTS_DOWN,
    COL_MICROSTEPS,
    COL_NEXT_TIME,
    COL_OB_HWM,
    COL_OCC_HWM,
    COL_POPK_DEFERRED,
    COL_ROUND,
    COL_SENDS,
    COL_WINDOW_END,
    COL_WINDOW_START,
    TRACE_COLS,
)
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu

# the cumulative counters whose per-round deltas the row carries, in the
# scratch's (and csrc/obs.cu kScratch's) order, with their row columns
SCRATCH_LANES = ("events", "popk_deferred", "bq_rebuilds", "faults_dropped", "faults_delayed",
                 "ec_timer", "ec_pkt", "ec_app", "fl_done")
_SCRATCH_COLS = (COL_EVENTS, COL_POPK_DEFERRED, COL_BQ_REBUILDS, COL_FAULTS_DROPPED,
                 COL_FAULTS_DELAYED, COL_EC_TIMER, COL_EC_PKT, COL_EC_APP, COL_FLOWS)
# lanes summed over hosts ([H]); the others are [1] lanes read as they are
_HOST_LANES = ("events", "faults_dropped", "faults_delayed")

_trace_k = CudaKernel("obs", "trace_round", ARG_BLOCK)
_flow_k = CudaKernel("obs", "flow_append", ARG_BLOCK)


def make_trace_scratch(device) -> torch.Tensor:
    """The round-entry values of `SCRATCH_LANES`, i64[9]."""
    return torch.zeros((len(SCRATCH_LANES),), dtype=torch.int64, device=device)


def counter_values_plain(stats) -> torch.Tensor:
    """The current values of `SCRATCH_LANES`, i64[9] (0 for a lane whose
    plane is off)."""
    vals = []
    for name in SCRATCH_LANES:
        x = getattr(stats, name, None)  # None: the plane is off
        if x is None:
            vals.append(torch.zeros((), dtype=torch.int64, device=stats.events.device))
        else:
            vals.append(x.sum() if name in _HOST_LANES else x[0])
    return torch.stack(vals)


def _scratch_args(stats) -> list[int]:
    h = stats.events.shape[0]
    out = []
    for name in SCRATCH_LANES:
        x = getattr(stats, name, None)  # None: the plane is off
        if x is not None:
            check(x, torch.int64, (h,) if name in _HOST_LANES else (1,), f"stats {name}")
        out.append(addr(x))
    return out


def trace_enter(scratch: torch.Tensor, stats) -> None:
    """Fill the scratch with the state's counter values (a chunk's entry)."""
    if on_cpu(scratch):
        scratch.copy_(counter_values_plain(stats))
        return
    check(scratch, torch.int64, (len(SCRATCH_LANES),), "trace scratch")
    h = stats.events.shape[0]
    _trace_k(arg_block([0, h, 0, addr(scratch), *_scratch_args(stats)] + [0] * 16))


class RoundInputs(NamedTuple):
    """What one round's row reads besides the counters: host scalars of the
    round loop and device lanes the round already computed."""

    rounds: torch.Tensor  # i64[] stats.rounds at the round's entry
    window_start: int  # the state's `now` at the round's entry (ns)
    window_end: int
    steps: int  # microsteps this round
    sends: torch.Tensor  # i32[1] the outbox count before the exchange
    occ: torch.Tensor  # i64[H] per-host queue occupancy after the exchange
    heads: torch.Tensor  # i64 plane whose minimum is the queue's next time
    ob_hwm: torch.Tensor  # i64[] the most sends one host staged
    gear: int  # the merge width in force
    cap: int  # the active queue capacity
    crash: tuple | None  # (down_t, up_t) i64[H, W] crash windows, or None


def trace_round_plain(ring, scratch: torch.Tensor, stats, r: RoundInputs) -> None:
    """`_trace_round` for one completed round: the row at cursor % R, the
    cursor bumped, the scratch advanced to the post-round counters."""
    dev = scratch.device
    cur = counter_values_plain(stats)
    row = torch.zeros((TRACE_COLS,), dtype=torch.int64, device=dev)
    row[COL_ROUND] = r.rounds
    row[COL_WINDOW_START] = r.window_start
    row[COL_WINDOW_END] = r.window_end
    row[COL_MICROSTEPS] = r.steps
    row[COL_SENDS] = r.sends[0].to(torch.int64)
    row[COL_OCC_HWM] = r.occ.max()
    row[COL_NEXT_TIME] = r.heads.min()
    row[COL_OB_HWM] = r.ob_hwm
    row[COL_GEAR] = r.gear
    row[COL_CAP] = r.cap
    for col, d in zip(_SCRATCH_COLS, cur - scratch):
        row[col] = d
    if r.crash is not None:
        # hosts inside a crash window at the round's end
        down_t, up_t = r.crash
        row[COL_HOSTS_DOWN] = ((down_t <= r.window_end) & (r.window_end < up_t)).any(dim=1).sum()
    idx = ring.cursor % ring.rows.shape[1]
    ring.rows[0].index_copy_(0, idx, row[None])
    ring.cursor.add_(1)
    scratch.copy_(cur)


def trace_round(ring, scratch: torch.Tensor, stats, r: RoundInputs) -> None:
    """`trace_round_plain` as one launch of K27 on CUDA."""
    if on_cpu(scratch):
        trace_round_plain(ring, scratch, stats, r)
        return
    h = stats.events.shape[0]
    nr = ring.rows.shape[1]
    check(ring.rows, torch.int64, (1, nr, TRACE_COLS), "trace rows")
    check(ring.cursor, torch.int64, (1,), "trace cursor")
    check(scratch, torch.int64, (len(SCRATCH_LANES),), "trace scratch")
    check(r.rounds, torch.int64, (), "rounds")
    check(r.sends, torch.int32, (1,), "outbox count")
    check(r.occ, torch.int64, (h,), "occupancy")
    check(r.ob_hwm, torch.int64, (), "ob_hwm")
    if r.heads.dtype != torch.int64 or not r.heads.is_contiguous():
        raise ValueError("queue heads: expected a contiguous int64 plane")
    w = 0
    if r.crash is not None:
        w = r.crash[0].shape[1]
        check(r.crash[0], torch.int64, (h, w), "fault down_t")
        check(r.crash[1], torch.int64, (h, w), "fault up_t")
    _trace_k(arg_block([
        1, h, nr, addr(scratch), *_scratch_args(stats),
        addr(r.rounds), int(r.window_start), int(r.window_end), int(r.steps), addr(r.sends),
        addr(r.occ), addr(r.heads), r.heads.numel(), addr(r.ob_hwm), int(r.gear), int(r.cap),
        w, addr(r.crash[0] if w else None), addr(r.crash[1] if w else None),
        addr(ring.rows), addr(ring.cursor),
    ]))


class FlowLanes(NamedTuple):
    """A microstep's flow-completion records, one row per event column
    ([E, H] each; row j is what K17 wrote for the microstep's j-th event):
    the completion mask and FLOW_FIELDS' lanes after the source host."""

    mask: torch.Tensor  # bool[E, H]
    dst: torch.Tensor  # i64[E, H]
    flow: torch.Tensor  # i64[E, H]
    t_start: torch.Tensor  # i64[E, H]
    t_end: torch.Tensor  # i64[E, H]
    bytes: torch.Tensor  # i64[E, H]
    retransmits: torch.Tensor  # i64[E, H]

    def row(self, j: int) -> "FlowLanes":
        """Column j's [H] lanes (views)."""
        return FlowLanes(*(x[j] for x in self))


def make_flow_lanes(e: int, h: int, device) -> FlowLanes:
    """Uninitialized lanes for E event columns (every lane of every column
    is written before the append reads it)."""
    return FlowLanes(torch.empty((e, h), dtype=torch.bool, device=device),
                     *(torch.empty((e, h), dtype=torch.int64, device=device) for _ in range(6)))


def flow_append_plain(ledger, lanes: FlowLanes, fl_done, fl_bytes, fl_rtx) -> None:
    """`_flow_append` and the fl_* fold over the entries in column order."""
    rows = ledger.rows[0]
    fr = rows.shape[0]
    h = lanes.mask.shape[1]
    src = torch.arange(h, dtype=torch.int64, device=rows.device)
    for j in range(lanes.mask.shape[0]):
        m = lanes.mask[j]
        m64 = m.to(torch.int64)
        ofs = torch.cumsum(m64, 0) - m64  # exclusive prefix: per-host slot
        n = m64.sum()
        live = m & (ofs >= n - fr)
        slot = (ledger.cursor + ofs) % fr
        row = torch.stack([src, lanes.dst[j], lanes.flow[j], lanes.t_start[j], lanes.t_end[j],
                           lanes.bytes[j], lanes.retransmits[j]], dim=1)
        rows.index_copy_(0, slot[live], row[live])
        ledger.cursor.add_(n)
        fl_done.add_(n)
        fl_bytes.add_(torch.where(m, lanes.bytes[j], 0).sum())
        fl_rtx.add_(torch.where(m, lanes.retransmits[j], 0).sum())


def flow_append(ledger, lanes: FlowLanes, fl_done, fl_bytes, fl_rtx) -> None:
    """`flow_append_plain` as one launch of K28 on CUDA, walking the
    microstep's entries in column order."""
    if on_cpu(ledger.rows):
        flow_append_plain(ledger, lanes, fl_done, fl_bytes, fl_rtx)
        return
    fr = ledger.rows.shape[1]
    e, h = lanes.mask.shape
    check(ledger.rows, torch.int64, (1, fr, FLOW_COLS), "flow rows")
    check(ledger.cursor, torch.int64, (1,), "flow cursor")
    check(lanes.mask, torch.bool, (e, h), "flow mask")
    for x, name in zip(lanes[1:], FlowLanes._fields[1:]):
        check(x, torch.int64, (e, h), f"flow {name}")
    for x, name in ((fl_done, "fl_done"), (fl_bytes, "fl_bytes"), (fl_rtx, "fl_rtx")):
        check(x, torch.int64, (1,), name)
    _flow_k(arg_block([h, e, fr, *(addr(x) for x in lanes), addr(ledger.rows),
                       addr(ledger.cursor), addr(fl_done), addr(fl_bytes), addr(fl_rtx)]))


KERNELS = {"trace_round": _trace_k, "flow_append": _flow_k}
