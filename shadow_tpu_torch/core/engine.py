"""The conservative-PDES round engine, single device (port of the
single-device subset of shadow_tpu/core/engine.py).

One round advances every host through the safe window [now, window_end):

  1. barrier: the minimum over hosts of the next event time (K1, over the
     slab or the bucketed queue's block caches);
  2. window_end = min(gmin + runahead, stop_time);
  3. microsteps, while any host has an event before window_end: every host
     pops its earliest event and packet arrivals pass ingress shaping (CoDel
     + downlink token bucket): one kernel for both on a flat queue (K36),
     else the pop (K5 + K6 on the bucketed queue) and K10; one
     vectorized model handler runs for all hosts, sends pass egress shaping
     (budget, uplink bucket, loss/jitter draws, routing) and K11 appends
     them to the [H, B] outbox itself; local pushes land in the queue (K3;
     K7 bucketed);
  4. exchange: the outbox merges into the destination queues (K4, or K13
     with `merge_scatter`), and a bucketed queue's block caches are rebuilt
     (K8). A round known to have sent nothing skips both, as the JAX
     package's `has_sends` cond does.

With `microstep_events` K > 1 a microstep peeks each host's K earliest
in-window events (K5), runs them through the handler in turn as long as no
push of this microstep would pop before the next one, clears the executed
prefix (K6) and applies all pushes in one pass (K3/K7), each holding back a
reserve so that drops equal the one-event microstep's.

With the timer wheel (`wheel_slots` S > 0, K = 1) the model's timer events
live in a second bucketed slab, [H, S] (ops/wheel.py): the microstep pops
the (time, order) minimum of queue and wheel, timer pushes go to the wheel
while it has room and spill to the queue when it does not, and the wheel's
heads fold into every next-event minimum. Dispatch order, digests, events
and drops equal the wheel-off path's.

With the fluid plane (`fluid_classes` K > 0, net/fluid.py) each round
first computes every host's extra loss and latency multiplier from the
previous round's background state (K16), which egress (K11) applies to
every send of the round; after the microsteps the outbox's foreground
bytes are folded per link (K14) and the rate ODE takes one step over the
committed window (K15), before the exchange clears the outbox. The
done-round holds the fluid state.

With a merge gear (`gear_cols` g, `Engine.run_chunk_gear`) the exchange
reads only the first g columns of each host's outbox row, in place. Sends
beyond them are counted exactly into `stats.gear_shed`, and the chunk stops
before its next round (`Simulation.run` replays it at a wider gear from a
pre-chunk snapshot, core/gears.py); the shed test rides in the window's
device-to-host read, so a round gains no sync.

With the fault plane (`fault_crash_windows` W > 0 or `fault_loss_windows`
L > 0, core/faults.py) crash windows hold a down host's events to its
restart (queue hold: K1's fault floor for the barrier and the loop tests,
K23 for the microsteps' pop limits and the K-way deferral, K10's hold lane
for the execution time) or consume them undispatched (queue clear: K10's
clear lane), and link windows add a loss draw and a latency multiplier to
every send (K11's lane). With the integrity sentinel (`integrity`,
core/integrity.py) every round is judged by K24 at the chunk's entry,
before the exchange and after it, the chunk stops after the first
violating round (read with the window, no extra sync), and K10 folds the
second digest.

With a pressure policy (`pressure_abort`, core/pressure.py) each round
after the exchange writes the run's capacity-drop total into
`stats.pressure` (K26), and the chunk stops after the first round where it
grew (read with the window, no extra sync); `run_chunk_resized` runs a
chunk at the state's (capacity, send budget) when escalation regrew it,
under `resized_cfg`'s pins.

With the observatories, observers that change no result: the trace ring
(`trace_rounds` > 0) gets one row per completed round from K27, whose
scratch holds the round-entry counters (filled at each chunk's entry);
the network observatory (`netobs`) counts executed events by class in K10
and `win_bound` per round, and with a flow ledger (`flow_records` > 0)
the model's handler writes each event column's flow records (K17) and
K28 appends a microstep's to the ledger ring.

With `replicas` R > 1 (the ensemble plane, core/ensemble.py) the engine
runs R replicas of one configuration folded into R x H rows of every
per-host plane, so each kernel of a round launches once for all of them.
Host ids, order keys, draws and destinations stay replica-local (K4,
K11, K13 take the rows per replica), and each replica keeps its own window,
done flag, microstep count, used-latency minimum and scalar counters ([R]
lanes; `now` and `done` host arrays): K31 computes every replica's barrier
and loop test in one launch read back in one copy, and a replica that is
done or past its loop test is frozen by a pop limit of 0 on its rows, so
it keeps its carry bit for bit. Replica r equals its solo run.

The slice is the JAX package's round loop: flat or bucketed queue, K >= 1,
the timer wheel, merge gears, the scatter merge, the fluid plane, the fault
plane, the integrity sentinel, the pressure plane and the observatories on
one device; across W ranks (`world` > 1, one process each, core/mesh.py)
every rank runs its shard's microsteps alone, and only the barrier (one
MIN of the next-event minimum, the used-latency minimum and the
sentinel's entry floor), the exchange (`exchange_mesh`: an all-gather, or
K29's blocks over an all-to-all, then K30 and the merge) and one SUM of the
round's global counts (gear sheds, the send count, the pressure total, the
sentinel's count, the fluid bytes) cross ranks.
`lax.while_loop` becomes a Python loop; each loop condition is one
device-to-host read, counted in `Engine.host_syncs`. The window itself is
computed on the device and read back with the `done` flag in the same
read.

Determinism: pops follow the packed (time, order) key; RNG lanes advance
only under masks; the merge orders rows by (dst, time, order). Per-host
digests, event counts and drop counters equal the JAX engine's bit for bit
(tests/test_torch_engine.py).

State is NamedTuples of tensors. The queue kernels update the slab planes in
place on CUDA (a state's queue is consumed by the step that takes it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.core.faults import down_and_resume
from shadow_tpu_torch.core.integrity import DIGEST2_OFFSET_I64, IntegrityCheck
from shadow_tpu_torch.obs.netobs import make_flow_ledger
from shadow_tpu_torch.obs.tracer import make_trace_ring
from shadow_tpu_torch.ops.chain import (
    Ingress,
    event_egress,
    event_ingress,
    pop_ingress,
    timer_kind_mask,
)
from shadow_tpu_torch.models.base import KIND_MASK, KIND_PKT, HandlerCtx
from shadow_tpu_torch.net import CodelState, TBParams, TBState, codel_init, tb_init
from shadow_tpu_torch.net.fluid import (
    LAT_SCALE,
    check_class_count,
    fluid_advance,
    fluid_fg_link_bytes,
    fluid_host_effects,
    make_fluid_state,
)
from shadow_tpu_torch.ops.events import (
    _LOCAL_SHIFT,
    _SRC_SHIFT,
    EVENT_PAYLOAD_WORDS,
    ORDER_MAX,
    SEQ_MASK,
    BucketQueue,
    Event,
    EventQueue,
    Push,
    as_flat,
    bucket_rebuild,
    check_order_limits,
    clear_popped,
    pop_k,
    q_head,
    q_len,
    q_next_time,
    q_pop_min,
    q_push_many,
)
from shadow_tpu_torch.ops.ensemble import (
    DONE,
    LIVE,
    LOOP,
    PENDING,
    ROUND,
    SENDS,
    STEPS,
    WEND,
    make_lanes,
    replica_window,
)
from shadow_tpu_torch.ops.cosim import GO, WEND, DONE, guarded_window
from shadow_tpu_torch.ops.exchange import ROW_WORDS, dshard_pack, exchange_unpack, pack_words
from shadow_tpu_torch.ops.merge import gear_shed_count, merge_flat_events, merge_scatter_free
from shadow_tpu_torch.ops.obs import (
    FlowLanes,
    RoundInputs,
    flow_append,
    make_flow_lanes,
    make_trace_scratch,
    trace_enter,
    trace_round,
)
from shadow_tpu_torch.ops.pressure import pressure_total
from shadow_tpu_torch.ops.rng import RngState, rng_init, u64
from shadow_tpu_torch.ops.wheel import (
    TimerWheel,
    resolve_wheel_block,
    wheel_free,
    wheel_next_time,
    wheel_pop_min,
    wheel_push_many,
)
from shadow_tpu_torch.simtime import TIME_MAX

_FNV_OFFSET = u64(0xCBF29CE484222325)


class Outbox(NamedTuple):
    """This round's staged sends, [H, B]: host h's k-th send in column k
    (with replicas, `count` holds one lane per replica)."""

    dst: torch.Tensor  # i32[H, B]
    t: torch.Tensor  # i64[H, B] arrival time; TIME_MAX = empty
    order: torch.Tensor  # i64[H, B]
    kind: torch.Tensor  # i32[H, B]
    payload: torch.Tensor  # i32[H, B, P]
    count: torch.Tensor  # i32[1] entries appended this round


class Stats(NamedTuple):
    """The counters the report reads (the JAX Stats lanes of this slice)."""

    events: torch.Tensor  # i64[H]
    pkts_sent: torch.Tensor  # i64[H]
    pkts_lost: torch.Tensor  # i64[H]
    pkts_unreachable: torch.Tensor  # i64[H]
    pkts_codel_dropped: torch.Tensor  # i64[H]
    pkts_delivered: torch.Tensor  # i64[H]
    monotonic_violations: torch.Tensor  # i64[H]
    pkts_budget_dropped: torch.Tensor  # i64[H]
    ob_dropped: torch.Tensor  # i64[1]
    microsteps: torch.Tensor  # i64[1]
    bq_rebuilds: torch.Tensor  # i64[1] wholesale block-cache rebuilds
    popk_deferred: torch.Tensor  # i64[1] K-way batch events peeked but deferred
    q_occ_hwm: torch.Tensor  # i64[H]
    outbox_hwm: torch.Tensor  # i64[1]
    digest: torch.Tensor  # i64[H] (uint64 FNV fold, bit pattern)
    rounds: torch.Tensor  # i64[]
    # cumulative sends beyond the active merge gear's columns; an accepted
    # chunk never adds to it (a shedding chunk is replayed wider)
    gear_shed: Any = None  # i64[1]
    # timer-wheel lanes, None unless the wheel is on: timer pushes spilled
    # to the queue because the wheel was full (never a loss), and the
    # per-host wheel-occupancy high-water
    wheel_spilled: Any = None  # i64[H] | None
    wheel_occ_hwm: Any = None  # i64[H] | None
    # fluid-plane byte counters, None unless the plane is on: background
    # bytes carried and dropped at congestion
    fl_bg_bytes: Any = None  # i64[] | None
    fl_bg_dropped: Any = None  # i64[] | None
    # fault-plane counters, None unless the plane is on: events and packets
    # an injected fault discarded (queue-clear drops charged to the down
    # host, link-fault loss to the sender), and events executed at a crash
    # restart plus packets a fault window slowed
    faults_dropped: Any = None  # i64[H] | None
    faults_delayed: Any = None  # i64[H] | None
    # integrity-sentinel lanes, None unless it is on: the cumulative count
    # of failed checks, the invariant bits seen and the first violating
    # round (-1 = none yet); the second digest (uint64 bit pattern) with
    # the dual digest
    integrity: Any = None  # i64[1] | None
    iv_mask: Any = None  # i64[1] | None
    iv_round: Any = None  # i64[1] | None
    digest2: Any = None  # i64[H] | None
    # the pressure plane's signal, None unless a policy is on (escalate or
    # abort): the run's cumulative capacity-drop total, written every round
    pressure: Any = None  # i64[1] | None
    # network-observatory lanes, None unless it is on: executed events by
    # class (timer / packet / app; they sum to the events), the flow
    # ledger's cumulative completions, payload bytes and retransmits
    # (None unless the ledger is on), and the rounds this device bound the
    # barrier (every non-done round on one device)
    ec_timer: Any = None  # i64[1] | None
    ec_pkt: Any = None  # i64[1] | None
    ec_app: Any = None  # i64[1] | None
    fl_done: Any = None  # i64[1] | None
    fl_bytes: Any = None  # i64[1] | None
    fl_rtx: Any = None  # i64[1] | None
    win_bound: Any = None  # i64[1] | None
    # the cross-shard exchange's lanes (the shard's own value of the JAX
    # package's [world] lanes; 0 on one device): block-overflow sheds of the
    # all-to-all exchanges, and the bytes the exchange collective moves per
    # the cost model (exchange_ici_bytes_per_round); with the hierarchical
    # exchange also its two tiers (None otherwise)
    a2a_shed: Any = None  # i64[1]
    ici_bytes: Any = None  # i64[1]
    ici_intra: Any = None  # i64[1] | None
    ici_inter: Any = None  # i64[1] | None


class SimState(NamedTuple):
    # completed-up-to time and the done flag (host scalars; with replicas,
    # int64 and bool numpy arrays [R])
    now: int
    done: bool
    queue: EventQueue | BucketQueue
    rng: RngState
    seq: torch.Tensor  # i64[H] per-host emission counter
    sent_round: torch.Tensor  # i32[H] sends staged this round
    tb_egress: TBState
    tb_ingress: TBState
    codel: CodelState
    min_used_lat: torch.Tensor  # i64[] min latency seen (dynamic runahead)
    # the CPU model's busy horizon: a host's events execute no earlier than
    # this (zeros, and untouched, unless cpu_delay_ns > 0)
    cpu_busy_until: torch.Tensor  # i64[H]
    model: Any
    outbox: Outbox
    stats: Stats
    wheel: Any = None  # TimerWheel | None (the [H, S] timer slab)
    fluid: Any = None  # FluidState | None (the fluid plane's rates and link_util)
    # the round trace ring (obs/tracer.py TraceRing; None unless
    # trace_rounds > 0) and the flow ledger (obs/netobs.py FlowLedger; None
    # unless the ledger is on): observers, written by K27 and K28
    trace: Any = None
    flows: Any = None


class EngineParams(NamedTuple):
    node_of: torch.Tensor  # i32[H] host -> graph node
    lat_ns: torch.Tensor  # i64[N, N] path latency; <0 = unreachable
    loss: torch.Tensor  # f32[N, N]
    jitter_ns: torch.Tensor  # i64[N, N]
    eg_tb: TBParams
    in_tb: TBParams
    model: Any
    # per-host rows of the path tables (lat_rows[h] = lat_ns[node_of[h]]),
    # built by init_state for multi-node graphs of moderate size
    lat_rows: Any = None  # i64[H, N] | None
    loss_rows: Any = None  # f32[H, N] | None
    jit_rows: Any = None  # i64[H, N] | None
    fluid: Any = None  # FluidParams | None (net/fluid.py compile_fluid)
    faults: Any = None  # FaultParams | None (core/faults.py compile_faults)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration (the JAX EngineConfig fields of this slice)."""

    num_hosts: int
    stop_time: int
    bootstrap_end_time: int = 0
    runahead_floor: int = 1_000_000
    static_min_latency: int = 1_000_000
    use_dynamic_runahead: bool = False
    tb_interval_ns: int = 1_000_000
    use_codel: bool = True
    # no bandwidth limit anywhere: shaping is an exact no-op and is skipped
    shaping: bool = True
    # exchange-merge overflow shed by outbox position instead of urgency
    cheap_shed: bool = False
    # CPU model: every executed event charges this much simulated CPU time;
    # an event that pops while its host is busy executes at the busy
    # horizon, or waits in the queue past the window (0 = off)
    cpu_delay_ns: int = 0
    # the exchange merge's positional row bound: rows at sorted position
    # >= merge_rows, one token per host counted, shed (0 = none)
    merge_rows: int = 0
    use_jitter: bool = False
    queue_capacity: int = 64
    # slots per block of the bucketed queue; 0 = flat queue
    queue_block: int = 0
    sends_per_host_round: int = 8
    max_round_inserts: int = 64
    microstep_limit: int = 0  # 0 -> 2 * queue_capacity
    # events folded per host per microstep (K)
    microstep_events: int = 1
    rounds_per_chunk: int = 64
    # host->node map is contiguous uniform blocks (node = host // g)
    hosts_per_node: int = 0
    # timer wheel: slots per host (0 = off) and slots per block of its
    # caches (0 = auto, ops/wheel.py resolve_wheel_block)
    wheel_slots: int = 0
    wheel_block: int = 0
    # active merge gear: the exchange reads the first gear_cols outbox
    # columns (0 = full width). The simulation's config keeps 0; the gear
    # programs run under a copy (Engine.run_chunk_gear).
    gear_cols: int = 0
    # the sort-free exchange merge (ops/merge.py merge_scatter_free, K13)
    merge_scatter: bool = False
    # fluid traffic plane (net/fluid.py; 0 classes = off): the arrays live
    # in EngineParams.fluid, these are its dims and coupling knobs
    fluid_classes: int = 0  # K background traffic classes
    fluid_links: int = 0  # N links (graph nodes) the ODE state covers
    fluid_tau_ns: int = 50_000_000  # rate-relaxation time constant
    fluid_util_threshold: float = 0.7  # coupling ramp start
    fluid_loss_max: float = 0.0  # extra loss probability at full overload
    fluid_lat_max_x1000: int = 2000  # latency multiplier cap (x1000)
    fluid_seed: int = 1  # the counter-based loss draw's seed
    # fault plane (core/faults.py; 0 windows = off): the arrays live in
    # EngineParams.faults, these are their dims and the restart policy
    fault_crash_windows: int = 0  # W: crash windows per host
    fault_loss_windows: int = 0  # L: link-fault windows
    # restart_queue "clear": events executing inside a crash window are
    # consumed and counted in faults_dropped ("hold" defers them)
    fault_queue_clear: bool = False
    # integrity sentinel (core/integrity.py): the per-round guards and the
    # chunk's first-violation stop; the dual digest lane; the window
    # monotonicity half of IV_TIME (static runahead only)
    integrity: bool = False
    integrity_dual: bool = False
    integrity_strict_time: bool = True
    # pressure plane (core/pressure.py): the per-round drop total (K26,
    # ops/pressure.py) and the chunk's first-drop stop; False (policy drop)
    # runs neither
    pressure_abort: bool = False
    # the round trace ring's rounds (0 = off; the driver sizes it to the
    # chunk), the network observatory and its flow ledger's records (0 = no
    # ledger; models with a flow port only)
    trace_rounds: int = 0
    netobs: bool = False
    flow_records: int = 0
    # the host mesh (core/mesh.py): `world` ranks, this process being rank
    # `rank`, which holds hosts [rank * hosts_per_shard, (rank + 1) *
    # hosts_per_shard); `num_hosts` is the global count. The exchange kind
    # across ranks (gather | alltoall | hierarchical) and the all-to-all
    # block (0 = auto); world 1 merges locally whatever they say
    world: int = 1
    rank: int = 0
    exchange: str = "gather"
    a2a_block: int = 0
    # the ensemble plane (core/ensemble.py): replicas of this configuration
    # folded into replicas x hosts_per_shard rows (1 = a solo run)
    replicas: int = 1

    def __post_init__(self):
        check_order_limits(self.num_hosts)
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.replicas > 1:
            off = [name for name, on in (
                ("world > 1", self.world > 1), ("fluid_classes", self.fluid_classes),
                ("integrity", self.integrity), ("pressure_abort", self.pressure_abort),
                ("gear_cols", self.gear_cols), ("trace_rounds", self.trace_rounds),
                ("netobs", self.netobs)) if on]
            if off:
                raise ValueError(f"replicas={self.replicas}: the ensemble fold does not run "
                                 f"{', '.join(off)}")
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank={self.rank} must be in [0, world={self.world})")
        if self.num_hosts % self.world != 0:
            raise ValueError(
                f"num_hosts={self.num_hosts} must divide evenly over world={self.world} ranks")
        if self.exchange not in ("gather", "alltoall", "hierarchical"):
            raise ValueError(
                f"exchange must be gather|alltoall|hierarchical, got {self.exchange!r}")
        if self.a2a_block < 0:
            raise ValueError(f"a2a_block must be >= 0 (0 = auto), got {self.a2a_block}")
        if self.queue_block < 0 or (
            self.queue_block and self.queue_capacity % self.queue_block
        ):
            raise ValueError(
                f"queue_block={self.queue_block} must be 0 (flat) or divide "
                f"queue_capacity={self.queue_capacity} evenly"
            )
        if self.microstep_events < 1:
            raise ValueError(f"microstep_events={self.microstep_events} must be >= 1")
        if self.cpu_delay_ns < 0 or self.merge_rows < 0:
            raise ValueError(
                f"cpu_delay_ns={self.cpu_delay_ns} and merge_rows={self.merge_rows} must be "
                f">= 0 (0 = off)"
            )
        if self.wheel_slots < 0:
            raise ValueError(f"wheel_slots={self.wheel_slots} must be >= 0 (0 = off)")
        if self.wheel_block < 0 or (
            self.wheel_slots and self.wheel_block and self.wheel_slots % self.wheel_block
        ):
            raise ValueError(
                f"wheel_block={self.wheel_block} must be 0 (auto) or divide "
                f"wheel_slots={self.wheel_slots} evenly"
            )
        if self.gear_cols < 0 or self.gear_cols > self.sends_per_host_round:
            raise ValueError(
                f"gear_cols={self.gear_cols} must be in "
                f"[0, sends_per_host_round={self.sends_per_host_round}]"
            )
        if self.fluid_classes < 0 or self.fluid_links < 0:
            raise ValueError(
                f"fluid dims must be >= 0, got classes={self.fluid_classes} "
                f"links={self.fluid_links}"
            )
        if self.fluid_classes and self.fluid_links < 1:
            raise ValueError(
                "fluid_classes > 0 requires fluid_links >= 1 (the ODE needs at least "
                "one link to cover)"
            )
        if self.fluid_classes:
            check_class_count(self.fluid_classes)
            if self.fluid_tau_ns <= 0:
                raise ValueError(f"fluid_tau_ns must be > 0, got {self.fluid_tau_ns}")
            if not 0.0 <= self.fluid_util_threshold < 1.0:
                raise ValueError(
                    f"fluid_util_threshold must be in [0, 1), got {self.fluid_util_threshold}"
                )
            if not 0.0 <= self.fluid_loss_max <= 1.0:
                raise ValueError(f"fluid_loss_max must be in [0, 1], got {self.fluid_loss_max}")
            if self.fluid_lat_max_x1000 < LAT_SCALE:
                raise ValueError(
                    f"fluid_lat_max_x1000 must be >= 1000 (inflation only: the "
                    f"conservative-lookahead bound), got {self.fluid_lat_max_x1000}"
                )
        if self.fault_crash_windows < 0 or self.fault_loss_windows < 0:
            raise ValueError(
                f"fault window counts must be >= 0, got crash="
                f"{self.fault_crash_windows} loss={self.fault_loss_windows}"
            )
        if self.integrity_dual and not self.integrity:
            raise ValueError(
                "integrity_dual requires integrity=True (the dual digest "
                "is an integrity-sentinel lane)"
            )
        if self.trace_rounds < 0:
            raise ValueError(f"trace_rounds={self.trace_rounds} must be >= 0 (0 = off)")
        if self.flow_records < 0:
            raise ValueError(
                f"flow_records={self.flow_records} must be >= 0 (0 = no flow ledger)")
        if self.flow_records and not self.netobs:
            raise ValueError(
                "flow_records > 0 requires netobs=True (the flow ledger is a "
                "network-observatory instrument)")
        if self.wheel_slots and self.microstep_events > 1:
            raise ValueError(
                f"unsupported knob pair: wheel_slots={self.wheel_slots} x "
                f"microstep_events={self.microstep_events} (the wheel's pop merges one "
                f"wheel candidate against the queue head per microstep; run the wheel "
                f"at microstep_events=1)"
            )

    @property
    def wheel_active(self) -> bool:
        return self.wheel_slots > 0

    @property
    def fluid_active(self) -> bool:
        return self.fluid_classes > 0

    @property
    def faults_active(self) -> bool:
        """Any fault lane runs (and the fault counters exist)."""
        return self.fault_crash_windows > 0 or self.fault_loss_windows > 0

    @property
    def fault_hold(self) -> bool:
        """Queue-hold crash faults: a down host's events defer to its
        restart (the barrier's and the microsteps' floor)."""
        return self.fault_crash_windows > 0 and not self.fault_queue_clear

    @property
    def fault_clear(self) -> bool:
        """Queue-clear crash faults: events executing while their host is
        down are consumed and counted in faults_dropped."""
        return self.fault_crash_windows > 0 and self.fault_queue_clear

    @property
    def flow_ledger_active(self) -> bool:
        """The flow ledger runs (K17's record lanes, K28)."""
        return self.netobs and self.flow_records > 0

    @property
    def effective_gear_cols(self) -> int:
        """The merge width in force (0 resolves to full width)."""
        return self.gear_cols or self.sends_per_host_round

    @property
    def gear_active(self) -> bool:
        """A merge gear narrower than the send budget: the sliced exchange
        and the gear-abort chunk test are on."""
        return 0 < self.gear_cols < self.sends_per_host_round

    @property
    def hosts_per_shard(self) -> int:
        """The hosts one rank holds (all of them on one device)."""
        return self.num_hosts // self.world

    @property
    def rows(self) -> int:
        """Rows of every per-host plane: the shard's hosts, times the
        replicas."""
        return self.replicas * self.hosts_per_shard

    @property
    def host_base(self) -> int:
        """The global id of this rank's first host."""
        return self.rank * self.hosts_per_shard

    @property
    def a2a_block_size(self) -> int:
        """Rows per destination shard of the all-to-all blocks: the explicit
        `a2a_block`, else 2 x the shard's outbox rows / world, at least 64
        and at most the rows."""
        if self.a2a_block:
            return self.a2a_block
        rows = self.hosts_per_shard * self.sends_per_host_round
        return min(rows, max(64, 2 * rows // self.world))

    @property
    def hier_active(self) -> bool:
        """The two-tier hierarchical exchange runs (world > 1 only)."""
        return self.exchange == "hierarchical" and self.world > 1

    @property
    def hier_block_size(self) -> int:
        """The hierarchical exchange's block: `a2a_block_size`'s law over
        the gear-sliced rows (an explicit `a2a_block` wins)."""
        if self.a2a_block:
            return self.a2a_block
        rows_g = self.hosts_per_shard * self.effective_gear_cols
        return min(rows_g, max(64, 2 * rows_g // self.world))

    @property
    def effective_rounds_per_chunk(self) -> int:
        """The chunk's round bound: `rounds_per_chunk`, clamped to the
        microstep valve above 2^19 hosts as the JAX package clamps it (the
        bound changes how rounds group into chunks, never a result)."""
        if self.num_hosts <= 1 << 19:
            return self.rounds_per_chunk
        return min(self.rounds_per_chunk, max(self.effective_microstep_limit, 1))

    @property
    def effective_microstep_limit(self) -> int:
        """The per-round livelock valve: for K = 1 it bounds microsteps; for
        K > 1 it bounds each host's executed events in the round (the round
        loop stops when any host's count reaches it), so the same number
        denominates an event budget either way."""
        return self.microstep_limit or 2 * self.queue_capacity

    @property
    def effective_microstep_events(self) -> int:
        """K clamped to the queue capacity."""
        return min(self.microstep_events, self.queue_capacity)


def _init_stats(cfg: EngineConfig, device) -> Stats:
    h = cfg.num_hosts

    def zi():
        return torch.zeros((h,), dtype=torch.int64, device=device)

    def z1():
        return torch.zeros((1,), dtype=torch.int64, device=device)

    return Stats(
        events=zi(), pkts_sent=zi(), pkts_lost=zi(), pkts_unreachable=zi(),
        pkts_codel_dropped=zi(), pkts_delivered=zi(), monotonic_violations=zi(),
        pkts_budget_dropped=zi(), ob_dropped=z1(), microsteps=z1(),
        bq_rebuilds=z1(), popk_deferred=z1(), q_occ_hwm=zi(), outbox_hwm=z1(),
        digest=torch.full((h,), _FNV_OFFSET, dtype=torch.int64, device=device),
        rounds=torch.zeros((), dtype=torch.int64, device=device),
        gear_shed=z1(),
        wheel_spilled=zi() if cfg.wheel_active else None,
        wheel_occ_hwm=zi() if cfg.wheel_active else None,
        fl_bg_bytes=(torch.zeros((), dtype=torch.int64, device=device)
                     if cfg.fluid_active else None),
        fl_bg_dropped=(torch.zeros((), dtype=torch.int64, device=device)
                       if cfg.fluid_active else None),
        faults_dropped=zi() if cfg.faults_active else None,
        faults_delayed=zi() if cfg.faults_active else None,
        integrity=z1() if cfg.integrity else None,
        iv_mask=z1() if cfg.integrity else None,
        iv_round=(torch.full((1,), -1, dtype=torch.int64, device=device)
                  if cfg.integrity else None),
        digest2=(torch.full((h,), DIGEST2_OFFSET_I64, dtype=torch.int64, device=device)
                 if cfg.integrity_dual else None),
        pressure=z1() if cfg.pressure_abort else None,
        ec_timer=z1() if cfg.netobs else None,
        ec_pkt=z1() if cfg.netobs else None,
        ec_app=z1() if cfg.netobs else None,
        fl_done=z1() if cfg.flow_ledger_active else None,
        fl_bytes=z1() if cfg.flow_ledger_active else None,
        fl_rtx=z1() if cfg.flow_ledger_active else None,
        win_bound=z1() if cfg.netobs else None,
        a2a_shed=z1(),
        ici_bytes=z1(),
        ici_intra=z1() if cfg.hier_active else None,
        ici_inter=z1() if cfg.hier_active else None,
    )


def exchange_ici_bytes_per_round(cfg: EngineConfig, kind: str | None = None) -> int:
    """Bytes one exchange moves into the collective per shard, as the JAX
    package's cost model counts them (its `exchange_ici_bytes_per_round`):
    gather, the other shards' gear-sliced outboxes (dst, t, order, kind,
    payload words per row) plus a 4-byte count word each; alltoall, (W - 1)
    blocks of `a2a_block_size` packed rows; hierarchical, the inter tier of
    `exchange_tier_bytes_per_round`. 0 on one device."""
    kind = kind or cfg.exchange
    if cfg.world <= 1:
        return 0
    rows_local = cfg.hosts_per_shard * cfg.effective_gear_cols
    row_bytes = 4 + 8 + 8 + 4 + 4 * EVENT_PAYLOAD_WORDS
    if kind == "gather":
        return (cfg.world - 1) * (rows_local * row_bytes + 4)
    if kind == "hierarchical":
        return exchange_tier_bytes_per_round(cfg)[1]
    return (cfg.world - 1) * cfg.a2a_block_size * (6 + EVENT_PAYLOAD_WORDS) * 4


def exchange_tier_bytes_per_round(cfg: EngineConfig) -> tuple[int, int]:
    """(intra, inter) bytes per shard of the hierarchical exchange's round:
    the compaction tier repacks every gear-sliced row once at wire width;
    the wire tier moves (W - 1) blocks of `hier_block_size` rows plus a
    4-byte fill counter per peer (the JAX package's model)."""
    if cfg.world <= 1:
        return 0, 0
    words = 6 + EVENT_PAYLOAD_WORDS
    intra = cfg.hosts_per_shard * cfg.effective_gear_cols * words * 4
    inter = (cfg.world - 1) * (cfg.hier_block_size * words + 1) * 4
    return intra, inter


def make_empty_outbox(num_hosts: int, send_budget: int, device, replicas: int = 1) -> Outbox:
    h, b = num_hosts, send_budget
    return Outbox(
        dst=torch.zeros((h, b), dtype=torch.int32, device=device),
        t=torch.full((h, b), TIME_MAX, dtype=torch.int64, device=device),
        order=torch.zeros((h, b), dtype=torch.int64, device=device),
        kind=torch.zeros((h, b), dtype=torch.int32, device=device),
        payload=torch.zeros((h, b, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=device),
        count=torch.zeros((replicas,), dtype=torch.int32, device=device),
    )


def seed_queue(cfg: EngineConfig, initial_events, device, timer_kinds: tuple = ()):
    """The t=0 queue from (host_id, t_ns, kind, payload) events (bucketed
    when `queue_block`), the t=0 timer wheel (None unless the wheel is on:
    seeded events of a kind in `timer_kinds` land in the wheel while it has
    room, the rest in the queue), and the per-host seq counters advanced
    past them in event-list order wherever each one lands."""
    h, c = cfg.num_hosts, cfg.queue_capacity
    s = cfg.wheel_slots if timer_kinds else 0
    kinds = set(timer_kinds)

    def planes(width):
        return {"t": np.full((h, width), TIME_MAX, np.int64),
                "order": np.full((h, width), ORDER_MAX, np.int64),
                "kind": np.zeros((h, width), np.int32),
                "payload": np.zeros((h, width, EVENT_PAYLOAD_WORDS), np.int32),
                "fill": np.zeros((h,), np.int32)}

    q, w = planes(c), planes(s)
    seq = np.zeros((h,), np.int64)
    for host, t_ns, k, pl in initial_events:
        okey = (1 << _LOCAL_SHIFT) | (host << _SRC_SHIFT) | (int(seq[host]) & SEQ_MASK)
        seq[host] += 1
        dest = w if s and k in kinds and w["fill"][host] < s else q
        slot = dest["fill"][host]
        if dest is q and slot >= c:
            raise ValueError(f"host {host}: {slot + 1} initial events exceed queue capacity {c}")
        dest["t"][host, slot] = t_ns
        dest["order"][host, slot] = okey
        dest["kind"][host, slot] = k
        dest["payload"][host, slot, : len(pl)] = pl
        dest["fill"][host] += 1

    def flat(p):
        return EventQueue(*(torch.as_tensor(p[f], device=device)
                            for f in ("t", "order", "kind", "payload")),
                          dropped=torch.zeros((h,), dtype=torch.int64, device=device))

    queue = flat(q)
    if cfg.queue_block:
        queue = bucket_rebuild(queue, cfg.queue_block)
    wheel = bucket_rebuild(flat(w), resolve_wheel_block(s, cfg.wheel_block)) if s else None
    return queue, wheel, torch.as_tensor(seq, device=device)


class _EvCarry(NamedTuple):
    stats: Stats
    rng: RngState
    seq: torch.Tensor
    sent_round: torch.Tensor
    tb_egress: TBState
    tb_ingress: TBState
    codel: CodelState
    model: Any
    cpu_busy_until: Any = None  # i64[H]: read and written by ingress (K10), CPU model on
    # egress (K11) appends each landed send here and folds its latency into
    # min_used_lat (i64[], or [R] with replicas)
    outbox: Any = None
    min_used_lat: Any = None


def _ev_carry_of(st: SimState) -> _EvCarry:
    return _EvCarry(st.stats, st.rng, st.seq, st.sent_round, st.tb_egress,
                    st.tb_ingress, st.codel, st.model, st.cpu_busy_until, st.outbox,
                    st.min_used_lat)


class FoldWindow(NamedTuple):
    """The round's window with replicas: each replica's window end (K31's
    lane) and every row's pop limit (its replica's window end while the
    replica runs this microstep, else 0)."""

    lane: torch.Tensor  # i64[R]
    rows: torch.Tensor  # i64[R x H]


def _limit_of(window_end):
    """The per-host form of a window end: the int itself, or the rows."""
    return window_end.rows if isinstance(window_end, FoldWindow) else window_end


def _lex_less(at, ao, bt, bo):
    """(at, ao) < (bt, bo) on the (time, order) total key."""
    return (at < bt) | ((at == bt) & (ao < bo))


class Engine:
    """Runs the round loop for a fixed (config, model) on one device.

    `run_chunk(state, params)` runs up to `rounds_per_chunk` rounds and
    returns the new state; the driver (`shadow_tpu_torch.sim`) calls it
    until `state.done`. `host_syncs` counts the device-to-host reads the
    loop conditions cost."""

    def __init__(self, cfg: EngineConfig, model, device, coll=None):
        if (coll is None) != (cfg.world == 1):
            raise ValueError("a Collectives (core/mesh.py) must be given iff cfg.world > 1")
        if cfg.wheel_active and not tuple(getattr(model, "timer_kinds", ())):
            raise ValueError(
                f"timer wheel enabled (wheel_slots={cfg.wheel_slots}) but model "
                f"{getattr(model, 'name', model)!r} declares no timer_kinds: nothing "
                f"would ever route to the wheel"
            )
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.host_syncs = 0
        # the mesh's collectives (None on one device)
        self.coll = coll
        # the integrity sentinel's staged per-round check (None when off)
        self._iv = IntegrityCheck(cfg) if cfg.integrity else None
        # each row's host id (within its replica)
        self._host_gid = cfg.host_base + torch.arange(
            cfg.hosts_per_shard, dtype=torch.int64, device=self.device).repeat(cfg.replicas)
        # the trace ring's round-entry counter values (K27's scratch) and
        # the model's timer kinds for K10's event-class lane
        self._trace_scratch = make_trace_scratch(self.device) if cfg.trace_rounds else None
        self._timer_mask = (timer_kind_mask(getattr(model, "timer_kinds", ()))
                            if cfg.netobs else 0)

    # ---- build -------------------------------------------------------------

    def init_state(self, params: EngineParams, model_state, initial_events, seed: int):
        """(state, params): the t=0 state, and params with the per-host
        routing rows materialized for multi-node graphs."""
        cfg, dev = self.cfg, self.device
        if (params.fluid is not None) != cfg.fluid_active:
            raise ValueError(
                "EngineParams.fluid must be provided iff the EngineConfig declares fluid "
                "classes (fluid_classes > 0): build both from one FluidSchedule "
                "(net/fluid.py compile_fluid)"
            )
        if (params.faults is not None) != cfg.faults_active:
            raise ValueError(
                "EngineParams.faults must be provided iff the EngineConfig declares fault "
                "windows (fault_crash_windows/fault_loss_windows): build both from one "
                "FaultSchedule (core/faults.py compile_faults)"
            )
        n_nodes = params.lat_ns.shape[0]
        if n_nodes > 1:
            node_np = params.node_of.cpu().numpy()
            counts = np.bincount(node_np, minlength=n_nodes)
            g = int(counts[0])
            if g > 0 and (counts == g).all() and (node_np == np.arange(node_np.shape[0]) // g).all():
                self.cfg = cfg = dataclasses.replace(cfg, hosts_per_node=g)
        rows_ok = cfg.num_hosts * n_nodes <= 32 << 20
        if tuple(params.lat_ns.shape) != (1, 1) and rows_ok and params.lat_rows is None:
            node = params.node_of.to(torch.int64)
            params = params._replace(
                lat_rows=params.lat_ns[node].contiguous(),
                loss_rows=params.loss[node].contiguous(),
                jit_rows=params.jitter_ns[node].contiguous(),
            )
        queue, wheel, seq = seed_queue(
            cfg, initial_events, dev, tuple(getattr(self.model, "timer_kinds", ()))
        )
        h = cfg.num_hosts
        state = SimState(
            now=0,
            done=False,
            queue=queue,
            rng=rng_init(h, seed, dev),
            seq=seq,
            sent_round=torch.zeros((h,), dtype=torch.int32, device=dev),
            tb_egress=tb_init(params.eg_tb),
            tb_ingress=tb_init(params.in_tb),
            codel=codel_init(h, dev),
            min_used_lat=torch.tensor(cfg.static_min_latency, dtype=torch.int64, device=dev),
            cpu_busy_until=torch.zeros((h,), dtype=torch.int64, device=dev),
            model=model_state,
            outbox=make_empty_outbox(h, cfg.sends_per_host_round, dev),
            stats=_init_stats(cfg, dev),
            wheel=wheel,
            fluid=(make_fluid_state(cfg.fluid_classes, cfg.fluid_links, dev)
                   if cfg.fluid_active else None),
            trace=make_trace_ring(cfg.trace_rounds, dev) if cfg.trace_rounds else None,
            flows=make_flow_ledger(cfg.flow_records, dev) if cfg.flow_ledger_active else None,
        )
        if cfg.world > 1:
            # built whole (deterministic on every rank), kept per shard
            from shadow_tpu_torch.core.mesh import shard_params, shard_state

            state = shard_state(state, cfg.num_hosts, cfg.world, cfg.rank)
            params = shard_params(params, cfg.num_hosts, cfg.world, cfg.rank)
        return state, params

    # ---- the round loop ------------------------------------------------------

    def run_chunk(self, st: SimState, params: EngineParams) -> SimState:
        """Up to `effective_rounds_per_chunk` rounds. Under a merge gear the
        chunk stops before the first round that follows a shed (the JAX
        chunk loop's gear abort); with the integrity sentinel, before the
        first round that follows a violation; with a pressure policy, before
        the first round that follows a capacity drop."""
        cfg = self.cfg
        if cfg.replicas > 1:
            return self._run_chunk_fold(st, params)
        shed0 = st.stats.gear_shed.clone() if cfg.gear_active else None
        press0 = st.stats.pressure.clone() if cfg.pressure_abort else None
        iv0 = None
        if self._iv is not None:
            iv0 = st.stats.integrity.clone()
            if not st.done:
                self._iv.enter(st)
        if self._trace_scratch is not None and not st.done:
            trace_enter(self._trace_scratch, st.stats)
        for _ in range(cfg.effective_rounds_per_chunk):
            if st.done:
                break
            window_end, done, stop = self.compute_window(st, shed0, iv0, params, press0)
            if stop:
                break
            st = self.window_step(st, params, window_end, done)
        return st

    def run_guarded_chunk(self, st: SimState, params: EngineParams, until: int,
                          probe_lane) -> SimState:
        """The co-simulation bridge's guarded round loop (the JAX package's
        `_run_guarded_chunk`): up to `effective_rounds_per_chunk` rounds,
        each run only while the state is not done, the global minimum of
        the effective next event times is below `until`, the stop probe's
        lane (`probe_lane(model_state)`, i32[H]: any > 0 stops) is all zero
        and no stop lane grew (the first merge-gear shed, sentinel violation
        or capacity drop, as `run_chunk` stops). K35 computes the loop test
        and the admitted round's window in one launch, read once per round;
        the round count stays on the host. A co-sim config refuses the knobs
        behind the stop lanes (merge gears, pressure abort, integrity):
        lifting integrity also needs the sentinel's entry check here."""
        cfg = self.cfg
        if cfg.replicas > 1 or self.coll is not None or cfg.use_dynamic_runahead:
            raise ValueError("the guarded round loop runs one replica on one device, with a "
                             "static runahead")
        names = [n for n, on in (("gear_shed", cfg.gear_active),
                                 ("pressure", cfg.pressure_abort),
                                 ("integrity", self._iv is not None)) if on]
        entry = {n: getattr(st.stats, n).clone() for n in names}
        runahead = max(cfg.runahead_floor, cfg.static_min_latency, 1)
        for _ in range(cfg.effective_rounds_per_chunk):
            if st.done:
                break
            lane = guarded_window(self.next_times(st, params), probe_lane(st.model), until,
                                  cfg.stop_time, runahead,
                                  [(getattr(st.stats, n), entry[n]) for n in names])
            vals = lane.tolist()
            self.host_syncs += 1
            if not vals[GO]:
                break
            st = self.window_step(st, params, int(vals[WEND]), bool(vals[DONE]))
        return st

    # ---- the ensemble fold (replicas > 1) ------------------------------------

    def _run_chunk_fold(self, st: SimState, params: EngineParams) -> SimState:
        """Up to `effective_rounds_per_chunk` lockstep rounds of every
        replica not yet done (the vmapped chunk loop: a replica that
        finishes is frozen for the rest of the chunk)."""
        cfg = self.cfg
        lanes = make_lanes(st.done, self.device)
        pop = torch.empty((cfg.rows,), dtype=torch.int64, device=self.device)
        for _ in range(cfg.effective_rounds_per_chunk):
            if st.done.all():
                break
            st = self._fold_round(st, params, lanes, pop)
        return st

    def _fold_round(self, st: SimState, params: EngineParams, lanes: torch.Tensor,
                    pop: torch.Tensor) -> SimState:
        """One round of every replica: K31's barrier (one read of every
        replica's window end, done and live flags), the microsteps while any
        replica is pending (one K31 loop test and one read each; frozen
        replicas pop under a limit of 0), the exchange, and the per-replica
        counters ([R] lanes, masked by the live flags)."""
        cfg = self.cfg
        r, h = cfg.replicas, cfg.hosts_per_shard
        kw = dict(rows=h, stop=cfg.stop_time,
                  runahead=max(cfg.runahead_floor, cfg.static_min_latency, 1),
                  floor=max(cfg.runahead_floor, 1), dynamic=cfg.use_dynamic_runahead,
                  min_used=st.min_used_lat, limit=cfg.effective_microstep_limit)
        replica_window(ROUND, self.next_times(st, params), lanes, pop, **kw)
        vals = lanes.cpu().numpy().copy()  # the CPU path's lanes stay live
        self.host_syncs += 1
        live = vals[LIVE] != 0
        has_sends = False
        if live.any():
            win = FoldWindow(lanes[WEND], pop)
            k_way = cfg.effective_microstep_events > 1
            valve = (torch.zeros((cfg.rows,), dtype=torch.int64, device=self.device) if k_way
                     else None)
            while True:
                replica_window(LOOP, self.next_times(st, params), lanes, pop, valve=valve,
                               ob_count=st.outbox.count, **kw)
                loop = lanes.cpu().numpy().copy()
                self.host_syncs += 1
                if not loop[PENDING].any():
                    has_sends = bool(loop[SENDS].any())
                    break
                if k_way:
                    st, executed = self.microstep_k(st, params, win)
                    valve = valve + executed
                else:
                    st = self.microstep(st, params, win)
        st_x = self.exchange(st, has_sends)
        s = st_x.stats
        stats = s._replace(
            rounds=s.rounds + lanes[LIVE],
            microsteps=s.microsteps + lanes[STEPS],
            q_occ_hwm=torch.maximum(s.q_occ_hwm, q_len(st_x.queue).to(torch.int64)),
            outbox_hwm=torch.maximum(s.outbox_hwm,
                                     st.sent_round.view(r, h).amax(1).to(torch.int64)),
        )
        if st_x.wheel is not None:
            stats = stats._replace(wheel_occ_hwm=torch.maximum(
                stats.wheel_occ_hwm, q_len(st_x.wheel).to(torch.int64)))
        return st_x._replace(now=np.where(live, vals[WEND], st.now), done=vals[DONE] != 0,
                             stats=stats)

    def _run_chunk_at(self, cfg: EngineConfig, st: SimState, params: EngineParams) -> SimState:
        """One chunk under `cfg` in place of the engine's config (the
        sentinel's check follows it); the base config is back afterwards."""
        base = self.cfg
        self.cfg = cfg
        if self._iv is not None:
            self._iv.cfg = cfg
        try:
            return self.run_chunk(st, params)
        finally:
            self.cfg = base
            if self._iv is not None:
                self._iv.cfg = base

    def run_chunk_gear(self, st: SimState, params: EngineParams, gear_cols: int) -> SimState:
        """One chunk at merge gear `gear_cols` (the exchange reads that many
        outbox columns); 0 or the full send budget is the full-width
        chunk. State shapes are the same at every gear."""
        if gear_cols <= 0 or gear_cols >= self.cfg.sends_per_host_round:
            return self.run_chunk(st, params)
        return self._run_chunk_at(dataclasses.replace(self.cfg, gear_cols=gear_cols), st, params)

    def run_chunk_resized(self, st: SimState, params: EngineParams, gear_cols: int,
                          queue_capacity: int, send_budget: int) -> SimState:
        """One chunk at an escalated shape: `queue_capacity` slots per host
        and a `send_budget`-wide outbox (the pressure plane's regrown
        shapes, which the state must already have), at merge gear
        `gear_cols` (0 = full width). The base shape, or 0 for either
        (the gears-only controller), is `run_chunk_gear`. Every part of the
        round that reads a shape from the config (the exchange's fresh
        outbox, the send-budget check, the sentinel's outbox bound, the
        K-way clamp, the merge's insert bound) runs under `resized_cfg`."""
        base = self.cfg
        if queue_capacity in (0, base.queue_capacity) and send_budget in (
                0, base.sends_per_host_round):
            return self.run_chunk_gear(st, params, gear_cols)
        if (st.queue.t.shape[1], st.outbox.t.shape[1]) != (queue_capacity, send_budget):
            raise ValueError(
                f"run_chunk_resized at ({queue_capacity}, {send_budget}) got a state of shape "
                f"({st.queue.t.shape[1]}, {st.outbox.t.shape[1]}): migrate it first")
        return self._run_chunk_at(self.resized_cfg(gear_cols, queue_capacity, send_budget),
                                  st, params)

    def resized_cfg(self, gear_cols: int, queue_capacity: int, send_budget: int) -> EngineConfig:
        """The escalated config, with the JAX package's pins, so that the
        escalated run equals one launched at the final shape with them:
        `microstep_limit` stays the base config's effective valve;
        `max_round_inserts` follows the capacity only where the base left
        it auto (equal to the base capacity); the gear is kept only below
        the new budget."""
        base = self.cfg
        return dataclasses.replace(
            base,
            queue_capacity=queue_capacity,
            sends_per_host_round=send_budget,
            gear_cols=gear_cols if 0 < gear_cols < send_budget else 0,
            microstep_limit=base.effective_microstep_limit,
            max_round_inserts=(queue_capacity if base.max_round_inserts == base.queue_capacity
                               else base.max_round_inserts),
        )

    def next_times(self, st: SimState, params: EngineParams | None = None) -> torch.Tensor:
        """Per-host next executable time: the queue's head, and the wheel's
        where there is one (a due timer is as executable as a due queue
        event), floored under the CPU model by the busy horizon (a busy
        host keeps its events queued and resumes at busy_until; an empty
        host stays at TIME_MAX) and, under queue-hold crash faults, moved
        to the restart of a crash window containing it (`params` carries
        the windows). Both floors are K1's lanes: each is monotone in the
        head time, so the minimum of two floored heads is the floored
        minimum."""
        floor = st.cpu_busy_until if self.cfg.cpu_delay_ns > 0 else None
        crash = self._hold_crash(params)
        nt = q_next_time(st.queue, floor, crash)
        if st.wheel is not None:
            nt = torch.minimum(nt, wheel_next_time(st.wheel, floor, crash))
        return nt

    def _hold_crash(self, params: EngineParams | None):
        """The crash windows (down_t, up_t) iff queue-hold faults are on."""
        if not self.cfg.fault_hold:
            return None
        if params is None:
            raise ValueError("queue-hold faults: next_times needs the params (the windows)")
        return params.faults.down_t, params.faults.up_t

    def _pop_limit(self, st: SimState, window_end: int, params: EngineParams):
        """The microstep's pop limit: `window_end`, or under the CPU model
        or queue-hold crash faults an [H] limit that holds back (0) every
        host whose execution floor has reached the window's end. The floor
        is the busy horizon and, under hold, the restart of a crash window
        containing the busy-floored head (K23 at that head: the queue's
        and, where there is one, the wheel's)."""
        cfg = self.cfg
        busy = st.cpu_busy_until if cfg.cpu_delay_ns > 0 else None
        if not cfg.fault_hold:
            if busy is None:
                return window_end
            return torch.where(busy < window_end, window_end, 0)
        ht = q_next_time(st.queue, busy)
        if st.wheel is not None:
            ht = torch.minimum(ht, wheel_next_time(st.wheel, busy))
        _, resume = down_and_resume(params.faults, ht)
        floor = resume if busy is None else torch.maximum(busy, resume)
        return torch.where(floor < window_end, window_end, 0)

    def compute_window(self, st: SimState, shed0=None, iv0=None,
                       params: EngineParams | None = None,
                       press0=None) -> tuple[int, bool, bool]:
        """Barrier + window: (window_end, done, stop), one device-to-host
        read. `stop` is whether `stats.gear_shed` grew past `shed0`,
        `stats.integrity` past `iv0` or `stats.pressure` past `press0` (the
        chunk-entry values; False without them)."""
        cfg = self.cfg
        gmin = self.next_times(st, params).min()
        if self.coll is not None:
            # the barrier: one MIN over the ranks of the local minimum, with
            # the dynamic lookahead's used-latency minimum and the
            # sentinel's round-entry time floor riding along (the JAX
            # package's pmins of the three)
            lanes = [gmin]
            if cfg.use_dynamic_runahead:
                lanes.append(st.min_used_lat)
            if self._iv is not None:
                lanes.append(self._iv.entry_min())
            red = self.coll.pmin(torch.stack(lanes))
            gmin = red[0]
            if cfg.use_dynamic_runahead:
                st.min_used_lat.copy_(red[1])
            if self._iv is not None:
                self._iv.set_entry_min(red[-1])
        done = gmin >= cfg.stop_time
        gmin_safe = torch.clamp_max(gmin, cfg.stop_time)
        if cfg.use_dynamic_runahead:
            runahead = torch.clamp_min(st.min_used_lat, max(cfg.runahead_floor, 1))
        else:
            runahead = max(cfg.runahead_floor, cfg.static_min_latency, 1)
        window_end = torch.clamp_max(gmin_safe + runahead, cfg.stop_time)
        lanes = [window_end, done.to(torch.int64)]
        if shed0 is not None:
            lanes.append((st.stats.gear_shed[0] > shed0[0]).to(torch.int64))
        if iv0 is not None:
            lanes.append((st.stats.integrity[0] > iv0[0]).to(torch.int64))
        if press0 is not None:
            lanes.append((st.stats.pressure[0] > press0[0]).to(torch.int64))
        vals = torch.stack(lanes).tolist()
        self.host_syncs += 1
        return int(vals[0]), bool(vals[1]), any(bool(v) for v in vals[2:])

    def round_step(self, st: SimState, params: EngineParams) -> SimState:
        if self._iv is not None:
            self._iv.enter(st)
        if self._trace_scratch is not None:
            trace_enter(self._trace_scratch, st.stats)
        window_end, done, _ = self.compute_window(st, params=params)
        return self.window_step(st, params, window_end, done)

    def window_step(self, st: SimState, params: EngineParams, window_end: int, done: bool) -> SimState:
        cfg = self.cfg
        limit = cfg.effective_microstep_limit
        steps = 0
        # whether the round staged any send, read with the loop test that
        # ends the microsteps (unknown, so merged, when the valve ends them)
        has_sends = True
        # the fluid coupling of this round, from the previous round's state
        # (the done-round runs no microstep and holds the fluid state)
        fx = None
        if cfg.fluid_active and not done:
            fx = fluid_host_effects(cfg, params.fluid, st.fluid, params.node_of)
        if cfg.effective_microstep_events > 1:
            # the valve is a per-host executed-event vector bounded by its
            # max, read in the same device-to-host read as the loop test
            valve = torch.zeros((cfg.hosts_per_shard,), dtype=torch.int64, device=self.device)
            while True:
                pending = (self.next_times(st, params) < window_end).any().to(torch.int64)
                go, vmax, sent = torch.stack(
                    [pending, valve.max(), st.outbox.count[0].to(torch.int64)]).tolist()
                self.host_syncs += 1
                if not go or vmax >= limit:
                    has_sends = sent > 0
                    break
                st, executed = self.microstep_k(st, params, window_end, fx)
                valve = valve + executed
                steps += 1
        else:
            while steps < limit:
                pending = (self.next_times(st, params) < window_end).any().to(torch.int64)
                go, sent = torch.stack([pending, st.outbox.count[0].to(torch.int64)]).tolist()
                self.host_syncs += 1
                if not go:
                    has_sends = sent > 0
                    break
                st = self.microstep(st, params, window_end, fx)
                steps += 1
        fg = None
        if fx is not None:
            # the packet -> fluid half: this round's outbox bytes per link,
            # then one ODE step over the committed window (before the
            # exchange clears the outbox; across ranks after the round's
            # sum has made the bytes global)
            fg = fluid_fg_link_bytes(cfg, st.outbox.dst, st.outbox.t, st.outbox.payload,
                                     params.node_of)
            if self.coll is None:
                st = self._fluid_step(st, params, fg, window_end, done)
        st_m = st
        if self._iv is not None:
            self._iv.pre_exchange(st_m)
        pend: dict[str, torch.Tensor] = {}
        if self.coll is None:
            st_x = self.exchange(st_m, has_sends)
        else:
            st_x, pend = self.exchange_mesh(st_m)
        occ = q_len(st_x.queue).to(torch.int64)
        ob_hwm = st_m.sent_round.max().to(torch.int64)
        s = st_x.stats
        stats = s._replace(
            rounds=s.rounds + (0 if done else 1),
            microsteps=s.microsteps + steps,
            q_occ_hwm=torch.maximum(s.q_occ_hwm, occ),
            outbox_hwm=torch.maximum(s.outbox_hwm, ob_hwm[None]),
        )
        if st_x.wheel is not None:
            # the exchange never touches the wheel: the post-exchange sample
            # is the round's post-push peak
            stats = stats._replace(wheel_occ_hwm=torch.maximum(
                stats.wheel_occ_hwm, q_len(st_x.wheel).to(torch.int64)))
        if cfg.pressure_abort:
            # the pressure signal (K26): the run's capacity-drop total after
            # the exchange (queue pushes and merge overflow, send budget,
            # outbox; across ranks the all-to-all's sheds, summed over the
            # ranks below)
            total = pressure_total(st_x.queue.dropped, stats.pkts_budget_dropped,
                                   stats.ob_dropped)
            if self.coll is None:
                stats = stats._replace(pressure=total)
            else:
                pend["pressure"] = total + stats.a2a_shed
        if self._iv is not None:
            # the sentinel's guards on the post-exchange state (the
            # done-round is never judged); across ranks the count of failed
            # checks is summed over the ranks below
            iv_before = stats.integrity.clone() if self.coll is not None else None
            stats = self._iv.post_exchange(st_x, stats, window_end, done, st.now)
            if iv_before is not None:
                pend["integrity"] = stats.integrity - iv_before
        if fg is not None and self.coll is not None:
            pend["fluid"] = fg
        if pend:
            st_x, stats = self._mesh_sums(st_x, stats, pend, params, window_end, done)
        if cfg.netobs and not done:
            # on one device this device binds every scheduling round
            stats = stats._replace(win_bound=stats.win_bound + 1)
        if cfg.trace_rounds and not done:
            # the round's trace row (K27); the done-round writes none
            q = st_x.queue
            trace_round(st_x.trace, self._trace_scratch, stats, RoundInputs(
                rounds=st.stats.rounds, window_start=st.now, window_end=window_end,
                steps=steps, sends=st_m.outbox.count, occ=occ,
                heads=q.bt if isinstance(q, BucketQueue) else q.t, ob_hwm=ob_hwm,
                gear=cfg.effective_gear_cols, cap=cfg.queue_capacity,
                crash=((params.faults.down_t, params.faults.up_t)
                       if cfg.fault_crash_windows else None)))
        return st_x._replace(
            now=st.now if done else window_end, done=done, stats=stats
        )

    def _fluid_step(self, st: SimState, params: EngineParams, fg, window_end: int,
                    done: bool) -> SimState:
        """One fluid ODE step (K15) over the round's committed window from
        its foreground bytes per link `fg`."""
        s = st.stats
        fl, bgb, bgd = fluid_advance(self.cfg, params.fluid, st.fluid, fg, st.now, window_end,
                                     done, s.fl_bg_bytes, s.fl_bg_dropped)
        return st._replace(fluid=fl, stats=s._replace(fl_bg_bytes=bgb, fl_bg_dropped=bgd))

    def _mesh_sums(self, st_x: SimState, stats: Stats, pend: dict, params, window_end: int,
                   done: bool):
        """The round's one SUM over the ranks (the JAX package's psums): the
        gear sheds, the send count whose global value decides a bucketed
        queue's rebuild count, the pressure total, the sentinel's failed
        checks and the fluid bytes per link, packed into one i64 vector.
        Returns (state, stats) with the global values applied; the fluid
        ODE steps here, on the global bytes."""
        names = list(pend)
        flat = torch.cat([pend[k].to(torch.int64).reshape(-1) for k in names])
        red = self.coll.psum(flat)
        out, at = {}, 0
        for k in names:
            n = pend[k].numel()
            out[k] = red[at:at + n].reshape(pend[k].shape)
            at += n
        if "gear" in out:
            stats = stats._replace(gear_shed=stats.gear_shed + out["gear"])
        if "count" in out:
            stats = stats._replace(bq_rebuilds=stats.bq_rebuilds + (out["count"] > 0))
        if "pressure" in out:
            stats = stats._replace(pressure=out["pressure"])
        if "integrity" in out:
            stats = stats._replace(integrity=stats.integrity - pend["integrity"]
                                   + out["integrity"])
        if "fluid" in out:
            st_x = self._fluid_step(st_x._replace(stats=stats), params, out["fluid"],
                                    window_end, done)
            stats = st_x.stats
        return st_x, stats

    def microstep(self, st: SimState, params: EngineParams, window_end: int,
                  fluid_fx=None) -> SimState:
        """The one-event microstep: pop, execute (egress appends the sends),
        push. Under the CPU model (or queue-hold crash faults) a host pops
        only while its execution floor is inside the window, and ingress
        moves the event to its execution time for every consumer
        downstream; under queue-clear faults ingress consumes an event
        whose host is down without dispatching it. On a flat queue without
        the wheel the pop and the ingress are one kernel (K36,
        `pop_ingress`); otherwise the pop, then K10."""
        wheel = st.wheel
        limit = self._pop_limit(st, _limit_of(window_end), params)
        c, ing = _ev_carry_of(st), None
        if wheel is not None:
            queue, wheel, ev, active = pop_min_merged(st.queue, wheel, limit)
        elif isinstance(st.queue, BucketQueue):
            queue, ev, active = q_pop_min(st.queue, limit)
        else:
            queue, c, ev, active, ing = pop_ingress(c, params, self.cfg, st.queue, limit,
                                                    self._timer_mask)
        lanes = self._flow_lanes(1)
        c, push_list = self.event_body(
            c, params, window_end, ev, active, fluid_fx,
            lanes.row(0) if lanes is not None else None, ing,
        )
        if wheel is not None and push_list:
            push_list, push_w, spilled = self._route_timer_pushes(wheel, push_list)
            if push_w:
                wheel = wheel_push_many(wheel, push_w)
            c = c._replace(stats=c.stats._replace(
                wheel_spilled=c.stats.wheel_spilled + spilled))
        if push_list:
            queue = q_push_many(queue, push_list)
        st = self._finish_microstep(st, c, queue, lanes)
        return st if wheel is None else st._replace(wheel=wheel)

    def _route_timer_pushes(self, wheel: TimerWheel, push_list: list[Push]):
        """Split a microstep's pushes into queue-bound and wheel-bound ones.
        A push goes to the wheel iff it is a model timer event (no packet
        flag, its kind in the model's `timer_kinds`) and the wheel still has
        a free slot after this microstep's earlier wheel pushes; a timer
        that finds the wheel full spills to the queue and is counted. The
        ingress requeue (a packet) and push ports outside the model's
        `timer_push_ports` are known never to carry a timer and skip the
        test. Returns (queue pushes, wheel pushes, spilled i64[H])."""
        model = self.model
        n_req = 1 if self.cfg.shaping else 0
        tports = getattr(model, "timer_push_ports", None)
        timer_kinds = tuple(model.timer_kinds)
        free = wheel_free(wheel)
        taken = torch.zeros_like(free)
        spilled = torch.zeros(free.shape, dtype=torch.int64, device=free.device)
        push_q, push_w = [], []
        for i, push in enumerate(push_list):
            if i < n_req or (tports is not None and (i - n_req) not in tports):
                push_q.append(push)
                continue
            kind = push.kind.to(torch.int32)
            is_kind = functools.reduce(
                torch.logical_or, [(kind & KIND_MASK) == k for k in timer_kinds])
            is_timer = push.mask & ((kind & KIND_PKT) == 0) & is_kind
            fits = is_timer & (taken < free)
            taken = taken + fits.to(torch.int32)
            spilled = spilled + (is_timer & ~fits)
            push_w.append(push._replace(mask=fits))
            push_q.append(push._replace(mask=push.mask & ~fits))
        return push_q, push_w, spilled

    def microstep_k(self, st: SimState, params: EngineParams, window_end: int, fluid_fx=None):
        """The K-way microstep: peek each host's K earliest in-window events
        (K5), fold them through the handler in turn, clear the executed
        prefix (K6) and apply every push in one pass. Returns (state',
        executed[H]).

        Exactness guard: batch event j+1 of a host executes only if no push
        this host emitted so far in this microstep (model pushes and ingress
        requeues) has an earlier (time, order) key — with one event per
        microstep that push would pop first. Deferral is monotone, so the
        executed events are a prefix of the batch; the rest stay in the
        slab. Under the CPU model a host peeks only while its busy horizon
        is inside the window, and batch event j+1 also defers once the
        events before it pushed the horizon to the window's end (the
        one-event microstep would stop popping there); under queue-hold
        crash faults likewise once it enters a crash window whose restart
        is past the window's end. Drop exactness: the
        pushes run after the clear, in one-event chronological order
        (requeue_0, pushes_0, requeue_1, ...), each holding a reserve of
        the batch events that executed after it."""
        cfg = self.cfg
        k = cfg.effective_microstep_events
        h = cfg.rows
        dev = self.device
        popped = pop_k(st.queue, self._pop_limit(st, _limit_of(window_end), params), k)
        # the per-host window ends the deferral tests read (with replicas,
        # 0 on frozen rows, which pop nothing)
        w_end = _limit_of(window_end)
        c = _ev_carry_of(st)
        deferred = torch.zeros((h,), dtype=torch.bool, device=dev)
        pm_t = torch.full((h,), TIME_MAX, dtype=torch.int64, device=dev)
        pm_o = torch.full((h,), ORDER_MAX, dtype=torch.int64, device=dev)
        cons_ks, push_lists = [], []
        lanes = self._flow_lanes(popped.t.shape[1])
        for j in range(popped.t.shape[1]):
            ev = popped.event(j)
            if j > 0:
                deferred = deferred | _lex_less(pm_t, pm_o, ev.t, ev.order)
                if cfg.cpu_delay_ns > 0:
                    deferred = deferred | (c.cpu_busy_until >= w_end)
                if cfg.fault_hold:
                    # a later batch event entering a crash window whose
                    # restart is past the horizon: the one-event microstep
                    # would stop popping this host (K23 at the event's
                    # busy-floored time, the candidate execution time)
                    t_cand = (torch.maximum(ev.t, c.cpu_busy_until) if cfg.cpu_delay_ns > 0
                              else ev.t)
                    down_j, resume_j = down_and_resume(params.faults, t_cand)
                    deferred = deferred | (down_j & (resume_j >= w_end))
            cons_j = popped.active[:, j] & ~deferred
            c, push_list = self.event_body(
                c, params, window_end, ev, cons_j, fluid_fx,
                lanes.row(j) if lanes is not None else None)
            # an event's own pushes cannot defer it: fold them in after
            for push in push_list:
                better = push.mask & _lex_less(push.t, push.order, pm_t, pm_o)
                pm_t = torch.where(better, push.t, pm_t)
                pm_o = torch.where(better, push.order, pm_o)
            cons_ks.append(cons_j.to(torch.int32))
            push_lists.append(push_list)
        m = functools.reduce(torch.add, cons_ks)
        queue = clear_popped(st.queue, popped, m)
        all_pushes = []
        for j, push_list in enumerate(push_lists):
            reserve = (functools.reduce(torch.add, cons_ks[j + 1 :]) if j + 1 < len(cons_ks)
                       else torch.zeros_like(m))
            all_pushes += [p._replace(reserve=reserve) for p in push_list]
        if all_pushes:
            queue = q_push_many(queue, all_pushes)
        if cfg.replicas == 1:
            n_deferred = popped.active.sum() - m.sum()
        else:
            n_deferred = (popped.active.sum(1) - m).view(cfg.replicas, -1).sum(1)
        c = c._replace(stats=c.stats._replace(
            popk_deferred=c.stats.popk_deferred + n_deferred
        ))
        return self._finish_microstep(st, c, queue, lanes), m

    def _flow_lanes(self, e: int) -> FlowLanes | None:
        """The flow ledger's record lanes for a microstep of `e` event
        columns, which the model's handler writes (None unless the ledger
        is on and the model has a flow port: nothing is appended then)."""
        if not (self.cfg.flow_ledger_active and getattr(self.model, "flow_ledger", False)):
            return None
        return make_flow_lanes(e, self.cfg.hosts_per_shard, self.device)

    def _finish_microstep(self, st: SimState, c: "_EvCarry", queue,
                          lanes: FlowLanes | None = None):
        """Apply the microstep's flow-ledger appends (its events' record
        lanes in one K28 pass) and reassemble the state; egress (K11)
        already appended the sends and folded the used-latency lookahead."""
        stats = c.stats
        if lanes is not None:
            flow_append(st.flows, lanes, stats.fl_done, stats.fl_bytes, stats.fl_rtx)
        return st._replace(
            queue=queue, rng=c.rng, seq=c.seq, sent_round=c.sent_round,
            tb_egress=c.tb_egress, tb_ingress=c.tb_ingress, codel=c.codel,
            model=c.model, outbox=c.outbox, min_used_lat=c.min_used_lat, stats=stats,
            cpu_busy_until=c.cpu_busy_until,
        )

    def event_body(self, c: _EvCarry, params: EngineParams, window_end: int, ev, active,
                   fluid_fx=None, flow: FlowLanes | None = None, ing: Ingress | None = None):
        """Execute one event per active host: ingress (the CPU model's
        execution time, digest, event classes, shaping, dispatch; K10, or
        `ing` where the pop already ran it, K36), the model's handler (with
        the flow ledger on, writing the event's flow records into `flow`, a
        FlowLanes row), egress (pushes, and sends appended to the carry's
        outbox with their latencies folded into its `min_used_lat`, with
        the round's fluid coupling `fluid_fx`; K11). Returns (carry',
        pushes)."""
        cfg = self.cfg
        if isinstance(window_end, FoldWindow):
            window_end = window_end.lane
        if ing is None:
            c, ing = event_ingress(c, params, cfg, ev, active, self._timer_mask)
        out = self.model.handle(HandlerCtx(
            t=ing.t,
            window_end=window_end,
            kind=ing.kind,
            payload=ev.payload,
            active=ing.dispatch,
            is_packet=ing.is_pkt,
            src=ing.src,
            host_id=self._host_gid,
            state=c.model,
            params=params.model,
            rng=c.rng,
            flow=flow,
        ))
        c = c._replace(model=out.state, rng=out.rng)
        c, pushes = event_egress(c, params, cfg, ing.t, ing.dispatch, window_end, out, fluid_fx)
        push_list = ([ing.requeue] if ing.requeue is not None else []) + pushes
        return c, push_list

    def exchange(self, st: SimState, has_sends: bool = True) -> SimState:
        """World-1 exchange: merge the outbox, host-major, into the queues
        (K4, or K13 with `merge_scatter`; under a merge gear only its first
        `gear_cols` columns, read in place, with the sends beyond them
        counted into `stats.gear_shed`); a bucketed queue then gets its
        block caches rebuilt (counted in rounds that sent anything, as the
        reference counts them). With `has_sends` False (the round staged
        nothing) the merge and the rebuild are skipped: they would not
        change the queue. The timer wheel is not touched."""
        cfg, ob = self.cfg, st.outbox
        queue, stats = st.queue, st.stats
        gc = cfg.gear_cols if cfg.gear_active else 0
        if gc:
            stats = stats._replace(
                gear_shed=stats.gear_shed + gear_shed_count(st.sent_round, gc))
        if has_sends:
            merge = merge_scatter_free if cfg.merge_scatter else merge_flat_events
            queue = merge(
                as_flat(st.queue), ob.dst, ob.t, ob.order, ob.kind, ob.payload, None,
                cfg.max_round_inserts, shed_urgency=not cfg.cheap_shed, cols=gc,
                merge_rows=cfg.merge_rows,
                rows_per_rep=cfg.hosts_per_shard if cfg.replicas > 1 else 0,
            )
            if isinstance(st.queue, BucketQueue):
                queue = bucket_rebuild(queue, st.queue.block)
                stats = stats._replace(bq_rebuilds=stats.bq_rebuilds + (ob.count > 0))
        return st._replace(
            queue=queue,
            stats=stats,
            outbox=make_empty_outbox(cfg.rows, cfg.sends_per_host_round, ob.t.device,
                                     cfg.replicas),
            sent_round=torch.zeros_like(st.sent_round),
        )

    def exchange_mesh(self, st: SimState) -> tuple[SimState, dict]:
        """The exchange across ranks (the JAX package's `_exchange`,
        `_exchange_alltoall` and `_exchange_hierarchical`), on the
        gear-sliced outbox (its first `gear_cols` columns, read in place):

          gather: the shard's rows packed at wire width (with its send
            count as one trailing row) and all-gathered, rank-major, so the
            merge sees the whole mesh's rows host-major as on one device;
          alltoall: K29 groups the rows by destination shard in (t, order)
            order into [world, a2a_block_size] blocks, one all-to-all moves
            them; block overflow counts into `a2a_shed`;
          hierarchical: the same at `hier_block_size`, after an all-to-all
            of the blocks' fill counts; a geared run's block overflow counts
            into `gear_shed` (the chunk replays wider), else into
            `a2a_shed`.

        K30 turns the received rows into the merge's planes (destinations
        rebased to the shard, rows outside it or past a fill count invalid),
        and K4 (K13 with `merge_scatter`) merges them every round; a
        bucketed queue's caches are rebuilt (K8). The exchange adds its
        modelled bytes to the ici lanes. Returns (state, the local values
        the round's SUM makes global: the gear sheds and, for the
        all-to-all kinds, the send count)."""
        cfg, coll, ob = self.cfg, self.coll, st.outbox
        h_local, base, world = cfg.hosts_per_shard, cfg.host_base, cfg.world
        gc = cfg.gear_cols if cfg.gear_active else 0
        cols = gc or ob.t.shape[1]
        stats = st.stats
        pend: dict[str, torch.Tensor] = {}
        gear = gear_shed_count(st.sent_round, gc) if gc else None
        if cfg.exchange == "gather":
            n = h_local * cols
            words = pack_words(ob.dst[:, :cols], ob.t[:, :cols], ob.order[:, :cols],
                               ob.kind[:, :cols], ob.payload[:, :cols]).reshape(n, ROW_WORDS)
            count_row = torch.zeros((1, ROW_WORDS), dtype=torch.int32, device=ob.t.device)
            count_row[0, 0] = ob.count[0]
            got = coll.all_gather(torch.cat([words, count_row]))  # [world, n + 1, W]
            rows = exchange_unpack(got, base, h_local, n=n)
            has_sends = got[:, n, 0].to(torch.int64).sum() > 0
            if isinstance(st.queue, BucketQueue):
                stats = stats._replace(bq_rebuilds=stats.bq_rebuilds + has_sends)
            ici = exchange_ici_bytes_per_round(cfg, "gather")
        else:
            hier = cfg.exchange == "hierarchical"
            k = cfg.hier_block_size if hier else cfg.a2a_block_size
            blocks, seg_len, shed = dshard_pack(ob.dst, ob.t, ob.order, ob.kind, ob.payload,
                                                h_local, world, k, cols=gc)
            counts = coll.all_to_all(torch.clamp_max(seg_len, k)) if hier else None
            recv = coll.all_to_all(blocks)  # [world, k, W]: block i from rank i
            rows = exchange_unpack(recv, base, h_local, counts)
            if isinstance(st.queue, BucketQueue):
                pend["count"] = ob.count.to(torch.int64).sum()
            if hier and cfg.gear_active:
                gear = gear + shed[0]
            else:
                stats = stats._replace(a2a_shed=stats.a2a_shed + shed)
            ici = exchange_ici_bytes_per_round(cfg)
        if gear is not None:
            pend["gear"] = gear
        merge = merge_scatter_free if cfg.merge_scatter else merge_flat_events
        queue = merge(as_flat(st.queue), *rows, cfg.max_round_inserts,
                      shed_urgency=not cfg.cheap_shed, merge_rows=cfg.merge_rows)
        if isinstance(st.queue, BucketQueue):
            queue = bucket_rebuild(queue, st.queue.block)
        stats = stats._replace(ici_bytes=stats.ici_bytes + ici)
        if cfg.hier_active:
            intra, inter = exchange_tier_bytes_per_round(cfg)
            stats = stats._replace(ici_intra=stats.ici_intra + intra,
                                   ici_inter=stats.ici_inter + inter)
        return st._replace(
            queue=queue,
            stats=stats,
            outbox=make_empty_outbox(h_local, ob.t.shape[1], ob.t.device),
            sent_round=torch.zeros_like(st.sent_round),
        ), pend


def pop_min_merged(queue, wheel: TimerWheel, limit: int):
    """Pop each host's earliest event from queue and wheel under the
    (time, order) key: compare the two heads, then each structure pops with
    the limit masked to the hosts it won (an [H] limit, 0 where it lost),
    so exactly one event pops per active host — the one the wheel-off path
    would pop from its single queue. `limit` is an int or an i64[H]
    (the CPU model's per-host limits). Live keys never tie; the all-empty tie
    on the sentinels goes to the wheel, whose pop then finds nothing.
    Returns (queue', wheel', event, active)."""
    qt, qo = q_head(queue)
    wt, wo = q_head(wheel)
    q_wins = _lex_less(qt, qo, wt, wo)
    zero = torch.zeros_like(qt)
    lim = limit if isinstance(limit, torch.Tensor) else torch.full_like(qt, limit)
    queue, ev_q, act_q = q_pop_min(queue, torch.where(q_wins, lim, zero))
    wheel, ev_w, act_w = wheel_pop_min(wheel, torch.where(q_wins, zero, lim))
    ev = Event(
        t=torch.where(act_w, ev_w.t, ev_q.t),
        order=torch.where(act_w, ev_w.order, ev_q.order),
        kind=torch.where(act_w, ev_w.kind, ev_q.kind),
        payload=torch.where(act_w[:, None], ev_w.payload, ev_q.payload),
    )
    return queue, wheel, ev, act_q | act_w
