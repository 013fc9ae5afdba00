"""Simulation driver: config -> graph -> engine -> chunk loop -> report (port
of the single-device subset of shadow_tpu/sim.py).

`Simulation(cfg, device=None)` runs on the CUDA device unless the caller
passes `device="cpu"`; without a GPU it raises. The report has the JAX
report's keys for every counter this slice has (including
`determinism_digest`, the XOR of the per-host digests as %016x, and the
`gears` block on merge-gear runs), plus the port's own `device`,
`host_syncs` and `kernel_launches` (per kernel, this run).

With `experimental.merge_gears` the run loop dispatches every chunk at the
gear the controller picked (core/pressure.py `ResilienceController`:
snapshot, run, and on a shed restore and replay wider), and the heartbeat
carries `gear=<g>`. Snapshots are taken only below the top gear; a
gear-free run without the sentinel dispatches `Engine.run_chunk` as
before.

A `fluid:` block compiles onto the graph's nodes (net/fluid.py
`compile_fluid`, zones resolved through `NetworkGraph.node_index`, the loss
draw's seed defaulting to `general.seed`); the report gains the JAX
package's `fluid{}` block and the heartbeat `bg=<bytes>/<dropped>`.

A `faults:` block compiles into crash and link-fault windows
(core/faults.py `compile_faults`, hosts named or by id, the seed defaulting
to `general.seed`); the heartbeat gains `faults=<dropped>/<delayed>`. With
`faults.supervisor.snapshot_every_chunks` > 0 every chunk runs under the
supervisor (core/supervisor.py: periodic snapshots, retry from the last
one on a dispatch failure, a graceful abort that reports the last good
state) and the report gains `supervisor{}`. With `integrity.enabled` the
chunks run through the replay controller (core/pressure.py) that also
carries the merge gears, the report gains `integrity{}` (with
`determinism_digest2`) and the heartbeat `iv=<transients>/<replays>`; a
deterministic violation ends the run with the last good state reported and
`integrity_aborted` set. The report always carries `faults_dropped`,
`faults_delayed` and `alltoall_shed_dropped` (0 on one device), as the JAX
package's does.

A `pressure:` block with policy escalate or abort runs every chunk through
the same controller with the pressure plane on (core/pressure.py; K26's
per-round drop total in ops/pressure.py, the first-drop stop, and under escalate the
capacity migration by K25 and the replay); each dispatch runs at the
state's own shapes. The report gains `pressure{}` (the controller's
accounting plus the ending `capacity` and `outbox` and their bases),
`pressure_regrows`, `pressure_replays` and, after an abort,
`pressure_aborted` and `aborted`; the heartbeat gains `cap=<capacity>`.
With `faults.supervisor.checkpoint_file` (relative to the data directory)
every supervisor snapshot is also written to disk (core/checkpoint.py
`save_checkpoint`); `load_checkpoint(path, sim)` resumes a freshly built
simulation from it, on either device.

The `observability` block runs the observatories (obs/): `trace` the round
trace ring (K27 writes a row per round into a ring of `rounds_per_chunk`
rows; the report gains `trace{}` and `per_host{}`, and `write_outputs`
writes `trace.json` and `metrics.prom`), `network` the network observatory
(K10's event classes; for a model with a flow port, K17's record lanes and
K28's flow ledger; the report's `network{}` block, heartbeat `ek=` and
`fct=`), `memory` the memory observatory (`memory{}`, `hbm=`, and under
escalate the memory guard), `runtime` the runtime observatory (`runtime{}`,
`rt=`) and `profile_dir` a torch.profiler trace of the run loop. The rings
are drained at each chunk boundary in one device-to-host read; a run that
ends on an abort keeps only the rows and records of the state it reports.
On a CUDA device the build refuses configs the queue kernels cannot take
(a base capacity above their slots, a bucketed queue above their blocks,
K above their batch), naming the knob.

With `general.parallelism` above 1 (0 = every visible card) the run spans
that many ranks, one process each (core/mesh.py): `run_mesh` (and the CLI)
launch them, each builds the whole simulation and keeps its shard of the
hosts (the host count padded to a multiple of the world with inert hosts,
as the JAX package pads it), and rank 0 reports and writes the outputs
from the mesh's gathered state; its report has the JAX package's
`ici_bytes` and `alltoall_shed_dropped` and, for the hierarchical
exchange, its `exchange{}` block. The observatories, on-disk checkpoints
and `pressure: escalate` are refused across ranks.

A config with managed processes (`path:`) is a co-simulation:
`build_simulation` and `run_simulation` hand it to the bridge
(cosim.py `HybridSimulation`), as the JAX package's `build_simulation`
does; `Simulation` refuses it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
import time
from typing import Any

import numpy as np
import torch
import yaml

from shadow_tpu_torch import resolve_device
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions, config_is_cosim
from shadow_tpu_torch.core.engine import Engine, EngineConfig, EngineParams
from shadow_tpu_torch.core.checkpoint import save_checkpoint
from shadow_tpu_torch.core.faults import INACTIVE_FAULTS, compile_faults
from shadow_tpu_torch.core.faults import KERNELS as FAULT_KERNELS
from shadow_tpu_torch.core.gears import GearController, resolve_gear_ladder
from shadow_tpu_torch.core.integrity import KERNELS as INTEGRITY_KERNELS
from shadow_tpu_torch.core.integrity import IntegrityAbort
from shadow_tpu_torch.core.mesh import gather_view, launch, resolve_world
from shadow_tpu_torch.core.pressure import (
    PressureAbort,
    ResilienceController,
    capacity_ladder,
    read_rows,
)
from shadow_tpu_torch.core.supervisor import ChunkSupervisor, SupervisorAbort
from shadow_tpu_torch.models import KERNELS as MODEL_KERNELS
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.net import TBParams
from shadow_tpu_torch.net.fluid import INACTIVE_SCHEDULE, assemble_fluid_report, compile_fluid
from shadow_tpu_torch.net.fluid import KERNELS as FLUID_KERNELS
from shadow_tpu_torch.net.graph import IpAssignment, NetworkGraph, load_graph
from shadow_tpu_torch.obs.memory import (
    MemoryGuard,
    MemoryMonitor,
    modeled_shard_bytes,
    observatory_report,
)
from shadow_tpu_torch.obs.netobs import (
    FlowCollector,
    FlowLedger,
    assemble_network_report,
    node_map,
)
from shadow_tpu_torch.obs.runtime import (
    BuildLedger,
    WallLedger,
    assemble_runtime_report,
    span_or_null,
)
from shadow_tpu_torch.obs.tracer import RoundTracer, TraceRing
from shadow_tpu_torch.ops import KERNELS as OPS_KERNELS
from shadow_tpu_torch.ops.events import MAX_BATCH, MAX_BLOCKS, MAX_CAPACITY
from shadow_tpu_torch.simtime import NS_PER_SEC

MTU_BITS = 1500 * 8
UNLIMITED_BW = 1 << 40  # token-bucket params for "no bandwidth configured"
SUPPORTED_MODELS = ("phold", "udp_echo", "timer", "tgen_tcp", "gossip", "circuit")
# every hand-written kernel's launch wrapper, by kernel name
KERNELS = {**OPS_KERNELS, **FLUID_KERNELS, **MODEL_KERNELS, **FAULT_KERNELS,
           **INTEGRITY_KERNELS}


@dataclasses.dataclass
class HostSpec:
    host_id: int
    name: str
    node_index: int  # index into the graph tables (not the GML id)
    ip: str
    bw_down_bits: int  # 0 = unlimited
    bw_up_bits: int
    model: str
    model_args: dict[str, Any]
    start_time: int
    shutdown_time: int | None
    pcap_enabled: bool = False
    pcap_capture_size: int = 65535
    # the CPU host plane's per-host TCP defaults (None on device-model hosts)
    tcp_cfg: Any = None
    # managed programs of a co-simulation host: [{path, args, start_time, ...}]
    programs: list = dataclasses.field(default_factory=list)


def _resolve_host_basics(cfg: ConfigOptions, graph: NetworkGraph):
    """Per-host resolution shared by both expanders: hosts sorted by name
    for a config-order-free host-id mapping, manual IPs assigned first,
    graph nodes and bandwidths resolved. Yields (host_id, host options,
    node, ip, bw_down, bw_up)."""
    ips = IpAssignment()
    ordered = sorted(cfg.hosts, key=lambda h: h.name)
    per_node: dict[int, int] = {}
    for h in ordered:
        n = graph.node_index(h.network_node_id)
        per_node[n] = per_node.get(n, 0) + h.count
    for n, cnt in sorted(per_node.items()):
        if cnt >= 2 and graph.lat_ns[n, n] < 0:
            raise ConfigError(
                f"graph node {int(graph.node_ids[n])} hosts {cnt} hosts but "
                f"has no self-loop edge: same-node traffic cannot route"
            )
    for i, h in enumerate(ordered):
        if h.ip_addr is not None:
            ips.assign_manual(i, h.ip_addr)
    for i, h in enumerate(ordered):
        if not h.processes:
            raise ConfigError(f"host {h.name!r} has no processes")
        node = graph.node_index(h.network_node_id)
        if h.ip_addr is None:
            ips.assign(i)
        bw_down = (h.bandwidth_down if h.bandwidth_down is not None
                   else int(graph.bw_down_bits[node]))
        bw_up = h.bandwidth_up if h.bandwidth_up is not None else int(graph.bw_up_bits[node])
        yield i, h, node, ips.ip_of(i), bw_down, bw_up


def expand_hosts(cfg: ConfigOptions, graph: NetworkGraph) -> list[HostSpec]:
    """Config hosts -> HostSpecs of a device-model config."""
    specs = []
    for i, h, node, ip, bw_down, bw_up in _resolve_host_basics(cfg, graph):
        if len(h.processes) != 1 or h.processes[0].model is None:
            raise ConfigError(
                f"host {h.name!r}: exactly one device-model process per host "
                f"is supported (got {len(h.processes)})"
            )
        p = h.processes[0]
        specs.append(HostSpec(
            host_id=i, name=h.name, node_index=node, ip=ip, bw_down_bits=bw_down,
            bw_up_bits=bw_up, model=p.model, model_args=dict(p.model_args),
            start_time=p.start_time, shutdown_time=p.shutdown_time,
        ))
    return specs


def expand_hosts_cosim(cfg: ConfigOptions, graph: NetworkGraph) -> list[HostSpec]:
    """Config -> specs of a co-simulation (the JAX package's
    `expand_hosts_hybrid`): program hosts (`path:`) run on the CPU host
    plane behind the hybrid device lane; model hosts (`model:`) run wholly
    on the device, sharing one device network with them (models/mixed.py)."""
    from shadow_tpu_torch.programs import PROGRAM_REGISTRY

    specs: list[HostSpec] = []
    for i, h, node, ip, bw_down, bw_up in _resolve_host_basics(cfg, graph):
        model_procs = [p for p in h.processes if p.model is not None]
        if model_procs:
            if len(h.processes) != 1:
                raise ConfigError(
                    f"host {h.name!r}: a modeled host runs exactly one "
                    f"model process (got {len(h.processes)} processes)")
            p = model_procs[0]
            if p.shutdown_time is not None:
                raise ConfigError(
                    f"host {h.name!r}: shutdown_time on a modeled host in a "
                    f"mixed simulation is not supported")
            if h.host_options.pcap_enabled:
                raise ConfigError(
                    f"host {h.name!r}: pcap on a modeled host in a mixed "
                    f"simulation is not supported (model packets carry no "
                    f"bytes; enable pcap on the program hosts instead)")
            specs.append(HostSpec(
                host_id=i, name=h.name, node_index=node, ip=ip, bw_down_bits=bw_down,
                bw_up_bits=bw_up, model=p.model, model_args=dict(p.model_args),
                start_time=p.start_time, shutdown_time=None, pcap_enabled=False,
                pcap_capture_size=h.host_options.pcap_capture_size))
            continue
        for p in h.processes:
            if p.path not in PROGRAM_REGISTRY:
                raise ConfigError(
                    f"host {h.name!r}: unknown program {p.path!r}; "
                    f"available: {sorted(PROGRAM_REGISTRY)}")
        specs.append(HostSpec(
            host_id=i, name=h.name, node_index=node, ip=ip, bw_down_bits=bw_down,
            bw_up_bits=bw_up, model="hybrid", model_args={}, start_time=0, shutdown_time=None,
            pcap_enabled=h.host_options.pcap_enabled,
            pcap_capture_size=h.host_options.pcap_capture_size,
            tcp_cfg=h.host_options.tcp_config(),
            programs=[{
                "path": p.path,
                "args": _program_args(p),
                "environment": dict(p.environment),
                "start_time": p.start_time,
                "shutdown_time": p.shutdown_time,
                "expected_final_state": p.expected_final_state,
            } for p in h.processes],
        ))
    return specs


def _program_args(p) -> dict:
    """Program args: `args: ["key=value", ...]` entries become a dict, other
    entries go to `_argv`, and each environment variable K to `env_K`."""
    out: dict[str, Any] = {}
    for a in p.args:
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
        else:
            out.setdefault("_argv", []).append(a)
    out.update({f"env_{k}": v for k, v in p.environment.items()})
    return out


def tb_params(bws: np.ndarray, interval_ns: int, device) -> TBParams:
    """Bandwidth -> token bucket: refill = bits per interval, burst capacity
    = refill + one MTU; unlimited lanes get a huge refill."""
    unlimited = bws <= 0
    per_itv = np.maximum(bws * interval_ns // NS_PER_SEC, 1)
    refill = np.where(unlimited, UNLIMITED_BW, per_itv).astype(np.int64)
    cap = np.where(unlimited, UNLIMITED_BW, per_itv + MTU_BITS).astype(np.int64)
    return TBParams(
        capacity=torch.as_tensor(cap, device=device),
        refill=torch.as_tensor(refill, device=device),
    )


def heartbeat_line(now_ns: int, wall: float, events: int, microsteps: int,
                   rounds: int, q_hwm: int, host_syncs: int, gear: int | None = None,
                   bg: tuple[int, int] | None = None, fault: tuple[int, int] | None = None,
                   iv: tuple[int, int] | None = None, cap: int | None = None, *,
                   hbm: int | None = None, ek: tuple[int, int] | None = None,
                   fct: int | None = None, rt: float | None = None, ici: int = 0,
                   rep: tuple[int, int] | None = None) -> str:
    """The `[heartbeat]` progress line, in the JAX package's format (ici_bytes
    the exchange's modelled bytes over the ranks, 0 on one device;
    `faults=<dropped>/<delayed>` only on fault-plane
    runs, after `q_hwm=`; `gear=` only on merge-gear runs, after `faults=`;
    `cap=<queue capacity>` only on pressure-plane runs, after `gear=`;
    `hbm=<bytes>` only on memory-observatory runs, after `cap=`;
    `ek=<timer>/<packet>` and `fct=<flows>` only on network-observatory
    runs (`fct=` with the flow ledger), after `hbm=`;
    `bg=<bytes>/<dropped>` only on fluid runs, after `fct=`;
    `iv=<transients>/<replays>` only on integrity-sentinel runs, after
    `bg=`; `rt=<last chunk's sim-s/wall-s>` only on runtime-observatory
    runs, after `iv=`; `rep=<replicas done>/<total>` only on ensemble
    campaign runs, after `rt=`) plus the port's host-sync count."""
    fault_f = f"faults={fault[0]}/{fault[1]} " if fault is not None else ""
    gear_f = f"gear={gear} " if gear is not None else ""
    cap_f = f"cap={cap} " if cap is not None else ""
    hbm_f = f"hbm={hbm} " if hbm is not None else ""
    ek_f = f"ek={ek[0]}/{ek[1]} " if ek is not None else ""
    fct_f = f"fct={fct} " if fct is not None else ""
    bg_f = f"bg={bg[0]}/{bg[1]} " if bg is not None else ""
    iv_f = f"iv={iv[0]}/{iv[1]} " if iv is not None else ""
    rt_f = f"rt={rt:.2f} " if rt is not None else ""
    rep_f = f"rep={rep[0]}/{rep[1]} " if rep is not None else ""
    return (
        f"[heartbeat] sim_time={now_ns / NS_PER_SEC:.3f}s "
        f"wall={wall:.2f}s events={events} "
        f"rounds={rounds} "
        f"msteps/round={microsteps / max(rounds, 1):.1f} "
        f"ev/mstep={events / max(microsteps, 1):.2f} "
        f"ici_bytes={ici} q_hwm={q_hwm} "
        f"{fault_f}"
        f"{gear_f}"
        f"{cap_f}"
        f"{hbm_f}"
        f"{ek_f}"
        f"{fct_f}"
        f"{bg_f}"
        f"{iv_f}"
        f"{rt_f}"
        f"{rep_f}"
        f"syncs={host_syncs} "
        f"ratio={now_ns / NS_PER_SEC / max(wall, 1e-9):.2f}x"
    )


def check_kernel_limits(ex, qcap: int) -> None:
    """The queue kernels' limits (csrc/queue.cu) against the base
    shapes, checked at build on a CUDA device so that a config never
    fails at its first launch: slots per host, blocks per host of a
    bucketed queue, and K (clamped to the capacity) per microstep. The
    CPU path runs any shape."""
    if qcap > MAX_CAPACITY:
        raise ConfigError(
            f"experimental.event_queue_capacity={qcap} exceeds the queue kernels' limit "
            f"of {MAX_CAPACITY} slots per host (csrc/queue.cu); run it on the CPU "
            f"(device='cpu') or lower the capacity")
    block = ex.event_queue_block
    if block and qcap // block > MAX_BLOCKS:
        raise ConfigError(
            f"experimental.event_queue_block={block}: capacity {qcap} makes "
            f"{qcap // block} blocks per host, past the bucketed kernels' limit of "
            f"{MAX_BLOCKS} (csrc/queue.cu); use blocks of at least "
            f"{-(-qcap // MAX_BLOCKS)} slots")
    if min(ex.microstep_events, qcap) > MAX_BATCH:
        raise ConfigError(
            f"experimental.microstep_events={ex.microstep_events} with capacity {qcap} "
            f"exceeds the K-way kernels' limit of K = {MAX_BATCH} (csrc/queue.cu); set "
            f"microstep_events to at most {MAX_BATCH}")


class Simulation:
    """Built simulation: engine + host specs + run loop, on one device, or
    one rank's part of a run across ranks (with the rank's Collectives,
    whose world it takes)."""

    def __init__(self, cfg: ConfigOptions, *, device=None, coll=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the mesh (core/mesh.py): a rank built inside `launch` takes its
        # world from its Collectives; without them the simulation runs on
        # one device, and an explicit `general.parallelism` above 1 is
        # refused (`run_simulation` and the CLI launch the ranks)
        if coll is None and cfg.general.parallelism > 1:
            resolve_world(cfg.general.parallelism, self.device)
            raise ValueError(
                f"general.parallelism={cfg.general.parallelism}: a Simulation at world > 1 is "
                f"one rank of a mesh, built with its Collectives inside core/mesh.py launch "
                f"(run_simulation and the CLI launch the ranks)")
        self.world = coll.world if coll is not None else 1
        self.coll = coll
        self.rank = coll.rank if coll is not None else 0
        if config_is_cosim(cfg):
            raise ConfigError(
                "this config has a managed process (`path:`): build it with "
                "shadow_tpu_torch.sim.build_simulation (the co-simulation bridge, cosim.py)")
        cfg.check_world(self.world)
        if cfg.campaign.active:
            raise ConfigError(
                "this config declares a campaign: block (a sweep of replicas); run it with "
                "`python -m shadow_tpu_torch.campaign CONFIG.yaml` (shadow_tpu_torch.campaign "
                "run_campaign), not as one simulation")
        self.graph = load_graph(cfg.network.graph)
        self.hosts = expand_hosts(cfg, self.graph)
        if not self.hosts:
            raise ConfigError("config defines no hosts")
        models = {h.model for h in self.hosts}
        if len(models) != 1:
            raise ConfigError(
                f"all hosts must run one device model per simulation; got {sorted(models)}"
            )
        name = models.pop()
        if name not in SUPPORTED_MODELS:
            raise ConfigError(
                f"model {name!r} is not supported by the PyTorch port yet "
                f"(supported: {', '.join(SUPPORTED_MODELS)})"
            )
        self.model = get_model(name)()
        ex = cfg.experimental
        # pad the host count to a multiple of the world with inert hosts
        # (empty queues never run; the report reads the real prefix)
        self._num_real = len(self.hosts)
        num_hosts = -(-self._num_real // self.world) * self.world
        qcap, send_budget, rpc = ex.resolve_shapes(num_hosts)
        ex.check_queue_block(qcap)
        if self.device.type == "cuda":
            self._check_kernel_limits(qcap)
        # fluid traffic plane: the background classes on the graph's nodes
        # (zone ids are GML node ids, resolved as the hosts' are)
        try:
            self._fluid_sched = (
                compile_fluid(cfg.fluid, num_links=self.graph.num_nodes,
                              default_seed=cfg.general.seed, zone_of=self.graph.node_index,
                              device=self.device)
                if cfg.fluid.active else INACTIVE_SCHEDULE
            )
        except (ValueError, KeyError) as e:
            raise ConfigError(f"fluid: {e}") from e
        fl = self._fluid_sched
        # fault plane: the seeded schedule as device arrays plus the
        # static dims the round specializes on
        try:
            self._fault_sched = (
                compile_faults(cfg.faults, num_hosts=num_hosts, num_real=self._num_real,
                               stop_time=cfg.general.stop_time,
                               bootstrap_end=cfg.general.bootstrap_end_time,
                               default_seed=cfg.general.seed,
                               name_to_id={h.name: h.host_id for h in self.hosts},
                               device=self.device)
                if cfg.faults.injecting else INACTIVE_FAULTS
            )
        except ValueError as e:
            raise ConfigError(f"faults: {e}") from e
        fs = self._fault_sched
        self._check_pressure(qcap, send_budget)
        # the timer wheel: a model with no timer kinds fails here, at
        # config time, not when the engine is built
        if ex.timer_wheel and not tuple(getattr(self.model, "timer_kinds", ())):
            raise ConfigError(
                f"experimental.timer_wheel: model {self.model.name!r} declares no "
                f"timer_kinds — nothing would route to the wheel; drop the knob or "
                f"use a model with timers"
            )
        obs = cfg.observability
        self.engine_cfg = EngineConfig(
            num_hosts=num_hosts,
            stop_time=cfg.general.stop_time,
            bootstrap_end_time=cfg.general.bootstrap_end_time,
            runahead_floor=ex.runahead,
            static_min_latency=max(self.graph.min_latency_ns_opt or 0, 1),
            use_jitter=self.graph.has_jitter,
            use_dynamic_runahead=ex.use_dynamic_runahead,
            use_codel=ex.use_codel,
            queue_capacity=qcap,
            queue_block=ex.event_queue_block,
            sends_per_host_round=send_budget,
            max_round_inserts=ex.max_round_inserts or qcap,
            rounds_per_chunk=rpc,
            microstep_limit=ex.microstep_limit,
            microstep_events=ex.microstep_events,
            shaping=any(h.bw_up_bits > 0 or h.bw_down_bits > 0 for h in self.hosts),
            cheap_shed=ex.overflow_shed == "append",
            cpu_delay_ns=ex.cpu_delay,
            merge_rows=ex.merge_rows,
            wheel_slots=ex.timer_wheel,
            wheel_block=ex.timer_wheel_block,
            merge_scatter=bool(ex.merge_scatter),
            fluid_classes=fl.classes,
            fluid_links=fl.links,
            fluid_tau_ns=fl.tau_ns,
            fluid_util_threshold=fl.util_threshold,
            fluid_loss_max=fl.loss_max,
            fluid_lat_max_x1000=fl.lat_max_x1000,
            fluid_seed=fl.seed,
            fault_crash_windows=fs.crash_windows,
            fault_loss_windows=fs.loss_windows,
            fault_queue_clear=fs.queue_clear,
            integrity=cfg.integrity.enabled,
            integrity_dual=cfg.integrity.enabled and cfg.integrity.dual_digest,
            pressure_abort=cfg.pressure.active,
            # the observatories: the trace ring sized to the chunk (drained
            # at every chunk boundary, so it never wraps); the flow ledger
            # only for a model with a flow port
            trace_rounds=rpc if obs.trace else 0,
            netobs=obs.network,
            flow_records=(obs.network_flows
                          if obs.network and getattr(self.model, "flow_ledger", False) else 0),
            world=self.world,
            rank=self.rank,
            exchange=ex.resolve_exchange(self.world),
            a2a_block=ex.a2a_block,
        )
        # merge gears: the ladder resolved against the (auto-sized) send
        # budget; [] = off (a budget of 1 leaves no narrower width)
        try:
            self._gear_ladder = resolve_gear_ladder(ex.merge_gears, send_budget)
        except ValueError as e:
            raise ConfigError(f"experimental.merge_gears: {e}") from e
        self._gearctl: GearController | None = None  # one per run()
        # gears, the pressure plane or the sentinel
        self._resil: ResilienceController | None = None
        self._supervisor: ChunkSupervisor | None = None
        self._aborted = self._integrity_aborted = self._pressure_aborted = False
        self._ob_hwm_run = 0  # run-wide outbox high-water of a geared run
        # test seams: a hook (state, attempt) -> state applied before each
        # dispatch attempt of a sentinel run (core/pressure.py
        # test_scribble), and the supervised dispatch calls (1-based) that
        # raise before dispatching
        self._integrity_test_scribble = None
        self._test_fail_dispatch: frozenset[int] = frozenset()
        self.engine = Engine(self.engine_cfg, self.model, self.device, coll)
        self._view_cache = None  # the mesh's gathered state for the report
        self._build_state()

    def _check_kernel_limits(self, qcap: int) -> None:
        check_kernel_limits(self.cfg.experimental, qcap)

    def _check_pressure(self, qcap: int, send_budget: int) -> None:
        """The pressure plane's build-time refusals: the JAX package's
        (escalate cannot cure a merge_rows bound or an explicit a2a_block;
        a ceiling below the base shape), and the port's queue kernels'
        limits, checked against the ladder's top rung so that a run never
        fails mid-way at a grown shape."""
        press, ex = self.cfg.pressure, self.cfg.experimental
        if press.policy != "escalate":
            return
        if ex.merge_rows > 0:
            raise ConfigError(
                "pressure: escalate cannot cure a merge_rows bound (its shed is positional, "
                "not capacity-sized) — drop merge_rows or keep policy: drop/abort")
        if ex.a2a_block > 0:
            raise ConfigError(
                "pressure: escalate cannot cure an explicit a2a_block's sheds (the resized "
                "programs scale only the AUTO block with the send budget) — drop a2a_block "
                "(auto-sizing follows escalation) or keep policy: drop/abort")
        if press.max_capacity and press.max_capacity < qcap:
            raise ConfigError(
                f"pressure.max_capacity={press.max_capacity} is below the configured queue "
                f"capacity {qcap}")
        if press.max_outbox and press.max_outbox < send_budget:
            raise ConfigError(
                f"pressure.max_outbox={press.max_outbox} is below the configured send "
                f"budget {send_budget}")
        top = capacity_ladder(qcap, press)[-1]
        block = ex.event_queue_block
        if top > MAX_CAPACITY or (block and top // block > MAX_BLOCKS):
            raise ConfigError(
                f"pressure: the capacity ladder's top rung {top}"
                + (f" (in blocks of {block})" if block else "")
                + f" exceeds the queue kernels' limit of {MAX_CAPACITY} slots and "
                f"{MAX_BLOCKS} blocks per host (csrc/queue.cu); set "
                f"pressure.max_capacity within it")

    def _model_hosts(self) -> list[dict]:
        return [
            {
                "host_id": h.host_id,
                "name": h.name,
                "start_time": h.start_time,
                "shutdown_time": h.shutdown_time,
                "ip": h.ip,
                "model_args": h.model_args,
            }
            for h in self.hosts
        ]

    def _pad(self, tree: dict) -> dict:
        """Model arrays [H_real, ...] zero-padded to the engine's host count
        (the JAX package's `_pad`)."""
        pad = self.engine_cfg.num_hosts - self._num_real
        if pad == 0:
            return tree
        return {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]) for k, v in tree.items()}

    def _build_state(self):
        ecfg, dev = self.engine_cfg, self.device
        try:
            mparams, mstate, events = self.model.build(
                self._model_hosts(), self.cfg.general.seed, dev
            )
        except (ValueError, KeyError) as e:
            raise ConfigError(f"model {self.model.name!r}: {e}") from e
        mparams, mstate = self._pad(mparams), self._pad(mstate)
        pad = np.zeros((ecfg.num_hosts - self._num_real,))
        node_of = np.concatenate([[s.node_index for s in self.hosts], pad]).astype(np.int32)
        bw_up = np.concatenate([[s.bw_up_bits for s in self.hosts], pad]).astype(np.int64)
        bw_down = np.concatenate([[s.bw_down_bits for s in self.hosts], pad]).astype(np.int64)
        params = EngineParams(
            node_of=torch.as_tensor(node_of, device=dev),
            lat_ns=torch.as_tensor(self.graph.lat_ns, device=dev),
            loss=torch.as_tensor(self.graph.loss, device=dev),
            jitter_ns=torch.as_tensor(self.graph.jitter_ns, device=dev),
            eg_tb=tb_params(bw_up, ecfg.tb_interval_ns, dev),
            in_tb=tb_params(bw_down, ecfg.tb_interval_ns, dev),
            model=mparams,
            fluid=self._fluid_sched.params,
            faults=self._fault_sched.params,
        )
        self.state, self.params = self.engine.init_state(
            params, mstate, events, seed=self.cfg.general.seed
        )
        self.engine_cfg = self.engine.cfg  # init_state may resolve affine routing

    def run(self, *, progress: bool | None = None, log=sys.stderr,
            start_gear: int | None = None) -> dict:
        """Drive chunks until done; returns the stats report. `start_gear`
        (merge-gear runs) is the first chunk's gear instead of the ladder's
        top, where the JAX package starts: a lower start makes early chunks
        shed and replay, a drill of the replay path that changes no
        result."""
        cfg = self.cfg
        ecfg = self.engine_cfg
        obs = cfg.observability
        show_progress = cfg.general.progress if progress is None else progress
        if self.rank != 0:
            # rank 0 speaks for the mesh
            log, show_progress = io.StringIO(), False
        hb_ns = cfg.general.heartbeat_interval
        next_hb = hb_ns
        launches0 = {k: v.launches for k, v in KERNELS.items()}
        syncs0 = self.engine.host_syncs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.monotonic()
        chunks = 0
        gearctl = GearController(self._gear_ladder) if self._gear_ladder else None
        if gearctl is not None and start_gear is not None:
            if start_gear not in gearctl.ladder:
                raise ValueError(f"start_gear={start_gear} is not on the ladder {gearctl.ladder}")
            gearctl.gear = start_gear
        self._gearctl = gearctl
        self._ob_hwm_run = 0
        self._aborted = self._integrity_aborted = self._pressure_aborted = False
        integrity_on = cfg.integrity.enabled
        pressure_on = cfg.pressure.active
        # the observatories: the collectors adopt the rings' current
        # cursors (a restored checkpoint's rows are not fresh rounds)
        tracer = flowcol = None
        if ecfg.trace_rounds or ecfg.flow_ledger_active:
            ring, ledger = self._read_rings()
            if ring is not None:
                tracer = RoundTracer(ecfg.trace_rounds)
                tracer.sync_cursor(ring)
            if ledger is not None:
                flowcol = FlowCollector(ecfg.flow_records)
                flowcol.sync_cursor(ledger)
        self._tracer, self._flowcol = tracer, flowcol
        monitor = MemoryMonitor([self.device]) if obs.memory else None
        self._memmon = monitor
        wallled = builds = None
        if obs.runtime:
            wallled = WallLedger()
            wallled.sync_sim(self.state.now)
            builds = BuildLedger(wallled)
            builds.attach()
        self._wallled, self._builds = wallled, builds
        prof = None
        if obs.profile_dir:
            os.makedirs(obs.profile_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        # the snapshot-replay seam: merge gears (a shed replays wider), the
        # pressure plane (a drop regrows and replays, or stops the run) and
        # the integrity sentinel (a violation replays to classify it)
        resil = None
        if gearctl is not None or integrity_on or pressure_on:
            memguard = None
            if pressure_on and monitor is not None:
                # memory-informed escalation: rung admission before dispatch
                memguard = MemoryGuard(ecfg, monitor,
                                       safety_factor=cfg.pressure.memory_safety_factor)
            resil = ResilienceController(
                gearctl=gearctl, pressure=cfg.pressure if pressure_on else None,
                integrity=cfg.integrity if integrity_on else None,
                queue_block=ecfg.queue_block, log=log, memory=memguard, wall=wallled)
            resil.test_scribble = self._integrity_test_scribble
        self._resil = resil
        sup = None
        if cfg.faults.supervisor.enabled:
            so = cfg.faults.supervisor
            ckpt = so.checkpoint_file
            if ckpt is not None:
                if not os.path.isabs(ckpt):
                    ckpt = os.path.join(cfg.general.data_directory, ckpt)
                os.makedirs(os.path.dirname(ckpt) or ".", exist_ok=True)
            sup = ChunkSupervisor(snapshot_every_chunks=so.snapshot_every_chunks,
                                  max_retries=so.max_retries,
                                  backoff_base_s=so.backoff_base_ms / 1000.0,
                                  checkpoint_path=ckpt,
                                  save_fn=(lambda path, st: save_checkpoint(path, self, st))
                                  if ckpt else None,
                                  log=log)
            sup.note_state(self.state)
        self._supervisor = sup
        gear = None
        calls = 0

        def chunk_step(st):
            nonlocal gear, calls
            calls += 1
            if calls in self._test_fail_dispatch:
                raise RuntimeError(f"injected dispatch failure (call {calls})")
            if resil is not None:
                st, g, hwm = resil.run_chunk(self.engine, st, self.params)
                gear = g if gearctl is not None else None
                self._ob_hwm_run = max(self._ob_hwm_run, hwm)
                return st
            return self.engine.run_chunk(st, self.params)

        def drain(t_chunk):
            # the trace ring and the flow ledger, in one device-to-host read
            if tracer is None and flowcol is None:
                return
            ring, ledger = self._read_rings()
            if tracer is not None:
                tracer.drain(ring, wall_t0=t_chunk, wall_t1=time.monotonic())
            if flowcol is not None and flowcol.drain(ledger) and tracer is not None:
                tracer.note_flows(flowcol.last_drained)

        def keep_reported_prefix():
            # the reported state was rewound (the last good snapshot): keep
            # only the rows and records its own prefix saw
            if tracer is not None:
                tracer.truncate_to_round(int(self.state.stats.rounds))
            if flowcol is not None:
                flowcol.truncate_to_cursor(self.state.flows.cursor.cpu().numpy())
                self.engine.host_syncs += 1
                if tracer is not None:
                    tracer.reset_flows(flowcol.records())

        try:
            while not self.state.done:
                t_chunk = time.monotonic()
                if wallled is not None:
                    wallled.chunk_start()
                try:
                    with span_or_null(wallled, "dispatch"):
                        if sup is not None:
                            self.state = sup.run_chunk(self.state, chunk_step)
                        else:
                            self.state = chunk_step(self.state)
                        if wallled is not None and self.device.type == "cuda":
                            # the chunk's device work belongs to its dispatch
                            torch.cuda.synchronize(self.device)
                            self.engine.host_syncs += 1
                except (IntegrityAbort, PressureAbort) as e:
                    # an integrity abort or an escalation that is cornered
                    # discards its attempts: report the last good pre-chunk
                    # state; the abort policy reports the dropping state
                    kind = "integrity" if isinstance(e, IntegrityAbort) else "pressure"
                    print(f"[{kind}] aborting run: {e}", file=log)
                    good = resil.abort_export_state()
                    if good is not None:
                        self.state = good
                    drain(t_chunk)
                    keep_reported_prefix()
                    if kind == "integrity":
                        self._integrity_aborted = True
                        if tracer is not None and resil.iv_deterministic is not None:
                            tracer.note_violation(resil.iv_deterministic)
                    else:
                        self._pressure_aborted = True
                    break
                except SupervisorAbort as e:
                    print(f"[supervisor] aborting run: {e}", file=log)
                    good = sup.abort_export_state()
                    if good is not None:
                        self.state = good
                        keep_reported_prefix()
                    self._aborted = True
                    break
                if builds is not None:
                    builds.collect()
                with span_or_null(wallled, "export"):
                    drain(t_chunk)
                    if monitor is not None:
                        t_s = time.monotonic()
                        per = monitor.sample(
                            modeled_bytes=modeled_shard_bytes(self.state, self.params),
                            wall_t=t_s)
                        if tracer is not None:
                            tracer.note_memory(t_s, per)
                chunks += 1
                now_ns = self.state.now
                if wallled is not None:
                    # heartbeat and progress printing land in the next
                    # chunk's host_python residual
                    wallled.chunk_end(now_ns)
                if hb_ns and now_ns >= next_hb:
                    self._heartbeat(log, now_ns, time.monotonic() - t0, syncs0, gear,
                                    resil, monitor, wallled)
                    next_hb = (now_ns // hb_ns + 1) * hb_ns
                if show_progress:
                    pct = min(100.0, 100.0 * now_ns / max(cfg.general.stop_time, 1))
                    print(f"\rprogress: {pct:5.1f}% ", end="", file=log, flush=True)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(obs.profile_dir, "torch_profile.json"))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._wall_seconds = time.monotonic() - t0
        if self.coll is not None:
            # the run loop's collectives, before the report gathers the mesh
            self.run_calls = dict(self.coll.calls)
            self.run_bytes_sent = self.coll.bytes_sent
        if show_progress:
            print(file=log)
        self._chunks = chunks
        self._host_syncs = self._syncs_since(syncs0)
        self._launches = {k: v.launches - launches0[k] for k, v in KERNELS.items()}
        return self.stats_report()

    def _read_rings(self) -> tuple[TraceRing | None, FlowLedger | None]:
        """The trace ring and the flow ledger as host arrays, in one
        device-to-host read (None for a ring that is off)."""
        st = self.state
        parts = [x for r in (st.trace, st.flows) if r is not None for x in (r.cursor, r.rows)]
        host = torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
        self.engine.host_syncs += 1
        out, at = [], 0
        for r, kind in ((st.trace, TraceRing), (st.flows, FlowLedger)):
            if r is None:
                out.append(None)
                continue
            n = r.rows.numel()
            out.append(kind(rows=host[at + 1:at + 1 + n].reshape(tuple(r.rows.shape)),
                            cursor=host[at:at + 1]))
            at += 1 + n
        return out[0], out[1]

    def _heartbeat(self, log, now_ns: int, wall: float, syncs0: int, gear, resil,
                   monitor, wallled) -> None:
        """One heartbeat line; its counters in one device-to-host read."""
        s = self.state.stats
        lanes = [s.events.sum(), s.microsteps.sum(), s.rounds, s.q_occ_hwm.max(),
                 s.ici_bytes.sum()]
        extra = {}
        for key, group in (("fault", (s.faults_dropped, s.faults_delayed)),
                           ("bg", (s.fl_bg_bytes, s.fl_bg_dropped)),
                           ("ek", (s.ec_timer, s.ec_pkt)), ("fct", (s.fl_done,))):
            if group[0] is not None:
                extra[key] = (len(lanes), len(group))
                lanes += [x.sum() for x in group]
        rows = read_rows(self.engine, lanes)
        # across ranks: sums, except the replicated rounds and background
        # bytes (rank 0's) and the occupancy high-water (the maximum)
        vals = [sum(c) for c in zip(*rows)]
        vals[2], vals[3] = rows[0][2], max(r[3] for r in rows)
        if "bg" in extra:
            i, n = extra["bg"]
            vals[i:i + n] = rows[0][i:i + n]
        if self.rank != 0:
            return
        got = {k: tuple(int(v) for v in vals[i:i + n]) for k, (i, n) in extra.items()}
        print(
            heartbeat_line(
                now_ns, wall, *vals[:4], self._syncs_since(syncs0), gear, got.get("bg"),
                got.get("fault"),
                (resil.iv_transients, resil.iv_replays) if self.cfg.integrity.enabled else None,
                # the ACTIVE queue capacity (escalation regrows it)
                self.state.queue.t.shape[1] if self.cfg.pressure.active else None,
                hbm=monitor.hwm_bytes() if monitor is not None else None,
                ek=got.get("ek"), fct=got["fct"][0] if "fct" in got else None,
                rt=wallled.rt_last if wallled is not None else None, ici=int(vals[4]),
            ),
            file=log,
        )

    def _syncs_since(self, syncs0: int) -> int:
        """Device-to-host reads of this run: the engine's, the supervisor's
        and the controller's own."""
        sup, resil = self._supervisor, self._resil
        return (self.engine.host_syncs - syncs0 + (sup.syncs if sup is not None else 0)
                + (resil.syncs if resil is not None else 0))

    def _view(self):
        """The state the report reads: this state on one device; across a
        mesh every rank's shard gathered (a collective: every rank calls
        it, the first time for each state)."""
        if self.coll is None:
            return self.state
        cached = self._view_cache
        if cached is None or cached[0] is not self.state:
            cached = (self.state, gather_view(self.state, self.coll,
                                              self.engine_cfg.hosts_per_shard))
            self._view_cache = cached
        return cached[1]

    def host_digests(self) -> np.ndarray:
        """Per-host event digests as uint64 (the real hosts)."""
        d = self._view().stats.digest.cpu().numpy().view(np.uint64)
        return d[:self._num_real]

    def stats_report(self) -> dict:
        report = self._base_report()
        view, n = self._view(), self._num_real
        if self.engine_cfg.hier_active:
            # the hierarchical exchange's two tiers (the JAX package's block)
            report["exchange"] = {
                "kind": "hierarchical",
                "block": self.engine_cfg.hier_block_size,
                "ici_intra_bytes": int(view.stats.ici_intra.sum()),
                "ici_inter_bytes": int(view.stats.ici_inter.sum()),
            }
        if self.engine_cfg.wheel_active:
            # occupancy high-water and spills: the slot-sizing signal; the
            # wheel's own drop lane is zero by construction (spills route
            # around a full wheel)
            s, w = view.stats, view.wheel
            report["wheel"] = {
                "slots": self.engine_cfg.wheel_slots,
                "block": w.block,
                "occupancy_hwm": int(s.wheel_occ_hwm[:n].max()),
                "spilled": int(s.wheel_spilled[:n].sum()),
                "dropped": int(w.dropped[:n].sum()),
            }
        if self._gearctl is not None:
            report["gears"] = self._gearctl.report()
        if self.cfg.pressure.active and self._resil is not None:
            rc = self._resil
            report["pressure"] = {
                **rc.report(),
                # the shapes the run ENDED at (escalation regrows them)
                "capacity": self.state.queue.t.shape[1],
                "outbox": self.state.outbox.t.shape[1],
                "base_capacity": self.engine_cfg.queue_capacity,
                "base_outbox": self.engine_cfg.sends_per_host_round,
            }
            report["pressure_regrows"] = rc.regrows + rc.proactive_regrows
            report["pressure_replays"] = rc.replays
            if self._pressure_aborted:
                report["pressure_aborted"] = True
                report["aborted"] = True
        if self.engine_cfg.integrity:
            # the sentinel's transient/replay accounting, the second digest
            # fold and, after an IntegrityAbort, the violation's naming
            block = (self._resil.integrity_report() if self._resil is not None
                     else {"transients": 0, "replays": 0,
                           "max_replays": self.cfg.integrity.max_replays})
            if self.engine_cfg.integrity_dual:
                d2 = view.stats.digest2.cpu().numpy().view(np.uint64)[:n]
                block["determinism_digest2"] = f"{int(np.bitwise_xor.reduce(d2)):016x}"
            report["integrity"] = block
            if self._integrity_aborted:
                report["integrity_aborted"] = True
                report["aborted"] = True
        if self.engine_cfg.netobs:
            # the network observatory: event classes, the safe window, the
            # flow ledger and the per-link fold
            h = self.engine_cfg.num_hosts
            report["network"] = assemble_network_report(
                stats=self.state.stats, num_real=h, rounds=report["rounds"],
                node_of=node_map(self.hosts, h), model=self.model,
                model_state=self._model_host_view(),
                flow_ledger=self.engine_cfg.flow_ledger_active,
                collector=getattr(self, "_flowcol", None))
        if self.engine_cfg.fluid_active:
            report["fluid"] = assemble_fluid_report(
                stats=view.stats, fluid_state=view.fluid, cfg=self.engine_cfg)
        if getattr(self, "_memmon", None) is not None:
            report["memory"] = observatory_report(
                self.engine, self.state, self.params, self._memmon,
                ledger=self.cfg.observability.memory_ledger)
        if self.cfg.observability.runtime:
            report["runtime"] = assemble_runtime_report(
                wall=getattr(self, "_wallled", None), compiles=getattr(self, "_builds", None),
                total_wall_s=report["wall_seconds"])
        if self._supervisor is not None:
            report["supervisor"] = self._supervisor.report()
        if self._aborted:
            # bounded retries exhausted: the report describes the last good
            # snapshot, unless it failed its cross-check
            report["aborted"] = True
            if self._supervisor is not None and self._supervisor.poisoned:
                report["poisoned"] = True
        tracer = getattr(self, "_tracer", None)
        if tracer is not None:
            s = self.state.stats
            report["trace"] = tracer.summary()
            report["per_host"] = {
                "events_processed": s.events.tolist(),
                "queue_occupancy_hwm": s.q_occ_hwm.tolist(),
            }
        return report

    def _model_host_view(self) -> dict:
        """The model state as host arrays, read once per state."""
        st = self._view().model
        cached = getattr(self, "_model_view_cache", None)
        if cached is not None and cached[0] is st:
            return cached[1]
        n = self._num_real
        view = {k: v.cpu().numpy()[:n] for k, v in st.items()}
        self._model_view_cache = (st, view)
        return view

    def _base_report(self) -> dict:
        state, n = self._view(), self._num_real
        s = {k: v.cpu().numpy() for k, v in state.stats._asdict().items()
             if v is not None}
        wall = getattr(self, "_wall_seconds", None)
        sim_s = self.state.now / NS_PER_SEC
        digest = int(np.bitwise_xor.reduce(self.host_digests()))
        return {
            "simulated_seconds": sim_s,
            "wall_seconds": wall,
            "sim_wall_ratio": (sim_s / wall) if wall else None,
            "rounds": int(s["rounds"]),
            "microsteps": int(s["microsteps"].sum()),
            "events_processed": int(s["events"][:n].sum()),
            "packets_sent": int(s["pkts_sent"][:n].sum()),
            "packets_delivered": int(s["pkts_delivered"][:n].sum()),
            "packets_lost": int(s["pkts_lost"][:n].sum()),
            "packets_unreachable": int(s["pkts_unreachable"][:n].sum()),
            "packets_codel_dropped": int(s["pkts_codel_dropped"][:n].sum()),
            "queue_overflow_dropped": int(state.queue.dropped[:n].sum()),
            "packets_budget_dropped": int(s["pkts_budget_dropped"][:n].sum()),
            "faults_dropped": (int(s["faults_dropped"][:n].sum()) if "faults_dropped" in s
                               else 0),
            "faults_delayed": (int(s["faults_delayed"][:n].sum()) if "faults_delayed" in s
                               else 0),
            "outbox_overflow_dropped": int(s["ob_dropped"].sum()),
            # the all-to-all exchanges' block sheds (none on one device)
            "alltoall_shed_dropped": int(s["a2a_shed"].sum()),
            "bucket_cache_rebuilds": int(s["bq_rebuilds"].sum()),
            "popk_deferred": int(s["popk_deferred"].sum()),
            "ici_bytes": int(s["ici_bytes"].sum()),
            "queue_occupancy_hwm": int(s["q_occ_hwm"][:n].max()),
            # a geared run resets the device lane every chunk: fold in the
            # run-wide maximum kept here
            "outbox_send_hwm": max(int(s["outbox_hwm"].max()), self._ob_hwm_run),
            "monotonic_violations": int(s["monotonic_violations"][:n].sum()),
            "determinism_digest": f"{digest:016x}",
            "model_report": self.model.report(self._model_host_view(), self._model_hosts()),
            "device": str(self.device),
            "host_syncs": getattr(self, "_host_syncs", None),
            "kernel_launches": getattr(self, "_launches", None),
        }

    def write_outputs(self, data_dir: str | None = None, report: dict | None = None) -> str:
        """Write the data directory as the JAX package does:
        processed-config.yaml, sim-stats.json and hosts/<name>/host-stats.json
        (the per-host counters and digest)."""
        data_dir = data_dir or self.cfg.general.data_directory
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "processed-config.yaml"), "w") as f:
            yaml.safe_dump(self.cfg.to_dict(), f, sort_keys=False)
        if report is None:
            report = self.stats_report()
        with open(os.path.join(data_dir, "sim-stats.json"), "w") as f:
            json.dump(report, f, indent=2)
        st = self._view().stats
        lanes = {k: getattr(st, f).cpu().numpy() for k, f in (
            ("events_processed", "events"), ("packets_sent", "pkts_sent"),
            ("packets_delivered", "pkts_delivered"), ("packets_lost", "pkts_lost"),
            ("queue_occupancy_hwm", "q_occ_hwm"))}
        if self.engine_cfg.netobs:
            # the network observatory's per-host counters: drop lanes by
            # cause and the model's per-host network counters
            lanes.update({k: getattr(st, f).cpu().numpy() for k, f in (
                ("packets_codel_dropped", "pkts_codel_dropped"),
                ("packets_budget_dropped", "pkts_budget_dropped"),
                ("packets_unreachable", "pkts_unreachable"))})
            if hasattr(self.model, "per_host_network"):
                lanes.update(self.model.per_host_network(self._model_host_view()))
        digests = self.host_digests()
        for h in self.hosts:
            hd = os.path.join(data_dir, "hosts", h.name)
            os.makedirs(hd, exist_ok=True)
            with open(os.path.join(hd, "host-stats.json"), "w") as f:
                json.dump({
                    "name": h.name,
                    "ip": h.ip,
                    **{k: int(v[h.host_id]) for k, v in lanes.items()},
                    "determinism_digest": f"{int(digests[h.host_id]):016x}",
                }, f, indent=2)
        tracer = getattr(self, "_tracer", None)
        if tracer is not None:
            # the Chrome trace (with the kernel-build track) and the metrics
            builds = getattr(self, "_builds", None)
            if builds is not None:
                tracer.note_compiles(builds.events())
            tracer.write_artifacts(data_dir, self.cfg.observability, report)
        return data_dir


def _rank_run(coll, cfg: ConfigOptions, device_type: str, data_dir: str | None):
    """One rank of a mesh run (core/mesh.py launch): build, run and, on rank
    0, write the outputs; returns rank 0's report."""
    dev = torch.device("cuda", coll.rank) if device_type == "cuda" else torch.device("cpu")
    sim = Simulation(cfg, device=dev, coll=coll)
    report = sim.run()
    if coll.rank != 0:
        return None
    if data_dir is not None:
        sim.write_outputs(data_dir, report)
    return report


def run_mesh(cfg: ConfigOptions, *, device=None, data_dir: str | None = None) -> dict:
    """Run `cfg` over `general.parallelism` ranks (0: every visible card),
    one process each: NCCL ranks on cuda:0..world-1, or gloo ranks on the
    CPU. Rank 0 writes the outputs into `data_dir` (None: none) and its
    report is returned."""
    dev = resolve_device(device)
    world = resolve_world(cfg.general.parallelism, dev)
    cfg.check_world(world)
    return launch(_rank_run, world, dev.type, (cfg, dev.type, data_dir))[0]


def build_simulation(cfg: ConfigOptions, *, device=None):
    """A modeled config -> `Simulation`; a config with a managed process ->
    the co-simulation bridge's `HybridSimulation` (cosim.py), as the JAX
    package's `build_simulation` picks them."""
    if config_is_cosim(cfg):
        from shadow_tpu_torch.cosim import HybridSimulation

        return HybridSimulation(cfg, device=device)
    return Simulation(cfg, device=device)


def run_simulation(cfg: ConfigOptions, *, device=None):
    """Build and run `cfg`: (simulation, report) on one device; across
    `general.parallelism` ranks (0: every visible card; core/mesh.py)
    (None, rank 0's report). A co-simulation config runs the bridge."""
    dev = resolve_device(device)
    if not config_is_cosim(cfg) and resolve_world(cfg.general.parallelism, dev) > 1:
        return None, run_mesh(cfg, device=dev)
    sim = build_simulation(cfg, device=dev)
    return sim, sim.run()
