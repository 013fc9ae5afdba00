"""Simulation driver: config -> graph -> engine -> chunk loop -> report (port
of the single-device subset of shadow_tpu/sim.py).

`Simulation(cfg, device=None)` runs on the CUDA device unless the caller
passes `device="cpu"`; without a GPU it raises. The report has the JAX
report's keys for every counter this slice has (including
`determinism_digest`, the XOR of the per-host digests as %016x, and the
`gears` block on merge-gear runs), plus the port's own `device`,
`host_syncs` and `kernel_launches` (per kernel, this run).

With `experimental.merge_gears` the run loop dispatches every chunk at the
gear the controller picked (core/gears.py `run_adaptive_chunk`: snapshot,
run, and on a shed restore and replay wider), and the heartbeat carries
`gear=<g>`. Snapshots are taken only below the top gear; a gear-free run
dispatches `Engine.run_chunk` as before.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any

import numpy as np
import torch
import yaml

from shadow_tpu_torch import resolve_device
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions
from shadow_tpu_torch.core.engine import Engine, EngineConfig, EngineParams
from shadow_tpu_torch.core.gears import GearController, resolve_gear_ladder, run_adaptive_chunk
from shadow_tpu_torch.models import get_model
from shadow_tpu_torch.net import TBParams
from shadow_tpu_torch.net.graph import IpAssignment, NetworkGraph, load_graph
from shadow_tpu_torch.ops import KERNELS
from shadow_tpu_torch.simtime import NS_PER_SEC

MTU_BITS = 1500 * 8
UNLIMITED_BW = 1 << 40  # token-bucket params for "no bandwidth configured"
SUPPORTED_MODELS = ("phold", "udp_echo", "timer", "tgen_tcp")


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


def expand_hosts(cfg: ConfigOptions, graph: NetworkGraph) -> list[HostSpec]:
    """Config hosts -> HostSpecs, sorted by name for a config-order-free
    host-id mapping, with IPs, graph nodes and bandwidths resolved."""
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
    specs = []
    for i, h in enumerate(ordered):
        if len(h.processes) != 1:
            raise ConfigError(
                f"host {h.name!r}: exactly one device-model process per host "
                f"is supported (got {len(h.processes)})"
            )
        node = graph.node_index(h.network_node_id)
        if h.ip_addr is None:
            ips.assign(i)
        p = h.processes[0]
        specs.append(HostSpec(
            host_id=i,
            name=h.name,
            node_index=node,
            ip=ips.ip_of(i),
            bw_down_bits=h.bandwidth_down if h.bandwidth_down is not None
            else int(graph.bw_down_bits[node]),
            bw_up_bits=h.bandwidth_up if h.bandwidth_up is not None
            else int(graph.bw_up_bits[node]),
            model=p.model,
            model_args=dict(p.model_args),
            start_time=p.start_time,
            shutdown_time=p.shutdown_time,
        ))
    return specs


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
                   rounds: int, q_hwm: int, host_syncs: int, gear: int | None = None) -> str:
    """The `[heartbeat]` progress line, in the JAX package's format (ici_bytes
    is 0 on one device; `gear=` only on merge-gear runs, where the JAX
    package puts it after `faults=` and before `cap=`) plus the port's
    host-sync count."""
    gear_f = f"gear={gear} " if gear is not None else ""
    return (
        f"[heartbeat] sim_time={now_ns / NS_PER_SEC:.3f}s "
        f"wall={wall:.2f}s events={events} "
        f"rounds={rounds} "
        f"msteps/round={microsteps / max(rounds, 1):.1f} "
        f"ev/mstep={events / max(microsteps, 1):.2f} "
        f"ici_bytes=0 q_hwm={q_hwm} "
        f"{gear_f}"
        f"syncs={host_syncs} "
        f"ratio={now_ns / NS_PER_SEC / max(wall, 1e-9):.2f}x"
    )


class Simulation:
    """Built simulation: engine + host specs + run loop, on one device."""

    def __init__(self, cfg: ConfigOptions, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
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
        num_hosts = len(self.hosts)
        qcap, send_budget, rpc = ex.resolve_shapes(num_hosts)
        ex.check_queue_block(qcap)
        # the timer wheel: a model with no timer kinds fails here, at
        # config time, not when the engine is built
        if ex.timer_wheel and not tuple(getattr(self.model, "timer_kinds", ())):
            raise ConfigError(
                f"experimental.timer_wheel: model {self.model.name!r} declares no "
                f"timer_kinds — nothing would route to the wheel; drop the knob or "
                f"use a model with timers"
            )
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
            wheel_slots=ex.timer_wheel,
            wheel_block=ex.timer_wheel_block,
            merge_scatter=bool(ex.merge_scatter),
        )
        # merge gears: the ladder resolved against the (auto-sized) send
        # budget; [] = off (a budget of 1 leaves no narrower width)
        try:
            self._gear_ladder = resolve_gear_ladder(ex.merge_gears, send_budget)
        except ValueError as e:
            raise ConfigError(f"experimental.merge_gears: {e}") from e
        self._gearctl: GearController | None = None  # one per run()
        self._ob_hwm_run = 0  # run-wide outbox high-water of a geared run
        self.engine = Engine(self.engine_cfg, self.model, self.device)
        self._build_state()

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

    def _build_state(self):
        ecfg, dev = self.engine_cfg, self.device
        try:
            mparams, mstate, events = self.model.build(
                self._model_hosts(), self.cfg.general.seed, dev
            )
        except (ValueError, KeyError) as e:
            raise ConfigError(f"model {self.model.name!r}: {e}") from e
        node_of = np.array([s.node_index for s in self.hosts], np.int32)
        bw_up = np.array([s.bw_up_bits for s in self.hosts], np.int64)
        bw_down = np.array([s.bw_down_bits for s in self.hosts], np.int64)
        params = EngineParams(
            node_of=torch.as_tensor(node_of, device=dev),
            lat_ns=torch.as_tensor(self.graph.lat_ns, device=dev),
            loss=torch.as_tensor(self.graph.loss, device=dev),
            jitter_ns=torch.as_tensor(self.graph.jitter_ns, device=dev),
            eg_tb=tb_params(bw_up, ecfg.tb_interval_ns, dev),
            in_tb=tb_params(bw_down, ecfg.tb_interval_ns, dev),
            model=mparams,
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
        show_progress = cfg.general.progress if progress is None else progress
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
        gear = None
        while not self.state.done:
            if gearctl is not None:
                self.state, gear, hwm = run_adaptive_chunk(
                    gearctl, self.engine, self.state, self.params)
                self._ob_hwm_run = max(self._ob_hwm_run, hwm)
            else:
                self.state = self.engine.run_chunk(self.state, self.params)
            chunks += 1
            now_ns = self.state.now
            if hb_ns and now_ns >= next_hb:
                s = self.state.stats
                # one device-to-host read for the four counters
                events, microsteps, rounds, q_hwm = torch.stack([
                    s.events.sum(), s.microsteps.sum(), s.rounds, s.q_occ_hwm.max(),
                ]).tolist()
                self.engine.host_syncs += 1
                print(
                    heartbeat_line(
                        now_ns, time.monotonic() - t0, events, microsteps, rounds,
                        q_hwm, self.engine.host_syncs - syncs0, gear,
                    ),
                    file=log,
                )
                next_hb = (now_ns // hb_ns + 1) * hb_ns
            if show_progress:
                pct = min(100.0, 100.0 * now_ns / max(cfg.general.stop_time, 1))
                print(f"\rprogress: {pct:5.1f}% ", end="", file=log, flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._wall_seconds = time.monotonic() - t0
        if show_progress:
            print(file=log)
        self._chunks = chunks
        self._host_syncs = self.engine.host_syncs - syncs0
        self._launches = {k: v.launches - launches0[k] for k, v in KERNELS.items()}
        return self.stats_report()

    def host_digests(self) -> np.ndarray:
        """Per-host event digests as uint64."""
        return self.state.stats.digest.cpu().numpy().view(np.uint64)

    def stats_report(self) -> dict:
        report = self._base_report()
        if self.engine_cfg.wheel_active:
            # occupancy high-water and spills: the slot-sizing signal; the
            # wheel's own drop lane is zero by construction (spills route
            # around a full wheel)
            s, w = self.state.stats, self.state.wheel
            report["wheel"] = {
                "slots": self.engine_cfg.wheel_slots,
                "block": w.block,
                "occupancy_hwm": int(s.wheel_occ_hwm.max()),
                "spilled": int(s.wheel_spilled.sum()),
                "dropped": int(w.dropped.sum()),
            }
        if self._gearctl is not None:
            report["gears"] = self._gearctl.report()
        return report

    def _base_report(self) -> dict:
        s = {k: v.cpu().numpy() for k, v in self.state.stats._asdict().items()
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
            "events_processed": int(s["events"].sum()),
            "packets_sent": int(s["pkts_sent"].sum()),
            "packets_delivered": int(s["pkts_delivered"].sum()),
            "packets_lost": int(s["pkts_lost"].sum()),
            "packets_unreachable": int(s["pkts_unreachable"].sum()),
            "packets_codel_dropped": int(s["pkts_codel_dropped"].sum()),
            "queue_overflow_dropped": int(self.state.queue.dropped.sum()),
            "packets_budget_dropped": int(s["pkts_budget_dropped"].sum()),
            "outbox_overflow_dropped": int(s["ob_dropped"].sum()),
            "bucket_cache_rebuilds": int(s["bq_rebuilds"].sum()),
            "popk_deferred": int(s["popk_deferred"].sum()),
            "queue_occupancy_hwm": int(s["q_occ_hwm"].max()),
            # a geared run resets the device lane every chunk: fold in the
            # run-wide maximum kept here
            "outbox_send_hwm": max(int(s["outbox_hwm"].max()), self._ob_hwm_run),
            "monotonic_violations": int(s["monotonic_violations"].sum()),
            "determinism_digest": f"{digest:016x}",
            "model_report": self.model.report(
                {k: v.cpu().numpy() for k, v in self.state.model.items()},
                self._model_hosts(),
            ),
            "device": str(self.device),
            "host_syncs": getattr(self, "_host_syncs", None),
            "kernel_launches": getattr(self, "_launches", None),
        }

    def write_outputs(self, data_dir: str | None = None, report: dict | None = None) -> str:
        """Write processed-config.yaml and sim-stats.json into the data
        directory."""
        data_dir = data_dir or self.cfg.general.data_directory
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "processed-config.yaml"), "w") as f:
            yaml.safe_dump(self.cfg.to_dict(), f, sort_keys=False)
        with open(os.path.join(data_dir, "sim-stats.json"), "w") as f:
            json.dump(report if report is not None else self.stats_report(), f, indent=2)
        return data_dir


def run_simulation(cfg: ConfigOptions, *, device=None) -> tuple[Simulation, dict]:
    sim = Simulation(cfg, device=device)
    return sim, sim.run()
