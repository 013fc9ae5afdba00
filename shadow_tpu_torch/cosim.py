"""Co-simulation bridge: CPU-plane hosts over the device network (port of
shadow_tpu/cosim.py `HybridSimulation`).

Hosts whose processes are managed programs (`path:` naming a registered
coroutine program, programs/) run on the CPU host plane (host/, tcp/);
every host owns one device lane, and all traffic crosses the device
network. Per window [start, end):

  1. joint barrier: t_next = min(CPU plane, device plane) next event time
     (the device's queue heads, no floors); window_end = min(t_next +
     runahead, stop);
  2. the CPU hosts run to window_end, in host-id order (or on the
     `experimental.host_workers` pool, flushed in host-id order); socket
     egress is staged as (src, t, dst, size, key) with the bytes held here,
     keyed by (src, key);
  3. prepare: cap_n is zeroed and the staged send requests merge into the
     device queues (K4, `merge_flat_events`), STAGING_CAP at a time;
  4. the guarded round loop (`Engine.run_guarded_chunk`, K35's test and
     window, one host read per round) runs device rounds while the device
     is below `until` = max(min(CPU plane's next, stop), window_end) and no
     capture ring holds a delivery;
  5. the capture rings are drained (cap_n read first, the rings only when
     one is non-zero), (src, key) is mapped back to bytes, and each
     delivery is scheduled on its CPU host at its arrival time.

Conservative lookahead makes this exact: every cross-host arrival lands at
>= window_end, so a packet staged in window N is delivered in window N+1
or later on both planes. The device lanes run the hybrid model (K33) or,
with device-modeled hosts beside the programs, the mixed plane (K34 around
K33 and the inner model's kernel).

Refused here, as in the JAX package: the fluid plane, host crashes and
churn, `pressure.policy: escalate`, the timer wheel and more than one
device model. `ConfigOptions.check_cosim` refuses at load what the port's
bridge does not run yet (real binaries, world > 1, merge gears, the
supervisor, the integrity sentinel, the pressure abort policy and the
observatories).

The report has the JAX package's keys, plus the port's `device`,
`host_syncs` (device-to-host reads of the run), `host_syncs_per_window`
and `kernel_launches`.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np
import torch
import yaml

from shadow_tpu_torch import resolve_device
from shadow_tpu_torch.config.options import ConfigError, ConfigOptions
from shadow_tpu_torch.core.engine import Engine, EngineConfig, EngineParams
from shadow_tpu_torch.core.faults import INACTIVE_FAULTS, compile_faults
from shadow_tpu_torch.host import CpuHost, HostConfig
from shadow_tpu_torch.host.sockets import NetPacket
from shadow_tpu_torch.models.base import get_model
from shadow_tpu_torch.models.hybrid import (
    KIND_SENDREQ,
    PW_DST_OR_SRC,
    PW_FLAGS,
    PW_KEY,
    PW_SIZE,
    HybridModel,
)
from shadow_tpu_torch.models.mixed import MixedModel
from shadow_tpu_torch.net.dns import Dns
from shadow_tpu_torch.net.graph import load_graph
from shadow_tpu_torch.obs import PcapWriter, PerfTimers, SimLogger, StraceLogger
from shadow_tpu_torch.ops.events import (
    _LOCAL_SHIFT,
    _SRC_SHIFT,
    SEQ_MASK,
    BucketQueue,
    as_flat,
    bucket_rebuild,
    q_next_time,
)
from shadow_tpu_torch.ops.merge import merge_flat_events
from shadow_tpu_torch.programs import get_program
from shadow_tpu_torch.simtime import NS_PER_SEC, TIME_MAX

_BYTES_GC_WINDOWS = 1024  # sweep horizon for lost-packet payloads
# staged send requests merged per prepare step (the rows of one K4 launch);
# more in one window take several merges before any device round runs
STAGING_CAP = 4096

# the flags word of a bridge send request: "the byte store holds this key";
# echo reconstruction in _drain_captures fires only on payloads carrying it
BYTES_KEY_MAGIC = 0x53484457  # "SHDW"


def _pad_tree(tree: dict, pad: int) -> dict:
    """Zero-pad every [H_real, ...] leaf (nested dicts included) to
    [H_real + pad, ...]."""
    if pad == 0:
        return tree
    out = {}
    for k, v in tree.items():
        out[k] = (_pad_tree(v, pad) if isinstance(v, dict)
                  else torch.cat([v, v.new_zeros((pad, *v.shape[1:]))]))
    return out


def _host_view(tree: dict) -> dict:
    """A (nested) dict of device tensors as numpy arrays."""
    return {k: _host_view(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in tree.items()}


class HybridSimulation:
    """A config with managed processes, built and run on one device (the
    CUDA device unless `device="cpu"`); CLI-compatible with `Simulation`."""

    def __init__(self, cfg: ConfigOptions, *, device=None):
        from shadow_tpu_torch import sim as simmod

        self.cfg = cfg
        self.device = resolve_device(device)
        cfg.check_cosim()
        self.graph = load_graph(cfg.network.graph)
        self.specs = simmod.expand_hosts_cosim(cfg, self.graph)
        if not self.specs:
            raise ConfigError("config defines no hosts")
        if cfg.fluid.active:
            raise ConfigError(
                "fluid: the hybrid (managed-process) driver does not "
                "support the fluid traffic plane yet — the CPU plane's "
                "packets would bypass the background coupling; run a "
                "pure device-model sim or drop the fluid block")
        model_names = {s.model for s in self.specs if s.model != "hybrid"}
        if model_names:
            if len(model_names) > 1:
                raise ConfigError(
                    f"mixed simulation supports one device model, got {sorted(model_names)}")
            inner_name = model_names.pop()
            if inner_name not in simmod.SUPPORTED_MODELS:
                raise ConfigError(
                    f"model {inner_name!r} is not supported by the PyTorch port yet "
                    f"(supported: {', '.join(simmod.SUPPORTED_MODELS)})")
            self.model = MixedModel(get_model(inner_name)(), inner_name)
        else:
            self.model = HybridModel()
        ex = cfg.experimental
        self._num_real = len(self.specs)
        num_hosts = self._num_real
        # the CPU plane lands many events per host per window: a roomy slab
        # (overflow is counted in queue_overflow_dropped, never silent)
        auto_qcap, auto_budget, auto_rpc = ex.resolve_shapes(num_hosts)
        qcap = max(auto_qcap, 256)
        ex.check_queue_block(qcap)
        if self.device.type == "cuda":
            simmod.check_kernel_limits(ex, qcap)
        if cfg.faults.crashes or (
                cfg.faults.host_churn is not None and cfg.faults.host_churn.prob > 0):
            raise ConfigError(
                "faults: host crashes/churn are not supported on hybrid "
                "(program) simulations — the CPU plane cannot pause live "
                "processes; use loss_windows, or model the hosts")
        if cfg.pressure.policy == "escalate":
            raise ConfigError(
                "pressure: escalate is not supported on hybrid (program) "
                "simulations — the CPU bridge cannot migrate staged state "
                "across queue shapes; use policy drop/abort or model the "
                "hosts")
        if ex.timer_wheel:
            raise ConfigError(
                "experimental.timer_wheel is not supported on hybrid "
                "(program) simulations — the bridge model declares no "
                "timer_kinds; drop the knob or model the hosts")
        try:
            self._fault_sched = (
                compile_faults(cfg.faults, num_hosts=num_hosts, num_real=self._num_real,
                               stop_time=cfg.general.stop_time,
                               bootstrap_end=cfg.general.bootstrap_end_time,
                               default_seed=cfg.general.seed, device=self.device)
                if cfg.faults.injecting else INACTIVE_FAULTS)
        except ValueError as e:
            raise ConfigError(f"faults: {e}") from e
        rpc = max(auto_rpc, 1)
        self.engine_cfg = EngineConfig(
            num_hosts=num_hosts,
            stop_time=cfg.general.stop_time,
            bootstrap_end_time=cfg.general.bootstrap_end_time,
            runahead_floor=ex.runahead,
            static_min_latency=max(self.graph.min_latency_ns_opt or 0, 1),
            use_jitter=self.graph.has_jitter,
            use_dynamic_runahead=False,
            use_codel=ex.use_codel,
            queue_capacity=qcap,
            queue_block=ex.event_queue_block,
            sends_per_host_round=max(auto_budget, 32),
            max_round_inserts=ex.max_round_inserts or qcap,
            # bounds each guarded dispatch, the only device execution path
            rounds_per_chunk=rpc,
            microstep_limit=ex.microstep_limit,
            microstep_events=ex.microstep_events,
            merge_scatter=bool(ex.merge_scatter),
            shaping=any(s.bw_up_bits > 0 or s.bw_down_bits > 0 for s in self.specs),
            fault_loss_windows=self._fault_sched.loss_windows,
        )
        self.engine = Engine(self.engine_cfg, self.model, self.device)
        self._build()

    # ---- build -------------------------------------------------------------

    def _build(self):
        from shadow_tpu_torch.sim import tb_params

        cfg, ecfg, dev = self.cfg, self.engine_cfg, self.device
        node_of = np.array([s.node_index for s in self.specs], np.int32)
        bw_up = np.array([s.bw_up_bits for s in self.specs], np.int64)
        bw_down = np.array([s.bw_down_bits for s in self.specs], np.int64)
        if isinstance(self.model, MixedModel):
            # built over the real lanes: the inner model's draws depend on H
            lane_hosts = [
                {
                    "host_id": s.host_id,
                    "name": s.name,
                    "plane": "native" if s.programs else "model",
                    "model_args": dict(s.model_args) if not s.programs else {},
                    "start_time": s.start_time,
                }
                for s in self.specs
            ]
        else:
            lane_hosts = [{"host_id": i} for i in range(self._num_real)]
        try:
            mparams, mstate, initial_events = self.model.build(lane_hosts, cfg.general.seed, dev)
        except (ValueError, KeyError) as e:
            raise ConfigError(f"model {self.model.name!r}: {e}") from e
        pad = ecfg.num_hosts - self._num_real
        mparams, mstate = _pad_tree(mparams, pad), _pad_tree(mstate, pad)
        params = EngineParams(
            node_of=torch.as_tensor(node_of, device=dev),
            lat_ns=torch.as_tensor(self.graph.lat_ns, device=dev),
            loss=torch.as_tensor(self.graph.loss, device=dev),
            jitter_ns=torch.as_tensor(self.graph.jitter_ns, device=dev),
            eg_tb=tb_params(bw_up, ecfg.tb_interval_ns, dev),
            in_tb=tb_params(bw_down, ecfg.tb_interval_ns, dev),
            model=mparams,
            faults=self._fault_sched.params,
        )
        self.state, self.params = self.engine.init_state(
            params, mstate, initial_events, seed=cfg.general.seed)
        self.engine_cfg = self.engine.cfg

        # the CPU plane: one CpuHost per program spec; modeled specs live on
        # the device only, but resolve by name and IP
        self.ip_to_gid: dict[str, int] = {}
        self.dns = Dns()
        for s in self.specs:
            self.dns.register(s.name, s.ip)
            self.ip_to_gid[s.ip] = s.host_id
        self.native_specs = [s for s in self.specs if s.programs]
        self._model_gids = {s.host_id for s in self.specs if not s.programs}
        self.hosts: list[CpuHost] = []
        self._host_by_gid: dict[int, CpuHost] = {}
        for s in self.native_specs:
            h = CpuHost(HostConfig(
                name=s.name, ip=s.ip, seed=cfg.general.seed, host_id=s.host_id,
                model_unblocked_latency=cfg.general.model_unblocked_syscall_latency,
                tcp=s.tcp_cfg, breadcrumbs=cfg.experimental.packet_breadcrumbs))
            h.egress = self._stage_send
            h.resolver = self.dns.resolve
            h.rev_resolver = self.dns.reverse
            self.hosts.append(h)
            self._host_by_gid[s.host_id] = h
        self.procs = []
        for s, h in zip(self.native_specs, self.hosts):
            for p in s.programs:
                proc = h.spawn(get_program(p["path"]), name=p["path"],
                               args=dict(p.get("args") or {}),
                               start_time=p.get("start_time", 0))
                proc.expected_final_state = p.get("expected_final_state", "running")
                if p.get("shutdown_time") is not None:
                    h.schedule(p["shutdown_time"], proc.kill)
                self.procs.append(proc)

        # observability of the CPU plane: pcap per interface, strace per
        # process, the sim-time-stamped log, the phase timers
        self.perf = PerfTimers()
        self._pcaps = []
        self._strace_files = []
        data_dir = cfg.general.data_directory
        self.log = None
        if cfg.general.log_file:
            path = cfg.general.log_file
            if not os.path.isabs(path):
                path = os.path.join(data_dir, path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.log = SimLogger(path, level=cfg.general.log_level)
            for h in self.hosts:
                h.on_process_exit = functools.partial(_log_process_exit, self.log, h)
        strace_mode = cfg.experimental.strace_logging_mode
        for s, h in zip(self.native_specs, self.hosts):
            host_dir = os.path.join(data_dir, "hosts", s.name)
            if s.pcap_enabled:
                os.makedirs(host_dir, exist_ok=True)
                h.pcap_lo = PcapWriter(os.path.join(host_dir, "lo.pcap"), s.pcap_capture_size)
                h.pcap_eth = PcapWriter(os.path.join(host_dir, "eth0.pcap"),
                                        s.pcap_capture_size)
                self._pcaps += [h.pcap_lo, h.pcap_eth]
            if strace_mode != "off":
                os.makedirs(host_dir, exist_ok=True)
                for p in h.processes.values():
                    f = open(os.path.join(host_dir, f"{p.name}.{p.pid}.strace"), "w")
                    self._strace_files.append(f)
                    p.strace = StraceLogger(f, strace_mode)

        # staging and the payload store; entries are (src, t, dst, size, key,
        # sock). Sends land in per-source buffers (each written by its own
        # host only, so a window's hosts can run in parallel) and are flushed
        # into `_staged` in host-id order, the serial order.
        self._staged: list[tuple[int, int, int, int, int, int]] = []
        self._stage_buf: list[list] = [[] for _ in self.specs]
        self._qdisc = cfg.experimental.interface_qdisc
        self._send_seq = np.zeros((ecfg.num_hosts,), np.int64)
        self._bytes: list[dict[int, tuple[int, NetPacket]]] = [{} for _ in self.specs]
        self._window_idx = 0
        self._unreach = [0] * len(self.specs)
        self._model_pkts_unrouted = 0  # model -> native with no UDP listener
        self._host_pool = None
        ex = cfg.experimental
        if ex.host_workers > 1 or ex.host_scheduler == "per-host":
            from shadow_tpu_torch.host import affinity
            from shadow_tpu_torch.host.scheduler import make_pool

            pin = affinity.assign(ex.host_workers) if ex.use_cpu_pinning else None
            self._host_pool = make_pool(ex.host_scheduler, ex.host_workers, pin)

    # ---- egress staging ----------------------------------------------------

    def _stage_send(self, host: CpuHost, pkt: NetPacket):
        gid = host.host_id
        dst_gid = self.ip_to_gid.get(pkt.dst_ip)
        if dst_gid is None:
            self._unreach[gid] += 1
            host.drop_packet(pkt, "inet_no_route")
            return
        key = int(self._send_seq[gid] % (1 << 31))
        self._send_seq[gid] += 1
        self._bytes[gid][key] = (self._window_idx, pkt)
        sock = (int(pkt.proto) << 16) | (int(pkt.src_port) & 0xFFFF)
        self._stage_buf[gid].append((gid, host.now(), dst_gid, pkt.size_bytes, key, sock))

    def _flush_stage_buf(self):
        """Move the per-source buffers into the staging list in host-id
        order (the deterministic merge point)."""
        for buf in self._stage_buf:
            if buf:
                self._staged.extend(buf)
                buf.clear()

    def _execute_hosts(self, until: int):
        if self._host_pool is not None:
            self._host_pool.run(self.hosts, lambda h: h.execute(until))
        else:
            for h in self.hosts:  # deterministic host order
                h.execute(until)
        self._flush_stage_buf()

    # ---- window loop -------------------------------------------------------

    def _cpu_min_next(self) -> int:
        return min((h.next_event_time() for h in self.hosts), default=TIME_MAX)

    def run(self, *, progress: bool | None = None, log=sys.stderr) -> dict:
        try:
            return self._run(progress=progress, log=log)
        finally:
            # flush the captures even when a window raises
            for w in self._pcaps:
                w.close()
            for f in self._strace_files:
                if not f.closed:
                    f.close()
            if self.log is not None:
                self.log.close()

    def _run(self, *, progress: bool | None = None, log=sys.stderr) -> dict:
        from shadow_tpu_torch.sim import KERNELS

        cfg = self.cfg
        stop = cfg.general.stop_time
        show_progress = cfg.general.progress if progress is None else progress
        hb_ns = cfg.general.heartbeat_interval
        launches0 = {k: v.launches for k, v in KERNELS.items()}
        syncs0 = self.engine.host_syncs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.monotonic()
        windows = self._window_loop(stop, show_progress, t0, hb_ns, hb_ns or 0, log)
        self._execute_hosts(stop)
        if self._host_pool is not None:
            self._host_pool.shutdown()
            self._host_pool = None
        # final states before reaping: a daemon alive at stop_time satisfies
        # expected_final_state: running although shutdown kills it
        for p in self.procs:
            p.state_at_stop = getattr(p.state, "value", p.state)
        for h in self.hosts:
            h.shutdown()
        if show_progress:
            print(file=log)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._wall_seconds = time.monotonic() - t0
        self._windows = windows
        self._host_syncs = self.engine.host_syncs - syncs0
        self._launches = {k: v.launches - launches0[k] for k, v in KERNELS.items()}
        return self.stats_report()

    def _window_loop(self, stop, show_progress, t0, hb_ns, next_hb, log):
        ecfg = self.engine_cfg
        runahead = max(ecfg.runahead_floor, ecfg.static_min_latency, 1)
        windows = 0
        while True:
            # the device plane's next event: the queue heads, no floors
            dev_min = int(q_next_time(self.state.queue).min())
            self.engine.host_syncs += 1
            t_next = min(self._cpu_min_next(), dev_min)
            if t_next >= stop:
                break
            window_end = min(t_next + runahead, stop)
            with self.perf.time("host_plane"):
                self._execute_hosts(window_end)
            # inject every staged send (several merges when staging
            # overflows its cap) before any device round runs, so that a
            # small cap costs merges and never shifts packet timing
            with self.perf.time("device_inject"):
                self._inject()
                while self._staged:
                    self._inject()
            until = min(self._cpu_min_next(), stop)
            with self.perf.time("device_rounds"):
                self.state = self.engine.run_guarded_chunk(
                    self.state, self.params, max(until, window_end), _capture_probe)
            with self.perf.time("drain_captures"):
                self._drain_captures()
            windows += 1
            if self.log is not None and hb_ns and window_end >= next_hb:
                self.log.info(window_end, "manager", f"heartbeat windows={windows}")
            if hb_ns and window_end >= next_hb:
                wall = time.monotonic() - t0
                print(
                    f"[heartbeat] sim_time={window_end / NS_PER_SEC:.3f}s "
                    f"wall={wall:.2f}s windows={windows} "
                    f"syncs={self.engine.host_syncs} "
                    f"ratio={window_end / NS_PER_SEC / max(wall, 1e-9):.2f}x",
                    file=log,
                )
                # per-host tracker interval (per-socket and per-interface deltas)
                for h in self.hosts:
                    h.record_heartbeat(window_end)
                next_hb = (window_end // hb_ns + 1) * hb_ns
            if show_progress:
                pct = min(100.0, 100.0 * window_end / max(stop, 1))
                print(f"\rprogress: {pct:5.1f}% ", end="", file=log, flush=True)
            if self._window_idx % 256 == 0:
                self._gc_bytes()
        return windows

    def _order_seq(self, gid: int) -> int:
        """A fresh per-host order counter for qdisc-reordered injections."""
        v = int(self._send_seq[gid] % (1 << 31))
        self._send_seq[gid] += 1
        return v

    def staged_rows(self, staged) -> tuple[np.ndarray, ...]:
        """The prepare step's rows (dst, t, order, kind, payload, valid) of
        up to STAGING_CAP staged sends: each a local KIND_SENDREQ event on
        its source host, its order key packed here (local bit, source, the
        per-source key, or under round-robin a fresh sequence); unused rows
        carry TIME_MAX and are invalid."""
        n = STAGING_CAP
        t = np.full((n,), TIME_MAX, np.int64)
        dstw = np.zeros((n,), np.int32)
        order = np.zeros((n,), np.int64)
        kind = np.zeros((n,), np.int32)
        payload = np.zeros((n, 4), np.int32)
        valid = np.zeros((n,), bool)
        for i, (gid, t_ns, dst_gid, size, key, _sock) in enumerate(staged):
            t[i] = t_ns
            dstw[i] = gid  # the send request is a local event on the source
            payload[i, PW_FLAGS] = BYTES_KEY_MAGIC
            seq = key if self._qdisc == "fifo" else self._order_seq(gid)
            order[i] = ((np.int64(1) << _LOCAL_SHIFT) | (np.int64(gid) << _SRC_SHIFT)
                        | (np.int64(seq) & SEQ_MASK))
            kind[i] = KIND_SENDREQ
            payload[i, PW_SIZE] = size
            payload[i, PW_DST_OR_SRC] = dst_gid
            payload[i, PW_KEY] = key
            valid[i] = True
        return dstw, t, order, kind, payload, valid

    def _inject(self):
        """Merge up to STAGING_CAP staged sends into the device queues."""
        cap = STAGING_CAP
        staged = self._staged[:cap]
        self._staged = self._staged[cap:]  # carried to the next merge
        if self._qdisc == "round-robin":
            staged = _rr_reorder(staged)
        rows = [torch.as_tensor(a, device=self.device) for a in self.staged_rows(staged)]
        self._window_idx += 1
        self.state = prepare_window(self.engine_cfg, self.state, *rows)

    def _drain_captures(self):
        # the counts first ([H] words): most windows deliver nothing
        # (a copy: on the CPU path .cpu() aliases the lane clear_caps zeroes)
        cap_n = self.state.model["cap_n"].cpu().numpy().copy()
        self.engine.host_syncs += 1
        if not cap_n.any():
            return
        m = self.state.model
        width = int(cap_n.max())
        rings = torch.stack([m[k][:, :width].to(torch.int64) for k in (
            "cap_t", "cap_src", "cap_key", "cap_size", "cap_flags")]).cpu().numpy()
        self.engine.host_syncs += 1
        cap_t, cap_src, cap_key, cap_size, cap_flags = rings
        # drained: nothing is delivered twice
        clear_caps(self.state)
        for gid in np.nonzero(cap_n > 0)[0]:
            host = self._host_by_gid.get(int(gid))
            if host is None:
                continue  # a modeled lane: no CPU plane
            for j in range(int(cap_n[gid])):
                t = int(cap_t[gid, j])
                src = int(cap_src[gid, j])
                key = int(cap_key[gid, j])
                if src in self._model_gids:
                    # a modeled source: no byte store. With the send-request
                    # magic the model echoed our payload (udp_echo): rebuild
                    # the endpoint-swapped reply from our own bytes; else
                    # synthesize a zero-filled datagram to the host's lowest
                    # bound UDP listener (40000 and counted when none)
                    echoed = int(cap_flags[gid, j]) == BYTES_KEY_MAGIC
                    own = self._bytes[gid].pop(key, None) if echoed else None
                    src_ip = self.specs[src].ip
                    if own is not None:
                        q = own[1]
                        pkt = NetPacket(src_ip=src_ip, src_port=q.dst_port, dst_ip=q.src_ip,
                                        dst_port=q.src_port, proto=q.proto, payload=q.payload)
                    else:
                        from shadow_tpu_torch.host.netns import EPHEMERAL_START

                        size = max(int(cap_size[gid, j]), 0)
                        udp_ports = sorted(
                            port for (proto, port), s in host.netns._ports.items()
                            if proto == 17 and port < EPHEMERAL_START
                            and getattr(s, "peer_ip", None) is None)
                        if udp_ports:
                            dst_port = udp_ports[0]
                        else:
                            dst_port = 40000
                            self._model_pkts_unrouted += 1
                        pkt = NetPacket(src_ip=src_ip, src_port=40000, dst_ip=host.ip,
                                        dst_port=dst_port, proto=17, payload=b"\0" * size)
                else:
                    entry = (self._bytes[src].pop(key, None)
                             if 0 <= src < len(self._bytes) else None)
                    if entry is None:
                        continue  # a duplicate capture (cannot happen) or swept
                    pkt = entry[1]
                host.schedule(t, functools.partial(host.deliver_packet, pkt))

    def _gc_bytes(self):
        horizon = self._window_idx - _BYTES_GC_WINDOWS
        if horizon <= 0:
            return
        for store in self._bytes:
            dead = [k for k, (w, _) in store.items() if w < horizon]
            for k in dead:  # lost on the device (loss, budget, CoDel)
                del store[k]

    # ---- outputs -----------------------------------------------------------

    def stats_report(self) -> dict:
        st = self.state
        s = {k: v.cpu().numpy() for k, v in st.stats._asdict().items() if v is not None}
        n = self._num_real
        wall = getattr(self, "_wall_seconds", None)
        sim_s = self.cfg.general.stop_time / NS_PER_SEC
        windows = getattr(self, "_windows", 0)

        def pstate(p):
            snap = getattr(p, "state_at_stop", None)
            return snap if snap is not None else getattr(p.state, "value", p.state)

        zombies = [p for p in self.procs if pstate(p) == "zombie"]
        failures = sum(
            1 for p in self.procs
            if (p.expected_final_state == "running" and pstate(p) == "zombie")
            or (isinstance(p.expected_final_state, dict)
                and p.expected_final_state.get("exited") is not None
                and p.exit_code != p.expected_final_state["exited"]))
        digest = int(np.bitwise_xor.reduce(s["digest"].view(np.uint64)[:n]))
        syncs = getattr(self, "_host_syncs", None)
        return {
            "simulated_seconds": sim_s,
            "wall_seconds": wall,
            "sim_wall_ratio": (sim_s / wall) if wall else None,
            "windows": windows,
            "device_rounds": int(s["rounds"]),
            "events_processed": int(s["events"][:n].sum())
            + sum(h.counters["events"] for h in self.hosts),
            "packets_sent": int(s["pkts_sent"][:n].sum()),
            "packets_delivered": int(s["pkts_delivered"][:n].sum()),
            "packets_lost": int(s["pkts_lost"][:n].sum()),
            "packets_budget_dropped": int(s["pkts_budget_dropped"][:n].sum()),
            "packets_codel_dropped": int(s["pkts_codel_dropped"][:n].sum()),
            "faults_dropped": (int(s["faults_dropped"][:n].sum()) if "faults_dropped" in s
                               else 0),
            "faults_delayed": (int(s["faults_delayed"][:n].sum()) if "faults_delayed" in s
                               else 0),
            "queue_overflow_dropped": int(st.queue.dropped[:n].sum()),
            "queue_occupancy_hwm": int(s["q_occ_hwm"][:n].max()) if n else 0,
            "outbox_send_hwm": int(s["outbox_hwm"].max()),
            "unreachable_ips": sum(self._unreach),
            "model_pkts_unrouted": self._model_pkts_unrouted,
            "syscalls": sum(h.counters["syscalls"] for h in self.hosts),
            "process_failures": failures,
            "processes_exited": len(zombies),
            "determinism_digest": f"{digest:016x}",
            "perf": self.perf.report(),
            "model_report": self.model.report(_host_view(st.model), None),
            "device": str(self.device),
            "host_syncs": syncs,
            "host_syncs_per_window": (syncs / windows) if syncs is not None and windows
            else None,
            "kernel_launches": getattr(self, "_launches", None),
        }

    def write_outputs(self, data_dir: str | None = None, report: dict | None = None) -> str:
        data_dir = data_dir or self.cfg.general.data_directory
        os.makedirs(data_dir, exist_ok=True)
        with open(os.path.join(data_dir, "processed-config.yaml"), "w") as f:
            yaml.safe_dump(self.cfg.to_dict(), f, sort_keys=False)
        with open(os.path.join(data_dir, "sim-stats.json"), "w") as f:
            json.dump(report or self.stats_report(), f, indent=2)
        with open(os.path.join(data_dir, "hosts.txt"), "w") as f:
            f.write(self.dns.hosts_file())
        for spec, host in zip(self.native_specs, self.hosts):
            hd = os.path.join(data_dir, "hosts", spec.name)
            os.makedirs(hd, exist_ok=True)
            for p in host.processes.values():
                base = os.path.join(hd, f"{p.name}.{p.pid}")
                with open(base + ".stdout", "wb") as f:
                    f.write(b"".join(p.stdout))
                with open(base + ".stderr", "wb") as f:
                    f.write(b"".join(p.stderr))
            with open(os.path.join(hd, "host-stats.json"), "w") as f:
                json.dump({
                    "name": spec.name,
                    "ip": spec.ip,
                    **host.counters,
                    "interfaces": host.if_counters,
                    "sockets": host.socket_stats(),
                    "heartbeats": host.heartbeats,
                    **({"packet_drops": host.packet_drops} if host.cfg.breadcrumbs else {}),
                }, f)
        return data_dir


def _capture_probe(model_state: dict) -> torch.Tensor:
    """The guarded loop's stop probe lane: a delivery waits in a ring."""
    return model_state["cap_n"]


def clear_caps(state) -> None:
    """Zero every capture ring's count, in place (a memset)."""
    state.model["cap_n"].zero_()


def prepare_window(cfg: EngineConfig, state, dst, t, order, kind, payload, valid):
    """The window's prepare step: zero cap_n, then merge the staged rows
    into the queues (K4 on CUDA, in place; a bucketed queue's block caches
    are rebuilt)."""
    clear_caps(state)
    q = merge_flat_events(as_flat(state.queue), dst, t, order, kind, payload, valid,
                          cfg.max_round_inserts)
    if isinstance(state.queue, BucketQueue):
        q = bucket_rebuild(q, state.queue.block)
    return state._replace(queue=q)


def _log_process_exit(log: SimLogger, host, proc):
    """A per-host process-lifecycle record in the log."""
    code = getattr(proc, "exit_code", None)
    sig = getattr(proc, "term_signal", None)
    how = f"signal {sig}" if sig else f"code {code}"
    log.info(host.now(), host.name,
             f"process {getattr(proc, 'name', '?')} (pid {proc.pid}) exited with {how}")


def _rr_reorder(staged):
    """Round-robin qdisc: within each source host, interleave this window's
    packets one per originating socket (sockets in first-seen order)
    instead of emit order. Depends only on the staged list."""
    by_host: dict[int, dict[int, list]] = {}
    host_order: list[int] = []
    for e in staged:
        gid, sock = e[0], e[5]
        if gid not in by_host:
            by_host[gid] = {}
            host_order.append(gid)
        by_host[gid].setdefault(sock, []).append(e)
    out = []
    for gid in host_order:
        socks = list(by_host[gid].values())
        while any(socks):
            for q in socks:
                if q:
                    out.append(q.pop(0))
    return out

