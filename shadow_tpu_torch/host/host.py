"""CpuHost: the emulated machine and its event loop.

Reference: `host/host.rs` (1452 LoC) — per-host event queue, deterministic
per-host RNG, boot/shutdown, `execute(until)` popping events in
deterministic order, and packet ingress/egress hooks. This host runs
coroutine processes (`shadow_tpu_torch.host.process`) instead of co-opted Linux
binaries; the C++ managed-process plane (`native/`) plugs real binaries
into the same structure.

Egress: `send_packet` hands loopback traffic straight back to this host
(scheduled, never re-entrant) and everything else to `self.egress`, wired
by the CPU wire (`host.network.CpuNetwork`) or the device bridge
(`shadow_tpu_torch.cosim`).
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable

from shadow_tpu_torch.host.filestate import CallbackQueue
from shadow_tpu_torch.host.netns import NetworkNamespace
from shadow_tpu_torch.host.process import Process, SyscallHandler
from shadow_tpu_torch.host.sockets import NetPacket

TIME_MAX = (1 << 63) - 1


@dataclass
class HostConfig:
    name: str
    ip: str
    seed: int = 0
    host_id: int = 0
    loopback_latency_ns: int = 0  # loopback relays same-round in reference
    # unblocked-syscall CPU-latency model (reference handler/mod.rs:268-318 +
    # `model_unblocked_syscall_latency`): after `unblocked_syscall_limit`
    # consecutive non-blocking syscalls a process is charged
    # `unblocked_syscall_latency_ns` of simulated time, so busy-loops that
    # poll without blocking cannot freeze the simulated clock
    model_unblocked_latency: bool = False
    unblocked_syscall_limit: int = 1024
    unblocked_syscall_latency_ns: int = 1_000
    # per-host TCP socket defaults (reference HostDefaultOptions socket
    # buffer/autotune knobs); None = TcpConfig() defaults
    tcp: Any = None
    # packet delivery-status breadcrumbs (reference packet.rs:16-39),
    # debug-only: every wire hop stamps the packet; drops are collected
    # with their full trail in `packet_drops`
    breadcrumbs: bool = False


class CpuHost:
    def __init__(self, cfg: HostConfig):
        self.cfg = cfg
        self.name = cfg.name
        self.ip = cfg.ip
        self.host_id = cfg.host_id
        self._now = 0
        self._seq = 0  # deterministic tiebreak (host.rs event ids)
        self._q: list[tuple[int, int, Callable]] = []
        self._cancelled: set[int] = set()
        self.rng = random.Random((cfg.seed << 16) ^ cfg.host_id)
        self.netns = NetworkNamespace(self, cfg.ip)
        self.syscalls = SyscallHandler(self)
        self.processes: dict[int, Process] = {}
        self._next_pid = 1000
        # wired by the network layer: fn(host, NetPacket)
        self.egress: Callable[["CpuHost", NetPacket], None] | None = None
        # pcap capture per interface (reference lo.pcap/eth0.pcap,
        # pcap_writer.rs + network_interface.c); set by the sim driver
        self.pcap_lo = None
        self.pcap_eth = None
        # name -> ip resolution (DNS); wired by the simulation driver
        self.resolver: Callable[[str], str] | None = None
        # ip -> name reverse resolution (gethostbyaddr/getnameinfo)
        self.rev_resolver: Callable[[str], str | None] | None = None
        # counters (tracker.c analogue)
        self.counters = {
            "events": 0,
            "pkts_sent": 0,
            "pkts_recv": 0,
            "bytes_sent": 0,
            "bytes_recv": 0,
            "syscalls": 0,
            # of which answered inside the shim from the descriptor fast
            # table (native_plane._fast_drain folds them back in)
            "syscalls_fast": 0,
        }
        # per-interface + per-socket byte/packet counters
        # (tracker.c:24-80 — the reference tracker reports both per
        # heartbeat interval; sockets are attributed by (proto, port)
        # lookup at send/deliver time, closed sockets keep their totals)
        self.if_counters = {
            name: {"tx_pkts": 0, "tx_bytes": 0, "rx_pkts": 0, "rx_bytes": 0}
            for name in ("lo", "eth0")
        }
        self.closed_socket_stats: list[dict] = []
        self.heartbeats: list[dict] = []
        # breadcrumb drop log (bounded; debug flag HostConfig.breadcrumbs)
        self.packet_drops: list[dict] = []
        self._hb_prev: dict | None = None
        self._hb_closed_seen: set[int] = set()

    # ---- tracker heartbeats (tracker.c:24-80) ------------------------------

    def socket_stats(self) -> list[dict]:
        """Per-socket cumulative tx/rx counters, live + closed."""
        out = list(self.closed_socket_stats)
        for sock in self.netns.live_sockets():
            out.append(sock.stat_record())
        return out

    def record_heartbeat(self, t_ns: int) -> dict:
        """Snapshot per-interface and per-socket counters as DELTAS since
        the previous heartbeat (the reference tracker logs per-interval
        numbers, not cumulative ones). A closed socket appears in exactly
        ONE interval record (its final delta) and is then excluded from
        the baseline — otherwise long many-connection runs would re-scan
        every socket ever closed on each heartbeat."""
        live = {
            s["id"]: s
            for s in (sk.stat_record() for sk in self.netns.live_sockets())
        }
        closed_new = {
            s["id"]: s
            for s in self.closed_socket_stats
            if s["id"] not in self._hb_closed_seen
        }
        cur = {
            "interfaces": {k: dict(v) for k, v in self.if_counters.items()},
            "sockets": {**closed_new, **live},
        }
        prev = self._hb_prev or {"interfaces": {}, "sockets": {}}

        def delta(now_d, prev_d):
            return {
                k: now_d[k] - prev_d.get(k, 0)
                for k in ("tx_pkts", "tx_bytes", "rx_pkts", "rx_bytes")
            }

        rec = {
            "t_ns": t_ns,
            "interfaces": {
                k: delta(v, prev["interfaces"].get(k, {}))
                for k, v in cur["interfaces"].items()
            },
            "sockets": [
                {**{f: s[f] for f in ("id", "proto", "local", "peer")},
                 **delta(s, prev["sockets"].get(s["id"], {}))}
                for s in cur["sockets"].values()
            ],
        }
        # drop all-zero socket rows: long-lived idle sockets would bloat
        # every interval record
        rec["sockets"] = [
            s for s in rec["sockets"]
            if s["tx_pkts"] or s["rx_pkts"] or s["tx_bytes"] or s["rx_bytes"]
        ]
        self._hb_closed_seen.update(closed_new)
        # baseline keeps only LIVE sockets: closed ones were just reported
        # for the last time and can never change again
        self._hb_prev = {"interfaces": cur["interfaces"], "sockets": live}
        self.heartbeats.append(rec)
        return rec

    # ---- clock & scheduling (TimerFd Scheduler protocol) -------------------

    def now(self) -> int:
        return self._now

    def schedule(self, t_ns: int, fn: Callable) -> object:
        if t_ns < self._now:
            t_ns = self._now
        self._seq += 1
        token = (t_ns, self._seq)
        heapq.heappush(self._q, (t_ns, self._seq, fn))
        return token

    def cancel(self, token: object):
        self._cancelled.add(token[1])

    def next_event_time(self) -> int:
        while self._q and self._q[0][1] in self._cancelled:
            self._cancelled.discard(self._q[0][1])
            heapq.heappop(self._q)
        return self._q[0][0] if self._q else TIME_MAX

    # ---- processes ---------------------------------------------------------

    def spawn(self, program, name: str | None = None, args: dict | None = None,
              start_time: int = 0) -> Process:
        self._next_pid += 1
        proc = Process(self, self._next_pid, name or program.__name__, program, args)
        self.processes[proc.pid] = proc
        self.schedule(max(start_time, self._now), proc.resume)
        return proc

    def on_process_exit(self, proc: Process):
        pass  # hook for the simulation driver (expected_final_state checks)

    def resolve(self, name: str) -> str:
        if self.resolver is None:
            raise OSError(f"EAI_NONAME: no resolver for {name!r}")
        return self.resolver(name)

    def rev_resolve(self, ip: str) -> str | None:
        """IPv4 -> simulated hostname (reverse DNS); the host always knows
        itself and loopback even without a wired registry."""
        if self.rev_resolver is not None:
            name = self.rev_resolver(ip)
            if name is not None:
                return name
        if ip == self.ip:
            return self.name
        if ip == "127.0.0.1":
            return "localhost"
        return None

    def next_iss(self) -> int:
        return self.rng.getrandbits(32)

    # ---- packets -----------------------------------------------------------

    def drop_packet(self, pkt: NetPacket, status: str):
        """Terminal breadcrumb: record WHERE the packet died (bounded so a
        pathological workload cannot eat the heap)."""
        pkt.crumb(self._now, status)
        if pkt.trail is not None and len(self.packet_drops) < 10_000:
            self.packet_drops.append(
                {
                    "t_ns": self._now,
                    "src": f"{pkt.src_ip}:{pkt.src_port}",
                    "dst": f"{pkt.dst_ip}:{pkt.dst_port}",
                    "proto": pkt.proto,
                    "dropped_at": status,
                    "trail": list(pkt.trail),
                }
            )

    def send_packet(self, pkt: NetPacket):
        if self.cfg.breadcrumbs and pkt.trail is None:
            pkt.trail = []
        self.counters["pkts_sent"] += 1
        self.counters["bytes_sent"] += pkt.size_bytes
        iface = "lo" if pkt.dst_ip in ("127.0.0.1", self.ip) else "eth0"
        ifc = self.if_counters[iface]
        ifc["tx_pkts"] += 1
        ifc["tx_bytes"] += pkt.size_bytes
        sock = self.netns.socket_for_local(pkt.proto, pkt.src_port,
                                           pkt.dst_ip, pkt.dst_port)
        if sock is not None:
            sock.stat["tx_pkts"] += 1
            sock.stat["tx_bytes"] += pkt.size_bytes
        if pkt.trail is not None:  # guard: no f-string on the hot path
            pkt.crumb(self._now, f"snd_{self.name}_{iface}")
        if pkt.dst_ip in ("127.0.0.1", self.ip):
            if self.pcap_lo is not None:
                self.pcap_lo.write(self._now, pkt)
            self.schedule(
                self._now + self.cfg.loopback_latency_ns,
                lambda: self.deliver_packet(pkt, iface="lo"),
            )
            return
        if self.pcap_eth is not None:
            self.pcap_eth.write(self._now, pkt)
        if self.egress is None:
            raise RuntimeError(f"host {self.name}: no egress wired for {pkt}")
        self.egress(self, pkt)

    def deliver_packet(self, pkt: NetPacket, iface: str = "eth"):
        """`iface` is set by the delivery path (loopback tags itself "lo"),
        not re-derived from headers — a socket bound to 127.0.0.1 must never
        show up on the eth0 capture."""
        self.counters["pkts_recv"] += 1
        self.counters["bytes_recv"] += pkt.size_bytes
        if pkt.trail is not None:  # guard: no f-string on the hot path
            pkt.crumb(self._now, f"rcv_{self.name}_{iface}")
        ifc = self.if_counters["lo" if iface == "lo" else "eth0"]
        ifc["rx_pkts"] += 1
        ifc["rx_bytes"] += pkt.size_bytes
        sock = self.netns.socket_for_local(pkt.proto, pkt.dst_port,
                                           pkt.src_ip, pkt.src_port)
        if sock is not None:
            sock.stat["rx_pkts"] += 1
            sock.stat["rx_bytes"] += pkt.size_bytes
        if iface == "eth" and self.pcap_eth is not None:
            self.pcap_eth.write(self._now, pkt)
        CallbackQueue.run(lambda q: self.netns.deliver(pkt))

    # ---- the event loop ----------------------------------------------------

    def execute(self, until_ns: int):
        """Run all events with t < until_ns (Host::execute, host.rs:809)."""
        while True:
            t = self.next_event_time()
            if t >= until_ns:
                break
            _, seq, fn = heapq.heappop(self._q)
            if seq in self._cancelled:
                self._cancelled.discard(seq)
                continue
            self._now = t
            self.counters["events"] += 1
            fn()
        self._now = max(self._now, min(until_ns, TIME_MAX))

    def shutdown(self):
        for proc in list(self.processes.values()):
            proc.kill()
