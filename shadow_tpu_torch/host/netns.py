"""Per-host network namespace: interfaces, port association, packet demux.

Reference: `host/network/namespace.rs` (399 LoC — localhost + eth0 and the
AssociatedPorts registry) and the socket demux inside
`network_interface.c` (find socket by (proto, local port, peer)). Flows
(connected TCP 4-tuples) take precedence over wildcard port bindings
(listeners / unconnected UDP), like the reference's most-specific-match.
"""

from __future__ import annotations

from shadow_tpu_torch.host.sockets import (
    NetPacket,
    PROTO_TCP,
    TcpListenerSocket,
    UdpSocket,
)
from shadow_tpu_torch.tcp.state import rst_for

EPHEMERAL_START = 49152
EPHEMERAL_END = 65535


class NetworkNamespace:
    def __init__(self, host, ip: str):
        self.host = host
        self.default_ip = ip
        # (proto, local_port) -> socket  [listeners + UDP binds]
        self._ports: dict[tuple[int, int], object] = {}
        # (proto, local_port, peer_ip, peer_port) -> TcpSocket [flows]
        self._flows: dict[tuple[int, int, str, int], object] = {}
        self._next_ephemeral = EPHEMERAL_START
        # abstract unix-domain namespace (reference abstract_unix_ns.rs)
        self.abstract_unix: dict[str, object] = {}
        self._sock_serial = 0

    # ---- tracker support (tracker.c per-socket counters) -------------------

    def next_sock_id(self) -> int:
        self._sock_serial += 1
        return self._sock_serial

    def socket_for_local(self, proto: int, local_port: int,
                         remote_ip: str, remote_port: int):
        """Most-specific socket owning (proto, local_port) traffic with the
        given remote endpoint — flow first, then port binding (the demux
        rule, reused for counter attribution)."""
        if proto == PROTO_TCP:
            flow = self._flows.get(
                (PROTO_TCP, local_port, remote_ip, remote_port)
            )
            if flow is not None:
                return flow
        return self._ports.get((proto, local_port))

    def live_sockets(self):
        seen = set()
        for sock in list(self._ports.values()) + list(self._flows.values()):
            if id(sock) not in seen:
                seen.add(id(sock))
                yield sock

    # ---- binding -----------------------------------------------------------

    def bind(self, sock, ip: str, port: int):
        if port == 0:
            port = self._alloc_ephemeral(sock.PROTO)
        key = (sock.PROTO, port)
        if key in self._ports:
            raise OSError(f"EADDRINUSE: port {port}")
        self._ports[key] = sock
        sock.local_ip = ip if ip not in ("0.0.0.0", "") else self.default_ip
        sock.local_port = port

    def _alloc_ephemeral(self, proto: int) -> int:
        for _ in range(EPHEMERAL_END - EPHEMERAL_START + 1):
            p = self._next_ephemeral
            self._next_ephemeral += 1
            if self._next_ephemeral > EPHEMERAL_END:
                self._next_ephemeral = EPHEMERAL_START
            if (proto, p) not in self._ports:
                return p
        raise OSError("EADDRNOTAVAIL: ephemeral ports exhausted")

    def register_flow(self, sock):
        """Track a connected TCP socket by its 4-tuple."""
        key = (PROTO_TCP, sock.local_port, sock.peer_ip, sock.peer_port)
        self._flows[key] = sock

    def unbind(self, sock):
        if sock.local_port is not None:
            key = (sock.PROTO, sock.local_port)
            if self._ports.get(key) is sock:
                del self._ports[key]
        if getattr(sock, "peer_ip", None) is not None:
            fkey = (PROTO_TCP, sock.local_port, sock.peer_ip, sock.peer_port)
            if self._flows.get(fkey) is sock:
                del self._flows[fkey]
        # tracker: keep the totals of any socket that saw traffic (the
        # reference reports until-close activity, not just live sockets).
        # Here because every socket type funnels through unbind at
        # teardown, including TcpSocket whose close() bypasses the base.
        if not getattr(sock, "_stats_recorded", False) and any(
            sock.stat.values()
        ):
            sock._stats_recorded = True
            self.host.closed_socket_stats.append(sock.stat_record())

    # ---- demux -------------------------------------------------------------

    def deliver(self, pkt: NetPacket):
        """Incoming packet -> most specific matching socket."""
        if pkt.proto == PROTO_TCP:
            flow = self._flows.get(
                (PROTO_TCP, pkt.dst_port, pkt.src_ip, pkt.src_port)
            )
            if flow is not None:
                pkt.crumb(self.host.now(), "rcv_flow_delivered")
                flow.deliver(pkt)
                return
        sock = self._ports.get((pkt.proto, pkt.dst_port))
        if sock is not None:
            sock.deliver(pkt)
            return
        # no receiver: TCP answers RST (reference closed-port behavior),
        # UDP drops (ICMP unreachable is out of scope, as in the reference)
        self.host.drop_packet(pkt, "rcv_no_listener")
        if pkt.proto == PROTO_TCP and pkt.seg is not None:
            rst = rst_for(pkt.seg)
            if rst is not None:
                self.host.send_packet(
                    NetPacket(
                        src_ip=pkt.dst_ip,
                        src_port=pkt.dst_port,
                        dst_ip=pkt.src_ip,
                        dst_port=pkt.src_port,
                        proto=PROTO_TCP,
                        seg=rst,
                    )
                )

    # ---- stats -------------------------------------------------------------

    def socket_count(self) -> int:
        return len(self._ports) + len(self._flows)
