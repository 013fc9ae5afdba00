"""Socket files: UDP datagrams and TCP streams over `shadow_tpu_torch.tcp`.

Reference: `host/descriptor/socket/inet/` — `udp.rs` (1157 LoC),
`tcp.rs` (the adapter binding the sans-I/O TCP crate to socket/file
semantics, 1135 LoC) and the listener/accept-queue handling inside it.
A socket talks to the world through its `NetworkNamespace` (port demux)
and the host's packet egress (`CpuHost.send_packet`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState
from shadow_tpu_torch.tcp import Segment, State, TcpConfig, TcpState
from shadow_tpu_torch.tcp.state import rst_for

PROTO_UDP = 17
PROTO_TCP = 6

UDP_RCVBUF_PACKETS = 256
UDP_MAX_PAYLOAD = 65507  # IPv4 datagram limit (65535 - 20 IP - 8 UDP)


@dataclass
class NetPacket:
    """A packet on the simulated wire (CPU plane). For TCP, `seg` carries
    the full segment; `payload` mirrors seg.payload for size accounting."""

    src_ip: str
    src_port: int
    dst_ip: str
    dst_port: int
    proto: int
    payload: bytes = b""
    seg: Segment | None = None
    # delivery-status breadcrumbs (reference packet.rs:16-39): when the
    # owning host enables them (HostConfig.breadcrumbs), every hop appends
    # (sim_time_ns, status) so a dropped packet's DROP SITE is readable
    # from host.packet_drops — digests say THAT histories diverged,
    # breadcrumbs say WHERE a packet died. None = disabled (zero cost).
    trail: list | None = None

    def crumb(self, t_ns: int, status: str):
        if self.trail is not None:
            self.trail.append((t_ns, status))

    @property
    def size_bytes(self) -> int:
        # IP+transport header burden like the reference's packet sizing
        return len(self.payload) + (28 if self.proto == PROTO_UDP else 40)


class _SocketBase(File):
    def __init__(self, netns):
        super().__init__()
        self.netns = netns
        self.local_ip: str | None = None
        self.local_port: int | None = None
        self.peer_ip: str | None = None
        self.peer_port: int | None = None
        # per-socket wire counters (reference tracker.c:24-80); attributed
        # centrally in CpuHost.send_packet/deliver_packet by port lookup
        self.sock_id = netns.next_sock_id()
        self.stat = {"tx_pkts": 0, "tx_bytes": 0, "rx_pkts": 0, "rx_bytes": 0}

    @property
    def host(self):
        return self.netns.host

    def stat_record(self) -> dict:
        peer = (
            f"{self.peer_ip}:{self.peer_port}"
            if self.peer_port is not None
            else None
        )
        return {
            "id": self.sock_id,
            "proto": "tcp" if self.PROTO == PROTO_TCP else "udp",
            "local": f"{self.local_ip or '*'}:{self.local_port or 0}",
            "peer": peer,
            **self.stat,
        }

    def bind(self, ip: str, port: int):
        if self.local_port is not None:
            raise OSError("EINVAL: already bound")
        self.netns.bind(self, ip, port)

    def _autobind(self):
        if self.local_port is None:
            self.netns.bind(self, self.netns.default_ip, 0)

    def close(self):
        if self.closed:
            return
        # final stat capture happens in netns.unbind — the teardown point
        # ALL socket types funnel through (TcpSocket.close does not call
        # super(); its flow unbinds from _after_tcp when fully closed)
        self.netns.unbind(self)
        super().close()


class UdpSocket(_SocketBase):
    PROTO = PROTO_UDP

    def __init__(self, netns):
        super().__init__(netns)
        self._rcv: list[tuple[str, int, bytes]] = []  # (src_ip, src_port, data)
        self._set_state(on=FileState.WRITABLE)

    def connect(self, ip: str, port: int):
        self._autobind()
        self.peer_ip = ip
        self.peer_port = port

    def sendto(self, data: bytes, addr: tuple[str, int] | None = None) -> int:
        if len(data) > UDP_MAX_PAYLOAD:
            raise OSError(f"EMSGSIZE: datagram of {len(data)} bytes")
        if addr is None:
            if self.peer_ip is None:
                raise OSError("EDESTADDRREQ")
            addr = (self.peer_ip, self.peer_port)
        self._autobind()
        self.host.send_packet(
            NetPacket(
                src_ip=self.local_ip,
                src_port=self.local_port,
                dst_ip=addr[0],
                dst_port=addr[1],
                proto=PROTO_UDP,
                payload=bytes(data),
            )
        )
        return len(data)

    def recvfrom(self, n: int) -> tuple[bytes, tuple[str, int]] | None:
        if not self._rcv:
            return None  # would block
        src_ip, src_port, data = self._rcv.pop(0)
        if not self._rcv:
            self._set_state(off=FileState.READABLE)
        return data[:n], (src_ip, src_port)

    def peekfrom(self, n: int) -> tuple[bytes, tuple[str, int]] | None:
        """MSG_PEEK: next datagram without popping it."""
        if not self._rcv:
            return None
        src_ip, src_port, data = self._rcv[0]
        return data[:n], (src_ip, src_port)

    def read(self, n: int) -> bytes | None:
        r = self.recvfrom(n)
        return None if r is None else r[0]

    def write(self, data: bytes) -> int | None:
        return self.sendto(data)

    # netns delivery
    def deliver(self, pkt: NetPacket):
        if self.peer_ip is not None and (
            pkt.src_ip != self.peer_ip or pkt.src_port != self.peer_port
        ):
            # connected socket filters other peers
            self.host.drop_packet(pkt, "rcv_udp_peer_filtered")
            return
        if len(self._rcv) >= UDP_RCVBUF_PACKETS:
            # rcvbuf overflow: silently dropped (on the wire), like real
            # UDP — but the breadcrumb trail names this exact site
            self.host.drop_packet(pkt, "rcv_udp_buffer_full")
            return
        pkt.crumb(self.host.now(), "rcv_socket_delivered")
        self._rcv.append((pkt.src_ip, pkt.src_port, pkt.payload))
        self._set_state(on=FileState.READABLE)


class TcpSocket(_SocketBase):
    """A connection-mode TCP socket wrapping one `TcpState`."""

    PROTO = PROTO_TCP

    def __init__(self, netns, tcp: TcpState | None = None, cfg: TcpConfig | None = None):
        super().__init__(netns)
        self.cfg = cfg or getattr(netns.host.cfg, "tcp", None) or TcpConfig()
        self.tcp = tcp or TcpState(self.cfg, iss=netns.host.next_iss())
        self._timer_token = None
        self._sync()

    # ---- app surface -------------------------------------------------------

    def connect(self, ip: str, port: int):
        self._autobind()
        self.peer_ip = ip
        self.peer_port = port
        self.netns.register_flow(self)
        self.tcp.connect(self.host.now())
        self._after_tcp()

    def write(self, data: bytes) -> int | None:
        if self.tcp.error is not None:
            raise ConnectionResetError(self.tcp.error.value)
        n = self.tcp.send(bytes(data))
        self._after_tcp()
        if n == 0:
            return None  # send buffer full: would block
        return n

    def read(self, n: int) -> bytes | None:
        out = self.tcp.recv(n)
        self._after_tcp()
        return out

    def peek(self, n: int) -> bytes | None:
        """MSG_PEEK: read() contract (None=block, b''=EOF) w/o consuming.
        Real clients (wget's persistent-connection probe) peek response
        headers before reading them."""
        buf = self.tcp.rcv_buf
        if buf.readable():
            return bytes(buf._ready[:n])
        if self.tcp.rcv_fin_seen or self.tcp.error is not None:
            return b""
        from shadow_tpu_torch.tcp import State as TS

        if self.tcp.state in (TS.CLOSED, TS.LISTEN):
            return b""
        return None

    def shutdown_write(self):
        self.tcp.shutdown_write(self.host.now())
        self._after_tcp()

    def close(self):
        """App close. The flow stays registered in the netns until TCP
        reaches CLOSED so in-flight FIN/ACK/TIME_WAIT traffic still demuxes
        here (the reference keeps its socket alive the same way)."""
        if self.closed:
            return
        if not self.tcp.is_closed():
            self.tcp.close(self.host.now())
        self._set_state(on=FileState.CLOSED, off=FileState.ACTIVE)
        self._after_tcp()

    # ---- wire surface ------------------------------------------------------

    def deliver(self, pkt: NetPacket):
        if pkt.seg is None:
            return
        self.tcp.on_segment(self.host.now(), pkt.seg)
        self._after_tcp()

    _listener: "TcpListenerSocket | None" = None  # set for accept()ed children

    def _after_tcp(self):
        """Flush segments, re-arm the TCP timer, refresh state bits."""
        now = self.host.now()
        for seg in self.tcp.poll_segments(now):
            self._emit(seg)
        self._rearm_timer()
        self._sync()
        if self._listener is not None and self.tcp.state == State.ESTABLISHED:
            lst, self._listener = self._listener, None
            lst._reap(self)
        if self.tcp.state == State.CLOSED and self.closed:
            self._rearm_timer()  # clears any residual token
            self.netns.unbind(self)

    def _emit(self, seg: Segment):
        seg = dataclasses.replace(
            seg,
            src_port=self.local_port or 0,
            dst_port=self.peer_port or 0,
        )
        self.host.send_packet(
            NetPacket(
                src_ip=self.local_ip or self.netns.default_ip,
                src_port=self.local_port or 0,
                dst_ip=self.peer_ip,
                dst_port=self.peer_port,
                proto=PROTO_TCP,
                payload=seg.payload,
                seg=seg,
            )
        )

    def _rearm_timer(self):
        if self._timer_token is not None:
            self.host.cancel(self._timer_token)
            self._timer_token = None
        t = self.tcp.next_timer()
        if t is not None:
            self._timer_token = self.host.schedule(t, self._on_timer)

    def _on_timer(self):
        self._timer_token = None
        self.tcp.on_timer(self.host.now())
        self._after_tcp()

    def _sync(self):
        on = FileState.NONE
        off = FileState.NONE
        if self.tcp.readable():
            on |= FileState.READABLE
        else:
            off |= FileState.READABLE
        if self.tcp.writable():
            on |= FileState.WRITABLE
        else:
            off |= FileState.WRITABLE
        if self.tcp.error is not None:
            on |= FileState.ERROR
        if self.tcp.rcv_fin_seen:
            on |= FileState.HUP
        self._set_state(on=on, off=off)


class TcpListenerSocket(_SocketBase):
    """listen(2) socket: forks a child TcpSocket per SYN, queues established
    children for accept (reference tcp.rs accept-queue handling)."""

    PROTO = PROTO_TCP

    def __init__(self, netns, cfg: TcpConfig | None = None, backlog: int = 128):
        super().__init__(netns)
        self.cfg = cfg or getattr(netns.host.cfg, "tcp", None) or TcpConfig()
        self.backlog = backlog
        self.tcp = TcpState(self.cfg, iss=0)
        self.tcp.listen()
        self._pending: list[TcpSocket] = []  # handshaking children
        self._accept_q: list[TcpSocket] = []  # ESTABLISHED, ready to accept

    def accept(self) -> TcpSocket | None:
        if not self._accept_q:
            return None  # would block
        child = self._accept_q.pop(0)
        if not self._accept_q:
            self._set_state(off=FileState.ACCEPTABLE | FileState.READABLE)
        return child

    def deliver(self, pkt: NetPacket):
        if pkt.seg is None:
            return
        now = self.host.now()
        if len(self._pending) + len(self._accept_q) >= self.backlog:
            # backlog full: drop SYN (peer retries), like Linux
            self.host.drop_packet(pkt, "rcv_tcp_backlog_full")
            return
        child_tcp = self.tcp.accept_segment(
            now, pkt.seg, child_iss=self.host.next_iss()
        )
        if child_tcp is None:
            rst = rst_for(pkt.seg)
            if rst is not None:
                self.host.send_packet(
                    NetPacket(
                        src_ip=self.local_ip,
                        src_port=self.local_port,
                        dst_ip=pkt.src_ip,
                        dst_port=pkt.src_port,
                        proto=PROTO_TCP,
                        seg=rst,
                    )
                )
            return
        child = TcpSocket(self.netns, tcp=child_tcp, cfg=self.cfg)
        child.local_ip = self.local_ip
        child.local_port = self.local_port
        child.peer_ip = pkt.src_ip
        child.peer_port = pkt.src_port
        child._listener = self
        self.netns.register_flow(child)
        self._pending.append(child)
        child._after_tcp()  # emits the SYN-ACK

    def _reap(self, child: TcpSocket):
        """Move children that completed the handshake to the accept queue."""
        if child in self._pending and child.tcp.state == State.ESTABLISHED:
            self._pending.remove(child)
            self._accept_q.append(child)
            self._set_state(on=FileState.ACCEPTABLE | FileState.READABLE)

    def poll_children(self):
        for child in list(self._pending):
            self._reap(child)

    def close(self):
        if self.closed:
            return
        for child in self._pending + self._accept_q:
            child.tcp.abort(self.host.now())
            child._after_tcp()
        self._pending.clear()
        self._accept_q.clear()
        super().close()
