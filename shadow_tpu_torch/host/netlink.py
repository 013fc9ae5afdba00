"""Netlink route sockets (minimal NETLINK_ROUTE emulation).

Reference: `host/descriptor/socket/netlink.rs` (~1290 LoC). Real
applications open an AF_NETLINK socket at startup to enumerate interfaces
and addresses (glibc getifaddrs does RTM_GETLINK + RTM_GETADDR dumps; the
shim interposes getifaddrs for the common path, this socket covers binaries
that speak rtnetlink directly). Supported: bind, getsockname, RTM_GETLINK
and RTM_GETADDR dump requests answered with the canonical two interfaces
(lo + eth0 with the host's simulated address); everything else gets
NLMSG_ERROR(-EOPNOTSUPP) — loud, never silent.
"""

from __future__ import annotations

import socket as _socket
import struct

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState

AF_NETLINK = 16
NETLINK_ROUTE = 0

NLMSG_ERROR = 2
NLMSG_DONE = 3
NLM_F_MULTI = 2
NLM_F_REQUEST = 1
NLM_F_DUMP = 0x100 | 0x200  # ROOT|MATCH

RTM_NEWLINK = 16
RTM_GETLINK = 18
RTM_NEWADDR = 20
RTM_GETADDR = 22

IFLA_IFNAME = 3
IFA_ADDRESS = 1
IFA_LOCAL = 2
IFA_LABEL = 3

ARPHRD_LOOPBACK = 772
ARPHRD_ETHER = 1
IFF_UP = 1
IFF_LOOPBACK = 8
IFF_RUNNING = 0x40


def _align4(b: bytes) -> bytes:
    pad = (-len(b)) % 4
    return b + b"\0" * pad


def _nlmsg(mtype: int, flags: int, seq: int, pid: int, payload: bytes) -> bytes:
    hdr = struct.pack("<IHHII", 16 + len(payload), mtype, flags, seq, pid)
    return _align4(hdr + payload)


def _attr(atype: int, data: bytes) -> bytes:
    return _align4(struct.pack("<HH", 4 + len(data), atype) + data)


class NetlinkSocket(File):
    """One emulated rtnetlink socket: request in, queued datagrams out."""

    def __init__(self, host):
        super().__init__()
        self.host = host
        self.pid = 0  # netlink port id (bind or kernel-assigned)
        self._rcv: list[bytes] = []
        self._set_state(on=FileState.WRITABLE)

    # ---- interface inventory (mirrors the shim's getifaddrs pair) ---------

    def _links(self):
        return [
            (1, "lo", ARPHRD_LOOPBACK, IFF_UP | IFF_LOOPBACK | IFF_RUNNING,
             "127.0.0.1", 8),
            (2, "eth0", ARPHRD_ETHER, IFF_UP | IFF_RUNNING,
             self.host.cfg.ip, 24),
        ]

    # ---- request handling --------------------------------------------------

    def submit(self, data: bytes) -> int:
        """One sendto/sendmsg worth of netlink request(s)."""
        n = len(data)
        off = 0
        while off + 16 <= len(data):
            mlen, mtype, flags, seq, _pid = struct.unpack_from("<IHHII", data, off)
            if mlen < 16 or off + mlen > len(data):
                break
            self._handle_req(mtype, flags, seq)
            off += (mlen + 3) & ~3
        if self._rcv:
            self._set_state(on=FileState.READABLE)
        return n

    def _handle_req(self, mtype: int, flags: int, seq: int):
        out = b""
        if mtype == RTM_GETLINK and flags & NLM_F_DUMP:
            for idx, name, hwtype, ifflags, _ip, _plen in self._links():
                ifi = struct.pack("<BxHiII", 0, hwtype, idx, ifflags, 0)
                out += _nlmsg(RTM_NEWLINK, NLM_F_MULTI, seq, self.pid,
                              ifi + _attr(IFLA_IFNAME, name.encode() + b"\0"))
            out += _nlmsg(NLMSG_DONE, NLM_F_MULTI, seq, self.pid,
                          struct.pack("<i", 0))
        elif mtype == RTM_GETADDR and flags & NLM_F_DUMP:
            for idx, name, _hw, _fl, ip, plen in self._links():
                ifa = struct.pack("<BBBBi", _socket.AF_INET, plen, 0, 0, idx)
                addr = _socket.inet_aton(ip)
                out += _nlmsg(
                    RTM_NEWADDR, NLM_F_MULTI, seq, self.pid,
                    ifa + _attr(IFA_ADDRESS, addr) + _attr(IFA_LOCAL, addr)
                    + _attr(IFA_LABEL, name.encode() + b"\0"),
                )
            out += _nlmsg(NLMSG_DONE, NLM_F_MULTI, seq, self.pid,
                          struct.pack("<i", 0))
        else:
            # loud refusal: NLMSG_ERROR carrying -EOPNOTSUPP + echoed header
            err = struct.pack("<i", -95) + struct.pack(
                "<IHHII", 16, mtype, flags, seq, self.pid
            )
            out = _nlmsg(NLMSG_ERROR, 0, seq, self.pid, err)
        self._rcv.append(out)

    # ---- read side ---------------------------------------------------------

    def read(self, n: int) -> bytes | None:
        """One queued response datagram (netlink reads are message-wise;
        a short buffer truncates, like the kernel with MSG_TRUNC unset)."""
        if not self._rcv:
            return None
        data = self._rcv.pop(0)
        if not self._rcv:
            self._set_state(off=FileState.READABLE)
        return data[:n]

    def peek(self, n: int) -> bytes | None:
        if not self._rcv:
            return None
        return self._rcv[0][:n]

    def write(self, data: bytes) -> int:
        return self.submit(bytes(data))

    def close(self):
        self._rcv.clear()
        super().close()
