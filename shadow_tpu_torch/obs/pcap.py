"""pcap capture with synthesized Ethernet/IPv4/UDP/TCP frames.

Reference: `src/main/utility/pcap_writer.rs:6-90` — classic pcap v2.4
global header + per-packet records, timestamps in *simulated* time, a
configurable snap length (`pcap_capture_size`), wired into the network
interface (network_interface.c) per host as `lo.pcap` / `eth0.pcap`.
The reference emits IP frames reconstructed from its packet headers; here
frames are synthesized from `NetPacket` (+ TCP `Segment` when present) —
enough for wireshark/tcpdump and for the determinism byte-compare gate
(determinism1_compare.cmake diffs these files).
"""

from __future__ import annotations

import socket
import struct

from shadow_tpu_torch.host.sockets import NetPacket, PROTO_TCP, PROTO_UDP
from shadow_tpu_torch.simtime import sim_to_emulated_ns

PCAP_MAGIC = 0xA1B2C3D4
LINKTYPE_ETHERNET = 1


def _ip(addr: str) -> bytes:
    try:
        return socket.inet_aton(addr)
    except OSError:
        return b"\x00\x00\x00\x00"


def _checksum(data: bytes) -> int:
    if len(data) % 2:
        data += b"\x00"
    s = sum(struct.unpack(f"!{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def packet_bytes(pkt: NetPacket) -> bytes:
    """Synthesize an Ethernet+IPv4+{UDP,TCP} frame for `pkt`.

    Payloads are truncated to what IPv4 length fields can carry — the
    capture path must never be able to abort a simulation."""
    payload = pkt.payload[:65495]
    if pkt.proto == PROTO_UDP:
        transport = struct.pack(
            "!HHHH", pkt.src_port, pkt.dst_port, 8 + len(payload), 0
        ) + payload
    else:
        seg = pkt.seg
        flags = seg.flags if seg is not None else 0
        seq = seg.seq if seg is not None else 0
        ack = seg.ack if seg is not None else 0
        wnd = seg.wnd if seg is not None else 0
        offset_flags = (5 << 12) | (flags & 0x3F)
        transport = struct.pack(
            "!HHIIHHHH",
            pkt.src_port,
            pkt.dst_port,
            seq & 0xFFFFFFFF,
            ack & 0xFFFFFFFF,
            offset_flags,
            min(wnd, 0xFFFF),
            0,
            0,
        ) + payload
    total = 20 + len(transport)
    ip_hdr = struct.pack(
        "!BBHHHBBH4s4s",
        0x45,
        0,
        total,
        0,
        0,
        64,
        pkt.proto,
        0,
        _ip(pkt.src_ip),
        _ip(pkt.dst_ip),
    )
    ip_hdr = ip_hdr[:10] + struct.pack("!H", _checksum(ip_hdr)) + ip_hdr[12:]
    eth = b"\x02" + b"\x00" * 5 + b"\x02" + b"\x00" * 5 + b"\x08\x00"
    return eth + ip_hdr + transport


class PcapWriter:
    """One capture file (per host interface, like the reference's)."""

    def __init__(self, path: str, snaplen: int = 65535):
        self.snaplen = snaplen
        self._f = open(path, "wb")
        self._f.write(
            struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, snaplen,
                        LINKTYPE_ETHERNET)
        )
        self.count = 0

    def write(self, t_ns: int, pkt: NetPacket):
        """`t_ns` is simulation time; stamps are EmulatedTime (epoch
        2000-01-01, emulated_time.rs:28-48) so captures read like the
        reference's."""
        full = packet_bytes(pkt)
        frame = full[: self.snaplen]
        emu = sim_to_emulated_ns(t_ns)
        self._f.write(
            struct.pack(
                "<IIII",
                emu // 1_000_000_000,
                (emu % 1_000_000_000) // 1000,
                len(frame),
                len(full),  # orig_len: untruncated size (pcap spec)
            )
        )
        self._f.write(frame)
        self.count += 1

    def close(self):
        if not self._f.closed:
            self._f.close()
