"""TCP segment representation.

A `Segment` is the sans-I/O wire unit: header fields the state machine cares
about plus an opaque payload. Ports are carried for the socket layer's demux
(the reference keeps ports in its `TcpHeader`, `src/lib/tcp/src/lib.rs`);
the state machine itself never inspects them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

FIN = 0x01
SYN = 0x02
RST = 0x04
PSH = 0x08
ACK = 0x10

_NAMES = [(SYN, "S"), (FIN, "F"), (RST, "R"), (PSH, "P"), (ACK, ".")]


def flags_str(flags: int) -> str:
    return "".join(n for bit, n in _NAMES if flags & bit) or "-"


@dataclass(frozen=True)
class Segment:
    flags: int
    seq: int  # sequence number of first payload byte (or of SYN/FIN)
    ack: int = 0  # acknowledgment number (valid iff flags & ACK)
    wnd: int = 0  # receive window advertised (pre-scaling units on SYN)
    payload: bytes = b""
    # options (present only on SYN segments, like the reference)
    mss: int | None = None
    wscale: int | None = None
    # SACK (RFC 2018; reference tcp.c:151-177 selectiveACKs): `sack_ok` is
    # the SYN-time capability option; `sack` carries up to 3 blocks of
    # received-out-of-order sequence ranges [start, end) on ACKs
    sack_ok: bool = False
    sack: tuple = ()
    # addressing for the socket layer (opaque to the state machine)
    src_port: int = 0
    dst_port: int = 0

    @property
    def seg_len(self) -> int:
        """Sequence space consumed: payload + SYN/FIN flags (RFC 793)."""
        n = len(self.payload)
        if self.flags & SYN:
            n += 1
        if self.flags & FIN:
            n += 1
        return n

    def __repr__(self) -> str:  # compact, strace-friendly
        p = f" len={len(self.payload)}" if self.payload else ""
        o = ""
        if self.mss is not None:
            o += f" mss={self.mss}"
        if self.wscale is not None:
            o += f" ws={self.wscale}"
        if self.sack:
            o += f" sack={list(self.sack)}"
        return (
            f"<{flags_str(self.flags)} seq={self.seq} ack={self.ack} "
            f"wnd={self.wnd}{p}{o}>"
        )
