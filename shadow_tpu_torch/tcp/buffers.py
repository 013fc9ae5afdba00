"""Send / receive buffers for the TCP state machine.

Reference: `src/lib/tcp/src/buffer.rs` (send queue with retransmit tracking,
receive reassembly). Design differences: the send buffer is a flat byte
deque indexed by absolute (unwrapped) stream offset — retransmission slices
it by range, so no per-segment bookkeeping survives an ACK; the receive
buffer keeps a small sorted list of out-of-order runs and merges on insert.
"""

from __future__ import annotations

from shadow_tpu_torch.tcp.seq import MOD, seq_diff


class SendBuffer:
    """Bytes the app has written, keyed by absolute stream offset.

    `una_off` .. `end_off` are *unwrapped* 64-bit offsets; the state machine
    maps sequence numbers to offsets via its own SND.UNA tracking (this is
    what makes mod-2^32 wraparound a non-issue here).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._chunks: list[bytes] = []
        self._len = 0
        self.una_off = 0  # offset of first unacked byte == start of buffer
        self.fin_queued = False

    @property
    def end_off(self) -> int:
        return self.una_off + self._len

    def space(self) -> int:
        return self.capacity - self._len

    def write(self, data: bytes) -> int:
        """Append up to space() bytes; returns bytes accepted."""
        if self.fin_queued:
            raise ValueError("write after shutdown")
        n = min(len(data), self.space())
        if n:
            self._chunks.append(bytes(data[:n]))
            self._len += n
        return n

    def ack_to(self, off: int) -> int:
        """Drop bytes below absolute offset `off`; returns bytes freed."""
        drop = off - self.una_off
        if drop <= 0:
            return 0
        if drop > self._len:
            raise ValueError(f"ack beyond buffered data: {off} > {self.end_off}")
        freed = drop
        self.una_off = off
        self._len -= drop
        while drop:
            head = self._chunks[0]
            if len(head) <= drop:
                drop -= len(head)
                self._chunks.pop(0)
            else:
                self._chunks[0] = head[drop:]
                drop = 0
        return freed

    def slice(self, off: int, n: int) -> bytes:
        """Read n bytes starting at absolute offset off (for (re)transmit)."""
        start = off - self.una_off
        if start < 0 or start + n > self._len:
            raise ValueError(
                f"slice [{off},{off + n}) outside [{self.una_off},{self.end_off})"
            )
        out = bytearray()
        for c in self._chunks:
            if start >= len(c):
                start -= len(c)
                continue
            take = c[start : start + n - len(out)]
            out += take
            start = 0
            if len(out) == n:
                break
        return bytes(out)


class RecvBuffer:
    """In-order delivery queue + out-of-order reassembly runs.

    RCV.NXT advancement is the caller's job; this buffer stores payload by
    32-bit sequence number and hands back contiguous data. Out-of-order runs
    are kept as a sorted list of (seq, bytes) merged on insert — network
    reordering windows are tiny compared to buffer sizes, so a list beats an
    interval tree here.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._ready = bytearray()  # contiguous, app-readable
        self._runs: list[tuple[int, bytes]] = []  # sorted by seq (wrapping)
        self.fin_seq: int | None = None  # seq of FIN byte, once known

    def readable(self) -> int:
        return len(self._ready)

    def window(self) -> int:
        """Advertisable receive window (free contiguous capacity)."""
        return max(0, self.capacity - len(self._ready))

    def insert(self, rcv_nxt: int, seq: int, data: bytes) -> int:
        """Insert payload at `seq` given current RCV.NXT; returns new RCV.NXT.

        Data at/below rcv_nxt is trimmed (retransmitted overlap); data beyond
        the window is trimmed (the state machine already bounds this).
        """
        if data:
            off = seq_diff(seq, rcv_nxt)
            if off < 0:  # overlaps already-received data
                data = data[-off:]
                off = 0
            if data and off <= self.window():
                data = data[: self.window() - off]
            if data:
                if off == 0:
                    self._ready += data
                    rcv_nxt = (rcv_nxt + len(data)) % MOD
                    rcv_nxt = self._drain_runs(rcv_nxt)
                else:
                    self._add_run((rcv_nxt + off) % MOD, bytes(data), rcv_nxt)
        if self.fin_seq is not None and seq_diff(self.fin_seq, rcv_nxt) == 0:
            rcv_nxt = (rcv_nxt + 1) % MOD
            self.fin_seq = None
        return rcv_nxt

    def _add_run(self, seq: int, data: bytes, rcv_nxt: int):
        self._runs.append((seq, data))
        # normalize: sort by distance from rcv_nxt, then merge overlaps
        self._runs.sort(key=lambda r: seq_diff(r[0], rcv_nxt))
        merged: list[tuple[int, bytes]] = []
        for s, d in self._runs:
            if merged:
                ps, pd = merged[-1]
                overlap = len(pd) - seq_diff(s, ps)  # bytes of d already held
                if overlap >= 0:
                    # keep existing bytes, append only d's new tail
                    if overlap < len(d):
                        merged[-1] = (ps, pd + d[overlap:])
                    continue
            merged.append((s, d))
        self._runs = merged

    def _drain_runs(self, rcv_nxt: int) -> int:
        changed = True
        while changed:
            changed = False
            for i, (s, d) in enumerate(self._runs):
                off = seq_diff(s, rcv_nxt)
                if off < 0 and off + len(d) <= 0:
                    self._runs.pop(i)
                    changed = True
                    break
                if off <= 0:
                    take = d[-off:]
                    self._ready += take
                    rcv_nxt = (rcv_nxt + len(take)) % MOD
                    self._runs.pop(i)
                    changed = True
                    break
        return rcv_nxt

    def ooo_ranges(self) -> list[tuple[int, int]]:
        """Out-of-order runs as wire-seq [start, end) blocks — the SACK
        blocks this receiver advertises (RFC 2018)."""
        return [(s, (s + len(d)) % MOD) for s, d in self._runs if d]

    def read(self, n: int) -> bytes:
        out = bytes(self._ready[:n])
        del self._ready[: len(out)]
        return out
