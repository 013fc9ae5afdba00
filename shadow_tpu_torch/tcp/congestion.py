"""Reno congestion control (slow start / congestion avoidance / fast recovery).

Reference: the pluggable congestion interface + Reno implementation
(`src/main/host/descriptor/tcp_cong.c`, `tcp_cong_reno.c` — the reference's
default and only in-tree algorithm). Mirrors the same plug-point shape: the
state machine calls `on_ack`, `on_dup_ack`, `on_retransmit_timeout`, reads
`cwnd`, so alternative algorithms drop in by duck type.
"""

from __future__ import annotations


class RenoCongestion:
    DUP_ACK_THRESH = 3  # fast-retransmit trigger (RFC 5681)

    def __init__(self, mss: int, initial_window_mss: int = 10):
        self.mss = mss
        self.cwnd = initial_window_mss * mss  # RFC 6928 IW10
        self.ssthresh = 1 << 30
        self.dup_acks = 0
        self.in_fast_recovery = False
        self._avoid_acc = 0  # byte accumulator for congestion avoidance

    # -- queries -------------------------------------------------------------

    @property
    def in_slow_start(self) -> bool:
        return self.cwnd < self.ssthresh

    def wants_fast_retransmit(self) -> bool:
        return self.dup_acks == self.DUP_ACK_THRESH and not self.in_fast_recovery

    # -- events --------------------------------------------------------------

    def on_ack(self, newly_acked: int):
        """Cumulative ACK advancing SND.UNA by `newly_acked` bytes."""
        self.dup_acks = 0
        if self.in_fast_recovery:
            # exit fast recovery: deflate to ssthresh (RFC 5681 step 6)
            self.in_fast_recovery = False
            self.cwnd = self.ssthresh
            return
        if self.in_slow_start:
            self.cwnd += min(newly_acked, self.mss)
        else:
            self._avoid_acc += min(newly_acked, self.mss)
            if self._avoid_acc >= self.cwnd:
                self._avoid_acc -= self.cwnd
                self.cwnd += self.mss

    def on_dup_ack(self):
        self.dup_acks += 1
        if self.dup_acks == self.DUP_ACK_THRESH and not self.in_fast_recovery:
            # enter fast recovery: halve, inflate by 3 segments
            self.ssthresh = max(self.cwnd // 2, 2 * self.mss)
            self.cwnd = self.ssthresh + 3 * self.mss
            self.in_fast_recovery = True
        elif self.in_fast_recovery:
            self.cwnd += self.mss  # window inflation per extra dup-ACK

    def on_retransmit_timeout(self):
        self.ssthresh = max(self.cwnd // 2, 2 * self.mss)
        self.cwnd = self.mss  # RFC 5681: back to 1 MSS (loss window)
        self.dup_acks = 0
        self.in_fast_recovery = False
        self._avoid_acc = 0
