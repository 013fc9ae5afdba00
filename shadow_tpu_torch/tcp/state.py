"""The sans-I/O TCP connection state machine.

Reference: `src/lib/tcp/src/lib.rs:244-345` (`TcpState<X: Dependencies>`) and
its per-state modules (`states.rs`) — rebuilt, not translated. All times are
absolute simulated nanoseconds passed in by the caller; the machine never
reads a clock. Typical driving loop:

    tcp = TcpState(cfg, iss=123)
    tcp.connect(now)
    for seg in tcp.poll_segments(now):  wire.send(seg)
    ...
    tcp.on_segment(now, seg_from_wire)
    t = tcp.next_timer()                # absolute ns or None
    if t is not None and now >= t: tcp.on_timer(now)

Internally, send-side bookkeeping uses *unwrapped 64-bit stream offsets*
(`una_off`/`nxt_off` into `SendBuffer`) with sequence numbers computed at
segment-emission time — mod-2^32 wraparound lives only at the wire boundary,
which removes the reference's pervasive `Seq` arithmetic from the hot paths.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

from shadow_tpu_torch.tcp.buffers import RecvBuffer, SendBuffer
from shadow_tpu_torch.tcp.congestion import RenoCongestion
from shadow_tpu_torch.tcp.rto import RttEstimator
from shadow_tpu_torch.tcp.segment import ACK, FIN, PSH, RST, SYN, Segment
from shadow_tpu_torch.tcp.seq import (
    MOD,
    in_window,
    seq_diff,
    seq_ge,
    seq_gt,
    seq_le,
    seq_lt,
    wrapping_add,
)

NS_PER_SEC = 1_000_000_000


class State(enum.Enum):
    CLOSED = "closed"
    LISTEN = "listen"
    SYN_SENT = "syn-sent"
    SYN_RECEIVED = "syn-received"
    ESTABLISHED = "established"
    FIN_WAIT_1 = "fin-wait-1"
    FIN_WAIT_2 = "fin-wait-2"
    CLOSING = "closing"
    TIME_WAIT = "time-wait"
    CLOSE_WAIT = "close-wait"
    LAST_ACK = "last-ack"


class TcpError(enum.Enum):
    RESET = "connection reset by peer"  # ECONNRESET
    REFUSED = "connection refused"  # ECONNREFUSED
    TIMED_OUT = "connection timed out"  # ETIMEDOUT


# states in which the app may still queue data for transmission
_SENDABLE = frozenset({State.ESTABLISHED, State.CLOSE_WAIT})
# states with a fully synchronized connection
SYNCHRONIZED = frozenset(
    {
        State.ESTABLISHED,
        State.FIN_WAIT_1,
        State.FIN_WAIT_2,
        State.CLOSING,
        State.TIME_WAIT,
        State.CLOSE_WAIT,
        State.LAST_ACK,
    }
)


@dataclass(frozen=True)
class TcpConfig:
    mss: int = 1460
    send_buf: int = 256 * 1024
    recv_buf: int = 256 * 1024
    window_scaling: bool = True
    time_wait: int = 60 * NS_PER_SEC  # 2*MSL
    max_retries: int = 12  # consecutive RTO expirations before TIMED_OUT
    initial_window_mss: int = 10
    # SACK (RFC 2018; reference tcp.c:151-177): negotiated on SYN, blocks on
    # ACKs; the sender keeps a scoreboard and skips sacked ranges when
    # retransmitting (selective repeat instead of a full go-back-N resend)
    sack: bool = True
    # delayed ACK (RFC 1122 4.2.3.2; reference tcp.c:1254,2014): hold the
    # ACK for one in-order segment up to `delack_ns`, ack every 2nd
    # immediately; out-of-order arrivals always ack immediately
    delayed_ack: bool = True
    delack_ns: int = 40_000_000  # 40 ms (Linux's default delack ceiling)
    # Nagle (RFC 896): hold a sub-MSS tail while any data is unacked.
    # Default off: the reference's sans-I/O machine ships without Nagle and
    # most corpus binaries would set TCP_NODELAY anyway
    nagle: bool = False
    # buffer autotuning (reference HostDefaultOptions autotune flags):
    # double a buffer under pressure — recv when the advertised window
    # drops below one MSS, send when the app fills it — up to `buf_max`.
    # The receive wscale is chosen from buf_max so a grown window stays
    # advertisable (RFC 7323 fixes the shift at SYN time).
    autotune: bool = True
    buf_max: int = 4 * 1024 * 1024


def _wscale_for(recv_buf: int) -> int:
    s = 0
    while s < 14 and (recv_buf >> s) > 0xFFFF:
        s += 1
    return s


class TcpState:
    def __init__(self, config: TcpConfig | None = None, *, iss: int = 0):
        self.cfg = config or TcpConfig()
        self.state = State.CLOSED
        self.error: TcpError | None = None

        # send side
        self.iss = iss % MOD
        self.snd_buf = SendBuffer(self.cfg.send_buf)
        self.una_off = 0  # first unacked stream byte (== snd_buf.una_off)
        self.nxt_off = 0  # next stream byte to transmit
        self.snd_wnd = 0  # peer-advertised window (post-scaling bytes)
        self.snd_wl1 = 0  # seq of segment used for last window update
        self.snd_wl2 = 0  # ack of segment used for last window update
        self.snd_max_seq = self.iss  # highest snd_nxt ever (for ack validation)
        self.syn_sent = False
        self.syn_acked = False
        self.fin_sent = False
        self.fin_acked = False
        self.snd_wscale = 0  # shift applied to windows the peer advertises
        self.mss = self.cfg.mss

        # receive side
        self.irs = 0
        self.rcv_nxt = 0
        self.rcv_buf = RecvBuffer(self.cfg.recv_buf)
        self.rcv_wscale = (
            _wscale_for(
                max(self.cfg.recv_buf, self.cfg.buf_max)
                if self.cfg.autotune
                else self.cfg.recv_buf
            )
            if self.cfg.window_scaling
            else 0
        )
        self.rcv_fin_seen = False  # FIN consumed (EOF reached)

        # congestion + timing
        self.cong = RenoCongestion(self.mss, self.cfg.initial_window_mss)
        self.rtt = RttEstimator()
        self._timed: tuple[int, int] | None = None  # (end_off, sent_at)
        self._max_sent_off = 0  # high-water transmit mark (Karn guard)
        self.rto_deadline: int | None = None
        self.probe_deadline: int | None = None
        self.tw_deadline: int | None = None
        self.retries = 0

        # pending output control
        self._pending_syn = False
        self._pending_ack = False
        self._dup_ack_owed = 0  # RFC 5681: one immediate ACK per ooo segment
        self._fast_rexmit = False
        self._probe_due = False
        self._pending_rst: Segment | None = None

        # SACK: negotiated capability + sender scoreboard of peer-held
        # ranges as disjoint sorted UNWRAPPED offset pairs [start, end)
        self.sack_ok = False
        self._sacked: list[tuple[int, int]] = []
        # delayed ACK: deadline for a held in-order-data ACK
        self._delack_deadline: int | None = None

        # stats (reference tcp crate keeps similar counters)
        self.segs_sent = 0
        self.segs_received = 0
        self.retransmits = 0

    # ------------------------------------------------------------------ app

    def listen(self):
        assert self.state == State.CLOSED
        self.state = State.LISTEN

    def connect(self, now: int):
        assert self.state in (State.CLOSED, State.LISTEN)
        self.state = State.SYN_SENT
        self._pending_syn = True
        self._arm_rto(now)

    def send(self, data: bytes) -> int:
        """Queue app data; returns bytes accepted (0 = buffer full)."""
        if self.state not in _SENDABLE and not (
            self.state in (State.SYN_SENT, State.SYN_RECEIVED)
        ):
            raise BrokenPipeError(f"send in state {self.state.value}")
        if self.snd_buf.fin_queued:
            raise BrokenPipeError("send after shutdown")
        n = self.snd_buf.write(data)
        if (
            n < len(data)
            and self.cfg.autotune
            and self.snd_buf.capacity < self.cfg.buf_max
        ):
            # sender autotune: the app outpaces the buffer — double it
            self.snd_buf.capacity = min(
                self.snd_buf.capacity * 2, self.cfg.buf_max
            )
            n += self.snd_buf.write(data[n:])
        return n

    def recv(self, n: int) -> bytes | None:
        """Read up to n bytes. None = would block; b'' = EOF."""
        if self.rcv_buf.readable():
            data = self.rcv_buf.read(n)
            self._pending_ack = True  # window opened; let peer know
            return data
        if self.rcv_fin_seen or self.error is not None:
            return b""
        if self.state in (State.CLOSED, State.LISTEN):
            return b""
        return None

    def shutdown_write(self, now: int):
        """Half-close: FIN after all queued data (like shutdown(SHUT_WR))."""
        if self.snd_buf.fin_queued:
            return
        self.snd_buf.fin_queued = True
        if self.state == State.ESTABLISHED:
            self.state = State.FIN_WAIT_1
        elif self.state == State.CLOSE_WAIT:
            self.state = State.LAST_ACK
        elif self.state == State.SYN_RECEIVED:
            # no data was ever accepted: close becomes FIN after handshake
            self.state = State.FIN_WAIT_1
        elif self.state in (State.SYN_SENT, State.LISTEN):
            self._enter_closed(None)
            return
        self._arm_rto(now)

    def close(self, now: int):
        """Full close (like close(2)): no more reads or writes."""
        self.shutdown_write(now)

    def abort(self, now: int):
        """Hard reset (SO_LINGER 0 close / process death)."""
        if self.state in SYNCHRONIZED or self.state == State.SYN_RECEIVED:
            self._pending_rst = Segment(
                RST | ACK, seq=self._snd_nxt_seq(), ack=self.rcv_nxt
            )
        self._enter_closed(None)

    # -------------------------------------------------------------- queries

    def readable(self) -> bool:
        return self.rcv_buf.readable() > 0 or self.rcv_fin_seen or self.error is not None

    def writable(self) -> bool:
        return (
            self.state in _SENDABLE
            and not self.snd_buf.fin_queued
            and self.snd_buf.space() > 0
        )

    def is_closed(self) -> bool:
        return self.state == State.CLOSED

    # --------------------------------------------------------------- listen

    def accept_segment(self, now: int, seg: Segment, *, child_iss: int) -> "TcpState | None":
        """LISTEN-socket demux: a SYN forks a child connection in
        SYN_RECEIVED (the reference's listener spawns per-connection state
        the same way); anything else is the socket layer's problem
        (`rst_for` below). Returns the child or None."""
        assert self.state == State.LISTEN
        if seg.flags & (RST | ACK) or not (seg.flags & SYN):
            return None
        child = TcpState(self.cfg, iss=child_iss)
        child.state = State.SYN_RECEIVED
        child._accept_syn_options(seg)
        child.irs = seg.seq
        child.rcv_nxt = wrapping_add(seg.seq, 1)
        child._pending_syn = True
        child._arm_rto(now)
        return child

    # ----------------------------------------------------------------- wire

    def on_segment(self, now: int, seg: Segment):
        self.segs_received += 1
        handler = {
            State.CLOSED: self._seg_closed,
            State.LISTEN: self._seg_closed,  # direct use; normally via accept
            State.SYN_SENT: self._seg_syn_sent,
        }.get(self.state, self._seg_synchronized)
        handler(now, seg)

    def _seg_closed(self, now: int, seg: Segment):
        if not (seg.flags & RST):
            self._pending_rst = rst_for(seg)

    def _seg_syn_sent(self, now: int, seg: Segment):
        acceptable_ack = False
        if seg.flags & ACK:
            if seq_le(seg.ack, self.iss) or seq_gt(seg.ack, self.snd_max_seq):
                if not (seg.flags & RST):
                    self._pending_rst = rst_for(seg)
                return
            acceptable_ack = True
        if seg.flags & RST:
            if acceptable_ack:
                self.error = TcpError.REFUSED
                self._enter_closed(TcpError.REFUSED)
            return
        if not (seg.flags & SYN):
            return
        self._accept_syn_options(seg)
        self.irs = seg.seq
        self.rcv_nxt = wrapping_add(seg.seq, 1)
        if acceptable_ack:
            self._ack_advance(now, seg.ack)  # manages the RTO timer itself
            self._update_snd_wnd(seg, syn=True)
            self.state = State.ESTABLISHED
            self._pending_ack = True
        else:
            # simultaneous open: resend our SYN as SYN-ACK
            self.state = State.SYN_RECEIVED
            self._pending_syn = True
            self._arm_rto(now)

    def _seg_synchronized(self, now: int, seg: Segment):
        # RFC 793 trimming: strip sequence space below RCV.NXT (retransmitted
        # SYN / payload prefix) so the remainder is judged on its own. This is
        # what lets a simultaneous-open SYN-ACK (whose SYN unit is already
        # consumed) deliver its ACK.
        d = seq_diff(seg.seq, self.rcv_nxt)
        if d < 0 and seg.seg_len > 0:
            old = -d
            flags, payload, seq = seg.flags, seg.payload, seg.seq
            if flags & SYN:
                flags &= ~SYN
                seq = wrapping_add(seq, 1)
                old -= 1
            if old > 0:
                drop = min(old, len(payload))
                payload = payload[drop:]
                seq = wrapping_add(seq, drop)
            seg = dataclasses.replace(seg, flags=flags, payload=payload, seq=seq)
            # an old duplicate must still elicit an ACK (so a sender that
            # rewound past data the peer already holds re-syncs its SND.UNA)
            self._pending_ack = True

        # RFC 793 p.69 acceptability: does the segment overlap RCV window?
        wnd = self.rcv_buf.window()
        if seg.seg_len == 0:
            ok = seq_diff(seg.seq, self.rcv_nxt) == 0 or in_window(
                seg.seq, self.rcv_nxt, wnd
            )
        else:
            ok = in_window(seg.seq, self.rcv_nxt, wnd) or in_window(
                wrapping_add(seg.seq, seg.seg_len - 1), self.rcv_nxt, wnd
            )
        if not ok:
            if not (seg.flags & RST):
                self._pending_ack = True
            return
        if seg.flags & RST:
            self._enter_closed(TcpError.RESET)
            return
        if seg.flags & SYN:
            # SYN in window in a synchronized state: error, reset
            self._pending_rst = Segment(RST, seq=self._snd_nxt_seq())
            self._enter_closed(TcpError.RESET)
            return
        if not (seg.flags & ACK):
            return

        # --- ACK processing
        if self.state == State.SYN_RECEIVED:
            if seq_le(seg.ack, self.iss) or seq_gt(seg.ack, self.snd_max_seq):
                self._pending_rst = rst_for(seg)
                return
            self.state = State.ESTABLISHED
            # the handshake-completing ACK carries no SYN, so its window is
            # already scaled (RFC 7323: only SYN-flagged segments are
            # unscaled) — but snd_wl1/wl2 are still at their init values, so
            # the update must be forced, not gated on the wl ordering check
            self._update_snd_wnd(seg, force=True)
        dup_candidate = (
            seg.seg_len == 0
            and (seg.wnd << self.snd_wscale) == self.snd_wnd
        )
        if self.sack_ok and seg.sack:
            self._absorb_sack(seg.sack)
        self._ack_advance(now, seg.ack, dup_candidate)
        self._update_snd_wnd(seg)

        # state transitions on our-FIN-acked
        if self.fin_acked:
            if self.state == State.FIN_WAIT_1:
                self.state = State.FIN_WAIT_2
            elif self.state == State.CLOSING:
                self._enter_time_wait(now)
            elif self.state == State.LAST_ACK:
                self._enter_closed(None)
                return

        # --- payload
        if seg.payload and self.state in (
            State.ESTABLISHED,
            State.FIN_WAIT_1,
            State.FIN_WAIT_2,
        ):
            before = self.rcv_nxt
            had_fin_pending = self.rcv_buf.fin_seq is not None
            had_runs = bool(self.rcv_buf._runs)
            self.rcv_nxt = self.rcv_buf.insert(self.rcv_nxt, seg.seq, seg.payload)
            if self.rcv_nxt != before and self.cfg.delayed_ack and not had_runs:
                # in-order data: ack every SECOND segment immediately, hold
                # a single segment's ACK up to delack_ns (RFC 1122 4.2.3.2;
                # reference tcp.c:1254,2014). Anything out of order below
                # acks immediately via the dup-ACK path.
                if self._delack_deadline is not None:
                    self._pending_ack = True
                    self._delack_deadline = None
                else:
                    self._delack_deadline = now + self.cfg.delack_ns
            else:
                self._pending_ack = True
            if self.rcv_nxt == before and seg.payload:
                # out-of-order: each such segment owes its own immediate
                # dup-ACK so the peer's fast-retransmit counter sees every
                # arrival even when the wire delivers a whole batch at once
                self._dup_ack_owed += 1
            if had_fin_pending and self.rcv_buf.fin_seq is None:
                # this insert filled the hole before an out-of-order FIN:
                # the buffer consumed it, so run the FIN transitions now
                self._on_fin_reached(now)
            if (
                self.cfg.autotune
                and self.rcv_buf.window() < self.mss
                and self.rcv_buf.capacity < self.cfg.buf_max
            ):
                # receiver autotune: the window is about to close on a
                # sender that is keeping it full — double the buffer (the
                # wscale chosen at SYN already covers buf_max)
                self.rcv_buf.capacity = min(
                    self.rcv_buf.capacity * 2, self.cfg.buf_max
                )
                self._pending_ack = True  # advertise the opened window

        # --- FIN (a fully-old retransmitted FIN never reaches here: the
        # acceptability check above already rejected it with an ACK)
        if seg.flags & FIN and not self.rcv_fin_seen:
            fin_seq = wrapping_add(seg.seq, len(seg.payload))
            self.rcv_buf.fin_seq = fin_seq
            self.rcv_nxt = self.rcv_buf.insert(self.rcv_nxt, fin_seq, b"")
            if self.rcv_buf.fin_seq is None:  # FIN consumed in order
                self._on_fin_reached(now)
            else:
                self._pending_ack = True  # out-of-order FIN: dup-ACK

    def _on_fin_reached(self, now: int):
        """RCV.NXT has passed the peer's FIN: EOF + state transitions."""
        if self.rcv_fin_seen:
            return
        self.rcv_fin_seen = True
        self._pending_ack = True
        if self.state == State.ESTABLISHED:
            self.state = State.CLOSE_WAIT
        elif self.state == State.FIN_WAIT_1:
            # if our own FIN is already acked this is a straight TIME_WAIT
            # entry; otherwise simultaneous close -> CLOSING
            if self.fin_acked:
                self._enter_time_wait(now)
            else:
                self.state = State.CLOSING
        elif self.state == State.FIN_WAIT_2:
            self._enter_time_wait(now)
        elif self.state == State.TIME_WAIT:
            self._enter_time_wait(now)  # restart 2MSL

    # ------------------------------------------------------------- ack math

    def _snd_nxt_seq(self) -> int:
        seq = wrapping_add(self.iss, (1 if self.syn_sent else 0) + self.nxt_off)
        if self.fin_sent:
            seq = wrapping_add(seq, 1)
        return seq

    def _snd_una_seq(self) -> int:
        return wrapping_add(self.iss, (1 if self.syn_acked else 0) + self.una_off)

    def _ack_advance(self, now: int, ack: int, dup_candidate: bool = False):
        """`dup_candidate`: segment was empty with an unchanged window, so an
        unmoved ACK counts toward fast retransmit (RFC 5681 dup-ACK rules)."""
        una = self._snd_una_seq()
        d = seq_diff(ack, una)
        if d < 0:
            return  # old ACK
        if seq_gt(ack, self.snd_max_seq):
            self._pending_ack = True  # ACK for unsent data
            return
        if d == 0:
            if (
                dup_candidate
                and self.syn_acked
                and self.nxt_off > self.una_off
                and not (self.fin_sent and not self.fin_acked)
            ):
                self.cong.on_dup_ack()
                if self.cong.dup_acks == self.cong.DUP_ACK_THRESH:
                    self._fast_rexmit = True
            return

        newly_acked_bytes = 0
        if not self.syn_acked and self.syn_sent:
            self.syn_acked = True
            d -= 1
        # bound by bytes ever transmitted, not nxt_off: after an RTO
        # go-back-N rewind (nxt_off = una_off) a late ACK may still cover
        # data sent before the rewind
        take = min(d, self._max_sent_off - self.una_off)
        if take:
            self.snd_buf.ack_to(self.una_off + take)
            self.una_off += take
            self.nxt_off = max(self.nxt_off, self.una_off)
            newly_acked_bytes = take
            d -= take
        if d and self.fin_sent and not self.fin_acked:
            self.fin_acked = True
            d -= 1
        if self._sacked:
            self._prune_sacked()
        # RTT sample (Karn: only if the timed range wasn't retransmitted)
        if self._timed is not None and self.una_off >= self._timed[0]:
            self.rtt.on_measurement(now - self._timed[1])
            self._timed = None
        self.cong.on_ack(max(newly_acked_bytes, 1))
        self.retries = 0
        self._fast_rexmit = False
        # restart or clear the retransmission timer
        if self._bytes_in_flight() or (self.fin_sent and not self.fin_acked):
            self._arm_rto(now)
        else:
            self.rto_deadline = None

    def _update_snd_wnd(self, seg: Segment, syn: bool = False, force: bool = False):
        """`syn`: the segment's window is unscaled (RFC 7323). `force`:
        bypass the snd_wl1/wl2 staleness check (used when wl1/wl2 still hold
        their pre-handshake init values and would reject ~half of ISS space)."""
        if not (seg.flags & ACK) and not syn:
            return
        wnd = seg.wnd if (syn or seg.flags & SYN) else seg.wnd << self.snd_wscale
        if (
            syn
            or force
            or seq_lt(self.snd_wl1, seg.seq)
            or (self.snd_wl1 == seg.seq and seq_le(self.snd_wl2, seg.ack))
        ):
            was_zero = self.snd_wnd == 0
            self.snd_wnd = wnd
            self.snd_wl1 = seg.seq
            self.snd_wl2 = seg.ack
            if was_zero and wnd > 0:
                self.probe_deadline = None
                self._probe_due = False

    def _accept_syn_options(self, seg: Segment):
        if seg.mss is not None:
            self.mss = min(self.cfg.mss, seg.mss)
            self.cong.mss = self.mss
        if seg.wscale is not None and self.cfg.window_scaling:
            self.snd_wscale = min(seg.wscale, 14)
        else:
            self.snd_wscale = 0
            self.rcv_wscale = 0  # peer didn't offer: RFC 7323 both-or-neither
        self.sack_ok = bool(seg.sack_ok) and self.cfg.sack

    def _bytes_in_flight(self) -> int:
        return self.nxt_off - self.una_off

    # ----------------------------------------------------------------- sack

    def _absorb_sack(self, blocks):
        """Merge wire-seq SACK blocks into the offset scoreboard. Blocks are
        anchored at SND.UNA (seq_diff is safe because peers only SACK data
        within the current send window)."""
        una_seq = self._snd_una_seq()
        changed = False
        for s, e in blocks:
            start = self.una_off + seq_diff(s, una_seq)
            end = self.una_off + seq_diff(e, una_seq)
            start = max(start, self.una_off)
            end = min(end, self._max_sent_off)
            if end > start:
                self._sacked.append((start, end))
                changed = True
        if changed:
            self._sacked.sort()
            merged: list[tuple[int, int]] = []
            for s0, e0 in self._sacked:
                if merged and s0 <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e0))
                else:
                    merged.append((s0, e0))
            self._sacked = merged

    def _prune_sacked(self):
        self._sacked = [
            (max(s, self.una_off), e)
            for s, e in self._sacked
            if e > self.una_off
        ]

    def _sack_jump(self, off: int) -> int:
        """Next offset at/after `off` NOT held by the peer (scoreboard skip);
        also returns the transmit ceiling imposed by the next sacked block
        via `_sack_limit`."""
        for s, e in self._sacked:
            if s <= off < e:
                return e
        return off

    def _sack_limit(self, off: int, limit: int) -> int:
        """Clamp a transmission starting at `off` so it stops at the next
        sacked block (no point retransmitting data the peer already holds)."""
        for s, e in self._sacked:
            if s > off:
                return min(limit, s)
        return limit

    # --------------------------------------------------------------- timers

    def next_timer(self) -> int | None:
        cands = [
            t
            for t in (
                self.rto_deadline,
                self.probe_deadline,
                self.tw_deadline,
                self._delack_deadline,
            )
            if t is not None
        ]
        return min(cands) if cands else None

    def on_timer(self, now: int):
        if self._delack_deadline is not None and now >= self._delack_deadline:
            self._delack_deadline = None
            self._pending_ack = True
        if self.tw_deadline is not None and now >= self.tw_deadline:
            self.tw_deadline = None
            if self.state == State.TIME_WAIT:
                self._enter_closed(None)
                return
        if self.rto_deadline is not None and now >= self.rto_deadline:
            self.rto_deadline = None
            self._on_rto(now)
        if self.probe_deadline is not None and now >= self.probe_deadline:
            self.probe_deadline = None
            self._probe_due = True
            self.rtt.on_timeout()

    def _arm_rto(self, now: int):
        self.rto_deadline = now + self.rtt.current_rto()

    def _on_rto(self, now: int):
        self.retries += 1
        if self.retries > self.cfg.max_retries:
            self._enter_closed(TcpError.TIMED_OUT)
            return
        self.rtt.on_timeout()
        self.cong.on_retransmit_timeout()
        self.retransmits += 1
        self._timed = None  # Karn: no sample from retransmitted data
        # go-back-N: rewind transmission to the oldest unacked octet
        if self.state in (State.SYN_SENT, State.SYN_RECEIVED) or (
            self.syn_sent and not self.syn_acked
        ):
            self._pending_syn = True
        self.nxt_off = self.una_off
        if self.fin_sent and not self.fin_acked:
            self.fin_sent = False  # re-emit FIN after data
        self._arm_rto(now)

    def _enter_time_wait(self, now: int):
        self.state = State.TIME_WAIT
        self.tw_deadline = now + self.cfg.time_wait
        self.rto_deadline = None
        self.probe_deadline = None
        self._pending_ack = True

    def _enter_closed(self, err: TcpError | None):
        self.state = State.CLOSED
        if err is not None and self.error is None:
            self.error = err
        self.rto_deadline = None
        self.probe_deadline = None
        self.tw_deadline = None

    # --------------------------------------------------------------- output

    def _recv_window_field(self) -> int:
        w = self.rcv_buf.window() >> self.rcv_wscale
        return min(w, 0xFFFF)

    def poll_segments(self, now: int) -> list[Segment]:
        """Drain all segments the machine wants on the wire right now."""
        out: list[Segment] = []
        if self._pending_rst is not None:
            out.append(self._pending_rst)
            self._pending_rst = None
        if self.state in (State.CLOSED, State.LISTEN):
            self.segs_sent += len(out)
            return out

        # SYN / SYN-ACK
        if self._pending_syn:
            self._pending_syn = False
            self.syn_sent = True
            flags = SYN
            ack = 0
            if self.state == State.SYN_RECEIVED:
                flags |= ACK
                ack = self.rcv_nxt
            out.append(
                Segment(
                    flags,
                    seq=self.iss,
                    ack=ack,
                    wnd=min(self.rcv_buf.window(), 0xFFFF),
                    mss=self.cfg.mss,
                    wscale=self.rcv_wscale if self.cfg.window_scaling else None,
                    # a SYN-ACK echoes the capability only if the peer's SYN
                    # offered it (negotiation); a plain SYN offers our config
                    sack_ok=(
                        self.sack_ok
                        if self.state == State.SYN_RECEIVED
                        else self.cfg.sack
                    ),
                )
            )
            self.snd_max_seq = wrapping_add(self.iss, 1)
            self._pending_ack = False
            self.segs_sent += len(out)
            return out  # nothing else until handshake progresses

        if not self.syn_acked:
            self.segs_sent += len(out)
            return out

        # fast retransmit: one segment from the oldest unacked octet,
        # bounded by the first SACKed block (only the hole is resent)
        if self._fast_rexmit and self.una_off < self.snd_buf.end_off:
            self._fast_rexmit = False
            hole_end = self._sack_limit(self.una_off, self.snd_buf.end_off)
            n = min(self.mss, hole_end - self.una_off)
            if n > 0:
                out.append(self._data_segment(self.una_off, n))
                self.retransmits += 1
                self._timed = None  # Karn: its ACK would be ambiguous

        # regular data: bounded by peer window + cwnd. After an RTO rewind
        # the SACK scoreboard turns the go-back-N into selective repeat:
        # ranges the peer already holds are skipped, transmissions stop at
        # the next held block (tcp.c's selectiveACKs retransmit behavior).
        limit_off = self.una_off + min(
            self.snd_wnd, self.cong.cwnd
        )  # first non-sendable offset
        end = self.snd_buf.end_off
        while self.nxt_off < end and self.nxt_off < limit_off:
            if self._sacked:
                jumped = self._sack_jump(self.nxt_off)
                if jumped != self.nxt_off:  # peer holds this range: skip
                    self.nxt_off = min(jumped, end)
                    continue
            stop = (
                self._sack_limit(self.nxt_off, limit_off)
                if self._sacked
                else limit_off
            )
            n = min(self.mss, end - self.nxt_off, stop - self.nxt_off)
            if n <= 0:
                break
            if (
                self.cfg.nagle
                and n < self.mss
                and self.nxt_off + n == end
                and self._bytes_in_flight() > 0
                and not self.snd_buf.fin_queued
            ):
                # Nagle: hold the sub-MSS tail while data is in flight
                break
            seg = self._data_segment(self.nxt_off, n)
            out.append(seg)
            if self.nxt_off < self._max_sent_off:
                self.retransmits += 1  # rewound range: this is a resend
            # Karn: only time ranges never transmitted before
            if self._timed is None and self.nxt_off >= self._max_sent_off:
                self._timed = (self.nxt_off + n, now)
            self.nxt_off += n
            self._max_sent_off = max(self._max_sent_off, self.nxt_off)
            if self.rto_deadline is None:
                self._arm_rto(now)
        # zero-window probe (persist timer): 1 byte past the window. The first
        # probe advances nxt_off (so the peer's ACK is accounted normally);
        # re-probes retransmit the in-flight octet.
        if self._probe_due:
            self._probe_due = False
            if self.snd_wnd == 0:
                if self._bytes_in_flight():
                    out.append(self._data_segment(self.una_off, 1))
                elif self.nxt_off < end:
                    out.append(self._data_segment(self.nxt_off, 1))
                    self.nxt_off += 1
                    self._max_sent_off = max(self._max_sent_off, self.nxt_off)
                # a lost probe byte must still retransmit once the peer's
                # window update clears the persist timer
                if self.rto_deadline is None and self._bytes_in_flight():
                    self._arm_rto(now)

        if (
            self.snd_wnd == 0
            and (self.nxt_off < end or self._bytes_in_flight())
            and self.probe_deadline is None
        ):
            self._arm_probe(now)

        # FIN once all data is out
        if (
            self.snd_buf.fin_queued
            and not self.fin_sent
            and self.nxt_off == end
            and self.state
            in (State.FIN_WAIT_1, State.LAST_ACK, State.CLOSING, State.TIME_WAIT)
        ):
            self.fin_sent = True
            out.append(
                Segment(
                    FIN | ACK,
                    seq=wrapping_add(self.iss, 1 + self.nxt_off),
                    ack=self.rcv_nxt,
                    wnd=self._recv_window_field(),
                )
            )
            self._pending_ack = False
            if self.rto_deadline is None:
                self._arm_rto(now)

        seq_after = self._snd_nxt_seq()
        if seq_gt(seq_after, self.snd_max_seq):
            self.snd_max_seq = seq_after

        # explicit dup-ACK train for out-of-order arrivals, carrying the
        # SACK blocks that tell the peer exactly which ranges arrived
        if self._dup_ack_owed:
            ack_seg = Segment(
                ACK,
                seq=self._snd_nxt_seq(),
                ack=self.rcv_nxt,
                wnd=self._recv_window_field(),
                sack=self._sack_blocks(),
            )
            out.extend([ack_seg] * self._dup_ack_owed)
            self._dup_ack_owed = 0
            self._pending_ack = False

        # pure ACK if still owed
        if self._pending_ack and not any(s.flags & ACK for s in out):
            out.append(
                Segment(
                    ACK,
                    seq=self._snd_nxt_seq(),
                    ack=self.rcv_nxt,
                    wnd=self._recv_window_field(),
                    sack=self._sack_blocks(),
                )
            )
        if any(s.flags & ACK for s in out):
            self._pending_ack = False
            self._delack_deadline = None  # the held ACK rode along
        self.segs_sent += len(out)
        return out

    def _sack_blocks(self) -> tuple:
        if not self.sack_ok:
            return ()
        return tuple(self.rcv_buf.ooo_ranges()[:3])

    def _data_segment(self, off: int, n: int) -> Segment:
        payload = self.snd_buf.slice(off, n)
        return Segment(
            ACK | (PSH if off + n == self.snd_buf.end_off else 0),
            seq=wrapping_add(self.iss, 1 + off),
            ack=self.rcv_nxt,
            wnd=self._recv_window_field(),
            payload=payload,
        )

    def _arm_probe(self, now: int):
        self.probe_deadline = now + self.rtt.current_rto()


def rst_for(seg: Segment) -> Segment | None:
    """RST replying to `seg` arriving for a nonexistent/closed endpoint
    (RFC 793 reset generation; the socket layer sends this for unmatched
    demux, like the reference's closed-port handling)."""
    if seg.flags & RST:
        return None
    if seg.flags & ACK:
        return Segment(RST, seq=seg.ack, src_port=seg.dst_port, dst_port=seg.src_port)
    return Segment(
        RST | ACK,
        seq=0,
        ack=wrapping_add(seg.seq, seg.seg_len),
        src_port=seg.dst_port,
        dst_port=seg.src_port,
    )
