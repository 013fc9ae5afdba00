"""Sans-I/O TCP state machine.

Capability mirror of the reference's clean-room TCP crate
(the reference's `src/lib/tcp/`, Rust ~8k LoC: `tcp/src/lib.rs:1-60,244-345`,
per-state modules in `states.rs`, mod-2^32 sequence arithmetic in `seq.rs`,
send/receive buffers, window scaling) — re-designed, not translated.

The machine is *sans-I/O*: it never touches wires or clocks. Callers feed it
wall input (`on_segment`, `on_timer(now)`) and app input (`connect`, `send`,
`recv`, `close`, `shutdown`), and drain output with `poll_segments(now)`.
Time is always an explicit `now` argument (simulated nanoseconds) — the
dependency-injection equivalent of the reference's `TcpState<X: Dependencies>`
type parameter. This is what lets the same machine run under the simulated
clock of the PDES host plane (`shadow_tpu_torch.host`) and under real time in unit
tests.

Feature set (matching the reference crate): 3-way handshake (active +
passive + simultaneous open), MSS + window-scaling options, cumulative ACKs,
out-of-order reassembly, RFC 6298 RTO with Karn's algorithm + exponential
backoff, fast retransmit on 3 dup-ACKs, Reno congestion control (slow start /
congestion avoidance / fast recovery — the reference's default pluggable CC,
`tcp_cong_reno.c`), zero-window probing, all close paths incl. simultaneous
close and TIME_WAIT 2MSL, RST generation/handling.
"""

from shadow_tpu_torch.tcp.seq import Seq, seq_ge, seq_gt, seq_le, seq_lt, seq_max, wrapping_add
from shadow_tpu_torch.tcp.segment import FIN, SYN, RST, PSH, ACK, Segment, flags_str
from shadow_tpu_torch.tcp.buffers import RecvBuffer, SendBuffer
from shadow_tpu_torch.tcp.congestion import RenoCongestion
from shadow_tpu_torch.tcp.rto import RttEstimator
from shadow_tpu_torch.tcp.state import TcpConfig, TcpError, TcpState, State

__all__ = [
    "ACK",
    "FIN",
    "PSH",
    "RST",
    "SYN",
    "RecvBuffer",
    "RenoCongestion",
    "RttEstimator",
    "Segment",
    "SendBuffer",
    "Seq",
    "State",
    "TcpConfig",
    "TcpError",
    "TcpState",
    "flags_str",
    "seq_ge",
    "seq_gt",
    "seq_le",
    "seq_lt",
    "seq_max",
    "wrapping_add",
]
