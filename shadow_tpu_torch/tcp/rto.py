"""RTT estimation and retransmission timeout (RFC 6298).

Reference: the retransmit bookkeeping of `src/lib/tcp` and the legacy
`tcp_retransmit_tally.cc` (C++, retransmit tracking). Times are simulated
nanoseconds, like everything in this framework.
"""

from __future__ import annotations

NS_PER_SEC = 1_000_000_000

K = 4
ALPHA_SHIFT = 3  # alpha = 1/8
BETA_SHIFT = 2  # beta = 1/4
MIN_RTO = NS_PER_SEC  # 1 s (RFC 6298 recommendation; Linux uses 200ms)
MAX_RTO = 60 * NS_PER_SEC
INITIAL_RTO = NS_PER_SEC
GRANULARITY = 1_000_000  # 1 ms clock granularity


class RttEstimator:
    def __init__(self, min_rto: int = MIN_RTO, max_rto: int = MAX_RTO):
        self.srtt: int | None = None
        self.rttvar = 0
        self.rto = INITIAL_RTO
        self.min_rto = min_rto
        self.max_rto = max_rto
        self.backoff = 0  # consecutive timeouts (Karn exponential backoff)

    def on_measurement(self, rtt: int):
        """Valid RTT sample (never from a retransmitted segment — Karn)."""
        rtt = max(rtt, 1)
        if self.srtt is None:
            self.srtt = rtt
            self.rttvar = rtt // 2
        else:
            err = abs(self.srtt - rtt)
            self.rttvar += (err - self.rttvar) >> BETA_SHIFT
            self.srtt += (rtt - self.srtt) >> ALPHA_SHIFT
        self.backoff = 0
        base = self.srtt + max(GRANULARITY, K * self.rttvar)
        self.rto = min(max(base, self.min_rto), self.max_rto)

    def on_timeout(self):
        """Exponential backoff; caller retransmits."""
        self.backoff += 1

    def current_rto(self) -> int:
        return min(self.rto << min(self.backoff, 12), self.max_rto)
