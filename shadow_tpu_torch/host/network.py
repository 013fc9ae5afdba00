"""The CPU wire: latency/loss fabric + conservative round loop for CpuHosts.

Reference: this is the host-plane counterpart of `Worker::send_packet`
(worker.rs:330-425 — latency lookup, loss draw from the *source* host RNG,
cross-host event push) plus the Manager round loop (manager.rs:392-478) in
miniature. The device engine implements the same contract on TPU; this
fabric exists so emulated hosts can also run self-contained (and as the
oracle for dual-target tests, SURVEY.md §4.8).
"""

from __future__ import annotations

from typing import Callable

from shadow_tpu_torch.host.host import CpuHost, TIME_MAX
from shadow_tpu_torch.host.sockets import NetPacket


class CpuNetwork:
    def __init__(
        self,
        hosts: list[CpuHost],
        latency_ns: Callable[[int, int], int],
        loss: Callable[[int, int], float] | None = None,
        names: dict[str, str] | None = None,
        workers: int = 1,
        scheduler: str = "steal",  # "steal" | "per-host" (thread_per_host.rs)
        pin_cpus: list[int] | None = None,
    ):
        self.hosts = hosts
        self.by_ip = {h.ip: h for h in hosts}
        self.latency_ns = latency_ns
        self.loss = loss or (lambda s, d: 0.0)
        self.min_latency = (
            min(
                latency_ns(a.host_id, b.host_id)
                for a in hosts
                for b in hosts
                if a is not b
            )
            if len(hosts) > 1
            else 1_000_000
        )
        names = names or {h.name: h.ip for h in hosts}
        rev = {ip: name for name, ip in names.items()}
        for h in hosts:
            h.egress = self._egress
            h.resolver = names.get
            h.rev_resolver = rev.get
        # parallel host execution (reference thread_per_core.rs:25-210):
        # hosts share nothing inside a window, so N pool threads can run
        # them concurrently. Cross-host deliveries are STAGED per source and
        # merged after the window in host-id order — conservative lookahead
        # guarantees every arrival lands >= window_end, so staging changes
        # nothing observable and keeps the merge order deterministic.
        # (CPython's GIL serializes pure-Python hosts; the win is native
        # hosts, whose service loops block in futex waits outside the GIL.)
        self.workers = max(1, workers)
        self._staged: list[list] = [[] for _ in hosts]
        self._pool = None
        if scheduler not in ("steal", "per-host"):
            raise ValueError(
                f"scheduler must be steal|per-host, got {scheduler!r}"
            )
        if self.workers > 1 or scheduler == "per-host":
            from shadow_tpu_torch.host.scheduler import make_pool

            self._pool = make_pool(scheduler, self.workers, pin_cpus)
        # per-source counters summed on read: parallel sources must not race
        # on shared ints
        self._dropped = [0] * len(hosts)
        self._relayed = [0] * len(hosts)

    @property
    def pkts_dropped(self) -> int:
        return sum(self._dropped)

    @property
    def pkts_relayed(self) -> int:
        return sum(self._relayed)

    def _egress(self, src: CpuHost, pkt: NetPacket):
        dst = self.by_ip.get(pkt.dst_ip)
        if dst is None:
            # unreachable: dropped (reference counts + drops too)
            src.drop_packet(pkt, "inet_no_route")
            return
        lat = self.latency_ns(src.host_id, dst.host_id)
        p = self.loss(src.host_id, dst.host_id)
        # loss drawn from the source host's RNG (worker.rs:374-390)
        if p > 0.0 and src.rng.random() < p:
            self._dropped[src.host_id] += 1
            src.drop_packet(pkt, "inet_loss_draw")
            return
        self._relayed[src.host_id] += 1
        pkt.crumb(src.now(), "inet_relayed")
        self._staged[src.host_id].append((src.now() + lat, dst, pkt))

    def _flush_staged(self):
        """Deliver staged packets in source-host-id order (the reference
        pushes into each dst's mutex'd queue; here the post-window merge
        IS the deterministic ordering point, worker.rs:644-654)."""
        for buf in self._staged:
            for t, dst, pkt in buf:
                dst.schedule(t, _mk_delivery(dst, pkt))
            buf.clear()

    def _execute_all(self, until: int):
        if self._pool is not None:
            # run() joins: every host finishes before the staged merge
            self._pool.run(self.hosts, lambda h: h.execute(until))
        else:
            for h in self.hosts:  # deterministic host order
                h.execute(until)
        self._flush_staged()

    # ---- conservative round loop ------------------------------------------

    def run(self, stop_ns: int, *, runahead_ns: int | None = None) -> int:
        """Advance all hosts to stop_ns in lookahead-bounded rounds.
        Returns the number of rounds executed."""
        runahead = max(runahead_ns or self.min_latency, 1)
        rounds = 0
        while True:
            nxt = min(h.next_event_time() for h in self.hosts)
            if nxt >= stop_ns:
                break
            window_end = min(nxt + runahead, stop_ns)
            self._execute_all(window_end)
            rounds += 1
        self._execute_all(stop_ns)
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        return rounds


def _mk_delivery(dst: CpuHost, pkt: NetPacket):
    return lambda: dst.deliver_packet(pkt)
