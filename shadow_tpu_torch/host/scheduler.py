"""Work-stealing host scheduler for the CPU host plane.

Reference: `src/lib/scheduler/src/thread_per_core.rs:25-210` — N worker
threads, hosts round-robined into per-thread queues, and an idle worker
STEALS from the other threads' queues by cycling them (`:192-210`). The
reference credits its custom pools with >10x over a naive task-per-host
pool (`scheduler/src/lib.rs:8-11`).

Python recast: persistent threads parked on a condition variable between
rounds (the reference's latch pair), per-worker `deque`s, owner pops from
the head and thieves from the tail (Chase-Lev shape; the GIL makes the
individual deque ops atomic). Determinism does not depend on execution
order at all: hosts share nothing inside a window and cross-host sends
are staged per SOURCE and merged in host-id order after the round
(CpuNetwork._flush_staged / HybridSimulation._flush_stage_buf), so the
steal schedule cannot reorder anything observable — asserted by the
serial-vs-parallel byte-compare gate in tests/test_scheduler_pool.py.

GIL caveat (same as the prior plain pool): pure-Python hosts serialize;
the win is hosts whose managed processes block in futex waits off-GIL.
Stealing fixes the SKEW problem the round-robin split has there: one
busy host no longer pins its whole queue behind it.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable

from shadow_tpu_torch.host import affinity


class WorkStealingPool:
    def __init__(self, workers: int, pin_cpus: list[int] | None = None):
        self.n = max(1, workers)
        self._pin_cpus = pin_cpus
        self._qs: list[deque] = [deque() for _ in range(self.n)]
        self._steals = [0] * self.n  # per-worker: no racy shared increment
        self._cv = threading.Condition()
        self._fn: Callable | None = None
        self._pending = 0
        self._round_id = 0
        self._error: BaseException | None = None
        self._shutdown = False
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,), daemon=True,
                name=f"host-worker-{i}",
            )
            for i in range(self.n)
        ]
        for t in self._threads:
            t.start()

    @property
    def steals(self) -> int:
        return sum(self._steals)

    def run(self, items, fn: Callable) -> None:
        """One scheduling round: `fn(item)` for every item, any worker.
        Raises the first exception any worker hit (matching the replaced
        ThreadPoolExecutor.map semantics — a raising host must surface,
        not hang the barrier)."""
        items = list(items)
        if not items:
            return
        with self._cv:
            # round-robin assignment (thread_per_core.rs:86-93); stealing
            # rebalances whatever this split gets wrong. Items are TAGGED
            # with the round id: a worker that lingers past the end of
            # round N (it decremented the last _pending, releasing run(),
            # but has not re-checked the round counter yet) would
            # otherwise pop round N+1's items and run them under round
            # N's closure — with a stale `until` horizon here.
            self._round_id += 1
            rid = self._round_id
            for i, it in enumerate(items):
                self._qs[i % self.n].append((rid, it))
            self._fn = fn
            self._pending = len(items)
            self._error = None
            self._cv.notify_all()
            while self._pending > 0:
                self._cv.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _worker(self, wid: int):
        if self._pin_cpus:
            affinity.pin_current(self._pin_cpus[wid % len(self._pin_cpus)])
        seen_round = 0
        while True:
            with self._cv:
                while self._round_id == seen_round and not self._shutdown:
                    self._cv.wait()
                if self._shutdown:
                    return
                seen_round = self._round_id
                fn = self._fn
            while True:
                tagged = None
                stolen_from = wid
                try:
                    tagged = self._qs[wid].popleft()  # own queue: head
                except IndexError:
                    # idle: cycle the other workers' queues and steal from
                    # the TAIL (thread_per_core.rs:192-210)
                    for k in range(1, self.n):
                        j = (wid + k) % self.n
                        try:
                            tagged = self._qs[j].pop()
                            stolen_from = j
                            break
                        except IndexError:
                            continue
                if tagged is None:
                    break  # round drained (items in flight finish elsewhere)
                rid, item = tagged
                if rid != seen_round:
                    # a NEWER round's item reached a stale worker: put it
                    # back and go (re)synchronize on the round counter
                    self._qs[stolen_from].append(tagged)
                    break
                if stolen_from != wid:
                    self._steals[wid] += 1
                try:
                    fn(item)
                except BaseException as e:  # noqa: BLE001 — must not hang
                    with self._cv:
                        if self._error is None:
                            self._error = e
                        self._pending -= 1
                        if self._pending <= 0:
                            self._cv.notify_all()
                    continue
                with self._cv:
                    self._pending -= 1
                    if self._pending <= 0:
                        self._cv.notify_all()

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)


class ThreadPerHostPool:
    """Thread-per-host scheduling policy (`thread_per_host.rs:25-60`).

    The reference spawns ONE OS thread per host, parks the host in that
    thread's TLS, and bounds how many run at once with a
    ParallelismBoundedThreadPool pinned over the logical processors. The
    payoff is that a host's state never migrates threads: thread-local
    caches, errno, and (here) any thread-affine guest state a managed
    process leans on stay put for the host's whole lifetime.

    Python recast: a dedicated worker thread is created the first time a
    host is scheduled (keyed by host object identity — NOT `host_id`,
    which collapses distinct hosts carrying a default/duplicate id onto
    one thread) and every subsequent round runs that host on the SAME
    thread — the
    TLS-stability guarantee, asserted by tests. A semaphore bounds
    concurrent execution to `parallelism` (the reference's bounded pool);
    blocked-in-futex native hosts release the GIL, so the bound governs
    genuine concurrency, not just thread count. Determinism is the same
    argument as WorkStealingPool: per-source staging merged in host-id
    order makes the execution schedule unobservable.
    """

    def __init__(self, parallelism: int, pin_cpus: list[int] | None = None):
        self.parallelism = max(1, parallelism)
        self._sem = threading.Semaphore(self.parallelism)
        # pinning follows the RUNNING slot, not the host thread: a host
        # thread that wins a semaphore slot takes a CPU from this free
        # list, pins, runs, and returns it — so the `parallelism` hosts
        # running at any instant occupy distinct CPUs (the reference pins
        # its bounded pool's N workers to N distinct LPs; pinning the
        # unbounded host threads round-robin would let two admitted hosts
        # share a CPU while assigned CPUs sit idle). deque append/popleft
        # are GIL-atomic.
        self._free_cpus: deque | None = (
            deque(pin_cpus[: self.parallelism]) if pin_cpus else None
        )
        # run() is single-caller (the window loop); _get_queue mutates
        # _workers/_threads without a lock on that contract
        self._workers: dict[object, queue.SimpleQueue] = {}
        self._threads: list[threading.Thread] = []
        self._cv = threading.Condition()
        self._pending = 0
        self._error: BaseException | None = None

    @property
    def thread_count(self) -> int:
        return len(self._threads)

    @staticmethod
    def _key(item) -> object:
        # object identity, NOT host_id: ids default to 0, and two
        # default-id hosts keyed by id would silently share one thread.
        # Host objects persist for the simulation, so id() is stable.
        return id(item)

    def _get_queue(self, item) -> queue.SimpleQueue:
        key = self._key(item)
        q = self._workers.get(key)
        if q is None:
            q = queue.SimpleQueue()
            self._workers[key] = q
            label = getattr(item, "host_id", None)
            t = threading.Thread(
                target=self._worker,
                args=(q,),
                daemon=True,
                name=f"host-{key if label is None else label}",
            )
            self._threads.append(t)
            t.start()
        return q

    def run(self, items, fn: Callable) -> None:
        items = list(items)
        if not items:
            return
        with self._cv:
            self._pending = len(items)
            self._error = None
        for it in items:
            self._get_queue(it).put((fn, it))
        with self._cv:
            while self._pending > 0:
                self._cv.wait()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _worker(self, q: queue.SimpleQueue):
        while True:
            task = q.get()
            if task is None:
                return
            fn, item = task
            with self._sem:
                cpu = None
                if self._free_cpus:
                    try:
                        cpu = self._free_cpus.popleft()
                        affinity.pin_current(cpu)
                    except IndexError:
                        cpu = None
                try:
                    fn(item)
                except BaseException as e:  # noqa: BLE001 — must not hang
                    with self._cv:
                        if self._error is None:
                            self._error = e
                finally:
                    if cpu is not None:
                        self._free_cpus.append(cpu)
                    with self._cv:
                        self._pending -= 1
                        if self._pending <= 0:
                            self._cv.notify_all()

    def shutdown(self):
        for q in self._workers.values():
            q.put(None)
        for t in self._threads:
            t.join(timeout=2)


def make_pool(
    scheduler: str, workers: int, pin_cpus: list[int] | None = None
):
    """The one scheduler-policy dispatch point (reference
    Scheduler::new, scheduler/src/lib.rs): "steal" = WorkStealingPool,
    "per-host" = ThreadPerHostPool; anything else raises."""
    if scheduler == "per-host":
        return ThreadPerHostPool(workers, pin_cpus)
    if scheduler == "steal":
        return WorkStealingPool(workers, pin_cpus)
    raise ValueError(
        f"host scheduler must be steal|per-host, got {scheduler!r}"
    )
