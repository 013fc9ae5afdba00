"""File status bits, listeners, and the deferred callback queue.

Reference: `FileState` bitflags (`host/descriptor/mod.rs:111-140`),
`StatusListener` (`host/descriptor/listener.rs`), and `CallbackQueue`
(`utility/callback_queue.rs`) — the mechanism that breaks borrow cycles by
deferring "state changed" notifications until the triggering operation has
fully unwound. Here the queue plays the same role for Python re-entrancy:
listener callbacks never run inside the mutation that caused them.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable


class FileState(enum.IntFlag):
    NONE = 0
    ACTIVE = 1 << 0  # open and usable
    READABLE = 1 << 1
    WRITABLE = 1 << 2
    CLOSED = 1 << 3
    ERROR = 1 << 4
    HUP = 1 << 5  # peer closed (EPOLLHUP analogue)
    # listen sockets: a connection is ready to accept (maps to READABLE in
    # poll semantics, kept distinct for introspection like the reference's
    # socket-specific bits)
    ACCEPTABLE = 1 << 6
    CHILD_EVENT = 1 << 7  # process exit notification (pidfd-style)


class StatusListener:
    """Watches a file for transitions of selected state bits.

    `notify(state, changed)` fires when any watched bit changes (or, for
    level-listeners, is set). Identity-hashable so files can deregister."""

    def __init__(
        self,
        interest: FileState,
        callback: Callable[[FileState, FileState], None],
        *,
        level: bool = False,
    ):
        self.interest = interest
        self.callback = callback
        self.level = level  # fire on "set" even without a transition

    def wants(self, state: FileState, changed: FileState) -> bool:
        if self.level:
            return bool(state & self.interest)
        return bool(changed & self.interest)


class CallbackQueue:
    """Deferred-callback runner. Mutations enqueue listener notifications;
    the outermost caller drains. `CallbackQueue.run(fn)` is the reference's
    `CallbackQueue::queue_and_run` entry point."""

    # PER-THREAD active queue: the parallel host plane runs hosts on pool
    # threads and hosts share nothing inside a window — a class-global here
    # would let thread A drain host B's callbacks mid-mutation (and clear
    # the queue under B's feet). threading.local restores the invariant.
    _tls = threading.local()

    def __init__(self):
        self._q: list[Callable[[], None]] = []

    def push(self, cb: Callable[[], None]):
        self._q.append(cb)

    def drain(self):
        while self._q:
            self._q.pop(0)()

    @classmethod
    def current(cls) -> "CallbackQueue | None":
        return getattr(cls._tls, "active", None)

    @classmethod
    def run(cls, fn: Callable[["CallbackQueue"], object]):
        """Run fn with an active queue, draining afterwards. Nested calls
        reuse the outer queue (callbacks still run only at the outermost
        unwind, preserving no-reentrancy)."""
        active = getattr(cls._tls, "active", None)
        if active is not None:
            return fn(active)
        q = cls()
        cls._tls.active = q
        try:
            out = fn(q)
            q.drain()
            return out
        finally:
            cls._tls.active = None
