"""timerfd(2) emulation (reference `host/descriptor/timerfd.rs`, 294 LoC,
over the host Timer; expiration bumps a counter read as 8 bytes)."""

from __future__ import annotations

from typing import Protocol

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState


class Scheduler(Protocol):
    """What a TimerFd needs from its host: the simulated clock and one-shot
    task scheduling (reference Host::schedule_task_at_emulated_time)."""

    def now(self) -> int: ...
    def schedule(self, t_ns: int, fn) -> object: ...
    def cancel(self, token: object) -> None: ...


class TimerFd(File):
    def __init__(self, sched: Scheduler):
        super().__init__()
        self.sched = sched
        self.expirations = 0
        self.deadline: int | None = None  # absolute ns
        self.interval: int = 0  # 0 = one-shot
        self._token: object | None = None

    # ---- timerfd_settime / gettime ----------------------------------------

    def settime(self, deadline_ns: int | None, interval_ns: int = 0) -> tuple[int, int]:
        """Arm (absolute deadline) or disarm (None). Returns previous
        (remaining_ns, interval_ns) like timerfd_settime's old_value."""
        old = self.gettime()
        if self._token is not None:
            self.sched.cancel(self._token)
            self._token = None
        self.expirations = 0
        self._set_state(off=FileState.READABLE)
        self.deadline = deadline_ns
        self.interval = interval_ns
        if deadline_ns is not None:
            self._token = self.sched.schedule(deadline_ns, self._fire)
        return old

    def gettime(self) -> tuple[int, int]:
        if self.deadline is None:
            return (0, self.interval)
        return (max(0, self.deadline - self.sched.now()), self.interval)

    def _fire(self):
        self.expirations += 1
        self._set_state(on=FileState.READABLE)
        if self.interval > 0:
            self.deadline = self.sched.now() + self.interval
            self._token = self.sched.schedule(self.deadline, self._fire)
        else:
            self.deadline = None
            self._token = None

    # ---- file surface ------------------------------------------------------

    def read(self, n: int) -> bytes | None:
        if n < 8:
            raise OSError("EINVAL: timerfd reads need 8 bytes")
        if self.expirations == 0:
            return None  # would block
        val = self.expirations
        self.expirations = 0
        self._set_state(off=FileState.READABLE)
        return val.to_bytes(8, "little")

    def close(self):
        if self._token is not None:
            self.sched.cancel(self._token)
            self._token = None
        super().close()
