"""epoll(7) emulation.

Reference: `host/descriptor/epoll.rs` wrapper + `epoll.c` (775 LoC): an
interest list of watched files, a ready set maintained by status listeners,
level- and edge-triggered modes, and the epoll fd itself being pollable
(readable when the ready set is non-empty) so epolls nest.
"""

from __future__ import annotations

from dataclasses import dataclass

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState, StatusListener

EPOLLIN = 0x001
EPOLLOUT = 0x004
EPOLLERR = 0x008
EPOLLHUP = 0x010
EPOLLET = 1 << 31


def _interest_to_state(events: int) -> FileState:
    s = FileState.ERROR | FileState.HUP | FileState.CLOSED  # always reported
    if events & EPOLLIN:
        s |= FileState.READABLE | FileState.ACCEPTABLE
    if events & EPOLLOUT:
        s |= FileState.WRITABLE
    return s


def _state_to_events(state: FileState, interest: int) -> int:
    ev = 0
    if state & (FileState.READABLE | FileState.ACCEPTABLE) and interest & EPOLLIN:
        ev |= EPOLLIN
    if state & FileState.WRITABLE and interest & EPOLLOUT:
        ev |= EPOLLOUT
    if state & FileState.ERROR:
        ev |= EPOLLERR
    if state & (FileState.HUP | FileState.CLOSED):
        ev |= EPOLLHUP
    return ev


@dataclass
class EpollEvent:
    fd: int
    events: int
    data: int  # epoll_data (opaque u64)


class _Watch:
    def __init__(self, epoll: "Epoll", fd: int, file: File, events: int, data: int):
        self.epoll = epoll
        self.fd = fd
        self.file = file
        self.events = events
        self.data = data
        self.ready_events = 0  # edge-trigger: armed on transitions
        self.listener = StatusListener(
            _interest_to_state(events), self._on_change, level=True
        )
        file.add_listener(self.listener)

    def _on_change(self, state: FileState, changed: FileState):
        if state & FileState.CLOSED:
            # Linux removes a file from every epoll interest list when its
            # last fd closes — no event is delivered for the closed file.
            # (Deferred callbacks may fire after an explicit remove/close,
            # hence the membership check.)
            if self.epoll._watches.get(self.fd) is self:
                self.epoll.remove(self.fd)
            return
        ev = _state_to_events(state, self.events)
        if ev:
            self.ready_events |= ev
            self.epoll._mark_ready(self)
        elif not (self.events & EPOLLET):
            self.ready_events = 0
            self.epoll._mark_unready(self)


class Epoll(File):
    def __init__(self):
        super().__init__()
        self._watches: dict[int, _Watch] = {}
        self._ready: dict[int, _Watch] = {}  # insertion-ordered ready "set"

    # ---- epoll_ctl ---------------------------------------------------------

    def add(self, fd: int, file: File, events: int, data: int | None = None):
        if fd in self._watches:
            raise OSError("EEXIST")
        w = _Watch(self, fd, file, events, data if data is not None else fd)
        self._watches[fd] = w
        self._refresh(w)

    def modify(self, fd: int, events: int, data: int | None = None):
        w = self._watches.get(fd)
        if w is None:
            raise OSError("ENOENT")
        w.events = events
        if data is not None:
            w.data = data
        w.listener.interest = _interest_to_state(events)
        w.ready_events = 0
        self._mark_unready(w)
        self._refresh(w)

    def remove(self, fd: int):
        w = self._watches.pop(fd, None)
        if w is None:
            raise OSError("ENOENT")
        w.file.remove_listener(w.listener)
        self._mark_unready(w)

    def _refresh(self, w: _Watch):
        ev = _state_to_events(w.file.state, w.events)
        if ev:
            w.ready_events |= ev
            self._mark_ready(w)

    # ---- ready tracking ----------------------------------------------------

    def _mark_ready(self, w: _Watch):
        self._ready.setdefault(w.fd, w)
        self._set_state(on=FileState.READABLE)

    def _mark_unready(self, w: _Watch):
        self._ready.pop(w.fd, None)
        if not self._ready:
            self._set_state(off=FileState.READABLE)

    # ---- epoll_wait --------------------------------------------------------

    def wait(self, max_events: int) -> list[EpollEvent] | None:
        """Collect ready events; None = would block (no ready fds)."""
        out: list[EpollEvent] = []
        for fd in list(self._ready):
            if len(out) >= max_events:
                break
            w = self._ready[fd]
            if w.events & EPOLLET:
                ev = w.ready_events  # consume the edge
                w.ready_events = 0
                self._mark_unready(w)
            else:
                ev = _state_to_events(w.file.state, w.events)
                if not ev:
                    self._mark_unready(w)
                    continue
            out.append(EpollEvent(fd=w.fd, events=ev, data=w.data))
        if not out:
            return None
        return out

    def close(self):
        for fd in list(self._watches):
            self.remove(fd)
        super().close()
