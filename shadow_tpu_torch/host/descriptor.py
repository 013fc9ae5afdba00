"""File objects and the per-process descriptor table.

Reference: `host/descriptor/mod.rs` (File enum + state), `descriptor.c`,
and `descriptor_table.rs` (fd allocation, dup, close-on-exec). Files here
are plain Python objects with a state bitmask and listener list; every
state mutation goes through `_set_state` which defers notifications via the
active `CallbackQueue`.
"""

from __future__ import annotations

from shadow_tpu_torch.host.filestate import CallbackQueue, FileState, StatusListener


class File:
    """Base of everything a descriptor can point at."""

    def __init__(self):
        self.state = FileState.ACTIVE
        self._listeners: list[StatusListener] = []

    # ---- state & listeners -------------------------------------------------

    def add_listener(self, listener: StatusListener):
        self._listeners.append(listener)
        if listener.level and listener.wants(self.state, FileState.NONE):
            q = CallbackQueue.current()
            st = self.state
            if q is not None:
                q.push(lambda: listener.callback(st, FileState.NONE))
            else:
                listener.callback(st, FileState.NONE)

    def remove_listener(self, listener: StatusListener):
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def _set_state(self, on: FileState = FileState.NONE, off: FileState = FileState.NONE):
        new = (self.state | on) & ~off
        changed = new ^ self.state
        if not changed:
            return
        self.state = new
        snapshot = list(self._listeners)
        q = CallbackQueue.current()
        for lst in snapshot:
            if lst.wants(new, FileState(changed)):
                if q is not None:
                    q.push(
                        lambda l=lst, s=new, c=FileState(changed): l.callback(s, c)
                    )
                else:
                    lst.callback(new, FileState(changed))

    # ---- lifecycle ---------------------------------------------------------

    def close(self):
        if self.state & FileState.CLOSED:
            return
        self._set_state(on=FileState.CLOSED, off=FileState.ACTIVE)

    @property
    def closed(self) -> bool:
        return bool(self.state & FileState.CLOSED)

    # default I/O surface: subclasses override what they support
    def read(self, n: int) -> bytes | None:  # None = would block
        raise OSError("not readable")

    def write(self, data: bytes) -> int | None:
        raise OSError("not writable")


class Descriptor:
    """An fd-table slot: file reference + per-descriptor flags (CLOEXEC)."""

    def __init__(self, file: File, cloexec: bool = False):
        self.file = file
        self.cloexec = cloexec


class DescriptorTable:
    """Per-process fd table (reference descriptor_table.rs: lowest-free fd
    allocation, dup to explicit slots, bulk close on exit)."""

    def __init__(self, max_fds: int = 1024):
        self.max_fds = max_fds
        self._slots: dict[int, Descriptor] = {}
        self._next_probe = 0

    def register(self, file: File, *, min_fd: int = 0) -> int:
        fd = min_fd
        while fd in self._slots:
            fd += 1
        if fd >= self.max_fds:
            raise OSError("EMFILE: descriptor table full")
        self._slots[fd] = Descriptor(file)
        return fd

    def register_at(self, fd: int, file: File):
        if fd < 0 or fd >= self.max_fds:
            raise OSError("EBADF: fd out of range")
        self._slots[fd] = Descriptor(file)

    def get(self, fd: int) -> File:
        d = self._slots.get(fd)
        if d is None:
            raise OSError(f"EBADF: fd {fd} not open")
        return d.file

    def dup(self, fd: int, min_fd: int = 0) -> int:
        file = self.get(fd)
        return self.register(file, min_fd=min_fd)

    def dup2(self, old: int, new: int) -> int:
        file = self.get(old)
        if old == new:
            return new
        if new in self._slots:
            self.close(new)
        self.register_at(new, file)
        return new

    def close(self, fd: int):
        d = self._slots.pop(fd, None)
        if d is None:
            raise OSError(f"EBADF: fd {fd} not open")
        # last reference in this table closes the file if no other slot holds it
        if not any(s.file is d.file for s in self._slots.values()):
            d.file.close()

    def close_all(self):
        for fd in sorted(self._slots):
            try:
                self.close(fd)
            except OSError:
                pass

    def fds(self) -> list[int]:
        return sorted(self._slots)
