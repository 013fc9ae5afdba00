"""eventfd(2) emulation (reference `host/descriptor/eventfd.rs`, 281 LoC)."""

from __future__ import annotations

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState

_MAX = (1 << 64) - 1


class EventFd(File):
    def __init__(self, initval: int = 0, semaphore: bool = False):
        super().__init__()
        self.count = initval
        self.semaphore = semaphore
        self._sync()

    def _sync(self):
        on = FileState.NONE
        off = FileState.NONE
        if self.count > 0:
            on |= FileState.READABLE
        else:
            off |= FileState.READABLE
        if self.count < _MAX - 1:
            on |= FileState.WRITABLE
        else:
            off |= FileState.WRITABLE
        self._set_state(on=on, off=off)

    def read(self, n: int) -> bytes | None:
        if n < 8:
            raise OSError("EINVAL: eventfd reads need 8 bytes")
        if self.count == 0:
            return None  # would block
        val = 1 if self.semaphore else self.count
        self.count -= val
        # pulse WRITABLE so a writer blocked on an overflowing add (whose
        # write would now fit) sees a transition and retries — the bit alone
        # can stay set across the whole episode
        self._set_state(off=FileState.WRITABLE)
        self._sync()
        return val.to_bytes(8, "little")

    def write(self, data: bytes) -> int | None:
        if len(data) < 8:
            raise OSError("EINVAL: eventfd writes need 8 bytes")
        add = int.from_bytes(data[:8], "little")
        if add == _MAX:
            raise OSError("EINVAL")
        if self.count + add > _MAX - 1:
            return None  # would block until read
        self.count += add
        self._sync()
        return 8
