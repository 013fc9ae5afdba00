"""Pipes over a shared byte buffer + the shared stream-end base.

Reference: `host/descriptor/pipe.rs` (475 LoC) on top of
`shared_buf.rs` — reader and writer ends share one bounded buffer; state
bits flip as it fills/drains; closing the peer end raises HUP/EPIPE.
`StreamEnd` is the generic (rx?, tx?) half over `_SharedBuf`s, reused by
unix-domain stream sockets (`host/unix.py`), which are exactly a crossed
pair of these buffers in the reference too.
"""

from __future__ import annotations

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState

PIPE_BUF_SIZE = 65536  # Linux default pipe capacity


class _SharedBuf:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data = bytearray()
        self.readers = 0
        self.writers = 0

    def space(self) -> int:
        return self.capacity - len(self.data)


class StreamEnd(File):
    """One endpoint with an optional read buffer and optional write buffer.

    Subclasses set `_rx` (we read from it) and/or `_tx` (we write into it)
    plus `peer` for cross-end state refresh. `_err_on_peer_close` controls
    whether a dead reader marks the writer with ERROR (pipes do: EPIPE is
    an error condition; unix sockets report plain HUP like Linux)."""

    _err_on_peer_close = False

    def __init__(self):
        super().__init__()
        self._rx: _SharedBuf | None = None
        self._tx: _SharedBuf | None = None
        self.peer: "StreamEnd | None" = None

    # ---- state -------------------------------------------------------------

    def _sync(self):
        if self.closed:
            return
        on = FileState.NONE
        off = FileState.NONE
        if self._rx is not None:
            if len(self._rx.data) > 0:
                on |= FileState.READABLE
            else:
                off |= FileState.READABLE
            if self._rx.writers == 0:
                on |= FileState.HUP | FileState.READABLE  # EOF is readable
        if self._tx is not None:
            if self._tx.readers == 0:
                on |= FileState.HUP
                if self._err_on_peer_close:
                    on |= FileState.ERROR
                off |= FileState.WRITABLE
            elif self._tx.space() >= self._writable_min():
                on |= FileState.WRITABLE
            else:
                off |= FileState.WRITABLE
        # `on` wins over `off` (EOF marks an empty buffer readable)
        self._set_state(on=on, off=off & ~on)

    def _writable_min(self) -> int:
        """Free space needed before WRITABLE is raised. Streams: any byte.
        Pipes override to PIPE_BUF — pipe(7)'s POLLOUT contract — which is
        also what re-wakes a writer parked on an atomic small write."""
        return 1

    def _sync_both(self):
        self._sync()
        if self.peer is not None:
            self.peer._sync()

    # ---- I/O ---------------------------------------------------------------

    def read(self, n: int) -> bytes | None:
        if self._rx is None:
            raise OSError("EBADF: not readable")
        if self._rx.data:
            out = bytes(self._rx.data[:n])
            del self._rx.data[: len(out)]
            self._sync_both()
            return out
        if self._rx.writers == 0:
            return b""  # EOF
        return None  # would block

    def peek(self, n: int) -> bytes | None:
        """MSG_PEEK: same result contract as read() without consuming."""
        if self._rx is None:
            raise OSError("EBADF: not readable")
        if self._rx.data:
            return bytes(self._rx.data[:n])
        if self._rx.writers == 0:
            return b""  # EOF
        return None  # would block

    def write(self, data: bytes) -> int | None:
        if self._tx is None:
            raise OSError("EBADF: not writable")
        if self._tx.readers == 0:
            raise BrokenPipeError("EPIPE: no readers")
        space = self._tx.space()
        if space == 0:
            return None  # would block
        took = bytes(data[:space])
        self._tx.data += took
        self._sync_both()
        return len(took)

    def shutdown_write(self):
        """Half-close the write direction (unix SHUT_WR; pipes via close)."""
        if self._tx is not None:
            self._tx.writers -= 1
            self._tx = None
            self._sync_both()

    def close(self):
        if self.closed:
            return
        if self._tx is not None:
            self._tx.writers -= 1
            self._tx = None
        if self._rx is not None:
            self._rx.readers -= 1
            self._rx = None
        peer = self.peer
        super().close()
        if peer is not None:
            peer._sync()


class PipeEnd(StreamEnd):
    _err_on_peer_close = True  # EPIPE surfaces as ERROR on the write end

    PIPE_BUF = 4096  # pipe(7): writes <= PIPE_BUF are atomic

    def __init__(self, buf: _SharedBuf, writable: bool):
        super().__init__()
        self.is_writer = writable
        if writable:
            self._tx = buf
            buf.writers += 1
            self._set_state(on=FileState.WRITABLE)
        else:
            self._rx = buf
            buf.readers += 1

    def _writable_min(self) -> int:
        if self._tx is None:
            return 1
        return min(self.PIPE_BUF, self._tx.capacity)

    def write(self, data: bytes) -> int | None:
        if (
            self._tx is not None
            and self._tx.readers != 0
            and len(data) <= min(self.PIPE_BUF, self._tx.capacity)
            and self._tx.space() < len(data)
        ):
            # atomicity: a small write must land whole or not at all —
            # the kernel never tears records <= PIPE_BUF across
            # interleaved writers (O_NONBLOCK gets EAGAIN, blockers wait)
            return None
        return super().write(data)


Pipe = PipeEnd  # exported name


def create_pipe(capacity: int = PIPE_BUF_SIZE) -> tuple[PipeEnd, PipeEnd]:
    """Returns (read_end, write_end) like pipe(2)."""
    buf = _SharedBuf(capacity)
    r = PipeEnd(buf, writable=False)
    w = PipeEnd(buf, writable=True)
    r.peer = w
    w.peer = r
    return r, w
