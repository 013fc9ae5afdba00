"""Unix-domain stream sockets + socketpair.

Reference: `host/descriptor/socket/unix/` (2419 LoC — connection-oriented
unix sockets over shared buffers, plus the abstract-name namespace in
`socket/abstract_unix_ns.rs`). A connected unix stream socket is a crossed
pair of bounded byte buffers — the generic `StreamEnd` from
`host/pipe.py` provides the whole stream I/O surface; this module adds
connection setup (pair/bind/listen/connect/accept) and the abstract
namespace.
"""

from __future__ import annotations

from shadow_tpu_torch.host.descriptor import File
from shadow_tpu_torch.host.filestate import FileState
from shadow_tpu_torch.host.pipe import StreamEnd, _SharedBuf

UNIX_BUF = 212992  # Linux default unix-socket buffer


def _drop_ref(obj):
    """Refcounted release of an in-flight SCM_RIGHTS object (mirrors the
    native plane's _drop_vfd: fork-shared descriptors die with their last
    holder; an unclaimed passed fd is one dropped reference)."""
    refs = getattr(obj, "_nrefs", 1)
    if refs > 1:
        obj._nrefs = refs - 1
    else:
        obj.close()


class UnixStreamSocket(StreamEnd):
    """One end of a connected unix stream pair (or a listener)."""

    def __init__(self):
        super().__init__()
        # listener state (bound to an abstract name)
        self.listening = False
        self.bound_name: str | None = None
        self.peer_name: str | None = None  # the address connect()ed to
        self._accept_q: list["UnixStreamSocket"] = []
        self._ns: dict | None = None  # abstract namespace (host-owned)
        # SCM_RIGHTS in transit to THIS end (reference socket/unix.rs
        # ancillary support): one entry per sendmsg that carried fds.
        # Divergence from the kernel: entries are not pinned to byte
        # positions in the stream — a recvmsg claims the oldest entry.
        self.anc_rx: list[list] = []

    @property
    def connected(self) -> bool:
        return self._rx is not None or self._tx is not None

    # ---- connection setup --------------------------------------------------

    @staticmethod
    def make_pair() -> tuple["UnixStreamSocket", "UnixStreamSocket"]:
        """socketpair(2): two connected ends."""
        a, b = UnixStreamSocket(), UnixStreamSocket()
        ab, ba = _SharedBuf(UNIX_BUF), _SharedBuf(UNIX_BUF)
        for buf in (ab, ba):
            buf.readers = buf.writers = 1
        a._tx, a._rx = ab, ba
        b._tx, b._rx = ba, ab
        a.peer, b.peer = b, a
        a._set_state(on=FileState.WRITABLE)
        b._set_state(on=FileState.WRITABLE)
        return a, b

    def bind_abstract(self, ns: dict, name: str):
        if name in ns:
            raise OSError(f"EADDRINUSE: @{name}")
        ns[name] = self
        self._ns = ns
        self.bound_name = name

    def listen(self):
        if self.bound_name is None:
            raise OSError("EINVAL: listen before bind")
        self.listening = True

    def connect_to(self, listener: "UnixStreamSocket") -> None:
        """Connect to a listening socket: forks a server-side end into the
        listener's accept queue (unix connects are immediate — no network
        latency — same as the reference)."""
        if self.connected:
            raise OSError("EISCONN: already connected")
        if not listener.listening:
            raise OSError("ECONNREFUSED")
        server_end, client_end = UnixStreamSocket.make_pair()
        # graft the client_end's plumbing into *this* socket
        self._tx, self._rx = client_end._tx, client_end._rx
        self.peer = server_end
        server_end.peer = self
        # getpeername: the client's peer is the LISTENER's address; the
        # accepted server end's peer (this client) is unnamed
        self.peer_name = listener.bound_name
        server_end.bound_name = listener.bound_name
        self._set_state(on=FileState.WRITABLE)
        listener._accept_q.append(server_end)
        listener._set_state(on=FileState.ACCEPTABLE | FileState.READABLE)

    def accept(self) -> "UnixStreamSocket | None":
        if not self._accept_q:
            return None
        child = self._accept_q.pop(0)
        if not self._accept_q:
            self._set_state(off=FileState.ACCEPTABLE | FileState.READABLE)
        return child

    # ---- I/O: StreamEnd provides read/write/shutdown_write/_sync ----------

    def read(self, n: int):
        if not self.connected and not self.listening:
            raise OSError("ENOTCONN")
        return super().read(n)

    def write(self, data: bytes):
        if not self.connected:
            raise OSError("ENOTCONN")
        return super().write(data)

    def close(self):
        if self.closed:
            return
        if self.bound_name is not None and self._ns is not None:
            self._ns.pop(self.bound_name, None)
        for child in self._accept_q:
            child.close()
        self._accept_q.clear()
        for ent in self.anc_rx:  # unclaimed passed fds die with the socket
            for obj in ent:
                _drop_ref(obj)
        self.anc_rx.clear()
        super().close()


UNIX_DGRAM_QUEUE = 512  # datagrams buffered per receiving socket


class UnixDgramSocket(File):
    """Unix-domain DATAGRAM socket: message boundaries preserved, sendto by
    bound name or connected peer (glibc syslog()'s /dev/log transport;
    reference socket/unix.rs dgram support). Delivery is immediate and
    reliable within a host; a full receive queue rejects the send with
    ENOBUFS (the kernel blocks or drops depending on flags — rejecting
    loudly keeps the plane deterministic)."""

    def __init__(self):
        super().__init__()
        self.bound_name: str | None = None
        self.peer_name: str | None = None
        self._ns: dict | None = None
        # (src name or "", data, SCM_RIGHTS objects or None) — rights ride
        # WITH their datagram (kernel semantics for dgram ancillary)
        self._rcv: list[tuple[str, bytes, list | None]] = []
        self._pending_rights: list | None = None  # set by sendmsg
        self.last_rights: list | None = None  # popped with the last recv
        self._set_state(on=FileState.WRITABLE)

    @staticmethod
    def make_pair() -> tuple["UnixDgramSocket", "UnixDgramSocket"]:
        a, b = UnixDgramSocket(), UnixDgramSocket()
        a.peer, b.peer = b, a
        return a, b

    peer: "UnixDgramSocket | None" = None

    def bind_abstract(self, ns: dict, name: str):
        if name in ns:
            raise OSError(f"EADDRINUSE: @{name}")
        ns[name] = self
        self._ns = ns
        self.bound_name = name

    def connect_name(self, ns: dict, name: str):
        if name not in ns or not isinstance(ns[name], UnixDgramSocket):
            raise OSError("ECONNREFUSED")
        self.peer_name = name
        self._ns = ns if self._ns is None else self._ns

    def _deliver(self, src_name: str, data: bytes,
                 rights: list | None = None) -> None:
        if len(self._rcv) >= UNIX_DGRAM_QUEUE:
            if rights:
                for obj in rights:
                    _drop_ref(obj)
            raise OSError("ENOBUFS: receive queue full")
        self._rcv.append((src_name, data, rights))
        self._set_state(on=FileState.READABLE)

    def send_to(self, ns: dict, name: str | None, data: bytes) -> int:
        """sendto: explicit name wins; otherwise the connected peer (by
        name) or the socketpair peer object."""
        rights, self._pending_rights = self._pending_rights, None
        target = None
        if name is not None:
            target = ns.get(name)
        elif self.peer_name is not None:
            target = ns.get(self.peer_name)
        elif self.peer is not None and not self.peer.closed:
            target = self.peer
        if not isinstance(target, UnixDgramSocket) or target.closed:
            if rights:
                for obj in rights:
                    _drop_ref(obj)
            raise OSError("ECONNREFUSED")
        target._deliver(self.bound_name or "", bytes(data), rights)
        return len(data)

    def recv_from(self, n: int) -> tuple[bytes, str] | None:
        if not self._rcv:
            return None
        src, data, rights = self._rcv.pop(0)
        if self.last_rights:  # previous receive's rights went unclaimed
            for obj in self.last_rights:
                _drop_ref(obj)
        self.last_rights = rights
        if not self._rcv:
            self._set_state(off=FileState.READABLE)
        return data[:n], src  # short buffer truncates, like SOCK_DGRAM

    def claim_rights(self) -> list | None:
        """recvmsg collects the rights attached to the datagram just
        popped; any other receive path leaves them to be dropped on the
        next pop (read(2)/recvfrom(2) discard ancillary, like the kernel)."""
        r, self.last_rights = self.last_rights, None
        return r

    def read(self, n: int) -> bytes | None:
        r = self.recv_from(n)
        return None if r is None else r[0]

    def peek(self, n: int) -> bytes | None:
        if not self._rcv:
            return None
        return self._rcv[0][1][:n]

    def write(self, data: bytes) -> int:
        return self.send_to(self._ns or {}, None, data)

    def close(self):
        if self.bound_name is not None and self._ns is not None:
            self._ns.pop(self.bound_name, None)
        for _, _, rights in self._rcv:
            if rights:
                for obj in rights:
                    _drop_ref(obj)
        self._rcv.clear()
        if self.last_rights:
            for obj in self.last_rights:
                _drop_ref(obj)
            self.last_rights = None
        super().close()
