"""Managed programs: coroutine processes + the syscall dispatch layer.

Reference: `host/process.rs` + `host/thread.rs` (virtual pids/tids, blocked
`SyscallCondition`, resume re-runs the same syscall —
`thread.rs:471-511`), and the syscall handler dispatch
(`host/syscall/handler/mod.rs:371-539`). Programs here are Python
generators that `yield` syscall tuples — the sans-I/O equivalent of a
managed process trapping into the simulator; a blocked syscall parks the
process on a (file-state mask | timeout) trigger and is re-executed when
the condition fires, exactly the reference's blocking model
(`syscall_condition.c`).

A program:

    def client(ctx):
        fd = yield ("socket", "tcp")
        yield ("connect", fd, ("10.0.0.2", 80))
        n = yield ("send", fd, b"GET /")
        data = yield ("recv", fd, 4096)
        yield ("exit", 0)

`ctx` carries host identity and process args. The syscall surface covers the
core families the reference's test corpus exercises (SURVEY.md §4.2):
sockets, pipes, epoll, eventfd, timerfd, time, sleep, random, dup, stdio.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from shadow_tpu_torch.host.descriptor import DescriptorTable, File
from shadow_tpu_torch.host.epoll import Epoll
from shadow_tpu_torch.host.eventfd import EventFd
from shadow_tpu_torch.host.filestate import CallbackQueue, FileState, StatusListener
from shadow_tpu_torch.host.pipe import create_pipe
from shadow_tpu_torch.host.sockets import TcpListenerSocket, TcpSocket, UdpSocket
from shadow_tpu_torch.host.timerfd import TimerFd
from shadow_tpu_torch.host.unix import UnixStreamSocket

NS_PER_SEC = 1_000_000_000


@dataclass
class Syscall:
    name: str
    args: tuple

    @classmethod
    def of(cls, req) -> "Syscall":
        if isinstance(req, Syscall):
            return req
        if isinstance(req, tuple) and req and isinstance(req[0], str):
            return cls(req[0], tuple(req[1:]))
        raise TypeError(f"program yielded {req!r}; expected (name, *args)")


@dataclass
class Blocked:
    """Syscall result meaning: park until `file` shows `mask` bits (or the
    absolute-ns `timeout`). `on_timeout` is delivered as the syscall result
    if the timer fires first; otherwise the syscall is re-executed."""

    file: File | None = None
    mask: FileState = FileState.NONE
    timeout: int | None = None
    on_timeout: Any = None
    has_timeout_result: bool = False


class ProcState(enum.Enum):
    RUNNING = "running"
    BLOCKED = "blocked"
    ZOMBIE = "zombie"


_WAIT_READ = FileState.READABLE | FileState.HUP | FileState.ERROR | FileState.CLOSED
_WAIT_WRITE = FileState.WRITABLE | FileState.HUP | FileState.ERROR | FileState.CLOSED
_WAIT_ACCEPT = FileState.ACCEPTABLE | FileState.ERROR | FileState.CLOSED


@dataclass
class ProgramCtx:
    host_name: str
    ip: str
    pid: int
    args: dict


class Process:
    """One managed process (single-threaded; the reference's thread-group
    structure collapses to process==thread here, the common case)."""

    def __init__(self, host, pid: int, name: str, program, args: dict | None = None):
        self.host = host
        self.pid = pid
        self.name = name
        self.fds = DescriptorTable()
        self.state = ProcState.RUNNING
        self.exit_code: int | None = None
        self.stdout: list[bytes] = []
        self.stderr: list[bytes] = []
        self.ctx = ProgramCtx(host.name, host.ip, pid, args or {})
        self._gen: Iterator = program(self.ctx)
        self._send_value: Any = None
        self._current: Syscall | None = None
        self._wake_listener: tuple[File, StatusListener] | None = None
        self._wake_timer: object | None = None
        # strace hook (observability plane): fn(time_ns, pid, name, args, result)
        self.strace: Callable[[int, int, str, tuple, Any], None] | None = None

    # ---- lifecycle ---------------------------------------------------------

    def resume(self):
        """Run until the program blocks or exits (Thread::resume)."""
        CallbackQueue.run(lambda q: self._resume_inner())

    _unblocked_run = 0  # consecutive syscalls completed without blocking

    def _resume_inner(self):
        cfg = self.host.cfg
        while self.state == ProcState.RUNNING:
            if self._current is None:
                self._current = self._advance(self._send_value, None)
                if self._current is None:
                    return
                self._send_value = None
            if (
                cfg.model_unblocked_latency
                and self._unblocked_run >= cfg.unblocked_syscall_limit
            ):
                # charge CPU latency: park, then re-run this same syscall
                self._unblocked_run = 0
                self._block(
                    Blocked(timeout=self.host.now() + cfg.unblocked_syscall_latency_ns)
                )
                return
            try:
                res = self.host.syscalls.execute(self, self._current)
            except OSError as e:
                # errno surfaces in the program as a raised exception; it
                # still counts toward the unblocked-syscall charge (an
                # error-polling retry loop is exactly the busy loop the
                # latency model exists to escape)
                self._unblocked_run += 1
                if self.strace is not None:
                    self.strace(
                        self.host.now(), self.pid, self._current.name,
                        self._current.args, e,
                    )
                self._current = self._advance(None, e)
                continue
            if isinstance(res, Blocked):
                self._unblocked_run = 0
                self._block(res)
                return
            self._unblocked_run += 1
            if self.strace is not None:
                self.strace(
                    self.host.now(), self.pid, self._current.name,
                    self._current.args, res,
                )
            if self._current.name == "exit":
                return
            self._current = None
            self._send_value = res

    def _advance(self, value, exc) -> Syscall | None:
        """Step the generator; returns the next syscall or None if exited."""
        try:
            req = self._gen.throw(exc) if exc is not None else self._gen.send(value)
        except StopIteration:
            self._exit(0)
            return None
        except OSError as e:
            self.stderr.append(f"uncaught: {e!r}\n".encode())
            self._exit(1)
            return None
        except Exception as e:
            self.stderr.append(f"uncaught: {e!r}\n".encode())
            self._exit(1)
            return None
        return Syscall.of(req)

    def _block(self, b: Blocked):
        self.state = ProcState.BLOCKED
        if b.file is not None:
            listener = StatusListener(b.mask, lambda s, c: self._wake(None))
            b.file.add_listener(listener)
            self._wake_listener = (b.file, listener)
        if b.timeout is not None:
            result = b.on_timeout if b.has_timeout_result else None
            self._wake_timer = self.host.schedule(
                b.timeout, lambda: self._wake_timeout(b, result)
            )

    def _clear_wakeups(self):
        if self._wake_listener is not None:
            f, l = self._wake_listener
            f.remove_listener(l)
            self._wake_listener = None
        if self._wake_timer is not None:
            self.host.cancel(self._wake_timer)
            self._wake_timer = None

    def _wake(self, _):
        """Condition fired: re-execute the same syscall (reference re-runs
        the SAME syscall after wakeup, handler/mod.rs + thread.rs)."""
        if self.state != ProcState.BLOCKED:
            return
        self._clear_wakeups()
        self.state = ProcState.RUNNING
        self.host.schedule(self.host.now(), self.resume)

    def _wake_timeout(self, b: Blocked, result):
        if self.state != ProcState.BLOCKED:
            return
        self._wake_timer = None
        self._clear_wakeups()
        self.state = ProcState.RUNNING
        if b.has_timeout_result:
            # timeout substitutes the syscall result instead of re-running
            if self.strace is not None and self._current is not None:
                self.strace(
                    self.host.now(), self.pid, self._current.name,
                    self._current.args, result,
                )
            self._current = None
            self._send_value = result
        self.host.schedule(self.host.now(), self.resume)

    def _exit(self, code: int):
        self.state = ProcState.ZOMBIE
        self.exit_code = code
        self._clear_wakeups()
        self.fds.close_all()
        self.host.on_process_exit(self)

    def kill(self):
        if self.state != ProcState.ZOMBIE:
            self._gen.close()
            self._exit(137)


ManagedProgram = Callable  # a program is just `def prog(ctx): yield ...`


class SyscallHandler:
    """Dispatch table (reference handler/mod.rs:371-539). Each op returns a
    result or `Blocked`. OSError propagates into the program as the raised
    exception (programs may try/except like checking errno)."""

    def __init__(self, host):
        self.host = host

    def execute(self, proc: Process, call: Syscall):
        fn = getattr(self, f"sys_{call.name}", None)
        if fn is None:
            raise OSError(f"ENOSYS: {call.name}")
        self.host.counters["syscalls"] += 1
        return fn(proc, *call.args)

    # ---- time --------------------------------------------------------------

    def sys_clock_gettime(self, proc):
        return self.host.now()

    def sys_gettimeofday(self, proc):
        t = self.host.now()
        return (t // NS_PER_SEC, (t % NS_PER_SEC) // 1000)

    def sys_time(self, proc):
        return self.host.now() // NS_PER_SEC

    def sys_nanosleep(self, proc, duration_ns: int):
        return Blocked(
            timeout=self.host.now() + max(int(duration_ns), 0),
            on_timeout=0,
            has_timeout_result=True,
        )

    # ---- random ------------------------------------------------------------

    def sys_getrandom(self, proc, n: int):
        return bytes(self.host.rng.getrandbits(8) for _ in range(n))

    # ---- stdio -------------------------------------------------------------

    def sys_write_stdout(self, proc, data: bytes):
        proc.stdout.append(bytes(data))
        return len(data)

    def sys_write_stderr(self, proc, data: bytes):
        proc.stderr.append(bytes(data))
        return len(data)

    # ---- descriptors -------------------------------------------------------

    def sys_close(self, proc, fd: int):
        proc.fds.close(fd)
        return 0

    def sys_dup(self, proc, fd: int):
        return proc.fds.dup(fd)

    def sys_dup2(self, proc, old: int, new: int):
        return proc.fds.dup2(old, new)

    def sys_pipe(self, proc):
        r, w = create_pipe()
        return (proc.fds.register(r), proc.fds.register(w))

    def sys_read(self, proc, fd: int, n: int):
        f = proc.fds.get(fd)
        out = f.read(n)
        if out is None:
            return Blocked(file=f, mask=_WAIT_READ)
        return out

    def sys_write(self, proc, fd: int, data: bytes):
        f = proc.fds.get(fd)
        n = f.write(data)
        if n is None:
            return Blocked(file=f, mask=_WAIT_WRITE)
        return n

    def sys_read_nonblock(self, proc, fd: int, n: int):
        return proc.fds.get(fd).read(n)  # None = EAGAIN

    def sys_write_nonblock(self, proc, fd: int, data: bytes):
        return proc.fds.get(fd).write(data)

    # ---- eventfd / timerfd / epoll ----------------------------------------

    def sys_eventfd(self, proc, initval: int = 0, semaphore: bool = False):
        return proc.fds.register(EventFd(initval, semaphore))

    def sys_timerfd_create(self, proc):
        return proc.fds.register(TimerFd(self.host))

    def sys_timerfd_settime(self, proc, fd: int, deadline_ns, interval_ns: int = 0):
        f = proc.fds.get(fd)
        if not isinstance(f, TimerFd):
            raise OSError("EINVAL: not a timerfd")
        return f.settime(deadline_ns, interval_ns)

    def sys_timerfd_gettime(self, proc, fd: int):
        f = proc.fds.get(fd)
        if not isinstance(f, TimerFd):
            raise OSError("EINVAL: not a timerfd")
        return f.gettime()

    def sys_epoll_create(self, proc):
        return proc.fds.register(Epoll())

    def sys_epoll_ctl(self, proc, epfd: int, op: str, fd: int, events: int = 0,
                      data: int | None = None):
        ep = proc.fds.get(epfd)
        if not isinstance(ep, Epoll):
            raise OSError("EINVAL: not an epoll fd")
        if op == "add":
            ep.add(fd, proc.fds.get(fd), events, data)
        elif op == "mod":
            ep.modify(fd, events, data)
        elif op == "del":
            ep.remove(fd)
        else:
            raise OSError(f"EINVAL: epoll op {op!r}")
        return 0

    def sys_epoll_wait(self, proc, epfd: int, max_events: int = 64,
                       timeout_ns: int | None = None):
        ep = proc.fds.get(epfd)
        if not isinstance(ep, Epoll):
            raise OSError("EINVAL: not an epoll fd")
        evs = ep.wait(max_events)
        if evs is not None:
            return [(e.fd, e.events, e.data) for e in evs]
        if timeout_ns == 0:
            return []
        return Blocked(
            file=ep,
            mask=FileState.READABLE,
            timeout=None if timeout_ns is None else self.host.now() + timeout_ns,
            on_timeout=[],
            has_timeout_result=timeout_ns is not None,
        )

    # ---- sockets -----------------------------------------------------------

    def sys_socket(self, proc, kind: str):
        if kind == "udp":
            return proc.fds.register(UdpSocket(self.host.netns))
        if kind == "tcp":
            return proc.fds.register(TcpSocket(self.host.netns))
        if kind == "unix":
            return proc.fds.register(UnixStreamSocket())
        raise OSError(f"EINVAL: socket kind {kind!r}")

    def sys_socketpair(self, proc):
        a, b = UnixStreamSocket.make_pair()
        return (proc.fds.register(a), proc.fds.register(b))

    def sys_bind(self, proc, fd: int, addr):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            name = addr if isinstance(addr, str) else addr[0]
            f.bind_abstract(self.host.netns.abstract_unix, name.removeprefix("@"))
            return 0
        f.bind(addr[0], addr[1])
        return 0

    def sys_listen(self, proc, fd: int, backlog: int = 128):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            f.listen()
            return 0
        if isinstance(f, TcpListenerSocket):
            return 0
        if not isinstance(f, TcpSocket):
            raise OSError("EOPNOTSUPP: listen on non-TCP socket")
        # rebind the same fd slot as a listener (reference converts the
        # socket's protocol state the same way)
        lst = TcpListenerSocket(self.host.netns, cfg=f.cfg, backlog=backlog)
        lst.local_ip, lst.local_port = f.local_ip, f.local_port
        if lst.local_port is None:
            raise OSError("EINVAL: listen before bind")
        self.host.netns._ports[(lst.PROTO, lst.local_port)] = lst
        for slot_fd in proc.fds.fds():
            if proc.fds.get(slot_fd) is f:
                proc.fds.register_at(slot_fd, lst)
        return 0

    def sys_accept(self, proc, fd: int):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            child = f.accept()
            if child is None:
                return Blocked(file=f, mask=_WAIT_ACCEPT)
            return (proc.fds.register(child), ("unix", 0))
        if not isinstance(f, TcpListenerSocket):
            raise OSError("EINVAL: accept on non-listener")
        child = f.accept()
        if child is None:
            return Blocked(file=f, mask=_WAIT_ACCEPT)
        cfd = proc.fds.register(child)
        return (cfd, (child.peer_ip, child.peer_port))

    def sys_connect(self, proc, fd: int, addr):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            name = (addr if isinstance(addr, str) else addr[0]).removeprefix("@")
            listener = self.host.netns.abstract_unix.get(name)
            if listener is None:
                raise ConnectionRefusedError(f"ECONNREFUSED: @{name}")
            f.connect_to(listener)
            return 0
        if isinstance(f, UdpSocket):
            f.connect(addr[0], addr[1])
            return 0
        if not isinstance(f, TcpSocket):
            raise OSError("EINVAL")
        from shadow_tpu_torch.tcp import State as TS

        if f.tcp.state == TS.ESTABLISHED:
            return 0
        if f.tcp.error is not None:
            raise ConnectionRefusedError(f.tcp.error.value)
        if f.tcp.state == TS.CLOSED and f.peer_ip is None:
            f.connect(addr[0], addr[1])
        return Blocked(file=f, mask=_WAIT_WRITE)

    def sys_sendto(self, proc, fd: int, data: bytes, addr: tuple | None = None):
        f = proc.fds.get(fd)
        if isinstance(f, UdpSocket):
            return f.sendto(data, addr)
        return self.sys_write(proc, fd, data)

    def sys_recvfrom(self, proc, fd: int, n: int):
        f = proc.fds.get(fd)
        if isinstance(f, UdpSocket):
            r = f.recvfrom(n)
            if r is None:
                return Blocked(file=f, mask=_WAIT_READ)
            return r
        data = f.read(n)
        if data is None:
            return Blocked(file=f, mask=_WAIT_READ)
        return (data, (f.peer_ip, f.peer_port))

    sys_send = sys_write
    sys_recv = sys_read

    def sys_shutdown(self, proc, fd: int):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            if not f.connected:
                raise OSError("ENOTCONN")
            f.shutdown_write()
            return 0
        if not isinstance(f, TcpSocket):
            raise OSError("ENOTSOCK")
        f.shutdown_write()
        return 0

    def sys_getsockname(self, proc, fd: int):
        f = proc.fds.get(fd)
        return (f.local_ip, f.local_port)

    def sys_getpeername(self, proc, fd: int):
        f = proc.fds.get(fd)
        if isinstance(f, UnixStreamSocket):
            if not f.connected:
                raise OSError("ENOTCONN")
            return ("unix", 0)
        if f.peer_ip is None:
            raise OSError("ENOTCONN")
        return (f.peer_ip, f.peer_port)

    def sys_gethostname(self, proc):
        return self.host.name

    def sys_resolve(self, proc, name: str):
        """shadow_hostname_to_addr_ipv4 equivalent (handler/mod.rs:513-517)."""
        return self.host.resolve(name)

    # ---- process -----------------------------------------------------------

    def sys_getpid(self, proc):
        return proc.pid

    def sys_exit(self, proc, code: int = 0):
        proc._exit(int(code))
        return code
