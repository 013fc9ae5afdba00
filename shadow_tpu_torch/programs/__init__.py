"""Built-in managed programs (the analogue of the reference's test/traffic
binaries: tgen flows `src/test/tgen/`, PHOLD `src/test/phold/`, echo
servers in `src/test/socket/`).

A program is a generator `def prog(ctx): yield ("syscall", ...)` run by
`shadow_tpu_torch.host.process`. Configs reference them by `path:` name; the
registry stands in for an on-disk binary (real executables arrive with the
native managed-process plane)."""

from __future__ import annotations

PROGRAM_REGISTRY: dict[str, object] = {}


def register_program(fn=None, *, name: str | None = None):
    def deco(f):
        PROGRAM_REGISTRY[name or f.__name__] = f
        return f

    return deco(fn) if fn is not None else deco


def get_program(name: str):
    if name not in PROGRAM_REGISTRY:
        raise KeyError(
            f"unknown program {name!r}; available: {sorted(PROGRAM_REGISTRY)}"
        )
    return PROGRAM_REGISTRY[name]


# ---------------------------------------------------------------- programs

MS = 1_000_000
SEC = 1_000_000_000


@register_program
def udp_echo_server(ctx):
    """Echo datagrams back to their sender forever (test/socket echo)."""
    port = int(ctx.args.get("port", 9000))
    fd = yield ("socket", "udp")
    yield ("bind", fd, ("0.0.0.0", port))
    while True:
        data, addr = yield ("recvfrom", fd, 65536)
        yield ("sendto", fd, data, addr)


@register_program
def udp_ping(ctx):
    """Send `count` datagrams to `server`, await each echo, log RTTs."""
    server = ctx.args.get("server", "server")
    port = int(ctx.args.get("port", 9000))
    count = int(ctx.args.get("count", 10))
    interval = int(ctx.args.get("interval_ns", 100 * MS))
    size = int(ctx.args.get("size", 64))
    ip = yield ("resolve", server)
    fd = yield ("socket", "udp")
    yield ("connect", fd, (ip, port))
    ok = 0
    for i in range(count):
        t0 = yield ("clock_gettime",)
        yield ("sendto", fd, bytes([i % 256]) * size)
        data, _ = yield ("recvfrom", fd, 65536)
        t1 = yield ("clock_gettime",)
        assert data == bytes([i % 256]) * size
        ok += 1
        yield ("write_stdout", f"seq={i} rtt_ns={t1 - t0}\n".encode())
        if i + 1 < count:
            yield ("nanosleep", interval)
    yield ("write_stdout", f"done ok={ok}/{count}\n".encode())
    yield ("exit", 0)


@register_program
def udp_blast(ctx):
    """Fire `count` datagrams at `server` without awaiting replies (one-way
    load source for mixed-plane tests where the modeled peer never echoes)."""
    server = ctx.args.get("server", "server")
    port = int(ctx.args.get("port", 9000))
    count = int(ctx.args.get("count", 5))
    interval = int(ctx.args.get("interval_ns", 100 * MS))
    size = int(ctx.args.get("size", 64))
    ip = yield ("resolve", server)
    fd = yield ("socket", "udp")
    yield ("connect", fd, (ip, port))
    for i in range(count):
        yield ("sendto", fd, bytes([i % 256]) * size)
        if i + 1 < count:
            yield ("nanosleep", interval)
    yield ("write_stdout", f"blast done {count}\n".encode())
    yield ("exit", 0)


@register_program
def tgen_server(ctx):
    """Accept TCP connections; drain each until EOF (tgen fixed_size sink).

    Serves `conns` connections sequentially, then exits 0 (or runs forever
    with conns=0)."""
    port = int(ctx.args.get("port", 8080))
    conns = int(ctx.args.get("conns", 0))
    fd = yield ("socket", "tcp")
    yield ("bind", fd, ("0.0.0.0", port))
    yield ("listen", fd)
    served = 0
    while conns == 0 or served < conns:
        cfd, peer = yield ("accept", fd)
        total = 0
        while (data := (yield ("recv", cfd, 65536))) != b"":
            total += len(data)
        yield ("write_stdout", f"conn={served} from={peer[0]} bytes={total}\n".encode())
        yield ("close", cfd)
        served += 1
    yield ("exit", 0)


@register_program
def tgen_client(ctx):
    """Stream `size` bytes to `server` over TCP, then FIN (tgen fixed_size)."""
    server = ctx.args.get("server", "server")
    port = int(ctx.args.get("port", 8080))
    size = int(ctx.args.get("size", 1 << 20))
    ip = yield ("resolve", server)
    fd = yield ("socket", "tcp")
    yield ("connect", fd, (ip, port))
    t0 = yield ("clock_gettime",)
    sent = 0
    block = bytes(range(256)) * 256  # 64 KiB pattern
    while sent < size:
        sent += yield ("send", fd, block[: min(len(block), size - sent)])
    yield ("shutdown", fd)
    t1 = yield ("clock_gettime",)
    yield (
        "write_stdout",
        f"sent={sent} elapsed_ns={t1 - t0} "
        f"goodput_mbps={sent * 8e3 / max(t1 - t0, 1):.2f}\n".encode(),
    )
    yield ("exit", 0)


@register_program
def tgen_duration_client(ctx):
    """Stream to `server` for `duration` seconds, then FIN (the reference's
    tgen fixed_duration flow, src/test/tgen/fixed_duration)."""
    server = ctx.args.get("server", "server")
    port = int(ctx.args.get("port", 8080))
    duration_ns = int(float(ctx.args.get("duration_s", 5)) * SEC)
    ip = yield ("resolve", server)
    fd = yield ("socket", "tcp")
    yield ("connect", fd, (ip, port))
    t0 = yield ("clock_gettime",)
    block = bytes(range(256)) * 256
    sent = 0
    while True:
        now = yield ("clock_gettime",)
        if now - t0 >= duration_ns:
            break
        sent += yield ("send", fd, block)
    yield ("shutdown", fd)
    yield (
        "write_stdout",
        f"sent={sent} duration_ns={now - t0} "
        f"goodput_mbps={sent * 8e3 / max(now - t0, 1):.2f}\n".encode(),
    )
    yield ("exit", 0)


@register_program
def unix_echo_pair(ctx):
    """Single-host unix-domain smoke workload: a socketpair echo plus an
    abstract-namespace listener/connector (reference socket/unix tests)."""
    a, b = yield ("socketpair",)
    yield ("write", a, b"ping")
    data = yield ("read", b, 16)
    assert data == b"ping", data
    lst = yield ("socket", "unix")
    yield ("bind", lst, "@echo")
    yield ("listen", lst)
    cli = yield ("socket", "unix")
    yield ("connect", cli, "@echo")
    srv, _ = yield ("accept", lst)
    yield ("write", cli, b"hello-unix")
    got = yield ("read", srv, 64)
    yield ("write_stdout", b"unix ok: " + got + b"\n")
    yield ("exit", 0)


@register_program
def phold_proc(ctx):
    """PHOLD as a managed program (the reference runs PHOLD as a real socket
    binary, src/test/phold/): hold `population` jobs, mature each after an
    exponential delay, forward to a uniform-random peer."""
    import math

    peers = ctx.args["peers"]  # list of hostnames
    port = int(ctx.args.get("port", 9000))
    population = int(ctx.args.get("population", 2))
    mean_delay = int(ctx.args.get("mean_delay_ns", 100 * MS))
    size = int(ctx.args.get("size", 64))
    fd = yield ("socket", "udp")
    yield ("bind", fd, ("0.0.0.0", port))
    ips = []
    for p in peers:
        ips.append((yield ("resolve", p)))
    ep = yield ("epoll_create",)
    yield ("epoll_ctl", ep, "add", fd, 0x001)
    tfd = yield ("timerfd_create",)
    yield ("epoll_ctl", ep, "add", tfd, 0x001)

    def draw_delay(u: float) -> int:
        return max(1, int(-mean_delay * math.log(1.0 - u)))

    pending = []  # maturity deadlines
    now = yield ("clock_gettime",)
    for _ in range(population):
        r = yield ("getrandom", 4)
        u = int.from_bytes(r, "little") / 2**32
        pending.append(now + draw_delay(u))
    forwarded = 0
    while True:
        pending.sort()
        yield ("timerfd_settime", tfd, pending[0] if pending else None, 0)
        evs = yield ("epoll_wait", ep)
        now = yield ("clock_gettime",)
        for efd, _, _ in evs:
            if efd == tfd:
                yield ("read", tfd, 8)
                while pending and pending[0] <= now:
                    pending.pop(0)
                    r = yield ("getrandom", 4)
                    dst = ips[int.from_bytes(r, "little") % len(ips)]
                    yield ("sendto", fd, b"j" * size, (dst, port))
                    forwarded += 1
            elif efd == fd:
                while (r := (yield ("read_nonblock", fd, 65536))) is not None:
                    rr = yield ("getrandom", 4)
                    u = int.from_bytes(rr, "little") / 2**32
                    pending.append(now + draw_delay(u))
