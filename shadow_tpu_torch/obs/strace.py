"""strace-style per-process syscall logs.

Reference: the strace hook wrapping every emulated syscall
(handler/mod.rs:348-369), formatter (host/syscall/formatter.rs), and
`StraceLoggingMode` off/standard/deterministic (configuration.rs:1162).
Deterministic mode prints only simulation-derived values so two runs (or
two schedulers) produce byte-identical files — the determinism suite
diffs them (determinism1_compare.cmake).
"""

from __future__ import annotations

from typing import IO

MAX_REPR = 64


def _fmt_val(v, deterministic: bool) -> str:
    if isinstance(v, bytes):
        body = v[:MAX_REPR]
        suffix = "..." if len(v) > MAX_REPR else ""
        return f"{body!r}{suffix}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_val(x, deterministic) for x in v) + "]"
    if deterministic and isinstance(v, float):
        return "<float>"
    if isinstance(v, BaseException):
        return f"{type(v).__name__}({v})"
    return repr(v)


class StraceLogger:
    """Collects one process's syscall lines; attach via `Process.strace`."""

    def __init__(self, out: IO[str], mode: str = "standard"):
        if mode not in ("standard", "deterministic"):
            raise ValueError(f"strace mode {mode!r}")
        self.out = out
        self.mode = mode

    def __call__(self, t_ns: int, pid: int, name: str, args: tuple, result):
        det = self.mode == "deterministic"
        secs, ns = divmod(t_ns, 1_000_000_000)
        argstr = ", ".join(_fmt_val(a, det) for a in args)
        res = _fmt_val(result, det)
        self.out.write(f"{secs:02d}.{ns:09d} [{pid}] {name}({argstr}) = {res}\n")
