"""CPU pinning / NUMA affinity for CPU-host-plane workers.

Reference: `src/main/core/affinity.c` — parses platform topology (logical
CPU -> core -> socket -> node), tracks how many workers were assigned to
each level, and gives the next worker the logical CPU whose (node, socket,
core, cpu) load vector is smallest, so workers pack distinct physical
cores first and spill onto hyperthread siblings last. The knob is
`experimental.use_cpu_pinning` (configuration.rs ExperimentalOptions).

Python recast: topology comes from sysfs
(`/sys/devices/system/cpu/cpu*/topology/{core_id,physical_package_id}`,
`/sys/devices/system/node/node*/cpulist`), restricted to the process's
inherited affinity mask (the reference honors the initial mask the same
way). Pinning itself is `os.sched_setaffinity(0, {cpu})`: on Linux, pid 0
means the *calling thread*, so each pool worker pins itself at startup.
On a single-CPU box every worker legally lands on the one CPU — the
assignment degrades to a no-op rather than failing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class CpuInfo:
    """One logical CPU and its position in the machine (affinity.c CPUInfo)."""

    cpu: int
    core: int
    socket: int
    node: int


def _read_int(path: str, default: int = 0) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return default


def _parse_cpulist(text: str) -> set[int]:
    """Parse a sysfs cpulist ("0-3,8,10-11") into a set of cpu numbers."""
    cpus: set[int] = set()
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.update(range(int(lo), int(hi) + 1))
        else:
            cpus.add(int(part))
    return cpus


def topology(allowed: set[int] | None = None) -> list[CpuInfo]:
    """The machine's logical CPUs, restricted to `allowed` (defaults to the
    process's current affinity mask, matching affinity.c's use of the
    initial mask as the universe)."""
    if allowed is None:
        try:
            allowed = set(os.sched_getaffinity(0))
        except (AttributeError, OSError):  # non-Linux
            allowed = set(range(os.cpu_count() or 1))
    node_of: dict[int, int] = {}
    try:
        for entry in os.listdir("/sys/devices/system/node"):
            if not (entry.startswith("node") and entry[4:].isdigit()):
                continue
            nid = int(entry[4:])
            try:
                with open(f"/sys/devices/system/node/{entry}/cpulist") as f:
                    for cpu in _parse_cpulist(f.read()):
                        node_of[cpu] = nid
            except OSError:
                continue
    except OSError:
        pass
    infos = []
    for cpu in sorted(allowed):
        base = f"/sys/devices/system/cpu/cpu{cpu}/topology"
        infos.append(
            CpuInfo(
                cpu=cpu,
                core=_read_int(f"{base}/core_id", cpu),
                socket=_read_int(f"{base}/physical_package_id", 0),
                node=node_of.get(cpu, 0),
            )
        )
    return infos


def assign(n_workers: int, cpus: list[CpuInfo] | None = None) -> list[int]:
    """Pick a logical CPU for each of `n_workers` workers.

    affinity.c's greedy: each worker goes to the CPU minimizing the load
    vector (node_load, socket_load, core_load, cpu_load, cpu_num) — i.e.
    stay on one NUMA node while it has idle cores, use every physical core
    before doubling up on SMT siblings, and break ties by lowest cpu
    number for determinism."""
    if cpus is None:
        cpus = topology()
    if not cpus:
        return [0] * n_workers
    node_load: dict[int, int] = {}
    socket_load: dict[tuple, int] = {}
    core_load: dict[tuple, int] = {}
    cpu_load: dict[int, int] = {}
    out = []
    for _ in range(n_workers):
        best = min(
            cpus,
            key=lambda c: (
                node_load.get(c.node, 0),
                socket_load.get((c.node, c.socket), 0),
                core_load.get((c.node, c.socket, c.core), 0),
                cpu_load.get(c.cpu, 0),
                c.cpu,
            ),
        )
        node_load[best.node] = node_load.get(best.node, 0) + 1
        sk = (best.node, best.socket)
        socket_load[sk] = socket_load.get(sk, 0) + 1
        ck = (best.node, best.socket, best.core)
        core_load[ck] = core_load.get(ck, 0) + 1
        cpu_load[best.cpu] = cpu_load.get(best.cpu, 0) + 1
        out.append(best.cpu)
    return out


def pin_current(cpu: int) -> bool:
    """Pin the calling thread to `cpu`. Returns False (never raises) when
    the platform refuses — pinning is a performance hint, not a
    correctness requirement (affinity.c logs and continues the same way)."""
    try:
        os.sched_setaffinity(0, {cpu})
        return True
    except (AttributeError, OSError, ValueError):
        return False
