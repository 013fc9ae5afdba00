"""The memory observatory (port of shadow_tpu/obs/memory.py): device-memory
accounting for the engine, from two sources.

  (a) the byte model: the state's and the parameters' tensors, priced at
      their own `nbytes` (the port's lanes are not all JAX's widths: tgen's
      reassembly bitmap is int64, uint64 lanes are carried as int64, so the
      model is the port's own figure, not the JAX package's registry
      formula), per state field, with the JAX report's keys; and the
      queue's and outbox's bytes at any (capacity, send budget) shape, the
      pressure plane's footprint predictor;

  (b) live sampling: `torch.cuda.memory_stats` (bytes allocated now and at
      the peak, bytes the caching allocator holds) and
      `torch.cuda.mem_get_info` (bytes free on the card) at chunk
      boundaries, folded into a high-water. The limit is what this process
      could hold: the card's free bytes plus the allocator's reserved
      bytes, so the CUDA context, the kernel modules and other processes
      are outside it. A CPU device reports no
      allocator statistics; the monitor then takes the modeled bytes, as
      the JAX package does on a backend without them.

Everything here is a host-side observer, with one deliberate feedback path:
`MemoryGuard` lets the pressure plane refuse a grown rung whose predicted
extra bytes (x the replay's two copies x a safety factor) exceed the
measured headroom BEFORE dispatching it, in place of an out-of-memory
round trip. Without a measured limit (the CPU, or no sample yet) it admits
everything.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

# while the pressure plane grows a rung it holds the pre-chunk snapshot AND
# the migrated live state, so admission charges every grown byte twice
DEFAULT_GUARD_COPIES = 2
DEFAULT_SAFETY_FACTOR = 1.25
# bound the retained sample list (one sample per chunk)
MAX_SAMPLES = 8192
# the state fields the JAX package's lane registry prices (its
# "registered" components); the rest are its "unregistered" planes
_REGISTERED = {"queue", "outbox", "stats", "trace", "flows", "rng", "now", "done", "seq",
               "sent_round", "cpu_busy_until", "min_used_lat"}


def leaf_nbytes(leaf) -> int:
    """Bytes of one leaf from its metadata (a tensor or an array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, np.ndarray):
        return int(leaf.nbytes)
    return 0


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def tree_bytes(tree) -> int:
    """Total bytes of a tree of NamedTuples, tuples, lists and dicts."""
    return sum(leaf_nbytes(x) for x in _leaves(tree))


def modeled_shard_bytes(state, params=None, world: int = 1) -> int:
    """The monitor's modeled figure: the live state's and the parameters'
    tensor bytes (per device)."""
    total = tree_bytes(state)
    if params is not None:
        total += tree_bytes(params)
    return total // max(int(world), 1)


def state_field_bytes(state) -> dict[str, int]:
    """Bytes per top-level field of a SimState."""
    out: dict[str, int] = {}
    for name, sub in zip(type(state)._fields, state):
        b = tree_bytes(sub)
        if b:
            out[name] = b
    return out


def queue_bytes(hosts: int, capacity: int, block: int, payload_words: int) -> int:
    """The event queue's planes at `capacity` slots per host: time and
    order (8 bytes), kind (4), payload (4 x P) per slot, the drop counter,
    and a bucketed queue's block caches (bt, bo: 8; bfill: 4 per block)."""
    slot = 8 + 8 + 4 + 4 * payload_words
    caches = (capacity // block) * (8 + 8 + 4) if block else 0
    return hosts * (capacity * slot + caches + 8)


def outbox_bytes(hosts: int, budget: int, payload_words: int) -> int:
    """The outbox's planes at `budget` columns: dst and kind (4), time and
    order (8), payload (4 x P) per column, and the count."""
    return hosts * budget * (4 + 8 + 8 + 4 + 4 * payload_words) + 4


def state_bytes_at(state, capacity: int, send_budget: int, block: int) -> int:
    """The state's bytes re-priced at (capacity, send_budget): its measured
    bytes with the queue and outbox planes swapped for the new shape's."""
    h, cap = state.queue.t.shape
    p = state.queue.payload.shape[2]
    box = state.outbox.t.shape[1]
    return (tree_bytes(state) - queue_bytes(h, cap, block, p) - outbox_bytes(h, box, p)
            + queue_bytes(h, capacity or cap, block, p)
            + outbox_bytes(h, send_budget or box, p))


def static_model(cfg, state, params=None) -> dict:
    """The byte model's report for the state's shape, with the JAX
    package's keys: every field priced from its tensors; `registered_bytes`
    over the fields the JAX registry covers, `unregistered` the others."""
    fields = state_field_bytes(state)
    registered = sum(v for k, v in fields.items() if k in _REGISTERED)
    unreg = {k: v for k, v in fields.items() if k not in _REGISTERED}
    measured = sum(fields.values())
    out: dict[str, Any] = {
        "components": fields,
        "registered_bytes": registered,
        "replicas": 1,
        "unregistered": unreg,
        "state_bytes_measured": measured,
        "state_bytes": measured,
    }
    if params is not None:
        pb = tree_bytes(params)
        out["params_bytes"] = pb
        out["total_bytes"] = measured + pb
    else:
        out["total_bytes"] = measured
    out["per_host_bytes"] = out["total_bytes"] // max(cfg.num_hosts, 1)
    return out


def shape_ledger(cfg, state) -> dict[str, dict]:
    """The state's bytes at each shape the run dispatched: the base shape,
    and the state's own where escalation regrew it."""
    out = {"base": {"state_bytes": state_bytes_at(
        state, cfg.queue_capacity, cfg.sends_per_host_round, cfg.queue_block)}}
    cap, box = state.queue.t.shape[1], state.outbox.t.shape[1]
    if (cap, box) != (cfg.queue_capacity, cfg.sends_per_host_round):
        out[f"cap={cap}/box={box}"] = {"state_bytes": tree_bytes(state)}
    return out


def device_memory_stats(device) -> dict | None:
    """The allocator's statistics of a CUDA device, in the JAX package's
    `memory_stats` keys; None on the CPU (no allocator statistics)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats(device)
    free, _total = torch.cuda.mem_get_info(device)
    # the headroom (limit less bytes in use) is then the card's free bytes
    # plus the allocator's reserved-but-unallocated ones
    return {
        "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(free) + int(st.get("reserved_bytes.all.current", 0)),
    }


def device_capacity_bytes(device=None) -> int | None:
    """The memory this process could hold on a device (the JAX package's
    `device_capacity_bytes`): on a CUDA device the card's free bytes plus
    the allocator's reserved ones (`torch.cuda.mem_get_info`), on the CPU
    the host's MemAvailable; None where neither is known (guards that need
    a capacity stay inert). The default device is the card where there is
    one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    st = device_memory_stats(device)
    if st and st.get("bytes_limit"):
        return int(st["bytes_limit"])
    if device.type == "cpu":
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            return None
    return None


class MemoryMonitor:
    """Live device-memory telemetry, sampled at chunk boundaries (one
    device). `stats_fn` injects a fake `device_memory_stats` for tests.
    Without allocator statistics `sample(modeled_bytes=...)` takes the
    byte model's figure; `source` says which."""

    def __init__(self, devices=None, stats_fn=None):
        self.devices = list(devices or [torch.device("cpu")])
        self._stats_fn = stats_fn or device_memory_stats
        n = len(self.devices)
        self.peak = [0] * n
        self.last = [0] * n
        self.limit_bytes: int | None = None
        self.source: str | None = None
        self.samples: list[tuple[float | None, tuple[int, ...]]] = []
        self.samples_lost = 0
        self.count = 0

    def sample(self, *, modeled_bytes: int | None = None,
               wall_t: float | None = None) -> list[int]:
        """One sample; returns the bytes in use per device."""
        per: list[int] = []
        source = None
        for i, d in enumerate(self.devices):
            st = self._stats_fn(d)
            if st and st.get("bytes_in_use") is not None:
                used = int(st["bytes_in_use"])
                peak = int(st.get("peak_bytes_in_use", used))
                if st.get("bytes_limit"):
                    self.limit_bytes = int(st["bytes_limit"])
                source = source or "device"
            elif modeled_bytes is not None:
                used = peak = int(modeled_bytes)
                source = source or "modeled"
            else:
                used = peak = 0
            per.append(used)
            self.peak[i] = max(self.peak[i], peak, used)
            self.last[i] = used
        if source is not None:
            self.source = self.source or source
        self.count += 1
        if len(self.samples) >= MAX_SAMPLES:
            self.samples_lost += 1
        else:
            self.samples.append((wall_t, tuple(per)))
        return per

    def headroom_bytes(self) -> int | None:
        """The limit less the bytes in use at the last sample, or None
        without a known limit (the guard is then inert)."""
        if self.limit_bytes is None or self.count == 0:
            return None
        return self.limit_bytes - max(self.last)

    def hwm_bytes(self) -> int:
        """The run's high-water (the heartbeat's `hbm=`)."""
        return max(self.peak) if self.peak else 0

    def report(self) -> dict:
        out: dict[str, Any] = {
            "source": self.source,
            "samples": self.count,
            "per_shard_hwm_bytes": list(self.peak),
            "bytes_in_use": list(self.last),
        }
        if self.limit_bytes is not None:
            out["limit_bytes"] = self.limit_bytes
            out["headroom_bytes"] = self.headroom_bytes()
        if self.samples_lost:
            out["samples_dropped"] = self.samples_lost
        return out


class MemoryGuard:
    """Pre-dispatch admission for the pressure plane's grown rungs
    (core/pressure.py ResilienceController's `memory`). A rung is admitted
    when its extra queue and outbox bytes, charged `copies` times and by
    the safety factor, fit the monitor's measured headroom; unknown
    headroom admits everything."""

    def __init__(self, cfg, monitor: MemoryMonitor | None,
                 safety_factor: float = DEFAULT_SAFETY_FACTOR,
                 copies: int = DEFAULT_GUARD_COPIES, payload_words: int = 4):
        self.cfg = cfg
        self.monitor = monitor
        self.safety_factor = float(safety_factor)
        self.copies = int(copies)
        self.payload_words = int(payload_words)

    def _bytes_at(self, cap: int, box: int) -> int:
        h, p = self.cfg.num_hosts, self.payload_words
        return queue_bytes(h, cap, self.cfg.queue_block, p) + outbox_bytes(h, box, p)

    def predicted_need_bytes(self, cur_cap: int, cur_box: int, new_cap: int,
                             new_box: int) -> int:
        delta = self._bytes_at(new_cap, new_box) - self._bytes_at(cur_cap, cur_box)
        return max(int(delta * self.copies * self.safety_factor), 0)

    def admit(self, cur_cap: int, cur_box: int, new_cap: int,
              new_box: int) -> tuple[bool, int, int | None]:
        """(ok, predicted need in bytes, headroom in bytes)."""
        need = self.predicted_need_bytes(cur_cap, cur_box, new_cap, new_box)
        headroom = self.monitor.headroom_bytes() if self.monitor is not None else None
        if headroom is None:
            return True, need, None
        return need <= headroom, need, headroom


def observatory_report(engine, state, params, monitor: MemoryMonitor | None = None, *,
                       ledger: bool = True) -> dict:
    """The sim-stats `memory{}` block: the byte model, the per-shape
    ledger and the live samples."""
    out: dict[str, Any] = {"model": static_model(engine.cfg, state, params)}
    if ledger:
        out["ledger"] = shape_ledger(engine.cfg, state)
    if monitor is not None:
        out.update(monitor.report())
    return out
