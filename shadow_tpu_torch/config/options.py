"""Config schema for the PyTorch port: the subset of the YAML/CLI surface
that the single-device round loop reads.

The schema is the JAX package's (`general`, `network.graph`,
`experimental`, `host_option_defaults`, `hosts` with device-model
`processes`), so one YAML file drives either package. Every knob the port
does not implement yet raises `ConfigError` naming the knob — a config is
never silently run with a plane switched off:

  - at `general.parallelism > 1` (world > 1, core/mesh.py) the planes
    that do not run sharded yet: the observatories (`observability.trace`,
    `network`, `memory`, `runtime`, `profile_dir`), on-disk checkpoints
    (`faults.supervisor.checkpoint_file`) and `pressure.policy: escalate`;
  - `experimental.scheduler: cpu-reference`;
  - a `campaign` block at world > 1 (the ensemble plane, `campaign.py`,
    runs on one device; `CampaignOptions` is the JAX package's parse);
  - models other than phold, udp_echo, timer, tgen_tcp, gossip and
    circuit (checked when the simulation is built);
  - `pcap_enabled` and `general.log_file` on a config with no managed
    process: they capture the CPU host plane, which only the co-simulation
    bridge runs.

Managed processes (`path:` naming a registered coroutine program, with
`args`, `environment`, `expected_final_state` and `shutdown_time`) make a
co-simulation config (`config_is_cosim`): the CPU host plane over the
device network (cosim.py). Its knobs are the JAX package's: the hosts'
`tcp_*` socket options, `pcap_enabled` and `pcap_capture_size`,
`general.log_file`, `log_level` and `model_unblocked_syscall_latency`, and
`experimental.host_workers`, `host_scheduler`, `use_cpu_pinning`,
`interface_qdisc`, `strace_logging_mode` and `packet_breadcrumbs`.
`ConfigOptions.check_cosim` refuses what the bridge does not run in the
port yet, naming the knob: a real binary (a `path:` holding `/`, the
native plane), `general.parallelism` above 1, merge gears, the
supervisor, the integrity sentinel, `pressure.policy: abort` and every
observability knob.

`experimental.event_queue_block` (the bucketed queue),
`microstep_events` (K events per host per microstep), `timer_wheel`,
`merge_gears` (off | auto | an int | a list of ints: the exchange's column
widths, resolved against the send budget by `core/gears.py`) and
`merge_scatter` (the sort-free exchange merge), `merge_rows` (the
exchange's positional row bound, 0 = none) and `cpu_delay` (the CPU model's
per-event charge, a time whose bare numbers are ms, 0 = off) are accepted
with the JAX package's validation: the block is >= 0 and divides the queue
capacity, K >= 1, and the gears' list entries are positive ints; a negative
row bound or delay, which the JAX package reads as "off", is refused. The `fluid` block
(background traffic classes, net/fluid.py) is parsed and validated as the
JAX package's `FluidOptions`, error texts included, and so are the `faults`
block (`FaultOptions`: host churn, explicit crashes, loss windows, the
supervisor, with its on-disk `checkpoint_file`), the `integrity` block
(`IntegrityOptions`), the `pressure` block (`PressureOptions`: drop,
escalate or abort, the ceilings, the growth factor and the headroom) and
the `observability` block (`ObservabilityOptions`: the round trace ring,
the network observatory, the memory and runtime observatories).

`ExperimentalOptions.resolve_shapes` is the JAX package's auto-sizing rule,
copied verbatim, so both packages resolve a config to the same queue
capacity, send budget and rounds per chunk.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml

from shadow_tpu_torch.config.units import parse_bits_per_sec, parse_time_ns, TimeUnit


class ConfigError(ValueError):
    pass


def _unsupported(knob: str, why: str = "") -> ConfigError:
    tail = f" ({why})" if why else ""
    return ConfigError(
        f"{knob} is not supported by the PyTorch port yet{tail}; "
        f"run the JAX package (python -m shadow_tpu) for this config"
    )


@dataclass
class GraphOptions:
    type: str = "1_gbit_switch"  # "gml" | "1_gbit_switch"
    path: str | None = None
    inline: str | None = None
    use_shortest_path: bool = True

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "GraphOptions":
        d = dict(d or {})
        g = GraphOptions(
            type=d.pop("type", "1_gbit_switch"),
            path=(d.pop("file", {}) or {}).get("path") if "file" in d else d.pop("path", None),
            inline=d.pop("inline", None),
            use_shortest_path=d.pop("use_shortest_path", True),
        )
        if d:
            raise ConfigError(f"unknown graph options: {sorted(d)}")
        return g


@dataclass
class GeneralOptions:
    stop_time: int = 0  # ns (required)
    bootstrap_end_time: int = 0  # ns; loss disabled before this time
    seed: int = 1
    parallelism: int = 0  # ranks (core/mesh.py resolve_world); 0 = every visible card
    data_directory: str = "shadow.data"
    heartbeat_interval: int | None = parse_time_ns("1 s")
    progress: bool = False
    # the co-simulation bridge's sim-time-stamped log (None = off; a
    # relative path lands inside data_directory) and its level
    log_file: str | None = None
    log_level: str = "info"
    # the CPU host plane charges simulated time to syscalls that do not block
    model_unblocked_syscall_latency: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "GeneralOptions":
        d = dict(d)
        if "stop_time" not in d:
            raise ConfigError("general.stop_time is required")
        heartbeat = d.pop("heartbeat_interval", "1 s")
        # accepted for schema compatibility, no effect
        d.pop("template_directory", None)
        g = GeneralOptions(
            stop_time=parse_time_ns(d.pop("stop_time"), TimeUnit.SEC),
            bootstrap_end_time=parse_time_ns(d.pop("bootstrap_end_time", 0), TimeUnit.SEC),
            seed=int(d.pop("seed", 1)),
            parallelism=int(d.pop("parallelism", 0)),
            data_directory=d.pop("data_directory", "shadow.data"),
            heartbeat_interval=(
                parse_time_ns(heartbeat, TimeUnit.SEC) if heartbeat is not None else None
            ),
            progress=bool(d.pop("progress", False)),
            log_file=d.pop("log_file", None),
            log_level=d.pop("log_level", "info"),
            model_unblocked_syscall_latency=bool(d.pop("model_unblocked_syscall_latency", False)),
        )
        if d:
            raise ConfigError(f"unknown general options: {sorted(d)}")
        return g


@dataclass
class NetworkOptions:
    graph: GraphOptions = field(default_factory=GraphOptions)

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "NetworkOptions":
        d = dict(d or {})
        n = NetworkOptions(graph=GraphOptions.from_dict(d.pop("graph", None)))
        if d:
            raise ConfigError(f"unknown network options: {sorted(d)}")
        return n


# experimental knobs of the JAX engine that this port rejects, with the
# value that means "off" (a config may spell the default explicitly)
_EXPERIMENTAL_OFF = {
    "scheduler": "tpu",
}


@dataclass
class ExperimentalOptions:
    runahead: int = parse_time_ns("1 ms")  # lookahead floor
    use_dynamic_runahead: bool = False
    use_codel: bool = True
    # exchange-merge overflow shed: "urgency" keeps the most urgent events;
    # "append" ranks each destination's rows by outbox position
    overflow_shed: str = "urgency"
    # engine static shapes (0 = auto-size from the host count)
    event_queue_capacity: int = 0
    # bucketed queue: slots per block (0 = flat); must divide the capacity
    event_queue_block: int = 0
    sends_per_host_round: int = 0
    max_round_inserts: int = 0
    rounds_per_chunk: int = 0
    microstep_limit: int = 0
    # events folded per host per microstep (K >= 1)
    microstep_events: int = 1
    # the exchange across ranks: auto | gather | alltoall | hierarchical
    # (auto is alltoall when world > 1; world 1 always merges locally), and
    # the all-to-all block (0 = auto; the pressure plane's escalate refuses
    # an explicit one, as in the JAX package)
    exchange: str = "auto"
    a2a_block: int = 0
    # timer wheel: slots per host for the model's timer events (0 = off;
    # needs microstep_events = 1) and slots per block of its caches (0 =
    # auto, a divisor near sqrt)
    timer_wheel: int = 0
    timer_wheel_block: int = 0
    # merge gears: 0 = off, "auto", or explicit widths (an int or a list
    # of ints); the ladder resolves against the send budget at build time
    merge_gears: Any = 0
    # the sort-free exchange merge (its fast path when every destination's
    # rows fit; the sort merge's result otherwise)
    merge_scatter: bool = False
    # the exchange merge's positional row bound (0 = none): rows at sorted
    # position >= merge_rows (one token per host counted) shed into
    # queue_overflow_dropped
    merge_rows: int = 0
    # CPU model: simulated ns of CPU time charged per handled event (0 = off)
    cpu_delay: int = 0
    # the co-simulation bridge's CPU host plane: the order a managed host's
    # same-window sends enter the network ("fifo" | "round-robin", one per
    # socket), strace-style per-process syscall logs ("off" | "standard" |
    # "deterministic"), packet-drop breadcrumbs in host-stats.json, and the
    # host plane's worker threads, their policy ("steal" | "per-host") and
    # pinning
    interface_qdisc: str = "fifo"
    strace_logging_mode: str = "off"
    packet_breadcrumbs: bool = False
    host_workers: int = 1
    host_scheduler: str = "steal"
    use_cpu_pinning: bool = False

    def resolve_exchange(self, world: int) -> str:
        """The engine's exchange kind for `world` ranks (the JAX package's
        rule): `auto` is the destination-sharded alltoall across ranks and
        the local gather on one device; an explicit kind wins."""
        if self.exchange != "auto":
            return self.exchange
        return "alltoall" if world > 1 else "gather"

    def validate(self) -> None:
        """The JAX package's checks of the queue-shape knobs; the block's
        divisibility is checked here when the capacity is set explicitly,
        and by `check_queue_block` once an auto capacity is resolved."""
        if self.exchange not in ("auto", "gather", "alltoall", "hierarchical"):
            raise ConfigError(
                f"experimental.exchange must be auto|gather|alltoall|"
                f"hierarchical, got {self.exchange!r}"
            )
        if self.a2a_block < 0:
            raise ConfigError(f"experimental.a2a_block must be >= 0 (0 = auto), "
                              f"got {self.a2a_block}")
        if self.event_queue_block < 0:
            raise ConfigError(
                f"experimental.event_queue_block must be >= 0 (0 = flat), "
                f"got {self.event_queue_block}"
            )
        if self.microstep_events < 1:
            raise ConfigError(
                f"experimental.microstep_events must be >= 1, got {self.microstep_events}"
            )
        if self.event_queue_capacity:
            self.check_queue_block(self.event_queue_capacity)
        if self.timer_wheel < 0:
            raise ConfigError(
                f"experimental.timer_wheel must be >= 0 (0 = off), got {self.timer_wheel}"
            )
        if self.timer_wheel_block < 0 or (
            self.timer_wheel and self.timer_wheel_block
            and self.timer_wheel % self.timer_wheel_block
        ):
            raise ConfigError(
                f"experimental.timer_wheel_block={self.timer_wheel_block} must be 0 "
                f"(auto) or divide timer_wheel={self.timer_wheel} evenly"
            )
        self.merge_gears = parse_merge_gears(self.merge_gears)
        for knob, allowed in (("interface_qdisc", ("fifo", "round-robin")),
                              ("strace_logging_mode", ("off", "standard", "deterministic")),
                              ("host_scheduler", ("steal", "per-host"))):
            if getattr(self, knob) not in allowed:
                raise ConfigError(f"experimental.{knob} must be {'|'.join(allowed)}, "
                                  f"got {getattr(self, knob)!r}")
        for knob in ("merge_rows", "cpu_delay"):
            if getattr(self, knob) < 0:
                raise ConfigError(
                    f"experimental.{knob} must be >= 0 (0 = off), got {getattr(self, knob)}"
                )
        if self.timer_wheel and self.microstep_events > 1:
            raise ConfigError(
                f"unsupported knob pair: experimental.timer_wheel={self.timer_wheel} x "
                f"experimental.microstep_events={self.microstep_events} (the wheel's pop "
                f"merges one wheel candidate against the queue head per microstep); run "
                f"the wheel with microstep_events=1 or keep it off"
            )

    def check_queue_block(self, capacity: int) -> None:
        if self.event_queue_block and capacity % self.event_queue_block:
            raise ConfigError(
                f"experimental.event_queue_block={self.event_queue_block} must "
                f"divide the queue capacity {capacity} evenly"
            )

    def resolve_shapes(self, num_hosts: int) -> tuple[int, int, int]:
        """(queue_capacity, send_budget, rounds_per_chunk), 0-valued knobs
        sized from the host count exactly as the JAX package sizes them."""
        if num_hosts <= 1 << 17:
            auto = (64, 8, 64)
        elif num_hosts <= 1 << 19:
            auto = (16, 4, 32)
        else:
            auto = (4, 1, 8)
        return (
            self.event_queue_capacity or auto[0],
            self.sends_per_host_round or auto[1],
            self.rounds_per_chunk or auto[2],
        )

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "ExperimentalOptions":
        d = dict(d or {})
        for knob, off in _EXPERIMENTAL_OFF.items():
            if knob in d:
                v = d.pop(knob)
                if v != off:
                    raise _unsupported(f"experimental.{knob}={v!r}")
        e = ExperimentalOptions()
        e.exchange = d.pop("exchange", "auto")
        e.a2a_block = int(d.pop("a2a_block", 0))
        for f in ("runahead", "cpu_delay"):
            if f in d:
                setattr(e, f, parse_time_ns(d.pop(f), TimeUnit.MS))
        if "overflow_shed" in d:
            e.overflow_shed = str(d.pop("overflow_shed"))
        if e.overflow_shed not in ("urgency", "append"):
            raise ConfigError(
                f"experimental.overflow_shed must be urgency|append, "
                f"got {e.overflow_shed!r}"
            )
        if "merge_gears" in d:
            e.merge_gears = d.pop("merge_gears")
        for f in ("interface_qdisc", "strace_logging_mode", "host_scheduler"):
            if f in d:
                setattr(e, f, str(d.pop(f)))
        for f in ("use_dynamic_runahead", "use_codel", "merge_scatter", "packet_breadcrumbs",
                  "use_cpu_pinning"):
            if f in d:
                setattr(e, f, bool(d.pop(f)))
        for f in (
            "event_queue_capacity",
            "event_queue_block",
            "sends_per_host_round",
            "max_round_inserts",
            "rounds_per_chunk",
            "microstep_limit",
            "microstep_events",
            "timer_wheel",
            "timer_wheel_block",
            "merge_rows",
            "host_workers",
        ):
            if f in d:
                setattr(e, f, int(d.pop(f)))
        if d:
            raise ConfigError(f"unknown experimental options: {sorted(d)}")
        e.validate()
        return e


def parse_merge_gears(mg: Any) -> Any:
    """Shape-check `experimental.merge_gears` as the JAX package does:
    "off"/0/None/False -> 0, "auto"/True -> "auto", an int or a list of
    positive ints as given (range-checked against the send budget when the
    ladder is resolved, `core.gears.resolve_gear_ladder`)."""
    if isinstance(mg, str):
        if mg.lower() not in ("auto", "off"):
            raise ConfigError(
                f"experimental.merge_gears must be off|auto|int|[ints], got {mg!r}"
            )
        return 0 if mg.lower() == "off" else "auto"
    if isinstance(mg, list):
        if not all(isinstance(g, int) and g > 0 for g in mg):
            raise ConfigError(
                f"experimental.merge_gears list entries must be positive ints, got {mg!r}"
            )
    elif mg is not None and not isinstance(mg, (int, bool)):
        raise ConfigError(
            f"experimental.merge_gears must be off|auto|int|[ints], got {mg!r}"
        )
    return mg or 0


@dataclass
class FluidClassOptions:
    """One background traffic class of the fluid plane (net/fluid.py):
    an aggregate src-zone -> dst-zone demand active over [start, end).
    Zones are graph node ids; the class occupies both zones' access
    links."""

    src_zone: int = 0
    dst_zone: int = 0
    rate: int = 0  # offered demand while active, bits/sec
    start: int = 0  # ns
    end: int = 0  # ns; 0 = the simulation horizon

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FluidClassOptions":
        d = dict(d)
        if "rate" not in d:
            raise ConfigError("fluid.classes entries need a rate")
        d.pop("name", None)  # labels are allowed, purely documentary
        c = FluidClassOptions(
            src_zone=int(d.pop("src_zone", 0)),
            dst_zone=int(d.pop("dst_zone", 0)),
            rate=parse_bits_per_sec(d.pop("rate")),
            start=parse_time_ns(d.pop("start", 0), TimeUnit.SEC),
            end=parse_time_ns(d.pop("end", 0), TimeUnit.SEC),
        )
        if c.rate <= 0:
            raise ConfigError(
                f"fluid.classes: rate must be > 0, got {c.rate}"
            )
        if c.end and c.end <= c.start:
            raise ConfigError(
                f"fluid.classes: end {c.end} <= start {c.start}"
            )
        if d:
            raise ConfigError(f"unknown fluid class options: {sorted(d)}")
        return c


@dataclass
class FluidOptions:
    """The fluid traffic plane (net/fluid.py): background-flow rate ODEs
    advanced once per round, coupled to the packet engine — background
    utilization inflates foreground latency (>= 1.0x) and optionally
    loss, while measured foreground bytes subtract from fluid capacity.
    With no classes the engine runs no fluid code."""

    # per-link (graph-node access aggregate) capacity, bits/sec
    link_capacity: int = parse_bits_per_sec("1 Gbit")
    # rate-relaxation time constant of the forward-Euler ODE (ns)
    tau: int = parse_time_ns("50 ms")
    # offered utilization where coupling starts ramping (RED min-th)
    util_threshold: float = 0.7
    # extra foreground loss probability at full overload (0 = coupling
    # is latency-only)
    loss_max: float = 0.0
    # foreground latency multiplier at full overload; >= 1.0 (inflation
    # only — deflation would break the conservative-lookahead bound)
    latency_factor_max: float = 2.0
    seed: int | None = None  # None = general.seed (the loss-draw hash)
    classes: list[FluidClassOptions] = field(default_factory=list)

    @property
    def active(self) -> bool:
        return bool(self.classes)

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "FluidOptions":
        d = dict(d or {})
        seed = d.pop("seed", None)
        f = FluidOptions(
            link_capacity=parse_bits_per_sec(
                d.pop("link_capacity", "1 Gbit")
            ),
            tau=parse_time_ns(d.pop("tau", "50 ms"), TimeUnit.MS),
            util_threshold=float(d.pop("util_threshold", 0.7)),
            loss_max=float(d.pop("loss_max", 0.0)),
            latency_factor_max=float(d.pop("latency_factor_max", 2.0)),
            seed=int(seed) if seed is not None else None,
            classes=[
                FluidClassOptions.from_dict(c)
                for c in d.pop("classes", []) or []
            ],
        )
        f.validate()
        if d:
            raise ConfigError(f"unknown fluid options: {sorted(d)}")
        return f

    def validate(self) -> None:
        """The JAX package's range checks (re-run after CLI overrides)."""
        if self.link_capacity <= 0:
            raise ConfigError(
                f"fluid.link_capacity must be > 0, got {self.link_capacity}"
            )
        if self.tau <= 0:
            raise ConfigError(f"fluid.tau must be > 0, got {self.tau}")
        if not 0.0 <= self.util_threshold < 1.0:
            raise ConfigError(
                f"fluid.util_threshold must be in [0, 1), "
                f"got {self.util_threshold}"
            )
        if not 0.0 <= self.loss_max <= 1.0:
            raise ConfigError(
                f"fluid.loss_max must be in [0, 1], got {self.loss_max}"
            )
        if self.latency_factor_max < 1.0:
            raise ConfigError(
                f"fluid.latency_factor_max must be >= 1.0 (got "
                f"{self.latency_factor_max}; deflation would shrink latency "
                f"below the conservative-lookahead bound)"
            )


@dataclass
class FaultChurnOptions:
    """Seeded host-churn: each host crashes once with probability `prob`
    at a uniform time in [bootstrap_end_time, stop_time), down for an
    exponential draw around `mean_downtime`."""

    prob: float = 0.0
    mean_downtime: int = parse_time_ns("1 s")  # ns

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "FaultChurnOptions | None":
        if d is None:
            return None
        d = dict(d)
        c = FaultChurnOptions(
            prob=float(d.pop("prob", 0.0)),
            mean_downtime=parse_time_ns(d.pop("mean_downtime", "1 s"), TimeUnit.SEC),
        )
        if not 0.0 <= c.prob <= 1.0:
            raise ConfigError(
                f"faults.host_churn.prob must be in [0, 1], got {c.prob}"
            )
        if d:
            raise ConfigError(f"unknown host_churn options: {sorted(d)}")
        return c


@dataclass
class FaultCrash:
    """One explicit host outage: down at `down_at`, back at `up_at`."""

    host: Any = 0  # host id (int) or host name (str)
    down_at: int = 0  # ns
    up_at: int = 0  # ns

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FaultCrash":
        d = dict(d)
        if "host" not in d or "down_at" not in d or "up_at" not in d:
            raise ConfigError(
                "faults.crashes entries need host, down_at, up_at"
            )
        c = FaultCrash(
            host=d.pop("host"),
            down_at=parse_time_ns(d.pop("down_at"), TimeUnit.SEC),
            up_at=parse_time_ns(d.pop("up_at"), TimeUnit.SEC),
        )
        if c.up_at <= c.down_at:
            raise ConfigError(
                f"faults.crashes: up_at must be > down_at (host {c.host!r})"
            )
        if d:
            raise ConfigError(f"unknown crash options: {sorted(d)}")
        return c


@dataclass
class FaultLossWindow:
    """A link-fault window: extra packet-loss probability and a latency
    multiplier active over [start, end). latency_factor must be >= 1.0 —
    deflation would break the conservative-lookahead bound."""

    start: int = 0  # ns
    end: int = 0  # ns
    loss: float = 0.0
    latency_factor: float = 1.0

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FaultLossWindow":
        d = dict(d)
        if "start" not in d or "end" not in d:
            raise ConfigError("faults.loss_windows entries need start, end")
        w = FaultLossWindow(
            start=parse_time_ns(d.pop("start"), TimeUnit.SEC),
            end=parse_time_ns(d.pop("end"), TimeUnit.SEC),
            loss=float(d.pop("loss", 0.0)),
            latency_factor=float(d.pop("latency_factor", 1.0)),
        )
        if w.end <= w.start:
            raise ConfigError("faults.loss_windows: end must be > start")
        if not 0.0 <= w.loss <= 1.0:
            raise ConfigError(
                f"faults.loss_windows: loss must be in [0, 1], got {w.loss}"
            )
        if w.latency_factor < 1.0:
            raise ConfigError(
                f"faults.loss_windows: latency_factor must be >= 1.0 "
                f"(got {w.latency_factor}; deflation would shrink latency "
                f"below the conservative-lookahead bound)"
            )
        if d:
            raise ConfigError(f"unknown loss_window options: {sorted(d)}")
        return w


@dataclass
class SupervisorOptions:
    """Crash-resilient run supervisor (core/supervisor.py): periodic
    device snapshots of the sim state, retry-with-backoff on dispatch
    failure, replay from the last good snapshot with a digest cross-check,
    graceful abort after bounded retries. 0 snapshot interval = off."""

    snapshot_every_chunks: int = 0
    checkpoint_file: str | None = None  # on-disk .npz, relative to data dir
    max_retries: int = 3
    backoff_base_ms: int = 50

    @property
    def enabled(self) -> bool:
        return self.snapshot_every_chunks > 0

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "SupervisorOptions":
        d = dict(d or {})
        s = SupervisorOptions(
            snapshot_every_chunks=int(d.pop("snapshot_every_chunks", 0)),
            checkpoint_file=d.pop("checkpoint_file", None),
            max_retries=int(d.pop("max_retries", 3)),
            backoff_base_ms=int(d.pop("backoff_base_ms", 50)),
        )
        if s.snapshot_every_chunks < 0:
            raise ConfigError(
                f"faults.supervisor.snapshot_every_chunks must be >= 0, "
                f"got {s.snapshot_every_chunks}"
            )
        if s.max_retries < 0:
            raise ConfigError(
                f"faults.supervisor.max_retries must be >= 0, "
                f"got {s.max_retries}"
            )
        if s.backoff_base_ms < 0:
            raise ConfigError(
                f"faults.supervisor.backoff_base_ms must be >= 0, "
                f"got {s.backoff_base_ms}"
            )
        if s.checkpoint_file is not None and not str(s.checkpoint_file):
            raise ConfigError(
                "faults.supervisor.checkpoint_file must be non-empty "
                "(use null to disable)"
            )
        if d:
            raise ConfigError(f"unknown supervisor options: {sorted(d)}")
        return s


@dataclass
class FaultOptions:
    """The fault plane (core/faults.py): deterministic in-sim fault
    injection plus the crash-resilient run supervisor (core/supervisor.py).
    Everything is seeded and bit-reproducible: same fault seed => same
    digests, across reruns and a mid-run snapshot restore. With the block
    absent the engine runs no fault lane and allocates none."""

    seed: int | None = None  # None = general.seed
    # what happens to a crashed host's pending events at/during the
    # outage: "hold" defers them to the restart (the CPU-model busy-floor
    # mechanics); "clear" drops every event whose execution time falls in
    # a down window (counted in stats.faults_dropped)
    restart_queue: str = "hold"
    host_churn: FaultChurnOptions | None = None
    crashes: list[FaultCrash] = field(default_factory=list)
    loss_windows: list[FaultLossWindow] = field(default_factory=list)
    supervisor: SupervisorOptions = field(default_factory=SupervisorOptions)

    @property
    def injecting(self) -> bool:
        """True when the block schedules any in-sim fault."""
        return bool(
            (self.host_churn is not None and self.host_churn.prob > 0)
            or self.crashes
            or self.loss_windows
        )

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "FaultOptions":
        d = dict(d or {})
        seed = d.pop("seed", None)
        f = FaultOptions(
            seed=int(seed) if seed is not None else None,
            restart_queue=str(d.pop("restart_queue", "hold")),
            host_churn=FaultChurnOptions.from_dict(d.pop("host_churn", None)),
            crashes=[FaultCrash.from_dict(c) for c in d.pop("crashes", []) or []],
            loss_windows=[
                FaultLossWindow.from_dict(w)
                for w in d.pop("loss_windows", []) or []
            ],
            supervisor=SupervisorOptions.from_dict(d.pop("supervisor", None)),
        )
        if f.restart_queue not in ("hold", "clear"):
            raise ConfigError(
                f"faults.restart_queue must be hold|clear, "
                f"got {f.restart_queue!r}"
            )
        if d:
            raise ConfigError(f"unknown faults options: {sorted(d)}")
        return f


@dataclass
class IntegrityOptions:
    """The integrity sentinel (core/integrity.py): per-round invariant
    guards run only when `enabled` — conservation laws the state must
    satisfy regardless of workload (time monotonicity, queue fill-cache
    agreement, counter monotonicity, outbox bounds, dual-digest
    virginity). With the block absent or off the engine runs no sentinel
    kernel and allocates no sentinel lane.

    On a violation the chunk aborts at the violating round and the
    driver restores the pre-chunk snapshot and replays: a violation
    reproducing with the same (shard, round, bitmask) signature is a
    DETERMINISTIC engine bug -> loud IntegrityAbort naming the
    invariant, round, and shard; one that does not reproduce is
    transient silent data corruption -> counted in sim-stats
    integrity{transients,replays}, logged, and the run continues."""

    enabled: bool = False
    # second, independently-folded per-host digest lane (stats.digest2)
    # so a scribble on the digest plane itself is detectable
    # (core/integrity.classify_digest_pair)
    dual_digest: bool = True
    # consecutive non-reproducing violation replays of ONE chunk before
    # the sentinel gives up (violations persisting without ever
    # reproducing still stop the run — progress must stay bounded)
    max_replays: int = 3

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "IntegrityOptions":
        d = dict(d or {})
        o = IntegrityOptions(
            enabled=bool(d.pop("enabled", False)),
            dual_digest=bool(d.pop("dual_digest", True)),
            max_replays=int(d.pop("max_replays", 3)),
        )
        if o.max_replays < 1:
            raise ConfigError(
                f"integrity.max_replays must be >= 1, got {o.max_replays}"
            )
        if d:
            raise ConfigError(f"unknown integrity options: {sorted(d)}")
        return o


@dataclass
class PressureOptions:
    """The pressure plane (core/pressure.py, a copy of the JAX package's
    options): what happens when a fixed-shape lane would drop for capacity
    (queue-push overflow, the exchange's overflow, outbox overflow,
    per-host send-budget drops).

      drop      — the default: drops are counted and the run goes on; no
                  pressure code runs.
      escalate  — drop-free: the chunk stops at the first dropping round,
                  the run loop restores the pre-chunk snapshot, regrows the
                  queue capacity and/or outbox width one geometric rung
                  (growth_factor) and replays; bounded by max_capacity /
                  max_outbox; also proactive at chunk boundaries once
                  occupancy crosses `headroom`.
      abort     — stop at the first dropping round and report it.
    """

    policy: str = "drop"  # drop | escalate | abort
    # escalation ceilings: 0 = auto (8x the initial queue capacity / 4x the
    # initial send budget)
    max_capacity: int = 0  # queue slots per host
    max_outbox: int = 0  # sends per host per round
    growth_factor: int = 2  # geometric rung ratio (>= 2 keeps a bucketed
    # queue's block divisibility: C * 2^k stays divisible by B)
    # proactive-regrow threshold: grow at a chunk boundary once the
    # occupancy high-water reaches ceil(headroom * capacity) (and the outbox
    # once a chunk's send high-water fills the budget); 0 disables it
    headroom: float = 0.85
    # the memory guard's safety factor on a rung's predicted bytes (the
    # guard runs with the memory observatory on: obs/memory.py MemoryGuard)
    memory_safety_factor: float = 1.25

    @property
    def active(self) -> bool:
        return self.policy != "drop"

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "PressureOptions":
        d = dict(d or {})
        p = PressureOptions(
            policy=str(d.pop("policy", "drop")),
            max_capacity=int(d.pop("max_capacity", 0)),
            max_outbox=int(d.pop("max_outbox", 0)),
            growth_factor=int(d.pop("growth_factor", 2)),
            headroom=float(d.pop("headroom", 0.85)),
            memory_safety_factor=float(d.pop("memory_safety_factor", 1.25)),
        )
        if p.policy not in ("drop", "escalate", "abort"):
            raise ConfigError(
                f"pressure.policy must be drop|escalate|abort, "
                f"got {p.policy!r}"
            )
        if p.max_capacity < 0 or p.max_outbox < 0:
            raise ConfigError(
                f"pressure ceilings must be >= 0 (0 = auto), got "
                f"max_capacity={p.max_capacity} max_outbox={p.max_outbox}"
            )
        if p.growth_factor < 2:
            raise ConfigError(
                f"pressure.growth_factor must be >= 2, "
                f"got {p.growth_factor}"
            )
        if not 0.0 <= p.headroom <= 1.0:
            raise ConfigError(
                f"pressure.headroom must be in [0, 1] (0 disables "
                f"proactive regrow), got {p.headroom}"
            )
        if p.memory_safety_factor < 1.0:
            raise ConfigError(
                f"pressure.memory_safety_factor must be >= 1.0 (a factor "
                f"below 1 would admit rungs past measured headroom), "
                f"got {p.memory_safety_factor}"
            )
        if d:
            raise ConfigError(f"unknown pressure options: {sorted(d)}")
        return p


@dataclass
class ObservabilityOptions:
    """The observability plane's knobs (the JAX package's, parsed and
    validated as there, error texts included). Every knob is an observer:
    digests, event counts and drop counters are bit-identical on or off."""

    # the round trace ring (obs/tracer.py): one row per scheduling round,
    # drained at chunk boundaries; exported to these paths under
    # general.data_directory (null skips that export)
    trace: bool = False
    trace_file: str | None = "trace.json"  # Chrome-trace/Perfetto JSON
    metrics_file: str | None = "metrics.prom"  # Prometheus text
    # wrap the run loop in torch.profiler, writing its trace here
    profile_dir: str | None = None
    # the memory observatory (obs/memory.py): per-chunk device-memory
    # samples, the byte model, the `memory{}` block and `hbm=`
    memory: bool = False
    # the network observatory (obs/netobs.py): event classes, the flow
    # ledger (models with a flow port), per-link folds, the safe window
    network: bool = False
    # flow-ledger ring capacity in records (0 = no ledger)
    network_flows: int = 4096
    # the per-shape ledger in the memory{} block
    memory_ledger: bool = True
    # the runtime observatory (obs/runtime.py): wall-clock spans, the
    # kernel-build ledger, the `runtime{}` block and `rt=`
    runtime: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "ObservabilityOptions":
        d = dict(d or {})
        o = ObservabilityOptions(
            trace=bool(d.pop("trace", False)),
            trace_file=d.pop("trace_file", "trace.json"),
            metrics_file=d.pop("metrics_file", "metrics.prom"),
            profile_dir=d.pop("profile_dir", None),
            memory=bool(d.pop("memory", False)),
            network=bool(d.pop("network", False)),
            network_flows=int(d.pop("network_flows", 4096)),
            memory_ledger=bool(d.pop("memory_ledger", True)),
            runtime=bool(d.pop("runtime", False)),
        )
        if o.network_flows < 0:
            raise ConfigError(
                f"observability.network_flows must be >= 0 (0 = no flow "
                f"ledger, event classes and safe-window only), "
                f"got {o.network_flows}"
            )
        # null disables an export; a non-null value must be a usable path
        for f in ("trace_file", "metrics_file", "profile_dir"):
            v = getattr(o, f)
            if v is not None:
                v = str(v)
                setattr(o, f, v)
                if not v:
                    raise ConfigError(
                        f"observability.{f} must be non-empty (use null "
                        f"to disable)"
                    )
        if d:
            raise ConfigError(f"unknown observability options: {sorted(d)}")
        return o


@dataclass
class CampaignOptions:
    """The ensemble plane's sweep declaration (the JAX package's, copied:
    core/ensemble.py + campaign.py): one folded round loop advances R
    replicas — seed sweeps, fault-schedule sweeps, A/B override pairs —
    with each replica bit-identical to its solo run.

    Replicas are the CROSS PRODUCT of the declared axes (an omitted axis
    contributes the base config), in (seed, fault_schedule, override)
    nesting order — so replica indices are stable and documentable:
    index = ((seed_i * len(fault_schedules)) + fault_i) * len(overrides)
    + override_i."""

    # seed axis: explicit list, or {start: S, count: N} for a range;
    # empty = [general.seed]
    seeds: list[int] = field(default_factory=list)
    # fault-schedule axis: each entry is a full `faults:` block (injection
    # fields only — the campaign's supervisor comes from the top-level
    # faults block), kept as the RAW mapping (validated at parse) because
    # the campaign driver expands replicas at the config-dict level;
    # empty = [the top-level faults block]
    fault_schedules: list[dict] = field(default_factory=list)
    # override axis: each entry maps dotted config paths to values
    # (the merge_cli_overrides syntax), e.g. {"experimental.cpu_delay": 2}.
    # Only values that change ARRAYS may vary — anything that changes an
    # EngineConfig static (shapes, queue layout, K, policies) is rejected
    # at build time. empty = [{}]
    overrides: list[dict] = field(default_factory=list)
    # replica index pairs expected to end bit-identical (A/A controls, or
    # A/B pairs whose delta should be inert); a pair that diverges is
    # reported in the ledger and — when `bisect` is on — pinpointed to
    # its first divergent chunk by snapshot-replay binary search
    expect_identical: list[list[int]] = field(default_factory=list)
    # per-replica digest ledger, written into general.data_directory
    # (null disables)
    ledger_file: str | None = "campaign-ledger.json"
    bisect: bool = True
    # replica-COUNT cap (cheap parse-time line of defense). The real memory
    # guard is memory-informed at build time: campaign.py computes R x
    # per-replica state bytes (obs/memory.py) against the measured device
    # capacity and rejects with the predicted numbers.
    max_replicas: int = 64

    @property
    def active(self) -> bool:
        """True when the block declares any sweep axis."""
        return bool(self.seeds or self.fault_schedules or self.overrides)

    @property
    def num_replicas(self) -> int:
        return (
            max(len(self.seeds), 1)
            * max(len(self.fault_schedules), 1)
            * max(len(self.overrides), 1)
        )

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "CampaignOptions":
        d = dict(d or {})
        seeds_raw = d.pop("seeds", []) or []
        if isinstance(seeds_raw, dict):
            sd = dict(seeds_raw)
            start, count = int(sd.pop("start", 1)), int(sd.pop("count", 0))
            if sd:
                raise ConfigError(f"unknown campaign.seeds keys: {sorted(sd)}")
            if count < 1:
                raise ConfigError(
                    f"campaign.seeds.count must be >= 1, got {count}"
                )
            seeds = list(range(start, start + count))
        else:
            seeds = [int(s) for s in seeds_raw]
        scheds = []
        for i, f in enumerate(d.pop("fault_schedules", []) or []):
            f = dict(f or {})
            parsed = FaultOptions.from_dict(f)  # loud validation up front
            if parsed.supervisor.enabled or parsed.supervisor.checkpoint_file:
                raise ConfigError(
                    f"campaign.fault_schedules[{i}]: supervisor settings "
                    f"belong in the top-level faults block (the supervisor "
                    f"wraps the whole campaign, not one replica)"
                )
            scheds.append(f)
        overrides = []
        for i, ov in enumerate(d.pop("overrides", []) or []):
            if ov is None:
                ov = {}
            if not isinstance(ov, dict):
                raise ConfigError(
                    f"campaign.overrides[{i}] must be a mapping of dotted "
                    f"config paths to values, got {ov!r}"
                )
            overrides.append(dict(ov))
        pairs = []
        for i, p in enumerate(d.pop("expect_identical", []) or []):
            if (
                not isinstance(p, (list, tuple))
                or len(p) != 2
                or not all(isinstance(x, int) and x >= 0 for x in p)
            ):
                raise ConfigError(
                    f"campaign.expect_identical[{i}] must be a pair of "
                    f"replica indices, got {p!r}"
                )
            pairs.append([int(p[0]), int(p[1])])
        c = CampaignOptions(
            seeds=seeds,
            fault_schedules=scheds,
            overrides=overrides,
            expect_identical=pairs,
            ledger_file=d.pop("ledger_file", "campaign-ledger.json"),
            bisect=bool(d.pop("bisect", True)),
            max_replicas=int(d.pop("max_replicas", 64)),
        )
        if c.ledger_file is not None and not str(c.ledger_file):
            raise ConfigError(
                "campaign.ledger_file must be non-empty (use null to disable)"
            )
        if c.max_replicas < 1:
            raise ConfigError(
                f"campaign.max_replicas must be >= 1, got {c.max_replicas}"
            )
        if c.active and c.num_replicas > c.max_replicas:
            raise ConfigError(
                f"campaign declares {c.num_replicas} replicas, over "
                f"max_replicas={c.max_replicas} (each replica holds a full "
                f"SimState in device memory; raise the guard deliberately)"
            )
        for p in c.expect_identical:
            if max(p) >= c.num_replicas:
                raise ConfigError(
                    f"campaign.expect_identical pair {p} references a "
                    f"replica >= num_replicas={c.num_replicas}"
                )
        if d:
            raise ConfigError(f"unknown campaign options: {sorted(d)}")
        return c


@dataclass
class ProcessOptions:
    """A device model (`model`, `model_args`) or a managed process (`path`
    naming a registered program, with `args`, `environment` and
    `expected_final_state`: "running" | {"exited": code} | {"signaled":
    sig})."""

    start_time: int = 0  # ns
    shutdown_time: int | None = None
    model: str | None = None
    model_args: dict[str, Any] = field(default_factory=dict)
    path: str | None = None
    args: list[str] = field(default_factory=list)
    environment: dict[str, str] = field(default_factory=dict)
    expected_final_state: Any = "running"

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ProcessOptions":
        d = dict(d)
        p = ProcessOptions(
            path=d.pop("path", None),
            args=_split_args(d.pop("args", [])),
            environment=dict(d.pop("environment", {}) or {}),
            start_time=parse_time_ns(d.pop("start_time", 0), TimeUnit.SEC),
            shutdown_time=(
                parse_time_ns(d["shutdown_time"], TimeUnit.SEC)
                if d.get("shutdown_time") is not None
                else None
            ),
            expected_final_state=d.pop("expected_final_state", "running"),
            model=d.pop("model", None),
            model_args=dict(d.pop("model_args", {}) or {}),
        )
        d.pop("shutdown_time", None)
        if p.path is None and p.model is None:
            raise ConfigError("process needs either `path` (managed) or `model` (device)")
        if p.model is not None:
            p.model = str(p.model)
        if d:
            raise ConfigError(f"unknown process options: {sorted(d)}")
        return p


def _split_args(args: Any) -> list[str]:
    if isinstance(args, str):
        return args.split()
    return [str(a) for a in (args or [])]


@dataclass
class HostDefaultOptions:
    """Per-host options, cascaded from `host_option_defaults` to each
    host's `host_options`: the CPU host plane's pcap capture and TCP socket
    knobs (device models ignore them)."""

    log_level: str | None = None
    pcap_enabled: bool = False
    pcap_capture_size: int = 65535
    tcp_send_buffer: int = 256 * 1024  # bytes ("256 KiB" accepted)
    tcp_recv_buffer: int = 256 * 1024
    tcp_autotune: bool = True  # grow buffers under pressure up to buf_max
    tcp_buffer_max: int = 4 * 1024 * 1024
    tcp_sack: bool = True
    tcp_delayed_ack: bool = True
    tcp_nagle: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "HostDefaultOptions":
        from shadow_tpu_torch.config.units import parse_bytes

        d = dict(d or {})
        h = HostDefaultOptions(
            log_level=d.pop("log_level", None),
            pcap_enabled=bool(d.pop("pcap_enabled", False)),
            pcap_capture_size=int(d.pop("pcap_capture_size", 65535)),
            tcp_send_buffer=parse_bytes(d.pop("tcp_send_buffer", 256 * 1024)),
            tcp_recv_buffer=parse_bytes(d.pop("tcp_recv_buffer", 256 * 1024)),
            tcp_autotune=bool(d.pop("tcp_autotune", True)),
            tcp_buffer_max=parse_bytes(d.pop("tcp_buffer_max", 4 * 1024 * 1024)),
            tcp_sack=bool(d.pop("tcp_sack", True)),
            tcp_delayed_ack=bool(d.pop("tcp_delayed_ack", True)),
            tcp_nagle=bool(d.pop("tcp_nagle", False)),
        )
        if d:
            raise ConfigError(f"unknown host default options: {sorted(d)}")
        return h

    def tcp_config(self):
        """The per-host TcpConfig these options describe."""
        from shadow_tpu_torch.tcp import TcpConfig

        return TcpConfig(
            send_buf=self.tcp_send_buffer,
            recv_buf=self.tcp_recv_buffer,
            autotune=self.tcp_autotune,
            buf_max=self.tcp_buffer_max,
            sack=self.tcp_sack,
            delayed_ack=self.tcp_delayed_ack,
            nagle=self.tcp_nagle,
        )


@dataclass
class HostOptions:
    name: str = ""
    network_node_id: int = 0
    count: int = 1
    ip_addr: str | None = None
    bandwidth_down: int | None = None  # bits/sec; falls back to graph node
    bandwidth_up: int | None = None
    processes: list[ProcessOptions] = field(default_factory=list)
    host_options: HostDefaultOptions = field(default_factory=HostDefaultOptions)

    @staticmethod
    def from_dict(name: str, d: dict[str, Any], defaults: HostDefaultOptions) -> "HostOptions":
        d = dict(d)
        overrides = d.pop("host_options", {}) or {}
        for k in overrides:
            if not hasattr(defaults, k):
                raise ConfigError(f"unknown host option {k!r}")
        merged = HostDefaultOptions.from_dict({**dataclasses.asdict(defaults), **overrides})
        bw_down = d.pop("bandwidth_down", None)
        bw_up = d.pop("bandwidth_up", None)
        h = HostOptions(
            name=name,
            network_node_id=int(d.pop("network_node_id", 0)),
            count=int(d.pop("count", 1)),
            ip_addr=d.pop("ip_addr", None),
            bandwidth_down=parse_bits_per_sec(bw_down) if bw_down is not None else None,
            bandwidth_up=parse_bits_per_sec(bw_up) if bw_up is not None else None,
            processes=[ProcessOptions.from_dict(p) for p in d.pop("processes", [])],
            host_options=merged,
        )
        if d:
            raise ConfigError(f"unknown host options for {name!r}: {sorted(d)}")
        return h


@dataclass
class ConfigOptions:
    general: GeneralOptions = field(default_factory=GeneralOptions)
    network: NetworkOptions = field(default_factory=NetworkOptions)
    experimental: ExperimentalOptions = field(default_factory=ExperimentalOptions)
    host_option_defaults: HostDefaultOptions = field(default_factory=HostDefaultOptions)
    hosts: list[HostOptions] = field(default_factory=list)
    fluid: FluidOptions = field(default_factory=FluidOptions)
    faults: FaultOptions = field(default_factory=FaultOptions)
    integrity: IntegrityOptions = field(default_factory=IntegrityOptions)
    pressure: PressureOptions = field(default_factory=PressureOptions)
    observability: ObservabilityOptions = field(default_factory=ObservabilityOptions)
    campaign: CampaignOptions = field(default_factory=CampaignOptions)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ConfigOptions":
        d = dict(d)
        if "general" not in d:
            raise ConfigError("`general` section is required")
        campaign = CampaignOptions.from_dict(d.pop("campaign", None))
        observability = ObservabilityOptions.from_dict(d.pop("observability", None))
        pressure = PressureOptions.from_dict(d.pop("pressure", None))
        fluid = FluidOptions.from_dict(d.pop("fluid", None))
        faults = FaultOptions.from_dict(d.pop("faults", None))
        integrity = IntegrityOptions.from_dict(d.pop("integrity", None))
        defaults = HostDefaultOptions.from_dict(d.pop("host_option_defaults", None))
        hosts: list[HostOptions] = []
        for name, hd in (d.pop("hosts", {}) or {}).items():
            h = HostOptions.from_dict(name, hd or {}, defaults)
            if h.count == 1:
                hosts.append(h)
            else:
                for i in range(1, h.count + 1):
                    hi = copy.deepcopy(h)
                    hi.name = f"{name}{i}"
                    hi.count = 1
                    hosts.append(hi)
        cfg = ConfigOptions(
            general=GeneralOptions.from_dict(d.pop("general")),
            network=NetworkOptions.from_dict(d.pop("network", None)),
            experimental=ExperimentalOptions.from_dict(d.pop("experimental", None)),
            host_option_defaults=defaults,
            hosts=hosts,
            fluid=fluid,
            faults=faults,
            integrity=integrity,
            pressure=pressure,
            observability=observability,
            campaign=campaign,
        )
        if d:
            raise ConfigError(f"unknown top-level sections: {sorted(d)}")
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """Checks that CLI overrides can also trip, re-run after merging."""
        if self.general.parallelism > 1:
            self.check_world(self.general.parallelism)
        if config_is_cosim(self):
            self.check_cosim()
        else:
            # the CPU host plane's captures: a modeled config has none
            if self.host_option_defaults.pcap_enabled or any(
                    h.host_options.pcap_enabled for h in self.hosts):
                raise _unsupported("pcap_enabled", "on a config with no managed process")
            if self.general.log_file is not None:
                raise _unsupported("general.log_file", "on a config with no managed process")
        self.experimental.validate()
        self.fluid.validate()

    def check_cosim(self) -> None:
        """Refuse, on a co-simulation config, what the port's bridge does
        not run yet (each names its knob)."""
        for h in self.hosts:
            for p in h.processes:
                if p.path is not None and "/" in p.path:
                    raise _unsupported(
                        f"host {h.name!r}: a real binary (`path: {p.path}`)",
                        "the native managed-process plane; registered coroutine programs run")
        if self.general.parallelism > 1:
            raise _unsupported(f"general.parallelism={self.general.parallelism} with a "
                               f"managed process", "the co-simulation bridge runs on one device")
        if parse_merge_gears(self.experimental.merge_gears):
            raise _unsupported("experimental.merge_gears with a managed process")
        if self.faults.supervisor.enabled:
            raise _unsupported("faults.supervisor with a managed process")
        if self.integrity.enabled:
            raise _unsupported("integrity with a managed process")
        if self.pressure.policy == "abort":
            raise _unsupported("pressure.policy=abort with a managed process")
        obs = self.observability
        for knob, on in (("trace", obs.trace), ("network", obs.network),
                         ("memory", obs.memory), ("runtime", obs.runtime),
                         ("profile_dir", obs.profile_dir)):
            if on:
                raise _unsupported(f"observability.{knob} with a managed process")

    def check_world(self, world: int) -> None:
        """Refuse, at `world` > 1 ranks, the planes that run on one rank
        only."""
        if world <= 1:
            return
        world = f"world {world}"
        obs = self.observability
        for knob, on in (("trace", obs.trace), ("network", obs.network),
                         ("memory", obs.memory), ("runtime", obs.runtime),
                         ("profile_dir", obs.profile_dir)):
            if on:
                raise _unsupported(f"observability.{knob} with {world}",
                                   "the observatories run on one rank only")
        if self.faults.supervisor.checkpoint_file is not None:
            raise _unsupported(f"faults.supervisor.checkpoint_file with {world}",
                               "on-disk checkpoints and resume run on one rank only")
        if self.pressure.policy == "escalate":
            raise _unsupported(f"pressure.policy=escalate with {world}",
                               "the capacity migration runs on one rank only; "
                               "drop and abort run sharded")
        if self.campaign.active:
            raise ConfigError(
                "campaign: the ensemble plane runs world=1 this round "
                "(a replica axis over a device mesh is a 2-D mesh "
                "program); set general.parallelism to 1 or shard the "
                "campaign across processes")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def config_is_cosim(cfg: ConfigOptions) -> bool:
    """True if any host runs a managed process (`path:`)."""
    return any(p.path is not None for h in cfg.hosts for p in h.processes)


def load_config(path_or_text: str, *, is_text: bool = False) -> ConfigOptions:
    """Load a YAML config from a path (or inline text / '-' for stdin)."""
    if is_text:
        text = path_or_text
    elif path_or_text == "-":
        import sys

        text = sys.stdin.read()
    else:
        with open(path_or_text) as f:
            text = f.read()
    data = yaml.safe_load(text)
    if not isinstance(data, dict):
        raise ConfigError("config must be a YAML mapping")
    return ConfigOptions.from_dict(data)


def merge_cli_overrides(cfg: ConfigOptions, overrides: dict[str, str]) -> ConfigOptions:
    """Apply `--section.key=value` CLI overrides; CLI wins over file."""
    cfg = copy.deepcopy(cfg)
    for dotted, raw in overrides.items():
        parts = dotted.split(".")
        if parts[0] == "experimental" and len(parts) == 2 and parts[1] in _EXPERIMENTAL_OFF:
            ExperimentalOptions.from_dict({parts[1]: yaml.safe_load(raw)})
            continue
        obj: Any = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise ConfigError(f"unknown config path {dotted!r}")
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise ConfigError(f"unknown config path {dotted!r}")
        cur = getattr(obj, leaf)
        val: Any = yaml.safe_load(raw)
        try:
            if leaf.endswith("_time") or leaf in ("heartbeat_interval",):
                val = parse_time_ns(val, TimeUnit.SEC)
            elif leaf in ("runahead", "cpu_delay"):
                val = parse_time_ns(val, TimeUnit.MS)
            elif leaf.startswith("bandwidth_") or leaf == "link_capacity":
                val = parse_bits_per_sec(val)
            elif leaf == "tau":
                val = parse_time_ns(val, TimeUnit.MS)
            elif leaf == "merge_gears":
                pass  # polymorphic (off|auto|int|[ints]); validate() checks it
            elif isinstance(cur, bool):
                val = bool(val)
            elif isinstance(cur, int):
                val = int(val)
        except (TypeError, ValueError) as e:
            raise ConfigError(f"bad value for --{dotted}: {e}") from e
        setattr(obj, leaf, val)
    cfg.validate()
    if cfg.experimental.overflow_shed not in ("urgency", "append"):
        raise ConfigError(
            f"experimental.overflow_shed must be urgency|append, "
            f"got {cfg.experimental.overflow_shed!r}"
        )
    return cfg
