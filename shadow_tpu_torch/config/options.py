"""Config schema for the PyTorch port: the subset of the YAML/CLI surface
that the single-device round loop reads.

The schema is the JAX package's (`general`, `network.graph`,
`experimental`, `host_option_defaults`, `hosts` with device-model
`processes`), so one YAML file drives either package. Every knob the port
does not implement yet raises `ConfigError` naming the knob — a config is
never silently run with a plane switched off:

  - `general.parallelism > 1` (world > 1);
  - `experimental.merge_rows > 0`, `cpu_delay > 0`, `scheduler:
    cpu-reference`;
  - any non-empty `faults`, `fluid`, `pressure`, `integrity` or `campaign`
    block, and any enabled `observability` knob (`trace`, `network`, ...);
  - `pcap_enabled`, managed processes (`path:`), and models other than
    phold, udp_echo, timer and tgen_tcp (checked when the simulation is
    built).

`experimental.event_queue_block` (the bucketed queue),
`microstep_events` (K events per host per microstep), `timer_wheel`,
`merge_gears` (off | auto | an int | a list of ints: the exchange's column
widths, resolved against the send budget by `core/gears.py`) and
`merge_scatter` (the sort-free exchange merge) are accepted with the JAX
package's validation: the block is >= 0 and divides the queue capacity,
K >= 1, and the gears' list entries are positive ints.

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
    parallelism: int = 0  # 0 or 1: one device (the only mode of this port)
    data_directory: str = "shadow.data"
    heartbeat_interval: int | None = parse_time_ns("1 s")
    progress: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "GeneralOptions":
        d = dict(d)
        if "stop_time" not in d:
            raise ConfigError("general.stop_time is required")
        heartbeat = d.pop("heartbeat_interval", "1 s")
        # accepted for schema compatibility, no effect on the device path
        for k in ("template_directory", "log_level",
                  "model_unblocked_syscall_latency"):
            d.pop(k, None)
        if d.pop("log_file", None) is not None:
            raise _unsupported("general.log_file")
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
    "merge_rows": 0,
    "cpu_delay": 0,
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

    def validate(self) -> None:
        """The JAX package's checks of the queue-shape knobs; the block's
        divisibility is checked here when the capacity is set explicitly,
        and by `check_queue_block` once an auto capacity is resolved."""
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
                if knob == "cpu_delay":
                    v = parse_time_ns(v, TimeUnit.MS)
                if v != off:
                    raise _unsupported(f"experimental.{knob}={v!r}")
        # the exchange kind only matters across devices; world 1 always
        # merges locally
        ex = d.pop("exchange", "auto")
        if ex not in ("auto", "gather", "alltoall", "hierarchical"):
            raise ConfigError(
                f"experimental.exchange must be auto|gather|alltoall|"
                f"hierarchical, got {ex!r}"
            )
        d.pop("a2a_block", None)
        e = ExperimentalOptions()
        if "runahead" in d:
            e.runahead = parse_time_ns(d.pop("runahead"), TimeUnit.MS)
        if "overflow_shed" in d:
            e.overflow_shed = str(d.pop("overflow_shed"))
        if e.overflow_shed not in ("urgency", "append"):
            raise ConfigError(
                f"experimental.overflow_shed must be urgency|append, "
                f"got {e.overflow_shed!r}"
            )
        if "merge_gears" in d:
            e.merge_gears = d.pop("merge_gears")
        for f in ("use_dynamic_runahead", "use_codel", "merge_scatter"):
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


def _reject_block(name: str, d: Any) -> None:
    """Optional planes of the JAX package: an absent or empty block is the
    plane switched off; anything else names what the port cannot run."""
    if not d:
        return
    if name == "observability":
        on = sorted(k for k, v in dict(d).items() if v)
        if on:
            raise _unsupported(f"observability.{on[0]}")
        return
    raise _unsupported(f"the `{name}` block")


@dataclass
class ProcessOptions:
    start_time: int = 0  # ns
    shutdown_time: int | None = None
    model: str = ""
    model_args: dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ProcessOptions":
        d = dict(d)
        if d.get("path") is not None:
            raise _unsupported("a managed process (`path:`)", "device models only")
        d.pop("path", None)
        for k in ("args", "environment", "expected_final_state"):
            d.pop(k, None)
        if d.get("model") is None:
            raise ConfigError("process needs a device `model`")
        p = ProcessOptions(
            start_time=parse_time_ns(d.pop("start_time", 0), TimeUnit.SEC),
            shutdown_time=(
                parse_time_ns(d["shutdown_time"], TimeUnit.SEC)
                if d.get("shutdown_time") is not None
                else None
            ),
            model=str(d.pop("model")),
            model_args=dict(d.pop("model_args", {}) or {}),
        )
        d.pop("shutdown_time", None)
        if d:
            raise ConfigError(f"unknown process options: {sorted(d)}")
        return p


@dataclass
class HostDefaultOptions:
    pcap_enabled: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "HostDefaultOptions":
        d = dict(d or {})
        h = HostDefaultOptions(pcap_enabled=bool(d.pop("pcap_enabled", False)))
        if h.pcap_enabled:
            raise _unsupported("pcap_enabled")
        # the CPU host plane's socket knobs do not apply to device models
        for k in list(d):
            if k == "log_level" or k.startswith("tcp_") or k == "pcap_capture_size":
                d.pop(k)
        if d:
            raise ConfigError(f"unknown host default options: {sorted(d)}")
        return h


@dataclass
class HostOptions:
    name: str = ""
    network_node_id: int = 0
    count: int = 1
    ip_addr: str | None = None
    bandwidth_down: int | None = None  # bits/sec; falls back to graph node
    bandwidth_up: int | None = None
    processes: list[ProcessOptions] = field(default_factory=list)

    @staticmethod
    def from_dict(name: str, d: dict[str, Any], defaults: HostDefaultOptions) -> "HostOptions":
        d = dict(d)
        HostDefaultOptions.from_dict(
            {**dataclasses.asdict(defaults), **(d.pop("host_options", {}) or {})}
        )
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

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ConfigOptions":
        d = dict(d)
        if "general" not in d:
            raise ConfigError("`general` section is required")
        for block in ("faults", "fluid", "pressure", "integrity", "campaign",
                      "observability"):
            _reject_block(block, d.pop(block, None))
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
        )
        if d:
            raise ConfigError(f"unknown top-level sections: {sorted(d)}")
        cfg.validate()
        return cfg

    def validate(self) -> None:
        """Checks that CLI overrides can also trip, re-run after merging."""
        if self.general.parallelism > 1:
            raise _unsupported(
                f"general.parallelism={self.general.parallelism}", "world > 1"
            )
        if self.host_option_defaults.pcap_enabled:
            raise _unsupported("pcap_enabled")
        self.experimental.validate()

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


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
            elif leaf == "runahead":
                val = parse_time_ns(val, TimeUnit.MS)
            elif leaf.startswith("bandwidth_"):
                val = parse_bits_per_sec(val)
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
