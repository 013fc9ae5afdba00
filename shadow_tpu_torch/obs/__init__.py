"""The observatories (port of shadow_tpu/obs/): the round trace ring
(`tracer`), the network observatory (`netobs`), the memory observatory
(`memory`), the runtime observatory (`runtime`) and the wall-clock phase
timers (`perf`), and the co-simulation bridge's CPU-plane captures: pcap
per interface (`pcap`), strace per process (`strace`) and the
sim-time-stamped log (`simlog`), copied from the JAX package. Their device
programs are ops/obs.py (K27, K28) and lanes of K10 and K17; everything
here is host-side."""

from shadow_tpu_torch.obs.memory import MemoryGuard, MemoryMonitor
from shadow_tpu_torch.obs.netobs import FlowCollector, FlowLedger
from shadow_tpu_torch.obs.pcap import PcapWriter, packet_bytes
from shadow_tpu_torch.obs.perf import PerfTimers
from shadow_tpu_torch.obs.runtime import BuildLedger, WallLedger
from shadow_tpu_torch.obs.simlog import SimLogger, format_sim_time
from shadow_tpu_torch.obs.strace import StraceLogger
from shadow_tpu_torch.obs.tracer import RoundTracer, TraceRing

__all__ = [
    "BuildLedger",
    "FlowCollector",
    "FlowLedger",
    "MemoryGuard",
    "MemoryMonitor",
    "PcapWriter",
    "PerfTimers",
    "RoundTracer",
    "SimLogger",
    "StraceLogger",
    "TraceRing",
    "WallLedger",
    "format_sim_time",
    "packet_bytes",
]
