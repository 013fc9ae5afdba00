"""CPU-side host emulation plane (reference L2, `src/main/host/`).

This package is the simulated-Linux-kernel half of the framework: file
descriptors with observable state bits, pipes/eventfds/timerfds/epoll, UDP
and TCP sockets (TCP backed by `shadow_tpu_torch.tcp`), a per-host network
namespace with port demux, and *managed programs* — coroutine processes
driven by a per-host event loop in simulated time, blocking on syscall
conditions exactly like the reference's `SyscallCondition` web
(`host/syscall/condition.rs`, `syscall_condition.c`, `listener.rs`,
`callback_queue.rs`).

The device engine (`shadow_tpu_torch.core.engine`) simulates *modeled* hosts fully
on TPU; this plane simulates *emulated* hosts — ones running program logic
too irregular for vectorized dispatch — and couples to the same network
fabric either through the pure-CPU wire (`host.network`) or the device
co-simulation bridge (`shadow_tpu_torch.cosim`).
"""

from shadow_tpu_torch.host.filestate import CallbackQueue, FileState, StatusListener
from shadow_tpu_torch.host.descriptor import Descriptor, DescriptorTable, File
from shadow_tpu_torch.host.pipe import Pipe, create_pipe
from shadow_tpu_torch.host.eventfd import EventFd
from shadow_tpu_torch.host.timerfd import TimerFd
from shadow_tpu_torch.host.epoll import Epoll, EpollEvent
from shadow_tpu_torch.host.sockets import TcpListenerSocket, TcpSocket, UdpSocket
from shadow_tpu_torch.host.netns import NetworkNamespace
from shadow_tpu_torch.host.process import Blocked, ManagedProgram, Syscall
from shadow_tpu_torch.host.host import CpuHost, HostConfig

__all__ = [
    "Blocked",
    "CallbackQueue",
    "CpuHost",
    "Descriptor",
    "DescriptorTable",
    "Epoll",
    "EpollEvent",
    "EventFd",
    "File",
    "FileState",
    "HostConfig",
    "ManagedProgram",
    "NetworkNamespace",
    "Pipe",
    "StatusListener",
    "Syscall",
    "TcpListenerSocket",
    "TcpSocket",
    "TimerFd",
    "UdpSocket",
    "create_pipe",
]
