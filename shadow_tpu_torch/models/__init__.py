"""Host application models, vectorized over all simulated hosts: `phold`,
`udp_echo`, `timer`, `tgen_tcp`, `gossip` and `circuit`; config
`processes: [{model: ...}]` resolves here. The co-simulation bridge's
device lanes are `hybrid` (the CPU-plane host's proxy) and `mixed`
(modeled and CPU-plane hosts on one device network). Each model's handler
is a hand-written CUDA kernel (K17-K22, K33; K34 at the mixed plane's
boundary; csrc/models.cu) beside its plain PyTorch version."""

from shadow_tpu_torch.models.base import (
    MODEL_REGISTRY,
    HandlerCtx,
    HandlerOut,
    LocalPush,
    Model,
    PacketSend,
    get_model,
    register_model,
)
from shadow_tpu_torch.models import circuit as _circuit  # noqa: F401  (registers)
from shadow_tpu_torch.models import echo as _echo  # noqa: F401
from shadow_tpu_torch.models import gossip as _gossip  # noqa: F401
from shadow_tpu_torch.models import hybrid as _hybrid  # noqa: F401
from shadow_tpu_torch.models import mixed as _mixed
from shadow_tpu_torch.models import phold as _phold  # noqa: F401
from shadow_tpu_torch.models import tgen as _tgen  # noqa: F401
from shadow_tpu_torch.models import timer as _timer  # noqa: F401

# every handler kernel's launch wrapper, by kernel name
KERNELS = {**_tgen.KERNELS, **_phold.KERNELS, **_echo.KERNELS, **_timer.KERNELS,
           **_gossip.KERNELS, **_circuit.KERNELS, **_hybrid.KERNELS, **_mixed.KERNELS}

__all__ = [
    "MODEL_REGISTRY",
    "HandlerCtx",
    "HandlerOut",
    "KERNELS",
    "LocalPush",
    "Model",
    "PacketSend",
    "get_model",
    "register_model",
]
