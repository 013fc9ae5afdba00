"""Host application models, vectorized over all simulated hosts: `phold`,
`udp_echo`, `timer` and `tgen_tcp`; config `processes: [{model: ...}]`
resolves here."""

from shadow_tpu_torch.models.base import (
    MODEL_REGISTRY,
    FlowDone,
    HandlerCtx,
    HandlerOut,
    LocalPush,
    Model,
    PacketSend,
    get_model,
    register_model,
)
from shadow_tpu_torch.models import echo as _echo  # noqa: F401  (registers)
from shadow_tpu_torch.models import phold as _phold  # noqa: F401
from shadow_tpu_torch.models import tgen as _tgen  # noqa: F401
from shadow_tpu_torch.models import timer as _timer  # noqa: F401

__all__ = [
    "MODEL_REGISTRY",
    "FlowDone",
    "HandlerCtx",
    "HandlerOut",
    "LocalPush",
    "Model",
    "PacketSend",
    "get_model",
    "register_model",
]
