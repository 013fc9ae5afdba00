"""shadow_tpu_torch — the PyTorch / CUDA port of shadow_tpu's conservative-PDES
round loop, for NVIDIA Hopper (H100).

The JAX package `shadow_tpu` is the reference: same configs, same per-host
event digests, event counts and drop counters, bit for bit. This package
imports neither JAX nor anything of `shadow_tpu`; it carries its own copies
of the JAX-free modules it needs (config, graph, simulated time, and the
co-simulation bridge's CPU host plane: host/, tcp/, programs/).

Entry points run on the CUDA device unless the caller passes
`device="cpu"` (the CPU path runs every kernel's plain PyTorch version and
exists for tests). Without a GPU they raise; they never fall back.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.simtime import (
    NS_PER_MSEC,
    NS_PER_SEC,
    NS_PER_USEC,
    TIME_MAX,
)

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU explicitly. Raises when CUDA is asked for (or defaulted to) and
    no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shadow_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = [
    "NS_PER_MSEC",
    "NS_PER_SEC",
    "NS_PER_USEC",
    "TIME_MAX",
    "__version__",
    "resolve_device",
]
