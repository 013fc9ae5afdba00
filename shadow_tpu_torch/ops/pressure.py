"""The pressure plane's per-round signal: K26 `pressure_total`
(csrc/pressure.cu), the run's cumulative capacity-drop total, and its plain
PyTorch version. The engine launches it after each round's exchange under
the escalate and abort policies; the policy itself is `core/pressure.py`."""

from __future__ import annotations

import ctypes

import torch

from shadow_tpu_torch.ops.cuda_build import CudaKernel, check, on_cpu, ptr

_total_k = CudaKernel("pressure", "pressure_total", [ctypes.c_void_p] * 4 + [ctypes.c_int])


def pressure_total_plain(dropped: torch.Tensor, budget_dropped: torch.Tensor,
                         ob_dropped: torch.Tensor) -> torch.Tensor:
    return (dropped.sum() + budget_dropped.sum() + ob_dropped[0])[None]


def pressure_total(dropped: torch.Tensor, budget_dropped: torch.Tensor,
                   ob_dropped: torch.Tensor) -> torch.Tensor:
    """The round's cumulative capacity-drop total i64[1]: Σ queue.dropped
    + Σ pkts_budget_dropped + ob_dropped[0] (the all-to-all's sheds are 0
    on one device). A new tensor; K26 on CUDA."""
    if on_cpu(dropped):
        return pressure_total_plain(dropped, budget_dropped, ob_dropped)
    h = dropped.shape[0]
    check(dropped, torch.int64, (h,), "queue dropped")
    check(budget_dropped, torch.int64, (h,), "pkts_budget_dropped")
    check(ob_dropped, torch.int64, (1,), "ob_dropped")
    out = torch.empty((1,), dtype=torch.int64, device=dropped.device)
    _total_k(ptr(dropped), ptr(budget_dropped), ptr(ob_dropped), ptr(out), h)
    return out


KERNELS = {"pressure_total": _total_k}
