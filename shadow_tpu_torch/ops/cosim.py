"""The co-simulation bridge's guarded round loop test: K35 `guarded_window`
(csrc/cosim.cu) and its plain PyTorch version.

`Engine.run_guarded_chunk` (core/engine.py) runs rounds while the state is
not done, the round count is below `effective_rounds_per_chunk`, the
global minimum of the effective next event times is below `until`, no
capture ring holds a delivery and no stop lane has grown; one launch of
K35 computes that test and the admitted round's window into one i64 lane
[7], read by the host in one device-to-host read per round:

    window_end, done, probe, below, stopped, go, gmin

(`go` = below and not probe and not stopped; the done flag and the round
count are the host's). The stop lanes are the chunk's first-shed,
first-violation and first-drop stops of `compute_window`: (current i64[1],
chunk-entry i64[1]) pairs."""

from __future__ import annotations

import torch

from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu

_guard_k = CudaKernel("cosim", "guarded_window", ARG_BLOCK)

WEND, DONE, PROBE, BELOW, STOPPED, GO, GMIN = range(7)
MAX_STOPS = 3


def guarded_window_plain(next_t: torch.Tensor, cap_n: torch.Tensor, until: int,
                         stop_time: int, runahead: int, stops=()) -> torch.Tensor:
    gmin = next_t.min()
    done = gmin >= stop_time
    safe = torch.clamp_max(gmin, stop_time)
    wend = torch.clamp_max(safe + runahead, stop_time)
    probe = (cap_n > 0).any()
    stopped = torch.zeros((), dtype=torch.bool, device=next_t.device)
    for cur, entry in stops:
        stopped = stopped | (cur[0] > entry[0])
    below = gmin < until
    go = below & ~probe & ~stopped
    return torch.stack([wend, done, probe, below, stopped, go, gmin]).to(torch.int64)


def guarded_window(next_t: torch.Tensor, cap_n: torch.Tensor, until: int, stop_time: int,
                   runahead: int, stops=()) -> torch.Tensor:
    """The guarded loop's lane i64[7] (module docstring) from the effective
    next times i64[H], cap_n i32[H] and the static runahead (the bridge
    runs no dynamic one). A new tensor; K35 on CUDA."""
    if on_cpu(next_t):
        return guarded_window_plain(next_t, cap_n, until, stop_time, runahead, stops)
    h = next_t.shape[0]
    check(next_t, torch.int64, (h,), "next times")
    check(cap_n, torch.int32, (h,), "cap_n")
    stops = list(stops)
    if len(stops) > MAX_STOPS:
        raise ValueError(f"guarded_window: {len(stops)} stop lanes, at most {MAX_STOPS}")
    lanes = []
    for cur, entry in stops:
        check(cur, torch.int64, (1,), "stop lane")
        check(entry, torch.int64, (1,), "stop lane entry")
        lanes += [addr(cur), addr(entry)]
    out = torch.empty((7,), dtype=torch.int64, device=next_t.device)
    _guard_k(arg_block([h, addr(next_t), addr(cap_n), int(until), int(stop_time), int(runahead),
                        len(stops), *lanes, addr(out)]))
    return out


KERNELS = {"guarded_window": _guard_k}
