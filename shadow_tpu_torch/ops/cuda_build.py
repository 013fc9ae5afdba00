"""Build and bind the hand-written CUDA kernels (`shadow_tpu_torch/csrc/*.cu`).

Each source compiles with `nvcc` into its own shared library with a plain C
interface, loaded with `ctypes` — no PyTorch headers, so a build takes
seconds. Libraries land in `shadow_tpu_torch/_build/` (ignored by git) and
are rebuilt whenever the content hash of the source, the shared headers
(`csrc/*.cuh`) or the flags changes. The event kernels do float32/float64
arithmetic that must round exactly as the plain versions do, so every
source is built with `--fmad=false` (no contraction into fused
multiply-adds; the integer kernels do not care) and never with
`--use_fast_math`. Nothing is built
when a module is imported: the first launch builds, or `build_all()` builds
every source at once (one `nvcc` process per source, all started together).

`CudaKernel` is the launch wrapper every kernel goes through: it resolves
the C symbol, passes tensor pointers and PyTorch's current stream, raises
when the C function reports a non-zero `cudaGetLastError()`, and counts its
launches in `launches` (a plain int), so a run can show which kernels the
main path really went through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("queue", "merge", "event", "fluid", "models", "faults", "integrity", "pressure",
           "obs", "exchange", "ensemble", "cosim")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--fmad=false",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# one record per library this process loaded, in load order: the source,
# when the load started (time.monotonic), its seconds (the build included),
# the nvcc seconds and whether the build directory already held it (a hit);
# read by obs/runtime.py BuildLedger
BUILD_LOG: list[dict] = []


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    src, so = _lib_path(name)
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return so, (proc, tmp)


def _finish_build(name: str, so: str, pending) -> str:
    if pending is None:
        return ""
    proc, tmp = pending
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel; returns nvcc's output (the
    `-Xptxas -v` register/shared-memory report) per source."""
    with _lock:
        started = {n: _start_build(n) for n in SOURCES}
        return {n: _finish_build(n, so, p) for n, (so, p) in started.items()}


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.monotonic()
            so, pending = _start_build(name)
            _finish_build(name, so, pending)
            t1 = time.monotonic()
            lib = _libs[name] = ctypes.CDLL(so)
            BUILD_LOG.append({"source": f"{name}.cu", "t0": t0, "seconds": time.monotonic() - t0,
                              "nvcc_s": t1 - t0 if pending is not None else 0.0,
                              "hit": pending is None})
        return lib


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# the argtypes of an entry point that takes one int64 argument block: its
# pointers and scalars in a fixed order, built by `arg_block`
ARG_BLOCK = [ctypes.POINTER(ctypes.c_longlong)]


def arg_block(vals: list[int]):
    """An int64 argument block (pointers as `addr`, scalars as ints)."""
    return (ctypes.c_longlong * len(vals))(*vals)


def addr(t: torch.Tensor | None) -> int:
    """A tensor's device address for an argument block; 0 for None."""
    return 0 if t is None else t.data_ptr()


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA
    tensor (launch the kernel); any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"unsupported device {t.device}")


def check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Validate a kernel argument before its pointer leaves Python."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    `argtypes` lists the ctypes of every argument after the pointers are
    converted; the stream is appended as the last argument. Every C entry
    point returns `cudaGetLastError()` after its launches."""

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, _stream())
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: cudaError {rc}"
            )
        self.launches += 1
