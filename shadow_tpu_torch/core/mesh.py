"""The host mesh: W ranks, one process per card, each holding one shard of
the hosts (the counterpart of the JAX package's `("hosts",)` mesh: the mesh
pieces of `Engine.__init__`, `Engine.state_specs` / `param_specs` and
`sim.resolve_world`).

Layout. Shard r holds hosts [r * h_local, (r + 1) * h_local), with
h_local = num_hosts / world after the simulation pads the host count to a
multiple of the world. A leaf the JAX package marks `P("hosts")` is cut to
the shard's rows; the others (the graph tables, `node_of`, the fluid
plane, the link-fault windows, the model's `global_*` tables, `now`,
`done`, `min_used_lat`, `rounds`) stay whole on every rank. A stats lane
that JAX keeps as [world] (one value per shard) is the rank's own [1].

Collectives. `Collectives` is the only caller of `torch.distributed`: the
round loop's barrier (`pmin`), its sums (`psum`), the exchanges
(`all_gather`, tiled rank-major like JAX's host-major flattening, and
`all_to_all`), and the host-side reads that every rank must agree on
(`host_rows`). NCCL when each rank has its own card (`cuda:rank`), gloo
when the caller asks for the CPU. World 1 makes no collective at all.

Launch. `launch(fn, world, device_type, args)` spawns one process per
rank, joins them into one process group (a `file://` rendezvous in a fresh
temporary directory, so concurrent launches never collide), runs
`fn(coll, *args)` in each and returns the results in rank order. On CUDA
the kernels are built once in the parent before the spawn: ranks that built
into the one build directory together would race.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from shadow_tpu_torch.config.options import ConfigError

_TIMEOUT_S = 600


def resolve_world(parallelism: int, device: torch.device) -> int:
    """The rank count for `general.parallelism` (the JAX package's
    `resolve_world`): 0 means every visible card; more than are visible is
    a ConfigError. On the CPU the ranks are gloo processes, as many as
    asked (0 = 1)."""
    if device.type != "cuda":
        return max(parallelism, 1)
    avail = torch.cuda.device_count()
    if parallelism <= 0:
        return max(avail, 1)
    if parallelism > avail:
        raise ConfigError(f"general.parallelism={parallelism} exceeds {avail} available devices")
    return parallelism


class Collectives:
    """This rank's view of the process group, with a count of the
    collectives it made (`calls`, by kind) and the bytes it sent into
    them (`bytes_sent`)."""

    def __init__(self, world: int, rank: int, device: torch.device):
        self.world = int(world)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.calls: dict[str, int] = {}
        self.bytes_sent = 0

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes_sent += x.numel() * x.element_size()

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum over the ranks (a new tensor)."""
        import torch.distributed as dist

        y = x.clone()
        self._count("pmin", y)
        dist.all_reduce(y, op=dist.ReduceOp.MIN)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks (a new tensor)."""
        import torch.distributed as dist

        y = x.clone()
        self._count("psum", y)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[world, *x.shape]: every rank's `x`, rank-major."""
        import torch.distributed as dist

        x = x.contiguous()
        cast = x.dtype == torch.bool
        if cast:
            x = x.to(torch.uint8)
        flat = torch.empty((self.world * x.numel(),), dtype=x.dtype, device=x.device)
        self._count("all_gather", x)
        dist.all_gather_into_tensor(flat, x.reshape(-1))
        out = flat.reshape(self.world, *x.shape)
        return out.to(torch.bool) if cast else out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x[j] goes to rank j; returns [world, ...] with row i from rank i."""
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.empty_like(x)
        self._count("all_to_all", x)
        dist.all_to_all_single(out, x)
        return out

    def host_rows(self, x: torch.Tensor) -> np.ndarray:
        """Every rank's i64 vector `x` as a host array [world, n], read in
        one device-to-host copy: the values a host-side decision reads, so
        that every rank takes the same one."""
        return self.all_gather(x.to(torch.int64)).cpu().numpy()


# --------------------------------------------------------------------------
# shard slicing (the JAX package's state_specs / param_specs)
# --------------------------------------------------------------------------


def _rows(x, lo: int, hi: int):
    return None if x is None else x[lo:hi].clone()


def _rows_tuple(t, lo: int, hi: int):
    return None if t is None else type(t)(*(_rows(v, lo, hi) for v in t))


def _model_rows(tree: dict, lo: int, hi: int) -> dict:
    """Model state/params: every leaf sharded by host, except dict keys
    named `global_*` (cross-host lookup tables, replicated)."""
    return {k: (v if k.startswith("global_") else _rows(v, lo, hi)) for k, v in tree.items()}


def shard_bounds(num_hosts: int, world: int, rank: int) -> tuple[int, int]:
    h_local = num_hosts // world
    return rank * h_local, (rank + 1) * h_local


def shard_state(state, num_hosts: int, world: int, rank: int):
    """A globally built SimState cut to rank `rank`'s shard."""
    lo, hi = shard_bounds(num_hosts, world, rank)
    s = state.stats
    stats = type(s)(*(_rows(v, lo, hi) if v is not None and v.dim() >= 1
                      and v.shape[0] == num_hosts else v for v in s))
    ob = state.outbox
    return state._replace(
        queue=_rows_tuple(state.queue, lo, hi),
        rng=_rows_tuple(state.rng, lo, hi),
        seq=_rows(state.seq, lo, hi),
        sent_round=_rows(state.sent_round, lo, hi),
        tb_egress=_rows_tuple(state.tb_egress, lo, hi),
        tb_ingress=_rows_tuple(state.tb_ingress, lo, hi),
        codel=_rows_tuple(state.codel, lo, hi),
        cpu_busy_until=_rows(state.cpu_busy_until, lo, hi),
        model=_model_rows(state.model, lo, hi),
        outbox=type(ob)(*(_rows(v, lo, hi) for v in ob[:-1]), ob.count),
        stats=stats,
        wheel=_rows_tuple(state.wheel, lo, hi),
    )


def shard_params(params, num_hosts: int, world: int, rank: int):
    """Globally built EngineParams cut to rank `rank`'s shard: the token
    buckets, the model's per-host params, the per-host route rows and the
    crash windows; the graph tables, `node_of`, the link-fault windows and
    the fluid plane stay whole."""
    lo, hi = shard_bounds(num_hosts, world, rank)
    f = params.faults
    if f is not None:
        f = f._replace(down_t=_rows(f.down_t, lo, hi), up_t=_rows(f.up_t, lo, hi))
    return params._replace(
        eg_tb=_rows_tuple(params.eg_tb, lo, hi),
        in_tb=_rows_tuple(params.in_tb, lo, hi),
        model=_model_rows(params.model, lo, hi),
        lat_rows=_rows(params.lat_rows, lo, hi),
        loss_rows=_rows(params.loss_rows, lo, hi),
        jit_rows=_rows(params.jit_rows, lo, hi),
        faults=f,
    )


def gather_view(state, coll: Collectives, h_local: int):
    """The whole mesh's state, for the report (every rank calls it): the
    sharded leaves of every rank concatenated host-major, a per-shard [1]
    stats lane as the JAX package's [world], the replicated leaves as this
    rank holds them."""

    def cat(x):
        return None if x is None else coll.all_gather(x).reshape(-1, *x.shape[1:])

    def cat_tuple(t):
        return None if t is None else type(t)(*(cat(v) for v in t))

    s = state.stats
    stats = type(s)(*(cat(v) if v is not None and v.dim() >= 1
                      and v.shape[0] in (h_local, 1) else v for v in s))
    ob = state.outbox
    return state._replace(
        queue=cat_tuple(state.queue), rng=cat_tuple(state.rng), seq=cat(state.seq),
        sent_round=cat(state.sent_round), tb_egress=cat_tuple(state.tb_egress),
        tb_ingress=cat_tuple(state.tb_ingress), codel=cat_tuple(state.codel),
        cpu_busy_until=cat(state.cpu_busy_until),
        model={k: (v if k.startswith("global_") else cat(v)) for k, v in state.model.items()},
        outbox=type(ob)(*(cat(v) for v in ob)), stats=stats, wheel=cat_tuple(state.wheel),
    )


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------


def _rank_main(rank: int, world: int, device_type: str, init: str, threads: int,
               fn: Callable, args: tuple, out) -> None:
    import torch.distributed as dist

    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            backend = "nccl"
        else:
            torch.set_num_threads(threads)
            device = torch.device("cpu")
            backend = "gloo"
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=_TIMEOUT_S))
        try:
            res = fn(Collectives(world, rank, device), *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:  # reported to the parent, which stops the other ranks
        out.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world: int, device_type: str = "cuda", args: tuple = (),
           threads: int = 1, timeout_s: float = 3600.0) -> list[Any]:
    """Run `fn(coll, *args)` in `world` spawned processes, rank r on
    `cuda:r` (NCCL) or on the CPU (gloo, `threads` intra-op threads each);
    returns the per-rank results in rank order. A failing rank raises
    RuntimeError with its traceback here, after every rank is stopped.
    `fn` and `args` must pickle (a module-level function)."""
    import multiprocessing as mp

    if device_type == "cuda":
        from shadow_tpu_torch.ops.cuda_build import build_all

        if torch.cuda.device_count() < world:
            raise ConfigError(
                f"world {world} needs {world} cards; {torch.cuda.device_count()} are visible")
        build_all()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="shadow_tpu_torch_rdv_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, device_type, init, threads, fn, args, out))
             for r in range(world)]
    results: dict[int, Any] = {}
    errors: dict[int, str] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) + len(errors) < world and failure is None:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue_mod.Empty:
                if errors and time.monotonic() > grace:
                    break  # the ranks still running wait on a dead peer
                if time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout_s} s"
                elif any(p.exitcode not in (None, 0) for p in procs):
                    failure = "a rank died: " + ", ".join(
                        f"rank {r} exit {p.exitcode}" for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0))
                continue
            if ok:
                results[rank] = res
            else:
                # the first failure is often a peer's lost connection: give
                # the others a moment to report theirs
                errors[rank] = res
                grace = time.monotonic() + 10.0
        if errors:
            failure = "\n".join(f"rank {r} failed:\n{e}" for r, e in sorted(errors.items()))
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(world)]
