"""Tor-like relay circuits (port of shadow_tpu/models/circuit.py): bench
config 4.

Every client owns a fixed 3-relay circuit (guard, middle, exit) drawn at
build time; a cell travels client -> guard -> middle -> exit, turns around,
and returns exit -> middle -> guard -> client. Each relay charges a
processing delay (a local continuation) before forwarding, so the load
mixes packet events, local continuations and timer ticks. The route rides
in the packet payload as 16-bit host ids, so a circuit simulation holds at
most 65,535 hosts. Clients keep at most one cell outstanding (send on tick
when idle), which gives an exact per-cell RTT.

The handler is kernel K22 `circuit_handle` (csrc/models.cu) on CUDA and
`handle_plain` on the CPU (models/base.py).
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.config.units import TimeUnit, parse_time_ns
from shadow_tpu_torch.models.base import (
    HandlerCtx,
    HandlerOut,
    LocalPush,
    PacketSend,
    check_lanes,
    const_lane,
    const_rows,
    ctx_arg_block,
    register_model,
)
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS

KIND_TICK = 0  # client timer
KIND_CELL = 1  # cell packet arriving at a relay or back at the client
KIND_FWD = 2  # relay continuation: processing delay elapsed, forward now

ROLE_RELAY = 0
ROLE_CLIENT = 1

# payload words (word 0 is the engine-owned size)
PW_GM = 1  # guard | middle << 16
PW_EC = 2  # exit | client << 16
PW_HD = 3  # hop | dir << 8

_handle_k = CudaKernel("models", "circuit_handle", ARG_BLOCK)


@register_model
class CircuitModel:
    name = "circuit"
    wire_kind = KIND_CELL  # cross-plane packets arrive as cells (mixed sims)
    # (name, dtype) of the [H] params and state lanes the kernel reads, in
    # its order (the [H, 3] route table goes first, apart)
    kernel_params = (("role", torch.int32), ("interval", torch.int64), ("proc", torch.int64))
    kernel_state = (("outstanding", torch.bool), ("launch_t", torch.int64),
                    ("cells_done", torch.int64), ("rtt_sum", torch.int64), ("fwd", torch.int64))

    def build(self, hosts, seed, device):
        h = len(hosts)
        if h > 0xFFFF:
            raise ValueError(f"circuit model routes via 16-bit host ids: {h} hosts > 65535")
        role = np.zeros((h,), np.int32)
        interval = np.zeros((h,), np.int64)
        proc = np.zeros((h,), np.int64)
        size = np.zeros((h,), np.int32)
        for i, hh in enumerate(hosts):
            a = hh["model_args"]
            role[i] = ROLE_CLIENT if a.get("role", "relay") == "client" else ROLE_RELAY
            interval[i] = parse_time_ns(a.get("interval", "200 ms"), TimeUnit.MS)
            proc[i] = parse_time_ns(a.get("relay_delay", "2 ms"), TimeUnit.MS)
            size[i] = int(a.get("cell_bytes", 512))
        relays = np.nonzero(role == ROLE_RELAY)[0]
        clients = np.nonzero(role == ROLE_CLIENT)[0]
        if len(relays) < 3 and len(clients):
            raise ValueError("circuit model needs >= 3 relay hosts")
        rng = np.random.default_rng(seed)
        route = np.zeros((h, 3), np.int32)
        for c in clients:
            route[c] = relays[rng.choice(len(relays), size=3, replace=False)]
        params = {
            "role": torch.as_tensor(role, device=device),
            "route": torch.as_tensor(route, device=device),
            "interval": torch.as_tensor(interval, device=device),
            "proc": torch.as_tensor(proc, device=device),
            "size": torch.as_tensor(size, device=device),
        }
        state = {
            "outstanding": torch.zeros((h,), dtype=torch.bool, device=device),
            "launch_t": torch.zeros((h,), dtype=torch.int64, device=device),
            "cells_done": torch.zeros((h,), dtype=torch.int64, device=device),
            "rtt_sum": torch.zeros((h,), dtype=torch.int64, device=device),
            "fwd": torch.zeros((h,), dtype=torch.int64, device=device),
        }
        events = [(hh["host_id"], hh["start_time"], KIND_TICK, ())
                  for i, hh in enumerate(hosts) if role[i] == ROLE_CLIENT]
        return params, state, events

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K22) on CUDA, updating the state
        lanes in place. The relay's continuation passes the event's own
        payload through; the launch and forward payloads are the
        kernel's."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        if p < 4:
            raise ValueError(f"circuit: {p} payload words, the route needs 4")
        check(ctx.params["route"], torch.int32, (h, 3), "circuit param route")
        args = [*ctx_arg_block(ctx), addr(ctx.params["route"]),
                *check_lanes(ctx.params, self.kernel_params, h, "circuit param"),
                *check_lanes(ctx.state, self.kernel_state, h, "circuit state")]
        launch, tick, relay, fwd = (torch.empty((h,), dtype=torch.bool, device=dev)
                                    for _ in range(4))
        guard, tick_t, proc_t, nxt = (torch.empty((h,), dtype=torch.int64, device=dev)
                                      for _ in range(4))
        launch_payload, fwd_payload = (torch.empty((h, p), dtype=torch.int32, device=dev)
                                       for _ in range(2))
        _handle_k(arg_block([*args, addr(launch), addr(guard), addr(launch_payload),
                             addr(tick), addr(tick_t), addr(relay), addr(proc_t), addr(fwd),
                             addr(nxt), addr(fwd_payload)]))
        cell = const_lane(KIND_CELL, torch.int32, h, dev)
        send_launch = PacketSend(mask=launch, dst=guard, size_bytes=ctx.params["size"],
                                 kind=cell, payload=launch_payload)
        tick_push = LocalPush(mask=tick, t=tick_t, kind=const_lane(KIND_TICK, torch.int32, h, dev),
                              payload=const_rows(h, p, dev))
        proc_push = LocalPush(mask=relay, t=proc_t, kind=const_lane(KIND_FWD, torch.int32, h, dev),
                              payload=ctx.payload)
        send_fwd = PacketSend(mask=fwd, dst=nxt, size_bytes=ctx.params["size"], kind=cell,
                              payload=fwd_payload)
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(tick_push, proc_push),
                          sends=(send_launch, send_fwd))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        st, p = ctx.state, ctx.params
        i32, i64 = torch.int32, torch.int64
        is_client = p["role"] == ROLE_CLIENT
        tick = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_TICK)
        cell_in = ctx.active & ctx.is_packet & (ctx.kind == KIND_CELL)
        fwd = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_FWD)
        cell_back = cell_in & is_client  # full round trip completed
        cell_at_relay = cell_in & ~is_client

        # client tick: launch a cell when idle; always re-arm the tick
        launch = tick & ~st["outstanding"]
        route = p["route"]
        gm = route[:, 0] | (route[:, 1] << 16)
        ec = route[:, 2] | (ctx.host_id.to(i32) << 16)
        launch_payload = torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=i32, device=dev)
        launch_payload[:, PW_GM] = gm
        launch_payload[:, PW_EC] = ec
        send_launch = PacketSend(mask=launch, dst=route[:, 0].to(i64), size_bytes=p["size"],
                                 kind=torch.full((h,), KIND_CELL, dtype=i32, device=dev),
                                 payload=launch_payload)
        tick_push = LocalPush(mask=tick, t=ctx.t + p["interval"],
                              kind=torch.full((h,), KIND_TICK, dtype=i32, device=dev),
                              payload=torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=i32, device=dev))

        # relay: charge the processing delay, then forward (KIND_FWD)
        proc_push = LocalPush(mask=cell_at_relay, t=ctx.t + p["proc"],
                              kind=torch.full((h,), KIND_FWD, dtype=i32, device=dev),
                              payload=ctx.payload)

        # forward continuation: the next hop from the packed route
        pl = ctx.payload
        g = (pl[:, PW_GM] & 0xFFFF).to(i64)
        m = ((pl[:, PW_GM] >> 16) & 0xFFFF).to(i64)
        e = (pl[:, PW_EC] & 0xFFFF).to(i64)
        c = ((pl[:, PW_EC] >> 16) & 0xFFFF).to(i64)
        hop = pl[:, PW_HD] & 0xFF
        dn = (pl[:, PW_HD] >> 8) & 1
        at_exit = (dn == 0) & (hop == 2)
        out = dn == 0
        nxt_dst = torch.where(out, torch.where(hop == 0, m, torch.where(hop == 1, e, m)),
                              torch.where(hop == 1, g, c))
        nxt_hop = torch.where(out, torch.where(hop == 0, 1, torch.where(hop == 1, 2, 1)), 0)
        nxt_dir = torch.where(at_exit, 1, dn)
        fwd_payload = pl.clone()
        fwd_payload[:, PW_HD] = (nxt_hop | (nxt_dir << 8)).to(i32)
        send_fwd = PacketSend(mask=fwd, dst=nxt_dst, size_bytes=p["size"],
                              kind=torch.full((h,), KIND_CELL, dtype=i32, device=dev),
                              payload=fwd_payload)

        rtt = ctx.t - st["launch_t"]
        state = {
            "outstanding": torch.where(launch, True,
                                       torch.where(cell_back, False, st["outstanding"])),
            "launch_t": torch.where(launch, ctx.t, st["launch_t"]),
            "cells_done": st["cells_done"] + cell_back,
            "rtt_sum": st["rtt_sum"] + torch.where(cell_back, rtt, 0),
            "fwd": st["fwd"] + fwd,
        }
        return HandlerOut(state=state, rng=ctx.rng, pushes=(tick_push, proc_push),
                          sends=(send_launch, send_fwd))

    def report(self, state, hosts):
        done = np.asarray(state["cells_done"])
        rtt = np.asarray(state["rtt_sum"])
        n = int(done.sum())
        return {
            "cells_completed": n,
            "mean_rtt_ms": (float(rtt.sum()) / n / 1e6) if n else None,
            "relay_forwards": int(np.asarray(state["fwd"]).sum()),
        }


KERNELS = {"circuit_handle": _handle_k}
