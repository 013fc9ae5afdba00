"""UDP echo / request-response traffic (port of shadow_tpu/models/echo.py).

Clients send fixed-size requests to a peer server on a period; the server
echoes the payload back; clients record RTTs from the send timestamp that
rides in payload words 1-2. Integer-only.

The handler is kernel K19 `echo_handle` (csrc/models.cu) on CUDA and
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
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, on_cpu
from shadow_tpu_torch.ops.events import EVENT_PAYLOAD_WORDS

KIND_TICK = 0  # client send timer
KIND_REQ = 1  # request packet (server handles)
KIND_RESP = 2  # response packet (client handles)

ROLE_CLIENT = 0
ROLE_SERVER = 1

_handle_k = CudaKernel("models", "echo_handle", ARG_BLOCK)


def _pack_t(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """i64 -> (lo, hi) i32 words, wrapping like numpy's astype."""
    lo = (t & 0xFFFFFFFF).to(torch.int32)
    hi = (t >> 32).to(torch.int32)
    return lo, hi


def _unpack_t(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


@register_model
class UdpEchoModel:
    name = "udp_echo"
    # cross-plane packets (mixed co-simulations) arrive as requests; this
    # protocol echoes the payload, so a native request's words (the bridge's
    # byte-store key and magic) ride back verbatim
    wire_kind = KIND_REQ
    sanitize_wire_payload = False
    # the kinds the timer wheel takes (ops/wheel.py)
    timer_kinds = (KIND_TICK,)
    # (name, dtype) of the params and state lanes the kernel reads, in its
    # order
    kernel_params = (("role", torch.int32), ("interval", torch.int64))
    kernel_state = tuple((k, torch.int64) for k in ("sent", "rcvd", "rtt_sum", "rtt_max"))

    def build(self, hosts, seed, device):
        h = len(hosts)
        role = np.zeros((h,), np.int32)
        peer = np.zeros((h,), np.int64)
        interval = np.zeros((h,), np.int64)
        size = np.zeros((h,), np.int32)
        by_name = {hh["name"]: hh["host_id"] for hh in hosts}
        for i, hh in enumerate(hosts):
            a = hh["model_args"]
            role[i] = ROLE_SERVER if a.get("role", "client") == "server" else ROLE_CLIENT
            if role[i] == ROLE_CLIENT:
                p = a.get("peer")
                if p is None:
                    raise ValueError(f"echo client {hh['name']} needs model_args.peer")
                if isinstance(p, str):
                    if p not in by_name:
                        raise ValueError(f"echo client {hh['name']}: unknown peer {p!r}")
                    peer[i] = by_name[p]
                else:
                    peer[i] = int(p)
            interval[i] = parse_time_ns(a.get("interval", "1 s"), TimeUnit.SEC)
            size[i] = int(a.get("size_bytes", 512))
        params = {
            "role": torch.as_tensor(role, device=device),
            "peer": torch.as_tensor(peer, device=device),
            "interval": torch.as_tensor(interval, device=device),
            "size": torch.as_tensor(size, device=device),
        }
        state = {
            k: torch.zeros((h,), dtype=torch.int64, device=device)
            for k in ("sent", "rcvd", "rtt_sum", "rtt_max")
        }
        events = [
            (hh["host_id"], hh["start_time"], KIND_TICK, ())
            for i, hh in enumerate(hosts)
            if role[i] == ROLE_CLIENT
        ]
        return params, state, events

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K19) on CUDA, updating the counters
        in place. The response port passes the event's source, size word
        and payload through, as the plain version does."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        if p < 3:
            raise ValueError(f"udp_echo: {p} payload words, the send time needs 3")
        args = [*ctx_arg_block(ctx),
                *check_lanes(ctx.params, self.kernel_params, h, "udp_echo param"),
                *check_lanes(ctx.state, self.kernel_state, h, "udp_echo state")]
        tick = torch.empty((h,), dtype=torch.bool, device=dev)
        push_t = torch.empty((h,), dtype=torch.int64, device=dev)
        req_payload = torch.empty((h, p), dtype=torch.int32, device=dev)
        req = torch.empty((h,), dtype=torch.bool, device=dev)
        _handle_k(arg_block([*args, addr(tick), addr(push_t), addr(req_payload), addr(req)]))
        send_req = PacketSend(mask=tick, dst=ctx.params["peer"], size_bytes=ctx.params["size"],
                              kind=const_lane(KIND_REQ, torch.int32, h, dev), payload=req_payload)
        push_tick = LocalPush(mask=tick, t=push_t, kind=const_lane(KIND_TICK, torch.int32, h, dev),
                              payload=const_rows(h, p, dev))
        send_resp = PacketSend(mask=req, dst=ctx.src, size_bytes=ctx.payload[:, 0],
                               kind=const_lane(KIND_RESP, torch.int32, h, dev),
                               payload=ctx.payload)
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(push_tick,),
                          sends=(send_req, send_resp))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        is_client = ctx.params["role"] == ROLE_CLIENT
        is_server = ctx.params["role"] == ROLE_SERVER
        zeros_payload = torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=dev)

        tick = ctx.active & (ctx.kind == KIND_TICK) & is_client
        lo, hi = _pack_t(ctx.t)
        req_payload = zeros_payload.clone()
        req_payload[:, 1] = lo
        req_payload[:, 2] = hi
        send_req = PacketSend(
            mask=tick,
            dst=ctx.params["peer"],
            size_bytes=ctx.params["size"],
            kind=torch.full((h,), KIND_REQ, dtype=torch.int32, device=dev),
            payload=req_payload,
        )
        push_tick = LocalPush(
            mask=tick,
            t=ctx.t + ctx.params["interval"],
            kind=torch.full((h,), KIND_TICK, dtype=torch.int32, device=dev),
            payload=zeros_payload,
        )

        req = ctx.active & (ctx.kind == KIND_REQ) & is_server
        send_resp = PacketSend(
            mask=req,
            dst=ctx.src,
            size_bytes=ctx.payload[:, 0],
            kind=torch.full((h,), KIND_RESP, dtype=torch.int32, device=dev),
            payload=ctx.payload,
        )

        resp = ctx.active & (ctx.kind == KIND_RESP) & is_client
        t_sent = _unpack_t(ctx.payload[:, 1], ctx.payload[:, 2])
        rtt = torch.where(resp, ctx.t - t_sent, 0)

        state = {
            "sent": ctx.state["sent"] + tick,
            "rcvd": ctx.state["rcvd"] + (resp | req),
            "rtt_sum": ctx.state["rtt_sum"] + rtt,
            "rtt_max": torch.maximum(ctx.state["rtt_max"], rtt),
        }
        return HandlerOut(state=state, rng=ctx.rng, pushes=(push_tick,), sends=(send_req, send_resp))

    def report(self, state, hosts):
        sent = np.asarray(state["sent"])
        rcvd = np.asarray(state["rcvd"])
        rtt_sum = np.asarray(state["rtt_sum"])
        client = np.array([hh["model_args"].get("role") != "server" for hh in hosts])
        n_resp = rcvd[client].sum()
        return {
            "requests_sent": int(sent[client].sum()),
            "responses_received": int(n_resp),
            "requests_served": int(rcvd[~client].sum()),
            "mean_rtt_ms": float(rtt_sum[client].sum() / max(n_resp, 1) / 1e6),
            "max_rtt_ms": float(np.asarray(state["rtt_max"]).max() / 1e6),
        }


KERNELS = {"echo_handle": _handle_k}
