"""Gossip/pubsub flood (port of shadow_tpu/models/gossip.py): bench config 3.

A source publishes a message; every host forwards it once to `fanout`
random static neighbors, one packet per microstep, with a same-timestamp
local continuation event walking the neighbor list. With `publisher: true`
and a `publish_interval`, the publisher floods a fresh generation every
interval; hosts adopt a message whose generation beats their own, restart
their forwarding walk, and drop stale continuations (a single publisher:
generations are its sequence numbers).

The handler is kernel K21 `gossip_handle` (csrc/models.cu) on CUDA and
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

KIND_MSG = 0  # gossip packet arrives
KIND_FWD = 1  # forwarding continuation (payload word 2 = its generation)
KIND_PUB = 2  # publisher's event

_handle_k = CudaKernel("models", "gossip_handle", ARG_BLOCK)


@register_model
class GossipModel:
    name = "gossip"
    wire_kind = KIND_MSG  # cross-plane packets arrive as gossip messages (mixed sims)
    # (name, dtype) of the [H] params and state lanes the kernel reads, in
    # its order (the [H, K] neighbor table goes first, apart)
    kernel_params = (("fanout", torch.int32), ("interval", torch.int64))
    kernel_state = (("gen", torch.int32), ("recv_time", torch.int64), ("hops", torch.int32),
                    ("fwd_idx", torch.int32), ("adopted", torch.int64))

    def build(self, hosts, seed, device):
        h = len(hosts)
        fanout = np.array([int(hh["model_args"].get("fanout", 8)) for hh in hosts], np.int32)
        size = np.array([int(hh["model_args"].get("payload_bytes", 256)) for hh in hosts],
                        np.int32)
        rng = np.random.default_rng(seed)
        # static random neighbor lists, [H, K] with K = max fanout; a host's
        # fanout masks the tail of its row; self-loops moved to the next host
        k = max(int(fanout.max()), 1)
        neighbors = rng.integers(0, h, size=(h, k), dtype=np.int64)
        self_rows = neighbors == np.arange(h)[:, None]
        neighbors = np.where(self_rows, (neighbors + 1) % h, neighbors)
        interval = np.array(
            [parse_time_ns(hh["model_args"].get("publish_interval", 0), TimeUnit.MS)
             for hh in hosts], np.int64)
        params = {
            "neighbors": torch.as_tensor(neighbors, device=device),
            "size": torch.as_tensor(size, device=device),
            "fanout": torch.as_tensor(fanout, device=device),
            "interval": torch.as_tensor(interval, device=device),
        }
        state = {
            "gen": torch.zeros((h,), dtype=torch.int32, device=device),
            "recv_time": torch.full((h,), -1, dtype=torch.int64, device=device),
            "hops": torch.full((h,), -1, dtype=torch.int32, device=device),
            "fwd_idx": torch.zeros((h,), dtype=torch.int32, device=device),
            "adopted": torch.zeros((h,), dtype=torch.int64, device=device),
        }
        events = [(hh["host_id"], hh["start_time"], KIND_PUB, ()) for hh in hosts
                  if hh["model_args"].get("publisher", False)]
        return params, state, events

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K21) on CUDA, updating the state
        lanes in place. The send and the continuation pass the event's own
        payload through; the start-forward payload is the kernel's."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        if p < 3:
            raise ValueError(f"gossip: {p} payload words, the generation needs 3")
        nbr_table = ctx.params["neighbors"]
        k = nbr_table.shape[-1]
        check(nbr_table, torch.int64, (h, k), "gossip param neighbors")
        args = [*ctx_arg_block(ctx), k, addr(nbr_table),
                *check_lanes(ctx.params, self.kernel_params, h, "gossip param"),
                *check_lanes(ctx.state, self.kernel_state, h, "gossip state")]
        fresh, repub, more, cont = (torch.empty((h,), dtype=torch.bool, device=dev)
                                    for _ in range(4))
        start_payload = torch.empty((h, p), dtype=torch.int32, device=dev)
        pub_t, dst = (torch.empty((h,), dtype=torch.int64, device=dev) for _ in range(2))
        _handle_k(arg_block([*args, addr(fresh), addr(start_payload), addr(repub),
                             addr(pub_t), addr(more), addr(dst), addr(cont)]))
        fwd_kind = const_lane(KIND_FWD, torch.int32, h, dev)
        start_fwd = LocalPush(mask=fresh, t=ctx.t, kind=fwd_kind, payload=start_payload)
        pub_push = LocalPush(mask=repub, t=pub_t, kind=const_lane(KIND_PUB, torch.int32, h, dev),
                             payload=const_rows(h, p, dev))
        send = PacketSend(mask=more, dst=dst, size_bytes=ctx.params["size"],
                          kind=const_lane(KIND_MSG, torch.int32, h, dev), payload=ctx.payload)
        cont_push = LocalPush(mask=cont, t=ctx.t, kind=fwd_kind, payload=ctx.payload)
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(start_fwd, pub_push, cont_push),
                          sends=(send,))

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        st, prm = ctx.state, ctx.params
        gen = st["gen"]
        pub = ctx.active & (ctx.kind == KIND_PUB)
        msg = ctx.active & (ctx.kind == KIND_MSG)
        # a publish starts generation gen + 1; a message carries its
        # generation in payload word 2 and is fresh if it beats ours
        msg_gen = torch.where(pub, gen + 1, ctx.payload[:, 2])
        fresh = (pub | msg) & (msg_gen > gen)
        hop = torch.where(pub, 0, ctx.payload[:, 1] + 1)

        # fresh adoption: record, and restart the forwarding walk at 0
        state = {
            "gen": torch.where(fresh, msg_gen, gen),
            "recv_time": torch.where(fresh, ctx.t, st["recv_time"]),
            "hops": torch.where(fresh, hop, st["hops"]),
            "fwd_idx": torch.where(fresh, 0, st["fwd_idx"]),
            "adopted": st["adopted"] + fresh,
        }
        zeros_payload = torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=dev)
        start_payload = zeros_payload.clone()
        start_payload[:, 1] = hop
        start_payload[:, 2] = msg_gen
        start_fwd = LocalPush(mask=fresh, t=ctx.t,
                              kind=torch.full((h,), KIND_FWD, dtype=torch.int32, device=dev),
                              payload=start_payload)
        # repeated-flood mode: the publisher re-arms its own publish
        pub_push = LocalPush(mask=pub & (prm["interval"] > 0), t=ctx.t + prm["interval"],
                             kind=torch.full((h,), KIND_PUB, dtype=torch.int32, device=dev),
                             payload=zeros_payload)

        # continuation: send to neighbors[fwd_idx] and re-push until the
        # fanout is done; a continuation of a superseded generation drops
        fwd = ctx.active & (ctx.kind == KIND_FWD) & (ctx.payload[:, 2] == state["gen"])
        idx = state["fwd_idx"]
        more = fwd & (idx < prm["fanout"])
        nbrs = prm["neighbors"]
        col = torch.clamp(idx, 0, nbrs.shape[1] - 1).to(torch.int64)
        nbr = nbrs.gather(1, col[:, None])[:, 0]
        send = PacketSend(mask=more, dst=nbr, size_bytes=prm["size"],
                          kind=torch.full((h,), KIND_MSG, dtype=torch.int32, device=dev),
                          payload=ctx.payload)  # the hop rides in word 1
        state["fwd_idx"] = torch.where(more, idx + 1, idx)
        cont = LocalPush(mask=more & ((idx + 1) < prm["fanout"]), t=ctx.t,
                         kind=torch.full((h,), KIND_FWD, dtype=torch.int32, device=dev),
                         payload=ctx.payload)
        return HandlerOut(state=state, rng=ctx.rng, pushes=(start_fwd, pub_push, cont),
                          sends=(send,))

    def report(self, state, hosts):
        g = np.asarray(state["gen"])
        hops = np.asarray(state["hops"])
        rt = np.asarray(state["recv_time"])
        gmax = int(g.max())
        reached = int((g == gmax).sum()) if gmax > 0 else 0
        return {
            "reached": reached,  # of the latest generation
            "coverage": float(reached / len(g)) if gmax > 0 else 0.0,
            "generations": gmax,
            "adoptions": int(np.asarray(state["adopted"]).sum()),
            "max_hops": int(hops.max()),
            "spread_ms": float((rt.max() - rt[rt >= 0].min()) / 1e6) if reached else 0.0,
        }


KERNELS = {"gossip_handle": _handle_k}
