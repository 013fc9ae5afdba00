"""Mixed plane: device-modeled hosts and CPU-plane hosts in one simulation
(port of shadow_tpu/models/mixed.py).

Every host owns one device lane. Native lanes (hosts of the CPU host plane)
run the hybrid proxy (capture ring and send requests, models/hybrid.py);
modeled lanes run the inner model. A replicated `global_is_native` table,
read by global host id, routes each event to its handler and translates
packet kinds at the plane boundary:

  native -> model : delivered as the inner model's `wire_kind`, with only
                    payload word 0 (the size) kept unless the model opts out
                    (`sanitize_wire_payload = False`: udp_echo, whose echo
                    carries the bridge's byte-store key back)
  model -> native : delivered as the hybrid KIND_DATA so the capture ring
                    picks it up

Device payloads carry no bytes: the bridge rebuilds an echoed reply from
the requester's own byte store and synthesizes other model-to-native
deliveries as zero-filled datagrams (cosim.py `_drain_captures`).

On CUDA one event runs K34 `mixed_plane` in its in mode (the hybrid and
inner active lanes, the translated kind and payload), K33 over the native
lanes, the inner model's kernel (K17-K22) over the modeled lanes and K34 in
its out mode over the inner model's send ports; the send ports come out
hybrid first, then the inner model's, as the budget's slots are taken in
port order. `handle_plain` is the plain PyTorch version of the same.
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.models.base import KIND_MASK, HandlerCtx, HandlerOut, ctx_arg_block
from shadow_tpu_torch.models.hybrid import KIND_DATA, HybridModel
from shadow_tpu_torch.ops.cuda_build import ARG_BLOCK, CudaKernel, addr, arg_block, check, on_cpu

_plane_k = CudaKernel("models", "mixed_plane", ARG_BLOCK)
MAX_PORTS = 8  # inner send ports K34's out mode takes in one launch


def _clip(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(x.to(torch.int64), 0, n - 1)


def mixed_in_plain(ctx: HandlerCtx, native: torch.Tensor, wire_kind: int | None,
                   sanitize: bool):
    """(hybrid active, inner active, inner kind, inner payload) of one event."""
    n = native.shape[0]
    native_lane = native[_clip(ctx.host_id, n)]
    hyb_active = ctx.active & native_lane
    in_active = ctx.active & ~native_lane
    in_kind, in_payload = ctx.kind, ctx.payload
    if wire_kind is not None:
        from_native = ctx.is_packet & native[_clip(ctx.src, n)]
        in_kind = torch.where(from_native, wire_kind, ctx.kind)
        if sanitize:
            keep = torch.zeros_like(ctx.payload)
            keep[:, 0] = ctx.payload[:, 0]
            in_payload = torch.where(from_native[:, None], keep, ctx.payload)
    return hyb_active, in_active, in_kind, in_payload


def mixed_out_plain(send, native: torch.Tensor) -> torch.Tensor:
    """An inner send port's translated kind lane."""
    to_native = send.mask & native[_clip(send.dst, native.shape[0])]
    return torch.where(to_native, KIND_DATA, send.kind.to(torch.int32) & KIND_MASK)


def mixed_in(ctx: HandlerCtx, native: torch.Tensor, wire_kind: int | None, sanitize: bool):
    """`mixed_in_plain` as K34's in mode on CUDA; the inner payload has the
    event payload's strides (a column of the K-way peek stays one)."""
    if on_cpu(ctx.t):
        return mixed_in_plain(ctx, native, wire_kind, sanitize)
    h, p = ctx.payload.shape
    dev = ctx.t.device
    n = native.shape[0]
    check(native, torch.bool, (n,), "global_is_native")
    args = ctx_arg_block(ctx)
    es = args[2]
    hyb_active = torch.empty((h,), dtype=torch.bool, device=dev)
    in_active = torch.empty((h,), dtype=torch.bool, device=dev)
    in_kind = torch.empty((h,), dtype=torch.int32, device=dev)
    in_payload = torch.empty((h, es, p), dtype=torch.int32, device=dev)[:, 0]
    _plane_k(arg_block([0, *args, n, addr(native), -1 if wire_kind is None else int(wire_kind),
                        int(bool(sanitize)), addr(hyb_active), addr(in_active), addr(in_kind),
                        addr(in_payload)]))
    return hyb_active, in_active, in_kind, in_payload


def _strided(x: torch.Tensor, dt: torch.dtype, h: int, keep: list) -> tuple[int, int]:
    """(address, host stride) of an [H] port lane, converted (and kept
    alive in `keep`) where its dtype is not the kernel's."""
    if x.dtype != dt:
        x = x.to(dt)
        keep.append(x)
    if not x.is_cuda or tuple(x.shape) != (h,):
        raise ValueError(f"send port lane: expected a CUDA [{h}] tensor")
    return x.data_ptr(), x.stride(0)


def mixed_out(sends, native: torch.Tensor) -> list[torch.Tensor]:
    """Every inner send port's translated kind lane: `mixed_out_plain` per
    port, or one launch of K34's out mode over them all on CUDA."""
    if not sends:
        return []
    if on_cpu(sends[0].mask):
        return [mixed_out_plain(s, native) for s in sends]
    if len(sends) > MAX_PORTS:
        raise ValueError(f"mixed_plane: {len(sends)} send ports, at most {MAX_PORTS}")
    h = sends[0].mask.shape[0]
    n = native.shape[0]
    check(native, torch.bool, (n,), "global_is_native")
    out = torch.empty((len(sends), h), dtype=torch.int32, device=native.device)
    keep, ports = [], []
    for j, s in enumerate(sends):
        ports += [*_strided(s.mask, torch.bool, h, keep), *_strided(s.dst, torch.int64, h, keep),
                  *_strided(s.kind, torch.int32, h, keep), addr(out[j])]
    _plane_k(arg_block([1, h, n, addr(native), len(sends), *ports]))
    del keep
    return list(out)


class MixedModel:
    """The mixed plane over one inner device model (module docstring)."""

    name = "mixed"

    def __init__(self, inner, inner_name: str):
        self.hybrid = HybridModel()
        self.inner = inner
        self.inner_name = inner_name
        self.wire_kind = getattr(inner, "wire_kind", None)
        self.sanitize = bool(getattr(inner, "sanitize_wire_payload", True))
        self.capture_cap = self.hybrid.capture_cap

    def build(self, hosts, seed, device):
        """`hosts`: per-lane dicts with "plane" in {"native", "model"}; the
        inner model is built over every lane, native lanes with the first
        modeled host's args (they are masked out of the inner handler)."""
        is_native = np.array([h.get("plane") == "native" for h in hosts], bool)
        model_hosts = [h for h in hosts if not is_native[h["host_id"]]]
        proto_args = model_hosts[0].get("model_args", {}) if model_hosts else {}
        inner_hosts = [
            dict(h) if not is_native[h["host_id"]] else {**h, "model_args": dict(proto_args)}
            for h in hosts
        ]
        hyb_params, hyb_state, _ = self.hybrid.build(hosts, seed, device)
        in_params, in_state, in_events = self.inner.build(inner_hosts, seed, device)
        self._inner_hosts = inner_hosts
        # only the modeled lanes' initial events: native lanes boot their
        # processes on the CPU plane
        live_model = np.array([not h.get("pad") and h.get("plane") != "native" for h in hosts],
                              bool)
        events = [e for e in in_events if live_model[e[0]]]
        params = {**hyb_params, "inner": in_params,
                  "global_is_native": torch.as_tensor(is_native, device=device)}
        state = {**hyb_state, "inner": in_state}
        return params, state, events

    def _split(self, ctx: HandlerCtx):
        p = ctx.params
        hyb_state = {k: v for k, v in ctx.state.items() if k != "inner"}
        hyb_params = {k: v for k, v in p.items() if k not in ("inner", "global_is_native")}
        return p["global_is_native"], hyb_state, hyb_params

    def _run(self, ctx: HandlerCtx, plain: bool) -> HandlerOut:
        native, hyb_state, hyb_params = self._split(ctx)
        lanes = (mixed_in_plain if plain else mixed_in)(ctx, native, self.wire_kind,
                                                       self.sanitize)
        hyb_active, in_active, in_kind, in_payload = lanes
        hyb_ctx = HandlerCtx(t=ctx.t, window_end=ctx.window_end, kind=ctx.kind,
                             payload=ctx.payload, active=hyb_active, is_packet=ctx.is_packet,
                             src=ctx.src, host_id=ctx.host_id, state=hyb_state,
                             params=hyb_params, rng=ctx.rng)
        hyb = self.hybrid.handle_plain if plain else self.hybrid.handle
        hyb_out = hyb(hyb_ctx)
        in_ctx = HandlerCtx(t=ctx.t, window_end=ctx.window_end, kind=in_kind,
                            payload=in_payload, active=in_active, is_packet=ctx.is_packet,
                            src=ctx.src, host_id=ctx.host_id, state=ctx.state["inner"],
                            params=ctx.params["inner"], rng=hyb_out.rng)
        inner = self.inner.handle_plain if plain else self.inner.handle
        in_out = inner(in_ctx)
        kinds = ([mixed_out_plain(s, native) for s in in_out.sends] if plain
                 else mixed_out(list(in_out.sends), native))
        sends = tuple(hyb_out.sends) + tuple(
            s._replace(kind=k) for s, k in zip(in_out.sends, kinds))
        return HandlerOut(state={**hyb_out.state, "inner": in_out.state}, rng=in_out.rng,
                          pushes=tuple(hyb_out.pushes) + tuple(in_out.pushes), sends=sends)

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        return self._run(ctx, plain=False)

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        return self._run(ctx, plain=True)

    def report(self, state, hosts):
        # the state arrives padded: every lane is cut back to the real lanes
        n = len(self._inner_hosts)
        state = {k: (np.asarray(v)[:n] if not isinstance(v, dict)
                     else {kk: np.asarray(vv)[:n] for kk, vv in v.items()})
                 for k, v in state.items()}
        rep = dict(self.hybrid.report({k: v for k, v in state.items() if k != "inner"}, hosts))
        rep[f"model_{self.inner_name}"] = self.inner.report(
            state["inner"], hosts if hosts is not None else self._inner_hosts)
        return rep


KERNELS = {"mixed_plane": _plane_k}
