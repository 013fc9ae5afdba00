"""tgen-style bulk TCP flows on device-modeled endpoints (port of
shadow_tpu/models/tgen.py).

Each host runs a client and a server lane as per-host SoA lanes advanced by
one vectorized handler: a SYN / SYN-ACK / DATA handshake, FIN / FIN-ACK
teardown, segment-granular Reno (slow start, congestion avoidance in
fixed point, fast retransmit on three duplicate ACKs, NewReno partial-ACK
repair, RTO with exponential backoff and go-back-N), RFC 6298 RTT
estimation with Karn's rule, delayed ACKs, and receiver-side reassembly
through a 32-segment bitmap. Workload: phased all-to-all; in phase k client
i sends `flow_segs` segments to peer (i + 1 + k mod (H-1)) mod H.

The port follows the JAX model lane for lane, in the same dtypes (most
lanes i32, times and counters i64), so that every state lane, digest and
counter is bit-identical. Two lanes need care in PyTorch:

  - the reassembly bitmap `sv_bm` is a uint32 lane in JAX. PyTorch's uint32
    support is partial and it has no popcount, so the lane is carried as
    int64 holding 0..2^32-1, masked after every negate or complement, and
    popcount is a SWAR bit count (`_popcount32`);
  - integer division: every `//` of the reference floors, and so does
    `torch.div(..., rounding_mode="floor")`.

The handler is kernel K17 `tgen_handle` (csrc/models.cu) on CUDA and
`handle_plain` on the CPU (models/base.py). With the network observatory's
flow ledger on, the engine hands the handler the record lanes of a flow
completed at this event (`HandlerCtx.flow`, ops/obs.py FlowLanes): K17
and `handle_plain` write them there in place, and K28 appends them to the
ledger.
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
from shadow_tpu_torch.simtime import TIME_MAX

KIND_TICK = 0  # client: start the next flow
KIND_SEG = 1  # wire segment (ftype in the meta word)
KIND_TX = 2  # client: transmit continuation (up to tx_batch DATA per step)
KIND_RTO = 3  # client: retransmission timer lane
KIND_DELACK = 4  # server: delayed-ACK timer lane

# segment types (meta word low byte)
FT_SYN = 1
FT_SYNACK = 2
FT_DATA = 3
FT_ACK = 4
FT_FIN = 5
FT_FINACK = 6

# payload words (word 0 is the engine-owned size)
PW_SEQ = 1  # DATA/SYN/FIN: segment index; ACK: SACK bitmap beyond ack
PW_ACK = 2  # ACK/SYNACK: cumulative ack (next expected segment)
PW_META = 3  # ftype | flow_phase << 8

# client connection states
CST_IDLE = 0
CST_SYN = 1
CST_EST = 2
CST_FIN = 3
CST_DONE = 4

HDR_BYTES = 40  # IP + TCP header burden
_CWND_ONE = 1 << 10  # fixed-point unit: cwnd_x == cwnd << 10
_U32 = 0xFFFFFFFF

_handle_k = CudaKernel("models", "tgen_handle", ARG_BLOCK)
_I32, _I64, _B = torch.int32, torch.int64, torch.bool
# the params and state lanes in the order K17 reads them (csrc/models.cu
# TgenArgs)
_KERNEL_PARAMS = (
    ("flow_segs", _I32), ("mss", _I32), ("flows", _I32), ("cwnd_init", _I32),
    ("cwnd_cap", _I32), ("rto_init", _I64), ("rto_min", _I64), ("rto_max", _I64),
    ("flow_gap", _I64), ("delack", _I64), ("num_hosts", _I32),
)
_KERNEL_STATE = (
    ("c_state", _I32), ("c_phase", _I32), ("c_peer", _I32), ("snd_una", _I32),
    ("snd_nxt", _I32), ("cwnd_x", _I32), ("ssth_x", _I32), ("dup", _I32), ("recover", _I32),
    ("srtt", _I64), ("rttvar", _I64), ("rto", _I64), ("rtt_seq", _I32), ("rtt_t0", _I64),
    ("deadline", _I64), ("timer_alive", _B), ("tx_alive", _B), ("flow_t0", _I64),
    ("sv_state", _I32), ("sv_peer", _I32), ("sv_phase", _I32), ("rcv_nxt", _I32),
    ("sv_bm", _I64), ("da_pend", _B), ("da_t", _I64), ("da_alive", _B),
    ("d_sent", _I64), ("d_rtx", _I64), ("fast_rtx", _I64), ("timeouts", _I64),
    ("flows_done", _I64), ("flow_rtx0", _I64), ("fct_sum", _I64), ("segs_rcvd", _I64),
    ("dup_segs", _I64), ("bytes_rcvd", _I64), ("done_t", _I64),
)


# the flow-ledger record lanes K17 writes (ops/obs.py FlowLanes)
_FLOW_LANES = (("mask", _B), ("dst", _I64), ("flow", _I64), ("t_start", _I64),
               ("t_end", _I64), ("bytes", _I64), ("retransmits", _I64))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value of an int64 tensor holding 0..2^32-1."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of a u32 carried as int64 (32 for x == 0)."""
    low = x & ((-x) & _U32)
    return torch.where(x == 0, 32, _popcount32((low - 1) & _U32))


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


@register_model
class TgenTcpModel:
    name = "tgen_tcp"
    wire_kind = KIND_SEG
    timer_kinds = (KIND_RTO, KIND_DELACK)
    # only push port B (timer chain, tick, delayed ACK) can carry a timer
    # kind: the wheel's router skips port A (always KIND_TX)
    timer_push_ports = (1,)
    flow_ledger = True  # handle() writes flow records at FIN-ACK
    # (name, dtype) of the params and state lanes the kernel reads, in its
    # order
    kernel_params = _KERNEL_PARAMS
    kernel_state = _KERNEL_STATE

    def build(self, hosts, seed, device):
        h = len(hosts)
        if h < 2:
            raise ValueError("tgen_tcp needs at least 2 hosts")

        def arg(hh, key, default):
            return hh["model_args"].get(key, default)

        def ints(key, default, dtype=np.int32):
            return torch.as_tensor(
                np.array([int(arg(hh, key, default)) for hh in hosts], dtype), device=device
            )

        def times(key, default):
            return torch.as_tensor(
                np.array([parse_time_ns(arg(hh, key, default), TimeUnit.MS) for hh in hosts],
                         np.int64),
                device=device,
            )

        params = {
            "flow_segs": ints("flow_segs", 64),
            "mss": ints("mss", 1460),
            "flows": ints("flows", 1),
            "cwnd_init": ints("cwnd_init", 2),
            "cwnd_cap": ints("cwnd_cap", 16),
            "rto_init": times("rto_init", "1 s"),
            "rto_min": times("rto_min", "200 ms"),
            "rto_max": times("rto_max", "60 s"),
            "flow_gap": times("flow_gap", "10 ms"),
            "delack": times("delack", "40 ms"),
            "num_hosts": torch.full((h,), h, dtype=torch.int32, device=device),
        }
        if (params["flow_segs"] < 1).any():
            raise ValueError("tgen_tcp: flow_segs must be >= 1 "
                             "(a zero-length flow would never FIN)")
        # segments transmitted per TX continuation (= the send port's burst
        # width), a static property of the model
        self.tx_batch = max(max(int(arg(hh, "tx_batch", 4)) for hh in hosts), 1)

        def full(v, dtype):
            return torch.full((h,), v, dtype=dtype, device=device)

        i32, i64, b = torch.int32, torch.int64, torch.bool
        state = {
            # client lane
            "c_state": full(0, i32),
            "c_phase": full(0, i32),
            "c_peer": full(0, i32),
            "snd_una": full(0, i32),
            "snd_nxt": full(0, i32),
            "cwnd_x": full(_CWND_ONE, i32),
            "ssth_x": full(0x7FFFFFFF, i32),
            "dup": full(0, i32),
            "recover": full(-1, i32),
            "srtt": full(0, i64),  # 0 = no sample yet
            "rttvar": full(0, i64),
            "rto": params["rto_init"].clone(),
            "rtt_seq": full(-1, i32),
            "rtt_t0": full(0, i64),
            "deadline": full(TIME_MAX, i64),
            "timer_alive": full(False, b),
            "tx_alive": full(False, b),
            "flow_t0": full(0, i64),
            # server lane
            "sv_state": full(0, i32),  # 0 LISTEN, 1 ESTABLISHED
            "sv_peer": full(0, i32),
            "sv_phase": full(0, i32),
            "rcv_nxt": full(0, i32),
            "sv_bm": full(0, i64),  # uint32 bitmap carried as int64
            "da_pend": full(False, b),
            "da_t": full(TIME_MAX, i64),
            "da_alive": full(False, b),
            # counters
            "d_sent": full(0, i64),
            "d_rtx": full(0, i64),
            "fast_rtx": full(0, i64),
            "timeouts": full(0, i64),
            "flows_done": full(0, i64),
            "flow_rtx0": full(0, i64),
            "fct_sum": full(0, i64),
            "segs_rcvd": full(0, i64),
            "dup_segs": full(0, i64),
            "bytes_rcvd": full(0, i64),
            "done_t": full(0, i64),
        }
        events = [
            (hh["host_id"], hh["start_time"], KIND_TICK, ())
            for hh in hosts
            if int(arg(hh, "flows", 1)) > 0
        ]
        return params, state, events

    # ------------------------------------------------------------------ #

    def handle(self, ctx: HandlerCtx) -> HandlerOut:
        """`handle_plain` as one kernel (K17) on CUDA, updating every state
        lane in place; port A's time is the event time, and the send
        port's kind and payload increment are constants. With `ctx.flow`
        (the flow ledger on) K17 also writes the record lanes there and
        `flow` returns them."""
        if on_cpu(ctx.t):
            return self.handle_plain(ctx)
        h, p = ctx.payload.shape
        dev = ctx.t.device
        if p <= PW_META:
            raise ValueError(f"tgen_tcp: {p} payload words, the segment header needs 4")
        args = [*ctx_arg_block(ctx), self.tx_batch,
                *check_lanes(ctx.params, self.kernel_params, h, "tgen_tcp param"),
                *check_lanes(ctx.state, self.kernel_state, h, "tgen_tcp state")]
        pa_mask, pb_mask, s_mask = (torch.empty((h,), dtype=_B, device=dev) for _ in range(3))
        pb_t, s_dst = (torch.empty((h,), dtype=_I64, device=dev) for _ in range(2))
        pb_kind, s_size, s_count = (torch.empty((h,), dtype=_I32, device=dev) for _ in range(3))
        s_payload = torch.empty((h, p), dtype=_I32, device=dev)
        flow = ctx.flow
        if flow is not None:
            check_lanes(flow._asdict(), _FLOW_LANES, h, "tgen_tcp flow")
        _handle_k(arg_block([*args, *(addr(x) for x in (
            pa_mask, pb_mask, pb_t, pb_kind, s_mask, s_dst, s_size, s_payload, s_count)),
            *(addr(getattr(flow, name, None)) for name, _ in _FLOW_LANES)]))
        zeros = const_rows(h, p, dev)
        port_a = LocalPush(mask=pa_mask, t=ctx.t, kind=const_lane(KIND_TX, _I32, h, dev),
                           payload=zeros)
        port_b = LocalPush(mask=pb_mask, t=pb_t, kind=pb_kind, payload=zeros)
        send = PacketSend(
            mask=s_mask, dst=s_dst, size_bytes=s_size, kind=const_lane(KIND_SEG, _I32, h, dev),
            payload=s_payload, count=s_count, payload_inc=const_rows(h, p, dev, PW_SEQ, 1),
            count_max=self.tx_batch,
        )
        return HandlerOut(state=ctx.state, rng=ctx.rng, pushes=(port_a, port_b), sends=(send,),
                          flow=flow)

    def handle_plain(self, ctx: HandlerCtx) -> HandlerOut:
        h = ctx.kind.shape[0]
        dev = ctx.t.device
        st = dict(ctx.state)
        p = ctx.params
        t = ctx.t
        where = torch.where

        tick = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_TICK)
        seg = ctx.active & ctx.is_packet & (ctx.kind == KIND_SEG)
        tx = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_TX)
        rto_ev = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_RTO)
        da_ev = ctx.active & ~ctx.is_packet & (ctx.kind == KIND_DELACK)

        meta = ctx.payload[:, PW_META]
        ftype = meta & 0xFF
        ph = meta >> 8
        w_seq = ctx.payload[:, PW_SEQ]
        w_ack = ctx.payload[:, PW_ACK]
        src = ctx.src.to(torch.int32)
        my_phase = st["c_phase"]
        L = p["flow_segs"]

        # ================= server lane (pure reaction to arrivals) ======
        syn_in = seg & (ftype == FT_SYN)
        data_in = seg & (ftype == FT_DATA)
        fin_in = seg & (ftype == FT_FIN)

        listen = st["sv_state"] == 0
        same_conn = (st["sv_peer"] == src) & (st["sv_phase"] == ph)
        new_conn = syn_in & listen
        dup_syn = syn_in & ~listen & same_conn
        synack_out = new_conn | dup_syn

        data_ok = data_in & (st["sv_state"] == 1) & same_conn
        rel = w_seq - st["rcv_nxt"]
        inorder = data_ok & (rel == 0)
        ooo = data_ok & (rel > 0) & (rel <= 32)
        dup_seg = data_ok & ((rel < 0) | (rel > 32))
        bm = st["sv_bm"]
        bit = torch.ones_like(bm) << torch.clamp(rel - 1, 0, 31).to(torch.int64)
        bm_set = where(ooo, bm | bit, bm)
        run = _ctz32((~bm_set) & _U32).to(torch.int32)
        adv = where(inorder, 1 + run, 0)
        rcv_nxt2 = st["rcv_nxt"] + adv
        shift = torch.clamp(adv, 0, 32).to(torch.int64)
        bm2 = where(inorder, where(shift >= 32, 0, bm_set >> shift), bm_set)
        fin_acc = (
            fin_in & (st["sv_state"] == 1) & same_conn & (st["rcv_nxt"] == w_seq)
        )
        fin_stateless = fin_in & listen
        finack_out = fin_acc | fin_stateless

        # ---- delayed ACK
        da_dis = p["delack"] == 0
        filling = bm != 0
        ack_2nd = inorder & (st["da_pend"] | da_dis | filling)
        hold = inorder & ~st["da_pend"] & ~da_dis & ~filling
        ack_imm = ooo | dup_seg
        da_fire = da_ev & st["da_pend"] & (t >= st["da_t"])
        da_repush = da_ev & st["da_pend"] & (t < st["da_t"])
        ack_out = ack_2nd | ack_imm | da_fire
        da_t_new = where(hold, t + p["delack"], st["da_t"])
        da_arm = hold & ~st["da_alive"]
        st["da_pend"] = where(hold, True, where(ack_out | fin_acc | new_conn, False, st["da_pend"]))
        st["da_t"] = da_t_new
        st["da_alive"] = where(da_ev, da_repush, where(da_arm, True, st["da_alive"]))

        st["sv_state"] = where(new_conn, 1, where(fin_acc, 0, st["sv_state"]))
        st["sv_peer"] = where(new_conn, src, st["sv_peer"])
        st["sv_phase"] = where(new_conn, ph, st["sv_phase"])
        st["rcv_nxt"] = where(new_conn, 0, where(fin_acc, 0, rcv_nxt2))
        st["sv_bm"] = where(new_conn | fin_acc, 0, bm2)
        st["segs_rcvd"] = st["segs_rcvd"] + inorder + ooo
        st["dup_segs"] = st["dup_segs"] + dup_seg
        wire_sz = ctx.payload[:, 0]
        st["bytes_rcvd"] = st["bytes_rcvd"] + where(
            inorder | ooo, (wire_sz - HDR_BYTES).to(torch.int64), 0
        )

        # ================= client lane ==================================
        for_me = seg & (src == st["c_peer"]) & (ph == my_phase)
        synack_in = for_me & (ftype == FT_SYNACK) & (st["c_state"] == CST_SYN)
        ack_in = for_me & (ftype == FT_ACK) & (st["c_state"] == CST_EST)
        finack_in = for_me & (ftype == FT_FINACK) & (st["c_state"] == CST_FIN)

        st["c_state"] = where(synack_in, CST_EST, st["c_state"])

        # ---- ACK processing (Reno + NewReno recovery)
        ack = w_ack
        una0 = st["snd_una"]
        new_acked = ack_in & (ack > una0)
        dup_ack = ack_in & (ack == una0) & (st["snd_nxt"] > una0)

        samp = new_acked & (st["rtt_seq"] >= 0) & (ack > st["rtt_seq"])
        r = t - st["rtt_t0"]
        first = samp & (st["srtt"] == 0)
        later = samp & (st["srtt"] != 0)
        rttvar1 = where(
            first,
            _fdiv(r, 2),
            where(later, _fdiv(3 * st["rttvar"] + torch.abs(st["srtt"] - r), 4), st["rttvar"]),
        )
        srtt1 = where(first, r, where(later, _fdiv(7 * st["srtt"] + r, 8), st["srtt"]))
        rto1 = where(
            samp,
            _clip(srtt1 + torch.clamp_min(4 * rttvar1, 1_000_000), p["rto_min"], p["rto_max"]),
            st["rto"],
        )
        st["srtt"], st["rttvar"], st["rto"] = srtt1, rttvar1, rto1
        st["rtt_seq"] = where(samp, -1, st["rtt_seq"])

        in_rec = st["recover"] >= 0
        exit_rec = new_acked & in_rec & (ack >= st["recover"])
        partial = new_acked & in_rec & (ack < st["recover"])

        grow = new_acked & ~in_rec
        acked_segs = where(grow, ack - una0, 0)
        ss = st["cwnd_x"] < st["ssth_x"]
        ca_inc = _fdiv(torch.full_like(st["cwnd_x"], 1 << 20), torch.clamp_min(st["cwnd_x"], 1))
        cwnd1 = where(
            grow,
            where(ss, st["cwnd_x"] + (acked_segs << 10), st["cwnd_x"] + ca_inc),
            st["cwnd_x"],
        )
        dup1 = where(new_acked, 0, where(dup_ack, st["dup"] + 1, st["dup"]))
        fast = dup_ack & (dup1 == 3) & ~in_rec
        inflight = st["snd_nxt"] - una0
        ssth_fast = torch.clamp_min(_fdiv(inflight << 10, 2), 2 << 10)
        cwnd1 = where(
            fast,
            ssth_fast + (3 << 10),
            where(dup_ack & in_rec, cwnd1 + _CWND_ONE, cwnd1),
        )
        st["ssth_x"] = where(fast, ssth_fast, st["ssth_x"])
        st["recover"] = where(fast, st["snd_nxt"], where(exit_rec, -1, st["recover"]))
        cwnd1 = where(exit_rec, st["ssth_x"], cwnd1)
        cwnd_cap_x = p["cwnd_cap"] << 10
        st["cwnd_x"] = _clip(cwnd1, torch.full_like(cwnd1, _CWND_ONE), cwnd_cap_x)
        st["dup"] = dup1
        st["snd_una"] = where(new_acked, ack, una0)
        st["rtt_seq"] = where(fast | partial, -1, st["rtt_seq"])

        all_acked = new_acked & (st["snd_una"] >= L) & (st["c_state"] == CST_EST)
        st["c_state"] = where(all_acked, CST_FIN, st["c_state"])

        # ---- FIN-ACK: flow complete; next phase or done. The flow ledger's
        # record is taken here, before the phase and flow_t0 lanes advance
        flow = ctx.flow
        if flow is not None:
            for lane, v in ((flow.mask, finack_in), (flow.dst, st["c_peer"]),
                            (flow.flow, my_phase), (flow.t_start, st["flow_t0"]),
                            (flow.t_end, t),
                            (flow.bytes, L.to(torch.int64) * p["mss"].to(torch.int64)),
                            (flow.retransmits, st["d_rtx"] - st["flow_rtx0"])):
                lane.copy_(v)
        phase1 = where(finack_in, my_phase + 1, my_phase)
        more = finack_in & (phase1 < p["flows"])
        st["c_phase"] = phase1
        st["c_state"] = where(finack_in, where(more, CST_IDLE, CST_DONE).to(torch.int32),
                              st["c_state"])
        st["flows_done"] = st["flows_done"] + finack_in
        st["fct_sum"] = st["fct_sum"] + where(finack_in, t - st["flow_t0"], 0)
        st["done_t"] = where(finack_in & ~more, t, st["done_t"])

        # ---- TICK: start the next flow (SYN out)
        start = tick & (st["c_state"] == CST_IDLE) & (my_phase < p["flows"])
        nh = p["num_hosts"]
        hid = ctx.host_id.to(torch.int32)
        # a mesh's padding hosts carry num_hosts 0 and never start a flow:
        # their divisors are replaced (integer remainder by 0 raises), as
        # are those of a one-host run, where the result is 0 either way
        peer = torch.remainder(hid + 1 + torch.remainder(my_phase, torch.where(nh > 1, nh - 1, 1)),
                               torch.where(nh > 0, nh, 1))
        st["c_peer"] = where(start, peer, st["c_peer"])
        st["c_state"] = where(start, CST_SYN, st["c_state"])
        st["snd_una"] = where(start, 0, st["snd_una"])
        st["snd_nxt"] = where(start, 0, st["snd_nxt"])
        st["cwnd_x"] = where(start, p["cwnd_init"] << 10, st["cwnd_x"])
        st["ssth_x"] = where(start, 0x7FFFFFFF, st["ssth_x"])
        st["dup"] = where(start, 0, st["dup"])
        st["recover"] = where(start, -1, st["recover"])
        st["srtt"] = where(start, 0, st["srtt"])
        st["rttvar"] = where(start, 0, st["rttvar"])
        st["rto"] = where(start, p["rto_init"], st["rto"])
        st["rtt_seq"] = where(start, -1, st["rtt_seq"])
        st["flow_t0"] = where(start, t, st["flow_t0"])
        st["flow_rtx0"] = where(start, st["d_rtx"], st["flow_rtx0"])

        # ---- TX continuation: up to tx_batch DATA segments per microstep
        txb = self.tx_batch
        cwnd_segs = st["cwnd_x"] >> 10
        lim_seq = torch.minimum(st["snd_una"] + cwnd_segs, L)
        n_can = where(tx & (st["c_state"] == CST_EST),
                      torch.clamp(lim_seq - st["snd_nxt"], 0, txb), 0)
        can_tx = n_can > 0
        tx_seq = st["snd_nxt"]
        st["snd_nxt"] = st["snd_nxt"] + n_can
        st["d_sent"] = st["d_sent"] + n_can
        time_it = can_tx & (st["rtt_seq"] < 0)
        st["rtt_seq"] = where(time_it, tx_seq, st["rtt_seq"])
        st["rtt_t0"] = where(time_it, t, st["rtt_t0"])
        chain_more = can_tx & (st["snd_nxt"] < lim_seq)

        # ---- RTO timer lane (single lazy timer event per host)
        armed = st["deadline"] != TIME_MAX
        expired = rto_ev & armed & (t >= st["deadline"])
        resched = rto_ev & armed & (t < st["deadline"])
        timer_dies = rto_ev & ~armed
        st["timer_alive"] = where(timer_dies, False, st["timer_alive"])

        syn_to = expired & (st["c_state"] == CST_SYN)
        est_to = expired & (st["c_state"] == CST_EST) & (st["snd_nxt"] > st["snd_una"])
        fin_to = expired & (st["c_state"] == CST_FIN)
        timeout = syn_to | est_to | fin_to
        st["timeouts"] = st["timeouts"] + timeout
        st["ssth_x"] = where(
            est_to,
            torch.clamp_min(_fdiv((st["snd_nxt"] - st["snd_una"]) << 10, 2), 2 << 10),
            st["ssth_x"],
        )
        st["cwnd_x"] = where(est_to, _CWND_ONE, st["cwnd_x"])
        st["snd_nxt"] = where(est_to, st["snd_una"] + 1, st["snd_nxt"])
        st["dup"] = where(est_to, 0, st["dup"])
        st["recover"] = where(est_to, -1, st["recover"])
        st["rtt_seq"] = where(est_to, -1, st["rtt_seq"])
        st["rto"] = where(timeout, torch.minimum(st["rto"] * 2, p["rto_max"]), st["rto"])

        # ---- deadline maintenance
        idleish = (st["c_state"] == CST_IDLE) | (st["c_state"] == CST_DONE)
        quiet = ack_in & ~idleish & (st["snd_nxt"] == st["snd_una"]) & (
            st["c_state"] == CST_EST
        )
        rearm = start | synack_in | new_acked | all_acked | can_tx | timeout
        st["deadline"] = where(
            finack_in | quiet | timer_dies,
            TIME_MAX,
            where(rearm, t + st["rto"], st["deadline"]),
        )

        # ================= emissions ====================================
        zeros_payload = torch.zeros((h, EVENT_PAYLOAD_WORDS), dtype=torch.int32, device=dev)
        # push port A: the TX chain
        can_send_more = (
            (st["c_state"] == CST_EST)
            & (st["snd_nxt"] < st["snd_una"] + (st["cwnd_x"] >> 10))
            & (st["snd_nxt"] < L)
        )
        restart = (synack_in | new_acked | dup_ack) & can_send_more & ~st["tx_alive"]
        push_tx = chain_more | restart
        st["tx_alive"] = where(tx, chain_more, where(restart, True, st["tx_alive"]))
        port_a = LocalPush(
            mask=push_tx,
            t=t,
            kind=torch.full((h,), KIND_TX, dtype=torch.int32, device=dev),
            payload=zeros_payload,
        )

        # push port B: timer chain + next-flow tick + delack timer (mutually
        # exclusive per host)
        arm_timer = (tick | seg | tx | rto_ev) & (st["deadline"] != TIME_MAX) & ~st["timer_alive"]
        st["timer_alive"] = where(arm_timer, True, st["timer_alive"])
        timer_push = arm_timer | resched | expired
        timer_t = where(arm_timer, st["deadline"], where(expired, t + st["rto"], st["deadline"]))
        next_tick = finack_in & more
        da_push = da_arm | da_repush
        port_b = LocalPush(
            mask=timer_push | next_tick | da_push,
            t=where(next_tick, t + p["flow_gap"], where(da_push, st["da_t"], timer_t)),
            kind=where(next_tick, KIND_TICK,
                       where(da_push, KIND_DELACK, KIND_RTO)).to(torch.int32),
            payload=zeros_payload,
        )

        # send port: at most one wire segment (or one TX burst) per host
        rtx_data = fast | partial | est_to
        rtx_seq = where(fast | est_to, st["snd_una"], ack)
        st["d_rtx"] = st["d_rtx"] + rtx_data
        st["fast_rtx"] = st["fast_rtx"] + fast
        send_syn = start | syn_to
        send_fin = all_acked | fin_to
        send_data = can_tx | rtx_data

        m = send_syn | send_fin | send_data | synack_out | ack_out | finack_out
        dst = where(
            ack_out, st["sv_peer"], where(synack_out | finack_out, src, st["c_peer"])
        ).to(torch.int64)
        ft = where(send_syn, FT_SYN, where(send_fin, FT_FIN, where(
            send_data, FT_DATA, where(synack_out, FT_SYNACK, where(ack_out, FT_ACK, FT_FINACK))
        )))
        out_phase = where(ack_out, st["sv_phase"], where(synack_out | finack_out, ph, my_phase))
        seq_word = where(
            send_data,
            where(rtx_data, rtx_seq, tx_seq),
            where(send_fin, L, where(ack_out, st["sv_bm"].to(torch.int32), 0)),
        )
        ack_word = where(ack_out, st["rcv_nxt"], 0)
        payload = zeros_payload.clone()
        payload[:, PW_SEQ] = seq_word
        payload[:, PW_ACK] = ack_word
        payload[:, PW_META] = ft.to(torch.int32) | (out_phase << 8)
        size = where(send_data, p["mss"] + HDR_BYTES, HDR_BYTES).to(torch.int32)
        seq_inc = zeros_payload.clone()
        seq_inc[:, PW_SEQ] = 1
        send = PacketSend(
            mask=m,
            dst=dst,
            size_bytes=size,
            kind=torch.full((h,), KIND_SEG, dtype=torch.int32, device=dev),
            payload=payload,
            count=where(can_tx, n_can, 1).to(torch.int32),
            payload_inc=seq_inc,
            count_max=txb,
        )
        return HandlerOut(state=st, rng=ctx.rng, pushes=(port_a, port_b), sends=(send,),
                          flow=flow)

    # ------------------------------------------------------------------ #

    def per_host_network(self, state):
        """Per-host payload bytes received (server side) and data segments
        retransmitted (client side)."""
        return {
            "bytes": np.asarray(state["bytes_rcvd"]),
            "retransmits": np.asarray(state["d_rtx"]),
        }

    def report(self, state, hosts):
        done = np.asarray(state["flows_done"])
        fct = np.asarray(state["fct_sum"])
        n = int(done.sum())
        return {
            "flows_completed": n,
            "flows_expected": int(sum(int(hh["model_args"].get("flows", 1)) for hh in hosts)),
            "data_segments_sent": int(np.asarray(state["d_sent"]).sum()),
            "retransmits": int(np.asarray(state["d_rtx"]).sum()),
            "fast_retransmits": int(np.asarray(state["fast_rtx"]).sum()),
            "timeouts": int(np.asarray(state["timeouts"]).sum()),
            "dup_segments": int(np.asarray(state["dup_segs"]).sum()),
            "mean_fct_ms": (float(fct.sum()) / n / 1e6) if n else None,
            "payload_bytes_received": int(np.asarray(state["bytes_rcvd"]).sum()),
        }


KERNELS = {"tgen_handle": _handle_k}
