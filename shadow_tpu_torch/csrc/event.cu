// Per-event chain kernels of the microstep. Plain C interface (ctypes);
// every entry point launches on the stream it is given and returns
// cudaGetLastError().
//
// Replaces (JAX reference):
//   K9  shadow_tpu/core/engine.py:1126 _outbox_append_multi   (B4)
//   K10 shadow_tpu/core/engine.py:2288-2367 _event_body, ingress half (B5):
//       events + digest fold, CoDel and the downlink token bucket, the
//       bucket-delay requeue, dispatch, pkts_delivered
//   K11 shadow_tpu/core/engine.py:2415-2640 _event_body, egress half (B5):
//       the model's local pushes (order keys, monotonic violations), then
//       every send port and burst segment: route lookup, send budget,
//       uplink token bucket, jitter and loss draws, outbox column and
//       arrival time, the packet counters
// with the device math of csrc/event_math.cuh (RNG, token bucket, CoDel,
// FNV fold).
//
// Layout: [H] lanes per host; the event may be a column of the K-way peek
// (host stride `es` elements, payload stride es * P). The entry stack K11
// writes is [E, H] per field (E = the model's send segments per event),
// payload [E, H, P]; K9 reads a microstep's stacks, one per event, in one
// launch. Model push ports and send ports come as arrays of per-port
// pointers, each field with its own host stride (a column of the K-way
// peek, or 0 for a broadcast): nothing is stacked or copied on the host.
//
// What bounds them on an H100: one thread per host, a few hundred integer
// and float64 operations and a few hundred bytes per host per event
// (H = 10,000: well under a microsecond of memory traffic). They are
// latency-bound single launches; what they remove is the ~900 small
// PyTorch launches per event of the plain chain. Design: one thread owns a
// host for the whole chain, keeping the RNG lanes, token buckets, CoDel
// state, seq and send cursor in registers, so the sequential port/segment
// loop with its threaded state needs no synchronisation at all, and the
// result cannot depend on scheduling. No shared memory. The only cross-host
// writes are K9's two integer totals (atomicAdd: integer sums commute, so
// they are exact and order-free).
//
// Argument blocks: K9-K11 take their pointers and scalars as one int64
// array read in a fixed order (`Args` below); the Python wrappers
// (ops/chain.py) build it in the same order.

#include <cstdint>
#include <cuda_runtime.h>

#include "event_math.cuh"

using namespace evm;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPushPorts = 8;
constexpr int kMaxSendPorts = 8;
constexpr int kMaxPayload = 16;

inline int blocks_for(int H) { return (H + kThreads - 1) / kThreads; }

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

// ---------------------------------------------------------------------------
// K9 outbox_append: a microstep's entry stacks -> outbox [H, B] (in place)
// ---------------------------------------------------------------------------

constexpr int kMaxStacks = 16;  // entry stacks per launch (the wrapper chunks past it)

// The microstep's events' [E_s, H] stacks, in event order: together the
// microstep's [sum E_s, H] entries, read where K11 wrote them.
struct AppendArgs {
  int H, B, P, n;
  int E[kMaxStacks];
  const bool* mask[kMaxStacks];
  const int* col[kMaxStacks];
  const int* dst[kMaxStacks];
  const long long* t[kMaxStacks];
  const long long* order[kMaxStacks];
  const int* kind[kMaxStacks];
  const int* payload[kMaxStacks];
  int* ob_dst;
  long long* ob_t;
  long long* ob_order;
  int* ob_kind;
  int* ob_payload;
  int* ob_count;
  long long* ob_lost;
};

__global__ void outbox_append_kernel(const AppendArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int H = a.H, B = a.B, P = a.P;
  int total = 0;
  long long lost = 0;
  for (int s = 0; s < a.n; ++s) {
    for (int e = 0; e < a.E[s]; ++e) {
      const long long i = (long long)e * H + h;
      if (!a.mask[s][i]) continue;
      ++total;
      const int col = a.col[s][i];
      if (col >= B) {
        ++lost;
      } else if (col >= 0) {
        const long long o = (long long)h * B + col;
        a.ob_dst[o] = a.dst[s][i];
        a.ob_t[o] = a.t[s][i];
        a.ob_order[o] = a.order[s][i];
        a.ob_kind[o] = a.kind[s][i];
        for (int w = 0; w < P; ++w) a.ob_payload[o * P + w] = a.payload[s][i * P + w];
      }
    }
  }
  if (total) atomicAdd(a.ob_count, total);
  if (lost) atomicAdd(reinterpret_cast<unsigned long long*>(a.ob_lost), (unsigned long long)lost);
}

// ---------------------------------------------------------------------------
// K10 event_ingress
// ---------------------------------------------------------------------------

struct IngressArgs {
  int H, P, es, shaping, use_codel;
  long long interval;
  // event (host stride es; payload stride es * P) and the active mask
  const long long* ev_t;
  const long long* ev_order;
  const int* ev_kind;
  const int* ev_payload;
  const bool* active;
  // carry, in place
  long long* events;
  unsigned long long* digest;
  long long* codel_dropped;
  long long* delivered;
  long long* tb_tokens;
  long long* tb_itv;
  const long long* tb_cap;
  const long long* tb_refill;
  long long* cd_first_above;
  long long* cd_drop_next;
  int* cd_count;
  bool* cd_dropping;
  // outputs [H]
  bool* dispatch;
  bool* is_pkt;
  int* kind_out;
  long long* src_out;
  bool* rq_mask;
  long long* rq_t;
  int* rq_kind;
};

__global__ void event_ingress_kernel(const IngressArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const long long ei = (long long)h * a.es;
  const bool act = a.active[h];
  const long long t = a.ev_t[ei];
  const long long order = a.ev_order[ei];
  const int kind = a.ev_kind[ei];
  if (act) {
    a.events[h] = wadd(a.events[h], 1);
    a.digest[h] = digest_fold(a.digest[h], t, kind, order);
  }
  const bool pkt = (kind & kKindPkt) != 0;
  bool dispatch = act;
  if (a.shaping) {
    const bool needs = act && pkt && (kind & kKindIngressDone) == 0;
    const long long size_bits = wmul((long long)a.ev_payload[ei * a.P + kSizeWord], 8);
    long long tokens = a.tb_tokens[h], itv = a.tb_itv[h];
    const long long cap = a.tb_cap[h], refill = a.tb_refill[h];
    // the probe: the departure the packet would get (the charge below sees
    // the same state, so it departs at the same time)
    long long tk0 = tokens, it0 = itv;
    const long long depart = tb_remove(tk0, it0, cap, refill, a.interval, t, size_bits, false);
    bool drop = false;
    if (a.use_codel) {
      Codel cd{a.cd_first_above[h], a.cd_drop_next[h], a.cd_count[h], a.cd_dropping[h]};
      drop = codel_on_packet(cd, t, wsub(depart, t), needs);
      if (needs) {
        a.cd_first_above[h] = cd.first_above;
        a.cd_drop_next[h] = cd.drop_next;
        a.cd_count[h] = cd.count;
        a.cd_dropping[h] = cd.dropping;
      }
    }
    const bool charge = needs && !drop;
    tb_remove(tokens, itv, cap, refill, a.interval, t, size_bits, charge);
    if (charge && refill > 0) {
      a.tb_tokens[h] = tokens;
      a.tb_itv[h] = itv;
    }
    const bool delay = charge && depart > t;
    a.rq_mask[h] = delay;
    a.rq_t[h] = depart;
    a.rq_kind[h] = kind | kKindIngressDone;
    if (drop) a.codel_dropped[h] = wadd(a.codel_dropped[h], 1);
    dispatch = act && !(needs && (drop || delay));
  }
  if (dispatch && pkt) a.delivered[h] = wadd(a.delivered[h], 1);
  a.dispatch[h] = dispatch;
  a.is_pkt[h] = pkt;
  a.kind_out[h] = kind & kKindMask;
  a.src_out[h] = (order >> kSrcShift) & kSrcMask;
}

// ---------------------------------------------------------------------------
// K11 event_egress
// ---------------------------------------------------------------------------

struct EgressArgs {
  int H, P, es, budget, shaping, use_jitter, route_mode, hosts_per_node, n_nodes;
  long long window_end, bootstrap_end, interval;
  const long long* ev_t;
  const bool* dispatch;
  // route tables: mode 0 [1, 1], mode 1 per-host rows [H, N], mode 2 [N, N]
  const int* node_of;
  const long long* lat;
  const float* loss;
  const long long* jit;
  const long long* eg_cap;
  const long long* eg_refill;
  // carry, in place
  long long* seq;
  int* sent_round;
  unsigned long long* rng;  // [H, 4]
  long long* tb_tokens;
  long long* tb_itv;
  long long* pkts_sent;
  long long* pkts_lost;
  long long* pkts_unreachable;
  long long* pkts_budget;
  long long* mono;
  // model pushes: inputs per port (host strides *_s), outputs [n_push, H]
  int n_push;
  const bool* pmask[kMaxPushPorts];
  const long long* pt[kMaxPushPorts];
  const int* pkind[kMaxPushPorts];
  long long pmask_s[kMaxPushPorts], pt_s[kMaxPushPorts], pkind_s[kMaxPushPorts];
  bool* op_mask;
  long long* op_t;
  long long* op_order;
  int* op_kind;
  // sends: inputs per port (count / inc may be null), outputs [E, H]
  int n_send;
  int cmax[kMaxSendPorts];
  const bool* smask[kMaxSendPorts];
  const long long* sdst[kMaxSendPorts];
  const int* ssize[kMaxSendPorts];
  const int* skind[kMaxSendPorts];
  const int* spayload[kMaxSendPorts];
  const int* scount[kMaxSendPorts];
  const int* sinc[kMaxSendPorts];
  // host strides in elements (payload and inc: row strides; words contiguous)
  long long smask_s[kMaxSendPorts], sdst_s[kMaxSendPorts], ssize_s[kMaxSendPorts],
      skind_s[kMaxSendPorts], spayload_s[kMaxSendPorts], scount_s[kMaxSendPorts],
      sinc_s[kMaxSendPorts];
  bool* e_mask;
  int* e_col;
  int* e_dst;
  long long* e_t;
  long long* e_order;
  int* e_kind;
  int* e_payload;
  long long* used_min;  // [H]
};

__device__ __forceinline__ void route(const EgressArgs& a, int h, long long dst, long long& lat,
                                      float& lossp, long long& jit) {
  if (a.route_mode == 0) {
    lat = a.lat[0];
    lossp = a.loss[0];
    jit = a.jit[0];
    return;
  }
  const int g = a.hosts_per_node;
  const long long dst_node = g > 0 ? floordiv(dst, g) : (long long)a.node_of[dst];
  long long i;
  if (a.route_mode == 1) {
    i = (long long)h * a.n_nodes + dst_node;
  } else {
    const long long src_node = g > 0 ? floordiv(h, g) : (long long)a.node_of[h];
    i = src_node * a.n_nodes + dst_node;
  }
  lat = a.lat[i];
  lossp = a.loss[i];
  jit = a.jit[i];
}

__global__ void event_egress_kernel(const EgressArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int H = a.H, P = a.P;
  const long long t = a.ev_t[(long long)h * a.es];
  const bool disp = a.dispatch[h];
  long long seq = a.seq[h];
  int sent = a.sent_round[h];
  u64 s[4];
  for (int k = 0; k < 4; ++k) s[k] = a.rng[(long long)h * 4 + k];
  long long tokens = a.tb_tokens[h], itv = a.tb_itv[h];
  const long long cap = a.eg_cap[h], refill = a.eg_refill[h];
  long long n_sent = 0, n_lost = 0, n_unreach = 0, n_budget = 0, n_mono = 0;

  // ---- the model's local pushes
  for (int p = 0; p < a.n_push; ++p) {
    const bool mask = a.pmask[p][h * a.pmask_s[p]] && disp;
    const long long pt = a.pt[p][h * a.pt_s[p]];
    n_mono += mask && pt < t;
    const long long o = (long long)p * H + h;
    a.op_mask[o] = mask;
    a.op_t[o] = imax(pt, t);
    a.op_order[o] = pack_order(1, h, seq);
    a.op_kind[o] = a.pkind[p][h * a.pkind_s[p]] & kKindMask;
    seq = wadd(seq, mask);
  }

  // ---- sends: each port a burst of up to cmax segments to one destination
  long long umin = kTimeMax;
  int e = 0;
  for (int sp = 0; sp < a.n_send; ++sp) {
    const bool mask0 = a.smask[sp][h * a.smask_s[sp]] && disp;
    const int counts =
        a.scount[sp] == nullptr ? (int)mask0 : (mask0 ? a.scount[sp][h * a.scount_s[sp]] : 0);
    const int sz = a.ssize[sp][h * a.ssize_s[sp]];
    const long long dst_raw = a.sdst[sp][h * a.sdst_s[sp]];
    const bool bad_dst = mask0 && (dst_raw < 0 || dst_raw >= H);
    const long long dst = imin(imax(dst_raw, 0), H - 1);
    long long lat, jit;
    float lossp;
    route(a, h, dst, lat, lossp, jit);
    const long long lat_bound0 = a.use_jitter ? wsub(lat, jit) : lat;
    const int port_kind = a.skind[sp][h * a.skind_s[sp]] | kKindPkt;
    const int* pay = a.spayload[sp] + h * a.spayload_s[sp];
    const int* inc = a.sinc[sp] == nullptr ? nullptr : a.sinc[sp] + h * a.sinc_s[sp];
    for (int j = 0; j < a.cmax[sp]; ++j, ++e) {
      const bool mask = mask0 && counts > j;
      const bool over = sent >= a.budget;
      long long eg_depart = t;
      if (a.shaping)
        eg_depart = tb_remove(tokens, itv, cap, refill, a.interval, t, wmul((long long)sz, 8),
                              mask && !over);
      long long lat_j = lat;
      if (a.use_jitter) {
        const float uj = rng_uniform(s, mask);
        const float x = __fmul_rn(__fsub_rn(__fmul_rn(uj, 2.0f), 1.0f), __ll2float_rn(jit));
        lat_j = wadd(lat, __float2ll_rz(x));
      }
      const bool unreachable = mask && (lat_bound0 < 0 || bad_dst);
      const float u = rng_uniform(s, mask);
      const bool lost = mask && u < lossp && t >= a.bootstrap_end;
      const bool send_ok = mask && !lost && !unreachable && !over;
      const bool budget_dropped = mask && !lost && !unreachable && over;
      const long long o = (long long)e * H + h;
      a.e_mask[o] = send_ok;
      a.e_col[o] = sent;
      a.e_dst[o] = (int)dst;
      a.e_t[o] = imax(wadd(eg_depart, imax(lat_j, 0)), a.window_end);
      a.e_order[o] = pack_order(0, h, seq);
      a.e_kind[o] = port_kind;
      for (int w = 0; w < P; ++w) {
        int v = pay[w];
        if (j > 0 && inc != nullptr) v = wadd32(v, wmul32(j, inc[w]));
        a.e_payload[o * P + w] = w == kSizeWord ? sz : v;
      }
      sent += send_ok;
      seq = wadd(seq, mask);
      if (send_ok) umin = imin(umin, lat_bound0);
      n_sent += mask;
      n_lost += lost;
      n_unreach += unreachable;
      n_budget += budget_dropped;
    }
  }

  a.seq[h] = seq;
  a.sent_round[h] = sent;
  for (int k = 0; k < 4; ++k) a.rng[(long long)h * 4 + k] = s[k];
  a.tb_tokens[h] = tokens;
  a.tb_itv[h] = itv;
  a.pkts_sent[h] = wadd(a.pkts_sent[h], n_sent);
  a.pkts_lost[h] = wadd(a.pkts_lost[h], n_lost);
  a.pkts_unreachable[h] = wadd(a.pkts_unreachable[h], n_unreach);
  a.pkts_budget[h] = wadd(a.pkts_budget[h], n_budget);
  a.mono[h] = wadd(a.mono[h], n_mono);
  if (a.used_min != nullptr) a.used_min[h] = umin;  // null: the model has no send port
}

}  // namespace

extern "C" {

int event_outbox_append(const long long* args, void* stream) {
  Reader r{args, 0};
  AppendArgs a;
  a.H = (int)r.v();
  a.B = (int)r.v();
  a.P = (int)r.v();
  a.ob_dst = r.p<int>();
  a.ob_t = r.p<long long>();
  a.ob_order = r.p<long long>();
  a.ob_kind = r.p<int>();
  a.ob_payload = r.p<int>();
  a.ob_count = r.p<int>();
  a.ob_lost = r.p<long long>();
  a.n = (int)r.v();
  if (a.n < 0 || a.n > kMaxStacks) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.n; ++s) {
    a.E[s] = (int)r.v();
    a.mask[s] = r.p<const bool>();
    a.col[s] = r.p<const int>();
    a.dst[s] = r.p<const int>();
    a.t[s] = r.p<const long long>();
    a.order[s] = r.p<const long long>();
    a.kind[s] = r.p<const int>();
    a.payload[s] = r.p<const int>();
  }
  if (a.H > 0 && a.n > 0)
    outbox_append_kernel<<<blocks_for(a.H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int event_ingress(const long long* args, void* stream) {
  Reader r{args, 0};
  IngressArgs a;
  a.H = (int)r.v();
  a.P = (int)r.v();
  a.es = (int)r.v();
  a.shaping = (int)r.v();
  a.use_codel = (int)r.v();
  a.interval = r.v();
  a.ev_t = r.p<const long long>();
  a.ev_order = r.p<const long long>();
  a.ev_kind = r.p<const int>();
  a.ev_payload = r.p<const int>();
  a.active = r.p<const bool>();
  a.events = r.p<long long>();
  a.digest = r.p<unsigned long long>();
  a.codel_dropped = r.p<long long>();
  a.delivered = r.p<long long>();
  a.tb_tokens = r.p<long long>();
  a.tb_itv = r.p<long long>();
  a.tb_cap = r.p<const long long>();
  a.tb_refill = r.p<const long long>();
  a.cd_first_above = r.p<long long>();
  a.cd_drop_next = r.p<long long>();
  a.cd_count = r.p<int>();
  a.cd_dropping = r.p<bool>();
  a.dispatch = r.p<bool>();
  a.is_pkt = r.p<bool>();
  a.kind_out = r.p<int>();
  a.src_out = r.p<long long>();
  a.rq_mask = r.p<bool>();
  a.rq_t = r.p<long long>();
  a.rq_kind = r.p<int>();
  if (a.P < 1 || a.interval <= 0) return (int)cudaErrorInvalidValue;
  if (a.H > 0)
    event_ingress_kernel<<<blocks_for(a.H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int event_egress(const long long* args, void* stream) {
  Reader r{args, 0};
  EgressArgs a;
  a.H = (int)r.v();
  a.P = (int)r.v();
  a.es = (int)r.v();
  a.budget = (int)r.v();
  a.shaping = (int)r.v();
  a.use_jitter = (int)r.v();
  a.route_mode = (int)r.v();
  a.hosts_per_node = (int)r.v();
  a.n_nodes = (int)r.v();
  a.window_end = r.v();
  a.bootstrap_end = r.v();
  a.interval = r.v();
  a.ev_t = r.p<const long long>();
  a.dispatch = r.p<const bool>();
  a.node_of = r.p<const int>();
  a.lat = r.p<const long long>();
  a.loss = r.p<const float>();
  a.jit = r.p<const long long>();
  a.eg_cap = r.p<const long long>();
  a.eg_refill = r.p<const long long>();
  a.seq = r.p<long long>();
  a.sent_round = r.p<int>();
  a.rng = r.p<unsigned long long>();
  a.tb_tokens = r.p<long long>();
  a.tb_itv = r.p<long long>();
  a.pkts_sent = r.p<long long>();
  a.pkts_lost = r.p<long long>();
  a.pkts_unreachable = r.p<long long>();
  a.pkts_budget = r.p<long long>();
  a.mono = r.p<long long>();
  a.n_push = (int)r.v();
  if (a.n_push < 0 || a.n_push > kMaxPushPorts) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.n_push; ++p) {
    a.pmask[p] = r.p<const bool>();
    a.pmask_s[p] = r.v();
    a.pt[p] = r.p<const long long>();
    a.pt_s[p] = r.v();
    a.pkind[p] = r.p<const int>();
    a.pkind_s[p] = r.v();
  }
  a.op_mask = r.p<bool>();
  a.op_t = r.p<long long>();
  a.op_order = r.p<long long>();
  a.op_kind = r.p<int>();
  a.n_send = (int)r.v();
  if (a.n_send < 0 || a.n_send > kMaxSendPorts) return (int)cudaErrorInvalidValue;
  for (int sp = 0; sp < a.n_send; ++sp) {
    a.cmax[sp] = (int)r.v();
    a.smask[sp] = r.p<const bool>();
    a.smask_s[sp] = r.v();
    a.sdst[sp] = r.p<const long long>();
    a.sdst_s[sp] = r.v();
    a.ssize[sp] = r.p<const int>();
    a.ssize_s[sp] = r.v();
    a.skind[sp] = r.p<const int>();
    a.skind_s[sp] = r.v();
    a.spayload[sp] = r.p<const int>();
    a.spayload_s[sp] = r.v();
    a.scount[sp] = r.p<const int>();
    a.scount_s[sp] = r.v();
    a.sinc[sp] = r.p<const int>();
    a.sinc_s[sp] = r.v();
  }
  a.e_mask = r.p<bool>();
  a.e_col = r.p<int>();
  a.e_dst = r.p<int>();
  a.e_t = r.p<long long>();
  a.e_order = r.p<long long>();
  a.e_kind = r.p<int>();
  a.e_payload = r.p<int>();
  a.used_min = r.p<long long>();
  if (a.P < 1 || a.P > kMaxPayload || a.interval <= 0 || a.route_mode < 0 || a.route_mode > 2)
    return (int)cudaErrorInvalidValue;
  if (a.H > 0)
    event_egress_kernel<<<blocks_for(a.H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
