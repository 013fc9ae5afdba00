// Per-event chain kernels of the microstep. Plain C interface (ctypes);
// every entry point launches on the stream it is given and returns
// cudaGetLastError().
//
// Replaces (JAX reference):
//   K10 shadow_tpu/core/engine.py:2288-2367 _event_body, ingress half (B5):
//       events + digest fold, CoDel and the downlink token bucket, the
//       bucket-delay requeue, dispatch, pkts_delivered; with the CPU model
//       (B20, :2754-2785 and :2995-3016) first the execution-time rewrite
//       max(t, busy_until) and the busy update; with queue-hold crash
//       faults (B13, :2768-2790 and :2996-3016) the restart floor of the
//       crash window containing that time, counted in faults_delayed; with
//       queue-clear faults (:2792-2803, :3020-3026) an event whose
//       execution time is down is consumed, not dispatched, and counted in
//       faults_dropped; with the integrity sentinel's dual digest (B15,
//       :1093-1101, :2293-2297) the second per-host fold; with the network
//       observatory (B23, :2302-2318) each executed event's class (timer:
//       the model's timer kinds, as a bitmask; packet; app) counted into
//       the three [1] ec_* lanes, per block in shared memory, then one
//       64-bit atomic add per class and block
//   K36 shadow_tpu/ops/events.py:138 pop_min followed by K10's ingress: the
//       one-event microstep's pop from a flat queue (the pop's device code
//       in queue_pop.cuh, shared with K2) and its ingress in one launch,
//       under one scalar limit or per-host limits (the CPU model's and
//       queue hold's held hosts, the ensemble plane's per-row window ends)
//   K11 shadow_tpu/core/engine.py:2415-2640 _event_body, egress half (B5):
//       the model's local pushes (order keys, monotonic violations), then
//       every send port and burst segment: route lookup, send budget,
//       uplink token bucket, jitter and loss draws, outbox column and
//       arrival time, the packet counters; with the fluid plane on
//       (:2459-2470, :2577-2603, :2633-2638) the background latency
//       inflation and, when its loss is on, the counter-hash loss draw
//       (shadow_tpu/net/fluid.py:302 fluid_send_uniform); with link-fault
//       windows (B14, :2445-2458, :2562-2613; core/faults.py:281
//       window_effects) one more loss draw after the path-loss draw and the
//       latency inflation, counted in faults_dropped and faults_delayed;
//       and, in its epilogue, shadow_tpu/core/engine.py:1126
//       _outbox_append_multi (B4) with the used-latency fold of the
//       microstep (min_used_lat): each landed send is written straight into
//       the [H, B] outbox at its send cursor, counted into the outbox count,
//       and a cursor at or past B is counted lost (ob_dropped)
// with the device math of csrc/event_math.cuh (RNG, token bucket, CoDel,
// FNV fold).
//
// Layout: [H] lanes per host; the event may be a column of the K-way peek
// (host stride `es` elements, payload stride es * P). The outbox is [H, B]
// per field (payload [H, B, P]); its count and loss lanes and min_used_lat
// hold one value per replica. Model push ports and send ports come as arrays of per-port
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
// result cannot depend on scheduling.
//
// K10 and K36 share one ingress body (`load_host`, `ingress_host`): every
// carry lane it reads is loaded into registers before the first store, so
// the loads' latencies overlap instead of adding up behind stores the
// compiler could not move them past, and every store comes last. Blocks
// of 64 threads, so 10,000 hosts spread over all 132 SMs. K36 (the pop and
// the ingress of the one-event microstep) saves K2's launch, its [H] event
// round trip through device memory and the wrapper's allocations: a group
// of four lanes owns a host, reads its row of the time plane into
// registers while its lead loads the carry lanes, and reads the order plane
// only where the least time ties; the lead then runs the ingress.
//
// K11's outbox epilogue, and why it equals the separate append bit for bit:
// a host's send cursor `sent_round` rises by one per landed send within a
// round, and the landed send takes the cursor's value as its column. So no
// two rows of a round, from any event column of a K-way microstep, land on
// the same (h, col): the row writes are order-free, and appending per event
// column (one K11 launch each) gives the per-microstep append's outbox.
// The only cross-host writes are the replica's totals: the appended rows,
// the rows lost past B and the least pre-jitter latency of a landed send.
// Integer sums and min are exact and commute, so any order gives the same
// lanes. To spare L2 thousands of same-address atomics, a warp's lanes are
// grouped by replica (__match_any_sync on h / HR; a warp may straddle two
// replicas), summed within the group (__reduce_add_sync; the min by a
// segmented shuffle), and the group's leader does one atomicAdd per
// counter and one 64-bit atomicMin.
//
// Replicas (the ensemble plane): the H rows may be R replicas of HR hosts
// (replica r in rows [r * HR, (r + 1) * HR)). K11 counts each row's
// appends and losses, and folds its latency, into its replica's [R] lanes;
// it uses the host's id
// within its replica (row % HR, plus host_base) for order keys and draws,
// a destination's range [0, HR), its replica's window end (an [R] lane in
// place of the scalar) and link-fault windows ([R, L]: row r / HR), and
// per-host route rows held once ([HR, N]) or per row ([H, N]). K10 reads no
// host id and no window: its rows are replica-blind. HR = H is one replica.
//
// Argument blocks: K10, K11 and K36 take their pointers and scalars as one
// int64 array read in a fixed order (`Args` below; K36's is K10's followed
// by the pop's); the Python wrappers (ops/chain.py) build it in the same
// order.

#include <cstdint>
#include <cuda_runtime.h>

#include "event_math.cuh"
#include "faults.cuh"
#include "queue_pop.cuh"

using namespace evm;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPushPorts = 8;
constexpr int kMaxSendPorts = 8;
constexpr int kMaxPayload = 16;
constexpr unsigned kFullMask = 0xffffffffu;

inline int blocks_for(int H) { return (H + kThreads - 1) / kThreads; }

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

// ---------------------------------------------------------------------------
// K10 event_ingress and K36 pop_ingress
// ---------------------------------------------------------------------------

// Threads per block of K10: 10,000 hosts make 157 blocks over the card's
// 132 SMs. K36: 128 threads per block (32 hosts of four lanes: 10,000 hosts
// make 313 blocks, all resident at once), and the columns each lane holds
// per pass of its row (four lanes: a 64-slot row in one pass).
constexpr int kIngressThreads = 64;
constexpr int kPopThreads = 128;
constexpr int kPopPerLane = 16;

struct IngressArgs {
  int H, P, es, shaping, use_codel;
  long long interval;
  // event (host stride es; payload stride es * P) and the active mask; the
  // time lane is rewritten to the execution time under the CPU model. K36
  // writes these (es = 1) from the pop.
  long long* ev_t;
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
  // the CPU model (null when off): the per-event charge and the busy
  // horizon, in place
  long long cpu_delay;
  long long* busy;
  // crash faults (fault_mode 0 off, 1 queue hold, 2 queue clear): the
  // [H, W] windows and the counters, in place
  int fault_mode, W;
  const long long* down_t;
  const long long* up_t;
  long long* faults_delayed;
  long long* faults_dropped;
  // the integrity sentinel's second digest (null when off), in place
  unsigned long long* digest2;
  // the network observatory's event-class lane (null when off): each
  // executed event counts once as timer (its model kind's bit set in
  // timer_mask, no packet flag), packet or app, into [1] counters
  unsigned long long timer_mask;
  long long* ec[3];  // timer, packet, app
};

// One host's carry lanes that ingress reads, in registers. Only the lanes
// of the planes that are on are loaded.
struct HostIn {
  long long events = 0, delivered = 0, busy = 0, faults = 0;
  unsigned long long digest = 0, digest2 = 0;
  long long tb_tokens = 0, tb_itv = 0, tb_cap = 0, tb_refill = 0, codel_dropped = 0;
  long long cd_first_above = 0, cd_drop_next = 0;
  int cd_count = 0;
  bool cd_dropping = false;
};

// The event one host executes, before the execution-time rewrite.
struct EvIn {
  bool act;
  long long t, order;
  int kind;
  int size;  // payload word kSizeWord (the packet's bytes), read under shaping
};

// Every carry lane ingress reads, before any store: none of these depends
// on the event, so K36 issues them before its pop.
__device__ __forceinline__ HostIn load_host(const IngressArgs& a, const int h) {
  const long long* __restrict__ events = a.events;
  const unsigned long long* __restrict__ digest = a.digest;
  const long long* __restrict__ delivered = a.delivered;
  HostIn s;
  s.events = events[h];
  s.digest = digest[h];
  s.delivered = delivered[h];
  if (a.digest2 != nullptr) s.digest2 = a.digest2[h];
  if (a.busy != nullptr) s.busy = a.busy[h];
  if (a.fault_mode == 1) s.faults = a.faults_delayed[h];
  if (a.fault_mode == 2) s.faults = a.faults_dropped[h];
  if (a.shaping) {
    const long long* __restrict__ tokens = a.tb_tokens;
    const long long* __restrict__ itv = a.tb_itv;
    const long long* __restrict__ codel_dropped = a.codel_dropped;
    s.tb_tokens = tokens[h];
    s.tb_itv = itv[h];
    s.tb_cap = __ldg(a.tb_cap + h);
    s.tb_refill = __ldg(a.tb_refill + h);
    s.codel_dropped = codel_dropped[h];
    if (a.use_codel) {
      const long long* __restrict__ fa = a.cd_first_above;
      const long long* __restrict__ dn = a.cd_drop_next;
      const int* __restrict__ cnt = a.cd_count;
      const bool* __restrict__ dropping = a.cd_dropping;
      s.cd_first_above = fa[h];
      s.cd_drop_next = dn[h];
      s.cd_count = cnt[h];
      s.cd_dropping = dropping[h];
    }
  }
  return s;
}

// Whether the host is down at t under its crash windows, and the restart
// of the window containing t.
__device__ __forceinline__ bool host_down(const IngressArgs& a, const int h, const long long t,
                                          long long& resume) {
  const long long row = (long long)h * a.W;
  return flt::down_resume(a.down_t + row, a.up_t + row, a.W, t, resume);
}

// One host's ingress on lanes already in registers: the arithmetic in
// registers, then every store. `t` gets the execution time (the event's
// own where no floor moved it). Returns the executed event's class (1
// timer, 2 packet, 3 app) or 0 where no event executed.
__device__ __forceinline__ int ingress_host(const IngressArgs& a, const int h, const HostIn& s,
                                            const EvIn& e, long long& t) {
  bool act = e.act;
  t = e.t;
  bool delayed = false, fdrop = false;
  if ((a.busy != nullptr || a.fault_mode == 1) && act) {
    // the execution time max(t, busy) — and under queue hold the restart
    // of a crash window containing it — replaces the event's time for
    // every consumer downstream (digest, shaping, handler, egress)
    if (a.busy != nullptr) t = imax(t, s.busy);
    long long resume;
    if (a.fault_mode == 1 && host_down(a, h, t, resume)) {
      t = imax(t, resume);
      delayed = true;
    }
  }
  if (a.fault_mode == 2 && act) {
    // queue clear: an event executing inside a crash window is consumed
    // (its host's CPU time charged) but not dispatched: no digest, no
    // pushes, no sends
    long long resume;
    if (host_down(a, h, t, resume)) {
      act = false;
      fdrop = true;
    }
  }
  const long long order = e.order;
  const int kind = e.kind;
  const bool pkt = (kind & kKindPkt) != 0;
  bool dispatch = act;
  bool needs = false, drop = false, charge = false, delay = false;
  long long depart = 0, tokens = s.tb_tokens, itv = s.tb_itv;
  Codel cd{s.cd_first_above, s.cd_drop_next, s.cd_count, s.cd_dropping};
  if (a.shaping) {
    needs = act && pkt && (kind & kKindIngressDone) == 0;
    const long long size_bits = wmul((long long)e.size, 8);
    // the departure the packet gets, and the bucket after its charge:
    // CoDel judges the sojourn, then the charge applies the plan
    const TbPlan tp = tb_plan(tokens, itv, s.tb_cap, s.tb_refill, a.interval, t, size_bits);
    depart = tp.depart;
    if (a.use_codel) drop = codel_on_packet(cd, t, wsub(depart, t), needs);
    charge = needs && !drop;
    if (charge && s.tb_refill > 0) {
      tokens = tp.tokens;
      itv = tp.last_itv;
    }
    delay = charge && depart > t;
    dispatch = act && !(needs && (drop || delay));
  }
  // the stores
  if (act) {
    a.events[h] = wadd(s.events, 1);
    a.digest[h] = digest_fold(s.digest, t, kind, order);
    if (a.digest2 != nullptr) a.digest2[h] = digest2_fold(s.digest2, t, kind, order);
  }
  if (a.busy != nullptr && e.act) a.busy[h] = wadd(t, a.cpu_delay);
  if (delayed) a.faults_delayed[h] = wadd(s.faults, 1);
  if (fdrop) a.faults_dropped[h] = wadd(s.faults, 1);
  if (a.shaping) {
    if (a.use_codel && needs) {
      a.cd_first_above[h] = cd.first_above;
      a.cd_drop_next[h] = cd.drop_next;
      a.cd_count[h] = cd.count;
      a.cd_dropping[h] = cd.dropping;
    }
    if (charge && s.tb_refill > 0) {
      a.tb_tokens[h] = tokens;
      a.tb_itv[h] = itv;
    }
    a.rq_mask[h] = delay;
    a.rq_t[h] = depart;
    a.rq_kind[h] = kind | kKindIngressDone;
    if (drop) a.codel_dropped[h] = wadd(s.codel_dropped, 1);
  }
  if (dispatch && pkt) a.delivered[h] = wadd(s.delivered, 1);
  a.dispatch[h] = dispatch;
  a.is_pkt[h] = pkt;
  a.kind_out[h] = kind & kKindMask;
  a.src_out[h] = (order >> kSrcShift) & kSrcMask;
  if (!act) return 0;
  if (pkt) return 2;
  const int mk = kind & kKindMask;
  return (mk < 64 && ((a.timer_mask >> mk) & 1ull)) ? 1 : 3;
}

// The event-class lane: counts in shared memory, then one 64-bit atomic
// add per class and block (integer sums: exact in any order).
struct ClassCounts {
  unsigned* cnt;  // [3] in shared memory

  __device__ __forceinline__ void init(const IngressArgs& a) {
    if (a.ec[0] != nullptr && threadIdx.x < 3) cnt[threadIdx.x] = 0;
    __syncthreads();
  }
  __device__ __forceinline__ void add(int cls) {
    if (cls) atomicAdd(&cnt[cls - 1], 1u);
  }
  __device__ __forceinline__ void flush(const IngressArgs& a) {
    __syncthreads();
    if (threadIdx.x < 3 && cnt[threadIdx.x])
      atomicAdd(reinterpret_cast<unsigned long long*>(a.ec[threadIdx.x]),
                (unsigned long long)cnt[threadIdx.x]);
  }
};

// K10: one thread per host; the event's lanes and the host's carry lanes
// are loaded before the first store.
__global__ void __launch_bounds__(kIngressThreads) event_ingress_kernel(const IngressArgs a) {
  __shared__ unsigned cnt[3];
  ClassCounts cc{cnt};
  const bool classes = a.ec[0] != nullptr;  // the same for every thread of the launch
  if (classes) cc.init(a);
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  int cls = 0;
  if (h < a.H) {
    const long long ei = (long long)h * a.es;
    const HostIn s = load_host(a, h);
    const EvIn e{a.active[h], a.ev_t[ei], a.ev_order[ei], a.ev_kind[ei],
                 a.shaping ? a.ev_payload[ei * a.P + kSizeWord] : 0};
    long long t;
    cls = ingress_host(a, h, s, e, t);
    if ((a.busy != nullptr || a.fault_mode == 1) && e.act) a.ev_t[ei] = t;
  }
  if (classes) {
    cc.add(cls);
    cc.flush(a);
  }
}

// K36's pop: the flat queue's [H, C] slab and the limit (one for every
// host, or per host where `limits` is not null).
struct PopArgs {
  long long* t;
  long long* order;
  const int* kind;
  const int* payload;
  int C;
  long long limit;
  const long long* limits;
};

// K36: pop each host's earliest event below its limit and run K10's
// ingress on it, in one launch. A group of G lanes owns a host (G = 4 up
// to 64 slots, else the warp); its lead lane (g = 0) runs the ingress.
// Per host, in three steps with one round trip each:
//  1. the lead loads the host's carry lanes and every lane its limit and
//     its columns of the time plane (kPopPerLane per pass, lane g holding
//     V adjacent columns in every V * G, so the group reads the row
//     contiguously; V = 2, 16-byte loads, where C is even), all in flight
//     together; the group merges the least time, its first slot and how
//     many slots hold it (shuffles over the whole warp, tail lanes
//     included, so no warp diverges before them);
//  2. at one slot holding the least time (the common case: live keys
//     rarely share a time) that slot wins: its order key, kind and payload
//     are read together. Where several slots tie, each lane reads the
//     order key at its tied slots, the group takes the (order, slot)
//     minimum (a group-uniform branch: shuffles over the group's lanes),
//     and the winner's kind and payload follow;
//  3. the lead runs the ingress in registers and stores last: the slot
//     clear, the event, `active`, the carry lanes and the outputs; the
//     group's lanes store the payload words.
// No shared memory and no barrier but the event-class lane's: the time
// plane goes straight into registers (one warp request: 8 rows x 64 bytes).
// Measured against a shared-memory tile filled by cp.async, it saves the
// tile's second scan and write-back (PERF.md, K36's row).
template <int G, int V>
__global__ void __launch_bounds__(kPopThreads)
    pop_ingress_kernel(const PopArgs q, const IngressArgs a, long long* __restrict__ ev_order,
                       int* __restrict__ ev_kind, int* __restrict__ ev_payload,
                       bool* __restrict__ active) {
  __shared__ unsigned cnt[3];
  ClassCounts cc{cnt};
  const bool classes = a.ec[0] != nullptr;  // the same for every thread of the launch
  if (classes) cc.init(a);
  const int g = threadIdx.x & (G - 1);
  const int h = blockIdx.x * (kPopThreads / G) + threadIdx.x / G;
  const bool own = h < a.H;
  const bool lead = own && g == 0;
  const unsigned gmask =
      G == 32 ? qpop::kFull : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const long long base = (long long)(own ? h : 0) * q.C;
  // read here, cleared by the lead at the end (its reads come first)
  const long long* t_row = q.t + base;
  const long long* o_row = q.order + base;
  // 1. carry lanes, limit and the time plane in flight together
  HostIn s;
  if (lead) s = load_host(a, h);
  const long long lim = !own ? kTimeMax : q.limits != nullptr ? q.limits[h] : q.limit;
  constexpr int W = G * kPopPerLane;
  // the slot of a lane's j-th column in the pass from c0 (increasing in j)
  const auto col = [g](int c0, int j) { return c0 + V * g + V * G * (j / V) + j % V; };
  qpop::MinTies mt;
  long long v[kPopPerLane];  // after the loop: the last pass's times
  for (int c0 = 0; c0 < q.C; c0 += W) {
#pragma unroll
    for (int j = 0; j < kPopPerLane; j += V) {
      const int c = col(c0, j);
      if constexpr (V == 2) {  // C even: c < C holds c + 1 too
        longlong2 x = make_longlong2(kTimeMax, kTimeMax);
        if (own && c < q.C) x = *reinterpret_cast<const longlong2*>(t_row + c);
        v[j] = x.x;
        v[j + 1] = x.y;
      } else {
        v[j] = own && c < q.C ? t_row[c] : kTimeMax;
      }
    }
#pragma unroll
    for (int j = 0; j < kPopPerLane; ++j) mt.fold(v[j], col(c0, j));
  }
  mt.group_merge<G>();
  // an active row's least time is live, so the padding never ties it
  const bool act = own && mt.m < lim;
  // 2. the winner
  int slot = mt.first;
  long long order = kOrderMax;
  if (act && mt.ties > 1) {  // the same for the whole group
    qpop::Cand w;
    if (q.C <= W) {
      // one pass: the times are still in registers, and every tied
      // slot's order key is read in one round trip
      long long o[kPopPerLane];
#pragma unroll
      for (int j = 0; j < kPopPerLane; ++j) o[j] = v[j] == mt.m ? o_row[col(0, j)] : kOrderMax;
#pragma unroll
      for (int j = 0; j < kPopPerLane; ++j)
        if (v[j] == mt.m) w.fold(mt.m, o[j], col(0, j));
    } else {
      for (int c = g; c < q.C; c += G)
        if (t_row[c] == mt.m) w.fold(mt.m, o_row[c], c);
    }
    qpop::group_min<G>(w, gmask);
    slot = w.i;
    order = w.o;
  }
  const long long at = base + slot;
  int kind = 0, size = 0;
  if (act && g == 0) {
    if (mt.ties == 1) order = o_row[slot];
    kind = q.kind[at];
    if (a.shaping) size = q.payload[at * a.P + kSizeWord];
  }
  if (own)
    for (int p = g; p < a.P; p += G)
      ev_payload[(long long)h * a.P + p] = act ? q.payload[at * a.P + p] : 0;
  // 3. the ingress, and every store
  int cls = 0;
  if (lead) {
    const EvIn e{act, act ? mt.m : kTimeMax, order, kind, size};
    long long t;
    cls = ingress_host(a, h, s, e, t);
    if (act) {
      q.t[at] = kTimeMax;
      q.order[at] = kOrderMax;
    }
    a.ev_t[h] = act ? t : kTimeMax;
    ev_order[h] = order;
    ev_kind[h] = kind;
    active[h] = act;
  }
  if (classes) {
    cc.add(cls);
    cc.flush(a);
  }
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
  // fluid coupling (bg_lat null: the plane is off): per-host extra loss and
  // latency x1000 for this round; the draw runs only when fluid_draw is set
  const float* bg_loss;
  const long long* bg_lat;
  unsigned long long fluid_seed;
  int fluid_draw;
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
  // the outbox [H, B] (payload [H, B, P]) and its [R] lanes, in place:
  // appended rows, rows lost past B, the used-latency minimum
  int B;
  int* ob_dst;
  long long* ob_t;
  long long* ob_order;
  int* ob_kind;
  int* ob_payload;
  int* ob_count;
  long long* ob_lost;
  long long* min_used;
  // link-fault windows (n_win 0: none): [L] each, and the counters, in place
  int n_win;
  const long long* win_start;
  const long long* win_end;
  const float* win_loss;
  const long long* win_lat;
  long long* faults_dropped;
  long long* faults_delayed;
  // the mesh: this shard's first global host id and the global host count
  // (a destination's range; one device: 0 and H)
  long long host_base, n_hosts;
  // replicas: rows per replica (H: one), the [R] window ends (null: the
  // scalar window_end), the rows of the mode-1 route tables (HR or H)
  int hr;
  const long long* wend;
  long long route_rows;
};

__device__ __forceinline__ void route(const EgressArgs& a, int h, long long gh, long long dst,
                                      long long& lat, float& lossp, long long& jit) {
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
    i = (long long)(h % a.route_rows) * a.n_nodes + dst_node;
  } else {
    const long long src_node = g > 0 ? floordiv(gh, g) : (long long)a.node_of[gh];
    i = src_node * a.n_nodes + dst_node;
  }
  lat = a.lat[i];
  lossp = a.loss[i];
  jit = a.jit[i];
}

// One host's egress; returns, through the references, its appended rows,
// its rows lost past B and the least pre-jitter latency of its landed sends
// (kTimeMax where none).
__device__ __forceinline__ void egress_one(const EgressArgs& a, const int h, int& n_app,
                                           int& n_oblost, long long& umin) {
  const int H = a.H, P = a.P, B = a.B;
  // the global host id within the replica (order keys, draws)
  const long long gh = a.host_base + h % a.hr;
  const int rep = h / a.hr;
  const long long window_end = a.wend != nullptr ? a.wend[rep] : a.window_end;
  const long long t = a.ev_t[(long long)h * a.es];
  const bool disp = a.dispatch[h];
  long long seq = a.seq[h];
  int sent = a.sent_round[h];
  u64 s[4];
  for (int k = 0; k < 4; ++k) s[k] = a.rng[(long long)h * 4 + k];
  long long tokens = a.tb_tokens[h], itv = a.tb_itv[h];
  const long long cap = a.eg_cap[h], refill = a.eg_refill[h];
  long long n_sent = 0, n_lost = 0, n_unreach = 0, n_budget = 0, n_mono = 0;
  const bool fluid = a.bg_lat != nullptr;
  const float bg_loss = fluid ? a.bg_loss[h] : 0.0f;
  const long long bg_lat = fluid ? a.bg_lat[h] : kLatScale;
  // inflation honours bootstrap_end_time like the loss draws
  const bool bg_inflate = fluid && bg_lat > kLatScale && t >= a.bootstrap_end;
  // the link-fault windows active at the event's time, shared by every
  // port and segment below
  float f_loss = 0.0f;
  long long f_lat = kLatScale;
  if (a.n_win > 0) {
    const long long w0 = (long long)rep * a.n_win;  // the replica's windows
    flt::window_effects(a.win_start + w0, a.win_end + w0, a.win_loss + w0, a.win_lat + w0,
                        a.n_win, t, f_loss, f_lat);
  }
  const bool f_inflate = f_lat > kLatScale && t >= a.bootstrap_end;
  long long n_fdrop = 0, n_fdelay = 0;

  // ---- the model's local pushes
  for (int p = 0; p < a.n_push; ++p) {
    const bool mask = a.pmask[p][h * a.pmask_s[p]] && disp;
    const long long pt = a.pt[p][h * a.pt_s[p]];
    n_mono += mask && pt < t;
    const long long o = (long long)p * H + h;
    a.op_mask[o] = mask;
    a.op_t[o] = imax(pt, t);
    a.op_order[o] = pack_order(1, gh, seq);
    a.op_kind[o] = a.pkind[p][h * a.pkind_s[p]] & kKindMask;
    seq = wadd(seq, mask);
  }

  // ---- sends: each port a burst of up to cmax segments to one destination
  for (int sp = 0; sp < a.n_send; ++sp) {
    const bool mask0 = a.smask[sp][h * a.smask_s[sp]] && disp;
    const int counts =
        a.scount[sp] == nullptr ? (int)mask0 : (mask0 ? a.scount[sp][h * a.scount_s[sp]] : 0);
    const int sz = a.ssize[sp][h * a.ssize_s[sp]];
    const long long dst_raw = a.sdst[sp][h * a.sdst_s[sp]];
    const bool bad_dst = mask0 && (dst_raw < 0 || dst_raw >= a.n_hosts);
    const long long dst = imin(imax(dst_raw, 0), a.n_hosts - 1);
    long long lat, jit;
    float lossp;
    route(a, h, gh, dst, lat, lossp, jit);
    const long long lat_bound0 = a.use_jitter ? wsub(lat, jit) : lat;
    const int port_kind = a.skind[sp][h * a.skind_s[sp]] | kKindPkt;
    const int* pay = a.spayload[sp] + h * a.spayload_s[sp];
    const int* inc = a.sinc[sp] == nullptr ? nullptr : a.sinc[sp] + h * a.sinc_s[sp];
    for (int j = 0; j < a.cmax[sp]; ++j) {
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
      // fault loss draws after the path-loss draw (a fixed place in the
      // host's stream), then the fault inflation of the jittered latency
      bool flost = false;
      if (a.n_win > 0) {
        const float uf = rng_uniform(s, mask);
        flost = mask && !lost && !unreachable && uf < f_loss && t >= a.bootstrap_end;
        if (f_inflate) lat_j = floordiv(wmul(lat_j, f_lat), kLatScale);
      }
      // fluid congestion loss after the path and fault draws (precedence:
      // path loss > unreachable > fault loss > fluid loss > budget), keyed
      // on the pre-increment seq; then the inflation of the latency
      bool bglost = false;
      if (fluid && a.fluid_draw)
        bglost = mask && !lost && !unreachable && !flost && t >= a.bootstrap_end &&
                 fluid_uniform(a.fluid_seed, gh, seq) < bg_loss;
      if (bg_inflate) lat_j = floordiv(wmul(lat_j, bg_lat), kLatScale);
      const bool send_ok = mask && !lost && !unreachable && !over && !bglost && !flost;
      const bool budget_dropped = mask && !lost && !unreachable && over && !bglost && !flost;
      n_fdrop += flost;
      // a fault-inflated send counts as delayed before the fluid draw
      n_fdelay += mask && !lost && !unreachable && !over && !flost && f_inflate;
      if (send_ok) {
        // the append: the row lands at the host's send cursor (counted
        // lost at or past B)
        ++n_app;
        if (sent >= B) {
          ++n_oblost;
        } else if (sent >= 0) {
          const long long o = (long long)h * B + sent;
          a.ob_dst[o] = (int)dst;
          a.ob_t[o] = imax(wadd(eg_depart, imax(lat_j, 0)), window_end);
          a.ob_order[o] = pack_order(0, gh, seq);
          a.ob_kind[o] = port_kind;
          for (int w = 0; w < P; ++w) {
            int v = pay[w];
            if (j > 0 && inc != nullptr) v = wadd32(v, wmul32(j, inc[w]));
            a.ob_payload[o * P + w] = w == kSizeWord ? sz : v;
          }
        }
        umin = imin(umin, lat_bound0);
      }
      sent += send_ok;
      seq = wadd(seq, mask);
      n_sent += mask;
      n_lost += lost || bglost;
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
  if (a.n_win > 0) {
    a.faults_dropped[h] = wadd(a.faults_dropped[h], n_fdrop);
    a.faults_delayed[h] = wadd(a.faults_delayed[h], n_fdelay);
  }
}

__global__ void event_egress_kernel(const EgressArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  int n_app = 0, n_oblost = 0;
  long long umin = kTimeMax;
  if (h < a.H) egress_one(a, h, n_app, n_oblost, umin);
  if (a.n_send == 0) return;  // the same for every thread of the launch
  // the epilogue: every lane of the warp takes part (kThreads is a multiple
  // of 32; lanes past H carry nothing, in a group of their own). The
  // replica's lanes are contiguous in the warp, so a segmented shuffle
  // scan leaves each group's min in its lowest lane, the leader.
  const int lane = threadIdx.x & 31;
  const int rep = h < a.H ? h / a.hr : -1;
  const unsigned peers = __match_any_sync(kFullMask, rep);
  const int leader = __ffs(peers) - 1;
  const int app = __reduce_add_sync(peers, n_app);
  const int oblost = __reduce_add_sync(peers, n_oblost);
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_down_sync(kFullMask, umin, off);
    const int vr = __shfl_down_sync(kFullMask, rep, off);
    if (lane + off < 32 && vr == rep) umin = imin(umin, v);
  }
  if (lane != leader || rep < 0) return;
  if (app) atomicAdd(a.ob_count + rep, app);
  if (oblost)
    atomicAdd(reinterpret_cast<unsigned long long*>(a.ob_lost + rep),
              (unsigned long long)oblost);
  if (umin < kTimeMax) atomicMin(a.min_used + rep, umin);
}

// K10's argument block (the order the Python wrappers build it in);
// false where it is inconsistent.
bool read_ingress(Reader& r, IngressArgs& a) {
  a.H = (int)r.v();
  a.P = (int)r.v();
  a.es = (int)r.v();
  a.shaping = (int)r.v();
  a.use_codel = (int)r.v();
  a.interval = r.v();
  a.ev_t = r.p<long long>();
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
  a.cpu_delay = r.v();
  a.busy = r.p<long long>();
  a.fault_mode = (int)r.v();
  a.W = (int)r.v();
  a.down_t = r.p<const long long>();
  a.up_t = r.p<const long long>();
  a.faults_delayed = r.p<long long>();
  a.faults_dropped = r.p<long long>();
  a.digest2 = r.p<unsigned long long>();
  a.timer_mask = (unsigned long long)r.v();
  for (int k = 0; k < 3; ++k) a.ec[k] = r.p<long long>();
  return !(a.P < 1 || a.interval <= 0 || a.fault_mode < 0 || a.fault_mode > 2 ||
           (a.fault_mode && (a.W < 1 || a.down_t == nullptr || a.up_t == nullptr)) ||
           (a.fault_mode == 1 && a.faults_delayed == nullptr) ||
           (a.fault_mode == 2 && a.faults_dropped == nullptr));
}

}  // namespace

extern "C" {

int event_ingress(const long long* args, void* stream) {
  Reader r{args, 0};
  IngressArgs a;
  if (!read_ingress(r, a)) return (int)cudaErrorInvalidValue;
  if (a.H > 0)
    event_ingress_kernel<<<(a.H + kIngressThreads - 1) / kIngressThreads, kIngressThreads, 0,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K36: K10's argument block (its event lanes and `active` are K36's
// outputs, es = 1) followed by the pop's: the slab planes t, order, kind,
// payload, the capacity C, the scalar limit and the per-host limits (0:
// none).
int pop_ingress(const long long* args, void* stream) {
  Reader r{args, 0};
  IngressArgs a;
  if (!read_ingress(r, a)) return (int)cudaErrorInvalidValue;
  PopArgs q;
  q.t = r.p<long long>();
  q.order = r.p<long long>();
  q.kind = r.p<const int>();
  q.payload = r.p<const int>();
  q.C = (int)r.v();
  q.limit = r.v();
  q.limits = r.p<const long long>();
  if (a.es != 1 || q.C < 1 || a.ev_t == nullptr) return (int)cudaErrorInvalidValue;
  if (a.H == 0) return (int)cudaGetLastError();
  // four lanes per host up to 64 slots, else a warp (two passes at 1,024);
  // 16-byte loads of the time plane where every row starts 16-byte aligned
  const bool narrow = q.C <= 4 * kPopPerLane;
  const bool v2 = q.C % 2 == 0 && reinterpret_cast<uintptr_t>(q.t) % 16 == 0;
  auto* kernel = narrow ? (v2 ? pop_ingress_kernel<4, 2> : pop_ingress_kernel<4, 1>)
                        : (v2 ? pop_ingress_kernel<32, 2> : pop_ingress_kernel<32, 1>);
  const int hosts = narrow ? kPopThreads / 4 : kPopThreads / 32;
  kernel<<<(a.H + hosts - 1) / hosts, kPopThreads, 0, (cudaStream_t)stream>>>(
      q, a, const_cast<long long*>(a.ev_order), const_cast<int*>(a.ev_kind),
      const_cast<int*>(a.ev_payload), const_cast<bool*>(a.active));
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
  a.bg_loss = r.p<const float>();
  a.bg_lat = r.p<const long long>();
  a.fluid_seed = (unsigned long long)r.v();
  a.fluid_draw = (int)r.v();
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
  a.B = (int)r.v();
  a.ob_dst = r.p<int>();
  a.ob_t = r.p<long long>();
  a.ob_order = r.p<long long>();
  a.ob_kind = r.p<int>();
  a.ob_payload = r.p<int>();
  a.ob_count = r.p<int>();
  a.ob_lost = r.p<long long>();
  a.min_used = r.p<long long>();
  a.n_win = (int)r.v();
  a.win_start = r.p<const long long>();
  a.win_end = r.p<const long long>();
  a.win_loss = r.p<const float>();
  a.win_lat = r.p<const long long>();
  a.faults_dropped = r.p<long long>();
  a.faults_delayed = r.p<long long>();
  a.host_base = r.v();
  a.n_hosts = r.v();
  a.hr = (int)r.v();
  a.wend = r.p<const long long>();
  a.route_rows = r.v();
  if (a.P < 1 || a.P > kMaxPayload || a.interval <= 0 || a.route_mode < 0 || a.route_mode > 2 ||
      a.hr < 1 || a.H % a.hr != 0 || (a.hr != a.H && a.wend == nullptr) ||
      (a.route_mode == 1 && (a.route_rows < 1 || a.H % a.route_rows != 0)) ||
      a.host_base < 0 || a.n_hosts < a.host_base + a.hr ||
      (a.n_send > 0 && (a.B < 0 || a.ob_dst == nullptr || a.ob_t == nullptr ||
                        a.ob_order == nullptr || a.ob_kind == nullptr ||
                        a.ob_payload == nullptr || a.ob_count == nullptr ||
                        a.ob_lost == nullptr || a.min_used == nullptr)) ||
      a.n_win < 0 || (a.n_win > 0 && (a.win_start == nullptr || a.win_end == nullptr ||
                                      a.win_loss == nullptr || a.win_lat == nullptr ||
                                      a.faults_dropped == nullptr ||
                                      a.faults_delayed == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.H > 0)
    event_egress_kernel<<<blocks_for(a.H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
