// The model handlers of the per-event chain, one kernel per model. Plain C
// interface (ctypes); every entry point launches on the stream it is given
// and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K17 shadow_tpu/models/tgen.py:250  TgenTcpModel.handle  (B18), with the
//       flow ledger's FlowDone record lanes (:452, B17) where the ledger is on
//   K18 shadow_tpu/models/phold.py:65  PholdModel.handle, :101 _exp_delay  (B19)
//   K19 shadow_tpu/models/echo.py:104  UdpEchoModel.handle  (B19)
//   K20 shadow_tpu/models/timer.py:41  TimerModel.handle  (B19)
//   K21 shadow_tpu/models/gossip.py:89  GossipModel.handle  (B19)
//   K22 shadow_tpu/models/circuit.py:99  CircuitModel.handle  (B19)
//   K33 shadow_tpu/models/hybrid.py:73  HybridModel.handle  (B25)
//   K34 shadow_tpu/models/mixed.py:83  MixedModel.handle, with translate :135
//       (B25): the plane boundary around K33 and the inner model's kernel
// In the JAX package the handler is traced into `_event_body`
// (shadow_tpu/core/engine.py:2381) and fused with the round; the port runs
// it between K10 (ingress) and K11 (egress), which reads the port fields
// these kernels write.
//
// Each kernel is its model's plain PyTorch `handle_plain`
// (shadow_tpu_torch/models/*.py) written as scalar code for one host, one
// thread per host: it loads the host's lanes into registers, runs the plain
// version's statements in the same order (lanes reassigned several times
// are reassigned in the same sequence), and writes back every state lane in
// place and every port field the plain version computes. Port fields the
// plain version passes through (the event time, parameters, the event
// payload) and constant fields (kinds, zero payloads) are not written here:
// the wrappers hand K11 those tensors themselves.
//
// Exactness: integer lanes wrap as two's complement, as PyTorch's do, so
// every add, subtract, multiply and left shift that can overflow goes
// through unsigned arithmetic (event_math.cuh's helpers and the 32-bit ones
// below); division and modulo round toward minus infinity; a u32 shift by
// 32 is spelled out (0), and so is count-trailing-zeros of 0 (32). PHOLD's
// log is XLA-CPU's algorithm exactly as `log_f32` computes it: every float32
// step with a round-to-nearest intrinsic, every fused multiply-add as a
// float64 multiply and add rounded once to float32 (never fmaf, which would
// round once instead of twice); the source is built with --fmad=false.
//
// What bounds them on an H100: one thread per host, 10-300 integer
// operations and 50-450 bytes per host per event (H = 10,000: 0.2-1.3 us of
// memory traffic at 3.35 TB/s). They are latency-bound single launches;
// what they remove is the plain handlers' 130-500 small PyTorch launches
// per event. Design: no shared memory and no cross-host writes, so results
// do not depend on scheduling.
//
// Layout: [H] lanes per host. The event time and payload may be a column of
// the K-way peek (host stride `es` elements, payload row stride es * P);
// every other lane is contiguous. Argument blocks: the handler context
// first (`Ctx`, in the order of models/base.py `ctx_arg_block`), then the
// model's parameters, state lanes and outputs in the order its wrapper
// builds them.

#include <cstdint>
#include <cuda_runtime.h>

#include "event_math.cuh"

using namespace evm;

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int H) { return (H + kThreads - 1) / kThreads; }

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

__device__ __forceinline__ int wsub32(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int shl32(int a, int k) { return (int)((unsigned)a << k); }
__device__ __forceinline__ int imin32(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax32(int a, int b) { return a > b ? a : b; }
// floor division and floor modulo of int32 values (the int64 result fits)
__device__ __forceinline__ int fdiv32(int a, int b) { return (int)floordiv(a, b); }
__device__ __forceinline__ int fmod32(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// int64 absolute value that wraps at INT64_MIN, as torch.abs does
__device__ __forceinline__ i64 wabs(i64 a) { return a < 0 ? wsub(0, a) : a; }

// The handler context (models/base.py HandlerCtx) as the kernels read it.
struct Ctx {
  int H, P, es;
  const long long* t;      // host stride es
  const int* payload;      // row stride es * P
  const int* kind;         // model kind (engine flags stripped)
  const bool* active;      // the dispatch mask
  const bool* is_pkt;
  const long long* src;
  const long long* host_id;
};

Ctx read_ctx(Reader& r) {
  Ctx c;
  c.H = (int)r.v();
  c.P = (int)r.v();
  c.es = (int)r.v();
  c.t = r.p<const long long>();
  c.payload = r.p<const int>();
  c.kind = r.p<const int>();
  c.active = r.p<const bool>();
  c.is_pkt = r.p<const bool>();
  c.src = r.p<const long long>();
  c.host_id = r.p<const long long>();
  return c;
}

// ---------------------------------------------------------------------------
// K20 timer_handle (models/timer.py handle_plain)
// ---------------------------------------------------------------------------

constexpr int kTimerFire = 0;

struct TimerArgs {
  const long long* interval;
  long long* fires;  // state, in place
  bool* push_mask;
  long long* push_t;
};

__global__ void timer_handle_kernel(const Ctx c, const TimerArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const long long t = c.t[(long long)h * c.es];
  const bool fire = c.active[h] && c.kind[h] == kTimerFire;
  a.push_mask[h] = fire;
  a.push_t[h] = wadd(t, a.interval[h]);
  a.fires[h] = wadd(a.fires[h], fire);
}

// ---------------------------------------------------------------------------
// K19 echo_handle (models/echo.py handle_plain)
// ---------------------------------------------------------------------------

constexpr int kEchoTick = 0, kEchoReq = 1, kEchoResp = 2;
constexpr int kRoleClient = 0, kRoleServer = 1;

struct EchoArgs {
  const int* role;
  const long long* interval;
  // state, in place
  long long* sent;
  long long* rcvd;
  long long* rtt_sum;
  long long* rtt_max;
  // outputs: the tick mask (push and request send), the push time, the
  // request payload [H, P], the response mask
  bool* tick;
  long long* push_t;
  int* req_payload;
  bool* req;
};

__global__ void echo_handle_kernel(const Ctx c, const EchoArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const long long t = c.t[(long long)h * c.es];
  const int* pl = c.payload + (long long)h * c.es * P;
  const bool act = c.active[h];
  const int kind = c.kind[h];
  const int role = a.role[h];
  const bool is_client = role == kRoleClient;
  const bool is_server = role == kRoleServer;

  const bool tick = act && kind == kEchoTick && is_client;
  int* rp = a.req_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) rp[w] = 0;
  rp[1] = (int)(unsigned)((u64)t & 0xFFFFFFFFULL);  // lo word
  rp[2] = (int)(t >> 32);                            // hi word
  a.tick[h] = tick;
  a.push_t[h] = wadd(t, a.interval[h]);

  const bool req = act && kind == kEchoReq && is_server;
  a.req[h] = req;

  const bool resp = act && kind == kEchoResp && is_client;
  const long long t_sent =
      (long long)(((u64)(long long)pl[2] << 32) | ((u64)(long long)pl[1] & 0xFFFFFFFFULL));
  const long long rtt = resp ? wsub(t, t_sent) : 0;

  a.sent[h] = wadd(a.sent[h], tick);
  a.rcvd[h] = wadd(a.rcvd[h], resp || req);
  a.rtt_sum[h] = wadd(a.rtt_sum[h], rtt);
  a.rtt_max[h] = imax(a.rtt_max[h], rtt);
}

// ---------------------------------------------------------------------------
// K18 phold_handle (models/phold.py handle_plain, log_f32, exp_delay)
// ---------------------------------------------------------------------------

constexpr int kPholdJob = 0, kPholdMsg = 1;

// the float32 constants of XLA-CPU's log (each double literal rounded to
// float32 once, as torch.tensor(v, dtype=float32) rounds it)
constexpr float kLogP0 = (float)7.0376836292e-2, kLogP1 = (float)-1.1514610310e-1,
                kLogP2 = (float)1.1676998740e-1, kLogP3 = (float)-1.2420140846e-1,
                kLogP4 = (float)1.4249322787e-1, kLogP5 = (float)-1.6668057665e-1,
                kLogP6 = (float)2.0000714765e-1, kLogP7 = (float)-2.4999993993e-1,
                kLogP8 = (float)3.3333331174e-1;
constexpr float kLogQ1 = (float)-2.12194440e-4;
constexpr float kLogQ2 = (float)0.693359375;
constexpr float kSqrtHf = (float)0.707106781186547524;
constexpr float kLogFloor = (float)1e-7;

// float32(float64(a) * float64(b) + float64(c)): the product is exact in
// float64, the sum rounds once, the narrowing once (phold.py `_fma`)
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// natural log of a positive normal float32, bit-identical to `log_f32`
__device__ __forceinline__ float log_f32(float x) {
  int e_i;
  const float m = frexpf(x, &e_i);  // m in [0.5, 1)
  float e = (float)e_i;
  const bool mask = m < kSqrtHf;
  x = __fadd_rn(__fsub_rn(m, 1.0f), mask ? m : 0.0f);
  e = __fsub_rn(e, mask ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = fma_f32(fma_f32(kLogP0, x, kLogP1), x, kLogP2);
  const float y1 = fma_f32(fma_f32(kLogP3, x, kLogP4), x, kLogP5);
  const float y2 = fma_f32(fma_f32(kLogP6, x, kLogP7), x, kLogP8);
  y = fma_f32(y, x3, y1);
  y = fma_f32(y, x3, y2);
  y = fma_f32(y, x3, __fmul_rn(e, kLogQ1));
  x = __fadd_rn(__fsub_rn(x, __fmul_rn(x2, 0.5f)), y);
  return fma_f32(e, kLogQ2, x);
}

// exponential holding time, floored at 1 us (`exp_delay`)
__device__ __forceinline__ long long exp_delay(float u, long long mean_ns) {
  const float x = -log_f32(fmaxf(__fsub_rn(1.0f, u), kLogFloor));
  const long long d = __float2ll_rz(__fmul_rn(x, __ll2float_rn(mean_ns)));
  return imax(d, 1000);
}

struct PholdArgs {
  const long long* mean_delay;
  const long long* num_hosts;
  long long* handled;        // state, in place
  unsigned long long* rng;   // [H, 4], in place
  // outputs: the hold push (mask, time), the job send (mask, destination)
  bool* arrived;
  long long* push_t;
  bool* job;
  long long* dst;
};

__global__ void phold_handle_kernel(const Ctx c, const PholdArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const long long t = c.t[(long long)h * c.es];
  const bool act = c.active[h];
  const int kind = c.kind[h];
  const bool job = act && kind == kPholdJob;
  const bool arrived = act && kind == kPholdMsg;
  u64 s[4];
  for (int k = 0; k < 4; ++k) s[k] = a.rng[(long long)h * 4 + k];

  const float u_hold = rng_uniform(s, arrived);
  const long long hold = exp_delay(u_hold, a.mean_delay[h]);
  a.arrived[h] = arrived;
  a.push_t[h] = wadd(t, hold);

  const float u_dst = rng_uniform(s, job);
  const long long n = a.num_hosts[h];
  a.job[h] = job;
  a.dst[h] = imin(__float2ll_rz(__fmul_rn(u_dst, __ll2float_rn(n))), wsub(n, 1));

  a.handled[h] = wadd(a.handled[h], act);
  for (int k = 0; k < 4; ++k) a.rng[(long long)h * 4 + k] = s[k];
}

// the test entry point: exp_delay over a flat array (mean host stride ms)
__global__ void phold_exp_delay_kernel(long long n, const float* u, const long long* mean,
                                       long long ms, long long* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = exp_delay(u[i], mean[i * ms]);
}

// ---------------------------------------------------------------------------
// K21 gossip_handle (models/gossip.py handle_plain)
// ---------------------------------------------------------------------------

constexpr int kGossipMsg = 0, kGossipFwd = 1, kGossipPub = 2;

struct GossipArgs {
  int K;                       // neighbor table width (max fanout)
  const long long* neighbors;  // [H, K]
  const int* fanout;
  const long long* interval;
  // state, in place
  int* gen;
  long long* recv_time;
  int* hops;
  int* fwd_idx;
  long long* adopted;
  // outputs: the start-forward push (mask, payload [H, P]), the publish
  // push (mask, time), the send (mask, destination), the continuation mask
  bool* fresh;
  int* start_payload;
  bool* repub;
  long long* pub_t;
  bool* more;
  long long* dst;
  bool* cont;
};

__global__ void gossip_handle_kernel(const Ctx c, const GossipArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const long long t = c.t[(long long)h * c.es];
  const int* pl = c.payload + (long long)h * c.es * P;
  const bool act = c.active[h];
  const int kind = c.kind[h];
  const int gen = a.gen[h];
  const bool pub = act && kind == kGossipPub;
  const bool msg = act && kind == kGossipMsg;
  // a publish starts generation gen + 1; a message carries its own
  const int msg_gen = pub ? wadd32(gen, 1) : pl[2];
  const bool fresh = (pub || msg) && msg_gen > gen;
  const int hop = pub ? 0 : wadd32(pl[1], 1);
  const int gen_n = fresh ? msg_gen : gen;
  a.gen[h] = gen_n;
  if (fresh) {
    a.recv_time[h] = t;
    a.hops[h] = hop;
  }
  const int idx = fresh ? 0 : a.fwd_idx[h];
  a.adopted[h] = wadd(a.adopted[h], fresh);
  a.fresh[h] = fresh;
  int* sp = a.start_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) sp[w] = 0;
  sp[1] = hop;
  sp[2] = msg_gen;
  const long long interval = a.interval[h];
  a.repub[h] = pub && interval > 0;
  a.pub_t[h] = wadd(t, interval);
  // the continuation walks the neighbor row; one of a superseded
  // generation (tested against the UPDATED generation) drops
  const bool fwd = act && kind == kGossipFwd && pl[2] == gen_n;
  const int fanout = a.fanout[h];
  const bool more = fwd && idx < fanout;
  a.more[h] = more;
  a.dst[h] = a.neighbors[(long long)h * a.K + imin32(imax32(idx, 0), a.K - 1)];
  const int idx1 = wadd32(idx, 1);
  a.fwd_idx[h] = more ? idx1 : idx;
  a.cont[h] = more && idx1 < fanout;
}

// ---------------------------------------------------------------------------
// K22 circuit_handle (models/circuit.py handle_plain)
// ---------------------------------------------------------------------------

constexpr int kCircTick = 0, kCircCell = 1, kCircFwd = 2;
constexpr int kCircClient = 1;
constexpr int kPwGm = 1, kPwEc = 2, kPwHd = 3;

struct CircuitArgs {
  const int* route;  // [H, 3]: guard, middle, exit
  const int* role;
  const long long* interval;
  const long long* proc;
  // state, in place
  bool* outstanding;
  long long* launch_t;
  long long* cells_done;
  long long* rtt_sum;
  long long* fwd;
  // outputs: the launch send (mask, guard, payload [H, P]), the tick push
  // (mask, time), the relay's continuation (mask, time), the forward send
  // (mask, next hop, payload [H, P])
  bool* launch;
  long long* guard;
  int* launch_payload;
  bool* tick;
  long long* tick_t;
  bool* relay;
  long long* proc_t;
  bool* fwd_mask;
  long long* nxt;
  int* fwd_payload;
};

__global__ void circuit_handle_kernel(const Ctx c, const CircuitArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const long long t = c.t[(long long)h * c.es];
  const int* pl = c.payload + (long long)h * c.es * P;
  const bool act = c.active[h];
  const bool pkt = c.is_pkt[h];
  const int kind = c.kind[h];
  const bool is_client = a.role[h] == kCircClient;
  const bool tick = act && !pkt && kind == kCircTick;
  const bool cell_in = act && pkt && kind == kCircCell;
  const bool fwd = act && !pkt && kind == kCircFwd;
  const bool cell_back = cell_in && is_client;

  // client tick: launch when idle; the route packs as 16-bit ids, shifted
  // on a u32 (ids of 32,768 and above reach the sign bit)
  const bool out0 = a.outstanding[h];
  const bool launch = tick && !out0;
  const int* rt = a.route + (long long)h * 3;
  a.launch[h] = launch;
  a.guard[h] = rt[0];
  int* lp = a.launch_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) lp[w] = 0;
  lp[kPwGm] = (int)((unsigned)rt[0] | ((unsigned)rt[1] << 16));
  lp[kPwEc] = (int)((unsigned)rt[2] | ((unsigned)(int)c.host_id[h] << 16));
  a.tick[h] = tick;
  a.tick_t[h] = wadd(t, a.interval[h]);
  a.relay[h] = cell_in && !is_client;
  a.proc_t[h] = wadd(t, a.proc[h]);

  // forward continuation: the next hop from the packed route
  const unsigned gmw = (unsigned)pl[kPwGm], ecw = (unsigned)pl[kPwEc];
  const long long g = gmw & 0xFFFF, m = (gmw >> 16) & 0xFFFF;
  const long long e = ecw & 0xFFFF, cl = (ecw >> 16) & 0xFFFF;
  const int hop = pl[kPwHd] & 0xFF;
  const int dn = (pl[kPwHd] >> 8) & 1;
  const bool at_exit = dn == 0 && hop == 2;
  a.fwd_mask[h] = fwd;
  a.nxt[h] = dn == 0 ? (hop == 0 ? m : (hop == 1 ? e : m)) : (hop == 1 ? g : cl);
  const int nxt_hop = dn == 0 ? (hop == 0 ? 1 : (hop == 1 ? 2 : 1)) : 0;
  const int nxt_dir = at_exit ? 1 : dn;
  int* fp = a.fwd_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) fp[w] = pl[w];
  fp[kPwHd] = nxt_hop | (nxt_dir << 8);

  const long long rtt = wsub(t, a.launch_t[h]);
  a.outstanding[h] = launch ? true : (cell_back ? false : out0);
  if (launch) a.launch_t[h] = t;
  a.cells_done[h] = wadd(a.cells_done[h], cell_back);
  a.rtt_sum[h] = wadd(a.rtt_sum[h], cell_back ? rtt : 0);
  a.fwd[h] = wadd(a.fwd[h], fwd);
}

// ---------------------------------------------------------------------------
// K17 tgen_handle (models/tgen.py handle_plain)
// ---------------------------------------------------------------------------

constexpr int kTgTick = 0, kTgSeg = 1, kTgTx = 2, kTgRto = 3, kTgDelack = 4;
constexpr int kFtSyn = 1, kFtSynack = 2, kFtData = 3, kFtAck = 4, kFtFin = 5, kFtFinack = 6;
constexpr int kPwSeq = 1, kPwAck = 2, kPwMeta = 3;
constexpr int kCstIdle = 0, kCstSyn = 1, kCstEst = 2, kCstFin = 3, kCstDone = 4;
constexpr int kHdrBytes = 40;
constexpr int kCwndOne = 1 << 10;

struct TgenArgs {
  int txb;  // tx_batch: the send port's burst width
  // params [H]
  const int* flow_segs;
  const int* mss;
  const int* flows;
  const int* cwnd_init;
  const int* cwnd_cap;
  const long long* rto_init;
  const long long* rto_min;
  const long long* rto_max;
  const long long* flow_gap;
  const long long* delack;
  const int* num_hosts;
  // state [H], in place: the client lane
  int* c_state;
  int* c_phase;
  int* c_peer;
  int* snd_una;
  int* snd_nxt;
  int* cwnd_x;
  int* ssth_x;
  int* dup;
  int* recover;
  long long* srtt;
  long long* rttvar;
  long long* rto;
  int* rtt_seq;
  long long* rtt_t0;
  long long* deadline;
  bool* timer_alive;
  bool* tx_alive;
  long long* flow_t0;
  // the server lane
  int* sv_state;
  int* sv_peer;
  int* sv_phase;
  int* rcv_nxt;
  long long* sv_bm;  // uint32 bitmap carried as int64
  bool* da_pend;
  long long* da_t;
  bool* da_alive;
  // counters
  long long* d_sent;
  long long* d_rtx;
  long long* fast_rtx;
  long long* timeouts;
  long long* flows_done;
  long long* flow_rtx0;
  long long* fct_sum;
  long long* segs_rcvd;
  long long* dup_segs;
  long long* bytes_rcvd;
  long long* done_t;
  // outputs: push port A (mask; t is the event time, kind KIND_TX), push
  // port B (mask, t, kind), the send port (mask, dst, size, payload [H, P],
  // count; kind KIND_SEG and the payload increment are constants)
  bool* pa_mask;
  bool* pb_mask;
  long long* pb_t;
  int* pb_kind;
  bool* s_mask;
  long long* s_dst;
  int* s_size;
  int* s_payload;
  int* s_count;
  // the flow-ledger record lanes (null unless the ledger is on): the
  // completion mask, peer, flow (phase), start and end times, payload
  // bytes and retransmits of a flow completed at this event (FIN-ACK)
  bool* f_mask;
  long long* f_dst;
  long long* f_flow;
  long long* f_t0;
  long long* f_t1;
  long long* f_bytes;
  long long* f_rtx;
};

__global__ void tgen_handle_kernel(const Ctx c, const TgenArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const long long t = c.t[(long long)h * c.es];
  const int* pl = c.payload + (long long)h * c.es * P;
  const bool act = c.active[h];
  const bool pkt = c.is_pkt[h];
  const int kind = c.kind[h];

  // the host's lanes, in registers
  int c_state = a.c_state[h], c_phase = a.c_phase[h], c_peer = a.c_peer[h];
  int snd_una = a.snd_una[h], snd_nxt = a.snd_nxt[h], cwnd_x = a.cwnd_x[h];
  int ssth_x = a.ssth_x[h], dup = a.dup[h], recover = a.recover[h];
  long long srtt = a.srtt[h], rttvar = a.rttvar[h], rto = a.rto[h];
  int rtt_seq = a.rtt_seq[h];
  long long rtt_t0 = a.rtt_t0[h], deadline = a.deadline[h];
  bool timer_alive = a.timer_alive[h], tx_alive = a.tx_alive[h];
  long long flow_t0 = a.flow_t0[h];
  int sv_state = a.sv_state[h], sv_peer = a.sv_peer[h], sv_phase = a.sv_phase[h];
  int rcv_nxt = a.rcv_nxt[h];
  unsigned sv_bm = (unsigned)a.sv_bm[h];
  bool da_pend = a.da_pend[h];
  long long da_t = a.da_t[h];
  bool da_alive = a.da_alive[h];
  long long d_sent = a.d_sent[h], d_rtx = a.d_rtx[h], fast_rtx = a.fast_rtx[h];
  long long timeouts = a.timeouts[h], flows_done = a.flows_done[h];
  long long flow_rtx0 = a.flow_rtx0[h], fct_sum = a.fct_sum[h];
  long long segs_rcvd = a.segs_rcvd[h], dup_segs = a.dup_segs[h];
  long long bytes_rcvd = a.bytes_rcvd[h], done_t = a.done_t[h];
  const int L = a.flow_segs[h];

  const bool tick = act && !pkt && kind == kTgTick;
  const bool seg = act && pkt && kind == kTgSeg;
  const bool tx = act && !pkt && kind == kTgTx;
  const bool rto_ev = act && !pkt && kind == kTgRto;
  const bool da_ev = act && !pkt && kind == kTgDelack;

  const int meta = pl[kPwMeta];
  const int ftype = meta & 0xFF;
  const int ph = meta >> 8;
  const int w_seq = pl[kPwSeq];
  const int w_ack = pl[kPwAck];
  const int src = (int)c.src[h];
  const int my_phase = c_phase;

  // ================= server lane (pure reaction to arrivals) ======
  const bool syn_in = seg && ftype == kFtSyn;
  const bool data_in = seg && ftype == kFtData;
  const bool fin_in = seg && ftype == kFtFin;

  const bool listen = sv_state == 0;
  const bool same_conn = sv_peer == src && sv_phase == ph;
  const bool new_conn = syn_in && listen;
  const bool dup_syn = syn_in && !listen && same_conn;
  const bool synack_out = new_conn || dup_syn;

  const bool data_ok = data_in && sv_state == 1 && same_conn;
  const int rel = wsub32(w_seq, rcv_nxt);
  const bool inorder = data_ok && rel == 0;
  const bool ooo = data_ok && rel > 0 && rel <= 32;
  const bool dup_seg = data_ok && (rel < 0 || rel > 32);
  const unsigned bm = sv_bm;
  const unsigned bit = 1u << imin32(imax32(wsub32(rel, 1), 0), 31);
  const unsigned bm_set = ooo ? (bm | bit) : bm;
  const unsigned holes = ~bm_set;
  const int run = holes == 0 ? 32 : __ffs((int)holes) - 1;  // ctz, 32 for 0
  const int adv = inorder ? 1 + run : 0;
  const int rcv_nxt2 = wadd32(rcv_nxt, adv);
  const int shift = imin32(imax32(adv, 0), 32);
  const unsigned bm2 = inorder ? (shift >= 32 ? 0u : bm_set >> shift) : bm_set;
  const bool fin_acc = fin_in && sv_state == 1 && same_conn && rcv_nxt == w_seq;
  const bool fin_stateless = fin_in && listen;
  const bool finack_out = fin_acc || fin_stateless;

  // ---- delayed ACK
  const long long delack = a.delack[h];
  const bool da_dis = delack == 0;
  const bool filling = bm != 0;
  const bool ack_2nd = inorder && (da_pend || da_dis || filling);
  const bool hold = inorder && !da_pend && !da_dis && !filling;
  const bool ack_imm = ooo || dup_seg;
  const bool da_fire = da_ev && da_pend && t >= da_t;
  const bool da_repush = da_ev && da_pend && t < da_t;
  const bool ack_out = ack_2nd || ack_imm || da_fire;
  const long long da_t_new = hold ? wadd(t, delack) : da_t;
  const bool da_arm = hold && !da_alive;
  da_pend = hold ? true : ((ack_out || fin_acc || new_conn) ? false : da_pend);
  da_t = da_t_new;
  da_alive = da_ev ? da_repush : (da_arm ? true : da_alive);

  sv_state = new_conn ? 1 : (fin_acc ? 0 : sv_state);
  sv_peer = new_conn ? src : sv_peer;
  sv_phase = new_conn ? ph : sv_phase;
  rcv_nxt = new_conn ? 0 : (fin_acc ? 0 : rcv_nxt2);
  sv_bm = (new_conn || fin_acc) ? 0u : bm2;
  segs_rcvd = wadd(segs_rcvd, (long long)inorder + (long long)ooo);
  dup_segs = wadd(dup_segs, dup_seg);
  const int wire_sz = pl[0];
  bytes_rcvd = wadd(bytes_rcvd, (inorder || ooo) ? (long long)wsub32(wire_sz, kHdrBytes) : 0);

  // ================= client lane ==================================
  const bool for_me = seg && src == c_peer && ph == my_phase;
  const bool synack_in = for_me && ftype == kFtSynack && c_state == kCstSyn;
  const bool ack_in = for_me && ftype == kFtAck && c_state == kCstEst;
  const bool finack_in = for_me && ftype == kFtFinack && c_state == kCstFin;

  c_state = synack_in ? kCstEst : c_state;

  // ---- ACK processing (Reno + NewReno recovery)
  const int ack = w_ack;
  const int una0 = snd_una;
  const bool new_acked = ack_in && ack > una0;
  const bool dup_ack = ack_in && ack == una0 && snd_nxt > una0;

  const bool samp = new_acked && rtt_seq >= 0 && ack > rtt_seq;
  const long long r = wsub(t, rtt_t0);
  const bool first = samp && srtt == 0;
  const bool later = samp && srtt != 0;
  const long long rttvar1 =
      first ? floordiv(r, 2)
            : (later ? floordiv(wadd(wmul(3, rttvar), wabs(wsub(srtt, r))), 4) : rttvar);
  const long long srtt1 = first ? r : (later ? floordiv(wadd(wmul(7, srtt), r), 8) : srtt);
  const long long rto1 =
      samp ? imin(imax(wadd(srtt1, imax(wmul(4, rttvar1), 1000000)), a.rto_min[h]), a.rto_max[h])
           : rto;
  srtt = srtt1;
  rttvar = rttvar1;
  rto = rto1;
  rtt_seq = samp ? -1 : rtt_seq;

  const bool in_rec = recover >= 0;
  const bool exit_rec = new_acked && in_rec && ack >= recover;
  const bool partial = new_acked && in_rec && ack < recover;

  const bool grow = new_acked && !in_rec;
  const int acked_segs = grow ? wsub32(ack, una0) : 0;
  const bool ss = cwnd_x < ssth_x;
  const int ca_inc = fdiv32(1 << 20, imax32(cwnd_x, 1));
  int cwnd1 = grow ? (ss ? wadd32(cwnd_x, shl32(acked_segs, 10)) : wadd32(cwnd_x, ca_inc))
                   : cwnd_x;
  const int dup1 = new_acked ? 0 : (dup_ack ? wadd32(dup, 1) : dup);
  const bool fast = dup_ack && dup1 == 3 && !in_rec;
  const int inflight = wsub32(snd_nxt, una0);
  const int ssth_fast = imax32(fdiv32(shl32(inflight, 10), 2), 2 << 10);
  cwnd1 = fast ? wadd32(ssth_fast, 3 << 10)
               : ((dup_ack && in_rec) ? wadd32(cwnd1, kCwndOne) : cwnd1);
  ssth_x = fast ? ssth_fast : ssth_x;
  recover = fast ? snd_nxt : (exit_rec ? -1 : recover);
  cwnd1 = exit_rec ? ssth_x : cwnd1;
  const int cwnd_cap_x = shl32(a.cwnd_cap[h], 10);
  cwnd_x = imin32(imax32(cwnd1, kCwndOne), cwnd_cap_x);
  dup = dup1;
  snd_una = new_acked ? ack : una0;
  rtt_seq = (fast || partial) ? -1 : rtt_seq;

  const bool all_acked = new_acked && snd_una >= L && c_state == kCstEst;
  c_state = all_acked ? kCstFin : c_state;

  // ---- FIN-ACK: flow complete; next phase or done. The flow ledger's
  // record is taken here, before the phase and flow_t0 lanes advance
  if (a.f_mask != nullptr) {
    a.f_mask[h] = finack_in;
    a.f_dst[h] = (long long)c_peer;
    a.f_flow[h] = (long long)my_phase;
    a.f_t0[h] = flow_t0;
    a.f_t1[h] = t;
    a.f_bytes[h] = (long long)L * (long long)a.mss[h];
    a.f_rtx[h] = wsub(d_rtx, flow_rtx0);
  }
  const int phase1 = finack_in ? wadd32(my_phase, 1) : my_phase;
  const bool more = finack_in && phase1 < a.flows[h];
  c_phase = phase1;
  c_state = finack_in ? (more ? kCstIdle : kCstDone) : c_state;
  flows_done = wadd(flows_done, finack_in);
  fct_sum = wadd(fct_sum, finack_in ? wsub(t, flow_t0) : 0);
  done_t = (finack_in && !more) ? t : done_t;

  // ---- TICK: start the next flow (SYN out)
  const bool start = tick && c_state == kCstIdle && my_phase < a.flows[h];
  const int nh = a.num_hosts[h];
  const int hid = (int)c.host_id[h];
  const int peer = fmod32(wadd32(wadd32(hid, 1), fmod32(my_phase, wsub32(nh, 1))), nh);
  c_peer = start ? peer : c_peer;
  c_state = start ? kCstSyn : c_state;
  snd_una = start ? 0 : snd_una;
  snd_nxt = start ? 0 : snd_nxt;
  cwnd_x = start ? shl32(a.cwnd_init[h], 10) : cwnd_x;
  ssth_x = start ? 0x7FFFFFFF : ssth_x;
  dup = start ? 0 : dup;
  recover = start ? -1 : recover;
  srtt = start ? 0 : srtt;
  rttvar = start ? 0 : rttvar;
  rto = start ? a.rto_init[h] : rto;
  rtt_seq = start ? -1 : rtt_seq;
  flow_t0 = start ? t : flow_t0;
  flow_rtx0 = start ? d_rtx : flow_rtx0;

  // ---- TX continuation: up to tx_batch DATA segments per microstep
  const int cwnd_segs = cwnd_x >> 10;
  const int lim_seq = imin32(wadd32(snd_una, cwnd_segs), L);
  const int n_can =
      (tx && c_state == kCstEst) ? imin32(imax32(wsub32(lim_seq, snd_nxt), 0), a.txb) : 0;
  const bool can_tx = n_can > 0;
  const int tx_seq = snd_nxt;
  snd_nxt = wadd32(snd_nxt, n_can);
  d_sent = wadd(d_sent, n_can);
  const bool time_it = can_tx && rtt_seq < 0;
  rtt_seq = time_it ? tx_seq : rtt_seq;
  rtt_t0 = time_it ? t : rtt_t0;
  const bool chain_more = can_tx && snd_nxt < lim_seq;

  // ---- RTO timer lane (single lazy timer event per host)
  const bool armed = deadline != kTimeMax;
  const bool expired = rto_ev && armed && t >= deadline;
  const bool resched = rto_ev && armed && t < deadline;
  const bool timer_dies = rto_ev && !armed;
  timer_alive = timer_dies ? false : timer_alive;

  const bool syn_to = expired && c_state == kCstSyn;
  const bool est_to = expired && c_state == kCstEst && snd_nxt > snd_una;
  const bool fin_to = expired && c_state == kCstFin;
  const bool timeout = syn_to || est_to || fin_to;
  timeouts = wadd(timeouts, timeout);
  ssth_x = est_to ? imax32(fdiv32(shl32(wsub32(snd_nxt, snd_una), 10), 2), 2 << 10) : ssth_x;
  cwnd_x = est_to ? kCwndOne : cwnd_x;
  snd_nxt = est_to ? wadd32(snd_una, 1) : snd_nxt;
  dup = est_to ? 0 : dup;
  recover = est_to ? -1 : recover;
  rtt_seq = est_to ? -1 : rtt_seq;
  rto = timeout ? imin(wmul(rto, 2), a.rto_max[h]) : rto;

  // ---- deadline maintenance
  const bool idleish = c_state == kCstIdle || c_state == kCstDone;
  const bool quiet = ack_in && !idleish && snd_nxt == snd_una && c_state == kCstEst;
  const bool rearm = start || synack_in || new_acked || all_acked || can_tx || timeout;
  deadline = (finack_in || quiet || timer_dies) ? kTimeMax : (rearm ? wadd(t, rto) : deadline);

  // ================= emissions ====================================
  // push port A: the TX chain
  const bool can_send_more =
      c_state == kCstEst && snd_nxt < wadd32(snd_una, cwnd_x >> 10) && snd_nxt < L;
  const bool restart = (synack_in || new_acked || dup_ack) && can_send_more && !tx_alive;
  const bool push_tx = chain_more || restart;
  tx_alive = tx ? chain_more : (restart ? true : tx_alive);
  a.pa_mask[h] = push_tx;

  // push port B: timer chain + next-flow tick + delack timer (mutually
  // exclusive per host)
  const bool arm_timer = (tick || seg || tx || rto_ev) && deadline != kTimeMax && !timer_alive;
  timer_alive = arm_timer ? true : timer_alive;
  const bool timer_push = arm_timer || resched || expired;
  const long long timer_t = arm_timer ? deadline : (expired ? wadd(t, rto) : deadline);
  const bool next_tick = finack_in && more;
  const bool da_push = da_arm || da_repush;
  a.pb_mask[h] = timer_push || next_tick || da_push;
  a.pb_t[h] = next_tick ? wadd(t, a.flow_gap[h]) : (da_push ? da_t : timer_t);
  a.pb_kind[h] = next_tick ? kTgTick : (da_push ? kTgDelack : kTgRto);

  // send port: at most one wire segment (or one TX burst) per host
  const bool rtx_data = fast || partial || est_to;
  const int rtx_seq = (fast || est_to) ? snd_una : ack;
  d_rtx = wadd(d_rtx, rtx_data);
  fast_rtx = wadd(fast_rtx, fast);
  const bool send_syn = start || syn_to;
  const bool send_fin = all_acked || fin_to;
  const bool send_data = can_tx || rtx_data;

  a.s_mask[h] = send_syn || send_fin || send_data || synack_out || ack_out || finack_out;
  a.s_dst[h] = (long long)(ack_out ? sv_peer : ((synack_out || finack_out) ? src : c_peer));
  const int ft = send_syn ? kFtSyn
                 : send_fin ? kFtFin
                 : send_data ? kFtData
                 : synack_out ? kFtSynack
                 : ack_out ? kFtAck
                           : kFtFinack;
  const int out_phase = ack_out ? sv_phase : ((synack_out || finack_out) ? ph : my_phase);
  const int seq_word =
      send_data ? (rtx_data ? rtx_seq : tx_seq)
                : (send_fin ? L : (ack_out ? (int)sv_bm : 0));
  const int ack_word = ack_out ? rcv_nxt : 0;
  int* sp = a.s_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) sp[w] = 0;
  sp[kPwSeq] = seq_word;
  sp[kPwAck] = ack_word;
  sp[kPwMeta] = ft | shl32(out_phase, 8);
  a.s_size[h] = send_data ? wadd32(a.mss[h], kHdrBytes) : kHdrBytes;
  a.s_count[h] = can_tx ? n_can : 1;

  // the state, back in place
  a.c_state[h] = c_state;
  a.c_phase[h] = c_phase;
  a.c_peer[h] = c_peer;
  a.snd_una[h] = snd_una;
  a.snd_nxt[h] = snd_nxt;
  a.cwnd_x[h] = cwnd_x;
  a.ssth_x[h] = ssth_x;
  a.dup[h] = dup;
  a.recover[h] = recover;
  a.srtt[h] = srtt;
  a.rttvar[h] = rttvar;
  a.rto[h] = rto;
  a.rtt_seq[h] = rtt_seq;
  a.rtt_t0[h] = rtt_t0;
  a.deadline[h] = deadline;
  a.timer_alive[h] = timer_alive;
  a.tx_alive[h] = tx_alive;
  a.flow_t0[h] = flow_t0;
  a.sv_state[h] = sv_state;
  a.sv_peer[h] = sv_peer;
  a.sv_phase[h] = sv_phase;
  a.rcv_nxt[h] = rcv_nxt;
  a.sv_bm[h] = (long long)sv_bm;  // zero-extended
  a.da_pend[h] = da_pend;
  a.da_t[h] = da_t;
  a.da_alive[h] = da_alive;
  a.d_sent[h] = d_sent;
  a.d_rtx[h] = d_rtx;
  a.fast_rtx[h] = fast_rtx;
  a.timeouts[h] = timeouts;
  a.flows_done[h] = flows_done;
  a.flow_rtx0[h] = flow_rtx0;
  a.fct_sum[h] = fct_sum;
  a.segs_rcvd[h] = segs_rcvd;
  a.dup_segs[h] = dup_segs;
  a.bytes_rcvd[h] = bytes_rcvd;
  a.done_t[h] = done_t;
}


// ---------------------------------------------------------------------------
// K33 hybrid_handle (models/hybrid.py handle_plain): the co-simulation
// bridge's device lane of a CPU-plane host
// ---------------------------------------------------------------------------

constexpr int kHybSendReq = 1, kHybData = 2;
constexpr int kPwSize = 0, kPwDst = 1, kPwKey = 2, kPwFlags = 3;

struct HybridArgs {
  int C;  // capture ring slots per host
  // the capture rings [H, C] and their counters [H], in place
  long long* cap_t;
  long long* cap_src;
  int* cap_key;
  int* cap_size;
  int* cap_flags;
  int* cap_n;
  long long* cap_lost;
  // the send port: mask, destination, size and the payload [H, P]
  // (contiguous: the event's words, copied, so that the port does not
  // alias a column of the K-way peek)
  bool* s_mask;
  long long* s_dst;
  int* s_size;
  int* s_payload;
};

// A delivery (an active KIND_DATA packet) takes ring slot cap_n if one is
// free, else counts into cap_lost; a send request (an active local
// KIND_SENDREQ) becomes a KIND_DATA send to payload word 1 of payload word
// 0 bytes, its payload passed through. Ring slots past cap_n are not
// touched.
__global__ void hybrid_handle_kernel(const Ctx c, const HybridArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const int* pl = c.payload + (long long)h * c.es * P;
  const bool act = c.active[h];
  const bool pkt = c.is_pkt[h];
  const int kind = c.kind[h];
  const bool is_send = act && !pkt && kind == kHybSendReq;
  const bool is_data = act && pkt && kind == kHybData;
  const int n = a.cap_n[h];
  const bool slot_ok = is_data && n < a.C;
  if (slot_ok) {
    const long long i = (long long)h * a.C + n;
    a.cap_t[i] = c.t[(long long)h * c.es];
    a.cap_src[i] = c.src[h];
    a.cap_key[i] = pl[kPwKey];
    a.cap_size[i] = pl[kPwSize];
    a.cap_flags[i] = pl[kPwFlags];
  }
  a.cap_n[h] = n + (slot_ok ? 1 : 0);
  a.cap_lost[h] = wadd(a.cap_lost[h], (is_data && !slot_ok) ? 1 : 0);
  a.s_mask[h] = is_send;
  a.s_dst[h] = (long long)pl[kPwDst];
  a.s_size[h] = pl[kPwSize];
  int* sp = a.s_payload + (long long)h * P;
  for (int w = 0; w < P; ++w) sp[w] = pl[w];
}

// ---------------------------------------------------------------------------
// K34 mixed_plane (models/mixed.py mixed_in_plain / mixed_out_plain): the
// plane boundary of a mixed co-simulation, by the replicated
// global_is_native table of N hosts
// ---------------------------------------------------------------------------

constexpr int kKindMask = 0xFFFF;
constexpr int kMaxMixedPorts = 8;

__device__ __forceinline__ long long clamp_id(long long x, int n) {
  return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

struct MixedInArgs {
  int N;
  const bool* native;
  int wire_kind;  // the inner model's wire kind, -1 for none
  int sanitize;   // keep only payload word 0 of a packet from a native source
  bool* hyb_active;
  bool* in_active;
  int* in_kind;
  int* in_payload;  // row stride es * P, as the event's payload
};

// In mode: the hybrid lanes (active & native) and the inner lanes (active
// & ~native); a packet from a native source arrives under the inner
// model's wire kind, with only word 0 of its payload where it sanitizes.
__global__ void mixed_in_kernel(const Ctx c, const MixedInArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= c.H) return;
  const int P = c.P;
  const long long row = (long long)h * c.es * P;
  const int* pl = c.payload + row;
  int* out = a.in_payload + row;
  const bool native = a.native[clamp_id(c.host_id[h], a.N)];
  const bool act = c.active[h];
  a.hyb_active[h] = act && native;
  a.in_active[h] = act && !native;
  bool from_native = false;
  if (a.wire_kind >= 0) from_native = c.is_pkt[h] && a.native[clamp_id(c.src[h], a.N)];
  a.in_kind[h] = from_native ? a.wire_kind : c.kind[h];
  const bool keep0 = from_native && a.sanitize;
  for (int w = 0; w < P; ++w) out[w] = (keep0 && w > 0) ? 0 : pl[w];
}

struct MixedPort {
  const bool* mask;
  const long long* dst;
  const int* kind;
  long long mask_s, dst_s, kind_s;  // host strides (0: a broadcast lane)
  int* out_kind;
};

struct MixedOutArgs {
  int H, N, ports;
  const bool* native;
  MixedPort port[kMaxMixedPorts];
};

// Out mode: each inner send port's kind becomes KIND_DATA where its
// destination is native (the capture ring picks it up), else its model
// kind without the engine's flag bits.
__global__ void mixed_out_kernel(const MixedOutArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  for (int j = 0; j < a.ports; ++j) {
    const MixedPort& p = a.port[j];
    const bool to_native =
        p.mask[h * p.mask_s] && a.native[clamp_id(p.dst[h * p.dst_s], a.N)];
    p.out_kind[h] = to_native ? kHybData : (p.kind[h * p.kind_s] & kKindMask);
  }
}

}  // namespace

extern "C" {

int timer_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  TimerArgs a;
  a.interval = r.p<const long long>();
  a.fires = r.p<long long>();
  a.push_mask = r.p<bool>();
  a.push_t = r.p<long long>();
  if (c.H > 0)
    timer_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

int echo_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  EchoArgs a;
  a.role = r.p<const int>();
  a.interval = r.p<const long long>();
  a.sent = r.p<long long>();
  a.rcvd = r.p<long long>();
  a.rtt_sum = r.p<long long>();
  a.rtt_max = r.p<long long>();
  a.tick = r.p<bool>();
  a.push_t = r.p<long long>();
  a.req_payload = r.p<int>();
  a.req = r.p<bool>();
  if (c.P < 3) return (int)cudaErrorInvalidValue;
  if (c.H > 0)
    echo_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

int phold_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  PholdArgs a;
  a.mean_delay = r.p<const long long>();
  a.num_hosts = r.p<const long long>();
  a.handled = r.p<long long>();
  a.rng = r.p<unsigned long long>();
  a.arrived = r.p<bool>();
  a.push_t = r.p<long long>();
  a.job = r.p<bool>();
  a.dst = r.p<long long>();
  if (c.H > 0)
    phold_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

int phold_exp_delay(const long long* args, void* stream) {
  Reader r{args, 0};
  const long long n = r.v();
  const float* u = r.p<const float>();
  const long long* mean = r.p<const long long>();
  const long long ms = r.v();
  long long* out = r.p<long long>();
  if (n > 0)
    phold_exp_delay_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>(n, u, mean, ms, out);
  return (int)cudaGetLastError();
}

int gossip_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  GossipArgs a;
  a.K = (int)r.v();
  a.neighbors = r.p<const long long>();
  a.fanout = r.p<const int>();
  a.interval = r.p<const long long>();
  a.gen = r.p<int>();
  a.recv_time = r.p<long long>();
  a.hops = r.p<int>();
  a.fwd_idx = r.p<int>();
  a.adopted = r.p<long long>();
  a.fresh = r.p<bool>();
  a.start_payload = r.p<int>();
  a.repub = r.p<bool>();
  a.pub_t = r.p<long long>();
  a.more = r.p<bool>();
  a.dst = r.p<long long>();
  a.cont = r.p<bool>();
  if (c.P < 3 || a.K < 1) return (int)cudaErrorInvalidValue;
  if (c.H > 0)
    gossip_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

int circuit_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  CircuitArgs a;
  a.route = r.p<const int>();
  a.role = r.p<const int>();
  a.interval = r.p<const long long>();
  a.proc = r.p<const long long>();
  a.outstanding = r.p<bool>();
  a.launch_t = r.p<long long>();
  a.cells_done = r.p<long long>();
  a.rtt_sum = r.p<long long>();
  a.fwd = r.p<long long>();
  a.launch = r.p<bool>();
  a.guard = r.p<long long>();
  a.launch_payload = r.p<int>();
  a.tick = r.p<bool>();
  a.tick_t = r.p<long long>();
  a.relay = r.p<bool>();
  a.proc_t = r.p<long long>();
  a.fwd_mask = r.p<bool>();
  a.nxt = r.p<long long>();
  a.fwd_payload = r.p<int>();
  if (c.P < 4) return (int)cudaErrorInvalidValue;
  if (c.H > 0)
    circuit_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

int tgen_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  TgenArgs a;
  a.txb = (int)r.v();
  a.flow_segs = r.p<const int>();
  a.mss = r.p<const int>();
  a.flows = r.p<const int>();
  a.cwnd_init = r.p<const int>();
  a.cwnd_cap = r.p<const int>();
  a.rto_init = r.p<const long long>();
  a.rto_min = r.p<const long long>();
  a.rto_max = r.p<const long long>();
  a.flow_gap = r.p<const long long>();
  a.delack = r.p<const long long>();
  a.num_hosts = r.p<const int>();
  a.c_state = r.p<int>();
  a.c_phase = r.p<int>();
  a.c_peer = r.p<int>();
  a.snd_una = r.p<int>();
  a.snd_nxt = r.p<int>();
  a.cwnd_x = r.p<int>();
  a.ssth_x = r.p<int>();
  a.dup = r.p<int>();
  a.recover = r.p<int>();
  a.srtt = r.p<long long>();
  a.rttvar = r.p<long long>();
  a.rto = r.p<long long>();
  a.rtt_seq = r.p<int>();
  a.rtt_t0 = r.p<long long>();
  a.deadline = r.p<long long>();
  a.timer_alive = r.p<bool>();
  a.tx_alive = r.p<bool>();
  a.flow_t0 = r.p<long long>();
  a.sv_state = r.p<int>();
  a.sv_peer = r.p<int>();
  a.sv_phase = r.p<int>();
  a.rcv_nxt = r.p<int>();
  a.sv_bm = r.p<long long>();
  a.da_pend = r.p<bool>();
  a.da_t = r.p<long long>();
  a.da_alive = r.p<bool>();
  a.d_sent = r.p<long long>();
  a.d_rtx = r.p<long long>();
  a.fast_rtx = r.p<long long>();
  a.timeouts = r.p<long long>();
  a.flows_done = r.p<long long>();
  a.flow_rtx0 = r.p<long long>();
  a.fct_sum = r.p<long long>();
  a.segs_rcvd = r.p<long long>();
  a.dup_segs = r.p<long long>();
  a.bytes_rcvd = r.p<long long>();
  a.done_t = r.p<long long>();
  a.pa_mask = r.p<bool>();
  a.pb_mask = r.p<bool>();
  a.pb_t = r.p<long long>();
  a.pb_kind = r.p<int>();
  a.s_mask = r.p<bool>();
  a.s_dst = r.p<long long>();
  a.s_size = r.p<int>();
  a.s_payload = r.p<int>();
  a.s_count = r.p<int>();
  a.f_mask = r.p<bool>();
  a.f_dst = r.p<long long>();
  a.f_flow = r.p<long long>();
  a.f_t0 = r.p<long long>();
  a.f_t1 = r.p<long long>();
  a.f_bytes = r.p<long long>();
  a.f_rtx = r.p<long long>();
  if (c.P < 4 || a.txb < 1) return (int)cudaErrorInvalidValue;
  if (c.H > 0)
    tgen_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

// K33: args = ctx block, C, the five rings, cap_n, cap_lost, then the send
// port's mask, dst, size and payload outputs.
int hybrid_handle(const long long* args, void* stream) {
  Reader r{args, 0};
  const Ctx c = read_ctx(r);
  HybridArgs a;
  a.C = (int)r.v();
  a.cap_t = r.p<long long>();
  a.cap_src = r.p<long long>();
  a.cap_key = r.p<int>();
  a.cap_size = r.p<int>();
  a.cap_flags = r.p<int>();
  a.cap_n = r.p<int>();
  a.cap_lost = r.p<long long>();
  a.s_mask = r.p<bool>();
  a.s_dst = r.p<long long>();
  a.s_size = r.p<int>();
  a.s_payload = r.p<int>();
  if (c.P < 4 || a.C < 1) return (int)cudaErrorInvalidValue;
  if (c.H > 0)
    hybrid_handle_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
  return (int)cudaGetLastError();
}

// K34: args = mode (0 in, 1 out), then
//   in:  ctx block, N, the table, wire kind (-1: none), sanitize, and the
//        hyb_active, in_active, in_kind and in_payload outputs;
//   out: H, N, the table, the port count, and per port its mask, mask
//        stride, dst, dst stride, kind, kind stride and the kind output.
int mixed_plane(const long long* args, void* stream) {
  Reader r{args, 0};
  const int mode = (int)r.v();
  if (mode == 0) {
    const Ctx c = read_ctx(r);
    MixedInArgs a;
    a.N = (int)r.v();
    a.native = r.p<const bool>();
    a.wire_kind = (int)r.v();
    a.sanitize = (int)r.v();
    a.hyb_active = r.p<bool>();
    a.in_active = r.p<bool>();
    a.in_kind = r.p<int>();
    a.in_payload = r.p<int>();
    if (a.N < 1) return (int)cudaErrorInvalidValue;
    if (c.H > 0)
      mixed_in_kernel<<<blocks_for(c.H), kThreads, 0, (cudaStream_t)stream>>>(c, a);
    return (int)cudaGetLastError();
  }
  if (mode != 1) return (int)cudaErrorInvalidValue;
  MixedOutArgs a;
  a.H = (int)r.v();
  a.N = (int)r.v();
  a.native = r.p<const bool>();
  a.ports = (int)r.v();
  if (a.N < 1 || a.ports < 0 || a.ports > kMaxMixedPorts) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a.ports; ++j) {
    MixedPort& p = a.port[j];
    p.mask = r.p<const bool>();
    p.mask_s = r.v();
    p.dst = r.p<const long long>();
    p.dst_s = r.v();
    p.kind = r.p<const int>();
    p.kind_s = r.v();
    p.out_kind = r.p<int>();
  }
  if (a.H > 0 && a.ports > 0)
    mixed_out_kernel<<<blocks_for(a.H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
