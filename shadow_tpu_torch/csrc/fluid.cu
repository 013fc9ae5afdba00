// Fluid traffic plane kernels (B11). Plain C interface (ctypes); every
// entry point launches on the stream it is given and returns
// cudaGetLastError().
//
// Replaces (JAX reference):
//   K14 shadow_tpu/core/engine.py:2202 _fluid_fg_link_bytes: this round's
//       foreground bytes per link, folded from the pre-exchange outbox
//   K15 shadow_tpu/net/fluid.py:222 fluid_advance (with :208 _bg_link_load):
//       one forward-Euler step of the per-class rate ODE, the DropTail share
//       per link, the carried and dropped bytes
//   K16 shadow_tpu/net/fluid.py:270 fluid_host_effects: per-host extra loss
//       (f32) and latency multiplier (x1000, i64) from link utilization
// (the fourth device program of B11, fluid.py:302 fluid_send_uniform, is the
// counter draw inside K11: csrc/event_math.cuh fluid_uniform).
//
// Exactness: the f64 results equal XLA-CPU's bit for bit, so the arithmetic
// is written out with round-to-nearest intrinsics (the source is built with
// --fmad=false as well): the fused multiply-adds XLA-CPU contracts
// (`rates + alpha * (demand - rates)`, `rates - rates * g`, the carried sum of
// K <= 32 classes) are __fma_rn, every other step is a separately rounded
// __dadd_rn/__dsub_rn/__dmul_rn/__ddiv_rn. Sums over the K classes follow
// XLA-CPU's order: a left fold for K <= 32; for 33 <= K <= 64 a left fold over
// each half [0, ceil(K/2)) and [ceil(K/2), K), then their sum (the wrapper
// refuses K in 28..32 and K > 64, see shadow_tpu_torch/net/fluid.py).
//
// What bounds them on an H100: K14 reads the [H, B] outbox's time plane and,
// for valid rows, their destination and size word (H = 10,000, B = 24: about
// 2 MB, well under a microsecond at 3.35 TB/s); its adds all land on N <= a
// few hundred counters, so a block folds its rows into shared-memory
// counters and adds those to the [N] result once (integer atomics: exact in
// any order). K15 is K classes and N links (config 12: 4 and 100): a few
// thousand operations, one block, latency-bound; K x N link loads are
// recomputed where needed rather than held in shared memory, so any N fits.
// K16 is one thread per host, each reading the utilization of its link and
// the K classes' rates: latency-bound at H = 10,000.
//
// Argument blocks: each kernel takes its pointers and scalars as one int64
// array read in a fixed order; the Python wrappers (net/fluid.py) build it in
// the same order. Doubles travel as their bit patterns.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "event_math.cuh"

using namespace evm;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 64;
constexpr int kSharedLinks = 4096;  // K14 folds into shared counters up to this N

struct Reader {
  const long long* a;
  int i;
  long long v() { return a[i++]; }
  double d() {
    long long x = a[i++];
    double y;
    memcpy(&y, &x, sizeof(y));
    return y;
  }
  template <typename T>
  T* p() {
    return reinterpret_cast<T*>(a[i++]);
  }
};

// ---------------------------------------------------------------------------
// K14 fluid_fg_link_bytes
// ---------------------------------------------------------------------------

struct FgArgs {
  int H, B, P, N, hosts_per_node;
  const int* ob_dst;
  const long long* ob_t;
  const int* ob_payload;
  const int* node_of;       // [n_hosts], by global host id
  unsigned long long* out;  // [N], zeroed before the launch
  // the mesh: this shard's first global host id and the global host count
  long long host_base, n_hosts;
};

__device__ __forceinline__ long long host_node(const int* node_of, int g, long long h) {
  return g > 0 ? h / g : (long long)node_of[h];  // h >= 0: division is floor
}

__global__ void fg_link_bytes_kernel(const FgArgs a) {
  extern __shared__ unsigned long long local[];
  const bool shared = a.N <= kSharedLinks;
  if (shared)
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) local[n] = 0;
  __syncthreads();
  const long long rows = (long long)a.H * a.B;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows && a.ob_t[i] != kTimeMax) {
    const unsigned long long size = (unsigned long long)(long long)a.ob_payload[i * a.P + kSizeWord];
    const long long h = a.host_base + i / a.B;
    const long long src = imin(imax(host_node(a.node_of, a.hosts_per_node, h), 0), a.N - 1);
    const long long d = imin(imax((long long)a.ob_dst[i], 0), a.n_hosts - 1);
    const long long dst = imin(imax(host_node(a.node_of, a.hosts_per_node, d), 0), a.N - 1);
    unsigned long long* acc = shared ? local : a.out;
    atomicAdd(acc + src, size);
    atomicAdd(acc + dst, size);
  }
  if (!shared) return;
  __syncthreads();
  for (int n = threadIdx.x; n < a.N; n += blockDim.x)
    if (local[n] != 0) atomicAdd(a.out + n, local[n]);
}

// ---------------------------------------------------------------------------
// K15 fluid_advance
// ---------------------------------------------------------------------------

struct AdvanceArgs {
  int K, N;
  long long now, window_end;
  int done;
  double alpha_scale;  // 1e-9 * (1 / (tau_ns * 1e-9)), computed on the host
  const int* src;
  const int* dst;
  const double* demand;
  const long long* win_start;
  const long long* win_end;
  const double* capacity;
  double* rates;      // [K], in place
  double* link_util;  // [N], in place
  const long long* fg_bytes;
  long long* bg_bytes;    // [], in place
  long long* bg_dropped;  // [], in place
};

__device__ __forceinline__ int halves(int k) { return k <= 32 ? k : (k + 1) / 2; }

// the background load on link n: sum over classes of r_k * charge_k(n) in
// XLA-CPU's order (charge 0, 1 or 2: the products are exact)
__device__ double link_load(const int* src, const int* dst, const double* r, int k, int n) {
  const int h = halves(k);
  double a = 0.0, b = 0.0;
  for (int i = 0; i < k; ++i) {
    const double c = (double)((src[i] == n) + (dst[i] == n));
    const double t = __dmul_rn(r[i], c);
    if (i < h)
      a = __dadd_rn(a, t);
    else
      b = __dadd_rn(b, t);
  }
  return h == k ? a : __dadd_rn(a, b);
}

__device__ __forceinline__ double fg_rate(const AdvanceArgs& a, int n, double dt_s) {
  return __ddiv_rn((double)a.fg_bytes[n], fmax(dt_s, 1e-18));
}

// DropTail share of link n for background load bg
__device__ __forceinline__ double link_share(const AdvanceArgs& a, int n, double bg, double dt_s) {
  const double avail = fmax(__dsub_rn(a.capacity[n], fg_rate(a, n, dt_s)), 0.0);
  return bg > avail ? __ddiv_rn(avail, fmax(bg, 1e-18)) : 1.0;
}

__global__ void fluid_advance_kernel(const AdvanceArgs a) {
  __shared__ double r[kMaxClasses];
  __shared__ double g[kMaxClasses];
  const long long dt_ns = imax(wsub(a.window_end, a.now), 0);
  const double dt_s = __dmul_rn((double)dt_ns, 1e-9);
  // the done-round and an empty window hold the state and add nothing
  if (a.done || !(dt_s > 0.0)) return;
  const int K = a.K, N = a.N;
  const double alpha = fmin(__dmul_rn((double)dt_ns, a.alpha_scale), 1.0);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const bool active = a.win_start[k] <= a.now && a.now < a.win_end[k];
    const double d = active ? a.demand[k] : 0.0;
    const double rate = a.rates[k];
    r[k] = __fma_rn(alpha, __dsub_rn(d, rate), rate);
  }
  __syncthreads();
  // links: offered utilization (written in place: nothing reads the old one)
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const double bg = link_load(a.src, a.dst, r, K, n);
    const double cap = a.capacity[n];
    a.link_util[n] = cap > 0.0 ? __ddiv_rn(__dadd_rn(bg, fg_rate(a, n, dt_s)), cap) : 0.0;
  }
  // classes: the bottleneck share over the class's two links
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int s = a.src[k], t = a.dst[k];
    const double gs = link_share(a, s, link_load(a.src, a.dst, r, K, s), dt_s);
    const double gt = link_share(a, t, link_load(a.src, a.dst, r, K, t), dt_s);
    g[k] = fmin(gs, gt);
    a.rates[k] = __dmul_rn(r[k], g[k]);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  // carried and dropped bytes: fixed-order sums over the classes
  const int h = halves(K);
  double delivered;
  if (h == K) {
    delivered = 0.0;
    for (int k = 0; k < K; ++k) delivered = __fma_rn(r[k], g[k], delivered);
  } else {
    double x = 0.0, y = 0.0;
    for (int k = 0; k < h; ++k) x = __dadd_rn(x, __dmul_rn(r[k], g[k]));
    for (int k = h; k < K; ++k) y = __dadd_rn(y, __dmul_rn(r[k], g[k]));
    delivered = __dadd_rn(x, y);
  }
  double x = 0.0, y = 0.0;
  for (int k = 0; k < K; ++k) {
    const double t = __fma_rn(-r[k], g[k], r[k]);
    if (k < h)
      x = __dadd_rn(x, t);
    else
      y = __dadd_rn(y, t);
  }
  const double dropped = h == K ? x : __dadd_rn(x, y);
  *a.bg_bytes = wadd(*a.bg_bytes, (long long)floor(__dmul_rn(delivered, dt_s)));
  *a.bg_dropped = wadd(*a.bg_dropped, (long long)floor(__dmul_rn(dropped, dt_s)));
}

// ---------------------------------------------------------------------------
// K16 fluid_host_effects
// ---------------------------------------------------------------------------

struct EffectsArgs {
  int H, K, N, hosts_per_node;
  long long host_base;  // this shard's first global host id (node_of is global)
  double thr, inv_span, loss_max, lat_span;  // lat_span = lat_max_x1000 - 1000
  const int* node_of;
  const int* src;
  const int* dst;
  const double* rates;
  const double* link_util;
  float* loss;      // [H]
  long long* lat;   // [H]
};

__global__ void fluid_host_effects_kernel(const EffectsArgs a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int n =
      (int)imin(imax(host_node(a.node_of, a.hosts_per_node, a.host_base + h), 0), a.N - 1);
  // only the sign of the link's load is read: rates are never negative, so
  // it is positive exactly when a class on the link has a positive rate
  const bool bg = link_load(a.src, a.dst, a.rates, a.K, n) > 0.0;
  double over = __dmul_rn(__dsub_rn(a.link_util[n], a.thr), a.inv_span);
  over = fmin(fmax(over, 0.0), 1.0);
  if (!bg) over = 0.0;
  a.loss[h] = __double2float_rn(__dmul_rn(over, a.loss_max));
  const long long lat = (long long)kLatScale + (long long)floor(__dmul_rn(over, a.lat_span));
  a.lat[h] = imax(lat, (long long)kLatScale);
}

}  // namespace

extern "C" {

int fluid_fg_link_bytes(const long long* args, void* stream) {
  Reader r{args, 0};
  FgArgs a;
  a.H = (int)r.v();
  a.B = (int)r.v();
  a.P = (int)r.v();
  a.N = (int)r.v();
  a.hosts_per_node = (int)r.v();
  a.ob_dst = r.p<const int>();
  a.ob_t = r.p<const long long>();
  a.ob_payload = r.p<const int>();
  a.node_of = r.p<const int>();
  a.out = r.p<unsigned long long>();
  a.host_base = r.v();
  a.n_hosts = r.v();
  if (a.N < 1 || a.P < 1 || a.host_base < 0 || a.n_hosts < a.host_base + a.H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a.out, 0, sizeof(unsigned long long) * a.N, s);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)a.H * a.B;
  if (rows > 0) {
    const size_t smem = a.N <= kSharedLinks ? sizeof(unsigned long long) * a.N : 0;
    fg_link_bytes_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

int fluid_advance(const long long* args, void* stream) {
  Reader r{args, 0};
  AdvanceArgs a;
  a.K = (int)r.v();
  a.N = (int)r.v();
  a.now = r.v();
  a.window_end = r.v();
  a.done = (int)r.v();
  a.alpha_scale = r.d();
  a.src = r.p<const int>();
  a.dst = r.p<const int>();
  a.demand = r.p<const double>();
  a.win_start = r.p<const long long>();
  a.win_end = r.p<const long long>();
  a.capacity = r.p<const double>();
  a.rates = r.p<double>();
  a.link_util = r.p<double>();
  a.fg_bytes = r.p<const long long>();
  a.bg_bytes = r.p<long long>();
  a.bg_dropped = r.p<long long>();
  if (a.K < 1 || a.K > kMaxClasses || a.N < 1) return (int)cudaErrorInvalidValue;
  fluid_advance_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int fluid_host_effects(const long long* args, void* stream) {
  Reader r{args, 0};
  EffectsArgs a;
  a.H = (int)r.v();
  a.K = (int)r.v();
  a.N = (int)r.v();
  a.hosts_per_node = (int)r.v();
  a.thr = r.d();
  a.inv_span = r.d();
  a.loss_max = r.d();
  a.lat_span = r.d();
  a.node_of = r.p<const int>();
  a.src = r.p<const int>();
  a.dst = r.p<const int>();
  a.rates = r.p<const double>();
  a.link_util = r.p<const double>();
  a.loss = r.p<float>();
  a.lat = r.p<long long>();
  a.host_base = r.v();
  if (a.K < 1 || a.K > kMaxClasses || a.N < 1 || a.host_base < 0)
    return (int)cudaErrorInvalidValue;
  if (a.H > 0)
    fluid_host_effects_kernel<<<(a.H + kThreads - 1) / kThreads, kThreads, 0,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
