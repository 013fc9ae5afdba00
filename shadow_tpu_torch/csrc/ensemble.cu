// The ensemble plane's per-replica kernels: R replicas of one simulation
// folded into R x H rows of every per-host plane (replica r holds rows
// [r * H, (r + 1) * H)). Plain C interface (ctypes); every entry point
// launches on the stream it is given and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K31 shadow_tpu/core/ensemble.py:272 (the vmap of _run_chunk) over
//       shadow_tpu/core/engine.py:1736-1870 _round_step: per replica, the
//       barrier (the minimum of its hosts' next times), the window
//       end = min(min(gmin, stop) + runahead, stop) with its own used-latency
//       runahead, its done flag, and the microstep loop's test (any host with
//       an event before the replica's window end, under the replica's valve)
//       — the vmapped while_loop's per-replica conditions. A replica whose
//       condition is false is frozen: its rows get a pop limit of 0.
//   K32 shadow_tpu/core/ensemble.py:319-371 replica_digest_sigs and
//       replica_ledger: per replica, the xor fold of the digest plane and
//       the sums of the ledger's per-host counters over its real hosts.
//
// Lanes. K31 reads and writes one int64 [6, R] block, which the host reads
// back in one copy per round and per loop test:
//   row 0 window end, 1 done, 2 live (runs this round: not done), 3 pending
//   (runs this microstep), 4 microsteps this round, 5 sends staged this
//   round (the replica's outbox count, copied in the loop test).
// Round mode (0) sets rows 0-2 and clears 3-4; loop-test mode (1) sets rows
// 3-5 and writes the pop limit of every row: the replica's window end
// where it is pending, else 0. The valve is the replica's microsteps (K = 1)
// or, with `valve` given (K > 1), the largest per-host executed count.
//
// What bounds them on an H100: K31 reads the R x H next times once (config
// 8: 4 x 4,096 x 8 B = 128 KB) and, in loop mode, writes the pop limits
// (128 KB); K32 reads 1 + F int64 planes of R x H. Both are far below one
// launch's latency, so they are latency-bound single launches. Design: one
// block per replica (a replica's rows are contiguous), strided partial
// minima / sums / xors per thread, a warp butterfly and one pass over the
// warp results in shared memory. Integer min, sum and xor are exact and
// order-free, so the results equal the plain versions' bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr int kLanes = 6;
constexpr int kMaxFields = 16;

enum Lane { kWend = 0, kDone = 1, kLive = 2, kPending = 3, kSteps = 4, kSends = 5 };

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_xor(unsigned long long v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v ^= __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K31 replica_window
// ---------------------------------------------------------------------------

struct WindowArgs {
  int R, H, mode, dynamic;
  long long stop, runahead, floor, limit;
  const long long* nt;        // [R * H] next executable times (K1's output)
  const long long* min_used;  // [R] used-latency minima (dynamic runahead)
  const long long* valve;     // [R * H] executed events this round (K > 1) | null
  const int* ob_count;        // [R] sends staged this round (loop mode) | null
  long long* lanes;           // [6, R], in place
  long long* pop_limit;       // [R * H] (loop mode)
};

__global__ void replica_window_kernel(const WindowArgs a) {
  __shared__ long long red[kWarps];
  __shared__ long long vred[kWarps];
  __shared__ long long decided;
  const int r = blockIdx.x, R = a.R, H = a.H;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const long long base = (long long)r * H;
  long long* L = a.lanes;
  if (a.mode == 0) {
    long long m = kTimeMax;
    for (int i = threadIdx.x; i < H; i += kThreads) m = min(m, a.nt[base + i]);
    m = warp_min(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long g = red[0];
      for (int w = 1; w < kWarps; ++w) g = min(g, red[w]);
      L[kPending * R + r] = 0;
      L[kSteps * R + r] = 0;
      if (L[kDone * R + r] != 0) {
        L[kLive * R + r] = 0;  // frozen: done in an earlier round
      } else {
        const bool done = g >= a.stop;
        const long long gs = min(g, a.stop);
        const long long ra = a.dynamic ? max(a.min_used[r], a.floor) : a.runahead;
        // gs <= stop and ra >= 1: the sum saturates instead of wrapping
        const long long we = ra > a.stop - gs ? a.stop : min(gs + ra, a.stop);
        L[kWend * R + r] = we;
        L[kDone * R + r] = done;
        L[kLive * R + r] = !done;
      }
    }
    return;
  }
  // loop-test mode: any of the replica's hosts before its window end, under
  // its valve, while it is live
  const long long we = L[kWend * R + r];
  const bool live = L[kLive * R + r] != 0;
  int any = 0;
  long long vmax = 0;
  if (live) {
    for (int i = threadIdx.x; i < H; i += kThreads) {
      any |= a.nt[base + i] < we;
      if (a.valve != nullptr) vmax = max(vmax, a.valve[base + i]);
    }
  }
  any = __syncthreads_or(any);
  if (a.valve != nullptr) {
    vmax = warp_max(vmax);
    if (lane == 0) vred[warp] = vmax;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    long long v = L[kSteps * R + r];
    if (a.valve != nullptr) {
      v = vred[0];
      for (int w = 1; w < kWarps; ++w) v = max(v, vred[w]);
    }
    const long long pend = live && any && v < a.limit;
    L[kPending * R + r] = pend;
    L[kSteps * R + r] += pend;
    L[kSends * R + r] = a.ob_count != nullptr ? a.ob_count[r] : 0;
    decided = pend ? we : 0;
  }
  __syncthreads();
  const long long lim = decided;
  for (int i = threadIdx.x; i < H; i += kThreads) a.pop_limit[base + i] = lim;
}

// ---------------------------------------------------------------------------
// K32 replica_fold
// ---------------------------------------------------------------------------

struct FoldArgs {
  int R, H, n, F;               // replicas, rows per replica, real hosts, fields
  const unsigned long long* digest;  // [R * H]
  const long long* field[kMaxFields];  // [R * H] each
  long long* out;               // [R, 1 + F]: xor, then the F sums
};

__global__ void replica_fold_kernel(const FoldArgs a) {
  __shared__ long long part[kWarps];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const long long base = (long long)r * a.H;
  long long* out = a.out + (long long)r * (1 + a.F);
  unsigned long long x = 0;
  for (int i = threadIdx.x; i < a.n; i += kThreads) x ^= a.digest[base + i];
  x = warp_xor(x);
  if (lane == 0) part[warp] = (long long)x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kWarps; ++w) t ^= (unsigned long long)part[w];
    out[0] = (long long)t;
  }
  for (int f = 0; f < a.F; ++f) {
    __syncthreads();  // part is reused
    long long s = 0;
    const long long* p = a.field[f] + base;
    for (int i = threadIdx.x; i < a.n; i += kThreads) s += p[i];
    s = warp_sum(s);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long t = 0;
      for (int w = 0; w < kWarps; ++w) t += part[w];
      out[1 + f] = t;
    }
  }
}

}  // namespace

extern "C" {

int replica_window(const long long* args, void* stream) {
  Reader rd{args, 0};
  WindowArgs a;
  a.R = (int)rd.v();
  a.H = (int)rd.v();
  a.mode = (int)rd.v();
  a.dynamic = (int)rd.v();
  a.stop = rd.v();
  a.runahead = rd.v();
  a.floor = rd.v();
  a.limit = rd.v();
  a.nt = rd.p<const long long>();
  a.min_used = rd.p<const long long>();
  a.valve = rd.p<const long long>();
  a.ob_count = rd.p<const int>();
  a.lanes = rd.p<long long>();
  a.pop_limit = rd.p<long long>();
  if (a.R < 1 || a.H < 1 || a.mode < 0 || a.mode > 1 || a.runahead < 1 || a.floor < 1 ||
      a.nt == nullptr || a.lanes == nullptr || (a.dynamic && a.min_used == nullptr) ||
      (a.mode == 1 && a.pop_limit == nullptr))
    return (int)cudaErrorInvalidValue;
  replica_window_kernel<<<a.R, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int replica_fold(const long long* args, void* stream) {
  Reader rd{args, 0};
  FoldArgs a;
  a.R = (int)rd.v();
  a.H = (int)rd.v();
  a.n = (int)rd.v();
  a.F = (int)rd.v();
  if (a.R < 1 || a.H < 1 || a.n < 0 || a.n > a.H || a.F < 0 || a.F > kMaxFields)
    return (int)cudaErrorInvalidValue;
  a.digest = rd.p<const unsigned long long>();
  for (int f = 0; f < a.F; ++f) a.field[f] = rd.p<const long long>();
  a.out = rd.p<long long>();
  replica_fold_kernel<<<a.R, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
