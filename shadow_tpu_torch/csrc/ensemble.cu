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
// launch's latency, so they are latency-bound single launches; what costs
// is the time one replica's rows take to stream through one SM.
//
// K31's design: one thread-block cluster of C blocks per replica (C <= 8,
// the portable cluster size; the host picks it from the rows per replica,
// and refuses to launch where the card reports no room for one cluster).
// Each block reads its slice of the replica's rows with 16-byte loads
// (a scalar head and tail where the slice is not aligned) and reduces min,
// any and max with warp shuffles and shared memory. It then pushes its
// partial over distributed shared memory into a slot of its own in the
// shared memory of the block that decides: rank 0 in round mode, every
// block in loop mode (each then decides alone, the same way, and writes
// its slice of the pop limits with 16-byte stores; rank 0 also writes the
// lanes). Two cluster barriers: the first, split around the loads (arrive
// at entry, wait before the push), proves every block has started, so its
// shared memory may be written; the second makes the pushed partials
// visible. No block reads another's shared memory, so none has to outlive
// another. One launch, no atomics, no second pass; integer min, max and or
// are exact and order-free, so both modes equal the plain version bit for
// bit.
//
// K32's design: one block per replica, strided partial sums / xors per
// thread, a warp butterfly and one pass over the warp results in shared
// memory; integer sum and xor are exact and order-free.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr int kLanes = 6;
constexpr int kMaxFields = 16;
constexpr int kMaxCluster = 8;  // the portable cluster size

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
  int R, H, mode, dynamic, C;  // C: blocks per replica (one cluster)
  long long stop, runahead, floor, limit;
  const long long* nt;        // [R * H] next executable times (K1's output)
  const long long* min_used;  // [R] used-latency minima (dynamic runahead)
  const long long* valve;     // [R * H] executed events this round (K > 1) | null
  const int* ob_count;        // [R] sends staged this round (loop mode) | null
  long long* lanes;           // [6, R], in place
  long long* pop_limit;       // [R * H] (loop mode)
};

// A slice [lo, hi) of an int64 plane cut for 16-byte access: [lo, q0) and
// [q1, hi) hold at most one element each, [q0, q1) whole aligned pairs.
struct Slice {
  long long lo, q0, q1, hi;
};

__device__ __forceinline__ Slice slice_of(const long long* p, long long lo, long long hi) {
  long long q0 = lo;
  if (q0 < hi && (reinterpret_cast<uintptr_t>(p + q0) & 15) != 0) ++q0;
  return {lo, q0, q0 + ((hi - q0) & ~1LL), hi};
}

// f(v) over every element of the slice: pairs by 16-byte loads, the head by
// the block's first thread, the tail by its last.
template <class F>
__device__ __forceinline__ void visit(const long long* p, const Slice& s, F f) {
  for (long long i = s.q0 + 2 * (long long)threadIdx.x; i < s.q1; i += 2 * kThreads) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(p + i);
    f(v.x);
    f(v.y);
  }
  if (threadIdx.x == 0 && s.lo < s.q0) f(p[s.lo]);
  if (threadIdx.x == kThreads - 1 && s.q1 < s.hi) f(p[s.q1]);
}

__device__ __forceinline__ void fill(long long* p, const Slice& s, long long x) {
  for (long long i = s.q0 + 2 * (long long)threadIdx.x; i < s.q1; i += 2 * kThreads)
    *reinterpret_cast<longlong2*>(p + i) = make_longlong2(x, x);
  if (threadIdx.x == 0 && s.lo < s.q0) p[s.lo] = x;
  if (threadIdx.x == kThreads - 1 && s.q1 < s.hi) p[s.q1] = x;
}

// The block's min (or max) of v, in thread 0.
template <bool kMin>
__device__ __forceinline__ long long block_reduce(long long v, long long* red) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  v = kMin ? warp_min(v) : warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) v = kMin ? min(v, red[w]) : max(v, red[w]);
  return v;
}

// The cluster barrier in two halves: arrive (relaxed: it orders nothing)
// and wait. A block's shared memory may be written by another block of the
// cluster only once every block has started, which a completed barrier
// proves.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) replica_window_kernel(const WindowArgs a) {
  __shared__ long long red[kWarps];
  // the C blocks' partials, pushed here by each block of the cluster: round
  // mode the slices' min next times (to rank 0 only), loop mode the slices'
  // max valves and any-before-window-end flags (to every block)
  __shared__ long long part_v[kMaxCluster];
  __shared__ int part_any[kMaxCluster];
  __shared__ long long lim_s;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // overlaps the loads below
  const int c = (int)cluster.block_rank();
  const int r = blockIdx.x / a.C, R = a.R, H = a.H;
  const long long base = (long long)r * H;
  const long long span = (H + a.C - 1) / a.C;
  const long long lo = base + min((long long)c * span, (long long)H);
  const long long hi = base + min((long long)(c + 1) * span, (long long)H);
  long long* L = a.lanes;
  if (a.mode == 0) {
    long long m = kTimeMax;
    visit(a.nt, slice_of(a.nt, lo, hi), [&](long long v) { m = min(m, v); });
    m = block_reduce<true>(m, red);
    cluster_wait();  // every block has started: rank 0's shared memory is writable
    if (threadIdx.x == 0) *cluster.map_shared_rank(&part_v[c], 0) = m;
    cluster.sync();  // the partials have landed in rank 0
    if (c != 0 || threadIdx.x != 0) return;
    long long g = part_v[0];
    for (int k = 1; k < a.C; ++k) g = min(g, part_v[k]);
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
    return;
  }
  // loop-test mode: any of the replica's rows before its window end, under
  // its valve, while it is live. Every block reads the lanes before the
  // barrier and rank 0 alone writes rows 3-5 after it
  const long long we = L[kWend * R + r];
  const bool live = L[kLive * R + r] != 0;
  const long long steps = L[kSteps * R + r];
  int any = 0;
  long long vmax = 0;
  if (live) {
    visit(a.nt, slice_of(a.nt, lo, hi), [&](long long v) { any |= v < we; });
    if (a.valve != nullptr)
      visit(a.valve, slice_of(a.valve, lo, hi), [&](long long v) { vmax = max(vmax, v); });
  }
  any = __syncthreads_or(any);
  if (a.valve != nullptr) vmax = block_reduce<false>(vmax, red);
  cluster_wait();  // every block has started: their shared memory is writable
  if (threadIdx.x == 0) {  // this block's partial, into every block's slot c
    for (int k = 0; k < a.C; ++k) {
      *cluster.map_shared_rank(&part_v[c], k) = vmax;
      *cluster.map_shared_rank(&part_any[c], k) = any;
    }
  }
  cluster.sync();  // every block holds the C partials
  if (threadIdx.x == 0) {
    int any_r = 0;
    long long v = 0;
    for (int k = 0; k < a.C; ++k) {
      any_r |= part_any[k];
      v = max(v, part_v[k]);
    }
    if (a.valve == nullptr) v = steps;
    const long long pend = live && any_r && v < a.limit;
    lim_s = pend ? we : 0;
    if (c == 0) {
      L[kPending * R + r] = pend;
      L[kSteps * R + r] = steps + pend;
      L[kSends * R + r] = a.ob_count != nullptr ? a.ob_count[r] : 0;
    }
  }
  __syncthreads();
  fill(a.pop_limit, slice_of(a.pop_limit, lo, hi), lim_s);
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
  a.C = (int)rd.v();
  if (a.R < 1 || a.H < 1 || a.mode < 0 || a.mode > 1 || a.runahead < 1 || a.floor < 1 ||
      a.C < 1 || a.C > kMaxCluster || a.C > a.H ||
      a.nt == nullptr || a.lanes == nullptr || (a.dynamic && a.min_used == nullptr) ||
      (a.mode == 1 && a.pop_limit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.R * a.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per cluster size: a card with no room for one cluster refuses
  static int fits[kMaxCluster + 1] = {0};
  if (fits[a.C] == 0) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, replica_window_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    fits[a.C] = n;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, replica_window_kernel, a);
  if (e != cudaSuccess) return (int)e;
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
