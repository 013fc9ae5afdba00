// K4 merge_insert and K13 merge_scatter: the round's exchange merge without
// a global sort.
//
// Replaces (JAX reference): K4 shadow_tpu/ops/merge.py:240 merge_flat_events
// (with _merge_scatter :73 / _merge_gather_plan :443, merge_rows = 0); K13
// shadow_tpu/ops/merge.py:312 merge_scatter_free (merge_rows = 0); both as
// called from shadow_tpu/core/engine.py:3273 _merge_into_queue.
//
// Rows. The rows are the first `gc` columns of an [R, B] outbox (host-major:
// row (h, k) is element e = h * B + k of every plane), so a gear-sliced
// outbox is read in place, never copied; N flat rows are the case R = N,
// B = gc = 1. A row is valid where `valid[e]` is set (or, with no valid
// plane, where its time is not TIME_MAX) and 0 <= dst[e] < H.
//
// K4 contract: destination h takes r = min(seg_len[h], r_cap, free slots of
// h) of the valid rows addressed to it — the r smallest by key — and writes
// the i-th smallest into its i-th free slot (free slots ranked by slot
// index); seg_len[h] - r adds to dropped[h]. Key = (t, order) in urgency
// mode, the row's element index e in append mode (monotone in the sliced
// row index h * gc + k that the JAX package ranks by); both are unique among
// valid rows.
//
// K13 contract: when every destination's count of valid rows is at most
// min(free slots, r_cap) ("fits"), destination h places its rows in
// DESCENDING element index: the row of rank i into its i-th free slot
// (JAX's scatter-max peeling), `dropped` unchanged. Otherwise the result is
// K4's in the configured shed mode. The choice is made on the device: a
// per-host check counts failing hosts into a flag word, and two inserts
// gated on that word follow — no host sync, no host-side branch.
//
// What bounds it on an H100: at the main path's shapes (H = 10,000 hosts,
// C = 16-64 slots, R x gc = 10,000-120,000 rows of which a few thousand
// are valid per round) the work is a few passes over the row columns plus
// one row-wise read of the queue's time plane and the inserted slots'
// writes — memory- and latency-bound, far below the compute rate.
// Design, on one stream:
//   1. histogram: one thread per row, atomicAdd into counts[dst] (integer
//      adds commute, so the counts are exact and order-free);
//   2. exclusive scan of counts into offsets (one 1024-thread block, warp
//      shuffles plus one shared-memory level);
//   3. scatter: each valid row claims a position in its destination's
//      bucket with an atomicAdd cursor — the order inside a bucket is
//      arbitrary and nothing downstream depends on it;
//   (K13) fits: one thread per host counts its free slots before any insert
//      writes, and bumps the flag word where its rows do not fit;
//   4. insert: one warp per destination selects its r smallest rows by
//      repeated warp-wide minimum extraction over the bucket (each round
//      takes the least key above the previous winner: O(r * seg_len / 32)),
//      and writes each winner into the first still-free slot. K13's fast
//      insert is the same loop keyed by -e. Selection by unique key is what
//      makes the result bit-identical run to run even though steps 1 and 3
//      use atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(long long at, long long ao, long long bt, long long bo) {
  return at < bt || (at == bt && ao < bo);
}

// Row i of the R x gc sliced rows: its element index in the [R, B] planes.
__device__ __forceinline__ long long elem_of(long long i, int B, int gc) {
  return (i / gc) * B + i % gc;
}

__device__ __forceinline__ bool row_ok(const bool* valid, const long long* t, const int* dst,
                                       long long e, int H) {
  const bool live = valid != nullptr ? valid[e] : t[e] != kTimeMax;
  return live && dst[e] >= 0 && dst[e] < H;
}

__global__ void histogram_kernel(const int* __restrict__ dst, const long long* __restrict__ t,
                                 const bool* __restrict__ valid, int* __restrict__ counts,
                                 long long N, int B, int gc, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long e = elem_of(i, B, gc);
  if (row_ok(valid, t, dst, e, H)) atomicAdd(&counts[dst[e]], 1);
}

__global__ void scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets, int H) {
  __shared__ int warp_sums[kScanThreads / kWarp];
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid >> 5;
  const int per = (H + kScanThreads - 1) / kScanThreads;
  const int start = min(tid * per, H), end = min(start + per, H);
  int sum = 0;
  for (int i = start; i < end; ++i) sum += counts[i];
  int v = sum;  // inclusive scan within the warp
  for (int o = 1; o < kWarp; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == kWarp - 1) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];  // kScanThreads / kWarp == kWarp
    for (int o = 1; o < kWarp; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int prefix = v - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = start; i < end; ++i) {
    offsets[i] = prefix;
    prefix += counts[i];
  }
  if (tid == kScanThreads - 1) offsets[H] = prefix;
}

__global__ void scatter_kernel(const int* __restrict__ dst, const long long* __restrict__ t,
                               const bool* __restrict__ valid, const int* __restrict__ offsets,
                               int* __restrict__ fill, long long* __restrict__ bucket,
                               long long N, int B, int gc, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long long e = elem_of(i, B, gc);
  if (row_ok(valid, t, dst, e, H)) {
    const int d = dst[e];
    bucket[offsets[d] + atomicAdd(&fill[d], 1)] = e;
  }
}

// K13's admission: host h fits iff its valid rows are at most min(free
// slots, r_cap). Runs before either insert writes; counts failing hosts.
__global__ void fits_kernel(const long long* __restrict__ qt, const int* __restrict__ counts,
                            int* __restrict__ over, int H, int C, int r_cap) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const int seg = counts[h];
  if (seg == 0) return;
  const long long base = (long long)h * C;
  int free_count = 0;
  for (int c = 0; c < C; ++c) free_count += qt[base + c] == kTimeMax;
  if (seg > min(free_count, r_cap)) atomicAdd(over, 1);
}

enum KeyMode { kAppend = 0, kUrgency = 1, kDescending = 2 };

__device__ __forceinline__ void row_key(const long long* t, const long long* order, long long e,
                                        int mode, long long& k1, long long& k2) {
  if (mode == kUrgency) { k1 = t[e]; k2 = order[e]; }
  else if (mode == kAppend) { k1 = 0; k2 = e; }
  else { k1 = 0; k2 = -e; }
}

// The queue planes are read and written by different lanes of one warp
// across iterations (ordered by __syncwarp), so they carry no __restrict__.
__global__ void insert_kernel(long long* qt, long long* qo, int* qk, int* qp,
                              long long* __restrict__ dropped,
                              const long long* __restrict__ t, const long long* __restrict__ order,
                              const int* __restrict__ kind, const int* __restrict__ payload,
                              const int* __restrict__ counts, const int* __restrict__ offsets,
                              const long long* __restrict__ bucket, int H, int C, int P,
                              int r_cap, int mode, const int* __restrict__ gate, int run_if_over) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (h >= H) return;
  // K13: each of the two inserts runs only on its side of the fits flag
  if (gate != nullptr && ((*gate != 0) != (run_if_over != 0))) return;
  const int seg = counts[h];
  if (seg == 0) return;
  const int off = offsets[h];
  const long long base = (long long)h * C;
  int free_count = 0;
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int c = c0 + lane;
    free_count += __popc(__ballot_sync(kFull, c < C && qt[base + c] == kTimeMax));
  }
  const int r = min(seg, min(r_cap, free_count));
  if (lane == 0 && seg > r) dropped[h] += seg - r;
  long long pk1 = 0, pk2 = 0;  // previous winner's key (none before k = 0)
  int slot_from = 0;           // free slots below this index are taken
  for (int k = 0; k < r; ++k) {
    long long b1 = kTimeMax, b2 = kTimeMax;
    long long brow = -1;
    for (int j = lane; j < seg; j += kWarp) {
      const long long i = bucket[off + j];
      long long k1, k2;
      row_key(t, order, i, mode, k1, k2);
      const bool above = k == 0 || lex_less(pk1, pk2, k1, k2);
      if (above && (brow < 0 || lex_less(k1, k2, b1, b2))) { b1 = k1; b2 = k2; brow = i; }
    }
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const long long o1 = __shfl_xor_sync(kFull, b1, o);
      const long long o2 = __shfl_xor_sync(kFull, b2, o);
      const long long orow = __shfl_xor_sync(kFull, brow, o);
      if (orow >= 0 && (brow < 0 || lex_less(o1, o2, b1, b2))) { b1 = o1; b2 = o2; brow = orow; }
    }
    pk1 = b1;
    pk2 = b2;
    // the first free slot at or after slot_from (k < free_count, so one exists)
    int slot = -1;
    for (int c0 = slot_from; c0 < C && slot < 0; c0 += kWarp) {
      const int c = c0 + lane;
      const unsigned bal = __ballot_sync(kFull, c < C && qt[base + c] == kTimeMax);
      if (bal) slot = c0 + __ffs(bal) - 1;
    }
    if (lane == 0) {
      qt[base + slot] = t[brow];
      qo[base + slot] = order[brow];
      qk[base + slot] = kind[brow];
    }
    if (lane < P) qp[(base + slot) * P + lane] = payload[brow * P + lane];
    slot_from = slot + 1;
    __syncwarp();
  }
}

inline unsigned cdiv(long long a, int b) { return (unsigned)((a + b - 1) / b); }

int launch_merge(long long* qt, long long* qo, int* qk, int* qp, long long* dropped,
                 const int* dst, const long long* t, const long long* order, const int* kind,
                 const int* payload, const bool* valid, int* counts, int* offsets, int* fill,
                 long long* bucket, int* over, int H, int C, int P, int R, int B, int gc,
                 int r_cap, int urgency, cudaStream_t s) {
  if (P > kWarp || gc > B || gc < 0) return (int)cudaErrorInvalidValue;
  if (H <= 0) return (int)cudaGetLastError();
  const long long N = (long long)R * gc;
  const int mode = urgency ? kUrgency : kAppend;
  cudaMemsetAsync(counts, 0, sizeof(int) * H, s);
  cudaMemsetAsync(fill, 0, sizeof(int) * H, s);
  if (N > 0) histogram_kernel<<<cdiv(N, 256), 256, 0, s>>>(dst, t, valid, counts, N, B, gc, H);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offsets, H);
  if (N > 0)
    scatter_kernel<<<cdiv(N, 256), 256, 0, s>>>(dst, t, valid, offsets, fill, bucket, N, B, gc, H);
  const unsigned blocks = cdiv(H, kWarpsPerBlock), threads = kWarpsPerBlock * kWarp;
  if (over != nullptr) {
    cudaMemsetAsync(over, 0, sizeof(int), s);
    fits_kernel<<<cdiv(H, 256), 256, 0, s>>>(qt, counts, over, H, C, r_cap);
    insert_kernel<<<blocks, threads, 0, s>>>(qt, qo, qk, qp, dropped, t, order, kind, payload,
                                             counts, offsets, bucket, H, C, P, r_cap,
                                             kDescending, over, 0);
  }
  insert_kernel<<<blocks, threads, 0, s>>>(qt, qo, qk, qp, dropped, t, order, kind, payload,
                                           counts, offsets, bucket, H, C, P, r_cap, mode, over, 1);
  return (int)cudaGetLastError();
}

}  // namespace

// K4: the sort-order merge.
extern "C" int merge_insert(long long* qt, long long* qo, int* qk, int* qp, long long* dropped,
                            const int* dst, const long long* t, const long long* order,
                            const int* kind, const int* payload, const bool* valid,
                            int* counts, int* offsets, int* fill, long long* bucket,
                            int H, int C, int P, int R, int B, int gc, int r_cap, int urgency,
                            void* stream) {
  return launch_merge(qt, qo, qk, qp, dropped, dst, t, order, kind, payload, valid, counts,
                      offsets, fill, bucket, nullptr, H, C, P, R, B, gc, r_cap, urgency,
                      (cudaStream_t)stream);
}

// K13: the scatter merge; `over` receives the count of hosts whose rows did
// not fit (0: the fast path ran).
extern "C" int merge_scatter(long long* qt, long long* qo, int* qk, int* qp, long long* dropped,
                             const int* dst, const long long* t, const long long* order,
                             const int* kind, const int* payload, const bool* valid,
                             int* counts, int* offsets, int* fill, long long* bucket, int* over,
                             int H, int C, int P, int R, int B, int gc, int r_cap, int urgency,
                             void* stream) {
  return launch_merge(qt, qo, qk, qp, dropped, dst, t, order, kind, payload, valid, counts,
                      offsets, fill, bucket, over, H, C, P, R, B, gc, r_cap, urgency,
                      (cudaStream_t)stream);
}
