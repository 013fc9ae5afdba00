// K29 dshard_pack and K30 exchange_unpack: the two halves of the cross-shard
// exchange around the collective. Plain C interface (ctypes); each entry
// point launches on the stream it is given and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K29 shadow_tpu/ops/merge.py:136 dshard_segments and
//       shadow_tpu/core/engine.py:3410 _dshard_pack_blocks (with _pack_words
//       ops/merge.py:172 and _invalid_row engine.py:3566): group the local
//       outbox rows by destination shard, each group in (t, order) order,
//       and pack each group's first k rows into a fixed wire block;
//   K30 the receive half of shadow_tpu/core/engine.py:3346
//       _exchange_alltoall / :3459 _exchange_hierarchical (_unpack_words
//       ops/merge.py:180, the rebase and validity at :3386 / :3517-3519)
//       and of the gather exchange :3188 (:3211-3212): wire rows back to the
//       (local, t, order, kind, payload, valid) planes the merge takes.
//
// Rows. K29 reads the first `gc` columns of the shard's [H, B] outbox in
// place (row i = (h, c) with h = i / gc, c = i % gc, element h * B + c), so
// a gear-sliced outbox is never copied. A row is valid where t != TIME_MAX
// and its destination shard dst / h_local lies in [0, world). A wire row
// is 6 + P int32 words: the destination host, t (low word, high word),
// order (low, high), kind, payload[P]; an unused slot holds the invalid
// row (dst 0, t = TIME_MAX, order = ORDER_MAX, zeros).
//
// K29 contract: block j holds the first min(seg_len[j], k) valid rows whose
// destination shard is j, in ascending (t, order) order; seg_len[j] is the
// count of such rows, shed the sum of max(seg_len[j] - k, 0). The order
// inside a block is observable downstream (the merge's append-mode keys and
// its merge_rows bound read it), so it is JAX's sorted order, not only its
// set. Order keys are unique among a shard's sends; the sort breaks any tie
// by row index, so the result is one total order whatever the schedule.
//
// What bounds it on an H100: at the 80k-host world-4 leg a shard's outbox
// is M = 20,000 x 12 = 240,000 rows (40 B of planes each) and a block is up
// to 120,000 rows of 40 B, a few MB read and written once: bytes, far below
// the compute rate. Design (a simple sort that is right):
//   1. keys: one thread per row packs (shard, t, order, row) into a 24-byte
//      key (invalid rows get shard = world, so they sort last);
//   2. tile sort: one block per 256 keys ranks each key within its tile in
//      shared memory (256 compares per thread);
//   3. merge passes: bottom-up over runs of 256, 512, ...: each key's output
//      position is its rank in its own run plus a binary search in the
//      partner run (ceil(log2(M / 256)) passes, ping-pong buffers);
//   4. finalize (one block): each group's first sorted position by binary
//      search on the shard field, seg_len and the shed sum;
//   5. fill: one thread per (block, slot) gathers its row's planes and
//      writes the wire words, or the invalid row.
// No atomics and no scratch that must start zeroed: the result is the
// same bits on every run.
//
// K30 contract: rows come as W groups of n rows, group w starting at row
// w * stride (a [W, k] receive buffer, or the gather buffer whose groups
// carry a trailing count row). Output row q = w * n + i: local = dst - base
// (int32, as JAX computes it), t, order, kind, payload unpacked, valid =
// t != TIME_MAX && 0 <= local < h_local && (no counts || i < counts[w]).
// Elementwise, one thread per row: bytes-bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kFinThreads = 1024;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr long long kOrderMax = 0x7fffffffffffffffLL;

struct Key {
  long long t;
  long long o;
  int ds;
  int idx;
};

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  if (a.ds != b.ds) return a.ds < b.ds;
  if (a.t != b.t) return a.t < b.t;
  if (a.o != b.o) return a.o < b.o;
  return a.idx < b.idx;
}

// the count of elements of sorted run [p, p + n) that are below x
__device__ __forceinline__ long long count_below(const Key* p, long long n, const Key& x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_less(p[mid], x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct PackArgs {
  int H, B, gc, P, world, k, h_local;
  const int* dst;
  const long long* t;
  const long long* order;
  const int* kind;
  const int* payload;  // [H, B, P]
  Key* keys_a;         // [M] scratch
  Key* keys_b;         // [M] scratch
  int* first;          // [world + 1] scratch
  int* blocks;         // [world, k, 6 + P]
  int* seg_len;        // [world]
  long long* shed;     // [1]
};

__global__ void dshard_keys_kernel(const PackArgs a, long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const long long e = (i / a.gc) * a.B + i % a.gc;
  Key k;
  k.t = a.t[e];
  k.o = a.order[e];
  k.idx = (int)i;
  long long ds = a.world;
  if (k.t != kTimeMax) {
    const long long s = floordiv((long long)a.dst[e], (long long)a.h_local);
    if (s >= 0 && s < a.world) ds = s;
  }
  k.ds = (int)ds;
  a.keys_a[i] = k;
}

__global__ void dshard_tile_sort_kernel(const Key* in, Key* out, long long M) {
  __shared__ Key tile[kTile];
  const long long start = (long long)blockIdx.x * kTile;
  const int n = (int)(M - start < kTile ? M - start : kTile);
  const int j = threadIdx.x;
  if (j < n) tile[j] = in[start + j];
  __syncthreads();
  if (j >= n) return;
  const Key x = tile[j];
  int rank = 0;
  for (int m = 0; m < n; ++m) rank += key_less(tile[m], x);
  out[start + rank] = x;
}

__global__ void dshard_merge_pass_kernel(const Key* in, Key* out, long long M, long long w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const Key x = in[i];
  const long long run = i / w;
  const long long a0 = (run & ~1LL) * w;
  const long long b0 = a0 + w;
  const long long b1 = b0 + w < M ? b0 + w : M;
  long long pos;
  if ((run & 1) == 0) {
    pos = (i - a0) + (b0 < M ? count_below(in + b0, b1 - b0, x) : 0);
  } else {
    pos = (i - b0) + count_below(in + a0, w, x);
  }
  out[a0 + pos] = x;
}

__global__ void dshard_finalize_kernel(const PackArgs a, const Key* sorted, long long M) {
  __shared__ long long shed_part[kFinThreads / 32];
  const int j = threadIdx.x;
  for (int g = j; g <= a.world; g += blockDim.x) {
    long long lo = 0, hi = M;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (sorted[mid].ds < g) lo = mid + 1;
      else hi = mid;
    }
    a.first[g] = (int)lo;
  }
  __syncthreads();
  long long s = 0;
  for (int g = j; g < a.world; g += blockDim.x) {
    const int len = a.first[g + 1] - a.first[g];
    a.seg_len[g] = len;
    s += len > a.k ? len - a.k : 0;
  }
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((j & 31) == 0) shed_part[j >> 5] = s;
  __syncthreads();
  if (j == 0) {
    long long tot = 0;
    for (int m = 0; m < (int)(blockDim.x >> 5); ++m) tot += shed_part[m];
    a.shed[0] = tot;
  }
}

__global__ void dshard_fill_kernel(const PackArgs a, const Key* sorted) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)a.world * a.k) return;
  const int j = (int)(q / a.k);
  const int r = (int)(q % a.k);
  const int W = 6 + a.P;
  int* row = a.blocks + q * W;
  const int len = a.first[j + 1] - a.first[j];
  if (r < len && r < a.k) {
    const int i = sorted[a.first[j] + r].idx;
    const long long e = (long long)(i / a.gc) * a.B + i % a.gc;
    const unsigned long long t = (unsigned long long)a.t[e];
    const unsigned long long o = (unsigned long long)a.order[e];
    row[0] = a.dst[e];
    row[1] = (int)(unsigned)(t & 0xffffffffull);
    row[2] = (int)(unsigned)(t >> 32);
    row[3] = (int)(unsigned)(o & 0xffffffffull);
    row[4] = (int)(unsigned)(o >> 32);
    row[5] = a.kind[e];
    for (int p = 0; p < a.P; ++p) row[6 + p] = a.payload[e * a.P + p];
  } else {
    const unsigned long long t = (unsigned long long)kTimeMax;
    const unsigned long long o = (unsigned long long)kOrderMax;
    row[0] = 0;
    row[1] = (int)(unsigned)(t & 0xffffffffull);
    row[2] = (int)(unsigned)(t >> 32);
    row[3] = (int)(unsigned)(o & 0xffffffffull);
    row[4] = (int)(unsigned)(o >> 32);
    row[5] = 0;
    for (int p = 0; p < a.P; ++p) row[6 + p] = 0;
  }
}

struct UnpackArgs {
  int W, n, stride, P, h_local;
  int base;
  const int* rows;
  const int* counts;  // [W] or null
  int* local;
  long long* t;
  long long* order;
  int* kind;
  int* payload;  // [W * n, P]
  bool* valid;
};

__global__ void exchange_unpack_kernel(const UnpackArgs a) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)a.W * a.n) return;
  const int w = (int)(q / a.n);
  const int i = (int)(q % a.n);
  const int Wd = 6 + a.P;
  const int* row = a.rows + ((long long)w * a.stride + i) * Wd;
  const long long t =
      (long long)((unsigned long long)(unsigned)row[1] | ((unsigned long long)(unsigned)row[2] << 32));
  const long long o =
      (long long)((unsigned long long)(unsigned)row[3] | ((unsigned long long)(unsigned)row[4] << 32));
  // int32 wraparound, as the reference's i32 subtraction
  const int local = (int)((unsigned)row[0] - (unsigned)a.base);
  a.local[q] = local;
  a.t[q] = t;
  a.order[q] = o;
  a.kind[q] = row[5];
  for (int p = 0; p < a.P; ++p) a.payload[q * a.P + p] = row[6 + p];
  bool ok = t != kTimeMax && local >= 0 && local < a.h_local;
  if (a.counts != nullptr) ok = ok && i < a.counts[w];
  a.valid[q] = ok;
}

struct Reader {
  const long long* a;
  int i;
  long long v() { return a[i++]; }
  template <typename T>
  T* p() {
    return reinterpret_cast<T*>(a[i++]);
  }
};

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// args: H, B, gc, P, world, k, h_local, dst, t, order, kind, payload,
//       keys_a, keys_b, first, blocks, seg_len, shed
int dshard_pack(const long long* args, void* stream) {
  Reader r{args, 0};
  PackArgs a;
  a.H = (int)r.v();
  a.B = (int)r.v();
  a.gc = (int)r.v();
  a.P = (int)r.v();
  a.world = (int)r.v();
  a.k = (int)r.v();
  a.h_local = (int)r.v();
  a.dst = r.p<const int>();
  a.t = r.p<const long long>();
  a.order = r.p<const long long>();
  a.kind = r.p<const int>();
  a.payload = r.p<const int>();
  a.keys_a = r.p<Key>();
  a.keys_b = r.p<Key>();
  a.first = r.p<int>();
  a.blocks = r.p<int>();
  a.seg_len = r.p<int>();
  a.shed = r.p<long long>();
  if (a.H < 1 || a.B < 1 || a.gc < 1 || a.gc > a.B || a.P < 1 || a.world < 1 ||
      a.world >= kFinThreads || a.k < 1 || a.h_local < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)a.H * a.gc;
  dshard_keys_kernel<<<blocks_for(M), kThreads, 0, s>>>(a, M);
  dshard_tile_sort_kernel<<<(unsigned)((M + kTile - 1) / kTile), kTile, 0, s>>>(a.keys_a, a.keys_b, M);
  Key* in = a.keys_b;
  Key* out = a.keys_a;
  for (long long w = kTile; w < M; w *= 2) {
    dshard_merge_pass_kernel<<<blocks_for(M), kThreads, 0, s>>>(in, out, M, w);
    Key* tmp = in;
    in = out;
    out = tmp;
  }
  dshard_finalize_kernel<<<1, kFinThreads, 0, s>>>(a, in, M);
  dshard_fill_kernel<<<blocks_for((long long)a.world * a.k), kThreads, 0, s>>>(a, in);
  return (int)cudaGetLastError();
}

// args: W, n, stride, P, h_local, base, rows, counts, local, t, order, kind,
//       payload, valid
int exchange_unpack(const long long* args, void* stream) {
  Reader r{args, 0};
  UnpackArgs a;
  a.W = (int)r.v();
  a.n = (int)r.v();
  a.stride = (int)r.v();
  a.P = (int)r.v();
  a.h_local = (int)r.v();
  a.base = (int)r.v();
  a.rows = r.p<const int>();
  a.counts = r.p<const int>();
  a.local = r.p<int>();
  a.t = r.p<long long>();
  a.order = r.p<long long>();
  a.kind = r.p<int>();
  a.payload = r.p<int>();
  a.valid = r.p<bool>();
  if (a.W < 1 || a.n < 0 || a.stride < a.n || a.P < 1 || a.h_local < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)a.W * a.n;
  if (n > 0) exchange_unpack_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
