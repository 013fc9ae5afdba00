// Event-queue kernels of the round loop. Plain C interface (ctypes); every
// entry point launches on the stream it is given and returns
// cudaGetLastError().
//
// Replaces (JAX reference):
//   K1  shadow_tpu/ops/events.py:129 next_time      (row min; also bq_next_time
//                                                    over the [H, C/B] block caches;
//                                                    the floor lane: the CPU model's
//                                                    busy horizon, core/engine.py:2255;
//                                                    the fault lane: the restart of a
//                                                    crash window containing the floored
//                                                    head, :2256-2259 with
//                                                    core/faults.py:266 down_and_resume)
//   K2  shadow_tpu/ops/events.py:138 pop_min        (lexicographic min, read, clear;
//                                                    the device code in queue_pop.cuh,
//                                                    shared with K36 in event.cu)
//   K3  shadow_tpu/ops/events.py:342 push_many      (k-th firing push -> k-th free
//                                                    slot, minus its reserve)
//   K5  shadow_tpu/ops/events.py:201 pop_k          (peek the K earliest in-window)
//   K6  shadow_tpu/ops/events.py:290 clear_popped   (clear the executed prefix;
//                                                    bucketed: victim-block recompute)
//   K7  shadow_tpu/ops/events.py:616 bq_push_many   (K3 plus the block-cache update)
//   K8  shadow_tpu/ops/events.py:460 block_minima   (wholesale cache rebuild)
//   K12 shadow_tpu/ops/wheel.py:123 wheel_cancel    (masked order-key compare over
//                                                    the timer wheel's slab + victim-
//                                                    block recompute)
//   K25 shadow_tpu/ops/events.py:719 migrate_queue  (re-seat [H, C] into new [H, C']
//                                                    tensors: pad, or stable compaction
//                                                    and truncation; or the live count
//                                                    per host, which :823
//                                                    migration_fits compares;
//                                                    ops/wheel.py:165 migrate_wheel on
//                                                    the wheel slab)
//
// Layout: one [H, C] slab per field, row-major; t/order int64, kind int32,
// payload int32[P] per slot. Empty slots hold (TIME_MAX, ORDER_MAX). The
// bucketed queue adds [H, NB] caches over NB = C / B blocks of B contiguous
// slots: bt/bo int64 (the block's lexicographic (t, order) minimum) and bfill
// int32 (its live slots).
//
// What bounds them on an H100: all are memory-bound passes over the slab
// (H = 10,000, C = 28 at bench config 6: 2.2 MB per int64 plane) with a few
// integer compares per element; the bound is bytes / 3.35 TB/s. Design: ONE
// WARP PER HOST ROW. Lane l owns slots l, l+32, ... so every load of a warp is
// one coalesced transaction per plane, and row reductions are five butterfly
// shuffles (no shared memory, no atomics, no block barrier). Results are
// independent of scheduling: each host is owned by exactly one warp and every
// reduction is over a total order with unique keys ((t, order) among live
// slots; (t, order, slot) where empty slots must be told apart).
//
// K25 moves each plane once (read [H, C], write [H, C']), a bytes-bound copy,
// once per capacity migration: one warp per host again, the destination of a
// slot from two ballot prefix counts (live slots before it, empty slots
// before it), so the compaction needs no sort and no shared memory.
//
// Limits checked at the C entry points: P <= 32, C <= 1024 (a lane tracks its
// slots in one 32-bit mask), K <= 32 and NP <= 32 (pushes per host per call;
// bench config 6 at K = 4 has 12), NB <= 32 blocks per row for the bucketed
// kernels.

#include <cstdint>
#include <cuda_runtime.h>

#include "faults.cuh"
#include "queue_pop.cuh"

namespace {

using qpop::kFull;
using qpop::kOrderMax;
using qpop::kTimeMax;
using qpop::lex_less;
using qpop::lex_less3;
constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPorts = 32;

// warp-wide lexicographic (t, order) minimum; every lane gets the result
__device__ __forceinline__ void warp_lexmin(long long& t, long long& o) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    long long ot = __shfl_xor_sync(kFull, t, off);
    long long oo = __shfl_xor_sync(kFull, o, off);
    if (lex_less(ot, oo, t, o)) { t = ot; o = oo; }
  }
}

__device__ __forceinline__ int host_of_warp() {
  return blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}

// K1: out[h] = min_c t[h, c]; with a floor (the CPU model's busy horizon),
// max(that, floor[h]) unless the row is empty (TIME_MAX stays)
__global__ void next_time_kernel(const long long* __restrict__ t,
                                 const long long* __restrict__ floor, long long* __restrict__ out,
                                 int H, int C, const long long* __restrict__ down_t,
                                 const long long* __restrict__ up_t, int W) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;  // whole warp exits together
  const long long* row = t + (long long)h * C;
  long long m = kTimeMax;
  for (int c = lane; c < C; c += kWarp) {
    long long v = row[c];
    m = v < m ? v : m;
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(kFull, m, off);
    m = o < m ? o : m;
  }
  if (floor != nullptr && m != kTimeMax && floor[h] > m) m = floor[h];
  if (lane == 0) {
    // the fault lane: a floored head inside one of the host's crash windows
    // executes at that window's restart (TIME_MAX stays TIME_MAX)
    if (down_t != nullptr && m != kTimeMax) {
      long long resume;
      const long long row = (long long)h * W;
      flt::down_resume(down_t + row, up_t + row, W, m, resume);
      m = resume > m ? resume : m;
    }
    out[h] = m;
  }
}

// K2: per host, the (t, order, slot) minimum over all slots under the tie
// rule of queue_pop.cuh; active iff its time is below `limit`. The winner
// is read out and its (t, order) cleared to the empty sentinel in place.
// Inactive hosts get the dummy event.
__global__ void pop_min_kernel(long long* __restrict__ t, long long* __restrict__ order,
                               const int* __restrict__ kind, const int* __restrict__ payload,
                               long long limit, const long long* __restrict__ limits,
                               long long* __restrict__ ev_t,
                               long long* __restrict__ ev_order, int* __restrict__ ev_kind,
                               int* __restrict__ ev_payload, bool* __restrict__ active,
                               int H, int C, int P) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  // per-host limits (the ensemble plane's frozen replicas pop under 0, the
  // CPU model's held hosts too), or one for every host
  if (limits != nullptr) limit = limits[h];
  const long long base = (long long)h * C;
  qpop::Cand w;
  for (int c = lane; c < C; c += kWarp) w.fold(t[base + c], order[base + c], c);
  qpop::group_min<kWarp>(w);
  // every lane now holds the same winner
  const bool act = w.t < limit;
  if (lane < P) {
    ev_payload[(long long)h * P + lane] = act ? payload[(base + w.i) * P + lane] : 0;
  }
  if (lane == 0) {
    ev_t[h] = act ? w.t : kTimeMax;
    ev_order[h] = act ? w.o : kOrderMax;
    ev_kind[h] = act ? kind[base + w.i] : 0;
    active[h] = act;
    if (act) {
      t[base + w.i] = kTimeMax;
      order[base + w.i] = kOrderMax;
    }
  }
}

// K3 (flat) and K7 (bucketed): pushes are applied in port order; the k-th
// push that fires takes the k-th free slot of the ORIGINAL free set (ranked
// by slot index), as long as k + reserve[push] < the row's free count; the
// rest add to dropped[h]. Push arrays are [NP, H] (payload [NP, H, P]);
// `preserve` may be null (no reserves). The bucketed variant then folds the
// landed pushes into their blocks' caches: (bt, bo) lexicographic min with
// the pushed keys (the reference's running 2-way min, which is a min over
// the set) and bfill += pushes landed in the block.
template <bool kBucketed>
__global__ void push_many_kernel(long long* __restrict__ t, long long* __restrict__ order,
                                 int* __restrict__ kind, int* __restrict__ payload,
                                 long long* __restrict__ dropped, long long* __restrict__ bt,
                                 long long* __restrict__ bo, int* __restrict__ bfill,
                                 const bool* __restrict__ pmask, const long long* __restrict__ pt,
                                 const long long* __restrict__ po, const int* __restrict__ pk,
                                 const int* __restrict__ pp, const int* __restrict__ preserve,
                                 int H, int C, int P, int NP, int B) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  // 1. free count of the row
  int free_count = 0;
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int c = c0 + lane;
    const bool f = c < C && t[base + c] == kTimeMax;
    free_count += __popc(__ballot_sync(kFull, f));
  }
  // 2. which pushes fire and fit (uniform across the warp): firing push
  //    number k (k < n_ok) is pushes[src[k]]
  int n_ok = 0, n_drop = 0;
  int src[kMaxPorts];
  for (int p = 0; p < NP; ++p) {
    const long long i = (long long)p * H + h;
    if (pmask[i]) {
      const int reserve = preserve ? preserve[i] : 0;
      if (n_ok + reserve < free_count) src[n_ok++] = p;
      else ++n_drop;
    }
  }
  if (lane == 0 && n_drop) dropped[h] += n_drop;
  if (n_ok == 0) return;
  // 3. one pass over the row: the slot of free rank r < n_ok gets push
  //    src[r]; bit k of `wrote` marks this lane's slot in chunk k
  unsigned wrote = 0;
  int rank0 = 0;
  for (int c0 = 0, k = 0; c0 < C && rank0 < n_ok; c0 += kWarp, ++k) {
    const int c = c0 + lane;
    const bool f = c < C && t[base + c] == kTimeMax;
    const unsigned bal = __ballot_sync(kFull, f);
    const int r = rank0 + __popc(bal & ((1u << lane) - 1u));
    if (f && r < n_ok) {
      const long long i = (long long)src[r] * H + h;
      t[base + c] = pt[i];
      order[base + c] = po[i];
      kind[base + c] = pk[i];
      for (int w = 0; w < P; ++w) payload[(base + c) * P + w] = pp[i * P + w];
      wrote |= 1u << k;
    }
    rank0 += __popc(bal);
  }
  if (!kBucketed) return;
  // 4. block caches of the blocks that received a push
  const int NB = C / B;
  unsigned touched = 0;
  for (unsigned w = wrote; w; w &= w - 1) touched |= 1u << (((__ffs(w) - 1) * kWarp + lane) / B);
  touched = __reduce_or_sync(kFull, touched);
  for (unsigned tb = touched; tb; tb &= tb - 1) {
    const int j = __ffs(tb) - 1;
    long long mt = kTimeMax, mo = kOrderMax;
    int cnt = 0;
    for (unsigned w = wrote; w; w &= w - 1) {
      const int c = (__ffs(w) - 1) * kWarp + lane;
      if (c / B == j) {
        ++cnt;
        const long long vt = t[base + c], vo = order[base + c];
        if (lex_less(vt, vo, mt, mo)) { mt = vt; mo = vo; }
      }
    }
    warp_lexmin(mt, mo);
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) {
      const long long bi = (long long)h * NB + j;
      if (lex_less(mt, mo, bt[bi], bo[bi])) { bt[bi] = mt; bo[bi] = mo; }
      bfill[bi] += cnt;
    }
  }
}

// K5: peek each host's K earliest events: round j takes the lexicographic
// (t, order, slot) minimum over the slots not taken by rounds < j (live keys
// are unique; the slot index only orders the empty sentinels). Column j is
// active iff its time is below the host's limit (`limits[h]`, or the scalar
// `limit` where `limits` is null; a prefix: times ascend). Nothing is
// written to the slab. Bit k of `taken` marks this lane's slot in chunk k.
__global__ void pop_k_kernel(const long long* __restrict__ t, const long long* __restrict__ order,
                             const int* __restrict__ kind, const int* __restrict__ payload,
                             long long limit, const long long* __restrict__ limits,
                             long long* __restrict__ out_t,
                             long long* __restrict__ out_order, int* __restrict__ out_kind,
                             int* __restrict__ out_payload, bool* __restrict__ out_active,
                             int* __restrict__ out_idx, int H, int C, int P, int K) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  const long long lim = limits ? limits[h] : limit;
  unsigned taken = 0;
  for (int j = 0; j < K; ++j) {
    long long bt = kTimeMax, bo = kOrderMax;
    int bi = 0x7fffffff;
    for (int c0 = 0, k = 0; c0 < C; c0 += kWarp, ++k) {
      const int c = c0 + lane;
      if (c < C && !(taken >> k & 1u)) {
        const long long vt = t[base + c], vo = order[base + c];
        if (lex_less3(vt, vo, c, bt, bo, bi)) { bt = vt; bo = vo; bi = c; }
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const long long ot = __shfl_xor_sync(kFull, bt, off);
      const long long oo = __shfl_xor_sync(kFull, bo, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (lex_less3(ot, oo, oi, bt, bo, bi)) { bt = ot; bo = oo; bi = oi; }
    }
    // K <= C, so an untaken slot always exists and bi is a real slot
    if ((bi & (kWarp - 1)) == lane) taken |= 1u << (bi / kWarp);
    const bool act = bt < lim;
    const long long o = (long long)h * K + j;
    if (lane < P) out_payload[o * P + lane] = act ? payload[(base + bi) * P + lane] : 0;
    if (lane == 0) {
      out_t[o] = act ? bt : kTimeMax;
      out_order[o] = act ? bo : kOrderMax;
      out_kind[o] = act ? kind[base + bi] : 0;
      out_active[o] = act;
      out_idx[o] = bi;
    }
  }
}

// K6: clear the first m[h] active batch slots of a K5 peek. Bucketed: each
// block that lost a slot gets its (bt, bo) recomputed from its B slots and
// its bfill reduced by the slots it lost; untouched blocks are not written.
template <bool kBucketed>
__global__ void clear_popped_kernel(long long* __restrict__ t, long long* __restrict__ order,
                                    long long* __restrict__ bt, long long* __restrict__ bo,
                                    int* __restrict__ bfill, const bool* __restrict__ active,
                                    const int* __restrict__ idx, const int* __restrict__ m,
                                    int H, int C, int K, int B) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  const bool take = lane < K && active[(long long)h * K + lane] && lane < m[h];
  const int c = take ? idx[(long long)h * K + lane] : 0;
  if (take) {
    t[base + c] = kTimeMax;
    order[base + c] = kOrderMax;
  }
  if (!kBucketed) return;
  __syncwarp();  // the clears are visible to every lane of the warp
  const int NB = C / B;
  const unsigned touched = __reduce_or_sync(kFull, take ? 1u << (c / B) : 0u);
  for (unsigned tb = touched; tb; tb &= tb - 1) {
    const int j = __ffs(tb) - 1;
    const int lost = __popc(__ballot_sync(kFull, take && c / B == j));
    long long mt = kTimeMax, mo = kOrderMax;
    for (int s = lane; s < B; s += kWarp) {
      const long long vt = t[base + j * B + s], vo = order[base + j * B + s];
      if (lex_less(vt, vo, mt, mo)) { mt = vt; mo = vo; }
    }
    warp_lexmin(mt, mo);
    if (lane == 0) {
      const long long bi = (long long)h * NB + j;
      bt[bi] = mt;
      bo[bi] = mo;
      bfill[bi] -= lost;
    }
  }
}

// K12: cancel the live slot whose order key equals key[h], for each masked
// host (keys are unique, so at most one slot matches; a miss changes
// nothing). Hit slots are cleared to the empty sentinel; each block that
// lost a slot gets its (bt, bo) recomputed from its B slots and its bfill
// reduced by the slots it lost. found[h] = any hit. Bit k of `hits` marks
// this lane's slot in chunk k.
__global__ void wheel_cancel_kernel(long long* __restrict__ t, long long* __restrict__ order,
                                    long long* __restrict__ bt, long long* __restrict__ bo,
                                    int* __restrict__ bfill, const bool* __restrict__ mask,
                                    const long long* __restrict__ key, bool* __restrict__ found,
                                    int H, int C, int B) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  const bool m = mask[h];
  const long long kh = key[h];
  unsigned hits = 0, touched = 0;
  for (int c0 = 0, k = 0; c0 < C; c0 += kWarp, ++k) {
    const int c = c0 + lane;
    if (m && c < C && order[base + c] == kh && t[base + c] != kTimeMax) {
      t[base + c] = kTimeMax;
      order[base + c] = kOrderMax;
      hits |= 1u << k;
      touched |= 1u << (c / B);
    }
  }
  touched = __reduce_or_sync(kFull, touched);
  if (lane == 0) found[h] = touched != 0;
  if (!touched) return;
  __syncwarp();  // the clears are visible to every lane of the warp
  const int NB = C / B;
  for (unsigned tb = touched; tb; tb &= tb - 1) {
    const int j = __ffs(tb) - 1;
    int lost = 0;
    for (unsigned w = hits; w; w &= w - 1) lost += ((__ffs(w) - 1) * kWarp + lane) / B == j;
    lost = __reduce_add_sync(kFull, lost);
    long long mt = kTimeMax, mo = kOrderMax;
    for (int s = lane; s < B; s += kWarp) {
      const long long vt = t[base + j * B + s], vo = order[base + j * B + s];
      if (lex_less(vt, vo, mt, mo)) { mt = vt; mo = vo; }
    }
    warp_lexmin(mt, mo);
    if (lane == 0) {
      const long long bi = (long long)h * NB + j;
      bt[bi] = mt;
      bo[bi] = mo;
      bfill[bi] -= lost;
    }
  }
}

// K8: (bt, bo, bfill) of every block, from the slab. With B <= 32 one pass
// covers 32 / B whole blocks: lane l reads slot pass_start + l and a
// segmented shuffle-down reduction within each run of B lanes leaves the
// block's minimum in its first lane; the live count is a popcount of the
// segment's ballot bits. With B > 32 each block is one strided warp
// reduction.
__global__ void block_minima_kernel(const long long* __restrict__ t,
                                    const long long* __restrict__ order,
                                    long long* __restrict__ bt, long long* __restrict__ bo,
                                    int* __restrict__ bfill, int H, int C, int B) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  const int NB = C / B;
  if (B <= kWarp) {
    const int per_pass = kWarp / B;  // whole blocks per pass
    const int seg = lane / B, pos = lane - seg * B;
    for (int j0 = 0; j0 < NB; j0 += per_pass) {
      const int j = j0 + seg;
      const bool mine = seg < per_pass && j < NB;
      long long vt = kTimeMax, vo = kOrderMax;
      if (mine) {
        vt = t[base + (long long)j * B + pos];
        vo = order[base + (long long)j * B + pos];
      }
      const unsigned live = __ballot_sync(kFull, mine && vt != kTimeMax);
      for (int off = 1; off < B; off <<= 1) {
        const long long ot = __shfl_down_sync(kFull, vt, off);
        const long long oo = __shfl_down_sync(kFull, vo, off);
        if (pos + off < B && lex_less(ot, oo, vt, vo)) { vt = ot; vo = oo; }
      }
      if (mine && pos == 0) {
        const unsigned segmask = (B == kWarp ? kFull : ((1u << B) - 1u)) << (seg * B);
        bt[(long long)h * NB + j] = vt;
        bo[(long long)h * NB + j] = vo;
        bfill[(long long)h * NB + j] = __popc(live & segmask);
      }
    }
  } else {
    for (int j = 0; j < NB; ++j) {
      long long mt = kTimeMax, mo = kOrderMax;
      int cnt = 0;
      for (int s = lane; s < B; s += kWarp) {
        const long long vt = t[base + (long long)j * B + s], vo = order[base + (long long)j * B + s];
        cnt += vt != kTimeMax;
        if (lex_less(vt, vo, mt, mo)) { mt = vt; mo = vo; }
      }
      warp_lexmin(mt, mo);
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) {
        bt[(long long)h * NB + j] = mt;
        bo[(long long)h * NB + j] = mo;
        bfill[(long long)h * NB + j] = cnt;
      }
    }
  }
}

// K25: re-seat each host's slots into new [H, C2] planes, or write the
// host's live-slot count. C2 >= C: every slot keeps its column (kind and
// payload of empty slots as they were) and the tail is padded with the empty
// sentinel and zero kind/payload. C2 < C: the reference's stable argsort on
// "slot is empty" -- the live slots first, in column order, then the empty
// slots in column order -- truncated to C2 (lossless iff live <= C2, which
// the callers check first). With out_t null only the live count is written;
// with live null only the planes.
__global__ void migrate_kernel(const long long* __restrict__ t, const long long* __restrict__ order,
                               const int* __restrict__ kind, const int* __restrict__ payload,
                               long long* __restrict__ out_t, long long* __restrict__ out_order,
                               int* __restrict__ out_kind, int* __restrict__ out_payload,
                               int* __restrict__ live, int H, int C, int C2, int P) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int h = host_of_warp();
  if (h >= H) return;
  const long long base = (long long)h * C;
  const long long obase = (long long)h * C2;
  int n_live = 0;
  if (live != nullptr || C2 < C) {
    for (int c = lane; c < C; c += kWarp) n_live += t[base + c] != kTimeMax;
    n_live = __reduce_add_sync(kFull, n_live);
  }
  if (live != nullptr && lane == 0) live[h] = n_live;
  if (out_t == nullptr) return;
  if (C2 >= C) {
    for (int c = lane; c < C2; c += kWarp) {
      const long long o = obase + c;
      if (c < C) {
        out_t[o] = t[base + c];
        out_order[o] = order[base + c];
        out_kind[o] = kind[base + c];
        for (int p = 0; p < P; ++p) out_payload[o * P + p] = payload[(base + c) * P + p];
      } else {
        out_t[o] = kTimeMax;
        out_order[o] = kOrderMax;
        out_kind[o] = 0;
        for (int p = 0; p < P; ++p) out_payload[o * P + p] = 0;
      }
    }
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  int seen_live = 0, seen_empty = 0;
  for (int c0 = 0; c0 < C; c0 += kWarp) {
    const int c = c0 + lane;
    const bool valid = c < C;
    const bool is_live = valid && t[base + c] != kTimeMax;
    const unsigned lm = __ballot_sync(kFull, is_live);
    const unsigned em = __ballot_sync(kFull, valid && !is_live);
    const int dst = is_live ? seen_live + __popc(lm & below)
                            : n_live + seen_empty + __popc(em & below);
    if (valid && dst < C2) {
      const long long o = obase + dst;
      out_t[o] = t[base + c];
      out_order[o] = order[base + c];
      out_kind[o] = kind[base + c];
      for (int p = 0; p < P; ++p) out_payload[o * P + p] = payload[(base + c) * P + p];
    }
    seen_live += __popc(lm);
    seen_empty += __popc(em);
  }
}

inline int blocks_for(int H) { return (H + kWarpsPerBlock - 1) / kWarpsPerBlock; }
constexpr int kThreads = kWarpsPerBlock * kWarp;

inline bool bad_block(int C, int B) { return B <= 0 || C % B != 0 || C / B > kWarp; }

}  // namespace

extern "C" {

int queue_next_time(const long long* t, const long long* floor, long long* out, int H, int C,
                    const long long* down_t, const long long* up_t, int W, void* stream) {
  if (down_t != nullptr && (up_t == nullptr || W < 1)) return (int)cudaErrorInvalidValue;
  if (H > 0)
    next_time_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(t, floor, out, H, C,
                                                                           down_t, up_t, W);
  return (int)cudaGetLastError();
}

int queue_pop_min(long long* t, long long* order, const int* kind, const int* payload,
                  long long limit, const long long* limits, long long* ev_t, long long* ev_order,
                  int* ev_kind, int* ev_payload, bool* active, int H, int C, int P,
                  void* stream) {
  if (P > kWarp) return (int)cudaErrorInvalidValue;
  if (H > 0)
    pop_min_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, kind, payload, limit, limits, ev_t, ev_order, ev_kind, ev_payload, active, H,
        C, P);
  return (int)cudaGetLastError();
}

int queue_push_many(long long* t, long long* order, int* kind, int* payload, long long* dropped,
                    const bool* pmask, const long long* pt, const long long* po, const int* pk,
                    const int* pp, const int* preserve, int H, int C, int P, int NP,
                    void* stream) {
  if (NP > kMaxPorts || C > kWarp * kWarp) return (int)cudaErrorInvalidValue;
  if (H > 0 && NP > 0)
    push_many_kernel<false><<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, kind, payload, dropped, nullptr, nullptr, nullptr, pmask, pt, po, pk, pp,
        preserve, H, C, P, NP, C);
  return (int)cudaGetLastError();
}

int queue_push_many_bucketed(long long* t, long long* order, int* kind, int* payload,
                             long long* dropped, long long* bt, long long* bo, int* bfill,
                             const bool* pmask, const long long* pt, const long long* po,
                             const int* pk, const int* pp, const int* preserve, int H, int C,
                             int P, int NP, int B, void* stream) {
  if (NP > kMaxPorts || C > kWarp * kWarp || bad_block(C, B)) return (int)cudaErrorInvalidValue;
  if (H > 0 && NP > 0)
    push_many_kernel<true><<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, kind, payload, dropped, bt, bo, bfill, pmask, pt, po, pk, pp, preserve, H, C,
        P, NP, B);
  return (int)cudaGetLastError();
}

int queue_pop_k(const long long* t, const long long* order, const int* kind, const int* payload,
                long long limit, const long long* limits, long long* out_t, long long* out_order, int* out_kind,
                int* out_payload, bool* out_active, int* out_idx, int H, int C, int P, int K,
                void* stream) {
  if (P > kWarp || K > kWarp || K > C || C > kWarp * kWarp) return (int)cudaErrorInvalidValue;
  if (H > 0 && K > 0)
    pop_k_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, kind, payload, limit, limits, out_t, out_order, out_kind, out_payload,
        out_active, out_idx, H, C, P, K);
  return (int)cudaGetLastError();
}

// B == 0: flat queue (bt/bo/bfill unused)
int queue_clear_popped(long long* t, long long* order, long long* bt, long long* bo, int* bfill,
                       const bool* active, const int* idx, const int* m, int H, int C, int K,
                       int B, void* stream) {
  if (K > kWarp || (B != 0 && bad_block(C, B))) return (int)cudaErrorInvalidValue;
  if (H > 0 && K > 0) {
    if (B == 0)
      clear_popped_kernel<false><<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
          t, order, nullptr, nullptr, nullptr, active, idx, m, H, C, K, C);
    else
      clear_popped_kernel<true><<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
          t, order, bt, bo, bfill, active, idx, m, H, C, K, B);
  }
  return (int)cudaGetLastError();
}

int queue_wheel_cancel(long long* t, long long* order, long long* bt, long long* bo, int* bfill,
                       const bool* mask, const long long* key, bool* found, int H, int C, int B,
                       void* stream) {
  if (C > kWarp * kWarp || bad_block(C, B)) return (int)cudaErrorInvalidValue;
  if (H > 0)
    wheel_cancel_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, bt, bo, bfill, mask, key, found, H, C, B);
  return (int)cudaGetLastError();
}

int queue_block_minima(const long long* t, const long long* order, long long* bt, long long* bo,
                       int* bfill, int H, int C, int B, void* stream) {
  if (B <= 0 || C % B != 0) return (int)cudaErrorInvalidValue;
  if (H > 0)
    block_minima_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, bt, bo, bfill, H, C, B);
  return (int)cudaGetLastError();
}

// out_t == nullptr: the live count only (migration_fits); live == nullptr:
// the re-seated planes only (migrate_queue)
int queue_migrate(const long long* t, const long long* order, const int* kind, const int* payload,
                  long long* out_t, long long* out_order, int* out_kind, int* out_payload,
                  int* live, int H, int C, int C2, int P, void* stream) {
  if (C < 1 || P > kWarp || (out_t == nullptr) == (live == nullptr) ||
      (out_t != nullptr && C2 < 1))
    return (int)cudaErrorInvalidValue;
  if (H > 0)
    migrate_kernel<<<blocks_for(H), kThreads, 0, (cudaStream_t)stream>>>(
        t, order, kind, payload, out_t, out_order, out_kind, out_payload, live, H, C, C2, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
