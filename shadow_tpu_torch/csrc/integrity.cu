// K24 integrity_round_check: the integrity sentinel's per-round invariant
// guards. Plain C interface (ctypes); the entry point launches on the stream
// it is given and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K24 shadow_tpu/core/engine.py:2050 _integrity_round_check   (B15)
//       as the round calls it, :1911-1930 (the count, the bitmask and the
//       first violating round folded into stats.integrity / iv_mask /
//       iv_round)
//
// One kernel, three stages over one [5 + n_lanes * H] int64 scratch that
// the engine keeps across rounds:
//   stage 0 (a chunk's first round, at entry): copy the counter lanes into
//           the scratch's entry rows and take the raw minimum of the queue's
//           (and the wheel's) time plane: the round's entry reads;
//   stage 1 (after the microsteps, before the exchange): IV_QFILL (a
//           bucketed slab's live slots against its fill caches, queue and
//           wheel; the merge rebuilds the caches, so it is judged here, as
//           :2127-2139 does) and IV_OUTBOX (send cursors within [0, budget],
//           the count word within [0, H x budget]);
//   stage 2 (after the exchange): IV_TIME (no slot below the entry minimum;
//           under static runahead with strict time, no window below the
//           committed time), IV_COUNTER (no counter lane below its entry
//           value or below 0; the wheel's drop lane 0), IV_DIGEST (a host
//           with no executed event still holds both digests' offsets); then
//           the last block folds the round's bits (zeroed on the
//           done-round) into the stats lanes and turns the post-exchange
//           reads into the next round's entry reads, so a round costs two
//           launches and a chunk one more.
//
// Scratch layout (int64): [0] the entry minimum, [1] the round's bits so
// far, [2] the entry round count, [3] the blocks finished (the last-block
// handshake), [4] the next entry minimum being reduced (TIME_MAX at rest),
// then n_lanes rows of [H] entry counter values. The engine fills it once
// (slots 1 and 3 zero, 4 TIME_MAX); each stage 0 and 2 leaves it so.
//
// What bounds it on an H100: memory traffic, one pass over the time plane
// (H = 10,000, C = 28: 2.2 MB) and the counter lanes (n_lanes x 80 KB) per
// stage; warp-shuffle minima and one atomic per block. The bits and the
// minimum are order-free (OR, min), so the result cannot depend on
// scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 12;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr unsigned long long kFnvOffset = 0xCBF29CE484222325ULL;
constexpr unsigned long long kDigest2Offset = 0x9AE16A3B2F90404FULL;
// invariant bits (core/integrity.py IV_*)
constexpr long long kIvTime = 1LL << 0;
constexpr long long kIvQfill = 1LL << 2;
constexpr long long kIvCounter = 1LL << 3;
constexpr long long kIvOutbox = 1LL << 4;
constexpr long long kIvDigest = 1LL << 5;
// the wheel's fill-cache check: reported as IV_QFILL, but counted as a
// check of its own (the reference counts each failed check once)
constexpr long long kIvQfillWheel = 1LL << 62;

struct Args {
  int stage, H, C, S, n_lanes, strict_time, done, budget, q_nb, w_nb;
  long long window_end, now0;
  // the queue's and the wheel's time planes [H, C], [H, S] (wheel null when
  // off) and their fill caches [H, NB] (null for a flat queue)
  const long long* q_t;
  const long long* w_t;
  const int* q_bfill;
  const int* w_bfill;
  // counter lanes [H]: events first
  const long long* lanes[kMaxLanes];
  const long long* wheel_dropped;
  const int* sent_round;
  const int* ob_count;
  const unsigned long long* digest;
  const unsigned long long* digest2;  // null without the dual digest
  const long long* rounds;
  long long* integrity;
  long long* iv_mask;
  long long* iv_round;
  long long* scratch;
};

__device__ long long block_min(long long v) {
  __shared__ long long part[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long m = kTimeMax;
  for (int w = 0; w < kThreads / 32; ++w) m = part[w] < m ? part[w] : m;
  return m;
}

__device__ long long row_min(const long long* row, int n) {
  long long m = kTimeMax;
  for (int c = 0; c < n; ++c) m = row[c] < m ? row[c] : m;
  return m;
}

__device__ bool fill_mismatch(const long long* t, const int* bfill, int n, int nb) {
  int live = 0, cached = 0;
  for (int c = 0; c < n; ++c) live += t[c] != kTimeMax;
  for (int b = 0; b < nb; ++b) cached += bfill[b];
  return live != cached;
}

__global__ void integrity_kernel(const Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = h < a.H;
  const long long H = a.H;
  long long* entry = a.scratch + 5;
  auto* s_u = reinterpret_cast<unsigned long long*>(a.scratch);
  long long bits = 0;
  long long m = kTimeMax;
  if (a.stage == 1) {
    if (on) {
      if (a.q_bfill != nullptr &&
          fill_mismatch(a.q_t + h * (long long)a.C, a.q_bfill + h * (long long)a.q_nb, a.C,
                        a.q_nb))
        bits |= kIvQfill;
      if (a.w_bfill != nullptr &&
          fill_mismatch(a.w_t + h * (long long)a.S, a.w_bfill + h * (long long)a.w_nb, a.S,
                        a.w_nb))
        bits |= kIvQfillWheel;
      const int sr = a.sent_round[h];
      if (sr > a.budget || sr < 0) bits |= kIvOutbox;
    }
    if (h == 0) {
      const long long count = a.ob_count[0];
      if (count < 0 || count > H * a.budget) bits |= kIvOutbox;
    }
    if (bits) atomicOr(s_u + 1, (unsigned long long)bits);
    return;
  }
  if (on) {
    m = row_min(a.q_t + h * (long long)a.C, a.C);
    if (a.w_t != nullptr) {
      const long long wm = row_min(a.w_t + h * (long long)a.S, a.S);
      m = wm < m ? wm : m;
    }
    if (a.stage == 0) {
      for (int k = 0; k < a.n_lanes; ++k) entry[k * H + h] = a.lanes[k][h];
    } else {
      if (m < a.scratch[0]) bits |= kIvTime;
      for (int k = 0; k < a.n_lanes; ++k) {
        const long long post = a.lanes[k][h];
        if (post < entry[k * H + h] || post < 0) bits |= kIvCounter;
        entry[k * H + h] = post;  // the next round's entry value
      }
      if (a.wheel_dropped != nullptr && a.wheel_dropped[h] != 0) bits |= kIvCounter;
      if (a.lanes[0][h] == 0 &&
          (a.digest[h] != kFnvOffset || (a.digest2 != nullptr && a.digest2[h] != kDigest2Offset)))
        bits |= kIvDigest;
    }
  }
  if (a.stage == 2 && h == 0 && a.strict_time && a.window_end < a.now0) bits |= kIvTime;
  if (bits) atomicOr(s_u + 1, (unsigned long long)bits);
  m = block_min(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicMin(a.scratch + 4, m);
    __threadfence();
    last = atomicAdd(s_u + 3, 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  if (a.stage == 2) {
    long long b = (long long)atomicOr(s_u + 1, 0ULL);
    if (a.done) b = 0;
    if (b) {
      a.integrity[0] += __popcll((unsigned long long)b);
      if (b & kIvQfillWheel) b = (b & ~kIvQfillWheel) | kIvQfill;
      a.iv_mask[0] |= b;
      if (a.iv_round[0] < 0) a.iv_round[0] = a.scratch[2];
    }
  }
  a.scratch[0] = atomicMin(a.scratch + 4, kTimeMax);
  a.scratch[4] = kTimeMax;
  a.scratch[1] = 0;
  a.scratch[2] = a.rounds[0];
  a.scratch[3] = 0;
}

}  // namespace

extern "C" {

// args: stage, H, C, S, n_lanes, strict_time, done, budget, q_nb, w_nb,
// window_end, now0, q_t, w_t, q_bfill, w_bfill, lanes[n_lanes],
// wheel_dropped, sent_round, ob_count, digest, digest2, rounds, integrity,
// iv_mask, iv_round, scratch
int integrity_round_check(const long long* v, void* stream) {
  Args a;
  int i = 0;
  a.stage = (int)v[i++];
  a.H = (int)v[i++];
  a.C = (int)v[i++];
  a.S = (int)v[i++];
  a.n_lanes = (int)v[i++];
  a.strict_time = (int)v[i++];
  a.done = (int)v[i++];
  a.budget = (int)v[i++];
  a.q_nb = (int)v[i++];
  a.w_nb = (int)v[i++];
  a.window_end = v[i++];
  a.now0 = v[i++];
  a.q_t = reinterpret_cast<const long long*>(v[i++]);
  a.w_t = reinterpret_cast<const long long*>(v[i++]);
  a.q_bfill = reinterpret_cast<const int*>(v[i++]);
  a.w_bfill = reinterpret_cast<const int*>(v[i++]);
  if (a.stage < 0 || a.stage > 2 || a.n_lanes < 1 || a.n_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a.n_lanes; ++k) a.lanes[k] = reinterpret_cast<const long long*>(v[i++]);
  a.wheel_dropped = reinterpret_cast<const long long*>(v[i++]);
  a.sent_round = reinterpret_cast<const int*>(v[i++]);
  a.ob_count = reinterpret_cast<const int*>(v[i++]);
  a.digest = reinterpret_cast<const unsigned long long*>(v[i++]);
  a.digest2 = reinterpret_cast<const unsigned long long*>(v[i++]);
  a.rounds = reinterpret_cast<const long long*>(v[i++]);
  a.integrity = reinterpret_cast<long long*>(v[i++]);
  a.iv_mask = reinterpret_cast<long long*>(v[i++]);
  a.iv_round = reinterpret_cast<long long*>(v[i++]);
  a.scratch = reinterpret_cast<long long*>(v[i++]);
  if (a.H < 1 || a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  integrity_kernel<<<(a.H + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
