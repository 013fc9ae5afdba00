// The observatories' device programs. Plain C interface (ctypes): each entry
// point takes one int64 argument block, launches on the stream it is given and
// returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K27 shadow_tpu/core/engine.py:1971 _trace_round (B16): one int64 row of
//       the 25 trace columns per completed round into the [1, R, 25] ring at
//       cursor % R, the cursor bumped. The counter columns are deltas of
//       cumulative lanes over the round; the round-entry values live in a
//       9-word scratch that a chunk's entry launch (mode 0) fills from the
//       state and every round's launch (mode 1) advances to its post-round
//       values, so no round needs a host read.
//   K28 shadow_tpu/core/engine.py:2661 _flow_append (B17) with the fl_* fold of
//       :2391-2404: a microstep's flow-completion entries (E event columns of
//       [H] record lanes, in order) go to the [1, R, 7] ledger ring with
//       host-major slots from an exclusive prefix sum over each entry's
//       completion mask, at (cursor + offset) % R; only the newest R
//       completions of one entry are written (offset >= n - R); the cursor
//       advances by n; fl_done, fl_bytes and fl_rtx add the entry's
//       completions, bytes and retransmits.
//
// What bounds them on an H100: bytes. K27 reads the [H] events, occupancy and
// (with faults) fault lanes and crash windows, and one queue-head plane (the
// slab's time plane, or a bucketed queue's block minima): about 0.5 MB at
// config 6's 10,000 hosts, 0.15 us at 3.35 TB/s, below one launch. K28 reads
// E x H x 49 bytes of record lanes (2 MB at config 6's K = 4 column). Design:
// one block of 1,024 threads each; K27 folds strided partial sums, maxima and
// minima through warp shuffles and one pass over the 32 warp results in shared
// memory (integer sums and extrema are exact in any order, so the row equals
// the plain version's bit for bit); K28 walks the entries in order and scans
// each mask a tile of 1,024 hosts at a time: a warp ballot and popc give each
// lane its offset inside its warp, a shared pass over the 32 warp counts the
// warp's offset inside the tile, and a running total carries tiles. A first
// pass counts the entry's completions (n), which the live test needs. One
// launch per completed round (K27) and one per microstep (K28), only with the
// trace or the flow ledger on.

#include <cstdint>
#include <cuda_runtime.h>

#include "faults.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr int kCols = 25;  // obs/tracer.py TRACE_COLS
constexpr int kFlowCols = 7;  // obs/netobs.py FLOW_COLS
constexpr int kScratch = 9;  // ops/obs.py SCRATCH_LANES
// trace columns (obs/tracer.py COL_*)
constexpr int kColRound = 0, kColWindowStart = 1, kColWindowEnd = 2, kColEvents = 3;
constexpr int kColMicrosteps = 4, kColPopk = 5, kColBq = 6, kColSends = 8;
constexpr int kColOcc = 10, kColNext = 11, kColObHwm = 12, kColGear = 13;
constexpr int kColFaultsDropped = 14, kColFaultsDelayed = 15, kColHostsDown = 16;
constexpr int kColCap = 17, kColEcTimer = 18, kColEcPkt = 19, kColEcApp = 20;
constexpr int kColFlows = 21;
// the scratch's lanes -> their row columns (ops/obs.py _SCRATCH_COLS)
__constant__ int kScratchCol[kScratch] = {kColEvents, kColPopk, kColBq, kColFaultsDropped,
                                          kColFaultsDelayed, kColEcTimer, kColEcPkt,
                                          kColEcApp, kColFlows};

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

__device__ __forceinline__ long long warp_sum(long long s) {
  for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__device__ __forceinline__ long long warp_max(long long s) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kFull, s, off);
    s = o > s ? o : s;
  }
  return s;
}

__device__ __forceinline__ long long warp_min(long long s) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kFull, s, off);
    s = o < s ? o : s;
  }
  return s;
}

// ---------------------------------------------------------------------------
// K27 trace_round
// ---------------------------------------------------------------------------

struct TraceArgs {
  int mode;  // 0: a chunk's entry (fill the scratch); 1: one completed round
  int H, R;
  long long* scratch;  // [9]
  // the cumulative lanes (null where the plane is off): events [H],
  // popk_deferred [1], bq_rebuilds [1], faults_dropped [H], faults_delayed [H],
  // ec_timer / ec_pkt / ec_app [1], fl_done [1]
  const long long* lane[kScratch];
  // mode 1: the round's inputs
  const long long* rounds;  // stats.rounds at the round's entry
  long long window_start, window_end, steps;
  const int* sends;  // the outbox count before the exchange [1]
  const long long* occ;  // [H]
  const long long* heads;  // the queue's head plane
  long long n_heads;
  const long long* ob_hwm;  // []
  long long gear, cap;
  int W;  // crash windows per host (0: no hosts_down column)
  const long long* down_t;
  const long long* up_t;
  long long* rows;  // [R, 25]
  long long* cursor;  // [1]
};

__device__ __forceinline__ bool host_lane(int k) { return k == 0 || k == 3 || k == 4; }

__global__ void trace_round_kernel(const TraceArgs a) {
  __shared__ long long part[5][kWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const bool round = a.mode == 1;
  // per-thread partials: the three [H] lanes' sums, the occupancy maximum,
  // the head minimum and the hosts inside a crash window at the round's end
  long long ev = 0, fd = 0, fy = 0, occ = 0, nxt = kTimeMax, down = 0;
  for (int h = threadIdx.x; h < a.H; h += kThreads) {
    ev += a.lane[0][h];
    if (a.lane[3] != nullptr) fd += a.lane[3][h];
    if (a.lane[4] != nullptr) fy += a.lane[4][h];
    if (round) {
      occ = a.occ[h] > occ ? a.occ[h] : occ;
      if (a.W > 0) {
        long long resume;
        down += flt::down_resume(a.down_t + (long long)h * a.W, a.up_t + (long long)h * a.W,
                                 a.W, a.window_end, resume);
      }
    }
  }
  if (round)
    for (long long i = threadIdx.x; i < a.n_heads; i += kThreads) nxt = a.heads[i] < nxt ? a.heads[i] : nxt;
  ev = warp_sum(ev);
  fd = warp_sum(fd);
  fy = warp_sum(fy);
  occ = warp_max(occ);
  nxt = warp_min(nxt);
  down = warp_sum(down);
  if (lane == 0) {
    part[0][warp] = ev;
    part[1][warp] = fd;
    part[2][warp] = fy;
    part[3][warp] = occ;
    part[4][warp] = nxt;
  }
  __shared__ long long down_part[kWarps];
  if (lane == 0) down_part[warp] = down;
  __syncthreads();
  if (warp != 0) return;
  ev = warp_sum(part[0][lane]);
  fd = warp_sum(part[1][lane]);
  fy = warp_sum(part[2][lane]);
  occ = warp_max(part[3][lane]);
  nxt = warp_min(part[4][lane]);
  down = warp_sum(down_part[lane]);
  if (lane != 0) return;
  long long cur[kScratch];
  for (int k = 0; k < kScratch; ++k) {
    if (host_lane(k))
      cur[k] = k == 0 ? ev : (k == 3 ? fd : fy);
    else
      cur[k] = a.lane[k] != nullptr ? a.lane[k][0] : 0;
  }
  if (round) {
    long long* row = a.rows + (a.cursor[0] % a.R) * kCols;
    for (int c = 0; c < kCols; ++c) row[c] = 0;
    row[kColRound] = a.rounds[0];
    row[kColWindowStart] = a.window_start;
    row[kColWindowEnd] = a.window_end;
    row[kColMicrosteps] = a.steps;
    row[kColSends] = (long long)a.sends[0];
    row[kColOcc] = occ;
    row[kColNext] = nxt;
    row[kColObHwm] = a.ob_hwm[0];
    row[kColGear] = a.gear;
    row[kColCap] = a.cap;
    if (a.W > 0) row[kColHostsDown] = down;
    for (int k = 0; k < kScratch; ++k) row[kScratchCol[k]] = cur[k] - a.scratch[k];
    a.cursor[0] += 1;
  }
  for (int k = 0; k < kScratch; ++k) a.scratch[k] = cur[k];
}

// ---------------------------------------------------------------------------
// K28 flow_append
// ---------------------------------------------------------------------------

struct FlowArgs {
  int H, E, R;
  // the entries' record lanes [E, H]
  const bool* mask;
  const long long* dst;
  const long long* flow;
  const long long* t_start;
  const long long* t_end;
  const long long* bytes;
  const long long* rtx;
  long long* rows;  // [R, 7]
  long long* cursor;  // [1]
  long long* fl_done;  // [1]
  long long* fl_bytes;  // [1]
  long long* fl_rtx;  // [1]
};

__global__ void flow_append_kernel(const FlowArgs a) {
  __shared__ long long part[3][kWarps];
  __shared__ int tile_ofs[kWarps];
  __shared__ long long total[3];
  __shared__ long long running;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  for (int e = 0; e < a.E; ++e) {
    const long long base = (long long)e * a.H;
    // pass 1: the entry's completions, bytes and retransmits
    long long n = 0, by = 0, rx = 0;
    for (int h = threadIdx.x; h < a.H; h += kThreads) {
      if (a.mask[base + h]) {
        n += 1;
        by += a.bytes[base + h];
        rx += a.rtx[base + h];
      }
    }
    n = warp_sum(n);
    by = warp_sum(by);
    rx = warp_sum(rx);
    if (lane == 0) {
      part[0][warp] = n;
      part[1][warp] = by;
      part[2][warp] = rx;
    }
    __syncthreads();
    if (warp == 0) {
      n = warp_sum(part[0][lane]);
      by = warp_sum(part[1][lane]);
      rx = warp_sum(part[2][lane]);
      if (lane == 0) {
        total[0] = n;
        total[1] = by;
        total[2] = rx;
        running = 0;
      }
    }
    __syncthreads();
    n = total[0];
    const long long cur = a.cursor[0];
    // pass 2: host-major slots, a tile of 1,024 hosts at a time
    for (int t0 = 0; t0 < a.H; t0 += kThreads) {
      const int h = t0 + threadIdx.x;
      const bool m = h < a.H && a.mask[base + h];
      const unsigned ballot = __ballot_sync(kFull, m);
      const int in_warp = __popc(ballot & ((1u << lane) - 1u));
      if (lane == 0) tile_ofs[warp] = __popc(ballot);
      __syncthreads();
      if (warp == 0) {
        // exclusive scan of the 32 warp counts
        const int c = tile_ofs[lane];
        int incl = c;
        for (int off = 1; off < kWarp; off <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += o;
        }
        tile_ofs[lane] = incl - c;
      }
      __syncthreads();
      const long long ofs = running + tile_ofs[warp] + in_warp;
      if (m && ofs >= n - a.R) {
        long long* row = a.rows + ((cur + ofs) % a.R) * kFlowCols;
        row[0] = (long long)h;
        row[1] = a.dst[base + h];
        row[2] = a.flow[base + h];
        row[3] = a.t_start[base + h];
        row[4] = a.t_end[base + h];
        row[5] = a.bytes[base + h];
        row[6] = a.rtx[base + h];
      }
      __syncthreads();
      if (threadIdx.x == kThreads - 1) running = ofs + (m ? 1 : 0);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      a.cursor[0] = cur + n;
      a.fl_done[0] += n;
      a.fl_bytes[0] += total[1];
      a.fl_rtx[0] += total[2];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int trace_round(const long long* args, void* stream) {
  Reader r{args, 0};
  TraceArgs a;
  a.mode = (int)r.v();
  a.H = (int)r.v();
  a.R = (int)r.v();
  a.scratch = r.p<long long>();
  for (int k = 0; k < kScratch; ++k) a.lane[k] = r.p<const long long>();
  a.rounds = r.p<const long long>();
  a.window_start = r.v();
  a.window_end = r.v();
  a.steps = r.v();
  a.sends = r.p<const int>();
  a.occ = r.p<const long long>();
  a.heads = r.p<const long long>();
  a.n_heads = r.v();
  a.ob_hwm = r.p<const long long>();
  a.gear = r.v();
  a.cap = r.v();
  a.W = (int)r.v();
  a.down_t = r.p<const long long>();
  a.up_t = r.p<const long long>();
  a.rows = r.p<long long>();
  a.cursor = r.p<long long>();
  if (a.H < 1 || a.lane[0] == nullptr || (a.mode == 1 && a.R < 1))
    return (int)cudaErrorInvalidValue;
  trace_round_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int flow_append(const long long* args, void* stream) {
  Reader r{args, 0};
  FlowArgs a;
  a.H = (int)r.v();
  a.E = (int)r.v();
  a.R = (int)r.v();
  a.mask = r.p<const bool>();
  a.dst = r.p<const long long>();
  a.flow = r.p<const long long>();
  a.t_start = r.p<const long long>();
  a.t_end = r.p<const long long>();
  a.bytes = r.p<const long long>();
  a.rtx = r.p<const long long>();
  a.rows = r.p<long long>();
  a.cursor = r.p<long long>();
  a.fl_done = r.p<long long>();
  a.fl_bytes = r.p<long long>();
  a.fl_rtx = r.p<long long>();
  if (a.H < 1 || a.E < 1 || a.R < 1) return (int)cudaErrorInvalidValue;
  flow_append_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
