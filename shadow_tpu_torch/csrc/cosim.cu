// K35 guarded_window: the co-simulation bridge's guarded round loop test
// and the round's window, in one launch. Plain C interface (ctypes); the
// entry point launches on the stream it is given and returns
// cudaGetLastError().
//
// Replaces (JAX reference): shadow_tpu/core/engine.py:1664
// _run_guarded_chunk (its loop condition, with _compute_window :1719 of the
// round it admits) (B26). The loop runs rounds while the state is not done,
// fewer than effective_rounds_per_chunk rounds have run (both counted on
// the host), the global minimum of the effective next event times is below
// `until`, no capture ring holds a delivery (the bridge's stop probe,
// any(cap_n > 0)) and no stop lane (the first merge-gear shed, sentinel
// violation or capacity drop) has grown past its chunk-entry value.
//
// Inputs: the effective next time per host (K1's lane, with the CPU-model
// busy floor and the crash-restart floor already applied: i64 [H]),
// cap_n (i32 [H]), until, the stop time, the static runahead (the bridge
// runs no dynamic one), and up to three stop lanes as (current i64 [1],
// entry value i64 [1]) pairs. Output: one i64 lane [7]:
//   0 window_end = min(min(gmin, stop) + runahead, stop)
//   1 done       = gmin >= stop
//   2 probe      = any(cap_n > 0)
//   3 below      = gmin < until
//   4 stopped    = some stop lane grew
//   5 go         = below && !probe && !stopped
//   6 gmin
// so one device-to-host read per round serves both the loop test and the
// window, as compute_window's one read does in a solo run.
//
// What bounds it on an H100: H * 12 bytes read (4,096 hosts: 49 KB, 15 ns
// at 3.35 TB/s) and H compares: one latency-bound launch. Design: one block
// of 1,024 threads strides over the hosts, reduces the minimum and the OR
// with warp shuffles and one shared-memory level; thread 0 writes the
// lane. Min and OR are order-free, so the result is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr int kMaxStops = 3;

struct GuardArgs {
  int H;
  const long long* next_t;
  const int* cap_n;
  long long until, stop_time, runahead;
  int n_stops;
  const long long* cur[kMaxStops];
  const long long* entry[kMaxStops];
  long long* out;
};

__global__ void guarded_window_kernel(const GuardArgs a) {
  __shared__ long long s_min[kWarps];
  __shared__ int s_any[kWarps];
  long long m = kTimeMax;
  int any = 0;
  for (int h = threadIdx.x; h < a.H; h += kThreads) {
    const long long t = a.next_t[h];
    m = t < m ? t : m;
    any |= a.cap_n[h] > 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long om = __shfl_down_sync(0xffffffffu, m, o);
    m = om < m ? om : m;
    any |= __shfl_down_sync(0xffffffffu, any, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_min[warp] = m;
    s_any[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    m = s_min[w] < m ? s_min[w] : m;
    any |= s_any[w];
  }
  const long long gmin = m;
  const bool done = gmin >= a.stop_time;
  const long long safe = gmin < a.stop_time ? gmin : a.stop_time;
  // safe + runahead cannot wrap: safe <= stop_time < 2^62 and the runahead
  // is a latency
  const long long wend_raw = safe + a.runahead;
  const long long wend = wend_raw < a.stop_time ? wend_raw : a.stop_time;
  bool stopped = false;
  for (int i = 0; i < a.n_stops; ++i) stopped = stopped || *a.cur[i] > *a.entry[i];
  const bool below = gmin < a.until;
  a.out[0] = wend;
  a.out[1] = done;
  a.out[2] = any != 0;
  a.out[3] = below;
  a.out[4] = stopped;
  a.out[5] = below && !any && !stopped;
  a.out[6] = gmin;
}

struct Reader {
  const long long* a;
  int i;
  template <class T>
  T* p() { return reinterpret_cast<T*>(a[i++]); }
  long long v() { return a[i++]; }
};

}  // namespace

extern "C" {

// args = H, next_t, cap_n, until, stop_time, runahead, the stop-lane count,
// then (cur, entry) per stop lane, and out.
int guarded_window(const long long* args, void* stream) {
  Reader r{args, 0};
  GuardArgs a;
  a.H = (int)r.v();
  a.next_t = r.p<const long long>();
  a.cap_n = r.p<const int>();
  a.until = r.v();
  a.stop_time = r.v();
  a.runahead = r.v();
  a.n_stops = (int)r.v();
  if (a.H < 0 || a.n_stops < 0 || a.n_stops > kMaxStops) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.n_stops; ++i) {
    a.cur[i] = r.p<const long long>();
    a.entry[i] = r.p<const long long>();
  }
  a.out = r.p<long long>();
  guarded_window_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
