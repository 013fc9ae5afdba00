// The pressure plane's per-round signal. Plain C interface (ctypes); the entry
// point launches on the stream it is given and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K26 shadow_tpu/core/engine.py:1896-1910 (the pressure signal in _round_step):
//       out[0] = sum(queue.dropped[H]) + sum(stats.pkts_budget_dropped[H])
//                + stats.ob_dropped[0] (+ stats.a2a_shed[0], which is 0 on one
//                device), the run's cumulative capacity-drop total that the
//                chunk loop's first-drop stop compares with its entry value.
//
// What bounds it on an H100: it reads two int64 [H] lanes once (H = 4,096 at
// bench config 9: 64 KB), so the bound is bytes / 3.35 TB/s, far below one
// launch. Design: one block of 1,024 threads, strided partial sums, a warp
// butterfly and one pass over the 32 warp sums in shared memory. Integer
// addition is exact and associative, so the total does not depend on the
// order of the partial sums: the result equals the plain version's bit for
// bit. One launch per round, after the exchange, only under the escalate and
// abort policies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long warp_sum(long long s) {
  for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__global__ void pressure_total_kernel(const long long* __restrict__ dropped,
                                      const long long* __restrict__ budget,
                                      const long long* __restrict__ ob_dropped,
                                      long long* __restrict__ out, int H) {
  __shared__ long long part[kThreads / kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  long long s = 0;
  for (int i = threadIdx.x; i < H; i += kThreads) s += dropped[i] + budget[i];
  s = warp_sum(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(part[lane]);
    if (lane == 0) out[0] = s + ob_dropped[0];
  }
}

}  // namespace

extern "C" {

int pressure_total(const long long* dropped, const long long* budget,
                   const long long* ob_dropped, long long* out, int H, void* stream) {
  if (H < 0) return (int)cudaErrorInvalidValue;
  pressure_total_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(dropped, budget, ob_dropped,
                                                                   out, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
