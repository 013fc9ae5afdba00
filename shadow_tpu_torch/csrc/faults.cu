// K23 fault_down_resume: per host, whether a time falls in one of its crash
// windows and when that window ends. Plain C interface (ctypes); the entry
// point launches on the stream it is given and returns cudaGetLastError().
//
// Replaces (JAX reference):
//   K23 shadow_tpu/core/faults.py:266 down_and_resume   (B13)
// as the K-way fold calls it under queue-hold faults: at the busy-floored
// head before the peek (shadow_tpu/core/engine.py:2966-2969) and at each
// batch column's candidate execution time for the deferral test
// (:2992-3008). The same device function (csrc/faults.cuh) is a lane of K1
// (the barrier's floor) and of K10 (the hold and clear lanes).
//
// Layout: t is [H] with host stride `ts` (a column of the K-way peek, or a
// contiguous lane); down_t and up_t are [H, W] row-major; down is bool[H]
// and resume i64[H] (0 where the host is up).
//
// What bounds it on an H100: one thread per host reads W pairs of int64
// and writes 9 bytes; at H = 10,000 and W = 1 that is about 250 KB, under
// a tenth of a microsecond of memory traffic, so the launch latency sets
// its time. No shared memory, no cross-host writes.

#include <cuda_runtime.h>

#include "faults.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void down_resume_kernel(int H, int W, long long ts, const long long* t,
                                   const long long* down_t, const long long* up_t, bool* down,
                                   long long* resume) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  long long r;
  const long long row = (long long)h * W;
  down[h] = flt::down_resume(down_t + row, up_t + row, W, t[(long long)h * ts], r);
  resume[h] = r;
}

}  // namespace

extern "C" {

// args: H, W, ts, t, down_t, up_t, down (out), resume (out)
int fault_down_resume(const long long* a, void* stream) {
  const int H = (int)a[0], W = (int)a[1];
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (H > 0)
    down_resume_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        H, W, a[2], reinterpret_cast<const long long*>(a[3]),
        reinterpret_cast<const long long*>(a[4]), reinterpret_cast<const long long*>(a[5]),
        reinterpret_cast<bool*>(a[6]), reinterpret_cast<long long*>(a[7]));
  return (int)cudaGetLastError();
}

}  // extern "C"
