// Device functions of the fault plane (B13, B14), shared by K1 (the
// barrier's fault floor), K10 (the hold and clear lanes), K11 (the link
// fault lane) and K23.
//
//   down_resume    shadow_tpu/core/faults.py:266 down_and_resume
//   window_effects shadow_tpu/core/faults.py:281 window_effects
//
// One host's W crash windows are a row of the [H, W] down/up planes (unused
// slots hold TIME_MAX in both, so they never contain a time); the merged
// windows of one host are disjoint, so at most one contains t. The L link
// fault windows are shared by every host.

#pragma once

namespace flt {

constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr long long kLatScale = 1000;

// Whether t falls in one of the host's windows [down, up); `resume` gets
// the least up time over the windows that contain t, 0 where none does.
// The windows are parameters no kernel writes: read-only loads.
__device__ __forceinline__ bool down_resume(const long long* down_t, const long long* up_t,
                                            int W, long long t, long long& resume) {
  bool down = false;
  long long r = kTimeMax;
  for (int w = 0; w < W; ++w) {
    const long long u = __ldg(up_t + w);
    if (__ldg(down_t + w) <= t && t < u) {
      down = true;
      r = u < r ? u : r;
    }
  }
  resume = down ? r : 0;
  return down;
}

// The link-fault effects active at time t: the largest loss probability
// (0 where no window is active) and the largest latency multiplier x1000
// (at least 1000) over the windows [start, end) that contain t.
__device__ __forceinline__ void window_effects(const long long* start, const long long* end,
                                               const float* loss, const long long* lat, int L,
                                               long long t, float& f_loss, long long& f_lat) {
  float lo = 0.0f;
  long long la = kLatScale;
  for (int l = 0; l < L; ++l) {
    if (start[l] <= t && t < end[l]) {
      lo = loss[l] > lo ? loss[l] : lo;
      la = lat[l] > la ? lat[l] : la;
    }
  }
  f_loss = lo;
  f_lat = la;
}

}  // namespace flt
