// Device code of the pop (shadow_tpu/ops/events.py:138 pop_min), shared by
// K2 (csrc/queue.cu, one warp per host) and K36 (csrc/event.cu, a group of
// lanes per host), so the tie rule lives in one place.
//
// The rule: each host pops the lexicographic (t, order, slot) minimum of its
// row, active iff that time is below the host's limit. Live keys (t, order)
// are unique, so the slot index only orders the empty sentinels (TIME_MAX,
// ORDER_MAX), which are never active. The winner's (t, order) is cleared to
// the empty sentinel in place; its kind and payload stay, as in the
// reference. Inactive hosts get the dummy event (TIME_MAX, ORDER_MAX, kind
// 0, payload 0) and their row is untouched.

#pragma once

namespace qpop {

constexpr long long kTimeMax = 0x7fffffffffffffffLL;
constexpr long long kOrderMax = 0x7fffffffffffffffLL;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(long long at, long long ao, long long bt, long long bo) {
  return at < bt || (at == bt && ao < bo);
}

__device__ __forceinline__ bool lex_less3(long long at, long long ao, int ai, long long bt,
                                          long long bo, int bi) {
  return at < bt || (at == bt && (ao < bo || (ao == bo && ai < bi)));
}

// A candidate slot of one row under the tie rule.
struct Cand {
  long long t = kTimeMax, o = kOrderMax;
  int i = 0x7fffffff;

  __device__ __forceinline__ void fold(long long vt, long long vo, int vi) {
    if (lex_less3(vt, vo, vi, t, o, i)) { t = vt; o = vo; i = vi; }
  }
};

// The row minimum of a group of G lanes (G a power of two, aligned within
// the warp; `mask` holds at least the group's lanes, all of which must
// call) whose lanes hold candidates; every lane of the group gets the
// winner. K2's group is the warp.
template <int G>
__device__ __forceinline__ void group_min(Cand& a, unsigned mask = kFull) {
  for (int off = G / 2; off > 0; off >>= 1) {
    const long long ot = __shfl_xor_sync(mask, a.t, off);
    const long long oo = __shfl_xor_sync(mask, a.o, off);
    const int oi = __shfl_xor_sync(mask, a.i, off);
    a.fold(ot, oo, oi);
  }
}

// K36's first step: the least time of a row, the first slot holding it and
// how many slots hold it, from the time plane alone. Each lane folds its
// own columns in increasing order, then the group merges; the order plane
// is read only where the least time ties (at one slot: the winner).
struct MinTies {
  long long m = kTimeMax;
  int first = 0x7fffffff, ties = 0;

  __device__ __forceinline__ void fold(long long v, int c) {
    if (v < m) { m = v; first = c; ties = 1; }
    else if (v == m) ++ties;
  }

  // every lane of the warp calls (groups of G aligned lanes)
  template <int G>
  __device__ __forceinline__ void group_merge() {
    for (int off = G / 2; off > 0; off >>= 1) {
      const long long om = __shfl_xor_sync(kFull, m, off);
      const int of = __shfl_xor_sync(kFull, first, off);
      const int ot = __shfl_xor_sync(kFull, ties, off);
      if (om < m) { m = om; first = of; ties = ot; }
      else if (om == m) { first = of < first ? of : first; ties += ot; }
    }
  }
};

}  // namespace qpop
