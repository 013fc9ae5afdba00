// Device math of the per-event chain (B5), shared by the event kernels.
//
// Each function is the CUDA twin of a plain PyTorch function of the port
// and of the JAX reference, bit for bit:
//   rng_next / rng_uniform   shadow_tpu/ops/rng.py:55,74 (xoshiro256++; the
//                            port carries the uint64 lanes as int64)
//   tb_remove                shadow_tpu/net/tokenbucket.py:53
//   codel_on_packet          shadow_tpu/net/codel.py:48,54
//   digest_fold              shadow_tpu/core/engine.py:1086
//   digest2_fold             shadow_tpu/core/engine.py:1093 _digest_update2
//   pack_order               shadow_tpu/ops/events.py pack_order
//   splitmix64 /             shadow_tpu/ops/rng.py _splitmix64 and
//   fluid_uniform            shadow_tpu/net/fluid.py:302 fluid_send_uniform
//
// Integer lanes wrap as two's complement, as int64 tensors do: every add,
// subtract and multiply that can overflow goes through the unsigned helpers
// below (signed overflow is undefined in C++). Division rounds toward minus
// infinity (Python's and torch's floor division), not toward zero. The
// float steps use the round-to-nearest intrinsics, so no contraction into a
// fused multiply-add can change a result; the source is compiled with
// --fmad=false as well, and never with --use_fast_math.

#pragma once

#include <cstdint>

namespace evm {

typedef unsigned long long u64;
typedef long long i64;

constexpr i64 kTimeMax = 0x7fffffffffffffffLL;
constexpr i64 kOrderMax = 0x7fffffffffffffffLL;
constexpr int kKindMask = 0xFFFF;
constexpr int kKindPkt = 1 << 16;
constexpr int kKindIngressDone = 1 << 17;
constexpr int kSrcShift = 40;
constexpr int kLocalShift = 62;
constexpr i64 kSeqMask = (1LL << 40) - 1;
constexpr i64 kSrcMask = (1LL << (kLocalShift - kSrcShift)) - 1;
constexpr int kSizeWord = 0;  // payload word 0 = packet size in bytes

constexpr i64 kCodelTarget = 10000000LL;     // 10 ms
constexpr i64 kCodelInterval = 100000000LL;  // 100 ms

constexpr u64 kMix1 = 0x9E3779B97F4A7C15ULL;
constexpr u64 kMix2 = 0xC2B2AE3D27D4EB4FULL;
constexpr u64 kFnvPrime = 1099511628211ULL;
// the integrity sentinel's second fold (shadow_tpu/core/engine.py:1093
// _digest_update2): no constant shared with the first
constexpr u64 kMix3 = 0xD6E8FEB86659FD93ULL;
constexpr u64 kMix4 = 0xA0761D6478BD642FULL;
constexpr u64 kDigest2Prime = 0x5851F42D4C957F2DULL;

// latency multipliers are parts per thousand (the fault and fluid planes)
constexpr i64 kLatScale = 1000;
constexpr u64 kGolden = 0x9E3779B97F4A7C15ULL;
constexpr u64 kSm1 = 0xBF58476D1CE4E5B9ULL;
constexpr u64 kSm2 = 0x94D049BB133111EBULL;
constexpr u64 kHostStride = 0xD1342543DE82EF95ULL;
constexpr u64 kCtrStride = 0xA0761D6478BD642FULL;

__device__ __forceinline__ i64 wadd(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 wsub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 wmul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__device__ __forceinline__ int wadd32(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wmul32(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }

// floor division for b > 0 (every divisor here is positive)
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ i64 pack_order(int is_local, i64 src, i64 seq) {
  return (i64)(((u64)is_local << kLocalShift) | ((u64)src << kSrcShift) | ((u64)(seq & kSeqMask)));
}

__device__ __forceinline__ u64 digest_fold(u64 digest, i64 t, int kind, i64 order) {
  u64 x = (u64)t * kMix1;
  x ^= (u64)(i64)kind * kMix2;
  x ^= (u64)order;
  return (digest ^ x) * kFnvPrime;
}

__device__ __forceinline__ u64 digest2_fold(u64 digest2, i64 t, int kind, i64 order) {
  u64 x = (u64)order * kMix3;
  x ^= (u64)t * kMix4;
  x ^= (u64)(i64)kind;
  return (digest2 ^ x) * kDigest2Prime;
}

// ---- xoshiro256++ (state s[4] in registers; advanced only where mask) ----

__device__ __forceinline__ u64 rotl(u64 x, int k) { return (x << k) | (x >> (64 - k)); }

__device__ __forceinline__ u64 rng_next(u64 s[4], bool mask) {
  const u64 s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3];
  const u64 result = rotl(s0 + s3, 23) + s0;
  const u64 t = s1 << 17;
  u64 s2n = s2 ^ s0;
  u64 s3n = s3 ^ s1;
  const u64 s1n = s1 ^ s2n;
  const u64 s0n = s0 ^ s3n;
  s2n ^= t;
  s3n = rotl(s3n, 45);
  if (mask) {
    s[0] = s0n;
    s[1] = s1n;
    s[2] = s2n;
    s[3] = s3n;
  }
  return result;
}

// float32 in [0, 1) from the draw's top 24 bits (exact: u24 < 2^24 and the
// scale is a power of two)
__device__ __forceinline__ float rng_uniform(u64 s[4], bool mask) {
  const u64 x = rng_next(s, mask);
  return __fmul_rn((float)(unsigned)(x >> 40), 1.0f / 16777216.0f);
}

// ---- the fluid plane's counter draw ----

// splitmix64's output for state x (the state advances by kGolden first)
__device__ __forceinline__ u64 splitmix64(u64 x) {
  u64 z = x + kGolden;
  z = (z ^ (z >> 30)) * kSm1;
  z = (z ^ (z >> 27)) * kSm2;
  return z ^ (z >> 31);
}

// float32 in [0, 1) keyed on (seed, host, emission counter): two splitmix64
// rounds, the top 24 bits scaled by 2^-24 (exact)
__device__ __forceinline__ float fluid_uniform(u64 seed, i64 host, i64 ctr) {
  const u64 x = seed + (u64)host * kHostStride + (u64)ctr * kCtrStride;
  const u64 u = splitmix64(splitmix64(x));
  return __fmul_rn((float)(unsigned)(u >> 40), 1.0f / 16777216.0f);
}

// ---- token bucket ----

// One packet of size_bits at t, planned: its departure and the bucket's
// state after charging it (`tb_remove` applies that state where asked).
struct TbPlan {
  i64 depart, tokens, last_itv;
};

__device__ __forceinline__ TbPlan tb_plan(i64 tokens, i64 last_itv, i64 cap, i64 refill,
                                          i64 interval, i64 t, i64 size_bits) {
  const i64 itv = imax(floordiv(t, interval), last_itv);
  const i64 elapsed = wsub(itv, last_itv);
  const i64 gain = elapsed < (1LL << 20) ? wmul(elapsed, refill) : cap;
  const i64 tk = imin(cap, wadd(tokens, gain));
  const bool conforms = tk >= size_bits;
  const i64 deficit = imax(wsub(size_bits, tk), 0);
  const i64 rs = imax(refill, 1);
  // ceil(deficit / rs); 0 without a deficit (rs - 1 < rs), so the
  // division runs only where a packet waits
  const i64 k = deficit > 0 ? floordiv(wsub(wadd(deficit, rs), 1), rs) : 0;
  const i64 depart_wait = wmul(wadd(itv, k), interval);
  const bool shaped = refill > 0;
  const i64 depart_now = imax(t, wmul(itv, interval));
  TbPlan p;
  p.depart = (shaped && !conforms) ? depart_wait : (shaped ? depart_now : t);
  p.tokens = conforms ? wsub(tk, size_bits) : wsub(wadd(tk, wmul(k, refill)), size_bits);
  p.last_itv = conforms ? itv : wadd(itv, k);
  return p;
}

// charge size_bits where mask; returns the departure
__device__ __forceinline__ i64 tb_remove(i64& tokens, i64& last_itv, i64 cap, i64 refill,
                                         i64 interval, i64 t, i64 size_bits, bool mask) {
  const TbPlan p = tb_plan(tokens, last_itv, cap, refill, interval, t, size_bits);
  if (mask && refill > 0) {
    tokens = p.tokens;
    last_itv = p.last_itv;
  }
  return p.depart;
}

// ---- CoDel (RFC 8289) ----

// now + round_half_even(INTERVAL / sqrt(count)) in float64: __dsqrt_rn and
// __ddiv_rn are IEEE correctly rounded, rint rounds half to even like
// jnp.round / torch.round
__device__ __forceinline__ i64 codel_control_law(i64 now, int count) {
  const int c = count < 1 ? 1 : count;
  const double q = __ddiv_rn((double)kCodelInterval, __dsqrt_rn((double)c));
  return wadd(now, (i64)rint(q));
}

struct Codel {
  i64 first_above;
  i64 drop_next;
  int count;
  bool dropping;
};

// one packet where mask; returns drop (false where !mask; state untouched)
__device__ __forceinline__ bool codel_on_packet(Codel& s, i64 now, i64 sojourn, bool mask) {
  const bool below = sojourn < kCodelTarget;
  const bool fa_unset = s.first_above == 0;
  const i64 new_fa = below ? 0 : (fa_unset ? wadd(now, kCodelInterval) : s.first_above);
  const bool ok = !below && !fa_unset && now >= s.first_above;
  const bool leave = s.dropping && !ok;
  const bool fire = s.dropping && ok && now >= s.drop_next;
  const int count_f = wadd32(s.count, 1);
  const bool enter = !s.dropping && ok;
  const bool recent = wsub(now, s.drop_next) < 16 * kCodelInterval;
  const int count_e = (recent && s.count > 2) ? s.count - 2 : 1;
  if (!mask) return false;
  const bool new_dropping = leave ? false : (enter ? true : s.dropping);
  const int new_count = fire ? count_f : (enter ? count_e : s.count);
  // fire and enter exclude each other (dropping or not): one control law,
  // evaluated only where one of them moves drop_next
  i64 new_dn = s.drop_next;
  if (fire || enter) new_dn = codel_control_law(fire ? s.drop_next : now, new_count);
  s.first_above = new_fa;
  s.drop_next = new_dn;
  s.count = new_count;
  s.dropping = new_dropping;
  return fire || enter;
}

}  // namespace evm
