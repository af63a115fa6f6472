// Pair functors of the first, one-target-a-thread design, shared by the
// tiled pair sums (pair_sums.cu: kernels C and D, and A's and B's
// yardstick) and the fused ring sums' yardstick (ring_sums.cu, E's and F's
// first design), so the sources cannot drift. The redesigned kernels' pair
// code is pair_terms.cuh.
//
//   Stokeslet  sum_s [ f_s / r + (d . f_s) d / r^3 ]
//   stresslet  sum_s -3 (d^T S_s d) d / r^5
//
// with d = x_t - x_s. A pair at r == 0 is dropped by a select
// (`r2 > 0 ? rsqrt(r2) : 0`), never by a multiply: fiber nodes are sources
// and targets of the Stokeslet sum, body nodes of the body double layer, and
// their self term must be exactly zero; inactive slots and zero-density
// sources sitting on a target must not turn into rsqrt(0) * 0 = NaN.
//
// A family carries its source record (position + payload, 16-byte aligned
// so a staged record is read with vector loads), the pair term added to a
// partial sum, and the constant applied once to a finished sum (-3 for the
// stresslet). kThreads / kUnroll are the tiled kernel's block size and
// inner-loop unroll.

#pragma once

#include <cuda_runtime.h>

namespace skelly {

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename Real>
struct Stokeslet {
  using T = Real;
  static constexpr int kThreads = 256;
  static constexpr int kUnroll = 4;
  static constexpr int kPayload = 3;
  struct __align__(16) Record {
    T x, y, z;
    T p[kPayload];  // force
  };
  __device__ static T finish(T scale) { return scale; }
  __device__ static void add(const Record& rec, T dx, T dy, T dz, T rinv,
                             T& px, T& py, T& pz) {
    const T rinv3 = rinv * rinv * rinv;
    const T c = (dx * rec.p[0] + dy * rec.p[1] + dz * rec.p[2]) * rinv3;
    px += rinv * rec.p[0] + c * dx;
    py += rinv * rec.p[1] + c * dy;
    pz += rinv * rec.p[2] + c * dz;
  }
};

template <typename Real>
struct Stresslet {
  using T = Real;
  static constexpr int kThreads = 128;
  static constexpr int kUnroll = 2;
  static constexpr int kPayload = 9;
  struct __align__(16) Record {
    T x, y, z;
    T p[kPayload];  // S, row-major
  };
  __device__ static T finish(T scale) { return T(-3) * scale; }
  __device__ static void add(const Record& rec, T dx, T dy, T dz, T rinv,
                             T& px, T& py, T& pz) {
    const T rinv2 = rinv * rinv;
    const T rinv5 = rinv2 * rinv2 * rinv;
    const T sdx = rec.p[0] * dx + rec.p[1] * dy + rec.p[2] * dz;
    const T sdy = rec.p[3] * dx + rec.p[4] * dy + rec.p[5] * dz;
    const T sdz = rec.p[6] * dx + rec.p[7] * dy + rec.p[8] * dz;
    const T c = (dx * sdx + dy * sdy + dz * sdz) * rinv5;
    px += c * dx;
    py += c * dy;
    pz += c * dz;
  }
};

// One source record's term at target (tx, ty, tz), added to (px, py, pz);
// the self pair is dropped by the select.
template <class Pair>
__device__ __forceinline__ void pair_term(const typename Pair::Record& rec,
                                          typename Pair::T tx,
                                          typename Pair::T ty,
                                          typename Pair::T tz,
                                          typename Pair::T& px,
                                          typename Pair::T& py,
                                          typename Pair::T& pz) {
  using T = typename Pair::T;
  const T dx = tx - rec.x;
  const T dy = ty - rec.y;
  const T dz = tz - rec.z;
  const T r2 = dx * dx + dy * dy + dz * dz;
  const T rinv = r2 > T(0) ? rsqrt_t(r2) : T(0);  // select: self pair -> 0
  Pair::add(rec, dx, dy, dz, rinv, px, py, pz);
}

// Source s of row-major [n, 3] positions and [n, kPayload] payload as a record.
template <class Pair>
__device__ __forceinline__ typename Pair::Record load_record(
    const typename Pair::T* __restrict__ src,
    const typename Pair::T* __restrict__ payload, long long s) {
  typename Pair::Record rec;
  rec.x = src[3 * s + 0];
  rec.y = src[3 * s + 1];
  rec.z = src[3 * s + 2];
#pragma unroll
  for (int k = 0; k < Pair::kPayload; ++k) {
    rec.p[k] = payload[Pair::kPayload * s + k];
  }
  return rec;
}

}  // namespace skelly
