// The per-pair code of the redesigned pair sums, in their fewest
// instructions, shared by the Stokeslet sums (stokeslet_sums.cu, kernels A
// and B), the stresslet sums (stresslet_sums.cu, kernels C and D) and the
// fused ring sums (ring_sums.cu, kernels E and F), so the sources cannot
// drift.
//
//   Stokeslet  u += f / r + (d . f) d / r^3 = r^-1 (f + c d),
//              c = (d . f) r^-2
//   stresslet  u += w d,  w = (d^T S d) r^-5   (the family's -3 is applied
//              once, to the finished sum)
//
// with d = x_t - x_s. Also the `cp.async` copies the kernels stage their
// source tiles with.

#pragma once

#include <cuda_runtime.h>

namespace skelly {

// -------------------------------------------------------------- precision
template <typename T>
struct Prec;

// f32: r^-1 from the ftz rsqrt as it comes (inf at r^2 = 0 or subnormal),
// and the pair added by three FMAs predicated on r^2 >= FLT_MIN: a pair
// that fails it adds nothing, whatever inf or NaN its terms hold, for one
// compare and no select.
template <>
struct Prec<float> {
  using Vec = float4;  // one 16-byte shared-memory read
  static __device__ __forceinline__ float rinv(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  }
  static __device__ __forceinline__ void add(float r2, float w, float ax,
                                             float ay, float az, float& px,
                                             float& py, float& pz) {
    asm("{\n\t.reg .pred p;\n\t"
        "setp.ge.f32 p, %3, 0f00800000;\n\t"  // FLT_MIN
        "@p fma.rn.f32 %0, %4, %5, %0;\n\t"
        "@p fma.rn.f32 %1, %4, %6, %1;\n\t"
        "@p fma.rn.f32 %2, %4, %7, %2;\n\t}"
        : "+f"(px), "+f"(py), "+f"(pz)
        : "f"(r2), "f"(w), "f"(ax), "f"(ay), "f"(az));
  }
};

// f64: r^-1 selected to 0 unless r^2 >= DBL_MIN, compared on r^2's high
// word (r^2 >= 0, so r^2 >= DBL_MIN exactly when it is >= 0x00100000): an
// integer compare, off the FP64 pipe. A dropped pair then adds 0 * f. (The
// predicated-FMA form of f32 made ptxas spill here, and it turned the
// predicate into six selects a pair anyway.)
template <>
struct Prec<double> {
  using Vec = double2;
  static __device__ __forceinline__ double seed(double x) {
    double y;
    asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
    return y;
  }
  static __device__ __forceinline__ double rsqrt(double x) {
    const double y = seed(x);
    const double e = fma(-x, y * y, 1.0);          // 1 - x y^2
    return fma(y * fma(e, 0.375, 0.5), e, y);      // y (1 + e/2 + 3e^2/8)
  }
  static __device__ __forceinline__ double rinv(double x) {
    return __double2hiint(x) >= 0x00100000 ? rsqrt(x) : 0.0;
  }
  static __device__ __forceinline__ void add(double, double w, double ax,
                                             double ay, double az, double& px,
                                             double& py, double& pz) {
    px = fma(w, ax, px);
    py = fma(w, ay, py);
    pz = fma(w, az, pz);
  }
};

__device__ __forceinline__ void unpack(const float4& v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void unpack(const double2& v, double* a) {
  a[0] = v.x;
  a[1] = v.y;
}

// Sources a group of 3 vector reads of positions carries (4 in f32, 2 in
// f64).
template <typename T>
constexpr int kGroup = 16 / sizeof(T);

// ------------------------------------------------------------------ pairs
// One Stokeslet pair: source (s, f) seen from target (tx, ty, tz), added to
// p; the r == 0 drop is the precision's (`Prec<T>::rinv` and `Prec<T>::add`).
// 18 FP32 instructions and one MUFU.RSQ in f32.
template <typename T>
__device__ __forceinline__ void stokeslet_pair(T sx, T sy, T sz, T fx, T fy,
                                               T fz, T tx, T ty, T tz, T& px,
                                               T& py, T& pz) {
  const T dx = tx - sx;
  const T dy = ty - sy;
  const T dz = tz - sz;
  const T r2 = fma(dz, dz, fma(dy, dy, dx * dx));
  const T rinv = Prec<T>::rinv(r2);
  const T c = fma(dz, fz, fma(dy, fy, dx * fx)) * (rinv * rinv);
  Prec<T>::add(r2, rinv, fma(c, dx, fx), fma(c, dy, fy), fma(c, dz, fz), px,
               py, pz);
}

// One stresslet pair, UNSCALED by the family's -3: source s with the
// row-major components S[0..8], seen from target (tx, ty, tz), adds
// (d^T S d) r^-5 d to p. r^-5 = r^-1 (r^-2)^2 from the one rsqrt, the weight
// w = (q r^-1) (r^-2 r^-2) in four multiplies; the drop as in the Stokeslet
// pair. 26 FP32 instructions (3 FADD, 9 FMUL, 13 FFMA, 1 FSETP) and one
// MUFU.RSQ in f32. A pair closer than ~1e-8 overflows r^-5 in f32, as in
// every f32 form of the sum; the discretisations never hold one.
template <typename T>
__device__ __forceinline__ void stresslet_pair(T sx, T sy, T sz, const T* S,
                                               T tx, T ty, T tz, T& px, T& py,
                                               T& pz) {
  const T dx = tx - sx;
  const T dy = ty - sy;
  const T dz = tz - sz;
  const T r2 = fma(dz, dz, fma(dy, dy, dx * dx));
  const T rinv = Prec<T>::rinv(r2);
  const T sdx = fma(S[2], dz, fma(S[1], dy, S[0] * dx));
  const T sdy = fma(S[5], dz, fma(S[4], dy, S[3] * dx));
  const T sdz = fma(S[8], dz, fma(S[7], dy, S[6] * dx));
  const T q = fma(dz, sdz, fma(dy, sdy, dx * sdx));
  const T rinv2 = rinv * rinv;
  const T w = (q * rinv) * (rinv2 * rinv2);
  Prec<T>::add(r2, w, dx, dy, dz, px, py, pz);
}

// ---------------------------------------------------------------- staging
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace skelly
