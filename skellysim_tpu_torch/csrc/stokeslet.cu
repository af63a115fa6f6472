// Singular Stokeslet pair sum on Hopper (sm_90a): kernel A (float32) and
// kernel B (float64).
//
//   u_t = scale * sum_s [ f_s / r + (d . f_s) d / r^3 ],  d = x_t - x_s,
//
// with pairs at r == 0 dropped (scale = 1/(8 pi eta), or 1 for the unscaled
// entry the ring evaluator will use). Inputs are row-major [n, 3] arrays;
// the output is [n_trg, 3].
//
// Kernel A replaces the Pallas tile `_stokeslet_kernel`
// (skellysim_tpu/ops/pallas_kernels.py, reached through `stokeslet_pallas`).
// Kernel B replaces the double-float Pallas tile `_stokeslet_df_kernel`
// (skellysim_tpu/ops/pallas_df.py, reached through `stokeslet_pallas_df`).
// The TPU kernel emulated f64 with (hi, lo) f32 pairs because the TPU has no
// fast FP64; the H100 has native FP64 units, so kernel B is the same loop as
// kernel A in plain double with a double rsqrt: the DF emulation (~300 f32
// operations a pair) would cost more than the native ~30 FP64 operations
// and only reproduce what the hardware already gives.
//
// What bounds it on this card: arithmetic, not memory. Each pair is ~18
// FP32 (FP64 for B) add/mul/FMA issues plus one rsqrt; kernel A's rsqrtf is
// one MUFU (SFU) instruction (16/clk/SM against 128 FP32 lanes/clk/SM, so the
// SFU is not the limit), kernel B's rsqrt(double) is an SFU seed plus a few
// FP64 Newton steps. Every source is read once per target block, which the
// L2 serves; device-memory traffic is O(n_trg + n_src).
//
// Design, for the card and not block for block from the TPU:
//  * one thread owns one target and keeps its three sums in registers;
//  * each block walks ALL source tiles in a loop, staging TILE sources
//    (position + force) through shared memory; that loop replaces the TPU's
//    sequential grid axis, so there is no cross-block reduction;
//  * the staged record is 16-byte aligned, so the inner loop reads it with
//    vector shared-memory loads (all threads of a warp read the same record:
//    a broadcast);
//  * each tile's contribution is summed into a tile partial first and then
//    added to the running sum, which keeps the f32 accumulation error near
//    eps * (sqrt(TILE) + sqrt(n_src / TILE)) instead of eps * sqrt(n_src);
//  * the ragged edges are masked by bounds checks (targets: `live`; sources:
//    the tile count), never by padding with sentinel coordinates;
//  * the r == 0 drop is a select (`r2 > 0 ? rsqrt(r2) : 0`), never a
//    multiply: fiber nodes are both targets and sources and their self term
//    must be exactly zero, and inactive slots sit at the origin with zero
//    force, where rsqrt(0) * 0 would be NaN.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // targets per block, one per thread
constexpr int kTile = 256;     // sources staged per shared-memory tile

template <typename T>
struct __align__(16) SrcRecord {
  T x, y, z, fx, fy, fz;
};

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
stokeslet_kernel(const T* __restrict__ trg, const T* __restrict__ src,
                 const T* __restrict__ force, T* __restrict__ out,
                 int64_t n_trg, int64_t n_src, T scale) {
  __shared__ SrcRecord<T> tile[kTile];

  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = t < n_trg;
  T tx = T(0), ty = T(0), tz = T(0);
  if (live) {
    tx = trg[3 * t + 0];
    ty = trg[3 * t + 1];
    tz = trg[3 * t + 2];
  }
  T ux = T(0), uy = T(0), uz = T(0);

  for (int64_t base = 0; base < n_src; base += kTile) {
    const int64_t s = base + threadIdx.x;
    __syncthreads();  // every thread is done reading the previous tile
    if (s < n_src) {
      SrcRecord<T> rec;
      rec.x = src[3 * s + 0];
      rec.y = src[3 * s + 1];
      rec.z = src[3 * s + 2];
      rec.fx = force[3 * s + 0];
      rec.fy = force[3 * s + 1];
      rec.fz = force[3 * s + 2];
      tile[threadIdx.x] = rec;
    }
    __syncthreads();

    const int count = static_cast<int>(
        n_src - base < kTile ? n_src - base : kTile);
    T px = T(0), py = T(0), pz = T(0);
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const SrcRecord<T> rec = tile[j];
      const T dx = tx - rec.x;
      const T dy = ty - rec.y;
      const T dz = tz - rec.z;
      const T r2 = dx * dx + dy * dy + dz * dz;
      const T rinv = r2 > T(0) ? rsqrt_t(r2) : T(0);  // select: self pair -> 0
      const T rinv3 = rinv * rinv * rinv;
      const T c = (dx * rec.fx + dy * rec.fy + dz * rec.fz) * rinv3;
      px += rinv * rec.fx + c * dx;
      py += rinv * rec.fy + c * dy;
      pz += rinv * rec.fz + c * dz;
    }
    ux += px;
    uy += py;
    uz += pz;
  }

  if (live) {
    out[3 * t + 0] = ux * scale;
    out[3 * t + 1] = uy * scale;
    out[3 * t + 2] = uz * scale;
  }
}

template <typename T>
int launch(const T* trg, const T* src, const T* force, T* out, int64_t n_trg,
           int64_t n_src, T scale, void* stream) {
  if (n_trg <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_trg + kThreads - 1) / kThreads;
  stokeslet_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      trg, src, force, out, n_trg, n_src, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 when
// the launch was accepted); the Python wrapper raises on anything else.
int stokeslet_f32_launch(const float* trg, const float* src, const float* force,
                         float* out, long long n_trg, long long n_src,
                         float scale, void* stream) {
  return launch<float>(trg, src, force, out, n_trg, n_src, scale, stream);
}

int stokeslet_f64_launch(const double* trg, const double* src,
                         const double* force, double* out, long long n_trg,
                         long long n_src, double scale, void* stream) {
  return launch<double>(trg, src, force, out, n_trg, n_src, scale, stream);
}

const char* stokeslet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
