// Singular pair sums on Hopper (sm_90a): one tiled kernel, two pair
// families, two precisions -- the first design of kernels A-D, kept only as
// the yardstick their redesigns are timed and checked against. No path
// launches them.
//
//   Stokeslet  u_t = scale * sum_s [ f_s / r + (d . f_s) d / r^3 ]
//   stresslet  u_t = scale * sum_s -3 (d^T S_s d) d / r^5
//
// with d = x_t - x_s and pairs at r == 0 dropped (scale = 1/(8 pi eta), or 1
// for the unscaled entry the ring evaluator's per-hop blocks use; the
// stresslet's -3 is part of the sum either way, as in
// `stresslet_pallas_block`). Positions are row-major [n, 3]; the payload is
// [n_src, 3] forces (Stokeslet) or [n_src, 9] row-major stresslet components
// S (Sxx..Szz); the output is [n_trg, 3].
//
// The instances here, the Pallas tiles their kernels replace, and where
// the redesign lives:
//   stokeslet_f32_tiled  A  `_stokeslet_kernel`     stokeslet_sums.cu
//   stokeslet_f64_tiled  B  `_stokeslet_df_kernel`  stokeslet_sums.cu
//   stresslet_f32_tiled  C  `_stresslet_kernel`     stresslet_sums.cu
//   stresslet_f64_tiled  D  `_stresslet_df_kernel`  stresslet_sums.cu
// (skellysim_tpu/ops/pallas_kernels.py and pallas_df.py).
// The TPU tiles of the f64 kernels carried every value as a (hi, lo) pair
// of f32 words with error-free transforms (~300 f32 operations a Stokeslet
// pair, ~420 a stresslet pair) because the TPU has no fast FP64. The H100
// has native FP64 units, so the f64 kernels are the f32 loop in plain double
// with a double rsqrt: they meet the same "f32 or f64 in, f64 out, ~1e-14
// relative" contract at about a tenth of the operations. The family's
// constant (-3 for the stresslet) and the scale are applied once, to the
// finished sum.
//
// What bounds them on this card: instruction issue (FP32) and the FP64
// pipe, not memory. A stresslet pair is ~25 FP32 issues (3 differences, 3
// for r^2, 3 for r^-5, 9 for S d, 3 for d.(S d), 1 scale, 3 accumulations)
// -- FP64 for D -- plus one rsqrt; rsqrtf is one MUFU plus a denormal
// fix-up, the double rsqrt a library routine. Each source is read once per
// target block, which the L2 serves; device-memory traffic is
// O(n_trg + n_src).
//
// Design (simple first; stokeslet_sums.cu and stresslet_sums.cu show what
// a redesign for the card does):
//  * one thread owns one target and keeps its three sums in registers;
//  * each block walks ALL source tiles in a loop, each thread staging one
//    source record (position + payload) through shared memory; that loop
//    replaces the TPU's sequential grid axis, so there is no cross-block
//    reduction. The stresslet's 12-word record takes 128-thread blocks, which
//    gives ~1,000 blocks at the confined path's 128,000 fiber-node targets and
//    fills the 132 SMs;
//  * the staged record is 16-byte aligned, so the inner loop reads it with
//    vector shared-memory loads (every thread of a warp reads the same record:
//    a broadcast), two a pair;
//  * each tile's contribution is summed into a tile partial first and then
//    added to the running sum, which keeps the f32 accumulation error near
//    eps * (sqrt(TILE) + sqrt(n_src / TILE)) instead of eps * sqrt(n_src);
//  * the ragged edges are masked by bounds checks (targets: `live`; sources:
//    the tile count), never by padding with sentinel coordinates;
//  * the r == 0 drop is a select, never a multiply (the pair functors and
//    the select live in `pair_functors.cuh`, shared with the fused ring
//    kernels of `ring_sums.cu`).

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_functors.cuh"

namespace {

using skelly::Stokeslet;
using skelly::Stresslet;

template <class Pair, int kUnroll>
__global__ void __launch_bounds__(Pair::kThreads)
pair_sum_kernel(const typename Pair::T* __restrict__ trg,
                const typename Pair::T* __restrict__ src,
                const typename Pair::T* __restrict__ payload,
                typename Pair::T* __restrict__ out, int64_t n_trg,
                int64_t n_src, typename Pair::T scale) {
  using T = typename Pair::T;
  using Record = typename Pair::Record;
  constexpr int kTile = Pair::kThreads;  // sources staged per tile
  __shared__ Record tile[kTile];

  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * Pair::kThreads + threadIdx.x;
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
      tile[threadIdx.x] = skelly::load_record<Pair>(src, payload, s);
    }
    __syncthreads();

    const int count = static_cast<int>(
        n_src - base < kTile ? n_src - base : kTile);
    T px = T(0), py = T(0), pz = T(0);
#pragma unroll (kUnroll)
    for (int j = 0; j < count; ++j) {
      const Record rec = tile[j];  // one vector read of the staged record
      skelly::pair_term<Pair>(rec, tx, ty, tz, px, py, pz);
    }
    ux += px;
    uy += py;
    uz += pz;
  }

  if (live) {
    const T k = Pair::finish(scale);  // once, on the finished sum
    out[3 * t + 0] = ux * k;
    out[3 * t + 1] = uy * k;
    out[3 * t + 2] = uz * k;
  }
}

template <class Pair>
int launch(const typename Pair::T* trg, const typename Pair::T* src,
           const typename Pair::T* payload, typename Pair::T* out,
           int64_t n_trg, int64_t n_src, typename Pair::T scale,
           void* stream) {
  if (n_trg <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_trg + Pair::kThreads - 1) / Pair::kThreads;
  pair_sum_kernel<Pair, Pair::kUnroll>
      <<<static_cast<unsigned int>(blocks), Pair::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      trg, src, payload, out, n_trg, n_src, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() right after the launch (0 when
// the launch was accepted); the Python wrapper raises on anything else.
int stokeslet_f32_tiled_launch(const float* trg, const float* src,
                               const float* payload, float* out,
                               long long n_trg, long long n_src, float scale,
                               void* stream) {
  return launch<Stokeslet<float>>(trg, src, payload, out, n_trg, n_src, scale,
                                  stream);
}

int stokeslet_f64_tiled_launch(const double* trg, const double* src,
                               const double* payload, double* out,
                               long long n_trg, long long n_src, double scale,
                               void* stream) {
  return launch<Stokeslet<double>>(trg, src, payload, out, n_trg, n_src,
                                   scale, stream);
}

int stresslet_f32_tiled_launch(const float* trg, const float* src,
                               const float* payload, float* out,
                               long long n_trg, long long n_src, float scale,
                               void* stream) {
  return launch<Stresslet<float>>(trg, src, payload, out, n_trg, n_src, scale,
                                  stream);
}

int stresslet_f64_tiled_launch(const double* trg, const double* src,
                               const double* payload, double* out,
                               long long n_trg, long long n_src, double scale,
                               void* stream) {
  return launch<Stresslet<double>>(trg, src, payload, out, n_trg, n_src,
                                   scale, stream);
}

const char* pair_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
