// The treecode's pair sums on Hopper (sm_90a): kernels G and H.
//
//   G  Stokeslet   u_t = sum_s [ f_s / r + (d . f_s) d / r^3 ]
//   H  stresslet   u_t = sum_s -3 (d^T S_s d) d / r^5
//
// d = x_t - x_s, pairs at r == 0 dropped (the precision's rule in
// pair_terms.cuh), times scale = 1/(8 pi eta). Each in float32 and float64.
// They have no Pallas counterpart: the JAX package sums the treecode's near
// and far fields in plain XLA (skellysim_tpu/ops/treecode.py `_tree_eval`,
// its `near_rows` / `far_rows` over `_stokeslet_rows` / `_stresslet_rows`),
// gathering each target's own padded sources, which on this card would be
// terabytes of gathered tensors a sum at 640,000 nodes.
//
// The work comes as lists (ops/treecode.py `_segment_lists`). The targets
// are sorted by leaf. An item is one run of at most kItemTargets targets of
// one leaf, with the leaf's segments: (first source, sources) runs of one
// source array that holds the bucketed sources (near: the 27 neighbor
// leaves' occupied slots) and the flat proxies (far: p^3 a cell of the
// leaf's interaction list). Near and far are the same pair sum, so one pass
// takes both.
//
// What bounds them. Like kernels A-D, the pair arithmetic: the far field is
// ~99% of the pairs at 640,000 nodes (7.0e10 of 7.06e10 at tol 1e-4), on
// O(n) words. Unlike A-D, a target sees only its own lists, so R targets a
// thread cannot share sources across leaves, and leaves are small (mean 37
// targets, median 32 at 640,000 fiber nodes): a lane a target leaves the
// lanes of a leaf's last warp idle.
//
// Design (first, simple and right; making it fast is later work):
//  * One block of kWarps warps an item, one target a lane (lanes past the
//    item's count compute and discard). The item's segments are split
//    round robin over the warps; each warp sums its segments into its own
//    registers, and the block adds the warps' sums in warp order, so two
//    launches on the same inputs give the same bits (no atomics).
//  * Each warp stages its segment through its own slice of shared memory,
//    kStage sources at a time, with coalesced loads by its 32 lanes; every
//    lane then reads each staged source as a broadcast. A far segment (a
//    cell's p^3 proxies) is contiguous.
//  * Each segment's pairs are summed into a segment partial first and then
//    added to the warp's sum, which keeps the f32 error near eps *
//    (sqrt(segment length) + sqrt(segments)).
//  * The pair code is pair_terms.cuh's (`stokeslet_pair`,
//    `stresslet_pair`), shared with A-F. The family's -3 and the scale are
//    applied once, to the finished sum.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_terms.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block (an item)
constexpr int kThreads = 32 * kWarps;
constexpr int kItemTargets = 32;          // targets an item, one a lane
constexpr int kStage = 64;                // sources a warp stages at a time
// Sources a pass of a full stage's loop, by family (G: 3 payload columns,
// H: 9). H's f32 instance spilled 4 bytes at 8 (ptxas -v); at 4 it spills
// none and gives the same bits.
constexpr int kUnrollG = 8;
constexpr int kUnrollH = 4;

using skelly::stokeslet_pair;
using skelly::stresslet_pair;

// One pair of family C (3: Stokeslet, forces; 9: stresslet, row-major S).
template <typename T, int C>
__device__ __forceinline__ void pair(const T* s, const T* q, T tx, T ty, T tz,
                                     T& px, T& py, T& pz) {
  if constexpr (C == 3) {
    stokeslet_pair(s[0], s[1], s[2], q[0], q[1], q[2], tx, ty, tz, px, py,
                   pz);
  } else {
    stresslet_pair(s[0], s[1], s[2], q, tx, ty, tz, px, py, pz);
  }
}

// One item a block: items[4 b .. 4 b + 3] = (first target, targets, first
// segment, segments); segs[2 g], segs[2 g + 1] = (first source, sources).
// Writes out[t] = scale * sum for the item's targets t (leaf-sorted order).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
tree_kernel(const T* __restrict__ trg, const T* __restrict__ src,
            const T* __restrict__ pay, const int64_t* __restrict__ items,
            const int64_t* __restrict__ segs, T* __restrict__ out, T scale) {
  __shared__ __align__(16) T s_pos[kWarps][3 * kStage];
  __shared__ __align__(16) T s_pay[kWarps][C * kStage];
  __shared__ T s_sum[kWarps][3][kItemTargets];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t* item = items + 4 * static_cast<int64_t>(blockIdx.x);
  const int64_t t = item[0] + lane;
  const bool live = lane < item[1];
  const int64_t g_end = item[2] + item[3];
  const T tx = live ? trg[3 * t + 0] : T(0);
  const T ty = live ? trg[3 * t + 1] : T(0);
  const T tz = live ? trg[3 * t + 2] : T(0);
  T* pos = s_pos[warp];
  T* q = s_pay[warp];
  constexpr int kUnroll = C == 9 ? kUnrollH : kUnrollG;

  T ux = T(0), uy = T(0), uz = T(0);
  for (int64_t g = item[2] + warp; g < g_end; g += kWarps) {
    const int64_t first = segs[2 * g];
    const int64_t len = segs[2 * g + 1];
    T px = T(0), py = T(0), pz = T(0);
    for (int64_t c0 = 0; c0 < len; c0 += kStage) {
      const int n = static_cast<int>(len - c0 < kStage ? len - c0 : kStage);
      const T* gp = src + 3 * (first + c0);
      const T* gq = pay + C * (first + c0);
      for (int w = lane; w < 3 * n; w += 32) pos[w] = gp[w];
      for (int w = lane; w < C * n; w += 32) q[w] = gq[w];
      __syncwarp();
      if (n == kStage) {
#pragma unroll (kUnroll)
        for (int j = 0; j < kStage; ++j) {
          pair<T, C>(pos + 3 * j, q + C * j, tx, ty, tz, px, py, pz);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
          pair<T, C>(pos + 3 * j, q + C * j, tx, ty, tz, px, py, pz);
        }
      }
      __syncwarp();  // every lane is done with the stage before the next
    }
    ux += px;
    uy += py;
    uz += pz;
  }

  s_sum[warp][0][lane] = ux;
  s_sum[warp][1][lane] = uy;
  s_sum[warp][2][lane] = uz;
  __syncthreads();
  if (warp == 0 && live) {
    T sx = s_sum[0][0][lane], sy = s_sum[0][1][lane], sz = s_sum[0][2][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      sx += s_sum[w][0][lane];
      sy += s_sum[w][1][lane];
      sz += s_sum[w][2][lane];
    }
    const T s = C == 9 ? T(-3) * scale : scale;
    out[3 * t + 0] = sx * s;
    out[3 * t + 1] = sy * s;
    out[3 * t + 2] = sz * s;
  }
}

template <typename T, int C>
int launch(const T* trg, const T* src, const T* pay, const int64_t* items,
           const int64_t* segs, T* out, int64_t n_items, T scale,
           void* stream) {
  if (n_items <= 0) return 0;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tree_kernel<T, C><<<static_cast<unsigned>(n_items), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      trg, src, pay, items, segs, out, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launchers: one launch on `stream`; each returns cudaGetLastError() after
// it (0 when accepted). trg [n_trg, 3] leaf-sorted, src [n_src, 3], pay
// [n_src, 3] (G) or [n_src, 9] (H), items [n_items, 4] and segs [n_seg, 2]
// int64, out [n_trg, 3]; every target lies in exactly one item.
int tree_stokeslet_f32_launch(const float* trg, const float* src,
                              const float* pay, const int64_t* items,
                              const int64_t* segs, float* out,
                              long long n_items, float scale, void* stream) {
  return launch<float, 3>(trg, src, pay, items, segs, out, n_items, scale,
                          stream);
}

int tree_stokeslet_f64_launch(const double* trg, const double* src,
                              const double* pay, const int64_t* items,
                              const int64_t* segs, double* out,
                              long long n_items, double scale, void* stream) {
  return launch<double, 3>(trg, src, pay, items, segs, out, n_items, scale,
                           stream);
}

int tree_stresslet_f32_launch(const float* trg, const float* src,
                              const float* pay, const int64_t* items,
                              const int64_t* segs, float* out,
                              long long n_items, float scale, void* stream) {
  return launch<float, 9>(trg, src, pay, items, segs, out, n_items, scale,
                          stream);
}

int tree_stresslet_f64_launch(const double* trg, const double* src,
                              const double* pay, const int64_t* items,
                              const int64_t* segs, double* out,
                              long long n_items, double scale, void* stream) {
  return launch<double, 9>(trg, src, pay, items, segs, out, n_items, scale,
                           stream);
}

// Targets an item (the lists' run length, checked by the wrapper).
int tree_item_targets() { return kItemTargets; }

const char* tree_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
