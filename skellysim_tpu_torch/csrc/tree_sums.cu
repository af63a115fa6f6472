// The treecode's pair sums on Hopper (sm_90a): kernels G and H.
//
//   G  Stokeslet   u_t = sum_s [ f_s / r + (d . f_s) d / r^3 ]
//   H  stresslet   u_t = sum_s -3 (d^T S_s d) d / r^5
//
// d = x_t - x_s, pairs at r == 0 dropped (the precision's rule in
// pair_terms.cuh), times scale = 1/(8 pi eta). Each in float32 and float64.
// They replace no Pallas kernel: the JAX package sums the treecode's near
// and far fields in plain XLA (skellysim_tpu/ops/treecode.py `_tree_eval`,
// its `near_rows` / `far_rows` over `_stokeslet_rows` / `_stresslet_rows`),
// gathering each target's own padded sources, which on this card would be
// terabytes of gathered tensors a sum at 640,000 nodes.
//
// The work comes as lists (ops/treecode.py `_segment_lists`). The targets
// are sorted by leaf. An item is a run of at most kItemTargets targets of
// one leaf, with the leaf's segments: (first source, sources) runs of one
// source array that holds the bucketed sources (near: the 27 neighbor
// leaves' occupied slots) and the flat proxies (far: p^3 a cell of the
// leaf's interaction list). Near and far are the same pair sum, so one pass
// takes both.
//
// What bounds them. Like kernels A-D, the pair arithmetic: the far field is
// 99% of the pairs at 640,000 nodes (5.86e10 of 5.91e10 at tol 1e-4), on
// O(n) words, so instruction issue bounds the f32 instances and the FP64
// pipe the f64 ones. Unlike A-D, a target sees only its own lists, so
// targets cannot share staged sources across leaves, and leaves are small
// (mean 37 targets, median 32 at 640,000 fiber nodes).
//
// Design. The first design (kept below as `tree_v1_kernel`, the yardstick
// `tree_*_v1`) gave each lane one target of an item of <= 32 and each warp
// whole segments; it reached half of its issue bound. What held it back,
// and what this design does about each:
//  1. Idle lanes: a 37-target leaf made items of 32 and 5, and 27 lanes of
//     the second computed for nothing (0.69 of the lane pairs busy). Here a
//     warp serves T targets x S source slices, T S = 32, with R = 2 targets
//     a lane: an item of n targets takes the smallest T (a power of two, at
//     least kMinLanes) with R T >= n, and lane (t, s) sums slice s of every
//     staged tile for targets t and t + T. The lists split a leaf into items
//     of 64, 32, 16 and 8 targets (`_segment_lists`), so a 37-target leaf
//     issues 32 + 8 target slots, not 64. At the end of the item the S slice
//     sums are added by `__shfl_xor_sync` in a fixed butterfly, then the
//     warps in warp order: two launches on the same inputs give the same
//     bits, with no atomics.
//  2. One shared-memory read a pair: with R = 2 a staged source serves two
//     targets, and sources are read as 16-byte vectors in groups of kGroup
//     (4 in f32, 2 in f64): 3 vectors of positions and C of payload a group
//     (G f32: 0.75 loads a pair, H f32 1.5; the first design ~4).
//  3. Serial staging: each warp stages its tiles by `cp.async` into two
//     buffers of its own, so tile i + 1's copies fly while tile i is summed
//     (one __syncwarp a tile, no block barrier in the loop). Copies are 16
//     bytes where the source run is 16-byte aligned (every run at p = 6:
//     the bucket capacity is a multiple of 8 and p^3 = 216), else a value at
//     a time.
//  4. The slow tail: the first design ran a tile shorter than its stage in a
//     loop a pair at a time, which took the last 24 of every 216-proxy far
//     segment. Here every tile runs the same loop, a group (kGroup sources x
//     R targets) an iteration; a short tile only leaves some slices a group
//     short, and a group's missing sources are zero-payload records at 1e18
//     (they add exact zeros). The lists are not padded.
//  The warp's segments are its item's segments round robin over the kWarps
//  warps; each segment's pairs are summed into a segment partial first and
//  then added to the lane's sum, which keeps the f32 error near eps *
//  (sqrt(segment length / S) + sqrt(segments)). The pair code is
//  pair_terms.cuh's (`stokeslet_pair`, `stresslet_pair`), shared with A-F.
//  The family's -3 and the scale are applied once, to the finished sum.
//  Shared memory: kWarps x 2 buffers x kStage x (3 + C) values (G 24 KiB,
//  H 48 KiB a block in either precision), dynamic, reused by the final
//  reduction.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair_terms.cuh"

namespace {

using skelly::cp_async16;
using skelly::cp_async4;
using skelly::cp_async_commit;
using skelly::cp_async_wait_all;
using skelly::kGroup;
using skelly::Prec;
using skelly::stokeslet_pair;
using skelly::stresslet_pair;
using skelly::unpack;

constexpr int kWarps = 4;                 // warps a block (an item)
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 2;                     // targets a lane
constexpr int kItemTargets = 32 * kR;     // targets an item at most
constexpr int kMinLanes = 4;              // target lanes a warp at least
// Sources a staged tile: 128 in f32, 64 in f64 (a buffer 3 KiB for G, 6 KiB
// for H). 64 f32 sources (the first build) ran 8% slower; 128 f64 sources
// cost H's f64 instance half its resident blocks and 20% of its speed.
template <typename T>
constexpr int kStage = 512 / sizeof(T);

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

// The target lanes T of an item of n targets: the smallest power of two,
// at least kMinLanes, with kR T >= n (ops/cuda_kernels.py
// `tree_item_lanes` is its mirror).
__device__ __forceinline__ int item_lanes(int n) {
  int lanes = kMinLanes;
  while (lanes < 32 && kR * lanes < n) lanes <<= 1;
  return lanes;
}

__device__ __forceinline__ void cp_async_value(float* dst, const float* src) {
  cp_async4(dst, src);
}

__device__ __forceinline__ void cp_async_value(double* dst,
                                               const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src)
               : "memory");
}

// Wait until at most the newest commit group is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Issue the warp's copies of n values from global to shared (dst 16-byte
// aligned): 16 bytes at a time where src is 16-byte aligned, else a value
// at a time.
template <typename T>
__device__ __forceinline__ void copy_values(T* dst, const T* src, int n,
                                            int lane) {
  constexpr int kV = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = n / kV;
    for (int v = lane; v < vecs; v += 32) {
      cp_async16(dst + v * kV, src + v * kV);
    }
    done = vecs * kV;
  }
  for (int w = done + lane; w < n; w += 32) cp_async_value(dst + w, src + w);
}

// Stage n <= kStage sources from `first` on into one buffer: positions
// [3 kStage], then payload [C kStage]. The rest of the last group becomes
// zero-payload records at 1e18, which add exact zeros.
template <typename T, int C>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ src,
                                      const T* __restrict__ pay,
                                      int64_t first, int n, int lane) {
  T* pos = buf;
  T* q = buf + 3 * kStage<T>;
  copy_values(pos, src + 3 * first, 3 * n, lane);
  copy_values(q, pay + C * first, C * n, lane);
  const int padded = (n + kGroup<T> - 1) / kGroup<T> * kGroup<T>;
  for (int w = 3 * n + lane; w < 3 * padded; w += 32) pos[w] = T(1e18);
  for (int w = C * n + lane; w < C * padded; w += 32) q[w] = T(0);
}

// Slice s of S of a staged tile of n sources, for targets a and b, added to
// the segment partials pa and pb: a group an iteration.
template <typename T, int C>
__device__ __forceinline__ void sum_tile(const T* buf, int n, int s, int S,
                                         const T* a, const T* b, T* pa,
                                         T* pb) {
  using Vec = typename Prec<T>::Vec;
  constexpr int kG = kGroup<T>;
  constexpr int kV = 16 / sizeof(T);
  const Vec* pos = reinterpret_cast<const Vec*>(buf);
  const Vec* q = reinterpret_cast<const Vec*>(buf + 3 * kStage<T>);
  const int groups = (n + kG - 1) / kG;
#pragma unroll 1
  for (int g = s; g < groups; g += S) {
    T p[3 * kG];
    T f[C * kG];
#pragma unroll
    for (int v = 0; v < 3; ++v) unpack(pos[3 * g + v], p + v * kV);
#pragma unroll
    for (int v = 0; v < C; ++v) unpack(q[C * g + v], f + v * kV);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      pair<T, C>(p + 3 * j, f + C * j, a[0], a[1], a[2], pa[0], pa[1], pa[2]);
      pair<T, C>(p + 3 * j, f + C * j, b[0], b[1], b[2], pb[0], pb[1], pb[2]);
    }
  }
}

// One item a block: items[4 i .. 4 i + 3] = (first target, targets, first
// segment, segments); segs[2 g], segs[2 g + 1] = (first source, sources).
// Writes out[t] = scale * sum for the item's targets t (leaf-sorted order).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
tree_kernel(const T* __restrict__ trg, const T* __restrict__ src,
            const T* __restrict__ pay, const int64_t* __restrict__ items,
            const int64_t* __restrict__ segs, T* __restrict__ out, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kStg = kStage<T>;
  constexpr int kBuf = (3 + C) * kStg;  // values a buffer

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t* item = items + 4 * static_cast<int64_t>(blockIdx.x);
  const int64_t t0 = item[0];
  const int n = static_cast<int>(item[1]);
  const int64_t g_end = item[2] + item[3];
  const int lanes = item_lanes(n);
  const int shift = __ffs(lanes) - 1;
  const int t = lane & (lanes - 1);  // target lane
  const int s = lane >> shift;       // source slice
  const int S = 32 >> shift;         // slices
  const bool live_a = t < n;
  const bool live_b = t + lanes < n;
  T a[3] = {T(0), T(0), T(0)};
  T b[3] = {T(0), T(0), T(0)};
  if (live_a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = trg[3 * (t0 + t) + k];
  }
  if (live_b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = trg[3 * (t0 + t + lanes) + k];
  }

  T u[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};  // a's sum, then b's
  T* bufs = smem + warp * 2 * kBuf;
  int64_t g = item[2] + warp;
  if (g < g_end) {
    int64_t first = segs[2 * g];
    int64_t len = segs[2 * g + 1];
    int64_t c0 = 0;
    int cur = 0;
    int n_cur = static_cast<int>(len < kStg ? len : kStg);
    T p[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};  // segment partials
    stage<T, C>(bufs, src, pay, first, n_cur, lane);
    cp_async_commit();
    for (;;) {
      // the warp's next tile: the rest of this segment, else its next one
      const bool seg_done = c0 + kStg >= len;
      int64_t g2 = g, first2 = first, len2 = len, c2 = c0 + kStg;
      if (seg_done) {
        g2 = g + kWarps;
        c2 = 0;
        if (g2 < g_end) {
          first2 = segs[2 * g2];
          len2 = segs[2 * g2 + 1];
        }
      }
      const bool more = g2 < g_end;
      int n_next = 0;
      if (more) {
        n_next = static_cast<int>(len2 - c2 < kStg ? len2 - c2 : kStg);
        stage<T, C>(bufs + (cur ^ 1) * kBuf, src, pay, first2 + c2, n_next,
                    lane);
      }
      cp_async_commit();
      cp_async_wait_one();  // this tile has landed; the next may still fly
      __syncwarp();
      sum_tile<T, C>(bufs + cur * kBuf, n_cur, s, S, a, b, p, p + 3);
      __syncwarp();  // every lane is done with this buffer before its reuse
      if (seg_done) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          u[k] += p[k];
          p[k] = T(0);
        }
      }
      if (!more) break;
      g = g2;
      first = first2;
      len = len2;
      c0 = c2;
      n_cur = n_next;
      cur ^= 1;
    }
  }
  cp_async_wait_all();

  // the slices of a target, in a fixed butterfly
  for (int o = 16; o >= lanes; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) u[k] += __shfl_xor_sync(0xffffffffu, u[k], o);
  }
  __syncthreads();  // every warp is done with its buffers: they become scratch
  T* red = smem;    // [kWarps][6][32]
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) red[(warp * 6 + k) * 32 + t] = u[k];
  }
  __syncthreads();
  if (warp == 0 && s == 0) {
    T v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = red[k * 32 + t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] += red[(w * 6 + k) * 32 + t];
    }
    const T sc = C == 9 ? T(-3) * scale : scale;
    if (live_a) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * (t0 + t) + k] = v[k] * sc;
    }
    if (live_b) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out[3 * (t0 + t + lanes) + k] = v[3 + k] * sc;
    }
  }
}

template <typename T, int C>
constexpr int kSharedBytes = kWarps * 2 * (3 + C) * kStage<T> * sizeof(T);

template <typename T, int C>
int launch(const T* trg, const T* src, const T* pay, const int64_t* items,
           const int64_t* segs, T* out, int64_t n_items, T scale,
           void* stream) {
  static_assert(kWarps * 6 * 32 <= kWarps * 2 * (3 + C) * kStage<T>,
                "the final reduction's scratch fits the staging buffers");
  if (n_items <= 0) return 0;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = kSharedBytes<T, C>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tree_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tree_kernel<T, C><<<static_cast<unsigned>(n_items), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      trg, src, pay, items, segs, out, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- the first design (yardstick)
// One block of kV1Warps warps an item of <= 32 targets, one target a lane
// (lanes past the item's count compute and discard); the item's segments
// round robin over the warps, each staged by its warp through shared memory
// kV1Stage sources at a time with plain loads; a full stage unrolled, a
// short one a pair at a time; the warps' sums added in warp order.

constexpr int kV1Warps = 4;
constexpr int kV1Threads = 32 * kV1Warps;
constexpr int kV1ItemTargets = 32;
constexpr int kV1Stage = 64;
// H's f32 instance spilled 4 bytes at an unroll of 8; at 4 none.
constexpr int kV1UnrollG = 8;
constexpr int kV1UnrollH = 4;

template <typename T, int C>
__global__ void __launch_bounds__(kV1Threads)
tree_v1_kernel(const T* __restrict__ trg, const T* __restrict__ src,
               const T* __restrict__ pay, const int64_t* __restrict__ items,
               const int64_t* __restrict__ segs, T* __restrict__ out,
               T scale) {
  __shared__ __align__(16) T s_pos[kV1Warps][3 * kV1Stage];
  __shared__ __align__(16) T s_pay[kV1Warps][C * kV1Stage];
  __shared__ T s_sum[kV1Warps][3][kV1ItemTargets];

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
  constexpr int kUnroll = C == 9 ? kV1UnrollH : kV1UnrollG;

  T ux = T(0), uy = T(0), uz = T(0);
  for (int64_t g = item[2] + warp; g < g_end; g += kV1Warps) {
    const int64_t first = segs[2 * g];
    const int64_t len = segs[2 * g + 1];
    T px = T(0), py = T(0), pz = T(0);
    for (int64_t c0 = 0; c0 < len; c0 += kV1Stage) {
      const int n = static_cast<int>(len - c0 < kV1Stage ? len - c0
                                                         : kV1Stage);
      const T* gp = src + 3 * (first + c0);
      const T* gq = pay + C * (first + c0);
      for (int w = lane; w < 3 * n; w += 32) pos[w] = gp[w];
      for (int w = lane; w < C * n; w += 32) q[w] = gq[w];
      __syncwarp();
      if (n == kV1Stage) {
#pragma unroll (kUnroll)
        for (int j = 0; j < kV1Stage; ++j) {
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
    for (int w = 1; w < kV1Warps; ++w) {
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
int launch_v1(const T* trg, const T* src, const T* pay, const int64_t* items,
              const int64_t* segs, T* out, int64_t n_items, T scale,
              void* stream) {
  if (n_items <= 0) return 0;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tree_v1_kernel<T, C><<<static_cast<unsigned>(n_items), kV1Threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      trg, src, pay, items, segs, out, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launchers: one launch on `stream`; each returns cudaGetLastError() after
// it (0 when accepted). trg [n_trg, 3] leaf-sorted, src [n_src, 3], pay
// [n_src, 3] (G) or [n_src, 9] (H), items [n_items, 4] and segs [n_seg, 2]
// int64, out [n_trg, 3]; every target lies in exactly one item, of at most
// tree_item_targets() targets (the _v1 launchers: tree_v1_item_targets()).
#define TREE_LAUNCHER(NAME, FN, T, C)                                        \
  int NAME(const T* trg, const T* src, const T* pay, const int64_t* items,  \
           const int64_t* segs, T* out, long long n_items, T scale,         \
           void* stream) {                                                  \
    return FN<T, C>(trg, src, pay, items, segs, out, n_items, scale,        \
                    stream);                                                \
  }

TREE_LAUNCHER(tree_stokeslet_f32_launch, launch, float, 3)
TREE_LAUNCHER(tree_stokeslet_f64_launch, launch, double, 3)
TREE_LAUNCHER(tree_stresslet_f32_launch, launch, float, 9)
TREE_LAUNCHER(tree_stresslet_f64_launch, launch, double, 9)
TREE_LAUNCHER(tree_stokeslet_f32_v1_launch, launch_v1, float, 3)
TREE_LAUNCHER(tree_stokeslet_f64_v1_launch, launch_v1, double, 3)
TREE_LAUNCHER(tree_stresslet_f32_v1_launch, launch_v1, float, 9)
TREE_LAUNCHER(tree_stresslet_f64_v1_launch, launch_v1, double, 9)

#undef TREE_LAUNCHER

// Targets an item at most (the lists' split, checked by the wrapper), and
// the first design's.
int tree_item_targets() { return kItemTargets; }
int tree_v1_item_targets() { return kV1ItemTargets; }

// Dynamic shared bytes of a launch of kernel G (cols 3) or H (cols 9), in
// f32 (f64 == 0) or f64.
int tree_shared_bytes(int cols, int f64) {
  if (cols == 3) {
    return f64 ? kSharedBytes<double, 3> : kSharedBytes<float, 3>;
  }
  return f64 ? kSharedBytes<double, 9> : kSharedBytes<float, 9>;
}

const char* tree_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
