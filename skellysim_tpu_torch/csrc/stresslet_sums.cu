// The stresslet double-layer sums on Hopper (sm_90a), designed for what
// bounds them on this card:
//
//   u_t = -3 scale sum_s (d^T S_s d) d / r^5,   d = x_t - x_s,
//
// pairs at r == 0 dropped; scale = 1/(8 pi eta), or 1 for the unscaled entry
// the ring evaluator's per-hop blocks use, and the -3 is part of the sum
// either way (the reduction pass applies -3 scale once, to the finished sum).
// Positions are row-major [n, 3], S is [n_src, 9] row-major (Sxx..Szz); the
// output is [n_trg, 3].
//
//   C  float32   replaces skellysim_tpu/ops/pallas_kernels.py
//                `_stresslet_kernel` (via `stresslet_pallas`)
//   D  float64   replaces skellysim_tpu/ops/pallas_df.py
//                `_stresslet_df_kernel` (via `stresslet_pallas_df`); native
//                FP64, where the TPU tile emulated it with f32 pairs
//
// What bounds them. Device memory does not: the work is O(n_trg * n_src)
// pairs on O(n_trg + n_src) words. C is bound by instruction issue: its pair
// (`skelly::stresslet_pair`, pair_terms.cuh, kernel F's) is 26 FP32
// instructions and one MUFU.RSQ, and every other instruction of the loop
// (shared-memory loads, the loop counter) costs an issue slot one for one on
// the card's 4 x 132 schedulers. D is bound by the FP64 pipe, 64 lanes a
// clock an SM, so the count that matters there is its FP64 instructions a
// pair: the same 25 arithmetic ones and kernel B's five-instruction rsqrt
// correction, 30. chip_smoke.py counts both from the built library's SASS.
//
// Design (kernel A's, stokeslet_sums.cu, for this pair):
//  * The 9-component pair, S d then d . (S d). The symmetric form (d^T S d
//    from the six components of S + S^T, 4 instructions fewer) was built
//    and measured: it loses the factored form of the shell's rank-one
//    density S = 2 eta n rho^T, whose d . n nearly cancels for a target on
//    the shell near a source, and missed the 1e-4 gate of
//    tests/test_torch_gpu.py there (PERF.md).
//  * R targets a thread, in registers (kR below). A staged source is read
//    from shared memory once for R pairs, as 16-byte broadcast loads: per
//    group of G sources (4 in f32, 2 in f64), 3 vectors of positions and 9
//    of S, 12 / (G R) loads a pair.
//  * The r == 0 drop is `Prec<T>`'s (pair_terms.cuh), exact: f32 adds the
//    pair by three FMAs predicated on r^2 >= FLT_MIN; f64 selects r^-1 to 0
//    unless r^2 >= DBL_MIN, compared on r^2's high word off the FP64 pipe.
//    A subnormal r^2 is dropped with it and makes no inf. A pair closer than
//    ~1e-8 overflows r^-5 in f32, as in every f32 form of the sum; the
//    discretisations never hold one.
//  * Full tiles (kTile sources) run a loop of compile-time length, unrolled
//    to 32 pairs a pass; the ragged last tile of the last chunk runs a loop
//    of runtime length.
//  * Staging by `cp.async` into a double-buffered tile: tile i + 1 lands
//    while tile i is summed, with one __syncthreads() a tile. Full tiles
//    copy 16 bytes at a time (the wrapper hands 16-byte aligned arrays, and
//    chunks start at tile multiples); the ragged tile copies 4 bytes at a
//    time.
//  * Work split over sources as well as targets: blockIdx.y is a source
//    chunk of whole tiles, and each (target block, chunk) writes its partial
//    sums to scratch [chunks, n_trg, 3]; the reduction pass adds the chunks
//    in order and applies -3 scale. No atomics: two launches on the same
//    inputs give the same bits. The plan (ops/cuda_kernels.py `pair_plan`)
//    picks the chunks so the card's block slots stay busy: the ring's
//    2,000-source hop and the body's 600 nodes give few target blocks.
//  * Members: one launch serves B independent sums of one shape (the
//    ensemble's lanes), member blockIdx.z, each with its own targets,
//    sources, payload, scratch rows and output; a chunk never reaches
//    another member's sources, and the reduction adds each member's chunks
//    in order. B = 1 is the lone sum, so a member with the lone plan's
//    chunks gets the lone launch's bits. The plan splits the sources for
//    B x n_trg targets: a batch of small members fills the SMs.
//  * Each tile is summed into a tile partial first and then added to the
//    chunk's sum, which keeps the f32 error near
//    eps * (sqrt(kTile) + sqrt(tiles a chunk) + sqrt(chunks)).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 128;     // sources a staged tile
constexpr int kPay = 9;        // S, row-major

using skelly::cp_async16;
using skelly::cp_async4;
using skelly::cp_async_commit;
using skelly::cp_async_wait_all;
using skelly::kGroup;
using skelly::Prec;
using skelly::stresslet_pair;
using skelly::unpack;

// Issue the copies of `count` sources from `first` on into one buffer.
template <typename T>
__device__ __forceinline__ void stage(T* pos, T* pay,
                                      const T* __restrict__ src,
                                      const T* __restrict__ S, int64_t first,
                                      int count) {
  const T* gp = src + 3 * first;
  const T* gs = S + kPay * first;
  if (count == kTile) {
    constexpr int kPer = 16 / sizeof(T);  // values a vector
    for (int v = threadIdx.x; v < 3 * kTile / kPer; v += kThreads) {
      cp_async16(pos + v * kPer, gp + v * kPer);
    }
    for (int v = threadIdx.x; v < kPay * kTile / kPer; v += kThreads) {
      cp_async16(pay + v * kPer, gs + v * kPer);
    }
  } else {
    constexpr int kWords = sizeof(T) / 4;  // 4-byte copies a value
    for (int w = threadIdx.x; w < 3 * count * kWords; w += kThreads) {
      cp_async4(reinterpret_cast<float*>(pos) + w,
                reinterpret_cast<const float*>(gp) + w);
    }
    for (int w = threadIdx.x; w < kPay * count * kWords; w += kThreads) {
      cp_async4(reinterpret_cast<float*>(pay) + w,
                reinterpret_cast<const float*>(gs) + w);
    }
  }
  cp_async_commit();
}

// One (target block, source chunk): R targets a thread, targets
// blockIdx.x * R * kThreads + k * kThreads + threadIdx.x (k < R), sources
// [blockIdx.y * chunk_len, min(n_src, (blockIdx.y + 1) * chunk_len)) of
// member blockIdx.z. chunk_len is a multiple of kTile. Writes the partial sums, without the -3
// and the scale, to part[blockIdx.z, blockIdx.y, t, :].
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
stresslet_chunk_kernel(const T* __restrict__ trg, const T* __restrict__ src,
                       const T* __restrict__ S, T* __restrict__ part,
                       int64_t n_trg, int64_t n_src, int64_t src_stride,
                       int64_t chunk_len) {
  using Vec = typename Prec<T>::Vec;
  constexpr int G = kGroup<T>;
  constexpr int kGroups = kTile / G;
  constexpr int kUnroll = 32 / (G * R) > 0 ? 32 / (G * R) : 1;
  static_assert(kTile % G == 0 && kGroups % kUnroll == 0, "tile shape");
  __shared__ __align__(16) T s_pos[2][3 * kTile];
  __shared__ __align__(16) T s_pay[2][kPay * kTile];

  // member blockIdx.z: its first target row and first source row (the
  // pointers themselves stay kernel parameters: offsetting them here would
  // keep four more 64-bit values live through the source loop)
  const int64_t member = blockIdx.z;
  const int64_t m_trg = member * n_trg;
  const int64_t m_src = member * src_stride;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * (R * kThreads) +
                     threadIdx.x;
  T tx[R], ty[R], tz[R], ux[R], uy[R], uz[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t t = t0 + k * kThreads;
    const bool live = t < n_trg;
    tx[k] = live ? trg[3 * (m_trg + t) + 0] : T(0);
    ty[k] = live ? trg[3 * (m_trg + t) + 1] : T(0);
    tz[k] = live ? trg[3 * (m_trg + t) + 2] : T(0);
    ux[k] = uy[k] = uz[k] = T(0);
  }

  const int64_t begin = m_src + static_cast<int64_t>(blockIdx.y) * chunk_len;
  const int64_t end = begin + chunk_len < m_src + n_src ? begin + chunk_len
                                                         : m_src + n_src;
  const int n_tiles = static_cast<int>((end - begin + kTile - 1) / kTile);
  auto tile_count = [&](int i) {
    const int64_t left = end - begin - static_cast<int64_t>(i) * kTile;
    return static_cast<int>(left < kTile ? left : kTile);
  };

  stage(s_pos[0], s_pay[0], src, S, begin, tile_count(0));
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i visible; every thread is done with tile i - 1
    if (i + 1 < n_tiles) {
      stage(s_pos[(i + 1) & 1], s_pay[(i + 1) & 1], src, S,
            begin + static_cast<int64_t>(i + 1) * kTile, tile_count(i + 1));
    }
    const T* pos = s_pos[i & 1];
    const T* pay = s_pay[i & 1];
    T px[R], py[R], pz[R];
#pragma unroll
    for (int k = 0; k < R; ++k) px[k] = py[k] = pz[k] = T(0);
    const int count = tile_count(i);
    if (count == kTile) {
#pragma unroll (kUnroll)
      for (int g = 0; g < kGroups; ++g) {
        T p[3 * G], q[kPay * G];
        const Vec* vp = reinterpret_cast<const Vec*>(pos + 3 * G * g);
        const Vec* vq = reinterpret_cast<const Vec*>(pay + kPay * G * g);
#pragma unroll
        for (int v = 0; v < 3; ++v) unpack(vp[v], p + v * G);
#pragma unroll
        for (int v = 0; v < kPay; ++v) unpack(vq[v], q + v * G);
#pragma unroll
        for (int j = 0; j < G; ++j) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            stresslet_pair(p[3 * j], p[3 * j + 1], p[3 * j + 2], q + kPay * j,
                           tx[k], ty[k], tz[k], px[k], py[k], pz[k]);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          stresslet_pair(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                         pay + kPay * j, tx[k], ty[k], tz[k], px[k], py[k],
                         pz[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ux[k] += px[k];
      uy[k] += py[k];
      uz[k] += pz[k];
    }
  }

  T* out = part + (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                       n_trg * 3;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t t = t0 + k * kThreads;
    if (t < n_trg) {
      out[3 * t + 0] = ux[k];
      out[3 * t + 1] = uy[k];
      out[3 * t + 2] = uz[k];
    }
  }
}

// out[m, i] = k * sum_c part[m, c, i] over each member m's chunks, in
// order (deterministic); n values a member.
template <typename T>
__global__ void __launch_bounds__(256)
stresslet_reduce_kernel(const T* __restrict__ part, T* __restrict__ out,
                        int64_t n, int64_t total, int chunks, T k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const T* p = part + (i / n) * chunks * n + i % n;
  T s = p[0];
  for (int c = 1; c < chunks; ++c) s += p[static_cast<int64_t>(c) * n];
  out[i] = s * k;
}

// Targets a thread of each precision's one instance (ops/cuda_kernels.py
// STRESSLET_R, tuned on the card: PERF.md). A launch refuses another R.
template <typename T>
constexpr int kR = std::is_same<T, float>::value ? 4 : 2;

template <typename T>
int launch(int r, const T* trg, const T* src, const T* S, T* part, T* out,
           int64_t n_trg, int64_t n_src, int64_t src_stride, int64_t chunk_len,
           int chunks, int members, T scale, void* stream) {
  constexpr int R = kR<T>;
  if (r != R || members < 1 || members > 65535 || src_stride < n_src) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n_trg + R * kThreads - 1) / (R * kThreads);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks),
                  static_cast<unsigned>(members));
  stresslet_chunk_kernel<T, R><<<grid, kThreads, 0, s>>>(trg, src, S, part,
                                                         n_trg, n_src,
                                                         src_stride,
                                                         chunk_len);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t n = 3 * n_trg;
  const int64_t total = n * members;
  stresslet_reduce_kernel<T>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
          part, out, n, total, chunks, T(-3) * scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, reinterpret_cast<const void*>(stresslet_chunk_kernel<T, kR<T>>),
      kThreads, 0));
}

}  // namespace

extern "C" {

// Launchers: the chunk pass and the reduction pass on `stream`, over
// `members` independent sums of one shape (member m's targets start at
// trg + 3 m n_trg, its sources and payload at row m src_stride, its output
// at out + 3 m n_trg; members = 1 is the lone sum). Each returns
// cudaGetLastError() after its launches (0 when both were accepted;
// cudaErrorInvalidValue, launching nothing, when r is not the precision's
// kR, members is outside [1, 65535] or src_stride < n_src). `part` is
// scratch of members * chunks * n_trg * 3 values; chunk_len is a multiple
// of 128; src and S are 16-byte aligned, and so is every member's
// first source (src_stride a multiple of 4 when members > 1).
int stresslet_f32_launch(int r, const float* trg, const float* src,
                         const float* S, float* part, float* out,
                         long long n_trg, long long n_src, long long src_stride,
                         long long chunk_len, int chunks, int members,
                         float scale, void* stream) {
  return launch<float>(r, trg, src, S, part, out, n_trg, n_src, src_stride,
                      chunk_len, chunks, members, scale, stream);
}

int stresslet_f64_launch(int r, const double* trg, const double* src,
                         const double* S, double* part, double* out,
                         long long n_trg, long long n_src, long long src_stride,
                         long long chunk_len, int chunks, int members,
                         double scale, void* stream) {
  return launch<double>(r, trg, src, S, part, out, n_trg, n_src, src_stride,
                      chunk_len, chunks, members, scale, stream);
}

// Resident blocks an SM of the chunk pass on the current device
// (`double_prec` 0: C, 1: D).
int stresslet_blocks_per_sm(int double_prec, int* out) {
  return double_prec ? blocks_per_sm<double>(out) : blocks_per_sm<float>(out);
}

const char* stresslet_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
