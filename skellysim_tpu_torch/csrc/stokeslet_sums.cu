// The Stokeslet pair sums on Hopper (sm_90a), designed for what bounds them
// on this card:
//
//   u_t = sum_s [ f_s / r + (d . f_s) d / r^3 ],   d = x_t - x_s,
//
// pairs at r == 0 dropped, unscaled here (the reduction pass applies
// scale = 1/(8 pi eta), or 1 for the unscaled entry). Positions and forces
// are row-major [n, 3]; the output is [n_trg, 3].
//
//   A  float32   replaces skellysim_tpu/ops/pallas_kernels.py
//                `_stokeslet_kernel` (via `stokeslet_pallas`)
//   B  float64   replaces skellysim_tpu/ops/pallas_df.py
//                `_stokeslet_df_kernel` (via `stokeslet_pallas_df`); native
//                FP64, where the TPU tile emulated it with f32 pairs
//
// What bounds them. Device memory does not: the work is O(n_trg * n_src)
// pairs on O(n_trg + n_src) words. A is bound by instruction issue: a pair
// needs 18 FP32 instructions (3 FADD, 4 FMUL, 10 FFMA, 1 FSETP) and one
// MUFU.RSQ, and the card issues one warp instruction a clock on each of
// its 4 x 132 schedulers, so every other instruction in the loop
// (shared-memory loads, the rsqrt's denormal fix-up, loop counters) costs
// time one for one. B is bound by the FP64 pipe, 64 lanes a clock an SM
// (half the issue rate), so the count that matters there is its FP64
// instructions a pair: 22 (3 DADD, 6 DMUL, 13 DFMA). chip_smoke.py counts
// both from the built library's SASS.
//
// Design:
//  * R targets a thread, in registers (kR below: 8 for A, 2 for B). A
//    staged source is read from shared memory once for R pairs, as 16-byte broadcast loads: 3 vectors carry
//    the positions of 4 f32 (2 f64) sources and 3 more their forces, so a
//    pair costs 1.5 / R (f32) or 3 / R (f64) load instructions.
//  * The pair in its fewest instructions (`pair_terms.cuh`, shared with
//    the ring kernels E and F): c = (d . f) r^-2 and
//    u += r^-1 (f + c d), three FFMA for f + c d and three for the sum,
//    no r^-3. f32: `rsqrt.approx.ftz.f32` inline, one MUFU with no
//    denormal fix-up (the compile flags stay the same for every kernel).
//    f64: `rsqrt.approx.ftz.f64` as a seed and one third-order correction
//    y (1 + e/2 + 3e^2/8), e = 1 - x y^2, in five FP64 instructions, where
//    the library's rsqrt(double) guards inputs this kernel never passes it.
//    The seed's error and the result's are measured on the card by
//    `rsqrt_f64_probe` (tests/test_torch_gpu.py, chip_smoke.py): the seed
//    holds ~2^-20, so one third-order step leaves ~2.5 (2^-20)^3, below f64
//    rounding, where two Newton steps would take seven instructions and
//    one Newton step would leave ~1e-12.
//  * The r == 0 drop is a select, never a multiply, and exact. f32: a
//    predicate on the three FMAs that add the pair to the sum (inline
//    PTX), so a dropped pair adds nothing and the select costs one compare;
//    the pair is added only when r^2 >= FLT_MIN. f64: r^-1 selected to 0
//    unless r^2 >= DBL_MIN, compared on r^2's high word on the integer
//    pipe, so the FP64 pipe does not pay for it. A subnormal r^2, which
//    the ftz rsqrt would flush to 0 and turn into inf, is dropped with it:
//    the pairs dropped are those closer than sqrt(FLT_MIN) = 1.1e-19 (f32)
//    or sqrt(DBL_MIN) = 1.5e-154 (f64), coincident pairs included. The
//    plain version drops only r == 0; nothing closer than 1e-19 but apart
//    occurs in a fiber, shell or body discretisation.
//  * Full tiles (kTile sources) run a loop of compile-time length, with no
//    bounds check and no remainder path; it is unrolled kUnroll groups at a
//    time, 32 pairs a pass: its counter and branch cost ~0.2 instructions
//    a pair. A full unroll of a tile would be ~20,000 instructions (~320 KB
//    of code) at R = 8, far beyond the SM's instruction cache. The ragged
//    last tile of the last chunk runs a separate loop with a runtime count.
//  * Staging by `cp.async` into a double-buffered tile: tile i + 1 lands
//    while tile i is summed, with one __syncthreads() a tile (it both
//    publishes tile i and retires tile i - 1's buffer). Full tiles copy 16
//    bytes at a time (the wrapper hands 16-byte aligned arrays, and chunks
//    start at tile multiples); the ragged tile copies 4 bytes at a time.
//  * Work split over sources as well as targets: blockIdx.y is a source
//    chunk, and each (target block, chunk) writes its own partial sums to
//    scratch [chunks, n_trg, 3]; a second pass (`stokeslet_reduce_kernel`)
//    adds the chunks in order and applies the scale. No atomics: two
//    launches on the same inputs give the same bits. The plan picks the
//    chunk count so the last wave of blocks on the card is not mostly idle
//    (A's 136,000 targets at 1,024 a block give 133 blocks: one an SM).
//  * Members: one launch serves B independent sums of one shape (the
//    ensemble's lanes), member blockIdx.z, each with its own targets,
//    sources, payload, scratch rows and output; a chunk never reaches
//    another member's sources, and the reduction adds each member's chunks
//    in order. B = 1 is the lone sum, so a member with the lone plan's
//    chunks gets the lone launch's bits. The plan splits the sources for
//    B x n_trg targets: a batch of small members fills the SMs.
//  * Inside a chunk each tile is summed into a tile partial first and then
//    added to the chunk's sum, which keeps the f32 error near
//    eps * (sqrt(kTile) + sqrt(tiles a chunk) + sqrt(chunks)).
//
// Tensor cores do not fit this sum. Forming r^2 or d . f as a K = 3 matrix
// product (|t|^2 + |s|^2 - 2 t . s) cancels catastrophically: in the 10k
// box (side 20) |t|^2 ~ 100 while r^2 ~ 1e-8 for the nearest pairs, below
// f32 and TF32 resolution of 100, and the rsqrt and the select are per-pair
// work no matrix unit does.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "pair_terms.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 128;     // sources a staged tile

using skelly::cp_async16;
using skelly::cp_async4;
using skelly::cp_async_commit;
using skelly::cp_async_wait_all;
using skelly::kGroup;
using skelly::Prec;
using skelly::stokeslet_pair;
using skelly::unpack;

// Issue the copies of `count` sources from `first` on into one buffer.
template <typename T>
__device__ __forceinline__ void stage(T* pos, T* frc,
                                      const T* __restrict__ src,
                                      const T* __restrict__ f, int64_t first,
                                      int count) {
  const T* gp = src + 3 * first;
  const T* gf = f + 3 * first;
  if (count == kTile) {
    constexpr int kVecs = 3 * kTile * sizeof(T) / 16;  // a buffer's vectors
    for (int v = threadIdx.x; v < kVecs; v += kThreads) {
      cp_async16(pos + v * (16 / sizeof(T)), gp + v * (16 / sizeof(T)));
      cp_async16(frc + v * (16 / sizeof(T)), gf + v * (16 / sizeof(T)));
    }
  } else {
    constexpr int kWords = sizeof(T) / 4;  // 4-byte copies a value
    const int n = 3 * count * kWords;
    for (int w = threadIdx.x; w < n; w += kThreads) {
      cp_async4(reinterpret_cast<float*>(pos) + w,
                reinterpret_cast<const float*>(gp) + w);
      cp_async4(reinterpret_cast<float*>(frc) + w,
                reinterpret_cast<const float*>(gf) + w);
    }
  }
  cp_async_commit();
}

// ------------------------------------------------------------------ kernels
// One (target block, source chunk): R targets a thread, targets
// blockIdx.x * R * kThreads + k * kThreads + threadIdx.x (k < R), sources
// [blockIdx.y * chunk_len, min(n_src, (blockIdx.y + 1) * chunk_len)) of
// member blockIdx.z. chunk_len is a multiple of kTile. Writes the unscaled partial sums to
// part[blockIdx.z, blockIdx.y, t, :].
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
stokeslet_chunk_kernel(const T* __restrict__ trg, const T* __restrict__ src,
                       const T* __restrict__ f, T* __restrict__ part,
                       int64_t n_trg, int64_t n_src, int64_t src_stride,
                       int64_t chunk_len) {
  using Vec = typename Prec<T>::Vec;
  constexpr int G = kGroup<T>;
  constexpr int kGroups = kTile / G;
  constexpr int kUnroll = 32 / (G * R) > 0 ? 32 / (G * R) : 1;
  static_assert(kTile % G == 0 && kGroups % kUnroll == 0, "tile shape");
  __shared__ __align__(16) T s_pos[2][3 * kTile];
  __shared__ __align__(16) T s_frc[2][3 * kTile];

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

  stage(s_pos[0], s_frc[0], src, f, begin, tile_count(0));
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i visible; every thread is done with tile i - 1
    if (i + 1 < n_tiles) {
      stage(s_pos[(i + 1) & 1], s_frc[(i + 1) & 1], src, f,
            begin + static_cast<int64_t>(i + 1) * kTile, tile_count(i + 1));
    }
    const T* pos = s_pos[i & 1];
    const T* frc = s_frc[i & 1];
    T px[R], py[R], pz[R];
#pragma unroll
    for (int k = 0; k < R; ++k) px[k] = py[k] = pz[k] = T(0);
    const int count = tile_count(i);
    if (count == kTile) {
#pragma unroll (kUnroll)
      for (int g = 0; g < kGroups; ++g) {
        T p[3 * G], q[3 * G];
        const Vec* vp = reinterpret_cast<const Vec*>(pos + 3 * G * g);
        const Vec* vq = reinterpret_cast<const Vec*>(frc + 3 * G * g);
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          unpack(vp[v], p + v * G);
          unpack(vq[v], q + v * G);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            stokeslet_pair(p[3 * j], p[3 * j + 1], p[3 * j + 2], q[3 * j],
                           q[3 * j + 1], q[3 * j + 2], tx[k], ty[k], tz[k],
                           px[k], py[k], pz[k]);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          stokeslet_pair(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                         frc[3 * j], frc[3 * j + 1], frc[3 * j + 2], tx[k],
                         ty[k], tz[k], px[k], py[k], pz[k]);
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

// out[m, i] = scale * sum_c part[m, c, i] over each member m's chunks, in
// order (deterministic); n values a member.
template <typename T>
__global__ void __launch_bounds__(256)
stokeslet_reduce_kernel(const T* __restrict__ part, T* __restrict__ out,
                        int64_t n, int64_t total, int chunks, T scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const T* p = part + (i / n) * chunks * n + i % n;
  T s = p[0];
  for (int c = 1; c < chunks; ++c) s += p[static_cast<int64_t>(c) * n];
  out[i] = s * scale;
}

// Targets a thread, tuned on the card (PERF.md): A runs R = 8 (127
// registers, 4 blocks an SM); B runs R = 2 (80 registers, 6 blocks an SM),
// since B's R = 8 needs more than 255 registers a thread and spills. The
// plan in ops/cuda_kernels.py passes its R, and a launch refuses another.
template <typename T>
constexpr int kR = std::is_same<T, float>::value ? 8 : 2;

template <typename T>
int launch(int r, const T* trg, const T* src, const T* f, T* part, T* out,
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
  stokeslet_chunk_kernel<T, R><<<grid, kThreads, 0, s>>>(trg, src, f, part,
                                                         n_trg, n_src,
                                                         src_stride,
                                                         chunk_len);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t n = 3 * n_trg;
  const int64_t total = n * members;
  stokeslet_reduce_kernel<T>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
          part, out, n, total, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, reinterpret_cast<const void*>(stokeslet_chunk_kernel<T, kR<T>>),
      kThreads, 0));
}

__global__ void rsqrt_f64_probe_kernel(const double* __restrict__ x,
                                       double* __restrict__ seed,
                                       double* __restrict__ y, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  seed[i] = Prec<double>::seed(x[i]);
  y[i] = Prec<double>::rsqrt(x[i]);
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
// of 128; src and f are 16-byte aligned, and so is every member's
// first source (src_stride a multiple of 4 when members > 1).
int stokeslet_f32_launch(int r, const float* trg, const float* src,
                         const float* f, float* part, float* out,
                         long long n_trg, long long n_src, long long src_stride,
                         long long chunk_len, int chunks, int members,
                         float scale, void* stream) {
  return launch<float>(r, trg, src, f, part, out, n_trg, n_src, src_stride,
                      chunk_len, chunks, members, scale, stream);
}

int stokeslet_f64_launch(int r, const double* trg, const double* src,
                         const double* f, double* part, double* out,
                         long long n_trg, long long n_src, long long src_stride,
                         long long chunk_len, int chunks, int members,
                         double scale, void* stream) {
  return launch<double>(r, trg, src, f, part, out, n_trg, n_src, src_stride,
                      chunk_len, chunks, members, scale, stream);
}

// Resident blocks an SM of the current device (`double_prec` 0: A, 1: B).
int stokeslet_blocks_per_sm(int double_prec, int* out) {
  return double_prec ? blocks_per_sm<double>(out) : blocks_per_sm<float>(out);
}

// B's reciprocal square root on n values: the seed and the corrected result.
int rsqrt_f64_probe_launch(const double* x, double* seed, double* y,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  rsqrt_f64_probe_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, seed, y, n);
  return static_cast<int>(cudaGetLastError());
}

const char* stokeslet_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
