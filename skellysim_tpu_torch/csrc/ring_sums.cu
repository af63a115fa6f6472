// Fused ring pair sums on Hopper (sm_90a): kernels E and F, float32.
//
//   E  Stokeslet ring   skellysim_tpu/parallel/ring_fused.py
//                       `_ring_kernel(kind="stokeslet")` (via
//                       `fused_ring_block_sum`)
//   F  stresslet ring   the same with kind="stresslet"
//
// Each shard of a mesh holds a resident target block [nt, 3] and a source
// block [ns, 3] with its payload ([ns, 3] forces or [ns, 9] stresslet
// components). The kernel returns, for every shard, the UNSCALED sum of its
// targets over every shard's source block (the caller applies 1/(8 pi eta);
// the stresslet's -3 is part of the sum, as in `stresslet_tile_sums`). The
// pair functors and the r == 0 select are `pair_functors.cuh`, shared with
// the tiled kernels A-D.
//
// The ring protocol of `ring_fused.py`, carried to the card. Shard k owns n
// write-once slots of ns source records. Slot s holds the source block of
// shard (k - s) mod n, so the accumulation order is the ppermute ring's: own
// block first, then the left neighbour's, and so on. At step s shard k
// pushes its slot s into its right neighbour's slot s+1 (step 0 packs its
// own block into its slot 0 and the neighbour's slot 1), computes its
// targets against slot s, and waits until its own slot s+1 is complete.
//
// Synchronisation uses monotone 64-bit epoch counters in device memory,
// never reset between calls (a memset would race with a slow neighbour):
// per shard one arrival counter per slot, an entry and an exit counter. The
// host numbers the calls of one ring (`epoch` = 1, 2, ...). A writer block
// stores its records, `__threadfence_system()`, then one system-scope
// atomic add on the receiver's counter; a reader block's thread 0 spins on
// an acquire load until the counter reaches epoch x (signals per instance),
// then `__syncthreads()` before the block reads the slot. Every shard keeps
// the ENTRY and EXIT neighbour barriers of the TPU kernel: no block pushes
// before both neighbours entered this instance, and none returns before
// both neighbours finished reading theirs. (With per-shard counters that
// name their epoch, and one launch per shard instance ordered by its
// stream, the entry barrier alone already keeps a fast neighbour out of
// slots still being read; the exit barrier keeps the guarantee for a
// layout where an instance spans several launches.) A wait that lasts
// kTimeoutNs traps: a broken ring fails its launch instead of hanging the
// card.
//
// No deadlock by construction: blocks spin on one another, so every block
// of a launch must be resident at once. The grid is persistent, sized by
// the occupancy calculator x the SM count (divided among the shards the
// launch serves), with a grid-stride loop over target tiles, and launched
// with cudaLaunchCooperativeKernel, which refuses an oversized grid instead
// of hanging. On several cards the host issues every card's launch before
// any call that blocks, and every launch of a ring uses the same grid width
// (each counter expects that many signals from its writer).
//
// One launch per card per ring call. It takes a table of every shard's
// pointers (targets, sources, payload, output, slots, counters) and the
// range of shards it serves (blockIdx.y + first). On n cards each card's
// launch serves its one shard and its stores reach the neighbour's slots
// over NVLink (peer access is enabled by `ring_enable_peer_access`); on one
// card a single launch serves all n shards and the "push" is a copy within
// the card. The device code is the same in both layouts; only the table's
// pointers differ, so a multi-process layout can fill the table from IPC
// handles without touching the kernel.
//
// What bounds it on this card: the pair arithmetic, as for A and C (22 or 40
// flops a pair at 67 TFLOP/s FP32). The slot traffic is n x ns records per
// shard, megabytes against seconds of compute at the full-width shapes.
// Design: one thread owns one target and keeps the step's partial sums in
// registers; the source records of a slot are staged through shared memory
// (vector loads that bypass L1, since another SM or card wrote them); the
// running sum of a target lives in the output between steps. Simple and
// right first: the persistent grid's tiles are not balanced across blocks,
// and the source dimension is not split (work for a later change).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "pair_functors.cuh"

namespace {

using skelly::Stokeslet;
using skelly::Stresslet;

constexpr int kMaxShards = 16;
constexpr int kThreads = 128;  // targets a tile, records staged a tile
constexpr unsigned long long kTimeoutNs = 20ull * 1000ull * 1000ull * 1000ull;
constexpr int kTableWords = 6;  // pointers a shard in the host's table

struct Shard {
  const float* trg;           // [nt, 3]
  const float* src;           // [ns, 3]
  const float* payload;       // [ns, kPayload]
  float* out;                 // [nt, 3]
  void* slots;                // [n, ns] records
  unsigned long long* flags;  // [n + 2]: arrival per slot, entry, exit
};

struct RingTable {
  Shard shard[kMaxShards];
  int n_shards;
  long long n_trg;
  long long n_src;
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every thread of the block: wait until *flag >= target (thread 0 spins),
// then the whole block may read what the signals published.
__device__ void block_wait(const unsigned long long* flag,
                           unsigned long long target, int shard,
                           const char* what) {
  if (threadIdx.x == 0) {
    if (load_acquire(flag) < target) {
      const unsigned long long t0 = global_ns();
      while (load_acquire(flag) < target) {
        __nanosleep(128);
        if (global_ns() - t0 > kTimeoutNs) {
          printf("ring_sums: shard %d block %d timed out waiting for %s "
                 "(counter %llu, need %llu)\n",
                 shard, static_cast<int>(blockIdx.x), what, load_acquire(flag),
                 target);
          __trap();
        }
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Every thread of the block: publish this thread's stores system-wide, then
// one signal per counter from the block (thread 0 fences again after the
// barrier, so the signal is ordered after every thread's stores).
__device__ void block_signal(unsigned long long* a, unsigned long long* b) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    atomicAdd_system(a, 1ull);
    if (b != nullptr) atomicAdd_system(b, 1ull);
  }
}

template <class Record>
__device__ __forceinline__ Record read_record(const Record* p) {
  static_assert(sizeof(Record) % sizeof(float4) == 0, "16-byte records");
  Record r;
  const float4* s = reinterpret_cast<const float4*>(p);
  float4* d = reinterpret_cast<float4*>(&r);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(Record) / sizeof(float4)); ++k) {
    d[k] = __ldcg(s + k);
  }
  return r;
}

template <class Record>
__device__ __forceinline__ void write_record(Record* p, const Record& r) {
  const float4* s = reinterpret_cast<const float4*>(&r);
  float4* d = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(Record) / sizeof(float4)); ++k) {
    __stcg(d + k, s[k]);
  }
}

// This block's target tiles against one slot of ns records; the step's sum
// of a target is written (first step) or added to its running sum in `out`.
template <class Pair, int kUnroll>
__device__ void accumulate(const typename Pair::Record* slot, long long ns,
                           const float* trg, float* out, long long nt,
                           bool first_step, typename Pair::Record* tile) {
  using Record = typename Pair::Record;
  const float k = Pair::finish(1.0f);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long tile0 = static_cast<long long>(blockIdx.x) * kThreads;
       tile0 < nt; tile0 += stride) {
    const long long t = tile0 + threadIdx.x;
    const bool live = t < nt;
    float tx = 0.f, ty = 0.f, tz = 0.f;
    if (live) {
      tx = trg[3 * t + 0];
      ty = trg[3 * t + 1];
      tz = trg[3 * t + 2];
    }
    float ux = 0.f, uy = 0.f, uz = 0.f;
    for (long long base = 0; base < ns; base += kThreads) {
      const long long s = base + threadIdx.x;
      __syncthreads();  // every thread is done reading the previous tile
      if (s < ns) tile[threadIdx.x] = read_record(slot + s);
      __syncthreads();
      const int count = static_cast<int>(ns - base < kThreads ? ns - base
                                                               : kThreads);
      float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll (kUnroll)
      for (int j = 0; j < count; ++j) {
        const Record rec = tile[j];
        skelly::pair_term<Pair>(rec, tx, ty, tz, px, py, pz);
      }
      ux += px;
      uy += py;
      uz += pz;
    }
    if (live) {
      if (first_step) {
        out[3 * t + 0] = ux * k;
        out[3 * t + 1] = uy * k;
        out[3 * t + 2] = uz * k;
      } else {
        out[3 * t + 0] += ux * k;
        out[3 * t + 1] += uy * k;
        out[3 * t + 2] += uz * k;
      }
    }
  }
}

template <class Pair, int kUnroll>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const RingTable table, const int first,
            const unsigned long long epoch) {
  using Record = typename Pair::Record;
  __shared__ Record tile[kThreads];

  const int n = table.n_shards;
  const int me = first + static_cast<int>(blockIdx.y);
  const int right = (me + 1) % n;
  const int left = (me + n - 1) % n;
  const Shard mine = table.shard[me];
  Record* const my_slots = static_cast<Record*>(mine.slots);
  Record* const right_slots = static_cast<Record*>(table.shard[right].slots);
  unsigned long long* const my_flags = mine.flags;
  unsigned long long* const right_flags = table.shard[right].flags;
  unsigned long long* const left_flags = table.shard[left].flags;
  const long long ns = table.n_src;
  const long long nt = table.n_trg;
  // every block of every launch of the ring signals each counter it feeds
  // once per instance; all launches share this grid width
  const unsigned long long done = epoch * gridDim.x;

  // ENTRY barrier: both neighbours entered this instance
  block_signal(left_flags + n, right_flags + n);
  block_wait(my_flags + n, 2 * done, me, "the entry barrier");

  // the records this block moves at every step
  const long long chunk = (ns + gridDim.x - 1) / gridDim.x;
  long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  c0 = c0 < ns ? c0 : ns;
  const long long c1 = c0 + chunk < ns ? c0 + chunk : ns;

  for (int s = 0; s < n; ++s) {
    if (s == 0) {
      // pack the own block into slot 0 and the right neighbour's slot 1
      for (long long i = c0 + threadIdx.x; i < c1; i += kThreads) {
        const Record rec = skelly::load_record<Pair>(mine.src, mine.payload, i);
        write_record(my_slots + i, rec);
        if (n > 1) write_record(right_slots + ns + i, rec);
      }
      block_signal(my_flags, n > 1 ? right_flags + 1 : nullptr);
      block_wait(my_flags, done, me, "its own slot 0");
    } else if (s + 1 < n) {
      // slot s -> the right neighbour's slot s + 1
      const Record* from = my_slots + s * ns;
      Record* to = right_slots + (s + 1) * ns;
      for (long long i = c0 + threadIdx.x; i < c1; i += kThreads) {
        write_record(to + i, read_record(from + i));
      }
      block_signal(right_flags + s + 1, nullptr);
    }
    accumulate<Pair, kUnroll>(my_slots + s * ns, ns, mine.trg, mine.out, nt,
                              s == 0, tile);
    if (s + 1 < n) {
      block_wait(my_flags + s + 1, done, me, "a slot from the left neighbour");
    }
  }

  // EXIT barrier: both neighbours are done reading their slots
  block_signal(left_flags + n + 1, right_flags + n + 1);
  block_wait(my_flags + n + 1, 2 * done, me, "the exit barrier");
}

template <class Pair>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&ring_kernel<Pair, Pair::kUnroll>);
}

template <class Pair>
int grid_x(int count, int device, int* out) {
  int coop = 0, sms = 0, occ = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, ring_kernel<Pair, Pair::kUnroll>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = count > 0 ? occ * sms / count : 0;
  return static_cast<int>(*out >= 1 ? cudaSuccess
                                    : cudaErrorCooperativeLaunchTooLarge);
}

template <class Pair>
int launch(const unsigned long long* ptrs, int n_shards, long long n_trg,
           long long n_src, int first, int count, int grid,
           unsigned long long epoch, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || first < 0 || count < 1 ||
      first + count > n_shards || grid < 1 || n_trg < 0 || n_src < 1 ||
      epoch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTable table = {};
  for (int k = 0; k < n_shards; ++k) {
    const unsigned long long* p = ptrs + kTableWords * k;
    table.shard[k].trg = reinterpret_cast<const float*>(p[0]);
    table.shard[k].src = reinterpret_cast<const float*>(p[1]);
    table.shard[k].payload = reinterpret_cast<const float*>(p[2]);
    table.shard[k].out = reinterpret_cast<float*>(p[3]);
    table.shard[k].slots = reinterpret_cast<void*>(p[4]);
    table.shard[k].flags = reinterpret_cast<unsigned long long*>(p[5]);
  }
  table.n_shards = n_shards;
  table.n_trg = n_trg;
  table.n_src = n_src;
  void* args[] = {&table, &first, &epoch};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of<Pair>(), dim3(grid, count), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises with the code
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of one slot record (the wrapper sizes the slot buffers with it).
int ring_record_bytes(int family) {
  return family == 0 ? static_cast<int>(sizeof(Stokeslet<float>::Record))
                     : static_cast<int>(sizeof(Stresslet<float>::Record));
}

// Widest cooperative grid (blocks a shard) for a launch serving `count`
// shards on `device`, which must be the current device. Returns a CUDA
// error code (0 on success).
int ring_stokeslet_f32_grid_x(int count, int device, int* out) {
  return grid_x<Stokeslet<float>>(count, device, out);
}

int ring_stresslet_f32_grid_x(int count, int device, int* out) {
  return grid_x<Stresslet<float>>(count, device, out);
}

// One cooperative launch serving shards [first, first + count) of an
// n_shards ring. `ptrs` holds 6 pointers a shard (targets, sources, payload,
// output, slots, counters) for every shard of the ring. Returns the launch's
// CUDA error code (0 when it was accepted).
int ring_stokeslet_f32_launch(const unsigned long long* ptrs, int n_shards,
                              long long n_trg, long long n_src, int first,
                              int count, int grid, unsigned long long epoch,
                              void* stream) {
  return launch<Stokeslet<float>>(ptrs, n_shards, n_trg, n_src, first, count,
                                  grid, epoch, stream);
}

int ring_stresslet_f32_launch(const unsigned long long* ptrs, int n_shards,
                              long long n_trg, long long n_src, int first,
                              int count, int grid, unsigned long long epoch,
                              void* stream) {
  return launch<Stresslet<float>>(ptrs, n_shards, n_trg, n_src, first, count,
                                  grid, epoch, stream);
}

// Let `device` read and write `peer`'s memory (the ring's neighbour
// stores and counter signals). Returns 0 on success or when access was
// already enabled, -1 when the pair cannot reach each other, else a CUDA
// error code. The current device is restored.
int ring_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return -1;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  const cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}

const char* ring_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
