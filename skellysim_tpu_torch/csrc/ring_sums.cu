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
// the stresslet's -3 is part of the sum, applied once by the reduction).
//
// The ring protocol of `ring_fused.py`, carried to the card. Shard k owns n
// write-once slots. Slot s holds the source block of shard (k - s) mod n,
// so the accumulation order is the ppermute ring's: own block first, then
// the left neighbour's, and so on. At step s shard k pushes its slot s into
// its right neighbour's slot s+1 (step 0 packs its own block into its slot 0
// and the neighbour's slot 1), computes its targets against slot s, and
// waits until its own slot s+1 is complete.
//
// Synchronisation uses monotone 64-bit epoch counters in device memory,
// never reset between calls (a memset would race with a slow neighbour):
// per shard one arrival counter per slot, an entry and an exit counter. The
// host numbers the calls of one ring (`epoch` = 1, 2, ...). A writer block
// stores its slot words, `__threadfence_system()`, then one system-scope
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
// launch serves; the plan in ops/cuda_kernels.py computes it), and launched
// with cudaLaunchCooperativeKernel, which refuses an oversized grid instead
// of hanging. On several cards the host issues every card's launch before
// any call that blocks, and every launch of a ring uses the same grid width
// (each counter expects that many signals from its writer).
//
// One launch per card per ring call. It takes a table of every shard's
// pointers (targets, sources, payload, output, slots, counters, partial
// sums) and the range of shards it serves (blockIdx.y + first). On n cards
// each card's launch serves its one shard and its stores reach the
// neighbour's slots over NVLink (peer access is enabled by
// `ring_enable_peer_access`); on one card a single launch serves all n
// shards and the "push" is a copy within the card. The device code is the
// same in both layouts; only the table's pointers differ.
//
// Across processes (one process a card; ops/cuda_kernels.py `_IpcRing`)
// each process fills the table's entries of its own shards and, for a
// neighbour that another process holds, only that neighbour's slots and
// counters, mapped by CUDA IPC (`ring_ipc_alloc` / `ring_ipc_open`); its
// other pointers stay null. That is enough: a launch reads and writes its
// own shards' entries (`mine`), and of a neighbour only the right one's
// slots and the two neighbours' counters (`ring_kernel` below); the
// reduction reads its own shards' only.
//
// What bounds it on this card: instruction issue, as for kernel A. The slot
// traffic is n x ns x 6 (E) or 12 (F) words a shard, megabytes against
// milliseconds of pair arithmetic at the full-width shapes. A Stokeslet pair
// is 18 FP32 instructions and a MUFU.RSQ (`skelly::stokeslet_pair`), a
// stresslet pair 26 and a MUFU.RSQ (`skelly::stresslet_pair`); both live in
// pair_terms.cuh with kernel A's, so the kernels cannot drift.
//
// Design (`TilePath`), kernel A's inside every ring step:
//  * The slot is the kernel's own layout, tile-major: per tile of kTile
//    sources, 3 x kTile position words (row-major x, y, z), then
//    kPay x kTile payload words (row-major forces or S): 6 (E) or 12 (F)
//    words a source, where the first design's records took 8 (E). The last
//    tile of a slot is padded to kTile sources, so every tile is full and
//    the hot loop has one compile-time length. A pad holds zero payload AND
//    the far-away position kPadPosition (the JAX package's _PAD_SENTINEL):
//    its r^2 ~ 3e36 passes the drop's compare, r^-1 ~ 6e-19 is finite, and
//    its term is (0 payload) x finite = exactly 0 for any target, where a
//    pad at the origin would give the stresslet 0 x inf for a target within
//    ~1e-8 of it.
//  * R targets a thread, in registers (kR below); a staged source is read
//    from shared memory once for R pairs, as 16-byte broadcast loads (3
//    vectors carry 4 sources' positions, kPay more their payload).
//  * The step's tiles are staged with `cp.async.cg` (through L2: another
//    SM or card wrote the slot), double-buffered, one __syncthreads() a
//    tile; the first copy of a step is issued after the block's acquire
//    wait for that slot.
//  * The sources of every step are split too. A work item is (target block
//    of R x kThreads targets, chunk of whole tiles) of the current slot;
//    over the call block b takes the items whose running index
//    (step x items + item) is b mod the grid, so a step's ragged last round
//    of items and the next step's first round fall on different blocks and
//    run side by side (a fixed split per step would give the same blocks
//    the extra item at every step). A slot is complete only when every
//    block of the left neighbour has finished its items of the step before
//    the previous one, so at most two steps are in flight: the plan fills
//    the card with one step's items (its busy share is a step's). Each item
//    writes its partial sums to part [n steps, chunks, nt, 3] on the
//    shard's device, each tile's partial summed apart before it joins the
//    item's sum; no atomics. A second ordinary launch on the same stream
//    (`ring_reduce_kernel`) adds the partials in a fixed order, step-major
//    then chunk, applies the family's constant and writes `out`: two
//    launches on the same inputs give the same bits. The plan
//    (`ring_plan`) adds chunks until 95% of a step's block slots are busy
//    on the whole card's grid (one shard a card), or until a chunk is one
//    tile. The split sets the order of the sums, so it is planned for that
//    one grid whatever the layout: the same shards give the same bits on
//    one card as on one card each. A launch that serves s shards gives
//    each the card's grid / s, which the same items fill at least as well
//    where s divides the card's grid.
//  * What a step's wait costs: the slot a block waits for was pushed by the
//    left neighbour's blocks at the START of their previous step, so a
//    block that reaches it after a round of that step's items finds it
//    complete and pays one acquire load and a __syncthreads(), ~1-2 us,
//    against ~0.2 ms of pair work a step for F at 2,000 sources x 32,000
//    targets a shard (E's steps are ~15x longer). Only the entry and exit
//    barriers wait on the slowest block.
//
// The first design (`RecordPath`) stays as a yardstick: one target a
// thread, padded 16-byte records (8 words for E, 12 for F) staged through
// shared memory, the r^-3 / r^-5 forms with the library rsqrtf and a select,
// the running sum in `out`. Instances `ring_*_f32_v1`: no path launches
// them; they share the protocol code above with the new design.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

#include "pair_functors.cuh"
#include "pair_terms.cuh"

namespace {

using skelly::cp_async16;
using skelly::cp_async_commit;
using skelly::cp_async_wait_all;
using skelly::Stokeslet;
using skelly::Stresslet;
using skelly::unpack;

constexpr int kMaxShards = 16;
constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 128;     // sources a staged tile
constexpr unsigned long long kTimeoutNs = 20ull * 1000ull * 1000ull * 1000ull;
constexpr int kTableWords = 7;  // pointers a shard in the host's table
constexpr float kPadPosition = 1e18f;

struct Shard {
  const float* trg;           // [nt, 3]
  const float* src;           // [ns, 3]
  const float* payload;       // [ns, kPayload]
  float* out;                 // [nt, 3]
  float* slots;               // n slots of slot_words
  unsigned long long* flags;  // [n + 2]: arrival per slot, entry, exit
  float* part;                // [n, chunks, nt, 3] partial sums (TilePath)
};

struct RingTable {
  Shard shard[kMaxShards];
  int n_shards;
  long long n_trg;
  long long n_src;
};

// The work split of TilePath (ops/cuda_kernels.py `RingPlan`).
struct Plan {
  int tiles;          // tiles a slot, ceil(ns / kTile)
  int chunk_tiles;    // tiles a chunk (the last chunk may hold fewer)
  int chunks;         // chunks a step
  int target_blocks;  // ceil(nt / (R kThreads))
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

// The end of a wait that timed out: say which, and trap. Out of line and
// noreturn, so no value of the waiting kernel is kept across the printf
// (inline, ptxas spilled registers around the call).
__device__ __noinline__ __attribute__((noreturn)) void ring_timeout(
    int shard, const char* what, unsigned long long counter,
    unsigned long long target) {
  printf("ring_sums: shard %d block %d timed out waiting for %s "
         "(counter %llu, need %llu)\n",
         shard, static_cast<int>(blockIdx.x), what, counter, target);
  __trap();
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
          ring_timeout(shard, what, load_acquire(flag), target);
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

// -------------------------------------------------------- the first design
template <class Pair>
struct RecordPath {
  using Record = typename Pair::Record;
  static constexpr int kWords = sizeof(Record) / sizeof(float);
  static_assert(kWords % 4 == 0, "16-byte records");

  static __device__ long long slot_words(long long ns, const Plan&) {
    return ns * kWords;
  }

  // Words 4v .. 4v + 3 of a slot: record w / kWords, padding words 0.
  static __device__ float4 pack(const Shard& sh, long long ns, long long v,
                                const Plan&) {
    float4 out;
    float* o = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long w = 4 * v + e;
      const long long i = w / kWords;
      const int k = static_cast<int>(w - i * kWords);
      o[e] = k < 3 ? sh.src[3 * i + k]
                   : (k < 3 + Pair::kPayload
                          ? sh.payload[Pair::kPayload * i + k - 3]
                          : 0.f);
    }
    (void)ns;
    return out;
  }

  // This block's target tiles against one slot of ns records; the step's
  // sum of a target is written (first step) or added to its running sum in
  // `out`.
  static __device__ void accumulate(const float* words, const Shard& sh,
                                    long long nt, long long ns, int step,
                                    const Plan&) {
    __shared__ Record tile[kThreads];
    const Record* slot = reinterpret_cast<const Record*>(words);
    const float k = Pair::finish(1.0f);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long tile0 = static_cast<long long>(blockIdx.x) * kThreads;
         tile0 < nt; tile0 += stride) {
      const long long t = tile0 + threadIdx.x;
      const bool live = t < nt;
      float tx = 0.f, ty = 0.f, tz = 0.f;
      if (live) {
        tx = sh.trg[3 * t + 0];
        ty = sh.trg[3 * t + 1];
        tz = sh.trg[3 * t + 2];
      }
      float ux = 0.f, uy = 0.f, uz = 0.f;
      for (long long base = 0; base < ns; base += kThreads) {
        const long long s = base + threadIdx.x;
        __syncthreads();  // every thread is done reading the previous tile
        if (s < ns) {
          Record r;
          const float4* from = reinterpret_cast<const float4*>(slot + s);
          float4* to = reinterpret_cast<float4*>(&r);
#pragma unroll
          for (int q = 0; q < kWords / 4; ++q) to[q] = __ldcg(from + q);
          tile[threadIdx.x] = r;
        }
        __syncthreads();
        const int count = static_cast<int>(ns - base < kThreads ? ns - base
                                                                 : kThreads);
        float px = 0.f, py = 0.f, pz = 0.f;
#pragma unroll (Pair::kUnroll)
        for (int j = 0; j < count; ++j) {
          const Record rec = tile[j];
          skelly::pair_term<Pair>(rec, tx, ty, tz, px, py, pz);
        }
        ux += px;
        uy += py;
        uz += pz;
      }
      if (live) {
        if (step == 0) {
          sh.out[3 * t + 0] = ux * k;
          sh.out[3 * t + 1] = uy * k;
          sh.out[3 * t + 2] = uz * k;
        } else {
          sh.out[3 * t + 0] += ux * k;
          sh.out[3 * t + 1] += uy * k;
          sh.out[3 * t + 2] += uz * k;
        }
      }
    }
  }
};

// ------------------------------------------------------------ the redesign
struct StokesletTiles {
  static constexpr int kPay = 3;  // force
  static constexpr float kFinish = 1.0f;
};

struct StressletTiles {
  static constexpr int kPay = 9;  // S, row-major
  static constexpr float kFinish = -3.0f;
};

template <class Fam, int R>
struct TilePath {
  static constexpr int kPay = Fam::kPay;
  static constexpr int kTileWords = (3 + kPay) * kTile;
  static constexpr int kTileVecs = kTileWords / 4;
  static constexpr int kG = skelly::kGroup<float>;  // sources a group
  static constexpr int kGroups = kTile / kG;
  static constexpr int kUnroll = 32 / (kG * R) > 0 ? 32 / (kG * R) : 1;
  static_assert(kGroups % kUnroll == 0, "tile shape");

  static __device__ long long slot_words(long long, const Plan& p) {
    return static_cast<long long>(p.tiles) * kTileWords;
  }

  // Words 4v .. 4v + 3 of a slot (a vector never straddles the position
  // and payload parts of a tile: 3 kTile is a multiple of 4).
  static __device__ float4 pack(const Shard& sh, long long ns, long long v,
                                const Plan&) {
    const long long j = v / kTileVecs;  // tile
    const int o = static_cast<int>(v - j * kTileVecs) * 4;
    float4 out;
    float* a = reinterpret_cast<float*>(&out);
    if (o < 3 * kTile) {
      const long long f = j * (3 * kTile) + o;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = f + e < 3 * ns ? sh.src[f + e] : kPadPosition;
      }
    } else {
      const long long f = j * (kPay * kTile) + (o - 3 * kTile);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = f + e < kPay * ns ? sh.payload[f + e] : 0.f;
      }
    }
    return out;
  }

  static __device__ __forceinline__ void stage(float* dst, const float* src) {
    for (int v = threadIdx.x; v < kTileVecs; v += kThreads) {
      cp_async16(dst + 4 * v, src + 4 * v);
    }
    cp_async_commit();
  }

  // One full staged tile against this thread's R targets, into p.
  static __device__ __forceinline__ void tile_sum(const float* buf,
                                                  const float* tx,
                                                  const float* ty,
                                                  const float* tz, float* px,
                                                  float* py, float* pz) {
#pragma unroll (kUnroll)
    for (int g = 0; g < kGroups; ++g) {
      float p[3 * kG], q[kPay * kG];
      const float4* vp = reinterpret_cast<const float4*>(buf + 3 * kG * g);
      const float4* vq = reinterpret_cast<const float4*>(
          buf + 3 * kTile + kPay * kG * g);
#pragma unroll
      for (int v = 0; v < 3; ++v) unpack(vp[v], p + 4 * v);
#pragma unroll
      for (int v = 0; v < kPay; ++v) unpack(vq[v], q + 4 * v);
#pragma unroll
      for (int j = 0; j < kG; ++j) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if constexpr (kPay == 3) {
            skelly::stokeslet_pair(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                                   q[3 * j], q[3 * j + 1], q[3 * j + 2],
                                   tx[k], ty[k], tz[k], px[k], py[k], pz[k]);
          } else {
            skelly::stresslet_pair(p[3 * j], p[3 * j + 1], p[3 * j + 2],
                                   q + 9 * j, tx[k], ty[k], tz[k], px[k],
                                   py[k], pz[k]);
          }
        }
      }
    }
  }

  // One item: target block tb against tiles [t_begin, t_end) of the slot;
  // writes the unscaled partial sums of its live targets to `part`.
  static __device__ void item(const float* slot, const float* trg,
                              float* part, long long nt, int tb, int t_begin,
                              int t_end, float (*buf)[kTileWords]) {
    const long long t0 = static_cast<long long>(tb) * (R * kThreads) +
                         threadIdx.x;
    float tx[R], ty[R], tz[R], ux[R], uy[R], uz[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long t = t0 + k * kThreads;
      const bool live = t < nt;
      tx[k] = live ? trg[3 * t + 0] : 0.f;
      ty[k] = live ? trg[3 * t + 1] : 0.f;
      tz[k] = live ? trg[3 * t + 2] : 0.f;
      ux[k] = uy[k] = uz[k] = 0.f;
    }
    const int n_tiles = t_end - t_begin;
    __syncthreads();  // every thread is done with the previous item's tiles
    stage(buf[0], slot + static_cast<long long>(t_begin) * kTileWords);
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait_all();
      __syncthreads();  // tile i visible; every thread is done with i - 1
      if (i + 1 < n_tiles) {
        stage(buf[(i + 1) & 1],
              slot + static_cast<long long>(t_begin + i + 1) * kTileWords);
      }
      float px[R], py[R], pz[R];
#pragma unroll
      for (int k = 0; k < R; ++k) px[k] = py[k] = pz[k] = 0.f;
      tile_sum(buf[i & 1], tx, ty, tz, px, py, pz);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        ux[k] += px[k];
        uy[k] += py[k];
        uz[k] += pz[k];
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long t = t0 + k * kThreads;
      if (t < nt) {
        part[3 * t + 0] = ux[k];
        part[3 * t + 1] = uy[k];
        part[3 * t + 2] = uz[k];
      }
    }
  }

  // This block's items of one step.
  static __device__ void accumulate(const float* slot, const Shard& sh,
                                    long long nt, long long, int step,
                                    const Plan& p) {
    __shared__ __align__(16) float buf[2][kTileWords];
    const long long grid = gridDim.x;
    const long long items = static_cast<long long>(p.target_blocks) * p.chunks;
    float* const part = sh.part + static_cast<long long>(step) * p.chunks *
                                      nt * 3;
    // the items whose running index step * items + i is blockIdx.x mod grid
    for (long long i = (blockIdx.x - (step * items) % grid + grid) % grid;
         i < items; i += grid) {
      const int tb = static_cast<int>(i / p.chunks);
      const int c = static_cast<int>(i - static_cast<long long>(tb) *
                                             p.chunks);
      const int t_begin = c * p.chunk_tiles;
      const int t_end = t_begin + p.chunk_tiles < p.tiles
                            ? t_begin + p.chunk_tiles
                            : p.tiles;
      item(slot, sh.trg, part + static_cast<long long>(c) * nt * 3, nt, tb,
           t_begin, t_end, buf);
    }
  }
};

// ------------------------------------------------------- the ring protocol
template <class Path>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const RingTable table, const int first,
            const unsigned long long epoch, const Plan plan) {
  const int n = table.n_shards;
  const int me = first + static_cast<int>(blockIdx.y);
  const int right = (me + 1) % n;
  const int left = (me + n - 1) % n;
  const Shard mine = table.shard[me];
  const long long ns = table.n_src;
  const long long nt = table.n_trg;
  const long long slot_words = Path::slot_words(ns, plan);
  const long long slot_vecs = slot_words / 4;
  float4* const my_slots = reinterpret_cast<float4*>(mine.slots);
  float4* const right_slots =
      reinterpret_cast<float4*>(table.shard[right].slots);
  unsigned long long* const my_flags = mine.flags;
  unsigned long long* const right_flags = table.shard[right].flags;
  unsigned long long* const left_flags = table.shard[left].flags;
  // every block of every launch of the ring signals each counter it feeds
  // once per instance; all launches share this grid width
  const unsigned long long done = epoch * gridDim.x;

  // ENTRY barrier: both neighbours entered this instance
  block_signal(left_flags + n, right_flags + n);
  block_wait(my_flags + n, 2 * done, me, "the entry barrier");

  // the slot vectors this block moves at every step
  const long long chunk = (slot_vecs + gridDim.x - 1) / gridDim.x;
  long long v0 = static_cast<long long>(blockIdx.x) * chunk;
  v0 = v0 < slot_vecs ? v0 : slot_vecs;
  const long long v1 = v0 + chunk < slot_vecs ? v0 + chunk : slot_vecs;

  for (int s = 0; s < n; ++s) {
    if (s == 0) {
      // pack the own block into slot 0 and the right neighbour's slot 1
      for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
        const float4 x = Path::pack(mine, ns, v, plan);
        __stcg(my_slots + v, x);
        if (n > 1) __stcg(right_slots + slot_vecs + v, x);
      }
      block_signal(my_flags, n > 1 ? right_flags + 1 : nullptr);
      block_wait(my_flags, done, me, "its own slot 0");
    } else if (s + 1 < n) {
      // slot s -> the right neighbour's slot s + 1
      const float4* from = my_slots + s * slot_vecs;
      float4* to = right_slots + (s + 1) * slot_vecs;
      for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
        __stcg(to + v, __ldcg(from + v));
      }
      block_signal(right_flags + s + 1, nullptr);
    }
    Path::accumulate(mine.slots + s * slot_words, mine, nt, ns, s, plan);
    if (s + 1 < n) {
      block_wait(my_flags + s + 1, done, me, "a slot from the left neighbour");
    }
  }

  // EXIT barrier: both neighbours are done reading their slots
  block_signal(left_flags + n + 1, right_flags + n + 1);
  block_wait(my_flags + n + 1, 2 * done, me, "the exit barrier");
}

// out = k * sum over (step, chunk) of part, step-major then chunk, for the
// shards [first, first + gridDim.y): the fixed order gives the same bits
// on every launch.
__global__ void __launch_bounds__(256)
ring_reduce_kernel(const RingTable table, const int first, const int terms,
                   const float k) {
  const Shard& sh = table.shard[first + static_cast<int>(blockIdx.y)];
  const long long n = 3 * table.n_trg;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float acc = sh.part[i];
  for (int j = 1; j < terms; ++j) acc += sh.part[j * n + i];
  sh.out[i] = acc * k;
}

// Targets a thread of both families' instances (ops/cuda_kernels.py
// RING_R, checked when the library loads); a launch refuses another R.
// Measured against R = 8 on the H100 (PERF.md): E ran slower at R = 8 (the
// ring's own live state on top of A's registers) and F spilled.
constexpr int kR = 4;

template <class Path>
int blocks_per_sm(int device, int* out) {
  int coop = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ring_kernel<Path>, kThreads, 0));
}

RingTable make_table(const unsigned long long* ptrs, int n_shards,
                     long long n_trg, long long n_src) {
  RingTable table = {};
  for (int k = 0; k < n_shards; ++k) {
    const unsigned long long* p = ptrs + kTableWords * k;
    table.shard[k].trg = reinterpret_cast<const float*>(p[0]);
    table.shard[k].src = reinterpret_cast<const float*>(p[1]);
    table.shard[k].payload = reinterpret_cast<const float*>(p[2]);
    table.shard[k].out = reinterpret_cast<float*>(p[3]);
    table.shard[k].slots = reinterpret_cast<float*>(p[4]);
    table.shard[k].flags = reinterpret_cast<unsigned long long*>(p[5]);
    table.shard[k].part = reinterpret_cast<float*>(p[6]);
  }
  table.n_shards = n_shards;
  table.n_trg = n_trg;
  table.n_src = n_src;
  return table;
}

bool valid_ring(int n_shards, long long n_trg, long long n_src, int first,
                int count, int grid, unsigned long long epoch) {
  return n_shards >= 1 && n_shards <= kMaxShards && first >= 0 && count >= 1 &&
         first + count <= n_shards && grid >= 1 && n_trg >= 1 && n_src >= 1 &&
         epoch >= 1;
}

template <class Path>
cudaError_t launch_ring(RingTable& table, int first, int count, int grid,
                        unsigned long long epoch, Plan& plan,
                        cudaStream_t stream) {
  void* args[] = {&table, &first, &epoch, &plan};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&ring_kernel<Path>), dim3(grid, count),
      dim3(kThreads), args, 0, stream);
}

int finish_launch(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it; the wrapper raises with the code
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The redesign: the ring launch, then the reduction on the same stream.
template <class Fam>
int launch_tiles(const unsigned long long* ptrs, int n_shards, long long n_trg,
                 long long n_src, int first, int count, int grid,
                 unsigned long long epoch, int r, int tiles, int chunk_tiles,
                 int chunks, int target_blocks, void* stream) {
  constexpr int R = kR;
  const long long want_tiles = (n_src + kTile - 1) / kTile;
  if (!valid_ring(n_shards, n_trg, n_src, first, count, grid, epoch) ||
      r != R || tiles != want_tiles || chunk_tiles < 1 ||
      chunks != (tiles + chunk_tiles - 1) / chunk_tiles ||
      target_blocks != (n_trg + R * kThreads - 1) / (R * kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTable table = make_table(ptrs, n_shards, n_trg, n_src);
  Plan plan = {tiles, chunk_tiles, chunks, target_blocks};
  const auto s = static_cast<cudaStream_t>(stream);
  const int rc = finish_launch(launch_ring<TilePath<Fam, R>>(
      table, first, count, grid, epoch, plan, s));
  if (rc != 0) return rc;
  const long long n = 3 * n_trg;
  ring_reduce_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256), count),
                       256, 0, s>>>(table, first, n_shards * chunks,
                                    Fam::kFinish);
  return static_cast<int>(cudaGetLastError());
}

template <class Pair>
int launch_records(const unsigned long long* ptrs, int n_shards,
                   long long n_trg, long long n_src, int first, int count,
                   int grid, unsigned long long epoch, void* stream) {
  if (!valid_ring(n_shards, n_trg, n_src, first, count, grid, epoch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingTable table = make_table(ptrs, n_shards, n_trg, n_src);
  Plan plan = {};
  return finish_launch(launch_ring<RecordPath<Pair>>(
      table, first, count, grid, epoch, plan,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Floats a source takes in a slot (the wrapper sizes the slot buffers with
// it): instance 0 E, 1 F (tile-major, unpadded), 2 E's and 3 F's first
// design (16-byte records).
int ring_record_words(int instance) {
  switch (instance) {
    case 0:
      return 3 + StokesletTiles::kPay;
    case 1:
      return 3 + StressletTiles::kPay;
    case 2:
      return RecordPath<Stokeslet<float>>::kWords;
    default:
      return RecordPath<Stresslet<float>>::kWords;
  }
}

// Targets a thread of the built instances of E and F.
int ring_targets_a_thread() { return kR; }

// Resident blocks an SM of each instance on `device`, which must be the
// current device (the cooperative grid is this x the SM count, divided
// among the shards a launch serves). Returns a CUDA error code (0 on
// success); cudaErrorNotSupported where the card has no cooperative launch.
int ring_stokeslet_f32_blocks_per_sm(int device, int* out) {
  return blocks_per_sm<TilePath<StokesletTiles, kR>>(device, out);
}

int ring_stresslet_f32_blocks_per_sm(int device, int* out) {
  return blocks_per_sm<TilePath<StressletTiles, kR>>(device, out);
}

int ring_stokeslet_f32_v1_blocks_per_sm(int device, int* out) {
  return blocks_per_sm<RecordPath<Stokeslet<float>>>(device, out);
}

int ring_stresslet_f32_v1_blocks_per_sm(int device, int* out) {
  return blocks_per_sm<RecordPath<Stresslet<float>>>(device, out);
}

// One cooperative launch serving shards [first, first + count) of an
// n_shards ring, then the reduction of their partial sums, both on
// `stream`. `ptrs` holds 7 pointers a shard (targets, sources, payload,
// output, slots, counters, partial sums) for every shard of the ring; the
// plan's numbers (R, tiles a slot, tiles a chunk, chunks, target blocks)
// must be those `ring_plan` gives for this instance, else nothing launches
// and cudaErrorInvalidValue returns. Returns the first launch error (0 when
// both launches were accepted).
int ring_stokeslet_f32_launch(const unsigned long long* ptrs, int n_shards,
                              long long n_trg, long long n_src, int first,
                              int count, int grid, unsigned long long epoch,
                              int r, int tiles, int chunk_tiles, int chunks,
                              int target_blocks, void* stream) {
  return launch_tiles<StokesletTiles>(ptrs, n_shards, n_trg, n_src, first,
                                      count, grid, epoch, r, tiles,
                                      chunk_tiles, chunks, target_blocks,
                                      stream);
}

int ring_stresslet_f32_launch(const unsigned long long* ptrs, int n_shards,
                              long long n_trg, long long n_src, int first,
                              int count, int grid, unsigned long long epoch,
                              int r, int tiles, int chunk_tiles, int chunks,
                              int target_blocks, void* stream) {
  return launch_tiles<StressletTiles>(ptrs, n_shards, n_trg, n_src, first,
                                      count, grid, epoch, r, tiles,
                                      chunk_tiles, chunks, target_blocks,
                                      stream);
}

// The first design's launch (the same table; the partial-sum pointer is
// not read): it writes `out` itself.
int ring_stokeslet_f32_v1_launch(const unsigned long long* ptrs, int n_shards,
                                 long long n_trg, long long n_src, int first,
                                 int count, int grid, unsigned long long epoch,
                                 void* stream) {
  return launch_records<Stokeslet<float>>(ptrs, n_shards, n_trg, n_src, first,
                                          count, grid, epoch, stream);
}

int ring_stresslet_f32_v1_launch(const unsigned long long* ptrs, int n_shards,
                                 long long n_trg, long long n_src, int first,
                                 int count, int grid, unsigned long long epoch,
                                 void* stream) {
  return launch_records<Stresslet<float>>(ptrs, n_shards, n_trg, n_src, first,
                                          count, grid, epoch, stream);
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

// The bytes of a `cudaIpcMemHandle_t` (the wrapper sizes its buffers).
int ring_ipc_handle_bytes() { return sizeof(cudaIpcMemHandle_t); }

// One shard's ring state for a ring that spans processes: `bytes` of
// device memory on `device` (its counters first, then its slots), the
// first `zero_bytes` zeroed and the fill waited for, and the allocation's
// IPC handle written to `handle`. A plain cudaMalloc, so the handle maps
// the pointer itself (not an enclosing block of a caching allocator). It
// is never freed: a neighbour process may write it as long as it runs.
// Returns a CUDA error code; the current device is restored.
int ring_ipc_alloc(int device, unsigned long long bytes,
                   unsigned long long zero_bytes, unsigned long long* ptr,
                   unsigned char* handle) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaMalloc(&p, bytes);
  if (e == cudaSuccess) e = cudaMemset(p, 0, zero_bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, p);
  if (e == cudaSuccess) {
    std::memcpy(handle, &h, sizeof(h));
    *ptr = reinterpret_cast<unsigned long long>(p);
  }
  const cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}

// Map another process's shard state (`handle` from its ring_ipc_alloc)
// into this process, for `device`'s kernels, peer access enabled as the
// mapping needs it. The mapping stays open for the life of the process.
int ring_ipc_open(int device, const unsigned char* handle,
                  unsigned long long* ptr) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  if (e == cudaSuccess) {
    e = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  }
  if (e == cudaSuccess) *ptr = reinterpret_cast<unsigned long long>(p);
  const cudaError_t r = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : r);
}

const char* ring_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
