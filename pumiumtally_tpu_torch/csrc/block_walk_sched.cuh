// The schedule shared by the block walks W1 (block_walk.cu) and W2
// (twotier_block_walk.cu): a persistent grid of CUDA blocks, each owning a
// fixed share of one partition block's slots, compacting that share's
// active slots into a shared-memory work list, staging the partition
// block's table once by a TMA bulk copy as soon as the list holds a
// particle, and handing list entries to threads through a shared counter
// (the persistent-threads pattern for divergent ray traversal: Aila &
// Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
// 2009).
//
// Grid: (partition blocks, k) CUDA blocks of SCHED_THREADS threads, with
// k = max(1, floor(SMs * resident blocks per SM / partition blocks)) from
// the occupancy query, so that the whole grid is resident at once. A
// partition block's cap_b slots are cut into chunks of SCHED_THREADS
// consecutive slots, and CUDA block (b, j) owns chunks j, j+k, j+2k, ...
// of partition block b: the engine's migration ranks arrivals by their
// source block, so a round's active slots come in runs, and contiguous
// shares would hand a run to one CUDA block while the others idle.
//
// Dynamic shared memory, in bytes from the base:
//   [0, 32)                 SchedHeader (mbarrier, counters)
//   [32, +round16(table))   the partition block's table (when it stages)
//   [.., +round16(partial)) the [L] flux partial (when it stages)
//   [.., +list_cap*4)       the work list of active slot ids
// list_cap = min(SCHED_LIST_MAX, what is left of SMEM_BYTES_PER_BLOCK
// (occupancy.cuh), rounded down to whole chunks); a share longer than
// the list is processed in batches of list_cap / SCHED_THREADS chunks.
// ops/vmem_walk.py (sched_smem_layout, sched_blocks_per_part,
// sched_chunks, sched_batches) holds the same arithmetic for the CPU
// tests; chip_smoke.py checks on the card, from the counts below, that
// the kernels walk every active slot and write out every idle one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

#define SCHED_THREADS 512
#define SCHED_LIST_MAX 4096
#define SCHED_HEADER_BYTES 32

// The optional counts[SCHED_COUNTS] output: each CUDA block adds one to
// the count of its regime (no active slot, rows read from global memory,
// table staged in shared memory) and adds the active slots it walked and
// the idle slots it wrote out in the pass.
enum SchedCount {
  kCountEmpty = 0,
  kCountGlobal = 1,
  kCountStaged = 2,
  kCountWalked = 3,
  kCountIdle = 4,
  SCHED_COUNTS = 5
};

struct SchedHeader {
  unsigned long long bar;  // mbarrier the table's bulk copy completes on
  int count;               // entries in the work list
  int next;                // next list entry to hand out
  int iters;               // most steps any of the block's particles took
  int started;             // the bulk copy has been started
};

__host__ __device__ __forceinline__ size_t sched_round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ __forceinline__ size_t sched_part_offset(
    size_t table_bytes) {
  return SCHED_HEADER_BYTES + sched_round16(table_bytes);
}

__host__ __device__ __forceinline__ size_t sched_list_offset(
    size_t table_bytes, size_t part_bytes) {
  return sched_part_offset(table_bytes) + sched_round16(part_bytes);
}

// The shared-memory layout for a table of `table_bytes` and a partial of
// `part_bytes` (both 0 when the block never stages): the total bytes and
// the list capacity. False when not even one pass of list fits.
static bool sched_layout(size_t table_bytes, size_t part_bytes,
                         size_t* bytes, int* list_cap) {
  const size_t list_off = sched_list_offset(table_bytes, part_bytes);
  if (list_off >= SMEM_BYTES_PER_BLOCK) return false;
  size_t cap = (SMEM_BYTES_PER_BLOCK - list_off) / sizeof(int);
  cap = cap / SCHED_THREADS * SCHED_THREADS;
  if (cap > SCHED_LIST_MAX) cap = SCHED_LIST_MAX;
  if (cap < SCHED_THREADS) return false;
  *list_cap = static_cast<int>(cap);
  *bytes = list_off + cap * sizeof(int);
  return true;
}

// k, the CUDA blocks per partition block, for `kernel` at `smem` bytes of
// dynamic shared memory: as many as the device keeps resident at once
// (occupancy.cuh), shared out among the partition blocks.
static cudaError_t sched_blocks_per_part(const void* kernel, size_t smem,
                                         int nparts, int* k) {
  int resident = 0;
  const cudaError_t err =
      resident_blocks(kernel, SCHED_THREADS, smem, &resident);
  if (err != cudaSuccess) return err;
  *k = resident / nparts > 1 ? resident / nparts : 1;
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t sched_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: arm the mbarrier for `bytes` and copy them from global to
// shared memory with one TMA bulk copy. Both addresses and `bytes` are
// multiples of 16.
__device__ __forceinline__ void sched_start_copy(uint32_t bar, void* dst,
                                                 const void* src,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sched_smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void sched_wait(uint32_t bar, uint32_t parity) {
  uint32_t ready = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!ready);
}

// Run CUDA block j of the k that share a partition block of cap_b slots:
// - `is_active(slot)` says whether a slot walks; `write_idle(slot)`
//   materialises a slot that does not, at once, in the pass;
// - `walk(slot, staged)` walks one active slot to completion or to a
//   block face, writes its outputs and returns its steps (`staged`: the
//   table is in shared memory at smem + SCHED_HEADER_BYTES and flux goes
//   to the partial; otherwise rows come from global memory and flux goes
//   to global atomics);
// - `table_src`/`table_bytes` is the partition block's table (0 bytes:
//   this launch never stages), staged once the list holds an entry;
// - the partial's nonzero entries are added into flux_b once, at the end.
// Every thread of the block must call it (it holds barriers).
template <typename T, typename Active, typename Idle, typename Walk>
__device__ __forceinline__ void sched_block(
    unsigned char* smem, int j, int k, int cap_b, int list_cap,
    const void* table_src, uint32_t table_bytes, int L, bool tally,
    T* __restrict__ flux_b, int* __restrict__ iters,
    int* __restrict__ counts, Active is_active, Idle write_idle, Walk walk) {
  SchedHeader* h = reinterpret_cast<SchedHeader*>(smem);
  const bool can_stage = table_bytes > 0;
  void* tbl = smem + SCHED_HEADER_BYTES;
  T* part = reinterpret_cast<T*>(smem + sched_part_offset(table_bytes));
  int* list = reinterpret_cast<int*>(
      smem + sched_list_offset(table_bytes,
                               can_stage ? (size_t)L * sizeof(T) : 0));
  const uint32_t bar = sched_smem_u32(&h->bar);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    h->count = 0;
    h->next = 0;
    h->iters = 0;
    h->started = 0;
    if (can_stage) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();

  bool staged = false, any = false;
  int steps_max = 0, walked = 0, idle = 0;
  const int nchunks = (cap_b + SCHED_THREADS - 1) / SCHED_THREADS;
  const int batch = list_cap / SCHED_THREADS;  // chunks per batch
  for (int c0 = j; c0 < nchunks; c0 += batch * k) {
    const int c_end = min(c0 + batch * k, nchunks);
    // The pass: coalesced over each chunk of the batch, idle slots written
    // out, active ones appended to the list (one shared atomic per warp).
    // Thread 0 starts the table's copy as soon as the list holds an
    // entry.
    for (int c = c0; c < c_end; c += k) {
      const int slot = c * SCHED_THREADS + tid;
      const bool in = slot < cap_b;
      const bool act = in && is_active(slot);
      if (in && !act) write_idle(slot);
      idle += __popc(__ballot_sync(0xffffffffu, in && !act));
      const unsigned m = __ballot_sync(0xffffffffu, act);
      if (m) {
        int first = 0;
        if (lane == 0) first = atomicAdd(&h->count, __popc(m));
        first = __shfl_sync(0xffffffffu, first, 0);
        if (act) list[first + __popc(m & ((1u << lane) - 1u))] = slot;
      }
      if (tid == 0 && can_stage && !h->started &&
          *reinterpret_cast<volatile int*>(&h->count) > 0) {
        sched_start_copy(bar, tbl, table_src, table_bytes);
        h->started = 1;
      }
    }
    __syncthreads();
    const int n = h->count;
    if (n > 0) {
      any = true;
      if (can_stage && !staged) {
        if (tid == 0 && !h->started)
          sched_start_copy(bar, tbl, table_src, table_bytes);
        if (tally)
          for (int e = tid; e < L; e += blockDim.x) part[e] = T(0);
        sched_wait(bar, 0);
        __syncthreads();
        staged = true;
      }
      // Threads pull work: one finishing its particle takes the next.
      for (int idx = atomicAdd(&h->next, 1); idx < n;
           idx = atomicAdd(&h->next, 1)) {
        const int steps = walk(list[idx], staged);
        steps_max = steps > steps_max ? steps : steps_max;
        ++walked;
      }
    }
    __syncthreads();
    if (tid == 0) {
      h->count = 0;
      h->next = 0;
      h->started = staged;
    }
    __syncthreads();
  }

  const int warp_max = __reduce_max_sync(0xffffffffu, steps_max);
  const int warp_walked = __reduce_add_sync(0xffffffffu, walked);
  if (lane == 0) {
    if (warp_max > 0) atomicMax(&h->iters, warp_max);
    if (counts != nullptr) {
      // `idle` is the same in every lane: each ballot counted the warp.
      atomicAdd(counts + kCountWalked, warp_walked);
      atomicAdd(counts + kCountIdle, idle);
    }
  }
  __syncthreads();
  if (staged && tally)
    for (int e = tid; e < L; e += blockDim.x)
      if (part[e] != T(0)) atomicAdd(flux_b + e, part[e]);
  if (tid == 0) {
    if (h->iters > 0) atomicMax(iters, h->iters);
    if (counts != nullptr)
      atomicAdd(counts + (staged ? kCountStaged
                                 : any ? kCountGlobal : kCountEmpty),
                1);
  }
}
