// W2: the two-tier block walk of the partitioned engine's sub-split mesh.
//
// Replaces: pumiumtally_tpu/ops/pallas_walk.py `pallas_walk_local` (a
// Pallas kernel, pallas_call at pallas_walk.py:475). There, the grid
// (blocks, tiles) streams each block's bf16 select tier and its
// refinement tier through VMEM and fetches rows with one-hot MXU
// matmuls. Here the contract is kept, not that mechanism: rows are
// indexed loads.
//
// Layout (engine-arranged, as in the JAX kernel): `blocks` stacked
// [L,16] bf16 select tables and [L*4,5] refinement tables (row
// (b*L + lelem)*4 + f); slots grouped by block, cap_b slots each; lelem
// is block-local; flux is [blocks*L]. Each active slot selects its exit
// face from its element's lifted bf16 row, re-solves that face's
// crossing from its one refinement row (which also names the
// neighbour), pauses with pending = -nxt-2 at a block face, and
// finishes at the boundary or on reaching dest (csrc/twotier_step.cuh).
// The ray is rebuilt as the JAX kernel does: d0 = dest - x0 and
// dest_c = x0 + d0 feed both projections, and the final position is
// materialised from x0 itself, x0 + s*d0 (dest for a particle that
// reached it).
//
// What bounds it on an H100 (80GB HBM3, 700 W power limit): the contract
// rewrites every slot each round, walking or not. An active slot reads
// and writes 57 B in f32; an idle one 40 B, 52 B if it left the mesh; the
// tables of the blocks that walk are read once (32 + 80 B per element)
// and their flux read and written. On chip_smoke.py's box (24 blocks,
// 1,007,616 slots) that is about 16 us for the first round and 12-14 us
// for a late one at 3.35 TB/s. Per crossing one 32 B select row, one 20 B
// refinement row and one flux add at data-dependent addresses, a
// dependent chain, so in practice latency bounds the early rounds; the
// measured times per round stand in PERF.md.
//
// What the design does about it (csrc/block_walk_sched.cuh): a persistent
// grid of (blocks, k) CUDA blocks of 512 threads, k from the occupancy
// query; each CUDA block owns every k-th 512-slot chunk of its
// partition block's slots, writes out the idle slots in one coalesced
// pass while compacting the active ones into a shared work list, and
// then:
// - with an empty list it stages nothing;
// - when the block's select rows do not fit shared memory (`use_shared`
//   false: one block holding a large mesh) it reads them from global
//   memory and adds flux with global atomics;
// - otherwise it copies the block's [L,16] bf16 select rows into shared
//   memory with one TMA bulk copy (32 B rows), started during the pass
//   as soon as the list holds a particle, and walks with a shared [L]
//   flux partial whose nonzero entries are added into global flux once.
// The refinement rows are always read from global memory (through L2):
// only the winning face's row is ever touched. Threads pull list entries
// through a shared counter; `iters` is reduced per warp and max-ed into
// global memory once per CUDA block. Shared memory when staging: 32 B of
// select row and the partial per element, plus the list (2 KB at
// least): L <= 6,399 in f32, 5,759 in f64.
//
// Scoring (kScore; K2's in-kernel scoring lanes, pallas_walk.py:381-418):
// block b's lanes are the [L*stride] slice at b*L*stride of the padded
// bank, and each crossing adds score_pair's values (the track score's
// c * fac[k], the count score's fac[k] when the step crossed a face:
// interior step, block-face pause or boundary exit) into lanes
// lelem*stride + bin_off + k through the scoring commit (score_lanes,
// walk_step.cuh: in f32 the fewest aligned v4 / v2 / scalar global
// reductions that cover them, padding only inside the element's row; in
// f64 a scalar atomic a lane), in both regimes: a [L, stride] partial
// does not fit beside the staged table (2,000 x 96 x 4 B = 768 KB). K2
// sums a per-tile matmul partial instead, so only the order of the
// additions differs. A crossing with bin_off >= stride (the DROP
// sentinel's) matches no lane of the slice and is dropped whole; a zero
// value is not added. The slot's bin offset and factors are read once
// per slot; the scoring-off instantiation is the kernel without any of
// this (the same shared-memory layout), and scoring changes no position,
// element, pause or flag.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_walk_sched.cuh"
#include "twotier_step.cuh"
#include "walk_step.cuh"

template <typename T>
struct TwoTierArgs {
  const uint16_t* table_lo;
  const T* table_hi;
  const T* x;
  const int* lelem_in;
  const T* dest;
  const signed char* fly;
  const T* w;
  const bool* done_in;
  const bool* exited_in;
  T* flux;
  T* x_out;
  int* lelem_out;
  bool* done_out;
  bool* exited_out;
  int* pending_out;
  int* iters;
  int* counts;
  int L, cap_b, list_cap, stage_bytes, max_iters, tally;
  T tol;
  // Scoring (kScore only): the padded bank, each slot's lane offset and
  // its [nscores] factors; `kinds` has bit k set for a "count" score.
  T* bank;
  const int* bin_off;
  const T* fac;
  int stride, nscores, kinds;
};

// Commit slot i: dest bit-exactly for a particle that reached it, else
// x0 + s*d0 from the original x0 (K2's rule).
template <typename T>
__device__ __forceinline__ void commit(const TwoTierArgs<T>& a, size_t i,
                                       T x0x, T x0y, T x0z, T dx, T dy, T dz,
                                       T s, int e, bool done, bool exited,
                                       int pending) {
  const bool at_dest = done && !exited;
  a.x_out[3 * i] = at_dest ? a.dest[3 * i] : x0x + s * dx;
  a.x_out[3 * i + 1] = at_dest ? a.dest[3 * i + 1] : x0y + s * dy;
  a.x_out[3 * i + 2] = at_dest ? a.dest[3 * i + 2] : x0z + s * dz;
  a.lelem_out[i] = e;
  a.done_out[i] = done;
  a.exited_out[i] = exited;
  a.pending_out[i] = pending;
}

// Walk slot i until it is done or paused; `lo` is the block's select
// tier (shared or global), `hi_b` its refinement tier, `acc` its flux
// (partial or global), `bank_b` its scoring lanes (kScore). Returns
// steps.
template <typename T, bool kScore>
__device__ __forceinline__ int walk_slot(const TwoTierArgs<T>& a, size_t i,
                                         const uint16_t* lo, const T* hi_b,
                                         T* acc, T* bank_b) {
  const T x0x = a.x[3 * i], x0y = a.x[3 * i + 1], x0z = a.x[3 * i + 2];
  const T dx = a.dest[3 * i] - x0x, dy = a.dest[3 * i + 1] - x0y,
          dz = a.dest[3 * i + 2] - x0z;
  // The ray's destination as the JAX kernel rebuilds it from the carried
  // invariants (not the input dest: x0 + (dest - x0) may differ from
  // dest by an ulp).
  const T cx = x0x + dx, cy = x0y + dy, cz = x0z + dz;
  int e = a.lelem_in[i], pending = -1;
  bool done = false, exited = a.exited_in[i];
  const T eff_w =
      a.tally ? walk_eff_weight(dx, dy, dz, a.fly[i], a.w[i]) : T(0);
  T s = 0;
  int steps = 0;
  int sbin = 0;
  T sfac[3] = {0, 0, 0};
  if constexpr (kScore) {
    sbin = a.bin_off[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sfac[k] = k < a.nscores ? a.fac[i * a.nscores + k] : T(0);
  }
  while (steps < a.max_iters) {
    int next;
    bool reached;
    const T s_new =
        twotier_step(lo + (size_t)e * WALK_TABLE_LO_WIDTH, hi_b, e, s, dx,
                     dy, dz, cx, cy, cz, a.tol, &next, &reached);
    const bool hit_boundary = !reached && next == -1;
    if (a.tally) {
      const T c = (s_new - s) * eff_w;
      if (c != T(0)) atomicAdd(acc + e, c);
      // Outside the c != 0 guard: a zero-length step is a crossing.
      // The DROP rule, one test a crossing: lanes past the element's row.
      if constexpr (kScore)
        if (sbin < a.stride)
          score_lanes(bank_b + (size_t)e * a.stride, a.stride, sbin,
                      a.nscores, a.kinds, c, !reached, sfac);
    }
    s = s_new;
    ++steps;
    if (reached || hit_boundary) {
      done = true;
      exited = exited || hit_boundary;
      break;
    }
    if (next <= -2) {
      pending = -next - 2;
      break;
    }
    e = next;
  }
  commit(a, i, x0x, x0y, x0z, dx, dy, dz, s, e, done, exited, pending);
  return steps;
}

template <typename T, bool kScore>
__global__ void __launch_bounds__(SCHED_THREADS, 2)
    twotier_block_walk_kernel(const TwoTierArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const size_t base = (size_t)b * a.cap_b;
  const uint16_t* lo_b = a.table_lo + (size_t)b * a.L * WALK_TABLE_LO_WIDTH;
  const T* hi_b = a.table_hi + (size_t)b * a.L * 4 * WALK_PLANE_WIDTH;
  T* flux_b = a.tally ? a.flux + (size_t)b * a.L : nullptr;
  T* bank_b = kScore ? a.bank + (size_t)b * a.L * a.stride : nullptr;
  const uint16_t* lo_s =
      reinterpret_cast<const uint16_t*>(smem_raw + SCHED_HEADER_BYTES);
  T* part = reinterpret_cast<T*>(smem_raw + sched_part_offset(a.stage_bytes));

  sched_block<T>(
      smem_raw, blockIdx.y, gridDim.y, a.cap_b, a.list_cap, lo_b,
      a.stage_bytes, a.L, a.tally != 0, flux_b, a.iters, a.counts,
      [&](int slot) { return !a.done_in[base + slot]; },
      [&](int slot) {
        // An idle slot commits dest unless it left the mesh, so x is read
        // only for one that did.
        const size_t i = base + slot;
        const bool exited = a.exited_in[i];
        T x0x = 0, x0y = 0, x0z = 0, dx = 0, dy = 0, dz = 0;
        if (exited) {
          x0x = a.x[3 * i];
          x0y = a.x[3 * i + 1];
          x0z = a.x[3 * i + 2];
          dx = a.dest[3 * i] - x0x;
          dy = a.dest[3 * i + 1] - x0y;
          dz = a.dest[3 * i + 2] - x0z;
        }
        commit(a, i, x0x, x0y, x0z, dx, dy, dz, T(0), a.lelem_in[i], true,
               exited, -1);
      },
      [&](int slot, bool staged) {
        return staged
                   ? walk_slot<T, kScore>(a, base + slot, lo_s, hi_b, part,
                                          bank_b)
                   : walk_slot<T, kScore>(a, base + slot, lo_b, hi_b, flux_b,
                                          bank_b);
      });
}

// The scoring arguments of a scoring entry (null bank: scoring off).
struct ScoreArgs {
  void* bank;
  const void* bin_off;
  const void* fac;
  int stride, nscores, kinds;
};

template <typename T>
static int launch_twotier_block_walk(
    const ScoreArgs& sc, const void* table_lo, const void* table_hi,
    const void* x, const void* lelem, const void* dest, const void* fly,
    const void* w, const void* done, const void* exited, void* flux,
    void* x_out, void* lelem_out, void* done_out, void* exited_out,
    void* pending_out, void* iters, void* counts, int blocks, int L,
    int cap_b, double tol, int max_iters, int tally, int use_shared,
    void* stream) {
  // Without staging the block reserves only the header and the list.
  const size_t table_bytes =
      use_shared ? (size_t)L * WALK_TABLE_LO_WIDTH * sizeof(uint16_t) : 0;
  const size_t part_bytes = use_shared ? (size_t)L * sizeof(T) : 0;
  size_t smem = 0;
  int list_cap = 0;
  if (!sched_layout(table_bytes, part_bytes, &smem, &list_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks <= 0 || cap_b <= 0) return static_cast<int>(cudaGetLastError());
  const bool score = sc.bank != nullptr;
  const void* kernel =
      score ? reinterpret_cast<const void*>(twotier_block_walk_kernel<T, true>)
            : reinterpret_cast<const void*>(twotier_block_walk_kernel<T, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int k = 0;
  if (err != cudaSuccess ||
      (err = sched_blocks_per_part(kernel, smem, blocks, &k)) != cudaSuccess)
    return static_cast<int>(err);
  TwoTierArgs<T> a;
  a.table_lo = static_cast<const uint16_t*>(table_lo);
  a.table_hi = static_cast<const T*>(table_hi);
  a.x = static_cast<const T*>(x);
  a.lelem_in = static_cast<const int*>(lelem);
  a.dest = static_cast<const T*>(dest);
  a.fly = static_cast<const signed char*>(fly);
  a.w = static_cast<const T*>(w);
  a.done_in = static_cast<const bool*>(done);
  a.exited_in = static_cast<const bool*>(exited);
  a.flux = static_cast<T*>(flux);
  a.x_out = static_cast<T*>(x_out);
  a.lelem_out = static_cast<int*>(lelem_out);
  a.done_out = static_cast<bool*>(done_out);
  a.exited_out = static_cast<bool*>(exited_out);
  a.pending_out = static_cast<int*>(pending_out);
  a.iters = static_cast<int*>(iters);
  a.counts = static_cast<int*>(counts);
  a.L = L;
  a.cap_b = cap_b;
  a.list_cap = list_cap;
  a.stage_bytes = static_cast<int>(table_bytes);
  a.max_iters = max_iters;
  a.tally = tally;
  a.tol = static_cast<T>(tol);
  a.bank = static_cast<T*>(sc.bank);
  a.bin_off = static_cast<const int*>(sc.bin_off);
  a.fac = static_cast<const T*>(sc.fac);
  a.stride = sc.stride;
  a.nscores = sc.nscores;
  a.kinds = sc.kinds;
  const dim3 grid(blocks, k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (score)
    twotier_block_walk_kernel<T, true><<<grid, SCHED_THREADS, smem, st>>>(a);
  else
    twotier_block_walk_kernel<T, false><<<grid, SCHED_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The arguments every entry takes after its scoring arguments.
#define W2_PARAMS                                                          \
  const void *table_lo, const void *table_hi, const void *x,              \
      const void *lelem, const void *dest, const void *fly, const void *w, \
      const void *done, const void *exited, void *flux, void *x_out,       \
      void *lelem_out, void *done_out, void *exited_out,                   \
      void *pending_out, void *iters, void *counts, int blocks, int L,     \
      int cap_b, double tol, int max_iters, int tally, int use_shared,     \
      void *stream
#define W2_ARGS                                                            \
  table_lo, table_hi, x, lelem, dest, fly, w, done, exited, flux, x_out,   \
      lelem_out, done_out, exited_out, pending_out, iters, counts, blocks, \
      L, cap_b, tol, max_iters, tally, use_shared, stream
#define W2_SCORE_PARAMS                                                    \
  void *bank, const void *bin_off, const void *fac, int stride,            \
      int nscores, int kinds

extern "C" int pumi_twotier_block_walk_f32(W2_PARAMS) {
  return launch_twotier_block_walk<float>(ScoreArgs{}, W2_ARGS);
}

extern "C" int pumi_twotier_block_walk_f64(W2_PARAMS) {
  return launch_twotier_block_walk<double>(ScoreArgs{}, W2_ARGS);
}

// A block's lanes are its own slice of the bank: the drop rule is
// bin_off + k >= stride, so no bank size is passed.
extern "C" int pumi_twotier_block_walk_scored_f32(W2_SCORE_PARAMS,
                                                  W2_PARAMS) {
  return launch_twotier_block_walk<float>(
      ScoreArgs{bank, bin_off, fac, stride, nscores, kinds}, W2_ARGS);
}

extern "C" int pumi_twotier_block_walk_scored_f64(W2_SCORE_PARAMS,
                                                  W2_PARAMS) {
  return launch_twotier_block_walk<double>(
      ScoreArgs{bank, bin_off, fac, stride, nscores, kinds}, W2_ARGS);
}
