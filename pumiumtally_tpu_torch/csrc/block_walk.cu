// W1: the block-local walk of the partitioned engine's sub-split mesh.
//
// Replaces: pumiumtally_tpu/ops/vmem_walk.py `vmem_walk_local` (a Pallas
// kernel, pallas_call at vmem_walk.py:483). There, each grid step pins
// one block's [L,20] walk table in VMEM, fetches rows with a one-hot MXU
// matmul and accumulates the block's flux in VMEM. Here shared memory
// plays VMEM's role and the row fetch is an indexed load.
//
// Layout (engine-arranged, as in the JAX kernel): `blocks` stacked
// [L,20] block tables; slots grouped by block, cap_b slots each; lelem
// is block-local; flux is [blocks*L]. A crossing whose neighbour lives
// in another block (adjacency <= -2, encoded -(glid+2)) parks the
// particle with pending = glid for the caller's migration.
//
// What bounds it on an H100 (80GB HBM3, 700 W power limit): the contract
// rewrites every slot each round, walking or not. An active slot reads
// and writes 57 B in f32; an idle one 40 B (dest, lelem and the masks in,
// the outputs back), 52 B if it left the mesh (x too); the tables of the
// blocks that walk are read once (80 B a row) and their flux read and
// written. On chip_smoke.py's box (47 blocks, 1,010,688 slots) that is
// about 16 us for the first round and 12-14 us for a late one, where a
// few percent of the slots walk, scattered among the stayers, at 3.35
// TB/s. Each crossing is a chain of dependent row reads and one flux
// add, so in practice latency bounds the early rounds; the measured
// times per round stand in PERF.md.
//
// What the design does about it (csrc/block_walk_sched.cuh): a persistent
// grid of (blocks, k) CUDA blocks of 512 threads, k from the occupancy
// query so the grid is resident at once; each CUDA block owns every k-th
// 512-slot chunk of its partition block's slots, writes out the idle
// slots in one coalesced pass while compacting the active ones into a
// shared work list, and then:
// - with an empty list it stages nothing;
// - otherwise it copies the block's table into shared memory with one
//   TMA bulk copy (80 B rows in f32, 160 B in f64), started during the
//   pass as soon as the list holds a particle, walks with 16-byte row
//   loads and a shared [L] flux partial, and adds the partial's nonzero
//   entries into global flux once.
// Threads pull list entries through a shared counter, so a warp never
// idles behind one long walk, and `iters` is reduced per warp and
// max-ed into global memory once per CUDA block. Shared memory: the
// [L,20] table, the [L] partial and the list (84 B per element in f32
// plus 2 KB at least: L <= 2,742 in f32, 1,371 in f64).

#include <cuda_runtime.h>

#include "block_walk_sched.cuh"
#include "walk_step.cuh"

// One packed row into registers with 16-byte loads (5 x float4 in f32,
// 10 x double2 in f64); rows are 80 / 160 B and 16 B aligned.
__device__ __forceinline__ void load_row(const float* row, float r[20]) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float4 v = p[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_row(const double* row, double r[20]) {
  const double2* p = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    const double2 v = p[q];
    r[2 * q] = v.x;
    r[2 * q + 1] = v.y;
  }
}

// walk_step on a row in registers: walk_exit's arithmetic, then the exit
// face's neighbour picked by selects (indexing the row with the run-time
// face, as walk_step does, would put it in local memory).
template <typename T>
__device__ __forceinline__ T step_row(const T* row, T s, T dx, T dy, T dz,
                                      T px, T py, T pz, T tol, int* next,
                                      bool* reached) {
  T r[WALK_TABLE_WIDTH];
  load_row(row, r);
  int f;
  const T s_exit = walk_exit(r, s, dx, dy, dz, px, py, pz, tol, &f);
  const T adj = f == 0   ? r[WALK_TABLE_ADJ]
                : f == 1 ? r[WALK_TABLE_ADJ + 1]
                : f == 2 ? r[WALK_TABLE_ADJ + 2]
                         : r[WALK_TABLE_ADJ + 3];
  *reached = s_exit >= T(1);
  *next = static_cast<int>(adj);
  return *reached ? T(1) : s_exit;
}

template <typename T>
struct BlockWalkArgs {
  const T* table;
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
};

// Commit slot i: a particle that reached its destination commits dest
// bit-exactly; everyone else (boundary leavers, paused and idle slots)
// commits x0 + s*d0 with x0 = dest - d0, as the JAX kernel does.
template <typename T>
__device__ __forceinline__ void commit(const BlockWalkArgs<T>& a, size_t i,
                                       T px, T py, T pz, T dx, T dy, T dz,
                                       T s, int e, bool done, bool exited,
                                       int pending) {
  const bool at_dest = done && !exited;
  a.x_out[3 * i] = at_dest ? px : (px - dx) + s * dx;
  a.x_out[3 * i + 1] = at_dest ? py : (py - dy) + s * dy;
  a.x_out[3 * i + 2] = at_dest ? pz : (pz - dz) + s * dz;
  a.lelem_out[i] = e;
  a.done_out[i] = done;
  a.exited_out[i] = exited;
  a.pending_out[i] = pending;
}

// Walk slot i until it is done or paused; `rows` is the block's table
// in shared memory, `acc` its flux partial. Returns steps.
template <typename T>
__device__ __forceinline__ int walk_slot(const BlockWalkArgs<T>& a, size_t i,
                                         const T* rows, T* acc) {
  const T px = a.dest[3 * i], py = a.dest[3 * i + 1], pz = a.dest[3 * i + 2];
  const T dx = px - a.x[3 * i], dy = py - a.x[3 * i + 1],
          dz = pz - a.x[3 * i + 2];
  int e = a.lelem_in[i], pending = -1;
  bool done = false, exited = a.exited_in[i];
  const T eff_w =
      a.tally ? walk_eff_weight(dx, dy, dz, a.fly[i], a.w[i]) : T(0);
  T s = 0;
  int steps = 0;
  while (steps < a.max_iters) {
    int next;
    bool reached;
    const T s_new = step_row(rows + (size_t)e * WALK_TABLE_WIDTH, s, dx, dy,
                             dz, px, py, pz, a.tol, &next, &reached);
    const bool hit_boundary = !reached && next == -1;
    if (a.tally) {
      const T c = (s_new - s) * eff_w;
      if (c != T(0)) atomicAdd(acc + e, c);
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
  commit(a, i, px, py, pz, dx, dy, dz, s, e, done, exited, pending);
  return steps;
}

template <typename T>
__global__ void __launch_bounds__(SCHED_THREADS, 2)
    block_walk_kernel(const BlockWalkArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const size_t base = (size_t)b * a.cap_b;
  const T* table_b = a.table + (size_t)b * a.L * WALK_TABLE_WIDTH;
  T* flux_b = a.tally ? a.flux + (size_t)b * a.L : nullptr;
  const T* tbl_s = reinterpret_cast<const T*>(smem_raw + SCHED_HEADER_BYTES);
  T* part = reinterpret_cast<T*>(smem_raw + sched_part_offset(a.stage_bytes));

  sched_block<T>(
      smem_raw, blockIdx.y, gridDim.y, a.cap_b, a.list_cap, table_b,
      a.stage_bytes, a.L, a.tally != 0, flux_b, a.iters, a.counts,
      [&](int slot) { return !a.done_in[base + slot]; },
      [&](int slot) {
        // An idle slot commits dest unless it left the mesh, so x is read
        // only for one that did.
        const size_t i = base + slot;
        const bool exited = a.exited_in[i];
        const T px = a.dest[3 * i], py = a.dest[3 * i + 1],
                pz = a.dest[3 * i + 2];
        T dx = 0, dy = 0, dz = 0;
        if (exited) {
          dx = px - a.x[3 * i];
          dy = py - a.x[3 * i + 1];
          dz = pz - a.x[3 * i + 2];
        }
        commit(a, i, px, py, pz, dx, dy, dz, T(0), a.lelem_in[i], true,
               exited, -1);
      },
      // The table is always staged before the first walk.
      [&](int slot, bool) { return walk_slot(a, base + slot, tbl_s, part); });
}

template <typename T>
static int launch_block_walk(const void* table, const void* x,
                             const void* lelem, const void* dest,
                             const void* fly, const void* w,
                             const void* done, const void* exited,
                             void* flux, void* x_out, void* lelem_out,
                             void* done_out, void* exited_out,
                             void* pending_out, void* iters, void* counts,
                             int blocks, int L, int cap_b, double tol,
                             int max_iters, int tally, void* stream) {
  const size_t table_bytes = (size_t)L * WALK_TABLE_WIDTH * sizeof(T);
  size_t smem = 0;
  int list_cap = 0;
  if (L < 1 ||
      !sched_layout(table_bytes, (size_t)L * sizeof(T), &smem, &list_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks <= 0 || cap_b <= 0) return static_cast<int>(cudaGetLastError());
  const void* kernel = reinterpret_cast<const void*>(block_walk_kernel<T>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int k = 0;
  if (err != cudaSuccess ||
      (err = sched_blocks_per_part(kernel, smem, blocks, &k)) != cudaSuccess)
    return static_cast<int>(err);
  BlockWalkArgs<T> a;
  a.table = static_cast<const T*>(table);
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
  const dim3 grid(blocks, k);
  block_walk_kernel<T><<<grid, SCHED_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pumi_block_walk_f32(
    const void* table, const void* x, const void* lelem, const void* dest,
    const void* fly, const void* w, const void* done, const void* exited,
    void* flux, void* x_out, void* lelem_out, void* done_out,
    void* exited_out, void* pending_out, void* iters, void* counts,
    int blocks, int L, int cap_b, double tol, int max_iters, int tally,
    void* stream) {
  return launch_block_walk<float>(table, x, lelem, dest, fly, w, done, exited,
                                  flux, x_out, lelem_out, done_out,
                                  exited_out, pending_out, iters, counts,
                                  blocks, L, cap_b, tol, max_iters, tally,
                                  stream);
}

extern "C" int pumi_block_walk_f64(
    const void* table, const void* x, const void* lelem, const void* dest,
    const void* fly, const void* w, const void* done, const void* exited,
    void* flux, void* x_out, void* lelem_out, void* done_out,
    void* exited_out, void* pending_out, void* iters, void* counts,
    int blocks, int L, int cap_b, double tol, int max_iters, int tally,
    void* stream) {
  return launch_block_walk<double>(table, x, lelem, dest, fly, w, done,
                                   exited, flux, x_out, lelem_out, done_out,
                                   exited_out, pending_out, iters, counts,
                                   blocks, L, cap_b, tol, max_iters, tally,
                                   stream);
}
