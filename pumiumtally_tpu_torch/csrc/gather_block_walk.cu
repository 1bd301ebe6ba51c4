// W4: the gather block walk of the partitioned engine.
//
// Replaces: pumiumtally_tpu/parallel/partition.py `walk_local` (:466, an
// XLA while_loop, not a Pallas kernel): the walk of every round of the
// partitioned facades' default configuration (one block holding the
// whole mesh), of the gather sub-split (walk_block_kernel="gather": the
// occupied blocks only), of bf16 tables with the vmem kernel and of
// scoring on the float32 tables. It is the partitioned counterpart of
// W0 and, like W0, the whole device cost of those paths.
//
// Layout (engine-arranged, as in the JAX engine): `blocks` stacked
// blocks of L rows, either [L,20] packed rows (four normals, four
// offsets, four local-encoded neighbours as floats) with, optionally,
// the [L,4] int32 adjacency sidecar (then the rows' adjacency lanes are
// ignored), or the two-tier [L,16] bf16 select rows with [L*4,5]
// refinement rows (row (b*L + lelem)*4 + f, whose adj lane names the
// neighbour); slots grouped by block, cb slots each; lelem block-local;
// flux [blocks*L]. Adjacency: -1 is the domain boundary (the particle
// is done and exited), <= -2 a face into another block (the particle
// pauses with pending = -nxt-2 and keeps its lelem), else the local
// neighbour.
//
// Arithmetic (the JAX walk_local's, not W0's): the packed exit test is
// x0-based, a = n.d0 and b = off - n.x0 with x0 the round's start x;
// the two-tier path rebuilds dest_c = x0 + d0 and hands that to the
// select and the refinement (twotier_step.cuh); eff_w = fly ? w*|d0| :
// 0; a crossing adds (s_new - s) * eff_w into flux[lelem] of its block;
// the final position is dest for a particle that reached it, else
// x0 + s*d0. Built with --fmad=false in the plain version's operation
// order (parallel/partition.py walk_local_plain, exit_cols_x0), so that
// positions, ids, masks and iters agree bitwise; flux sums in another
// order (float atomics).
//
// What bounds it on an H100 (80GB HBM3): rows stay in global memory,
// through the 50 MB L2 (the box's one block is 3.84 MB of f32 rows, the
// lattice's 78.8 MB): staging a block in shared memory is what W1 does,
// and this route exists for blocks that do not fit there. Per crossing
// one 80 B packed row (five 16-byte loads; with the sidecar one more
// 16-byte load) or a 32 B select row and a 20 B refinement row, and one
// flux atomic, at data-dependent addresses: a dependent chain, so
// latency and scattered L2 sectors bound it, not the bytes (each slot of
// a walked block read and written once, each crossed row read once).
//
// Design: the simple one. One thread per slot, a 1-D grid over the
// pairs (listed block, tile of 256 of its slots), a block's tiles
// adjacent, the blocks those of the occupied-block list `block_ids`
// (null: every block), so a block with no not-done slot launches
// nothing. On grid.x, not a second grid dimension: grid.y stops at
// 65,535, and a gather sub-split can list more blocks than that. Each thread walks its particle to the end, to a
// pause or to max_iters, and writes its slot's outputs once; `iters` is
// max-reduced per warp and max-ed into global memory. No persistent
// grid, no staging, no compaction of idle slots: making W4 fast is a
// later change (PERF.md).
//
// Scoring (kScore; walk_local's `scoring=` hook, partition.py:563-569,
// 613-624): block b's lanes are the [L*stride] slice at b*L*stride of
// the padded bank; each crossing (interior step, block-face pause or
// boundary exit: a pause commits its crossing, counted once across the
// migration) adds score_pair's values into lanes lelem*stride + bin_off
// + k through the scoring commit (score_lanes, walk_step.cuh). A
// crossing whose first lane lies at or past the slice's end (the DROP
// sentinel's bin offset) is dropped whole; a zero value is not added.

#include <cuda_runtime.h>
#include <stdint.h>

#include "twotier_step.cuh"
#include "walk_step.cuh"

#define GATHER_THREADS 256

template <typename T>
struct GatherArgs {
  const T* table;       // packed rows (null when two-tier)
  const int* adj_int;   // [blocks*L, 4] sidecar, or null
  const uint16_t* table_lo;  // two-tier select rows
  const T* table_hi;    // two-tier refinement rows
  const T* x;
  const int* lelem;
  const T* dest;
  const signed char* fly;
  const T* w;
  const bool* done;
  const bool* exited;
  T* flux;
  T* x_out;
  int* lelem_out;
  bool* done_out;
  bool* exited_out;
  int* pending;
  int* iters;
  const int* block_ids;  // the walked blocks, or null: every block
  int L, cb, tiles, max_iters, tally;  // tiles: CUDA blocks a block
  T tol;
  T* bank;
  const int* bin_off;
  const T* fac;
  int stride, nscores, kinds;
};

// The packed exit of the tet whose 16 plane values start at `row`, in
// walk_local's x0-based form: b = off - n.x0. Returns s_exit (infinite
// when no face lies ahead, not clamped to 1) and the first minimal face.
template <typename T>
__device__ __forceinline__ T exit_x0(const T r[WALK_TABLE_WIDTH], T s, T dx,
                                     T dy, T dz, T qx, T qy, T qz, T tol,
                                     int* f_exit) {
  const T one = T(1);
  T s_exit = walk_inf<T>();
  int f_min = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T nx = r[3 * f], ny = r[3 * f + 1], nz = r[3 * f + 2];
    const T a = nx * dx + ny * dy + nz * dz;
    const T n_x0 = nx * qx + ny * qy + nz * qz;
    const T b = r[WALK_TABLE_OFFSETS + f] - n_x0;
    const bool crossing = a * (one - s) > tol;
    T s_f = crossing ? b / a : walk_inf<T>();
    s_f = s_f > s ? s_f : s;
    if (f == 0 || s_f < s_exit) {
      s_exit = s_f;
      f_min = f;
    }
  }
  *f_exit = f_min;
  return s_exit;
}

template <typename T, bool kTwoTier, bool kScore>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_block_walk_kernel(const GatherArgs<T> a) {
  const int j = static_cast<int>(blockIdx.x) / a.tiles;  // list position
  const int b = a.block_ids != nullptr ? a.block_ids[j] : j;
  const int r = (static_cast<int>(blockIdx.x) - j * a.tiles) * GATHER_THREADS
                + threadIdx.x;
  int steps = 0;
  if (r < a.cb) {
    const size_t i = (size_t)b * a.cb + r;
    const size_t row0 = (size_t)b * a.L;  // the block's first row
    const T qx = a.x[3 * i], qy = a.x[3 * i + 1], qz = a.x[3 * i + 2];
    const T px = a.dest[3 * i], py = a.dest[3 * i + 1],
            pz = a.dest[3 * i + 2];
    const T dx = px - qx, dy = py - qy, dz = pz - qz;
    const T eff_w =
        a.tally ? walk_eff_weight(dx, dy, dz, a.fly[i], a.w[i]) : T(0);
    bool done = a.done[i], exited = a.exited[i];
    int e = a.lelem[i], pending = -1;
    T s = T(0);
    int sbin = 0;
    T sfac[3] = {0, 0, 0};
    if constexpr (kScore) {
      sbin = a.bin_off[i];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sfac[k] = k < a.nscores ? a.fac[i * a.nscores + k] : T(0);
    }
    while (!done && steps < a.max_iters) {
      int next;
      bool reached;
      T s_new;
      if constexpr (kTwoTier) {
        // dest_c = x0 + d0 feeds both tiers (walk_local, :582).
        s_new = twotier_step(a.table_lo + (row0 + e) * WALK_TABLE_LO_WIDTH,
                             a.table_hi, static_cast<int>(row0 + e), s, dx,
                             dy, dz, qx + dx, qy + dy, qz + dz, a.tol, &next,
                             &reached);
      } else {
        T row[WALK_TABLE_WIDTH];
        walk_load_row(a.table + (row0 + e) * WALK_TABLE_WIDTH, row);
        int f;
        const T s_exit = exit_x0(row, s, dx, dy, dz, qx, qy, qz, a.tol, &f);
        if (a.adj_int != nullptr) {
          const int4 adj =
              *reinterpret_cast<const int4*>(a.adj_int + (row0 + e) * 4);
          next = f == 0 ? adj.x : f == 1 ? adj.y : f == 2 ? adj.z : adj.w;
        } else {
          next = static_cast<int>(f == 0   ? row[WALK_TABLE_ADJ]
                                  : f == 1 ? row[WALK_TABLE_ADJ + 1]
                                  : f == 2 ? row[WALK_TABLE_ADJ + 2]
                                           : row[WALK_TABLE_ADJ + 3]);
        }
        reached = s_exit >= T(1);
        s_new = reached ? T(1) : s_exit;
      }
      const bool hit_boundary = !reached && next == -1;
      const bool goes_remote = !reached && next <= -2;
      if (a.tally) {
        const T c = (s_new - s) * eff_w;
        if (c != T(0)) atomicAdd(a.flux + row0 + e, c);
        // Outside the c != 0 guard: a zero-length step is a crossing.
        if constexpr (kScore)
          if ((long long)e * a.stride + sbin < (long long)a.L * a.stride)
            score_lanes(a.bank + (row0 + e) * a.stride, a.stride, sbin,
                        a.nscores, a.kinds, c, !reached, sfac);
      }
      if (!reached && !hit_boundary && !goes_remote) e = next;
      s = s_new;
      if (goes_remote) pending = -next - 2;
      done = reached || hit_boundary;
      exited = exited || hit_boundary;
      ++steps;
      if (goes_remote) break;
    }
    const bool at_dest = done && !exited;
    a.x_out[3 * i] = at_dest ? px : qx + s * dx;
    a.x_out[3 * i + 1] = at_dest ? py : qy + s * dy;
    a.x_out[3 * i + 2] = at_dest ? pz : qz + s * dz;
    a.lelem_out[i] = e;
    a.done_out[i] = done;
    a.exited_out[i] = exited;
    a.pending[i] = pending;
  }
  const int warp_max = __reduce_max_sync(0xffffffffu, steps);
  if ((threadIdx.x & 31) == 0 && warp_max > 0) atomicMax(a.iters, warp_max);
}

template <typename T, bool kTwoTier, bool kScore>
static int launch_gather(GatherArgs<T> a, int n_occ, void* stream) {
  if (n_occ <= 0 || a.cb <= 0) return static_cast<int>(cudaGetLastError());
  a.tiles = (a.cb + GATHER_THREADS - 1) / GATHER_THREADS;
  const long long grid = static_cast<long long>(a.tiles) * n_occ;
  if (grid > 0x7fffffffLL)  // grid.x's limit, 2**31 - 1
    return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_block_walk_kernel<T, kTwoTier, kScore>
      <<<static_cast<unsigned>(grid), GATHER_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static GatherArgs<T> gather_args(
    const void* table, const void* adj_int, const void* table_lo,
    const void* table_hi, const void* x, const void* lelem, const void* dest,
    const void* fly, const void* w, const void* done, const void* exited,
    void* flux, void* x_out, void* lelem_out, void* done_out,
    void* exited_out, void* pending, void* iters, const void* block_ids,
    int L, int cb, double tol, int max_iters, int tally) {
  GatherArgs<T> a;
  a.table = static_cast<const T*>(table);
  a.adj_int = static_cast<const int*>(adj_int);
  a.table_lo = static_cast<const uint16_t*>(table_lo);
  a.table_hi = static_cast<const T*>(table_hi);
  a.x = static_cast<const T*>(x);
  a.lelem = static_cast<const int*>(lelem);
  a.dest = static_cast<const T*>(dest);
  a.fly = static_cast<const signed char*>(fly);
  a.w = static_cast<const T*>(w);
  a.done = static_cast<const bool*>(done);
  a.exited = static_cast<const bool*>(exited);
  a.flux = static_cast<T*>(flux);
  a.x_out = static_cast<T*>(x_out);
  a.lelem_out = static_cast<int*>(lelem_out);
  a.done_out = static_cast<bool*>(done_out);
  a.exited_out = static_cast<bool*>(exited_out);
  a.pending = static_cast<int*>(pending);
  a.iters = static_cast<int*>(iters);
  a.block_ids = static_cast<const int*>(block_ids);
  a.L = L;
  a.cb = cb;
  a.tiles = 0;  // set by launch_gather
  a.max_iters = max_iters;
  a.tally = tally;
  a.tol = static_cast<T>(tol);
  a.bank = nullptr;
  a.bin_off = nullptr;
  a.fac = nullptr;
  a.stride = a.nscores = a.kinds = 0;
  return a;
}

template <typename T>
static GatherArgs<T> with_scoring(GatherArgs<T> a, void* bank,
                                  const void* bin_off, const void* fac,
                                  int stride, int nscores, int kinds) {
  a.bank = static_cast<T*>(bank);
  a.bin_off = static_cast<const int*>(bin_off);
  a.fac = static_cast<const T*>(fac);
  a.stride = stride;
  a.nscores = nscores;
  a.kinds = kinds;
  return a;
}

// The slot arguments every entry takes after its tables.
#define GATHER_SLOT_PARAMS                                                \
  const void *x, const void *lelem, const void *dest, const void *fly,   \
      const void *w, const void *done, const void *exited, void *flux,    \
      void *x_out, void *lelem_out, void *done_out, void *exited_out,     \
      void *pending, void *iters, const void *block_ids, int n_occ,       \
      int L, int cb, double tol, int max_iters, int tally, void *stream
#define GATHER_SLOT_ARGS                                                  \
  x, lelem, dest, fly, w, done, exited, flux, x_out, lelem_out, done_out, \
      exited_out, pending, iters, block_ids, L, cb, tol, max_iters, tally
#define GATHER_SCORE_PARAMS                                               \
  void *bank, const void *bin_off, const void *fac, int stride,           \
      int nscores, int kinds
#define GATHER_SCORE_ARGS bank, bin_off, fac, stride, nscores, kinds

#define GATHER_ENTRIES(SUFFIX, T)                                          \
  extern "C" int pumi_gather_block_walk_##SUFFIX(                          \
      const void* table, const void* adj_int, GATHER_SLOT_PARAMS) {        \
    return launch_gather<T, false, false>(                                 \
        gather_args<T>(table, adj_int, nullptr, nullptr, GATHER_SLOT_ARGS), \
        n_occ, stream);                                                    \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_twotier_##SUFFIX(                  \
      const void* table_lo, const void* table_hi, GATHER_SLOT_PARAMS) {    \
    return launch_gather<T, true, false>(                                  \
        gather_args<T>(nullptr, nullptr, table_lo, table_hi,               \
                       GATHER_SLOT_ARGS),                                  \
        n_occ, stream);                                                    \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_scored_##SUFFIX(                   \
      GATHER_SCORE_PARAMS, const void* table, const void* adj_int,         \
      GATHER_SLOT_PARAMS) {                                                \
    return launch_gather<T, false, true>(                                  \
        with_scoring(gather_args<T>(table, adj_int, nullptr, nullptr,      \
                                    GATHER_SLOT_ARGS),                     \
                     GATHER_SCORE_ARGS),                                   \
        n_occ, stream);                                                    \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_twotier_scored_##SUFFIX(           \
      GATHER_SCORE_PARAMS, const void* table_lo, const void* table_hi,     \
      GATHER_SLOT_PARAMS) {                                                \
    return launch_gather<T, true, true>(                                   \
        with_scoring(gather_args<T>(nullptr, nullptr, table_lo, table_hi,  \
                                    GATHER_SLOT_ARGS),                     \
                     GATHER_SCORE_ARGS),                                   \
        n_occ, stream);                                                    \
  }

GATHER_ENTRIES(f32, float)
GATHER_ENTRIES(f64, double)
