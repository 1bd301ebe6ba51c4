// W0: the monolithic tallied tet walk.
//
// Replaces: pumiumtally_tpu/ops/walk.py `walk` (an XLA while_loop, not a
// Pallas kernel) -- the whole device cost of the main path
// (PumiTally.CopyInitialPosition / MoveToNextLocation).
//
// What bounds it on an H100: each crossing reads one 80 B (f32) table
// row of the current tet at a data-dependent address and adds one value
// into flux[elem]. The f32 table of the 48k-tet bench mesh is 3.8 MB, so
// rows come from the 50 MB L2, not HBM; the floor is the per-particle
// state read and written once (x, dest, elem, fly, w in; x, elem, done,
// exited, s out) plus the table and flux once. In practice the walk
// stays far above that floor: the 32 lanes of a warp read 32 unrelated
// rows, so every crossing asks L2 for scattered 32-byte sectors (three
// for the packed row, one for the select row and one or two for the
// refinement row) and one flux atomic, and its cost follows their count
// (chip_smoke.py prints the SM cycles per crossing; PERF.md reads it).
//
// What the design does about it:
// - the packed row comes as five 16-byte loads (ten in f64), not twenty
//   scalar ones, and the exit face's neighbour is picked by selects from
//   registers (walk_step.cuh);
// - a persistent grid (the SM count times the resident blocks per SM,
//   occupancy.cuh, capped at what n needs) whose lanes pull particles:
//   once WALK_REFILL lanes of a warp (or all of them) have no particle,
//   they take the next indices of the warp's share, and a warp whose
//   share is spent takes the next WALK_GRAB indices from a global counter
//   with one atomic (indices handed out by ballot and popc); no warp runs
//   on for its slowest lane and no CUDA block holds its SM slot for one
//   long walk. Refilling several lanes at once reads consecutive
//   particles together;
// - a lane whose particle ended stages its outputs in shared memory, in
//   its share's slot of a ring of WALK_RING shares, and the warp writes a
//   share out, coalesced, once all its particles ended (written by each
//   lane at its own scattered index, each of the seven output stores
//   asks L2 for a sector of its own);
// - max_iters is a per-particle budget; `iters` is reduced per warp and
//   per CUDA block and max-ed into global memory once per CUDA block.
// Flux goes through atomicAdd (double atomics for f64), so its summation
// order, and only that, varies from run to run. Positions are
// materialised once from the ray coordinate at the end; a particle that
// reaches its destination commits dest bit-exactly (the continue-mode
// contract). No compaction cascade: the lanes that pull work have no
// lock-step waste to bound.
//
// The two-tier variant (kTwoTier; the JAX walk's lo_select branch,
// ops/walk.py _advance_geometry :425-431) reads, per crossing, the tet's
// 32 B bf16 select row as two 16-byte loads and then the winning face's
// 20 B (f32) refinement row, whose adj lane names the neighbour: 52 B
// instead of 80 B, and face_adj is never read (csrc/twotier_step.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "twotier_step.cuh"
#include "walk_step.cuh"

#define WALK_THREADS 256
#define WALK_GRAB 32    // particle indices a warp takes per global atomic
#define WALK_REFILL 16  // idle lanes that make a warp refill
#define WALK_RING 4     // shares whose outputs a warp stages at once

template <typename T>
struct WalkArgs {
  const T* table;
  const uint16_t* table_lo;
  const T* table_hi;
  const T* x;
  const int* elem_in;
  const T* dest;
  const signed char* fly;
  const T* w;
  const T* s_init;
  T* flux;
  T* x_out;
  int* elem_out;
  bool* done_out;
  bool* exited_out;
  T* s_out;
  int* iters;
  int* next;  // the global particle counter, zeroed by the caller
  int* counts;
  int n, max_iters, tally;
  T tol;
};

// One crossing of the tet `e` with its rows read from global memory.
template <typename T, bool kTwoTier>
__device__ __forceinline__ T crossing(const WalkArgs<T>& a, int e, T s,
                                      T dx, T dy, T dz, T px, T py, T pz,
                                      int* next, bool* reached) {
  if constexpr (kTwoTier) {
    return twotier_step(a.table_lo + (size_t)e * WALK_TABLE_LO_WIDTH,
                        a.table_hi, e, s, dx, dy, dz, px, py, pz, a.tol, next,
                        reached);
  } else {
    T r[WALK_TABLE_WIDTH];
    walk_load_row(a.table + (size_t)e * WALK_TABLE_WIDTH, r);
    return walk_step(r, s, dx, dy, dz, px, py, pz, a.tol, next, reached);
  }
}

// One warp's staged outputs: WALK_RING shares of 32 particles, a
// particle's record at its index mod 32.
template <typename T>
struct WalkStage {
  T x[WALK_RING][96];  // x_out of the share's particles, [32][3]
  T s[WALK_RING][32];
  int elem[WALK_RING][32];
  unsigned char flags[WALK_RING][32];  // done | exited << 1
};

// Write ring slot `r`'s staged records whose bit is set in `mask` to the
// outputs of particles [base, base + 32) (clipped to n), coalesced.
template <typename T>
__device__ __forceinline__ void walk_flush(const WalkArgs<T>& a,
                                           const WalkStage<T>& st, int r,
                                           int base, unsigned mask,
                                           int lane) {
  __syncwarp();  // the lanes' records are visible
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int k = 32 * q + lane;
    if ((mask >> (k / 3)) & 1u && base + k / 3 < a.n)
      a.x_out[3 * (size_t)base + k] = st.x[r][k];
  }
  const int j = base + lane;
  if ((mask >> lane) & 1u && j < a.n) {
    a.s_out[j] = st.s[r][lane];
    a.elem_out[j] = st.elem[r][lane];
    a.done_out[j] = st.flags[r][lane] & 1;
    a.exited_out[j] = st.flags[r][lane] >> 1;
  }
  __syncwarp();  // the slot may be written again
}

template <typename T, bool kTwoTier>
__global__ void __launch_bounds__(WALK_THREADS)
    walk_kernel(const WalkArgs<T> a) {
  __shared__ int block_iters, block_walked;
  __shared__ WalkStage<T> stage[WALK_THREADS / 32];
  WalkStage<T>& st = stage[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) {
    block_iters = 0;
    block_walked = 0;
  }
  __syncthreads();

  // The warp's share of particle indices [pool, pool_end), the same in
  // every lane; `drained`: the global counter has passed n. Shares start
  // at multiples of 32 (WALK_GRAB), so a particle's place in its share is
  // its index mod 32. Each share is staged in ring slot `cur`:
  // ring_base[r] is the share in slot r (-1: free) and ring_done[r] the
  // places whose record is staged or that lie past n; a full slot is
  // flushed. A share that needs a slot still held by an older one
  // flushes what that one has staged, and the older share's remaining
  // particles write their outputs directly (slot -1).
  int pool = 0, pool_end = 0, cur = WALK_RING - 1;
  bool drained = false;
  int ring_base[WALK_RING];
  unsigned ring_done[WALK_RING];
#pragma unroll
  for (int r = 0; r < WALK_RING; ++r) {
    ring_base[r] = -1;
    ring_done[r] = 0;
  }
  int i = -1;  // this lane's particle, -1 while it has none
  int slot = -1;  // the ring slot of its share, -1: write directly
  T px = 0, py = 0, pz = 0, dx = 0, dy = 0, dz = 0, eff_w = 0, s = 0;
  int e = 0, steps = 0, steps_max = 0, walked = 0;
  for (;;) {
    // Once WALK_REFILL lanes (or all) have no particle, they take the
    // next indices of the warp's share, in lane order; an empty share is
    // refilled first.
    const unsigned idle = __ballot_sync(0xffffffffu, i < 0);
    if (__popc(idle) >= WALK_REFILL || idle == 0xffffffffu) {
      if (pool == pool_end && !drained) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.next, WALK_GRAB);
        base = __shfl_sync(0xffffffffu, base, 0);
        pool = min(base, a.n);
        pool_end = min(base + WALK_GRAB, a.n);
        drained = base + WALK_GRAB >= a.n;
        if (pool < pool_end) {
          cur = cur + 1 == WALK_RING ? 0 : cur + 1;
#pragma unroll
          for (int r = 0; r < WALK_RING; ++r) {
            if (r != cur) continue;
            if (ring_base[r] >= 0) {
              walk_flush(a, st, r, ring_base[r], ring_done[r], lane);
              if (slot == r) slot = -1;
            }
            ring_base[r] = base;
            const int m = pool_end - base;
            ring_done[r] = m == 32 ? 0u : ~((1u << m) - 1u);
          }
        }
      }
      const int take = pool + __popc(idle & below);
      if (i < 0 && take < pool_end) {
        i = take;
        slot = cur;
        px = a.dest[3 * i];
        py = a.dest[3 * i + 1];
        pz = a.dest[3 * i + 2];
        dx = px - a.x[3 * i];
        dy = py - a.x[3 * i + 1];
        dz = pz - a.x[3 * i + 2];
        eff_w = a.tally ? walk_eff_weight(dx, dy, dz, a.fly[i], a.w[i])
                        : T(0);
        s = a.s_init ? a.s_init[i] : T(0);
        e = a.elem_in[i];
        steps = 0;
      }
      pool = min(pool + __popc(idle), pool_end);
    }
    if (!__any_sync(0xffffffffu, i >= 0)) break;

    bool done = false, fin = false;
    if (i >= 0) {
      if (steps < a.max_iters) {
        int next;
        bool reached;
        const T s_new = crossing<T, kTwoTier>(a, e, s, dx, dy, dz, px, py,
                                              pz, &next, &reached);
        const bool hit_boundary = !reached && next == -1;
        if (a.tally) {
          const T c = (s_new - s) * eff_w;
          if (c != T(0)) atomicAdd(a.flux + e, c);
        }
        if (!reached && !hit_boundary) e = next;
        s = s_new;
        done = reached || hit_boundary;
        ++steps;
      }
      fin = done || steps >= a.max_iters;
    }
    // A particle that ended stages its record (or writes it directly).
    unsigned place = 0;
    if (fin) {
      const bool exited = done && s < T(1);
      const bool at_dest = done && !exited;
      const T xo[3] = {at_dest ? px : px + (s - T(1)) * dx,
                       at_dest ? py : py + (s - T(1)) * dy,
                       at_dest ? pz : pz + (s - T(1)) * dz};
      const unsigned char flags = (done ? 1 : 0) | (exited ? 2 : 0);
      if (slot >= 0) {
        const int k = i & 31;
        st.x[slot][3 * k] = xo[0];
        st.x[slot][3 * k + 1] = xo[1];
        st.x[slot][3 * k + 2] = xo[2];
        st.s[slot][k] = s;
        st.elem[slot][k] = e;
        st.flags[slot][k] = flags;
        place = 1u << k;
      } else {
        a.x_out[3 * i] = xo[0];
        a.x_out[3 * i + 1] = xo[1];
        a.x_out[3 * i + 2] = xo[2];
        a.elem_out[i] = e;
        a.done_out[i] = done;
        a.exited_out[i] = exited;
        a.s_out[i] = s;
      }
      steps_max = steps > steps_max ? steps : steps_max;
      ++walked;
      i = -1;
    }
    if (__any_sync(0xffffffffu, place != 0)) {
#pragma unroll
      for (int r = 0; r < WALK_RING; ++r) {
        ring_done[r] |= __reduce_or_sync(0xffffffffu, slot == r ? place : 0u);
        if (ring_base[r] >= 0 && ring_done[r] == 0xffffffffu) {
          walk_flush(a, st, r, ring_base[r], ring_done[r], lane);
          ring_base[r] = -1;
          ring_done[r] = 0;
        }
      }
    }
  }
  // Every slot was flushed when its last particle ended.

  const int warp_max = __reduce_max_sync(0xffffffffu, steps_max);
  const int warp_walked = __reduce_add_sync(0xffffffffu, walked);
  if (lane == 0) {
    if (warp_max > 0) atomicMax(&block_iters, warp_max);
    if (warp_walked > 0) atomicAdd(&block_walked, warp_walked);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_iters > 0) atomicMax(a.iters, block_iters);
    if (a.counts != nullptr) atomicAdd(a.counts, block_walked);
  }
}

template <typename T, bool kTwoTier>
static int launch_walk(const WalkArgs<T>& a, void* stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  int resident = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(walk_kernel<T, kTwoTier>), WALK_THREADS,
      0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (a.n + WALK_THREADS - 1) / WALK_THREADS;
  walk_kernel<T, kTwoTier>
      <<<needed < resident ? needed : resident, WALK_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static WalkArgs<T> walk_args(const void* table, const void* table_lo,
                             const void* table_hi, const void* x,
                             const void* elem, const void* dest,
                             const void* fly, const void* w,
                             const void* s_init, void* flux, void* x_out,
                             void* elem_out, void* done_out, void* exited_out,
                             void* s_out, void* iters, void* next,
                             void* counts, int n, double tol, int max_iters,
                             int tally) {
  WalkArgs<T> a;
  a.table = static_cast<const T*>(table);
  a.table_lo = static_cast<const uint16_t*>(table_lo);
  a.table_hi = static_cast<const T*>(table_hi);
  a.x = static_cast<const T*>(x);
  a.elem_in = static_cast<const int*>(elem);
  a.dest = static_cast<const T*>(dest);
  a.fly = static_cast<const signed char*>(fly);
  a.w = static_cast<const T*>(w);
  a.s_init = static_cast<const T*>(s_init);
  a.flux = static_cast<T*>(flux);
  a.x_out = static_cast<T*>(x_out);
  a.elem_out = static_cast<int*>(elem_out);
  a.done_out = static_cast<bool*>(done_out);
  a.exited_out = static_cast<bool*>(exited_out);
  a.s_out = static_cast<T*>(s_out);
  a.iters = static_cast<int*>(iters);
  a.next = static_cast<int*>(next);
  a.counts = static_cast<int*>(counts);
  a.n = n;
  a.max_iters = max_iters;
  a.tally = tally;
  a.tol = static_cast<T>(tol);
  return a;
}

// The particle arguments every entry takes after its tables.
#define WALK_PARTICLE_PARAMS                                                \
  const void *x, const void *elem, const void *dest, const void *fly,      \
      const void *w, const void *s_init, void *flux, void *x_out,           \
      void *elem_out, void *done_out, void *exited_out, void *s_out,        \
      void *iters, void *next, void *counts, int n, double tol,             \
      int max_iters, int tally, void *stream
#define WALK_PARTICLE_ARGS                                                  \
  x, elem, dest, fly, w, s_init, flux, x_out, elem_out, done_out,           \
      exited_out, s_out, iters, next, counts, n, tol, max_iters, tally

extern "C" int pumi_walk_f32(const void* table, WALK_PARTICLE_PARAMS) {
  return launch_walk<float, false>(
      walk_args<float>(table, nullptr, nullptr, WALK_PARTICLE_ARGS), stream);
}

extern "C" int pumi_walk_f64(const void* table, WALK_PARTICLE_PARAMS) {
  return launch_walk<double, false>(
      walk_args<double>(table, nullptr, nullptr, WALK_PARTICLE_ARGS), stream);
}

extern "C" int pumi_walk_twotier_f32(const void* table_lo,
                                     const void* table_hi,
                                     WALK_PARTICLE_PARAMS) {
  return launch_walk<float, true>(
      walk_args<float>(nullptr, table_lo, table_hi, WALK_PARTICLE_ARGS),
      stream);
}

extern "C" int pumi_walk_twotier_f64(const void* table_lo,
                                     const void* table_hi,
                                     WALK_PARTICLE_PARAMS) {
  return launch_walk<double, true>(
      walk_args<double>(nullptr, table_lo, table_hi, WALK_PARTICLE_ARGS),
      stream);
}
