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
// order, and only that, varies from run to run; the kDet instantiations
// (entries given a `det` record description, the deterministic commit
// of ops/det_commit.py) write one record a contribution instead
// (det_records.cuh: the element, the crossing's step and the particle's
// index, the value), which det_commit.cu adds in the plain version's
// order. Positions are
// materialised once from the ray coordinate at the end; a particle that
// reaches its destination commits dest bit-exactly (the continue-mode
// contract). No compaction cascade: the lanes that pull work have no
// lock-step waste to bound.
//
// `skip` (optional, device int32): the port of the JAX move's
// `lax.cond(trivial, skip_a, run_a)` (api/tally.py:326), decided on the
// device so that the host never waits for it. Each CUDA block reads it
// once; when it is non-zero the kernel walks nothing and writes every
// particle's inputs back out: x_out = x, elem_out = elem, done = 1,
// exited = 0, s = s_init (or 0), leaving counts and iters alone.
//
// Scoring (kScore; the JAX walk's `scoring=` hook, ops/walk.py:449 through
// `score_pair` :177 and `fused_tally_body` :196): at every crossing each of
// the spec's S <= 3 scores adds into lane e*stride + bin_off + k of the
// flattened bank the value c * fac[k] for a "track" score (c = (s_new -
// s) * eff_w, the flux lane's own value) and fac[k] for a "count" score
// when the step crossed a face (interior step or boundary exit). A
// crossing whose first lane lies at or past bank_size (the DROP
// sentinel's) is dropped whole; a zero value is not added. The
// particle's bin offset and factors are loaded into registers once, when
// a lane takes the particle. The scoring-off instantiation is the code
// without any of this, and scoring changes no position, element, ray
// coordinate or flag. Bound: each bank lane the walk touches, read and
// written once, and bin_off/fac once per particle join the bytes above.
// The lanes lie at scattered addresses of an E*stride bank (18 MB in f32
// on the box at stride 96, 378 MB on the lattice, past L2), so the cost
// is the count of reductions and of the sectors they touch. The commit
// (score_lanes, walk_step.cuh) covers a crossing's lanes with the fewest
// naturally aligned vector reductions in f32 (v4 / v2 / scalar, each in
// one 16-byte quad: 1.5 a crossing at S = 3, not 3 scalar atomics); f64
// keeps a scalar atomic a lane. The kDet instantiations write a record a
// non-zero lane instead (det_score_lanes).
//
// The two-tier variant (kLayout WALK_TWO_TIER; the JAX walk's lo_select
// branch, ops/walk.py _advance_geometry :425-431) reads, per crossing, the
// tet's 32 B bf16 select row as two 16-byte loads and then the winning
// face's 20 B (f32) refinement row, whose adj lane names the neighbour:
// 52 B instead of 80 B, and face_adj is never read (csrc/twotier_step.cuh).
//
// The unpacked variant (WALK_UNPACKED; the JAX walk's `_gather_walk_row`
// fallback, ops/walk.py:279-290) reads a tet's four planes from two arrays
// and its neighbours from the int32 face_adj: face f of tet e has its
// normal at nrm[(4e + f) * nstride + c] and its offset at
// off[(4e + f) * ostride], its neighbour at adj[4e + f] (one 16-byte int4
// load, as W4's sidecar). Two callers share it: a mesh whose ids a float
// lane cannot hold exactly (2^24 tets or more in float32; strides 3 and 1,
// the stored planes) and the float32 tier of a two-tier mesh (strides 5
// and 5, the refinement tier's planes in place: `nrm` its row base, `off`
// the row base + 3). The same 80 B a crossing in f32 (48 B normals, 16 B
// offsets, 16 B ids) as the packed row, from three places: more sectors.
// The plane values are scalar loads (the strides are run-time); the
// arithmetic is walk_step.cuh's, so positions and ids equal the packed
// walk's on the same planes.
//
// The segmented commit (kSeg; the JAX walk's `tally_seg`, ops/walk.py:470,
// :533-556, the service's cross-session fusion): an int32 offset a
// particle, `seg[i]`, moves its flux index to seg[i] + e, in a flux bank
// of `flux_size` entries that concatenates several sessions' [E] fluxes;
// an index at or past flux_size (a padding row's) is dropped, as the
// scoring lanes drop theirs. The atomic commit and the kDet records both
// take the shifted index. The scoring lanes keep e*stride + bin_off (the
// caller shifts bin_off). A null `seg` launches the instantiation without
// any of this, the code as before.

#include <cuda_runtime.h>
#include <stdint.h>

#include "det_records.cuh"
#include "occupancy.cuh"
#include "twotier_step.cuh"
#include "walk_step.cuh"

#define WALK_THREADS 256
#define WALK_GRAB 32    // particle indices a warp takes per global atomic
#define WALK_REFILL 16  // idle lanes that make a warp refill
#define WALK_RING 4     // shares whose outputs a warp stages at once

// Walk layouts, the kernel's kLayout: the packed row, the two tiers, the
// unpacked planes and ids.
#define WALK_PACKED 0
#define WALK_TWO_TIER 1
#define WALK_UNPACKED 2

template <typename T>
struct WalkArgs {
  const T* table;
  const uint16_t* table_lo;
  const T* table_hi;
  // WALK_UNPACKED: the planes and neighbour ids, and the planes' strides
  // in elements between one face and the next.
  const T* nrm;
  const T* off;
  const int* adj;
  int nstride, ostride;
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
  const int* skip;
  int n, max_iters, tally;
  T tol;
  // Scoring (kScore only): the bank, each particle's lane offset and its
  // [nscores] factors; `kinds` has bit k set for a "count" score.
  T* bank;
  const int* bin_off;
  const T* fac;
  int stride, nscores, kinds, bank_size;
  // kDet only: the record streams of the flux and the lanes.
  DetArgs<T> det;
  // kSeg only: each particle's flux offset and the flux bank's length.
  const int* seg;
  int flux_size;
};

// One crossing of the tet `e` with its rows read from global memory.
template <typename T, int kLayout>
__device__ __forceinline__ T crossing(const WalkArgs<T>& a, int e, T s,
                                      T dx, T dy, T dz, T px, T py, T pz,
                                      int* next, bool* reached) {
  if constexpr (kLayout == WALK_TWO_TIER) {
    return twotier_step(a.table_lo + (size_t)e * WALK_TABLE_LO_WIDTH,
                        a.table_hi, e, s, dx, dy, dz, px, py, pz, a.tol, next,
                        reached);
  } else if constexpr (kLayout == WALK_UNPACKED) {
    // The 16 plane values in the packed row's order, then walk_step's
    // arithmetic; the neighbour from the int4 of ids.
    T r[WALK_TABLE_ADJ];
    const T* n = a.nrm + (size_t)e * 4 * a.nstride;
    const T* o = a.off + (size_t)e * 4 * a.ostride;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      r[3 * f] = n[f * a.nstride];
      r[3 * f + 1] = n[f * a.nstride + 1];
      r[3 * f + 2] = n[f * a.nstride + 2];
      r[WALK_TABLE_OFFSETS + f] = o[f * a.ostride];
    }
    const int4 ids = *reinterpret_cast<const int4*>(a.adj + (size_t)e * 4);
    int f;
    const T s_exit = walk_exit(r, s, dx, dy, dz, px, py, pz, a.tol, &f);
    *reached = s_exit >= T(1);
    *next = f == 0 ? ids.x : f == 1 ? ids.y : f == 2 ? ids.z : ids.w;
    return *reached ? T(1) : s_exit;
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

template <typename T, int kLayout, bool kScore, bool kDet, bool kSeg>
__global__ void __launch_bounds__(WALK_THREADS)
    walk_kernel(const WalkArgs<T> a) {
  __shared__ int block_iters, block_walked, block_skip;
  __shared__ WalkStage<T> stage[WALK_THREADS / 32];
  WalkStage<T>& st = stage[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) {
    block_iters = 0;
    block_walked = 0;
    block_skip = a.skip != nullptr && *a.skip != 0;
  }
  __syncthreads();
  if (block_skip) {
    // Nothing to walk: every output is its input, grid-stride.
    const int stride = gridDim.x * WALK_THREADS;
    const int first = blockIdx.x * WALK_THREADS + threadIdx.x;
    for (int k = first; k < 3 * a.n; k += stride) a.x_out[k] = a.x[k];
    for (int j = first; j < a.n; j += stride) {
      a.elem_out[j] = a.elem_in[j];
      a.done_out[j] = true;
      a.exited_out[j] = false;
      a.s_out[j] = a.s_init ? a.s_init[j] : T(0);
    }
    return;
  }

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
  int sbin = 0;  // scoring: the particle's lane offset and factors
  T sfac[3] = {0, 0, 0};
  int soff = 0;  // kSeg: the particle's flux offset
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
        if constexpr (kScore) {
          sbin = a.bin_off[i];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            sfac[k] = k < a.nscores ? a.fac[(size_t)i * a.nscores + k] : T(0);
        }
        if constexpr (kSeg) soff = a.seg[i];
      }
      pool = min(pool + __popc(idle), pool_end);
    }
    if (!__any_sync(0xffffffffu, i >= 0)) break;

    bool done = false, fin = false;
    if (i >= 0) {
      if (steps < a.max_iters) {
        int next;
        bool reached;
        const T s_new = crossing<T, kLayout>(a, e, s, dx, dy, dz, px, py,
                                             pz, &next, &reached);
        const bool hit_boundary = !reached && next == -1;
        if (a.tally) {
          const T c = (s_new - s) * eff_w;
          if constexpr (kDet) {
            // Records keyed (element or lane, step, particle).
            const long long ord = det_ord(steps, i);
            if constexpr (kSeg) {
              if (c != T(0) && (long long)soff + e < a.flux_size)
                det_emit(a.det.flux, soff + e, ord, c);
            } else {
              if (c != T(0)) det_emit(a.det.flux, e, ord, c);
            }
            if constexpr (kScore)
              if ((long long)e * a.stride + sbin < a.bank_size)
                det_score_lanes(a.det.lanes, (long long)e * a.stride + sbin,
                                a.nscores, a.kinds, c, !reached, sfac, ord);
          } else {
            if constexpr (kSeg) {
              if (c != T(0) && (long long)soff + e < a.flux_size)
                atomicAdd(a.flux + soff + e, c);
            } else {
              if (c != T(0)) atomicAdd(a.flux + e, c);
            }
            // Outside the c != 0 guard: a zero-length step is a crossing.
            // The DROP rule, one test a crossing: lanes at or past the
            // bank.
            if constexpr (kScore)
              if ((long long)e * a.stride + sbin < a.bank_size)
                score_lanes(a.bank + (size_t)e * a.stride, a.stride, sbin,
                            a.nscores, a.kinds, c, !reached, sfac);
          }
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

template <typename T, int kLayout, bool kScore, bool kDet, bool kSeg>
static int launch_walk(const WalkArgs<T>& a, void* stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  int resident = 0;
  const cudaError_t err = resident_blocks(
      reinterpret_cast<const void*>(
          walk_kernel<T, kLayout, kScore, kDet, kSeg>),
      WALK_THREADS, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (a.n + WALK_THREADS - 1) / WALK_THREADS;
  walk_kernel<T, kLayout, kScore, kDet, kSeg>
      <<<needed < resident ? needed : resident, WALK_THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The atomic commit, or with `det` (the host's record description,
// det_records.cuh det_args) the kDet instantiation; with `seg` the kSeg
// one.
template <typename T, int kLayout, bool kScore, bool kSeg>
static int dispatch_commit(WalkArgs<T> a, const void* det, void* stream) {
  if (det == nullptr)
    return launch_walk<T, kLayout, kScore, false, kSeg>(a, stream);
  a.det = det_args<T>(static_cast<const long long*>(det));
  return launch_walk<T, kLayout, kScore, true, kSeg>(a, stream);
}

template <typename T, int kLayout, bool kScore = false>
static int dispatch_walk(WalkArgs<T> a, const void* det, void* stream) {
  if (a.seg == nullptr)
    return dispatch_commit<T, kLayout, kScore, false>(a, det, stream);
  return dispatch_commit<T, kLayout, kScore, true>(a, det, stream);
}

template <typename T>
static WalkArgs<T> walk_args(const void* table, const void* table_lo,
                             const void* table_hi, const void* x,
                             const void* elem, const void* dest,
                             const void* fly, const void* w,
                             const void* s_init, void* flux, void* x_out,
                             void* elem_out, void* done_out, void* exited_out,
                             void* s_out, void* iters, void* next,
                             void* counts, const void* skip, int n,
                             double tol, int max_iters, int tally,
                             const void* seg, int flux_size) {
  WalkArgs<T> a;
  a.table = static_cast<const T*>(table);
  a.table_lo = static_cast<const uint16_t*>(table_lo);
  a.table_hi = static_cast<const T*>(table_hi);
  a.nrm = nullptr;
  a.off = nullptr;
  a.adj = nullptr;
  a.nstride = a.ostride = 0;
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
  a.skip = static_cast<const int*>(skip);
  a.n = n;
  a.max_iters = max_iters;
  a.tally = tally;
  a.tol = static_cast<T>(tol);
  a.bank = nullptr;
  a.bin_off = nullptr;
  a.fac = nullptr;
  a.stride = a.nscores = a.kinds = a.bank_size = 0;
  a.det = DetArgs<T>{};
  a.seg = static_cast<const int*>(seg);
  a.flux_size = flux_size;
  return a;
}

// The scoring arguments of a walk_scored entry, set on `a`.
template <typename T>
static WalkArgs<T> with_scoring(WalkArgs<T> a, void* bank,
                                const void* bin_off, const void* fac,
                                int stride, int nscores, int kinds,
                                int bank_size) {
  a.bank = static_cast<T*>(bank);
  a.bin_off = static_cast<const int*>(bin_off);
  a.fac = static_cast<const T*>(fac);
  a.stride = stride;
  a.nscores = nscores;
  a.kinds = kinds;
  a.bank_size = bank_size;
  return a;
}

// The unpacked arguments of a walk_unpacked entry, set on `a`.
template <typename T>
static WalkArgs<T> with_planes(WalkArgs<T> a, const void* nrm,
                               const void* off, const void* adj, int nstride,
                               int ostride) {
  a.nrm = static_cast<const T*>(nrm);
  a.off = static_cast<const T*>(off);
  a.adj = static_cast<const int*>(adj);
  a.nstride = nstride;
  a.ostride = ostride;
  return a;
}

// The particle arguments every entry takes after its tables.
#define WALK_PARTICLE_PARAMS                                                \
  const void *x, const void *elem, const void *dest, const void *fly,      \
      const void *w, const void *s_init, void *flux, void *x_out,           \
      void *elem_out, void *done_out, void *exited_out, void *s_out,        \
      void *iters, void *next, void *counts, const void *skip, int n,       \
      double tol, int max_iters, int tally, const void *seg, int flux_size, \
      const void *det, void *stream
#define WALK_PARTICLE_ARGS                                                  \
  x, elem, dest, fly, w, s_init, flux, x_out, elem_out, done_out,           \
      exited_out, s_out, iters, next, counts, skip, n, tol, max_iters, tally, \
      seg, flux_size

extern "C" int pumi_walk_f32(const void* table, WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_PACKED>(
      walk_args<float>(table, nullptr, nullptr, WALK_PARTICLE_ARGS), det,
      stream);
}

extern "C" int pumi_walk_f64(const void* table, WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_PACKED>(
      walk_args<double>(table, nullptr, nullptr, WALK_PARTICLE_ARGS), det,
      stream);
}

extern "C" int pumi_walk_twotier_f32(const void* table_lo,
                                     const void* table_hi,
                                     WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_TWO_TIER>(
      walk_args<float>(nullptr, table_lo, table_hi, WALK_PARTICLE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_twotier_f64(const void* table_lo,
                                     const void* table_hi,
                                     WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_TWO_TIER>(
      walk_args<double>(nullptr, table_lo, table_hi, WALK_PARTICLE_ARGS),
      det, stream);
}

// The scoring entries: the same walk with the scoring lanes (kScore).
#define WALK_SCORE_PARAMS                                                 \
  void *bank, const void *bin_off, const void *fac, int stride,           \
      int nscores, int kinds, int bank_size
#define WALK_SCORE_ARGS \
  bank, bin_off, fac, stride, nscores, kinds, bank_size

extern "C" int pumi_walk_scored_f32(WALK_SCORE_PARAMS, const void* table,
                                    WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_PACKED, true>(
      with_scoring(walk_args<float>(table, nullptr, nullptr,
                                    WALK_PARTICLE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_scored_f64(WALK_SCORE_PARAMS, const void* table,
                                    WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_PACKED, true>(
      with_scoring(walk_args<double>(table, nullptr, nullptr,
                                     WALK_PARTICLE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_twotier_scored_f32(WALK_SCORE_PARAMS,
                                            const void* table_lo,
                                            const void* table_hi,
                                            WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_TWO_TIER, true>(
      with_scoring(walk_args<float>(nullptr, table_lo, table_hi,
                                    WALK_PARTICLE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_twotier_scored_f64(WALK_SCORE_PARAMS,
                                            const void* table_lo,
                                            const void* table_hi,
                                            WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_TWO_TIER, true>(
      with_scoring(walk_args<double>(nullptr, table_lo, table_hi,
                                     WALK_PARTICLE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}

// The unpacked entries: planes through their strides, int32 neighbour ids.
#define WALK_PLANE_PARAMS                                                 \
  const void *nrm, const void *off, const void *adj, int nstride, int ostride
#define WALK_PLANE_ARGS nrm, off, adj, nstride, ostride

extern "C" int pumi_walk_unpacked_f32(WALK_PLANE_PARAMS,
                                      WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_UNPACKED>(
      with_planes(walk_args<float>(nullptr, nullptr, nullptr,
                                   WALK_PARTICLE_ARGS),
                  WALK_PLANE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_unpacked_f64(WALK_PLANE_PARAMS,
                                      WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_UNPACKED>(
      with_planes(walk_args<double>(nullptr, nullptr, nullptr,
                                    WALK_PARTICLE_ARGS),
                  WALK_PLANE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_unpacked_scored_f32(WALK_SCORE_PARAMS,
                                             WALK_PLANE_PARAMS,
                                             WALK_PARTICLE_PARAMS) {
  return dispatch_walk<float, WALK_UNPACKED, true>(
      with_scoring(with_planes(walk_args<float>(nullptr, nullptr, nullptr,
                                                WALK_PARTICLE_ARGS),
                               WALK_PLANE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}

extern "C" int pumi_walk_unpacked_scored_f64(WALK_SCORE_PARAMS,
                                             WALK_PLANE_PARAMS,
                                             WALK_PARTICLE_PARAMS) {
  return dispatch_walk<double, WALK_UNPACKED, true>(
      with_scoring(with_planes(walk_args<double>(nullptr, nullptr, nullptr,
                                                 WALK_PARTICLE_ARGS),
                               WALK_PLANE_ARGS),
                   WALK_SCORE_ARGS),
      det, stream);
}
