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
// latency and scattered L2 sectors bound it, not the bytes (each listed
// slot read and written once, each crossed row read once).
//
// Design: one thread per entry of a work list (PERF.md, the W4 rows).
// - The caller hands the kernel a device-side int32 list of slot ids
//   (`work`, its length `*n_work` on the device, so no host sync sizes
//   the launch; the grid covers the list's capacity, the slot count, and
//   CUDA blocks past its length return after reading it). A slot off the
//   list is neither read nor written, so a later round costs its front,
//   not the capacity of the blocks it walks. The engine takes a later
//   round's list from the frontier migrate's arrivals, or from `done`
//   after a full migrate (gather_work_list below).
// - Without a list (a phase's first round), a thread per slot, and a
//   done slot is skipped: read (its flag) but not written.
// - The outputs are written in place, into the slot state the thread
//   read (x, lelem, done, exited; `pending` of walked slots, the caller
//   fills the rest with -1). A listed slot that is done walks no step
//   and is written back as walk_local writes it (x = dest unless it
//   exited).
// - `iters` is max-reduced per warp and max-ed into global memory;
//   `counts` (optional) gets the slots walked.
// Measured arms that lost (PERF.md): a persistent grid whose lanes pull
// list entries (as W0's do) was slower than this on every cell; a
// first-round list in slot order costs its build and gains nothing; one
// in element order gained on the box's dense one block and lost on the
// lattice's sparse one and on a sub-split's first round.
// Flux goes through atomicAdd, so its summation order, and only that,
// depends on the schedule; the kDet instantiations (entries given a `det`
// record description, ops/det_commit.py) write one record a contribution
// instead (det_records.cuh: the block-padded row or lane, the crossing's
// step in this call and the thread's place in the list, or its slot
// without one), which det_commit.cu adds in the plain version's order.
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

#include "det_records.cuh"
#include "twotier_step.cuh"
#include "walk_step.cuh"

#define GATHER_THREADS 256
// The list build: a CUDA block of LIST_THREADS covers a chunk of
// LIST_CHUNK slots, a warp LIST_STEPS steps of 128 consecutive slots, 4
// a lane (parallel/partition.py WORK_CHUNK sizes the chunk counts'
// buffer).
#define LIST_THREADS 256
#define LIST_STEPS 4
#define LIST_CHUNK (LIST_THREADS * LIST_STEPS * 4)

template <typename T>
struct GatherArgs {
  const T* table;       // packed rows (null when two-tier)
  const int* adj_int;   // [blocks*L, 4] sidecar, or null
  const uint16_t* table_lo;  // two-tier select rows
  const T* table_hi;    // two-tier refinement rows
  T* x;                 // slot state, read and written in place
  int* lelem;
  const T* dest;
  const signed char* fly;
  const T* w;
  bool* done;
  bool* exited;
  T* flux;
  int* pending;         // written for listed slots
  int* iters;
  int* counts;          // [1]: slots walked, or null
  const int* work;      // the list of slot ids, or null: every slot
  const int* n_work;    // its length, on the device
  int L, cb, max_iters, tally;
  T tol;
  T* bank;
  const int* bin_off;
  const T* fac;
  int stride, nscores, kinds;
  // kDet only: the record streams of the flux and the lanes.
  DetArgs<T> det;
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

template <typename T, bool kTwoTier, bool kScore, bool kDet>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_block_walk_kernel(const GatherArgs<T> a, int cap) {
  const int n = a.work != nullptr ? *a.n_work : cap;
  // A CUDA block past the list's end has no entry.
  if (static_cast<long long>(blockIdx.x) * GATHER_THREADS >= n) return;
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;
  int i = t < n ? (a.work != nullptr ? a.work[t] : t) : -1;
  // Without a list, a done slot is skipped: neither walked nor written.
  if (i >= 0 && a.work == nullptr && a.done[i]) i = -1;
  int steps = 0;
  if (i >= 0) {
    const size_t row0 = (size_t)(i / a.cb) * a.L;  // the block's first row
    const size_t j = 3 * (size_t)i;
    const T qx = a.x[j], qy = a.x[j + 1], qz = a.x[j + 2];
    const T px = a.dest[j], py = a.dest[j + 1], pz = a.dest[j + 2];
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
        sfac[k] = k < a.nscores ? a.fac[(size_t)i * a.nscores + k] : T(0);
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
        if constexpr (kDet) {
          // Records keyed (row or lane, step, the thread's place).
          const long long ord = det_ord(steps, t);
          if (c != T(0))
            det_emit(a.det.flux, static_cast<int>(row0 + e), ord, c);
          if constexpr (kScore)
            if ((long long)e * a.stride + sbin < (long long)a.L * a.stride)
              det_score_lanes(a.det.lanes,
                              (long long)(row0 + e) * a.stride + sbin,
                              a.nscores, a.kinds, c, !reached, sfac, ord);
        } else {
          if (c != T(0)) atomicAdd(a.flux + row0 + e, c);
          // Outside the c != 0 guard: a zero-length step is a crossing.
          if constexpr (kScore)
            if ((long long)e * a.stride + sbin < (long long)a.L * a.stride)
              score_lanes(a.bank + (row0 + e) * a.stride, a.stride, sbin,
                          a.nscores, a.kinds, c, !reached, sfac);
        }
      }
      if (!reached && !hit_boundary && !goes_remote) e = next;
      s = s_new;
      if (goes_remote) pending = -next - 2;
      done = reached || hit_boundary;
      exited = exited || hit_boundary;
      ++steps;
      if (goes_remote) break;
    }
    // Written back in place, once.
    const bool at_dest = done && !exited;
    a.x[j] = at_dest ? px : qx + s * dx;
    a.x[j + 1] = at_dest ? py : qy + s * dy;
    a.x[j + 2] = at_dest ? pz : qz + s * dz;
    a.lelem[i] = e;
    a.done[i] = done;
    a.exited[i] = exited;
    a.pending[i] = pending;
  }
  const int warp_max = __reduce_max_sync(0xffffffffu, steps);
  if ((threadIdx.x & 31) == 0 && warp_max > 0) atomicMax(a.iters, warp_max);
  if (a.counts != nullptr) {
    const int walked = __popc(__ballot_sync(0xffffffffu, i >= 0));
    if ((threadIdx.x & 31) == 0 && walked > 0) atomicAdd(a.counts, walked);
  }
}

// The work list of a later round (entry gather_work_list; its plain
// version is partition.py work_list_plain): the slots that are not done,
// of the blocks `walked` marks (null: every block), in slot order, and
// their count. Over chunks of LIST_CHUNK slots: count each chunk's slots,
// scan the counts into each chunk's first place (one CUDA block), then
// write each chunk's slots from there. A lane reads its 4 slots' flags as one 32-bit word (`done`
// is 4-byte aligned), all of its steps' words before it uses any, so a
// warp keeps LIST_STEPS coalesced loads in flight.
struct ListArgs {
  const bool* done;
  const bool* walked;  // [blocks], or null
  int* chunk_counts;   // [chunks] scratch
  int* work;           // [n]
  int* n_work;         // [1]
  int n, cb;
};

// Bit j of step s: slot first + 128 s + j is on the list, for this
// lane's `first` (its 4 slots of the warp's first step).
__device__ __forceinline__ void list_bits(const ListArgs& a, int first,
                                          unsigned (&bits)[LIST_STEPS]) {
  unsigned word[LIST_STEPS];
#pragma unroll
  for (int s = 0; s < LIST_STEPS; ++s) {
    const int i = first + 128 * s;
    if (i + 3 < a.n) {
      word[s] = *reinterpret_cast<const unsigned*>(a.done + i);
    } else {
      word[s] = 0x01010101u;  // past the end: done
      for (int j = 0; j < 4 && i + j < a.n; ++j)
        word[s] = (word[s] & ~(0xffu << (8 * j))) |
                  (static_cast<unsigned>(a.done[i + j]) << (8 * j));
    }
  }
#pragma unroll
  for (int s = 0; s < LIST_STEPS; ++s) {
    const int i = first + 128 * s;
    unsigned b = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (((word[s] >> (8 * j)) & 0xffu) == 0 &&
          (a.walked == nullptr || a.walked[(i + j) / a.cb]))
        b |= 1u << j;
    bits[s] = b;
  }
}

// This lane's first slot: the warp's share of the chunk, 4 a lane.
__device__ __forceinline__ int list_first() {
  return blockIdx.x * LIST_CHUNK + (threadIdx.x >> 5) * (LIST_STEPS * 128) +
         4 * (threadIdx.x & 31);
}

// The sum of `v` over the CUDA block, in thread 0.
__device__ __forceinline__ int list_block_sum(int v, int* warp_part) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < LIST_THREADS / 32; ++w) total += warp_part[w];
  return total;
}

__global__ void __launch_bounds__(LIST_THREADS)
    work_count_kernel(const ListArgs a) {
  __shared__ int warp_part[LIST_THREADS / 32];
  unsigned bits[LIST_STEPS];
  list_bits(a, list_first(), bits);
  int mine = 0;
#pragma unroll
  for (int s = 0; s < LIST_STEPS; ++s) mine += __popc(bits[s]);
  const int total = list_block_sum(mine, warp_part);
  if (threadIdx.x == 0) a.chunk_counts[blockIdx.x] = total;
}

// The chunk counts become the chunks' first places, by one CUDA block, a
// tile of LIST_THREADS chunks at a time; their sum is the list's length.
__global__ void __launch_bounds__(LIST_THREADS)
    work_scan_kernel(const ListArgs a, int chunks) {
  __shared__ int warp_part[LIST_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += LIST_THREADS) {
    const int c = c0 + threadIdx.x;
    const int v = c < chunks ? a.chunk_counts[c] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_part[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < LIST_THREADS / 32; ++w) {
      before += w < warp ? warp_part[w] : 0;
      carry += warp_part[w];
    }
    if (c < chunks) a.chunk_counts[c] = before + incl - v;
    __syncthreads();  // warp_part is read before the next tile
  }
  if (threadIdx.x == 0) *a.n_work = carry;
}

__global__ void __launch_bounds__(LIST_THREADS)
    work_write_kernel(const ListArgs a) {
  __shared__ int warp_part[LIST_THREADS / 32];
  __shared__ int warp_base[LIST_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = list_first();
  unsigned bits[LIST_STEPS];
  list_bits(a, first, bits);
  int before = a.chunk_counts[blockIdx.x];  // the chunk's first place
  int mine = 0;
#pragma unroll
  for (int s = 0; s < LIST_STEPS; ++s) mine += __popc(bits[s]);
  const int warp_total = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) warp_part[warp] = warp_total;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < LIST_THREADS / 32; ++w) {
      warp_base[w] = before;
      before += warp_part[w];
    }
  }
  __syncthreads();
  int pos = warp_base[warp];
#pragma unroll
  for (int s = 0; s < LIST_STEPS; ++s) {
    // The lane's place in the step: an exclusive scan of the counts.
    const int c = __popc(bits[s]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int at = pos + incl - c;
    for (unsigned b = bits[s]; b; b &= b - 1)
      a.work[at++] = first + 128 * s + __ffs(b) - 1;
    pos += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// `done` [n] (4-byte aligned), `walked` [n / cb] or null; `chunk_counts`
// holds ceil(n / LIST_CHUNK) ints of scratch; `work` [n] and `n_work` [1] are
// written.
extern "C" int pumi_gather_work_list_f32(const void* done,
                                         const void* walked,
                                         void* chunk_counts, void* work,
                                         void* n_work, int n, int cb,
                                         void* stream) {
  if (n <= 0 || cb <= 0) return static_cast<int>(cudaGetLastError());
  const ListArgs a = {static_cast<const bool*>(done),
                      static_cast<const bool*>(walked),
                      static_cast<int*>(chunk_counts),
                      static_cast<int*>(work),
                      static_cast<int*>(n_work),
                      n,
                      cb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (n + LIST_CHUNK - 1) / LIST_CHUNK;
  work_count_kernel<<<chunks, LIST_THREADS, 0, st>>>(a);
  work_scan_kernel<<<1, LIST_THREADS, 0, st>>>(a, chunks);
  work_write_kernel<<<chunks, LIST_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `cap`: the list's capacity (its tensor's length), or without a list the
// slot count; it sizes the grid, and the kernel reads the length itself.
template <typename T, bool kTwoTier, bool kScore, bool kDet>
static int launch_gather(const GatherArgs<T>& a, int cap, void* stream) {
  if (cap <= 0 || a.cb <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = (cap + GATHER_THREADS - 1) / GATHER_THREADS;
  gather_block_walk_kernel<T, kTwoTier, kScore, kDet>
      <<<grid, GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a,
                                                                    cap);
  return static_cast<int>(cudaGetLastError());
}

// The atomic commit, or with `det` (the host's record description,
// det_records.cuh det_args) the kDet instantiation.
template <typename T, bool kTwoTier, bool kScore>
static int dispatch_gather(GatherArgs<T> a, const void* det, int cap,
                           void* stream) {
  if (det == nullptr)
    return launch_gather<T, kTwoTier, kScore, false>(a, cap, stream);
  a.det = det_args<T>(static_cast<const long long*>(det));
  return launch_gather<T, kTwoTier, kScore, true>(a, cap, stream);
}

template <typename T>
static GatherArgs<T> gather_args(
    const void* table, const void* adj_int, const void* table_lo,
    const void* table_hi, void* x, void* lelem, const void* dest,
    const void* fly, const void* w, void* done, void* exited, void* flux,
    void* pending, void* iters, void* counts, const void* work,
    const void* n_work, int L, int cb, double tol, int max_iters,
    int tally) {
  GatherArgs<T> a;
  a.table = static_cast<const T*>(table);
  a.adj_int = static_cast<const int*>(adj_int);
  a.table_lo = static_cast<const uint16_t*>(table_lo);
  a.table_hi = static_cast<const T*>(table_hi);
  a.x = static_cast<T*>(x);
  a.lelem = static_cast<int*>(lelem);
  a.dest = static_cast<const T*>(dest);
  a.fly = static_cast<const signed char*>(fly);
  a.w = static_cast<const T*>(w);
  a.done = static_cast<bool*>(done);
  a.exited = static_cast<bool*>(exited);
  a.flux = static_cast<T*>(flux);
  a.pending = static_cast<int*>(pending);
  a.iters = static_cast<int*>(iters);
  a.counts = static_cast<int*>(counts);
  a.work = static_cast<const int*>(work);
  a.n_work = static_cast<const int*>(n_work);
  a.L = L;
  a.cb = cb;
  a.max_iters = max_iters;
  a.tally = tally;
  a.tol = static_cast<T>(tol);
  a.bank = nullptr;
  a.bin_off = nullptr;
  a.fac = nullptr;
  a.stride = a.nscores = a.kinds = 0;
  a.det = DetArgs<T>{};
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
  void *x, void *lelem, const void *dest, const void *fly, const void *w, \
      void *done, void *exited, void *flux, void *pending, void *iters,   \
      void *counts, const void *work, const void *n_work, int cap, int L, \
      int cb, double tol, int max_iters, int tally, const void *det,      \
      void *stream
#define GATHER_SLOT_ARGS                                                  \
  x, lelem, dest, fly, w, done, exited, flux, pending, iters, counts,     \
      work, n_work, L, cb, tol, max_iters, tally
#define GATHER_SCORE_PARAMS                                               \
  void *bank, const void *bin_off, const void *fac, int stride,           \
      int nscores, int kinds
#define GATHER_SCORE_ARGS bank, bin_off, fac, stride, nscores, kinds

#define GATHER_ENTRIES(SUFFIX, T)                                          \
  extern "C" int pumi_gather_block_walk_##SUFFIX(                          \
      const void* table, const void* adj_int, GATHER_SLOT_PARAMS) {        \
    return dispatch_gather<T, false, false>(                               \
        gather_args<T>(table, adj_int, nullptr, nullptr, GATHER_SLOT_ARGS), \
        det, cap, stream);                                                 \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_twotier_##SUFFIX(                  \
      const void* table_lo, const void* table_hi, GATHER_SLOT_PARAMS) {    \
    return dispatch_gather<T, true, false>(                                \
        gather_args<T>(nullptr, nullptr, table_lo, table_hi,               \
                       GATHER_SLOT_ARGS),                                  \
        det, cap, stream);                                                 \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_scored_##SUFFIX(                   \
      GATHER_SCORE_PARAMS, const void* table, const void* adj_int,         \
      GATHER_SLOT_PARAMS) {                                                \
    return dispatch_gather<T, false, true>(                                \
        with_scoring(gather_args<T>(table, adj_int, nullptr, nullptr,      \
                                    GATHER_SLOT_ARGS),                     \
                     GATHER_SCORE_ARGS),                                   \
        det, cap, stream);                                                 \
  }                                                                        \
  extern "C" int pumi_gather_block_walk_twotier_scored_##SUFFIX(           \
      GATHER_SCORE_PARAMS, const void* table_lo, const void* table_hi,     \
      GATHER_SLOT_PARAMS) {                                                \
    return dispatch_gather<T, true, true>(                                 \
        with_scoring(gather_args<T>(nullptr, nullptr, table_lo, table_hi,  \
                                    GATHER_SLOT_ARGS),                     \
                     GATHER_SCORE_ARGS),                                   \
        det, cap, stream);                                                 \
  }

GATHER_ENTRIES(f32, float)
GATHER_ENTRIES(f64, double)
