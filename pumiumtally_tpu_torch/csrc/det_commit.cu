// DC: the deterministic commit of the tallying walks' records.
//
// Replaces: the float atomics with which W0 (walk.cu, the port of
// pumiumtally_tpu/ops/walk.py `walk`, its flux through
// `fused_tally_body` :196 and its lanes through `score_pair` :177) and
// W4 (gather_block_walk.cu, parallel/partition.py `walk_local` :466) add
// flux and scoring lanes. The JAX walks commit through a deterministic
// scatter-add; the atomics make the order of the sum, and so the low
// bits of flux, vary from run to run, which breaks the resilience
// layer's bitwise resume. With the deterministic commit the walks'
// kDet instantiations write one record a contribution
// (det_records.cuh) and this library adds them.
//
// What it computes: for every bank entry k, its records in ascending
// `ord` (the crossing's step in the walk call, then the particle) added
// one by one onto target[k]'s standing value, serially: exactly the
// order of the plain versions' serial index_add_ (ops/walk.py
// walk_plain, parallel/partition.py _walk_loop), so that with
// --fmad=false the result equals theirs bitwise (ops/det_commit.py
// det_commit_plain states it in plain PyTorch). A zero contribution
// makes no record: a sum that starts at +0.0 never reaches -0.0 under
// round-to-nearest, and adding +0.0 changes nothing else.
//
// How, over m records and K bank entries, with the host's plan
// (ops/det_commit.py dc_plan: the keys cut into T tiles of TK
// consecutive keys, sized so that a tile's expected records fill about
// half a CTA's shared-memory stage of S records, two CTAs an SM; the
// tiles grouped into W windows of TW consecutive tiles, ~16 MB of
// records each, or one window where all the records fit L2). A memset
// and up to seven kernels, no host sync:
// 1. dc_hist: each CTA counts a contiguous chunk of the keys by tile
//    with shared-memory atomics, adds its counts into the tiles' totals
//    (one global atomic a tile it holds) and writes its count of each
//    window (a row of W);
// 2. dc_starts (one CTA): the tiles' first places (an exclusive scan of
//    the totals: a tile's records will lie contiguous), the tiles'
//    cursors, and the fine split's pieces a window; dc_bases (a CTA a
//    window): each chunk's first place in each window's run;
// 3. dc_split, coarse (W > 1): each CTA re-reads its chunk, 4,096
//    records at a time, groups them by window in shared memory (a
//    counting sort) and writes each window's run from its own places (no
//    shared counter): the W digits are few, so a run is hundreds of
//    records and the 16-byte (float64: 24-byte) record stores coalesce;
// 4. dc_split, fine: each CTA takes 4,096 records of one window's run
//    (of the stream itself with one window), groups them by tile the
//    same way and writes each tile's run at a place taken with one
//    atomic a tile; a window's few hundred tiles keep runs a dozen
//    records long, and a window's pieces, run together, write within
//    L2. (One split of many megabytes into T tiles would leave runs of
//    about one record, scattered over the whole buffer: on the card
//    that measured slower than both splits together.)
// 5. dc_tiles: one CTA a tile loads its run into shared memory (two
//    passes over it, the second from L2), counting-sorts it by key
//    group (a group is one key unless a tile spans more than
//    DC_HIST_MAX keys), orders each group by (key, ord) -- up to
//    DC_THREAD_MAX records by a thread in registers (a one-key group
//    then added at once), up to 256 by a warp in registers with
//    shuffles, up to DC_WARP_MAX by a warp in shared memory, larger by
//    the CTA's bitonic network -- and adds each group's values serially
//    onto the target, one thread a group, many groups at once, the
//    standing values read before the sort;
// 6. dc_overfull: a tile whose records exceed the stage (a skewed
//    source, a hot element) is put on a device-side list by dc_tiles
//    and committed here, one CTA a listed tile: where each of its key
//    groups fits the stage, in passes of as many groups as fit, each
//    loaded from the run (in L2) and committed as in 5; where one does
//    not (a hot key), its run sorted in place by (key, ord) in global
//    memory (a bitonic network whose steps below the stage's power of
//    two run on chunks staged in shared memory), then summed chunk by
//    staged chunk. The device chooses the path from the tile's counts;
//    the host never sees it.
//
// What bounds it on an H100: bytes. The records are read by the
// histogram (the keys), read and written by each split, and read by the
// tile commit (its second pass hits L2): about 84 bytes a float32
// record (``dc_floor_ms`` in chip_smoke.py), against 16 bytes read
// once (each record) plus the target read and written for the bound.
// The sorts run in registers and shared memory; a tile commit's phases
// are separated by barriers, so its latencies hide across its two CTAs
// an SM.

#include <climits>

#include <cuda_runtime.h>

#define DC_THREADS 512
#define DC_WARPS (DC_THREADS / 32)
#define DC_SUB 4096  // records a split stages at a time
#define DC_SUB_ITEMS (DC_SUB / DC_THREADS)
#define DC_AHEAD 4  // records a histogram or tile-load thread loads ahead
#define DC_HIST_MAX 2048  // key groups of a tile, or digits of a split
#define DC_THREAD_LOG 3  // a group of up to 2^DC_THREAD_LOG records is a
#define DC_THREAD_MAX (1 << DC_THREAD_LOG)  // thread's, sorted in registers
#define DC_WARP_MAX 512   // a group a warp sorts
#define DC_BIG_MAX 64     // groups a CTA sorts together, at most
#define DC_SUM_AHEAD 8    // records a serial sum loads ahead
#define DC_GLOBAL_AHEAD 4  // comparators a global sorting step loads ahead
#define DC_PLAN_LEN 9

// A partitioned record: 16 bytes in float32 (one vector access), 24 in
// float64.
template <typename T>
struct alignas(sizeof(T) == 4 ? 16 : 8) DcRec {
  long long ord;
  T val;
  int key;
};

// Records are ordered by (key, ord); a key's ords are distinct.
template <typename T>
__device__ __forceinline__ bool dc_less(const DcRec<T>& a,
                                        const DcRec<T>& b) {
  return a.key < b.key || (a.key == b.key && a.ord < b.ord);
}

// The stage in shared memory: ords, values and keys of up to S records.
// Without kKeys the sorts neither compare nor move the keys: a group of
// one key (the plan's group shift 0), whose records all carry it.
template <typename T, bool kKeys = true>
struct DcStage {
  long long* ord;
  T* val;
  int* key;
  __device__ DcRec<T> get(unsigned i) const {
    return DcRec<T>{ord[i], val[i], kKeys ? key[i] : 0};
  }
  __device__ void put(unsigned i, const DcRec<T>& r) const {
    ord[i] = r.ord;
    val[i] = r.val;
    if (kKeys) key[i] = r.key;
  }
  __device__ int key_at(unsigned i) const { return key[i]; }
  __device__ T val_at(unsigned i) const { return val[i]; }
  __device__ DcStage at(int s) const {
    return DcStage{ord + s, val + s, key + s};
  }
};

// A run of partitioned records in global memory.
template <typename T>
struct DcRun {
  DcRec<T>* rec;
  __device__ DcRec<T> get(unsigned i) const { return rec[i]; }
  __device__ void put(unsigned i, const DcRec<T>& r) const { rec[i] = r; }
  __device__ int key_at(unsigned i) const { return rec[i].key; }
  __device__ T val_at(unsigned i) const { return rec[i].val; }
};

// The dynamic shared memory of dc_split over nd digits: their counts,
// places and cursors, then DC_SUB staged records and their digits.
template <typename T>
__host__ __device__ constexpr long long dc_split_bytes(long long nd) {
  return ((12 * nd + 4 + 15) / 16) * 16 +
         DC_SUB * (static_cast<long long>(sizeof(DcRec<T>)) + 4);
}

// The dynamic shared memory of dc_tiles and dc_overfull: the stage of S
// records (ords, values, keys) and two group arrays of DC_HIST_MAX + 1.
template <typename T>
__host__ __device__ constexpr long long dc_tiles_bytes(long long S) {
  return S * (8 + static_cast<long long>(sizeof(T)) + 4) +
         2LL * 4 * (DC_HIST_MAX + 1);
}

extern __shared__ __align__(16) unsigned char dc_smem[];

// The exclusive scan of `v` over the CUDA block (and the block's total).
__device__ __forceinline__ int dc_block_excl(int v, int* warp_part,
                                             int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < DC_WARPS; ++w) {
    before += w < warp ? warp_part[w] : 0;
    all += warp_part[w];
  }
  __syncthreads();  // warp_part may be written again
  *total = all;
  return before + incl - v;
}

// a[0, n) in shared memory becomes its exclusive scan and a[n] the
// total. The caller synchronizes before (a written) and after.
__device__ void dc_scan_shared(int* a, int n, int* warp_part) {
  const int per = (n + DC_THREADS - 1) / DC_THREADS;
  const int first = threadIdx.x * per;
  int mine = 0;
  for (int j = 0; j < per; ++j)
    if (first + j < n) mine += a[first + j];
  int total;
  int run = dc_block_excl(mine, warp_part, &total);
  for (int j = 0; j < per; ++j)
    if (first + j < n) {
      const int v = a[first + j];
      a[first + j] = run;
      run += v;
    }
  if (threadIdx.x == 0) a[n] = total;
}

// ---------------------------------------------------------------------------
// 1-4. The tile histogram, the places, and the two splits
// ---------------------------------------------------------------------------

// Each CTA counts its chunk of records by tile in shared memory, adds
// the counts into the tiles' totals (one atomic a tile it holds records
// of), and writes its count of each window (TW consecutive tiles) at
// cw[w * chunks + chunk].
__global__ void __launch_bounds__(DC_THREADS)
    dc_hist(const int* key, int m, int tk, int T_, int tw, int W,
            long long rc, int* tot, int* cw) {
  int* cnt = reinterpret_cast<int*>(dc_smem);
  for (int t = threadIdx.x; t < T_; t += DC_THREADS) cnt[t] = 0;
  __syncthreads();
  const long long lo = blockIdx.x * rc;
  const long long hi = min(static_cast<long long>(m), lo + rc);
  long long r = lo + threadIdx.x;
  for (; r + (DC_AHEAD - 1) * DC_THREADS < hi; r += DC_AHEAD * DC_THREADS) {
    int k[DC_AHEAD];
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) k[q] = key[r + q * DC_THREADS];
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) atomicAdd(cnt + k[q] / tk, 1);
  }
  for (; r < hi; r += DC_THREADS) atomicAdd(cnt + key[r] / tk, 1);
  __syncthreads();
  for (int t = threadIdx.x; t < T_; t += DC_THREADS)
    if (cnt[t]) atomicAdd(tot + t, cnt[t]);
  for (int w = threadIdx.x; w < W; w += DC_THREADS) {
    int c = 0;
    for (int t = w * tw; t < min((w + 1) * tw, T_); ++t) c += cnt[t];
    cw[static_cast<long long>(w) * gridDim.x + blockIdx.x] = c;
  }
}

// One CUDA block: the tiles' totals become their first places (start,
// T + 1 entries, the last m) and the fine split's cursors (tcur);
// poff[w] counts the fine split's pieces (DC_SUB records of one
// window's run) of the windows before w (W + 1 entries). The count of
// over-full tiles is zeroed for this commit.
__global__ void __launch_bounds__(DC_THREADS)
    dc_starts(int* start, int T_, int tw, int W, int* tcur, int* poff,
              int* ofl_count) {
  __shared__ int warp_part[DC_WARPS];
  if (threadIdx.x == 0) *ofl_count = 0;
  int carry = 0;
  for (int t0 = 0; t0 <= T_; t0 += DC_THREADS) {
    const int t = t0 + threadIdx.x;
    const int v = t < T_ ? start[t] : 0;
    int total;
    const int before = dc_block_excl(v, warp_part, &total);
    if (t <= T_) start[t] = carry + before;
    if (t < T_) tcur[t] = carry + before;
    carry += total;
  }
  __syncthreads();  // start is complete
  carry = 0;
  for (int w0 = 0; w0 <= W; w0 += DC_THREADS) {
    const int w = w0 + threadIdx.x;
    const int v = w < W ? (start[min((w + 1) * tw, T_)] - start[w * tw] +
                           DC_SUB - 1) / DC_SUB
                        : 0;
    int total;
    const int before = dc_block_excl(v, warp_part, &total);
    if (w <= W) poff[w] = carry + before;
    carry += total;
  }
}

// One CUDA block a window: its chunks' counts (cw[w * chunks + c])
// become each chunk's first place in the window's run, from the
// window's first place.
__global__ void __launch_bounds__(DC_THREADS)
    dc_bases(const int* start, int tw, int chunks, int* cw) {
  __shared__ int warp_part[DC_WARPS];
  int* row = cw + static_cast<long long>(blockIdx.x) * chunks;
  int carry = start[blockIdx.x * tw];
  for (int c0 = 0; c0 < chunks; c0 += DC_THREADS) {
    const int c = c0 + threadIdx.x;
    const int v = c < chunks ? row[c] : 0;
    int total;
    const int before = dc_block_excl(v, warp_part, &total);
    if (c < chunks) row[c] = carry + before;
    carry += total;
  }
}

// Up to DC_SUB records, one or none a thread per DC_THREADS (item j of
// thread x is record j * DC_THREADS + x, read by load(j) once its place
// is known), with digits dig[j] below nd, written at their digits' next
// places: cur[d] is digit d's cursor, in shared memory (kShared:
// advanced here) or in global memory (a place taken for the run with
// one atomic a digit present). The records are grouped by digit in a
// stage in shared memory first, so that neighbouring threads store to
// neighbouring places along each run.
template <bool kShared, typename T, class Load>
__device__ void dc_split_sub(const Load& load, const int (&dig)[DC_SUB_ITEMS],
                             int len, int nd, int* cur, DcRec<T>* out,
                             int* lst, int* res, DcRec<T>* stage, int* s_dig,
                             int* warp_part) {
  for (int d = threadIdx.x; d < nd; d += DC_THREADS) lst[d] = 0;
  __syncthreads();
  int rank[DC_SUB_ITEMS];
#pragma unroll
  for (int j = 0; j < DC_SUB_ITEMS; ++j)
    if (j * DC_THREADS + static_cast<int>(threadIdx.x) < len)
      rank[j] = atomicAdd(lst + dig[j], 1);
  __syncthreads();
  // A thread's places taken in global memory are kept in registers
  // until the scan is done, so that the atomics' round trips overlap it.
  int took[DC_HIST_MAX / DC_THREADS];
  if (!kShared) {
#pragma unroll
    for (int q = 0; q < DC_HIST_MAX / DC_THREADS; ++q) {
      const int d = q * DC_THREADS + threadIdx.x;
      const int c = d < nd ? lst[d] : 0;
      took[q] = c ? atomicAdd(cur + d, c) : 0;
    }
  }
  dc_scan_shared(lst, nd, warp_part);
  __syncthreads();
  if (kShared) {
    for (int d = threadIdx.x; d < nd; d += DC_THREADS) {
      res[d] = cur[d] - lst[d];
      cur[d] += lst[d + 1] - lst[d];
    }
  } else {
#pragma unroll
    for (int q = 0; q < DC_HIST_MAX / DC_THREADS; ++q) {
      const int d = q * DC_THREADS + threadIdx.x;
      if (d < nd) res[d] = took[q] - lst[d];
    }
  }
#pragma unroll
  for (int j = 0; j < DC_SUB_ITEMS; ++j)
    if (j * DC_THREADS + static_cast<int>(threadIdx.x) < len) {
      const int p = lst[dig[j]] + rank[j];
      stage[p] = load(j);
      s_dig[p] = dig[j];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += DC_THREADS)
    out[res[s_dig[i]] + i] = stage[i];
  __syncthreads();
}

// The coarse split's records: the stream's (SoA) from place s0.
template <typename T>
struct DcLoadStream {
  const int* key;
  const long long* ord;
  const T* val;
  long long s0;
  __device__ DcRec<T> operator()(int j) const {
    const long long g = s0 + j * DC_THREADS + threadIdx.x;
    return DcRec<T>{ord[g], val[g], key[g]};
  }
};

// The fine split's records: partitioned ones from place s0.
template <typename T>
struct DcLoadRun {
  const DcRec<T>* in;
  int s0;
  __device__ DcRec<T> operator()(int j) const {
    return in[s0 + j * DC_THREADS + threadIdx.x];
  }
};

// The two splits, DC_SUB records at a time. Coarse (kFine false): each
// CTA takes a chunk of the stream's records (SoA) and splits it by
// window (TW consecutive tiles) into `out`, from its places in
// dc_bases' rows, with cursors in shared memory. Fine: each CTA takes
// one piece of DC_SUB records of a window's run in `in` (poff[w]
// counts the pieces of the windows before w) and splits it by tile into
// `out`, taking its places from the tiles' cursors `tcur`. A split's
// digits are few (windows, or a window's tiles), so its runs are long
// and its stores coalesce. A thread holds only its records' digits and
// ranks, and reads each record again (from L1 or L2) once its place is
// known: two CTAs an SM.
template <typename T, bool kFine>
__global__ void __launch_bounds__(DC_THREADS, 2)
    dc_split(const int* key, const long long* ord, const T* val,
             const DcRec<T>* in, int m, int tk, int T_, int tw, int W,
             long long rc, int chunks, const int* start, const int* base,
             const int* poff, int* tcur, DcRec<T>* out) {
  __shared__ int warp_part[DC_WARPS];
  const int nd = kFine ? tw : W;
  int* lst = reinterpret_cast<int*>(dc_smem);  // [nd + 1]
  int* res = lst + nd + 1;                      // [nd]
  int* cur = res + nd;                          // [nd]
  DcRec<T>* stage =
      reinterpret_cast<DcRec<T>*>(dc_smem + ((12LL * nd + 4 + 15) / 16) * 16);
  int* s_dig = reinterpret_cast<int*>(stage + DC_SUB);
  int dig[DC_SUB_ITEMS];
  if (kFine) {
    // This CTA's window: the last w with poff[w] <= blockIdx.x.
    const int b = blockIdx.x;
    if (b >= poff[W]) return;
    int lo = 0, hi = W;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (poff[mid] <= b)
        lo = mid;
      else
        hi = mid;
    }
    const int t0 = lo * tw;
    const int s0 = start[t0] + (b - poff[lo]) * DC_SUB;
    const int len = min(DC_SUB, start[min(t0 + tw, T_)] - s0);
    if (in == nullptr) {
      // One window: the stream's records, not split by window first.
#pragma unroll
      for (int j = 0; j < DC_SUB_ITEMS; ++j) {
        const int i = j * DC_THREADS + threadIdx.x;
        if (i < len) dig[j] = key[s0 + i] / tk;
      }
      dc_split_sub<false, T>(DcLoadStream<T>{key, ord, val, s0}, dig, len,
                             tw, tcur, out, lst, res, stage, s_dig,
                             warp_part);
      return;
    }
#pragma unroll
    for (int j = 0; j < DC_SUB_ITEMS; ++j) {
      const int i = j * DC_THREADS + threadIdx.x;
      if (i < len) dig[j] = in[s0 + i].key / tk - t0;
    }
    dc_split_sub<false, T>(DcLoadRun<T>{in, s0}, dig, len, tw, tcur + t0,
                           out, lst, res, stage, s_dig, warp_part);
    return;
  }
  for (int d = threadIdx.x; d < nd; d += DC_THREADS)
    cur[d] = base[static_cast<long long>(d) * chunks + blockIdx.x];
  const long long lo = blockIdx.x * rc;
  const long long hi = min(static_cast<long long>(m), lo + rc);
  for (long long s0 = lo; s0 < hi; s0 += DC_SUB) {
    const int len =
        static_cast<int>(min(static_cast<long long>(DC_SUB), hi - s0));
#pragma unroll
    for (int j = 0; j < DC_SUB_ITEMS; ++j) {
      const int i = j * DC_THREADS + threadIdx.x;
      if (i < len) dig[j] = key[s0 + i] / tk / tw;
    }
    dc_split_sub<true, T>(DcLoadStream<T>{key, ord, val, s0}, dig, len, W,
                          cur, out, lst, res, stage, s_dig, warp_part);
  }
}

// ---------------------------------------------------------------------------
// 4-5. Ordering and summing a tile
// ---------------------------------------------------------------------------

template <bool kCta>
__device__ __forceinline__ void dc_sync() {
  if (kCta)
    __syncthreads();
  else
    __syncwarp();
}

// One step of the bitonic network over [0, n) of a power-of-two span P
// (places at or past n hold +infinity and are never compared): merge
// width k, distance j, the `nt` participants numbered `r`. Every
// comparator puts the smaller record at the lower place (the first step
// of a merge compares i with its mirror i ^ (k - 1)), so the network
// sorts ascending and the +infinity places never move.
template <int kAhead = 1, class A>
__device__ void dc_step(const A& a, unsigned n, unsigned P, unsigned k,
                        unsigned j, unsigned r, unsigned nt) {
  // kAhead comparators' loads are issued before their stores: within a
  // step the comparators touch distinct places.
  for (unsigned c0 = r; c0 < (P >> 1); c0 += kAhead * nt) {
    unsigned i[kAhead], l[kAhead];
    bool on[kAhead];
    decltype(a.get(0)) x[kAhead], y[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const unsigned c = c0 + q * nt;
      i[q] = ((c & ~(j - 1)) << 1) | (c & (j - 1));
      l[q] = j == (k >> 1) ? (i[q] ^ (k - 1)) : (i[q] | j);
      on[q] = c < (P >> 1) && l[q] < n;
      if (on[q]) {
        x[q] = a.get(i[q]);
        y[q] = a.get(l[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (on[q] && dc_less(y[q], x[q])) {
        a.put(i[q], y[q]);
        a.put(l[q], x[q]);
      }
  }
}

__device__ __forceinline__ unsigned dc_pow2_ceil(unsigned n) {
  return n <= 1 ? 1u : 1u << (32 - __clz(n - 1));
}

// Sorts [0, n) by (key, ord): the whole network, synchronizing the warp
// (kCta false) or the CTA after each step.
template <bool kCta, class A>
__device__ void dc_bitonic(const A& a, unsigned n, unsigned r, unsigned nt) {
  const unsigned P = dc_pow2_ceil(n);
  for (unsigned k = 2; k <= P; k <<= 1)
    for (unsigned j = k >> 1; j > 0; j >>= 1) {
      dc_step(a, n, P, k, j, r, nt);
      dc_sync<kCta>();
    }
}

// A warp's sort of a group of b <= 32 << LOGE records in registers: lane
// L holds places L * E + e (E = 1 << LOGE), places at or past b hold
// +infinity, and the bitonic network's steps run within a lane where
// the partner place is in it and across lanes by shuffles elsewhere.
// Without kKeys only the ords are compared (a group of one key).
template <bool kKeys, typename T>
__device__ __forceinline__ bool dc_reg_less(const DcRec<T>& a,
                                            const DcRec<T>& b) {
  return kKeys ? dc_less(a, b) : a.ord < b.ord;
}

template <bool kKeys, typename T>
__device__ __forceinline__ DcRec<T> dc_shfl(const DcRec<T>& x, int mask) {
  DcRec<T> y;
  y.ord = __shfl_xor_sync(0xffffffffu, x.ord, mask);
  y.val = __shfl_xor_sync(0xffffffffu, x.val, mask);
  y.key = kKeys ? __shfl_xor_sync(0xffffffffu, x.key, mask) : 0;
  return y;
}

// x becomes the smaller of x and y where `lower`, else the larger.
template <bool kKeys, typename T>
__device__ __forceinline__ void dc_keep(DcRec<T>& x, const DcRec<T>& y,
                                        bool lower) {
  if (dc_reg_less<kKeys>(y, x) == lower) x = y;
}

template <bool kKeys, typename T>
__device__ __forceinline__ void dc_swap_less(DcRec<T>& lo, DcRec<T>& hi) {
  if (dc_reg_less<kKeys>(hi, lo)) {
    const DcRec<T> t = lo;
    lo = hi;
    hi = t;
  }
}

// A thread's bitonic sort of its 2^LOGE records in registers.
template <int LOGE, bool kKeys, typename T>
__device__ __forceinline__ void dc_sort_regs(DcRec<T> (&x)[1 << LOGE]) {
#pragma unroll
  for (int lk = 1; lk <= LOGE; ++lk)
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj)
#pragma unroll
      for (int e = 0; e < (1 << LOGE); ++e)
        if ((e & (1 << lj)) == 0)
          dc_swap_less<kKeys>(
              x[e], x[lj == lk - 1 ? e ^ ((1 << lk) - 1) : e | (1 << lj)]);
}

template <int LOGE, bool kKeys, typename T, class A>
__device__ void dc_regsort(const A& a, int b, unsigned lane) {
  constexpr int E = 1 << LOGE;
  DcRec<T> x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < b) {
      x[e] = a.get(i);
    } else {
      x[e].ord = LLONG_MAX;
      x[e].val = T(0);
      x[e].key = INT_MAX;
    }
  }
#pragma unroll
  for (int lk = 1; lk <= LOGE + 5; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      if (lj == lk - 1 && lk > LOGE) {
        // The merge's mirror step across lanes: place L * E + e meets
        // place L' * E + E - 1 - e, L' = L ^ (2^lk / E - 1).
        const int mk = (1 << (lk - LOGE)) - 1;
        const bool lower = (lane & (1u << (lk - LOGE - 1))) == 0;
        if (E == 1) {
          dc_keep<kKeys>(x[0], dc_shfl<kKeys>(x[0], mk), lower);
        } else {
#pragma unroll
          for (int e = 0; e < E / 2; ++e) {
            const DcRec<T> ya = dc_shfl<kKeys>(x[E - 1 - e], mk);
            const DcRec<T> yb = dc_shfl<kKeys>(x[e], mk);
            dc_keep<kKeys>(x[e], ya, lower);
            dc_keep<kKeys>(x[E - 1 - e], yb, lower);
          }
        }
      } else if (lj == lk - 1) {
        // The mirror step within a lane.
#pragma unroll
        for (int e = 0; e < E; ++e)
          if ((e & (1 << lj)) == 0)
            dc_swap_less<kKeys>(x[e], x[e ^ ((1 << lk) - 1)]);
      } else if (lj >= LOGE) {
        const int mj = 1 << (lj - LOGE);
        const bool lower = (lane & mj) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e)
          dc_keep<kKeys>(x[e], dc_shfl<kKeys>(x[e], mj), lower);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if ((e & (1 << lj)) == 0) dc_swap_less<kKeys>(x[e], x[e | (1 << lj)]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < b) a.put(i, x[e]);
  }
}

// Adds records [s, e), ordered by (key, ord), onto their entries: one
// dependent add a record, each entry's standing value read once and its
// sum written once. The records are read DC_SUM_AHEAD at a time, so that
// their loads overlap.
template <typename T, class A>
__device__ void dc_sum(const A& a, int s, int e, T* target) {
  int cur = a.key_at(s);
  T acc = target[cur];
  int i = s;
  for (; i + DC_SUM_AHEAD <= e; i += DC_SUM_AHEAD) {
    int k[DC_SUM_AHEAD];
    T v[DC_SUM_AHEAD];
#pragma unroll
    for (int q = 0; q < DC_SUM_AHEAD; ++q) {
      k[q] = a.key_at(i + q);
      v[q] = a.val_at(i + q);
    }
#pragma unroll
    for (int q = 0; q < DC_SUM_AHEAD; ++q) {
      if (k[q] != cur) {
        target[cur] = acc;
        cur = k[q];
        acc = target[cur];
      }
      acc += v[q];
    }
  }
  for (; i < e; ++i) {
    const int k = a.key_at(i);
    if (k != cur) {
      target[cur] = acc;
      cur = k;
      acc = target[cur];
    }
    acc += a.val_at(i);
  }
  target[cur] = acc;
}

// The standing value `acc` with records [s, e) of one key added onto it
// in order, DC_SUM_AHEAD loaded at a time.
template <typename T, class A>
__device__ T dc_add(const A& a, int s, int e, T acc) {
  int i = s;
  for (; i + DC_SUM_AHEAD <= e; i += DC_SUM_AHEAD) {
    T v[DC_SUM_AHEAD];
#pragma unroll
    for (int q = 0; q < DC_SUM_AHEAD; ++q) v[q] = a.val_at(i + q);
#pragma unroll
    for (int q = 0; q < DC_SUM_AHEAD; ++q) acc += v[q];
  }
  for (; i < e; ++i) acc += a.val_at(i);
  return acc;
}

// The tile's place in the partitioned records and its keys.
struct DcTile {
  int lo, n, k0, groups;
};

__device__ __forceinline__ DcTile dc_tile(int t, const int* start, int tk,
                                          long long K, int g) {
  DcTile d;
  d.lo = start[t];
  d.n = start[t + 1] - d.lo;
  d.k0 = t * tk;
  const int nk = static_cast<int>(min(static_cast<long long>(tk),
                                      K - d.k0));
  d.groups = ((nk - 1) >> g) + 1;
  return d;
}

template <typename T, bool kKeys = true>
__device__ __forceinline__ DcStage<T, kKeys> dc_stage(int S) {
  long long* ord = reinterpret_cast<long long*>(dc_smem);
  T* val = reinterpret_cast<T*>(ord + S);
  int* key = reinterpret_cast<int*>(val + S);
  return DcStage<T, kKeys>{ord, val, key};
}

// hist[0, groups] (in shared memory, after the stage) becomes each
// group's first place in the tile and hist[groups] its count, from the
// keys of the n records of `a`.
template <class A>
__device__ void dc_group_starts(const A& a, int n, int k0, int g,
                                int groups, int* hist, int* warp_part) {
  for (int j = threadIdx.x; j <= groups; j += DC_THREADS) hist[j] = 0;
  __syncthreads();
  int i = threadIdx.x;
  for (; i + (DC_AHEAD - 1) * DC_THREADS < n; i += DC_AHEAD * DC_THREADS) {
    int k[DC_AHEAD];
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) k[q] = a.key_at(i + q * DC_THREADS);
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) atomicAdd(hist + ((k[q] - k0) >> g), 1);
  }
  for (; i < n; i += DC_THREADS)
    atomicAdd(hist + ((a.key_at(i) - k0) >> g), 1);
  __syncthreads();
  dc_scan_shared(hist, groups, warp_part);
  __syncthreads();
}

// The stage's groups [0, nb), group j at [starts[j] - base,
// starts[j + 1] - base), each ordered by (key, ord) and added onto the
// target: up to DC_THREAD_MAX records a thread's, sorted in registers
// (and, for one-key groups, added onto the standing value at once), up
// to 256 a warp's in registers, up to DC_WARP_MAX a warp's in shared
// memory, larger the CTA's; then one thread a group adds it serially.
// kGrouped: the plan's group shift is not 0, so a group holds several
// keys and its sorts compare and move them; otherwise group j is key
// key0 + j and standing[q] the standing value of group q * DC_THREADS +
// threadIdx.x. The caller zeroed *nbig; `big` lists the CTA's groups.
template <typename T, bool kGrouped>
__device__ __forceinline__ void dc_commit_groups(
    const DcStage<T>& all, const int* starts, int base, int nb, int key0,
    const T (&standing)[DC_HIST_MAX / DC_THREADS], T* target, int* big,
    int* nbig) {
  const DcStage<T, kGrouped> st{all.ord, all.val, all.key};
#pragma unroll
  for (int q = 0; q < DC_HIST_MAX / DC_THREADS; ++q) {
    const int j = q * DC_THREADS + threadIdx.x;
    if (j >= nb) break;
    const int s = starts[j] - base, b = starts[j + 1] - starts[j];
    if (b < 1 || b > DC_THREAD_MAX) continue;
    DcRec<T> x[DC_THREAD_MAX];
#pragma unroll
    for (int e = 0; e < DC_THREAD_MAX; ++e) {
      if (e < b) {
        x[e] = st.get(s + e);
      } else {
        x[e].ord = LLONG_MAX;
        x[e].val = T(0);
        x[e].key = INT_MAX;
      }
    }
    dc_sort_regs<DC_THREAD_LOG, kGrouped>(x);
    if (kGrouped) {
#pragma unroll
      for (int e = 0; e < DC_THREAD_MAX; ++e)
        if (e < b) st.put(s + e, x[e]);
    } else {
      T acc = standing[q];
#pragma unroll
      for (int e = 0; e < DC_THREAD_MAX; ++e)
        if (e < b) acc += x[e].val;
      target[key0 + j] = acc;
    }
  }
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < nb; j += DC_WARPS) {
    const int s = starts[j] - base, b = starts[j + 1] - starts[j];
    if (b <= DC_THREAD_MAX) continue;
    if (b <= 32)
      dc_regsort<0, kGrouped, T>(st.at(s), b, lane);
    else if (b <= 64)
      dc_regsort<1, kGrouped, T>(st.at(s), b, lane);
    else if (b <= 128)
      dc_regsort<2, kGrouped, T>(st.at(s), b, lane);
    else if (b <= 256)
      dc_regsort<3, kGrouped, T>(st.at(s), b, lane);
    else if (b <= DC_WARP_MAX)
      dc_bitonic<false>(st.at(s), b, lane, 32);
    else if (lane == 0)
      big[atomicAdd(nbig, 1)] = j;
  }
  __syncthreads();
  for (int q = 0; q < *nbig; ++q) {
    const int j = big[q];
    dc_bitonic<true>(st.at(starts[j] - base), starts[j + 1] - starts[j],
                     threadIdx.x, DC_THREADS);
  }
  __syncthreads();
  if (kGrouped) {
    for (int j = threadIdx.x; j < nb; j += DC_THREADS)
      if (starts[j + 1] > starts[j])
        dc_sum(all, starts[j] - base, starts[j + 1] - base, target);
    return;
  }
#pragma unroll
  for (int q = 0; q < DC_HIST_MAX / DC_THREADS; ++q) {
    const int j = q * DC_THREADS + threadIdx.x;
    if (j < nb && starts[j + 1] - starts[j] > DC_THREAD_MAX)
      target[key0 + j] = dc_add(all, starts[j] - base, starts[j + 1] - base,
                                standing[q]);
  }
}

// Standing values of one-key groups [0, nb) of keys key0 + j, one a
// thread per DC_THREADS, read ahead of their sums.
template <typename T, bool kGrouped>
__device__ __forceinline__ void dc_standing(
    T (&standing)[DC_HIST_MAX / DC_THREADS], const T* target, int key0,
    int nb) {
  if (kGrouped) return;
#pragma unroll
  for (int q = 0; q < DC_HIST_MAX / DC_THREADS; ++q) {
    const int j = q * DC_THREADS + threadIdx.x;
    if (j < nb) standing[q] = target[key0 + j];
  }
}

// Each record of the run whose group lies in [g_lo, g_hi) put at its
// group's next place in the stage (cur, less `base`).
template <typename T>
__device__ __forceinline__ void dc_load_groups(const DcRun<T>& run, int n,
                                               int k0, int g, int g_lo,
                                               int g_hi, int base,
                                               const DcStage<T>& all,
                                               int* cur) {
  int i = threadIdx.x;
  for (; i + (DC_AHEAD - 1) * DC_THREADS < n; i += DC_AHEAD * DC_THREADS) {
    DcRec<T> r[DC_AHEAD];
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) r[q] = run.get(i + q * DC_THREADS);
#pragma unroll
    for (int q = 0; q < DC_AHEAD; ++q) {
      const int grp = (r[q].key - k0) >> g;
      if (grp >= g_lo && grp < g_hi)
        all.put(atomicAdd(cur + grp, 1) - base, r[q]);
    }
  }
  for (; i < n; i += DC_THREADS) {
    const DcRec<T> r = run.get(i);
    const int grp = (r.key - k0) >> g;
    if (grp >= g_lo && grp < g_hi) all.put(atomicAdd(cur + grp, 1) - base, r);
  }
}

template <typename T, bool kGrouped>
__global__ void __launch_bounds__(DC_THREADS, 2)
    dc_tiles(const DcRec<T>* rec, const int* start, int tk, long long K,
             int g, int S, T* target, int* ofl_count, int* ofl_list) {
  __shared__ int warp_part[DC_WARPS];
  __shared__ int big[DC_BIG_MAX];
  __shared__ int nbig;
  const DcTile d = dc_tile(blockIdx.x, start, tk, K, g);
  if (d.n == 0) return;
  if (d.n > S) {  // over-full: dc_overfull commits it
    if (threadIdx.x == 0) ofl_list[atomicAdd(ofl_count, 1)] = blockIdx.x;
    return;
  }
  const DcStage<T> all = dc_stage<T>(S);
  int* hist = all.key + S;             // [groups + 1]: the group starts
  int* cur = hist + DC_HIST_MAX + 1;   // [groups]: the counting sort's
  if (threadIdx.x == 0) nbig = 0;
  const DcRun<T> run{const_cast<DcRec<T>*>(rec) + d.lo};
  T standing[DC_HIST_MAX / DC_THREADS];
  dc_standing<T, kGrouped>(standing, target, d.k0, d.groups);
  dc_group_starts(run, d.n, d.k0, g, d.groups, hist, warp_part);
  for (int j = threadIdx.x; j < d.groups; j += DC_THREADS) cur[j] = hist[j];
  __syncthreads();
  dc_load_groups(run, d.n, d.k0, g, 0, d.groups, 0, all, cur);
  __syncthreads();
  dc_commit_groups<T, kGrouped>(all, hist, 0, d.groups, d.k0, standing,
                                target, big, &nbig);
}

// Chunk by chunk of C records (a power of two, at most S): the chunk
// loaded into the stage, steps at distances below C (all of a full sort
// when `k` is 0, else merge width k's last steps) run there, the chunk
// stored back.
template <typename T>
__device__ void dc_chunks(const DcRun<T>& run, const DcStage<T>& st,
                          unsigned n, unsigned C, unsigned k) {
  for (unsigned base = 0; base < n; base += C) {
    const unsigned v = min(C, n - base);
    for (unsigned i = threadIdx.x; i < v; i += DC_THREADS)
      st.put(i, run.get(base + i));
    __syncthreads();
    if (k == 0)
      dc_bitonic<true>(st, v, threadIdx.x, DC_THREADS);
    else
      for (unsigned j = C >> 1; j > 0; j >>= 1) {
        dc_step(st, v, C, k, j, threadIdx.x, DC_THREADS);
        __syncthreads();
      }
    for (unsigned i = threadIdx.x; i < v; i += DC_THREADS)
      run.put(base + i, st.get(i));
    __syncthreads();
  }
}

// An over-full tile: where every group fits the stage, its groups in
// passes of as many as fit, each pass loading them from the run (in L2)
// into the stage and committing them as dc_tiles does; where a group
// does not (a hot key), the whole run sorted in place by (key, ord) in
// global memory (the bitonic network's merges up to width C on staged
// chunks, then each wider merge's steps at distances C and above on
// global memory and the rest on staged chunks) and summed chunk by
// staged chunk, each group's piece of a chunk added onto its entries'
// standing values, which carry the sum from one chunk to the next.
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(DC_THREADS)
    dc_overfull(DcRec<T>* rec, const int* start, int tk, long long K, int g,
                int S, T* target, const int* ofl_count,
                const int* ofl_list) {
  __shared__ int warp_part[DC_WARPS];
  __shared__ int big[DC_BIG_MAX];
  __shared__ int nbig, hot, s_hi;
  const DcStage<T> st = dc_stage<T>(S);
  int* hist = st.key + S;
  int* cur = hist + DC_HIST_MAX + 1;
  const unsigned C = 1u << (31 - __clz(S));
  const int listed = *ofl_count;
  for (int q = blockIdx.x; q < listed; q += gridDim.x) {
    const DcTile d = dc_tile(ofl_list[q], start, tk, K, g);
    const DcRun<T> run{rec + d.lo};
    const unsigned n = d.n, P = dc_pow2_ceil(n);
    if (threadIdx.x == 0) hot = 0;
    dc_group_starts(run, d.n, d.k0, g, d.groups, hist, warp_part);
    for (int j = threadIdx.x; j < d.groups; j += DC_THREADS)
      if (hist[j + 1] - hist[j] > S) hot = 1;
    __syncthreads();
    if (!hot) {
      for (int g_lo = 0; g_lo < d.groups;) {
        if (threadIdx.x == 0) {
          // The most groups from g_lo whose records fit the stage.
          int lo = g_lo + 1, hi = d.groups;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (hist[mid] - hist[g_lo] <= S)
              lo = mid;
            else
              hi = mid - 1;
          }
          s_hi = lo;
          nbig = 0;
        }
        __syncthreads();
        const int g_hi = s_hi, base = hist[g_lo];
        T standing[DC_HIST_MAX / DC_THREADS];
        dc_standing<T, kGrouped>(standing, target, d.k0 + g_lo, g_hi - g_lo);
        for (int j = g_lo + threadIdx.x; j < g_hi; j += DC_THREADS)
          cur[j] = hist[j];
        __syncthreads();
        dc_load_groups(run, d.n, d.k0, g, g_lo, g_hi, base, st, cur);
        __syncthreads();
        dc_commit_groups<T, kGrouped>(st, hist + g_lo, base, g_hi - g_lo,
                                      d.k0 + g_lo, standing, target, big,
                                      &nbig);
        __syncthreads();  // the stage, hist's pass and s_hi are free
        g_lo = g_hi;
      }
      continue;
    }
    dc_chunks(run, st, n, C, 0);
    for (unsigned k = 2 * C; k <= P; k <<= 1) {
      for (unsigned j = k >> 1; j >= C; j >>= 1) {
        dc_step<DC_GLOBAL_AHEAD>(run, n, P, k, j, threadIdx.x, DC_THREADS);
        __syncthreads();
      }
      dc_chunks(run, st, n, C, k);
    }
    dc_group_starts(run, d.n, d.k0, g, d.groups, hist, warp_part);
    for (unsigned base = 0; base < n; base += C) {
      const unsigned v = min(C, n - base);
      for (unsigned i = threadIdx.x; i < v; i += DC_THREADS)
        st.put(i, run.get(base + i));
      __syncthreads();
      const DcStage<T> at = st.at(-static_cast<int>(base));
      for (int j = threadIdx.x; j < d.groups; j += DC_THREADS) {
        const int s = max(hist[j], static_cast<int>(base));
        const int e = min(hist[j + 1], static_cast<int>(base + v));
        if (s < e) dc_sum(at, s, e, target);
      }
      __syncthreads();
    }
  }
}

// The records (key, ord, val) [m] are only read. `plan` is the host's
// (ops/det_commit.py dc_plan, DC_PLAN_LEN int64): TK, T, the group
// shift, chunks, records a chunk, S, tiles a window (TW), windows (W),
// dc_overfull's grid. `scratch` holds 3 * T + W + 2 + W * chunks ints
// (the tiles' starts, the over-full list, the tiles' cursors, the fine
// split's piece offsets, the windows' counts and places a chunk),
// `b_rec` 2 * m partitioned records (the coarse split's, then
// the fine split's) and `ofl` one int (the over-full tiles of this
// commit, left for the caller to read).
template <typename T>
static int det_commit(const void* key, const void* ord, const void* val,
                      int m, void* target, long long K, const long long* plan,
                      void* scratch, void* b_rec, void* ofl, void* stream) {
  if (m <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tk = static_cast<int>(plan[0]), T_ = static_cast<int>(plan[1]);
  const int g = static_cast<int>(plan[2]), chunks = static_cast<int>(plan[3]);
  const long long rc = plan[4];
  const int S = static_cast<int>(plan[5]), tw = static_cast<int>(plan[6]);
  const int W = static_cast<int>(plan[7]);
  const int ofl_grid = static_cast<int>(plan[8]);
  if (tk <= 0 || T_ <= 0 || static_cast<long long>(T_) * tk < K ||
      static_cast<long long>(T_ - 1) * tk >= K || rc <= 0 ||
      rc * chunks < m || S <= 0 || S > DC_BIG_MAX * DC_WARP_MAX ||
      ((tk - 1) >> g) >= DC_HIST_MAX || tw <= 0 || W <= 0 ||
      tw > DC_HIST_MAX || W > DC_HIST_MAX ||
      static_cast<long long>(W) * tw < T_ ||
      static_cast<long long>(W - 1) * tw >= T_ || ofl_grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_smem = dc_tiles_bytes<T>(S);
  const long long coarse_smem = dc_split_bytes<T>(W);
  const long long fine_smem = dc_split_bytes<T>(tw);
  int* start = static_cast<int*>(scratch);  // [T + 1]
  int* olist = start + T_ + 1;                // [T]
  int* tcur = olist + T_;                     // [T]
  int* poff = tcur + T_;                      // [W + 1]
  int* cw = poff + W + 1;                     // [W * chunks]
  int* ocount = static_cast<int*>(ofl);
  cudaError_t err = cudaSuccess;
  const struct {
    const void* fn;
    long long bytes;
  } attrs[] = {
      {reinterpret_cast<const void*>(dc_hist), 4LL * T_},
      {reinterpret_cast<const void*>(dc_split<T, false>), coarse_smem},
      {reinterpret_cast<const void*>(dc_split<T, true>), fine_smem},
      {reinterpret_cast<const void*>(dc_tiles<T, false>), tiles_smem},
      {reinterpret_cast<const void*>(dc_tiles<T, true>), tiles_smem},
      {reinterpret_cast<const void*>(dc_overfull<T, false>), tiles_smem},
      {reinterpret_cast<const void*>(dc_overfull<T, true>), tiles_smem},
  };
  for (const auto& a : attrs) {
    err = cudaFuncSetAttribute(a.fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(a.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(start, 0, sizeof(int) * T_, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* k32 = static_cast<const int*>(key);
  dc_hist<<<chunks, DC_THREADS, 4LL * T_, st>>>(k32, m, tk, T_, tw, W, rc,
                                                 start, cw);
  dc_starts<<<1, DC_THREADS, 0, st>>>(start, T_, tw, W, tcur, poff, ocount);
  const long long* o64 = static_cast<const long long*>(ord);
  const T* v = static_cast<const T*>(val);
  DcRec<T>* coarse = static_cast<DcRec<T>*>(b_rec);
  DcRec<T>* fine = coarse + m;
  if (W > 1) {
    dc_bases<<<W, DC_THREADS, 0, st>>>(start, tw, chunks, cw);
    dc_split<T, false><<<chunks, DC_THREADS, coarse_smem, st>>>(
        k32, o64, v, nullptr, m, tk, T_, tw, W, rc, chunks, start, cw, poff,
        tcur, coarse);
  }
  // With one window the fine split reads the stream itself.
  dc_split<T, true><<<(m + DC_SUB - 1) / DC_SUB + W, DC_THREADS, fine_smem,
                      st>>>(k32, o64, v, W > 1 ? coarse : nullptr, m, tk, T_,
                            tw, W, rc, chunks, start, cw, poff, tcur, fine);
  T* tgt = static_cast<T*>(target);
  if (g > 0) {
    dc_tiles<T, true><<<T_, DC_THREADS, tiles_smem, st>>>(
        fine, start, tk, K, g, S, tgt, ocount, olist);
    dc_overfull<T, true><<<ofl_grid, DC_THREADS, tiles_smem, st>>>(
        fine, start, tk, K, g, S, tgt, ocount, olist);
  } else {
    dc_tiles<T, false><<<T_, DC_THREADS, tiles_smem, st>>>(
        fine, start, tk, K, g, S, tgt, ocount, olist);
    dc_overfull<T, false><<<ofl_grid, DC_THREADS, tiles_smem, st>>>(
        fine, start, tk, K, g, S, tgt, ocount, olist);
  }
  return static_cast<int>(cudaGetLastError());
}

#define DC_PARAMS                                                         \
  const void *key, const void *ord, const void *val, int m, void *target, \
      long long K, const long long *plan, void *scratch, void *b_rec,     \
      void *ofl, void *stream
#define DC_ARGS key, ord, val, m, target, K, plan, scratch, b_rec, ofl, stream

extern "C" int pumi_det_commit_f32(DC_PARAMS) {
  return det_commit<float>(DC_ARGS);
}

extern "C" int pumi_det_commit_f64(DC_PARAMS) {
  return det_commit<double>(DC_ARGS);
}
