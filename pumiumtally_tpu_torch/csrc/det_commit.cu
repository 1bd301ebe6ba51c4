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
// How, over m records and K bank entries:
// 1. count: off[key + 1] += 1 (int atomics; off zeroed first);
// 2. scan: off becomes each bucket's first place (an inclusive scan of
//    K + 1 counts: chunk sums, one CUDA block's scan of the chunk sums,
//    each chunk's scan from its base);
// 3. scatter: each record (its ord and value, one 16-byte store) to
//    place atomicAdd(off[key], 1) of its bucket (the place within the bucket is the schedule's; after this
//    off[k] ends bucket k), in `passes` launches over key ranges whose
//    buckets fit in L2 (the host sizes them);
// 4. buckets: a warp takes 32 consecutive keys (one where buckets are
//    large): a lane ranks its own small bucket's records by ord in
//    shared memory (a record's place is the count of its bucket's
//    records with a smaller ord: the ords of a bucket are distinct),
//    writes the values in that order and adds them serially onto the
//    standing value; a large bucket is ranked by the whole warp and
//    added by its lane.
//
// What bounds it on an H100: the records are read and written a few
// times (the count, the scatter, the ranks) and the offsets of K + 1
// ints are zeroed, scanned and read; the ranking is quadratic in a
// bucket's size, ~170 records an element a move on the 48,000-tet box at
// 500,000 particles, and a bucket's sum is serial (PERF.md).

#include <cuda_runtime.h>

#define DC_THREADS 256
#define DC_ITEMS 16  // offsets a thread scans
#define DC_CHUNK (DC_THREADS * DC_ITEMS)
#define DC_BUCKET_THREADS 128
#define DC_STAGE 512  // records of a bucket staged in shared memory
#define DC_LANE 16     // records of a bucket one lane takes alone

__global__ void __launch_bounds__(DC_THREADS)
    dc_count(const int* key, int m, int* off) {
  const int stride = gridDim.x * DC_THREADS;
  for (int r = blockIdx.x * DC_THREADS + threadIdx.x; r < m; r += stride)
    atomicAdd(off + key[r] + 1, 1);
}

// The sum of `v` over the CUDA block, in every thread.
__device__ __forceinline__ int dc_block_sum(int v, int* warp_part) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < DC_THREADS / 32; ++w) total += warp_part[w];
  return total;
}

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
  for (int w = 0; w < DC_THREADS / 32; ++w) {
    before += w < warp ? warp_part[w] : 0;
    all += warp_part[w];
  }
  __syncthreads();  // warp_part may be written again
  *total = all;
  return before + incl - v;
}

__global__ void __launch_bounds__(DC_THREADS)
    dc_chunk_sum(const int* off, long long n, int* chunk) {
  __shared__ int warp_part[DC_THREADS / 32];
  const long long first =
      blockIdx.x * (long long)DC_CHUNK + threadIdx.x * (long long)DC_ITEMS;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < DC_ITEMS; ++j)
    if (first + j < n) mine += off[first + j];
  const int total = dc_block_sum(mine, warp_part);
  if (threadIdx.x == 0) chunk[blockIdx.x] = total;
}

// One CUDA block: the chunk sums become each chunk's base.
__global__ void __launch_bounds__(DC_THREADS)
    dc_chunk_scan(int* chunk, int chunks) {
  __shared__ int warp_part[DC_THREADS / 32];
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += DC_THREADS) {
    const int c = c0 + threadIdx.x;
    const int v = c < chunks ? chunk[c] : 0;
    int total;
    const int before = dc_block_excl(v, warp_part, &total);
    if (c < chunks) chunk[c] = carry + before;
    carry += total;
  }
}

// Each chunk's inclusive scan, from its base, in place.
__global__ void __launch_bounds__(DC_THREADS)
    dc_offsets(int* off, long long n, const int* chunk) {
  __shared__ int warp_part[DC_THREADS / 32];
  const long long first =
      blockIdx.x * (long long)DC_CHUNK + threadIdx.x * (long long)DC_ITEMS;
  int v[DC_ITEMS];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < DC_ITEMS; ++j) {
    v[j] = first + j < n ? off[first + j] : 0;
    mine += v[j];
  }
  int total;
  int run = chunk[blockIdx.x] + dc_block_excl(mine, warp_part, &total);
#pragma unroll
  for (int j = 0; j < DC_ITEMS; ++j) {
    run += v[j];
    if (first + j < n) off[first + j] = run;
  }
}

// The records whose key lies in [klo, khi): one of the scatter's passes
// over key ranges whose buckets fit in L2, so that the scattered writes
// merge there into whole sectors before they reach HBM.
// A bucketed record: its ord and value in one 16-byte store.
template <typename T>
struct alignas(16) DcRec {
  long long ord;
  T val;
};

template <typename T>
__global__ void __launch_bounds__(DC_THREADS)
    dc_scatter(const int* key, const long long* ord, const T* val, int m,
               int klo, int khi, int* off, DcRec<T>* b_rec) {
  const int stride = gridDim.x * DC_THREADS;
  for (int r = blockIdx.x * DC_THREADS + threadIdx.x; r < m; r += stride) {
    const int k = key[r];
    if (k < klo || k >= khi) continue;
    const int at = atomicAdd(off + k, 1);
    b_rec[at] = DcRec<T>{ord[r], val[r]};
  }
}

// Bucket k holds places [k ? off[k-1] : 0, off[k]) after the scatter.
// A warp takes `kpw` consecutive keys, one a lane (the host's choice from
// the mean bucket size: 32 for small buckets, 1 for large ones). A bucket
// of at most DC_LANE records is its lane's alone: its ords staged in the
// lane's column of the warp's shared stage, each record ranked by the
// count of smaller ords (distinct in a bucket, so the ranks are a
// permutation), its value written at its rank, and the values added in
// that order onto the standing value. A larger bucket is the warp's, one
// at a time: staged (up to DC_STAGE records) and ranked by all lanes,
// then added by its lane; past DC_STAGE records it is ranked from global
// memory into `sorted`.
template <typename T>
__global__ void __launch_bounds__(DC_BUCKET_THREADS)
    dc_buckets(const int* off, long long K, int kpw, const DcRec<T>* b_rec,
               T* sorted, T* target) {
  __shared__ long long st_ord[DC_BUCKET_THREADS / 32][DC_STAGE];
  __shared__ T st_val[DC_BUCKET_THREADS / 32][DC_STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* so = st_ord[warp];
  T* sv = st_val[warp];
  const long long k =
      (blockIdx.x * (long long)(DC_BUCKET_THREADS / 32) + warp) * kpw + lane;
  int lo = 0, hi = 0;
  if (lane < kpw && k < K) {
    lo = k == 0 ? 0 : off[k - 1];
    hi = off[k];
  }
  const int mine = hi - lo;
  if (mine > 0 && mine <= DC_LANE) {
    // The lane's column: entry b at b * 32 + lane (no bank conflicts).
    for (int a = 0; a < mine; ++a) so[a * 32 + lane] = b_rec[lo + a].ord;
    for (int a = 0; a < mine; ++a) {
      const long long oa = so[a * 32 + lane];
      int r = 0;
      for (int b = 0; b < mine; ++b) r += so[b * 32 + lane] < oa;
      sv[r * 32 + lane] = b_rec[lo + a].val;
    }
    T acc = target[k];
    for (int b = 0; b < mine; ++b) acc += sv[b * 32 + lane];
    target[k] = acc;
  }
  __syncwarp();  // the columns are free
  for (unsigned todo = __ballot_sync(0xffffffffu, mine > DC_LANE); todo;
       todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const int blo = __shfl_sync(0xffffffffu, lo, j);
    const int m = __shfl_sync(0xffffffffu, hi, j) - blo;
    const DcRec<T>* br = b_rec + blo;
    if (m <= DC_STAGE) {
      for (int a = lane; a < m; a += 32) so[a] = br[a].ord;
      __syncwarp();
      for (int a = lane; a < m; a += 32) {
        const long long oa = so[a];
        int r0 = 0, r1 = 0, r2 = 0, r3 = 0, b = 0;
        for (; b + 4 <= m; b += 4) {
          r0 += so[b] < oa;
          r1 += so[b + 1] < oa;
          r2 += so[b + 2] < oa;
          r3 += so[b + 3] < oa;
        }
        for (; b < m; ++b) r0 += so[b] < oa;
        sv[r0 + r1 + r2 + r3] = br[a].val;
      }
      __syncwarp();
      if (lane == j) {
        T acc = target[k];
        for (int b = 0; b < m; ++b) acc += sv[b];
        target[k] = acc;
      }
    } else {
      T* out = sorted + blo;
      for (int a = lane; a < m; a += 32) {
        const long long oa = br[a].ord;
        int r = 0;
        for (int b = 0; b < m; ++b) r += br[b].ord < oa;
        out[r] = br[a].val;
      }
      __syncwarp();
      if (lane == j) {
        T acc = target[k];
        for (int b = 0; b < m; ++b) acc += out[b];
        target[k] = acc;
      }
    }
    __syncwarp();  // the stage is free
  }
}

// The records (key, ord, val) [m] are only read; `off` holds K + 1 ints
// and `chunk` ceil((K + 1) / DC_CHUNK) of scratch; `b_rec` m bucketed
// records (16 bytes each) and `s_val` m values (a large bucket's values
// in order).
template <typename T>
static int det_commit(const void* key, const void* ord, const void* val,
                      int m, void* target, long long K, int passes,
                      void* off, void* chunk, void* b_rec, void* s_val,
                      void* stream) {
  if (m <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(off);
  int* c = static_cast<int*>(chunk);
  const long long n = K + 1;
  const int chunks = static_cast<int>((n + DC_CHUNK - 1) / DC_CHUNK);
  const int rec_grid = (m + DC_THREADS - 1) / DC_THREADS;
  cudaError_t err = cudaMemsetAsync(o, 0, n * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dc_count<<<rec_grid, DC_THREADS, 0, st>>>(static_cast<const int*>(key), m,
                                            o);
  dc_chunk_sum<<<chunks, DC_THREADS, 0, st>>>(o, n, c);
  dc_chunk_scan<<<1, DC_THREADS, 0, st>>>(c, chunks);
  dc_offsets<<<chunks, DC_THREADS, 0, st>>>(o, n, c);
  for (int p = 0; p < passes; ++p) {
    const long long klo = K * p / passes, khi = K * (p + 1) / passes;
    dc_scatter<T><<<rec_grid, DC_THREADS, 0, st>>>(
        static_cast<const int*>(key), static_cast<const long long*>(ord),
        static_cast<const T*>(val), m, static_cast<int>(klo),
        static_cast<int>(khi), o, static_cast<DcRec<T>*>(b_rec));
  }
  // Keys a warp: a lane each where a bucket is mostly a lane's, else one.
  const int kpw = m <= static_cast<long long>(DC_LANE) * K ? 32 : 1;
  const long long warps = (K + kpw - 1) / kpw;
  const long long bucket_grid =
      (warps + DC_BUCKET_THREADS / 32 - 1) / (DC_BUCKET_THREADS / 32);
  dc_buckets<T>
      <<<static_cast<unsigned>(bucket_grid), DC_BUCKET_THREADS, 0, st>>>(
          o, K, kpw, static_cast<const DcRec<T>*>(b_rec),
          static_cast<T*>(s_val), static_cast<T*>(target));
  return static_cast<int>(cudaGetLastError());
}

#define DC_PARAMS                                                          \
  const void *key, const void *ord, const void *val, int m, void *target,  \
      long long K, int passes, void *off, void *chunk, void *b_rec,        \
      void *s_val, void *stream
#define DC_ARGS \
  key, ord, val, m, target, K, passes, off, chunk, b_rec, s_val, stream

extern "C" int pumi_det_commit_f32(DC_PARAMS) {
  return det_commit<float>(DC_ARGS);
}

extern "C" int pumi_det_commit_f64(DC_PARAMS) {
  return det_commit<double>(DC_ARGS);
}
