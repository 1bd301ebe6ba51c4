// G1: row gather out[i,:] = tab[idx[i],:] from a [E,W] float32 table.
//
// Replaces both Pallas row-gather probes, which differ only in what an
// index outside the table gives:
//   - tools/exp_pallas_gather.py `gather` (pallas_call at :15):
//     jnp.take(tab, idx, axis=0, fill_value=0)  -> entry
//     pumi_row_gather_take_f32, fill 0 (the caller's fill value);
//   - tools/exp_pallas_gather2.py `gather` (pallas_call at :16):
//     jnp.take_along_axis of idx broadcast to [T,W], whose default fill
//     is NaN -> entry pumi_row_gather_take_along_axis_f32.
// Index rule (both): an index in [-E, 0) wraps to idx + E; one outside
// [-E, E) gives the fill value for the whole row.
//
// What bounds it on an H100: bytes. It reads the T indices and each
// distinct row they name once, and writes T rows (T*4 + (distinct +
// T)*W*4 bytes: 2.0 MB at the probes' shape, 72 MB at T = 500,000, where
// all 48,000 rows of the 6.1 MB table are named); there is no
// arithmetic to speak of. The probes pin the table in VMEM; here the
// table stays in global memory and repeated rows come from L2. At the
// probes' shape the gather is one short wave whose time is the card's
// fixed cost of a kernel (an empty one takes ~0.89 us) and two
// dependent round trips, an index load then a row load, before the
// store: ~1.57 us, where a contiguous copy of the same rows (one round
// trip) takes ~1.26 us. At T = 500,000 rows it is bandwidth: ~29 us,
// 1.36x the 21.5 us its bytes take at HBM's rate, where a fill of the
// 64 MB output alone takes ~20 us.
//
// What the design does about it: one thread per 16 B of output (a W = 32
// row is 8 float4), so neighbouring threads read and write neighbouring
// 16 B words of a row, a warp moves four whole 128 B rows per access,
// and each of the probes' 2,048 warps waits on one short chain. Designs
// that give a warp 32 rows (one coalesced index load handed out by
// __shfl_sync, eight 16-byte row loads a lane in flight, a persistent
// one-wave grid), with or without a cp.async.bulk copy of each row
// through a shared tile, were 0.3-1.0 us slower at the probes' shape and
// -3% to +12% at 500,000 rows; 32-bit index math was 2% slower at the
// probes' shape (PERF.md).
// Needs W % 4 == 0 and 16-byte aligned tables (the wrapper checks).

#include <cuda_runtime.h>

__global__ void row_gather_kernel(const float4* __restrict__ tab,
                                  const int* __restrict__ idx,
                                  float4* __restrict__ out, int E, int n,
                                  int vec_per_row, float fill) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * vec_per_row) return;
  const int i = static_cast<int>(t / vec_per_row);
  const int c = static_cast<int>(t - (long long)i * vec_per_row);
  int j = idx[i];
  if (j < 0) j += E;  // no overflow: j < 0 < E
  out[t] = (j >= 0 && j < E) ? tab[(size_t)j * vec_per_row + c]
                             : make_float4(fill, fill, fill, fill);
}

static int launch_row_gather(const void* tab, const void* idx, void* out,
                             int E, int n, int W, float fill, void* stream) {
  const int threads = 256;
  const int vec_per_row = W / 4;
  const long long total = (long long)n * vec_per_row;
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    row_gather_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(tab), static_cast<const int*>(idx),
        static_cast<float4*>(out), E, n, vec_per_row, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pumi_row_gather_take_f32(const void* tab, const void* idx,
                                        void* out, int E, int n, int W,
                                        double fill, void* stream) {
  return launch_row_gather(tab, idx, out, E, n, W, static_cast<float>(fill),
                           stream);
}

extern "C" int pumi_row_gather_take_along_axis_f32(const void* tab,
                                                   const void* idx, void* out,
                                                   int E, int n, int W,
                                                   double fill, void* stream) {
  return launch_row_gather(tab, idx, out, E, n, W, static_cast<float>(fill),
                           stream);
}
