// W1: the block-local walk of the partitioned engine's sub-split mesh.
//
// Replaces: pumiumtally_tpu/ops/vmem_walk.py `vmem_walk_local` (a Pallas
// kernel, pallas_call at vmem_walk.py:483). There, each grid step pins
// one block's [L,20] walk table in VMEM, fetches rows with a one-hot MXU
// matmul and accumulates the block's flux in VMEM. Here shared memory
// plays VMEM's role and the row fetch is an indexed shared-memory load.
//
// Layout (engine-arranged, as in the JAX kernel): `blocks` stacked
// [L,20] block tables; slots grouped by block, cap_b slots each; lelem
// is block-local; flux is [blocks*L]. A crossing whose neighbour lives
// in another block (adjacency <= -2, encoded -(glid+2)) parks the
// particle with pending = glid for the caller's migration.
//
// What bounds it on an H100: after the table is staged, each crossing
// costs one 80 B (f32) shared-memory row read and one shared atomic add,
// so the device-memory floor is the per-slot state read and written once
// per round plus the block tables (1024 rows x 80 B = 80 KiB per block,
// re-read by every CUDA block of that partition block from L2).
//
// What the design does about it: the CUDA grid is (partition block b,
// chunk of b's slots); each CUDA block stages b's table and a zeroed
// [L] flux partial in dynamic shared memory (84 B per element in f32:
// 84 KiB at L=1024, 168 KiB in f64 -- above 48 KiB it needs
// cudaFuncSetAttribute), walks one slot per thread until the particle
// is done or paused, then adds the nonzero partial entries into global
// flux once per CUDA block. A chunk with no active slot skips the table
// load. `iters` is the atomicMax of per-thread step counts, which equals
// the JAX kernel's per-tile loop count reduced by max.

#include <cuda_runtime.h>

#include "walk_step.cuh"

template <typename T>
__global__ void block_walk_kernel(
    const T* __restrict__ table, const T* __restrict__ x,
    const int* __restrict__ lelem_in, const T* __restrict__ dest,
    const signed char* __restrict__ fly, const T* __restrict__ w,
    const bool* __restrict__ done_in, const bool* __restrict__ exited_in,
    T* __restrict__ flux, T* __restrict__ x_out, int* __restrict__ lelem_out,
    bool* __restrict__ done_out, bool* __restrict__ exited_out,
    int* __restrict__ pending_out, int* __restrict__ iters, int L, int cap_b,
    T tol, int max_iters, int tally) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tbl = reinterpret_cast<T*>(smem_raw);      // [L*20] block table
  T* part = tbl + (size_t)L * WALK_TABLE_WIDTH;  // [L] flux partial
  const int b = blockIdx.x;
  const int slot = blockIdx.y * blockDim.x + threadIdx.x;
  const bool in_range = slot < cap_b;
  const size_t i = (size_t)b * cap_b + (in_range ? slot : 0);
  const bool active0 = in_range && !done_in[i];

  T px = 0, py = 0, pz = 0, dx = 0, dy = 0, dz = 0, s = 0;
  int e = 0, pending = -1;
  bool done = true, exited = false;
  if (in_range) {
    px = dest[3 * i];
    py = dest[3 * i + 1];
    pz = dest[3 * i + 2];
    dx = px - x[3 * i];
    dy = py - x[3 * i + 1];
    dz = pz - x[3 * i + 2];
    e = lelem_in[i];
    done = done_in[i];
    exited = exited_in[i];
  }

  if (__syncthreads_or(active0)) {
    const T* src = table + (size_t)b * L * WALK_TABLE_WIDTH;
    for (int k = threadIdx.x; k < L * WALK_TABLE_WIDTH; k += blockDim.x)
      tbl[k] = src[k];
    if (tally)
      for (int k = threadIdx.x; k < L; k += blockDim.x) part[k] = T(0);
    __syncthreads();

    if (active0) {
      const T eff_w =
          tally ? walk_eff_weight(dx, dy, dz, fly[i], w[i]) : T(0);
      int steps = 0;
      while (steps < max_iters) {
        int next;
        bool reached;
        const T s_new =
            walk_step(tbl + (size_t)e * WALK_TABLE_WIDTH, s, dx, dy, dz, px,
                      py, pz, tol, &next, &reached);
        const bool hit_boundary = !reached && next == -1;
        if (tally) {
          const T c = (s_new - s) * eff_w;
          if (c != T(0)) atomicAdd(part + e, c);
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
      atomicMax(iters, steps);
    }

    if (tally) {
      __syncthreads();
      T* dst = flux + (size_t)b * L;
      for (int k = threadIdx.x; k < L; k += blockDim.x)
        if (part[k] != T(0)) atomicAdd(dst + k, part[k]);
    }
  }

  if (in_range) {
    // Same materialisation rule as the JAX kernel: a particle that
    // reached its destination commits dest bit-exactly; everyone else
    // (boundary leavers, paused and untouched slots) commits
    // x0 + s*d0 with x0 = dest - d0.
    const bool at_dest = done && !exited;
    x_out[3 * i] = at_dest ? px : (px - dx) + s * dx;
    x_out[3 * i + 1] = at_dest ? py : (py - dy) + s * dy;
    x_out[3 * i + 2] = at_dest ? pz : (pz - dz) + s * dz;
    lelem_out[i] = e;
    done_out[i] = done;
    exited_out[i] = exited;
    pending_out[i] = pending;
  }
}

template <typename T>
static int launch_block_walk(const void* table, const void* x,
                             const void* lelem, const void* dest,
                             const void* fly, const void* w,
                             const void* done, const void* exited,
                             void* flux, void* x_out, void* lelem_out,
                             void* done_out, void* exited_out,
                             void* pending_out, void* iters, int blocks,
                             int L, int cap_b, double tol, int max_iters,
                             int tally, void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)L * (WALK_TABLE_WIDTH + 1) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0 && cap_b > 0) {
    const dim3 grid(blocks, (cap_b + threads - 1) / threads);
    block_walk_kernel<T><<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), static_cast<const T*>(x),
        static_cast<const int*>(lelem), static_cast<const T*>(dest),
        static_cast<const signed char*>(fly), static_cast<const T*>(w),
        static_cast<const bool*>(done), static_cast<const bool*>(exited),
        static_cast<T*>(flux), static_cast<T*>(x_out),
        static_cast<int*>(lelem_out), static_cast<bool*>(done_out),
        static_cast<bool*>(exited_out), static_cast<int*>(pending_out),
        static_cast<int*>(iters), L, cap_b, static_cast<T>(tol), max_iters,
        tally);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pumi_block_walk_f32(
    const void* table, const void* x, const void* lelem, const void* dest,
    const void* fly, const void* w, const void* done, const void* exited,
    void* flux, void* x_out, void* lelem_out, void* done_out,
    void* exited_out, void* pending_out, void* iters, int blocks, int L,
    int cap_b, double tol, int max_iters, int tally, void* stream) {
  return launch_block_walk<float>(table, x, lelem, dest, fly, w, done, exited,
                                  flux, x_out, lelem_out, done_out,
                                  exited_out, pending_out, iters, blocks, L,
                                  cap_b, tol, max_iters, tally, stream);
}

extern "C" int pumi_block_walk_f64(
    const void* table, const void* x, const void* lelem, const void* dest,
    const void* fly, const void* w, const void* done, const void* exited,
    void* flux, void* x_out, void* lelem_out, void* done_out,
    void* exited_out, void* pending_out, void* iters, int blocks, int L,
    int cap_b, double tol, int max_iters, int tally, void* stream) {
  return launch_block_walk<double>(table, x, lelem, dest, fly, w, done,
                                   exited, flux, x_out, lelem_out, done_out,
                                   exited_out, pending_out, iters, blocks, L,
                                   cap_b, tol, max_iters, tally, stream);
}
