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
// What bounds it on an H100: per crossing one 32 B select row and one
// 20 B (f32) refinement row, one flux add, at data-dependent addresses;
// the device-memory floor is the per-slot state read and written once
// plus the tables once (32 + 80 B per element in f32).
//
// What the design does about it: one thread walks one slot until it is
// done or paused; a CUDA block covers (partition block b, chunk of b's
// slots). Two regimes, one kernel (the kShared flag):
// - shared: when L*(32 + sizeof(T)) fits the 227 KB of dynamic shared
//   memory (L <= 6,456 in f32, 5,811 in f64), the block stages b's [L,16]
//   bf16 select rows and a zeroed [L] flux partial in shared memory,
//   walks, then adds the partial's nonzero entries into global flux
//   once. A chunk with no active slot skips the staging. The refinement
//   rows are read from global memory (through L2): only the winning
//   face's row is ever touched.
// - global: otherwise (one block holding a whole large mesh), the select
//   rows come from global memory and flux goes straight to global
//   atomics.
// `iters` is the atomicMax of per-thread step counts, which equals the
// JAX kernel's per-tile loop count, max-reduced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "twotier_step.cuh"

// Dynamic shared memory one CUDA block may use on an H100 (227 KB).
#define SMEM_BYTES_PER_BLOCK 232448

template <typename T, bool kShared>
__global__ void twotier_block_walk_kernel(
    const uint16_t* __restrict__ table_lo, const T* __restrict__ table_hi,
    const T* __restrict__ x, const int* __restrict__ lelem_in,
    const T* __restrict__ dest, const signed char* __restrict__ fly,
    const T* __restrict__ w, const bool* __restrict__ done_in,
    const bool* __restrict__ exited_in, T* __restrict__ flux,
    T* __restrict__ x_out, int* __restrict__ lelem_out,
    bool* __restrict__ done_out, bool* __restrict__ exited_out,
    int* __restrict__ pending_out, int* __restrict__ iters, int L, int cap_b,
    T tol, int max_iters, int tally) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int slot = blockIdx.y * blockDim.x + threadIdx.x;
  const bool in_range = slot < cap_b;
  const size_t i = (size_t)b * cap_b + (in_range ? slot : 0);
  const bool active0 = in_range && !done_in[i];

  T x0x = 0, x0y = 0, x0z = 0, dx = 0, dy = 0, dz = 0, s = 0;
  int e = 0, pending = -1;
  bool done = true, exited = false;
  if (in_range) {
    x0x = x[3 * i];
    x0y = x[3 * i + 1];
    x0z = x[3 * i + 2];
    dx = dest[3 * i] - x0x;
    dy = dest[3 * i + 1] - x0y;
    dz = dest[3 * i + 2] - x0z;
    e = lelem_in[i];
    done = done_in[i];
    exited = exited_in[i];
  }
  // The ray's destination as the JAX kernel rebuilds it from the carried
  // invariants (not the input dest: x0 + (dest - x0) may differ from
  // dest by an ulp).
  const T cx = x0x + dx, cy = x0y + dy, cz = x0z + dz;

  const uint16_t* lo_b = table_lo + (size_t)b * L * WALK_TABLE_LO_WIDTH;
  const T* hi_b = table_hi + (size_t)b * L * 4 * WALK_PLANE_WIDTH;
  T* flux_b = flux + (size_t)b * L;
  uint16_t* lo_s = reinterpret_cast<uint16_t*>(smem_raw);
  T* part = reinterpret_cast<T*>(smem_raw + (size_t)L * 32);

  bool any_active = active0;
  if constexpr (kShared) any_active = __syncthreads_or(active0);
  if (any_active) {
    if constexpr (kShared) {
      const uint4* src = reinterpret_cast<const uint4*>(lo_b);
      uint4* dst = reinterpret_cast<uint4*>(lo_s);
      for (int k = threadIdx.x; k < 2 * L; k += blockDim.x) dst[k] = src[k];
      if (tally)
        for (int k = threadIdx.x; k < L; k += blockDim.x) part[k] = T(0);
      __syncthreads();
    }
    if (active0) {
      const T eff_w =
          tally ? walk_eff_weight(dx, dy, dz, fly[i], w[i]) : T(0);
      const uint16_t* lo = kShared ? lo_s : lo_b;
      T* acc = kShared ? part : flux_b;
      int steps = 0;
      while (steps < max_iters) {
        int next;
        bool reached;
        const T s_new = twotier_step(lo + (size_t)e * WALK_TABLE_LO_WIDTH,
                                     hi_b, e, s, dx, dy, dz, cx, cy, cz, tol,
                                     &next, &reached);
        const bool hit_boundary = !reached && next == -1;
        if (tally) {
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
      atomicMax(iters, steps);
    }
    if constexpr (kShared) {
      if (tally) {
        __syncthreads();
        for (int k = threadIdx.x; k < L; k += blockDim.x)
          if (part[k] != T(0)) atomicAdd(flux_b + k, part[k]);
      }
    }
  }

  if (in_range) {
    const bool at_dest = done && !exited;
    x_out[3 * i] = at_dest ? dest[3 * i] : x0x + s * dx;
    x_out[3 * i + 1] = at_dest ? dest[3 * i + 1] : x0y + s * dy;
    x_out[3 * i + 2] = at_dest ? dest[3 * i + 2] : x0z + s * dz;
    lelem_out[i] = e;
    done_out[i] = done;
    exited_out[i] = exited;
    pending_out[i] = pending;
  }
}

template <typename T>
static int launch_twotier_block_walk(
    const void* table_lo, const void* table_hi, const void* x,
    const void* lelem, const void* dest, const void* fly, const void* w,
    const void* done, const void* exited, void* flux, void* x_out,
    void* lelem_out, void* done_out, void* exited_out, void* pending_out,
    void* iters, int blocks, int L, int cap_b, double tol, int max_iters,
    int tally, int use_shared, void* stream) {
  const int threads = 256;
  const size_t smem =
      use_shared ? (size_t)L * (32 + sizeof(T)) : static_cast<size_t>(0);
  if (smem > SMEM_BYTES_PER_BLOCK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = use_shared ? twotier_block_walk_kernel<T, true>
                           : twotier_block_walk_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0 && cap_b > 0) {
    const dim3 grid(blocks, (cap_b + threads - 1) / threads);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(table_lo),
        static_cast<const T*>(table_hi), static_cast<const T*>(x),
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

extern "C" int pumi_twotier_block_walk_f32(
    const void* table_lo, const void* table_hi, const void* x,
    const void* lelem, const void* dest, const void* fly, const void* w,
    const void* done, const void* exited, void* flux, void* x_out,
    void* lelem_out, void* done_out, void* exited_out, void* pending_out,
    void* iters, int blocks, int L, int cap_b, double tol, int max_iters,
    int tally, int use_shared, void* stream) {
  return launch_twotier_block_walk<float>(
      table_lo, table_hi, x, lelem, dest, fly, w, done, exited, flux, x_out,
      lelem_out, done_out, exited_out, pending_out, iters, blocks, L, cap_b,
      tol, max_iters, tally, use_shared, stream);
}

extern "C" int pumi_twotier_block_walk_f64(
    const void* table_lo, const void* table_hi, const void* x,
    const void* lelem, const void* dest, const void* fly, const void* w,
    const void* done, const void* exited, void* flux, void* x_out,
    void* lelem_out, void* done_out, void* exited_out, void* pending_out,
    void* iters, int blocks, int L, int cap_b, double tol, int max_iters,
    int tally, int use_shared, void* stream) {
  return launch_twotier_block_walk<double>(
      table_lo, table_hi, x, lelem, dest, fly, w, done, exited, flux, x_out,
      lelem_out, done_out, exited_out, pending_out, iters, blocks, L, cap_b,
      tol, max_iters, tally, use_shared, stream);
}
