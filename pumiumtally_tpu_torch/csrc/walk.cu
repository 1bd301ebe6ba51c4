// W0: the monolithic tallied tet walk, one thread per particle.
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
// exited, s out) plus the row and flux traffic per crossing.
//
// What the design does about it: every thread walks its particle to
// completion with the row read through the read-only path, so there is
// no lock-step waste and no compaction cascade (the JAX walk needs one
// to bound the waste of a batch-wide while_loop). Flux goes through
// atomicAdd (double atomics for f64), so its summation order, and only
// that, varies from run to run. Positions are materialised once from
// the ray coordinate at the end; a particle that reaches its
// destination commits dest bit-exactly (the continue-mode contract).

#include <cuda_runtime.h>

#include "walk_step.cuh"

template <typename T>
__global__ void walk_kernel(const T* __restrict__ table,
                            const T* __restrict__ x,
                            const int* __restrict__ elem_in,
                            const T* __restrict__ dest,
                            const signed char* __restrict__ fly,
                            const T* __restrict__ w,
                            const T* __restrict__ s_init,
                            T* __restrict__ flux, T* __restrict__ x_out,
                            int* __restrict__ elem_out,
                            bool* __restrict__ done_out,
                            bool* __restrict__ exited_out,
                            T* __restrict__ s_out, int* __restrict__ iters,
                            int n, T tol, int max_iters, int tally) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T px = dest[3 * i], py = dest[3 * i + 1], pz = dest[3 * i + 2];
  const T dx = px - x[3 * i], dy = py - x[3 * i + 1], dz = pz - x[3 * i + 2];
  const T eff_w = tally ? walk_eff_weight(dx, dy, dz, fly[i], w[i]) : T(0);
  T s = s_init ? s_init[i] : T(0);
  int e = elem_in[i];
  bool done = false;
  int steps = 0;
  while (!done && steps < max_iters) {
    int next;
    bool reached;
    const T s_new = walk_step(table + (size_t)e * WALK_TABLE_WIDTH, s, dx,
                              dy, dz, px, py, pz, tol, &next, &reached);
    const bool hit_boundary = !reached && next == -1;
    if (tally) {
      const T c = (s_new - s) * eff_w;
      if (c != T(0)) atomicAdd(flux + e, c);
    }
    if (!reached && !hit_boundary) e = next;
    s = s_new;
    done = reached || hit_boundary;
    ++steps;
  }
  const bool exited = done && s < T(1);
  const bool at_dest = done && !exited;
  x_out[3 * i] = at_dest ? px : px + (s - T(1)) * dx;
  x_out[3 * i + 1] = at_dest ? py : py + (s - T(1)) * dy;
  x_out[3 * i + 2] = at_dest ? pz : pz + (s - T(1)) * dz;
  elem_out[i] = e;
  done_out[i] = done;
  exited_out[i] = exited;
  s_out[i] = s;
  atomicMax(iters, steps);
}

template <typename T>
static int launch_walk(const void* table, const void* x, const void* elem,
                       const void* dest, const void* fly, const void* w,
                       const void* s_init, void* flux, void* x_out,
                       void* elem_out, void* done_out, void* exited_out,
                       void* s_out, void* iters, int n, double tol,
                       int max_iters, int tally, void* stream) {
  const int threads = 256;
  if (n > 0) {
    walk_kernel<T><<<(n + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), static_cast<const T*>(x),
        static_cast<const int*>(elem), static_cast<const T*>(dest),
        static_cast<const signed char*>(fly), static_cast<const T*>(w),
        static_cast<const T*>(s_init), static_cast<T*>(flux),
        static_cast<T*>(x_out), static_cast<int*>(elem_out),
        static_cast<bool*>(done_out), static_cast<bool*>(exited_out),
        static_cast<T*>(s_out), static_cast<int*>(iters), n,
        static_cast<T>(tol), max_iters, tally);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pumi_walk_f32(const void* table, const void* x,
                             const void* elem, const void* dest,
                             const void* fly, const void* w,
                             const void* s_init, void* flux, void* x_out,
                             void* elem_out, void* done_out, void* exited_out,
                             void* s_out, void* iters, int n, double tol,
                             int max_iters, int tally, void* stream) {
  return launch_walk<float>(table, x, elem, dest, fly, w, s_init, flux,
                            x_out, elem_out, done_out, exited_out, s_out,
                            iters, n, tol, max_iters, tally, stream);
}

extern "C" int pumi_walk_f64(const void* table, const void* x,
                             const void* elem, const void* dest,
                             const void* fly, const void* w,
                             const void* s_init, void* flux, void* x_out,
                             void* elem_out, void* done_out, void* exited_out,
                             void* s_out, void* iters, int n, double tol,
                             int max_iters, int tally, void* stream) {
  return launch_walk<double>(table, x, elem, dest, fly, w, s_init, flux,
                             x_out, elem_out, done_out, exited_out, s_out,
                             iters, n, tol, max_iters, tally, stream);
}
