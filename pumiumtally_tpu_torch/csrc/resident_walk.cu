// W3: the whole-mesh walk with the mesh's plane table resident in shared
// memory, the whole walk loop in one kernel and a per-block flux partial.
//
// Replaces: tools/exp_r3_vmem.py `walk_vmem_pallas` (a Pallas kernel,
// pallas_call at exp_r3_vmem.py:237). There, each grid step pins the
// padded [L,32] table in VMEM, fetches rows with a one-hot MXU matmul
// (`oh @ table`) and scatters the tally with another (`contrib @ oh`)
// into a per-tile [L] partial. Both matmuls exist only for the TPU: here
// the row fetch is an indexed shared-memory load and the scatter a
// shared-memory atomic add.
//
// Layout: the [L,20] packed row does not fit beside an [L] flux partial
// at the tool's largest mesh (L = 3,072: 258,048 B > 232,448 B), so the
// kernel keeps only the 16 plane floats of each tet in shared memory
// (64 B per row, 196,608 B at L = 3,072) and reads the winning face's
// neighbour as int32 from adj [L,4] in global memory (one 4 B read per
// crossing, through L2). 68 B per element in all: L <= 3,418.
//
// What bounds it on an H100: the per-particle state, read and written
// once (the table and adjacency are small); each crossing is a chain of
// dependent shared-memory reads and a division, so in practice latency.
//
// What the design does about it: a persistent grid, as many 1024-thread
// blocks as fit on the SMs at once (one per SM at the largest L), each
// staging the table and zeroing its partial once and then grid-striding
// over particles, one thread walking its particle to completion. A
// per-256-particle tile as on the TPU would restage ~200 KB per tile
// (~390 MB at N = 500,000). The partial's nonzero entries are added into
// global flux once per block with float atomics, so the summation order
// (only that) varies from run to run.
//
// Semantics kept from the tool: every particle walks (done starts false),
// only flying ones tally (eff_w = fly ? w*|d0| : 0), a zero-length move
// finishes on its first iteration, and max_iters caps each particle's
// crossings (the tool caps per tile; every active lane advances one
// crossing per iteration there, so the caps agree). Float32 only, as in
// the tool.

#include <cuda_runtime.h>

#include "occupancy.cuh"
#include "walk_step.cuh"

#define PLANE_WIDTH 16  // 4 normals + 4 offsets per tet
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads, 1) resident_walk_kernel(
    const float4* __restrict__ planes, const int* __restrict__ adj,
    const float* __restrict__ x, const int* __restrict__ elem_in,
    const float* __restrict__ dest, const signed char* __restrict__ fly,
    const float* __restrict__ w, float* __restrict__ flux,
    float* __restrict__ x_out, int* __restrict__ elem_out,
    bool* __restrict__ done_out, bool* __restrict__ exited_out,
    float* __restrict__ s_out, int n, int L, float tol, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* tbl4 = reinterpret_cast<float4*>(smem_raw);  // [L*4] float4
  const float* tbl = reinterpret_cast<const float*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw) + (size_t)L * PLANE_WIDTH;
  for (int k = threadIdx.x; k < L * (PLANE_WIDTH / 4); k += blockDim.x)
    tbl4[k] = planes[k];
  for (int k = threadIdx.x; k < L; k += blockDim.x) part[k] = 0.0f;
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float px = dest[3 * i], py = dest[3 * i + 1], pz = dest[3 * i + 2];
    const float dx = px - x[3 * i], dy = py - x[3 * i + 1],
                dz = pz - x[3 * i + 2];
    const float eff_w = walk_eff_weight(dx, dy, dz, fly[i], w[i]);
    float s = 0.0f;
    int e = elem_in[i];
    bool done = false;
    int steps = 0;
    while (!done && steps < max_iters) {
      int f_exit;
      const float s_exit = walk_exit(tbl + (size_t)e * PLANE_WIDTH, s, dx, dy,
                                     dz, px, py, pz, tol, &f_exit);
      const bool reached = s_exit >= 1.0f;
      const float s_new = reached ? 1.0f : s_exit;
      const int next = adj[4 * e + f_exit];
      const bool hit_boundary = !reached && next == -1;
      const float c = (s_new - s) * eff_w;
      if (c != 0.0f) atomicAdd(part + e, c);
      if (!reached && !hit_boundary) e = next;
      s = s_new;
      done = reached || hit_boundary;
      ++steps;
    }
    const bool exited = done && s < 1.0f;
    const bool at_dest = done && !exited;
    x_out[3 * i] = at_dest ? px : px + (s - 1.0f) * dx;
    x_out[3 * i + 1] = at_dest ? py : py + (s - 1.0f) * dy;
    x_out[3 * i + 2] = at_dest ? pz : pz + (s - 1.0f) * dz;
    elem_out[i] = e;
    done_out[i] = done;
    exited_out[i] = exited;
    s_out[i] = s;
  }

  __syncthreads();
  for (int k = threadIdx.x; k < L; k += blockDim.x)
    if (part[k] != 0.0f) atomicAdd(flux + k, part[k]);
}

extern "C" int pumi_resident_walk_f32(
    const void* planes, const void* adj, const void* x, const void* elem,
    const void* dest, const void* fly, const void* w, void* flux, void* x_out,
    void* elem_out, void* done_out, void* exited_out, void* s_out, int n,
    int L, double tol, int max_iters, void* stream) {
  const size_t smem = (size_t)L * (PLANE_WIDTH + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resident_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  int resident = 0;
  if ((err = resident_blocks(reinterpret_cast<const void*>(
                                 resident_walk_kernel),
                             kThreads, smem, &resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int needed = (n + kThreads - 1) / kThreads;
  const int grid = needed < resident ? needed : resident;
  resident_walk_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(planes), static_cast<const int*>(adj),
      static_cast<const float*>(x), static_cast<const int*>(elem),
      static_cast<const float*>(dest), static_cast<const signed char*>(fly),
      static_cast<const float*>(w), static_cast<float*>(flux),
      static_cast<float*>(x_out), static_cast<int*>(elem_out),
      static_cast<bool*>(done_out), static_cast<bool*>(exited_out),
      static_cast<float*>(s_out), n, L, static_cast<float>(tol), max_iters);
  return static_cast<int>(cudaGetLastError());
}
