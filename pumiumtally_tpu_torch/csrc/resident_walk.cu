// W3: the whole-mesh walk with the mesh resident in shared memory, the
// whole walk loop in one kernel and a per-block flux partial.
//
// Replaces: tools/exp_r3_vmem.py `walk_vmem_pallas` (a Pallas kernel,
// pallas_call at exp_r3_vmem.py:237). There, each grid step pins the
// padded [L,32] table in VMEM, fetches rows with a one-hot MXU matmul
// (`oh @ table`) and scatters the tally with another (`contrib @ oh`)
// into a per-tile [L] partial. Both matmuls exist only for the TPU: here
// the row fetch is an indexed shared-memory load and the scatter a
// shared-memory atomic add.
//
// What bounds it on an H100: the per-particle state, read and written
// once (the mesh is small). In practice the crossings: each reads a 64 B
// plane row at a data-dependent element, 32 lanes reading 32 unrelated
// rows that conflict in shared memory's banks, then divides four times.
// One thread walking one particle to completion, reading a row as 16
// scalar loads from [L,16] rows (whose 64 B stride puts a given float of
// every row in one of two banks), took ~9.5 SM cycles a crossing; this
// design ~5, flat in L (chip_smoke.py --w3-g1-times).
//
// Shared memory (dynamic, one 1024-thread block per SM at large L):
//   [0, 16)                 two block counters (and padding)
//   [16, 16 + image)        the mesh image, staged once per CUDA block
//   [.., + 4 L)             the [L] flux partial
// The image (built by experiments/r3_vmem.py `resident_image`) is
//   - the plane rows quad-major: [4][L] float4, quad q of element e
//     holding its row's floats 4q..4q+3 (normals, then the 4 offsets),
//     so one 16-byte load of a quad of 32 unrelated elements lands on
//     8 bank groups (e mod 8), where [L,16] rows would land on 2;
//   - in the shared-adjacency regime, the 4 neighbour ids as 12-bit
//     codes (0xFFF = the boundary, -1) in 6 B: [L] uint32 words
//     id0 | id1 << 12 | (id2 & 0xFF) << 24, then [L] uint16 words
//     id2 >> 8 | id3 << 4, padded to 16 B. 16 + 74 B an element: L <=
//     3,140 (`w3_shared_adj_max_elems`). The wrapper builds the image
//     once per mesh and passes its byte count: the layout's arithmetic
//     lives in the wrapper alone. At the tool's largest mesh (L = 3,072) a crossing reads no
//     mesh data from global memory: the walk loop's only global loads
//     are a refilled particle's inputs (its SASS has one LDG fewer than
//     the global regime's; chip_smoke.py checks).
// Above 3,140 elements (the global-adjacency regime, L <= 3,418) the
// image holds the planes only and the winning face's neighbour comes
// from int32 adj [L,4] in global memory (one 4 B read per crossing,
// through L2). The wrapper picks the regime from L.
//
// What the design does about it:
// - a persistent grid (occupancy.cuh) whose lanes pull particles, as in
//   W0 (walk.cu): once W3_REFILL lanes of a warp (or all) have no
//   particle they take the next indices of the warp's share, and a warp
//   whose share is spent takes W3_GRAB more from a global counter; no
//   warp waits for its longest walk (W3_REFILL = 8 keeps ~72% of the
//   lanes busy, 16 ~66%);
// - a row is four 16-byte loads from the quad-major planes, the ids two
//   loads issued beside them, the neighbour picked by shifts;
// - the image is staged with 16-byte loads by every thread of the block
//   (one TMA bulk copy on an mbarrier, its first particles' input loads
//   overlapping it, was 2-6% slower on the whole kernel: PERF.md);
// - the tally goes into the shared partial with atomicAdd, a CAS loop in
//   SASS (ATOMS.CAST.SPIN; Hopper has no shared float add), and the
//   partial's nonzero entries are added into global flux once per CUDA
//   block with float atomics, so the summation order (only that) varies
//   from run to run. Adding straight into global flux, a native float
//   reduction in L2, was 2.6-7x slower: a few thousand hot addresses;
// - the optional counts (walked particles, warp steps) are added once
//   per CUDA block: crossings / (32 x warp steps) is the lanes' busy
//   share.
//
// Semantics kept from the tool: every particle walks (done starts false),
// only flying ones tally (eff_w = fly ? w*|d0| : 0), a zero-length move
// finishes on its first iteration, and max_iters caps each particle's
// crossings (the tool caps per tile; every active lane advances one
// crossing per iteration there, so the caps agree). Float32 only, as in
// the tool.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "walk_step.cuh"

#define W3_THREADS 1024
#define W3_GRAB 32     // particle indices a warp takes per global atomic
#define W3_REFILL 8    // idle lanes that make a warp refill
#define W3_HEADER 16   // two block counters, padded to 16 B
#define W3_ID_BITS 12
#define W3_ID_BOUNDARY 0xFFF

// The optional counts[W3_COUNTS] output.
enum W3Count { kW3Walked = 0, kW3WarpSteps = 1, W3_COUNTS = 2 };

struct W3Header {
  int walked;      // particles the block walked
  int warp_steps;  // loop iterations its warps ran a crossing in
};

struct W3Args {
  const float4* image;  // the mesh image (see above)
  const int* adj;       // [L,4] int32 neighbour ids (global regime)
  const float* x;
  const int* elem_in;
  const float* dest;
  const signed char* fly;
  const float* w;
  float* flux;
  float* x_out;
  int* elem_out;
  bool* done_out;
  bool* exited_out;
  float* s_out;
  int* next;    // the global particle counter, zeroed by the caller
  int* counts;  // [W3_COUNTS] or null
  int n, L, max_iters;
  uint32_t image_bytes;  // the image's size, a multiple of 16 B
  float tol;
};

template <bool kSharedAdj>
__global__ void __launch_bounds__(W3_THREADS, 1)
    resident_walk_kernel(const W3Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  W3Header* h = reinterpret_cast<W3Header*>(smem);
  const float4* quads = reinterpret_cast<const float4*>(smem + W3_HEADER);
  const uint32_t* ids_a =
      reinterpret_cast<const uint32_t*>(smem + W3_HEADER + 64u * a.L);
  const uint16_t* ids_b = reinterpret_cast<const uint16_t*>(ids_a + a.L);
  float* part = reinterpret_cast<float*>(smem + W3_HEADER + a.image_bytes);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) {
    h->walked = 0;
    h->warp_steps = 0;
  }
  for (uint32_t k = threadIdx.x; k < a.image_bytes / 16; k += blockDim.x)
    reinterpret_cast<float4*>(smem + W3_HEADER)[k] = a.image[k];
  for (int k = threadIdx.x; k < a.L; k += blockDim.x) part[k] = 0.0f;
  __syncthreads();

  // The warp's share of particle indices [pool, pool_end), the same in
  // every lane; `drained`: the global counter has passed n.
  int pool = 0, pool_end = 0;
  bool drained = false;
  int i = -1;  // this lane's particle, -1 while it has none
  float px = 0, py = 0, pz = 0, dx = 0, dy = 0, dz = 0, eff_w = 0, s = 0;
  int e = 0, steps = 0, walked = 0, warp_steps = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(0xffffffffu, i < 0);
    if (__popc(idle) >= W3_REFILL || idle == 0xffffffffu) {
      if (pool == pool_end && !drained) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.next, W3_GRAB);
        base = __shfl_sync(0xffffffffu, base, 0);
        pool = min(base, a.n);
        pool_end = min(base + W3_GRAB, a.n);
        drained = base + W3_GRAB >= a.n;
      }
      const int take = pool + __popc(idle & below);
      if (i < 0 && take < pool_end) {
        i = take;
        px = a.dest[3 * i];
        py = a.dest[3 * i + 1];
        pz = a.dest[3 * i + 2];
        dx = px - a.x[3 * i];
        dy = py - a.x[3 * i + 1];
        dz = pz - a.x[3 * i + 2];
        eff_w = walk_eff_weight(dx, dy, dz, a.fly[i], a.w[i]);
        s = 0.0f;
        e = a.elem_in[i];
        steps = 0;
      }
      pool = min(pool + __popc(idle), pool_end);
    }
    if (!__any_sync(0xffffffffu, i >= 0)) break;
    ++warp_steps;

    bool done = false, fin = false;
    if (i >= 0) {
      if (steps < a.max_iters) {
        float r[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = quads[q * a.L + e];
          r[4 * q] = v.x;
          r[4 * q + 1] = v.y;
          r[4 * q + 2] = v.z;
          r[4 * q + 3] = v.w;
        }
        uint64_t ids = 0;
        if constexpr (kSharedAdj)
          ids = ids_a[e] | static_cast<uint64_t>(ids_b[e]) << 32;
        int f;
        const float s_exit =
            walk_exit(r, s, dx, dy, dz, px, py, pz, a.tol, &f);
        int next;
        if constexpr (kSharedAdj) {
          const int id = static_cast<int>(ids >> (W3_ID_BITS * f)) &
                         W3_ID_BOUNDARY;
          next = id == W3_ID_BOUNDARY ? -1 : id;
        } else {
          next = a.adj[4 * e + f];
        }
        const bool reached = s_exit >= 1.0f;
        const float s_new = reached ? 1.0f : s_exit;
        const bool hit_boundary = !reached && next == -1;
        const float c = (s_new - s) * eff_w;
        if (c != 0.0f) atomicAdd(part + e, c);
        if (!reached && !hit_boundary) e = next;
        s = s_new;
        done = reached || hit_boundary;
        ++steps;
      }
      fin = done || steps >= a.max_iters;
    }
    if (fin) {
      const bool exited = done && s < 1.0f;
      const bool at_dest = done && !exited;
      a.x_out[3 * i] = at_dest ? px : px + (s - 1.0f) * dx;
      a.x_out[3 * i + 1] = at_dest ? py : py + (s - 1.0f) * dy;
      a.x_out[3 * i + 2] = at_dest ? pz : pz + (s - 1.0f) * dz;
      a.elem_out[i] = e;
      a.done_out[i] = done;
      a.exited_out[i] = exited;
      a.s_out[i] = s;
      ++walked;
      i = -1;
    }
  }
  const int warp_walked = __reduce_add_sync(0xffffffffu, walked);
  if (lane == 0 && a.counts != nullptr) {
    atomicAdd(&h->walked, warp_walked);
    atomicAdd(&h->warp_steps, warp_steps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.L; k += blockDim.x)
    if (part[k] != 0.0f) atomicAdd(a.flux + k, part[k]);
  if (threadIdx.x == 0 && a.counts != nullptr) {
    atomicAdd(a.counts + kW3Walked, h->walked);
    atomicAdd(a.counts + kW3WarpSteps, h->warp_steps);
  }
}

template <bool kSharedAdj>
static int launch_resident_walk(const W3Args& a, void* stream) {
  const size_t smem = W3_HEADER + size_t{a.image_bytes} + 4u * a.L;
  const void* kernel =
      reinterpret_cast<const void*>(resident_walk_kernel<kSharedAdj>);
  if (smem > SMEM_BYTES_PER_BLOCK || a.image_bytes % 16 != 0 ||
      a.image_bytes < 64u * a.L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n <= 0 || a.L <= 0) return static_cast<int>(cudaGetLastError());
  int resident = 0;
  if ((err = resident_blocks(kernel, W3_THREADS, smem, &resident)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const int needed = (a.n + W3_THREADS - 1) / W3_THREADS;
  resident_walk_kernel<kSharedAdj>
      <<<needed < resident ? needed : resident, W3_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pumi_resident_walk_f32(
    const void* image, const void* adj, const void* x, const void* elem,
    const void* dest, const void* fly, const void* w, void* flux, void* x_out,
    void* elem_out, void* done_out, void* exited_out, void* s_out, void* next,
    void* counts, int n, int L, int shared_adj, int image_bytes, double tol,
    int max_iters, void* stream) {
  W3Args a;
  a.image = static_cast<const float4*>(image);
  a.adj = static_cast<const int*>(adj);
  a.x = static_cast<const float*>(x);
  a.elem_in = static_cast<const int*>(elem);
  a.dest = static_cast<const float*>(dest);
  a.fly = static_cast<const signed char*>(fly);
  a.w = static_cast<const float*>(w);
  a.flux = static_cast<float*>(flux);
  a.x_out = static_cast<float*>(x_out);
  a.elem_out = static_cast<int*>(elem_out);
  a.done_out = static_cast<bool*>(done_out);
  a.exited_out = static_cast<bool*>(exited_out);
  a.s_out = static_cast<float*>(s_out);
  a.next = static_cast<int*>(next);
  a.counts = static_cast<int*>(counts);
  a.n = n;
  a.L = L;
  a.max_iters = max_iters;
  a.image_bytes = static_cast<uint32_t>(image_bytes);
  a.tol = static_cast<float>(tol);
  return shared_adj ? launch_resident_walk<true>(a, stream)
                    : launch_resident_walk<false>(a, stream);
}
