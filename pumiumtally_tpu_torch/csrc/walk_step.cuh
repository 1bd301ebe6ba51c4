// One crossing of the fixed-ray tet walk, shared by the walk kernels
// (walk.cu, block_walk.cu, resident_walk.cu), and the packed row's
// 16-byte loaders. Templated on float / double.
//
// The ray is parametrised by s in [0,1] along x0 -> dest with
// x0 = dest - d0. For face f with outward unit normal n_f and offset
// off_f (n_f . p = off_f on the face):
//   a_f = n_f . d0,   b_f = off_f - n_f . dest + a_f   (= off_f - n_f . x0)
// the face is crossed ahead iff a_f * (1 - s) > tol, at s_f = b_f / a_f,
// clamped to s_f >= s (a committed point epsilon outside a face never
// steps back). The exit face is the FIRST minimal s_f (lowest face
// index wins ties, as argmin does). Sources: pumiumtally_tpu/ops/walk.py
// _advance_geometry and ops/vmem_walk.py _advance_cols; this is the
// column-wise form of the latter, operation for operation, so that a
// build with --fmad=false rounds exactly as the plain PyTorch versions
// (ops/walk.py walk_plain, ops/vmem_walk.py vmem_walk_local_plain) do.

#pragma once

// Packed walk-table row (mesh/tetmesh.py WALK_TABLE_*): 4 face normals,
// 4 plane offsets, 4 neighbour ids stored as floats. A neighbour id of
// -1 is the domain boundary; <= -2 encodes a neighbour in another block
// as -(glid + 2).
#define WALK_TABLE_WIDTH 20
#define WALK_TABLE_OFFSETS 12
#define WALK_TABLE_ADJ 16

template <typename T>
__device__ __forceinline__ T walk_inf();

template <>
__device__ __forceinline__ float walk_inf<float>() {
  return __int_as_float(0x7f800000);
}

template <>
__device__ __forceinline__ double walk_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// The exit face of the tet whose 16 plane values (4 normals, 4 offsets)
// start at `row`: returns its crossing s_f (infinite when no face lies
// ahead) and, through `f_exit`, the first minimal face.
// (dx,dy,dz) = d0 and (px,py,pz) = dest are walk constants.
template <typename T>
__device__ __forceinline__ T walk_exit(const T* row, T s, T dx, T dy, T dz,
                                       T px, T py, T pz, T tol,
                                       int* f_exit) {
  const T one = T(1);
  T s_exit = walk_inf<T>();
  int f_min = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T nx = row[3 * f], ny = row[3 * f + 1], nz = row[3 * f + 2];
    const T a = nx * dx + ny * dy + nz * dz;
    const T n_dest = nx * px + ny * py + nz * pz;
    const T b = row[WALK_TABLE_OFFSETS + f] - n_dest + a;
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

// One packed row into registers with 16-byte loads (5 x float4 in f32,
// 10 x double2 in f64); rows are 80 / 160 B and 16 B aligned, in global
// memory (W0) or shared memory (W1).
__device__ __forceinline__ void walk_load_row(const float* row,
                                              float r[WALK_TABLE_WIDTH]) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float4 v = p[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void walk_load_row(const double* row,
                                              double r[WALK_TABLE_WIDTH]) {
  const double2* p = reinterpret_cast<const double2*>(row);
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    const double2 v = p[q];
    r[2 * q] = v.x;
    r[2 * q + 1] = v.y;
  }
}

// Advance one crossing from ray coordinate s inside the tet whose packed
// row `r` is in registers. Returns the new coordinate (1 when the
// destination lies inside this tet) and, through `next`, the neighbour
// across the exit face, picked by selects (indexing the row with the
// run-time face would put it in local memory).
template <typename T>
__device__ __forceinline__ T walk_step(const T r[WALK_TABLE_WIDTH], T s,
                                       T dx, T dy, T dz, T px, T py, T pz,
                                       T tol, int* next, bool* reached) {
  int f;
  const T s_exit = walk_exit(r, s, dx, dy, dz, px, py, pz, tol, &f);
  const T adj = f == 0   ? r[WALK_TABLE_ADJ]
                : f == 1 ? r[WALK_TABLE_ADJ + 1]
                : f == 2 ? r[WALK_TABLE_ADJ + 2]
                         : r[WALK_TABLE_ADJ + 3];
  *reached = s_exit >= T(1);
  *next = static_cast<int>(adj);
  return *reached ? T(1) : s_exit;
}

// The per-particle walk constants: segment length and premultiplied
// tally weight eff_w = flying * weight * |d0|, in the plain versions'
// operation order.
template <typename T>
__device__ __forceinline__ T walk_eff_weight(T dx, T dy, T dz,
                                             signed char fly, T w) {
  const T seg = sqrt(dx * dx + dy * dy + dz * dz);
  return fly ? w * seg : T(0);
}
