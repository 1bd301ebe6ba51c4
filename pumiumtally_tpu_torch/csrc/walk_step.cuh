// One crossing of the fixed-ray tet walk, shared by the walk kernels
// (walk.cu, block_walk.cu, resident_walk.cu), the packed row's 16-byte
// loaders, and the scoring commit, one crossing's scoring lanes (walk.cu,
// twotier_block_walk.cu). Templated on (or overloaded for) float / double.
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

// N consecutive lanes into registers with 16-byte loads (N / 4 float4
// in f32, N / 2 double2 in f64); `p` is 16 B aligned, in global memory
// (W0) or shared memory (W1).
template <int N>
__device__ __forceinline__ void walk_load_lanes(const float* p,
                                                float (&r)[N]) {
  static_assert(N % 4 == 0, "whole float4 words");
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 v = q[k];
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void walk_load_lanes(const double* p,
                                                double (&r)[N]) {
  static_assert(N % 2 == 0, "whole double2 words");
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const double2 v = q[k];
    r[2 * k] = v.x;
    r[2 * k + 1] = v.y;
  }
}

// One packed row into registers with 16-byte loads (5 x float4 in f32,
// 10 x double2 in f64); rows are 80 / 160 B and 16 B aligned.
template <typename T>
__device__ __forceinline__ void walk_load_row(const T* row,
                                              T (&r)[WALK_TABLE_WIDTH]) {
  walk_load_lanes<WALK_TABLE_WIDTH>(row, r);
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

// Score k's value at one crossing (the JAX `score_pair`): c * fac[k] for a
// "track" score (c is the flux lane's own (s_new - s) * eff_w) or fac[k]
// for a "count" score (bit k of `kinds`) when the step crossed a face; 0
// for k >= nscores.
template <typename T>
__device__ __forceinline__ T score_value(int k, int nscores, int kinds, T c,
                                         bool crossed, const T (&fac)[3]) {
  if (k >= nscores) return T(0);
  return (kinds >> k) & 1 ? (crossed ? fac[k] : T(0)) : c * fac[k];
}

// The scoring commit: one crossing's `nscores` <= 3 values added into
// lanes row[off + k] of the element's row [row, row + stride). The caller
// has applied the DROP rule (one test a crossing: a valid bin offset puts
// every lane in the row, the sentinel none). A lane whose value is zero
// takes no reduction of its own, and a crossing whose values are all zero
// issues nothing.
//
// float64 has no vector float reduction on sm_90: one scalar atomicAdd a
// lane.
__device__ __forceinline__ void score_lanes(double* row, int stride, int off,
                                            int nscores, int kinds, double c,
                                            bool crossed,
                                            const double (&fac)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double v = score_value(k, nscores, kinds, c, crossed, fac);
    if (v != 0.0) atomicAdd(row + off + k, v);
  }
}

// Lanes q[0], q[1] of an 8-byte-aligned pair, `m` the ones that take a
// value: one v2 reduction for both, else a scalar one.
__device__ __forceinline__ void score_pair_add(float* q, int m, float v0,
                                               float v1) {
  if (m == 3)
    atomicAdd(reinterpret_cast<float2*>(q), make_float2(v0, v1));
  else if (m == 1)
    atomicAdd(q, v0);
  else if (m == 2)
    atomicAdd(q + 1, v1);
}

// float32: the fewest naturally aligned vector reductions (sm_90's
// `red.global.add.v4.f32` / `.v2.f32`, through atomicAdd on float4* /
// float2*) and scalar ones that cover the lanes, each within one 16-byte
// quad, so one 32-byte sector. Alignment comes from the lane's address
// (not from the bin offset: an odd stride changes the parity from row to
// row, and W2 adds its block's slice). A vector's extra lanes add +0.0f
// and stay inside the element's row, so inside the bank and W2's slice
// whatever the stride; a vector reduction is atomic per lane, so a
// padding lane may be one another thread updates. For S = 3 by the first
// lane's place in its quad: 0 or 1, one v4; 2, a v2 and a scalar; 3, a
// scalar and a v2 (1.5 reductions a crossing, not 3). Adding zeros
// changes no sum (the JAX scatter adds its zero entries too).
__device__ __forceinline__ void score_lanes(float* row, int stride, int off,
                                            int nscores, int kinds, float c,
                                            bool crossed,
                                            const float (&fac)[3]) {
  float v[3];
  int need = 0;  // bit k: score k adds a non-zero value
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = score_value(k, nscores, kinds, c, crossed, fac);
    need |= (v[k] != 0.0f) << k;
  }
  if (need == 0) return;
  float* p = row + off;
  const int r =
      static_cast<int>((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
  float* q = p - r;  // the first lane's 16-byte quad; its next is q + 4
  // l[j]: the value at q[j] (score j - r, or padding).
  float l[6];
#pragma unroll
  for (int j = 0; j < 6; ++j)
    l[j] = j == r ? v[0] : j == r + 1 ? v[1] : j == r + 2 ? v[2] : 0.0f;
  const int m = need << r;  // the places q[j] that take a value
  // The places of q[0..3] inside the row: a v4 may cover all four.
  const long long lo = row - q, hi = lo + stride;
  const bool quad_in_row = lo <= 0 && hi >= 4;
  if ((m & 3) && (m & 12) && quad_in_row) {
    atomicAdd(reinterpret_cast<float4*>(q),
              make_float4(l[0], l[1], l[2], l[3]));
  } else {
    score_pair_add(q, m & 3, l[0], l[1]);
    score_pair_add(q + 2, (m >> 2) & 3, l[2], l[3]);
  }
  // The next quad holds at most places 4 and 5 (r <= 3, k <= 2).
  score_pair_add(q + 4, (m >> 4) & 3, l[4], l[5]);
}
