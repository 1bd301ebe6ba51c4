// One two-tier crossing of the fixed-ray tet walk, shared by W0's
// two-tier variant (walk.cu) and W2 (twotier_block_walk.cu). Templated
// on float / double; the select rows are bf16 either way.
//
// SELECT: the tet's bf16 row [16] = 4 face normals | 4 plane offsets,
// lifted exactly to the working type (bf16 is a truncated float: shift
// the 16 bits up). Each face's candidate s_f is computed as in
// walk_step.cuh (a = n.d0, b = off - n.dest + a, crossing iff
// a * (1 - s) > tol, s_f = b / a, clamped to s_f >= s) and the FIRST
// minimal face wins (argmin's tie rule; a candidate rounded behind s
// clamps to s and wins, and the refinement recomputes its true
// crossing).
// REFINE: the winning face's full-precision row [5] = (nx, ny, nz, off,
// adj) re-solves the crossing the same way. A face that is no longer a
// genuine forward crossing keeps the bf16 candidate; an infinite
// candidate (no face ahead) stays infinite so that "reached" fires. The
// neighbour comes from the row's adj lane (a float holding an exact
// id; -1 boundary, <= -2 a neighbour in another block).
//
// Sources: pumiumtally_tpu/ops/walk.py select_rows_lo (:321) and
// refine_plane_hi (:371). The plain PyTorch versions
// (pumiumtally_tpu_torch/ops/walk.py select_rows_lo, refine_plane_hi)
// run these operations in this order, so with --fmad=false the
// kernels round exactly as they do.

#pragma once

#include <stdint.h>

#include "walk_step.cuh"

#define WALK_TABLE_LO_WIDTH 16
#define WALK_TABLE_LO_OFFSETS 12
#define WALK_PLANE_WIDTH 5

// The 16 bf16 values of a select row, lifted to float. The row is 32 B
// and 32 B aligned (the tables start on allocation boundaries), read as
// two 16 B words from global or shared memory.
__device__ __forceinline__ void twotier_load_lo(const uint16_t* row,
                                                float v[16]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
  const uint4 q0 = p[0], q1 = p[1];
  const uint32_t w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);  // low half: element 2k
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Select the exit face from the lifted row: returns the candidate
// minimum, the face through `f_exit`.
template <typename T>
__device__ __forceinline__ T twotier_select(const float v[16], T s, T dx,
                                            T dy, T dz, T px, T py, T pz,
                                            T tol, int* f_exit) {
  const T one = T(1);
  T s_sel = walk_inf<T>();
  int f_best = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const T nx = T(v[3 * f]), ny = T(v[3 * f + 1]), nz = T(v[3 * f + 2]);
    const T a = nx * dx + ny * dy + nz * dz;
    const T n_dest = nx * px + ny * py + nz * pz;
    const T b = T(v[WALK_TABLE_LO_OFFSETS + f]) - n_dest + a;
    const bool crossing = a * (one - s) > tol;
    T s_f = crossing ? b / a : walk_inf<T>();
    s_f = s_f > s ? s_f : s;
    if (f == 0 || s_f < s_sel) {
      s_sel = s_f;
      f_best = f;
    }
  }
  *f_exit = f_best;
  return s_sel;
}

// Refine the winning face from its plane row: returns s_exit (not yet
// clamped to 1), the neighbour through `next`.
template <typename T>
__device__ __forceinline__ T twotier_refine(const T* __restrict__ plane,
                                            T s, T s_sel, T dx, T dy, T dz,
                                            T px, T py, T pz, T tol,
                                            int* next) {
  const T one = T(1);
  const T nx = plane[0], ny = plane[1], nz = plane[2];
  const T a = nx * dx + ny * dy + nz * dz;
  const T n_dest = nx * px + ny * py + nz * pz;
  const T b = plane[3] - n_dest + a;
  const bool genuine = a * (one - s) > tol;
  T s_ref = genuine ? b / a : s_sel;
  s_ref = s_ref > s ? s_ref : s;
  *next = static_cast<int>(plane[4]);
  return isinf(s_sel) ? s_sel : s_ref;
}

// A whole two-tier crossing of the tet `e`: select from `lo_row`, refine
// from the tier row `hi + (e*4 + f) * 5`. Returns the new coordinate (1
// when the destination lies inside the tet), the neighbour through
// `next`.
template <typename T>
__device__ __forceinline__ T twotier_step(const uint16_t* lo_row,
                                          const T* __restrict__ hi, int e,
                                          T s, T dx, T dy, T dz, T px, T py,
                                          T pz, T tol, int* next,
                                          bool* reached) {
  float v[16];
  twotier_load_lo(lo_row, v);
  int f;
  const T s_sel = twotier_select(v, s, dx, dy, dz, px, py, pz, tol, &f);
  const T s_exit = twotier_refine(
      hi + ((size_t)e * 4 + f) * WALK_PLANE_WIDTH, s, s_sel, dx, dy, dz, px,
      py, pz, tol, next);
  *reached = s_exit >= T(1);
  return *reached ? T(1) : s_exit;
}
