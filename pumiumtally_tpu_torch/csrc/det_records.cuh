// The deterministic commit's records, written by the tallying walks W0
// (walk.cu) and W4 (gather_block_walk.cu) in their kDet instantiations
// in place of the flux and scoring-lane atomics, and reduced in a fixed
// order by det_commit.cu.
//
// A record is (key, ord, val): the index of the bank entry the
// contribution adds into (the flux's element, W4's block-padded row, or
// a scoring lane), the order key (the crossing's step in this walk
// call, then the particle: W0's particle index, W4's place in its work
// list, or its slot without a list) and the value. The commit adds each
// bank entry's records in ord order onto its standing value: the order
// in which the plain versions' serial index_add_ commits them
// (ops/walk.py walk_plain, parallel/partition.py _walk_loop), so the
// flux and the lanes equal the plain versions' bitwise.
//
// A stream of records is three arrays of `cap` entries and a 64-bit
// counter. Each warp's lanes that emit take consecutive places with one
// atomic on the counter; a place at or past `cap` is not written, and
// the counter still counts it, so the caller sees the overflow and
// walks again with room enough (ops/det_commit.py).

#pragma once

#include <cooperative_groups.h>

#include "walk_step.cuh"

template <typename T>
struct DetStream {
  int* key;
  long long* ord;
  T* val;
  unsigned long long* count;
  long long cap;
};

// The two streams of a tallying walk: flux and scoring lanes.
template <typename T>
struct DetArgs {
  DetStream<T> flux, lanes;
};

// The host's description of both streams (ops/det_commit.py
// `det_host_args`): key, ord, val, count, cap for the flux, then the
// same for the lanes; a stream the walk does not use has null arrays.
template <typename T>
static DetArgs<T> det_args(const long long* h) {
  DetArgs<T> d;
  DetStream<T>* s[2] = {&d.flux, &d.lanes};
  for (int j = 0; j < 2; ++j) {
    const long long* q = h + 5 * j;
    s[j]->key = reinterpret_cast<int*>(q[0]);
    s[j]->ord = reinterpret_cast<long long*>(q[1]);
    s[j]->val = reinterpret_cast<T*>(q[2]);
    s[j]->count = reinterpret_cast<unsigned long long*>(q[3]);
    s[j]->cap = q[4];
  }
  return d;
}

// The order key of a crossing: its step in the walk call, then the
// particle, so that records sort as the plain versions commit them.
__device__ __forceinline__ long long det_ord(int step, int pid) {
  return (static_cast<long long>(step) << 32) |
         static_cast<long long>(static_cast<unsigned>(pid));
}

// One record into stream `d`, its place taken with the other lanes that
// emit here (one counter atomic a warp).
template <typename T>
__device__ __forceinline__ void det_emit(const DetStream<T>& d, int key,
                                         long long ord, T v) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  unsigned long long base = 0;
  if (g.thread_rank() == 0)
    base = atomicAdd(d.count, static_cast<unsigned long long>(g.size()));
  base = g.shfl(base, 0);
  const unsigned long long at = base + g.thread_rank();
  if (at < static_cast<unsigned long long>(d.cap)) {
    d.key[at] = key;
    d.ord[at] = ord;
    d.val[at] = v;
  }
}

// A crossing's scoring lanes as records: score k's value (score_value,
// walk_step.cuh) into lane `lane0 + k` when it is not zero, as
// score_lanes adds it. The caller has applied the DROP rule.
template <typename T>
__device__ __forceinline__ void det_score_lanes(const DetStream<T>& d,
                                                long long lane0, int nscores,
                                                int kinds, T c, bool crossed,
                                                const T (&fac)[3],
                                                long long ord) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T v = score_value(k, nscores, kinds, c, crossed, fac);
    if (v != T(0)) det_emit(d, static_cast<int>(lane0 + k), ord, v);
  }
}
