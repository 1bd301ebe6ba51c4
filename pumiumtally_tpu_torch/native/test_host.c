/* Oracle-grade C-ABI end-to-end test: a pure-C host drives the 6-tet
 * unit cube through the port's libpumiumtally_c.so with the reference white-box
 * test's EXACT 5-particle trajectories
 * (test/test_pumi_tally_impl_methods.cpp, hand-computed expectations
 * recorded in BASELINE.md and tests/test_walk_oracle.py) and asserts
 * every observable to the reference's 1e-8 comparison tolerance:
 *
 *   - localization at (0.1,0.4,0.5): all particles in element 2,
 *     flux identically zero;
 *   - move 1 to (1.2,0.4,0.5): crosses elements 2,3,4 with track
 *     lengths 0.3/0.1/0.5 each => flux[2,3,4] = 1.5/0.5/2.5, flying
 *     zeroed in place across the C boundary, positions clamped to the
 *     x=1.0 boundary, all particles in element 4;
 *   - move 2 (mixed flying/weights): flux[3] += 0.08790490988459178*2,
 *     flux[4] += 0.879049070406094*2 + 0.552268050859363*0.5, final
 *     elements {3,4,4,4,4}.
 *
 * Exits nonzero on ANY mismatch — this is the host-app-eye view of
 * the whole stack (C ABI -> embedded interpreter -> engine -> CUDA
 * kernels, or their plain versions with PUMIUMTALLY_DEVICE=cpu), so a
 * silent numerical regression cannot hide behind a green Python tier.
 * "--corrupt" perturbs one expected value by 1e-3 and demands the
 * harness FAIL, proving the assertions are live
 * (tests/test_torch_native.py and chip_smoke.py run both directions).
 * The 1e-8 oracle needs PUMIUMTALLY_DTYPE=float64.
 *
 * Usage: test_host <mesh.msh> [--corrupt]
 */
#include <math.h>
#include <stdio.h>
#include <string.h>

#include "pumiumtally_c.h"

#define NUM 5
#define NELEMS 6
#define TOL 1e-8 /* reference test:21-27 */

static int g_failures = 0;

static void check_close(const char* what, double got, double want,
                        double tol) {
  if (!(fabs(got - want) <= tol)) {
    fprintf(stderr, "MISMATCH %s: got %.17g want %.17g (tol %g)\n", what,
            got, want, tol);
    g_failures++;
  }
}

static void check_eq_i(const char* what, long got, long want) {
  if (got != want) {
    fprintf(stderr, "MISMATCH %s: got %ld want %ld\n", what, got, want);
    g_failures++;
  }
}

static void fill3(double* buf, double x, double y, double z) {
  for (int i = 0; i < NUM; ++i) {
    buf[3 * i + 0] = x;
    buf[3 * i + 1] = y;
    buf[3 * i + 2] = z;
  }
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <mesh.msh> [--corrupt]\n", argv[0]);
    return 2;
  }
  int corrupt = argc > 2 && strcmp(argv[2], "--corrupt") == 0;

  pumiumtally_handle* h = pumiumtally_create(argv[1], NUM);
  if (!h) {
    fprintf(stderr, "FAILURE: pumiumtally_create returned NULL\n");
    return 1;
  }

  double init[3 * NUM];
  fill3(init, 0.1, 0.4, 0.5);
  if (pumiumtally_copy_initial_position(h, init, 3 * NUM) != 0) {
    fprintf(stderr, "FAILURE: copy_initial_position rc != 0\n");
    pumiumtally_destroy(h);
    return 1;
  }

  /* -- localization oracle: element 2, zero flux ------------------- */
  int32_t eids[NUM];
  check_eq_i("get_elem_ids count", pumiumtally_get_elem_ids(h, eids, NUM),
             NUM);
  for (int i = 0; i < NUM; ++i)
    check_eq_i("localized element", eids[i], 2);
  double flux[NELEMS];
  check_eq_i("get_flux count", pumiumtally_get_flux(h, flux, NELEMS),
             NELEMS);
  for (int e = 0; e < NELEMS; ++e)
    check_close("initial flux", flux[e], 0.0, TOL);

  /* -- move 1: ray to (1.2,0.4,0.5), exits at x=1.0 ---------------- */
  double dests[3 * NUM];
  fill3(dests, 1.2, 0.4, 0.5);
  int8_t flying[NUM];
  double weights[NUM];
  for (int i = 0; i < NUM; ++i) {
    flying[i] = 1;
    weights[i] = 1.0;
  }
  if (pumiumtally_move_to_next_location(h, init, dests, flying, weights,
                                        3 * NUM) != 0) {
    fprintf(stderr, "FAILURE: move_to_next_location(1) rc != 0\n");
    pumiumtally_destroy(h);
    return 1;
  }
  for (int i = 0; i < NUM; ++i) /* in-place zeroing crossed the ABI */
    check_eq_i("flying zeroed", flying[i], 0);

  double expect1[NELEMS] = {0.0, 0.0, 0.3 * NUM, 0.1 * NUM, 0.5 * NUM,
                            0.0};
  if (corrupt) expect1[2] += 1e-3; /* prove the harness can fail */
  pumiumtally_get_flux(h, flux, NELEMS);
  for (int e = 0; e < NELEMS; ++e)
    check_close("move-1 flux", flux[e], expect1[e], TOL);

  double pos[3 * NUM];
  check_eq_i("get_positions count",
             pumiumtally_get_positions(h, pos, 3 * NUM), 3 * NUM);
  for (int i = 0; i < NUM; ++i) {
    check_close("clamped x", pos[3 * i + 0], 1.0, TOL);
    check_close("clamped y", pos[3 * i + 1], 0.4, TOL);
    check_close("clamped z", pos[3 * i + 2], 0.5, TOL);
  }
  pumiumtally_get_elem_ids(h, eids, NUM);
  for (int i = 0; i < NUM; ++i)
    check_eq_i("move-1 element", eids[i], 4);

  /* -- move 2: mixed flying/weights (reference test:284-390) ------- */
  double origins2[3 * NUM]; /* committed positions (production contract) */
  fill3(origins2, 1.0, 0.4, 0.5);
  double dests2[3 * NUM];
  fill3(dests2, 1.0, 0.4, 0.5);
  int8_t flying2[NUM] = {0, 0, 0, 0, 0};
  double weights2[NUM] = {1.0, 1.0, 1.0, 1.0, 1.0};
  dests2[0] = 0.15;
  dests2[1] = 0.05;
  dests2[2] = 0.20;
  flying2[0] = 1;
  weights2[0] = 2.0;
  dests2[6] = 0.85;
  dests2[7] = 0.05;
  dests2[8] = 0.10;
  flying2[2] = 1;
  weights2[2] = 0.5;
  if (pumiumtally_move_to_next_location(h, origins2, dests2, flying2,
                                        weights2, 3 * NUM) != 0) {
    fprintf(stderr, "FAILURE: move_to_next_location(2) rc != 0\n");
    pumiumtally_destroy(h);
    return 1;
  }

  double expect2[NELEMS];
  memcpy(expect2, expect1, sizeof(expect2));
  if (corrupt) expect2[2] -= 1e-3; /* move-2 increments checked alone */
  expect2[3] += 0.08790490988459178 * 2.0;
  expect2[4] += 0.879049070406094 * 2.0 + 0.552268050859363 * 0.5;
  if (corrupt) expect2[4] += 1e-3;
  pumiumtally_get_flux(h, flux, NELEMS);
  for (int e = 0; e < NELEMS; ++e)
    check_close("move-2 flux", flux[e], expect2[e], TOL);

  int32_t expect_eids[NUM] = {3, 4, 4, 4, 4};
  pumiumtally_get_elem_ids(h, eids, NUM);
  for (int i = 0; i < NUM; ++i)
    check_eq_i("move-2 element", eids[i], expect_eids[i]);
  pumiumtally_get_positions(h, pos, 3 * NUM);
  for (int i = 0; i < 3 * NUM; ++i)
    check_close("move-2 position", pos[i], dests2[i], TOL);

  pumiumtally_destroy(h);
  if (g_failures) {
    fprintf(stderr, "FAILURE: %d oracle mismatches\n", g_failures);
    return 1;
  }
  printf("test_host OK\n");
  return 0;
}
