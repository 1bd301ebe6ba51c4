/* Native-path benchmark host: drives the full two-phase protocol
 * through the C ABI (embedded-interpreter boundary) on the SAME
 * workload shape as the Python facade's benchmark (chip_smoke.py's
 * phase 16 drives both), so the per-call cost of the native facade can
 * be compared against the pure-Python facade (the reference's physics
 * host pays this boundary on every call, reference PumiTally.cpp:16-60).
 *
 * Prints one line:  native_two_phase_moves_per_sec=<rate>
 *
 * Usage: bench_host <mesh file> [num_particles] [moves]
 */
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

#include "pumiumtally_c.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <mesh> [n] [moves]\n", argv[0]);
    return 2;
  }
  const char* mesh = argv[1];
  const int32_t n = argc > 2 ? std::atoi(argv[2]) : 500000;
  const int moves = argc > 3 ? std::atoi(argv[3]) : 6;

  pumiumtally_handle* h = pumiumtally_create(mesh, n);
  if (!h) return 1;

  /* bench.py's make_trajectory shape: uniform interior source, then
   * clipped gaussian steps of mean length 0.25 (statistically — not
   * bitwise — the Python facade's workload). */
  std::mt19937_64 rng(0);
  std::uniform_real_distribution<double> uni(0.05, 0.95);
  std::normal_distribution<double> step(0.0, 0.25 / std::sqrt(3.0));
  std::vector<std::vector<double>> pts(moves + 2,
                                       std::vector<double>(3 * (size_t)n));
  for (int32_t i = 0; i < 3 * n; ++i) pts[0][i] = uni(rng);
  for (int m = 1; m < moves + 2; ++m)
    for (int32_t i = 0; i < 3 * n; ++i) {
      double v = pts[m - 1][i] + step(rng);
      pts[m][i] = v < 0.02 ? 0.02 : (v > 0.98 ? 0.98 : v);
    }

  if (pumiumtally_copy_initial_position(h, pts[0].data(), 3 * n)) return 1;

  std::vector<int8_t> flying((size_t)n);
  std::vector<double> weights((size_t)n, 1.0);
  auto drive = [&](int m) {
    std::fill(flying.begin(), flying.end(), (int8_t)1);
    return pumiumtally_move_to_next_location(
        h, pts[m - 1].data(), pts[m].data(), flying.data(), weights.data(),
        3 * n);
  };

  if (drive(1)) return 1; /* warmup: compiles the kernels */
  /* a flux fetch is the real sync on a lazy backend */
  std::vector<double> flux;
  int64_t ne = pumiumtally_get_flux(h, nullptr, 0);
  if (ne < 0) return 1;
  flux.resize((size_t)ne);
  pumiumtally_get_flux(h, flux.data(), ne);

  auto t0 = std::chrono::steady_clock::now();
  for (int m = 2; m < moves + 2; ++m)
    if (drive(m)) return 1;
  pumiumtally_get_flux(h, flux.data(), ne); /* sync */
  double dt = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();

  double total = 0.0;
  for (double f : flux) total += f;
  std::printf("native_two_phase_moves_per_sec=%.0f (sum normflux %.4f, "
              "%d moves of %d particles in %.3f s)\n",
              (double)n * moves / dt, total, moves, n, dt);
  pumiumtally_destroy(h);
  return 0;
}
