/* Minimal physics-host stand-in: drives the tally engine through the C
 * ABI exactly as the OpenMC fork drives the reference (ctor →
 * CopyInitialPosition → MoveToNextLocation* → WriteTallyResults;
 * reference images/public_methods_explanation.svg call sites, SURVEY.md
 * §1). Pure C++ — proves a host app needs no Python/CUDA toolchain.
 *
 * Usage: demo <mesh.msh> [num_particles]
 */
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "PumiumTally.hpp"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <mesh.msh> [num_particles]\n", argv[0]);
    return 2;
  }
  const char* mesh = argv[1];
  int32_t n = argc > 2 ? std::atoi(argv[2]) : 1000;

  pumiumtally::PumiTally tally(mesh, n);

  std::vector<double> pos(3 * n);
  for (int32_t i = 0; i < n; ++i) {
    pos[3 * i + 0] = 0.1 + 0.8 * (double)i / n;
    pos[3 * i + 1] = 0.4;
    pos[3 * i + 2] = 0.5;
  }
  tally.CopyInitialPosition(pos.data(), 3 * n);

  std::vector<double> dest(3 * n);
  std::vector<int8_t> flying(n, 1);
  std::vector<double> weights(n, 1.0);
  for (int32_t i = 0; i < n; ++i) {
    dest[3 * i + 0] = pos[3 * i + 0];
    dest[3 * i + 1] = pos[3 * i + 1] + 0.3;
    dest[3 * i + 2] = pos[3 * i + 2];
  }
  tally.MoveToNextLocation(pos.data(), dest.data(), flying.data(),
                           weights.data(), 3 * n);
  for (int32_t i = 0; i < n; ++i) {
    if (flying[i] != 0) {
      std::fprintf(stderr, "FAIL: flying[] not zeroed in place\n");
      return 1;
    }
  }

  int64_t ne = tally.GetFlux(nullptr, 0);
  std::vector<double> flux((size_t)ne);
  tally.GetFlux(flux.data(), ne);
  double total = 0.0;
  for (double f : flux) total += f;
  /* every particle flies 0.3 inside the box → sum(flux) = 0.3 * n */
  double expect = 0.3 * n;
  if (total < expect - 1e-6 || total > expect + 1e-6) {
    std::fprintf(stderr, "FAIL: sum(flux)=%.9f expected %.9f\n", total,
                 expect);
    return 1;
  }
  tally.WriteTallyResults("demo_fluxresult.vtk");
  std::printf("demo OK: %lld elements, sum(flux)=%.9f\n", (long long)ne,
              total);
  return 0;
}
