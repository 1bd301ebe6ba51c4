/* C++ convenience facade over the C ABI — the drop-in analogue of the
 * reference's PIMPL class (reference src/pumitally/PumiTally.h:34-107):
 * same three-call protocol, builtin-typed parameters, RAII lifetime.
 * Header-only so host apps need only link libpumiumtally_c (the port's
 * build: pumiumtally_tpu_torch/native/build.py).
 */
#ifndef PUMIUMTALLY_HPP
#define PUMIUMTALLY_HPP

#include <stdexcept>
#include <string>

#include "pumiumtally_c.h"

namespace pumiumtally {

class PumiTally {
 public:
  PumiTally(const std::string& mesh_filename, int32_t num_particles)
      : h_(pumiumtally_create(mesh_filename.c_str(), num_particles)) {
    if (!h_) throw std::runtime_error("pumiumtally_create failed");
  }
  PumiTally(const PumiTally&) = delete;
  PumiTally& operator=(const PumiTally&) = delete;
  ~PumiTally() { pumiumtally_destroy(h_); }

  /* reference PumiTally.h:66-67 */
  void CopyInitialPosition(const double* positions, int32_t size) {
    check(pumiumtally_copy_initial_position(h_, positions, size),
          "CopyInitialPosition");
  }

  /* reference PumiTally.h:87-89; flying is zeroed in place */
  void MoveToNextLocation(const double* origins, const double* destinations,
                          int8_t* flying, const double* weights,
                          int32_t size) {
    check(pumiumtally_move_to_next_location(h_, origins, destinations,
                                            flying, weights, size),
          "MoveToNextLocation");
  }

  /* Continue-mode fast path (an extension of the reference's protocol): transport from the
   * committed positions; flying/weights may be nullptr (all fly / unit
   * weights). */
  void MoveContinue(const double* destinations, int8_t* flying,
                    const double* weights, int32_t size) {
    check(pumiumtally_move_continue(h_, destinations, flying, weights, size),
          "MoveContinue");
  }

  /* reference PumiTally.h:94-95 */
  void WriteTallyResults(const char* filename = nullptr) {
    check(pumiumtally_write_tally_results(h_, filename), "WriteTallyResults");
  }

  int64_t GetFlux(double* out, int64_t capacity) {
    return pumiumtally_get_flux(h_, out, capacity);
  }

  int64_t GetPositions(double* out, int64_t capacity) {
    return pumiumtally_get_positions(h_, out, capacity);
  }

  int64_t GetElemIds(int32_t* out, int64_t capacity) {
    return pumiumtally_get_elem_ids(h_, out, capacity);
  }

 private:
  static void check(int rc, const char* what) {
    if (rc != 0) {
      throw std::runtime_error(std::string("pumiumtally ") + what +
                               " failed");
    }
  }
  pumiumtally_handle* h_;
};

}  // namespace pumiumtally

#endif /* PUMIUMTALLY_HPP */
