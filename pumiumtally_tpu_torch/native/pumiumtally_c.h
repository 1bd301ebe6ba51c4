/* C ABI for the PyTorch/CUDA tally engine (pumiumtally_tpu_torch).
 *
 * Mirrors the reference's public facade protocol (reference
 * src/pumitally/PumiTally.h:34-107): an opaque handle plus the three
 * calls CopyInitialPosition / MoveToNextLocation / WriteTallyResults,
 * all parameters builtin types only (reference PumiTally.h:29-30 pins
 * that design so the physics host app needs no GPU/Python toolchain).
 *
 * The implementation embeds a CPython interpreter hosting the PyTorch
 * engine, whose hand-written CUDA kernels run on the GPU; a host app
 * (e.g. the OpenMC --ohMesh fork, reference README.md:84-104) links
 * this library exactly as it links the reference's libpumitally. The
 * declarations are the JAX package's (native/pumiumtally_c.h), so a
 * host built against that library relinks against this one unchanged.
 */
#ifndef PUMIUMTALLY_C_H
#define PUMIUMTALLY_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct pumiumtally_handle pumiumtally_handle;

/* Create an engine bound to a mesh file (.msh Gmsh ASCII/binary or
 * .osh Omega_h directory; the reference ctor takes its .osh path,
 * PumiTally.h:50). The engine flavor, device and precision are
 * environment-selected so this signature stays builtin-typed:
 * PUMIUMTALLY_ENGINE = mono (default), streaming, partitioned, or
 * streaming_partitioned; PUMIUMTALLY_DEVICE = cuda (default) or cpu;
 * PUMIUMTALLY_DTYPE = float32 (default) or float64; with
 * PUMIUMTALLY_{CHUNK_SIZE,CAPACITY_FACTOR,TOLERANCE,OUTPUT,...} knobs
 * (see pumiumtally_tpu_torch/api/native.py). Without a CUDA device the
 * default refuses rather than run on the CPU.
 * Returns NULL on failure (error printed to stderr). */
pumiumtally_handle* pumiumtally_create(const char* mesh_filename,
                                       int32_t num_particles);

/* Localize particles at sampled source points; positions has
 * 3*num_particles doubles (reference PumiTally.h:66-67). Returns 0 on
 * success. */
int pumiumtally_copy_initial_position(pumiumtally_handle* h,
                                      const double* positions,
                                      int32_t size);

/* Two-phase tracked move (reference PumiTally.h:87-89). flying is
 * ZEROED in place after staging, matching the reference's documented
 * host-side side effect (reference PumiTallyImpl.cpp:169-172). The
 * buffers are staged before the call returns, so the host may refill
 * them at once. Returns 0 on success. */
int pumiumtally_move_to_next_location(pumiumtally_handle* h,
                                      const double* origins,
                                      const double* destinations,
                                      int8_t* flying,
                                      const double* weights,
                                      int32_t size);

/* Continue-mode move (an extension of the reference's protocol):
 * transport straight from the committed positions — valid whenever no
 * particle was resampled since the last move. Halves staging and
 * device work versus the two-phase call. flying may be NULL (everyone
 * flies; no zeroing side effect) and weights may be NULL (unit
 * weights). Returns 0 on success. */
int pumiumtally_move_continue(pumiumtally_handle* h,
                              const double* destinations,
                              int8_t* flying,
                              const double* weights,
                              int32_t size);

/* Normalize by element volume and write the VTK file (reference
 * PumiTally.h:94-95; hard-default name fluxresult.vtk). Pass NULL for
 * the default filename. Returns 0 on success. */
int pumiumtally_write_tally_results(pumiumtally_handle* h,
                                    const char* filename);

/* Copy the current per-element flux into out[nelems]; returns the
 * element count (or <0 on error) so hosts can size the buffer with
 * out=NULL first. */
int64_t pumiumtally_get_flux(pumiumtally_handle* h, double* out,
                             int64_t capacity);

/* Copy the committed particle positions into out[3*num_particles];
 * returns the value count 3*num_particles (or <0 on error). */
int64_t pumiumtally_get_positions(pumiumtally_handle* h, double* out,
                                  int64_t capacity);

/* Copy the current element id of each particle into
 * out[num_particles]; returns num_particles (or <0 on error). */
int64_t pumiumtally_get_elem_ids(pumiumtally_handle* h, int32_t* out,
                                 int64_t capacity);

void pumiumtally_destroy(pumiumtally_handle* h);

#ifdef __cplusplus
}
#endif

#endif /* PUMIUMTALLY_C_H */
