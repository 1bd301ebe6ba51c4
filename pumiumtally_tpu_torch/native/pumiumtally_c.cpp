/* C ABI implementation: embeds CPython hosting the PyTorch tally engine.
 *
 * Native-runtime equivalent of the reference's PIMPL facade
 * (reference src/pumitally/PumiTally.cpp:16-60): the host app sees
 * builtin-typed C calls; device work happens in the embedded
 * interpreter (the port's CUDA kernels on the GPU). Buffers cross the
 * boundary zero-copy as numpy views over the host pointers — the same
 * trick as the reference's unmanaged Kokkos views over OpenMC's arrays
 * (reference PumiTallyImpl.cpp:159-236) — and the facade stages them
 * into its own page-locked buffers before the call returns, so the host
 * may refill them at once. The accessors copy through
 * ``api.native.host_array``, which brings a CUDA tensor to the host
 * before numpy sees it.
 *
 * Interpreter ownership: if the process already runs Python (e.g. a
 * ctypes caller), every call attaches via PyGILState; otherwise the
 * first create initializes an interpreter and keeps it until process
 * exit. Py_Finalize is never called: the CUDA context lives as long as
 * the process.
 *
 * Build-time definitions (native/build.py): PUMIUMTALLY_PYTHON, the
 * interpreter the library was built for (an embedded interpreter takes
 * it as its program name, so it finds that installation's packages),
 * and PUMIUMTALLY_ROOT, the checkout holding pumiumtally_tpu_torch
 * (appended to sys.path when the package is not importable otherwise).
 */
#include "pumiumtally_c.h"

#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#define PY_ARRAY_UNIQUE_SYMBOL pumiumtally_torch_ARRAY_API
#include <numpy/arrayobject.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

const char* kModule = "pumiumtally_tpu_torch.api.native";

/* numpy C-API table is per-shared-object; resolve lazily. */
bool g_numpy_ready = false;
PyObject* g_host_array = nullptr;  // api.native.host_array

bool ensure_numpy() {
  if (g_numpy_ready) return true;
  if (_import_array() < 0) {
    PyErr_Print();
    return false;
  }
  g_numpy_ready = true;
  return true;
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

bool ensure_interpreter() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;  // the host owns its signals
  PyStatus status = PyStatus_Ok();
#ifdef PUMIUMTALLY_PYTHON
  if (!std::getenv("PYTHONHOME")) {
    status = PyConfig_SetBytesString(&config, &config.program_name,
                                     PUMIUMTALLY_PYTHON);
  }
#endif
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "[ERROR] pumiumtally: interpreter start failed: %s\n",
                 status.err_msg ? status.err_msg : "(no message)");
    return false;
  }
  /* Release the GIL acquired by initialization so GilGuard works
   * uniformly afterwards. */
  PyEval_SaveThread();
  return true;
}

int fail_py(const char* what) {
  std::fprintf(stderr, "[ERROR] pumiumtally: %s failed:\n", what);
  PyErr_Print();
  return -1;
}

/* Import the engine module; when the package is not on sys.path,
 * append the checkout the library was built from and try again. */
PyObject* import_native() {
  PyObject* mod = PyImport_ImportModule(kModule);
#ifdef PUMIUMTALLY_ROOT
  if (!mod && PyErr_ExceptionMatches(PyExc_ModuleNotFoundError)) {
    PyErr_Clear();
    PyObject* path = PySys_GetObject("path");  // borrowed
    PyObject* root = PyUnicode_FromString(PUMIUMTALLY_ROOT);
    if (path && root && PyList_Append(path, root) == 0) {
      mod = PyImport_ImportModule(kModule);
    }
    Py_XDECREF(root);
  }
#endif
  return mod;
}

PyObject* np_view_1d(void* data, npy_intp n, int typenum, bool writeable) {
  int flags = NPY_ARRAY_C_CONTIGUOUS | (writeable ? NPY_ARRAY_WRITEABLE : 0);
  return PyArray_New(&PyArray_Type, 1, &n, typenum, nullptr, data, 0, flags,
                     nullptr);
}

}  // namespace

struct pumiumtally_handle {
  PyObject* tally;  // a pumiumtally_tpu_torch facade
  int32_t num_particles;
};

extern "C" {

pumiumtally_handle* pumiumtally_create(const char* mesh_filename,
                                       int32_t num_particles) {
  if (!ensure_interpreter()) return nullptr;
  GilGuard gil;
  if (!ensure_numpy()) return nullptr;

  /* Engine, device and dtype selection is environment-driven so the C
   * signature stays the reference's; see
   * pumiumtally_tpu_torch/api/native.py for the PUMIUMTALLY_* vars. */
  PyObject* mod = import_native();
  if (!mod) {
    fail_py("import pumiumtally_tpu_torch.api.native");
    return nullptr;
  }
  if (!g_host_array) {
    g_host_array = PyObject_GetAttrString(mod, "host_array");
    if (!g_host_array) {
      Py_DECREF(mod);
      fail_py("host_array lookup");
      return nullptr;
    }
  }
  PyObject* factory = PyObject_GetAttrString(mod, "native_create");
  Py_DECREF(mod);
  if (!factory) {
    fail_py("native_create lookup");
    return nullptr;
  }
  PyObject* tally = PyObject_CallFunction(factory, "si", mesh_filename,
                                          (int)num_particles);
  Py_DECREF(factory);
  if (!tally) {
    fail_py("native_create()");
    return nullptr;
  }
  return new pumiumtally_handle{tally, num_particles};
}

int pumiumtally_copy_initial_position(pumiumtally_handle* h,
                                      const double* positions,
                                      int32_t size) {
  if (!h) return -1;
  GilGuard gil;
  PyObject* arr =
      np_view_1d(const_cast<double*>(positions), size, NPY_DOUBLE, false);
  if (!arr) return fail_py("position view");
  PyObject* r = PyObject_CallMethod(h->tally, "CopyInitialPosition", "Oi",
                                    arr, (int)size);
  Py_DECREF(arr);
  if (!r) return fail_py("CopyInitialPosition");
  Py_DECREF(r);
  return 0;
}

namespace {

/* Shared body of the two move entry points. origins may be NULL
 * (continue mode); flying may be NULL (all fly; no zeroing side
 * effect); weights may be NULL (unit weights). A NULL pointer becomes
 * Python None, which the facade's MoveToNextLocation interprets the
 * same way (api/tally.py). */
int do_move(pumiumtally_handle* h, const double* origins,
            const double* destinations, int8_t* flying, const double* weights,
            int32_t size) {
  if (!h) return -1;
  GilGuard gil;
  PyObject* o = origins
                    ? np_view_1d(const_cast<double*>(origins), size,
                                 NPY_DOUBLE, false)
                    : (Py_INCREF(Py_None), Py_None);
  PyObject* d =
      np_view_1d(const_cast<double*>(destinations), size, NPY_DOUBLE, false);
  /* flying is writeable: the facade zeroes it in place (the
   * reference's documented side effect, PumiTallyImpl.cpp:169-172). */
  PyObject* f = flying ? np_view_1d(flying, h->num_particles, NPY_INT8, true)
                       : (Py_INCREF(Py_None), Py_None);
  PyObject* w = weights
                    ? np_view_1d(const_cast<double*>(weights),
                                 h->num_particles, NPY_DOUBLE, false)
                    : (Py_INCREF(Py_None), Py_None);
  if (!o || !d || !f || !w) {
    Py_XDECREF(o);
    Py_XDECREF(d);
    Py_XDECREF(f);
    Py_XDECREF(w);
    return fail_py("buffer views");
  }
  PyObject* r = PyObject_CallMethod(h->tally, "MoveToNextLocation", "OOOOi",
                                    o, d, f, w, (int)size);
  Py_DECREF(o);
  Py_DECREF(d);
  Py_DECREF(f);
  Py_DECREF(w);
  if (!r) return fail_py("MoveToNextLocation");
  Py_DECREF(r);
  return 0;
}

/* Copy a 1-D attribute of the tally into out through host_array. */
int64_t copy_attr(pumiumtally_handle* h, const char* attr, const char* dtype,
                  void* out, int64_t capacity, size_t elem_size) {
  GilGuard gil;
  PyObject* arr =
      PyObject_CallFunction(g_host_array, "Oss", h->tally, attr, dtype);
  if (!arr) return fail_py(attr);
  if (!PyArray_Check(arr)) {
    Py_DECREF(arr);
    std::fprintf(stderr, "[ERROR] pumiumtally: host_array(%s) returned no "
                 "ndarray\n", attr);
    return -1;
  }
  auto* a = reinterpret_cast<PyArrayObject*>(arr);
  int64_t n = (int64_t)PyArray_SIZE(a);
  if (out && capacity >= n) {
    std::memcpy(out, PyArray_DATA(a), (size_t)n * elem_size);
  }
  Py_DECREF(arr);
  return n;
}

}  // namespace

int pumiumtally_move_to_next_location(pumiumtally_handle* h,
                                      const double* origins,
                                      const double* destinations,
                                      int8_t* flying,
                                      const double* weights,
                                      int32_t size) {
  return do_move(h, origins, destinations, flying, weights, size);
}

int pumiumtally_move_continue(pumiumtally_handle* h,
                              const double* destinations,
                              int8_t* flying,
                              const double* weights,
                              int32_t size) {
  /* origins=NULL selects the continue-mode fast path (api/tally.py). */
  return do_move(h, nullptr, destinations, flying, weights, size);
}

int pumiumtally_write_tally_results(pumiumtally_handle* h,
                                    const char* filename) {
  if (!h) return -1;
  GilGuard gil;
  PyObject* r;
  if (filename) {
    r = PyObject_CallMethod(h->tally, "WriteTallyResults", "s", filename);
  } else {
    r = PyObject_CallMethod(h->tally, "WriteTallyResults", nullptr);
  }
  if (!r) return fail_py("WriteTallyResults");
  Py_DECREF(r);
  return 0;
}

int64_t pumiumtally_get_flux(pumiumtally_handle* h, double* out,
                             int64_t capacity) {
  if (!h) return -1;
  return copy_attr(h, "flux", "float64", out, capacity, sizeof(double));
}

int64_t pumiumtally_get_positions(pumiumtally_handle* h, double* out,
                                  int64_t capacity) {
  if (!h) return -1;
  return copy_attr(h, "positions", "float64", out, capacity, sizeof(double));
}

int64_t pumiumtally_get_elem_ids(pumiumtally_handle* h, int32_t* out,
                                 int64_t capacity) {
  if (!h) return -1;
  return copy_attr(h, "elem_ids", "int32", out, capacity, sizeof(int32_t));
}

void pumiumtally_destroy(pumiumtally_handle* h) {
  if (!h) return;
  {
    GilGuard gil;
    Py_DECREF(h->tally);
  }
  delete h;
}

}  // extern "C"
