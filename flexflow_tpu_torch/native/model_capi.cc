/* Flat C model-building API of flexflow_tpu_torch, backed by the
 * embedded CPython runtime.
 *
 * The PyTorch port's copy of native/src/model_capi.cc, with the same ABI
 * (native/include/flexflow_tpu_c.h): the surface embeds the interpreter
 * (Py_InitializeEx) and drives flexflow_tpu_torch.capi_host instead of
 * the JAX package's module; the enum integer arguments keep the
 * reference's ffconst values, so a C program written against them runs
 * unchanged on either library. flexflow_tpu_torch/native_bridge.py builds
 * it at first use (build_capi) into flexflow_tpu_torch/_native_build/.
 *
 * Requirements: flexflow_tpu_torch must be importable in the embedded
 * interpreter (set PYTHONPATH before fftpu_runtime_init); the model runs
 * on the card unless FLEXFLOW_TPU_DEVICE=cpu.
 *
 * Thread-safety: every entry point takes the GIL (PyGILState_Ensure),
 * so the surface may be called from any host thread. Handles are owned
 * PyObject references; release them with fftpu_model_destroy /
 * fftpu_tensor_destroy.
 */

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <mutex>

extern "C" {

typedef void *fftpu_model;
typedef void *fftpu_tensor;

static PyObject *g_host = nullptr; /* flexflow_tpu_torch.capi_host module */
static char g_err[1024];
static bool g_we_initialized = false;

static void set_err_from_python(void) {
  PyObject *t = nullptr, *v = nullptr, *tb = nullptr;
  PyErr_Fetch(&t, &v, &tb);
  PyErr_NormalizeException(&t, &v, &tb);
  if (v != nullptr) {
    PyObject *s = PyObject_Str(v);
    if (s != nullptr) {
      char const *c = PyUnicode_AsUTF8(s);
      std::snprintf(g_err, sizeof(g_err), "%s", c ? c : "unknown error");
      Py_DECREF(s);
    }
  }
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
}

char const *fftpu_last_error(void) { return g_err; }

/* Initialize the embedded runtime (idempotent; safe when the host
 * process already runs Python — e.g. a ctypes consumer). Returns 0.
 * A mutex serializes the check-then-init so concurrent first calls from
 * different host threads cannot race Py_InitializeEx / the module
 * import (after init, the GIL serializes everything else). */
int fftpu_runtime_init(void) {
  static std::mutex init_mu;
  std::lock_guard<std::mutex> lock(init_mu);
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    /* release the GIL the init left with the main thread, so every
     * entry point can PyGILState_Ensure from any host thread */
    PyEval_SaveThread();
  }
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = 0;
  if (g_host == nullptr) {
    g_host = PyImport_ImportModule("flexflow_tpu_torch.capi_host");
    if (g_host == nullptr) {
      set_err_from_python();
      rc = -1;
    }
  }
  PyGILState_Release(st);
  return rc;
}

void fftpu_runtime_finalize(void) {
  if (g_host != nullptr && Py_IsInitialized()) {
    PyGILState_STATE st = PyGILState_Ensure();
    Py_CLEAR(g_host);
    PyGILState_Release(st);
  }
  /* Py_Finalize is deliberately NOT called: torch's background threads
   * do not survive interpreter teardown; the reference likewise leaves
   * runtime shutdown to process exit. */
  (void)g_we_initialized;
}

/* call a helper with the GIL HELD; steals args; returns new ref/null */
static PyObject *call_locked(char const *fn, PyObject *args) {
  PyObject *out = nullptr;
  if (args != nullptr) {
    PyObject *f = PyObject_GetAttrString(g_host, fn);
    if (f != nullptr) {
      out = PyObject_CallObject(f, args);
      Py_DECREF(f);
    }
  }
  if (out == nullptr) {
    set_err_from_python();
  }
  Py_XDECREF(args);
  return out;
}

/* ensure runtime, take GIL; returns false when init failed */
static bool enter(PyGILState_STATE *st) {
  if (g_host == nullptr && fftpu_runtime_init() != 0) {
    return false;
  }
  *st = PyGILState_Ensure();
  return true;
}

static PyObject *dims_tuple(int64_t const *dims, int32_t ndim) {
  PyObject *t = PyTuple_New(ndim);
  for (int32_t i = 0; i < ndim; i++) {
    PyTuple_SET_ITEM(t, i, PyLong_FromLongLong(dims[i]));
  }
  return t;
}

static int64_t numel(int64_t const *dims, int32_t ndim) {
  int64_t n = 1;
  for (int32_t i = 0; i < ndim; i++) {
    n *= dims[i];
  }
  return n;
}

fftpu_model fftpu_model_create(int32_t batch_size, int32_t epochs,
                               int32_t num_devices,
                               int32_t only_data_parallel,
                               int32_t search_budget) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "model_create",
      Py_BuildValue("(iiiii)", batch_size, epochs, num_devices,
                    only_data_parallel, search_budget));
  PyGILState_Release(st);
  return (fftpu_model)r;
}

void fftpu_model_destroy(fftpu_model m) {
  if (m != nullptr && Py_IsInitialized()) {
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF((PyObject *)m);
    PyGILState_Release(st);
  }
}

void fftpu_tensor_destroy(fftpu_tensor t) { fftpu_model_destroy(t); }

fftpu_tensor fftpu_model_create_tensor(fftpu_model m, int32_t ndim,
                                       int64_t const *dims, int32_t dtype) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "create_tensor",
      Py_BuildValue("(ONi)", (PyObject *)m, dims_tuple(dims, ndim), dtype));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_dense(fftpu_model m, fftpu_tensor t,
                               int32_t out_dim, int32_t activation,
                               int32_t use_bias) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "dense", Py_BuildValue("(OOiii)", (PyObject *)m, (PyObject *)t,
                             out_dim, activation, use_bias));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_conv2d(fftpu_model m, fftpu_tensor t,
                                int32_t out_channels, int32_t kh, int32_t kw,
                                int32_t sh, int32_t sw, int32_t ph,
                                int32_t pw, int32_t activation,
                                int32_t groups, int32_t use_bias) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "conv2d",
      Py_BuildValue("(OOiiiiiiiiii)", (PyObject *)m, (PyObject *)t,
                    out_channels, kh, kw, sh, sw, ph, pw, activation, groups,
                    use_bias));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_pool2d(fftpu_model m, fftpu_tensor t, int32_t kh,
                                int32_t kw, int32_t sh, int32_t sw,
                                int32_t ph, int32_t pw, int32_t pool_type,
                                int32_t activation) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "pool2d", Py_BuildValue("(OOiiiiiiii)", (PyObject *)m, (PyObject *)t,
                              kh, kw, sh, sw, ph, pw, pool_type, activation));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

static fftpu_tensor unary_op(fftpu_model m, fftpu_tensor t,
                             char const *kind) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "unary", Py_BuildValue("(OOs)", (PyObject *)m, (PyObject *)t, kind));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_relu(fftpu_model m, fftpu_tensor t) {
  return unary_op(m, t, "relu");
}
fftpu_tensor fftpu_model_sigmoid(fftpu_model m, fftpu_tensor t) {
  return unary_op(m, t, "sigmoid");
}
fftpu_tensor fftpu_model_tanh(fftpu_model m, fftpu_tensor t) {
  return unary_op(m, t, "tanh");
}
fftpu_tensor fftpu_model_gelu(fftpu_model m, fftpu_tensor t) {
  return unary_op(m, t, "gelu");
}
fftpu_tensor fftpu_model_flat(fftpu_model m, fftpu_tensor t) {
  return unary_op(m, t, "flat");
}

fftpu_tensor fftpu_model_softmax(fftpu_model m, fftpu_tensor t,
                                 int32_t axis) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "softmax", Py_BuildValue("(OOi)", (PyObject *)m, (PyObject *)t, axis));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_concat(fftpu_model m, int32_t n,
                                fftpu_tensor const *ts, int32_t axis) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *lst = PyList_New(n);
  for (int32_t i = 0; i < n; i++) {
    Py_INCREF((PyObject *)ts[i]);
    PyList_SET_ITEM(lst, i, (PyObject *)ts[i]);
  }
  PyObject *r = call_locked(
      "concat", Py_BuildValue("(ONi)", (PyObject *)m, lst, axis));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

fftpu_tensor fftpu_model_embedding(fftpu_model m, fftpu_tensor t,
                                   int32_t num_entries, int32_t out_dim) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return nullptr;
  }
  PyObject *r = call_locked(
      "embedding", Py_BuildValue("(OOii)", (PyObject *)m, (PyObject *)t,
                                 num_entries, out_dim));
  PyGILState_Release(st);
  return (fftpu_tensor)r;
}

/* Writes up to max_ndim dims; returns the tensor's rank or -1. */
int fftpu_tensor_ndim(fftpu_tensor t, int64_t *dims_out, int32_t max_ndim) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *r = call_locked("tensor_dims",
                            Py_BuildValue("(O)", (PyObject *)t));
  int n = -1;
  if (r != nullptr) {
    n = (int)PyList_Size(r);
    for (int32_t i = 0; i < n && i < max_ndim && dims_out != nullptr; i++) {
      dims_out[i] = PyLong_AsLongLong(PyList_GetItem(r, i));
    }
    Py_DECREF(r);
  }
  PyGILState_Release(st);
  return n;
}

int fftpu_model_compile(fftpu_model m, char const *optimizer, double lr,
                        char const *loss, char const *metrics_csv) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *r = call_locked(
      "compile_model",
      Py_BuildValue("(Osdss)", (PyObject *)m, optimizer ? optimizer : "sgd",
                    lr, loss, metrics_csv ? metrics_csv : ""));
  int rc = (r == nullptr) ? -1 : 0;
  Py_XDECREF(r);
  PyGILState_Release(st);
  return rc;
}

static PyObject *mv_ro(void const *p, int64_t bytes) {
  return PyMemoryView_FromMemory(
      const_cast<char *>(static_cast<char const *>(p)), bytes, PyBUF_READ);
}
static PyObject *mv_rw(void *p, int64_t bytes) {
  return PyMemoryView_FromMemory(static_cast<char *>(p), bytes, PyBUF_WRITE);
}

/* GIL must be held */
static void build_x_lists(int32_t n_inputs, float const *const *xs,
                          int64_t const *const *xdims, int32_t const *xndims,
                          PyObject **bufs_out, PyObject **dims_out) {
  PyObject *bufs = PyList_New(n_inputs);
  PyObject *dims = PyList_New(n_inputs);
  for (int32_t i = 0; i < n_inputs; i++) {
    int64_t bytes = numel(xdims[i], xndims[i]) * (int64_t)sizeof(float);
    PyList_SET_ITEM(bufs, i, mv_ro(xs[i], bytes));
    PyList_SET_ITEM(dims, i, dims_tuple(xdims[i], xndims[i]));
  }
  *bufs_out = bufs;
  *dims_out = dims;
}

int fftpu_model_fit(fftpu_model m, int32_t n_inputs, float const *const *xs,
                    int64_t const *const *xdims, int32_t const *xndims,
                    void const *y, int64_t const *ydims, int32_t yndim,
                    int32_t y_is_int, int32_t epochs) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *bufs, *dims;
  build_x_lists(n_inputs, xs, xdims, xndims, &bufs, &dims);
  int64_t ybytes = numel(ydims, yndim) * 4; /* float32 or int32 labels */
  PyObject *r = call_locked(
      "fit", Py_BuildValue("(ONNNNii)", (PyObject *)m, bufs, dims,
                           mv_ro(y, ybytes), dims_tuple(ydims, yndim),
                           y_is_int, epochs));
  int rc = (r == nullptr) ? -1 : 0;
  Py_XDECREF(r);
  PyGILState_Release(st);
  return rc;
}

int fftpu_model_eval(fftpu_model m, int32_t n_inputs, float const *const *xs,
                     int64_t const *const *xdims, int32_t const *xndims,
                     void const *y, int64_t const *ydims, int32_t yndim,
                     int32_t y_is_int, double *accuracy_out,
                     double *loss_out) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *bufs, *dims;
  build_x_lists(n_inputs, xs, xdims, xndims, &bufs, &dims);
  int64_t ybytes = numel(ydims, yndim) * 4;
  PyObject *r = call_locked(
      "evaluate", Py_BuildValue("(ONNNNi)", (PyObject *)m, bufs, dims,
                                mv_ro(y, ybytes), dims_tuple(ydims, yndim),
                                y_is_int));
  int rc = -1;
  if (r != nullptr) {
    if (accuracy_out != nullptr) {
      *accuracy_out = PyFloat_AsDouble(PyList_GetItem(r, 0));
    }
    if (loss_out != nullptr) {
      *loss_out = PyFloat_AsDouble(PyList_GetItem(r, 1));
    }
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(st);
  return rc;
}

int fftpu_model_forward(fftpu_model m, int32_t n_inputs,
                        float const *const *xs, int64_t const *const *xdims,
                        int32_t const *xndims, float *logits_out,
                        int64_t logits_numel) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *bufs, *dims;
  build_x_lists(n_inputs, xs, xdims, xndims, &bufs, &dims);
  PyObject *r = call_locked(
      "forward",
      Py_BuildValue("(ONNN)", (PyObject *)m, bufs, dims,
                    mv_rw(logits_out,
                          logits_numel * (int64_t)sizeof(float))));
  int rc = (r == nullptr) ? -1 : 0;
  Py_XDECREF(r);
  PyGILState_Release(st);
  return rc;
}

int fftpu_model_get_weight(fftpu_model m, char const *op_name,
                           char const *weight_name, float *out,
                           int64_t out_numel) {
  PyGILState_STATE st;
  if (!enter(&st)) {
    return -1;
  }
  PyObject *r = call_locked(
      "get_weight",
      Py_BuildValue("(OssN)", (PyObject *)m, op_name, weight_name,
                    mv_rw(out, out_numel * (int64_t)sizeof(float))));
  int rc = (r == nullptr) ? -1 : 0;
  Py_XDECREF(r);
  PyGILState_Release(st);
  return rc;
}

} /* extern "C" */
