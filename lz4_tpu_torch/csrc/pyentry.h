// A CPython entry point for the probe gathers (probe_lane.cu,
// probe_gather.cu): the wrapper's checks, the output's allocation and the
// launch in one C call.
//
// A gather of a few microseconds on the card is bound by its host call.
// With the checks in Python and the launch through ctypes, a call took
// 15-21 us of host time on an H100 machine against 6-10 us for one
// `torch.gather` (`host_us`, probes/_common.measure); through this entry,
// 7-10 us. It reads the same attributes through the C API, allocates the
// output with torch.empty_like(a) and launches on the current stream of
// a's device.
//
// gather(a, b, code) returns the output (a's shape, dtype and device), or
// None where the fast path does not apply (a dtype other than
// torch.int32, a tensor that is not contiguous or not on the current CUDA
// device, shapes that differ or that `valid` refuses); the Python wrapper
// then runs its own checks, which raise, or enters the device and calls
// again. A failed launch raises
// RuntimeError. Include this header first: Python.h must precede the
// system headers.
#pragma once

#include <Python.h>

#include <cuda_runtime.h>

namespace lz4t {

constexpr int kMaxDims = 4;

// shape (ndim <= kMaxDims) and `code` -> whether the kernel takes them
using GatherValid = bool (*)(const long long* shape, int ndim, int code);
// launches the gather; returns its cudaError_t
using GatherLaunch = int (*)(const long long* shape, int ndim, const void* a,
                             const void* b, void* out, int code,
                             cudaStream_t st);

struct Ref {                        // an owned reference, released on exit
  PyObject* p;
  explicit Ref(PyObject* q) : p(q) {}
  ~Ref() { Py_XDECREF(p); }
  Ref(const Ref&) = delete;
  Ref& operator=(const Ref&) = delete;
};

struct PyTorch {                    // what the entry needs of torch
  PyObject* int32 = nullptr;
  PyObject* empty_like = nullptr;
  PyObject* raw_stream = nullptr;   // torch._C._cuda_getCurrentRawStream
  PyObject* s_dtype = nullptr;
  PyObject* s_is_cuda = nullptr;
  PyObject* s_get_device = nullptr;
  PyObject* s_shape = nullptr;
  PyObject* s_is_contiguous = nullptr;
  PyObject* s_data_ptr = nullptr;
};

inline PyTorch g_torch;

// Fills g_torch from the imported torch module; 0 on success, -1 with a
// Python error set.
inline int init_torch() {
  if (g_torch.int32) return 0;
  Ref torch(PyImport_ImportModule("torch"));
  if (!torch.p) return -1;
  Ref c(PyObject_GetAttrString(torch.p, "_C"));
  if (!c.p) return -1;
  PyTorch t;
  t.int32 = PyObject_GetAttrString(torch.p, "int32");
  t.empty_like = PyObject_GetAttrString(torch.p, "empty_like");
  t.raw_stream = PyObject_GetAttrString(c.p, "_cuda_getCurrentRawStream");
  t.s_dtype = PyUnicode_InternFromString("dtype");
  t.s_is_cuda = PyUnicode_InternFromString("is_cuda");
  t.s_get_device = PyUnicode_InternFromString("get_device");
  t.s_shape = PyUnicode_InternFromString("shape");
  t.s_is_contiguous = PyUnicode_InternFromString("is_contiguous");
  t.s_data_ptr = PyUnicode_InternFromString("data_ptr");
  PyObject* all[] = {t.int32, t.empty_like, t.raw_stream, t.s_dtype,
                     t.s_is_cuda, t.s_get_device, t.s_shape,
                     t.s_is_contiguous, t.s_data_ptr};
  for (PyObject* p : all)
    if (!p) {
      for (PyObject* q : all) Py_XDECREF(q);
      return -1;
    }
  g_torch = t;
  return 0;
}

// 1: t.<attr> is `want`, 0: it is not, -1: error
inline int attr_is(PyObject* t, PyObject* attr, PyObject* want) {
  Ref v(PyObject_GetAttr(t, attr));
  return v.p ? v.p == want : -1;
}

// 1: t.is_contiguous(), 0: not, -1: error
inline int contiguous(PyObject* t) {
  Ref v(PyObject_CallMethodNoArgs(t, g_torch.s_is_contiguous));
  return v.p ? v.p == Py_True : -1;
}

inline void* data_ptr(PyObject* t) {
  Ref v(PyObject_CallMethodNoArgs(t, g_torch.s_data_ptr));
  return v.p ? PyLong_AsVoidPtr(v.p) : nullptr;
}

// gather(a, b, code): see the top of the file. `what` names the kernel in
// a launch error.
inline PyObject* py_gather(PyObject* const* args, Py_ssize_t nargs,
                           GatherValid valid, GatherLaunch launch,
                           const char* what) {
  if (nargs != 3) {
    PyErr_SetString(PyExc_TypeError, "gather(a, b, code) takes 3 arguments");
    return nullptr;
  }
  if (init_torch()) return nullptr;
  const PyTorch& T = g_torch;
  PyObject* a = args[0];
  PyObject* b = args[1];
  const long code = PyLong_AsLong(args[2]);
  if (code == -1 && PyErr_Occurred()) return nullptr;
  PyObject* both[] = {a, b};
  for (PyObject* t : both) {
    int r = attr_is(t, T.s_dtype, T.int32);
    if (r == 1) r = contiguous(t);
    if (r < 0) return nullptr;
    if (!r) Py_RETURN_NONE;
  }
  // both on the current CUDA device
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess) Py_RETURN_NONE;
  Ref index(PyLong_FromLong(cur));
  if (!index.p) return nullptr;
  for (PyObject* t : both) {
    int r = attr_is(t, T.s_is_cuda, Py_True);
    if (r < 0) return nullptr;
    if (!r) Py_RETURN_NONE;
    Ref dev(PyObject_CallMethodNoArgs(t, T.s_get_device));
    if (!dev.p) return nullptr;
    r = PyObject_RichCompareBool(dev.p, index.p, Py_EQ);
    if (r < 0) return nullptr;
    if (!r) Py_RETURN_NONE;
  }
  Ref sa(PyObject_GetAttr(a, T.s_shape));
  Ref sb(PyObject_GetAttr(b, T.s_shape));
  if (!sa.p || !sb.p) return nullptr;
  int r = PyObject_RichCompareBool(sa.p, sb.p, Py_EQ);
  if (r < 0) return nullptr;
  if (!r || !PyTuple_Check(sa.p)) Py_RETURN_NONE;
  const Py_ssize_t ndim = PyTuple_GET_SIZE(sa.p);
  if (ndim > kMaxDims) Py_RETURN_NONE;
  long long shape[kMaxDims] = {0, 0, 0, 0};
  for (Py_ssize_t i = 0; i < ndim; ++i) {
    shape[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(sa.p, i));
    if (shape[i] == -1 && PyErr_Occurred()) return nullptr;
  }
  if (!valid(shape, static_cast<int>(ndim), static_cast<int>(code)))
    Py_RETURN_NONE;
  Ref stream(PyObject_CallOneArg(T.raw_stream, index.p));
  if (!stream.p) return nullptr;
  void* st = PyLong_AsVoidPtr(stream.p);
  if (!st && PyErr_Occurred()) return nullptr;
  PyObject* out = PyObject_CallOneArg(T.empty_like, a);
  if (!out) return nullptr;
  const void* pa = data_ptr(a);
  const void* pb = pa ? data_ptr(b) : nullptr;
  void* po = pb ? data_ptr(out) : nullptr;
  if (!po) {
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_RuntimeError, "a tensor without storage");
    Py_DECREF(out);
    return nullptr;
  }
  const int rc = launch(shape, static_cast<int>(ndim), pa, pb, po,
                        static_cast<int>(code),
                        static_cast<cudaStream_t>(st));
  if (rc) {
    Py_DECREF(out);
    PyErr_Format(PyExc_RuntimeError, "%s launch failed: CUDA error %d", what,
                 rc);
    return nullptr;
  }
  return out;
}

}  // namespace lz4t

// The module `name` (loaded by _build.module as lz4t_<source>) with its
// one function, gather, calling lz4t::py_gather with VALID and LAUNCH.
#define LZ4T_GATHER_MODULE(name, VALID, LAUNCH, WHAT)                        \
  static PyObject* lz4t_py_gather(PyObject*, PyObject* const* args,         \
                                  Py_ssize_t nargs) {                        \
    return lz4t::py_gather(args, nargs, VALID, LAUNCH, WHAT);                \
  }                                                                          \
  static PyMethodDef lz4t_methods[] = {                                      \
      {"gather", reinterpret_cast<PyCFunction>(                              \
                     reinterpret_cast<void (*)(void)>(lz4t_py_gather)),      \
       METH_FASTCALL, "gather(a, b, code) -> out, or None"},                 \
      {nullptr, nullptr, 0, nullptr}};                                       \
  static PyModuleDef lz4t_module = {PyModuleDef_HEAD_INIT, #name, nullptr,  \
                                    -1, lz4t_methods};                       \
  PyMODINIT_FUNC PyInit_##name() { return PyModule_Create(&lz4t_module); }
