// What the kernels' CPython extension modules share: reading a tensor's
// dtype, shape, device, contiguity and data pointer through its Python
// attributes, looking up the device's current CUDA stream, and the module
// set-up that interns the names both need.
//
// Included by cms_update.cu and route_accumulate.cu, each built into a
// library of its own; everything here has internal linkage, so each library
// keeps its own copy.  It needs Python.h only (no PyTorch headers), so an
// nvcc build stays seconds long.  A kernel whose host call costs more than
// its card time (a chunk of 4096 tuples is ~1.5 us on the card) calls
// through such a module: on an H100's host a ctypes call of a plain C entry
// costs ~2.5 us more than a METH_FASTCALL one, and the same input checks
// cost ~3 us in Python (PERF.md).
#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace {

struct Names {
  PyObject *dtype, *shape, *get_device, *is_contiguous, *data_ptr;
  PyObject *int32, *float32, *raw_stream;  // torch.int32, torch.float32,
                                           // torch._C._cuda_getCurrentRawStream
};
Names g;

struct TensorInfo {
  PyObject* dtype;  // borrowed: torch's dtype objects live as long as torch
  long long dims[3];
  int ndim;         // -1 for more than 3 dimensions
  long device;      // -1 off the card
  bool contiguous;
  void* ptr;
};

// Fills `out` from tensor `t`; false with a Python exception set if an
// attribute could not be read.
bool read_tensor(PyObject* t, TensorInfo* out) {
  PyObject* dtype = PyObject_GetAttr(t, g.dtype);
  if (!dtype) return false;
  out->dtype = dtype;
  Py_DECREF(dtype);
  PyObject* shape = PyObject_GetAttr(t, g.shape);
  if (!shape) return false;
  const Py_ssize_t nd = PyTuple_Size(shape);
  out->ndim = nd < 0 || nd > 3 ? -1 : static_cast<int>(nd);
  for (int i = 0; i < out->ndim; ++i)
    out->dims[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(shape, i));
  Py_DECREF(shape);
  PyObject* r = PyObject_CallMethodNoArgs(t, g.get_device);
  if (!r) return false;
  out->device = PyLong_AsLong(r);
  Py_DECREF(r);
  r = PyObject_CallMethodNoArgs(t, g.is_contiguous);
  if (!r) return false;
  out->contiguous = r == Py_True;
  Py_DECREF(r);
  r = PyObject_CallMethodNoArgs(t, g.data_ptr);
  if (!r) return false;
  out->ptr = PyLong_AsVoidPtr(r);
  Py_DECREF(r);
  return !PyErr_Occurred();
}

// The raw current stream of CUDA device `device` (torch.cuda.stream
// contexts and graph capture included); nullptr with a Python exception
// set on failure (the default stream is a valid nullptr only when no
// exception is set).
void* current_stream(long device) {
  PyObject* index = PyLong_FromLong(device);
  if (!index) return nullptr;
  PyObject* st = PyObject_CallOneArg(g.raw_stream, index);
  Py_DECREF(index);
  if (!st) return nullptr;
  void* stream = PyLong_AsVoidPtr(st);
  Py_DECREF(st);
  return stream;
}

// Module set-up: imports torch and fills `g`; false with a Python
// exception set on failure.
bool init_names() {
  PyObject* torch = PyImport_ImportModule("torch");
  if (!torch) return false;
  PyObject* c = PyObject_GetAttrString(torch, "_C");
  g.int32 = PyObject_GetAttrString(torch, "int32");
  g.float32 = PyObject_GetAttrString(torch, "float32");
  Py_DECREF(torch);
  if (!c || !g.int32 || !g.float32) return false;
  g.raw_stream = PyObject_GetAttrString(c, "_cuda_getCurrentRawStream");
  Py_DECREF(c);
  if (!g.raw_stream) return false;
  g.dtype = PyUnicode_InternFromString("dtype");
  g.shape = PyUnicode_InternFromString("shape");
  g.get_device = PyUnicode_InternFromString("get_device");
  g.is_contiguous = PyUnicode_InternFromString("is_contiguous");
  g.data_ptr = PyUnicode_InternFromString("data_ptr");
  return g.dtype && g.shape && g.get_device && g.is_contiguous && g.data_ptr;
}

}  // namespace
