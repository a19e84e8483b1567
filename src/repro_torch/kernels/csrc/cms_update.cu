// Count-min sketch update for Hopper (sm_90a): HHD's PE update.
//
// Replaces src/repro/kernels/cms_update.py::cms_update.  For every tuple t
// whose effective PE eff[t] lies in [0, num_pe) and every sketch row
// d < depth, adds value[t] to sketch[eff[t], d, cols[t, d]], folding straight
// into the carried [num_pe, depth, width] sketch.  The TPU kernel contracts
// two one-hot factors on the MXU and drops the masked sentinel eff = num_pe
// only because no one-hot row matches it; here the sentinel (and padding -1)
// is dropped by an explicit range check.
//
// Bound: bytes.  A tuple reads 4 (eff) + 4*depth (cols) + 4 (value) bytes and
// each sketch cell the chunk touches is read and written once.  HHD's sketch
// (31 x 4 x 1024 int32, ~0.5 MB) does not fit in one block's shared memory,
// so it lives in the 50 MB L2 and takes global atomics.  At the executor's
// chunk of 4096 tuples the call's host time costs far more than the card's
// (the wrapper keeps that path short).  On the card, skew is what costs: at
// Zipf alpha = 3 a share 1/zeta(3) ~ 0.83 of the tuples carry the hottest
// key, so the hot PE and its SecPEs take hundreds of same-address atomics a
// chunk on the same few cells -- but Ditto's redirection spreads them:
// with X = 14 SecPEs the hot key's tuples round-robin over 15 PEs, 15
// different cells in each row, so a warp of 32 tuples holds about 2 per
// cell.
// The design:
//   - one thread per tuple, grid-stride; with depth 4 it loads its columns
//     with one 16-byte load (a plain loop otherwise), and does no 64-bit
//     division;
//   - one global atomicAdd per (tuple, row).  Warp-aggregated atomics
//     (lanes whose flat cell index matches under __match_any_sync sum their
//     values and the lowest lane adds the sum) measured slower on an H100
//     at both alpha = 3 and alpha = 0 (PERF.md), so they were left out.
// int32 adds commute, so the result is bit-exact; float32 sums in another
// order than the plain version.
//
// Binding: besides the plain C entry, the library is a CPython extension
// module (cms_update.update, at the end; py_tensor.h says why).
#include "py_tensor.h"

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(T* __restrict__ sketch, const int* __restrict__ eff,
                  const int* __restrict__ cols, const T* __restrict__ val, int n,
                  int num_pe, int depth, int width, int cols4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; t < n;
       t += stride) {
    const int e = eff[t];
    if (e < 0 || e >= num_pe) continue;
    const T x = val[t];
    const int row0 = e * depth;
    auto add = [&](int d, int c) {
      if (c >= 0 && c < width) atomicAdd(&sketch[(row0 + d) * width + c], x);
    };
    if (cols4) {
      const int4 c = reinterpret_cast<const int4*>(cols)[t];
      add(0, c.x);
      add(1, c.y);
      add(2, c.z);
      add(3, c.w);
    } else {
      for (int d = 0; d < depth; ++d) add(d, cols[t * depth + d]);
    }
  }
}

template <typename T>
cudaError_t launch(void* sketch, const void* eff, const void* cols,
                   const void* val, int n, int num_pe, int depth, int width,
                   cudaStream_t stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const int cols4 = depth == 4 && reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  cms_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(sketch), static_cast<const int*>(eff),
      static_cast<const int*>(cols), static_cast<const T*>(val), n, num_pe,
      depth, width, cols4);
  return cudaGetLastError();
}

}  // namespace

// sketch: [num_pe, depth, width] int32 (is_float=0) or float32 (is_float=1),
// updated in place, fewer than 2^31 cells.  eff: [n] int32.  cols: [n, depth]
// int32, row-major.  val: [n] of the sketch's type.  Returns the CUDA error
// of the launch.
extern "C" int cms_update(void* sketch, const void* eff, const void* cols,
                          const void* val, int n, int num_pe, int depth,
                          int width, int is_float, void* stream) {
  if (n <= 0 || num_pe <= 0 || depth <= 0 || width <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_float ? launch<float>(sketch, eff, cols, val, n, num_pe, depth, width, s)
               : launch<int>(sketch, eff, cols, val, n, num_pe, depth, width, s);
  return static_cast<int>(err);
}

// ---- the CPython binding
//
// cms_update.update(sketch, eff, cols, value) takes the four tensors,
// reads what the kernel needs from each (dtype, shape, device, contiguity,
// data pointer), makes every check of the Python wrapper, looks up the
// device's current stream and launches.  Returns 1 after a launch, 0 for an
// empty chunk, -1 if an input fails a check (the wrapper then works out
// which, and raises); raises RuntimeError if the launch fails.

namespace {

PyObject* py_update(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 4) {
    PyErr_SetString(PyExc_TypeError, "update takes sketch, eff, cols, value");
    return nullptr;
  }
  TensorInfo sk, eff, cols, val;
  if (!read_tensor(args[0], &sk) || !read_tensor(args[1], &eff) ||
      !read_tensor(args[2], &cols) || !read_tensor(args[3], &val))
    return nullptr;
  const bool is_float = sk.dtype == g.float32;
  const long long n = eff.ndim == 1 ? eff.dims[0] : -1;
  const bool ok =
      (is_float || sk.dtype == g.int32) && sk.ndim == 3 && sk.device >= 0 &&
      eff.dtype == g.int32 && cols.dtype == g.int32 && val.dtype == sk.dtype &&
      eff.device == sk.device && cols.device == sk.device && val.device == sk.device &&
      n >= 0 && val.ndim == 1 && val.dims[0] == n && cols.ndim == 2 && cols.dims[0] == n &&
      cols.dims[1] == sk.dims[1] && sk.contiguous && eff.contiguous && cols.contiguous &&
      val.contiguous && sk.dims[0] * sk.dims[1] * sk.dims[2] < (1LL << 31) &&
      n < (1LL << 31);
  if (!ok) return PyLong_FromLong(-1);
  if (n == 0 || sk.dims[0] * sk.dims[1] * sk.dims[2] == 0) return PyLong_FromLong(0);
  void* stream = current_stream(sk.device);
  if (PyErr_Occurred()) return nullptr;
  const int err = cms_update(sk.ptr, eff.ptr, cols.ptr, val.ptr, static_cast<int>(n),
                             static_cast<int>(sk.dims[0]), static_cast<int>(sk.dims[1]),
                             static_cast<int>(sk.dims[2]), is_float, stream);
  if (err) return PyErr_Format(PyExc_RuntimeError, "cms_update launch failed: CUDA error %d", err);
  return PyLong_FromLong(1);
}

PyMethodDef kMethods[] = {
    {"update", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(py_update)),
     METH_FASTCALL, "Check the inputs and launch the count-min sketch update."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "cms_update", nullptr, -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_cms_update(void) {
  if (!init_names()) return nullptr;
  return PyModule_Create(&kModule);
}
