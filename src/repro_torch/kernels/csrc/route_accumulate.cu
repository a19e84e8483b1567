// PE buffer update for Hopper (sm_90a): fold each tuple's value into the
// carried PriPE/SecPE buffers at cell (eff[t], idx[t]), with add or max.
//
// Replaces src/repro/kernels/route_accumulate.py::route_accumulate together
// with the flattening/fold wrapper around it in
// src/repro/kernels/dispatch.py::pe_buffer_update.  The TPU kernel turns the
// scatter into a one-hot MXU contraction because VMEM has no fast scatter;
// Hopper has L2 atomics, so this kernel scatters directly.
//
// Bound: bytes.  Each tuple is read once (eff, idx, value: 12 B) and each
// cell the chunk touches is read and written once.  At the executor's chunk
// of 4096 tuples that is ~50 KB, far below what one launch costs, so on the
// main path the kernel is launch-bound.  Under heavy skew (Zipf alpha=3 sends
// most tuples to one cell) atomics on one address serialize in L2.  A
// variant that privatized the bins in shared memory took longer on the card
// at both main-path shapes (HLL [30, 256] max, HISTO [30, 32] add), because
// every block fills and folds back all bins, so there is one path.
//
// Design: one thread per tuple in a grid-stride loop, one global atomic per
// valid tuple.  Tuples with eff outside [0, num_pe) or idx outside
// [0, local) are dropped (padding -1 and the executor's masked sentinel
// eff = num_pe).  The fold goes into the carried buffer, so `max` is exact
// for values of any sign.  Integer results are bit-exact; float `add`
// depends on the atomic order.  Float `max` is a CAS loop.
//
// Binding: the card's ~1.4 us per chunk is far below the host's cost of a
// call, so besides the plain C entry the library is a CPython extension
// module (route_accumulate.update, at the end; py_tensor.h says why) that
// checks the tensors and launches in C.
#include "py_tensor.h"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;

__device__ __forceinline__ void atomic_max(int* addr, int v) { atomicMax(addr, v); }

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  int* bits = reinterpret_cast<int*>(addr);
  int old = *bits;
  while (__int_as_float(old) < v) {
    const int assumed = old;
    old = atomicCAS(bits, assumed, __float_as_int(v));
    if (old == assumed) break;
  }
}

template <typename T, bool kMax>
__device__ __forceinline__ void fold(T* addr, T v) {
  if constexpr (kMax) {
    atomic_max(addr, v);
  } else {
    atomicAdd(addr, v);
  }
}

template <typename T, bool kMax>
__global__ void route_accumulate_kernel(T* __restrict__ buf,
                                        const int* __restrict__ eff,
                                        const int* __restrict__ idx,
                                        const T* __restrict__ val, int n,
                                        int num_pe, int local) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const int e = eff[t];
    const int i = idx[t];
    if (e >= 0 && e < num_pe && i >= 0 && i < local)
      fold<T, kMax>(&buf[static_cast<long long>(e) * local + i], val[t]);
  }
}

template <typename T, bool kMax>
cudaError_t launch(void* buf, const void* eff, const void* idx,
                   const void* val, int n, int num_pe, int local,
                   cudaStream_t stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  route_accumulate_kernel<T, kMax><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(buf), static_cast<const int*>(eff),
      static_cast<const int*>(idx), static_cast<const T*>(val), n, num_pe,
      local);
  return cudaGetLastError();
}

}  // namespace

// buf: [num_pe, local] int32 (is_float=0) or float32 (is_float=1), updated in
// place.  eff, idx: [n] int32.  val: [n] of buf's type.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int route_accumulate(void* buf, const void* eff, const void* idx,
                                const void* val, int n, int num_pe, int local,
                                int is_max, int is_float, void* stream) {
  if (n <= 0 || num_pe <= 0 || local <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_float) {
    err = is_max ? launch<float, true>(buf, eff, idx, val, n, num_pe, local, s)
                 : launch<float, false>(buf, eff, idx, val, n, num_pe, local, s);
  } else {
    err = is_max ? launch<int, true>(buf, eff, idx, val, n, num_pe, local, s)
                 : launch<int, false>(buf, eff, idx, val, n, num_pe, local, s);
  }
  return static_cast<int>(err);
}

// ---- the CPython binding
//
// route_accumulate.update(buffers, eff, idx, value, is_max) takes the four
// tensors, reads what the kernel needs from each (dtype, shape, device,
// contiguity, data pointer), makes every check of the Python wrapper, looks
// up the device's current stream and launches.  Returns 1 after a launch,
// 0 when there is nothing to fold (no tuple or no cell), -1 if an input
// fails a check (the wrapper then works out which, and raises); raises
// RuntimeError if the launch fails.

namespace {

PyObject* py_update(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 5) {
    PyErr_SetString(PyExc_TypeError, "update takes buffers, eff, idx, value, is_max");
    return nullptr;
  }
  TensorInfo buf, eff, idx, val;
  if (!read_tensor(args[0], &buf) || !read_tensor(args[1], &eff) ||
      !read_tensor(args[2], &idx) || !read_tensor(args[3], &val))
    return nullptr;
  const int is_max = PyObject_IsTrue(args[4]);
  if (is_max < 0) return nullptr;
  const bool is_float = buf.dtype == g.float32;
  const long long n = eff.ndim == 1 ? eff.dims[0] : -1;
  const bool ok =
      (is_float || buf.dtype == g.int32) && buf.ndim == 2 && buf.device >= 0 &&
      eff.dtype == g.int32 && idx.dtype == g.int32 && val.dtype == buf.dtype &&
      eff.device == buf.device && idx.device == buf.device && val.device == buf.device &&
      n >= 0 && idx.ndim == 1 && idx.dims[0] == n && val.ndim == 1 && val.dims[0] == n &&
      buf.contiguous && eff.contiguous && idx.contiguous && val.contiguous &&
      buf.dims[0] * buf.dims[1] < (1LL << 31) && n < (1LL << 31);
  if (!ok) return PyLong_FromLong(-1);
  if (n == 0 || buf.dims[0] * buf.dims[1] == 0) return PyLong_FromLong(0);
  void* stream = current_stream(buf.device);
  if (PyErr_Occurred()) return nullptr;
  const int err = route_accumulate(buf.ptr, eff.ptr, idx.ptr, val.ptr, static_cast<int>(n),
                                   static_cast<int>(buf.dims[0]),
                                   static_cast<int>(buf.dims[1]), is_max, is_float, stream);
  if (err)
    return PyErr_Format(PyExc_RuntimeError, "route_accumulate launch failed: CUDA error %d",
                        err);
  return PyLong_FromLong(1);
}

PyMethodDef kMethods[] = {
    {"update", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(py_update)),
     METH_FASTCALL, "Check the inputs and launch the PE buffer update."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "route_accumulate", nullptr, -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_route_accumulate(void) {
  if (!init_names()) return nullptr;
  return PyModule_Create(&kModule);
}
