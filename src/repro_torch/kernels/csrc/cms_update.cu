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
// each sketch cell the chunk touches is read and written once.  HHD's sketch (31 x 4 x 1024 int32,
// ~0.5 MB) does not fit in one block's shared memory, so it lives in the
// 50 MB L2 and takes global atomics: one thread per (tuple, row).  At the
// executor's chunk of 4096 tuples the launch costs more than the bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

template <typename T>
__global__ void cms_update_kernel(T* __restrict__ sketch,
                                  const int* __restrict__ eff,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ val, int n,
                                  int num_pe, int depth, int width) {
  const long long total = static_cast<long long>(n) * depth;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i / depth);
    const int d = static_cast<int>(i % depth);
    const int e = eff[t];
    const int c = cols[i];
    if (e >= 0 && e < num_pe && c >= 0 && c < width)
      atomicAdd(&sketch[(static_cast<long long>(e) * depth + d) * width + c],
                val[t]);
  }
}

template <typename T>
cudaError_t launch(void* sketch, const void* eff, const void* cols,
                   const void* val, int n, int num_pe, int depth, int width,
                   cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * depth;
  long long blocks = (total + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  cms_update_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(sketch), static_cast<const int*>(eff),
      static_cast<const int*>(cols), static_cast<const T*>(val), n, num_pe,
      depth, width);
  return cudaGetLastError();
}

}  // namespace

// sketch: [num_pe, depth, width] int32 (is_float=0) or float32 (is_float=1),
// updated in place.  eff: [n] int32.  cols: [n, depth] int32, row-major.
// val: [n] of the sketch's type.  Returns the CUDA error of the launch.
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
