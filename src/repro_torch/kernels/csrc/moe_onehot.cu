// MoE capacity-slot pack and unpack for Hopper (sm_90a): the routing
// network of Ditto-MoE (models/moe.py), one launch per layer for all its
// dispatch groups.
//
//   dispatch: packed[g, p, c, :] = sum_t [eff[g,t] = p and slot[g,t] = c] * x[g, t, :]
//   combine:  y[g, t, :]         = gate[g, t] * packed[g, eff[g,t], slot[g,t], :]
//
// Replace src/repro/kernels/moe_onehot.py::onehot_dispatch and
// ::onehot_combine.  On the TPU both are one-hot MXU contractions over the
// flattened (p * C + c) axis, because VMEM has no fast scatter.  Hopper
// moves rows directly: dispatch is a row scatter, combine a row gather.
//
// Bound: bytes.  Dispatch reads each kept row once and writes the whole
// packed tensor once (zero fill plus the scattered rows); combine reads one
// packed row and writes one output row per tuple.  There is no arithmetic
// to speak of.
//
// Design: one warp per tuple row, in a grid-stride loop over the G * T rows;
// each lane moves 16 bytes at a time (8 bf16 or 4 float) when the row width
// allows it, so a warp moves 512 contiguous bytes per step.  Dispatch
// zero-fills `packed` (cudaMemsetAsync on the same stream) and adds each
// kept row with atomics, so duplicate (eff, slot) cells sum as in the
// reference.  On the model path `slot` is the occurrence rank, so the kept
// cells are unique: each cell receives exactly one add onto zero and the
// result is bit-exact, in bfloat16 too.  Tuples with eff outside
// [0, num_pe) or slot outside [0, capacity) are dropped (dispatch) or give
// zero rows (combine).  bf16 converts only through __bfloat162float and
// __float2bfloat16; the gate product is taken in float and rounded once,
// as torch's bf16 multiply does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_float(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_float(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16(v);
}

// Adds VEC consecutive values; bf16 pairs use the packed bf16x2 atomic.
template <int VEC>
__device__ __forceinline__ void atomic_add_vec(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
}

template <int VEC>
__device__ __forceinline__ void atomic_add_vec(__nv_bfloat16* dst,
                                               const __nv_bfloat16* v) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2)
      atomicAdd(reinterpret_cast<__nv_bfloat162*>(dst + i),
                *reinterpret_cast<const __nv_bfloat162*>(v + i));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T* buf, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) buf[i] = src[i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const T* buf) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(buf);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = buf[i];
  }
}

__device__ __forceinline__ bool kept(int e, int s, int num_pe, int cap) {
  return e >= 0 && e < num_pe && s >= 0 && s < cap;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(T* __restrict__ packed, const int* __restrict__ eff,
                const int* __restrict__ slot, const T* __restrict__ x,
                long long rows, int t, int d, int num_pe, int cap) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       r < rows; r += nwarps) {
    const int e = eff[r];
    const int s = slot[r];
    if (!kept(e, s, num_pe, cap)) continue;  // uniform across the warp
    const long long g = r / t;
    T* dst = packed + ((g * num_pe + e) * cap + s) * static_cast<long long>(d);
    const T* src = x + r * static_cast<long long>(d);
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) T buf[VEC];
      load_vec<T, VEC>(buf, src + c);
      atomic_add_vec<VEC>(dst + c, buf);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
combine_kernel(T* __restrict__ y, const int* __restrict__ eff,
               const int* __restrict__ slot, const T* __restrict__ packed,
               const T* __restrict__ gate, long long rows, int t, int d,
               int num_pe, int cap) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       r < rows; r += nwarps) {
    const int e = eff[r];
    const int s = slot[r];
    const bool keep = kept(e, s, num_pe, cap);
    const float gv = gate != nullptr ? to_float(gate[r]) : 1.0f;
    const long long g = r / t;
    const T* src = packed + ((g * num_pe + e) * cap + s) * static_cast<long long>(d);
    T* dst = y + r * static_cast<long long>(d);
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) T buf[VEC];
      if (keep) {
        load_vec<T, VEC>(buf, src + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) store_float(&buf[i], to_float(buf[i]) * gv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) store_float(&buf[i], 0.0f);
      }
      store_vec<T, VEC>(dst + c, buf);
    }
  }
}

int grid_for(long long rows) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
cudaError_t launch_dispatch(void* packed, const void* eff, const void* slot,
                            const void* x, int groups, int t, int d, int num_pe,
                            int cap, int vec, cudaStream_t stream) {
  const long long rows = static_cast<long long>(groups) * t;
  const size_t bytes = static_cast<size_t>(groups) * num_pe * cap * d * sizeof(T);
  cudaError_t err = cudaMemsetAsync(packed, 0, bytes, stream);
  if (err != cudaSuccess || rows == 0) return err;
  constexpr int kVec = 16 / sizeof(T);
  T* p = static_cast<T*>(packed);
  const int* e = static_cast<const int*>(eff);
  const int* s = static_cast<const int*>(slot);
  const T* xs = static_cast<const T*>(x);
  if (vec) {
    dispatch_kernel<T, kVec><<<grid_for(rows), kThreads, 0, stream>>>(
        p, e, s, xs, rows, t, d, num_pe, cap);
  } else {
    dispatch_kernel<T, 1><<<grid_for(rows), kThreads, 0, stream>>>(
        p, e, s, xs, rows, t, d, num_pe, cap);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(void* y, const void* eff, const void* slot,
                           const void* packed, const void* gate, int groups,
                           int t, int d, int num_pe, int cap, int vec,
                           cudaStream_t stream) {
  const long long rows = static_cast<long long>(groups) * t;
  if (rows == 0) return cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  T* out = static_cast<T*>(y);
  const int* e = static_cast<const int*>(eff);
  const int* s = static_cast<const int*>(slot);
  const T* p = static_cast<const T*>(packed);
  const T* g = static_cast<const T*>(gate);
  if (vec) {
    combine_kernel<T, kVec><<<grid_for(rows), kThreads, 0, stream>>>(
        out, e, s, p, g, rows, t, d, num_pe, cap);
  } else {
    combine_kernel<T, 1><<<grid_for(rows), kThreads, 0, stream>>>(
        out, e, s, p, g, rows, t, d, num_pe, cap);
  }
  return cudaGetLastError();
}

}  // namespace

// packed: [groups, num_pe, cap, d] (written whole); eff, slot: [groups, t]
// int32; x: [groups, t, d].  Element type float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1).  vec = 1 when d * sizeof(T) is a multiple of 16
// and every pointer is 16-byte aligned.  Returns the CUDA error (0 = ok).
extern "C" int onehot_dispatch(void* packed, const void* eff, const void* slot,
                               const void* x, int groups, int t, int d,
                               int num_pe, int cap, int is_bf16, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_dispatch<__nv_bfloat16>(packed, eff, slot, x, groups, t, d,
                                               num_pe, cap, vec, s)
              : launch_dispatch<float>(packed, eff, slot, x, groups, t, d, num_pe,
                                       cap, vec, s);
  return static_cast<int>(err);
}

// y: [groups, t, d]; packed: [groups, num_pe, cap, d]; gate: [groups, t] of
// the same element type, or null for 1.  Other arguments as above.
extern "C" int onehot_combine(void* y, const void* eff, const void* slot,
                              const void* packed, const void* gate, int groups,
                              int t, int d, int num_pe, int cap, int is_bf16,
                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_combine<__nv_bfloat16>(y, eff, slot, packed, gate, groups,
                                              t, d, num_pe, cap, vec, s)
              : launch_combine<float>(y, eff, slot, packed, gate, groups, t, d,
                                      num_pe, cap, vec, s);
  return static_cast<int>(err);
}
