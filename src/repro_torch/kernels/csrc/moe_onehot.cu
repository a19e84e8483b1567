// MoE capacity-slot pack and unpack for Hopper (sm_90a): the routing
// network of Ditto-MoE (models/moe.py), one call per layer for all its
// dispatch groups.
//
//   dispatch: packed[g, p, c, :] = sum_t [eff[g,t] = p and slot[g,t] = c] * x[g, t, :]
//   combine:  y[g, t, :]         = gate[g, t] * packed[g, eff[g,t], slot[g,t], :]
//
// Replace src/repro/kernels/moe_onehot.py::onehot_dispatch and
// ::onehot_combine.  On the TPU both are one-hot MXU contractions over the
// flattened (p * C + c) axis, because VMEM has no fast scatter.  Hopper
// moves rows directly: dispatch fills each packed row from the tuples that
// land in it, combine gathers one packed row per tuple.
//
// Bound: bytes.  Dispatch reads each kept row once and writes the whole
// packed tensor once; combine reads one packed row and writes one output
// row per tuple.  There is no arithmetic to speak of.
//
// Dispatch writes every packed cell exactly once, without a memset of
// `packed` and without atomics on its rows:
//   1. a cudaMemsetAsync sets a head map of one int32 per cell to -1
//      (138 KB at the prefill shape, against 141.6 MB of packed rows);
//   2. the link kernel, one thread per tuple, pushes each kept tuple r onto
//      its cell's list: next[r] = atomicExch(&head[cell], r);
//   3. the fill kernel, one warp per packed row in a grid-stride loop,
//      writes zeros for an empty list, copies x's row for a list of one (so
//      a unique cell is bit-exact), and sums a longer list in float,
//      rounding once, so duplicate cells sum in an order the atomics of
//      step 2 decide.  A lane loads four 16-byte pieces before it stores
//      them, with the streaming hint (st.global.cs): on an H100 that took
//      the call 3.8% less card time than plain stores, and 1% less than
//      streaming only the zero rows (PERF.md).
// All three run on the caller's stream; the wrapper allocates the head map
// and the lists in one scratch tensor.  On the model path `slot` is the
// occurrence rank, so every kept cell is unique and holds a list of one.
//
// Combine: one warp per tuple row, in a grid-stride loop over the G * T
// rows.  Both kernels move 16 bytes a lane at a time (8 bf16 or 4 float)
// when the row width and alignment allow it, a scalar a lane otherwise.
// Tuples with eff outside [0, num_pe) or slot outside [0, capacity) are
// dropped (dispatch) or give zero rows (combine).  bf16 converts only
// through __bfloat162float and __float2bfloat16; the gate product is taken
// in float and rounded once, as torch's bf16 multiply does.
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

// store_vec with the streaming hint (st.global.cs: evict first) on 16-byte
// pieces: the fill kernel writes each packed row once and never reads it.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec_cs(T* dst, const T* buf) {
  if constexpr (VEC * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(buf));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = buf[i];
  }
}

__device__ __forceinline__ bool kept(int e, int s, int num_pe, int cap) {
  return e >= 0 && e < num_pe && s >= 0 && s < cap;
}

// Pushes each kept tuple r onto the list of its cell: head[cell] is the
// last tuple pushed, next[r] the one pushed before r (-1 ends a list).
__global__ void __launch_bounds__(kThreads)
dispatch_link_kernel(int* __restrict__ head, int* __restrict__ next,
                     const int* __restrict__ eff, const int* __restrict__ slot, int rows,
                     int t, int num_pe, int cap) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < rows;
       i += stride) {
    const int r = static_cast<int>(i);
    const int e = eff[r];
    const int s = slot[r];
    if (!kept(e, s, num_pe, cap)) continue;
    next[r] = atomicExch(&head[(r / t * num_pe + e) * cap + s], r);
  }
}

// One warp per packed row: zeros, a copy of the one row in the cell's list,
// or the list's sum in float rounded once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dispatch_fill_kernel(T* __restrict__ packed, const int* __restrict__ head,
                     const int* __restrict__ next, const T* __restrict__ x,
                     long long cells, int d) {
  constexpr int kStep = 32 * VEC;     // columns a warp moves per piece
  constexpr int kUnroll = 4;          // pieces a lane loads before it stores
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long cell = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       cell < cells; cell += nwarps) {
    T* dst = packed + cell * d;
    const int first = head[cell];
    const int second = first < 0 ? -1 : next[first];
    if (second < 0) {                 // zeros, or a copy of row `first`
      const T* src = x + static_cast<long long>(first < 0 ? 0 : first) * d;
      for (int c0 = lane * VEC; c0 < d; c0 += kUnroll * kStep) {
        alignas(16) T buf[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u * kStep >= d) break;
          if (first < 0) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) store_float(&buf[u][i], 0.0f);
          } else {
            load_vec<T, VEC>(buf[u], src + c0 + u * kStep);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + u * kStep >= d) break;
          store_vec_cs<T, VEC>(dst + c0 + u * kStep, buf[u]);
        }
      }
      continue;
    }
    for (int c = lane * VEC; c < d; c += kStep) {   // a duplicate cell
      float acc[VEC] = {};
      for (int r = first; r >= 0; r = next[r]) {
        alignas(16) T buf[VEC];
        load_vec<T, VEC>(buf, x + static_cast<long long>(r) * d + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += to_float(buf[i]);
      }
      alignas(16) T buf[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) store_float(&buf[i], acc[i]);
      store_vec_cs<T, VEC>(dst + c, buf);
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


int grid_for(long long rows, int per_block) {
  const long long blocks = (rows + per_block - 1) / per_block;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
cudaError_t launch_dispatch(void* packed, void* scratch, const void* eff,
                            const void* slot, const void* x, int groups, int t,
                            int d, int num_pe, int cap, int vec,
                            cudaStream_t stream) {
  const long long cells = static_cast<long long>(groups) * num_pe * cap;
  const int rows = groups * t;
  if (cells == 0 || d == 0) return cudaSuccess;
  int* head = static_cast<int*>(scratch);
  int* next = head + cells;
  cudaError_t err = cudaMemsetAsync(head, 0xff, cells * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (rows > 0) {
    dispatch_link_kernel<<<grid_for(rows, kThreads), kThreads, 0, stream>>>(
        head, next, static_cast<const int*>(eff), static_cast<const int*>(slot), rows,
        t, num_pe, cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int kVec = 16 / sizeof(T);
  T* p = static_cast<T*>(packed);
  const T* xs = static_cast<const T*>(x);
  if (vec) {
    dispatch_fill_kernel<T, kVec><<<grid_for(cells, kWarps), kThreads, 0, stream>>>(
        p, head, next, xs, cells, d);
  } else {
    dispatch_fill_kernel<T, 1><<<grid_for(cells, kWarps), kThreads, 0, stream>>>(
        p, head, next, xs, cells, d);
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
    combine_kernel<T, kVec><<<grid_for(rows, kWarps), kThreads, 0, stream>>>(
        out, e, s, p, g, rows, t, d, num_pe, cap);
  } else {
    combine_kernel<T, 1><<<grid_for(rows, kWarps), kThreads, 0, stream>>>(
        out, e, s, p, g, rows, t, d, num_pe, cap);
  }
  return cudaGetLastError();
}

}  // namespace

// packed: [groups, num_pe, cap, d] (written whole); scratch: int32
// [groups * num_pe * cap + groups * t] (the head map and the lists; any
// contents); eff, slot: [groups, t] int32; x: [groups, t, d].  Element type
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  vec = 1 when
// d * sizeof(T) is a multiple of 16 and every pointer is 16-byte aligned.
// groups * t and the number of cells are below 2^31.  Returns the CUDA error
// of the first stream operation that failed (0 = ok).
extern "C" int onehot_dispatch(void* packed, void* scratch, const void* eff,
                               const void* slot, const void* x, int groups, int t,
                               int d, int num_pe, int cap, int is_bf16, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_dispatch<__nv_bfloat16>(packed, scratch, eff, slot, x, groups, t,
                                               d, num_pe, cap, vec, s)
              : launch_dispatch<float>(packed, scratch, eff, slot, x, groups, t, d,
                                       num_pe, cap, vec, s);
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
