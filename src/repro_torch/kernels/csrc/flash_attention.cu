// Flash (online-softmax) attention forward for Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h',:] * dh^-0.5) v[b,j,h',:]
//
// over the keys j that the masks keep: causal (j <= i), a sliding window
// (j > i - window when window > 0) and key padding (j < Sk); h' = h / (H/KV)
// (GQA by index, never materialised).  Replaces
// src/repro/kernels/flash_attention.py::flash_attention, whose Pallas grid
// walks the KV tiles as its last, sequential axis with (m, l, acc) resident
// in VMEM.  Here one block owns one (b*h, q-tile) and loops over the KV
// tiles itself, since blocks run in no order and carry nothing between them.
//
// Bound: operations.  At the prefill shape (B=4, S=1024, H=16, dh=128) the
// causal half of QK^T and PV is 17.2 GFLOP against 67 MB of bytes moved;
// the tensor cores would bound it at ~0.02 ms.  This first kernel computes
// in float32 on the CUDA cores (67 TFLOP/s peak), so it sits well above that
// bound: wgmma and TMA are later work.
//
// Design: 256 threads as a 16 x 16 grid; a 64 x 64 (q, k) tile.  Q, K and V
// tiles are staged in shared memory as float (rows padded by one float so
// the K reads of a warp fall on distinct banks), and each thread owns a
// 4 x 4 block of scores (rows ty + 16i, keys tx + 16j) and a 4 x (D/16) block
// of the accumulator (columns tx + 16j).  Row max and row sum reduce over the
// 16 lanes that share a row with xor shuffles.  The running m, l and acc stay
// in float32 registers; the epilogue writes acc / max(l, 1e-20).  KV tiles
// wholly above the diagonal (causal) or wholly before the window are skipped.
// Masked scores are -1e30 and masked probabilities exactly 0, as in Pallas.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_float(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_float(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16(v);
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

__device__ __forceinline__ float reduce16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float reduce16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads rows [r0, r0 + kRows) of one head into smem as float, zero past
// `limit` rows and past dh columns.  `stride` is the distance between
// consecutive positions (heads * dh).
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long stride, int r0, int limit,
                                          int dh) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    float v = 0.0f;
    if (r0 + r < limit && c < dh) v = to_float(src[(r0 + r) * stride + c]);
    dst[r * dst_stride + c] = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int heads, int kv_heads, int dh, float scale, int causal,
             int window) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);     // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);     // [kBK][D]
  float* ps = vs + kBK * D;           // [kBQ][kBK + 1]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBQ;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const T* qb = q + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
  const T* kb = k + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const T* vb = v + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  T* ob = o + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;

  load_tile<T, D, kBQ>(qs, D + 1, qb, q_stride, q0, sq, dh);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  int kv_end = (sk + kBK - 1) / kBK;
  if (causal) kv_end = min(kv_end, q_last / kBK + 1);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = (q0 - window + 1) / kBK;

  for (int tile = kv_begin; tile < kv_end; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    load_tile<T, D, kBK>(ks, D + 1, kb, kv_stride, k0, sk, dh);
    load_tile<T, D, kBK>(vs, D, vb, kv_stride, k0, sk, dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool keep[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        keep[j] = kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += p;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + reduce16_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) store_float(&ob[row * q_stride + col], acc[i][j] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int heads, int kv_heads, int dh, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (sq + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, heads, kv_heads, dh, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, int b,
                      int sq, int sk, int heads, int kv_heads, int dh, float scale,
                      int causal, int window, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, b, sq, sk, heads, kv_heads, dh, scale, causal,
                         window, stream);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, b, sq, sk, heads, kv_heads, dh, scale, causal,
                          window, stream);
  return launch<T, 256>(q, k, v, o, b, sq, sk, heads, kv_heads, dh, scale, causal,
                        window, stream);
}

}  // namespace

// q, o: [b, sq, heads, dh]; k, v: [b, sk, kv_heads, dh], all contiguous, of
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); dh <= 256; heads a
// multiple of kv_heads; window <= 0 means none.  Returns the CUDA error.
extern "C" int flash_attention(void* o, const void* q, const void* k, const void* v,
                               int b, int sq, int sk, int heads, int kv_heads,
                               int dh, float scale, int causal, int window,
                               int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, b, sq, sk, heads, kv_heads, dh,
                                         scale, causal, window, s)
              : launch_dh<float>(q, k, v, o, b, sq, sk, heads, kv_heads, dh, scale,
                                 causal, window, s);
  return static_cast<int>(err);
}
