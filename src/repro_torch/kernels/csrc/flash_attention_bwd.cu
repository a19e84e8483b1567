// Flash attention backward for Hopper (sm_90a): the gradients of
// flash_attention.cu's forward,
//
//   o[b, i, h, :] = sum_j P[i, j] v[b, j, h', :],  P = softmax_j(c(q_i . k_j * dh^-0.5))
//
// with the forward's masks (causal, sliding window, key padding), GQA by
// index (h' = h / (H/KV)) and soft-cap c(s) = cap * tanh(s / cap) (or the
// identity).  Given dO and the forward's row log-sum-exp LSE it follows
// FlashAttention-2 (Dao, 2023), recomputing P from LSE instead of storing it:
//
//   Delta_i = rowsum(dO_i * O_i)
//   P  = exp(c(S) - LSE),  dV = P^T dO,  dP = dO V^T
//   dS = P * (dP - Delta) * c'(S) * dh^-0.5,  c' = 1 - tanh^2 under a cap
//   dQ = dS K,  dK = dS^T Q
//
// The JAX package has no Pallas backward: it differentiates sdpa_chunked
// with jax.grad.  This kernel is the gradient of the port's replacement of
// src/repro/kernels/flash_attention.py::flash_attention.
//
// Bound: operations.  Five products of 2 dh operations a kept (q, k) pair
// (S, dP, dV, dK, dQ) against q, k, v, o, dO read once and dQ, dK, dV
// written once: at llama3.2-3b's training shape ([1, 1024, 24/8, 128],
// causal) 4.0 GFLOP against 22 MB.
//
// Three launches on the caller's stream, no atomics, so every gradient is
// deterministic:
//   1. delta: one warp a (b, i, h) row, Delta in float32 [B, H, Sq];
//   2. dK and dV: one block a (b, KV head, 64-key block, dh slice), looping
//      over the group's query heads and over the 64-query blocks that keep
//      any of its keys (blocks wholly outside the causal or window band are
//      skipped), so a KV head's gradient sums its heads in registers;
//   3. dQ: one block a (b, head, 64-query block), looping over the key
//      blocks in the band, as the forward does.
// Both 2 and 3 recompute S and dP; the 7 products against FA-2's 5 buy the
// absence of atomics on dQ.
//
// bfloat16, tensor cores (namespace tc).  Blocks of 4 warps; tiles move by
// cp.async into flash_common.cuh's swizzled layout, one stage (a simple
// kernel first: no ring).  In 2 a warp owns 16 keys and computes the
// transposed scores S^T = K Q^T and dP^T = V dO^T with mma.sync (K and V
// as A fragments by ldmatrix, Q and dO as B), so P^T and dS^T are already
// A fragments of dV += P^T dO and dK += dS^T Q (dO and Q by
// ldmatrix.trans); the per-query LSE and Delta sit in shared memory.  dK
// and dV accumulate in float32 registers, 16 keys x a slice of at most 128
// columns each; at dh 256 the grid holds two slices, each recomputing S
// and dP, so that the accumulators fit.  In 3 a warp owns 16 queries:
// S = Q K^T and dP = dO V^T, then dQ += dS K with dS packed from the score
// registers and K by ldmatrix.trans.  P and dS are rounded to bf16 before
// their products; every sum is float32.
//
// float32, CUDA cores (namespace f32).  32 x 32 (q, k) tiles in shared
// memory as float, 256 threads: a thread computes 4 scores of one query
// row, then accumulates 1/8 of a key's (2) or query's (3) row of columns.
#include "flash_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in float32.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int sq,
                             int heads, int dh) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * dh;
  const T* drow = dout + row * dh;
  float s = 0.0f;
  for (int c = lane; c < dh; c += 32) s = fmaf(to_f(orow[c]), to_f(drow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % heads);
    const long long bi = row / heads;
    const int i = static_cast<int>(bi % sq);
    const long long b = bi / sq;
    delta[(b * heads + h) * sq + i] = s;
  }
}

// Whether score (query qp, key kp) is kept by the forward's masks.
__device__ __forceinline__ bool kept(int qp, int kp, int sq, int sk, int causal,
                                     int window) {
  return qp < sq && kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// The query rows [lo, hi) that keep some key of [k0, k_last].
__device__ __forceinline__ void query_band(int k0, int k_last, int sq, int causal,
                                           int window, int* lo, int* hi) {
  *lo = causal ? k0 : 0;
  *hi = window > 0 ? min(sq, k_last + window) : sq;
}

// The key tiles [lo, hi) of kBK keys that some query row of [q0, q_last] keeps.
template <int kBK>
__device__ __forceinline__ void key_band(int q0, int q_last, int sk, int causal,
                                         int window, int* lo, int* hi) {
  *hi = (sk + kBK - 1) / kBK;
  if (causal) *hi = min(*hi, q_last / kBK + 1);
  *lo = window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / kBK : 0;
}

// The arguments of one backward call (see the entry point below).
struct Args {
  void *dq, *dk, *dv;
  float* delta;
  const void *q, *k, *v, *dout;
  const float* lse;
  int b, sq, sk, heads, kv_heads, dh;
  float scale;
  int causal, window;
  float cap;
  cudaStream_t stream;
};

namespace tc {

using namespace flash_common;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;        // keys a block (2) or a tile (3)
constexpr int kBQ = 64;        // queries a tile (2) or a block (3)

template <int D>
constexpr int smem_bytes() {   // K, V, Q, dO tiles, then LSE and Delta
  return (2 * kBK + 2 * kBQ) * D * static_cast<int>(sizeof(bf16)) +
         2 * kBQ * static_cast<int>(sizeof(float));
}

// Per-lane ldmatrix addressing (as in flash_attention.cu).  A fragments of
// 16 rows (r0 + lane % 16, chunks 2kk + lane / 16); B fragments of two
// 8-row n-tiles (rows mr + 8 (mi / 2), chunks 2kk + mi % 2); transposed B
// of 16 k-rows (rows mr + 8 (mi % 2), chunks j + mi / 2).
struct Lanes {
  int aoff[4], boff[4], toff[4];
  int brow, trow;
  __device__ __forceinline__ Lanes(int lane, int D) {
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      aoff[i] = chunk_off(2 * i + (lane >> 4), mr);
      boff[i] = chunk_off(2 * i + (mi & 1), mr);
      toff[i] = chunk_off(2 * i + (mi >> 1), mr);
    }
    brow = (mr + 8 * (mi >> 1)) * D;
    trow = (mr + 8 * (mi & 1)) * D;
  }
};

// acc[16 x 64] (8 n-tiles) += A[16 rows of `a`] . B[64 rows of `b`]^T over
// D columns: a and b are swizzled [rows][D] tiles, `arow` the lane's A row.
template <int D>
__device__ __forceinline__ void scores(float (*acc)[4], const bf16* a, int arow,
                                       const bf16* b, const Lanes& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4(fa, a + arow + ((kk >> 2) << 6) + ln.aoff[kk & 3]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t fb[4];
      ldsm_x4(fb, b + ln.brow + 8 * j * D + ((kk >> 2) << 6) + ln.boff[kk & 3]);
      mma(acc[j], fa, fb[0], fb[1]);
      mma(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[16 x kCols columns from col0] += X[16 x 64] . T[64 rows][col0 ...]:
// X is held as C fragments (8 n-tiles), T a swizzled [64][D] tile read
// transposed.
template <int D, int kCols>
__device__ __forceinline__ void accumulate(float (*acc)[4], const float (*x)[4],
                                           const bf16* t, int col0, const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    c_to_a(fa, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < kCols / 8; j += 2) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, t + ln.trow + 16 * kk * D + col0 + ((j >> 3) << 6) +
                            ln.toff[(j & 7) >> 1]);
      mma(acc[j], fa, fb[0], fb[1]);
      mma(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// P and dS of one score: s the raw q.k, dp the dO.v, lse2 the row's LSE in
// log2 units, dlt its Delta.  Under a cap, c = cap * tanh(s * cap_in).
template <bool kCapped>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float dlt,
                                     float score_log2, float cap_in, float cap,
                                     float scale) {
  if (kCapped) {
    const float t = tanhf(s * cap_in);
    const float p = exp2_approx(cap * t * kLog2e - lse2);
    s = p;
    dp = p * (dp - dlt) * (1.0f - t * t) * scale;
  } else {
    const float p = exp2_approx(fmaf(s, score_log2, -lse2));
    s = p;
    dp = p * (dp - dlt) * scale;
  }
}

// Rows [r0, r0 + 16) x columns [col0, col0 + kCols) of a C-fragment
// accumulator into `out` (row stride `stride`), rows < limit, columns < dh.
template <int kCols>
__device__ __forceinline__ void store_rows(bf16* out, const float (*acc)[4], int r0,
                                           int limit, int col0, int dh,
                                           long long stride, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1);
      const int c = col0 + 8 * j + 2 * tq + (e & 1);
      if (r < limit && c < dh) out[r * stride + c] = __float2bfloat16(acc[j][e]);
    }
  }
}

// 2: dK and dV of 64 keys of one KV head, columns [s0, s0 + DS).
template <int D, int DS, bool kCapped>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int heads,
            int kv_heads, int dh, float score_log2, float cap_in, float cap,
            float scale, int causal, int window, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kBK][D]
  bf16* vs = ks + kBK * D;                       // [kBK][D]
  bf16* qs = vs + kBK * D;                       // [kBQ][D]
  bf16* dos = qs + kBQ * D;                      // [kBQ][D]: dO
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * D);  // [kBQ], log2 units
  float* dlt_s = lse_s + kBQ;                              // [kBQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const Lanes ln(lane, D);
  const int b = blockIdx.x / kv_heads;
  const int kh = blockIdx.x - b * kv_heads;
  const int k0 = blockIdx.y * kBK;
  const int s0 = blockIdx.z * DS;
  const int group = heads / kv_heads;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const long long kv_off = static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const int arow = (warp * 16 + (lane & 15)) * D;   // the warp's 16 keys
  const int wk0 = k0 + warp * 16;

  load_tile<D, kBK, kThreads>(ks, k + kv_off, kv_stride, k0, sk, dh, vec);
  load_tile<D, kBK, kThreads>(vs, v + kv_off, kv_stride, k0, sk, dh, vec);
  cp_commit();

  float dk_acc[DS / 8][4], dv_acc[DS / 8][4];
#pragma unroll
  for (int j = 0; j < DS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  int lo, hi;
  query_band(k0, min(k0 + kBK, sk) - 1, sq, causal, window, &lo, &hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const long long bh = static_cast<long long>(b) * heads + h;
    const long long q_off = static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
    for (int q0 = lo - lo % kBQ; q0 < hi; q0 += kBQ) {
      __syncthreads();   // the previous tile's reads are done
      load_tile<D, kBQ, kThreads>(qs, q + q_off, q_stride, q0, sq, dh, vec);
      load_tile<D, kBQ, kThreads>(dos, dout + q_off, q_stride, q0, sq, dh, vec);
      cp_commit();
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool in = q0 + i < sq;
        lse_s[i] = in ? lse[bh * sq + q0 + i] * kLog2e : 0.0f;
        dlt_s[i] = in ? delta[bh * sq + q0 + i] : 0.0f;
      }
      cp_wait<0>();
      __syncthreads();

      float st[8][4], dpt[8][4];   // S^T, dP^T: 16 keys x 64 queries
      scores<D>(st, ks, arow, qs, ln);
      scores<D>(dpt, vs, arow, dos, ln);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = wk0 + g + 8 * (e >> 1);
          const int ql = 8 * j + 2 * tq + (e & 1);
          if (kept(q0 + ql, kp, sq, sk, causal, window)) {
            p_ds<kCapped>(st[j][e], dpt[j][e], lse_s[ql], dlt_s[ql], score_log2,
                          cap_in, cap, scale);
          } else {
            st[j][e] = 0.0f;
            dpt[j][e] = 0.0f;
          }
        }
      }
      accumulate<D, DS>(dv_acc, st, dos, s0, ln);   // dV += P^T dO
      accumulate<D, DS>(dk_acc, dpt, qs, s0, ln);   // dK += dS^T Q
    }
  }
  store_rows<DS>(dk + kv_off, dk_acc, wk0, sk, s0, dh, kv_stride, lane);
  store_rows<DS>(dv + kv_off, dv_acc, wk0, sk, s0, dh, kv_stride, lane);
}

// 3: dQ of 64 query rows of one head.
template <int D, bool kCapped>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int sq, int sk, int heads, int kv_heads, int dh,
          float score_log2, float cap_in, float cap, float scale, int causal,
          int window, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][D]
  bf16* dos = qs + kBQ * D;                      // [kBQ][D]: dO
  bf16* ks = dos + kBQ * D;                      // [kBK][D]
  bf16* vs = ks + kBK * D;                       // [kBK][D]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const Lanes ln(lane, D);
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
  const int kh = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // the long causal rows first
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const long long q_off = static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
  const long long kv_off = static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const int arow = (warp * 16 + (lane & 15)) * D;   // the warp's 16 queries
  const int wq0 = q0 + warp * 16;

  load_tile<D, kBQ, kThreads>(qs, q + q_off, q_stride, q0, sq, dh, vec);
  load_tile<D, kBQ, kThreads>(dos, dout + q_off, q_stride, q0, sq, dh, vec);
  cp_commit();
  float lse2[2], dlt[2];   // the thread's rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    lse2[r] = row < sq ? lse[bh * sq + row] * kLog2e : 0.0f;
    dlt[r] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.0f;

  int lo, hi;
  key_band<kBK>(q0, min(q0 + kBQ, sq) - 1, sk, causal, window, &lo, &hi);
  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();   // the previous tile's reads are done
    load_tile<D, kBK, kThreads>(ks, k + kv_off, kv_stride, k0, sk, dh, vec);
    load_tile<D, kBK, kThreads>(vs, v + kv_off, kv_stride, k0, sk, dh, vec);
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];   // S, dP: 16 queries x 64 keys
    scores<D>(s, qs, arow, ks, ln);
    scores<D>(dp, dos, arow, vs, ln);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
        if (kept(wq0 + g + 8 * r, kp, sq, sk, causal, window)) {
          p_ds<kCapped>(s[j][e], dp[j][e], lse2[r], dlt[r], score_log2, cap_in, cap,
                        scale);
        } else {
          dp[j][e] = 0.0f;
        }
      }
    }
    accumulate<D, D>(dq_acc, dp, ks, 0, ln);   // dQ += dS K
  }
  store_rows<D>(dq + q_off, dq_acc, wq0, sq, 0, dh, q_stride, lane);
}

template <int D, bool kCapped>
cudaError_t launch(const Args& a) {
  constexpr int DS = D < 128 ? D : 128;
  constexpr int kSmem = smem_bytes<D>();
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = a.dh % 8 == 0 && any % 16 == 0;
  const float score_log2 = kCapped ? kLog2e : a.scale * kLog2e;
  const float cap_in = kCapped ? a.scale / a.cap : 0.0f;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  cudaError_t err;
  if (a.sk > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<D, DS, kCapped>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.b * a.kv_heads, (a.sk + kBK - 1) / kBK, D / DS);
    dkdv_kernel<D, DS, kCapped><<<grid, kThreads, kSmem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.sq, a.sk, a.heads, a.kv_heads, a.dh, score_log2, cap_in, a.cap, a.scale,
        a.causal, a.window, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(dq_kernel<D, kCapped>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.heads, (a.sq + kBQ - 1) / kBQ);
  dq_kernel<D, kCapped><<<grid, kThreads, kSmem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.sq, a.sk, a.heads,
      a.kv_heads, a.dh, score_log2, cap_in, a.cap, a.scale, a.causal, a.window, vec);
  return cudaGetLastError();
}

}  // namespace tc

namespace f32 {

constexpr int kB = 32;          // queries and keys a tile
constexpr int kThreads = 256;

template <int D>
constexpr int smem_bytes() {    // Q, dO, K, V as float, P, dS, LSE, Delta
  return static_cast<int>(sizeof(float)) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

template <int D>
struct Tiles {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse_s, *dlt_s;
  __device__ __forceinline__ explicit Tiles(float* smem) {
    qs = smem;
    dos = qs + kB * (D + 1);
    ks = dos + kB * (D + 1);
    vs = ks + kB * (D + 1);
    ps = vs + kB * (D + 1);
    dss = ps + kB * (kB + 1);
    lse_s = dss + kB * (kB + 1);
    dlt_s = lse_s + kB;
  }
};

// Rows [r0, r0 + kB) of one head into a [kB][D + 1] float tile, zero past
// `limit` rows and dh columns.
__device__ __forceinline__ void load_rows(float* dst, int width, const float* src,
                                          long long stride, int r0, int limit, int dh) {
  for (int i = threadIdx.x; i < kB * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    dst[r * (width + 1) + c] = r0 + r < limit && c < dh ? src[(r0 + r) * stride + c] : 0.0f;
  }
}

// P and dS of the (q0, k0) tile into ps and dss: thread t takes query row
// t / 8 and keys t % 8 + 8c.
template <int D>
__device__ __forceinline__ void tile_p_ds(const Tiles<D>& sm, int q0, int k0, int sq,
                                          int sk, int dh, float scale, int causal,
                                          int window, float cap) {
  const int i = threadIdx.x >> 3;
  const int jj = threadIdx.x & 7;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = 0; d < dh; ++d) {
    const float qv = sm.qs[i * (D + 1) + d];
    const float dov = sm.dos[i * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = fmaf(qv, sm.ks[(jj + 8 * c) * (D + 1) + d], s[c]);
      dp[c] = fmaf(dov, sm.vs[(jj + 8 * c) * (D + 1) + d], dp[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jj + 8 * c;
    float p = 0.0f, ds = 0.0f;
    if (kept(q0 + i, k0 + j, sq, sk, causal, window)) {
      float x = s[c] * scale;
      float slope = scale;
      if (cap > 0.0f) {
        const float t = tanhf(x / cap);
        x = cap * t;
        slope *= 1.0f - t * t;
      }
      p = expf(x - sm.lse_s[i]);
      ds = p * (dp[c] - sm.dlt_s[i]) * slope;
    }
    sm.ps[i * (kB + 1) + j] = p;
    sm.dss[i * (kB + 1) + j] = ds;
  }
}

// LSE and Delta of query rows [q0, q0 + kB) of row block bh.
__device__ __forceinline__ void load_stats(float* lse_s, float* dlt_s, const float* lse,
                                           const float* delta, long long bh, int q0,
                                           int sq) {
  for (int i = threadIdx.x; i < kB; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[bh * sq + q0 + i] : 0.0f;
    dlt_s[i] = in ? delta[bh * sq + q0 + i] : 0.0f;
  }
}

// 2: dK and dV of 32 keys of one KV head.  Thread t accumulates key
// t / 8, columns t % 8 + 8c.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int heads,
            int kv_heads, int dh, float scale, int causal, int window, float cap) {
  extern __shared__ float smem[];
  const Tiles<D> sm(smem);
  const int b = blockIdx.x / kv_heads;
  const int kh = blockIdx.x - b * kv_heads;
  const int k0 = blockIdx.y * kB;
  const int group = heads / kv_heads;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const long long kv_off = static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const int jr = threadIdx.x >> 3;
  const int c0 = threadIdx.x & 7;

  load_rows(sm.ks, D, k + kv_off, kv_stride, k0, sk, dh);
  load_rows(sm.vs, D, v + kv_off, kv_stride, k0, sk, dh);
  float dk_acc[D / 8], dv_acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

  int lo, hi;
  query_band(k0, min(k0 + kB, sk) - 1, sq, causal, window, &lo, &hi);
  for (int hh = 0; hh < group; ++hh) {
    const int h = kh * group + hh;
    const long long bh = static_cast<long long>(b) * heads + h;
    const long long q_off = static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
    for (int q0 = lo - lo % kB; q0 < hi; q0 += kB) {
      __syncthreads();
      load_rows(sm.qs, D, q + q_off, q_stride, q0, sq, dh);
      load_rows(sm.dos, D, dout + q_off, q_stride, q0, sq, dh);
      load_stats(sm.lse_s, sm.dlt_s, lse, delta, bh, q0, sq);
      __syncthreads();
      tile_p_ds<D>(sm, q0, k0, sq, sk, dh, scale, causal, window, cap);
      __syncthreads();
      for (int i = 0; i < kB; ++i) {
        const float p = sm.ps[i * (kB + 1) + jr];
        const float ds = sm.dss[i * (kB + 1) + jr];
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          dv_acc[c] = fmaf(p, sm.dos[i * (D + 1) + c0 + 8 * c], dv_acc[c]);
          dk_acc[c] = fmaf(ds, sm.qs[i * (D + 1) + c0 + 8 * c], dk_acc[c]);
        }
      }
    }
  }
  if (k0 + jr < sk) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c0 + 8 * c;
      if (col < dh) {
        dk[kv_off + (k0 + jr) * kv_stride + col] = dk_acc[c];
        dv[kv_off + (k0 + jr) * kv_stride + col] = dv_acc[c];
      }
    }
  }
}

// 3: dQ of 32 query rows of one head.  Thread t accumulates query t / 8,
// columns t % 8 + 8c.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int sq, int sk, int heads, int kv_heads, int dh,
          float scale, int causal, int window, float cap) {
  extern __shared__ float smem[];
  const Tiles<D> sm(smem);
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kB;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const long long q_off = static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
  const long long kv_off = static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const int ir = threadIdx.x >> 3;
  const int c0 = threadIdx.x & 7;

  load_rows(sm.qs, D, q + q_off, q_stride, q0, sq, dh);
  load_rows(sm.dos, D, dout + q_off, q_stride, q0, sq, dh);
  load_stats(sm.lse_s, sm.dlt_s, lse, delta, bh, q0, sq);
  float dq_acc[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dq_acc[c] = 0.0f;

  int lo, hi;
  key_band<kB>(q0, min(q0 + kB, sq) - 1, sk, causal, window, &lo, &hi);
  for (int tile = lo; tile < hi; ++tile) {
    const int k0 = tile * kB;
    __syncthreads();
    load_rows(sm.ks, D, k + kv_off, kv_stride, k0, sk, dh);
    load_rows(sm.vs, D, v + kv_off, kv_stride, k0, sk, dh);
    __syncthreads();
    tile_p_ds<D>(sm, q0, k0, sq, sk, dh, scale, causal, window, cap);
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      const float ds = sm.dss[ir * (kB + 1) + j];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        dq_acc[c] = fmaf(ds, sm.ks[j * (D + 1) + c0 + 8 * c], dq_acc[c]);
    }
  }
  if (q0 + ir < sq) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = c0 + 8 * c;
      if (col < dh) dq[q_off + (q0 + ir) * q_stride + col] = dq_acc[c];
    }
  }
}

template <int D>
cudaError_t launch(const Args& a) {
  constexpr int kSmem = smem_bytes<D>();
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (a.sk > 0) {
    err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.b * a.kv_heads, (a.sk + kB - 1) / kB);
    dkdv_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.sq, a.sk, a.heads, a.kv_heads, a.dh, a.scale, a.causal, a.window, a.cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.heads, (a.sq + kB - 1) / kB);
  dq_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk, a.heads,
      a.kv_heads, a.dh, a.scale, a.causal, a.window, a.cap);
  return cudaGetLastError();
}

}  // namespace f32

template <int D>
cudaError_t launch(const Args& a, bool is_bf16) {
  if (!is_bf16) return f32::launch<D>(a);
  return a.cap > 0.0f ? tc::launch<D, true>(a) : tc::launch<D, false>(a);
}

}  // namespace

// q, o, dout, dq: [b, sq, heads, dh]; k, v, dk, dv: [b, sk, kv_heads, dh];
// lse (the forward's) and delta (scratch): float32 [b, heads, sq].  All
// contiguous, of float32 (is_bf16 = 0: CUDA cores) or bfloat16 (is_bf16 = 1:
// tensor cores); dh <= 256; heads a multiple of kv_heads; window <= 0 means
// none; softcap <= 0 means none.  Every element of dq, dk and dv is written.
// Returns the CUDA error.
extern "C" int flash_attention_bwd(void* dq, void* dk, void* dv, void* delta,
                                   const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   int b, int sq, int sk, int heads, int kv_heads,
                                   int dh, float scale, int causal, int window,
                                   float softcap, int is_bf16, void* stream) {
  if (b <= 0 || heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  const long long rows = static_cast<long long>(b) * sq * heads;
  if (rows > 0) {
    const int blocks = static_cast<int>((rows * 32 + 255) / 256);
    if (is_bf16)
      delta_kernel<<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(o),
                                          static_cast<const __nv_bfloat16*>(dout), dl, rows,
                                          sq, heads, dh);
    else
      delta_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
                                          static_cast<const float*>(dout), dl, rows, sq,
                                          heads, dh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq <= 0) {   // no query: dK and dV are zero
    const size_t n = static_cast<size_t>(b) * sk * kv_heads * dh * (is_bf16 ? 2 : 4);
    cudaError_t err = cudaMemsetAsync(dk, 0, n, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, s);
    return static_cast<int>(err);
  }
  const Args a{dq, dk, dv, dl, q, k, v, dout, ls, b, sq, sk, heads, kv_heads, dh,
               scale, causal, window, softcap, s};
  const cudaError_t err = dh <= 64    ? launch<64>(a, is_bf16)
                          : dh <= 128 ? launch<128>(a, is_bf16)
                                      : launch<256>(a, is_bf16);
  return static_cast<int>(err);
}
