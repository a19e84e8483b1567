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
// (S, dP, dV, dK, dQ) against q, k, v, o, dO and LSE read once and dQ, dK,
// dV written once: at llama3.2-3b's training shape ([1, 1024, 24/8, 128],
// causal: 12,595,200 kept pairs) 16.1 GFLOP against 33.6 MB, 0.0163 ms at
// 989 TFLOP/s.
//
// bfloat16, tensor cores (namespace tc): three launches on the caller's
// stream, one pass over the (key block, query tile) pairs.
//   1. delta: one warp a (b, i, h) row, Delta in float32 [B, H, Sq]; the
//      same warp zeroes that row of dQ's float32 accumulator.
//   2. tile: one CTA a (b, query head, 64-key block), the long causal key
//      blocks first (blockIdx.y = 0 keeps the most query rows, and blocks
//      start in index order).  It walks the query tiles of its band once,
//      computing S^T = K Q^T and dP^T = V dO^T once a (key block, query
//      tile): dV += P^T dO and dK += dS^T Q accumulate in registers; dS^T
//      goes to shared memory once, and dQ += dS K is added into the
//      accumulator [B, Sq, H, dh] with float32 atomics (two floats an
//      atomic).  At H = KV the CTA stores dK and dV in bf16.  The CTAs of a
//      GQA group's query heads at one key block form a thread-block cluster
//      (groups of up to 8): each puts its dK and dV in its shared memory,
//      and each sums a share of the rows over the group's CTAs through
//      distributed shared memory, in head order, and stores them in bf16.
//      A larger group stores float32 partials [B, Sk, H, dh] instead.  A
//      key block that no query keeps (causal, Sq < Sk) loads nothing and
//      stores zeros.
//   3. convert: dq = bf16(accumulator); for a group larger than a cluster
//      also dk and dv = bf16(the group's partials summed in head order).
// Determinism: the atomics add a dQ element's key blocks in the order the
// CTAs reach them, so bf16 dq's last bits vary from run to run, as in
// PyTorch's flash backward.  dK and dV are summed in a fixed order and do
// not vary.
//
// Tiles.  A CTA holds 64 keys, a warp 16 of them, over query tiles of 64
// (dh <= 128: one warpgroup, 128 threads).  Tiles move by cp.async into
// shared memory as 64-column blocks with the 128-byte swizzle: K and V once;
// Q, dO, LSE and Delta through a 2-stage ring (commit_group / wait_group
// 1), so tile i + 1's copy is in flight while tile i computes.  The five
// products are wgmma (sm_90a) on the warpgroup: S^T and dP^T with K, V, Q
// and dO from shared memory; dV += P^T dO and dK += dS^T Q with P^T and
// dS^T from registers (the score accumulators, rounded to bf16, are
// already A fragments) and dO and Q read N-major; dQ += dS K with dS^T
// (stored once a tile in the same swizzled layout) and K both read
// transposed.  At dh 256 the accumulators of one warpgroup would not fit:
// two warpgroups share the 64 keys (256 threads, query tiles of 32), one
// computes S^T and the other dP^T, they swap them through shared memory,
// and each accumulates dK and dV for 128 of the columns, so no product is
// computed twice; there dQ (m = 32 queries, below wgmma's 64) runs on
// mma.sync from ldmatrix.  Masks are tested score by score only on tiles
// that straddle an edge (the causal diagonal, the window's start, Sq or
// Sk): interior tiles skip the test.  P and dS are rounded to bf16 before
// their products; every sum is float32.  Registers (ptxas, sm_90a,
// uncapped / capped): 163 / 179 at dh 64, 249 / 244 at dh 128, 255 / 255 at
// dh 256, no spills.
//
// float32, CUDA cores (namespace f32), the parity path: deterministic, no
// atomics.  Three launches: delta; dK and dV, one block a (b, KV head,
// 32-key block) looping over the group's heads and the query blocks of its
// band; dQ, one block a (b, head, 32-query block).  32 x 32 (q, k) tiles in
// shared memory as float, 256 threads: a thread computes 4 scores of one
// query row, then accumulates 1/8 of a key's or query's row of columns.
#include "flash_common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(x); else return x;
}

// Delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in float32; with
// `zero`, the same row of a float32 [B, Sq, H, dh] buffer is zeroed.  With
// `vec` (bf16 rows of a multiple of 8, 16-byte aligned) a lane reads 8
// values at once.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, float* __restrict__ zero,
                             long long rows, int sq, int heads, int dh, int vec) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * dh;
  const T* drow = dout + row * dh;
  float s = 0.0f;
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      for (int c = 8 * lane; c < dh; c += 256) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(xp[e]), d = __bfloat1622float2(yp[e]);
          s = fmaf(a.x, d.x, fmaf(a.y, d.y, s));
        }
      }
    } else {
      for (int c = lane; c < dh; c += 32) s = fmaf(to_f(orow[c]), to_f(drow[c]), s);
    }
  } else {
    for (int c = lane; c < dh; c += 32) s = fmaf(to_f(orow[c]), to_f(drow[c]), s);
  }
  if (zero != nullptr) {
    if (dh % 4 == 0) {
      for (int c = 4 * lane; c < dh; c += 128)
        *reinterpret_cast<float4*>(zero + row * dh + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int c = lane; c < dh; c += 32) zero[row * dh + c] = 0.0f;
    }
  }
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

// GQA groups of up to this many query heads sum dK and dV in a thread-block
// cluster (the portable cluster size); larger groups through partials.
constexpr int kMaxCluster = 8;

// The arguments of one backward call (see the entry point below).  The
// float32 buffers are carved from the caller's scratch.
struct Args {
  void *dq, *dk, *dv;
  float *delta, *dq_accum, *dk_part, *dv_part;
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
constexpr int kStages = 2;     // Q/dO/LSE/Delta ring depth

// The tiles at head dim D (dh padded to 64, 128 or 256): a CTA holds 64
// keys, a warp 16 of them (warp kw of each warpgroup).  At dh 256 two
// warpgroups share the keys (kSplit 2), each holding dK and dV for half the
// columns, and dQ's tile [kBQ][D] is cut into units of 16 rows x 64
// columns for mma.sync, kUnits a warp.
template <int D>
struct Cfg {
  static constexpr int kKeyWarps = 4;
  static constexpr int kSplit = D > 128 ? 2 : 1;
  static constexpr int kWarps = kKeyWarps * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = 16 * kKeyWarps;      // keys a CTA
  static constexpr int kBQ = D > 128 ? 32 : 64;   // queries a tile
  static constexpr int kCols = D / kSplit;        // dK/dV columns a warpgroup
  static constexpr bool kWgDq = kBQ == 64;        // dQ by wgmma (its M is 64)
  static constexpr int kDS = kWgDq ? kBQ : kBQ + 8;   // dS^T's row stride (bf16)
  static constexpr int kMT = kBQ / 16;            // dQ's m-tiles (mma.sync)
  static constexpr int kUnits = kMT * (D / 64) / kWarps;
  static constexpr int kXch = kSplit > 1 ? kWarps * 16 * kBQ : 0;   // floats
  static constexpr int kSmem =   // + 1024 to align the tiles
      (2 * kBK * D + 2 * kStages * kBQ * D + kBK * kDS) * static_cast<int>(sizeof(bf16)) +
      (2 * kStages * kBQ + kXch) * static_cast<int>(sizeof(float)) + 1024;
  static_assert(kWgDq || kMT * (D / 64) % kWarps == 0, "whole dQ units a warp");
};

// 4 bytes by cp.async, zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0) : "memory");
}

// Adds (x, y) to dst[0], dst[1] in global memory (columns c, c + 1 of dh).
__device__ __forceinline__ void add_pair(float* dst, float x, float y, int c, int dh) {
  if ((dh & 1) == 0 && c + 1 < dh) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(x, y));
  } else {
    if (c < dh) atomicAdd(dst, x);
    if (c + 1 < dh) atomicAdd(dst + 1, y);
  }
}

// Tiles of rows x D bf16 values live in shared memory as D / 64 blocks of
// [rows][64], each 128-byte row's 16-byte chunks XOR-swizzled by row
// (chunk ^ row % 8), on 1024-byte boundaries: the 128-byte swizzle that
// wgmma's descriptors name, and bank-conflict free for ldmatrix.  The
// element offset of chunk c of row r:
template <int kRows>
__device__ __forceinline__ int blk(int r, int c) {
  return (c >> 3) * kRows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Rows [r0, r0 + kRows) of one head into a blocked [kRows][D] tile, zero
// past `limit` rows and past dh columns; `stride` is heads * dh.  With
// `vec` by cp.async in 16-byte pieces (the caller commits and waits), else
// element by element.  kThreads threads of the block share the copy.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_blk(bf16* dst, const bf16* src, long long stride,
                                         int r0, int limit, int dh, bool vec) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "whole passes of the block");
  if (vec) {
#pragma unroll
    for (int pass = 0; pass < kRows * kChunks / kThreads; ++pass) {
      const int i = pass * kThreads + threadIdx.x;
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool full = r0 + r < limit && c * 8 < dh;
      const bf16* from = full ? src + (r0 + r) * stride + c * 8 : src;
      cp_async16(dst + blk<kRows>(r, c), from, full);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      bf16 x = __float2bfloat16(0.0f);
      if (r0 + r < limit && c < dh) x = src[(r0 + r) * stride + c];
      dst[blk<kRows>(r, c >> 3) + (c & 7)] = x;
    }
  }
}

// Per-lane ldmatrix addressing of transposed B fragments of 16 k-rows in a
// blocked tile (rows mr + 8 (mi % 2), chunks j + mi / 2): offsets within a
// 64-column block; the block's own offset is the caller's.
struct Lanes {
  int toff[4];
  int trow;
  __device__ __forceinline__ explicit Lanes(int lane) {
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) toff[i] = chunk_off(2 * i + (mi >> 1), mr);
    trow = (mr + 8 * (mi & 1)) * 64;
  }
};

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

// A warp's C fragments [kNT][4] to and from the pair's exchange buffer,
// element-major so that the 32 lanes touch 32 consecutive floats.
template <int kNT>
__device__ __forceinline__ void to_xch(float* dst, const float (*x)[4], int lane) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * j + e) * 32 + lane] = x[j][e];
}
template <int kNT>
__device__ __forceinline__ void from_xch(float (*x)[4], const float* src, int lane) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = src[(4 * j + e) * 32 + lane];
}

// dq rows q0 + [0, 64) += dS . K by wgmma, the CTA's one warpgroup: dS^T
// as a blocked [64 keys][64 queries] tile (A, M-major) and K a blocked
// [64][D] tile (B, N-major), 64 columns at a time, added into the float32
// accumulator `dq` (row stride `stride`).
template <int D>
__device__ __forceinline__ void dq_wg(float* dq, const bf16* dss, const bf16* ks, int q0,
                                      int sq, int dh, long long stride, int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb) {
    float acc[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n64<1, 1>(acc, gmma_desc_mn(dss + 16 * kk * 64, 64 * 128),
                      gmma_desc_mn(ks + nb * 64 * 64 + 16 * kk * 64, 64 * 128), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_acc<8>(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row >= sq) continue;
      float* dst = dq + row * stride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * nb + 8 * j + 2 * tq;
        add_pair(dst + c, acc[j][2 * r], acc[j][2 * r + 1], c, dh);
      }
    }
  }
}

// dq[rows q0 + 16 m + [0, 16)] x [columns c0, c0 + 64) += dS . K over the
// CTA's kBK keys by mma.sync (dh 256), added into the float32 accumulator
// `dq` (row stride `stride`): dS from dS^T [kBK][kDS] and K (a blocked
// [kBK][D] tile, c0 a multiple of 64) in shared memory, both read
// transposed.
template <int D, int kBK, int kDS>
__device__ __forceinline__ void dq_unit(float* dq, const bf16* dss, const bf16* ks,
                                        int m, int c0, int q0, int sq, int dh,
                                        long long stride, const Lanes& ln, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* a = dss + (mr + 8 * (mi >> 1)) * kDS + 16 * m + 8 * (mi & 1);
  const bf16* t = ks + ln.trow + (c0 >> 6) * kBK * 64;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t fa[4];
    ldsm_x4_trans(fa, a + 16 * kk * kDS);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t fb[4];
      ldsm_x4_trans(fb, t + 16 * kk * 64 + ln.toff[j >> 1]);
      mma(acc[j], fa, fb[0], fb[1]);
      mma(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * m + g + 8 * r;
    if (row >= sq) continue;
    float* dst = dq + row * stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      add_pair(dst + c, acc[j][2 * r], acc[j][2 * r + 1], c, dh);
    }
  }
}

// Rows [r0, r0 + 16) x columns [col0, col0 + kCols) of a C-fragment
// accumulator into `out` (row stride `stride`), rows < limit, columns < dh:
// bf16 pairs, or float32 pairs (T = float).
template <int kCols, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4], int r0,
                                           int limit, int col0, int dh,
                                           long long stride, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= limit) continue;
    T* dst = out + row * stride;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      const int c = col0 + 8 * j + 2 * tq;
      const float x = acc[j][2 * r], y = acc[j][2 * r + 1];
      if ((dh & 1) == 0 && c + 1 < dh) {
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(x, y);
        } else {
          *reinterpret_cast<float2*>(dst + c) = make_float2(x, y);
        }
      } else {
        if (c < dh) dst[c] = from_f<T>(x);
        if (c + 1 < dh) dst[c + 1] = from_f<T>(y);
      }
    }
  }
}

// 2: one (b, query head, key block): dK and dV of the block's keys over
// its band of query tiles, and the block's share of dQ.
template <int D, bool kCapped>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
bwd_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq_accum, bf16* __restrict__ dk, bf16* __restrict__ dv,
                float* __restrict__ dk_part, float* __restrict__ dv_part, int sq, int sk,
                int heads, int kv_heads, int dh, float score_log2, float cap_in,
                float cap, float scale, int causal, int window, int vec, int clustered) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK, kBQ = C::kBQ, kDS = C::kDS, kCols = C::kCols;
  constexpr int kThreads = C::kThreads, kWarps = C::kWarps;
  constexpr int kNT = kBQ / 8;             // n-tiles of S^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles on 1024-byte boundaries (the 128-byte swizzle's period)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(smem);                   // [kBK][D]
  bf16* vs = ks + kBK * D;                                    // [kBK][D]
  bf16* qs = vs + kBK * D;                                    // [kStages][kBQ][D]
  bf16* dos = qs + kStages * kBQ * D;                         // [kStages][kBQ][D]: dO
  bf16* dss = dos + kStages * kBQ * D;                        // [kBK][kDS]: dS^T
                                                              // (blocked if kWgDq)
  float* lse_s = reinterpret_cast<float*>(dss + kBK * kDS);   // [kStages][kBQ]
  float* dlt_s = lse_s + kStages * kBQ;                       // [kStages][kBQ]
  float* xch = dlt_s + kStages * kBQ;                         // [kWarps][16 kBQ]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = warp % C::kKeyWarps;     // the warp's 16 keys
  const int half = C::kSplit == 1 ? 0 : warp / C::kKeyWarps;   // its warpgroup
  const Lanes ln(lane);
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * heads);
  const int group = heads / kv_heads;
  const int kh = h / group;
  const int k0 = blockIdx.y * kBK;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const long long q_off = static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
  const long long kv_off = static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const int wk0 = k0 + kw * 16;

  int lo, hi;
  query_band(k0, min(k0 + kBK, sk) - 1, sq, causal, window, &lo, &hi);
  const int t0 = lo / kBQ;
  const int tiles = hi > lo ? (hi + kBQ - 1) / kBQ - t0 : 0;

  // Query tile t of the band (Q, dO, LSE, Delta) into ring stage t % kStages.
  auto fetch = [&](int t) {
    const int stage = t % kStages;
    const int q0 = (t0 + t) * kBQ;
    load_blk<D, kBQ, kThreads>(qs + stage * kBQ * D, q + q_off, q_stride, q0, sq, dh, vec);
    load_blk<D, kBQ, kThreads>(dos + stage * kBQ * D, dout + q_off, q_stride, q0, sq, dh,
                               vec);
    for (int i = threadIdx.x; i < 2 * kBQ; i += kThreads) {
      const int r = i % kBQ;
      const bool in = q0 + r < sq;
      const float* src = (i < kBQ ? lse : delta) + bh * sq;
      cp_async4((i < kBQ ? lse_s : dlt_s) + stage * kBQ + r, in ? src + q0 + r : src, in);
    }
  };

  // K and V only where some query keeps the block: a block with no query
  // tile issues no copy, so none can land after the loop
  if (tiles > 0) {
    load_blk<D, kBK, kThreads>(ks, k + kv_off, kv_stride, k0, sk, dh, vec);
    load_blk<D, kBK, kThreads>(vs, v + kv_off, kv_stride, k0, sk, dh, vec);
    fetch(0);
  }
  cp_commit();

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kStages;
    const int q0 = (t0 + t) * kBQ;
    if (t + 1 < tiles) fetch(t + 1);
    cp_commit();
    cp_wait<1>();      // tile t (and K, V) landed; tile t + 1 in flight
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // for wgmma
    __syncthreads();   // ... for every thread; the last tile's dQ reads are done
    const bf16* qt = qs + stage * kBQ * D;
    const bf16* dot = dos + stage * kBQ * D;
    const float* lt = lse_s + stage * kBQ;
    const float* dt = dlt_s + stage * kBQ;

    float st[kNT][4], dpt[kNT][4];   // S^T, dP^T: 16 keys x kBQ queries
    if constexpr (C::kSplit == 1) {   // the one warpgroup computes both
      wgmma_fence();
      scores_wg<D, kBK, kBQ>(st, ks, qt);
      scores_wg<D, kBK, kBQ>(dpt, vs, dot);
      wgmma_commit();
      wgmma_wait();
      fence_acc<kNT>(st);
      fence_acc<kNT>(dpt);
    } else {   // warpgroup 0 computes S^T, warpgroup 1 dP^T; each warp swaps
               // its 16 keys' with the other warpgroup's warp kw
      float* mine = xch + warp * 16 * kBQ;
      const float* theirs = xch + (warp ^ C::kKeyWarps) * 16 * kBQ;
      wgmma_fence();
      if (half == 0) {
        scores_wg<D, kBK, kBQ>(st, ks, qt);
        wgmma_commit();
        wgmma_wait();
        fence_acc<kNT>(st);
        to_xch<kNT>(mine, st, lane);
      } else {
        scores_wg<D, kBK, kBQ>(dpt, vs, dot);
        wgmma_commit();
        wgmma_wait();
        fence_acc<kNT>(dpt);
        to_xch<kNT>(mine, dpt, lane);
      }
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + kw), "n"(64) : "memory");
      if (half == 0) {
        from_xch<kNT>(dpt, theirs, lane);
      } else {
        from_xch<kNT>(st, theirs, lane);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int ql = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + ql);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_ds<kCapped>(st[j][e], dpt[j][e], (e & 1 ? l2.y : l2.x) * kLog2e,
                      e & 1 ? d2.y : d2.x, score_log2, cap_in, cap, scale);
    }
    // scores outside the masks only on tiles that straddle an edge
    const bool edge = q0 + kBQ > sq || k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kept(q0 + 8 * j + 2 * tq + (e & 1), wk0 + g + 8 * (e >> 1), sq, sk, causal,
                    window))
            st[j][e] = dpt[j][e] = 0.0f;
    }
    // dV += P^T dO and dK += dS^T Q, the warpgroup's kCols columns
    wgmma_fence();
    accumulate_wg<kCols, kBQ>(dv_acc, st, dot + half * (kCols / 64) * kBQ * 64);
    accumulate_wg<kCols, kBQ>(dk_acc, dpt, qt + half * (kCols / 64) * kBQ * 64);
    wgmma_commit();
    wgmma_wait();
    fence_acc<kCols / 8>(dv_acc);
    fence_acc<kCols / 8>(dk_acc);
    if (half == 0) {   // dS^T to shared memory, once
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = kw * 16 + g + 8 * r;
          const int at = C::kWgDq ? blk<kBK>(row, j) + 2 * tq : row * kDS + 8 * j + 2 * tq;
          *reinterpret_cast<uint32_t*>(dss + at) = pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
        }
    }
    if constexpr (C::kWgDq) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // dS^T complete
    if constexpr (C::kWgDq) {   // dQ += dS K, into the accumulator
      dq_wg<D>(dq_accum + q_off, dss, ks, q0, sq, dh, q_stride, warp, lane);
    } else {
#pragma unroll
      for (int i = 0; i < C::kUnits; ++i) {
        const int u = warp + i * kWarps;
        dq_unit<D, kBK, kDS>(dq_accum + q_off, dss, ks, u % C::kMT, (u / C::kMT) * 64, q0,
                             sq, dh, q_stride, ln, lane);
      }
    }
  }
  if (clustered) {
    // The group's CTAs of this key block form one cluster (rank h % group):
    // each puts its dK and dV in its shared memory, then sums the group's
    // in rank order over the rows r = rank mod group and stores them.
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    constexpr int kPS = D + 4;   // a partial's row stride in floats
    static_assert(2 * kBK * kPS * static_cast<int>(sizeof(float)) <= C::kSmem - 1024,
                  "the partials fit in the tiles' shared memory");
    float* part = reinterpret_cast<float*>(smem);   // [2][kBK][kPS]: dK, dV
    cp_wait<0>();      // no copy lands on the partials
    __syncthreads();   // ... and the tiles' last reads are done
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (kw * 16 + g + 8 * r) * kPS + half * kCols + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(part + at) = make_float2(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
        *reinterpret_cast<float2*>(part + kBK * kPS + at) =
            make_float2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    for (int i = threadIdx.x; i < kBK * (D / 4); i += kThreads) {
      const int r = i / (D / 4);
      const int c = 4 * (i % (D / 4));
      if (r % group != rank || k0 + r >= sk || c >= dh) continue;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int m = 0; m < group; ++m) {
        const float* peer = cluster.map_shared_rank(part, m);
        const float4 a = *reinterpret_cast<const float4*>(peer + r * kPS + c);
        const float4 d = *reinterpret_cast<const float4*>(peer + (kBK + r) * kPS + c);
        x[0] += a.x, x[1] += a.y, x[2] += a.z, x[3] += a.w;
        y[0] += d.x, y[1] += d.y, y[2] += d.z, y[3] += d.w;
      }
      bf16* to_k = dk + kv_off + (k0 + r) * kv_stride + c;
      bf16* to_v = dv + kv_off + (k0 + r) * kv_stride + c;
      if (dh % 4 == 0) {
        *reinterpret_cast<uint2*>(to_k) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
        *reinterpret_cast<uint2*>(to_v) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
      } else {
        for (int e = 0; e < 4 && c + e < dh; ++e) {
          to_k[e] = __float2bfloat16(x[e]);
          to_v[e] = __float2bfloat16(y[e]);
        }
      }
    }
    cluster.sync();   // the peers have read this CTA's partials
  } else if (group == 1) {
    store_rows<kCols>(dk + kv_off, dk_acc, wk0, sk, half * kCols, dh, kv_stride, lane);
    store_rows<kCols>(dv + kv_off, dv_acc, wk0, sk, half * kCols, dh, kv_stride, lane);
  } else {   // this head's partials [B, Sk, H, dh]
    const long long part = static_cast<long long>(b) * sk * q_stride + static_cast<long long>(h) * dh;
    store_rows<kCols>(dk_part + part, dk_acc, wk0, sk, half * kCols, dh, q_stride, lane);
    store_rows<kCols>(dv_part + part, dv_acc, wk0, sk, half * kCols, dh, q_stride, lane);
  }
}

// 3: dq = bf16(dq_accum) over n_q elements; with group > 1 also dk and dv
// (n_kv elements each, [B, Sk, KV, dh]) = bf16(the sum over the group's
// per-head partials [B, Sk, H, dh], in head order).  kVec elements a
// thread (4 when dh % 4 == 0).
template <int kVec>
__device__ __forceinline__ void load_vec(float* x, const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = p[0];
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(bf16* p, const float* x) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else {
    p[0] = __float2bfloat16(x[0]);
  }
}

template <int kVec>
__global__ void bwd_convert_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq,
                                   long long n_q, const float* __restrict__ dk_part,
                                   const float* __restrict__ dv_part, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, long long n_kv, int group, int dh) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  float x[kVec];
  if (i < n_q) {
    load_vec<kVec>(x, dq_accum + i);
    store_vec<kVec>(dq + i, x);
    return;
  }
  const long long j = i - n_q;
  if (j >= n_kv) return;
  const long long row = j / dh;   // (b, key, KV head)
  const long long c = j - row * dh;
  float y[kVec], sx[kVec], sy[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) sx[e] = sy[e] = 0.0f;
  for (int hh = 0; hh < group; ++hh) {
    const long long at = (row * group + hh) * dh + c;
    load_vec<kVec>(x, dk_part + at);
    load_vec<kVec>(y, dv_part + at);
#pragma unroll
    for (int e = 0; e < kVec; ++e) sx[e] += x[e], sy[e] += y[e];
  }
  store_vec<kVec>(dk + j, sx);
  store_vec<kVec>(dv + j, sy);
}

template <int D, bool kCapped>
cudaError_t launch(const Args& a) {
  using C = Cfg<D>;
  const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const int vec = a.dh % 8 == 0 && any % 16 == 0;
  const float score_log2 = kCapped ? kLog2e : a.scale * kLog2e;
  const float cap_in = kCapped ? a.scale / a.cap : 0.0f;
  const int group = a.heads / a.kv_heads;
  cudaError_t err;
  const int clustered = group > 1 && group <= kMaxCluster;
  if (a.sk > 0) {
    auto kernel = bwd_tile_kernel<D, kCapped>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.b * a.heads, (a.sk + C::kBK - 1) / C::kBK);
    cfg.blockDim = dim3(C::kThreads);
    cfg.dynamicSmemBytes = C::kSmem;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = group;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = clustered ? 1 : 0;
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
        static_cast<const float*>(a.delta), a.dq_accum, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.dk_part, a.dv_part, a.sq, a.sk, a.heads, a.kv_heads, a.dh,
        score_log2, cap_in, a.cap, a.scale, a.causal, a.window, vec, clustered);
    if (err != cudaSuccess) return err;
  }
  const long long n_q = static_cast<long long>(a.b) * a.sq * a.heads * a.dh;
  const long long n_kv =
      group > kMaxCluster ? static_cast<long long>(a.b) * a.sk * a.kv_heads * a.dh : 0;
  const long long n = n_q + n_kv;
  if (n == 0) return cudaSuccess;
  if (a.dh % 4 == 0) {
    bwd_convert_kernel<4><<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, a.stream>>>(
        a.dq_accum, static_cast<bf16*>(a.dq), n_q, a.dk_part, a.dv_part,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_kv, group, a.dh);
  } else {
    bwd_convert_kernel<1><<<static_cast<unsigned>((n + 255) / 256), 256, 0, a.stream>>>(
        a.dq_accum, static_cast<bf16*>(a.dq), n_q, a.dk_part, a.dv_part,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_kv, group, a.dh);
  }
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

// The float32 scratch of a call, carved in this order, each part rounded up
// to 4 floats (16 bytes): Delta [b, heads, sq]; for bfloat16 also dQ's
// accumulator [b, sq, heads, dh] and, for a GQA group larger than a cluster
// (kMaxCluster), the per-head dK and dV partials [b, sk, heads, dh] each.
struct Scratch {
  long long delta, dq_accum, part, total;
  Scratch(int b, int sq, int sk, int heads, int kv_heads, int dh, int is_bf16) {
    auto round4 = [](long long n) { return (n + 3) / 4 * 4; };
    delta = round4(static_cast<long long>(b) * heads * sq);
    dq_accum = is_bf16 ? round4(static_cast<long long>(b) * sq * heads * dh) : 0;
    part = is_bf16 && heads > kMaxCluster * kv_heads
               ? round4(static_cast<long long>(b) * sk * heads * dh) : 0;
    total = delta + dq_accum + 2 * part;
  }
};

}  // namespace

// Floats of scratch that flash_attention_bwd takes at these arguments.
extern "C" long long flash_attention_bwd_scratch(int b, int sq, int sk, int heads,
                                                 int kv_heads, int dh, int is_bf16) {
  return Scratch(b, sq, sk, heads, kv_heads, dh, is_bf16).total;
}

// q, o, dout, dq: [b, sq, heads, dh]; k, v, dk, dv: [b, sk, kv_heads, dh];
// lse (the forward's): float32 [b, heads, sq]; scratch: float32, at least
// flash_attention_bwd_scratch(...) elements, 16-byte aligned.  All
// contiguous, of float32 (is_bf16 = 0: CUDA cores) or bfloat16 (is_bf16 = 1:
// tensor cores); dh <= 256; heads a multiple of kv_heads; window <= 0 means
// none; softcap <= 0 means none.  Every element of dq, dk and dv is written.
// Returns the CUDA error.
extern "C" int flash_attention_bwd(void* dq, void* dk, void* dv, void* scratch,
                                   const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   int b, int sq, int sk, int heads, int kv_heads,
                                   int dh, float scale, int causal, int window,
                                   float softcap, int is_bf16, void* stream) {
  if (b <= 0 || heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sizes(b, sq, sk, heads, kv_heads, dh, is_bf16);
  float* dl = static_cast<float*>(scratch);
  float* dq_accum = is_bf16 ? dl + sizes.delta : nullptr;
  float* dk_part = sizes.part ? dl + sizes.delta + sizes.dq_accum : nullptr;
  float* dv_part = sizes.part ? dk_part + sizes.part : nullptr;
  const float* ls = static_cast<const float*>(lse);
  const long long rows = static_cast<long long>(b) * sq * heads;
  if (rows > 0) {
    const int blocks = static_cast<int>((rows * 32 + 255) / 256);
    const uintptr_t any = reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout);
    if (is_bf16)
      delta_kernel<<<blocks, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dl,
          dq_accum, rows, sq, heads, dh, dh % 8 == 0 && any % 16 == 0);
    else
      delta_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
                                          static_cast<const float*>(dout), dl, nullptr, rows,
                                          sq, heads, dh, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq <= 0) {   // no query: dK and dV are zero
    const size_t n = static_cast<size_t>(b) * sk * kv_heads * dh * (is_bf16 ? 2 : 4);
    cudaError_t err = cudaMemsetAsync(dk, 0, n, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, s);
    return static_cast<int>(err);
  }
  const Args a{dq, dk, dv, dl, dq_accum, dk_part, dv_part, q, k, v, dout, ls,
               b, sq, sk, heads, kv_heads, dh, scale, causal, window, softcap, s};
  const cudaError_t err = dh <= 64    ? launch<64>(a, is_bf16)
                          : dh <= 128 ? launch<128>(a, is_bf16)
                                      : launch<256>(a, is_bf16);
  return static_cast<int>(err);
}
