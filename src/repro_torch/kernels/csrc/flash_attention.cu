// Flash (online-softmax) attention forward for Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(c(q[b,i,h,:] . k[b,j,h',:] * dh^-0.5)) v[b,j,h',:]
//
// over the keys j that the masks keep: causal (j <= i), a sliding window
// (j > i - window when window > 0) and key padding (j < Sk); h' = h / (H/KV)
// (GQA by index, never materialised).  c is the soft-cap of gemma2's
// attention, c(s) = cap * tanh(s / cap) (tanhf, the accurate libdevice
// function), or the identity for cap = 0; the cap is a runtime argument.
// It is applied to kept scores only: the masked sentinel stays the
// sentinel (tanh(-inf) is -1, so a capped sentinel would keep its key).
// The JAX model applies it outside its Pallas kernel, in sdpa_chunked and
// sdpa_decode.  Replaces
// src/repro/kernels/flash_attention.py::flash_attention, whose Pallas grid
// walks the KV tiles as its last, sequential axis with (m, l, acc) resident
// in VMEM.  Here one block owns one (b*h, q-tile) and loops over the KV
// tiles itself, since blocks run in no order and carry nothing between them.
// Masked probabilities are exactly 0, as in Pallas; KV tiles wholly above
// the diagonal (causal) or wholly before the window are skipped, and the
// epilogue writes acc / max(l, 1e-20).
//
// The entry routes by dtype: bfloat16 (the model's prefill) takes the
// tensor-core kernel, float32 the CUDA-core kernel.  Either writes each
// row's float32 log-sum-exp when given a buffer for it (training keeps it
// for flash_attention_bwd.cu); inference passes null and skips the store.
// The tensor-core helpers are shared with the backward in flash_common.cuh.
//
// bfloat16, tensor cores (namespace tc).  Bound: operations.  At the
// prefill shape (B=4, S=1024, H=16, dh=128, causal) QK^T and PV are 17.2
// GFLOP against 67 MB moved: 0.017 ms at 989 TFLOP/s, 0.020 ms at 3.35 TB/s.
// The float32 kernel below reads every element with one 2-byte load and a
// conversion and runs FMAs at 67 TFLOP/s peak; this one keeps the data in
// bf16 and feeds mma.sync:
//   - a block of 4 warps owns 128 query rows of one (b, h): 2 m-tiles of
//     16 rows a warp, so each K and V fragment read from shared memory feeds
//     two mma (dh 256: one m-tile, for the registers).  The grid launches the
//     heavy causal q-tiles first (reversed blockIdx.y) so the short diagonal
//     tiles fill the tail;
//   - Q, K and V move by cp.async in 16-byte pieces into shared memory laid
//     out with an XOR swizzle of the 16-byte chunks (chunk ^ row % 8), so
//     ldmatrix reads 8 rows of one chunk column without bank conflicts;
//     each lane keeps four swizzled column offsets and the rest of every
//     ldmatrix address is compile-time.  K and V tiles of 64 keys stream
//     through a 2-stage ring (commit_group / wait_group), loading tile j+1
//     while tile j computes; Q is read by ldmatrix each tile;
//   - S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 accumulate), K
//     fragments by ldmatrix; the online softmax runs in registers: a thread
//     holds 2 rows of each m-tile, row max and row sum reduce over the quad
//     with two xor shuffles, dh^-0.5 * log2(e) folds into one FMA before the
//     SFU's ex2, and masks are applied only on tiles that straddle an edge.
//     With a cap the scale cannot stay folded (tanh is not linear): each
//     kept score becomes cap * tanhf(s * dh^-0.5 / cap) first, and log2(e)
//     alone goes into the FMA.  Whether to cap is a template flag, picked
//     at launch from the runtime cap, so that cap 0 runs the uncapped code
//     and arithmetic bit for bit; the cap's value stays an argument.  The
//     mask test stays inside the edge-tile branch: a per-score "kept" flag
//     evaluated on every tile made the uncapped kernel 10-20% slower.
//     Masked scores are -inf, so their probabilities are exactly 0, and a
//     row with no kept key yet is taken against 0 in place of its -inf max;
//   - O += P V with P packed to bf16 A fragments straight from the score
//     registers and V loaded by ldmatrix.trans;
//   - the epilogue divides in float32, rounds to bf16 and stages the tile
//     in shared memory so each store is 16 bytes and coalesced.
// Measured on an H100 (PERF.md), this layout beat 8 warps a block
// and 1 m-tile a warp with Q held in registers as A fragments for the whole
// KV loop.  dh is zero-padded in shared memory to the template's 64, 128 or
// 256.  Where dh is not a multiple of 8 or a pointer is not 16-byte aligned,
// the same kernel loads and stores element by element.
// Numerics: a product of two bf16 values is exact in float32 and QK^T, m,
// l and O accumulate in float32; P is rounded to bf16 before PV, the one
// departure from the Pallas kernel's float32 math (within the bf16
// tolerance, rtol = atol = 2e-2, that the tests hold it to).
//
// float32, CUDA cores (namespace f32).  256 threads as a 16 x 16 grid; a
// 64 x 64 (q, k) tile.  Q, K and V tiles are staged in shared memory as
// float (rows padded by one float so the K reads of a warp fall on distinct
// banks), and each thread owns a 4 x 4 block of scores (rows ty + 16i, keys
// tx + 16j) and a 4 x (D/16) block of the accumulator (columns tx + 16j).
// Row max and row sum reduce over the 16 lanes that share a row with xor
// shuffles; m, l and acc stay in float32 registers; a kept score is scaled
// and then capped (cap > 0), a masked one is -1e30, as in Pallas.
#include "flash_common.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

namespace tc {

using namespace flash_common;
constexpr int kWarps = 4;      // a block
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;        // keys a tile
constexpr int kStages = 2;     // K/V ring depth

// Two 16-row m-tiles a warp, so each K and V fragment feeds two mma; one
// at dh 256, where the accumulators of two would not fit in registers.
template <int D>
struct Layout {
  static constexpr int kMT = D <= 128 ? 2 : 1;
  static constexpr int kBQ = kWarps * 16 * kMT;   // query rows a block
  static constexpr int kSmem =
      (kBQ + 2 * kStages * kBK) * D * static_cast<int>(sizeof(bf16));
};

template <int D, bool kCapped>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int sq,
                  int sk, int heads, int kv_heads, int dh, float score_log2,
                  float cap_in, float cap, int causal, int window, int vec) {
  // score_log2 takes a score as the softmax sees it into log2 units:
  // dh^-0.5 * log2(e) uncapped, log2(e) after the cap, whose input is the
  // raw score times cap_in = dh^-0.5 / cap
  using L = Layout<D>;
  constexpr int kMT = L::kMT;
  constexpr int kRows = 16 * kMT;       // query rows a warp
  constexpr int kBQ = L::kBQ;
  constexpr int kChunks = D / 8;        // 16-byte chunks a row; O's n-tiles
  constexpr int kSteps = D / 16;        // k-steps of QK^T
  constexpr int kKeyTiles = kBK / 8;    // n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][D]; O in the epilogue
  bf16* ks = qs + kBQ * D;                        // [kStages][kBK][D]
  bf16* vs = ks + kStages * kBK * D;              // [kStages][kBK][D]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // the thread's rows: g and g + 8 of each m-tile
  const int tq = lane & 3;       // its pair of columns within each n-tile
  const int mi = lane >> 3;      // the ldmatrix matrix this lane addresses
  const int mr = lane & 7;       // ... and its row there, mod 8
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int wr0 = warp * kRows;  // the warp's first row in the block's tile
  const int wq0 = q0 + wr0;
  const long long q_stride = static_cast<long long>(heads) * dh;
  const long long kv_stride = static_cast<long long>(kv_heads) * dh;
  const bf16* qb = q + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;
  const bf16* kb = k + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  const bf16* vb = v + static_cast<long long>(b) * sk * kv_stride + static_cast<long long>(kh) * dh;
  bf16* ob = o + static_cast<long long>(b) * sq * q_stride + static_cast<long long>(h) * dh;

  // ldmatrix addressing.  Q (A, rows l % 16 of an m-tile, chunks 2kk + l / 16)
  // and K (B of Q K^T, keys 8j + mr + 8 (mi / 2), chunks 2kk + mi % 2): chunk
  // 2kk + b = 8 (kk / 4) + 2 (kk % 4) + b.  V (B of P V through .trans,
  // keys 16kk + mr + 8 (mi % 2), chunks j + mi / 2 for even j).
  int qoff[4], koff[4], voff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qoff[i] = chunk_off(2 * i + (lane >> 4), mr);
    koff[i] = chunk_off(2 * i + (mi & 1), mr);
    voff[i] = chunk_off(2 * i + (mi >> 1), mr);
  }
  const int qrow = (wr0 + (lane & 15)) * D;
  const int krow = (mr + 8 * (mi >> 1)) * D;
  const int vrow = (mr + 8 * (mi & 1)) * D;

  const int q_last = min(q0 + kBQ, sq) - 1;
  int kv_end = (sk + kBK - 1) / kBK;
  if (causal) kv_end = min(kv_end, q_last / kBK + 1);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = (q0 - window + 1) / kBK;

  load_tile<D, kBQ, kThreads>(qs, qb, q_stride, q0, sq, dh, vec);
  cp_commit();
  if (kv_begin < kv_end) {
    load_tile<D, kBK, kThreads>(ks, kb, kv_stride, kv_begin * kBK, sk, dh, vec);
    load_tile<D, kBK, kThreads>(vs, vb, kv_stride, kv_begin * kBK, sk, dh, vec);
  }
  cp_commit();
  cp_wait<1>();       // Q has landed (the first tile may still be in flight)
  __syncthreads();

  float acc[kMT][kChunks][4];
  float m[kMT][2], l[kMT][2];         // m in log2 units; l: this thread's share
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
    m[mt][0] = m[mt][1] = kMasked;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int tile = kv_begin, it = 0; tile < kv_end; ++tile, ++it) {
    // prefetch the next tile into the stage the previous tile freed
    if (tile + 1 < kv_end) {
      const int ns = (it + 1) % kStages;
      load_tile<D, kBK, kThreads>(ks + ns * kBK * D, kb, kv_stride, (tile + 1) * kBK, sk, dh, vec);
      load_tile<D, kBK, kThreads>(vs + ns * kBK * D, vb, kv_stride, (tile + 1) * kBK, sk, dh, vec);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    const int k0 = tile * kBK;
    const bf16* kt = ks + (it % kStages) * kBK * D + krow;
    const bf16* vt = vs + (it % kStages) * kBK * D + vrow;
    // a warp whose rows keep no key of this tile only waits at the barriers
    const bool live = !(causal && k0 > wq0 + kRows - 1) &&
                      !(window > 0 && k0 + kBK - 1 <= wq0 - window);
    if (live) {
      float s[kMT][kKeyTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
          s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm_x4(a[mt], qs + qrow + 16 * mt * D + ((kk >> 2) << 6) + qoff[kk & 3]);
#pragma unroll
        for (int j = 0; j < kKeyTiles; j += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, kt + 8 * j * D + ((kk >> 2) << 6) + koff[kk & 3]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(s[mt][j], a[mt], bk[0], bk[1]);
            mma(s[mt][j + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // masks only where the tile straddles an edge of some row's range
      const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + kRows - 1 - window);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the cap touches kept scores only
            if (edge) {
              const int qp = wq0 + 16 * mt + g + 8 * (e >> 1);
              const int kp = k0 + 8 * j + 2 * tq + (e & 1);
              if (!(kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
                s[mt][j][e] = kMasked;
              else if (kCapped)
                s[mt][j][e] = cap * tanhf(s[mt][j][e] * cap_in);
            } else if (kCapped) {
              s[mt][j][e] = cap * tanhf(s[mt][j][e] * cap_in);
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
          }
        }
        // a row with no kept key yet has m = -inf and is taken against 0,
        // so its probabilities are exp2(-inf) = 0
        float base_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[mt][r], mx[r] * score_log2);
          base_m[r] = m_new == kMasked ? 0.0f : m_new;
          const float alpha = exp2_approx(m[mt][r] - base_m[r]);
          m[mt][r] = m_new;
          l[mt][r] *= alpha;
#pragma unroll
          for (int j = 0; j < kChunks; ++j) {
            acc[mt][j][2 * r] *= alpha;
            acc[mt][j][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(fmaf(s[mt][j][e], score_log2, -base_m[e >> 1]));
            s[mt][j][e] = p;
            l[mt][e >> 1] += p;
          }
        }
      }

#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // P's A fragment for keys 16kk..+15 is S's n-tiles 2kk and 2kk+1
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) c_to_a(a[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < kChunks; j += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vt + 16 * kk * D + ((j >> 3) << 6) + voff[(j & 7) >> 1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma(acc[mt][j], a[mt], bv[0], bv[1]);
            mma(acc[mt][j + 1], a[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // epilogue: O / max(l, 1e-20) in float32, rounded to bf16, staged in the
  // warp's own rows of qs, then written out 16 bytes at a time
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.0f / fmaxf(sum, 1e-20f);
      // the row's log-sum-exp of the scores as the softmax takes them, in
      // natural units (m is in log2 units); +inf for a row with no kept key
      const int lrow = wq0 + 16 * mt + g + 8 * r;
      if (lse != nullptr && tq == 0 && lrow < sq)
        lse[static_cast<long long>(bh) * sq + lrow] =
            sum > 0.0f ? (m[mt][r] + log2f(sum)) * kLn2 : INFINITY;
    }
    const int row = wr0 + 16 * mt + g;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      *reinterpret_cast<uint32_t*>(qs + swz<D>(row, j) + 2 * tq) =
          pack_bf16(acc[mt][j][0] * inv[0], acc[mt][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(qs + swz<D>(row + 8, j) + 2 * tq) =
          pack_bf16(acc[mt][j][2] * inv[1], acc[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
  if (vec) {
#pragma unroll
    for (int i = lane; i < kRows * kChunks; i += 32) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      if (wq0 + r < sq && c * 8 < dh)
        *reinterpret_cast<int4*>(ob + (wq0 + r) * q_stride + c * 8) =
            *reinterpret_cast<const int4*>(qs + swz<D>(wr0 + r, c));
    }
  } else {
    for (int i = lane; i < kRows * D; i += 32) {
      const int r = i / D;
      const int c = i % D;
      if (wq0 + r < sq && c < dh)
        ob[(wq0 + r) * q_stride + c] = qs[swz<D>(wr0 + r, c >> 3) + (c & 7)];
    }
  }
}

template <int D, bool kCapped>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int sq, int sk, int heads, int kv_heads, int dh, float scale,
                   int causal, int window, float cap, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D, kCapped>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kSmem);
  if (err != cudaSuccess) return err;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int vec = dh % 8 == 0 && any % 16 == 0;
  const dim3 grid(b * heads, (sq + L::kBQ - 1) / L::kBQ);
  flash_bf16_kernel<D, kCapped><<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, sk, heads, kv_heads, dh,
      kCapped ? kLog2e : scale * kLog2e,
      kCapped ? scale / cap : 0.0f, cap, causal, window, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_cap(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                       int sq, int sk, int heads, int kv_heads, int dh, float scale,
                       int causal, int window, float cap, cudaStream_t stream) {
  if (cap > 0.0f)
    return launch<D, true>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                           window, cap, stream);
  return launch<D, false>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                          window, cap, stream);
}

cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                      int sq, int sk, int heads, int kv_heads, int dh, float scale,
                      int causal, int window, float cap, cudaStream_t stream) {
  if (dh <= 64)
    return launch_cap<64>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                          window, cap, stream);
  if (dh <= 128)
    return launch_cap<128>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                           window, cap, stream);
  return launch_cap<256>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                         window, cap, stream);
}

}  // namespace tc

namespace f32 {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store_float(float* out, float v) { *out = v; }

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
             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
             int sq, int sk,
             int heads, int kv_heads, int dh, float scale, int causal,
             int window, float cap) {
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
        float x = s[i][j] * scale;
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        s[i][j] = keep[j] ? x : kNegInf;
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<long long>(bh) * sq + row] = l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) store_float(&ob[row * q_stride + col], acc[i][j] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int sq, int sk, int heads, int kv_heads, int dh, float scale,
                   int causal, int window, float cap, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (sq + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, heads, kv_heads, dh, scale, causal, window, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                      int sq, int sk, int heads, int kv_heads, int dh, float scale,
                      int causal, int window, float cap, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                         window, cap, stream);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                          window, cap, stream);
  return launch<T, 256>(q, k, v, o, lse, b, sq, sk, heads, kv_heads, dh, scale, causal,
                        window, cap, stream);
}

}  // namespace f32

}  // namespace

// q, o: [b, sq, heads, dh]; k, v: [b, sk, kv_heads, dh], all contiguous, of
// float32 (is_bf16 = 0: CUDA cores) or bfloat16 (is_bf16 = 1: tensor
// cores); dh <= 256; heads a multiple of kv_heads; window <= 0 means none;
// softcap <= 0 means none.  lse, if not null, receives each row's float32
// log-sum-exp [b, heads, sq] for the backward (flash_attention_bwd.cu).
// Returns the CUDA error.
extern "C" int flash_attention(void* o, void* lse, const void* q, const void* k, const void* v,
                               int b, int sq, int sk, int heads, int kv_heads,
                               int dh, float scale, int causal, int window,
                               float softcap, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
  cudaError_t err =
      is_bf16 ? tc::launch_dh(q, k, v, o, lse_out, b, sq, sk, heads, kv_heads, dh, scale,
                              causal, window, softcap, s)
              : f32::launch_dh<float>(q, k, v, o, lse_out, b, sq, sk, heads, kv_heads, dh,
                                      scale, causal, window, softcap, s);
  return static_cast<int>(err);
}
