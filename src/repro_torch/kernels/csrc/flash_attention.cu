// Flash (online-softmax) attention forward for Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(c(q[b,i,h,:] . k[b,j,h',:] * dh^-0.5)) v[b,j,h',:]
//
// over the keys j that the masks keep: causal (j <= i), a sliding window
// (j > i - window when window > 0) and key padding (j < Sk); h' = h / (H/KV)
// (GQA by index, never materialised).  c is the soft-cap of gemma2's
// attention, c(s) = cap * tanh(s / cap), or the identity for cap = 0; the
// cap is a runtime argument.  It is applied to kept scores only: the masked
// sentinel stays the sentinel (tanh(-inf) is -1, so a capped sentinel would
// keep its key).  The JAX model applies it outside its Pallas kernel, in
// sdpa_chunked and sdpa_decode.  Masked probabilities are exactly 0, as in
// Pallas, and the epilogue writes acc / max(l, 1e-20), so a row with no
// kept key gives 0.  Given a buffer, each row's float32 natural-log
// log-sum-exp is written too (+inf for a row with no kept key): training
// keeps it for flash_attention_bwd.cu; inference passes null.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (its Pallas
// kernel at :84, launched at :118), whose grid walks the KV tiles as its
// last, sequential axis with (m, l, acc) resident in VMEM.  Here one CTA
// owns one (b*h, q-tile) and loops over the KV tiles itself, since CTAs run
// in no order and carry nothing between them.  KV tiles wholly above the
// diagonal (causal) or wholly before the window are skipped.
//
// Two kernels, by dtype: bfloat16 on wgmma (namespace sm90; head-dim
// templates 64, 128, 192, 256), float32 on the CUDA cores, the parity path
// (namespace f32; 64, 128, 256).  The entry picks the smallest template that
// holds dh.  The bf16 kernel reads its tensors by TMA, which needs 16-byte
// aligned bases and strides: the Python wrapper (kernels/flash_attention.py,
// tma_operands) zero-pads dh to a multiple of 8 and copies a misaligned
// tensor before the call, so every bf16 input takes this one kernel.
//
// Bound (chip_smoke.flash_bound: q, k, v read and out written once; QK^T and
// PV 4 dh operations a kept pair at 989 TFLOP/s, a cap 3 more at the CUDA
// cores' 67 TFLOP/s): moonshot's prefill [4, 1024, 16/16, 128] causal moves
// 67 MB, 0.0200 ms at 3.35 TB/s, against 17.2 GFLOP, 0.0174 ms; MLA's
// [4, 1024, 16/16, 192] 101 MB, 0.0300 ms (bytes); gemma2's [4, 1024, 8/4,
// 256] 0.0181 ms with the cap, Jamba's [1, 1024, 64/8, 128] 0.0174, phi-3's
// [1, 2048, 32/32, 96] 0.0261, whisper's encoder [4, 1500, 8/8, 64]
// non-causal 0.0186 and cross [4, 448 -> 1500] 0.0056 ms (operations).
//
// bfloat16 on wgmma (namespace sm90), after FlashAttention-3 (Shah et al.,
// 2024).  A CTA is a producer warpgroup and kConsumers consumer warpgroups
// of 64 query rows of one (b, h): three (192 rows) at dh 64 and 128, two
// (128 rows) at 192 and 256.
//   - The producer's first thread loads the Q tile once and streams K and
//     V tiles of kBK keys through a 2-stage ring by TMA (cp.async.bulk.tensor
//     over the [B, S, heads, dh] tensors as they are, 64-column boxes with
//     the 128-byte swizzle that wgmma's descriptors read), with a full
//     mbarrier for each K and V tile (its bytes landed) and an empty one a
//     stage (every consumer warp is done with it).  TMA's zero fill stands
//     in for guarded loads past Sk, Sq and dh (dh 96 runs in the 128
//     template without reading columns 96-127).  A CTA that keeps no key
//     tile loads nothing, so no copy can land after it exits.  The tensor
//     maps are built on the host for each call (cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint, so the library needs no -lcuda),
//     passed as __grid_constant__ parameters and prefetched at the start.
//   - setmaxnreg leaves the producer 24 registers a thread and gives each
//     consumer 160 (three) or 240 (two).  In a consumer, S = Q K^T is an
//     SS-wgmma m64nBKk16 (Q and K K-major from shared memory); the online
//     softmax runs in the accumulator registers as wgmma lays them out (a
//     thread holds 2 rows of its warp's 16; row max and row sum reduce over
//     the quad with two xor shuffles; dh^-0.5 * log2(e) folds into one FMA
//     before ex2.approx; masks are tested only on tiles that straddle the
//     diagonal, the window's start, Sq or Sk; a row with no kept key yet is
//     taken against 0 in place of its -inf max); O += P V is an RS-wgmma
//     m64nDk16 with P packed to bf16 A fragments straight from the score
//     registers and V read N-major through the transpose bit.  Then each
//     warp arrives on the stage's empty barrier.  A consumer whose rows
//     keep no key of a tile waits for its bytes and skips it.
//   - The cap without tanhf: tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) by
//     ex2.approx and rcp.approx, about 1e-6 absolute (tanh.approx.f32's
//     ~2^-11, times a cap of 50, would move a logit by up to ~0.025); the
//     backward recomputes c(S) with tanhf from this kernel's LSE, so the two
//     must agree that closely.  Whether to cap is a template flag, picked at
//     launch from the runtime cap; the cap's value stays an argument.
//   - The epilogue divides in float32, rounds to bf16 into the consumer's
//     own rows of the Q tile and writes them with one TMA store a 64-column
//     block, which drops the rows past Sq and the columns past dh.
//   - Q-tiles end at Sq rounded up to 64 rows, so the partial one is the
//     lightest causal tile, and the heavy ones launch first.
// Tiles: dh 64: 192 rows, 128 keys (89 KB of shared memory); 128: 192 rows,
// 64 keys (113 KB); 192: 128 rows, 96 keys (193 KB); 256: 128 rows, 64 keys
// (193 KB).  ptxas (sm_90a, CUDA 12.9, capped and not): 128 registers a
// thread at launch for the three-consumer kernels, 168 for the two, no
// spills, no serialised wgmma.
// Measured on an H100 in turns (tools/kernel_turns.py; PERF.md §6 row 5)
// and dropped, as ms at moonshot's prefill shape against the kept design
// of the time: FlashAttention-3's intra-warpgroup overlap (tile n's QK^T
// issued before tile n - 1's PV, the softmax under the PV) 0.0716 against
// 0.0690 (whisper's encoder 0.1024 against 0.0706); with ping-pong named
// barriers between the two consumers on top 0.0687, but 0.1055 at whisper's
// encoder; ping-pong in the kept loop, freeing K and V of a stage apart
// (mid-loop arrivals), and 64-key tiles with a 4-stage ring at every dh
// each made ptxas serialise the wgmma (C7520): 0.0964, 0.0754, 0.0859; a
// 3-stage ring at dh 64 and 128 0.0693 against 0.0689 (whisper's encoder
// 0.0956 against 0.0714); three consumers with 128-key tiles at dh 128
// 0.0725 (too few registers: serialised).  Kept, each ahead in turns:
// three consumers at dh 64 and 128 (moonshot 0.0590 against 0.0685,
// whisper's encoder 0.0625 against 0.0720), the tensor-map prefetch (even:
// 0.0687 against 0.0689), q-tiles ending at Sq (0.0572 against 0.0588).
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

namespace sm90 {

using namespace flash_common;
constexpr int kProducerRegs = 24;                // setmaxnreg: the producer's

// The CTA at head dim D: kConsumers warpgroups of 64 query rows beside the
// producer warpgroup, keys a tile (kBK) and the K/V ring's depth, so that
// Q [kBQ][D] and the ring fit in 227 KB and a consumer's S [64][kBK] and
// O [64][D] accumulators fit in its kConsumerRegs registers (setmaxnreg:
// 128 x 24 + 384 x 160 or 256 x 240 = 64,512 of the SM's 65,536).  With
// three consumers (dh <= 128) each K/V tile a CTA loads serves 192 query
// rows, not 128; at dh 128 only with 64-key tiles, as S [64][128] and O
// did not fit in 160 registers (ptxas serialised the wgmma).
template <int D>
struct Tiles {
  static constexpr int kConsumers = D <= 128 ? 3 : 2;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBQ = 64 * kConsumers;    // query rows a CTA
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kBK = D == 64 ? 128 : D == 192 ? 96 : 64;
  static constexpr int kStages = 2;
  static constexpr int kQ = kBQ * D;             // elements of the Q tile
  static constexpr int kKV = kBK * D;            // elements of one K or V tile
  static constexpr int kBars = 1 + 3 * kStages;  // Q full; K full, V full, empty
  static constexpr int kSmem =                   // + 1024 to align the tiles
      (kQ + 2 * kStages * kKV) * static_cast<int>(sizeof(bf16)) + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "227 KB of shared memory a CTA");
};

// out = softmax(c(Q K^T dh^-0.5)) V for kBQ query rows of one (b, h): the
// producer warpgroup's first thread loads Q once and K and V tiles through
// the ring by TMA; each consumer warpgroup owns 64 of the rows.
template <int D, bool kCapped>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int sq, int sk, int heads, int kv_heads,
                   float score_log2, float cap_in, int causal, int window) {
  // score_log2 takes a score as the softmax sees it into log2 units:
  // dh^-0.5 * log2(e) on the raw score uncapped, cap * log2(e) on
  // tanh(raw * dh^-0.5 / cap) capped; cap_in = 2 * log2(e) * dh^-0.5 / cap
  using T = Tiles<D>;
  constexpr int kBK = T::kBK, kStages = T::kStages, kBQ = T::kBQ;
  constexpr int kNT = kBK / 8;                   // n-tiles of S
  constexpr int kBlocks = D / 64;                // 64-column blocks of a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(smem);      // [kBlocks][kBQ][64]; O at the end
  bf16* ks = qs + T::kQ;                         // [kStages][kBlocks][kBK][64]
  bf16* vs = ks + kStages * T::kKV;              // [kStages][kBlocks][kBK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * T::kKV);
  uint64_t* k_full = q_full + 1;                 // [kStages]
  uint64_t* v_full = k_full + kStages;           // [kStages]
  uint64_t* empty = v_full + kStages;            // [kStages]: both consumers done

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int kh = h / (heads / kv_heads);
  // q-tiles end at Sq rounded up to 64 rows, so the partial tile is the
  // first, the lightest causal one, and the heavy ones launch first.  The
  // first may start before row 0: TMA reads those rows as 0, and a
  // consumer whose 64 rows all lie there computes and stores nothing (a
  // consumer's rows that straddled row 0 made its TMA store fault)
  const int q0 = (sq + 63) / 64 * 64 - (static_cast<int>(blockIdx.y) + 1) * kBQ;
  // the key tiles [kv_begin, kv_end) that some row of the CTA keeps
  const int q_last = min(q0 + kBQ, sq) - 1;
  int kv_end = (sk + kBK - 1) / kBK;
  if (causal) kv_end = min(kv_end, q_last / kBK + 1);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = (q0 - window + 1) / kBK;
  const int tiles = max(kv_end - kv_begin, 0);

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    prefetch_tensormap(&to);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * T::kConsumers);   // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.  A CTA with no key tile loads nothing, not even Q, so no
    // copy can land after its consumers have left.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && tiles > 0) {
      mbar_expect_tx(q_full, T::kQ * sizeof(bf16));
      for (int c = 0; c < kBlocks; ++c)
        tma_load_4d(qs + c * kBQ * 64, &tq, q_full, 64 * c, h, q0, b);
      for (int n = 0; n < tiles; ++n) {
        const int st = n % kStages;
        if (n >= kStages) mbar_wait(&empty[st], ((n / kStages) - 1) & 1);
        const int k0 = (kv_begin + n) * kBK;
        mbar_expect_tx(&k_full[st], T::kKV * sizeof(bf16));
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(ks + st * T::kKV + c * kBK * 64, &tk, &k_full[st], 64 * c, kh, k0, b);
        mbar_expect_tx(&v_full[st], T::kKV * sizeof(bf16));
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(vs + st * T::kKV + c * kBK * 64, &tv, &v_full[st], 64 * c, kh, k0, b);
      }
    }
  } else {
    // Consumer warpgroup cw: rows wq0 + [0, 64), warp w of it rows
    // row0 + [0, 16), as wgmma's accumulators lie.
    setmaxnreg_inc<T::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;       // the thread's rows: g and g + 8 of the warp's 16
    const int tq = lane & 3;       // its pair of columns within each n-tile
    const int wq0 = q0 + 64 * cw;
    const int row0 = wq0 + 16 * warp;
    // the tiles of the ring this warpgroup computes; it waits on the rest
    const bool rows = wq0 >= 0;
    int my_end = kv_end, my_begin = kv_begin;
    if (causal) my_end = min(my_end, min(wq0 + 63, sq - 1) / kBK + 1);
    if (window > 0 && wq0 - window + 1 > 0) my_begin = max(my_begin, (wq0 - window + 1) / kBK);
    const bf16* qw = qs + cw * 64 * 64;

    float acc[D / 8][4];
    float m[2], l[2];              // m in log2 units; l: this thread's share
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.0f;

    if (tiles > 0) mbar_wait(q_full, 0);
    for (int n = 0; n < tiles; ++n) {
      const int st = n % kStages;
      const uint32_t parity = (n / kStages) & 1;
      const int tile = kv_begin + n;
      const int k0 = tile * kBK;
      mbar_wait(&k_full[st], parity);
      if (rows && tile >= my_begin && tile < my_end) {
        float s[kNT][4];
        wgmma_fence();
        scores_wg<D, kBQ, kBK>(s, qw, ks + st * T::kKV);
        wgmma_commit();
        wgmma_wait();
        fence_acc<kNT>(s);

        // masks only where the tile straddles an edge of one of the warp's rows
        const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > row0) ||
                          (window > 0 && k0 <= row0 + 15 - window);
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // the cap touches kept scores only: tanh(y) = 1 - 2 / (2^(2y log2 e) + 1)
            if (edge) {
              const int qp = row0 + g + 8 * (e >> 1);
              const int kp = k0 + 8 * j + 2 * tq + (e & 1);
              if (!(kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
                s[j][e] = kMasked;
              else if (kCapped)
                s[j][e] = 1.0f - 2.0f * rcp_approx(exp2_approx(s[j][e] * cap_in) + 1.0f);
            } else if (kCapped) {
              s[j][e] = 1.0f - 2.0f * rcp_approx(exp2_approx(s[j][e] * cap_in) + 1.0f);
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
        // a row with no kept key yet has m = -inf and is taken against 0,
        // so its probabilities are exp2(-inf) = 0
        float base_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * score_log2);
          base_m[r] = m_new == kMasked ? 0.0f : m_new;
          const float alpha = exp2_approx(m[r] - base_m[r]);
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[j][2 * r] *= alpha;
            acc[j][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_approx(fmaf(s[j][e], score_log2, -base_m[e >> 1]));
            s[j][e] = p;
            l[e >> 1] += p;
          }
        }

        // O += P V: P from the score registers, rounded to bf16
        mbar_wait(&v_full[st], parity);
        wgmma_fence();
        accumulate_wg<D, kBK>(acc, s, vs + st * T::kKV);
        wgmma_commit();
        wgmma_wait();
        fence_acc<D / 8>(acc);
      } else {
        mbar_wait(&v_full[st], parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: O / max(l, 1e-20) in float32, rounded to bf16, into the
    // warpgroup's own rows of the Q tile (their last reader, this
    // warpgroup's QK^T, is done), then one TMA store a 64-column block,
    // which clips the rows past Sq and the columns past dh
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.0f / fmaxf(sum, 1e-20f);
      // the row's log-sum-exp of the scores as the softmax takes them, in
      // natural units (m is in log2 units); +inf for a row with no kept key
      const int lrow = row0 + g + 8 * r;
      if (lse != nullptr && tq == 0 && lrow >= 0 && lrow < sq)
        lse[static_cast<long long>(bh) * sq + lrow] =
            sum > 0.0f ? (m[r] + log2f(sum)) * kLn2 : INFINITY;
    }
    const int rr = 64 * cw + 16 * warp + g;    // the thread's first row in the tile
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      bf16* blk = qs + (j >> 3) * kBQ * 64 + 2 * tq;
      const int sw = ((j & 7) ^ (rr & 7)) << 3;   // rows rr and rr + 8 share it
      *reinterpret_cast<uint32_t*>(blk + rr * 64 + sw) =
          pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(blk + (rr + 8) * 64 + sw) =
          pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
    fence_proxy_async();           // the generic writes before TMA reads them
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0 && rows) {
      for (int c = 0; c < kBlocks; ++c)
        tma_store_4d(&to, qs + c * kBQ * 64 + cw * 64 * 64, 64 * c, h, wq0, b);
      tma_store_wait();
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a contiguous bf16 [b, s, heads, dh] tensor as it is,
// boxes of 64 columns x 1 head x `rows` positions x 1 batch, 128-byte
// swizzle; reads past s or dh give 0, stores there are dropped.
bool tensor_map(CUtensorMap* map, const void* base, int b, int s, int heads, int dh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t n = static_cast<cuuint64_t>(s > 0 ? s : 1);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads), n,
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(dh) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * n};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D, bool kCapped>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int sq, int sk, int heads, int kv_heads, int dh, float scale,
                   int causal, int window, float cap, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap mq, mk, mv, mo;
  // with no key (sk = 0) nothing is loaded: K's and V's maps lie over q
  if (!tensor_map(&mq, q, b, sq, heads, dh, T::kBQ) ||
      !tensor_map(&mk, sk > 0 ? k : q, b, sk, kv_heads, dh, T::kBK) ||
      !tensor_map(&mv, sk > 0 ? v : q, b, sk, kv_heads, dh, T::kBK) ||
      !tensor_map(&mo, o, b, sq, heads, dh, 64))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D, kCapped>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * heads, (sq + T::kBQ - 1) / T::kBQ);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mo, lse, sq, sk, heads, kv_heads,
      kCapped ? cap * kLog2e : scale * kLog2e, kCapped ? 2.0f * kLog2e * scale / cap : 0.0f,
      causal, window);
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

}  // namespace sm90

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

}  // namespace f32

}  // namespace

// q, o: [b, sq, heads, dh]; k, v: [b, sk, kv_heads, dh], all contiguous,
// all float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1: dh % 8 == 0 and
// every pointer 16-byte aligned, as TMA needs); dh <= 256; heads a multiple
// of kv_heads; scale the scores' factor (dh^-0.5 of the true head dim when
// the caller padded dh); window <= 0 means none; softcap <= 0 means none.
// lse, if not null, receives each row's float32 log-sum-exp [b, heads, sq]
// for the backward (flash_attention_bwd.cu).  Returns the CUDA error
// (cudaErrorInvalidValue for a dh it has no template for, or a tensor map
// the CUDA driver refuses).
extern "C" int flash_attention(void* o, void* lse, const void* q, const void* k, const void* v,
                               int b, int sq, int sk, int heads, int kv_heads,
                               int dh, float scale, int causal, int window,
                               float softcap, int is_bf16, void* stream) {
  if (b <= 0 || sq <= 0 || heads <= 0) return 0;
  if (dh <= 0 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
  cudaError_t err;
#define FLASH_ARGS q, k, v, o, lse_out, b, sq, sk, heads, kv_heads, dh, scale, causal, window, \
                   softcap, s
  if (is_bf16)
    err = dh <= 64    ? sm90::launch_cap<64>(FLASH_ARGS)
          : dh <= 128 ? sm90::launch_cap<128>(FLASH_ARGS)
          : dh <= 192 ? sm90::launch_cap<192>(FLASH_ARGS)
                      : sm90::launch_cap<256>(FLASH_ARGS);
  else
    err = dh <= 64    ? f32::launch<float, 64>(FLASH_ARGS)
          : dh <= 128 ? f32::launch<float, 128>(FLASH_ARGS)
                      : f32::launch<float, 256>(FLASH_ARGS);
#undef FLASH_ARGS
  return static_cast<int>(err);
}
