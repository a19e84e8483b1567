// Pieces shared by the flash attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) on the tensor cores: cp.async, ldmatrix
// and mma.sync wrappers, and the swizzled bf16 tile layout.
//
// A tile of rows x D bf16 values lives in shared memory with its 16-byte
// chunks XOR-swizzled by row (chunk ^ row % 8), so that ldmatrix reads 8
// rows of one chunk column without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <limits>

namespace flash_common {

using bf16 = __nv_bfloat16;
constexpr float kMasked = -std::numeric_limits<float>::infinity();  // exp2 -> 0
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `c` of row `r` in a [rows][D] bf16 tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// The swizzled column offset of chunk 8 * blk + c7 (c7 < 8) in a row r
// with r % 8 = mr: blk stays, the low three bits take the xor.  ldmatrix
// lanes address rows with a fixed r % 8, so each lane keeps four such
// offsets (c7 = 2i + b) in registers and the rest is compile-time.
__device__ __forceinline__ int chunk_off(int c7, int mr) { return (c7 ^ mr) << 3; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (relative error ~2^-22; 2^-inf = +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of an m16n8k16 product whose 16 k-columns are the two
// 8-column n-tiles c0 and c1 of a float accumulator held as C fragments
// (the rows stay; the registers map one to one, rounded to bf16).
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [r0, r0 + kRows) of one head into a swizzled [kRows][D] tile, zero
// past `limit` rows and past dh columns; `stride` is heads * dh.  With
// `vec` by cp.async in 16-byte pieces (the caller commits and waits), else
// element by element.  kThreads threads of the block share the copy.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int limit,
                                          int dh, bool vec) {
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
      cp_async16(dst + swz<D>(r, c), from, full);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      bf16 x = __float2bfloat16(0.0f);
      if (r0 + r < limit && c < dh) x = src[(r0 + r) * stride + c];
      dst[swz<D>(r, c >> 3) + (c & 7)] = x;
    }
  }
}

}  // namespace flash_common
