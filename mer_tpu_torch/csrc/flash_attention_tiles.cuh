// Tile products shared by the long-sequence attention kernels K3
// (flash_attention_stream.cu) and K4 (flash_attention_tiled_bwd.cu).
//
// A warp owns a 16-row strip of a product and holds its results in the
// register layout of mma.sync.m16n8k16's accumulator: lane (g, t) = (lane / 4,
// lane % 4) holds, for each 8-column n-tile, c[0], c[1] at (row g, columns
// 2t, 2t + 1) and c[2], c[3] at row g + 8. Both products below take and give
// that layout, so the softmax, masking and dropout code around them is the
// same for both element types:
//
// - bf16: the tensor cores (mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32).
//   Operands are read from shared memory with ldmatrix.x4: A and the
//   "row-major B^T" operand of gemm_nt as stored (B two n-tiles a load), the
//   "row-major B" operand of gemm_pv with .trans (two n-tiles a load). A
//   probability operand comes from the accumulator registers of the product
//   before it, rounded to bf16 (the rounding the TPU kernel makes with
//   p.astype(v.dtype)).
// - f32: the same results by FMA on the CUDA cores (no TF32), each lane
//   computing the entries it holds; a probability operand goes through a
//   per-warp shared scratch, since a lane needs the whole row.
//
// Shared tiles are row-major with a row stride of dh_pad + 16 / sizeof(T)
// elements (dh_pad = Dh rounded up to 16): a multiple of 16 bytes, as
// ldmatrix wants, and rows 4 banks apart, so the 8 rows a fragment load
// touches hit 32 different banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mer_tiles {

using bf16 = __nv_bfloat16;

template <typename T> struct Pad { static constexpr int kElems = 16 / sizeof(T); };

// The masking constants of every attention kernel, defined here once: a fully masked row's rule must be the
// same in the templates and the stacked designs.
constexpr float kMaskBias = -1e30f;        // an ignored key's bias, as the TPU kernel's _NEG_INF
constexpr float kFullyMaskedLse = -1e29f;  // a row's lse below this: every key of the row ignored

// e^x as exp2f(x log2 e): one ex2 instead of expf's range reduction, off by the
// rounding of x log2 e (relative |x| 2^-24 or so). x is a difference of scores
// (s - max, s - lse), so a fully masked row, whose scores all round to -1e30,
// gets x = 0 exactly and e^x = 1.
__device__ __forceinline__ float exp_of(float x) { return exp2f(x * 1.4426950408889634f); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// -- async copies ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage n_rows contiguous rows of Dh elements (src) into a shared tile of row
// stride `stride`. vec: 16-byte cp.async chunks (Dh a multiple of 16 bytes and
// src 16-byte aligned); else element by element, synchronously. Rows past
// n_rows and columns past Dh are left as they are.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* __restrict__ src, int n_rows, int Dh,
                                           bool vec, int tid, int n_threads) {
  if (vec) {
    constexpr int kVec = Pad<T>::kElems;
    const int per_row = Dh / kVec;
    const int total = n_rows * per_row;
    for (int i = tid; i < total; i += n_threads) {
      const int r = i / per_row, c = (i - r * per_row) * kVec;
      cp_async16(dst + r * stride + c, src + (size_t)r * Dh + c);
    }
  } else {
    const int total = n_rows * Dh;
    for (int i = tid; i < total; i += n_threads) {
      const int r = i / Dh, c = i - r * Dh;
      dst[r * stride + c] = src[i];
    }
  }
}

// Zero `bytes` (a multiple of 16) of shared memory from 16-byte aligned p.
__device__ __forceinline__ void zero_smem(void* p, int bytes, int tid, int n_threads) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = tid; i < bytes / 16; i += n_threads) q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// -- quad reductions (the 4 lanes that hold one row) --------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- bf16 on the tensor cores -------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c[n][.] += A[16 x kdim] B[8 NT x kdim]^T: A rows a[0..15], B rows b[0..8 NT - 1],
// both row-major with `stride`; kdim a multiple of 16 (dh_pad, zero columns past Dh); NT even.
template <int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const bf16* a, const bf16* b, int stride, int kdim,
                                        int lane) {
  static_assert(NT % 2 == 0, "B is loaded two n-tiles at a time");
  const int r = lane & 7, m = lane >> 3;
  // matrices of A: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15);
  // of B, per n pair: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  const bf16* a_row = a + (r + 8 * (m & 1)) * stride + 8 * (m >> 1);
  const bf16* b_row = b + (r + 8 * (m >> 1)) * stride + 8 * (m & 1);
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a_row + k0);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b_row + 8 * n * stride + k0);
      mma16816(c[n], af, bf[0], bf[1]);
      mma16816(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// c[n][.] += P[16 x 16 KS] B[16 KS x 8 n]: P in accumulator layout p[2 KS][4]
// (columns = the k of this product), rounded to bf16; B rows b[0..16 KS - 1],
// row-major with `stride`; n-tiles n < nd (nd even) of the ND held.
template <int KS, int ND>
__device__ __forceinline__ void gemm_pv(float (&c)[ND][4], const float (&p)[2 * KS][4], const bf16* b, int stride,
                                        int nd, int lane, float* /*scratch*/) {
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const uint32_t af[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]), pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]), pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of this k-step and n pair
    const bf16* row = b + (16 * j + (i & 1) * 8 + r) * stride + (i >> 1) * 8;
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      if (n >= nd) break;
      uint32_t bf[4];
      ldsm_x4_trans(bf, row + 8 * n);
      mma16816(c[n], af, bf[0], bf[1]);
      mma16816(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// -- f32 on the CUDA cores -----------------------------------------------------------

template <int NT>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const float* a, const float* b, int stride, int kdim,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * stride;
  const float* a1 = a0 + 8 * stride;
  for (int k = 0; k < kdim; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float y0 = b[(8 * n + 2 * t) * stride + k], y1 = b[(8 * n + 2 * t + 1) * stride + k];
      c[n][0] = fmaf(x0, y0, c[n][0]);
      c[n][1] = fmaf(x0, y1, c[n][1]);
      c[n][2] = fmaf(x1, y0, c[n][2]);
      c[n][3] = fmaf(x1, y1, c[n][3]);
    }
  }
}

// scratch: this warp's [16][16 KS + 4] f32
template <int KS, int ND>
__device__ __forceinline__ void gemm_pv(float (&c)[ND][4], const float (&p)[2 * KS][4], const float* b, int stride,
                                        int nd, int lane, float* scratch) {
  constexpr int kLd = 16 * KS + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    scratch[g * kLd + 8 * n + 2 * t] = p[n][0];
    scratch[g * kLd + 8 * n + 2 * t + 1] = p[n][1];
    scratch[(g + 8) * kLd + 8 * n + 2 * t] = p[n][2];
    scratch[(g + 8) * kLd + 8 * n + 2 * t + 1] = p[n][3];
  }
  __syncwarp();
  for (int k = 0; k < 16 * KS; ++k) {
    const float x0 = scratch[g * kLd + k], x1 = scratch[(g + 8) * kLd + k];
    const float* brow = b + k * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n >= nd) break;
      const float y0 = brow[8 * n], y1 = brow[8 * n + 1];
      c[n][0] = fmaf(x0, y0, c[n][0]);
      c[n][1] = fmaf(x0, y1, c[n][1]);
      c[n][2] = fmaf(x1, y0, c[n][2]);
      c[n][3] = fmaf(x1, y1, c[n][3]);
    }
  }
  __syncwarp();  // the scratch is free again
}

}  // namespace mer_tiles
