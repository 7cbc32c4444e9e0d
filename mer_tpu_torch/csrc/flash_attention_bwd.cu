// Masked multi-head attention backward for Hopper (sm_90a), f32 and bf16: the
// fused kernel K2.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:270 (`_bwd_kernel`,
// launched at :390 from `_flash_bwd_fused`, which `_flash_bwd_impl` takes up
// to BWD_FUSED_MAX keys), with its dropout branch. It computes
//
//   P = exp(s - lse) (1/Sk on a fully masked row),  delta = rowsum(g o out) - g_lse
//   dS = P o ((g v^T) o D - delta),  dq = scale dS k,  dk = scale dS^T q,  dv = (P o D)^T g
//
// with one rounding the TPU kernel does not make: in bf16, P o D and dS are
// rounded to the input dtype before their products, as K4 rounds them (the
// TPU's _bwd_kernel keeps both in f32 for its dense f32 dots); in f32 nothing
// is rounded. D is the Philox4x32-10 keep mask of (seed, b*H + h, row, column)
// (philox.cuh) that K1 drew.
//
// Design: the two grids of flash_attention_backward.cuh, which K4 shares: a
// dq grid that writes delta, then a dk/dv grid over the keys that walks the
// query rows in order with dk and dv in registers; no float atomics, so f32
// reproduces bit for bit. All five products (S, g v^T, dS k, dS^T q,
// (P o D)^T g) run in bf16 on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), the accumulator registers of S and g v^T becoming the dS and
// P o D operands; tiles staged with cp.async, double-buffered, in the input
// dtype. f32 runs the same entries by FMA on the CUDA cores. A block of 4
// warps takes 1, 2 or 4 (b*h) slices: the dq grid by Sq and the dk/dv grid by
// Sk, 4 up to 16, 2 up to 32 (the TPU kernel's bh_block, :120-128), so the
// fusion model's dialogues (S = 8-33) fill every warp.
//
// Bound. At the wav2vec2 fine-tune step's shape [16, 12, 499, 499, 64] bf16
// one call reads q, k, v, out, g and writes dq, dk, dv (12.3 MB each, 98.1
// MB) with the lse and the mask: 29.4 us at 3.35 TB/s; its five products are
// 10 x 192 x 499^2 x 64 = 30.6 GFLOP, 30.9 us at 989 TFLOP/s. Operations bound
// it; mma.sync, the exponentials and the grids' second reads of K, V (dq
// grid) and q, g (dk/dv grid) from L2 are what the kernel meets. At the
// fusion shape [32, 8, 33, 33, 96] a call moves 13 MB (3.9 us): launch and
// latency bound.

#include "flash_attention_backward.cuh"

namespace {

constexpr int kMaxSk = 2048;  // BWD_FUSED_MAX: beyond, the key-tiled K4 (flash_attention_tiled_bwd.cu)
struct flash_attention_bwd {};  // the kernels' tag: K2 in a profile

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// delta is f32 scratch of [B, H, Sq]. dropout as in mer_flash_attention_fwd.
// Refuses more than kMaxSk keys. Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* mask,
                                       const void* out, const void* lse, const void* g, const void* g_lse, void* dq,
                                       void* dk, void* dv, void* delta, int B, int H, int Sq, int Sk, int Dh,
                                       float scale, int dropout, uint32_t seed0, uint32_t seed1, uint32_t threshold,
                                       float keep_scale, void* stream) {
  if (Sk > kMaxSk) return static_cast<int>(cudaErrorInvalidValue);
  const mer_bwd::Args a{q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh, scale,
                        {seed0, seed1, threshold, keep_scale, dropout}, 0, static_cast<cudaStream_t>(stream)};
  return mer_bwd::launch<flash_attention_bwd, true>(dtype, a);
}
