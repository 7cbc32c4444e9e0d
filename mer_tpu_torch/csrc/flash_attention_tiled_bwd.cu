// Long-sequence masked attention backward for Hopper (sm_90a), f32 and bf16:
// the key-tiled kernel K4.
//
// Replaces the TPU kernels mer_tpu/ops/flash_attention.py:579
// (`_bwd_dkv_kernel`) and :624 (`_bwd_dq_kernel`), launched at :693 and :721
// from `_flash_bwd_tiled`, which `_flash_bwd_impl` takes above BWD_FUSED_MAX =
// 2048 keys. It computes K2's function (flash_attention_bwd.cu) for any Sk,
// with P o D and dS rounded to the input dtype before their products (the
// rounding K3 makes for P.V; formulas in flash_attention_backward.cuh).
//
// Fully masked rows take P = 1/Sk, as K2 has it. The TPU kernel does not: its
// tiled backward takes exp(s - lse) = 1 there and gives that row's dk, dv Sk
// times the fused backward's (a standing difference, held by
// tests/test_torch_attention_long.py).
//
// Design: the two grids of flash_attention_backward.cuh, which K2 shares,
// with one (b*h) slice a block: a dq grid of 64 query rows a block that
// writes delta and walks 64-key tiles, then a dk/dv grid of 64 keys a block
// that walks the query rows in order, dk and dv in registers; no float
// atomics. bf16 products on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), f32 as FMA on the CUDA cores.
//
// Bound. At [2, 12, 4499, 4499, 64] bf16 (the 90 s clips' fine-tune step) one
// call reads q, k, v, out, g (6.9 MB each), lse and the mask and writes dq,
// dk, dv: about 55 MB, 16 us at 3.35 TB/s; its five products are 10 x 2 x 12
// x 4499^2 x 64 = 311 GFLOP, 0.31 ms at 989 TFLOP/s. Operations bound it.

#include "flash_attention_backward.cuh"

namespace {

struct flash_attention_tiled_bwd {};  // the kernels' tag: K4 in a profile

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// delta is f32 scratch of [B, H, Sq]. dropout as in mer_flash_attention_fwd.
// Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_tiled_bwd(int dtype, const void* q, const void* k, const void* v,
                                             const void* mask, const void* out, const void* lse, const void* g,
                                             const void* g_lse, void* dq, void* dk, void* dv, void* delta, int B,
                                             int H, int Sq, int Sk, int Dh, float scale, int dropout,
                                             uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_scale,
                                             void* stream) {
  const mer_bwd::Args a{q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh, scale,
                        {seed0, seed1, threshold, keep_scale, dropout}, 0, static_cast<cudaStream_t>(stream)};
  return mer_bwd::launch<flash_attention_tiled_bwd, false>(dtype, a);
}
