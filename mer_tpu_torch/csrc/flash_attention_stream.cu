// Long-sequence masked attention forward for Hopper (sm_90a), f32 and bf16:
// the streaming kernel K3.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:424
// (`_stream_kernel`, launched at :470 from `_flash_stream`, taken by
// `_flash_impl` above STREAM_THRESHOLD keys). It computes K1's function with
// an online softmax over key tiles, as :436-462 does, with the TPU kernel's
// rounding: p o D is rounded to v's dtype before the product with v
// (:453-455). The TPU kernel takes no dropout; the port's training path needs
// it here (the model's attention dropout on clips past the threshold).
//
// Design: the forward template of flash_attention_forward.cuh, which K1
// shares, with one (b*h) slice a block: 4 warps own 64 query rows and walk
// the keys in double-buffered 64-key tiles, both bf16 products on the tensor
// cores (mma.sync.m16n8k16, f32 accumulation), f32 as FMA on the CUDA cores.
//
// Bound. At [2, 12, 8192, 8192, 64] bf16 one call moves q, k, v, out (25.2 MB
// each, 101 MB) and the lse (0.8 MB): 30 us at 3.35 TB/s; its two products
// are 4 x 2 x 12 x 8192^2 x 64 = 412 GFLOP, 0.42 ms at the dense bf16 peak of
// 989 TFLOP/s. Operations bound it. mma.sync reaches a fraction of that peak
// (wgmma, TMA, a producer warp and larger tiles are later work), and the
// exponentials (one per score) and, with dropout, ten Philox rounds per score
// ride on the CUDA cores beside it.

#include "flash_attention_forward.cuh"

namespace {

struct flash_attention_stream {};  // the kernel's tag: K3 in a profile

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout: 0 = off; else the keep bit of
// each probability is Philox(seed0, seed1) >= threshold, kept ones scaled by
// keep_scale. Returns the cudaError_t of the launch.
extern "C" int mer_flash_attention_stream(int dtype, const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, int B, int H, int Sq, int Sk,
                                          int Dh, float scale, int dropout, uint32_t seed0, uint32_t seed1,
                                          uint32_t threshold, float keep_scale, void* stream) {
  cudaError_t err = mer_fwd::check_args(B, H, Sq, Sk, Dh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using K3 = flash_attention_stream;
  if (dtype == 0) err = mer_fwd::launch<K3, float, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else if (dtype == 1)
    err = mer_fwd::launch<K3, __nv_bfloat16, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
