// Long-sequence masked attention forward for Hopper (sm_90a), f32 and bf16:
// the streaming kernel K3.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:424
// (`_stream_kernel`, launched at :470 from `_flash_stream`, taken by
// `_flash_impl` above STREAM_THRESHOLD keys). It computes K1's function with
// an online softmax over key tiles, as :436-462 does, with the TPU kernel's
// rounding: p o D is rounded to v's dtype before the product with v
// (:453-455). The TPU kernel takes no dropout; the port's training path needs
// it here (the model's attention dropout on clips past the threshold). The
// function is the one at the head of flash_attention_forward.cuh: out =
// softmax(scale q k^T + bias) v with P o D rounded first, lse in natural-log
// units, -1e30 on ignored keys, no weight on keys past Sk, a fully masked row
// giving the mean of v, dropout as Philox4x32-10 of (seed, b*H + h, row,
// column), one call per 2 x 2 scores (philox.cuh).
//
// Three designs, picked per call:
//
// - bf16 with Dh = 64 (the wav2vec2 heads: the long-clip path) and 16-byte
//   aligned q, k, v and out: the bf16 Hopper forward of
//   flash_attention_hopper.cuh that K1 launches too (one launch: TMA into an
//   mbarrier ring under a producer warp, the key biases made in the kernel
//   from the mask's bytes, S = q K^T and (P o D) V on wgmma, the second behind
//   the next tile's first).
// - f32 with Dh = 64 and 16-byte aligned tensors (scratch too): the 3xTF32
//   Hopper forward of the same header, which K1 launches too (a prep pass that
//   splits K and V^T into TF32 halves, then wgmma.m64n64k8 tf32 in three
//   passes; bound at [2, 12, 4499, 4499, 64]: 373 GFLOP of TF32, 0.754 ms at
//   495 TFLOP/s).
// - Anything else (any other Dh <= 128: the f32 parity legs' 50 and 96; an
//   unaligned tensor): the forward template of flash_attention_forward.cuh,
//   which K1 shares, at one (b*h) slice a block (mma.sync in bf16, FMA in
//   f32).
//
// Bound. At [2, 12, 4499, 4499, 64] bf16 (the 90 s clips' bucket) one call
// reads q, k, v (6.9 MB each) and the mask and writes out and lse: about 28 MB,
// 8.4 us at 3.35 TB/s; its two products are 4 x 2 x 12 x 4499^2 x 64 = 124
// GFLOP, 0.126 ms at 989 TFLOP/s. Operations bound it. Beside the products
// each score takes an exp2 (486 M of them: about 0.13 ms at the SFU's 16 a
// cycle and SM) and, with dropout, a quarter of a Philox4x32-10 call (ten
// rounds of two 32 x 32 -> 64-bit multiplies): integer work on the CUDA cores
// of the same order as the products, which the design overlaps with them but
// cannot remove.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_forward.cuh"
#include "flash_attention_hopper.cuh"

namespace {

struct flash_attention_stream {};  // the kernels' tag: K3 in a profile

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout: 0 = off; else the keep bit of
// each probability is Philox(seed0, seed1) >= threshold, kept ones scaled by
// keep_scale. scratch: 16-byte aligned, read by the f32 Hopper design only,
// mer_hopper::tf32_scratch_floats(B, H, Sk) floats (null in bf16). Returns the
// cudaError_t of the launches.
extern "C" int mer_flash_attention_stream(int dtype, const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* lse, void* scratch, int B, int H,
                                          int Sq, int Sk, int Dh, float scale, int dropout, uint32_t seed0,
                                          uint32_t seed1, uint32_t threshold, float keep_scale, void* stream) {
  cudaError_t err = mer_fwd::check_args(B, H, Sq, Sk, Dh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using K3 = flash_attention_stream;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (Dh == mer_hopper::kD && aligned(q) && aligned(k) && aligned(v) && aligned(out)) {
    if (dtype == 1)
      return static_cast<int>(mer_hopper::launch_bf16<K3>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, drop, s));
    if (dtype == 0 && aligned(scratch))
      return static_cast<int>(
          mer_hopper::launch_tf32<K3>(q, k, v, mask, out, lse, scratch, B, H, Sq, Sk, scale, drop, s));
  }
  if (dtype == 0) err = mer_fwd::launch<K3, float, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else if (dtype == 1)
    err = mer_fwd::launch<K3, __nv_bfloat16, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
