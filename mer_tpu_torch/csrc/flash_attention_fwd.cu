// Masked multi-head attention forward for Hopper (sm_90a), f32 and bf16: the
// single-pass kernel K1.
//
// Replaces the TPU kernel mer_tpu/ops/flash_attention.py:72 (`_kernel`,
// launched at :538 from `_flash_impl` up to STREAM_THRESHOLD keys), with its
// dropout branch (:86-115, mask :50-69):
//
//   s   = (q * 1/sqrt(Dh)) k^T + bias,  bias = -1e30 on ignored keys, else 0
//   lse = m + log(sum exp(s - m)),      m = row max of s        (f32)
//   out = (softmax(s) o D) v                                    (q's dtype)
//
// with the TPU kernel's rounding: in bf16 the probabilities (after dropout)
// are rounded to v's dtype before the product with v (:117,
// p.astype(v.dtype)); here they are rounded before the division by the row
// sum, which the online softmax makes last. D is the Philox4x32-10 keep mask
// of (seed, b*H + h, row, column) (philox.cuh) that K2, K3 and K4 draw.
//
// Three designs, picked per call; the C entry writes which it launched to
// its `route` argument:
//
// - bf16 with Dh = 64 (the wav2vec2 and RoBERTa heads) and 16-byte aligned
//   q, k, v and out: the bf16 Hopper forward of
//   flash_attention_hopper.cuh, which K3 launches too (route 1): one launch,
//   a producer warp streaming 64-key tiles of K and V by TMA into an mbarrier
//   ring, consumer warpgroups of 64 query rows making the key biases from the
//   mask's bytes, S = q K^T and (P o D) V on wgmma (P from registers, V
//   MN-major through the transpose bit), S of tile i
//   issued with (P o D) V of tile i - 1, the online softmax and Philox in log2
//   units in the accumulator registers between them.
// - f32 with Dh = 64 and 16-byte aligned tensors (scratch too): the 3xTF32
//   Hopper forward of the same header, which K3 launches too (route 2): a
//   prep pass splits each K and V value into TF32 halves (V^T, keys permuted
//   in groups of 8, so that P's accumulator registers are its A operand as
//   they lie), then a block of one consumer warpgroup and a TMA producer warp
//   a 64-row query tile, two blocks an SM: S = q K^T and P V each as three
//   tf32 wgmma.m64n64k8 passes (lo hi + hi lo + hi hi), P V's into a fresh
//   accumulator a key tile, the online softmax in log2 units between them.
// - Anything else (the fusion model's head dims 96 and 50, in bf16 and f32;
//   an unaligned tensor): the forward template of flash_attention_forward.cuh,
//   which K3 shares (route 0): an online softmax over double-buffered key
//   tiles staged with cp.async in the input dtype, both bf16 products on the
//   tensor cores (mma.sync.m16n8k16, f32 accumulation; P's A operand straight
//   from the scores' accumulator registers, V through ldmatrix.trans), f32 as
//   FMA on the CUDA cores in the same register layout. A block of 4 warps
//   takes 1, 2 or 4 (b*h) slices by Sq: above 32 rows one slice of 64 rows
//   and 64-key tiles; up to 32 two slices of 32 rows, up to 16 four of 16 (the
//   TPU kernel's bh_block, :120-128), with 32- and 16-key tiles, so the fusion
//   model's dialogues (Sq = 8-33) leave no warp idle. These calls are launch-
//   and latency-bound (below), where a wgmma tile of 64 rows would hold one
//   slice and leave most of its rows empty.
//
// Bound. At the wav2vec2 export's shape [32, 12, 499, 499, 64] bf16 one call
// moves q, k, v, out (24.5 MB each), the lse and the mask: 98.9 MB, 29.5 us
// at 3.35 TB/s; its two products are 4 x 384 x 499^2 x 64 = 24.5 GFLOP, 24.7
// us at 989 TFLOP/s. Bytes bound it, just: the Hopper forward reads q once
// and K, V once per query block (from L2 after the first), and meets first
// the exponentials on the SFU, which take as long as the products at this
// head dim (flash_attention_hopper.cuh). In f32 (the --f32 export) the same
// products are 73.4 GFLOP of TF32 in three passes, 0.148 ms at 495 TFLOP/s,
// against 196 MB of q, k, v, out (0.059 ms): operations bound it; the prep
// pass adds 300 MB. At the fusion shape [32, 8, 33, 33, 96] a call moves 6.5
// MB (2 us) and does 0.11 GFLOP: launch and latency bound.

#include "flash_attention_forward.cuh"
#include "flash_attention_hopper.cuh"

namespace {

struct flash_attention_fwd {};  // the kernels' tag: K1 in a profile

// slices a block by the query rows: four strips of 16, two of 32, or one of 64
template <typename T>
cudaError_t launch_by_rows(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                           int B, int H, int Sq, int Sk, int Dh, float scale, mer_philox::Dropout drop,
                           cudaStream_t s) {
  using K1 = flash_attention_fwd;
  if (Sq <= 16) return mer_fwd::launch<K1, T, 4>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  if (Sq <= 32) return mer_fwd::launch<K1, T, 2>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  return mer_fwd::launch<K1, T, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout: 0 = off; else the keep bit of
// each probability is Philox(seed0, seed1) >= threshold, kept ones scaled by
// keep_scale. scratch: 16-byte aligned, mer_hopper::tf32_scratch_floats(B, H,
// Sk) floats, read by the f32 Hopper design only (null in bf16). route: in,
// -1 for the design picked below, or 0 for the template whatever the call (a
// hook for timing the designs against each other on the same inputs,
// scripts/bench_attention.py --crossover); out, the design launched: 0 the
// template, 1 the bf16 Hopper forward, 2 the f32 3xTF32 one. Returns the
// cudaError_t of the launches.
extern "C" int mer_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, const void* mask,
                                       void* out, void* lse, void* scratch, int* route, int B, int H, int Sq, int Sk,
                                       int Dh, float scale, int dropout, uint32_t seed0, uint32_t seed1,
                                       uint32_t threshold, float keep_scale, void* stream) {
  cudaError_t err = mer_fwd::check_args(B, H, Sq, Sk, Dh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const mer_philox::Dropout drop{seed0, seed1, threshold, keep_scale, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using K1 = flash_attention_fwd;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool hopper = *route != 0 && Dh == mer_hopper::kD && aligned(q) && aligned(k) && aligned(v) &&
                      aligned(out) && (dtype == 1 || aligned(scratch));
  *route = hopper && (dtype == 0 || dtype == 1) ? 2 - dtype : 0;
  if (hopper && dtype == 1)
    return static_cast<int>(mer_hopper::launch_bf16<K1>(q, k, v, mask, out, lse, B, H, Sq, Sk, scale, drop, s));
  if (hopper && dtype == 0)
    return static_cast<int>(
        mer_hopper::launch_tf32<K1>(q, k, v, mask, out, lse, scratch, B, H, Sq, Sk, scale, drop, s));
  if (dtype == 0) err = launch_by_rows<float>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else if (dtype == 1) err = launch_by_rows<__nv_bfloat16>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
