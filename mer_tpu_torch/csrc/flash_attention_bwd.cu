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
// Two designs, picked per call; the C entry writes which it launched to its
// `route` argument:
//
// - bf16 and f32 at Sq, Sk <= 64 and Dh 50, 64 or 96 with 16-byte aligned q,
//   k, v, out, g, dq, dk, dv (the fusion model's dialogues, 8 heads of 96, and
//   the mel variant's 6 audio heads of 50): the one-pass stacked design of
//   flash_attention_bwd_stacked.cuh (route 1 in bf16, 2 in f32). One launch a
//   call; a block owns a 64-row tile that stacks whole (b*h) slices
//   block-diagonally (8, 4, 2, 1 at 8, 16, 24, 33 keys) and computes S, g v^T,
//   P, D, dS and delta once each; in bf16 swizzled 64 x 64 boxes of the [B*H*S,
//   Dh] views (by TMA, or at Dh 50 by 4-byte loads) and five wgmma products (S
//   and dP m64n64k16, dV, dK and dQ m64n96k16, or m64n56k16 at Dh 50, with P o
//   D and dS from shared memory), in f32 1-D bulk copies (8-byte loads at Dh
//   50) and FMA on the CUDA cores. No scratch.
// - Anything else (other head dims, an unaligned view, more than 64 keys or
//   rows): the two grids of flash_attention_backward.cuh (route 0),
//   which K4 shares: a dq grid that writes delta to the f32 scratch, then a
//   dk/dv grid over the keys that walks the query rows in order with dk and dv
//   in registers; all five products on mma.sync.m16n8k16 in bf16 (f32 by FMA),
//   tiles staged with cp.async, a block of 4 warps taking 1, 2 or 4 (b*h)
//   slices (the TPU kernel's bh_block, :120-128).
//
// Neither uses float atomics, so f32 reproduces bit for bit.
//
// Bound. At the wav2vec2 fine-tune step's shape [16, 12, 499, 499, 64] bf16
// one call reads q, k, v, out, g and writes dq, dk, dv (12.3 MB each, 98.1
// MB) with the lse and the mask: 29.4 us at 3.35 TB/s; its five products are
// 10 x 192 x 499^2 x 64 = 30.6 GFLOP, 30.9 us at 989 TFLOP/s (the dispatch
// sends such calls to K4). At the fusion shapes [16-32, 4-8, 8-33, 8-33, 96]
// a call moves 1.6-13 MB in bf16 (0.47-3.9 us; up to 7.8 us in f32): latency
// and launch bound, what the stacked design is built for.

#include "flash_attention_backward.cuh"
#include "flash_attention_bwd_stacked.cuh"

namespace {

constexpr int kMaxSk = 2048;  // FUSED_KERNEL_MAX; the dispatch sends K2 at most BWD_FUSED_MAX = 33 keys (K4 beyond)
struct flash_attention_bwd {};  // the kernels' tag: K2 in a profile

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g_lse may be null (no lse cotangent);
// delta is f32 scratch of [B, H, Sq] for the template, null for the stacked
// design. route: in, -1 for the design picked above, or 0 for the template
// whatever the call (a hook for timing the designs against each other on the
// same inputs, scripts/bench_attention.py --crossover); out, the design
// launched: 0 the template, 1 the bf16 stacked design, 2 the f32 one. dropout
// as in mer_flash_attention_fwd. Refuses more than kMaxSk keys, and the
// template without delta. Returns the cudaError_t of the launches.
extern "C" int mer_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* mask,
                                       const void* out, const void* lse, const void* g, const void* g_lse, void* dq,
                                       void* dk, void* dv, void* delta, int* route, int B, int H, int Sq, int Sk,
                                       int Dh, float scale, int dropout, uint32_t seed0, uint32_t seed1,
                                       uint32_t threshold, float keep_scale, void* stream) {
  if (Sk > kMaxSk) return static_cast<int>(cudaErrorInvalidValue);
  const mer_bwd::Args a{q, k, v, mask, out, lse, g, g_lse, dq, dk, dv, delta, B, H, Sq, Sk, Dh, scale,
                        {seed0, seed1, threshold, keep_scale, dropout}, 0, static_cast<cudaStream_t>(stream)};
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool stacked = *route != 0 && mer_stacked::takes(dtype, Sq, Sk, Dh,
                                                         aligned(q) && aligned(k) && aligned(v) && aligned(out) &&
                                                             aligned(g) && aligned(dq) && aligned(dk) && aligned(dv));
  *route = stacked ? 2 - dtype : 0;
  if (stacked)
    return static_cast<int>(dtype == 1 ? mer_stacked::launch_bf16<flash_attention_bwd>(a)
                                       : mer_stacked::launch_f32<flash_attention_bwd>(a));
  if (delta == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return mer_bwd::launch<flash_attention_bwd, true>(dtype, a);
}
