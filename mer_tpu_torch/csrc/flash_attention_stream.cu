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
//   aligned tensors (scratch too): the Hopper design below (`mer_k3`).
// - f32 with Dh = 64 and 16-byte aligned tensors: the 3xTF32 Hopper forward
//   of flash_attention_hopper.cuh, which K1 launches too (a prep pass that
//   splits K and V^T into TF32 halves, then wgmma.m64n64k8 tf32 in three
//   passes; bound at [2, 12, 4499, 4499, 64]: 373 GFLOP of TF32, 0.754 ms at
//   495 TFLOP/s).
// - Anything else (any other Dh <= 128: the f32 parity legs' 50 and 96): the
//   forward template of flash_attention_forward.cuh, which K1 shares, at one
//   (b*h) slice a block (mma.sync in bf16, FMA in f32).
//
// The bf16 Hopper design: two launches in order on the stream, on the parts
// of flash_attention_hopper.cuh (the key biases, the online softmax of a
// tile in the accumulator registers, the epilogue).
//
// 1. prep: per key its bias in log2 units into f32 scratch [B][Sk padded to
//    64]: 0, -1e30 log2 e on an ignored key, -inf past Sk (no weight, even in
//    a fully masked row).
// 2. forward: a block owns one (b*h) slice and 64 query rows, one consumer
//    warpgroup and one producer warp. TMA loads the q tile once (3-D maps
//    [slice][rows][64]: no box crosses a slice); 64-key tiles of K and V and
//    their biases (a bulk copy) stream through a ring of stages, each with a
//    "full" and an "empty" mbarrier. Per tile S = q K^T is wgmma.m64n64k16
//    from shared memory (both K-major, 128-byte swizzled as TMA writes them);
//    the online softmax runs in the accumulator registers in log2 units
//    (exp2 of scale log2 e s + bias - m, the running max m and a per-thread
//    partial row sum), and with dropout each lane draws its scores' keep bits
//    there: lane (g, t) of warp w holds rows 16 w + g (+ 8), columns 8 j + 2 t
//    (+ 1), the mma.sync layout mer_philox::factors serves. O += (P o D) V is
//    a wgmma whose A (P o D rounded to bf16) comes from registers and whose B
//    is the V tile read MN-major through the transpose bit. The products
//    overlap the softmax: S of tile i and (P o D) V of tile i - 1 are issued
//    together, the exponentials and Philox of tile i run while the second
//    product completes, and O is rescaled once it has. Three blocks an SM
//    overlap one another's softmax and products; a block of two consumer
//    warpgroups sharing the ring and taking turns at the tensor cores (named
//    barriers), timed against it at the long-clip shapes, was slower at every
//    one. out and lse are written once.
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
#include <math.h>
#include <stdint.h>

#include "flash_attention_forward.cuh"
#include "flash_attention_hopper.cuh"
#include "philox.cuh"
#include "sm90.cuh"

namespace {

struct flash_attention_stream {};  // the kernels' tag: K3 in a profile

namespace mer_k3 {

using bf16 = __nv_bfloat16;
using namespace sm90;
using mer_hopper::align1024;
using mer_hopper::kD;
using mer_hopper::kTile;
using mer_tiles::pack_bf16;
using Params = mer_hopper::Params<bf16>;

constexpr uint32_t kTileBytes = kTile * kD * sizeof(bf16);
constexpr int kStages = 3;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp

struct Smem {
  bf16 q[kTile * kD];  // 1024-byte aligned tiles first
  bf16 k[kStages][kTile * kD];
  bf16 v[kStages][kTile * kD];
  float bias[kStages][kTile];
  uint64_t full[kStages], empty[kStages], q_full;
};

// 1. per key its bias in log2 units
template <typename Tag>
__global__ void __launch_bounds__(256) prep_kernel(const Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B * p.sk_pad) return;
  const int b = i / p.sk_pad, j = i - b * p.sk_pad;
  p.bias[i] = mer_hopper::key_bias(p, b, j);
}

// 2. out and lse of 64 query rows of one slice; three blocks an SM (with dropout that caps it at 128 registers,
// unspilled)
template <typename Tag, bool kDrop>
__global__ void __launch_bounds__(kThreads, 3)
    forward_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int n_tiles = (p.Sk + kTile - 1) / kTile;

  if (threadIdx.x >= 128) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(&sm.q_full, kTileBytes);
      tma_load_3d(sm.q, &map_q, &sm.q_full, 0, q0, bh);
      const float* bias = p.bias + (size_t)(bh / p.H) * p.sk_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes + kTile * sizeof(float));
        tma_load_3d(sm.k[s], &map_k, &sm.full[s], 0, it * kTile, bh);
        tma_load_3d(sm.v[s], &map_v, &sm.full[s], 0, it * kTile, bh);
        bulk_load(sm.bias[s], bias + it * kTile, kTile * sizeof(float), &sm.full[s]);
      }
    }
    return;
  }

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * w + g;  // this lane's query rows: row0, row0 + 8
  const float c_log2 = p.scale * mer_hopper::kLog2e;

  float o[32], sc[32], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  uint32_t a_p[4][4];  // P o D of the previous tile, bf16 pairs: the A operand of its product with V
  mbar_wait(&sm.q_full, 0);
  const uint64_t q_desc = desc_sw128(sm.q);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, prev = (it + kStages - 1) % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    const uint64_t k_desc = desc_sw128(sm.k[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    if (it > 0) {  // O += (P o D) V of the previous tile, behind S of this one
      const uint64_t v_desc = desc_sw128(sm.v[prev]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(o, a_p[kk], v_desc + 128 * kk);
      wgmma_commit();
    }
    if (it > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_operands(sc);

    // scores in log2 units where they lie: row row0 + 8 h, key it * 64 + 8 j + 2 t + c
    float alpha[2];
    mer_hopper::softmax_tile<kDrop>(sc, sm.bias[s], c_log2, m2, l, alpha, p.drop, bh, row0, it * kTile, t);
    if (it > 0) {
      wgmma_wait<0>();  // the previous tile's product with V: its stage and a_p are free
      fence_operands(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[prev]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a_p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  }
  {  // the last tile's product with V
    const uint64_t v_desc = desc_sw128(sm.v[(n_tiles - 1) % kStages]);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(o, a_p[kk], v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
  }
  mer_hopper::write_rows(o, l, m2, p, bh, row0, t);
}

template <typename Kernel>
cudaError_t launch_forward(Kernel kernel, const CUtensorMap (&maps)[3], const Params& p, cudaStream_t stream) {
  const int bytes = sizeof(Smem) + 1024;  // + alignment slack
  const cudaError_t smem_ok = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  kernel<<<dim3((p.Sq + kTile - 1) / kTile, p.BH), kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// One call of the Hopper design: scratch holds B pad64(Sk) floats.
template <typename Tag>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
                   void* scratch, int B, int H, int Sq, int Sk, float scale, mer_philox::Dropout drop,
                   cudaStream_t stream) {
  const int sk_pad = (Sk + kTile - 1) / kTile * kTile;
  const Params p{static_cast<bf16*>(out), static_cast<float*>(lse), static_cast<const uint8_t*>(mask),
                 static_cast<float*>(scratch), B * H, B, H, Sq, Sk, sk_pad, scale, drop};
  if (p.BH > 65535 || (long long)B * sk_pad > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap maps[3];  // q, k, v
  if (!encode_rows64(&maps[0], q, Sq, p.BH) || !encode_rows64(&maps[1], k, Sk, p.BH) ||
      !encode_rows64(&maps[2], v, Sk, p.BH))
    return cudaErrorInvalidValue;
  prep_kernel<Tag><<<(B * sk_pad + 255) / 256, 256, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (drop.on) return launch_forward(forward_kernel<Tag, true>, maps, p, stream);
  return launch_forward(forward_kernel<Tag, false>, maps, p, stream);
}

}  // namespace mer_k3
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dropout: 0 = off; else the keep bit of
// each probability is Philox(seed0, seed1) >= threshold, kept ones scaled by
// keep_scale. scratch: 16-byte aligned, read by the Hopper designs only: in
// bf16 B pad64(Sk) floats (pad64: rounded up to 64), in f32
// mer_hopper::tf32_scratch_floats(B, H, Sk). Returns the cudaError_t of the
// launches.
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
  if (Dh == mer_hopper::kD && aligned(q) && aligned(k) && aligned(v) && aligned(out) && aligned(scratch)) {
    if (dtype == 1)
      return static_cast<int>(mer_k3::launch<K3>(q, k, v, mask, out, lse, scratch, B, H, Sq, Sk, scale, drop, s));
    if (dtype == 0)
      return static_cast<int>(
          mer_hopper::launch_tf32<K3>(q, k, v, mask, out, lse, scratch, B, H, Sq, Sk, scale, drop, s));
  }
  if (dtype == 0) err = mer_fwd::launch<K3, float, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else if (dtype == 1)
    err = mer_fwd::launch<K3, __nv_bfloat16, 1>(q, k, v, mask, out, lse, B, H, Sq, Sk, Dh, scale, drop, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
