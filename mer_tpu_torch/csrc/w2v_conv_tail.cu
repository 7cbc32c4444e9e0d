// wav2vec2 conv layers 1..6 (stride 2, 512 -> 512 channels, exact GELU) for
// Hopper (sm_90a), f32 and bf16: kernel K6 of the port.
//
// Replaces the TPU kernel mer_tpu/ops/w2v_conv_pallas.py:135 (`_kernel`,
// launched from `conv_stack_fused` at :504, whose chain is `_conv_chain`
// :115). For the layer-0 output x0 [B, T0, 512] in the compute dtype T:
//
//   for layer i = 1..6, taps k_i = 3, 3, 3, 3, 2, 2, stride 2, no bias:
//     T_i           = (T_{i-1} - k_i) / 2 + 1
//     x_i[b, t, :]  = gelu( sum_j x_{i-1}[b, 2 t + j, :] @ W_i[j] )     t < T_i
//
// with f32 accumulation, the exact (erf) GELU in f32, and one rounding to T
// after each layer (as `_conv_chain` recasts between layers). out = x_6.
//
// Layout: x [B, T, 512] T, contiguous, channels last; the weights per output
// channel: w3 [4, 512, 3 * 512] for layers 1..4 and w2 [2, 512, 2 * 512] for
// layers 5, 6, row c_out, column j * 512 + c_in (the transpose of
// `_stack_weights`' tap-major matrices), in T. Scratch buf_a [B, T_1, 512],
// buf_b [B, T_2, 512]; out [B, T_6, 512].
//
// Each layer is one launch (6 a call), an implicit GEMM per clip: with
// channels last, window t of a clip is the contiguous run of k * 512 values
// that starts at row 2 t, so
//
//   out[b] [T_out, 512] = gelu( A_b [T_out, K] @ W^T ),   K = k * 512,
//   A_b row t = x[b] + 2 t * 512   (rows overlap)
//   W row n   = w + n * K          (both operands are rows of K contiguous values)
//
// A fused tail (all six layers on a tile in shared memory, as the TPU kernel
// does in VMEM) does not pay here: one output frame needs 79 rows of layer-1
// input, the 227 KB of an SM hold few frames with their intermediates, and
// every tile would stream the 8.4 MB of weights again; the intermediates it
// saves are 1/2, 1/4, ... of the layer-0 output that is read anyway.
//
// f32 (no main path runs it): a block of 256 threads owns a 128 x 128 output
// tile and walks K in slices of 16, fetched into registers (16-byte loads)
// while the last slice is multiplied out of shared memory, stored [k][row];
// each thread accumulates an 8 x 8 tile on the f32 CUDA cores. f32 inputs
// need full f32 products for the 2e-5 tolerance (no TF32).
//
// bf16 (the main paths): Hopper's pipeline.
//
// - Products on wgmma (m64nNk16, bf16 -> f32): a consumer warpgroup per 64
//   output frames, A and W both read from shared memory through 128-byte
//   swizzled descriptors, K-major (W as stack_tail_weights lays it out).
// - Loads by TMA into a ring of 3-4 stages of 64 k (a full and an empty
//   mbarrier each), which one producer warp fills: the consumers issue no
//   loads and no block-wide barriers.
// - The A operand as non-overlapping 2-D tiles. A clip's frames viewed as
//   pair rows [T / 2][1,024], row p = [x[2 p] | x[2 p + 1]] (the TPU kernel's
//   `_fold_pairs`, w2v_conv_pallas.py:106): taps 0 and 1 of output frame t
//   are pair row t, columns 0-1,023; tap 2 is frame 2 t + 2, the first half
//   of pair row t + 1. TMA checks bounds per dimension only, so for an odd T
//   the last pair row would run half past the clip (past the allocation for
//   the last clip). Hence two maps, each 3-D with the clip as a dimension:
//   the pairs [floor(T / 2)][1,024] for taps 0 and 1, and the even frames
//   [ceil(T / 2)][512] (row stride 1,024 values) for tap 2. Every element of
//   either lies inside its clip, so no load touches memory outside the tensor
//   it reads; where a box leaves a map TMA fills zeros, which reach only rows
//   t >= T_out, never stored. A K slice of 64 is then one box: (pairs, column
//   k0, row t0) below k0 = 1,024, else (even, column k0 - 1,024, row t0 + 1).
// - Tiles sized to fill the card, chosen per layer by the wrapper
//   (`ops/w2v_conv.py::conv_plan`, handed over as `plan`): 128 x 128 (two
//   consumer warpgroups, 3 stages, two blocks an SM) where that grid has at
//   least one block per SM (132), else 64 x 128 (one warpgroup, 4 stages);
//   128 x 256 tiles (one block an SM) timed no faster. A layer still under one
//   block per SM at 64 x 128 (the short layers of batch-2 calls) splits K:
//   each split stores its f32 sums, and the split that finishes a tile last
//   (an int counter per tile) adds them in split order, so the result has the
//   same bits from call to call; no float atomics.
// - Six launches, overlapped: layers 2-6 launch as programmatic dependents of
//   the layer before, so a layer's blocks start on the SMs its predecessor's
//   tail leaves free and send their first weight boxes before waiting for it
//   (griddepcontrol); every layer's output is still rounded to bf16 in memory.
// - Epilogue: the exact (erf) GELU in f32, one rounding to bf16, the tile
//   staged in the ring (16-byte units XOR-swizzled by row), 16-byte stores
//   of the rows t < T_out.

// Bound. At the export batch [32, 31999, 512] the six layers do
// 2 * 512 * 512 * (3 * (15999 + 7999 + 3999 + 1999) + 2 * (999 + 499)) per
// clip = 48.8 GFLOP, 1.56 TFLOP a batch: 1.6 ms at the 989 TFLOP/s of the bf16
// tensor cores, 23 ms at the 67 TFLOP/s of the f32 CUDA cores, against 1.1 GB
// (bf16) of input, 33 MB of output and 8.4 MB of weights, 0.33 ms at
// 3.35 TB/s. Bound by operations in both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kC = 512;          // channels in and out
constexpr int kBM = 128;         // output frames per block
constexpr int kBN = 128;         // output channels per block, both paths
constexpr int kThreads = 256;
constexpr int kLayers = 6;

static_assert(kC % kBN == 0 && kBM == kBN, "one fetch pattern serves both operands");

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// -- f32: the CUDA cores ---------------------------------------------------------

constexpr int kBK = 16;          // K slice
constexpr int kLd = kBM + 4;     // padded [k][row] row, a multiple of 4 floats

static_assert(kC % kBK == 0 && kBM * kBK == 8 * kThreads, "8 values of each operand a thread per slice");

// grid (512 / kBN, ceil(T_out / kBM), B); K = taps * 512.
__global__ void __launch_bounds__(kThreads, 2)
w2v_conv_s2_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                        int T_in, int T_out, int K) {
  __shared__ __align__(16) float a_s[2][kBK][kLd];  // [buffer][k][frame]
  __shared__ __align__(16) float b_s[2][kBK][kLd];  // [buffer][k][channel]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const float* x_clip = x + (size_t)blockIdx.z * T_in * kC;

  // fetch: 8 values (k f_k..f_k + 7) of frame f_row of A and of channel f_row of W
  const int f_row = tid & (kBM - 1);
  const int f_k = (tid >> 7) * 8;
  const bool a_valid = m0 + f_row < T_out;
  const float* a_src = x_clip + (size_t)(m0 + f_row) * 2 * kC + f_k;
  const float* b_src = w + (size_t)(n0 + f_row) * K + f_k;

  float4 a_reg[2], b_reg[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_reg[h] = a_valid ? *reinterpret_cast<const float4*>(a_src + k0 + 4 * h) : make_float4(0.f, 0.f, 0.f, 0.f);
      b_reg[h] = *reinterpret_cast<const float4*>(b_src + k0 + 4 * h);
    }
  };
  auto stash = [&](int buf) {  // transposed: a warp's 32 rows land in 32 banks
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float av[4] = {a_reg[h].x, a_reg[h].y, a_reg[h].z, a_reg[h].w};
      const float bv[4] = {b_reg[h].x, b_reg[h].y, b_reg[h].z, b_reg[h].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_s[buf][f_k + 4 * h + j][f_row] = av[j];
        b_s[buf][f_k + 4 * h + j][f_row] = bv[j];
      }
    }
  };

  // compute: frames 4 ty.. and 64 + 4 ty.., channels 4 tx.. and 64 + 4 tx..
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  const int n_slices = K / kBK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slices) fetch((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[buf][kk][4 * ty]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[buf][kk][64 + 4 * ty]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[buf][kk][4 * tx]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[buf][kk][64 + 4 * tx]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_slices) stash(buf ^ 1);  // the other buffer: nobody reads it during this slice
    __syncthreads();
  }

  float* out_clip = out + (size_t)blockIdx.z * T_out * kC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
    if (row >= T_out) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float4*>(out_clip + (size_t)row * kC + n0 + 64 * half + 4 * tx) =
          make_float4(gelu_exact(acc[i][4 * half]), gelu_exact(acc[i][4 * half + 1]),
                      gelu_exact(acc[i][4 * half + 2]), gelu_exact(acc[i][4 * half + 3]));
  }
}

// -- bf16: wgmma with TMA (Hopper) ---------------------------------------------------

namespace mer_k6 {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBK = 64;             // k of a ring stage: one 128-byte swizzled row of bf16
constexpr int kPairCols = 2 * kC;   // a pair row: frames 2 p and 2 p + 1, 1,024 values
constexpr int kPlanInts = 2;        // per layer: consumer warpgroups, K splits

// One layer's grid, besides its three tensor maps.
struct Layer {
  bf16* out;        // [B, t_out, 512]
  float* partial;   // split K: [tile][split][BM * BN] f32, in the consumers' register order
  int* counters;    // split K: one per output tile; zero on entry, left zero
  int t_out, m_tiles, k_slices, splits, layer;  // layer: the weights' index in w3 or w2
};

template <int kWG>  // every tile is kBN = 128 channels wide
struct Tile {
  static constexpr int kBM = 64 * kWG;              // one consumer warpgroup per 64 output frames
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
  static constexpr uint32_t kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
  static constexpr int kStages = kWG == 2 ? 3 : 4;  // two blocks an SM either way
  static constexpr int kBlocksPerSM = 2;
  static constexpr int kRingBytes = kStages * (kABytes + kBBytes);
  static constexpr int kSmem = 1024 + kRingBytes + 2 * kStages * 8 + 16;  // + alignment slack, barriers, flag
  static_assert(kBM * kBN * 2 <= kRingBytes, "the epilogue stages the bf16 tile in the ring");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (512 / kBN, m_tiles, B * splits): block (n, m, clip * splits + split) computes output frames
// m * kBM .. of clip `clip`, channels n * kBN .., over its split's share of the K slices.
template <int kWG>
__global__ void __launch_bounds__(Tile<kWG>::kThreads, Tile<kWG>::kBlocksPerSM)
    w2v_conv_s2_gelu_wgmma_kernel(const __grid_constant__ CUtensorMap map_pairs,
                                  const __grid_constant__ CUtensorMap map_even,
                                  const __grid_constant__ CUtensorMap map_w, const Layer p) {
  using T = Tile<kWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* a_ring = ring;                            // [kStages][kBM rows][128 B], swizzled
  unsigned char* b_ring = ring + T::kStages * T::kABytes;  // [kStages][kBN rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::kRingBytes);
  uint64_t* empty = full + T::kStages;
  int* last = reinterpret_cast<int*>(empty + T::kStages);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * T::kBM;
  const int clip = blockIdx.z / p.splits, split = blockIdx.z - clip * p.splits;
  const int s0 = split * p.k_slices / p.splits;
  const int n_it = (split + 1) * p.k_slices / p.splits - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  grid_dependents_launch();  // the next layer's blocks may take SMs this grid no longer needs

  if (threadIdx.x >= T::kConsumers) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == T::kConsumers) {
      // The weights do not depend on the previous layer: the first stages' W boxes go out before waiting for it.
      const int n_pre = min(n_it, T::kStages);
      for (int i = 0; i < n_pre; ++i) {
        mbar_expect_tx(&full[i], T::kABytes + T::kBBytes);
        tma_load_3d(b_ring + i * T::kBBytes, &map_w, &full[i], (s0 + i) * kBK, n0, p.layer);
      }
      grid_dependency_wait();  // the previous layer (this layer's A) has completed
      for (int i = 0; i < n_it; ++i) {
        const int s = i % T::kStages, k0 = (s0 + i) * kBK;
        if (i >= n_pre) {
          mbar_wait(&empty[s], ((i / T::kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kABytes + T::kBBytes);
          tma_load_3d(b_ring + s * T::kBBytes, &map_w, &full[s], k0, n0, p.layer);
        }
        if (k0 < kPairCols)  // taps 0 and 1 of frame t: pair row t
          tma_load_3d(a_ring + s * T::kABytes, &map_pairs, &full[s], k0, m0, clip);
        else  // tap 2: frame 2 t + 2, the first half of pair row t + 1
          tma_load_3d(a_ring + s * T::kABytes, &map_even, &full[s], k0 - kPairCols, m0 + 1, clip);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float acc[kBN / 2];
#pragma unroll
  for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;
  for (int i = 0; i < n_it; ++i) {
    const int s = i % T::kStages;
    mbar_wait(&full[s], (i / T::kStages) & 1);
    const uint64_t da = desc_sw128(a_ring + s * T::kABytes + wg * 64 * 128);
    const uint64_t db = desc_sw128(b_ring + s * T::kBBytes);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_ss(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done: its stage goes back to the producer
    fence_operands(acc);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % T::kStages]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int ct = threadIdx.x;  // 0 .. kConsumers - 1
  if (p.splits > 1) {
    // Each split stores its f32 sums; the block that finishes a tile last adds them in split order (the same
    // bits whichever block that is) and goes on to the epilogue. No float atomics.
    constexpr int kTileVals = T::kBM * kBN;
    const int tile = (clip * p.m_tiles + blockIdx.y) * gridDim.x + blockIdx.x;
    float* part = p.partial + (size_t)tile * p.splits * kTileVals;
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) part[(size_t)split * kTileVals + v * T::kConsumers + ct] = acc[v];
    __threadfence();
    bar_sync(1, T::kConsumers);
    if (ct == 0) *last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    bar_sync(1, T::kConsumers);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {  // a split's kBN / 2 loads in flight at once
      const float* src = part + (size_t)sp * kTileVals + ct;
#pragma unroll
      for (int v = 0; v < kBN / 2; ++v) acc[v] += __ldcg(src + v * T::kConsumers);
    }
    if (ct == 0) p.counters[tile] = 0;
  }

  // Epilogue: GELU in f32, one rounding to bf16, the tile staged in the ring (64-column chunks of 128-byte rows,
  // 16-byte units XOR-swizzled by the row: conflict-free both ways), then 16-byte stores of rows < t_out.
  bar_sync(1, T::kConsumers);  // every consumer warpgroup is past its last wgmma: the ring is free
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + g + 8 * h;  // d[4 j + 2 h + c]: row r, column 8 j + 2 t + c
      const int chunk = j >> 3, unit = j & 7;
      *reinterpret_cast<uint32_t*>(ring + chunk * (T::kBM * 128) + r * 128 + ((unit ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(gelu_exact(acc[4 * j + 2 * h]), gelu_exact(acc[4 * j + 2 * h + 1]));
    }
  bar_sync(1, T::kConsumers);
  constexpr int kUnits = kBN / 8;  // 16-byte units of a tile row
  const int rows = min(T::kBM, p.t_out - m0);
  bf16* out = p.out + ((size_t)clip * p.t_out + m0) * kC + n0;
  for (int q = ct; q < rows * kUnits; q += T::kConsumers) {
    const int r = q / kUnits, u = q - r * kUnits, chunk = u >> 3, unit = u & 7;
    *reinterpret_cast<uint4*>(out + (size_t)r * kC + 8 * u) =
        *reinterpret_cast<const uint4*>(ring + chunk * (T::kBM * 128) + r * 128 + ((unit ^ (r & 7)) << 4));
  }
}

// overlap: launch as a programmatic dependent of the previous kernel on the stream (the previous layer), whose
// tail then overlaps this grid's start; its producer waits for it before reading A.
template <int kWG>
cudaError_t launch_layer(const bf16* x, int t_in, const bf16* w, int n_w, const Layer& p, int B, bool overlap,
                         cudaStream_t stream) {
  using T = Tile<kWG>;
  // A: the clip's frames as pair rows [floor(t_in / 2)][1,024] (taps 0, 1) and as even frames
  // [ceil(t_in / 2)][512] (tap 2), with the clip as the third dimension: every element of either map lies in
  // its clip, so no box reads outside the tensor (TMA zero-fills a box where it leaves a map).
  const cuuint64_t a_strides[2] = {2 * kC * sizeof(bf16), (cuuint64_t)t_in * kC * sizeof(bf16)};
  const cuuint32_t a_box[3] = {kBK, T::kBM, 1};
  const int K = p.k_slices * kBK;
  CUtensorMap maps[3];
  if (!encode_bf16_3d(&maps[0], x, {kPairCols, (cuuint64_t)(t_in / 2), (cuuint64_t)B}, a_strides, a_box) ||
      !encode_bf16_3d(&maps[1], x, {kC, (cuuint64_t)((t_in + 1) / 2), (cuuint64_t)B}, a_strides, a_box) ||
      !encode_bf16_3d(&maps[2], w, {(cuuint64_t)K, kC, (cuuint64_t)n_w},
                      {(cuuint64_t)K * sizeof(bf16), (cuuint64_t)K * kC * sizeof(bf16)}, {kBK, kBN, 1}))
    return cudaErrorInvalidValue;
  auto kernel = w2v_conv_s2_gelu_wgmma_kernel<kWG>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC / kBN, p.m_tiles, B * p.splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], p);
}

// The six layers in turn, layer i on the tile of plan[2 i] consumer warpgroups and the plan[2 i + 1] K splits.
int launch(const bf16* x, const bf16* w3, const bf16* w2, bf16* buf_a, bf16* buf_b, bf16* out, int B, int T0,
           const int* plan, float* partial, long long partial_numel, int* counters, int n_counters,
           cudaStream_t stream) {
  const int taps[kLayers] = {3, 3, 3, 3, 2, 2};
  bf16* dst_of[kLayers] = {buf_a, buf_b, buf_a, buf_b, buf_a, out};
  const bf16* src = x;
  int t_in = T0;
  for (int layer = 0; layer < kLayers; ++layer) {
    const int k = taps[layer], wg = plan[kPlanInts * layer], splits = plan[kPlanInts * layer + 1];
    const int t_out = (t_in - k) / 2 + 1;
    const int bm = 64 * wg, k_slices = k * kC / kBK;
    if (t_in < k || t_out <= 0 || wg < 1 || splits < 1 || splits > k_slices || B * splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const Layer p{dst_of[layer], partial, counters, t_out, (t_out + bm - 1) / bm, k_slices, splits,
                  layer < 4 ? layer : layer - 4};
    if (p.m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    if (splits > 1) {
      const long long tiles = (long long)B * p.m_tiles * (kC / kBN);
      if (partial == nullptr || counters == nullptr || tiles > n_counters ||
          tiles * splits * bm * kBN > partial_numel)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const bf16* w = layer < 4 ? w3 : w2;
    const int n_w = layer < 4 ? 4 : 2;
    cudaError_t err;
    if (wg == 2)
      err = launch_layer<2>(src, t_in, w, n_w, p, B, layer > 0, stream);
    else if (wg == 1)
      err = launch_layer<1>(src, t_in, w, n_w, p, B, layer > 0, stream);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst_of[layer];
    t_in = t_out;
  }
  return 0;
}

}  // namespace mer_k6

// the f32 path: six launches of the CUDA-core kernel
int launch_f32(const float* x, const float* w3, const float* w2, float* buf_a, float* buf_b, float* out, int B,
               int T0, cudaStream_t stream) {
  const int taps[kLayers] = {3, 3, 3, 3, 2, 2};
  float* dst_of[kLayers] = {buf_a, buf_b, buf_a, buf_b, buf_a, out};
  const float* src = x;
  int t_in = T0;
  for (int layer = 0; layer < kLayers; ++layer) {
    const int k = taps[layer];
    const int t_out = (t_in - k) / 2 + 1;
    if (t_in < k || t_out <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const float* w = layer < 4 ? w3 + (size_t)layer * 3 * kC * kC : w2 + (size_t)(layer - 4) * 2 * kC * kC;
    const dim3 grid(kC / kBN, (t_out + kBM - 1) / kBM, B);
    w2v_conv_s2_gelu_kernel<<<grid, kThreads, 0, stream>>>(src, w, dst_of[layer], t_in, t_out, k * kC);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst_of[layer];
    t_in = t_out;
  }
  return 0;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x, w3, w2, buf_a, buf_b, out). buf_a holds
// [B, T_1, 512] and buf_b [B, T_2, 512] values; the six layers alternate
// between them and the last writes out [B, T_6, 512]. The rest serves bf16
// only (f32 ignores it): plan holds 2 ints a layer (consumer warpgroups of the
// 128-channel tile, 2 or 1; K splits, 1 .. 8 k); partial (partial_numel
// floats) and counters (n_counters ints, zero on entry and left zero) hold,
// for the layer that needs most, its tiles = B ceil(T_out / (64 wg)) 4
// counters and tiles splits 64 wg 128 floats, and may be null when no layer splits; every tensor is 16-byte
// aligned. Returns the cudaError_t of the first launch that failed
// (cudaErrorInvalidValue for arguments the kernels do not take), or 0.
extern "C" int mer_w2v_conv_tail(int dtype, const void* x, const void* w3, const void* w2, void* buf_a, void* buf_b,
                                 void* out, int B, int T0, const int* plan, void* partial, long long partial_numel,
                                 void* counters, int n_counters, void* stream) {
  if (B <= 0 || B > 65535 || T0 <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(w3), static_cast<const float*>(w2),
                      static_cast<float*>(buf_a), static_cast<float*>(buf_b), static_cast<float*>(out), B, T0, s);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (plan == nullptr || !aligned(x) || !aligned(w3) || !aligned(w2) || !aligned(buf_a) || !aligned(buf_b) ||
      !aligned(out) || !aligned(partial))
    return static_cast<int>(cudaErrorInvalidValue);
  using mer_k6::bf16;
  return mer_k6::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
                        static_cast<bf16*>(buf_a), static_cast<bf16*>(buf_b), static_cast<bf16*>(out), B, T0, plan,
                        static_cast<float*>(partial), partial_numel, static_cast<int*>(counters), n_counters, s);
}
