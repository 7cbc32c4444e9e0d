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
// `_stack_weights`' tap-major matrices), in T; in f32 each stacked twice,
// the TF32 high halves then the low halves (w3 [2, 4, 512, 1,536]). Scratch buf_a [B, T_1, 512],
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
// Both compute dtypes run one pipeline:
//
// - Products on the tensor cores: a consumer warpgroup per 64 output frames.
//   bf16: wgmma m64n128k16 (bf16 -> f32), A and W both read from shared
//   memory through 128-byte swizzled descriptors, K-major (W as
//   stack_tail_weights lays it out). f32: TF32 with error compensation
//   (3xTF32): each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
//   (round to nearest), and each K slice's lo_A hi_W + hi_A lo_W + hi_A hi_W
//   runs as wgmma m64n128k8 tf32 into a fresh accumulator, which the CUDA
//   cores add to the f32 sum (the dropped lo_A lo_W is 2^-22 of a product:
//   f32's accuracy, where one TF32 pass keeps 2^-11; the tensor cores' f32
//   accumulation does not round to nearest, so it spans one slice). The weights'
//   halves are split once on the host side (split_tail_weights, kept across
//   calls); the activations' are split in registers: each consumer thread
//   reads its A fragment (4 values a k-step of 8) from the swizzled stage
//   that TMA wrote and feeds hi and lo to wgmma as its register operand, so
//   no extra pass, buffer or shared-memory write is needed (TF32 wgmma takes
//   only K-major operands, which both are here).
// - Loads by TMA into a ring of 2-4 stages of one 128-byte swizzled row of k
//   (64 bf16 or 32 f32; a full and an empty mbarrier each), which one
//   producer warp fills: the consumers issue no loads and no block-wide
//   barriers. An f32 stage holds A, W's hi and W's lo.
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
//   t >= T_out, never stored. A K slice (one 128-byte row) is then one box: (pairs, column
//   k0, row t0) below k0 = 1,024, else (even, column k0 - 1,024, row t0 + 1).
// - Tiles sized to fill the card, chosen per layer by the wrapper
//   (`ops/w2v_conv.py::conv_plan`, handed over as `plan`, the same for both
//   dtypes): 128 x 128 (two consumer warpgroups; bf16 3 stages, two blocks an
//   SM; f32 3 stages, one block an SM) where that grid has at least one block
//   per SM (132), else 64 x 128 (one warpgroup; bf16 4 stages, f32 2; two
//   blocks an SM);
//   128 x 256 tiles (one block an SM) timed no faster. A layer still under one
//   block per SM at 64 x 128 (the short layers of batch-2 calls) splits K:
//   each split stores its f32 sums, and the split that finishes a tile last
//   (an int counter per tile) adds them in split order, so the result has the
//   same bits from call to call; no float atomics.
// - Six launches, overlapped: layers 2-6 launch as programmatic dependents of
//   the layer before, so a layer's blocks start on the SMs its predecessor's
//   tail leaves free and send their first weight boxes before waiting for it
//   (griddepcontrol); every layer's output is still rounded to T in memory.
// - Epilogue: the exact (erf) GELU in f32; bf16: one rounding, the tile
//   staged in the ring (16-byte units XOR-swizzled by row), 16-byte stores of
//   the rows t < T_out; f32: 8-byte stores straight from the accumulator (a
//   quad writes 32 contiguous bytes of a row).

// Bound. At the export batch [32, 31999, 512] the six layers do
// 2 * 512 * 512 * (3 * (15999 + 7999 + 3999 + 1999) + 2 * (999 + 499)) per
// clip = 48.8 GFLOP, 1.56 TFLOP a batch: 1.6 ms at the 989 TFLOP/s of the bf16
// tensor cores; in f32, three TF32 products each, 9.5 ms at 495 TFLOP/s (the
// f32 CUDA cores, 67 TFLOP/s, would take 23 ms), against 1.1 GB (bf16; 2.1 GB
// f32) of input, 33 MB of output and 8.4 MB of weights, 0.33 ms at 3.35 TB/s.
// Bound by operations in both types. What holds each below its bound: the
// grid at batch 2 (split K), the ring fill and epilogue per tile, and for f32
// the A fragments read and split in registers between a stage's arrival and
// its products (the other warpgroups of the SM fill that gap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {
namespace mer_k6 {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kC = 512;             // channels in and out
constexpr int kBN = 128;            // output channels of every tile
constexpr int kLayers = 6;
constexpr int kPairCols = 2 * kC;   // a pair row: frames 2 p and 2 p + 1, 1,024 values
constexpr int kPlanInts = 2;        // per layer: consumer warpgroups, K splits
constexpr int kRow = 128;           // bytes of a swizzled tile row: a ring stage's k

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

// Per compute dtype: the k of a ring stage (one 128-byte row), the weight tiles a stage holds (f32: the TF32 high
// and low halves) and the TMA element type.
template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int kBK = kRow / 2, kWParts = 1;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<float> {
  static constexpr int kBK = kRow / 4, kWParts = 2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// One layer's grid, besides its three tensor maps.
struct Layer {
  void* out;        // [B, t_out, 512] in the compute dtype
  float* partial;   // split K: [tile][split][BM * BN] f32, in the consumers' register order
  int* counters;    // split K: one per output tile; zero on entry, left zero
  int t_out, m_tiles, k_slices, splits;
  int layer, n_w;   // the weights' index in w3 or w2, and how many that tensor stacks (f32: its lo halves follow)
};

template <typename T, int kWG>  // every tile is kBN = 128 channels wide
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBK = Elem<T>::kBK;
  static constexpr int kBM = 64 * kWG;              // one consumer warpgroup per 64 output frames
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
  static constexpr uint32_t kABytes = kBM * kRow, kBBytes = kBN * kRow;
  static constexpr uint32_t kStageBytes = kABytes + Elem<T>::kWParts * kBBytes;
  // bf16: two blocks an SM either way; f32 (48 KB a 128 x 128 stage, A split in registers): the wide tile one
  // block an SM of 3 stages, the narrow one two of 2
  static constexpr int kStages = kF32 ? (kWG == 2 ? 3 : 2) : (kWG == 2 ? 3 : 4);
  static constexpr int kBlocksPerSM = kF32 && kWG == 2 ? 1 : 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kRingBytes + 2 * kStages * 8 + 16;  // + alignment slack, barriers, flag
  static_assert(kF32 || kBM * kBN * 2 <= kRingBytes, "the bf16 epilogue stages its tile in the ring");
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
template <typename T, int kWG>
__global__ void __launch_bounds__(Tile<T, kWG>::kThreads, Tile<T, kWG>::kBlocksPerSM)
    w2v_conv_s2_gelu_wgmma_kernel(const __grid_constant__ CUtensorMap map_pairs,
                                  const __grid_constant__ CUtensorMap map_even,
                                  const __grid_constant__ CUtensorMap map_w, const Layer p) {
  using Tl = Tile<T, kWG>;
  constexpr int kBK = Tl::kBK, kWParts = Elem<T>::kWParts;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* a_ring = ring;                              // [kStages][kBM rows][128 B], swizzled
  unsigned char* b_ring = ring + Tl::kStages * Tl::kABytes;  // [kStages][kWParts][kBN rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::kRingBytes);
  uint64_t* empty = full + Tl::kStages;
  int* last = reinterpret_cast<int*>(empty + Tl::kStages);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * Tl::kBM;
  const int clip = blockIdx.z / p.splits, split = blockIdx.z - clip * p.splits;
  const int s0 = split * p.k_slices / p.splits;
  const int n_it = (split + 1) * p.k_slices / p.splits - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tl::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  grid_dependents_launch();  // the next layer's blocks may take SMs this grid no longer needs

  if (threadIdx.x >= Tl::kConsumers) {  // the producer warp: one lane issues every copy
    if (threadIdx.x == Tl::kConsumers) {
      const auto load_w = [&](int s, int i) {  // the weight tiles of slice s0 + i into stage s (f32: hi, then lo)
        for (int part = 0; part < kWParts; ++part)
          tma_load_3d(b_ring + (s * kWParts + part) * Tl::kBBytes, &map_w, &full[s], (s0 + i) * kBK, n0,
                      p.layer + part * p.n_w);
      };
      // The weights do not depend on the previous layer: the first stages' W boxes go out before waiting for it.
      const int n_pre = min(n_it, Tl::kStages);
      for (int i = 0; i < n_pre; ++i) {
        mbar_expect_tx(&full[i], Tl::kStageBytes);
        load_w(i, i);
      }
      grid_dependency_wait();  // the previous layer (this layer's A) has completed
      for (int i = 0; i < n_it; ++i) {
        const int s = i % Tl::kStages, k0 = (s0 + i) * kBK;
        if (i >= n_pre) {
          mbar_wait(&empty[s], ((i / Tl::kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], Tl::kStageBytes);
          load_w(s, i);
        }
        if (k0 < kPairCols)  // taps 0 and 1 of frame t: pair row t
          tma_load_3d(a_ring + s * Tl::kABytes, &map_pairs, &full[s], k0, m0, clip);
        else  // tap 2: frame 2 t + 2, the first half of pair row t + 1
          tma_load_3d(a_ring + s * Tl::kABytes, &map_even, &full[s], k0 - kPairCols, m0 + 1, clip);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kBN / 2];
#pragma unroll
  for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;
  for (int i = 0; i < n_it; ++i) {
    const int s = i % Tl::kStages;
    mbar_wait(&full[s], (i / Tl::kStages) & 1);
    const unsigned char* a_tile = a_ring + s * Tl::kABytes + wg * 64 * kRow;  // this warpgroup's 64 rows
    const uint64_t db = desc_sw128(b_ring + s * kWParts * Tl::kBBytes);
    if constexpr (Tl::kF32) {
      // A fragment of k-step kk, register r: row 16 warp + g + 8 (r & 1), column 8 kk + t + 4 (r >> 1), whose
      // 16-byte chunk 2 kk + (r >> 1) sits at chunk index ^ (row & 7) = ^ g in the 128-byte swizzle
      uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * warp + g + 8 * (r & 1), chunk = (2 * kk + (r >> 1)) ^ g;
          const float x = *reinterpret_cast<const float*>(a_tile + row * kRow + (chunk << 4) + 4 * t);
          hi[kk][r] = tf32_rna(x);
          lo[kk][r] = tf32_rna(x - __uint_as_float(hi[kk][r]));
        }
      // The slice's twelve products go into a fresh accumulator, added to acc in f32 on the CUDA cores: with one
      // tensor-core accumulator over a whole K (576 products a layer) the error against the plain version grew
      // to the f32 limit, over one slice's twelve it stays at f32 rounding (the tensor cores' accumulation does
      // not round to nearest).
      const uint64_t db_lo = desc_sw128(b_ring + (s * kWParts + 1) * Tl::kBBytes);
      float part[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_rs(part, lo[kk], db + 2 * kk, kk);  // the small terms first
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_rs(part, hi[kk], db_lo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) wgmma_tf32_rs(part, hi[kk], db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();  // the registers of hi and lo are read until the products complete
      fence_operands(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int v = 0; v < kBN / 2; ++v) acc[v] += part[v];
    } else {
      const uint64_t da = desc_sw128(a_tile);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_ss(acc, da + 2 * kk, db + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its stage goes back to the producer
      fence_operands(acc);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(i - 1) % Tl::kStages]);
      }
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int ct = threadIdx.x;  // 0 .. kConsumers - 1
  if (p.splits > 1) {
    // Each split stores its f32 sums; the block that finishes a tile last adds them in split order (the same
    // bits whichever block that is) and goes on to the epilogue. No float atomics.
    constexpr int kTileVals = Tl::kBM * kBN;
    const int tile = (clip * p.m_tiles + blockIdx.y) * gridDim.x + blockIdx.x;
    float* part = p.partial + (size_t)tile * p.splits * kTileVals;
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) part[(size_t)split * kTileVals + v * Tl::kConsumers + ct] = acc[v];
    __threadfence();
    bar_sync(1, Tl::kConsumers);
    if (ct == 0) *last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
    bar_sync(1, Tl::kConsumers);
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {  // a split's kBN / 2 loads in flight at once
      const float* src = part + (size_t)sp * kTileVals + ct;
#pragma unroll
      for (int v = 0; v < kBN / 2; ++v) acc[v] += __ldcg(src + v * Tl::kConsumers);
    }
    if (ct == 0) p.counters[tile] = 0;
  }

  if constexpr (Tl::kF32) {
    // f32: d[4 j + 2 h + c] is row 64 wg + 16 warp + g + 8 h, column 8 j + 2 t + c; a quad stores 32 bytes a row
    float* out = static_cast<float*>(p.out) + ((size_t)clip * p.t_out + m0) * kC + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * warp + g + 8 * h;
      if (m0 + r >= p.t_out) continue;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(out + (size_t)r * kC + 8 * j + 2 * t) =
            make_float2(gelu_exact(acc[4 * j + 2 * h]), gelu_exact(acc[4 * j + 2 * h + 1]));
    }
  } else {
    // bf16: GELU in f32, one rounding to bf16, the tile staged in the ring (64-column chunks of 128-byte rows,
    // 16-byte units XOR-swizzled by the row: conflict-free both ways), then 16-byte stores of rows < t_out.
    bar_sync(1, Tl::kConsumers);  // every consumer warpgroup is past its last wgmma: the ring is free
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * warp + g + 8 * h;  // d[4 j + 2 h + c]: row r, column 8 j + 2 t + c
        const int chunk = j >> 3, unit = j & 7;
        *reinterpret_cast<uint32_t*>(ring + chunk * (Tl::kBM * 128) + r * 128 + ((unit ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(gelu_exact(acc[4 * j + 2 * h]), gelu_exact(acc[4 * j + 2 * h + 1]));
      }
    bar_sync(1, Tl::kConsumers);
    constexpr int kUnits = kBN / 8;  // 16-byte units of a tile row
    const int rows = min(Tl::kBM, p.t_out - m0);
    bf16* out = static_cast<bf16*>(p.out) + ((size_t)clip * p.t_out + m0) * kC + n0;
    for (int q = ct; q < rows * kUnits; q += Tl::kConsumers) {
      const int r = q / kUnits, u = q - r * kUnits, chunk = u >> 3, unit = u & 7;
      *reinterpret_cast<uint4*>(out + (size_t)r * kC + 8 * u) =
          *reinterpret_cast<const uint4*>(ring + chunk * (Tl::kBM * 128) + r * 128 + ((unit ^ (r & 7)) << 4));
    }
  }
}

// overlap: launch as a programmatic dependent of the previous kernel on the stream (the previous layer), whose
// tail then overlaps this grid's start; its producer waits for it before reading A.
template <typename T, int kWG>
cudaError_t launch_layer(const T* x, int t_in, const T* w, const Layer& p, int B, bool overlap,
                         cudaStream_t stream) {
  using Tl = Tile<T, kWG>;
  constexpr int kBK = Tl::kBK;
  constexpr CUtensorMapDataType kMap = Elem<T>::kMap;
  // A: the clip's frames as pair rows [floor(t_in / 2)][1,024] (taps 0, 1) and as even frames
  // [ceil(t_in / 2)][512] (tap 2), with the clip as the third dimension: every element of either map lies in
  // its clip, so no box reads outside the tensor (TMA zero-fills a box where it leaves a map). W: [n_w (f32: 2
  // n_w, the lo halves after the hi ones)][512][K].
  const cuuint64_t a_strides[2] = {2 * kC * sizeof(T), (cuuint64_t)t_in * kC * sizeof(T)};
  const cuuint32_t a_box[3] = {kBK, Tl::kBM, 1};
  const int K = p.k_slices * kBK;
  CUtensorMap maps[3];
  if (!encode_3d(&maps[0], kMap, x, {kPairCols, (cuuint64_t)(t_in / 2), (cuuint64_t)B}, a_strides, a_box) ||
      !encode_3d(&maps[1], kMap, x, {kC, (cuuint64_t)((t_in + 1) / 2), (cuuint64_t)B}, a_strides, a_box) ||
      !encode_3d(&maps[2], kMap, w, {(cuuint64_t)K, kC, (cuuint64_t)(p.n_w * Elem<T>::kWParts)},
                 {(cuuint64_t)K * sizeof(T), (cuuint64_t)K * kC * sizeof(T)}, {kBK, kBN, 1}))
    return cudaErrorInvalidValue;
  auto kernel = w2v_conv_s2_gelu_wgmma_kernel<T, kWG>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC / kBN, p.m_tiles, B * p.splits);
  cfg.blockDim = dim3(Tl::kThreads);
  cfg.dynamicSmemBytes = Tl::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], p);
}

// The six layers in turn, layer i on the tile of plan[2 i] consumer warpgroups and the plan[2 i + 1] K splits.
template <typename T>
int launch(const T* x, const T* w3, const T* w2, T* buf_a, T* buf_b, T* out, int B, int T0, const int* plan,
           float* partial, long long partial_numel, int* counters, int n_counters, cudaStream_t stream) {
  const int taps[kLayers] = {3, 3, 3, 3, 2, 2};
  T* dst_of[kLayers] = {buf_a, buf_b, buf_a, buf_b, buf_a, out};
  const T* src = x;
  int t_in = T0;
  for (int layer = 0; layer < kLayers; ++layer) {
    const int k = taps[layer], wg = plan[kPlanInts * layer], splits = plan[kPlanInts * layer + 1];
    const int t_out = (t_in - k) / 2 + 1;
    const int bm = 64 * wg, k_slices = k * kC / Elem<T>::kBK;
    if (t_in < k || t_out <= 0 || wg < 1 || splits < 1 || splits > k_slices || B * splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const Layer p{dst_of[layer], partial, counters, t_out, (t_out + bm - 1) / bm, k_slices, splits,
                  layer < 4 ? layer : layer - 4, layer < 4 ? 4 : 2};
    if (p.m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    if (splits > 1) {
      const long long tiles = (long long)B * p.m_tiles * (kC / kBN);
      if (partial == nullptr || counters == nullptr || tiles > n_counters ||
          tiles * splits * bm * kBN > partial_numel)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const T* w = layer < 4 ? w3 : w2;
    cudaError_t err;
    if (wg == 2)
      err = launch_layer<T, 2>(src, t_in, w, p, B, layer > 0, stream);
    else if (wg == 1)
      err = launch_layer<T, 1>(src, t_in, w, p, B, layer > 0, stream);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst_of[layer];
    t_in = t_out;
  }
  return 0;
}

}  // namespace mer_k6
}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x, w3, w2, buf_a, buf_b, out). The weights
// per output channel (stack_tail_weights): bf16 w3 [4, 512, 3 * 512] and w2
// [2, 512, 2 * 512]; f32 w3 [2, 4, 512, 3 * 512] and w2 [2, 2, 512, 2 * 512],
// the TF32 high halves then the low halves (split_tail_weights). buf_a holds
// [B, T_1, 512] and buf_b [B, T_2, 512] values; the six layers alternate
// between them and the last writes out [B, T_6, 512]. plan holds 2 ints a
// layer (consumer warpgroups of the 128-channel tile, 2 or 1; K splits, 1 ..
// the layer's K slices: taps x 8 in bf16, taps x 16 in f32); partial
// (partial_numel floats) and counters (n_counters ints, zero on entry and
// left zero) hold, for the layer that needs most, its tiles = B ceil(T_out /
// (64 wg)) 4 counters and tiles splits 64 wg 128 floats, and may be null
// when no layer splits; every tensor is 16-byte aligned. Returns the
// cudaError_t of the first launch that failed (cudaErrorInvalidValue for
// arguments the kernels do not take), or 0.
extern "C" int mer_w2v_conv_tail(int dtype, const void* x, const void* w3, const void* w2, void* buf_a, void* buf_b,
                                 void* out, int B, int T0, const int* plan, void* partial, long long partial_numel,
                                 void* counters, int n_counters, void* stream) {
  if (B <= 0 || B > 65535 || T0 <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (plan == nullptr || !aligned(x) || !aligned(w3) || !aligned(w2) || !aligned(buf_a) || !aligned(buf_b) ||
      !aligned(out) || !aligned(partial))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  int* count = static_cast<int*>(counters);
  if (dtype == 0)
    return mer_k6::launch(static_cast<const float*>(x), static_cast<const float*>(w3), static_cast<const float*>(w2),
                          static_cast<float*>(buf_a), static_cast<float*>(buf_b), static_cast<float*>(out), B, T0,
                          plan, part, partial_numel, count, n_counters, s);
  using mer_k6::bf16;
  return mer_k6::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
                        static_cast<bf16*>(buf_a), static_cast<bf16*>(buf_b), static_cast<bf16*>(out), B, T0, plan,
                        part, partial_numel, count, n_counters, s);
}
