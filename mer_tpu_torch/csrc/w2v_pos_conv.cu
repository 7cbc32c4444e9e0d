// wav2vec2's positional convolution for Hopper (sm_90a), bf16: kernel K9 of the
// port. Its forward and its data gradient are one kernel; its weight and bias
// gradient a second.
//
// Replaces no TPU kernel: mer_tpu leaves this conv to XLA (the nn.Conv of
// mer_tpu/models/wav2vec2.py's positional embedding). On the card cuDNN ran
// it, its data gradient through the generic `dgrad_engine` at under 0.1% of the
// bf16 peak, which held most of a fine-tune step's device time (PERF.md §5).
//
// For x [B, T, C] bf16, C / Cg groups of Cg = 48 channels (wav2vec2-base's 16
// groups of 768; other geometries take the stock conv), weights W [C, Cg, 128]
// (out, in, tap), with x zero outside [0, T):
//
//   y[b, t, g Cg + o] = bias[g Cg + o] + sum_{j < 128} sum_{i < Cg} W[g Cg + o, i, j] x[b, t + j - pad, g Cg + i]
//
// for t < T, sums in f32, y rounded to bf16 once. At pad = 64 this is the
// conv with padding 64 whose last output frame (t = T) is dropped. The data
// gradient is the same function of dy at pad = 63 (128 - 1 - 64), with each
// group's weight transposed and its taps reversed, W'[g Cg + i, o, j] =
// W[g Cg + o, i, 127 - j], and no bias (dy of the dropped frame is zero). The
// weight and bias gradient, in f32:
//
//   dW[g Cg + o, i, j] = sum_{b, t < T} dy[b, t, g Cg + o] x[b, t + j - pad, g Cg + i]
//   db[c]              = sum_{b, t < T} dy[b, t, c]
//
// Layout: x, dy, y [B, T, C] channels last, as the encoder keeps its hidden
// states; each group's Cg channels of a frame are Cg / 8 16-byte chunks.
// Weights for the forward kernel as `taps` [C / Cg][128][Cg / 8][Cg][8] bf16:
// per group and tap the Cg x Cg matrix B[n = out][k = in] in the operand
// layout below, made once per call by ops/pos_conv.py (forward_taps for the
// forward, of the transposed, reversed weight for the data gradient); dW
// [C, Cg, 128] f32, db [C] f32.
//
// Forward and data gradient (one kernel, grid (T / BM, C / Cg, B)): an
// implicit GEMM per block of BM = 128 frames of one clip and one group,
// out [BM, Cg] = sum over 128 taps j of X_j [BM, Cg] @ W_j^T, X_j the frames
// t0 + j - pad .., so that K = 128 Cg.
// - A producer warp loads the block's window once, frames t0 - pad .. t0 - pad
//   + BM + 127, Cg channels, by TMA from a [B][T][C] tensor map whose boxes
//   are 8 channels (16 bytes) x 128 frames, unswizzled; frames outside the
//   clip read as zeros, which is the conv's padding. It then streams the
//   group's 128 tap matrices through a 4-stage mbarrier ring, 4 taps a stage,
//   each stage one bulk copy of the prepared `taps`.
// - Two consumer warpgroups of 64 frames run wgmma m64n48k16 (bf16 in, f32
//   sums), Cg / 16 = 3 products a tap. Both operands are read
//   from shared memory through descriptors of the interleaved (unswizzled)
//   layout: core matrices of 8 rows x 16 bytes, each 128 contiguous bytes. A
//   window chunk holds its frames as consecutive 16-byte rows, so the A tile of
//   tap j starts j rows (16 j bytes) after tap 0's: the descriptor takes any
//   16-byte aligned start, and no shifted copy of A is made.
// - Epilogue: the bias (bf16 values) added in f32, one rounding, 4-byte
//   stores of the rows t < T.
//
// Weight and bias gradient (grid (128 / 8, C / Cg)): a block owns one group
// and 8 taps, 4 a consumer warpgroup, and walks over every clip's frames in
// items of 128: per item the window (frames f0 - pad .. f0 - pad + 255) and
// the dy tile (frames f0 ..) arrive by TMA in a 3-stage ring, and per 16
// frames each warpgroup runs one wgmma m64n48k16 a tap with both operands
// MN-major: A = dy^T (64 channel rows: the last 16 read unfilled shared
// memory and are never stored), B = the window shifted by the
// tap. 256 blocks fill the card's 132 SMs in two waves, so K (the frames) is
// not split and each dW value is one block's sum: no partials, no atomics,
// the same bits from call to call. The producer warp of each group's first
// block also sums dy's rows into db as the items pass.
//
// Bound. At [16, 499, 768] each of the three is 2 x 16 x 499 x 768 x
// 48 x 128 = 75.3 GFLOP, 76 us at the 989 TFLOP/s of the bf16 tensor cores,
// against 12-25 MB of activations (under 8 us at 3.35 TB/s): bound by
// operations. What holds them below it: each m64n48k16 product reads 3.5 KB
// of shared memory for 98 kFLOP (the SM's shared memory gives 128 bytes a
// clock, its tensor cores about 4 kFLOP), the weight stream from L2 (each
// forward block reads its group's 590 KB of taps for BM frames), and the
// padding to 64-row tiles (frames past T; a third more work in the weight
// gradient's A).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {
namespace mer_k9 {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTaps = 128;
constexpr int kCg = 48;                   // channels a group
constexpr int kChunks = kCg / 8;          // 16-byte chunks of a group's channels
constexpr int kBoxRows = 128;             // frames of a TMA box (a box dimension is at most 256)
constexpr int kWG = 2;                    // consumer warpgroups a block
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSmemPerSM = 232448;        // shared memory an SM gives its blocks, 1 KB of each block's reserved

// descriptor of an operand in the interleaved layout (no swizzle): core matrices of 8 rows x 16 bytes, 128
// contiguous bytes each, `lbo` bytes apart along the reduction and `sbo` bytes apart along M or N. Its start needs
// only 16-byte alignment. Offsets add to it in 16-byte units.
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d[64 x 48] += A[64 x 16] B[16 x 48] (bf16 in, f32 sums), both operands in shared memory, each K-major (0) or
// MN-major (1); d's layout as sm90's wgmma_ss, the column groups j running to 5.
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma(float (&d)[kCg / 2], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128u - (smem_u32(p) & 127u)) & 127u);
}

// -- forward and data gradient --------------------------------------------------------

struct Conv {
  static constexpr int kBM = 64 * kWG;  // frames a block: a 64-frame tile a consumer warpgroup
  static constexpr int kWinRows = kBM + kBoxRows;  // the BM + 127 frames of the window, in whole boxes
  static constexpr uint32_t kChunkBytes = kWinRows * 16;
  static constexpr uint32_t kWinBytes = kChunks * kChunkBytes;
  static constexpr uint32_t kTapBytes = kCg * kCg * 2;
  static constexpr int kTapsPerStage = 4;
  static constexpr uint32_t kStageBytes = kTapsPerStage * kTapBytes;
  static constexpr int kStages = 4;
  static constexpr int kIters = kTaps / kTapsPerStage;
  static constexpr int kSmem = 128 + kWinBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static constexpr int kBlocksPerSM = 2;  // 99 KB of shared memory a block
  static_assert(kBlocksPerSM * (kSmem + 1024) <= kSmemPerSM, "two forward blocks an SM");
};

// grid (ceil(T / BM), C / Cg, B): block (m, g, b) computes frames m BM .. of clip b, group g.
__global__ void __launch_bounds__(kThreads, Conv::kBlocksPerSM)
    pos_conv_kernel(const __grid_constant__ CUtensorMap map_x, const bf16* __restrict__ taps,
                    const bf16* __restrict__ bias, bf16* __restrict__ out, int T, int C, int pad) {
  using P = Conv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* win = align128(smem_raw);  // [chunk][window row][16 B]
  unsigned char* ring = win + P::kWinBytes;  // [stage][tap][chunk][Cg][16 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::kStages * P::kStageBytes);
  uint64_t* empty = full + P::kStages;
  uint64_t* win_full = empty + P::kStages;
  const int t0 = blockIdx.x * P::kBM, g = blockIdx.y, b = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // one arrival per consumer warp
    }
    mbar_init(win_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane starts every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(win_full, P::kWinBytes);
      for (int c = 0; c < kChunks; ++c)
        for (int r = 0; r < P::kWinRows; r += kBoxRows)
          tma_load_3d(win + c * P::kChunkBytes + r * 16, &map_x, win_full, g * kCg + 8 * c, t0 - pad + r, b);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(taps) + (size_t)g * kTaps * P::kTapBytes;
      for (int i = 0; i < P::kIters; ++i) {
        const int s = i % P::kStages;
        if (i >= P::kStages) mbar_wait(&empty[s], ((i / P::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::kStageBytes);
        bulk_load(ring + s * P::kStageBytes, src + (size_t)i * P::kStageBytes, P::kStageBytes, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = wg * 64;  // this warpgroup's first frame in the block
  float acc[kCg / 2];
#pragma unroll
  for (int v = 0; v < kCg / 2; ++v) acc[v] = 0.f;
  // A: window rows at 16 bytes, chunks kChunkBytes apart; B: a tap's n rows at 16 bytes, chunks Cg 16 bytes apart
  const uint64_t da = desc_plain(win + row0 * 16, P::kChunkBytes, 128);
  const uint64_t db = desc_plain(ring, kCg * 16, 128);
  mbar_wait(win_full, 0);
  for (int i = 0; i < P::kIters; ++i) {
    const int s = i % P::kStages;
    mbar_wait(&full[s], (i / P::kStages) & 1);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < P::kTapsPerStage; ++jj) {
      const int j = i * P::kTapsPerStage + jj;
#pragma unroll
      for (int kk = 0; kk < kCg / 16; ++kk)
        mma<0, 0>(acc, da + ((2 * kk * P::kChunkBytes + j * 16) >> 4),
                  db + ((s * P::kStageBytes + jj * P::kTapBytes + 2 * kk * kCg * 16) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: it goes back to the producer
    fence_operands(acc);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % P::kStages]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // d[4 jn + 2 h + c] of thread (warp, lane 4 gq + tq): row 16 warp + gq + 8 h, column 8 jn + 2 tq + c
  const int gq = lane >> 2, tq = lane & 3;
  float bv[kCg / 8][2];
#pragma unroll
  for (int jn = 0; jn < kCg / 8; ++jn)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      bv[jn][c] = bias == nullptr ? 0.f : __bfloat162float(bias[g * kCg + 8 * jn + 2 * tq + c]);
  bf16* dst = out + (size_t)b * T * C + g * kCg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + row0 + 16 * warp + gq + 8 * h;
    if (t >= T) continue;
    bf16* row = dst + (size_t)t * C;
#pragma unroll
    for (int jn = 0; jn < kCg / 8; ++jn)
      *reinterpret_cast<uint32_t*>(row + 8 * jn + 2 * tq) =
          pack_bf16(acc[4 * jn + 2 * h] + bv[jn][0], acc[4 * jn + 2 * h + 1] + bv[jn][1]);
  }
}

// x [B, T, C] bf16 as boxes of 8 channels (16 bytes) x kBoxRows frames of one clip, unswizzled: a box lands as
// kBoxRows consecutive 16-byte rows, the interleaved layout's core matrices; frames outside [0, T) read as zeros.
inline bool encode_chunks(CUtensorMap* map, const void* x, int B, int T, int C) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t box[3] = {8, kBoxRows, 1}, elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_conv(const bf16* x, const bf16* taps, const bf16* bias, bf16* out, int B, int T, int C, int pad,
                        cudaStream_t stream) {
  using P = Conv;
  CUtensorMap map;
  if (!encode_chunks(&map, x, B, T, C)) return cudaErrorInvalidValue;
  auto kernel = pos_conv_kernel;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((T + P::kBM - 1) / P::kBM, C / kCg, B), kThreads, P::kSmem, stream>>>(map, taps, bias, out, T, C,
                                                                                       pad);
  return cudaGetLastError();
}

// -- weight and bias gradient -------------------------------------------------------------

struct Wgrad {
  static constexpr int kTapsWG = 4;  // taps a consumer warpgroup
  static constexpr int kTapsBlock = kTapsWG * kWG;
  static constexpr int kF = 128;  // frames an item
  static constexpr int kWinRows = kF + kBoxRows;  // the item's frames and the 127 after, in whole boxes
  static constexpr uint32_t kWinChunkBytes = kWinRows * 16;
  static constexpr uint32_t kWinBytes = kChunks * kWinChunkBytes;
  static constexpr uint32_t kDyChunkBytes = kF * 16;
  static constexpr uint32_t kDyBytes = 8 * kDyChunkBytes;  // 64 channel rows of A, Cg of them loaded
  static constexpr uint32_t kStageBytes = kWinBytes + kDyBytes;
  static constexpr uint32_t kLoadBytes = kWinBytes + kChunks * kDyChunkBytes;
  static constexpr int kStages = 3;
  static constexpr int kSmem = 128 + kStages * kStageBytes + 2 * kStages * 8;
};

// grid (128 / 8, C / Cg): block (tb, g) computes dW of group g, taps 8 tb .. 8 tb + 7, over every clip's frames;
// db of group g in block (0, g) when db is not null.
__global__ void __launch_bounds__(kThreads, 1)
    pos_conv_wgrad_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_dy,
                          float* __restrict__ dw, float* __restrict__ db, int B, int T, int pad) {
  using P = Wgrad;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align128(smem_raw);  // [stage]: window [chunk][256 rows][16 B], dy [8 chunks][128][16 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + P::kStages * P::kStageBytes);
  uint64_t* empty = full + P::kStages;
  const int tb = blockIdx.x, g = blockIdx.y;
  const int tiles = (T + P::kF - 1) / P::kF, items = B * tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: lane 0 starts the copies; all lanes sum db
    const int lane = threadIdx.x & 31;
    const bool sums_db = tb == 0 && db != nullptr;
    const int c = lane % kChunks, q = lane / kChunks;  // db: chunk c, rows q, q + 4, ... of each item
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = 0.f;
    for (int it = 0; it <= items; ++it) {
      if (it < items && lane == 0) {
        const int s = it % P::kStages, clip = it / tiles, f0 = (it - clip * tiles) * P::kF;
        if (it >= P::kStages) mbar_wait(&empty[s], ((it / P::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], P::kLoadBytes);
        unsigned char* st = ring + s * P::kStageBytes;
        for (int cc = 0; cc < kChunks; ++cc) {
          for (int r = 0; r < P::kWinRows; r += kBoxRows)
            tma_load_3d(st + cc * P::kWinChunkBytes + r * 16, &map_x, &full[s], g * kCg + 8 * cc, f0 - pad + r,
                        clip);
          tma_load_3d(st + P::kWinBytes + cc * P::kDyChunkBytes, &map_dy, &full[s], g * kCg + 8 * cc, f0, clip);
        }
      }
      __syncwarp();
      if (sums_db && it > 0) {  // item it - 1's dy rows (frames past T read as zeros); its stage is refilled later
        const int prev = it - 1, s = prev % P::kStages;
        mbar_wait(&full[s], (prev / P::kStages) & 1);
        if (q < 4) {
          const unsigned char* rows = ring + s * P::kStageBytes + P::kWinBytes + c * P::kDyChunkBytes;
          for (int r = q; r < P::kF; r += 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(rows + r * 16);
            const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(e2[e]);
              sum[2 * e] += f.x;
              sum[2 * e + 1] += f.y;
            }
          }
        }
      }
    }
    if (sums_db) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float total = 0.f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) total += __shfl_sync(0xffffffffu, sum[e], c + kChunks * qq);
        if (q == 0) db[g * kCg + 8 * c + e] = total;
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int j0 = tb * P::kTapsBlock + wg * P::kTapsWG;  // this warpgroup's first tap
  float acc[P::kTapsWG][kCg / 2];
#pragma unroll
  for (int jj = 0; jj < P::kTapsWG; ++jj)
#pragma unroll
    for (int v = 0; v < kCg / 2; ++v) acc[jj][v] = 0.f;
  // both MN-major: 8 frames (the reduction) are one core matrix, 128 bytes; channel chunks a chunk's bytes apart
  const uint64_t da = desc_plain(ring + P::kWinBytes, 128, P::kDyChunkBytes);
  const uint64_t dbw = desc_plain(ring + j0 * 16, 128, P::kWinChunkBytes);
  for (int it = 0; it < items; ++it) {
    const int s = it % P::kStages;
    mbar_wait(&full[s], (it / P::kStages) & 1);
    const uint32_t stage = (s * P::kStageBytes) >> 4;
#pragma unroll
    for (int jj = 0; jj < P::kTapsWG; ++jj) fence_operands(acc[jj]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < P::kF / 16; ++ks)
#pragma unroll
      for (int jj = 0; jj < P::kTapsWG; ++jj)
        mma<1, 1>(acc[jj], da + stage + 16 * ks, dbw + stage + 16 * ks + jj);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int jj = 0; jj < P::kTapsWG; ++jj) fence_operands(acc[jj]);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % P::kStages]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int jj = 0; jj < P::kTapsWG; ++jj) fence_operands(acc[jj]);

  // d[4 jn + 2 h + c]: out channel o = 16 warp + gq + 8 h, in channel i = 8 jn + 2 tq + c; dW[g Cg + o, i, j]
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = 16 * warp + gq + 8 * h;
    if (o >= kCg) continue;
    float* dst = dw + (size_t)(g * kCg + o) * kCg * kTaps + j0;
#pragma unroll
    for (int jj = 0; jj < P::kTapsWG; ++jj)
#pragma unroll
      for (int jn = 0; jn < kCg / 8; ++jn)
#pragma unroll
        for (int c = 0; c < 2; ++c) dst[(size_t)(8 * jn + 2 * tq + c) * kTaps + jj] = acc[jj][4 * jn + 2 * h + c];
  }
}

cudaError_t launch_wgrad(const bf16* x, const bf16* dy, float* dw, float* db, int B, int T, int C, int pad,
                         cudaStream_t stream) {
  using P = Wgrad;
  CUtensorMap maps[2];
  if (!encode_chunks(&maps[0], x, B, T, C) || !encode_chunks(&maps[1], dy, B, T, C)) return cudaErrorInvalidValue;
  auto kernel = pos_conv_wgrad_kernel;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kTaps / P::kTapsBlock, C / kCg), kThreads, P::kSmem, stream>>>(maps[0], maps[1], dw, db, B, T, pad);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool geometry_ok(int B, int T, int C, int pad) {
  return B > 0 && B <= 65535 && T > 0 && C > 0 && C % kCg == 0 && C / kCg <= 65535 && pad >= 0 && pad < kTaps &&
         (long long)T * C * 2 < (1ll << 40);
}

}  // namespace mer_k9
}  // namespace

// The forward (pad 64, bias [C] bf16) or the data gradient (x = dy, pad 63, bias null): x and out [B, T, C] bf16,
// C / 48 groups of 48 channels, taps [C / 48][128][6][48][8] bf16 (ops/pos_conv.py::forward_taps). x, taps and out
// 16-byte aligned. Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments the kernel does not take),
// or 0.
extern "C" int mer_w2v_pos_conv(const void* x, const void* taps, const void* bias, void* out, int B, int T, int C,
                                int pad, void* stream) {
  using namespace mer_k9;
  if (!geometry_ok(B, T, C, pad) || !aligned16(x) || !aligned16(taps) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_conv(static_cast<const bf16*>(x), static_cast<const bf16*>(taps),
                                      static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, T, C, pad,
                                      static_cast<cudaStream_t>(stream)));
}

// The weight gradient dw [C, 48, 128] f32 and, unless db is null, the bias gradient db [C] f32 of the forward at
// pad: x and dy [B, T, C] bf16, 16-byte aligned. Returns the launch's cudaError_t, or 0.
extern "C" int mer_w2v_pos_conv_wgrad(const void* x, const void* dy, void* dw, void* db, int B, int T, int C, int pad,
                                      void* stream) {
  using namespace mer_k9;
  if (!geometry_ok(B, T, C, pad) || !aligned16(x) || !aligned16(dy) || dw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wgrad(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                                       static_cast<float*>(dw), static_cast<float*>(db), B, T, C, pad,
                                       static_cast<cudaStream_t>(stream)));
}
