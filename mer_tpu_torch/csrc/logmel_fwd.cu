// Frames -> log-mel for Hopper (sm_90a), f32: kernel K5 of the port.
//
// Replaces the TPU kernel mer_tpu/ops/logmel_pallas.py:78 (`_kernel`,
// launched from `logmel_frames_pallas` at :106). For frames [B, F, 400] f32:
//
//   re  = frames @ (w * cos),  im = frames @ (w * -sin)    [B, F, 201]
//   mag = sqrt(re^2 + im^2)                                (power 1)
//   out = log(mag @ mel^T + eps)                           [B, F, 128] f32
//
// w is the periodic Hann window, folded into the DFT matrices on the host
// (built in f64, cast to f32, as `dft_matrices`); mel is the L1-normalised
// Slaney filterbank [128, 201]; eps = 2.220446e-16f, the f32 value of the
// f64 epsilon that JAX's weakly typed add uses.
//
// Layout: the frames are read through two strides (clip, frame) with the 400
// taps contiguous, so the `unfold` view of the reflect-padded waveforms
// [B, L + 400] (clip stride L + 400, frame stride hop) feeds the kernel with
// no frames in memory. The DFT operand is [2 passes][400 taps][cos 128 | sin
// 128] (bins pass*128 + j, zero past bin 200); mel [128, 201] dense with each
// band's first and last nonzero bin (band_lo, band_hi). out [B, F, 128].
//
// Design. One block of 256 threads per (clip, tile of 32 frames). The block
// stages its 32 frames in shared memory, transposed to [tap][frame] with a
// padded row (33) so the staging writes hit 32 banks. Two passes of 128 bins
// cover the 201 bins; in each, slices of 16 taps of the cos/sin operand are
// staged in shared memory and every thread accumulates a 4-frame x 4-bin tile
// of re and im (32 FMA chains) in registers: per tap a warp reads its 4 frame
// groups' values (one wavefront, 4 addresses) and 8 bin groups' cos and sin as
// float4 (one wavefront each). The magnitudes go to shared memory and never
// leave the chip. The mel projection then walks each band's nonzero bins only
// (a Slaney triangle feeds each bin into at most two bands): thread m % 128
// takes band m for 16 of the 32 frames, and writes log(mel + eps) coalesced
// across bands.
//
// Bound. At the export batch [32, 1001, 400] the function's bytes (20.5 MB
// of padded waveforms, 16.4 MB out) take about 11 us at 3.35 TB/s. Its least
// work (a real FFT of 400 taps, the magnitude, the mel product over the
// filterbank's 394 nonzeros, the log: about 10.9 kFLOP a frame) takes about
// 5 us at the card's 67 TFLOP/s f32 (non-tensor) peak, so the function is
// bound by bytes. The dense DFT this kernel runs needs 34 times that work,
// 2 * 32 * 1001 * (400 * 402 + 201 * 128) = 11.95 GFLOP, 0.178 ms at the
// f32 peak: the algorithm, not the function, is bound by operations on the
// f32 CUDA cores. It computes 256 bins where 201 are needed (27% more DFT
// products), skips the mel product's zeros, and does not use the tensor
// cores (TF32 or bf16 splits change the values under the quantisation). An
// FFT in the kernel is the way toward the bytes bound; later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 400;                       // n_fft
constexpr int kBins = 201;                       // n_fft / 2 + 1
constexpr int kMels = 128;
constexpr int kPassBins = 128;                   // bins per pass
constexpr int kPasses = 2;                       // 2 x 128 >= 201
constexpr int kTileF = 32;                       // frames per block
constexpr int kThreads = 256;
constexpr int kSliceTaps = 16;                   // taps per staged operand slice
constexpr int kFrameRow = kTileF + 1;            // padded [tap][frame] row
constexpr int kOperandRow = 2 * kPassBins;       // cos | sin
constexpr int kMagRow = kPasses * kPassBins;     // [frame][bin]
constexpr float kEps = 2.220446049250313e-16f;   // float(np.finfo(np.float64).eps) in f32

constexpr int kFramesFloats = kTaps * kFrameRow;           // 13,200
constexpr int kSliceFloats = kSliceTaps * kOperandRow;     // 4,096
constexpr int kMagFloats = kTileF * kMagRow;               // 8,192
constexpr size_t kSmemBytes = sizeof(float) * (kFramesFloats + kSliceFloats + kMagFloats);  // 101,952

static_assert(kTaps % kSliceTaps == 0, "slices must tile the taps");
static_assert(kFramesFloats % 4 == 0 && kSliceFloats % 4 == 0, "float4 alignment of the smem regions");
static_assert(kThreads == (kPassBins / 4) * (kTileF / 4), "one thread per 4x4 tile of a pass");

__global__ void __launch_bounds__(kThreads, 2)
logmel_fwd_kernel(const float* __restrict__ frames, long long clip_stride, long long frame_stride, int F,
                  const float* __restrict__ operand, const float* __restrict__ mel_w,
                  const int* __restrict__ band_lo, const int* __restrict__ band_hi,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* frames_s = reinterpret_cast<float*>(smem4);  // [kTaps][kFrameRow]
  float* slice_s = frames_s + kFramesFloats;           // [kSliceTaps][kOperandRow]
  float* mag_s = slice_s + kSliceFloats;                // [kTileF][kMagRow]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_frames = min(kTileF, F - f0);
  const float* clip = frames + (long long)b * clip_stride;

  // stage the tile's frames transposed; frames past F read as zeros
  for (int idx = tid; idx < kTileF * kTaps; idx += kThreads) {
    const int i = idx / kTaps, n = idx - i * kTaps;
    frames_s[n * kFrameRow + i] = i < n_frames ? clip[(long long)(f0 + i) * frame_stride + n] : 0.f;
  }

  // this thread's tile: bins 4*bg.. of the pass, frames 4*fg..
  const int bg = (lane & 7) + 8 * (warp & 3);
  const int fg = (lane >> 3) + 4 * (warp >> 2);

  for (int pass = 0; pass < kPasses; ++pass) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    const float4* pass_src = reinterpret_cast<const float4*>(operand + (size_t)pass * kTaps * kOperandRow);
    for (int n0 = 0; n0 < kTaps; n0 += kSliceTaps) {
      __syncthreads();  // the previous slice is consumed (the frames staged, the first time)
      const float4* src = pass_src + (size_t)n0 * kOperandRow / 4;
      float4* dst = reinterpret_cast<float4*>(slice_s);
      for (int j = tid; j < kSliceFloats / 4; j += kThreads) dst[j] = __ldg(src + j);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kSliceTaps; ++t) {
        const float* fr = frames_s + (n0 + t) * kFrameRow + 4 * fg;
        const float a[4] = {fr[0], fr[1], fr[2], fr[3]};
        const float4 c4 = reinterpret_cast<const float4*>(slice_s + t * kOperandRow)[bg];
        const float4 s4 = reinterpret_cast<const float4*>(slice_s + t * kOperandRow + kPassBins)[bg];
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], c[j], re[i][j]);
            im[i][j] = fmaf(a[i], s[j], im[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      reinterpret_cast<float4*>(mag_s + (4 * fg + i) * kMagRow + pass * kPassBins)[bg] =
          make_float4(m[0], m[1], m[2], m[3]);
    }
  }
  __syncthreads();

  // mel projection over each band's nonzero bins, then the log
  const int m = tid & (kMels - 1);
  const int lo = band_lo[m], hi = band_hi[m];
  const float* w = mel_w + m * kBins;
  for (int i = tid / kMels; i < n_frames; i += kThreads / kMels) {
    const float* mag = mag_s + i * kMagRow;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(__ldg(w + k), mag[k], acc);
    out[((long long)b * F + f0 + i) * kMels + m] = logf(acc + kEps);
  }
}

}  // namespace

// frames: f32, element (b, f, n) at frames[b * clip_stride + f * frame_stride + n];
// operand [2][400][256], mel_w [128][201] f32; band_lo/band_hi [128] int32;
// out [B, F, 128] f32 contiguous. Returns the cudaError_t of the launch.
extern "C" int mer_logmel_fwd(const void* frames, long long clip_stride, long long frame_stride, int B, int F,
                              int n_taps, int n_bins, int n_mels, const void* operand, const void* mel_w,
                              const void* band_lo, const void* band_hi, void* out, void* stream) {
  if (B <= 0 || B > 65535 || F <= 0 || n_taps != kTaps || n_bins != kBins || n_mels != kMels ||
      clip_stride < 0 || frame_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(logmel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kTileF - 1) / kTileF, B);
  logmel_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), clip_stride, frame_stride, F, static_cast<const float*>(operand),
      static_cast<const float*>(mel_w), static_cast<const int*>(band_lo), static_cast<const int*>(band_hi),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
