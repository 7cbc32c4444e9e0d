// Frames -> log-mel for Hopper (sm_90a): kernel K5 of the port, f32 in and
// out, float64 arithmetic inside.
//
// Replaces the TPU kernel mer_tpu/ops/logmel_pallas.py:78 (`_kernel`,
// launched from `logmel_frames_pallas` at :106). For frames [B, F, 400] f32:
//
//   X   = rfft(w * frame)                                  201 bins
//   mag = |X|                                              (power 1)
//   out = log(mag @ mel^T + eps)                           [B, F, 128] f32
//
// w is the periodic Hann window; mel is the L1-normalised Slaney filterbank
// [128, 201]; eps = 2^-52, the f64 epsilon that JAX's weakly typed add uses
// (exact in f32 as well).
//
// Layout: the frames are read through two strides (clip, frame) with the 400
// taps contiguous, so the `unfold` view of the reflect-padded waveforms
// [B, L + 400] (clip stride L + 400, frame stride hop) feeds the kernel with
// no frames in memory. Host tables, float64: the window [400], W200^m =
// exp(-2 pi i m / 200) [200][re, im] for the FFT's twiddles and butterfly
// constants, W400^k [201][re, im] for the real unpack; and, f32, each mel
// band's 9 filterbank weights from its first bin (band_start; a Slaney
// triangle spans at most 9 of the 201 bins here). No sincos in the kernel.
// out [B, F, 128].
//
// Precision. The samples are f32 and so is the output, rounded once from the
// float64 log. An f32 FFT is within about 7e-7 of each frame's largest band
// of a float64 chain, but the mel training quantises the per-clip min/max
// normalised log-mel to a uint8 cache, and rounding at that level moves about
// 1 in 10,000 cache entries by one step (an f32 FFT's and the dense f32
// DFT's caches part in 6,044 of 56,888,832 on the synthetic MELD train
// split); three Adam steps from two such caches part by 2.6e-3 in the loss.
// In float64 the cache is the float64 chain's, entry for entry. The function
// is bound by bytes, and the H100's float64 rate (34 TFLOP/s outside the
// tensor cores) still does its least work in under the bytes' time.
//
// Design. One block of 256 threads per (clip, tile of 16 frames).
// 1. Staging: the tile's f32 samples go to shared memory once, with 16-byte
//    loads where the address allows. A frame stride of at most 400 stages the
//    contiguous span of (n - 1) * stride + 400 samples, so the overlapping
//    frames of a tile read each sample once; a larger stride stages the
//    frames row by row. A word is stored at a + a / 32 (one pad word every
//    32), so the 16 frames read at one tap hit 16 banks at hop 160.
// 2. The real 400-point DFT as a complex 200-point FFT: z[m] = w x[2m] +
//    i w x[2m+1], the window applied as the samples are read. A Stockham
//    FFT of radices 8, 5, 5 (natural order in, natural order out) through
//    two [16 frames][201] complex float64 buffers in shared memory; the
//    second aliases the staging buffer, whose samples are dead by then.
//    Thread t takes frame t % 16 and the butterflies t / 16, t / 16 + 16,
//    ..., so the 8 lanes of a 16-byte access phase read one butterfly slot
//    of 8 frames at a row pitch of 201 complex values: 8 distinct 16-byte
//    bank groups, no conflict.
// 3. Unpack: X[k] = E + W400^k O with E = (Z[k] + conj Z[200 - k]) / 2,
//    O = -i (Z[k] - conj Z[200 - k]) / 2, and X[200 - k] = conj(E - W400^k O)
//    from the same two loads, k = 0..100; the magnitudes stay in shared
//    memory and never leave the chip.
// 4. The mel product: a thread takes one band for 8 frames, its 9 weights in
//    registers, 9 independent reads of the magnitudes a frame, then the log,
//    written coalesced across bands. No atomics; the same bits from run to
//    run; silent frames give log(eps) rounded to f32.
//
// Bound. At the export batch [32, 1001, 400] in the unfold layout the
// function's bytes (20.5 MB of padded waveforms, 16.4 MB out) take about
// 11.8 us at 3.35 TB/s. Its least work (the window, a real FFT of 400 taps,
// the magnitude, the mel product over the filterbank's 394 nonzeros, the log:
// about 10.9 kFLOP a frame) takes about 5 us at the card's 67 TFLOP/s f32
// (non-tensor) peak, about 10 us at its float64 rate, so the function is
// bound by bytes. This kernel reads each sample once per tile (neighbouring
// tiles at hop 160 share 240 of their 2,800) and writes each output byte
// once; its arithmetic (radix-8 and radix-5 butterflies, the unpack, the mel
// product over the nonzeros) is about that least work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 400;                       // n_fft
constexpr int kHalf = kTaps / 2;                 // complex FFT points
constexpr int kBins = kHalf + 1;                 // 201
constexpr int kMels = 128;
constexpr int kBandWidth = 9;                    // bins a mel band spans, at most (the Slaney bank at 400 taps)
constexpr int kTileF = 16;                       // frames per block
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileF;       // butterfly groups: a thread is (frame, group)
constexpr int kRow = kBins;                      // complex values per frame row (odd pitch: no conflicts)
constexpr double kEps = 2.220446049250313e-16;   // np.finfo(np.float64).eps = 2^-52

constexpr int kStageFloats = kTileF * kTaps + kTileF * kTaps / 32;   // 6,600: padded staging
constexpr size_t kBufferBytes = sizeof(double2) * kTileF * kRow;    // 51,456: one complex buffer
constexpr size_t kSmemBytes = 2 * kBufferBytes;                     // 102,912

static_assert(sizeof(float) * kStageFloats <= kBufferBytes, "the staging buffer fits under buffer B");
static_assert(kBufferBytes % 16 == 0, "buffer A starts 16-byte aligned");
static_assert(kThreads == 2 * kMels, "the mel stage: two frames at a time, a thread a band");

__device__ __forceinline__ int padded(int a) { return a + (a >> 5); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 mul_neg_i(double2 a) { return make_double2(a.y, -a.x); }  // -i a

// 4-point DFT in place, natural order
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2, double2& a3) {
  const double2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3), t3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// 8-point DFT in place, natural order; c = cos(pi / 4)
__device__ __forceinline__ void dft8(double2 (&v)[8], double c) {
  dft4(v[0], v[2], v[4], v[6]);  // E0..E3
  dft4(v[1], v[3], v[5], v[7]);  // O0..O3
  const double2 o1 = make_double2(c * (v[3].x + v[3].y), c * (v[3].y - v[3].x));   // W8^1 O1
  const double2 o2 = mul_neg_i(v[5]);                                                // W8^2 O2
  const double2 o3 = make_double2(c * (v[7].y - v[7].x), -c * (v[7].x + v[7].y));  // W8^3 O3
  const double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// 5-point DFT in place, natural order; c1, s1 = cos, sin(2 pi / 5), c2, s2 = cos, sin(4 pi / 5)
__device__ __forceinline__ void dft5(double2 (&v)[5], double c1, double s1, double c2, double s2) {
  const double2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]), a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
  const double2 p1 = make_double2(v[0].x + c1 * a1.x + c2 * a2.x, v[0].y + c1 * a1.y + c2 * a2.y);
  const double2 p2 = make_double2(v[0].x + c2 * a1.x + c1 * a2.x, v[0].y + c2 * a1.y + c1 * a2.y);
  const double2 q1 = make_double2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y);
  const double2 q2 = make_double2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y);
  v[0] = cadd(v[0], cadd(a1, a2));
  v[1] = make_double2(p1.x + q1.y, p1.y - q1.x);  // p1 - i q1
  v[4] = make_double2(p1.x - q1.y, p1.y + q1.x);  // p1 + i q1
  v[2] = make_double2(p2.x + q2.y, p2.y - q2.x);
  v[3] = make_double2(p2.x - q2.y, p2.y + q2.x);
}

// `runs` runs of `width` floats, run r at src + r * src_pitch, to the logical
// staging positions r * dst_pitch + [0, width)
__device__ __forceinline__ void stage(const float* __restrict__ src, int runs, int width, long long src_pitch,
                                      int dst_pitch, float* __restrict__ dst) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (runs == 1 || (src_pitch & 3) == 0);
  const int w4 = vec ? width / 4 : 0, tail = width - 4 * w4;
  for (int idx = threadIdx.x; idx < runs * w4; idx += kThreads) {
    const int r = idx / w4, q = idx - r * w4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * src_pitch) + q);
    const int a = r * dst_pitch + 4 * q;  // a multiple of 4: the four words share one padded run of 32
    float* d = dst + padded(a);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int idx = threadIdx.x; idx < runs * tail; idx += kThreads) {
    const int r = idx / tail, n = 4 * w4 + (idx - r * tail);
    dst[padded(r * dst_pitch + n)] = __ldg(src + r * src_pitch + n);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
logmel_fwd_kernel(const float* __restrict__ frames, long long clip_stride, long long frame_stride, int F,
                  const double* __restrict__ window, const double2* __restrict__ w200,
                  const double2* __restrict__ w400, const float* __restrict__ band_w,
                  const int* __restrict__ band_start, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);        // staging, then buffer B, then the magnitudes
  double2* buf_b = reinterpret_cast<double2*>(smem4);     // [kTileF][kRow]
  double2* buf_a = reinterpret_cast<double2*>(reinterpret_cast<char*>(smem4) + kBufferBytes);  // [kTileF][kRow]
  double* mag_s = reinterpret_cast<double*>(smem4);        // [kTileF][kBins]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const int tid = threadIdx.x;
  const int n_frames = min(kTileF, F - f0);
  const float* src = frames + (long long)b * clip_stride + (long long)f0 * frame_stride;

  // 1. stage the tile's samples once
  const bool span = frame_stride <= kTaps;
  const int pitch = span ? (int)frame_stride : kTaps;  // logical staging position of frame i: i * pitch
  if (span)
    stage(src, 1, (n_frames - 1) * pitch + kTaps, 0, 0, region);
  else
    stage(src, n_frames, kTaps, frame_stride, kTaps, region);

  const double2 t25 = __ldg(w200 + 25), t40 = __ldg(w200 + 40), t80 = __ldg(w200 + 80);
  const double c8 = t25.x, c1 = t40.x, s1 = -t40.y, c2 = t80.x, s2 = -t80.y;
  const int i = tid % kTileF, g = tid / kTileF;  // this thread's frame and butterfly group
  const bool live = i < n_frames;
  double2* row_a = buf_a + i * kRow;
  double2* row_b = buf_b + i * kRow;
  __syncthreads();

  // 2a. radix 8 (Ns = 1), staging -> A: z[m] = w x[2m] + i w x[2m+1], butterfly j reads m = j + 25 r
  for (int j = g; j < kHalf / 8; j += kGroups) {
    double2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = j + r * (kHalf / 8), a = i * pitch + 2 * m;
      const double2 w = __ldg(reinterpret_cast<const double2*>(window) + m);
      v[r] = live ? make_double2(w.x * region[padded(a)], w.y * region[padded(a + 1)]) : make_double2(0.0, 0.0);
    }
    dft8(v, c8);
#pragma unroll
    for (int r = 0; r < 8; ++r) row_a[8 * j + r] = v[r];
  }
  __syncthreads();

  // 2b. radix 5 (Ns = 8), A -> B: twiddle W40^(k r) = W200^(5 k r), k = j % 8
  for (int j = g; j < kHalf / 5; j += kGroups) {
    const int k = j % 8;
    double2 v[5];
    v[0] = row_a[j];
#pragma unroll
    for (int r = 1; r < 5; ++r) v[r] = cmul(row_a[j + r * (kHalf / 5)], __ldg(w200 + 5 * k * r));
    dft5(v, c1, s1, c2, s2);
    const int base = (j / 8) * 40 + k;
#pragma unroll
    for (int r = 0; r < 5; ++r) row_b[base + 8 * r] = v[r];
  }
  __syncthreads();

  // 2c. radix 5 (Ns = 40), B -> A: twiddle W200^(k r), k = j
  for (int j = g; j < kHalf / 5; j += kGroups) {
    double2 v[5];
    v[0] = row_b[j];
#pragma unroll
    for (int r = 1; r < 5; ++r) v[r] = cmul(row_b[j + r * (kHalf / 5)], __ldg(w200 + j * r));
    dft5(v, c1, s1, c2, s2);
#pragma unroll
    for (int r = 0; r < 5; ++r) row_a[j + 40 * r] = v[r];
  }
  __syncthreads();

  // 3. unpack the real spectrum and its magnitude (over B, dead now), bins k and 200 - k from one pair of
  // loads: X[k] = E + W400^k O and X[200 - k] = conj(E - W400^k O), k = 0..100
  for (int k = g; k <= kHalf / 2; k += kGroups) {
    const double2 zk = row_a[k];
    const double2 zr = row_a[k == 0 ? 0 : kHalf - k];
    const double2 zc = make_double2(zr.x, -zr.y);
    const double2 e = make_double2(0.5 * (zk.x + zc.x), 0.5 * (zk.y + zc.y));
    const double2 o = mul_neg_i(make_double2(0.5 * (zk.x - zc.x), 0.5 * (zk.y - zc.y)));
    const double2 wo = cmul(__ldg(w400 + k), o);
    const double2 x = cadd(e, wo), x_mirror = csub(e, wo);  // X[k], conj X[200 - k]
    mag_s[i * kBins + k] = sqrt(x.x * x.x + x.y * x.y);
    mag_s[i * kBins + kHalf - k] = sqrt(x_mirror.x * x_mirror.x + x_mirror.y * x_mirror.y);
  }
  __syncthreads();

  // 4. mel projection: band m's kBandWidth weights from bin band_start[m] on, held in registers (zeros
  // outside its triangle add exact zeros), then the log
  const int m = tid % kMels;
  const double* mag_m = mag_s + band_start[m];
  double wm[kBandWidth];
#pragma unroll
  for (int q = 0; q < kBandWidth; ++q) wm[q] = __ldg(band_w + m * kBandWidth + q);
  for (int f = tid / kMels; f < n_frames; f += kThreads / kMels) {
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < kBandWidth; ++q) acc = fma(wm[q], mag_m[f * kBins + q], acc);
    out[((long long)b * F + f0 + f) * kMels + m] = static_cast<float>(log(acc + kEps));
  }
}

}  // namespace

// frames: f32, element (b, f, n) at frames[b * clip_stride + f * frame_stride + n];
// window [400], w200 [200][2], w400 [201][2] float64, band_w [128][band_width] f32 (band m's filterbank row
// from bin band_start[m] on), band_start [128] int32 (at most 201 - band_width); out [B, F, 128] f32
// contiguous. Returns the cudaError_t of the launch.
extern "C" int mer_logmel_fwd(const void* frames, long long clip_stride, long long frame_stride, int B, int F,
                              int n_taps, int n_bins, int n_mels, int band_width, const void* window,
                              const void* w200, const void* w400, const void* band_w, const void* band_start,
                              void* out, void* stream) {
  if (B <= 0 || B > 65535 || F <= 0 || n_taps != kTaps || n_bins != kBins || n_mels != kMels ||
      band_width != kBandWidth || clip_stride < 0 || frame_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(logmel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kTileF - 1) / kTileF, B);
  logmel_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), clip_stride, frame_stride, F, static_cast<const double*>(window),
      static_cast<const double2*>(w200), static_cast<const double2*>(w400), static_cast<const float*>(band_w),
      static_cast<const int*>(band_start), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
