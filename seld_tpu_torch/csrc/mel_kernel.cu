// K1: STFT frames -> log-mel dB in one pass, for Hopper (sm_90a).
//
// Replaces seld_tpu/ops/mel_pallas.py::log_mel_frames_pallas (body
// `_kernel`). For every frame it computes
//
//   re  = frame @ C_re        (Hann-windowed DFT, real part)
//   im  = frame @ C_im        (imaginary part)
//   mel = (re^2 + im^2) @ FB  (power spectrum onto the mel filterbank)
//   out = 10 * log10(max(mel, amin))
//
// with C_re/C_im of shape (n_fft, n_bins) (481 bins zero-padded to 512)
// and FB of shape (n_bins, 64) (n_mels zero-padded to 64). Like the TPU
// kernel it never writes the (N, 512) power spectrum to device memory.
//
// What bounds it on an H100. The function itself: per frame it reads
// n_fft floats and writes n_mels, N*(960+64)*4 bytes, and needs about
// 28 kFLOP if the DFT is an FFT (2.5*960*log2(960)) and the filterbank
// product skips its zeros -- some 7 FLOP per byte, under the card's f32
// balance point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B), so its floor is
// the bytes at 3.35 TB/s. This kernel's own arithmetic: the DFT as GEMMs,
// 2*960*1024 + 2*512*64 = 2.03 MFLOP per frame over the padded bins (1.91
// MFLOP at the 481 real ones), about 500 FLOP per byte: in this form it
// is compute-bound in f32, so the design keeps the arithmetic in
// registers and shared memory and reads the frames and DFT bases through
// L2 only:
//
//   * a block owns 64 frames and loops over 64-bin chunks of the spectrum;
//   * per chunk it runs a 64x(64+64) x 960 product over 16-deep shared
//     memory tiles of the frames and of C_re/C_im, each thread holding a
//     4-frame x 4-bin tile of re and of im in registers;
//   * it squares and adds them, stages the 64x64 power tile and the
//     matching 64x64 slice of FB in shared memory, and adds the chunk's
//     contribution to the block's 64x64 mel sums, which stay in registers
//     (4 frames x 4 mels per thread) across all chunks;
//   * the epilogue writes 10*log10(max(mel, amin)) for the valid frames.
//
// The arithmetic is plain f32 FMA on the CUDA cores. Tensor cores
// (3xTF32 through wgmma) and TMA loads are the way to the next factor.
//
// C interface (bound with ctypes): seld_log_mel_frames(...) launches on
// the given stream and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFrames = 64;            // frames per block
constexpr int kTileBins = 64;              // spectrum bins per chunk
constexpr int kTileDepth = 16;             // DFT depth per shared-memory stage
constexpr int kMels = 64;                  // filterbank width (n_mels padded)
constexpr int kPitch = kTileFrames + 4;    // padded row of frame-indexed tiles

static_assert(kThreads == 4 * kTileFrames, "frame tile load: one float4 each");
static_assert(kThreads * 4 == kTileDepth * kTileBins, "DFT tile load: one float4 each");

__global__ void __launch_bounds__(kThreads, 2)
log_mel_kernel(const float* __restrict__ frames, const float* __restrict__ c_re,
               const float* __restrict__ c_im, const float* __restrict__ fb,
               float* __restrict__ out, int n_frames, int n_fft, int n_bins,
               int n_mels, float amin) {
  __shared__ __align__(16) float a_s[kTileDepth][kPitch];    // frames, [depth][frame]
  __shared__ __align__(16) float re_s[kTileDepth][kTileBins];
  __shared__ __align__(16) float im_s[kTileDepth][kTileBins];
  __shared__ __align__(16) float pow_s[kTileBins][kPitch];   // power, [bin][frame]
  __shared__ __align__(16) float fb_s[kTileBins][kMels];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns frames ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // owns bins / mels tx, tx+16, tx+32, tx+48
  const int m0 = blockIdx.x * kTileFrames;

  // Frame tile load: 64 frames x 16 samples, one float4 per thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 4;
  const bool a_valid = m0 + a_row < n_frames;
  const float* a_ptr = frames + static_cast<size_t>(m0 + a_row) * n_fft + a_col;
  // DFT tile load: 16 samples x 64 bins, one float4 per thread per matrix.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 4;

  float mel[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mel[i][j] = 0.f;

  for (int b0 = 0; b0 < n_bins; b0 += kTileBins) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += kTileDepth) {
      const float4 a = a_valid ? *reinterpret_cast<const float4*>(a_ptr + k0)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      a_s[a_col + 0][a_row] = a.x;
      a_s[a_col + 1][a_row] = a.y;
      a_s[a_col + 2][a_row] = a.z;
      a_s[a_col + 3][a_row] = a.w;
      const size_t c_off = static_cast<size_t>(k0 + b_row) * n_bins + b0 + b_col;
      *reinterpret_cast<float4*>(&re_s[b_row][b_col]) =
          *reinterpret_cast<const float4*>(c_re + c_off);
      *reinterpret_cast<float4*>(&im_s[b_row][b_col]) =
          *reinterpret_cast<const float4*>(c_im + c_off);
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kTileDepth; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        float br[4], bi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          br[j] = re_s[kk][tx + 16 * j];
          bi[j] = im_s[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a4[i], br[j], re[i][j]);
            im[i][j] = fmaf(a4[i], bi[j], im[i][j]);
          }
      }
      __syncthreads();
    }

    // Power tile and the matching filterbank rows into shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pow_s[tx + 16 * j][ty * 4 + i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
#pragma unroll
    for (int r = 0; r < (kTileBins * kMels) / (4 * kThreads); ++r) {
      const int idx = tid + r * kThreads;
      const int row = idx / (kMels / 4);
      const int col = (idx % (kMels / 4)) * 4;
      *reinterpret_cast<float4*>(&fb_s[row][col]) =
          *reinterpret_cast<const float4*>(fb + static_cast<size_t>(b0 + row) * kMels + col);
    }
    __syncthreads();

#pragma unroll 8
    for (int b = 0; b < kTileBins; ++b) {
      const float4 pv = *reinterpret_cast<const float4*>(&pow_s[b][ty * 4]);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = fb_s[b][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mel[i][j] = fmaf(p4[i], f[j], mel[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < n_mels)
        out[static_cast<size_t>(m) * n_mels + c] = 10.f * log10f(fmaxf(mel[i][j], amin));
    }
  }
}

}  // namespace

extern "C" int seld_log_mel_frames(const void* frames, const void* c_re,
                                   const void* c_im, const void* fb, void* out,
                                   int n_frames, int n_fft, int n_bins,
                                   int n_mels, float amin, void* stream) {
  if (n_frames < 0 || n_fft <= 0 || n_fft % kTileDepth != 0 || n_bins <= 0 ||
      n_bins % kTileBins != 0 || n_mels < 1 || n_mels > kMels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames == 0) return 0;
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames);
  log_mel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(c_re),
      static_cast<const float*>(c_im), static_cast<const float*>(fb),
      static_cast<float*>(out), n_frames, n_fft, n_bins, n_mels, amin);
  return static_cast<int>(cudaGetLastError());
}
