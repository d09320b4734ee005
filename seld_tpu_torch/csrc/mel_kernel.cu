// K1: STFT frames -> log-mel dB in one pass, for Hopper (sm_90a).
//
// Replaces seld_tpu/ops/mel_pallas.py::log_mel_frames_pallas (body
// `_kernel`). For every frame x of n_fft samples it computes
//
//   X   = rfft(hann * x)                      (n_fft / 2 + 1 bins)
//   mel = |X|^2 @ FB                          (HTK filterbank, sparse)
//   out = 10 * log10(max(mel, amin))
//
// and, like the TPU kernel, never writes the power spectrum to device
// memory. The TPU kernel computes the DFT as two MXU matrix products;
// here it is a real FFT kept in registers.
//
// What bounds it on an H100. Per frame the function reads n_fft floats and
// writes n_mels: at n_fft = 960, 3.8 KB in and 256 B out, against some
// 28 kFLOP with an FFT, about 7 FLOP per byte, under the card's f32 balance
// point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B). So its floor is the bytes,
// and the design reads each input byte once and spends few instructions
// on everything else. (A DFT as a matrix product does 70x the arithmetic
// and is compute-bound in f32; one-pass TF32 or bf16 tensor-core products
// do not hold the 5e-3 dB the tests ask, and 3xTF32 through wgmma costs
// about what the whole FFT path takes, so tensor cores are not used.)
//
// Design: one warp per frame, the frame read in place.
//
//   * Frames are addressed as x + c * channel_stride + t * frame_stride, so
//     a (C, T, n_fft) view of the reflect-padded waveform (hop = n_fft / 2)
//     is read where it lies: no framed copy, and the half of each frame
//     that the next one shares comes from L2.
//   * The real FFT is warp_fft.cuh's `warp_rfft` (shared with K4): a
//     half-length complex FFT of M = n_fft / 2 = 32 R points, lane l
//     loading z[l + 32 j], j < R, as float2 (each warp load is 256
//     contiguous bytes; scalar loads when the view is not 8-byte aligned)
//     with the window applied as it loads; an R-point DFT per lane, five
//     cross-lane radix-2 stages through __shfl_xor_sync and the real split,
//     whose partner bin is one shuffle away. The lane writes |X[k]|^2 to
//     its warp's row in shared memory.
//   * Mel and log: the filterbank is packed per band (first bin, bin count,
//     weights); each bin lies in at most two HTK bands, so it holds ~2 x
//     481 weights. Lane l sums bands l and n_mels - 1 - l from shared
//     memory (warp_fft.cuh's `band_sums`) and writes their dB: one
//     coalesced row per frame.
//
// Other n_fft: ops/mel_cuda.py::kernel_path routes each n_fft to one of
// three kernels in this file.
//
// Even n_fft whose half M has no prime factor above 7, 64 <= n_fft <=
// 4096 (1200, 600, 640, 882, 1764, 1920, ...): `log_mel_mixed_kernel`
// below, the same function with mixed_fft.cuh's stage: one warp per frame,
// the frame loaded with the window into a Stockham mixed-radix FFT of M
// points (radices 2, 3, 4, 5, 7, 8) in the warp's shared memory, the real
// split, |X[k]|^2 written over the warp's buffer, then `band_sums` as
// above. Its bound is the register kernel's (the bytes, and an FFT's
// arithmetic), but each pass reads and writes M complex values of shared
// memory and each butterfly loads its twiddles from the plan's W_M table,
// where the register kernel shuffles: four passes at n_fft 1200. Dynamic
// shared memory: two buffers of (M + M / 16 + 1) x 8 bytes a warp, as many
// warps a block (1 to 8) as fit in 48 KB: 4 warps and 40.8 KB at n_fft
// 1200, 8 and 40.9 KB at 600, 1 and 34.8 KB at 4096.
//
// Every other n_fft (odd, or a half with a larger prime factor, such as
// 1202 = 2 x 601): `log_mel_dft_kernel` below, the DFT as tiles (the
// design the FFT replaced, taking any n_fft): a block owns 64 frames and
// loops over 64-bin chunks of the spectrum; per chunk a 64 x (64 + 64) x
// n_depth product over 16-deep shared-memory tiles of the frames and of the
// Hann-windowed bases C_re / C_im (n_depth = n_fft rounded up to 16, the
// bases' extra rows zero and the frame loads guarded past n_fft), each
// thread holding 4 frames x 4 bins of re and im in registers; the power
// tile and the matching filterbank slice go through shared memory into the
// block's 64 x 64 mel sums, which stay in registers across all chunks. It
// reads the frames in place through the same strides, with scalar loads
// (any alignment). f32 FMA, compute-bound: 2 n_depth n_bins FLOP a frame.
//
// Nothing is pipelined: 12,004 frames give 12,004 warps over 132 SMs,
// each warp with R independent loads in flight, which hides the latency.
// All arithmetic is f32; every twiddle comes from the plan's float64
// tables rounded once to f32.
//
// C interface (bound with ctypes): seld_log_mel_frames(...) launches on
// the given stream and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "mixed_fft.cuh"
#include "warp_fft.cuh"

namespace {

using warp_fft::kWarp;
using warp_fft::RadixConsts;
using warp_fft::SpecRow;

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxMels = 64;
constexpr int kMixedBlockBytes = 48 * 1024;  // the mixed-radix kernel's buffers a block

// The plan's tables are those warp_fft.cuh lists.
template <int R, bool kVec2>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
log_mel_kernel(const float* __restrict__ x, long long channel_stride, long long frame_stride,
               int n_frames, int total, const float2* __restrict__ window2,
               const float2* __restrict__ lane_tw, const float2* __restrict__ warp_tw,
               const float2* __restrict__ split_tw, const int* __restrict__ bands,
               const float* __restrict__ weights, int n_mels, float amin,
               float* __restrict__ out, const __grid_constant__ RadixConsts radix) {
  using Row = SpecRow<R>;
  __shared__ float pw_s[kWarpsPerBlock][Row::kPitch];  // power row of one frame, bins 0..M

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int f = blockIdx.x * kWarpsPerBlock + warp;
  if (f >= total) return;  // whole warps only: nothing below syncs the block
  const int ch = f / n_frames;
  const int t = f - ch * n_frames;
  const float* src = x + ch * channel_stride + t * frame_stride;

  float* pw = pw_s[warp];
  warp_fft::warp_rfft<R, kVec2>(src, lane, window2, lane_tw, warp_tw, split_tw, radix,
                                [&](int k, float re, float im) {
                                  pw[Row::at(k)] = fmaf(re, re, im * im);
                                });
  __syncwarp();

  float* row = out + static_cast<long long>(f) * n_mels;
  warp_fft::band_sums(
      lane, n_mels, bands, weights, [&](int k) { return pw[Row::at(k)]; },
      [&](int m, float acc) { row[m] = 10.f * log10f(fmaxf(acc, amin)); });
}

template <int R>
int launch(const float* x, long long cs, long long fs, int n_frames, int total,
           bool vec2, const float2* window2, const float2* lane_tw, const float2* warp_tw,
           const float2* split_tw, const int* bands, const float* weights, int n_mels,
           float amin, float* out, const RadixConsts& radix, cudaStream_t stream) {
  const dim3 grid((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  if (vec2) {
    log_mel_kernel<R, true><<<grid, block, 0, stream>>>(
        x, cs, fs, n_frames, total, window2, lane_tw, warp_tw, split_tw, bands, weights,
        n_mels, amin, out, radix);
  } else {
    log_mel_kernel<R, false><<<grid, block, 0, stream>>>(
        x, cs, fs, n_frames, total, window2, lane_tw, warp_tw, split_tw, bands, weights,
        n_mels, amin, out, radix);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames: n_channels x n_frames frames of n_fft floats at x + c *
// channel_stride + t * frame_stride (strides in floats); out: the
// (n_channels * n_frames, n_mels) log-mel, contiguous. radix: host pointer
// to the plan's 16 complex constants. n_fft must be 512, 960, 1024 or 2048.
extern "C" int seld_log_mel_frames(const void* x, long long channel_stride,
                                   long long frame_stride, int n_channels, int n_frames,
                                   int n_fft, const void* window, const void* lane_tw,
                                   const void* warp_tw, const void* split_tw,
                                   const float* radix, const void* bands,
                                   const void* weights, int n_mels, float amin, void* out,
                                   void* stream) {
  if (n_channels < 0 || n_frames < 0 || n_mels < 1 || n_mels > kMaxMels ||
      static_cast<long long>(n_channels) * n_frames > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total = n_channels * n_frames;
  if (total == 0) return 0;
  RadixConsts rc;
  std::memcpy(&rc, radix, sizeof(rc));
  // float2 loads need an 8-byte aligned frame start for every frame
  const bool vec2 = reinterpret_cast<unsigned long long>(x) % 8 == 0 &&
                    channel_stride % 2 == 0 && frame_stride % 2 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* w2 = static_cast<const float2*>(window);
  const auto* lt = static_cast<const float2*>(lane_tw);
  const auto* wt = static_cast<const float2*>(warp_tw);
  const auto* st = static_cast<const float2*>(split_tw);
  const auto* bd = static_cast<const int*>(bands);
  const auto* wg = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 512:
      return launch<8>(xf, channel_stride, frame_stride, n_frames, total, vec2, w2, lt, wt, st,
                       bd, wg, n_mels, amin, o, rc, s);
    case 960:
      return launch<15>(xf, channel_stride, frame_stride, n_frames, total, vec2, w2, lt, wt, st,
                        bd, wg, n_mels, amin, o, rc, s);
    case 1024:
      return launch<16>(xf, channel_stride, frame_stride, n_frames, total, vec2, w2, lt, wt, st,
                        bd, wg, n_mels, amin, o, rc, s);
    case 2048:
      return launch<32>(xf, channel_stride, frame_stride, n_frames, total, vec2, w2, lt, wt, st,
                        bd, wg, n_mels, amin, o, rc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// The mixed-radix path: tables as mixed_fft.cuh lists, bands and weights
// as the register kernel's; blockDim.x / 32 warps, each with two buffers.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
log_mel_mixed_kernel(const float* __restrict__ x, long long channel_stride,
                     long long frame_stride, int n_frames, int total, bool vec2,
                     const float2* __restrict__ window2, const float2* __restrict__ twiddles,
                     const float2* __restrict__ split_tw, const int* __restrict__ bands,
                     const float* __restrict__ weights, int n_mels, float amin,
                     float* __restrict__ out, const __grid_constant__ mixed_fft::Plan plan) {
  extern __shared__ float2 buffers[];  // two rows of mixed_fft::pitch(M) a warp

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int f = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (f >= total) return;  // whole warps only: nothing below syncs the block
  const int ch = f / n_frames;
  const int t = f - ch * n_frames;
  float2* a = buffers + 2 * warp * mixed_fft::pitch(plan.m);
  float2* b = a + mixed_fft::pitch(plan.m);

  const float2* z = mixed_fft::forward(x + ch * channel_stride + t * frame_stride, vec2,
                                       window2, a, b, lane, twiddles, plan);
  float* pw = reinterpret_cast<float*>(z == a ? b : a);  // the power of bins 0..M
  mixed_fft::real_split(z, lane, plan.m, split_tw,
                        [&](int k, float re, float im) { pw[k] = fmaf(re, re, im * im); });
  __syncwarp();

  float* row = out + static_cast<long long>(f) * n_mels;
  warp_fft::band_sums(
      lane, n_mels, bands, weights, [&](int k) { return pw[k]; },
      [&](int m, float acc) { row[m] = 10.f * log10f(fmaxf(acc, amin)); });
}

}  // namespace

// The mixed-radix path. frames as seld_log_mel_frames takes them, any
// alignment; n_fft even with M = n_fft / 2 from 32 to 2048 and the
// product of the n_pass radices (each 2, 3, 4, 5, 7 or 8); consts: host
// pointer to the plan's 8 complex butterfly constants; window, twiddles,
// split_tw: the plan's device tables; out: (n_channels * n_frames, n_mels).
extern "C" int seld_log_mel_frames_mixed(const void* x, long long channel_stride,
                                         long long frame_stride, int n_channels, int n_frames,
                                         int n_fft, const void* window, const void* twiddles,
                                         const void* split_tw, const int* radices, int n_pass,
                                         const float* consts, const void* bands,
                                         const void* weights, int n_mels, float amin, void* out,
                                         void* stream) {
  mixed_fft::Plan plan;
  if (n_channels < 0 || n_frames < 0 || n_mels < 1 || n_mels > kMaxMels ||
      static_cast<long long>(n_channels) * n_frames > 0x7fffffffLL ||
      !mixed_fft::make_plan(n_fft, radices, n_pass, consts, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total = n_channels * n_frames;
  if (total == 0) return 0;
  const bool vec2 = reinterpret_cast<unsigned long long>(x) % 8 == 0 &&
                    channel_stride % 2 == 0 && frame_stride % 2 == 0;
  // warps a block: as many as keep its buffers within 48 KB, 1 to 8
  const int warp_bytes = 2 * mixed_fft::pitch(plan.m) * static_cast<int>(sizeof(float2));
  const int warps = std::max(1, std::min(kWarpsPerBlock, kMixedBlockBytes / warp_bytes));
  const int smem = warps * warp_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      log_mel_mixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((total + warps - 1) / warps);
  log_mel_mixed_kernel<<<grid, kWarp * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), channel_stride, frame_stride, n_frames, total, vec2,
      static_cast<const float2*>(window), static_cast<const float2*>(twiddles),
      static_cast<const float2*>(split_tw), static_cast<const int*>(bands),
      static_cast<const float*>(weights), n_mels, amin, static_cast<float*>(out), plan);
  return static_cast<int>(cudaGetLastError());
}

namespace {
namespace dft {

constexpr int kThreads = 256;
constexpr int kTileFrames = 64;          // frames per block
constexpr int kTileBins = 64;            // spectrum bins per chunk
constexpr int kTileDepth = 16;           // DFT depth per shared-memory stage
constexpr int kMels = 64;                // filterbank width (n_mels padded)
constexpr int kPitch = kTileFrames + 4;  // padded row of frame-indexed tiles

static_assert(kThreads == 4 * kTileFrames, "frame tile load: four samples each");
static_assert(kThreads * 4 == kTileDepth * kTileBins, "DFT tile load: one float4 each");

__global__ void __launch_bounds__(kThreads, 2)
log_mel_dft_kernel(const float* __restrict__ x, long long channel_stride,
                   long long frame_stride, int n_frames, int total, int n_fft, int n_depth,
                   const float* __restrict__ c_re, const float* __restrict__ c_im,
                   const float* __restrict__ fb, int n_bins, int n_mels, float amin,
                   float* __restrict__ out) {
  __shared__ __align__(16) float a_s[kTileDepth][kPitch];    // frames, [depth][frame]
  __shared__ __align__(16) float re_s[kTileDepth][kTileBins];
  __shared__ __align__(16) float im_s[kTileDepth][kTileBins];
  __shared__ __align__(16) float pow_s[kTileBins][kPitch];   // power, [bin][frame]
  __shared__ __align__(16) float fb_s[kTileBins][kMels];

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns frames ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // owns bins / mels tx, tx+16, tx+32, tx+48
  const int m0 = blockIdx.x * kTileFrames;

  // Frame tile load: 64 frames x 16 samples, four guarded scalars a thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 4;
  const int a_frame = m0 + a_row;
  const bool a_valid = a_frame < total;
  const int a_ch = a_valid ? a_frame / n_frames : 0;
  const float* a_ptr = x + a_ch * channel_stride +
                       static_cast<long long>(a_frame - a_ch * n_frames) * frame_stride;
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

    for (int k0 = 0; k0 < n_depth; k0 += kTileDepth) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + a_col + i;
        a_s[a_col + i][a_row] = a_valid && k < n_fft ? a_ptr[k] : 0.f;
      }
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
    if (m >= total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < n_mels)
        out[static_cast<size_t>(m) * n_mels + c] = 10.f * log10f(fmaxf(mel[i][j], amin));
    }
  }
}

}  // namespace dft
}  // namespace

// The general-n_fft path. frames as seld_log_mel_frames takes them, any
// n_fft >= 1 and any alignment; c_re, c_im: (n_depth, n_bins) Hann-windowed
// DFT bases, n_depth = n_fft rounded up to 16 with zero rows past n_fft;
// fb: (n_bins, 64) filterbank, n_bins a multiple of 64, zero past the real
// bins and the n_mels columns; out: (n_channels * n_frames, n_mels).
extern "C" int seld_log_mel_frames_dft(const void* x, long long channel_stride,
                                       long long frame_stride, int n_channels, int n_frames,
                                       int n_fft, int n_depth, const void* c_re,
                                       const void* c_im, const void* fb, int n_bins,
                                       int n_mels, float amin, void* out, void* stream) {
  if (n_channels < 0 || n_frames < 0 || n_fft < 1 || n_depth < n_fft ||
      n_depth % dft::kTileDepth != 0 || n_bins <= 0 || n_bins % dft::kTileBins != 0 ||
      n_mels < 1 || n_mels > dft::kMels ||
      static_cast<long long>(n_channels) * n_frames > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total = n_channels * n_frames;
  if (total == 0) return 0;
  const dim3 grid((total + dft::kTileFrames - 1) / dft::kTileFrames);
  dft::log_mel_dft_kernel<<<grid, dft::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), channel_stride, frame_stride, n_frames, total, n_fft,
      n_depth, static_cast<const float*>(c_re), static_cast<const float*>(c_im),
      static_cast<const float*>(fb), n_bins, n_mels, amin, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
