// K4: 4-channel STFT frames -> spatial feature stack in one pass, for
// Hopper (sm_90a).
//
// Replaces seld_tpu/ops/spatial_pallas.py::spatial_features_pallas (body
// `_kernel`, constants `_constants`). For each frame of the four FOA
// channels (ACN order W, Y, Z, X) it computes
//
//   X_c      = rfft(hann * x_c)                       (n_fft / 2 + 1 bins)
//   mel_c    = 10 log10(max(|X_c|^2 @ FB, amin))      (4 log-mel planes)
//   mel_iv:  energy = (p_W + (p_X + p_Y + p_Z) / 3) / 2 + eps and
//            iv_c = Re(conj(X_W) X_c) / energy @ FB_norm, c = X, Y, Z
//   mel_gcc: for the 6 pairs (i, j) of itertools.combinations(range(4), 2)
//            C = conj(X_i) X_j * rsqrt(cr^2 + ci^2 + eps^2), projected onto
//            n_mels lags centred on 0: irfft(C) at samples m mod n_fft,
//            m in [-n_mels / 2, n_mels - n_mels / 2)
//
// and writes (T, C_out, n_mels), C_out = 4 / 7 / 10. Like the TPU kernel
// it never writes a spectrum to device memory. The TPU kernel computes the
// DFT and the lag projection as MXU matrix products; here both are FFTs.
//
// What bounds it on an H100. Read in place (below), a 60 s clip is the
// 23.06 MB reflect-padded waveform in and 5.38 / 7.68 MB out (mel_iv /
// mel_gcc): 0.0085 / 0.0092 ms at 3.35 TB/s. With FFTs the function is
// some 0.38 / 0.88 GFLOP, 0.006 / 0.013 ms at the 67 TFLOP/s f32 peak, so
// mel_iv is bound by its bytes and mel_gcc by its arithmetic. The earlier
// design ran the DFT as f32 GEMMs, 70x this arithmetic; the GCC lag
// projection as a dense product would be 2.2 GFLOP more with a 246 KB lag
// matrix. So the design is K1's FFT stage per channel, sparse band sums
// and, for GCC, a pruned inverse FFT:
//
//   * One block of four warps per frame, warp c on channel c. Frames are
//     read in place at x + c * channel_stride + t * frame_stride, so
//     `frame_signal`'s (4, T, n_fft) view of the padded waveform needs no
//     framed copy. Each warp runs warp_fft.cuh's `warp_rfft` (K1's stage:
//     float2 loads with the window, the lane DFT, five cross-lane shuffle
//     stages, the real split) and writes X_c[k] for bins 0..M (M = n_fft
//     / 2) as re and im rows to shared memory: 4 x 2 x 481 floats, 15.4 KB
//     at n_fft = 960 (33.8 KB at 2048, padded for banks at even R).
//   * Mel planes: each warp sums its own channel's bands at once, with
//     K1's `band_sums` on |X_c|^2 = fmaf(re, re, im * im): the same
//     weights in the same order, so the 4 mel planes equal K1's output on
//     the same frames bit for bit. "mel" stops here.
//   * mel_iv, after a block barrier: the 128 threads walk the bins; each
//     reads the four spectra at its bin, forms the energy and the three
//     intensities and writes them over the re rows of channels 0-2 at that
//     bin (no other thread touches that bin); after a second barrier
//     warps 1-3 sum the bands of one plane each on FB_norm's packed
//     weights (FB's bands, other weights).
//   * mel_gcc, after a block barrier: warp w takes pairs w and w + 4. It
//     forms the PHAT-normalised cross-spectrum at the bins it held in the
//     forward stage (k = r + R bitrev5(lane)), then runs that stage in
//     reverse: the inverse real split (the partner bin M - k one shuffle
//     away, bin M on lane 0), the five cross-lane stages inverted in the
//     opposite order with conjugate twiddles, and the lane DFT pruned to
//     the samples the lags need. The 64 lags are the complex samples
//     z[0..15] (lanes 0-15, n2 = 0) and z[M-16..M-1] (lanes 16-31, n2 =
//     R - 1), so each lane forms one R-term sum with the plan's lag
//     twiddles (the conjugate lane twiddle, the pruned DFT's row and 2 /
//     n_fft folded in). irfft reads only the real parts of bins 0 and M;
//     so does the kernel, as the TPU's lag matrix does (its sine column
//     is 0 there).
//   * Silence gives exactly -100 dB and exact zeros: a zero cross-spectrum
//     times rsqrt(eps^2) is 0, and every stage maps zeros to zeros. No
//     atomics: reruns are bit-equal. Every channel goes through the same
//     code, so a signed permutation of the channels permutes and signs
//     the planes exactly (the ACS commutation).
//
// Other n_fft: ops/mel_cuda.py::kernel_path routes each n_fft to one of
// three kernels in this file.
//
// Even n_fft whose half M has no prime factor above 7, 64 <= n_fft <=
// 4096: `spatial_mixed_kernel` below, the same features on K1's
// mixed-radix stage (mixed_fft.cuh). One block of four warps per frame,
// warp c on channel c: the Stockham FFT of channel c between its two rows
// of dynamic shared memory, the real split writing X_c[0..M] in natural
// order to the row that does not hold Z, the mel planes by `band_sums` as
// above. "mel_iv" as above (the intensities over the .x of three spectra
// rows). "mel_gcc": after a block barrier the 128 threads walk the bins
// and write the six pairs' PHAT cross-spectra over rows 0-5 (a thread
// reads all four spectra at its bin before it writes that bin of any
// row); after a second barrier warp w inverts pairs w and w + 4, with row
// 6 + w as its other buffer (two rows more for this set): the inverse real
// split (irfft's Re C[0] and Re C[M] only), its conjugate, then the forward
// passes of the same plan, so that the inverse FFT is conj(FFT(conj Z)) on
// the same twiddles; the lags are the complex samples z[0..15] and
// z[M-16..M-1] of that full inverse (no pass is pruned), conjugated and
// scaled by 2 / n_fft. Silence gives exact zeros and -100 dB, and every
// channel and pair goes through the same code, as above. Dynamic shared
// memory: 8 (10 for "mel_gcc") rows of (M + M / 16 + 1) x 8 bytes, 40.8 /
// 51.0 KB at n_fft 1200.
//
// Every other n_fft: `spatial_dft_kernel` below, the DFT as tiles (the design
// the FFT replaced, taking any n_fft): a block owns 16 frames of all 4
// channels, 64 DFT rows frame-major and channel-minor, so the thread that
// owns a frame holds its 4 channels' re / im at 4 bins in registers and
// forms the derived planes (power, intensity vectors or PHAT cross-spectra)
// without an exchange; per 64-bin chunk it runs a 64 x (64 + 64) x n_depth
// product over 16-deep shared-memory tiles (n_depth = n_fft rounded up to
// 16, the bases' extra rows zero, frame loads guarded past n_fft and read
// in place as scalars), then adds the chunk's planes times the projection
// slices (filterbank, column-normalised filterbank, lag matrices) to the
// (16, C_out, 64) output sums in registers. Compute-bound in f32 FMA.
//
// Nothing is pipelined: 3,001 frames give 3,001 blocks of four warps, each
// warp with R independent loads in flight. What holds it above its bound,
// by chip_smoke.py's times of the three feature sets: the "mel" set alone
// (K1's forward stage and mel sums) takes most of mel_iv's and mel_gcc's
// time, so that stage's instructions (lane DFT, shuffle stages, per-band
// loops) come first; then the pairs, 2 + 2 + 1 + 1 over the four warps,
// so warps 2-3 idle through one pair's inverse. All arithmetic is f32 on
// the CUDA cores, every twiddle from the plan's float64 tables rounded
// once: the IV and GCC planes are held to 1e-4, which one-pass TF32
// cannot meet, and an FFT does 1/70 of the work that 3xTF32 tensor-core
// DFT products would.
//
// C interface (bound with ctypes): seld_spatial_features(...) launches on
// the given stream and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.

#include <cuda_runtime.h>

#include <cstring>

#include "mixed_fft.cuh"
#include "warp_fft.cuh"

namespace {

using warp_fft::cmul;
using warp_fft::kWarp;
using warp_fft::RadixConsts;
using warp_fft::SpecRow;

constexpr int kChannels = 4;
constexpr int kThreads = kChannels * kWarp;  // one warp per channel of one frame
constexpr int kMaxMels = 64;

// ACN channel order of STARSS22's FOA: W, Y, Z, X.
constexpr int kW = 0, kY = 1, kZ = 2, kX = 3;

enum FeatureSet { kMel = 0, kMelIv = 1, kMelGcc = 2 };

template <int kSet>
constexpr int kOutPlanes = kSet == kMel ? 4 : kSet == kMelIv ? 7 : 10;

// The inverse of warp_rfft's real split for the bins a lane holds: with a
// = C[k] and p = C[M - k], Z[k] = (a + conj p) / 2 + conj(tw) (a - conj p),
// tw = -(i/2) W_N^k the forward's split twiddle (half the true inverse's Z,
// the lag twiddles carry the 2).
__device__ __forceinline__ float2 inverse_split(float2 a, float2 p, float2 tw) {
  const float2 sum = make_float2(0.5f * (a.x + p.x), 0.5f * (a.y - p.y));
  const float2 dif = make_float2(a.x - p.x, a.y + p.y);
  return make_float2(fmaf(tw.x, dif.x, fmaf(tw.y, dif.y, sum.x)),
                     fmaf(tw.x, dif.y, fmaf(-tw.y, dif.x, sum.y)));
}

// The per-bin arithmetic of the derived planes, shared by the register and
// mixed-radix kernels. iv: the energy-normalised intensities of X, Y, Z
// from the four spectra's re / im (ACN order) at one bin.
__device__ __forceinline__ void intensity_vector(const float (&re)[kChannels],
                                                 const float (&im)[kChannels], float eps,
                                                 float (&iv)[3]) {
  float p[kChannels];
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) p[ch] = fmaf(re[ch], re[ch], im[ch] * im[ch]);
  const float energy = (p[kW] + (p[kX] + p[kY] + p[kZ]) / 3.f) / 2.f + eps;
  const float inv_e = 1.f / energy;
  const int xyz[3] = {kX, kY, kZ};
#pragma unroll
  for (int q = 0; q < 3; ++q) iv[q] = (re[kW] * re[xyz[q]] + im[kW] * im[xyz[q]]) * inv_e;
}

// The PHAT-normalised cross-spectrum conj(S_i) S_j at one bin.
__device__ __forceinline__ float2 phat(float ar, float ai, float br, float bi, float eps2) {
  const float cr = ar * br + ai * bi;
  const float ci = ar * bi - ai * br;
  const float inv = rsqrtf(cr * cr + ci * ci + eps2);
  return make_float2(cr * inv, ci * inv);
}

// Pair q of (0,1) (0,2) (0,3) (1,2) (1,3) (2,3): its channels i < j.
__device__ __forceinline__ int pair_first(int q) { return (q >= 3) + (q >= 5); }
__device__ __forceinline__ int pair_second(int q) {
  const int i = pair_first(q);
  return q + 1 - i * (5 - i) / 2;
}

// One GCC-PHAT plane of a frame, one warp: spectra i and j are rows of
// shared memory; writes the n_mels lag columns of `plane`. lag_tw (R, 32)
// float2: (2 / n_fft) exp(2 pi i k2 n / M) at [k2][lane], n = lane for
// lanes 0-15 and M - 32 + lane for lanes 16-31.
template <int R>
__device__ __forceinline__ void gcc_plane(const float* re_i, const float* im_i,
                                          const float* re_j, const float* im_j, int lane,
                                          const float2* __restrict__ warp_tw,
                                          const float2* __restrict__ split_tw,
                                          const float2* __restrict__ lag_tw, float eps2,
                                          float* __restrict__ plane, int n_mels) {
  using Row = SpecRow<R>;
  constexpr int M = R * kWarp;
  auto cross = [&](int k) {
    const int a = Row::at(k);
    return phat(re_i[a], im_i[a], re_j[a], im_j[a], eps2);
  };
  const int k1 = warp_fft::brev5(lane);
  float2 z[R];
#pragma unroll
  for (int r = 0; r < R; ++r) z[r] = cross(r + R * k1);
  if (lane == 0) z[0].y = 0.f;  // irfft reads Re C[0] only
  const float nyq = cross(M).x;  // and Re C[M]: every lane reads it (a broadcast)

  // inverse real split, in place: bins k and M - k of a lane's registers r
  // and R - r pair with registers R - r and r of lane 31 - lane; register
  // 0 pairs with register 0 of the lane whose bitrev5 is 32 - bitrev5(lane),
  // and on lane 0 (bin 0) with bin M
  {
    const int src0 = warp_fft::brev5((kWarp - k1) % kWarp);
    float2 p = warp_fft::shfl2(z[0], src0);
    if (lane == 0) p = make_float2(nyq, 0.f);
    z[0] = inverse_split(z[0], p, split_tw[lane]);
  }
#pragma unroll
  for (int r = 1; 2 * r <= R; ++r) {
    const float2 pa = warp_fft::shfl_xor2(z[R - r], kWarp - 1);
    if (2 * r == R) {
      z[r] = inverse_split(z[r], pa, split_tw[r * kWarp + lane]);
    } else {
      const float2 pb = warp_fft::shfl_xor2(z[r], kWarp - 1);
      z[r] = inverse_split(z[r], pa, split_tw[r * kWarp + lane]);
      z[R - r] = inverse_split(z[R - r], pb, split_tw[(R - r) * kWarp + lane]);
    }
  }

  // the forward's five cross-lane stages, each inverted (times 2), in the
  // opposite order: the upper lane of a pair undoes its twiddle, then the
  // pair's sum and difference; bitrev5 order in, natural order out
#pragma unroll
  for (int s = 4; s >= 0; --s) {
    const int h = 16 >> s;
    const float sign = (lane & h) ? -1.f : 1.f;
    float2 tw = s < 4 ? warp_tw[s * kWarp + lane] : make_float2(1.f, 0.f);
    tw.y = -tw.y;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = s < 4 ? cmul(z[r], tw) : z[r];
      const float2 p = warp_fft::shfl_xor2(v, h);
      z[r] = make_float2(fmaf(sign, v.x, p.x), fmaf(sign, v.y, p.y));
    }
  }

  // the lane DFT pruned to the one output this lane needs
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 w = lag_tw[r * kWarp + lane];
    acc.x = fmaf(z[r].x, w.x, fmaf(-z[r].y, w.y, acc.x));
    acc.y = fmaf(z[r].x, w.y, fmaf(z[r].y, w.x, acc.y));
  }
  // acc = (x[2n], x[2n + 1]): lags 2 lane, 2 lane + 1 on lanes 0-15 and
  // 2 lane - 64, 2 lane - 63 on lanes 16-31
  const int col = (lane < 16 ? 2 * lane : 2 * lane - 2 * kWarp) + n_mels / 2;
  if (col >= 0 && col < n_mels) plane[col] = acc.x;
  if (col + 1 >= 0 && col + 1 < n_mels) plane[col + 1] = acc.y;
}

// The plan's tables are those warp_fft.cuh lists, and:
//   norm_weights (nnz,) float: FB_norm's weights, packed with FB's bands
//   lag_tw       (R, 32) float2: gcc_plane's
template <int R, int kSet, bool kVec2>
__global__ void __launch_bounds__(kThreads)
spatial_kernel(const float* __restrict__ x, long long channel_stride, long long frame_stride,
               const float2* __restrict__ window2, const float2* __restrict__ lane_tw,
               const float2* __restrict__ warp_tw, const float2* __restrict__ split_tw,
               const float2* __restrict__ lag_tw, const int* __restrict__ bands,
               const float* __restrict__ weights, const float* __restrict__ norm_weights,
               int n_mels, float amin, float eps, float* __restrict__ out,
               const __grid_constant__ RadixConsts radix) {
  using Row = SpecRow<R>;
  constexpr int M = R * kWarp;
  __shared__ float re_s[kChannels][Row::kPitch];
  __shared__ float im_s[kChannels][Row::kPitch];

  const int lane = threadIdx.x % kWarp;
  const int c = threadIdx.x / kWarp;  // the warp's channel
  const long long t = blockIdx.x;
  float* row = out + t * kOutPlanes<kSet> * n_mels;

  warp_fft::warp_rfft<R, kVec2>(x + c * channel_stride + t * frame_stride, lane, window2,
                                lane_tw, warp_tw, split_tw, radix,
                                [&](int k, float re, float im) {
                                  re_s[c][Row::at(k)] = re;
                                  im_s[c][Row::at(k)] = im;
                                });
  __syncwarp();
  const float* re_c = re_s[c];
  const float* im_c = im_s[c];
  warp_fft::band_sums(
      lane, n_mels, bands, weights,
      [&](int k) {
        const float re = re_c[Row::at(k)], im = im_c[Row::at(k)];
        return fmaf(re, re, im * im);
      },
      [&](int m, float acc) { row[c * n_mels + m] = 10.f * log10f(fmaxf(acc, amin)); });
  if constexpr (kSet == kMelIv) {
    __syncthreads();
    for (int k = threadIdx.x; k <= M; k += kThreads) {
      const int a = Row::at(k);
      float re[kChannels], im[kChannels], iv[3];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) {
        re[ch] = re_s[ch][a];
        im[ch] = im_s[ch][a];
      }
      intensity_vector(re, im, eps, iv);
#pragma unroll
      for (int q = 0; q < 3; ++q) re_s[q][a] = iv[q];
    }
    __syncthreads();
    if (c > 0) {
      const float* iv = re_s[c - 1];
      warp_fft::band_sums(
          lane, n_mels, bands, norm_weights, [&](int k) { return iv[Row::at(k)]; },
          [&](int m, float acc) { row[(3 + c) * n_mels + m] = acc; });
    }
  } else if constexpr (kSet == kMelGcc) {
    __syncthreads();
    for (int q = c; q < 6; q += kChannels) {
      const int i = pair_first(q), j = pair_second(q);
      gcc_plane<R>(re_s[i], im_s[i], re_s[j], im_s[j], lane, warp_tw, split_tw, lag_tw,
                   eps * eps, row + (4 + q) * n_mels, n_mels);
    }
  }
}

template <int R, int kSet>
int launch(const float* x, long long cs, long long fs, int n_frames, bool vec2,
           const float2* window2, const float2* lane_tw, const float2* warp_tw,
           const float2* split_tw, const float2* lag_tw, const int* bands, const float* weights,
           const float* norm_weights, int n_mels, float amin, float eps, float* out,
           const RadixConsts& radix, cudaStream_t stream) {
  auto kernel = vec2 ? spatial_kernel<R, kSet, true> : spatial_kernel<R, kSet, false>;
  kernel<<<n_frames, kThreads, 0, stream>>>(x, cs, fs, window2, lane_tw, warp_tw, split_tw,
                                            lag_tw, bands, weights, norm_weights, n_mels, amin,
                                            eps, out, radix);
  return static_cast<int>(cudaGetLastError());
}

template <int kSet>
int launch_set(int n_fft, const float* x, long long cs, long long fs, int n_frames, bool vec2,
               const float2* w2, const float2* lt, const float2* wt, const float2* st,
               const float2* gt, const int* bd, const float* wg, const float* nw, int n_mels,
               float amin, float eps, float* o, const RadixConsts& rc, cudaStream_t s) {
  switch (n_fft) {
    case 512:
      return launch<8, kSet>(x, cs, fs, n_frames, vec2, w2, lt, wt, st, gt, bd, wg, nw, n_mels,
                             amin, eps, o, rc, s);
    case 960:
      return launch<15, kSet>(x, cs, fs, n_frames, vec2, w2, lt, wt, st, gt, bd, wg, nw, n_mels,
                              amin, eps, o, rc, s);
    case 1024:
      return launch<16, kSet>(x, cs, fs, n_frames, vec2, w2, lt, wt, st, gt, bd, wg, nw, n_mels,
                              amin, eps, o, rc, s);
    case 2048:
      return launch<32, kSet>(x, cs, fs, n_frames, vec2, w2, lt, wt, st, gt, bd, wg, nw, n_mels,
                              amin, eps, o, rc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// feature_set: 0 "mel", 1 "mel_iv", 2 "mel_gcc". frames: channel c, frame
// t at x + c * channel_stride + t * frame_stride (strides in floats), 4
// channels of n_fft floats; out: (n_frames, C_out, n_mels), contiguous.
// radix: host pointer to the plan's 16 complex constants. n_fft must be
// 512, 960, 1024 or 2048.
extern "C" int seld_spatial_features(int feature_set, const void* x, long long channel_stride,
                                     long long frame_stride, int n_frames, int n_fft,
                                     const void* window, const void* lane_tw,
                                     const void* warp_tw, const void* split_tw,
                                     const void* lag_tw, const float* radix, const void* bands,
                                     const void* weights, const void* norm_weights, int n_mels,
                                     float amin, float eps, void* out, void* stream) {
  if (n_frames < 0 || n_mels < 1 || n_mels > kMaxMels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames == 0) return 0;
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
  const auto* gt = static_cast<const float2*>(lag_tw);
  const auto* bd = static_cast<const int*>(bands);
  const auto* wg = static_cast<const float*>(weights);
  const auto* nw = static_cast<const float*>(norm_weights);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (feature_set) {
    case kMel:
      return launch_set<kMel>(n_fft, xf, channel_stride, frame_stride, n_frames, vec2, w2, lt,
                              wt, st, gt, bd, wg, nw, n_mels, amin, eps, o, rc, s);
    case kMelIv:
      return launch_set<kMelIv>(n_fft, xf, channel_stride, frame_stride, n_frames, vec2, w2,
                                lt, wt, st, gt, bd, wg, nw, n_mels, amin, eps, o, rc, s);
    case kMelGcc:
      return launch_set<kMelGcc>(n_fft, xf, channel_stride, frame_stride, n_frames, vec2, w2,
                                 lt, wt, st, gt, bd, wg, nw, n_mels, amin, eps, o, rc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// The mixed-radix path (tables as mixed_fft.cuh lists; norm_weights as
// spatial_kernel's). scale = 2 / n_fft. Rows of mixed_fft::pitch(M): warp
// c's two buffers are rows c and 4 + c; "mel_gcc" adds rows 8 and 9.
template <int kSet>
__global__ void __launch_bounds__(kChannels * kWarp)
spatial_mixed_kernel(const float* __restrict__ x, long long channel_stride,
                     long long frame_stride, bool vec2, const float2* __restrict__ window2,
                     const float2* __restrict__ twiddles, const float2* __restrict__ split_tw,
                     const int* __restrict__ bands, const float* __restrict__ weights,
                     const float* __restrict__ norm_weights, int n_mels, float amin, float eps,
                     float scale, float* __restrict__ out,
                     const __grid_constant__ mixed_fft::Plan plan) {
  using mixed_fft::at;
  extern __shared__ float2 rows[];
  const int m = plan.m;
  const int pitch = mixed_fft::pitch(m);
  const int lane = threadIdx.x % kWarp;
  const int c = threadIdx.x / kWarp;  // the warp's channel
  const long long t = blockIdx.x;
  float* row = out + t * kOutPlanes<kSet> * n_mels;

  float2* a = rows + c * pitch;
  float2* b = rows + (kChannels + c) * pitch;
  const float2* z = mixed_fft::forward(x + c * channel_stride + t * frame_stride, vec2, window2,
                                       a, b, lane, twiddles, plan);
  // X_c in the other buffer: every warp ran the same passes, so the four
  // spectra are rows s .. s + 3, s = 0 or 4
  float2* spec = z == a ? b : a;
  const int s0 = z == a ? kChannels : 0;
  mixed_fft::real_split(z, lane, m, split_tw,
                        [&](int k, float re, float im) { spec[at(k)] = make_float2(re, im); });
  __syncwarp();
  warp_fft::band_sums(
      lane, n_mels, bands, weights,
      [&](int k) {
        const float2 v = spec[at(k)];
        return fmaf(v.x, v.x, v.y * v.y);
      },
      [&](int mel, float acc) { row[c * n_mels + mel] = 10.f * log10f(fmaxf(acc, amin)); });
  if constexpr (kSet == kMelIv) {
    __syncthreads();
    for (int k = threadIdx.x; k <= m; k += kThreads) {
      const int i = at(k);
      float re[kChannels], im[kChannels], iv[3];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) {
        const float2 v = rows[(s0 + ch) * pitch + i];
        re[ch] = v.x;
        im[ch] = v.y;
      }
      intensity_vector(re, im, eps, iv);
#pragma unroll
      for (int q = 0; q < 3; ++q) rows[(s0 + q) * pitch + i].x = iv[q];
    }
    __syncthreads();
    if (c > 0) {
      const float2* iv = rows + (s0 + c - 1) * pitch;
      warp_fft::band_sums(
          lane, n_mels, bands, norm_weights, [&](int k) { return iv[at(k)].x; },
          [&](int mel, float acc) { row[(3 + c) * n_mels + mel] = acc; });
    }
  } else if constexpr (kSet == kMelGcc) {
    // the six PHAT cross-spectra over rows 0-5 (a thread reads the four
    // spectra at its bin before it writes that bin of any row)
    __syncthreads();
    const float eps2 = eps * eps;
    for (int k = threadIdx.x; k <= m; k += kThreads) {
      const int i = at(k);
      float2 v[kChannels];
#pragma unroll
      for (int ch = 0; ch < kChannels; ++ch) v[ch] = rows[(s0 + ch) * pitch + i];
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float2 si = v[pair_first(q)], sj = v[pair_second(q)];
        rows[q * pitch + i] = phat(si.x, si.y, sj.x, sj.y, eps2);
      }
    }
    __syncthreads();
    // warp c inverts pairs c and c + 4, with row 6 + c as its other buffer
    float2* scratch = rows + (6 + c) * pitch;
    for (int q = c; q < 6; q += kChannels) {
      float2* cross = rows + q * pitch;
      // the inverse real split, conjugated; irfft reads Re C[0] and Re C[M] only
      for (int k = lane; k < m; k += kWarp) {
        float2 u = cross[at(k)];
        float2 v = cross[at(m - k)];
        if (k == 0) u.y = v.y = 0.f;
        const float2 w = inverse_split(u, v, __ldg(split_tw + k));
        scratch[at(k)] = make_float2(w.x, -w.y);
      }
      __syncwarp();
      const float2* r = mixed_fft::buffer_passes(scratch, cross, lane, 0, 1, twiddles, plan);
      // lane l holds complex sample n = l (lanes 0-15) or M - 32 + l (16-31):
      // (x[2n], x[2n + 1]) = conj of it times 2 / n_fft, lags 2 l, 2 l + 1
      // and 2 l - 64, 2 l - 63
      const float2 zn = r[at(lane < 16 ? lane : m - 2 * 16 + lane)];
      float* plane = row + (4 + q) * n_mels;
      const int col = (lane < 16 ? 2 * lane : 2 * lane - 2 * kWarp) + n_mels / 2;
      if (col >= 0 && col < n_mels) plane[col] = zn.x * scale;
      if (col + 1 >= 0 && col + 1 < n_mels) plane[col + 1] = -zn.y * scale;
      __syncwarp();  // the next pair reuses the scratch row
    }
  }
}

}  // namespace

// The mixed-radix path. feature_set and frames as seld_spatial_features
// takes them, any alignment; n_fft even with M = n_fft / 2 from 32 to 2048
// and the product of the n_pass radices (each 2, 3, 4, 5, 7 or 8);
// consts: host pointer to the plan's 8 complex butterfly constants;
// window, twiddles, split_tw, bands, weights, norm_weights: the plan's
// device tables; scale: 2 / n_fft; out: (n_frames, C_out, n_mels).
extern "C" int seld_spatial_features_mixed(int feature_set, const void* x,
                                           long long channel_stride, long long frame_stride,
                                           int n_frames, int n_fft, const void* window,
                                           const void* twiddles, const void* split_tw,
                                           const int* radices, int n_pass, const float* consts,
                                           const void* bands, const void* weights,
                                           const void* norm_weights, int n_mels, float amin,
                                           float eps, float scale, void* out, void* stream) {
  mixed_fft::Plan plan;
  if (n_frames < 0 || n_mels < 1 || n_mels > kMaxMels ||
      !mixed_fft::make_plan(n_fft, radices, n_pass, consts, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames == 0) return 0;
  const bool vec2 = reinterpret_cast<unsigned long long>(x) % 8 == 0 &&
                    channel_stride % 2 == 0 && frame_stride % 2 == 0;
  const int n_rows = feature_set == kMelGcc ? 10 : 2 * kChannels;
  const int smem = n_rows * mixed_fft::pitch(plan.m) * static_cast<int>(sizeof(float2));
  auto launch = [&](auto kernel) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_frames, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), channel_stride, frame_stride, vec2,
        static_cast<const float2*>(window), static_cast<const float2*>(twiddles),
        static_cast<const float2*>(split_tw), static_cast<const int*>(bands),
        static_cast<const float*>(weights), static_cast<const float*>(norm_weights), n_mels,
        amin, eps, scale, static_cast<float*>(out), plan);
    return static_cast<int>(cudaGetLastError());
  };
  switch (feature_set) {
    case kMel: return launch(spatial_mixed_kernel<kMel>);
    case kMelIv: return launch(spatial_mixed_kernel<kMelIv>);
    case kMelGcc: return launch(spatial_mixed_kernel<kMelGcc>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {
namespace dft {

constexpr int kThreads = 256;
constexpr int kTileFrames = 16;                     // frames per block, all 4 channels
constexpr int kRows = kChannels * kTileFrames;      // DFT rows: frame-major, channel-minor
constexpr int kTileBins = 64;                       // spectrum bins per chunk
constexpr int kTileDepth = 16;                      // DFT depth per shared-memory stage
constexpr int kCols = 64;                           // output columns (n_mels / lags padded)
constexpr int kPitch = kRows + 4;                   // padded row of the frame tile
constexpr int kPlane = kTileFrames * kTileBins;     // one derived plane of a chunk
constexpr int kMat = kTileBins * kCols;             // one projection-matrix slice
constexpr int kStaging = kTileDepth * kPitch + 2 * kTileDepth * kTileBins;

template <int kSet> struct Layout {
  // derived planes per chunk, output planes, projection-matrix slices
  static constexpr int kDerived = kSet == kMel ? 4 : kSet == kMelIv ? 7 : 16;
  static constexpr int kOut = kOutPlanes<kSet>;
  static constexpr int kMats = kSet == kMel ? 1 : kSet == kMelIv ? 2 : 3;
  static constexpr int kSmemFloats = kDerived * kPlane + kMats * kMat;
};

static_assert(kThreads == 4 * kRows, "frame tile load: four samples each");
static_assert(kThreads * 4 == kTileDepth * kTileBins, "DFT tile load: one float4 each");
static_assert(kThreads == kTileFrames * 16, "16 threads per frame, 4 bins/columns each");
static_assert(kStaging <= kMat, "the DFT staging tiles alias the first matrix slice");

// Plane p of frame f at bin b: the odd frames' halves are swapped so that
// the two frames a warp covers hit different banks.
__device__ __forceinline__ int plane_at(int p, int f, int b) {
  return p * kPlane + f * kTileBins + (b ^ ((f & 1) << 4));
}

// ptxas gives the "mel_gcc" instantiation a 16-byte stack frame (12 bytes
// of spill stores) with or without a min-blocks hint; chip_smoke.py prints
// it on every build.
template <int kSet>
__global__ void __launch_bounds__(kThreads, 2)
spatial_dft_kernel(const float* __restrict__ x, long long chan_stride, long long frame_stride,
                   const float* __restrict__ c_re, const float* __restrict__ c_im,
                   const float* __restrict__ fb, const float* __restrict__ fb_norm,
                   const float* __restrict__ lag_re, const float* __restrict__ lag_im,
                   float* __restrict__ out, int n_frames, int n_fft, int n_depth, int n_bins,
                   int n_mels, float amin, float eps) {
  using L = Layout<kSet>;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem;                          // [kDerived][kTileFrames][kTileBins]
  float* mats = smem + L::kDerived * kPlane;     // [kMats][kTileBins][kCols]
  float* a_s = mats;                             // [kTileDepth][kPitch], rows (frame, channel)
  float* re_s = a_s + kTileDepth * kPitch;       // [kTileDepth][kTileBins]
  float* im_s = re_s + kTileDepth * kTileBins;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns frame ty of the tile (DFT rows ty*4 .. ty*4+3)
  const int tx = tid % 16;  // owns bins / columns tx, tx+16, tx+32, tx+48
  const int t0 = blockIdx.x * kTileFrames;

  // Frame tile load: 64 rows (16 frames x 4 channels) x 16 samples, four
  // guarded scalars a thread.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 4;
  const int a_frame = a_row / kChannels;
  const int a_ch = a_row % kChannels;
  const bool a_valid = t0 + a_frame < n_frames;
  const float* a_ptr = x + a_ch * chan_stride + static_cast<long long>(t0 + a_frame) * frame_stride;
  // DFT tile load: 16 samples x 64 bins, one float4 per thread per matrix.
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 4;

  float acc[L::kOut][4];
#pragma unroll
  for (int o = 0; o < L::kOut; ++o)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[o][j] = 0.f;

  for (int b0 = 0; b0 < n_bins; b0 += kTileBins) {
    float re[kChannels][4], im[kChannels][4];
#pragma unroll
    for (int c = 0; c < kChannels; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[c][j] = im[c][j] = 0.f;

    for (int k0 = 0; k0 < n_depth; k0 += kTileDepth) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + a_col + i;
        a_s[(a_col + i) * kPitch + a_row] = a_valid && k < n_fft ? a_ptr[k] : 0.f;
      }
      const size_t c_off = static_cast<size_t>(k0 + b_row) * n_bins + b0 + b_col;
      *reinterpret_cast<float4*>(&re_s[b_row * kTileBins + b_col]) =
          *reinterpret_cast<const float4*>(c_re + c_off);
      *reinterpret_cast<float4*>(&im_s[b_row * kTileBins + b_col]) =
          *reinterpret_cast<const float4*>(c_im + c_off);
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kTileDepth; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk * kPitch + ty * 4]);
        const float a4[kChannels] = {av.x, av.y, av.z, av.w};
        float br[4], bi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          br[j] = re_s[kk * kTileBins + tx + 16 * j];
          bi[j] = im_s[kk * kTileBins + tx + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < kChannels; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[c][j] = fmaf(a4[c], br[j], re[c][j]);
            im[c][j] = fmaf(a4[c], bi[j], im[c][j]);
          }
      }
      __syncthreads();
    }

    // The chunk's derived planes, from this thread's registers. Every
    // channel goes through the same expression, so a signed permutation
    // of the input channels permutes and signs the planes exactly.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = tx + 16 * j;
      float p[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        p[c] = re[c][j] * re[c][j] + im[c][j] * im[c][j];
        planes[plane_at(c, ty, b)] = p[c];
      }
      if constexpr (kSet == kMelIv) {
        const float energy = (p[kW] + (p[kX] + p[kY] + p[kZ]) / 3.f) / 2.f + eps;
        const float inv_e = 1.f / energy;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int c = q == 0 ? kX : q == 1 ? kY : kZ;
          planes[plane_at(4 + q, ty, b)] =
              (re[kW][j] * re[c][j] + im[kW][j] * im[c][j]) * inv_e;
        }
      } else if constexpr (kSet == kMelGcc) {
        int q = 4;
#pragma unroll
        for (int i = 0; i < kChannels; ++i)
#pragma unroll
          for (int k = i + 1; k < kChannels; ++k) {
            const float cr = re[i][j] * re[k][j] + im[i][j] * im[k][j];
            const float ci = re[i][j] * im[k][j] - im[i][j] * re[k][j];
            const float inv = rsqrtf(cr * cr + ci * ci + eps * eps);
            planes[plane_at(q, ty, b)] = cr * inv;
            planes[plane_at(q + 1, ty, b)] = ci * inv;
            q += 2;
          }
      }
    }

    // The matching 64 x 64 projection slices (over the staging tiles,
    // which the last DFT step is done with).
#pragma unroll
    for (int m = 0; m < L::kMats; ++m) {
      const float* src = m == 0 ? fb : m == 2 ? lag_im : kSet == kMelIv ? fb_norm : lag_re;
#pragma unroll
      for (int r = 0; r < kMat / (4 * kThreads); ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / (kCols / 4);
        const int col = (idx % (kCols / 4)) * 4;
        *reinterpret_cast<float4*>(&mats[m * kMat + row * kCols + col]) =
            *reinterpret_cast<const float4*>(src + static_cast<size_t>(b0 + row) * kCols + col);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int b = 0; b < kTileBins; ++b) {
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = mats[b * kCols + tx + 16 * j];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float d = planes[plane_at(c, ty, b)];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = fmaf(d, f[j], acc[c][j]);
      }
      if constexpr (kSet == kMelIv) {
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = mats[kMat + b * kCols + tx + 16 * j];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float d = planes[plane_at(4 + q, ty, b)];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 + q][j] = fmaf(d, g[j], acc[4 + q][j]);
        }
      } else if constexpr (kSet == kMelGcc) {
        float lr[4], li[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lr[j] = mats[kMat + b * kCols + tx + 16 * j];
          li[j] = mats[2 * kMat + b * kCols + tx + 16 * j];
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float dr = planes[plane_at(4 + 2 * q, ty, b)];
          const float di = planes[plane_at(5 + 2 * q, ty, b)];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[4 + q][j] = fmaf(di, li[j], fmaf(dr, lr[j], acc[4 + q][j]));
        }
      }
    }
    __syncthreads();  // planes and matrix slices are rewritten by the next chunk
  }

  const int t = t0 + ty;
  if (t >= n_frames) return;
  float* row = out + static_cast<size_t>(t) * L::kOut * n_mels;
#pragma unroll
  for (int o = 0; o < L::kOut; ++o)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < n_mels)
        row[o * n_mels + col] = o < kChannels ? 10.f * log10f(fmaxf(acc[o][j], amin))
                                              : acc[o][j];
    }
}

template <int kSet>
int launch(const float* x, long long cs, long long fs, const float* c_re, const float* c_im,
           const float* fb, const float* fb_norm, const float* lag_re, const float* lag_im,
           float* out, int n_frames, int n_fft, int n_depth, int n_bins, int n_mels,
           float amin, float eps, cudaStream_t stream) {
  constexpr int smem = Layout<kSet>::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      spatial_dft_kernel<kSet>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spatial_dft_kernel<kSet>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames);
  spatial_dft_kernel<kSet><<<grid, kThreads, smem, stream>>>(
      x, cs, fs, c_re, c_im, fb, fb_norm, lag_re, lag_im, out, n_frames, n_fft, n_depth,
      n_bins, n_mels, amin, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dft
}  // namespace

// The general-n_fft path. feature_set and frames as seld_spatial_features
// takes them, any n_fft >= 1 and any alignment; c_re, c_im: (n_depth,
// n_bins) Hann-windowed DFT bases, n_depth = n_fft rounded up to 16 with
// zero rows past n_fft; fb, fb_norm, lag_re, lag_im: (n_bins, 64), n_bins a
// multiple of 64; out: (n_frames, C_out, n_mels).
extern "C" int seld_spatial_features_dft(int feature_set, const void* x,
                                         long long channel_stride, long long frame_stride,
                                         int n_frames, int n_fft, int n_depth,
                                         const void* c_re, const void* c_im, const void* fb,
                                         const void* fb_norm, const void* lag_re,
                                         const void* lag_im, int n_bins, int n_mels,
                                         float amin, float eps, void* out, void* stream) {
  if (n_frames < 0 || n_fft < 1 || n_depth < n_fft || n_depth % dft::kTileDepth != 0 ||
      n_bins <= 0 || n_bins % dft::kTileBins != 0 || n_mels < 1 || n_mels > dft::kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames == 0) return 0;
  const auto* f = static_cast<const float*>(x);
  const auto* cr = static_cast<const float*>(c_re);
  const auto* ci = static_cast<const float*>(c_im);
  const auto* m0 = static_cast<const float*>(fb);
  const auto* m1 = static_cast<const float*>(fb_norm);
  const auto* l0 = static_cast<const float*>(lag_re);
  const auto* l1 = static_cast<const float*>(lag_im);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (feature_set) {
    case kMel:
      return dft::launch<kMel>(f, channel_stride, frame_stride, cr, ci, m0, m1, l0, l1, o,
                               n_frames, n_fft, n_depth, n_bins, n_mels, amin, eps, s);
    case kMelIv:
      return dft::launch<kMelIv>(f, channel_stride, frame_stride, cr, ci, m0, m1, l0, l1, o,
                                 n_frames, n_fft, n_depth, n_bins, n_mels, amin, eps, s);
    case kMelGcc:
      return dft::launch<kMelGcc>(f, channel_stride, frame_stride, cr, ci, m0, m1, l0, l1, o,
                                  n_frames, n_fft, n_depth, n_bins, n_mels, amin, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
