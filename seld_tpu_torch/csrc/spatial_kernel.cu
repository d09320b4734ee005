// K4: 4-channel STFT frames -> spatial feature stack in one pass, for
// Hopper (sm_90a).
//
// Replaces seld_tpu/ops/spatial_pallas.py::spatial_features_pallas (body
// `_kernel`, constants `_constants`). For a tile of frames of all four
// FOA channels (ACN order W, Y, Z, X) it computes, per 64-bin chunk of
// the spectrum (481 bins zero-padded to 512):
//
//   re_c, im_c = frame_c @ C_re, frame_c @ C_im   (Hann-windowed DFT)
//   p_c        = re_c^2 + im_c^2                  (4 power planes)
//   mel_iv:  energy = (p_W + (p_X + p_Y + p_Z) / 3) / 2 + eps and
//            iv_c = (re_W re_c + im_W im_c) / energy for c = X, Y, Z
//   mel_gcc: for the 6 pairs (i, j) of itertools.combinations(range(4), 2)
//            cr + i ci = conj(S_i) S_j, scaled by rsqrt(cr^2 + ci^2 + eps^2)
//
// and adds the chunk's products with the projection matrices to the
// block's output sums: the 4 power planes onto the mel filterbank FB, the
// intensities onto the column-normalised FB_norm, and the PHAT-normalised
// cross-spectra onto the lag matrices (lag column l is lag l - n_mels/2,
// one-sided weights and 1/n_fft folded in). After the last chunk it
// writes (T, C_out, n_mels), C_out = 4 / 7 / 10: 10*log10(max(., amin))
// for the mel planes and the sums as they are for the rest. Padded bins
// have zero DFT columns and zero projection rows, so they add exactly 0
// (a zero cross-spectrum times rsqrt(eps^2) is 0; zero frames give -100
// dB mels and zero IV/GCC planes, never NaN). Like the TPU kernel it never
// writes a spectrum to device memory.
//
// What bounds it on an H100. The function: per frame it reads 4 x n_fft
// floats and writes C_out x n_mels, 51-54 MB for a 60 s clip; with FFTs
// its least arithmetic is some 0.3 GFLOP, so its floor is those bytes at
// 3.35 TB/s (about 0.015 ms). This kernel's own arithmetic is the DFT as
// float32 GEMMs: 8 x 2 x 960 x 512 FLOP per frame (23.6 GFLOP for 3,001
// frames, 0.35 ms at the 67 TFLOP/s f32 peak), plus 2 x 512 x 64 per
// derived plane (4, 7 or 16 of them). In that form it is compute-bound,
// so the design, like K1's, keeps everything between the frames and the
// features in registers and shared memory:
//
//   * a block owns 16 frames of all 4 channels: 64 DFT rows, frame-major
//     and channel-minor, so the thread that owns frame f holds the 4
//     channels' re/im at its 4 bins in registers and forms the derived
//     planes without an exchange;
//   * per chunk it runs the 64 x (64 + 64) x n_fft product over 16-deep
//     shared-memory tiles, each thread holding 4 channels x 4 bins of re
//     and of im (K1's tiling, with rows that are (frame, channel) pairs);
//   * it writes the chunk's derived planes (4, 7 or 16 of 16 frames x 64
//     bins) and the matching 64 x 64 slices of the projection matrices to
//     shared memory and adds their products to the (16, C_out, 64)
//     output sums, 4 columns of one frame per thread, in registers across
//     all chunks;
//   * the feature set is a template parameter: no branch in a loop.
//
// Shared memory is dynamic: 32 KB (mel), 60 KB (mel_iv), 112 KB
// (mel_gcc: 16 planes of 4 KB and three 16 KB matrix slices), so two
// blocks fit on a multiprocessor in every case. A 60 s clip (T = 3,001)
// is 188 blocks on 132 multiprocessors, one wave at two blocks each.
// The arithmetic is plain f32 FMA on the CUDA cores: the IV and GCC
// planes are held to 1e-4, which TF32 cannot meet; 3xTF32 through wgmma
// and TMA loads are the way to the next factor.
//
// C interface (bound with ctypes): seld_spatial_features(...) launches on
// the given stream and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 4;
constexpr int kTileFrames = 16;                     // frames per block, all 4 channels
constexpr int kRows = kChannels * kTileFrames;      // DFT rows: frame-major, channel-minor
constexpr int kTileBins = 64;                       // spectrum bins per chunk
constexpr int kTileDepth = 16;                      // DFT depth per shared-memory stage
constexpr int kCols = 64;                           // output columns (n_mels / lags padded)
constexpr int kPitch = kRows + 4;                   // padded row of the frame tile
constexpr int kPlane = kTileFrames * kTileBins;     // one derived plane of a chunk
constexpr int kMat = kTileBins * kCols;             // one projection-matrix slice
constexpr int kStaging = kTileDepth * kPitch + 2 * kTileDepth * kTileBins;

// ACN channel order of STARSS22's FOA: W, Y, Z, X.
constexpr int kW = 0, kY = 1, kZ = 2, kX = 3;

enum FeatureSet { kMel = 0, kMelIv = 1, kMelGcc = 2 };

template <int kSet> struct Layout {
  // derived planes per chunk, output planes, projection-matrix slices
  static constexpr int kDerived = kSet == kMel ? 4 : kSet == kMelIv ? 7 : 16;
  static constexpr int kOut = kSet == kMel ? 4 : kSet == kMelIv ? 7 : 10;
  static constexpr int kMats = kSet == kMel ? 1 : kSet == kMelIv ? 2 : 3;
  static constexpr int kSmemFloats = kDerived * kPlane + kMats * kMat;
};

static_assert(kThreads == 4 * kRows, "frame tile load: one float4 each");
static_assert(kThreads * 4 == kTileDepth * kTileBins, "DFT tile load: one float4 each");
static_assert(kThreads == kTileFrames * 16, "16 threads per frame, 4 bins/columns each");
static_assert(kStaging <= kMat, "the DFT staging tiles alias the first matrix slice");

// Plane p of frame f at bin b: the odd frames' halves are swapped so that
// the two frames a warp covers hit different banks.
__device__ __forceinline__ int plane_at(int p, int f, int b) {
  return p * kPlane + f * kTileBins + (b ^ ((f & 1) << 4));
}

template <int kSet>
__global__ void __launch_bounds__(kThreads, 2)
spatial_kernel(const float* __restrict__ frames, long long chan_stride,
               const float* __restrict__ c_re, const float* __restrict__ c_im,
               const float* __restrict__ fb, const float* __restrict__ fb_norm,
               const float* __restrict__ lag_re, const float* __restrict__ lag_im,
               float* __restrict__ out, int n_frames, int n_fft, int n_bins,
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

  // Frame tile load: 64 rows (16 frames x 4 channels) x 16 samples.
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 4;
  const int a_frame = a_row / kChannels;
  const int a_ch = a_row % kChannels;
  const bool a_valid = t0 + a_frame < n_frames;
  const float* a_ptr = frames + a_ch * chan_stride +
                       static_cast<long long>(t0 + a_frame) * n_fft + a_col;
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

    for (int k0 = 0; k0 < n_fft; k0 += kTileDepth) {
      const float4 a = a_valid ? *reinterpret_cast<const float4*>(a_ptr + k0)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      a_s[(a_col + 0) * kPitch + a_row] = a.x;
      a_s[(a_col + 1) * kPitch + a_row] = a.y;
      a_s[(a_col + 2) * kPitch + a_row] = a.z;
      a_s[(a_col + 3) * kPitch + a_row] = a.w;
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
        const int xyz[3] = {kX, kY, kZ};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int c = xyz[q];
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
    const float* srcs[3] = {fb, kSet == kMelIv ? fb_norm : lag_re, lag_im};
#pragma unroll
    for (int m = 0; m < L::kMats; ++m)
#pragma unroll
      for (int r = 0; r < kMat / (4 * kThreads); ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / (kCols / 4);
        const int col = (idx % (kCols / 4)) * 4;
        *reinterpret_cast<float4*>(&mats[m * kMat + row * kCols + col]) =
            *reinterpret_cast<const float4*>(srcs[m] + static_cast<size_t>(b0 + row) * kCols + col);
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
int launch(const float* frames, long long chan_stride, const float* c_re,
           const float* c_im, const float* fb, const float* fb_norm,
           const float* lag_re, const float* lag_im, float* out, int n_frames,
           int n_fft, int n_bins, int n_mels, float amin, float eps,
           cudaStream_t stream) {
  constexpr int smem = Layout<kSet>::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      spatial_kernel<kSet>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spatial_kernel<kSet>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileFrames - 1) / kTileFrames);
  spatial_kernel<kSet><<<grid, kThreads, smem, stream>>>(
      frames, chan_stride, c_re, c_im, fb, fb_norm, lag_re, lag_im, out, n_frames,
      n_fft, n_bins, n_mels, amin, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feature_set: 0 "mel", 1 "mel_iv", 2 "mel_gcc". frames: channel c, frame
// t at frames + c * chan_stride + t * n_fft; fb, fb_norm, lag_re and
// lag_im are (n_bins, 64); out is (n_frames, C_out, n_mels).
extern "C" int seld_spatial_features(int feature_set, const void* frames,
                                     long long chan_stride, const void* c_re,
                                     const void* c_im, const void* fb,
                                     const void* fb_norm, const void* lag_re,
                                     const void* lag_im, void* out, int n_frames,
                                     int n_fft, int n_bins, int n_mels, float amin,
                                     float eps, void* stream) {
  if (n_frames < 0 || n_fft <= 0 || n_fft % kTileDepth != 0 || n_bins <= 0 ||
      n_bins % kTileBins != 0 || n_mels < 1 || n_mels > kCols ||
      chan_stride < static_cast<long long>(n_frames) * n_fft || chan_stride % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames == 0) return 0;
  const auto* f = static_cast<const float*>(frames);
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
      return launch<kMel>(f, chan_stride, cr, ci, m0, m1, l0, l1, o, n_frames, n_fft,
                          n_bins, n_mels, amin, eps, s);
    case kMelIv:
      return launch<kMelIv>(f, chan_stride, cr, ci, m0, m1, l0, l1, o, n_frames, n_fft,
                            n_bins, n_mels, amin, eps, s);
    case kMelGcc:
      return launch<kMelGcc>(f, chan_stride, cr, ci, m0, m1, l0, l1, o, n_frames, n_fft,
                             n_bins, n_mels, amin, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
