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
//   * Real FFT through a half-length complex one: z[n] = x[2n] + i x[2n+1],
//     M = n_fft / 2 = R * 32 points. Lane l loads z[l + 32 j], j < R, as
//     float2 (each warp load is 256 contiguous bytes; scalar loads when the
//     view is not 8-byte aligned) and applies the window as it loads.
//   * Four-step FFT, n = n1 + 32 n2, k = k2 + R k1: each lane runs the
//     R-point DFT over its own R values in registers (R = 8, 16, 32: radix-2
//     with the plan's constants; R = 15 = 3 x 5: prime-factor, no
//     twiddles), multiplies by W_M^(n1 k2), then the 32-point DFTs run
//     across the lanes as five radix-2 stages through __shfl_xor_sync.
//     Lane l then holds Z[r + R bitrev5(l)] in register r.
//   * Real split: Z[M - k] sits in register R - r of lane 31 - l (register
//     0 of another lane for r = 0), one shuffle away; X[k] = (Z[k] +
//     conj Z[M-k]) / 2 - (i/2) W_N^k (Z[k] - conj Z[M-k]), and the lane
//     writes |X[k]|^2 to its warp's row in shared memory.
//   * Mel and log: the filterbank is packed per band (first bin, bin count,
//     weights); each bin lies in at most two HTK bands, so it holds ~2 x
//     481 weights. Lane l sums bands l and n_mels - 1 - l from shared
//     memory and writes their dB: one coalesced row per frame.
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

#include <cstring>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxMels = 64;

// The per-lane R-point DFT's constants, passed by value (constant bank):
// W_R^j for j < R / 2 when R is a power of two; W_3^1, W_5^1, W_5^2 for
// R = 15. W_p^j = (cos(2 pi j / p), -sin(2 pi j / p)).
struct RadixConsts {
  float2 w[16];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }
__host__ __device__ constexpr int bit_reverse(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((v >> i) & 1);
  return r;
}

// Radix-2 decimation in frequency over a[0..R), stage of half-width H and
// the ones below it; leaves X[k] in a[bit_reverse(k)].
template <int R, int H>
struct Dif {
  static __device__ __forceinline__ void run(float2 (&a)[R], const RadixConsts& c) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float2 u = a[b + i];
        const float2 v = a[b + i + H];
        a[b + i] = cadd(u, v);
        const float2 d = csub(u, v);
        a[b + i + H] = i == 0 ? d : cmul(d, c.w[i * (R / (2 * H))]);
      }
    }
    Dif<R, H / 2>::run(a, c);
  }
};
template <int R>
struct Dif<R, 0> {
  static __device__ __forceinline__ void run(float2 (&)[R], const RadixConsts&) {}
};

// 3-point DFT in place, w = W_3^1.
__device__ __forceinline__ void dft3(float2& a0, float2& a1, float2& a2, float2 w) {
  const float2 t = cadd(a1, a2);
  const float2 d = csub(a1, a2);
  const float2 m = make_float2(fmaf(w.x, t.x, a0.x), fmaf(w.x, t.y, a0.y));
  const float2 r = make_float2(-w.y * d.y, w.y * d.x);  // (a1 - a2) * (-i sin)
  a0 = cadd(a0, t);
  a1 = cadd(m, r);
  a2 = csub(m, r);
}

// 5-point DFT in place, w1 = W_5^1, w2 = W_5^2.
__device__ __forceinline__ void dft5(float2 (&a)[5], float2 w1, float2 w2) {
  const float2 s1 = cadd(a[1], a[4]), d1 = csub(a[1], a[4]);
  const float2 s2 = cadd(a[2], a[3]), d2 = csub(a[2], a[3]);
  const float c1 = w1.x, c2 = w2.x, n1 = -w1.y, n2 = -w2.y;
  const float2 p1 = make_float2(fmaf(c2, s2.x, fmaf(c1, s1.x, a[0].x)),
                                fmaf(c2, s2.y, fmaf(c1, s1.y, a[0].y)));
  const float2 p2 = make_float2(fmaf(c1, s2.x, fmaf(c2, s1.x, a[0].x)),
                                fmaf(c1, s2.y, fmaf(c2, s1.y, a[0].y)));
  const float2 q1 = make_float2(fmaf(n2, d2.x, n1 * d1.x), fmaf(n2, d2.y, n1 * d1.y));
  const float2 q2 = make_float2(fmaf(-n1, d2.x, n2 * d1.x), fmaf(-n1, d2.y, n2 * d1.y));
  a[0] = cadd(a[0], cadd(s1, s2));
  a[1] = make_float2(p1.x + q1.y, p1.y - q1.x);  // p1 - i q1
  a[4] = make_float2(p1.x - q1.y, p1.y + q1.x);  // p1 + i q1
  a[2] = make_float2(p2.x + q2.y, p2.y - q2.x);
  a[3] = make_float2(p2.x - q2.y, p2.y + q2.x);
}

// The R-point forward DFT of a lane's registers, natural order in and out.
template <int R>
__device__ __forceinline__ void lane_dft(float2 (&a)[R], const RadixConsts& c) {
  if constexpr (R == 15) {
    // prime-factor 3 x 5: n = (5 n1 + 3 n2) mod 15, k = (10 k1 + 6 k2) mod 15
    float2 t[3][5];
#pragma unroll
    for (int n1 = 0; n1 < 3; ++n1) {
#pragma unroll
      for (int n2 = 0; n2 < 5; ++n2) t[n1][n2] = a[(5 * n1 + 3 * n2) % 15];
      dft5(t[n1], c.w[1], c.w[2]);
    }
#pragma unroll
    for (int k2 = 0; k2 < 5; ++k2) {
      float2 u0 = t[0][k2], u1 = t[1][k2], u2 = t[2][k2];
      dft3(u0, u1, u2, c.w[0]);
      a[(6 * k2) % 15] = u0;
      a[(10 + 6 * k2) % 15] = u1;
      a[(20 + 6 * k2) % 15] = u2;
    }
  } else {
    static_assert((R & (R - 1)) == 0 && R <= 32, "R is 15 or a power of two up to 32");
    Dif<R, R / 2>::run(a, c);
    float2 t[R];
#pragma unroll
    for (int k = 0; k < R; ++k) t[k] = a[bit_reverse(k, ilog2(R))];
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = t[k];
  }
}

__device__ __forceinline__ float2 shfl_xor2(float2 v, int mask) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, mask),
                     __shfl_xor_sync(0xffffffffu, v.y, mask));
}
__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

// Plan tables (built by ops/mel_cuda.py::fft_mel_plan, float64 rounded once):
//   window2  (M,)      float2: (w[2n], w[2n+1])
//   lane_tw  (R, 32)   float2: W_M^(lane * k2) at [k2][lane]
//   warp_tw  (4, 32)   float2: stage s (half-width 16 >> s) twiddle of lane,
//                              W_{2h}^(lane mod h) on upper lanes, 1 below
//   split_tw (R, 32)   float2: -(i/2) W_N^k at k = r + R bitrev5(lane), [r][lane]
//   bands    (3, n_mels) int:  first bin, bin count, offset into weights
//   weights  (nnz,)    float:  each band's weights, packed
template <int R, bool kVec2>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
log_mel_kernel(const float* __restrict__ x, long long channel_stride, long long frame_stride,
               int n_frames, int total, const float2* __restrict__ window2,
               const float2* __restrict__ lane_tw, const float2* __restrict__ warp_tw,
               const float2* __restrict__ split_tw, const int* __restrict__ bands,
               const float* __restrict__ weights, int n_mels, float amin,
               float* __restrict__ out, const __grid_constant__ RadixConsts radix) {
  constexpr int M = R * kWarp;
  // power row of one frame, bins 0..M; even R pads one word per 32 bins so
  // that the 32 lanes' stores of a register land in 32 banks
  constexpr bool kPad = R % 2 == 0;
  constexpr int kPitch = M + (kPad ? M / kWarp : 0) + 1;
  __shared__ float pw_s[kWarpsPerBlock][kPitch];

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int f = blockIdx.x * kWarpsPerBlock + warp;
  if (f >= total) return;  // whole warps only: nothing below syncs the block
  const int ch = f / n_frames;
  const int t = f - ch * n_frames;
  const float* src = x + ch * channel_stride + t * frame_stride;

  float2 z[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = lane + kWarp * j;
    const float2 v = kVec2 ? reinterpret_cast<const float2*>(src)[n]
                           : make_float2(src[2 * n], src[2 * n + 1]);
    const float2 w = window2[n];
    z[j] = make_float2(v.x * w.x, v.y * w.y);
  }

  lane_dft<R>(z, radix);
#pragma unroll
  for (int k2 = 1; k2 < R; ++k2) z[k2] = cmul(z[k2], lane_tw[k2 * kWarp + lane]);

  // 32-point DFTs across the lanes: radix-2 decimation in frequency; the
  // lower lane of a pair keeps u + v, the upper (u - v) * twiddle
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    const float sign = (lane & h) ? -1.f : 1.f;
    const float2 tw = s < 4 ? warp_tw[s * kWarp + lane] : make_float2(1.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 p = shfl_xor2(z[r], h);
      const float2 y = make_float2(fmaf(sign, z[r].x, p.x), fmaf(sign, z[r].y, p.y));
      z[r] = s < 4 ? cmul(y, tw) : y;
    }
  }

  // real split: Z[M - k] is register R - r of lane 31 - lane, or for r = 0
  // register 0 of the lane whose bitrev5 is 32 - bitrev5(lane)
  const int k1 = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
  const int src0 = static_cast<int>(__brev(static_cast<unsigned>((kWarp - k1) % kWarp)) >> 27);
  float* pw = pw_s[warp];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 a = z[r];
    const float2 p = r == 0 ? shfl2(z[0], src0) : shfl_xor2(z[(R - r) % R], kWarp - 1);
    const float2 sum = make_float2(0.5f * (a.x + p.x), 0.5f * (a.y - p.y));
    const float2 dif = make_float2(a.x - p.x, a.y + p.y);
    const float2 tw = split_tw[r * kWarp + lane];
    const float re = fmaf(tw.x, dif.x, fmaf(-tw.y, dif.y, sum.x));
    const float im = fmaf(tw.x, dif.y, fmaf(tw.y, dif.x, sum.y));
    const int k = r + R * k1;
    pw[k + (kPad ? k / kWarp : 0)] = fmaf(re, re, im * im);
  }
  if (lane == 0) {  // Nyquist bin M = Re Z[0] - Im Z[0], real
    const float nyq = z[0].x - z[0].y;
    pw[M + (kPad ? M / kWarp : 0)] = nyq * nyq;
  }
  __syncwarp();

  // lane l: bands l and n_mels - 1 - l
  float* row = out + static_cast<long long>(f) * n_mels;
  if (lane < (n_mels + 1) / 2) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int m = which == 0 ? lane : n_mels - 1 - lane;
      if (which == 1 && m == lane) break;
      const int first = __ldg(bands + m);
      const int count = __ldg(bands + n_mels + m);
      const float* wt = weights + __ldg(bands + 2 * n_mels + m);
      float acc = 0.f;
      for (int j = 0; j < count; ++j) {
        const int k = first + j;
        acc = fmaf(__ldg(wt + j), pw[k + (kPad ? k / kWarp : 0)], acc);
      }
      row[m] = 10.f * log10f(fmaxf(acc, amin));
    }
  }
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
