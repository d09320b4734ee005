// The real FFT of one frame in one warp, in registers: the stage that
// kernels K1 (mel_kernel.cu) and K4 (spatial_kernel.cu) share.
//
// A frame of n_fft = 64 R samples is read as the half-length complex
// sequence z[n] = x[2n] + i x[2n+1], M = n_fft / 2 = 32 R points, with the
// Hann window applied as it loads; lane l holds z[l + 32 j] in register j.
// Four-step FFT, n = n1 + 32 n2, k = k2 + R k1: each lane runs the R-point
// DFT over its own R values (R = 8, 16, 32: radix-2 with the plan's
// constants; R = 15 = 3 x 5: prime-factor, no twiddles), multiplies by
// W_M^(n1 k2), then the 32-point DFTs run across the lanes as five radix-2
// stages through __shfl_xor_sync. Lane l then holds Z[r + R bitrev5(l)]
// in register r. The real split takes Z[M - k] from register R - r of
// lane 31 - l (register 0 of another lane for r = 0), one shuffle away:
// X[k] = (Z[k] + conj Z[M-k]) / 2 - (i/2) W_N^k (Z[k] - conj Z[M-k]).
//
// Plan tables (ops/mel_cuda.py::fft_mel_plan, float64 rounded once):
//   window2  (M,)      float2: (w[2n], w[2n+1])
//   lane_tw  (R, 32)   float2: W_M^(lane * k2) at [k2][lane]
//   warp_tw  (4, 32)   float2: stage s (half-width 16 >> s) twiddle of lane,
//                              W_{2h}^(lane mod h) on upper lanes, 1 below
//   split_tw (R, 32)   float2: -(i/2) W_N^k at k = r + R bitrev5(lane), [r][lane]
//   bands    (3, n_mels) int:  first bin, bin count, offset into weights
//   weights  (nnz,)    float:  each band's weights, packed

#pragma once

#include <cuda_runtime.h>

namespace warp_fft {

constexpr int kWarp = 32;

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
__device__ __forceinline__ int brev5(int v) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> 27);
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

// A row of bins 0..M in shared memory: even R pads one word per 32 bins,
// so that the 32 lanes' accesses to the bins of one register (k = r + R
// bitrev5(lane)) land in 32 banks.
template <int R>
struct SpecRow {
  static constexpr int kBins = R * kWarp + 1;
  static constexpr bool kPad = R % 2 == 0;
  static constexpr int kPitch = kBins + (kPad ? (kBins - 1) / kWarp : 0);
  static __device__ __forceinline__ int at(int k) { return k + (kPad ? k / kWarp : 0); }
};

// The Hann-windowed real FFT of the n_fft = 64 R samples at src (float2
// loads when kVec2, else scalar), one warp: calls store(k, re, im) with
// X[k] for the R bins k = r + R bitrev5(lane) the lane holds, and on lane
// 0 also for the Nyquist bin k = M (im = 0).
template <int R, bool kVec2, typename Store>
__device__ __forceinline__ void warp_rfft(const float* __restrict__ src, int lane,
                                          const float2* __restrict__ window2,
                                          const float2* __restrict__ lane_tw,
                                          const float2* __restrict__ warp_tw,
                                          const float2* __restrict__ split_tw,
                                          const RadixConsts& radix, Store&& store) {
  constexpr int M = R * kWarp;
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
  const int k1 = brev5(lane);
  const int src0 = brev5((kWarp - k1) % kWarp);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 a = z[r];
    const float2 p = r == 0 ? shfl2(z[0], src0) : shfl_xor2(z[(R - r) % R], kWarp - 1);
    const float2 sum = make_float2(0.5f * (a.x + p.x), 0.5f * (a.y - p.y));
    const float2 dif = make_float2(a.x - p.x, a.y + p.y);
    const float2 tw = split_tw[r * kWarp + lane];
    const float re = fmaf(tw.x, dif.x, fmaf(-tw.y, dif.y, sum.x));
    const float im = fmaf(tw.x, dif.y, fmaf(tw.y, dif.x, sum.y));
    store(r + R * k1, re, im);
  }
  if (lane == 0) store(M, z[0].x - z[0].y, 0.f);  // Nyquist: Re Z[0] - Im Z[0], real
}

// Sparse filterbank sums of one row, K1's band loop: lane l sums bands l
// and n_mels - 1 - l (the narrow and the wide end, so the lanes' loops
// are about equally long), value(k) over each band's packed bins in
// order, and calls emit(m, sum).
template <typename Value, typename Emit>
__device__ __forceinline__ void band_sums(int lane, int n_mels, const int* __restrict__ bands,
                                          const float* __restrict__ weights, Value&& value,
                                          Emit&& emit) {
  if (lane >= (n_mels + 1) / 2) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int m = which == 0 ? lane : n_mels - 1 - lane;
    if (which == 1 && m == lane) break;
    const int first = __ldg(bands + m);
    const int count = __ldg(bands + n_mels + m);
    const float* wt = weights + __ldg(bands + 2 * n_mels + m);
    float acc = 0.f;
    for (int j = 0; j < count; ++j) acc = fmaf(__ldg(wt + j), value(first + j), acc);
    emit(m, acc);
  }
}

}  // namespace warp_fft
