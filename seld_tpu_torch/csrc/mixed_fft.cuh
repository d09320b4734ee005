// The real FFT of one frame in one warp for a general n_fft, through the
// warp's shared memory: the stage that the mixed-radix kernels of K1
// (mel_kernel.cu) and K4 (spatial_kernel.cu) share.
//
// It takes any even n_fft = 2 M whose half M has no prime factor above 7,
// kMinM = 32 <= M <= kMaxM = 2048 (n_fft 64 to 4096: 1200 at 50 ms and 24
// kHz, 640, 882, 1764, 1920, ...). The floor is K4's: its 64 GCC lags are
// the complex samples z[0..15] and z[M-16..M-1], which must not overlap.
// The register FFT of warp_fft.cuh takes only M = 32 R, R in {8, 15, 16,
// 32}: its cross-lane stage is a 32-point radix-2 FFT, so M = 600 or 441
// cannot be spread over the lanes that way.
//
// As warp_fft.cuh does, the frame is read as the M-point complex sequence
// z[n] = x[2n] + i x[2n+1], the Hann window applied as it loads (float2
// loads when the frame start is 8-byte aligned, else scalar). Then a
// Stockham autosort FFT of M points, one pass per radix of the plan (from
// {2, 3, 4, 5, 7, 8}, largest first): pass s with radix R, after passes
// whose radices multiply to Ns, runs M / R butterflies j,
//
//   v_r  = in[j + r M / R] * W_{Ns R}^(r (j mod Ns))      r = 0 .. R - 1
//   v    = DFT_R(v)
//   out[(j / Ns) Ns R + (j mod Ns) + r Ns] = v_r,
//
// which leaves Z = DFT_M(z) in natural order after the last pass. Every
// twiddle is one entry of the plan's table W_M^j, j < M (W_{Ns R}^(r k) =
// W_M^(r k M / (Ns R)), an index below M). The first pass reads the frame
// from device memory (Ns = 1, no twiddles); the others read one of the
// warp's two buffers of M complex values and write the other, so that a
// lane takes its butterflies j = lane, lane + 32, ... one at a time, with
// R values in registers. (One buffer with each lane's inputs of a whole
// pass staged in registers first, ceil(M / 32) complex values a lane,
// spilled in every instantiation on the H100, with ptxas at 255 registers.)
// A buffer's slot of complex index i is at(i) = i + i / 16: one pad every 16
// values, so that the first passes' writes at stride R (R = 2, 4, 8) and
// the later passes' runs of consecutive indices both meet distinct banks
// within a half-warp.
//
// The real split then reads Z[k] and Z[M - k] from the buffer that holds
// Z and hands X to the caller, who writes it to the other one:
//   X[k] = (Z[k] + conj Z[M-k]) / 2 - (i/2) W_N^k (Z[k] - conj Z[M-k]),
// X[M] = Re Z[0] - Im Z[0]. The kernels sum bins 0..M with warp_fft.cuh's
// band_sums as the register kernels do: the same weights in the same order.
//
// Plan tables (ops/mel_cuda.py::mixed_fft_plan, float64 rounded once):
//   window2  (M,)  float2: (w[2n], w[2n+1])
//   twiddles (M,)  float2: W_M^j
//   split_tw (M,)  float2: -(i/2) W_N^k
//   Plan (by value): M, the radices in order, the butterflies' constants
//   W_3^1, W_5^1, W_5^2, W_7^1, W_7^2, W_7^3, W_8^1.

#pragma once

#include <cuda_runtime.h>

#include "warp_fft.cuh"

namespace mixed_fft {

using warp_fft::cadd;
using warp_fft::cmul;
using warp_fft::csub;
using warp_fft::kWarp;

constexpr int kMinM = 32;
constexpr int kMaxM = 2048;
constexpr int kMaxPasses = 12;

struct Plan {
  int m;
  int n_pass;
  int radix[kMaxPasses];
  float2 c[8];  // W_3^1, W_5^1, W_5^2, W_7^1, W_7^2, W_7^3, W_8^1, unused
};

// Slot of complex index i in a warp's buffer, and the slots of a buffer
// that holds bins 0..M.
__host__ __device__ __forceinline__ int at(int i) { return i + (i >> 4); }
__host__ __device__ constexpr int pitch(int m) { return m + m / 16 + 1; }

// Host side: the plan from the wrapper's radices and constants; false for
// a shape the kernels do not take.
inline bool make_plan(int n_fft, const int* radices, int n_pass, const float* consts,
                      Plan* plan) {
  if (n_fft % 2 != 0 || n_pass < 1 || n_pass > kMaxPasses) return false;
  const int m = n_fft / 2;
  if (m < kMinM || m > kMaxM) return false;
  long long product = 1;
  for (int s = 0; s < n_pass; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) return false;
    product *= r;
    plan->radix[s] = r;
  }
  if (product != m) return false;
  plan->m = m;
  plan->n_pass = n_pass;
  for (int i = 0; i < 8; ++i) plan->c[i] = make_float2(consts[2 * i], consts[2 * i + 1]);
  return true;
}

// 2-, 4-, 7- and 8-point DFTs in place, natural order in and out (3 and 5:
// warp_fft.cuh's dft3 / dft5). X[k] = sum_n a[n] W_R^(n k).
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = csub(a1, a3);
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = make_float2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  a3 = make_float2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// r = sqrt(1/2): W_8^1 = (r, -r)
__device__ __forceinline__ void dft8(float2 (&a)[8], float r) {
  float2 e0 = a[0], e1 = a[2], e2 = a[4], e3 = a[6];
  float2 o0 = a[1], o1 = a[3], o2 = a[5], o3 = a[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2(r * (o1.x + o1.y), r * (o1.y - o1.x));   // * W_8^1
  o2 = make_float2(o2.y, -o2.x);                            // * W_8^2 = -i
  o3 = make_float2(r * (o3.y - o3.x), -r * (o3.x + o3.y));  // * W_8^3
  a[0] = cadd(e0, o0);
  a[4] = csub(e0, o0);
  a[1] = cadd(e1, o1);
  a[5] = csub(e1, o1);
  a[2] = cadd(e2, o2);
  a[6] = csub(e2, o2);
  a[3] = cadd(e3, o3);
  a[7] = csub(e3, o3);
}

// 7-point DFT in place, w_j = W_7^j: with s_j = a_j + a_7-j, d_j = a_j -
// a_7-j, X[k] = p_k - i q_k and X[7 - k] = p_k + i q_k.
__device__ __forceinline__ void dft7(float2 (&a)[7], float2 w1, float2 w2, float2 w3) {
  const float2 s1 = cadd(a[1], a[6]), d1 = csub(a[1], a[6]);
  const float2 s2 = cadd(a[2], a[5]), d2 = csub(a[2], a[5]);
  const float2 s3 = cadd(a[3], a[4]), d3 = csub(a[3], a[4]);
  const float c1 = w1.x, c2 = w2.x, c3 = w3.x, n1 = -w1.y, n2 = -w2.y, n3 = -w3.y;
  auto p = [&](float ca, float cb, float cc) {
    return make_float2(fmaf(cc, s3.x, fmaf(cb, s2.x, fmaf(ca, s1.x, a[0].x))),
                       fmaf(cc, s3.y, fmaf(cb, s2.y, fmaf(ca, s1.y, a[0].y))));
  };
  auto q = [&](float na, float nb, float nc) {
    return make_float2(fmaf(nc, d3.x, fmaf(nb, d2.x, na * d1.x)),
                       fmaf(nc, d3.y, fmaf(nb, d2.y, na * d1.y)));
  };
  const float2 p1 = p(c1, c2, c3), p2 = p(c2, c3, c1), p3 = p(c3, c1, c2);
  const float2 q1 = q(n1, n2, n3), q2 = q(n2, -n3, -n1), q3 = q(n3, -n1, n2);
  a[0] = cadd(a[0], cadd(cadd(s1, s2), s3));
  a[1] = make_float2(p1.x + q1.y, p1.y - q1.x);
  a[6] = make_float2(p1.x - q1.y, p1.y + q1.x);
  a[2] = make_float2(p2.x + q2.y, p2.y - q2.x);
  a[5] = make_float2(p2.x - q2.y, p2.y + q2.x);
  a[3] = make_float2(p3.x + q3.y, p3.y - q3.x);
  a[4] = make_float2(p3.x - q3.y, p3.y + q3.x);
}

template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R], const Plan& p) {
  if constexpr (R == 2) {
    const float2 t = a[0];
    a[0] = cadd(t, a[1]);
    a[1] = csub(t, a[1]);
  } else if constexpr (R == 3) {
    warp_fft::dft3(a[0], a[1], a[2], p.c[0]);
  } else if constexpr (R == 4) {
    dft4(a[0], a[1], a[2], a[3]);
  } else if constexpr (R == 5) {
    warp_fft::dft5(a, p.c[1], p.c[2]);
  } else if constexpr (R == 7) {
    dft7(a, p.c[3], p.c[4], p.c[5]);
  } else {
    static_assert(R == 8, "radices are 2, 3, 4, 5, 7 and 8");
    dft8(a, p.c[6].x);
  }
}

// One Stockham pass of radix R after passes whose radices multiply to ns:
// load(i) gives input i (from a buffer, or from the frame on the first
// pass); the outputs go to dst.
template <int R, typename Load>
__device__ __forceinline__ void pass(float2* dst, int lane, int m, int ns,
                                     const float2* __restrict__ twiddles, const Plan& p,
                                     Load&& load) {
  const int n_bf = m / R;
  const int step = m / (ns * R);
#pragma unroll 2
  for (int j = lane; j < n_bf; j += kWarp) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(j + r * n_bf);
    const int q = j / ns;
    const int k = j - q * ns;
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(twiddles + r * k * step));
    }
    dft<R>(v, p);
    const int base = q * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[at(base + r * ns)] = v[r];
  }
  __syncwarp();
}

template <typename Load>
__device__ __forceinline__ void pass_of(int radix, float2* dst, int lane, int m, int ns,
                                        const float2* __restrict__ twiddles, const Plan& p,
                                        Load&& load) {
  switch (radix) {
    case 2: pass<2>(dst, lane, m, ns, twiddles, p, load); break;
    case 3: pass<3>(dst, lane, m, ns, twiddles, p, load); break;
    case 4: pass<4>(dst, lane, m, ns, twiddles, p, load); break;
    case 5: pass<5>(dst, lane, m, ns, twiddles, p, load); break;
    case 7: pass<7>(dst, lane, m, ns, twiddles, p, load); break;
    default: pass<8>(dst, lane, m, ns, twiddles, p, load); break;
  }
}

// The plan's passes from `first` on (the radices before it multiply to
// ns), the first of them reading `cur`, each writing the other buffer;
// returns the buffer that holds the result.
__device__ __forceinline__ float2* buffer_passes(float2* cur, float2* nxt, int lane, int first,
                                                 int ns, const float2* __restrict__ twiddles,
                                                 const Plan& p) {
  for (int s = first; s < p.n_pass; ++s) {
    const float2* src = cur;
    pass_of(p.radix[s], nxt, lane, p.m, ns, twiddles, p, [src](int i) { return src[at(i)]; });
    ns *= p.radix[s];
    float2* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Z = DFT_M of the Hann-windowed frame at src, in natural order at at(k)
// of a or b (returned), one warp.
__device__ __forceinline__ float2* forward(const float* __restrict__ src, bool vec2,
                                           const float2* __restrict__ window2, float2* a,
                                           float2* b, int lane,
                                           const float2* __restrict__ twiddles, const Plan& p) {
  pass_of(p.radix[0], a, lane, p.m, 1, twiddles, p, [&](int n) {
    const float2 v = vec2 ? reinterpret_cast<const float2*>(src)[n]
                          : make_float2(src[2 * n], src[2 * n + 1]);
    const float2 w = __ldg(window2 + n);
    return make_float2(v.x * w.x, v.y * w.y);
  });
  return buffer_passes(a, b, lane, 1, p.radix[0], twiddles, p);
}

// The real split of Z (natural order in z): emit(k, re, im) with X[k] for
// the bins k = lane + 32 i < M, and on lane 0 also for k = M. emit writes
// to the warp's other buffer; the caller syncs the warp after.
template <typename Emit>
__device__ __forceinline__ void real_split(const float2* z, int lane, int m,
                                           const float2* __restrict__ split_tw, Emit&& emit) {
  for (int k = lane; k < m; k += kWarp) {
    const float2 a = z[at(k)];
    const float2 b = z[at(k == 0 ? 0 : m - k)];
    const float2 sum = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 dif = make_float2(a.x - b.x, a.y + b.y);
    const float2 tw = __ldg(split_tw + k);
    emit(k, fmaf(tw.x, dif.x, fmaf(-tw.y, dif.y, sum.x)),
         fmaf(tw.x, dif.y, fmaf(tw.y, dif.x, sum.y)));
  }
  if (lane == 0) emit(m, z[0].x - z[0].y, 0.f);  // Nyquist: Re Z[0] - Im Z[0]
}

}  // namespace mixed_fft
