// K2: the grid loss's softmax region in one pass each way, for Hopper
// (sm_90a).
//
// Replaces seld_tpu/ops/loss_pallas.py::grid_loss_terms (bodies
// `_fwd_kernel` and `_bwd_kernel`). For class-major logits x of shape
// (N, M, G) and a class bitmask of shape (N, G) (bit m set <=> event class
// m active in the cell; 0 <=> background, the last class):
//
//   forward   p       = softmax over m of x[n, :, g]
//             t[m]    = (mask >> m) & 1 for m < M-1,  t[M-1] = (mask == 0)
//             sq[n,g] = sum_m (p[m] - t[m])^2
//             pbg[n,g] = p[M-1]
//   backward  recompute p, r = p - t, c = sum_m r[m] p[m]
//             dx[n,m,g] = g_sq * 2 p[m] (r[m] - c)
//                       + g_bg * p[M-1] (1[m = M-1] - p[m])
//
// What bounds it on an H100: bytes. A cell costs about 14 exp and some
// 100 flops against 4*M + 2 bytes read and 8 written forward (4*M + 10
// read, 4*M written backward): under 2 flops per byte, far below the
// card's f32 balance point (20 flop/B). So the design moves every byte
// once and keeps everything else in registers:
//
//   * one thread per cell (n, g); neighbouring threads take neighbouring
//     g, so each of the M loads x[n, m, g] (and each of the M stores of
//     dx) is one coalesced row segment per warp;
//   * the M logits of the cell stay in registers: the kernels are
//     templates on M, instantiated for every M from 2 to the ceiling of
//     16 and chosen by the launcher from its M argument, so every loop
//     over classes unrolls to straight-line register code;
//   * max, exp, sum, targets from the mask bits and the sums over m are
//     register arithmetic; p is recomputed in the backward, never stored.
//
// expf and a true division (no fast-math, no reciprocal approximation):
// the forward is held to rtol 1e-5 against torch.softmax. Vectorised
// loads, TMA and a persistent grid are the next step; this kernel is the
// simple one.
//
// C interface (bound with ctypes): both launchers run on the given stream
// and return cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for shapes the kernels do not take. In the backward either cotangent
// pointer may be null, which stands for zeros.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 16;

// Loads the cell's M logits (stride G apart) and leaves softmax p[m] in `p`.
template <int M>
__device__ __forceinline__ void softmax_cell(const float* __restrict__ xp, int G,
                                             float (&p)[M]) {
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    p[m] = xp[static_cast<size_t>(m) * G];
    mx = fmaxf(mx, p[m]);
  }
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    p[m] = expf(p[m] - mx);
    sum += p[m];
  }
#pragma unroll
  for (int m = 0; m < M; ++m) p[m] = p[m] / sum;
}

template <int M>
__device__ __forceinline__ float target(unsigned int bits, int m) {
  return (m < M - 1) ? static_cast<float>((bits >> m) & 1u)
                     : (bits == 0u ? 1.f : 0.f);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
grid_loss_fwd_kernel(const float* __restrict__ x,
                     const unsigned short* __restrict__ mask,
                     float* __restrict__ sq, float* __restrict__ pbg,
                     long long n_cells, int G) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_cells) return;
  const long long n = i / G;
  const int g = static_cast<int>(i - n * G);
  float p[M];
  softmax_cell<M>(x + static_cast<size_t>(n) * M * G + g, G, p);
  const unsigned int bits = mask[i];
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float r = p[m] - target<M>(bits, m);
    acc = fmaf(r, r, acc);
  }
  sq[i] = acc;
  pbg[i] = p[M - 1];
}

template <int M>
__global__ void __launch_bounds__(kThreads)
grid_loss_bwd_kernel(const float* __restrict__ x,
                     const unsigned short* __restrict__ mask,
                     const float* __restrict__ g_sq,
                     const float* __restrict__ g_bg, float* __restrict__ dx,
                     long long n_cells, int G) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_cells) return;
  const long long n = i / G;
  const int g = static_cast<int>(i - n * G);
  const size_t base = static_cast<size_t>(n) * M * G + g;
  float p[M];
  softmax_cell<M>(x + base, G, p);
  const unsigned int bits = mask[i];
  const float gs2 = g_sq != nullptr ? 2.f * g_sq[i] : 0.f;
  const float gbp = g_bg != nullptr ? g_bg[i] * p[M - 1] : 0.f;
  float c = 0.f;
#pragma unroll
  for (int m = 0; m < M; ++m) c = fmaf(p[m] - target<M>(bits, m), p[m], c);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float r = p[m] - target<M>(bits, m);
    const float is_bg = (m == M - 1) ? 1.f : 0.f;
    dx[base + static_cast<size_t>(m) * G] = gs2 * p[m] * (r - c) + gbp * (is_bg - p[m]);
  }
}

bool bad_shape(long long n_rows, int M, int G) {
  return n_rows < 0 || M < 2 || M > kMaxClasses || G < 1;
}

unsigned int blocks_for(long long n_cells) {
  return static_cast<unsigned int>((n_cells + kThreads - 1) / kThreads);
}

}  // namespace

// one case per instantiated class count, 2 to kMaxClasses
#define SELD_FOR_EACH_CLASS_COUNT(CASE)                                        \
  CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)     \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

extern "C" int seld_grid_loss_fwd(const void* x, const void* mask, void* sq,
                                  void* pbg, long long n_rows, int M, int G,
                                  void* stream) {
  if (bad_shape(n_rows, M, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_cells = n_rows * G;
  if (n_cells == 0) return 0;
  switch (M) {
#define SELD_FWD_CASE(M_)                                                      \
  case M_:                                                                     \
    grid_loss_fwd_kernel<M_><<<blocks_for(n_cells), kThreads, 0,               \
                               static_cast<cudaStream_t>(stream)>>>(           \
        static_cast<const float*>(x), static_cast<const unsigned short*>(mask),\
        static_cast<float*>(sq), static_cast<float*>(pbg), n_cells, G);        \
    break;
    SELD_FOR_EACH_CLASS_COUNT(SELD_FWD_CASE)
#undef SELD_FWD_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seld_grid_loss_bwd(const void* x, const void* mask,
                                  const void* g_sq, const void* g_bg, void* dx,
                                  long long n_rows, int M, int G, void* stream) {
  if (bad_shape(n_rows, M, G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_cells = n_rows * G;
  if (n_cells == 0) return 0;
  switch (M) {
#define SELD_BWD_CASE(M_)                                                      \
  case M_:                                                                     \
    grid_loss_bwd_kernel<M_><<<blocks_for(n_cells), kThreads, 0,               \
                               static_cast<cudaStream_t>(stream)>>>(           \
        static_cast<const float*>(x), static_cast<const unsigned short*>(mask),\
        static_cast<const float*>(g_sq), static_cast<const float*>(g_bg),      \
        static_cast<float*>(dx), n_cells, G);                                  \
    break;
    SELD_FOR_EACH_CLASS_COUNT(SELD_BWD_CASE)
#undef SELD_BWD_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
