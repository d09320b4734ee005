// K3: exact softmax attention without the (T x T) score matrix, forward and
// backward, for Hopper (sm_90a).
//
// Replaces seld_tpu/ops/flash_attention.py::flash_attention (bodies
// `_fwd_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`). For q, k, v of shape
// (B, H, T, Dh), per (batch, head):
//
//   forward   s = q k^T * scale, online softmax over key tiles (running
//             max m, normaliser l, accumulator in registers);
//             out = softmax(s) v,  lse = m + log(l)           (B*H, T) f32
//   dQ        p = exp(s - lse), dp = dO v^T,
//             ds = p (dp - delta) scale,  dq = ds k      (streams K/V tiles)
//   dK/dV     one block per key tile streams Q/dO tiles:
//             dv = p^T dO,  dk = ds^T q
//
// with delta = rowsum(dO * out): in bf16 the dQ kernel forms it from dO
// and out and writes it for dK/dV (or reads it, when the caller gives it);
// in float32 the caller computes it. Scores, softmax and
// every accumulator are float32; the probabilities and ds are rounded to
// the inputs' type before the products that consume them, as in the TPU
// kernels. The one exception is dv = p^T dO, where the TPU kernel keeps p in
// float32: the bf16 kernel feeds p there as a bf16 pair (p rounded, and the
// rounding's remainder, one more product), because the recomputed
// p = exp(s - lse) has no exact entries as the forward's exp(s - max) has,
// and a row's largest p would carry its full bf16 error into dv. Keys at or
// beyond T get -1e30 before the running max; query rows at or beyond T are
// loaded as zeros and never written. Nothing of size (T x T) reaches device
// memory, forward or backward.
//
// What differs from the TPU version: Dh is not padded to 128 lanes and T is
// not padded in device memory; the ragged last tile is masked in the kernel;
// the sequential reduction grid dimension is a loop inside the block, and
// the state lives in registers instead of VMEM scratch. dQ and dK/dV are two
// passes with no atomics, so gradients are bit-reproducible.
//
// What bounds it on an H100: operations. Forward is 4*T*T*Dh flops per
// (batch, head) against 4*T*Dh elements moved: at T = 1000 about 500 flops
// per byte in bf16, above the card's balance point (295 flop/B), and the
// backward more so. The design therefore keeps operands in shared memory
// and all state in registers:
//
//   bf16 fwd  a block of 4 warps owns 64 rows, 16 per warp; K/V tiles of 64
//             rows (32 when Dh > 64) staged in padded shared memory by
//             synchronous 16-byte copies; products are mma.sync m16n8k16
//             (bf16 in, f32 accumulate) on fragments that ldmatrix brings
//             in four 8x8 blocks at a time, transposed on the way where a
//             product runs over the tile's rows; the score fragments are
//             exponentiated in registers and repacked as the A operand of
//             the next product, so p never touches shared memory.
//   bf16 bwd  wgmma on tiles that TMA stages through a ring in 128-byte
//             swizzled shared memory (hopper.cuh; the section below):
//             a warpgroup's 64-row product reads each B tile once, where
//             four mma.sync warps read it four times, and it runs
//             asynchronously; the accumulators are the m16n8k16 C layout
//             per warp, so the same register repacking feeds p and ds to
//             the next product.
//   float32   TF32 cannot hold the forward to 2e-5, so float32 inputs take
//             plain f32 FMA: 4 threads share a row, each holding every
//             fourth float4 of q / dO / the accumulators; dot products are
//             finished with two shuffles. Slow, and exact.
//
// Inputs are addressed by batch / head / time strides (last dim contiguous,
// strides and base 16-byte aligned), so the (B, T, H, Dh) layout the model's
// projections produce is read in place.
//
// C interface (bound with ctypes): every launcher runs on the given stream
// and returns cudaGetLastError() of its launch, cudaErrorInvalidValue for
// a shape or type the kernels do not take, or -1 when libcuda refuses a
// tensor map of the bf16 backward. `strides` holds (batch, head,
// time) element strides, three per tensor, in argument order. dtype: 0 is
// float32, 1 is bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRowsMma = 64;   // rows a block owns in the bf16 kernels
constexpr int kRowsF32 = 32;   // rows a block owns in the float32 kernels
constexpr float kNegInf = -1e30f;

struct Strides {
  long long sb, sh, st;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  float* lse;          // written by the forward, read by the backward
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  int H, T, n_tiles;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_of(const void* p, const Strides& s, int b, int h) {
  return static_cast<const T*>(p) + b * s.sb + h * s.sh;
}

template <typename T>
__device__ __forceinline__ T* head_of(void* p, const Strides& s, int b, int h) {
  return static_cast<T*>(p) + b * s.sb + h * s.sh;
}

// Rows [row0, row0 + ROWS) of a (t_len, DH) matrix with row stride `st` into
// shared memory with row stride LD, 16 bytes per thread and step; rows at or
// beyond t_len become zeros.
template <typename T, int ROWS, int DH, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long st, int row0, int t_len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_len) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * st + c * kVec);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * kVec) = val;
  }
}

// lse and delta of rows [row0, row0 + ROWS) into shared memory; 0 beyond t_len.
template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* lse, const float* delta,
                                               int row0, int t_len) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = row0 + i < t_len;
    lse_s[i] = ok ? lse[row0 + i] : 0.f;
    delta_s[i] = ok ? delta[row0 + i] : 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16. Fragment layout, with g = lane / 4, t = lane % 4:
//   A (16x16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, k x n)       b0 (k = 2t..2t+1, n = g)          b1 (k = 2t+8.., n = g)
//   C (16x8, f32)         c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// Two neighbouring C tiles, rounded to bf16, are one A fragment of the next
// product: a0 = (c0, c1) and a1 = (c2, c3) of tile 2j, a2 and a3 of 2j+1.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory in one ldmatrix: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes, aligned), and receives
// in r[i] its two values of matrix i in fragment order: (row g, columns 2t
// and 2t+1), or with kTrans (rows 2t and 2t+1, column g).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What rounding (lo, hi) to `packed` left over, as a bf16 pair of its own.
__device__ __forceinline__ uint32_t pack_remainder(float lo, float hi, uint32_t packed) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_floats(lo - r.x, hi - r.y);
}

// acc[j] += A[row0 .. row0+16, :DH] * Bt[8j .. 8j+8, :DH]^T for j < NT, both
// operands row major in shared memory with row stride LD.
template <int DH, int NT, int LD>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[NT][4], const bf16* As, int row0,
                                                 const bf16* Bs, int lane) {
  const int r8 = lane & 7, m = lane >> 3;  // this lane's row of matrix m in an ldmatrix
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
    uint32_t a[4];
    ldmatrix_x4<false>(a, As + (row0 + (m & 1) * 8 + r8) * LD + kk * 16 + (m >> 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // B of two n-tiles: (n-tile j, k 0-7), (j, k 8-15), (j+1, k 0-7), (j+1, k 8-15)
      uint32_t b[4];
      ldmatrix_x4<false>(b, Bs + ((j + (m >> 1)) * 8 + r8) * LD + kk * 16 + (m & 1) * 8);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[nd] += P * B for nd < DH / 8: P is 16 x (8 NT) in C-fragment layout,
// rounded to bf16 here; B is (8 NT) x DH, row major in shared memory.
template <int DH, int NT, int LD>
__device__ __forceinline__ void mma_frag_by_tile(float (&acc)[DH / 8][4], const float (&p)[NT][4],
                                                 const bf16* Bs, int lane) {
  const int r8 = lane & 7, m = lane >> 3;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = pack_floats(p[2 * kc + (i >> 1)][2 * (i & 1)], p[2 * kc + (i >> 1)][2 * (i & 1) + 1]);
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; nd += 2) {
      // B of two n-tiles, transposed on the way in: (k 0-7, n-tile nd),
      // (k 8-15, nd), (k 0-7, nd+1), (k 8-15, nd+1)
      uint32_t b[4];
      ldmatrix_x4<true>(b, Bs + (kc * 16 + (m & 1) * 8 + r8) * LD + (nd + (m >> 1)) * 8);
      mma_bf16(acc[nd], a, b[0], b[1]);
      mma_bf16(acc[nd + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// Rows g and g + 8 of a warp's 16 x DH accumulator to device memory as bf16.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long st, const float (&acc)[DH / 8][4],
                                           int row_g, int t_len, int t, float mul0, float mul1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= t_len) continue;
    const float mul = r ? mul1 : mul0;
    bf16* rp = dst + static_cast<long long>(row) * st + 2 * t;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(rp + nd * 8) =
          __floats2bfloat162_rn(acc[nd][2 * r] * mul, acc[nd][2 * r + 1] * mul);
    }
  }
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = DH + 8;
  constexpr int NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRowsMma * LD;
  bf16* Vs = Ks + BN * LD;

  const int bh = blockIdx.x / p.n_tiles;
  const int m0 = (blockIdx.x - bh * p.n_tiles) * kRowsMma;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int T = p.T;
  const bf16* kp = head_of<bf16>(p.k, p.ks, b, h);
  const bf16* vp = head_of<bf16>(p.v, p.vs, b, h);

  load_tile<bf16, kRowsMma, DH, LD>(Qs, head_of<bf16>(p.q, p.qs, b, h), p.qs.st, m0, T);

  float o[DH / 8][4];
  zero(o);
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int n0 = 0; n0 < T; n0 += BN) {
    __syncthreads();
    load_tile<bf16, BN, DH, LD>(Ks, kp, p.ks.st, n0, T);
    load_tile<bf16, BN, DH, LD>(Vs, vp, p.vs.st, n0, T);
    __syncthreads();

    float s[NT][4];
    zero(s);
    mma_rows_by_rows<DH, NT, LD>(s, Qs, wr, Ks, lane);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float val = col < T ? s[j][e] * p.scale : kNegInf;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
    mma_frag_by_tile<DH, NT, LD>(o, s, Vs, lane);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l_run[r]), 1e-30f);
    inv[r] = 1.f / denom;
    const int row = m0 + wr + g + 8 * r;
    if (t == 0 && row < T) p.lse[static_cast<long long>(bh) * T + row] = m_run[r] + logf(denom);
  }
  store_rows<DH>(head_of<bf16>(p.out, p.os, b, h), p.os.st, o, m0 + wr + g, T, t, inv[0], inv[1]);
}

// ---------------------------------------------------------------------------
// bf16 backward: wgmma on TMA-staged tiles (hopper.cuh). A block is two
// consumer warpgroups, each owning 64 of the block's 128 rows, and a
// producer warpgroup, one warp of which loads the block's own rows once
// and then streams the other operand through a ring of kStages tiles: TMA
// fills a stage and counts its bytes on the stage's `full` barrier; the
// 256 consumer threads arrive on its `empty` barrier when their products
// have read it. The producers give their registers to the consumers
// (setmaxnreg 24 / 240): the dK/dV accumulators of a 128-column head need
// them.
//
//   dQ     owns 128 queries (Q, dO); streams K/V tiles of BN keys.
//          S = Q K^T, dP = dO V^T (A and B K-major from shared memory;
//          two commit groups, so p's exponentials run while dP's product
//          does); ds = p (dp - delta) scale, rounded to bf16 in registers;
//          dq += ds K (A from registers, B the K tile read MN-major).
//          Before the loop each warpgroup forms delta = rowsum(dO * out) of
//          its rows in float32 from device memory and writes it for dK/dV,
//          unless the caller gives delta.
//   dK/dV  owns 128 keys (K, V); streams Q/dO tiles of BN queries with
//          their lse and delta, which the producer warp stages beside them.
//          S^T = K Q^T, dP^T = V dO^T; p^T as a bf16 pair (rounded, and the
//          rounding's remainder) into dv += p^T dO; dk += ds^T Q.
//
// p = exp2(s * scale * log2(e) - lse * log2(e)): one FFMA and ex2.approx.
// Dh is read in 64-column TMA boxes (DP = 64 or 128 columns, zero beyond
// Dh); products along Dh take Dh / 16 steps, products into a Dh-wide
// accumulator run over all DP columns, and stores are masked to Dh. Rows
// at or beyond T come in as zeros (TMA's out-of-bounds fill); padded keys
// get p = 0 by index, padded queries contribute nothing because their Q
// and dO rows are zero. The products are 5 per streamed tile in dK/dV (two
// for dv) and 3 in dQ; no atomics.
// ---------------------------------------------------------------------------

constexpr int kBwdConsumers = 256;
constexpr int kBwdThreads = kBwdConsumers + 128;
constexpr int kOwnRows = 128;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct BwdShape {
  static constexpr int DP = DH <= 64 ? 64 : 128;  // columns staged
  static constexpr int NB = DP / 64;              // 64-column boxes a row
  static constexpr int BN = DP == 64 ? 64 : 32;   // rows of a streamed tile
  static constexpr int KS = DH / 16;              // k-steps along Dh
  static constexpr int kOwnBytes = NB * kOwnRows * 128;
  static constexpr int kTileBytes = NB * BN * 128;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = 2 * kOwnBytes + kStages * kStageBytes;
  // full[kStages], empty[kStages], own; then float stats
  static constexpr int kStatsOffset = kBarOffset + (2 * kStages + 1) * 8;
  static constexpr int kSmemBytes = kStatsOffset + 2 * kStages * BN * 4 + kOwnRows * 4 + 1024;
};

struct BwdParams {
  const bf16* out;   // dQ: for delta
  const bf16* dout;  // dQ: for delta
  const float* lse;
  float* delta;  // dQ: written unless delta_given; dK/dV: read
  bf16* d0;      // dq, or dk
  bf16* d1;      // dv
  Strides os, gs, d0s, d1s;
  int H, T, n_row_tiles, n_stream, delta_given;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The producer warp's loads of rows [row0, row0 + rows) of `map` for head
// (b, h), every 64-column box, into `dst` (boxes `box_stride` bytes apart).
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int rows, int box_stride, int h, int b) {
  using S = BwdShape<DH>;
#pragma unroll
  for (int cb = 0; cb < S::NB; ++cb) {
    for (int r = 0; r < rows; r += S::BN) {
      hopper::tma_load_4d(dst + cb * box_stride + r * 128, map, bar, cb * 64, row0 + r, h, b);
    }
  }
}

// A fragments of the next product from a m64nBN accumulator tile: k-step
// kk takes columns 16 kk .. 16 kk + 15.
template <int N>
__device__ __forceinline__ void pack_tile(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_floats(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void pack_tile_remainder(uint32_t (&lo)[N / 16][4],
                                                    const uint32_t (&hi)[N / 16][4],
                                                    const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[kk][i] = pack_remainder(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[kk][i]);
    }
  }
}

// Rows row_g and row_g + 8 of a warpgroup's m64nDP accumulator, columns
// below DH, to device memory as bf16; rows at or beyond t_len are skipped.
template <int DH, int N>
__device__ __forceinline__ void store_acc(bf16* dst, long long st, const float (&acc)[N],
                                          int row_g, int t_len, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= t_len) continue;
    bf16* rp = dst + static_cast<long long>(row) * st + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(rp + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// s (+)= A rows of `own` (this warpgroup's 64) times the streamed tile's
// rows, along Dh: both K-major.
template <int DH>
__device__ __forceinline__ void products_along_dh(float (&s)[BwdShape<DH>::BN / 2], uint32_t own,
                                                  uint32_t tile, int wg) {
  using S = BwdShape<DH>;
#pragma unroll
  for (int kk = 0; kk < S::KS; ++kk) {
    const uint32_t a = own + (kk / 4) * kOwnRows * 128 + wg * 64 * 128 + (kk % 4) * 32;
    const uint32_t b = tile + (kk / 4) * S::BN * 128 + (kk % 4) * 32;
    hopper::wgmma_ss(s, hopper::desc_k_major(a), hopper::desc_k_major(b), kk > 0);
  }
}

template <int DH>
__device__ __forceinline__ uint64_t tile_mn_desc(uint32_t tile, int kk) {
  return hopper::desc_mn_major(tile + kk * 16 * 128, BwdShape<DH>::BN * 128);
}

template <int DH>
struct BwdSmem {
  using S = BwdShape<DH>;
  uint32_t own0, own1, stage0, bars;
  float* stats;  // dK/dV: [kStages][2][BN] (-lse log2 e, delta); dQ: delta of the 128 rows
  unsigned char* base;

  __device__ __forceinline__ explicit BwdSmem(unsigned char* raw) {
    const uint32_t a = hopper::smem_u32(raw);
    base = raw + (((a + 1023) & ~1023u) - a);
    own0 = hopper::smem_u32(base);
    own1 = own0 + S::kOwnBytes;
    stage0 = own0 + 2 * S::kOwnBytes;
    bars = own0 + S::kBarOffset;
    stats = reinterpret_cast<float*>(base + S::kStatsOffset);
  }
  __device__ __forceinline__ uint32_t tile(int stage, int which) const {
    return stage0 + stage * S::kStageBytes + which * S::kTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int stage) const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty(int stage) const {
    return bars + 8 * (kStages + stage);
  }
  __device__ __forceinline__ uint32_t own_bar() const { return bars + 16 * kStages; }
};

// Barrier set-up, then the producer warp: own rows [row0, row0 + 128) of
// maps a0 / a1, then tiles of maps b0 / b1 (with their stats for dK/dV).
// Returns true in the consumer threads.
template <int DH, bool kDkv>
__device__ __forceinline__ bool bwd_pipeline(const BwdSmem<DH>& sm, const BwdParams& p,
                                             const CUtensorMap* a0, const CUtensorMap* a1,
                                             const CUtensorMap* b0, const CUtensorMap* b1,
                                             int bh, int row0) {
  using S = BwdShape<DH>;
  const int b = bh / p.H, h = bh - b * p.H;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(sm.full(s), kDkv ? 32 : 1);
      hopper::mbar_init(sm.empty(s), kBwdConsumers);
    }
    hopper::mbar_init(sm.own_bar(), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < kBwdConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    return true;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
  if (threadIdx.x >= kBwdConsumers + 32) return false;

  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(sm.own_bar(), 2 * S::kOwnBytes);
    load_rows<DH>(sm.own0, a0, sm.own_bar(), row0, kOwnRows, kOwnRows * 128, h, b);
    load_rows<DH>(sm.own1, a1, sm.own_bar(), row0, kOwnRows, kOwnRows * 128, h, b);
  } else if (!kDkv) {
    return false;
  }
  const float* lse = p.lse + static_cast<long long>(bh) * p.T;
  const float* delta = p.delta + static_cast<long long>(bh) * p.T;
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % kStages;
    if (i >= kStages) hopper::mbar_wait(sm.empty(s), ((i / kStages) & 1) ^ 1);
    const int t0 = i * S::BN;
    if (kDkv) {
      float* st = sm.stats + s * 2 * S::BN;
      for (int r = lane; r < S::BN; r += 32) {
        const bool ok = t0 + r < p.T;
        st[r] = ok ? -lse[t0 + r] * kLog2e : 0.f;
        st[S::BN + r] = ok ? delta[t0 + r] : 0.f;
      }
    }
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(sm.full(s), S::kStageBytes);
      load_rows<DH>(sm.tile(s, 0), b0, sm.full(s), t0, S::BN, S::BN * 128, h, b);
      load_rows<DH>(sm.tile(s, 1), b1, sm.full(s), t0, S::BN, S::BN * 128, h, b);
    } else {
      hopper::mbar_arrive(sm.full(s));
    }
  }
  return false;
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, const BwdParams p) {
  using S = BwdShape<DH>;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<DH> sm(smem_raw);
  const int bh = blockIdx.x / p.n_row_tiles;
  const int m0 = (blockIdx.x - bh * p.n_row_tiles) * kOwnRows;
  if (!bwd_pipeline<DH, false>(sm, p, &tq, &tg, &tk, &tv, bh, m0)) return;

  const int T = p.T;
  const int b = bh / p.H, h = bh - b * p.H;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_g = m0 + wg * 64 + (tw >> 5) * 16 + g;  // this thread's rows: row_g, row_g + 8
  const long long at = static_cast<long long>(bh) * T;

  float delta_r[2], nlse_r[2];
  if (p.delta_given) {
#pragma unroll
    for (int r = 0; r < 2; ++r) delta_r[r] = row_g + 8 * r < T ? p.delta[at + row_g + 8 * r] : 0.f;
  } else {
    // two threads a row, Dh / 2 columns each, 8 at a time
    const int row = m0 + wg * 64 + (tw >> 1), half = tw & 1;
    float acc = 0.f;
    if (row < T) {
      const bf16* gr = head_of<bf16>(p.dout, p.gs, b, h) + row * p.gs.st + half * (DH / 2);
      const bf16* orow = head_of<bf16>(p.out, p.os, b, h) + row * p.os.st + half * (DH / 2);
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gr + 8 * c);
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(g2[i]), y = __bfloat1622float2(o2[i]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sm.stats[row - m0] = acc;
      if (row < T) p.delta[at + row] = acc;
    }
    hopper::named_barrier(1 + wg, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) delta_r[r] = sm.stats[row_g + 8 * r - m0];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    nlse_r[r] = row_g + 8 * r < T ? -p.lse[at + row_g + 8 * r] * kLog2e : 0.f;
  }
  const float c = p.scale * kLog2e;

  float acc[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(sm.own_bar(), 0);
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(sm.full(s), (i / kStages) & 1);
    float sc[S::BN / 2], dp[S::BN / 2];
    hopper::wgmma_fence();
    products_along_dh<DH>(sc, sm.own0, sm.tile(s, 0), wg);
    hopper::wgmma_commit();
    products_along_dh<DH>(dp, sm.own1, sm.tile(s, 1), wg);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // S: its exponentials run while dP's product does
    hopper::fence_regs(sc);
    const int n0 = i * S::BN;
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n0 + 8 * j + 2 * t + (e & 1) < T;
        sc[4 * j + e] = ok ? ex2(fmaf(sc[4 * j + e], c, nlse_r[e >> 1])) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < S::BN / 2; ++j) {
      sc[j] = sc[j] * (dp[j] - delta_r[(j >> 1) & 1]) * p.scale;
    }
    uint32_t ds[S::BN / 16][4];
    pack_tile<S::BN>(ds, sc);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::BN / 16; ++kk) {
      hopper::wgmma_rs(acc, ds[kk], tile_mn_desc<DH>(sm.tile(s, 0), kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(sm.empty(s));
  }
  store_acc<DH>(head_of<bf16>(p.d0, p.d0s, b, h), p.d0s.st, acc, row_g, T, t);
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg, const BwdParams p) {
  using S = BwdShape<DH>;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<DH> sm(smem_raw);
  const int bh = blockIdx.x / p.n_row_tiles;
  const int n0 = (blockIdx.x - bh * p.n_row_tiles) * kOwnRows;
  if (!bwd_pipeline<DH, true>(sm, p, &tk, &tv, &tq, &tg, bh, n0)) return;

  const int T = p.T;
  const int b = bh / p.H, h = bh - b * p.H;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_g = n0 + wg * 64 + (tw >> 5) * 16 + g;  // this thread's keys: row_g, row_g + 8
  const bool key_ok[2] = {row_g < T, row_g + 8 < T};
  const float c = p.scale * kLog2e;

  float dk[S::DP / 2], dv[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(sm.own_bar(), 0);
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(sm.full(s), (i / kStages) & 1);
    float st[S::BN / 2], dpt[S::BN / 2];
    hopper::wgmma_fence();
    products_along_dh<DH>(st, sm.own0, sm.tile(s, 0), wg);
    products_along_dh<DH>(dpt, sm.own1, sm.tile(s, 1), wg);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    const float* nlse = sm.stats + s * 2 * S::BN;
    const float* dl = nlse + S::BN;
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float pe = key_ok[e >> 1] ? ex2(fmaf(st[4 * j + e], c, nlse[qc])) : 0.f;
        st[4 * j + e] = pe;
        dpt[4 * j + e] = pe * (dpt[4 * j + e] - dl[qc]) * p.scale;
      }
    }
    uint32_t hi[S::BN / 16][4], lo[S::BN / 16][4], ds[S::BN / 16][4];
    pack_tile<S::BN>(hi, st);
    pack_tile_remainder<S::BN>(lo, hi, st);
    pack_tile<S::BN>(ds, dpt);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::BN / 16; ++kk) {
      const uint64_t g_desc = tile_mn_desc<DH>(sm.tile(s, 1), kk);
      hopper::wgmma_rs(dv, hi[kk], g_desc);
      hopper::wgmma_rs(dv, lo[kk], g_desc);
      hopper::wgmma_rs(dk, ds[kk], tile_mn_desc<DH>(sm.tile(s, 0), kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::mbar_arrive(sm.empty(s));
  }
  store_acc<DH>(head_of<bf16>(p.d0, p.d0s, b, h), p.d0s.st, dk, row_g, T, t);
  store_acc<DH>(head_of<bf16>(p.d1, p.d1s, b, h), p.d1s.st, dv, row_g, T, t);
}

// ---------------------------------------------------------------------------
// float32: plain FMA. Four neighbouring threads share a row; thread `sub`
// of the four holds float4 chunks sub, sub + 4, sub + 8, ... of the row, so
// the four read 16 consecutive floats of a shared-memory row at a time.
// ---------------------------------------------------------------------------

template <int NC>
__device__ __forceinline__ void load_row(float4 (&x)[NC], const float* base, long long st, int row,
                                         int t_len, int sub) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    x[i] = row < t_len ? *reinterpret_cast<const float4*>(
                             base + static_cast<long long>(row) * st + (i * 4 + sub) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NC>
__device__ __forceinline__ void store_row(float* base, long long st, int row, int t_len, int sub,
                                          const float4 (&x)[NC]) {
  if (row >= t_len) return;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    *reinterpret_cast<float4*>(base + static_cast<long long>(row) * st + (i * 4 + sub) * 4) = x[i];
  }
}

template <int NC>
__device__ __forceinline__ void zero4(float4 (&x)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i) x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// This thread's share of <x, row>, where row is a DH-float row in shared memory.
template <int NC>
__device__ __forceinline__ float dot_share(const float4 (&x)[NC], const float* row, int sub) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + (i * 4 + sub) * 4);
    acc = fmaf(x[i].x, y.x, acc);
    acc = fmaf(x[i].y, y.y, acc);
    acc = fmaf(x[i].z, y.z, acc);
    acc = fmaf(x[i].w, y.w, acc);
  }
  return acc;
}

// x += w * row
template <int NC>
__device__ __forceinline__ void axpy_share(float4 (&x)[NC], float w, const float* row, int sub) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 y = *reinterpret_cast<const float4*>(row + (i * 4 + sub) * 4);
    x[i].x = fmaf(w, y.x, x[i].x);
    x[i].y = fmaf(w, y.y, x[i].y);
    x[i].z = fmaf(w, y.z, x[i].z);
    x[i].w = fmaf(w, y.w, x[i].w);
  }
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * DH;

  const int bh = blockIdx.x / p.n_tiles;
  const int m0 = (blockIdx.x - bh * p.n_tiles) * kRowsF32;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = m0 + (threadIdx.x >> 2), sub = threadIdx.x & 3;
  const int T = p.T;
  const float* kp = head_of<float>(p.k, p.ks, b, h);
  const float* vp = head_of<float>(p.v, p.vs, b, h);

  float4 qv[NC], o[NC];
  load_row<NC>(qv, head_of<float>(p.q, p.qs, b, h), p.qs.st, row, T, sub);
  zero4<NC>(o);
  float m_run = kNegInf, l_run = 0.f;

  for (int n0 = 0; n0 < T; n0 += BN) {
    __syncthreads();
    load_tile<float, BN, DH, DH>(Ks, kp, p.ks.st, n0, T);
    load_tile<float, BN, DH, DH>(Vs, vp, p.vs.st, n0, T);
    __syncthreads();

    float s[BN];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float dot = quad_sum(dot_share<NC>(qv, Ks + j * DH, sub));
      s[j] = n0 + j < T ? dot * p.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      o[i].x *= alpha;
      o[i].y *= alpha;
      o[i].z *= alpha;
      o[i].w *= alpha;
    }
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float pe = expf(s[j] - m_new);
      l_tile += pe;
      axpy_share<NC>(o, pe, Vs + j * DH, sub);
    }
    l_run = l_run * alpha + l_tile;
  }

  const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    o[i].x /= denom;
    o[i].y /= denom;
    o[i].z /= denom;
    o[i].w /= denom;
  }
  store_row<NC>(head_of<float>(p.out, p.os, b, h), p.os.st, row, T, sub, o);
  if (sub == 0 && row < T) p.lse[static_cast<long long>(bh) * T + row] = m_run + logf(denom);
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(const Params p) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * DH;

  const int bh = blockIdx.x / p.n_tiles;
  const int m0 = (blockIdx.x - bh * p.n_tiles) * kRowsF32;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = m0 + (threadIdx.x >> 2), sub = threadIdx.x & 3;
  const int T = p.T;
  const float* kp = head_of<float>(p.k, p.ks, b, h);
  const float* vp = head_of<float>(p.v, p.vs, b, h);

  float4 qv[NC], gv[NC], acc[NC];
  load_row<NC>(qv, head_of<float>(p.q, p.qs, b, h), p.qs.st, row, T, sub);
  load_row<NC>(gv, head_of<float>(p.dout, p.gs, b, h), p.gs.st, row, T, sub);
  zero4<NC>(acc);
  const long long at = static_cast<long long>(bh) * T + row;
  const float lse_r = row < T ? p.lse[at] : 0.f;
  const float delta_r = row < T ? p.delta[at] : 0.f;

  for (int n0 = 0; n0 < T; n0 += BN) {
    __syncthreads();
    load_tile<float, BN, DH, DH>(Ks, kp, p.ks.st, n0, T);
    load_tile<float, BN, DH, DH>(Vs, vp, p.vs.st, n0, T);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float sv = quad_sum(dot_share<NC>(qv, Ks + j * DH, sub)) * p.scale;
      const float dpv = quad_sum(dot_share<NC>(gv, Vs + j * DH, sub));
      const float pe = n0 + j < T ? expf(sv - lse_r) : 0.f;
      axpy_share<NC>(acc, pe * (dpv - delta_r) * p.scale, Ks + j * DH, sub);
    }
  }
  store_row<NC>(head_of<float>(p.dq, p.dqs, b, h), p.dqs.st, row, T, sub, acc);
}

template <int DH, int BN>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(const Params p) {
  constexpr int NC = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + BN * DH;
  float* lse_s = Gs + BN * DH;
  float* delta_s = lse_s + BN;

  const int bh = blockIdx.x / p.n_tiles;
  const int n0 = (blockIdx.x - bh * p.n_tiles) * kRowsF32;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = n0 + (threadIdx.x >> 2), sub = threadIdx.x & 3;
  const int T = p.T;
  const float* qp = head_of<float>(p.q, p.qs, b, h);
  const float* gp = head_of<float>(p.dout, p.gs, b, h);
  const float* lse = p.lse + static_cast<long long>(bh) * T;
  const float* delta = p.delta + static_cast<long long>(bh) * T;

  float4 kv[NC], vv[NC], dk[NC], dv[NC];
  load_row<NC>(kv, head_of<float>(p.k, p.ks, b, h), p.ks.st, row, T, sub);
  load_row<NC>(vv, head_of<float>(p.v, p.vs, b, h), p.vs.st, row, T, sub);
  zero4<NC>(dk);
  zero4<NC>(dv);
  const bool key_ok = row < T;

  for (int m0 = 0; m0 < T; m0 += BN) {
    __syncthreads();
    load_tile<float, BN, DH, DH>(Qs, qp, p.qs.st, m0, T);
    load_tile<float, BN, DH, DH>(Gs, gp, p.gs.st, m0, T);
    load_row_stats<BN>(lse_s, delta_s, lse, delta, m0, T);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BN; ++i) {
      const float sv = quad_sum(dot_share<NC>(kv, Qs + i * DH, sub)) * p.scale;
      const float dpv = quad_sum(dot_share<NC>(vv, Gs + i * DH, sub));
      const float pe = key_ok ? expf(sv - lse_s[i]) : 0.f;
      axpy_share<NC>(dv, pe, Gs + i * DH, sub);
      axpy_share<NC>(dk, pe * (dpv - delta_s[i]) * p.scale, Qs + i * DH, sub);
    }
  }
  store_row<NC>(head_of<float>(p.dk, p.dks, b, h), p.dks.st, row, T, sub, dk);
  store_row<NC>(head_of<float>(p.dv, p.dvs, b, h), p.dvs.st, row, T, sub, dv);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Pass { kFwd, kDq, kDkv };

constexpr int kTensorMapRefused = -1;  // libcuda refused a TMA tensor map

constexpr int bn_bf16(int dh) { return dh > 64 ? 32 : 64; }
constexpr int kBnF32 = 32;

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int n_bh, size_t smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(n_bh) * p.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_fwd_bf16(Params p, int n_bh, void* stream) {
  constexpr int BN = bn_bf16(DH);
  constexpr size_t row = (DH + 8) * sizeof(bf16);
  p.n_tiles = (p.T + kRowsMma - 1) / kRowsMma;
  return launch(flash_fwd_bf16_kernel<DH, BN>, p, n_bh, (kRowsMma + 2 * BN) * row, stream);
}

// tensors: q, k, v, dO; geometry: nine values each (hopper::encode_bf16_4d)
template <int DH>
int launch_bwd_bf16(Pass pass, BwdParams p, const void* const* tensors,
                    const long long* geometry, int n_bh, void* stream) {
  using S = BwdShape<DH>;
  auto kernel = pass == kDq ? flash_dq_wgmma_kernel<DH> : flash_dkv_wgmma_kernel<DH>;
  // first a runtime call: it makes the device's context current on this
  // thread (autograd's backward thread may have none yet), which the
  // tensor-map encoding in libcuda needs
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const long long* geo = geometry + 9 * i;
    if (geo[0] != DH || geo[1] != p.T || geo[7] != 64 || geo[8] != S::BN) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (!hopper::encode_bf16_4d(&maps[i], tensors[i], geo)) return kTensorMapRefused;
  }
  p.n_row_tiles = (p.T + kOwnRows - 1) / kOwnRows;
  p.n_stream = (p.T + S::BN - 1) / S::BN;
  const long long blocks = static_cast<long long>(n_bh) * p.n_row_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned int>(blocks), kBwdThreads, S::kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(Pass pass, Params p, int n_bh, void* stream) {
  constexpr int BN = kBnF32;
  constexpr size_t tiles = 2 * BN * DH * sizeof(float);
  p.n_tiles = (p.T + kRowsF32 - 1) / kRowsF32;
  switch (pass) {
    case kFwd:
      return launch(flash_fwd_f32_kernel<DH, BN>, p, n_bh, tiles, stream);
    case kDq:
      return launch(flash_dq_f32_kernel<DH, BN>, p, n_bh, tiles, stream);
    default:
      return launch(flash_dkv_f32_kernel<DH, BN>, p, n_bh, tiles + 2 * BN * sizeof(float), stream);
  }
}

// one case per instantiated head width: the multiples of 16 up to 128
#define SELD_FOR_EACH_HEAD_DIM(CASE) \
  CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)

// The shared checks; 1 if there is nothing to do, 0 to launch, or an error.
int check_shape(int B, int H, int T, int dtype, int* n_bh) {
  if (B < 0 || H < 1 || T < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(B) * H;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *n_bh = static_cast<int>(n);
  return B == 0 || T == 0 ? 1 : 0;
}

// the forward in either dtype, or a float32 backward pass
int dispatch(Pass pass, const Params& p, int B, int Dh, int dtype, void* stream) {
  int n_bh = 0;
  const int rc = check_shape(B, p.H, p.T, dtype, &n_bh);
  if (rc != 0) return rc == 1 ? 0 : rc;
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_)                                                     \
  case DH_:                                                                         \
    return dtype == 1 ? launch_fwd_bf16<DH_>(p, n_bh, stream)                       \
                      : launch_f32<DH_>(pass, p, n_bh, stream);
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bwd_bf16(Pass pass, const BwdParams& p, const void* const* tensors,
                      const long long* geometry, int B, int Dh, void* stream) {
  int n_bh = 0;
  const int rc = check_shape(B, p.H, p.T, 1, &n_bh);
  if (rc != 0) return rc == 1 ? 0 : rc;
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_) \
  case DH_:                     \
    return launch_bwd_bf16<DH_>(pass, p, tensors, geometry, n_bh, stream);
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides strides_at(const long long* strides, int i) {
  return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// dynamic shared memory of a bf16 backward block at head width Dh (the
// same for dQ and dK/dV), or -1 for a width the kernels do not take
extern "C" int seld_flash_attention_bwd_smem_bytes(int Dh) {
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_) \
  case DH_:                     \
    return BwdShape<DH_>::kSmemBytes;
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return -1;
  }
}

// strides: q, k, v, out
extern "C" int seld_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, const long long* strides, int B, int H, int T,
                                        int Dh, float scale, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.os = strides_at(strides, 3);
  p.H = H;
  p.T = T;
  p.scale = scale;
  return dispatch(kFwd, p, B, Dh, dtype, stream);
}

// strides: q, k, v, dout, out, dq; geometry (bf16): q, k, v, dout.
// delta_given = 0: the kernel forms delta from dout and out and writes it
// to `delta` (bf16 only); 1: it reads `delta`.
extern "C" int seld_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* out, const void* lse,
                                           void* delta, void* dq, const long long* strides,
                                           const long long* geometry, int delta_given, int B,
                                           int H, int T, int Dh, float scale, int dtype,
                                           void* stream) {
  if (dtype == 1) {
    BwdParams p{};
    p.out = static_cast<const bf16*>(out);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.d0 = static_cast<bf16*>(dq);
    p.gs = strides_at(strides, 3);
    p.os = strides_at(strides, 4);
    p.d0s = strides_at(strides, 5);
    p.H = H;
    p.T = T;
    p.delta_given = delta_given;
    p.scale = scale;
    const void* tensors[4] = {q, k, v, dout};
    return dispatch_bwd_bf16(kDq, p, tensors, geometry, B, Dh, stream);
  }
  if (!delta_given) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.gs = strides_at(strides, 3);
  p.dqs = strides_at(strides, 5);
  p.H = H;
  p.T = T;
  p.scale = scale;
  return dispatch(kDq, p, B, Dh, dtype, stream);
}

// strides: q, k, v, dout, dk, dv; geometry (bf16): q, k, v, dout
extern "C" int seld_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, const long long* strides,
                                            const long long* geometry, int B, int H, int T, int Dh,
                                            float scale, int dtype, void* stream) {
  if (dtype == 1) {
    BwdParams p{};
    p.lse = static_cast<const float*>(lse);
    p.delta = const_cast<float*>(static_cast<const float*>(delta));
    p.d0 = static_cast<bf16*>(dk);
    p.d1 = static_cast<bf16*>(dv);
    p.d0s = strides_at(strides, 4);
    p.d1s = strides_at(strides, 5);
    p.H = H;
    p.T = T;
    p.delta_given = 1;
    p.scale = scale;
    const void* tensors[4] = {q, k, v, dout};
    return dispatch_bwd_bf16(kDkv, p, tensors, geometry, B, Dh, stream);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.gs = strides_at(strides, 3);
  p.dks = strides_at(strides, 4);
  p.dvs = strides_at(strides, 5);
  p.H = H;
  p.T = T;
  p.scale = scale;
  return dispatch(kDkv, p, B, Dh, dtype, stream);
}
