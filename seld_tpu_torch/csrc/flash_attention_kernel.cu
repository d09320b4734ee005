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
// backward more so. Beside the tensor cores the forward has a second bound
// of the same size: its T*T exponentials, at 16 a clock per SM. The design
// therefore keeps operands in shared memory and all state in registers,
// and runs the exponentials while the tensor cores work:
//
//   bf16      wgmma on tiles that TMA stages through a ring in 128-byte
//             swizzled shared memory (hopper.cuh; the section below): a
//             warpgroup's 64-row product reads each B tile once and runs
//             asynchronously; the accumulators are the m16n8k16 C layout
//             per warp, so p and ds are repacked in registers as the A
//             operand of the next product and never touch shared memory.
//             The forward commits the next tile's scores before this
//             tile's value product and exponentiates them while it runs.
//   float32   TF32 cannot hold the forward to 2e-5, so float32 inputs take
//             plain f32 FMA: 4 threads share a row, each holding every
//             fourth float4 of q / dO / the accumulators; dot products are
//             finished with two shuffles. Slow, and exact.
//
// Inputs are addressed by batch / head / time strides (last dim contiguous,
// strides and base 16-byte aligned), so the (B, T, H, Dh) layout the model's
// projections produce is read in place.
//
// Ring modes (kernel K5, seld_tpu_torch/ops/ring_attention.py; replaces
// seld_tpu/ops/ring_attention.py::ring_flash_attention, whose merge and
// sums the JAX package runs in jnp between the chunk kernels). A ring step
// runs one of these kernels on one time chunk of the keys and folds its
// result into a float32 running state that the block's own rows own, in
// the epilogue, so a step is one launch forward and two backward with no
// other kernel between steps. Two flags: `read` (fold into the state that
// an earlier step wrote) and `final_` (store the result in the inputs'
// dtype; otherwise the state in float32). read = 0, final_ = 1 is K3 itself.
//   forward   the chunk's normalised o stays float32; with read,
//             lse' = logaddexp(lse_run, lse_c) and
//             o = o_run exp(lse_run - lse') + o exp(lse_c - lse'); lse (the
//             running lse) is read and written in place; final_ stores out
//             through the TMA store as K3 does, else o_run in float32.
//   dQ, dK/dV the float32 partial is added to the running sum (read), then
//             stored in float32 or, final_, in the inputs' dtype.
// The float32 state is written with 16-byte stores: the four threads of a
// quad, which share a row of the wgmma accumulator and hold two adjacent
// columns of every 8, swap pairs with their neighbour so each holds four
// adjacent columns (quad_gather), and a quad covers 64 contiguous bytes of
// the row. No shared-memory round trip and no barrier: the state is read
// and written once a step, and its bytes, not the layout, set the cost.
// What bounds a ring step: K3's operations, plus the running state's
// bytes (a design cost; see PERF.md). No atomics: each block owns its
// rows, so the same inputs give the same bits.
//
// C interface (bound with ctypes): every launcher runs on the given stream
// and returns cudaGetLastError() of its launch, cudaErrorInvalidValue for
// a shape or type the kernels do not take, or -1 when libcuda refuses a
// tensor map of a bf16 kernel. `strides` holds (batch, head, time) element
// strides, three per tensor, in argument order (zeros for a tensor not
// given); the launchers encode the bf16 kernels' tensor maps from them
// (seld_flash_attention_tma_geometry returns what they encode). A kernel's
// shared-memory limit is set once per device and the SM count is read once.
// dtype: 0 is float32, 1 is bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // a float32 block
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
  float* run0;  // the ring's float32 state: o (forward), dq, or dk
  float* run1;  // dv's
  Strides qs, ks, vs, os, gs, dqs, dks, dvs, r0s, r1s;
  int H, T, n_tiles;
  int read, final_;  // ring modes (see the top)
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

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What rounding (lo, hi) to `packed` left over, as a bf16 pair of its own.
__device__ __forceinline__ uint32_t pack_remainder(float lo, float hi, uint32_t packed) {
  const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_floats(lo - r.x, hi - r.y);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-staged tiles (hopper.cuh). A block is CW consumer
// warpgroups, each owning 64 of the block's 64 CW rows, and a producer
// warpgroup, one thread of which loads the block's own rows and streams the
// other operands through a ring of stages: TMA fills a stage and counts
// its bytes on the stage's `full` barrier; each consumer warp arrives on
// its `empty` barrier once its products have read it. The producers give
// their registers to the consumers (setmaxnreg): the dK/dV accumulators of
// a 128-column head need 240, the forward's four warpgroups share 112 each.
//
//   forward  persistent, one block per SM walking (head, 64 CW queries)
//            work items; Q in two buffers, so the next item's loads run
//            under this item's last products and its epilogue. Up to
//            Dh = 64 four warpgroups own 256 queries (two and 128 above),
//            so each K/V tile that crosses from L2 serves 256 rows; K/V
//            tiles of 64 keys. S = Q K^T (A and B K-major from shared
//            memory); keys at or beyond T get -1e30; running max m and
//            normaliser l in registers; p = exp2(s * scale * log2(e) -
//            m * scale * log2(e)), rounded to bf16 in registers; o += P V
//            (A from registers, B the V tile read MN-major). Tile j's S
//            product is committed before tile j-1's P V product, so tile
//            j's exponentials run while P V does, and the warpgroups take
//            turns at issuing (named barriers), so one's exponentials run
//            while another's products do; o takes tile j's rescaling once
//            P V has landed. At the end o / max(l, 1e-30) to bf16 through
//            shared memory and a TMA store, and lse = m * scale +
//            log(max(l, 1e-30)).
//   dQ       two warpgroups own 128 queries (Q, dO); streams K/V tiles of
//            BN keys. S = Q K^T, dP = dO V^T (two commit groups, so p's
//            exponentials run while dP's product does); ds = p (dp -
//            delta) scale, rounded to bf16 in registers; dq += ds K (B the
//            K tile read MN-major). Before the loop each warpgroup forms
//            delta = rowsum(dO * out) of its rows in float32 from device
//            memory and writes it for dK/dV, unless the caller gives delta.
//   dK/dV    two warpgroups own 128 keys (K, V); streams Q/dO tiles of BN
//            queries with their lse and delta, which the producer warp
//            stages beside them. S^T = K Q^T, dP^T = V dO^T; p^T as a bf16
//            pair (rounded, and the rounding's remainder) into dv += p^T
//            dO; dk += ds^T Q.
//
// In the backward p = exp2(s * scale * log2(e) - lse * log2(e)): one FFMA
// and ex2.approx. Dh is read in 64-column TMA boxes (DP = 64 or 128
// columns, zero beyond Dh); products along Dh take Dh / 16 steps, products
// into a Dh-wide accumulator run over all DP columns, and stores are
// masked to Dh. Rows at or beyond T come in as zeros (TMA's out-of-bounds
// fill); padded keys get p = 0 by index, padded queries contribute
// nothing to dK/dV because their Q and dO rows are zero, and no row at or
// beyond T is written. The products are 2 per streamed tile in the
// forward, 3 in dQ and 5 in dK/dV (two for dv); no atomics.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// A wgmma kernel's block and shared memory: CW consumer warpgroups owning
// 64 rows each and a producer warpgroup; OWN tiles of the block's own rows
// (loaded in TMA boxes of OWN_BOX rows), then STAGES stages of two BN-row
// tiles of the streamed operands, then the barriers (full[STAGES],
// empty[STAGES], own_full[2], own_empty[2]), then STAT_BYTES of float
// stats. A tile is DP columns as NB 64-column boxes, one after the other,
// each starting at a 1024-byte boundary.
template <int DH, int BN_, int STAGES, int OWN, int STAT_BYTES, int CW = 2, int OWN_BOX = BN_>
struct RingShape {
  static constexpr int DP = DH <= 64 ? 64 : 128;  // columns staged
  static constexpr int NB = DP / 64;              // 64-column boxes a row
  static constexpr int BN = BN_;                  // rows of a streamed tile
  static constexpr int kStages = STAGES;
  static constexpr int KS = DH / 16;              // k-steps along Dh
  static constexpr int kOwnRows = 64 * CW;
  static constexpr int kOwnBox = OWN_BOX;  // rows of a TMA box of the own rows
  static constexpr int kConsumers = 128 * CW;
  static constexpr int kThreads = kConsumers + 128;
  // registers a consumer thread takes (setmaxnreg) when the producer
  // warpgroup gives back all but 24: the block holds what its launch bound
  // gives each thread (65536 / kThreads, in steps of 8); setmaxnreg can only
  // share that out, in steps of 8, at most 240 a thread
  static constexpr int kBlockRegs = 65536 / kThreads / 8 * 8 * kThreads;
  static constexpr int kShared = (kBlockRegs - 128 * 24) / kConsumers / 8 * 8;
  static constexpr int kConsumerRegs = kShared < 240 ? kShared : 240;
  static constexpr int kOwnTiles = OWN;
  static constexpr int kOwnBytes = NB * kOwnRows * 128;
  static constexpr int kTileBytes = NB * BN * 128;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBarOffset = OWN * kOwnBytes + kStages * kStageBytes;
  static constexpr int kStatsOffset = kBarOffset + (2 * kStages + 4) * 8;
  static constexpr int kSmemBytes = kStatsOffset + STAT_BYTES + 1024;
  static_assert(kOwnRows % kOwnBox == 0, "own rows load in whole boxes");
};

// Forward: Q in two buffers, each loaded as one TMA box per 64 columns;
// K/V tiles of 64 keys. Up to Dh = 64 four consumer warpgroups own 256
// queries (112 registers each hold S, P, O and the softmax state); above,
// where O alone takes 64 registers, two own 128.
constexpr int fwd_warpgroups(int dh) { return dh <= 64 ? 4 : 2; }
template <int DH>
using FwdShape = RingShape<DH, 64, 3, 2, 0, fwd_warpgroups(DH), 64 * fwd_warpgroups(DH)>;

constexpr int bwd_bn(int dh) { return dh <= 64 ? 64 : 32; }
constexpr int kBwdStages = 3;

// Backward: Q/dO (dQ) or K/V (dK/dV) owned; tiles of 64 rows, 32 above
// Dh = 64 (the dK/dV accumulators of a 128-column head take the
// registers); stats: dK/dV's [STAGES][2][BN] (-lse log2 e, delta), dQ's
// delta of the 128 rows.
template <int DH>
using BwdShape = RingShape<DH, bwd_bn(DH), kBwdStages, 2, (2 * kBwdStages * bwd_bn(DH) + 128) * 4>;

struct WgmmaParams {
  const bf16* out;   // dQ: for delta
  const bf16* dout;  // dQ: for delta
  float* lse;        // written by the forward (read too with `read`), read by the backward
  float* delta;      // dQ: written unless delta_given; dK/dV: read
  bf16* d0;          // dq or dk (the forward's out goes through its tensor map)
  bf16* d1;          // dv
  float* run0;       // the ring's float32 state: o (forward), dq, or dk
  float* run1;       // dv's
  Strides os, gs, d0s, d1s, r0s, r1s;
  int H, T, n_row_tiles, n_stream, delta_given;
  int read, final_;  // ring modes (see the top)
  int n_items;  // forward: heads x row tiles, the work items of its persistent blocks
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The producer warp's loads of rows [row0, row0 + rows) of `map` for head
// (b, h), every 64-column box, into `dst` (boxes `box_stride` bytes apart),
// in TMA boxes of BOX rows.
template <class S, int BOX>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int rows, int box_stride, int h, int b) {
#pragma unroll
  for (int cb = 0; cb < S::NB; ++cb) {
    for (int r = 0; r < rows; r += BOX) {
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

// The ring modes' float32 state, 16 bytes a thread. In a wgmma accumulator
// thread t of a quad holds columns 8 j + 2 t, + 1 of its rows; swapping a
// pair with the neighbour t ^ 1 gives it four adjacent columns of every 16,
// starting at 16 i + quad_col(t), and the quad 64 contiguous bytes.
__device__ __forceinline__ int quad_col(int t) { return 8 * (t & 1) + 2 * (t & 2); }

// Columns 16 i + quad_col(t) .. + 3 of row half r (row_g + 8 r). Every lane
// of the warp takes part (shuffles).
template <int N>
__device__ __forceinline__ float4 quad_gather(const float (&acc)[N], int r, int i, int t) {
  const bool odd = t & 1;
  const float2 a = make_float2(acc[8 * i + 2 * r], acc[8 * i + 2 * r + 1]);      // j = 2 i
  const float2 b = make_float2(acc[8 * i + 4 + 2 * r], acc[8 * i + 5 + 2 * r]);  // j = 2 i + 1
  const float2 keep = odd ? b : a, give = odd ? a : b;
  const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                 __shfl_xor_sync(0xffffffffu, give.y, 1));
  return odd ? make_float4(got.x, got.y, keep.x, keep.y) : make_float4(keep.x, keep.y, got.x, got.y);
}

// The inverse of quad_gather: x back into the accumulator's own layout.
template <int N>
__device__ __forceinline__ void quad_scatter(float (&acc)[N], int r, int i, int t, float4 x) {
  const bool odd = t & 1;
  const float2 lo = make_float2(x.x, x.y), hi = make_float2(x.z, x.w);
  const float2 keep = odd ? hi : lo, give = odd ? lo : hi;
  const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                 __shfl_xor_sync(0xffffffffu, give.y, 1));
  const float2 a = odd ? got : keep, b = odd ? keep : got;
  acc[8 * i + 2 * r] = a.x;
  acc[8 * i + 2 * r + 1] = a.y;
  acc[8 * i + 4 + 2 * r] = b.x;
  acc[8 * i + 5 + 2 * r] = b.y;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}

// torch.logaddexp's formula, for finite a and b
__device__ __forceinline__ float log_add_exp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

// A backward accumulator (dq, dk or dv of rows row_g, row_g + 8, columns
// below DH) in a ring mode: the running float32 sum `run` plus this
// partial (read), stored in bf16 to `dst` (final_) or in float32 to run.
// read = 0, final_ = 1 is K3's own store.
template <int DH, int N>
__device__ __forceinline__ void store_ring(bf16* dst, long long st, float* run, long long rst,
                                           const float (&acc)[N], int row_g, int t_len, int t,
                                           int read, int final_) {
  if (!read && final_) {
    store_acc<DH>(dst, st, acc, row_g, t_len, t);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row_g + 8 * r;
    const bool ok = row < t_len;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      float4 x = quad_gather(acc, r, i, t);
      const int col = 16 * i + quad_col(t);
      float* rp = run + row * rst + col;
      if (ok && read) x = add4(*reinterpret_cast<const float4*>(rp), x);
      if (ok && final_) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        *reinterpret_cast<uint2*>(dst + row * st + col) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      } else if (ok) {
        *reinterpret_cast<float4*>(rp) = x;
      }
    }
  }
}

// s (+)= A rows of `own` (this warpgroup's 64) times the streamed tile's
// rows, along Dh: both K-major.
template <class S>
__device__ __forceinline__ void products_along_dh(float (&s)[S::BN / 2], uint32_t own,
                                                  uint32_t tile, int wg) {
#pragma unroll
  for (int kk = 0; kk < S::KS; ++kk) {
    const uint32_t a = own + (kk / 4) * S::kOwnRows * 128 + wg * 64 * 128 + (kk % 4) * 32;
    const uint32_t b = tile + (kk / 4) * S::BN * 128 + (kk % 4) * 32;
    hopper::wgmma_ss(s, hopper::desc_k_major(a), hopper::desc_k_major(b), kk > 0);
  }
}

// k-step kk (16 rows) of a streamed tile, read MN-major
template <class S>
__device__ __forceinline__ uint64_t tile_mn_desc(uint32_t tile, int kk) {
  return hopper::desc_mn_major(tile + kk * 16 * 128, S::BN * 128);
}

template <class S>
struct RingSmem {
  uint32_t own0, own1, stage0, bars;
  float* stats;

  __device__ __forceinline__ explicit RingSmem(unsigned char* raw) {
    const uint32_t a = hopper::smem_u32(raw);
    unsigned char* base = raw + (((a + 1023) & ~1023u) - a);
    own0 = hopper::smem_u32(base);
    own1 = own0 + S::kOwnBytes;  // the backward's second owned operand, or Q's second buffer
    stage0 = own0 + S::kOwnTiles * S::kOwnBytes;
    bars = own0 + S::kBarOffset;
    stats = reinterpret_cast<float*>(base + S::kStatsOffset);
  }
  __device__ __forceinline__ uint32_t tile(int stage, int which) const {
    return stage0 + stage * S::kStageBytes + which * S::kTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int stage) const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty(int stage) const {
    return bars + 8 * (S::kStages + stage);
  }
  // own rows in buffer j have landed / are no longer read (the forward
  // keeps two buffers: the next item's Q loads while this item runs)
  __device__ __forceinline__ uint32_t own_full(int j) const {
    return bars + 8 * (2 * S::kStages + j);
  }
  __device__ __forceinline__ uint32_t own_empty(int j) const {
    return bars + 8 * (2 * S::kStages + 2 + j);
  }
  __device__ __forceinline__ uint32_t own(int j) const { return own0 + j * S::kOwnBytes; }
  // A consumer warp is done with a stage: one arrival a warp, after the
  // wgmma_wait by which its products have read the stage.
  __device__ __forceinline__ void release(int stage) const {
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty(stage));
  }
};

// Barrier set-up; then the consumers take their registers from the
// producer warpgroup. Returns true in the consumer threads. `full` counts
// full_count arrivals, `empty` one a consumer warp, `own_empty` one a
// consumer warpgroup.
template <class S>
__device__ __forceinline__ bool ring_setup(const RingSmem<S>& sm, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hopper::mbar_init(sm.full(s), full_count);
      hopper::mbar_init(sm.empty(s), S::kConsumers / 32);
    }
    for (int j = 0; j < 2; ++j) {
      hopper::mbar_init(sm.own_full(j), 1);
      hopper::mbar_init(sm.own_empty(j), S::kConsumers / 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < S::kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs) : "memory");
    return true;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
  return false;
}

// The backward's set-up, then its producer warp: own rows [row0, row0 +
// 128) of maps a0 and a1, then tiles of maps b0 / b1 (with their stats for
// dK/dV). Returns true in the consumer threads.
template <class S, bool kDkv>
__device__ __forceinline__ bool ring_pipeline(const RingSmem<S>& sm, const WgmmaParams& p,
                                              const CUtensorMap* a0, const CUtensorMap* a1,
                                              const CUtensorMap* b0, const CUtensorMap* b1,
                                              int bh, int row0) {
  const int b = bh / p.H, h = bh - b * p.H;
  if (ring_setup<S>(sm, kDkv ? 32 : 1)) return true;
  if (threadIdx.x >= S::kConsumers + 32) return false;

  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(sm.own_full(0), 2 * S::kOwnBytes);
    load_rows<S, S::kOwnBox>(sm.own0, a0, sm.own_full(0), row0, S::kOwnRows, S::kOwnRows * 128,
                             h, b);
    load_rows<S, S::kOwnBox>(sm.own1, a1, sm.own_full(0), row0, S::kOwnRows, S::kOwnRows * 128,
                             h, b);
  } else if (!kDkv) {
    return false;
  }
  const float* lse = p.lse + static_cast<long long>(bh) * p.T;
  const float* delta = p.delta + static_cast<long long>(bh) * p.T;
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % S::kStages;
    if (i >= S::kStages) hopper::mbar_wait(sm.empty(s), ((i / S::kStages) & 1) ^ 1);
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
      load_rows<S, S::BN>(sm.tile(s, 0), b0, sm.full(s), t0, S::BN, S::BN * 128, h, b);
      load_rows<S, S::BN>(sm.tile(s, 1), b1, sm.full(s), t0, S::BN, S::BN * 128, h, b);
    } else {
      hopper::mbar_arrive(sm.full(s));
    }
  }
  return false;
}

// The forward's online softmax of one tile of raw scores s (this thread's
// rows row_g and row_g + 8, keys n0 + 8 j + 2 t + e % 2 for s[4 j + e]):
// masks keys at or beyond t_len, moves the running max m, returns in
// alpha what the earlier tiles' sums must be scaled by, and leaves p in s
// and its sum in l. Maxima and sums run in four and two independent
// chains a row: two warps a scheduler hide little latency.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int n0, int t_len, int t,
                                               float c) {
  if (n0 + BN > t_len) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + 8 * j + 2 * t + (e & 1) >= t_len) s[4 * j + e] = kNegInf;
      }
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r][0] = mx[r][1] = mx[r][2] = mx[r][3] = m[r];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    float& x = mx[(j >> 1) & 1][(j & 1) | ((j >> 1) & 2)];
    x = fmaxf(x, s[j]);
  }
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = quad_max(fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])));
    alpha[r] = ex2((m[r] - m_new) * c);
    m[r] = m_new;
    nm[r] = -m_new * c;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const float pe = ex2(fmaf(s[j], c, nm[(j >> 1) & 1]));
    s[j] = pe;
    sum[(j >> 1) & 1][j & 1] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r][0] + sum[r][1]);
}

// o += P V for one streamed tile: P from registers, V MN-major.
template <class S>
__device__ __forceinline__ void values_product(float (&o)[S::DP / 2],
                                               const uint32_t (&pa)[S::BN / 16][4],
                                               uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < S::BN / 16; ++kk) {
    hopper::wgmma_rs(o, pa[kk], tile_mn_desc<S>(v_tile, kk));
  }
}

// The forward's epilogue in a ring mode, for this thread's rows row0 and
// row0 + 8: the chunk's normalised o and its lse_c, folded into the running
// (o_run, lse) with `read`; lse (the head's row) written back. With
// final_ the result goes back into o for the out store (to be stored as
// it is), else to o_run in float32.
template <int DH, int N>
__device__ __forceinline__ void fwd_ring_epilogue(float (&o)[N], const float (&m)[2],
                                                  const float (&l)[2], float scale, float* lse,
                                                  float* run, long long rst, int row0, int t_len,
                                                  int t, int read, int final_) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    const float inv = 1.f / denom;
    const int row = row0 + 8 * r;
    const bool ok = row < t_len;
    const float lse_c = m[r] * scale + logf(denom);
    float lse_new = lse_c, w_run = 0.f, w_c = 1.f;
    if (read && ok) {
      const float lse_run = lse[row];
      lse_new = log_add_exp(lse_run, lse_c);
      w_run = expf(lse_run - lse_new);
      w_c = expf(lse_c - lse_new);
    }
    float* rp = run + static_cast<long long>(row) * rst;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      float4 x = scale4(quad_gather(o, r, i, t), inv);
      const int col = 16 * i + quad_col(t);
      if (read && ok) {
        x = add4(scale4(*reinterpret_cast<const float4*>(rp + col), w_run), scale4(x, w_c));
      }
      if (final_) {
        quad_scatter(o, r, i, t, x);
      } else if (ok) {
        *reinterpret_cast<float4*>(rp + col) = x;
      }
    }
    __syncwarp();  // every lane of the quad has read lse[row]
    if (t == 0 && ok) lse[row] = lse_new;
  }
}

// The consumer warpgroups take turns issuing their products (named
// barriers kFwdTurn + wg, round robin), so that one's exponentials run
// while another's products do; kFwdStoreBar + wg: a warpgroup's out tile
// is in shared memory.
constexpr int kFwdTurn = 1;
constexpr int kFwdStoreBar = 8;

// The forward's producer thread: for each work item of this block (a head
// and 64 CW of its queries; items blockIdx.x, + gridDim.x, ...) Q into
// buffer n % 2 once the item before last has let it go, then the head's
// K/V tiles through the ring, which runs on across items.
template <class S>
__device__ __forceinline__ void fwd_producer(const RingSmem<S>& sm, const WgmmaParams& p,
                                             const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv) {
  int tile = 0;
  for (int n = 0, item = blockIdx.x; item < p.n_items; ++n, item += gridDim.x) {
    const int bh = item / p.n_row_tiles;
    const int m0 = (item - bh * p.n_row_tiles) * S::kOwnRows;
    const int b = bh / p.H, h = bh - b * p.H;
    const int buf = n & 1;
    if (n >= 2) hopper::mbar_wait(sm.own_empty(buf), ((n >> 1) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(sm.own_full(buf), S::kOwnBytes);
    load_rows<S, S::kOwnBox>(sm.own(buf), tq, sm.own_full(buf), m0, S::kOwnRows,
                             S::kOwnRows * 128, h, b);
    for (int i = 0; i < p.n_stream; ++i, ++tile) {
      const int s = tile % S::kStages;
      if (tile >= S::kStages) hopper::mbar_wait(sm.empty(s), ((tile / S::kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(sm.full(s), S::kStageBytes);
      load_rows<S, S::BN>(sm.tile(s, 0), tk, sm.full(s), i * S::BN, S::BN, S::BN * 128, h, b);
      load_rows<S, S::BN>(sm.tile(s, 1), tv, sm.full(s), i * S::BN, S::BN, S::BN * 128, h, b);
    }
  }
}

// Persistent: a block per SM walks the work items (see fwd_producer); the
// next item's Q and first K/V tiles load while this item's last products
// and its epilogue run.
template <int DH>
__global__ void __launch_bounds__(FwdShape<DH>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tout, const WgmmaParams p) {
  using S = FwdShape<DH>;
  constexpr int CW = S::kOwnRows / 64;  // consumer warpgroups
  extern __shared__ unsigned char smem_raw[];
  const RingSmem<S> sm(smem_raw);
  if (!ring_setup<S>(sm, 1)) {
    if (threadIdx.x == S::kConsumers) fwd_producer<S>(sm, p, &tq, &tk, &tv);
    return;
  }

  const int T = p.T;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row_w = wg * 64 + (tw >> 5) * 16 + (lane >> 2);  // rows row_w, row_w + 8 of a block
  const float c = p.scale * kLog2e;

  int tile = 0;  // K/V tiles this block has taken from the ring
  for (int n = 0, item = blockIdx.x; item < p.n_items; ++n, item += gridDim.x, tile += p.n_stream) {
    const int bh = item / p.n_row_tiles;
    const int m0 = (item - bh * p.n_row_tiles) * S::kOwnRows;
    const int b = bh / p.H, h = bh - b * p.H;
    const uint32_t q_tile = sm.own(n & 1);

    float o[S::DP / 2], s[S::BN / 2];
#pragma unroll
    for (int i = 0; i < S::DP / 2; ++i) o[i] = 0.f;
    uint32_t pa[S::BN / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

    hopper::mbar_wait(sm.own_full(n & 1), (n >> 1) & 1);
    if (wg == CW - 1 && p.n_stream > 1) hopper::named_barrier_arrive(kFwdTurn, 256);
    hopper::mbar_wait(sm.full(tile % S::kStages), (tile / S::kStages) & 1);
    hopper::wgmma_fence();
    products_along_dh<S>(s, q_tile, sm.tile(tile % S::kStages, 0), wg);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    online_softmax<S::BN>(s, m, l, alpha, 0, T, t, c);
    pack_tile<S::BN>(pa, s);
    for (int i = 1; i < p.n_stream; ++i) {
      const int st = (tile + i) % S::kStages, prev = (tile + i - 1) % S::kStages;
      hopper::mbar_wait(sm.full(st), ((tile + i) / S::kStages) & 1);
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      hopper::named_barrier(kFwdTurn + wg, 256);  // this warpgroup's turn
      hopper::wgmma_fence();
      products_along_dh<S>(s, q_tile, sm.tile(st, 0), wg);
      hopper::wgmma_commit();
      values_product<S>(o, pa, sm.tile(prev, 1));
      hopper::wgmma_commit();
      if (wg < CW - 1 || i + 1 < p.n_stream) {  // the next one's turn
        hopper::named_barrier_arrive(kFwdTurn + (wg + 1) % CW, 256);
      }
      hopper::wgmma_wait<1>();  // S of tile i: its exponentials run while P V does
      hopper::fence_regs(s);
      online_softmax<S::BN>(s, m, l, alpha, i * S::BN, T, t, c);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      sm.release(prev);
#pragma unroll
      for (int j = 0; j < S::DP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      pack_tile<S::BN>(pa, s);
    }
    const int last = (tile + p.n_stream - 1) % S::kStages;
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    hopper::wgmma_fence();
    values_product<S>(o, pa, sm.tile(last, 1));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    sm.release(last);

    const long long at = static_cast<long long>(bh) * T;
    float inv[2];
    if (!p.read && p.final_) {  // K3
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
        inv[r] = 1.f / denom;
        const int row = m0 + row_w + 8 * r;
        if (t == 0 && row < T) p.lse[at + row] = m[r] * p.scale + logf(denom);
      }
    } else {
      if (!p.final_) {  // no out tile to stage: the Q buffer goes back now
        hopper::named_barrier(kFwdStoreBar + wg, 128);
        if (tw == 0) hopper::mbar_arrive(sm.own_empty(n & 1));
      }
      fwd_ring_epilogue<DH>(o, m, l, p.scale, p.lse + at, head_of<float>(p.run0, p.r0s, b, h),
                            p.r0s.st, m0 + row_w, T, t, p.read, p.final_);
      if (!p.final_) continue;
      inv[0] = inv[1] = 1.f;  // o holds the merged, normalised rows
    }
    // out through shared memory and one TMA store per 64-column box: this
    // warpgroup's 64 rows of the Q buffer are free once its S products are
    // done; written in the maps' 128-byte swizzle (conflict-free: the 8 rows
    // of a store instruction land in 8 different 16-byte chunks), and TMA
    // leaves out rows at or beyond T and columns at or beyond Dh. The
    // buffer goes back to the producer once the stores have read it.
#pragma unroll
    for (int j = 0; j < S::DP / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_w + 8 * r;
        const uint32_t chunk = static_cast<uint32_t>((j & 7) ^ (row & 7));
        const uint32_t at_smem = q_tile + (j >> 3) * S::kOwnRows * 128 + row * 128 + chunk * 16;
        hopper::st_shared_u32(at_smem + 4 * t, pack_floats(o[4 * j + 2 * r] * inv[r],
                                                           o[4 * j + 2 * r + 1] * inv[r]));
      }
    }
    hopper::fence_async_shared();
    hopper::named_barrier(kFwdStoreBar + wg, 128);
    if (tw == 0) {
#pragma unroll
      for (int cb = 0; cb < S::NB; ++cb) {
        hopper::tma_store_4d(&tout, q_tile + cb * S::kOwnRows * 128 + wg * 64 * 128, cb * 64,
                             m0 + wg * 64, h, b);
      }
      hopper::tma_store_wait_read();
      hopper::mbar_arrive(sm.own_empty(n & 1));
    }
  }
}

// kRing: the ring modes' store (store_ring); K3's own launches take the
// instantiation without it. Choosing the store at run time made K3's dQ
// kernel 3 % slower on the card than with store_acc alone; this
// instantiation times as the earlier kernel did (PERF.md, section 6).
template <int DH, bool kRing>
__global__ void __launch_bounds__(BwdShape<DH>::kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, const WgmmaParams p) {
  using S = BwdShape<DH>;
  extern __shared__ unsigned char smem_raw[];
  const RingSmem<S> sm(smem_raw);
  const int bh = blockIdx.x / p.n_row_tiles;
  const int m0 = (blockIdx.x - bh * p.n_row_tiles) * S::kOwnRows;
  if (!ring_pipeline<S, false>(sm, p, &tq, &tg, &tk, &tv, bh, m0)) return;

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
  hopper::mbar_wait(sm.own_full(0), 0);
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % S::kStages;
    hopper::mbar_wait(sm.full(s), (i / S::kStages) & 1);
    float sc[S::BN / 2], dp[S::BN / 2];
    hopper::wgmma_fence();
    products_along_dh<S>(sc, sm.own0, sm.tile(s, 0), wg);
    hopper::wgmma_commit();
    products_along_dh<S>(dp, sm.own1, sm.tile(s, 1), wg);
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
      hopper::wgmma_rs(acc, ds[kk], tile_mn_desc<S>(sm.tile(s, 0), kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    sm.release(s);
  }
  if constexpr (kRing) {
    store_ring<DH>(head_of<bf16>(p.d0, p.d0s, b, h), p.d0s.st,
                   head_of<float>(p.run0, p.r0s, b, h), p.r0s.st, acc, row_g, T, t, p.read,
                   p.final_);
  } else {
    store_acc<DH>(head_of<bf16>(p.d0, p.d0s, b, h), p.d0s.st, acc, row_g, T, t);
  }
}

template <int DH>
__global__ void __launch_bounds__(BwdShape<DH>::kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg, const WgmmaParams p) {
  using S = BwdShape<DH>;
  extern __shared__ unsigned char smem_raw[];
  const RingSmem<S> sm(smem_raw);
  const int bh = blockIdx.x / p.n_row_tiles;
  const int n0 = (blockIdx.x - bh * p.n_row_tiles) * S::kOwnRows;
  if (!ring_pipeline<S, true>(sm, p, &tk, &tv, &tq, &tg, bh, n0)) return;

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
  hopper::mbar_wait(sm.own_full(0), 0);
  for (int i = 0; i < p.n_stream; ++i) {
    const int s = i % S::kStages;
    hopper::mbar_wait(sm.full(s), (i / S::kStages) & 1);
    float st[S::BN / 2], dpt[S::BN / 2];
    hopper::wgmma_fence();
    products_along_dh<S>(st, sm.own0, sm.tile(s, 0), wg);
    products_along_dh<S>(dpt, sm.own1, sm.tile(s, 1), wg);
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
      const uint64_t g_desc = tile_mn_desc<S>(sm.tile(s, 1), kk);
      hopper::wgmma_rs(dv, hi[kk], g_desc);
      hopper::wgmma_rs(dv, lo[kk], g_desc);
      hopper::wgmma_rs(dk, ds[kk], tile_mn_desc<S>(sm.tile(s, 0), kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    sm.release(s);
  }
  store_ring<DH>(head_of<bf16>(p.d0, p.d0s, b, h), p.d0s.st, head_of<float>(p.run0, p.r0s, b, h),
                 p.r0s.st, dk, row_g, T, t, p.read, p.final_);
  store_ring<DH>(head_of<bf16>(p.d1, p.d1s, b, h), p.d1s.st, head_of<float>(p.run1, p.r1s, b, h),
                 p.r1s.st, dv, row_g, T, t, p.read, p.final_);
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
  const long long at = static_cast<long long>(bh) * T + row;
  float lse_new = m_run + logf(denom);
  if (p.read && row < T) {  // fold into the ring's running (o_run, lse)
    const float lse_c = lse_new, lse_run = p.lse[at];
    lse_new = log_add_exp(lse_run, lse_c);
    const float w_run = expf(lse_run - lse_new), w_c = expf(lse_c - lse_new);
    float4 y[NC];
    load_row<NC>(y, head_of<float>(p.run0, p.r0s, b, h), p.r0s.st, row, T, sub);
#pragma unroll
    for (int i = 0; i < NC; ++i) o[i] = add4(scale4(y[i], w_run), scale4(o[i], w_c));
  }
  if (p.final_) {
    store_row<NC>(head_of<float>(p.out, p.os, b, h), p.os.st, row, T, sub, o);
  } else {
    store_row<NC>(head_of<float>(p.run0, p.r0s, b, h), p.r0s.st, row, T, sub, o);
  }
  __syncwarp();  // every lane of the row has read lse[at]
  if (sub == 0 && row < T) p.lse[at] = lse_new;
}

// A float32 backward accumulator in a ring mode: the running sum plus this
// partial (read), stored to dst (final_) or to the running sum.
template <int NC>
__device__ __forceinline__ void store_row_ring(float* dst, long long st, float* run, long long rst,
                                               int row, int t_len, int sub, float4 (&x)[NC],
                                               int read, int final_) {
  if (read) {
    float4 y[NC];
    load_row<NC>(y, run, rst, row, t_len, sub);
#pragma unroll
    for (int i = 0; i < NC; ++i) x[i] = add4(y[i], x[i]);
  }
  if (final_) {
    store_row<NC>(dst, st, row, t_len, sub, x);
  } else {
    store_row<NC>(run, rst, row, t_len, sub, x);
  }
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
  store_row_ring<NC>(head_of<float>(p.dq, p.dqs, b, h), p.dqs.st,
                     head_of<float>(p.run0, p.r0s, b, h), p.r0s.st, row, T, sub, acc, p.read,
                     p.final_);
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
  store_row_ring<NC>(head_of<float>(p.dk, p.dks, b, h), p.dks.st,
                     head_of<float>(p.run0, p.r0s, b, h), p.r0s.st, row, T, sub, dk, p.read,
                     p.final_);
  store_row_ring<NC>(head_of<float>(p.dv, p.dvs, b, h), p.dvs.st,
                     head_of<float>(p.run1, p.r1s, b, h), p.r1s.st, row, T, sub, dv, p.read,
                     p.final_);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Pass { kFwd, kDq, kDkv };

constexpr int kTensorMapRefused = -1;  // libcuda refused a TMA tensor map
constexpr int kMaxDevices = 64;

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

// A bf16 kernel's devices on which its dynamic shared-memory limit is set.
struct KernelState {
  std::atomic<unsigned long long> limit_set{0};
};

// The devices on which this thread has made that runtime call: it makes
// the device's context current on the thread, which libcuda's tensor-map
// encoding needs (autograd's backward thread may have none yet).
thread_local unsigned long long t_context_bound = 0;

// The calling thread's device, with the kernel's limit set there once (and
// the call made once per thread and device).
template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes, KernelState& state, int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*device < 0 || *device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned long long bit = 1ull << *device;
  if ((state.limit_set.load(std::memory_order_acquire) & bit) && (t_context_bound & bit)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  state.limit_set.fetch_or(bit, std::memory_order_release);
  t_context_bound |= bit;
  return 0;
}

// The device's SM count, read once.
int sm_count(int device, int* sms) {
  static std::atomic<int> cache[kMaxDevices];
  *sms = cache[device].load(std::memory_order_relaxed);
  if (*sms > 0) return 0;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cache[device].store(*sms, std::memory_order_relaxed);
  return 0;
}

// The TMA tensor map of a bf16 (B, H, T, Dh) view with element strides s =
// (batch, head, time), as ops/flash_attention.py::tma_geometry computes it:
// dims innermost first (Dh, T, H, B), the byte strides of T, H and B (a dim
// of size 1 with stride 0 gets 16: TMA takes positive multiples of 16 and
// never steps over it), the box of 64 columns and box_rows rows.
void tma_geometry(long long (&geo)[9], const long long* s, int B, int H, int T, int Dh,
                  int box_rows) {
  geo[0] = Dh;
  geo[1] = T;
  geo[2] = H;
  geo[3] = B;
  geo[4] = s[2] != 0 || T > 1 ? s[2] * 2 : 16;
  geo[5] = s[1] != 0 || H > 1 ? s[1] * 2 : 16;
  geo[6] = s[0] != 0 || B > 1 ? s[0] * 2 : 16;
  geo[7] = 64;
  geo[8] = box_rows;
}

// The box rows of a bf16 pass's four maps: q, k, v, and out (forward) or dO.
template <int DH>
void box_rows(Pass pass, int (&rows)[4]) {
  if (pass == kFwd) {  // q: the block's rows; out: a warpgroup's
    using S = FwdShape<DH>;
    rows[0] = S::kOwnBox;
    rows[1] = rows[2] = S::BN;
    rows[3] = 64;
  } else {
    rows[0] = rows[1] = rows[2] = rows[3] = BwdShape<DH>::BN;
  }
}

// A bf16 launch: the maps of tensors q, k, v and out (forward) or dO
// (backward), encoded from the first four (batch, head, time) strides.
template <class S, int DH, typename Kernel>
int launch_wgmma(Kernel kernel, KernelState& state, Pass pass, WgmmaParams p,
                 const void* const* tensors, const long long* strides, int B, int n_bh,
                 bool persistent, void* stream) {
  int device = 0;
  int rc = prepare(kernel, S::kSmemBytes, state, &device);
  if (rc != 0) return rc;
  int rows[4];
  box_rows<DH>(pass, rows);
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    long long geo[9];
    tma_geometry(geo, strides + 3 * i, B, p.H, p.T, DH, rows[i]);
    if (!hopper::encode_bf16_4d(&maps[i], tensors[i], geo)) return kTensorMapRefused;
  }
  p.n_row_tiles = (p.T + S::kOwnRows - 1) / S::kOwnRows;
  p.n_stream = (p.T + S::BN - 1) / S::BN;
  long long blocks = static_cast<long long>(n_bh) * p.n_row_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (persistent) {  // one block per SM, each walking its share of the items
    p.n_items = static_cast<int>(blocks);
    int sms = 0;
    rc = sm_count(device, &sms);
    if (rc != 0) return rc;
    blocks = blocks < sms ? blocks : sms;
  }
  const dim3 grid(static_cast<unsigned int>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, S::kThreads, S::kSmemBytes, st>>>(maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(Pass pass, const WgmmaParams& p, const void* const* tensors,
                const long long* strides, int B, int n_bh, void* stream) {
  switch (pass) {
    case kFwd: {
      static KernelState state;
      return launch_wgmma<FwdShape<DH>, DH>(flash_fwd_wgmma_kernel<DH>, state, pass, p, tensors,
                                            strides, B, n_bh, true, stream);
    }
    case kDq: {
      if (p.read || !p.final_) {
        static KernelState ring_state;
        return launch_wgmma<BwdShape<DH>, DH>(flash_dq_wgmma_kernel<DH, true>, ring_state, pass,
                                              p, tensors, strides, B, n_bh, false, stream);
      }
      static KernelState state;
      return launch_wgmma<BwdShape<DH>, DH>(flash_dq_wgmma_kernel<DH, false>, state, pass, p,
                                            tensors, strides, B, n_bh, false, stream);
    }
    default: {
      static KernelState state;
      return launch_wgmma<BwdShape<DH>, DH>(flash_dkv_wgmma_kernel<DH>, state, pass, p, tensors,
                                            strides, B, n_bh, false, stream);
    }
  }
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

int dispatch_f32(Pass pass, const Params& p, int B, int Dh, void* stream) {
  int n_bh = 0;
  const int rc = check_shape(B, p.H, p.T, 0, &n_bh);
  if (rc != 0) return rc == 1 ? 0 : rc;
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_) \
  case DH_:                     \
    return launch_f32<DH_>(pass, p, n_bh, stream);
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bf16(Pass pass, const WgmmaParams& p, const void* const* tensors,
                  const long long* strides, int B, int Dh, void* stream) {
  int n_bh = 0;
  const int rc = check_shape(B, p.H, p.T, 1, &n_bh);
  if (rc != 0) return rc == 1 ? 0 : rc;
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_) \
  case DH_:                     \
    return launch_bf16<DH_>(pass, p, tensors, strides, B, n_bh, stream);
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides strides_at(const long long* strides, int i) {
  return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The ring modes' buffers: a running state wherever a step reads it or
// does not finish, the output wherever it finishes.
bool modes_ok(int read, int final_, const void* run, const void* result) {
  return (read == 0 || read == 1) && (final_ == 0 || final_ == 1) &&
         (run != nullptr || (!read && final_)) && (result != nullptr || !final_);
}

}  // namespace

// dynamic shared memory of a bf16 block at head width Dh: the forward's
// (forward = 1) or the backward's (the same for dQ and dK/dV), or -1 for a
// width the kernels do not take
extern "C" int seld_flash_attention_smem_bytes(int Dh, int forward) {
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_) \
  case DH_:                     \
    return forward ? FwdShape<DH_>::kSmemBytes : BwdShape<DH_>::kSmemBytes;
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return -1;
  }
}

// The nine values of each of the four tensor maps that a bf16 launch of
// `pass` (0 forward, 1 dQ, 2 dK/dV) encodes from its first four tensors'
// strides, into geometry[36]; cudaErrorInvalidValue for a width the
// kernels do not take.
extern "C" int seld_flash_attention_tma_geometry(int pass, const long long* strides, int B, int H,
                                                 int T, int Dh, long long* geometry) {
  int rows[4];
  switch (Dh) {
#define SELD_HEAD_DIM_CASE(DH_)                               \
  case DH_:                                                   \
    box_rows<DH_>(pass == 0 ? kFwd : pass == 1 ? kDq : kDkv, rows); \
    break;
    SELD_FOR_EACH_HEAD_DIM(SELD_HEAD_DIM_CASE)
#undef SELD_HEAD_DIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 4; ++i) {
    long long geo[9];
    tma_geometry(geo, strides + 3 * i, B, H, T, Dh, rows[i]);
    for (int j = 0; j < 9; ++j) geometry[9 * i + j] = geo[j];
  }
  return 0;
}

// strides: q, k, v, out, run. run: the ring's float32 running o (out's
// shape), needed unless read = 0 and final_ = 1; lse is read (read) and
// written. out is always given (the bf16 forward encodes its map).
extern "C" int seld_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, void* run, const long long* strides, int read,
                                        int final_, int B, int H, int T, int Dh, float scale,
                                        int dtype, void* stream) {
  if (out == nullptr || !modes_ok(read, final_, run, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    WgmmaParams p{};  // out goes through its tensor map
    p.lse = static_cast<float*>(lse);
    p.run0 = static_cast<float*>(run);
    p.r0s = strides_at(strides, 4);
    p.H = H;
    p.T = T;
    p.read = read;
    p.final_ = final_;
    p.scale = scale;
    const void* tensors[4] = {q, k, v, out};
    return dispatch_bf16(kFwd, p, tensors, strides, B, Dh, stream);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.run0 = static_cast<float*>(run);
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.os = strides_at(strides, 3);
  p.r0s = strides_at(strides, 4);
  p.H = H;
  p.T = T;
  p.read = read;
  p.final_ = final_;
  p.scale = scale;
  return dispatch_f32(kFwd, p, B, Dh, stream);
}

// strides: q, k, v, dout, out, dq, run. delta_given = 0: the kernel forms
// delta from dout and out and writes it to `delta` (bf16 only); 1: it
// reads `delta`. run: the ring's float32 running dq, needed unless
// read = 0 and final_ = 1; dq is written only with final_.
extern "C" int seld_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* out, const void* lse,
                                           void* delta, void* dq, void* run,
                                           const long long* strides, int delta_given, int read,
                                           int final_, int B, int H, int T, int Dh, float scale,
                                           int dtype, void* stream) {
  if (!modes_ok(read, final_, run, dq)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    WgmmaParams p{};
    p.out = static_cast<const bf16*>(out);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = const_cast<float*>(static_cast<const float*>(lse));
    p.delta = static_cast<float*>(delta);
    p.d0 = static_cast<bf16*>(dq);
    p.run0 = static_cast<float*>(run);
    p.gs = strides_at(strides, 3);
    p.os = strides_at(strides, 4);
    p.d0s = strides_at(strides, 5);
    p.r0s = strides_at(strides, 6);
    p.H = H;
    p.T = T;
    p.delta_given = delta_given;
    p.read = read;
    p.final_ = final_;
    p.scale = scale;
    const void* tensors[4] = {q, k, v, dout};
    return dispatch_bf16(kDq, p, tensors, strides, B, Dh, stream);
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
  p.run0 = static_cast<float*>(run);
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.gs = strides_at(strides, 3);
  p.dqs = strides_at(strides, 5);
  p.r0s = strides_at(strides, 6);
  p.H = H;
  p.T = T;
  p.read = read;
  p.final_ = final_;
  p.scale = scale;
  return dispatch_f32(kDq, p, B, Dh, stream);
}

// strides: q, k, v, dout, dk, dv, dk_run, dv_run. The runs: the ring's
// float32 running dk and dv, needed unless read = 0 and final_ = 1; dk
// and dv are written only with final_.
extern "C" int seld_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, void* dk_run, void* dv_run,
                                            const long long* strides, int read, int final_, int B,
                                            int H, int T, int Dh, float scale, int dtype,
                                            void* stream) {
  if (!modes_ok(read, final_, dk_run, dk) || !modes_ok(read, final_, dv_run, dv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    WgmmaParams p{};
    p.lse = const_cast<float*>(static_cast<const float*>(lse));
    p.delta = const_cast<float*>(static_cast<const float*>(delta));
    p.d0 = static_cast<bf16*>(dk);
    p.d1 = static_cast<bf16*>(dv);
    p.run0 = static_cast<float*>(dk_run);
    p.run1 = static_cast<float*>(dv_run);
    p.d0s = strides_at(strides, 4);
    p.d1s = strides_at(strides, 5);
    p.r0s = strides_at(strides, 6);
    p.r1s = strides_at(strides, 7);
    p.H = H;
    p.T = T;
    p.delta_given = 1;
    p.read = read;
    p.final_ = final_;
    p.scale = scale;
    const void* tensors[4] = {q, k, v, dout};
    return dispatch_bf16(kDkv, p, tensors, strides, B, Dh, stream);
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
  p.run0 = static_cast<float*>(dk_run);
  p.run1 = static_cast<float*>(dv_run);
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.gs = strides_at(strides, 3);
  p.dks = strides_at(strides, 4);
  p.dvs = strides_at(strides, 5);
  p.r0s = strides_at(strides, 6);
  p.r1s = strides_at(strides, 7);
  p.H = H;
  p.T = T;
  p.read = read;
  p.final_ = final_;
  p.scale = scale;
  return dispatch_f32(kDkv, p, B, Dh, stream);
}
