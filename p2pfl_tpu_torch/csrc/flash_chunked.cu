// Flash attention on the CUDA cores at any head size above 512, f32 only:
// the forward (with and without logsumexp), the backward pair (dq; dk/dv)
// and ring attention's carry fold, with the head size a run-time argument.
// bf16 runs the tensor-core kernels above 256 (the carry above 64):
// flash_fwd_grouped_sm90.cu, flash_bwd_grouped_sm90.cu and
// flash_carry_grouped_sm90.cu.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py above the
// largest compiled head size (512) of flash_attn.cu:
//   flash_fwd_chunked<with_lse=true>   <- _flash_kernel          (pallas_call at :308; f32)
//   flash_fwd_chunked<with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298; f32)
//   flash_bwd_dq_chunked               <- _flash_bwd_dq_kernel   (pallas_call at :446; f32)
//   flash_bwd_dkv_chunked              <- _flash_bwd_dkv_kernel  (pallas_call at :463; f32)
//   flash_carry_chunked                <- _flash_carry_kernel    (pallas_call at :590; f32)
// The TPU kernels keep (block, D) f32 scratch in VMEM and so take any D;
// a block here has at most 227 KB of shared memory, which holds no 64-row
// tile of a row of a thousand f32 columns.
//
// What it computes is what flash_attn.cu's CUDA-core kernels compute, in
// the same f32 arithmetic: q scaled by 1/sqrt(D) in f32 as it is loaded,
// every product and sum f32, the causal mask -0.7 * FLT_MAX (keys past Sk:
// -inf in the forward and carry, P = 0 in the backward), l clamped at 1e-30
// and lse = m + log(l). ops/_kernels.py zero-pads D up to a multiple of 64
// (exact: zero columns add exact zeros to Q.K^T and dO.V^T and come out as
// zeros).
//
// Design: simple and right, not fast. One block works on one (b * h, tile of
// 64 rows, 64-column panel of the output): a q tile and a panel of O (the
// carry's acc) or dQ, or a k tile and a panel of dK and dV. For each tile of
// the other side it builds the 64 x 64 score tile (and dP for the backward)
// over all of D, one 64-column panel of q and k (dO and v) in shared memory
// at a time, f32 sums in a 4 x 4 register micro-tile per thread, then runs
// the softmax (forward, carry) or forms P and dS (backward) and multiplies
// them into its own panel only. Every panel block of a tile runs the same
// arithmetic on the same data in the same order, so all reach the same m
// and l; the panel-0 block writes lse (the carry: m and l). One launch per
// call; the scores are recomputed D / 64 times, once per panel block, and
// that cost is accepted: at D = 1024 the work is 16 times a panel's.
//
// What bounds it on this card: the f32 products on the CUDA cores (67
// TFLOP/s against the tensor cores' 989), times D / 64 for the recomputed
// scores; the bound in chip_smoke.py counts each product once.
//
// A fold with no key tile to fold (wholly in the future) writes the carry
// back unchanged, bit for bit, as flash_attn.cu's carry kernel does.
//
// Interface: p2pfl::launch_flash_*_chunked, called by the C entry points of
// flash_attn.cu for head sizes above 512; each launches on the given
// stream, allocates nothing and returns cudaGetLastError()
// (cudaErrorInvalidValue for a head size that is not a multiple of 64 or a
// dtype other than 0, f32).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TX = 16;  // threads along a tile's columns
constexpr int TY = 16;  // threads along a tile's rows
constexpr int NTHREADS = TX * TY;
constexpr int BQ = 64, BK = 64;            // q / k rows per tile
constexpr int RI = BQ / TY, RJ = BK / TX;  // rows / columns of a thread's score micro-tile
constexpr int PC = 64;                     // columns of one panel of D
constexpr int PJ = PC / TX;                // a thread's columns of its block's output panel
constexpr int LD = PC + 1;                 // a panel row in shared memory, padded against bank conflicts
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // ops/attention.py DEFAULT_MASK_VALUE

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Max / sum over the 16 lanes that hold one tile row (a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Columns [col0, col0 + 64) of rows [row0, row0 + ROWS) of one (b, h) of a
// [B, S, H, D] tensor into a [ROWS][LD] f32 tile, times `mul`; rows at or
// past S read as 0.
template <typename T, int ROWS>
__device__ __forceinline__ void load_panel(float* tile, const T* __restrict__ src, int b, int h, int row0,
                                           int col0, int S, int H, int D, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * PC; idx += NTHREADS) {
    const int r = idx / PC, c = idx % PC;
    const int pos = row0 + r;
    float val = 0.f;
    if (pos < S) val = to_f32(src[((int64_t(b) * S + pos) * H + h) * D + col0 + c]) * mul;
    tile[r * LD + c] = val;
  }
}

// Per-row f32 values (lse, delta) of one (b, h) for rows [r0, r0 + BQ); 0 past S.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int64_t bh, int r0, int S) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) dst[r] = r0 + r < S ? src[bh * S + r0 + r] : 0.f;
}

// s[i][j] += A[ty + TY i] . B[tx + TX j] over one panel (A, B: [64][LD] tiles).
__device__ __forceinline__ void panel_product(float (&s)[RI][RJ], const float* As, const float* Bs) {
#pragma unroll 8
  for (int d = 0; d < PC; ++d) {
    float av[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = As[(threadIdx.x / TX + TY * i) * LD + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = Bs[(threadIdx.x % TX + TX * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c W[ty + TY i][c] X[c][tx + TX j] (W: [64][BK + 1], X: [64][LD]).
__device__ __forceinline__ void panel_accumulate(float (&acc)[RI][PJ], const float* Ws, const float* Xs) {
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    float xv[PJ];
#pragma unroll
    for (int j = 0; j < PJ; ++j) xv[j] = Xs[c * LD + threadIdx.x % TX + TX * j];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float w = Ws[(threadIdx.x / TX + TY * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(w, xv[j], acc[i][j]);
    }
  }
}

// The online softmax of one score tile (rows q0 + ty + TY i at global q
// positions q_pos0 + those, keys k0 + tx + TX j at kv_pos0 + those): mask,
// new row max, P into Ps, l and acc rescaled.
__device__ __forceinline__ void softmax_tile(float (&s)[RI][RJ], float (&m)[RI], float (&l)[RI],
                                             float (&acc)[RI][PJ], float* Ps, int q_pos0, int k0, int kv_pos0,
                                             int Sk, bool causal) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qg = q_pos0 + ty + TY * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int kpos = k0 + tx + TX * j;
      if (kpos >= Sk) s[i][j] = -INFINITY;  // ragged tail: no contribution
      else if (causal && qg < kv_pos0 + kpos) s[i][j] = MASK_VALUE;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const float p = expf(s[i][j] - m_new);
      ps += p;
      Ps[(ty + TY * i) * (BK + 1) + tx + TX * j] = p;
    }
    const float corr = expf(m[i] - m_new);
    l[i] = corr * l[i] + row_sum(ps);
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] *= corr;
  }
}

// One k tile folded into (m, l, acc) of the block's q tile and output
// panel: the scores over all of D a panel at a time, the softmax, then P
// times this block's panel of V. Shared memory: Qs and KVs [64][LD], Ps
// [64][BK + 1].
template <typename T>
__device__ __forceinline__ void fold_k_tile(float (&m)[RI], float (&l)[RI], float (&acc)[RI][PJ], float* Qs,
                                            float* KVs, float* Ps, const T* __restrict__ q,
                                            const T* __restrict__ k, const T* __restrict__ v, int b, int h,
                                            int q0, int k0, int c0, int Sq, int Sk, int H, int D, float scale,
                                            bool causal, int q_pos0, int kv_pos0) {
  float s[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
  for (int p0 = 0; p0 < D; p0 += PC) {
    __syncthreads();  // the previous panel (or tile's V panel and P) is no longer read
    load_panel<T, BQ>(Qs, q, b, h, q0, p0, Sq, H, D, scale);
    load_panel<T, BK>(KVs, k, b, h, k0, p0, Sk, H, D, 1.f);
    __syncthreads();
    panel_product(s, Qs, KVs);
  }
  softmax_tile(s, m, l, acc, Ps, q_pos0, k0, kv_pos0, Sk, causal);
  __syncthreads();  // every thread is done with the last K panel, and P is written
  load_panel<T, BK>(KVs, v, b, h, k0, c0, Sk, H, D, 1.f);
  __syncthreads();
  panel_accumulate(acc, Ps, KVs);
}

constexpr size_t kFwdSmem = sizeof(float) * (BQ * LD + BK * LD + BQ * (BK + 1));
constexpr size_t kDqSmem = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1) + 2 * BQ);
constexpr size_t kDkvSmem = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ);
static_assert(kFwdSmem == 49920 && kDqSmem == 83712 && kDkvSmem == 100352, "tiles changed");

// ----------------------------------------------------------------------------
// Forward: grid (q tiles, B * H, D / 64 output panels).
template <typename T, bool WITH_LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale,
                         int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD] one panel of q, pre-scaled
  float* KVs = Qs + BQ * LD;    // [BK][LD] one panel of k, then this block's panel of v
  float* Ps = KVs + BK * LD;    // [BQ][BK + 1]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.z * PC;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  float m[RI], l[RI], acc[RI][PJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;  // causal: future tiles skipped
  for (int k0 = 0; k0 < k_end; k0 += BK)
    fold_k_tile(m, l, acc, Qs, KVs, Ps, q, k, v, b, h, q0, k0, c0, Sq, Sk, H, D, scale, causal != 0, q0, 0);

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t(b) * Sq + qpos) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < PJ; ++j) orow[tx + TX * j] = from_f32<T>(acc[i][j] / l_safe);
    if (WITH_LSE && blockIdx.z == 0 && tx == 0) lse[int64_t(blockIdx.y) * Sq + qpos] = m[i] + logf(l_safe);
  }
}

// ----------------------------------------------------------------------------
// Carry fold: the forward's loop from the incoming (m, l, acc) rows at
// global positions (flash_attn.cu's flash_carry_kernel); grid as the forward.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)  // up to 128 registers: at ptxas's default of 64 it spills
flash_carry_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ acc_in, float* __restrict__ m_out, float* __restrict__ l_out,
                           float* __restrict__ acc_out, int Sq, int Sk, int H, int D, float scale, int causal,
                           int q_offset, int kv_offset) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.z * PC;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t bh = blockIdx.y;

  float m[RI], l[RI], acc[RI][PJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    const bool in = qpos < Sq;
    m[i] = in ? m_in[bh * Sq + qpos] : -INFINITY;
    l[i] = in ? l_in[bh * Sq + qpos] : 0.f;
    const float* arow = acc_in + ((int64_t(b) * Sq + qpos) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = in ? arow[tx + TX * j] : 0.f;
  }
  // Causal: k tiles wholly in this q tile's future are skipped; a chunk
  // wholly in the future runs no tile and writes the carry back unchanged.
  const int k_end = causal ? min(Sk, q_offset + q0 + BQ - kv_offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK)
    fold_k_tile(m, l, acc, Qs, KVs, Ps, q, k, v, b, h, q0, k0, c0, Sq, Sk, H, D, scale, causal != 0,
                q_offset + q0, kv_offset);

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    if (blockIdx.z == 0 && tx == 0) {
      m_out[bh * Sq + qpos] = m[i];
      l_out[bh * Sq + qpos] = l[i];
    }
    float* arow = acc_out + ((int64_t(b) * Sq + qpos) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < PJ; ++j) arow[tx + TX * j] = acc[i][j];
  }
}

// ----------------------------------------------------------------------------
// dq: grid (q tiles, B * H, D / 64 panels of dQ).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int D,
                            float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD] one panel of q, pre-scaled
  float* dOs = Qs + BQ * LD;          // [BQ][LD] one panel of dO
  float* Ks = dOs + BQ * LD;          // [BK][LD] one panel of k, then this block's panel of k
  float* Vs = Ks + BK * LD;           // [BK][LD] one panel of v
  float* dSs = Vs + BK * LD;          // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* dd_s = lse_s + BQ;            // [BQ]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, c0 = blockIdx.z * PC;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_rows(lse_s, lse, blockIdx.y, q0, Sq);
  load_rows(dd_s, delta, blockIdx.y, q0, Sq);
  float acc[RI][PJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int p0 = 0; p0 < D; p0 += PC) {
      __syncthreads();  // the previous panels (and the previous tile's dS and K panel) are no longer read
      load_panel<T, BQ>(Qs, q, b, h, q0, p0, Sq, H, D, scale);
      load_panel<T, BQ>(dOs, dout, b, h, q0, p0, Sq, H, D, 1.f);
      load_panel<T, BK>(Ks, k, b, h, k0, p0, Sk, H, D, 1.f);
      load_panel<T, BK>(Vs, v, b, h, k0, p0, Sk, H, D, 1.f);
      __syncthreads();
      panel_product(s, Qs, Ks);
      panel_product(dp, dOs, Vs);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kpos = k0 + tx + TX * j;
        float sv = s[i][j];
        if (causal && qpos < kpos) sv = MASK_VALUE;
        const float p = kpos < Sk ? expf(sv - lse_s[r]) : 0.f;
        dSs[r * (BK + 1) + tx + TX * j] = p * (dp[i][j] - dd_s[r]);
      }
    }
    __syncthreads();  // every thread is done with the last K panel, and dS is written
    load_panel<T, BK>(Ks, k, b, h, k0, c0, Sk, H, D, 1.f);
    __syncthreads();
    panel_accumulate(acc, dSs, Ks);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    T* row = dq + ((int64_t(b) * Sq + qpos) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < PJ; ++j) row[tx + TX * j] = from_f32<T>(scale * acc[i][j]);
  }
}

// ----------------------------------------------------------------------------
// dk / dv: grid (k tiles, B * H, D / 64 panels of dK and dV); rows of the
// micro-tiles are keys, columns q positions (flash_attn.cu's dk/dv kernel).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                             int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][LD] one panel of k
  float* Vs = Ks + BK * LD;            // [BK][LD] one panel of v
  float* Qs = Vs + BK * LD;            // [BQ][LD] one panel of q, pre-scaled (then this block's)
  float* dOs = Qs + BQ * LD;           // [BQ][LD] one panel of dO (then this block's)
  float* Pt = dOs + BQ * LD;           // [BK][BQ + 1]
  float* dSt = Pt + BK * (BQ + 1);     // [BK][BQ + 1]
  float* lse_s = dSt + BK * (BQ + 1);  // [BQ]
  float* dd_s = lse_s + BQ;            // [BQ]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK, c0 = blockIdx.z * PC;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  float dk_acc[RI][PJ], dv_acc[RI][PJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Causal: a q tile contributes iff its last row can see this k tile.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    float st[RI][RJ], dpt[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int p0 = 0; p0 < D; p0 += PC) {
      __syncthreads();  // the previous panels (and the previous tile's P, dS, rows and panels) are no longer read
      if (p0 == 0) {
        load_rows(lse_s, lse, blockIdx.y, q0, Sq);
        load_rows(dd_s, delta, blockIdx.y, q0, Sq);
      }
      load_panel<T, BK>(Ks, k, b, h, k0, p0, Sk, H, D, 1.f);
      load_panel<T, BK>(Vs, v, b, h, k0, p0, Sk, H, D, 1.f);
      load_panel<T, BQ>(Qs, q, b, h, q0, p0, Sq, H, D, scale);
      load_panel<T, BQ>(dOs, dout, b, h, q0, p0, Sq, H, D, 1.f);
      __syncthreads();
      panel_product(st, Ks, Qs);
      panel_product(dpt, Vs, dOs);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kr = ty + TY * i;
      const int kpos = k0 + kr;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int qc = tx + TX * j;
        const int qpos = q0 + qc;
        float sv = st[i][j];
        if (causal && qpos < kpos) sv = MASK_VALUE;
        const float p = qpos < Sq ? expf(sv - lse_s[qc]) : 0.f;
        Pt[kr * (BQ + 1) + qc] = p;
        dSt[kr * (BQ + 1) + qc] = p * (dpt[i][j] - dd_s[qc]);
      }
    }
    __syncthreads();  // every thread is done with the last Q and dO panels; P^T and dS^T are written
    load_panel<T, BQ>(Qs, q, b, h, q0, c0, Sq, H, D, scale);
    load_panel<T, BQ>(dOs, dout, b, h, q0, c0, Sq, H, D, 1.f);
    __syncthreads();
    panel_accumulate(dv_acc, Pt, dOs);
    panel_accumulate(dk_acc, dSt, Qs);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kpos = k0 + ty + TY * i;
    if (kpos >= Sk) continue;
    const int64_t off = ((int64_t(b) * Sk + kpos) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      dk[off + tx + TX * j] = from_f32<T>(dk_acc[i][j]);
      dv[off + tx + TX * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ----------------------------------------------------------------------------
// Host side.

dim3 grid_of(int rows, int B, int H, int D) { return dim3((rows + BQ - 1) / BQ, B * H, D / PC); }

template <typename K>
cudaError_t prepared(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

namespace p2pfl {

// [B, S, H, head_dim] q / k / v / o in f32 (dtype 0); lse [B, H, Sq] f32 or
// nullptr (the forward that writes no logsumexp).
cudaError_t launch_flash_fwd_chunked(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                                     int Sk, int H, int head_dim, int dtype, float scale, bool causal,
                                     cudaStream_t stream) {
  if (dtype != 0 || head_dim < PC || head_dim % PC != 0) return cudaErrorInvalidValue;
  const auto kern = lse != nullptr ? flash_fwd_chunked_kernel<float, true> : flash_fwd_chunked_kernel<float, false>;
  const cudaError_t e = prepared(kern, kFwdSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(Sq, B, H, head_dim), NTHREADS, kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(o),
      lse, Sq, Sk, H, head_dim, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

// [B, S, H, head_dim] q / k / v / dout / dq in f32 (dtype 0); lse and delta
// [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dq_chunked(const void* q, const void* k, const void* v, const void* dout,
                                        const float* lse, const float* delta, void* dq, int B, int Sq, int Sk, int H,
                                        int head_dim, int dtype, float scale, bool causal, cudaStream_t stream) {
  if (dtype != 0 || head_dim < PC || head_dim % PC != 0) return cudaErrorInvalidValue;
  const auto kern = flash_bwd_dq_chunked_kernel<float>;
  const cudaError_t e = prepared(kern, kDqSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(Sq, B, H, head_dim), NTHREADS, kDqSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), Sq, Sk, H, head_dim, scale,
      causal ? 1 : 0);
  return cudaGetLastError();
}

// [B, S, H, head_dim] q / k / v / dout / dk / dv in f32 (dtype 0); lse and
// delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dkv_chunked(const void* q, const void* k, const void* v, const void* dout,
                                         const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                         int Sk, int H, int head_dim, int dtype, float scale, bool causal,
                                         cudaStream_t stream) {
  if (dtype != 0 || head_dim < PC || head_dim % PC != 0) return cudaErrorInvalidValue;
  const auto kern = flash_bwd_dkv_chunked_kernel<float>;
  const cudaError_t e = prepared(kern, kDkvSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(Sk, B, H, head_dim), NTHREADS, kDkvSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H,
      head_dim, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

// q / k / v [B, S, H, head_dim] in f32 (dtype 0); m / l: [B, H, Sq] f32;
// acc: [B, Sq, H, head_dim] f32; *_in and *_out must not overlap.
cudaError_t launch_flash_carry_chunked(const void* q, const void* k, const void* v, const float* m_in,
                                       const float* l_in, const float* acc_in, float* m_out, float* l_out,
                                       float* acc_out, int B, int Sq, int Sk, int H, int head_dim, int dtype,
                                       float scale, bool causal, int q_offset, int kv_offset, cudaStream_t stream) {
  if (dtype != 0 || head_dim < PC || head_dim % PC != 0) return cudaErrorInvalidValue;
  const auto kern = flash_carry_chunked_kernel<float>;
  const cudaError_t e = prepared(kern, kFwdSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(Sq, B, H, head_dim), NTHREADS, kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), m_in, l_in, acc_in,
      m_out, l_out, acc_out, Sq, Sk, H, head_dim, scale, causal ? 1 : 0, q_offset, kv_offset);
  return cudaGetLastError();
}

}  // namespace p2pfl
