// Flash attention on the CUDA cores, f32 only: forward (with and without
// logsumexp), the FlashAttention-2 backward pair (dq; dk/dv), and ring
// attention's fold of one kv chunk into an online-softmax carry; and the C
// entry points of every kernel of the library.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py, f32 only:
//   flash_fwd<with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd<with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
//   flash_bwd_dq               <- _flash_bwd_dq_kernel   (pallas_call at :446)
//   flash_bwd_dkv              <- _flash_bwd_dkv_kernel  (pallas_call at :463)
//   flash_carry                <- _flash_carry_kernel    (pallas_call at :590)
// bf16 at head size 64 runs the tensor-core kernels: the forward and the
// carry fold in flash_fwd_sm90.cu, the backward pair in flash_bwd_sm90.cu,
// launched from p2pfl_flash_fwd / p2pfl_flash_carry / p2pfl_flash_bwd_dq /
// p2pfl_flash_bwd_dkv below (ops/_kernels.py zero-pads narrower bf16 heads to
// 64). bf16 at head sizes 128 and 256 runs the kernels here at
// <__nv_bfloat16, 128 / 256>: bf16 loads, f32 arithmetic, bf16 stores (a
// tensor-core instance there would need its own TMA boxes and wgmma shapes);
// no other bf16 instance of a kernel here is compiled.
//
// What it computes is what the TPU kernels compute: q is scaled by 1/sqrt(D)
// in f32, every product and sum is f32, the causal mask writes -0.7 *
// FLT_MAX (not -inf), l is clamped at 1e-30 and lse = m + log(l). The
// backward kernels read dO and D = rowsum(dO * O) in f32, as the TPU wrapper
// hands them. It is not a block-by-block copy:
//   * the TPU's sequential k grid axis (scratch carried across grid steps)
//     becomes a loop inside one block, since blocks on this card run in
//     parallel and share nothing;
//   * the 128-lane broadcast of m / l / lse is gone: lse is [B, H, S] f32;
//   * ragged sequence tails are masked inside the tile instead of shrinking
//     the block to a divisor of S;
//   * tensors stay in the [B, S, H, D] layout of the public API (a row of one
//     head is D contiguous elements), so no transpose runs around the call.
//
// What bounds it on this card: at the slice's shapes ([8, 1024, 8, 64],
// causal) the work sits near the H100's ridge (~300 bf16 FLOP per byte): the
// forward's ~S/4 = 256 FLOP per byte makes its bound the bytes, the backward
// pair's ~300-340 makes theirs the operations. Either bound is ~10-17 us at
// the H100 SXM data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s).
// These kernels are held far above both by arithmetic: they do every
// product on the CUDA cores in f32, whose peak is 67 TFLOP/s against the
// 989 TFLOP/s of the bf16 tensor cores (which the *_sm90.cu sources use for
// bf16). The design keeps the working set on
// chip so that the f32 rate is the only limit: one 64-row q (or k) tile
// per block (32 rows at D = 256, tile_rows below), K/V (or Q/dO) tiles
// staged in shared memory padded by one column so that the strided row reads
// are free of bank conflicts, the online-softmax state and a 4 x 4 (rows x
// columns; 2 x 2 at D = 256) register micro-tile per thread, and
// causal-future tiles skipped. They stay on the CUDA cores
// because f32 parity (1e-5) forbids TF32 products.
//
// Interface: plain C functions, loaded with ctypes. Each launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TX = 16;  // threads along a tile's columns
constexpr int TY = 16;  // threads along a tile's rows
constexpr int NTHREADS = TX * TY;

// Rows of a q (and of a k) tile at head size D: 64 up to D = 128, 32 above,
// where a 64-row tile's shared memory no longer fits in a block (dk/dv at
// D = 256 would need 296,960 B against 232,448). Every kernel and launcher
// below reads its tile through this one compile-time function of D, so the
// instances up to 128 keep their names and code; each kernel derives
//   BQ = BK = tile_rows<D>()     q / k rows per tile,
//   RI = BQ / TY, RJ = BK / TX   rows / columns of a thread's micro-tile.
template <int D>
__host__ __device__ constexpr int tile_rows() { return D > 128 ? 32 : 64; }
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // ops/attention.py DEFAULT_MASK_VALUE

// The kernels keep their element type T as a parameter: float at every head
// size, __nv_bfloat16 at 128 only (bf16 at 64 and below runs the tensor-core
// kernels). Either way every product and sum is f32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Max / sum over the 16 lanes that hold one tile row (a half warp: tx is the
// fast thread index, so the xor offsets below never leave it).
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

// Copy rows [row0, row0 + ROWS) of one (b, h) slice of a [B, S, H, D] tensor
// into a [ROWS][D + 1] f32 tile, times `mul`; rows at or past S read as 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, int b, int h,
                                          int row0, int S, int H, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    const int pos = row0 + r;
    float val = 0.f;
    if (pos < S) val = to_f32(src[((int64_t(b) * S + pos) * H + h) * D + d]) * mul;
    tile[r * (D + 1) + d] = val;
  }
}

// ----------------------------------------------------------------------------
// Forward: one block per (q tile, b * h); loop over k tiles with online softmax.
template <typename T, int D, bool WITH_LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H,
                 float scale, bool causal) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RI = BQ / TY, RJ = BK / TX;
  constexpr int DJ = D / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D + 1], pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D + 1]
  float* Ps = Vs + BK * (D + 1);    // [BQ][BK + 1]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_tile<T, D, BQ>(Qs, q, b, h, q0, Sq, H, scale);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // Causal: k tiles wholly in this q tile's future are skipped.
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    load_tile<T, D, BK>(Ks, k, b, h, k0, Sk, H, 1.f);
    load_tile<T, D, BK>(Vs, v, b, h, k0, Sk, H, 1.f);
    __syncthreads();

    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + TY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kpos = k0 + tx + TX * j;
        if (kpos >= Sk) s[i][j] = -INFINITY;  // ragged tail: no contribution
        else if (causal && qpos < kpos) s[i][j] = MASK_VALUE;
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
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * (D + 1) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + TX * j] = from_f32<T>(acc[i][j] / l_safe);
    if (WITH_LSE && tx == 0) lse[(int64_t(blockIdx.y)) * Sq + qpos] = m[i] + logf(l_safe);
  }
}

// Per-row f32 values (lse, D) of one (b, h) for q rows [q0, q0 + ROWS); 0 past Sq.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int64_t bh,
                                          int q0, int Sq) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) {
    const int pos = q0 + r;
    dst[r] = pos < Sq ? src[bh * Sq + pos] : 0.f;
  }
}

// ----------------------------------------------------------------------------
// dq: one block per (q tile, b * h); loop over k tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                    float scale, bool causal) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RI = BQ / TY, RJ = BK / TX;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1], pre-scaled
  float* dOs = Qs + BQ * (D + 1);    // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);    // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* dd_s = lse_s + BQ;            // [BQ]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_tile<T, D, BQ>(Qs, q, b, h, q0, Sq, H, scale);
  load_tile<T, D, BQ>(dOs, dout, b, h, q0, Sq, H, 1.f);
  load_rows<BQ>(lse_s, lse, blockIdx.y, q0, Sq);
  load_rows<BQ>(dd_s, delta, blockIdx.y, q0, Sq);

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<T, D, BK>(Ks, k, b, h, k0, Sk, H, 1.f);
    load_tile<T, D, BK>(Vs, v, b, h, k0, Sk, H, 1.f);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[RJ], vv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + TY * i) * (D + 1) + d];
        ov[i] = dOs[(ty + TY * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
        vv[j] = Vs[(tx + TX * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
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
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * (D + 1) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = dSs[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    T* row = dq + ((int64_t(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + TX * j] = from_f32<T>(scale * acc[i][j]);
  }
}

// ----------------------------------------------------------------------------
// dk / dv: one block per (k tile, b * h); loop over the q tiles that see it.
// The micro-tile is transposed relative to the forward: rows are k positions,
// columns q positions, so each thread's accumulators are whole dk / dv rows.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, int H, float scale, bool causal) {
  constexpr int BQ = tile_rows<D>(), BK = BQ;
  constexpr int DJ = D / TX;
  constexpr int KI = BK / TY;  // k rows per thread
  constexpr int QJ = BQ / TX;  // q columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);       // [BQ][D + 1], pre-scaled
  float* dOs = Qs + BQ * (D + 1);      // [BQ][D + 1]
  float* Pt = dOs + BQ * (D + 1);      // [BK][BQ + 1]
  float* dSt = Pt + BK * (BQ + 1);     // [BK][BQ + 1]
  float* lse_s = dSt + BK * (BQ + 1);  // [BQ]
  float* dd_s = lse_s + BQ;            // [BQ]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_tile<T, D, BK>(Ks, k, b, h, k0, Sk, H, 1.f);
  load_tile<T, D, BK>(Vs, v, b, h, k0, Sk, H, 1.f);

  float dk_acc[KI][DJ], dv_acc[KI][DJ];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Causal: a q tile contributes iff its last row can see this k tile.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    __syncthreads();
    load_tile<T, D, BQ>(Qs, q, b, h, q0, Sq, H, scale);
    load_tile<T, D, BQ>(dOs, dout, b, h, q0, Sq, H, 1.f);
    load_rows<BQ>(lse_s, lse, blockIdx.y, q0, Sq);
    load_rows<BQ>(dd_s, delta, blockIdx.y, q0, Sq);
    __syncthreads();

    float st[KI][QJ], dpt[KI][QJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[KI], vv[KI], qv[QJ], ov[QJ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kv[i] = Ks[(ty + TY * i) * (D + 1) + d];
        vv[i] = Vs[(ty + TY * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        qv[j] = Qs[(tx + TX * j) * (D + 1) + d];
        ov[j] = dOs[(tx + TX * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int kr = ty + TY * i;
      const int kpos = k0 + kr;
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int qc = tx + TX * j;
        const int qpos = q0 + qc;
        float sv = st[i][j];
        if (causal && qpos < kpos) sv = MASK_VALUE;
        const float p = qpos < Sq ? expf(sv - lse_s[qc]) : 0.f;
        Pt[kr * (BQ + 1) + qc] = p;
        dSt[kr * (BQ + 1) + qc] = p * (dpt[i][j] - dd_s[qc]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float ov[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[c * (D + 1) + tx + TX * j];
        qv[j] = Qs[c * (D + 1) + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const float p = Pt[(ty + TY * i) * (BQ + 1) + c];
        const float ds = dSt[(ty + TY * i) * (BQ + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] = fmaf(p, ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int kpos = k0 + ty + TY * i;
    if (kpos >= Sk) continue;
    const int64_t off = ((int64_t(b) * Sk + kpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + TX * j] = from_f32<T>(dk_acc[i][j]);
      dv[off + tx + TX * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// ----------------------------------------------------------------------------
// Carry fold (ring attention's per-chunk step): the forward's loop, but the
// online-softmax state starts from the incoming (m, l, acc) rows and leaves
// unnormalized; q rows sit at global positions q_offset + [0, Sq) and k rows
// at kv_offset + [0, Sk), and both the causal mask and the future-tile skip
// compare those global positions. The f32 CUDA-core products hold it far
// above its bound, as they do the forward (the bf16 fold is the tensor-core
// kernel of flash_fwd_sm90.cu). The carry is read once and written once per
// q row, through registers: in and out are separate buffers.
//
// No row can produce -inf - -inf: every processed k tile holds column k0 < Sk
// (in range), masked scores are finite, so m_new is finite after the tile.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_carry_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ m_in, const float* __restrict__ l_in,
                   const float* __restrict__ acc_in, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out, int Sq, int Sk, int H,
                   float scale, bool causal, int q_offset, int kv_offset) {
  constexpr int BQ = tile_rows<D>(), BK = BQ, RI = BQ / TY, RJ = BK / TX;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D + 1], pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D + 1]
  float* Ps = Vs + BK * (D + 1);    // [BQ][BK + 1]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t bh = blockIdx.y;

  load_tile<T, D, BQ>(Qs, q, b, h, q0, Sq, H, scale);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    const bool in = qpos < Sq;
    m[i] = in ? m_in[bh * Sq + qpos] : -INFINITY;
    l[i] = in ? l_in[bh * Sq + qpos] : 0.f;
    const float* arow = acc_in + ((int64_t(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = in ? arow[tx + TX * j] : 0.f;
  }

  // Causal: k tiles wholly in this q tile's future (kv_offset + k0 >=
  // q_offset + q0 + BQ) are skipped; a chunk wholly in the future runs no
  // tile and writes the carry back unchanged.
  const int k_end = causal ? min(Sk, q_offset + q0 + BQ - kv_offset) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    load_tile<T, D, BK>(Ks, k, b, h, k0, Sk, H, 1.f);
    load_tile<T, D, BK>(Vs, v, b, h, k0, Sk, H, 1.f);
    __syncthreads();

    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + TY * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = Ks[(tx + TX * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qg = q_offset + q0 + ty + TY * i;  // global q position
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int kpos = k0 + tx + TX * j;
        if (kpos >= Sk) s[i][j] = -INFINITY;  // ragged tail: no contribution
        else if (causal && qg < kv_offset + kpos) s[i][j] = MASK_VALUE;
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
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * (D + 1) + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + TY * i) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    if (tx == 0) {
      m_out[bh * Sq + qpos] = m[i];
      l_out[bh * Sq + qpos] = l[i];
    }
    float* arow = acc_out + ((int64_t(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) arow[tx + TX * j] = acc[i][j];
  }
}

// ----------------------------------------------------------------------------
// Host side: dispatch on element type and head size, size shared memory.

template <int D>
constexpr size_t fwd_smem() {
  constexpr int BQ = tile_rows<D>(), BK = BQ;
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}
template <int D>
constexpr size_t dq_smem() {
  constexpr int BQ = tile_rows<D>(), BK = BQ;
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = tile_rows<D>(), BK = BQ;
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}
// A block has at most 227 KB (232,448 B) of shared memory on this card.
static_assert(dkv_smem<128>() == 165888 && fwd_smem<128>() == 115712, "D = 128 tiles changed");
static_assert(fwd_smem<256>() == 102912 && dq_smem<256>() == 136064 && dkv_smem<256>() == 140288,
              "D = 256 tiles changed");
static_assert(dkv_smem<256>() <= 232448, "the D = 256 tiles must fit in a block's shared memory");

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, float scale, bool causal, cudaStream_t stream) {
  const dim3 grid((Sq + tile_rows<D>() - 1) / tile_rows<D>(), B * H);
  const size_t smem = fwd_smem<D>();
  if (lse != nullptr) {
    auto kern = flash_fwd_kernel<T, D, true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse, Sq,
                                           Sk, H, scale, causal);
  } else {
    auto kern = flash_fwd_kernel<T, D, false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    kern<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), nullptr,
                                           Sq, Sk, H, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B, int Sq, int Sk, int H,
                      float scale, bool causal, cudaStream_t stream) {
  const dim3 grid((Sq + tile_rows<D>() - 1) / tile_rows<D>(), B * H);
  const size_t smem = dq_smem<D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Sq, Sk, H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                       int Sk, int H, float scale, bool causal, cudaStream_t stream) {
  const dim3 grid((Sk + tile_rows<D>() - 1) / tile_rows<D>(), B * H);
  const size_t smem = dkv_smem<D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk,
      H, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_carry(const void* q, const void* k, const void* v, const float* m_in,
                         const float* l_in, const float* acc_in, float* m_out, float* l_out,
                         float* acc_out, int B, int Sq, int Sk, int H, float scale, bool causal,
                         int q_offset, int kv_offset, cudaStream_t stream) {
  const dim3 grid((Sq + tile_rows<D>() - 1) / tile_rows<D>(), B * H);
  const size_t smem = fwd_smem<D>();
  auto kern = flash_carry_kernel<T, D>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), m_in, l_in,
      acc_in, m_out, l_out, acc_out, Sq, Sk, H, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, D>) for the head sizes with an
// f32 instance: 16, 32, 64, 128 and 256 (DJ = D / TX columns per thread: 1,
// 2, 4, 8, 16). At D = 128 the dk/dv kernel takes dkv_smem<128>() = 165,888
// bytes of shared memory (the forward and carry 115,712), one block per SM;
// at D = 256 the 32-row tiles take 102,912 (forward, carry), 136,064 (dq) and
// 140,288 (dk/dv). ops/_kernels.py zero-pads any other head size up to 256
// to the next instance; bf16 exists at 64 (the tensor-core kernels, narrower
// heads padded to it), 128 and 256 (the kernels here).
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& launch) {
  switch (head_dim) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 head sizes that run the CUDA-core kernels here: 128 and 256.
template <typename F>
cudaError_t with_bf16_head_dim(int head_dim, F&& launch) {
  switch (head_dim) {
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace p2pfl {
cudaError_t launch_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                  int Sq, int Sk, int H, float scale, bool causal, cudaStream_t stream);
cudaError_t launch_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                     const float* lse, const float* delta, void* dq, int B, int Sq, int Sk, int H,
                                     float scale, bool causal, cudaStream_t stream);
cudaError_t launch_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                      int Sk, int H, float scale, bool causal, cudaStream_t stream);
cudaError_t launch_flash_carry_sm90(const void* q, const void* k, const void* v, const float* m_in,
                                    const float* l_in, const float* acc_in, float* m_out, float* l_out,
                                    float* acc_out, int B, int Sq, int Sk, int H, float scale, bool causal,
                                    int q_offset, int kv_offset, cudaStream_t stream);
}

extern "C" {

// Every entry point returns cudaErrorInvalidValue for a head size without an
// instance: f32 has 16, 32, 64, 128 and 256, bf16 has 64 (tensor cores), 128
// and 256 (the CUDA-core kernels above).
//
// lse == NULL selects the forward that writes no logsumexp. bf16 at 64 runs
// the tensor-core kernel of flash_fwd_sm90.cu; f32, and bf16 at 128 and 256,
// the CUDA-core kernel above.
int p2pfl_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int Sq, int Sk, int H, int head_dim, int dtype, float scale, int causal,
                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(with_head_dim(head_dim, [&](auto d) {
      return launch_fwd<float, decltype(d)::value>(q, k, v, o, lse, B, Sq, Sk, H, scale, causal != 0, s);
    }));
  if (dtype == 1 && head_dim == 64)
    return int(p2pfl::launch_flash_fwd_sm90(q, k, v, o, lse, B, Sq, Sk, H, scale, causal != 0, s));
  if (dtype == 1)
    return int(with_bf16_head_dim(head_dim, [&](auto d) {
      return launch_fwd<__nv_bfloat16, decltype(d)::value>(q, k, v, o, lse, B, Sq, Sk, H, scale, causal != 0, s);
    }));
  return int(cudaErrorInvalidValue);
}

// bf16 at 64 runs the tensor-core pair of flash_bwd_sm90.cu; f32, and bf16
// at 128 and 256, the CUDA-core kernels above.
int p2pfl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                       int H, int head_dim, int dtype, float scale, int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(with_head_dim(head_dim, [&](auto d) {
      return launch_dq<float, decltype(d)::value>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, scale,
                                                  causal != 0, s);
    }));
  if (dtype == 1 && head_dim == 64)
    return int(p2pfl::launch_flash_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, scale,
                                               causal != 0, s));
  if (dtype == 1)
    return int(with_bf16_head_dim(head_dim, [&](auto d) {
      return launch_dq<__nv_bfloat16, decltype(d)::value>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, scale,
                                                          causal != 0, s);
    }));
  return int(cudaErrorInvalidValue);
}

int p2pfl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                        int Sk, int H, int head_dim, int dtype, float scale, int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(with_head_dim(head_dim, [&](auto d) {
      return launch_dkv<float, decltype(d)::value>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, scale,
                                                   causal != 0, s);
    }));
  if (dtype == 1 && head_dim == 64)
    return int(p2pfl::launch_flash_bwd_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, scale,
                                                causal != 0, s));
  if (dtype == 1)
    return int(with_bf16_head_dim(head_dim, [&](auto d) {
      return launch_dkv<__nv_bfloat16, decltype(d)::value>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, scale,
                                                           causal != 0, s);
    }));
  return int(cudaErrorInvalidValue);
}

// m / l: [B, H, Sq] f32; acc: [B, Sq, H, D] f32; *_in and *_out must not
// overlap. bf16 at 64 runs the tensor-core kernel of flash_fwd_sm90.cu; f32,
// and bf16 at 128 and 256, the CUDA-core kernel above.
int p2pfl_flash_carry(const void* q, const void* k, const void* v, const float* m_in,
                      const float* l_in, const float* acc_in, float* m_out, float* l_out,
                      float* acc_out, int B, int Sq, int Sk, int H, int head_dim, int dtype,
                      float scale, int causal, int q_offset, int kv_offset, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(with_head_dim(head_dim, [&](auto d) {
      return launch_carry<float, decltype(d)::value>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B, Sq,
                                                     Sk, H, scale, causal != 0, q_offset, kv_offset, s);
    }));
  if (dtype == 1 && head_dim == 64)
    return int(p2pfl::launch_flash_carry_sm90(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B, Sq, Sk, H,
                                              scale, causal != 0, q_offset, kv_offset, s));
  if (dtype == 1)
    return int(with_bf16_head_dim(head_dim, [&](auto d) {
      return launch_carry<__nv_bfloat16, decltype(d)::value>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B,
                                                             Sq, Sk, H, scale, causal != 0, q_offset, kv_offset, s);
    }));
  return int(cudaErrorInvalidValue);
}

const char* p2pfl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
