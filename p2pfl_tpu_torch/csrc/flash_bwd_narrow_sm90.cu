// Flash-attention backward for Hopper's tensor cores (sm_90a) at head sizes
// below 64: the bf16 dq kernel and the bf16 dk/dv kernel, read at the true
// head size.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_bwd_dq_narrow_sm90_kernel<W>   <- _flash_bwd_dq_kernel   (pallas_call at :446)
//   flash_bwd_dkv_narrow_sm90_kernel<W>  <- _flash_bwd_dkv_kernel  (pallas_call at :463)
// for bf16 inputs at a head size D below 64 that is a multiple of 8, in
// instances of box width W = 16, 32 and 64 (D 8 and 16 take W 16, D 24 and
// 32 take W 32, D 40, 48 and 56 take W 64), as flash_fwd_narrow_sm90.cu reads
// the forward. ops/_kernels.py zero-pads any other D below 57 to the next
// multiple of 8 (TMA strides in multiples of 16 bytes) and D 57-63 to 64,
// which run flash_bwd_sm90.cu's D 64 pair.
//
// What it computes is what flash_bwd_sm90.cu computes, from the forward's
// lse and delta = rowsum(dO * O) (f32, [B, H, Sq]) and dO in bf16: S = Q.K^T
// and dP = dO.V^T are exact bf16 products summed in f32 by wgmma; S is
// multiplied by the scale 1/sqrt(D) in f32 after the product (not a power of
// two at D 8, 24, 32, 40, 48 and 56: one rounding more than at D 64, where
// the reference rounds q * scale first; about one f32 ulp of each score, well
// inside the bar below); the causal mask writes -0.7 * FLT_MAX, P =
// expf(S - lse), P = 0 exactly for keys (queries) past the sequence, and
// dS = P * (dP - delta), all in f32. The second products take their f32
// operand (dS in dq; P^T and dS^T in dk/dv) split as X_hi + X_lo with
// X_hi = bf16(X), X_lo = bf16(X - X_hi), both halves into one f32
// accumulator; dq = scale dQ, dk = scale dK, dv = dV. Each gradient is held
// to the plain version within 1e-6 + 1 bf16 ulp + 2^-15 of its weighted mass
// (ops/attention.py plain_flash_grad_mass).
//
// What bounds it on this card: at the narrow LM's shapes ([8, 1024, 16, 32]
// and [8, 1024, 32, 16] causal) the products take ~13 / 17 us at 989
// TFLOP/s (dq / dk/dv) and the bytes less, but the per-score arithmetic on
// the CUDA cores costs the same at every D: one expf, the scale, dS and one
// (dq) or two (dk/dv) bf16 splits per score, over ~67M causal scores at
// [8, 1024, 16, 32] and ~134M at [8, 1024, 32, 16], once in each kernel.
// That floor sits above both bounds; the padded D 64 pair added to it the
// pads' copies (four of q, k, v and dO per kernel, and the slices of dq, dk
// and dv) and the tensor work and bytes of the zero columns.
//
// Design (flash_bwd_sm90.cu's products, flash_fwd_narrow_sm90.cu's layout):
//   * TMA reads the API's [B, S, H, D] tensors through 4-D tensor maps
//     encoded on the true D, in boxes {W, 1, 64, 1} under the swizzle of 2 W
//     bytes (sm90_common.cuh encode_bshd_box); TMA fills the columns D..W-1
//     with zeros, as it fills rows past S, so no host copy is made;
//   * two warpgroups a block: a TMA producer and one consumer of 64 rows
//     (dq) or keys (dk/dv); the per-score work bounds these kernels, so
//     several blocks an SM hide its latencies: dq four at W 16 and three at
//     W 32 / 64, dk/dv (four accumulators: S^T, dP^T, dK, dV) three at W 16
//     / 32 and two at W 64 (kDqBlocksW, kDkvBlocksW; setmaxnreg splits the
//     launch registers as Split says). Two blocks an SM ran up to 19 %
//     slower at the LM's shapes, and a count that spills up to 6x (PERF.md);
//   * the streamed tiles pass through a ring of kStages stages with full /
//     empty mbarriers; the producer's waits trap after ~17 s, and after its
//     last load it waits until the consumer has released every stage;
//   * first products from shared memory, both operands K-major, in W / 16
//     k-steps of wgmma m64n64k16 (smem_desc_span<2 W>); second products with
//     A from registers (an accumulator's layout is the next A fragment's) and
//     B MN-major at N = W (wgmma_rs), the tile read along its rows, as the
//     narrow forward reads V;
//   * the epilogue stores only columns below D, at the row stride H D.
//
// dq: one block per (b * h, q tile of 64 rows), q tiles handed out longest
// first. Q, dO and the rows' lse / delta are loaded once; K and V tiles of
// 64 keys stream. Per tile: S = Q.K^T and dP = dO.V^T, P and dS in
// registers, dQ += dS_hi.K + dS_lo.K. Causal key tiles wholly in the q
// tile's future are skipped.
//
// dk/dv: one block per (b * h, key tile of 64), key tiles handed out in
// ascending order (under the causal mask key tile 0 sees every q tile:
// longest first). K and V are loaded once; Q and dO tiles of 64 rows stream,
// each stage carrying its rows' lse and delta in shared memory (written by
// the producer warpgroup's 128 threads, one value each, before they arrive
// on the stage's full barrier beside the TMA bytes). Per tile: S^T = K.Q^T
// and dP^T = V.dO^T, whose accumulators hold P^T and dS^T in the layout the
// next products take as A; dV += P^T_hi.dO + P^T_lo.dO and dK += dS^T_hi.Q
// + dS^T_lo.Q. Causal q tiles that cannot see the key tile are skipped (the
// q loop starts at the key tile's first key).
//
// Interface: p2pfl::launch_flash_bwd_dq_narrow_sm90 and
// p2pfl::launch_flash_bwd_dkv_narrow_sm90, called by p2pfl_flash_bwd_dq /
// p2pfl_flash_bwd_dkv in flash_attn.cu for bf16 below 64; they encode the
// tensor maps on each call, allocate nothing, launch on the given stream and
// return a CUDA error code (cudaErrorInvalidValue for a head size that is
// not a multiple of 8 in [8, 56], or a tensor map that cannot be encoded).

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 64;         // q rows of a dq block, and of a streamed Q / dO tile of dk/dv
constexpr int BK = 64;         // keys of a streamed K / V tile of dq, and of a dk/dv block
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's
constexpr int kStages = 2;     // the ring's depth

// Blocks an SM by box width W (scripts/torch_kernel_variants.py bwd_narrow
// times other values): the most that ptxas fits without a spill, but dq at
// W 32, whose four blocks spilled 132 bytes and ran 2-4 % slower than three.
template <int W>
constexpr int kDqBlocksW = W == 16 ? 4 : 3;
template <int W>
constexpr int kDkvBlocksW = W < 64 ? 3 : 2;

// setmaxnreg's split of the registers a block launches with (the register
// file's share, a multiple of 8 a thread) at BLOCKS blocks an SM: at four 64,
// split 24 / 104, at three 80 (24 / 136), at two 128 (40 / 216).
template <int BLOCKS>
struct Split {
  static constexpr int kLaunchRegs = 65536 / (BLOCKS * kThreads) / 8 * 8;
  static constexpr int kProducerRegs = BLOCKS > 2 ? 24 : 40;
  static constexpr int kFreeRegs = (kLaunchRegs * kThreads - 128 * kProducerRegs) / 128 / 8 * 8;
  static constexpr int kConsumerRegs = kFreeRegs < 232 ? kFreeRegs : 232;

  static_assert((kProducerRegs + kConsumerRegs) * 128 * BLOCKS <= 65536, "register file");
};

// Shared memory of both kernels: the two tiles loaded once (dq: Q, dO;
// dk/dv: K, V), then the ring's stages of two streamed tiles (dq: K, V;
// dk/dv: Q, dO), then (dk/dv only) each stage's lse and delta rows, then the
// barriers.
template <int W>
struct Tiles {
  static constexpr uint32_t kSpan = 2 * W;                         // bytes of one box row: the swizzle span
  static constexpr uint32_t kTileBytes = BQ * kSpan;               // one tile of 64 rows
  static constexpr uint32_t kRingBytes = (2 + 2 * kStages) * kTileBytes;
  static constexpr uint32_t kStatBytes = 2 * BQ * 4;               // a Q tile's lse rows, then its delta rows
  static constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr size_t kDqSmemBytes = 1024 + kRingBytes + kBarrierBytes;  // 1024: alignment slack
  static constexpr size_t kDkvSmemBytes = 1024 + kRingBytes + kStages * kStatBytes + kBarrierBytes;

  static_assert(W == 16 || W == 32 || W == 64, "box widths 16, 32 and 64");
  static_assert(BQ == BK, "one tile size for every role");
  static_assert(2 * BQ == 128, "the producer warpgroup's 128 threads load one lse or delta value each");
  static_assert(kTileBytes % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(kDqSmemBytes * kDqBlocksW<W> <= 232448 && kDkvSmemBytes * kDkvBlocksW<W> <= 232448,
                "shared memory of the blocks an SM holds");
};

static_assert(Tiles<16>::kDqSmemBytes == 13352 && Tiles<32>::kDqSmemBytes == 25640 &&
                  Tiles<64>::kDqSmemBytes == 50216 && Tiles<16>::kDkvSmemBytes == 14376 &&
                  Tiles<32>::kDkvSmemBytes == 26664 && Tiles<64>::kDkvSmemBytes == 51240,
              "tiles changed");

// acc = A.B^T over the box's W columns (zeros past D) in W / 16 k-steps of 16
// (32 bytes along the rows), both tiles K-major; issued, not committed.
template <int W>
__device__ __forceinline__ void issue_first(float (&acc)[32], uint32_t a_tile, uint32_t b_tile) {
  constexpr uint32_t span = Tiles<W>::kSpan;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_m64n64k16_ss(acc, smem_desc_span<span>(a_tile + 32 * kk), smem_desc_span<span>(b_tile + 32 * kk), kk > 0);
}

// acc += X_hi.B + X_lo.B over a tile's 64 rows: X's A fragments from
// registers (k-step kk takes pairs 4 kk .. 4 kk + 3), B the tile MN-major,
// rows of 16 of it 16 * 2 W bytes apart; issued, not committed.
template <int W>
__device__ __forceinline__ void issue_split(float (&acc)[W / 2], const uint32_t (&hi)[16], const uint32_t (&lo)[16],
                                            uint32_t tile) {
  constexpr uint32_t span = Tiles<W>::kSpan;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
             smem_desc_span<span>(tile + kk * 16 * span));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
             smem_desc_span<span>(tile + kk * 16 * span));
}

// Store mul * acc, one consumer thread's rows row0 and row0 + 8 of an
// m64nW accumulator, as bf16 into a [B, S, H, head_dim] tensor: columns
// below head_dim only, rows past S not at all.
template <int W>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&acc)[W / 2], float mul,
                                           int row0, int col0, int b, int h, int S, int H, int head_dim) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + ((int64_t(b) * S + row) * H + h) * head_dim;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j >= head_dim) break;  // head_dim is a multiple of 8: a pair is all in or all out
      const __nv_bfloat162 pair =
          __float22bfloat162_rn(make_float2(mul * acc[4 * j + 2 * i], mul * acc[4 * j + 2 * i + 1]));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) = pair;
    }
  }
}

// --- dq ---------------------------------------------------------------------------

// Where a dq block's tiles and barriers lie in shared memory, and its work.
// Each role computes it after its setmaxnreg, so that no value is live
// across the register split.
template <int W>
struct DqBlock {
  using T = Tiles<W>;
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_rows() const { return base; }
  __device__ uint32_t do_rows() const { return base + T::kTileBytes; }
  __device__ uint32_t k_tile(int s) const { return base + (2 + 2 * s) * T::kTileBytes; }
  __device__ uint32_t v_tile(int s) const { return k_tile(s) + T::kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + T::kRingBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t q_bar() const { return full_bar(2 * kStages); }
};

template <int W>
__device__ __forceinline__ DqBlock<W> dq_block(const uint8_t* smem, int Sk, int H, int causal) {
  DqBlock<W> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;             // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + BK - 1) / BK;
  return blk;
}

template <int W>
__global__ void __launch_bounds__(kThreads, kDqBlocksW<W>)
flash_bwd_dq_narrow_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int head_dim, float scale,
                                int causal) {
  using T = Tiles<W>;
  using R = Split<kDqBlocksW<W>>;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DqBlock<W> blk = dq_block<W>(smem_raw, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: one thread loads Q and dO, then keeps the K / V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::kProducerRegs));
    if (threadIdx.x == 128) {
      const DqBlock<W> blk = dq_block<W>(smem_raw, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), 2 * T::kTileBytes);
      tma_load(blk.q_rows(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      tma_load(blk.do_rows(), &tm_do, blk.h, blk.q0, blk.b, blk.q_bar());
      Ring ring;
      for (int t = 0; t < blk.n_tiles; ++t) {
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(ring.stage), 2 * T::kTileBytes);
        tma_load(blk.k_tile(ring.stage), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        tma_load(blk.v_tile(ring.stage), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        ring.next(kStages);
      }
      for (int t = 0; t < kStages; ++t) {  // outlive the consumer (see the top)
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);
        ring.next(kStages);
      }
    }
    return;
  }

  // Consumer: the block's 64 q rows from q0 on.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::kConsumerRegs));
  const DqBlock<W> blk = dq_block<W>(smem_raw, Sk, H, causal);
  const int tid = threadIdx.x;
  const int row0 = blk.q0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);

  float lse_r[2], delta_r[2];  // rows past Sq read 0: their dS is 0 and they are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse_r[i] = row < Sq ? lse[int64_t(blockIdx.x) * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[int64_t(blockIdx.x) * Sq + row] : 0.f;
  }
  float acc[W / 2];
#pragma unroll
  for (int e = 0; e < W / 2; ++e) acc[e] = 0.f;

  mbar_wait(blk.q_bar(), 0);
  Ring ring;
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(ring.stage), ring.phase);
    const uint32_t k_tile = blk.k_tile(ring.stage);

    // S = Q.K^T and dP = dO.V^T over the box's W columns, one group.
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
    issue_first<W>(sc, blk.q_rows(), k_tile);
    issue_first<W>(dp, blk.do_rows(), blk.v_tile(ring.stage));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // Scale and mask; keys past Sk get -inf, so that P is exactly 0 there
    // (TMA's zero rows would otherwise score 0).
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > blk.q0);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        if (col >= Sk) sc[e] = -INFINITY;
        else if (causal && col > row) sc[e] = MASK_VALUE;
      }
    }
    // dS = P * (dP - delta) with P = exp(S - lse), split into A fragments:
    // k-step kk of dS.K covers keys [16 kk, 16 kk + 16), pairs [4 kk, 4 kk + 4).
    uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = r % 2;
      const float d0 = expf(sc[2 * r] - lse_r[i]) * (dp[2 * r] - delta_r[i]);
      const float d1 = expf(sc[2 * r + 1] - lse_r[i]) * (dp[2 * r + 1] - delta_r[i]);
      split_bf16x2(d0, d1, ds_hi[r], ds_lo[r]);
    }

    // dQ += dS_hi.K + dS_lo.K, K MN-major.
    fence_regs(acc);
    wgmma_fence();
    issue_split<W>(acc, ds_hi, ds_lo, k_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(ring.stage));  // this stage's K and V are no longer read
    ring.next(kStages);
  }

  store_rows<W>(dq, acc, scale, row0, col0, blk.b, blk.h, Sq, H, head_dim);
}

// --- dk / dv ------------------------------------------------------------------------

template <int W>
struct DkvBlock {
  using T = Tiles<W>;
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, k0, q_begin, n_tiles;

  __device__ uint32_t k_rows() const { return base; }
  __device__ uint32_t v_rows() const { return base + T::kTileBytes; }
  __device__ uint32_t q_tile(int s) const { return base + (2 + 2 * s) * T::kTileBytes; }
  __device__ uint32_t do_tile(int s) const { return q_tile(s) + T::kTileBytes; }
  __device__ uint32_t stats(int s) const { return base + T::kRingBytes + s * T::kStatBytes; }
  __device__ uint32_t full_bar(int s) const { return base + T::kRingBytes + kStages * T::kStatBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t kv_bar() const { return full_bar(2 * kStages); }
};

template <int W>
__device__ __forceinline__ DkvBlock<W> dkv_block(const uint8_t* smem, int Sq, int H, int causal) {
  DkvBlock<W> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.k0 = blockIdx.y * BK;           // ascending: the longest causal tiles first
  blk.q_begin = causal ? blk.k0 : 0;  // causal: q tiles that cannot see these keys skipped
  blk.n_tiles = max(0, (Sq - blk.q_begin + BQ - 1) / BQ);
  return blk;
}

template <int W>
__global__ void __launch_bounds__(kThreads, kDkvBlocksW<W>)
flash_bwd_dkv_narrow_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                                 int H, int head_dim, float scale, int causal) {
  using T = Tiles<W>;
  using R = Split<kDkvBlocksW<W>>;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DkvBlock<W> blk = dkv_block<W>(smem_raw, Sq, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 128);  // every producer thread: 127 after their row statistic, one with the bytes
      mbar_init(blk.empty_bar(s), 128);
    }
    mbar_init(blk.kv_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: thread 0 loads K and V, then each stage's Q and dO tiles;
    // thread p writes the stage's lse (p < 64) or delta (p >= 64) of row p % 64.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::kProducerRegs));
    const DkvBlock<W> blk = dkv_block<W>(smem_raw, Sq, H, causal);
    const int p = threadIdx.x - 128;
    if (p == 0) {
      mbar_expect_tx(blk.kv_bar(), 2 * T::kTileBytes);
      tma_load(blk.k_rows(), &tm_k, blk.h, blk.k0, blk.b, blk.kv_bar());
      tma_load(blk.v_rows(), &tm_v, blk.h, blk.k0, blk.b, blk.kv_bar());
    }
    const float* stat = (p < BQ ? lse : delta) + int64_t(blockIdx.x) * Sq;
    Ring ring;
    for (int t = 0; t < blk.n_tiles; ++t) {
      const int q0 = blk.q_begin + t * BQ;
      mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);  // the first pass finds every stage free
      const int row = q0 + p % BQ;
      sts_f32(blk.stats(ring.stage) + 4 * p, row < Sq ? stat[row] : 0.f);  // rows past Sq: P is 0 there anyway
      if (p == 0) {
        mbar_expect_tx(blk.full_bar(ring.stage), 2 * T::kTileBytes);
        tma_load(blk.q_tile(ring.stage), &tm_q, blk.h, q0, blk.b, blk.full_bar(ring.stage));
        tma_load(blk.do_tile(ring.stage), &tm_do, blk.h, q0, blk.b, blk.full_bar(ring.stage));
      } else {
        mbar_arrive(blk.full_bar(ring.stage));
      }
      ring.next(kStages);
    }
    if (p == 0) {
      for (int t = 0; t < kStages; ++t) {  // outlive the consumer (see the top)
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);
        ring.next(kStages);
      }
    }
    return;
  }

  // Consumer: the block's 64 keys from k0 on; its accumulators hold rows =
  // keys, columns = q rows of the streamed tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::kConsumerRegs));
  const DkvBlock<W> blk = dkv_block<W>(smem_raw, Sq, H, causal);
  const int tid = threadIdx.x;
  const int key0 = blk.k0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (tid % 4);

  float dk_acc[W / 2], dv_acc[W / 2];
#pragma unroll
  for (int e = 0; e < W / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  mbar_wait(blk.kv_bar(), 0);
  Ring ring;
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int q0 = blk.q_begin + t * BQ;
    mbar_spin(blk.full_bar(ring.stage), ring.phase);
    const uint32_t q_tile = blk.q_tile(ring.stage), do_tile = blk.do_tile(ring.stage);

    // S^T = K.Q^T and dP^T = V.dO^T over the box's W columns, one group.
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    wgmma_fence();
    issue_first<W>(st, blk.k_rows(), q_tile);
    issue_first<W>(dpt, blk.v_rows(), do_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Scale and mask (q before key); q rows past Sq get -inf, so that P is
    // exactly 0 there.
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= scale;
    const bool edge = q0 + BQ > Sq || (causal && q0 < blk.k0 + BK - 1);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qpos = q0 + 8 * (e / 4) + col0 + (e % 2);
        const int key = key0 + 8 * ((e / 2) % 2);
        if (qpos >= Sq) st[e] = -INFINITY;
        else if (causal && qpos < key) st[e] = MASK_VALUE;
      }
    }
    // P^T = exp(S^T - lse_col), dS^T = P^T * (dP^T - delta_col), each split
    // into A fragments: k-step kk covers q columns [16 kk, 16 kk + 16), pairs
    // [4 kk, 4 kk + 4). This thread's columns are 8 j + col0 + {0, 1}.
    uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
    const uint32_t stats = blk.stats(ring.stage);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = lds_f2(stats + 4 * (8 * j + col0));
      const float2 dl = lds_f2(stats + 4 * (BQ + 8 * j + col0));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
        const float p0 = expf(st[e] - l.x), p1 = expf(st[e + 1] - l.y);
        split_bf16x2(p0, p1, p_hi[2 * j + i], p_lo[2 * j + i]);
        split_bf16x2(p0 * (dpt[e] - dl.x), p1 * (dpt[e + 1] - dl.y), ds_hi[2 * j + i], ds_lo[2 * j + i]);
      }
    }

    // dV += P^T_hi.dO + P^T_lo.dO and dK += dS^T_hi.Q + dS^T_lo.Q; dO and Q
    // MN-major.
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
    issue_split<W>(dv_acc, p_hi, p_lo, do_tile);
    issue_split<W>(dk_acc, ds_hi, ds_lo, q_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(ring.stage));  // this stage's Q, dO and row statistics are no longer read
    ring.next(kStages);
  }

  store_rows<W>(dk, dk_acc, scale, key0, col0, blk.b, blk.h, Sk, H, head_dim);
  store_rows<W>(dv, dv_acc, 1.f, key0, col0, blk.b, blk.h, Sk, H, head_dim);
}

// --- host side -------------------------------------------------------------------

// The four tensor maps on the true head size: q and dO in boxes of BQ rows,
// k and v in boxes of BK, W columns each.
template <int W>
cudaError_t encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout,
                        int B, int Sq, int Sk, int H, int head_dim) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_bshd_box(encode, &maps[0], q, B, Sq, H, head_dim, BQ, W) &&
                  encode_bshd_box(encode, &maps[1], k, B, Sk, H, head_dim, BK, W) &&
                  encode_bshd_box(encode, &maps[2], v, B, Sk, H, head_dim, BK, W) &&
                  encode_bshd_box(encode, &maps[3], dout, B, Sq, H, head_dim, BQ, W);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <int W>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int Sq, int Sk, int H, int head_dim, float scale,
                      bool causal, cudaStream_t stream) {
  using R = Split<kDqBlocksW<W>>;
  const auto kern = flash_bwd_dq_narrow_sm90_kernel<W>;
  // Once per instance: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads,
                                                    R::kProducerRegs, R::kConsumerRegs, 1, Tiles<W>::kDqSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_maps<W>(maps, q, k, v, dout, B, Sq, Sk, H, head_dim);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, kThreads, Tiles<W>::kDqSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                            static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, head_dim,
                                                            scale, causal ? 1 : 0);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int head_dim,
                       float scale, bool causal, cudaStream_t stream) {
  using R = Split<kDkvBlocksW<W>>;
  const auto kern = flash_bwd_dkv_narrow_sm90_kernel<W>;
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads,
                                                    R::kProducerRegs, R::kConsumerRegs, 1, Tiles<W>::kDkvSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_maps<W>(maps, q, k, v, dout, B, Sq, Sk, H, head_dim);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  kern<<<grid, kThreads, Tiles<W>::kDkvSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                             static_cast<__nv_bfloat16*>(dk),
                                                             static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, head_dim,
                                                             scale, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / dout / dq with head_dim a multiple of
// 8 in [8, 56], 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dq_narrow_sm90(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                                            int H, int head_dim, float scale, bool causal, cudaStream_t stream) {
  if (head_dim < 8 || head_dim > 56 || head_dim % 8 != 0) return cudaErrorInvalidValue;
  if (head_dim <= 16) return launch_dq<16>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, head_dim, scale, causal, stream);
  if (head_dim <= 32) return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, head_dim, scale, causal, stream);
  return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, head_dim, scale, causal, stream);
}

// bf16 [B, S, H, head_dim] q / k / v / dout / dk / dv with head_dim a
// multiple of 8 in [8, 56], 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dkv_narrow_sm90(const void* q, const void* k, const void* v, const void* dout,
                                             const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                             int Sk, int H, int head_dim, float scale, bool causal,
                                             cudaStream_t stream) {
  if (head_dim < 8 || head_dim > 56 || head_dim % 8 != 0) return cudaErrorInvalidValue;
  if (head_dim <= 16)
    return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, head_dim, scale, causal, stream);
  if (head_dim <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, head_dim, scale, causal, stream);
  return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, head_dim, scale, causal, stream);
}

}  // namespace p2pfl
