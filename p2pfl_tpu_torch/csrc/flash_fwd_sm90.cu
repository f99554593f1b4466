// Flash-attention forward for Hopper's tensor cores (sm_90a): the bf16
// forward, with and without the per-row logsumexp, and ring attention's bf16
// fold of one kv chunk into an online-softmax carry.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_fwd_sm90<with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd_sm90<with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
//   flash_carry_sm90                <- _flash_carry_kernel    (pallas_call at :590)
// for bf16 inputs at head size 64. The bf16 forward at head sizes 128 and
// 256 is flash_fwd_wide_sm90.cu's, this design with each row split into
// 64-column panels (a template of its own, so that the code here stays as
// it was measured). The f32 forward and carry fold stay the CUDA-core
// kernels of flash_attn.cu: f32 parity holds them to 1e-5 and forbids TF32.
//
// What it computes is what the TPU kernel computes, with one difference in
// rounding. Scores S = Q.K^T are exact bf16 products summed in f32 by wgmma
// and then scaled by 1/sqrt(64) = 2^-3; a power of two, so this equals the
// reference's (q * scale) . k up to the order of the f32 sums. The causal
// mask writes -0.7 * FLT_MAX (columns past Sk: -inf), the online softmax
// uses expf, l is clamped at 1e-30 and lse = m + log(l), as in the
// reference. The one new choice is P . V: the tensor cores take bf16
// operands, so the f32 probabilities are split as P = P_hi + P_lo with
// P_hi = bf16(P), P_lo = bf16(P - P_hi), and both halves are multiplied
// with V into the same f32 accumulator. P_hi + P_lo equals P to within
// 2^-17 P, so the product keeps ~16 bits of P, where a single bf16 P would
// keep 8 (the usual FlashAttention choice, a different function). The
// checks hold the output to 1 bf16 ulp + 2^-15 sum_j (p_j / l) |v_j| of
// the plain version.
//
// The carry fold runs the same tile loop from an incoming carry (m, l, acc)
// f32 and leaves it unnormalized: m_new = max(m_in, rowmax S), l = corr l_in
// + sum p, acc = corr acc_in + P.V, with no clamp and no log; q rows sit at
// global positions q_offset + [0, Sq) and keys at kv_offset + [0, Sk), and
// the causal mask and the future-tile skip compare those. Its acc is held to
// the plain version's within 1e-5 + 1e-5 |ref| + 1e-6 l + 2^-15 of the
// fold's mass exp(S - m_new) @ |V| (ops/attention.py plain_flash_chunk_mass).
//
// What bounds it on this card: at the slice's shapes ([8, 1024, 8, 64]
// causal; [16, 1024, 8, 64] for the forward without lse) the algorithm does
// ~254 FLOP per byte of q, k, v and out, under the H100's bf16 ridge (~295),
// so its bound is the bytes (~10 / 20 us at 3.35 TB/s). The split adds half
// again to the tensor cores' work, and the online softmax costs one expf
// and a handful of other CUDA-core instructions per score, so the kernel
// is held above that bound by its per-score arithmetic on the CUDA cores
// rather than by the tensor cores or memory. The carry fold at the ring's
// chunk shape ([2, 1024, 8, 64], a past chunk) is bound by its bytes too
// (~4.5 us: q, k, v in bf16 and the f32 carry read and written once), but
// its grid is one wave of 128 blocks on 132 SMs, each walking every key
// tile of the chunk, so the slowest block's 8 tile steps set its time.
//
// Design:
//   * one block per (b * h, q tile of 128 rows); q tiles are handed out
//     longest first (the last causal tile walks the most k tiles), a cheap
//     longest-job-first order against the causal imbalance;
//   * three warpgroups: warpgroup 2 is the producer (one thread issues TMA
//     loads; setmaxnreg gives its registers away), warpgroups 0 and 1 are
//     consumers of 64 q rows each (setmaxnreg raises them to 232);
//   * Q is loaded once; K and V tiles of 128 keys stream through a ring of
//     kStages stages with full / empty mbarriers;
//   * TMA reads the API's [B, S, H, D] tensors directly through 4-D tensor
//     maps (dims {D, H, S, B}, box {64, 1, 128, 1}) with the 128-byte
//     swizzle (one bf16 row of D = 64 is 128 bytes, the swizzle atom);
//     rows past S are zero-filled, and the mask gives their columns -inf;
//   * S = Q.K^T: wgmma m64n128k16, 4 k-steps, both operands K-major in
//     shared memory, f32 accumulator in registers;
//   * the online softmax runs in the accumulator's register layout (two
//     rows per thread, row max over the 4-lane quad by shuffles);
//   * O += P_hi.V + P_lo.V: wgmma m64n64k16 with A from registers (the S
//     accumulator's layout is the next A fragment's layout) and B the V
//     tile, MN-major in shared memory (transposed operand);
//   * causal k tiles wholly in a q tile's future are skipped;
//   * the carry fold runs the same tile step (its own copy, carry_tile,
//     with the mask on global positions), reads its incoming m, l and acc
//     once, straight into the registers the loop keeps them in (acc as
//     float2 in the accumulator layout), and writes the new carry from
//     there, in f32, to separate buffers (plain stores: a TMA store is
//     later work).
//
// The PTX wrappers, the tensor-map encoder and the launch guard are in
// sm90_common.cuh, shared with the backward pair (flash_bwd_sm90.cu).
//
// Interface: host functions called by p2pfl_flash_fwd and p2pfl_flash_carry
// in flash_attn.cu, which encode the tensor maps on each call, launch on the
// given stream and return a CUDA error code (cudaErrorInvalidValue if a
// tensor map cannot be encoded).

#include "sm90_common.cuh"

#include <algorithm>

namespace {

constexpr int BQ = 128;               // q rows per block (two consumer warpgroups of 64)
constexpr int BK = 128;               // keys per K / V tile
constexpr int kStages = 2;            // K / V ring depth
constexpr int kConsumers = 2;         // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kQBytes = BQ * kRowBytes;              // 16 KB
constexpr uint32_t kTileBytes = BK * kRowBytes;           // 16 KB for K, as much for V
constexpr uint32_t kStageBytes = 2 * kTileBytes;
constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
constexpr size_t kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + kBarrierBytes;  // 1024: alignment slack

static_assert(BQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");

// --- the kernels ---------------------------------------------------------------
//
// (The accumulator layout of wgmma, which the softmax below walks, is
// written out in sm90_common.cuh.)

// Where a block's tiles and barriers lie in shared memory, and its work.
// Each role computes it after its setmaxnreg, so that no value is live
// across the register split (one that is gets spilled to local memory).
struct Block {
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_tile() const { return base; }
  __device__ uint32_t k_tile(int s) const { return base + kQBytes + s * kStageBytes; }
  __device__ uint32_t v_tile(int s) const { return k_tile(s) + kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + kQBytes + kStages * kStageBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t q_bar() const { return full_bar(2 * kStages); }
};

__device__ __forceinline__ Block this_block(const uint8_t* smem, int Sk, int H, int causal) {
  Block blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;             // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + BK - 1) / BK;
  return blk;
}

// The carry fold's block: its causal skip compares global positions, so a
// key tile is in the q tile's future when kv_offset + k0 >= q_offset + q0 +
// BQ, i.e. k_end = q0 + BQ + diag with diag = q_offset - kv_offset; a q
// tile that sees no key of the chunk (k_end <= 0) runs no tile.
__device__ __forceinline__ Block carry_block(const uint8_t* smem, int Sk, int H, int causal, int diag) {
  Block blk = this_block(smem, Sk, H, causal);
  if (causal) blk.n_tiles = max(0, (min(Sk, blk.q0 + BQ + diag) + BK - 1) / BK);
  return blk;
}

// The carry fold's step over one K / V tile, for one consumer warpgroup's
// 64 q rows: S = Q.K^T, scale and mask, the running max m and this thread's
// share of l updated and o rescaled, then O += P_hi.V + P_lo.V. It is the
// forward's loop body (flash_fwd_sm90_kernel below) with the causal mask
// moved to global positions: rows and columns are positions within the
// chunk (this thread's q rows row0 and row0 + 8; keys k0 + ...), and key
// col is masked for q row `row` when col > row + diag, where diag =
// q_offset - kv_offset. A copy, not a function the forward calls too:
// sharing one changed the forward's register allocation and schedule (same
// instruction count, registers and HGMMA; cuobjdump -sass against the
// forward before the carry kernel existed), and the forward must stay as it
// was measured.
__device__ __forceinline__ void carry_tile(float (&o)[32], float (&m)[2], float (&l_part)[2], const Block& blk,
                                           int s, int k0, uint32_t q_rows, int wg, int row0, int col0, int Sk,
                                           float scale, int causal, int diag) {
  // S = Q . K^T over D = 64 in 4 k-steps of 16 (32 bytes along the row).
  float sc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) sc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(sc, smem_desc(q_rows + 32 * kk), smem_desc(blk.k_tile(s) + 32 * kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);

  // Scale, mask, and the online softmax, two rows per thread.
#pragma unroll
  for (int e = 0; e < 64; ++e) sc[e] *= scale;
  const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > blk.q0 + 64 * wg + diag);
  if (edge) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
      const int row = row0 + 8 * ((e / 2) % 2);
      if (col >= Sk) sc[e] = -INFINITY;  // ragged tail: no contribution
      else if (causal && col > row + diag) sc[e] = MASK_VALUE;
    }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = quad_max(mx);
    corr[i] = expf(m[i] - mx);
    m[i] = mx;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(sc[4 * j + 2 * i + c] - mx);
        sc[4 * j + 2 * i + c] = p;
        ps += p;
      }
    }
    l_part[i] = corr[i] * l_part[i] + ps;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] *= corr[(e / 2) % 2];

  // P as A fragments: k-step kk of P . V covers keys [16 kk, 16 kk + 16),
  // which are accumulator elements [8 kk, 8 kk + 8) in fragment order.
  uint32_t p_hi[32], p_lo[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) split_bf16x2(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

  // O += P_hi . V + P_lo . V; V rows of 16 keys are 2048 bytes apart.
  const uint32_t v_tile = blk.v_tile(s);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n64k16_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
                       smem_desc(v_tile + kk * 16 * kRowBytes));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n64k16_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                       smem_desc(v_tile + kk * 16 * kRowBytes));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(p_hi);
  fence_regs(p_lo);
}

template <bool WITH_LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block blk = this_block(smem_raw, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread keeps the K / V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block blk = this_block(smem_raw, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), kQBytes);
      tma_load(blk.q_tile(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      for (int t = 0; t < blk.n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(s), kStageBytes);
        tma_load(blk.k_tile(s), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(s));
        tma_load(blk.v_tile(s), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(s));
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = this_block(smem_raw, Sk, H, causal);
  const int b = blk.b, h = blk.h, q0 = blk.q0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = blk.q_tile() + wg * 64 * kRowBytes;

  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this thread's share of l; summed over the quad at the end

  mbar_wait(blk.q_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S = Q . K^T over D = 64 in 4 k-steps of 16 (32 bytes along the row).
    float sc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(sc, smem_desc(q_rows + 32 * kk), smem_desc(blk.k_tile(s) + 32 * kk),
                          kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scale, mask, and the online softmax, two rows per thread.
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + 64 * wg);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        if (col >= Sk) sc[e] = -INFINITY;  // ragged tail: no contribution
        else if (causal && col > row) sc[e] = MASK_VALUE;
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = quad_max(mx);
      corr[i] = expf(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(sc[4 * j + 2 * i + c] - mx);
          sc[4 * j + 2 * i + c] = p;
          ps += p;
        }
      }
      l_part[i] = corr[i] * l_part[i] + ps;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= corr[(e / 2) % 2];

    // P as A fragments: k-step kk of P . V covers keys [16 kk, 16 kk + 16),
    // which are accumulator elements [8 kk, 8 kk + 8) in fragment order.
    uint32_t p_hi[32], p_lo[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) split_bf16x2(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

    // O += P_hi . V + P_lo . V; V rows of 16 keys are 2048 bytes apart.
    const uint32_t v_tile = blk.v_tile(s);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
                         smem_desc(v_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                         smem_desc(v_tile + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(blk.empty_bar(s));  // this stage's K and V are no longer read
  }

  // Epilogue: out = acc / max(l, 1e-30) in bf16; lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l_safe = fmaxf(quad_sum(l_part[i]), 1e-30f);
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + ((int64_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 pair =
          __float22bfloat162_rn(make_float2(o[4 * j + 2 * i] / l_safe, o[4 * j + 2 * i + 1] / l_safe));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) = pair;
    }
    if (WITH_LSE && col0 == 0) lse[int64_t(blockIdx.x) * Sq + row] = m[i] + logf(l_safe);
  }
}

// Ring attention's fold of one kv chunk into the carry (m, l [B, H, Sq];
// acc [B, Sq, H, D]; f32), the forward's roles and tile loop around an
// incoming carry. Where trouble lies:
//   * Q and n_tiles == 0: a q tile that sees no key of the chunk (a chunk
//     wholly in its future) still has its Q loaded by the producer and
//     waited on by the consumers, so that no consumer waits on a barrier
//     nobody arrives on (the consumers' tile wait is unguarded: its hang
//     guard made ptxas spill in the forward); the carry then goes back out
//     bit-identical (l is l_in + 0 + 0 + 0 over the quad);
//   * the producer outlives the consumers, as in the backward pair: after
//     its last load it waits until every stage is released, so a consumer
//     stuck on a tile traps there (~17 s) instead of hanging the card;
//   * rows whose first processed tile holds no real key: a row with
//     m_in = -inf whose first tile is all masked gets m = MASK_VALUE and
//     p = 1 per masked key, as the reference and the plain version do, but
//     the result then depends on the tile size (128 keys here, 64 in the
//     CUDA-core kernel). The ring never folds such a chunk: it folds the
//     self chunk first, and kv_offset <= q_offset on every fold it does not
//     skip, so every row sees key 0 of the chunk in its first tile;
//   * one wave: at the ring's chunk shape the grid is B * H x Sq / 128 =
//     16 x 8 = 128 blocks on 132 SMs, and a past fold walks all 8 key tiles
//     in every block (the diagonal fold's last q tile too), so the past and
//     the diagonal fold take about as long, and the longest-first order buys
//     nothing within one wave.
__global__ void __launch_bounds__(kThreads, 1)
flash_carry_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, const float* __restrict__ acc_in,
                        float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out, int Sq,
                        int Sk, int H, float scale, int causal, int diag) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block blk = this_block(smem_raw, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread loads Q (always, see above), keeps the K / V ring
    // full, then outlives the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block blk = carry_block(smem_raw, Sk, H, causal, diag);
      mbar_expect_tx(blk.q_bar(), kQBytes);
      tma_load(blk.q_tile(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      for (int t = 0; t < blk.n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(s), kStageBytes);
        tma_load(blk.k_tile(s), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(s));
        tma_load(blk.v_tile(s), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(s));
      }
      for (int t = blk.n_tiles; t < blk.n_tiles + kStages; ++t)
        mbar_wait(blk.empty_bar(t % kStages), ((t / kStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = carry_block(smem_raw, Sk, H, causal, diag);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = blk.q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = blk.q_tile() + wg * 64 * kRowBytes;
  const int64_t bh = blockIdx.x;  // b * H + h: the row statistics' [B, H, Sq] slice

  // Prologue: the incoming carry, read once into the loop's registers. acc
  // lands in the accumulator layout (pairs of columns 8 j + col0, as
  // float2); l is kept as this thread's share, as the forward keeps it:
  // l_in on the quad's lane with col0 == 0 and 0 on the other three (corr
  // is the same on all four, so the quad's sum at the end is the fold's l).
  // Rows past Sq start empty and are not stored.
  float o[32], m[2], l_part[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < Sq;
    m[i] = in ? m_in[bh * Sq + row] : -INFINITY;
    l_part[i] = in && col0 == 0 ? l_in[bh * Sq + row] : 0.f;
    const float* arow = acc_in + ((int64_t(blk.b) * Sq + row) * H + blk.h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 a = in ? *reinterpret_cast<const float2*>(arow + 8 * j) : make_float2(0.f, 0.f);
      o[4 * j + 2 * i] = a.x;
      o[4 * j + 2 * i + 1] = a.y;
    }
  }

  mbar_wait(blk.q_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);
    carry_tile(o, m, l_part, blk, s, k0, q_rows, wg, row0, col0, Sk, scale, causal, diag);
    mbar_arrive(blk.empty_bar(s));  // this stage's K and V are no longer read
  }

  // Epilogue: the new carry, unnormalized and in f32: m, the quad-summed l
  // (no clamp, no log) and acc as float2 pairs.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l = quad_sum(l_part[i]);
    if (row >= Sq) continue;
    if (col0 == 0) {
      m_out[bh * Sq + row] = m[i];
      l_out[bh * Sq + row] = l;
    }
    float* arow = acc_out + ((int64_t(blk.b) * Sq + row) * H + blk.h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(arow + 8 * j) = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
  }
}

// --- host side -------------------------------------------------------------------

// Once per instance: the shared-memory limit and the register-split guard.
template <bool WITH_LSE>
cudaError_t prepare() {
  static const cudaError_t status =
      prepare_split(reinterpret_cast<const void*>(flash_fwd_sm90_kernel<WITH_LSE>), kThreads, kProducerRegs,
                    kConsumerRegs, kConsumers, kSmemBytes);
  return status;
}

template <bool WITH_LSE>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o, float* lse,
                   int B, int Sq, int Sk, int H, float scale, bool causal, cudaStream_t stream) {
  const cudaError_t e = prepare<WITH_LSE>();
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd_sm90_kernel<WITH_LSE><<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t prepare_carry() {
  static const cudaError_t status =
      prepare_split(reinterpret_cast<const void*>(flash_carry_sm90_kernel), kThreads, kProducerRegs,
                    kConsumerRegs, kConsumers, kSmemBytes);
  return status;
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, 64] q / k / v / o, 16-byte aligned; lse [B, H, Sq] f32 or
// nullptr (the forward that writes no logsumexp).
cudaError_t launch_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                  int Sq, int Sk, int H, float scale, bool causal, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, Sq, H, BQ) || !encode_bshd(encode, &tk, k, B, Sk, H, BK) ||
      !encode_bshd(encode, &tv, v, B, Sk, H, BK))
    return cudaErrorInvalidValue;
  return lse != nullptr ? launch<true>(tq, tk, tv, o, lse, B, Sq, Sk, H, scale, causal, stream)
                        : launch<false>(tq, tk, tv, o, nullptr, B, Sq, Sk, H, scale, causal, stream);
}

// bf16 [B, S, H, 64] q / k / v, 16-byte aligned; m / l [B, H, Sq] and acc
// [B, Sq, H, 64] f32, acc 8-byte aligned; *_in and *_out must not overlap.
cudaError_t launch_flash_carry_sm90(const void* q, const void* k, const void* v, const float* m_in,
                                    const float* l_in, const float* acc_in, float* m_out, float* l_out,
                                    float* acc_out, int B, int Sq, int Sk, int H, float scale, bool causal,
                                    int q_offset, int kv_offset, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, Sq, H, BQ) || !encode_bshd(encode, &tk, k, B, Sk, H, BK) ||
      !encode_bshd(encode, &tv, v, B, Sk, H, BK))
    return cudaErrorInvalidValue;
  const cudaError_t e = prepare_carry();
  if (e != cudaSuccess) return e;
  // The kernel masks key col for q row `row` (chunk positions) when col >
  // row + diag. Rows run below Sq + BQ and columns below Sk, so any diag
  // past either end of [-(Sq + BQ), Sk] masks (and skips tiles) as that end
  // does; the clamp keeps row + diag and q0 + BQ + diag inside int.
  const long long diag = std::min<long long>(Sk, std::max<long long>(-(Sq + BQ), (long long)q_offset - kv_offset));
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_carry_sm90_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, m_in, l_in, acc_in, m_out, l_out, acc_out, Sq, Sk, H, scale, causal ? 1 : 0, int(diag));
  return cudaGetLastError();
}

}  // namespace p2pfl
