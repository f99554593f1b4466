// Flash-attention backward for Hopper's tensor cores (sm_90a) at head sizes
// 128 and 256: the bf16 dq kernel and the bf16 dk/dv kernel.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_bwd_dq_wide_sm90_kernel<D>   <- _flash_bwd_dq_kernel   (pallas_call at :446)
//   flash_bwd_dkv_wide_sm90_kernel<D>  <- _flash_bwd_dkv_kernel  (pallas_call at :463)
// for bf16 inputs at D = 128 and 256 (ops/_kernels.py zero-pads 64 < D <
// 128 to 128 and 128 < D < 256 to 256). D = 64 is flash_bwd_sm90.cu's pair,
// which this one follows; it is a template of its own so that the D = 64
// kernels keep their code. The f32 backward at every width stays the
// CUDA-core pair of flash_attn.cu.
//
// What it computes is what flash_bwd_sm90.cu computes (its header), from
// the forward's lse and delta = rowsum(dO * O) (f32, [B, H, Sq]) and dO in
// bf16: S = Q.K^T and dP = dO.V^T are exact bf16 products summed in f32 by
// wgmma; S is then multiplied by the scale 1/sqrt(D) in f32 (not a power of
// two at these D, so this rounds once where the reference's (q * scale) . k
// rounds each q element first, as in flash_fwd_wide_sm90.cu); causal-masked
// entries get -0.7 * FLT_MAX, P = expf(S - lse), P = 0 exactly for keys
// (queries) past the sequence, dS = P * (dP - delta), all in f32 in the
// accumulators' registers. The second products take their f32 A operand
// (dS in dq; P^T and dS^T in dk/dv) split as X_hi + X_lo in bf16 into one
// f32 accumulator; dq = scale * acc, dk = scale * dK, dv = dV. The checks
// hold each gradient to 1 bf16 ulp + 2^-15 of its weighted mass
// (ops/attention.py plain_flash_grad_mass) of the plain version.
//
// What bounds it on this card: at the paths' shapes ([8, 1024, 4, 128] and
// [8, 1024, 2, 256], causal) the FLOPs and bytes are those of the D = 64
// pair at [8, 1024, 8, 64]: above the bf16 ridge, so the bound is the
// operations (~13 / 17 us at 989 TFLOP/s). Per score the CUDA cores do an
// expf, the mask on edge tiles, dS and one or two splits, as at D = 64, but
// each score now costs the tensor cores two or four times as many products.
//
// Design (flash_bwd_sm90.cu's, with D split into panels as in
// flash_fwd_wide_sm90.cu):
//   * three warpgroups: a TMA producer (setmaxnreg 40) and two consumers
//     (setmaxnreg 232); full / empty mbarrier rings of kStages stages; the
//     producer's waits trap after ~17 s, and after its last load it waits
//     until the consumers have released every stage;
//   * every tile is D / 64 panels: TMA boxes {64, 1, rows, 1} of one tensor
//     map over [B, S, H, D] (sm90_common.cuh encode_bshd, tma_load's
//     column), each landing as its own rows x 128-byte swizzled panel; the
//     first products walk the panels (k-step kk reads 32 bytes at 32 (kk %
//     4) of panel kk / 4 of both operands); the second products run one
//     wgmma m64n64k16 per 64-column panel of their B operand into that
//     panel's 32-register slice of the accumulator (A from registers, B
//     MN-major, rows of 16 keys or q positions 2048 bytes apart).
//
// dq: one block per (b * h, q tile of 128 rows: a consumer owns 64), q tiles
// handed out longest first; Q and dO (and each thread's lse / delta) are
// loaded once, K and V tiles of BK keys stream. A consumer holds dQ for its
// 64 rows, D / 2 f32 a thread (64 at D 128, 128 at D 256), beside S and dP
// (BK / 2 each) and dS's halves (BK / 4 words each): BK = 64 at D 128
// (wgmma m64n64k16) and BK = 32 at D 256 (m64n32k16) keep that under
// setmaxnreg's 232. Shared memory: Q 32 + dO 32 + 2 x (K 16 + V 16) = 128 KB
// at D 128, 64 + 64 + 2 x (16 + 16) = 192 KB at D 256, of the 227 KB a
// block has. Causal k tiles wholly in the q tile's future are skipped.
//
// dk/dv: one block per (b * h, k tile of BK keys), k tiles handed out in
// ascending order (under the causal mask k tile 0 sees every q tile); K and
// V are loaded once, Q and dO tiles of BQ = 32 rows stream, each stage
// carrying its rows' lse and delta in shared memory (written by the
// producer warpgroup's threads before they arrive on the stage's full
// barrier). A consumer holds dK and dV for 64 keys over two 64-column
// panels: 2 x 2 x 32 = 128 f32 a thread, beside S^T and dP^T (BQ / 2 each)
// and the four split halves (BQ / 4 words each), 192 in all. At D 128 that
// is all of a key's columns, so the block takes BK = 128 keys, 64 per
// consumer. At D 256 dK and dV for 64 keys are 256 f32 a thread, more than
// 232: both consumers take the same BK = 64 keys and each owns one half of
// D's columns of both dK and dV (panels 2 wg and 2 wg + 1), computing S^T
// and dP^T over all of D itself. That keeps one code path and one register
// budget for both D, and costs the first products twice per block (8 units
// of tensor work per tile where the alternative, one consumer owning dV
// from P^T alone and the other dK, needs 7 but takes 4 on one consumer and
// 3 on the other, so its critical path is no shorter). Per q tile: S^T =
// K.Q^T and dP^T = V.dO^T (wgmma m64n32k16 over D / 16 k-steps), P^T and
// dS^T in registers, dV[:, p] += P^T_hi.dO[:, p] + P^T_lo.dO[:, p] and
// dK[:, p] += dS^T_hi.Q[:, p] + dS^T_lo.Q[:, p] for the consumer's two
// panels p. Shared memory: K 32 + V 32 + 2 x (Q 8 + dO 8) KB = 96 KB at D
// 128; 32 + 32 + 2 x (16 + 16) = 128 KB at D 256. Causal q tiles that
// cannot see the k tile are skipped (the q loop starts at floor(k0 / 32) *
// 32).
//
// Interface: p2pfl::launch_flash_bwd_dq_wide_sm90 and
// launch_flash_bwd_dkv_wide_sm90, called by p2pfl_flash_bwd_dq /
// p2pfl_flash_bwd_dkv in flash_attn.cu for bf16; each encodes the tensor
// maps on each call, launches on the given stream and returns a CUDA error
// code (cudaErrorInvalidValue if a tensor map cannot be encoded or the head
// size is not 128 or 256).

#include "sm90_common.cuh"

namespace {

constexpr int kStages = 2;     // depth of the streamed operands' ring
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPanelCols = 64;  // the columns of one TMA box and one 128-byte swizzled panel
constexpr uint32_t kKStepRows = 16 * kRowBytes;  // an MN-major operand's k-step: 16 rows of a panel

static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");
static_assert(kPanelCols * 2 == int(kRowBytes), "a panel row is the 128-byte swizzle atom");

// Store mul * acc, one consumer thread's rows row0 and row0 + 8 of NP
// m64n64 accumulators (columns [64 (p0 + p), 64 (p0 + p) + 64)), as bf16
// into a [B, S, H, HD] tensor; rows past S are not written.
template <int HD, int NP>
__device__ __forceinline__ void store_panels(__nv_bfloat16* __restrict__ out, const float (&acc)[NP][32], float mul,
                                             int row0, int col0, int p0, int b, int h, int S, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + ((int64_t(b) * S + row) * H + h) * HD + kPanelCols * p0;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j) {
        const __nv_bfloat162 pair =
            __float22bfloat162_rn(make_float2(mul * acc[p][4 * j + 2 * i], mul * acc[p][4 * j + 2 * i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(orow + kPanelCols * p + 8 * j + col0) = pair;
      }
  }
}

// --- dq ---------------------------------------------------------------------------

template <int HD>
struct DqTiles {
  static constexpr int BQ = 128;                  // q rows per block (two consumers of 64)
  static constexpr int BK = HD == 128 ? 64 : 32;  // keys per K / V tile
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr uint32_t kQPanelBytes = BQ * kRowBytes;          // 16 KB
  static constexpr uint32_t kKPanelBytes = BK * kRowBytes;          // 8 KB (D 128) or 4 KB (D 256)
  static constexpr uint32_t kQBytes = kPanels * kQPanelBytes;       // Q, and as much for dO
  static constexpr uint32_t kTileBytes = kPanels * kKPanelBytes;    // K, and as much for V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr size_t kSmemBytes = 1024 + 2 * kQBytes + kStages * kStageBytes + kBarrierBytes;  // 1024: alignment
};
static_assert(DqTiles<128>::kSmemBytes == 132136 && DqTiles<256>::kSmemBytes == 197672, "dq tiles changed");
static_assert(DqTiles<256>::kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");

template <int HD>
struct DqBlock {
  using T = DqTiles<HD>;
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_panel(int p) const { return base + p * T::kQPanelBytes; }
  __device__ uint32_t do_panel(int p) const { return base + T::kQBytes + p * T::kQPanelBytes; }
  __device__ uint32_t k_panel(int s, int p) const {
    return base + 2 * T::kQBytes + s * T::kStageBytes + p * T::kKPanelBytes;
  }
  __device__ uint32_t v_panel(int s, int p) const { return k_panel(s, p) + T::kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + 2 * T::kQBytes + kStages * T::kStageBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t q_bar() const { return full_bar(2 * kStages); }
};

template <int HD>
__device__ __forceinline__ DqBlock<HD> dq_block(const uint8_t* smem, int Sk, int H, int causal) {
  using T = DqTiles<HD>;
  DqBlock<HD> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * T::BQ;            // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + T::BQ) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + T::BK - 1) / T::BK;
  return blk;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, float scale, int causal) {
  using T = DqTiles<HD>;
  constexpr int BK = T::BK, P = T::kPanels;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DqBlock<HD> blk = dq_block<HD>(smem_raw, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread loads Q and dO, then keeps the K / V ring full, a box per panel.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const DqBlock<HD> blk = dq_block<HD>(smem_raw, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), 2 * T::kQBytes);
      for (int p = 0; p < P; ++p) {
        tma_load(blk.q_panel(p), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar(), p * kPanelCols);
        tma_load(blk.do_panel(p), &tm_do, blk.h, blk.q0, blk.b, blk.q_bar(), p * kPanelCols);
      }
      for (int t = 0; t < blk.n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(s), T::kStageBytes);
        for (int p = 0; p < P; ++p) {
          tma_load(blk.k_panel(s, p), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(s), p * kPanelCols);
          tma_load(blk.v_panel(s, p), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(s), p * kPanelCols);
        }
      }
      for (int t = blk.n_tiles; t < blk.n_tiles + kStages; ++t)  // outlive the consumers (see the top)
        mbar_wait(blk.empty_bar(t % kStages), ((t / kStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const DqBlock<HD> blk = dq_block<HD>(smem_raw, Sk, H, causal);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = blk.q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = wg * 64 * kRowBytes;  // this warpgroup's rows within each Q / dO panel

  float lse_r[2], delta_r[2];  // rows past Sq read 0: their dS is 0 and they are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse_r[i] = row < Sq ? lse[int64_t(blockIdx.x) * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[int64_t(blockIdx.x) * Sq + row] : 0.f;
  }
  float acc[P][32];  // dQ's columns [64 p, 64 p + 64) in the m64n64 accumulator layout
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;

  mbar_wait(blk.q_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S = Q . K^T and dP = dO . V^T over D in D / 16 k-steps, one group.
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_first(sc, smem_desc(blk.q_panel(kk / 4) + q_rows + 32 * (kk % 4)),
                  smem_desc(blk.k_panel(s, kk / 4) + 32 * (kk % 4)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_first(dp, smem_desc(blk.do_panel(kk / 4) + q_rows + 32 * (kk % 4)),
                  smem_desc(blk.v_panel(s, kk / 4) + 32 * (kk % 4)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // Scale and mask; keys past Sk get -inf, so that P is exactly 0 there
    // (TMA's zero rows would otherwise score 0).
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > blk.q0 + 64 * wg);
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        if (col >= Sk) sc[e] = -INFINITY;
        else if (causal && col > row) sc[e] = MASK_VALUE;
      }
    }
    // dS = P * (dP - delta) with P = exp(S - lse), split into A fragments:
    // k-step kk of dS . K covers keys [16 kk, 16 kk + 16), pairs [4 kk, 4 kk + 4).
    uint32_t ds_hi[BK / 4], ds_lo[BK / 4];
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) {
      const int i = r % 2;
      const float d0 = expf(sc[2 * r] - lse_r[i]) * (dp[2 * r] - delta_r[i]);
      const float d1 = expf(sc[2 * r + 1] - lse_r[i]) * (dp[2 * r + 1] - delta_r[i]);
      split_bf16x2(d0, d1, ds_hi[r], ds_lo[r]);
    }

    // dQ[:, panel p] += dS_hi . K[:, panel p] + dS_lo . K[:, panel p].
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgmma_m64n64k16_rs(acc[p], ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2], ds_hi[4 * kk + 3],
                           smem_desc(blk.k_panel(s, p) + kk * kKStepRows));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgmma_m64n64k16_rs(acc[p], ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2], ds_lo[4 * kk + 3],
                           smem_desc(blk.k_panel(s, p) + kk * kKStepRows));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(acc[p]);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(s));  // this stage's K and V are no longer read
  }

  store_panels<HD>(dq, acc, scale, row0, col0, 0, blk.b, blk.h, Sq, H);
}

// --- dk / dv ------------------------------------------------------------------------

template <int HD>
struct DkvTiles {
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kOwnPanels = 2;            // the dK and dV panels a consumer owns
  static constexpr int BK = HD == 128 ? 128 : 64;  // keys per block (D 128: 64 per consumer; D 256: both share)
  static constexpr int BQ = 32;                    // q rows per streamed Q / dO tile
  static constexpr uint32_t kKPanelBytes = BK * kRowBytes;        // 16 KB (D 128) or 8 KB (D 256)
  static constexpr uint32_t kKBytes = kPanels * kKPanelBytes;     // K, and as much for V: 32 KB
  static constexpr uint32_t kQPanelBytes = BQ * kRowBytes;        // 4 KB
  static constexpr uint32_t kQBytes = kPanels * kQPanelBytes;     // a Q tile, and as much for dO
  static constexpr uint32_t kStageBytes = 2 * kQBytes;
  static constexpr uint32_t kStatBytes = 2 * BQ * 4;              // a Q tile's lse rows, then its delta rows
  static constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr size_t kSmemBytes =
      1024 + 2 * kKBytes + kStages * (kStageBytes + kStatBytes) + kBarrierBytes;
};
static_assert(DkvTiles<128>::kPanels == DkvTiles<128>::kOwnPanels, "at D 128 a consumer owns every panel");
static_assert(DkvTiles<256>::kPanels == DkvTiles<256>::kOwnPanels * kConsumers, "at D 256 each owns half");
static_assert(DkvTiles<128>::kSmemBytes == 99880 && DkvTiles<256>::kSmemBytes == 132648, "dk/dv tiles changed");
static_assert(2 * DkvTiles<128>::BQ <= 128, "the producer warpgroup writes one lse or delta value a thread");

template <int HD>
struct DkvBlock {
  using T = DkvTiles<HD>;
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  int b, h, k0, q_begin, n_tiles;

  __device__ uint32_t k_panel(int p) const { return base + p * T::kKPanelBytes; }
  __device__ uint32_t v_panel(int p) const { return base + T::kKBytes + p * T::kKPanelBytes; }
  __device__ uint32_t q_panel(int s, int p) const {
    return base + 2 * T::kKBytes + s * T::kStageBytes + p * T::kQPanelBytes;
  }
  __device__ uint32_t do_panel(int s, int p) const { return q_panel(s, p) + T::kQBytes; }
  __device__ uint32_t stats(int s) const { return base + 2 * T::kKBytes + kStages * T::kStageBytes + s * T::kStatBytes; }
  __device__ uint32_t full_bar(int s) const {
    return base + 2 * T::kKBytes + kStages * (T::kStageBytes + T::kStatBytes) + 8 * s;
  }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t kv_bar() const { return full_bar(2 * kStages); }
};

template <int HD>
__device__ __forceinline__ DkvBlock<HD> dkv_block(const uint8_t* smem, int Sq, int H, int causal) {
  using T = DkvTiles<HD>;
  DkvBlock<HD> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.k0 = blockIdx.y * T::BK;                             // ascending: the longest causal tiles first
  blk.q_begin = causal ? (blk.k0 / T::BQ) * T::BQ : 0;      // causal: q tiles that cannot see these keys skipped
  blk.n_tiles = max(0, (Sq - blk.q_begin + T::BQ - 1) / T::BQ);
  return blk;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                               float scale, int causal) {
  using T = DkvTiles<HD>;
  constexpr int BQ = T::BQ, P = T::kPanels, OWN = T::kOwnPanels;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DkvBlock<HD> blk = dkv_block<HD>(smem_raw, Sq, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 128);  // every producer thread: 127 after their row statistic, one with the bytes
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.kv_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: thread 0 loads K and V, then each stage's Q and dO tiles, a
    // box per panel; thread p < 2 BQ writes the stage's lse (p < BQ) or
    // delta (p >= BQ) of row p % BQ.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const DkvBlock<HD> blk = dkv_block<HD>(smem_raw, Sq, H, causal);
    const int p = threadIdx.x - 128 * kConsumers;
    if (p == 0) {
      mbar_expect_tx(blk.kv_bar(), 2 * T::kKBytes);
      for (int c = 0; c < P; ++c) {
        tma_load(blk.k_panel(c), &tm_k, blk.h, blk.k0, blk.b, blk.kv_bar(), c * kPanelCols);
        tma_load(blk.v_panel(c), &tm_v, blk.h, blk.k0, blk.b, blk.kv_bar(), c * kPanelCols);
      }
    }
    const float* stat = (p < BQ ? lse : delta) + int64_t(blockIdx.x) * Sq;
    for (int t = 0; t < blk.n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = blk.q_begin + t * BQ;
      mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
      if (p < 2 * BQ) {
        const int row = q0 + p % BQ;
        sts_f32(blk.stats(s) + 4 * p, row < Sq ? stat[row] : 0.f);  // rows past Sq: P is 0 there anyway
      }
      if (p == 0) {
        mbar_expect_tx(blk.full_bar(s), T::kStageBytes);
        for (int c = 0; c < P; ++c) {
          tma_load(blk.q_panel(s, c), &tm_q, blk.h, q0, blk.b, blk.full_bar(s), c * kPanelCols);
          tma_load(blk.do_panel(s, c), &tm_do, blk.h, q0, blk.b, blk.full_bar(s), c * kPanelCols);
        }
      } else {
        mbar_arrive(blk.full_bar(s));
      }
    }
    if (p == 0) {
      for (int t = blk.n_tiles; t < blk.n_tiles + kStages; ++t)  // outlive the consumers (see the top)
        mbar_wait(blk.empty_bar(t % kStages), ((t / kStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: at D 128 warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  // and every column; at D 256 both own keys [k0, k0 + 64) and warpgroup wg
  // the columns of panels 2 wg and 2 wg + 1. The first products' accumulators
  // hold rows = keys, columns = q rows of the streamed tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const DkvBlock<HD> blk = dkv_block<HD>(smem_raw, Sq, H, causal);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int key_base = blk.k0 + (P == OWN ? 64 * wg : 0);         // this warpgroup's first key
  const int key0 = key_base + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (tid % 4);
  const int own0 = P == OWN ? 0 : OWN * wg;                       // this warpgroup's first dK / dV panel
  const uint32_t k_rows = (key_base - blk.k0) * kRowBytes;        // its keys within each K / V panel

  float dk_acc[OWN][32], dv_acc[OWN][32];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  mbar_wait(blk.kv_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int q0 = blk.q_begin + t * BQ;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T over D in D / 16 k-steps, one group.
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] = dpt[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_first(st, smem_desc(blk.k_panel(kk / 4) + k_rows + 32 * (kk % 4)),
                  smem_desc(blk.q_panel(s, kk / 4) + 32 * (kk % 4)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_first(dpt, smem_desc(blk.v_panel(kk / 4) + k_rows + 32 * (kk % 4)),
                  smem_desc(blk.do_panel(s, kk / 4) + 32 * (kk % 4)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Scale and mask (q before key); q rows past Sq get -inf, so that P is
    // exactly 0 there.
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] *= scale;
    const bool edge = q0 + BQ > Sq || (causal && q0 < key_base + 63);
    if (edge) {
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int qpos = q0 + 8 * (e / 4) + col0 + (e % 2);
        const int key = key0 + 8 * ((e / 2) % 2);
        if (qpos >= Sq) st[e] = -INFINITY;
        else if (causal && qpos < key) st[e] = MASK_VALUE;
      }
    }
    // P^T = exp(S^T - lse_col), dS^T = P^T * (dP^T - delta_col), each split
    // into A fragments: k-step kk covers q columns [16 kk, 16 kk + 16), pairs
    // [4 kk, 4 kk + 4). This thread's columns are 8 j + col0 + {0, 1}.
    uint32_t p_hi[BQ / 4], p_lo[BQ / 4], ds_hi[BQ / 4], ds_lo[BQ / 4];
    const uint32_t stats = blk.stats(s);
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

    // dV[:, c] += P^T_hi . dO[:, c] + P^T_lo . dO[:, c] and dK[:, c] +=
    // dS^T_hi . Q[:, c] + dS^T_lo . Q[:, c] for this warpgroup's panels c.
#pragma unroll
    for (int c = 0; c < OWN; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < OWN; ++c) {
        const uint64_t b_do = smem_desc(blk.do_panel(s, own0 + c) + kk * kKStepRows);
        wgmma_m64n64k16_rs(dv_acc[c], p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], b_do);
        wgmma_m64n64k16_rs(dv_acc[c], p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3], b_do);
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < OWN; ++c) {
        const uint64_t b_q = smem_desc(blk.q_panel(s, own0 + c) + kk * kKStepRows);
        wgmma_m64n64k16_rs(dk_acc[c], ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2], ds_hi[4 * kk + 3], b_q);
        wgmma_m64n64k16_rs(dk_acc[c], ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2], ds_lo[4 * kk + 3], b_q);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < OWN; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(s));  // this stage's Q, dO and row statistics are no longer read
  }

  store_panels<HD>(dk, dk_acc, scale, key0, col0, own0, blk.b, blk.h, Sk, H);
  store_panels<HD>(dv, dv_acc, 1.f, key0, col0, own0, blk.b, blk.h, Sk, H);
}

// --- host side -------------------------------------------------------------------

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int Sq, int Sk, int H, float scale, bool causal,
                      cudaStream_t stream) {
  using T = DqTiles<HD>;
  const auto kern = flash_bwd_dq_wide_sm90_kernel<HD>;
  // Once per instance: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, HD, T::BQ, T::BK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                  static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, float scale, bool causal,
                       cudaStream_t stream) {
  using T = DkvTiles<HD>;
  const auto kern = flash_bwd_dkv_wide_sm90_kernel<HD>;
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, HD, T::BQ, T::BK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sk + T::BK - 1) / T::BK);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                  static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                                                  Sq, Sk, H, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / dout / dq with head_dim 128 or 256,
// 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dq_wide_sm90(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                                          int H, int head_dim, float scale, bool causal, cudaStream_t stream) {
  switch (head_dim) {
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, scale, causal, stream);
    case 256: return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 [B, S, H, head_dim] q / k / v / dout / dk / dv with head_dim 128 or
// 256, 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dkv_wide_sm90(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                           int Sk, int H, int head_dim, float scale, bool causal,
                                           cudaStream_t stream) {
  switch (head_dim) {
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, scale, causal, stream);
    case 256: return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace p2pfl
