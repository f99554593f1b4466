// Flash-attention backward for Hopper's tensor cores (sm_90a) at every head
// size above 256: the bf16 dq kernel and the bf16 dk/dv kernel, with the head
// size a run-time argument.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_bwd_dq_grouped_sm90_kernel   <- _flash_bwd_dq_kernel   (pallas_call at :446)
//   flash_bwd_dkv_grouped_sm90_kernel  <- _flash_bwd_dkv_kernel  (pallas_call at :463)
// for bf16 inputs at a head size D that is a multiple of 64 above 256
// (ops/_kernels.py zero-pads 256 < D <= 512 to 512 and larger D to the next
// multiple of 64). Up to 256 the bf16 pair is flash_bwd_sm90.cu's (D 64) and
// flash_bwd_wide_sm90.cu's (D 128 / 256), which this one follows; the f32
// pair at every D stays on the CUDA cores (flash_attn.cu, flash_chunked.cu).
//
// What it computes is what flash_bwd_wide_sm90.cu computes (its header), from
// the forward's lse and delta = rowsum(dO * O) (f32, [B, H, Sq]) and dO in
// bf16: S = Q.K^T and dP = dO.V^T are exact bf16 products summed in f32 by
// wgmma; S is then multiplied by the scale 1/sqrt(D) in f32; causal-masked
// entries get -0.7 * FLT_MAX, P = expf(S - lse), P = 0 exactly for keys
// (queries) past the sequence, dS = P * (dP - delta), all in f32 in the
// accumulators' registers. The second products take their f32 A operand
// (dS in dq; P^T and dS^T in dk/dv) split as X_hi + X_lo in bf16 into one f32
// accumulator; dq = scale * acc, dk = scale * dK, dv = dV. The checks hold
// each gradient to 1 bf16 ulp + 2^-15 of its weighted mass (ops/attention.py
// plain_flash_grad_mass) of the plain version.
//
// What bounds it on this card: at the paths' shapes ([8, 1024, 1, 512] and
// [8, 1024, 1, 1024], causal) the FLOPs and bytes are those of the D 64 pair
// at [8, 1024, 8, 64] times D / 512: above the bf16 ridge, so the bound is
// the operations. The tensor work exceeds the bound's count: the second
// products are done twice (the split), and S and dP once per group of output
// columns (below), 2x at D 512 and 4x at D 1024. Neither a Q nor a K tile
// fits a block at D 1024 (a 128-row Q tile and its dO are 512 KB), so the
// operand that is not the block's own is re-read from L2 once per tile of
// the other side: ~52 FLOP per L2 byte in dq, ~50 in dk/dv at D 1024, which
// may hold the kernels at L2's rate rather than the tensor cores'.
//
// Design (flash_fwd_grouped_sm90.cu's, with the backward's two first
// products): three warpgroups, a TMA producer (setmaxnreg 40) and two
// consumers (setmaxnreg 232); full / empty mbarrier rings walked by producer
// and consumers alike through sm90_common.cuh's Ring (stage, phase); every
// operand a TMA box {64, 1, rows, 1} of one tensor map over [B, S, H, D]
// landing as its own 128-byte-swizzled panel; the producer's waits trap
// after ~17 s and after its last load it waits until the consumers have
// released every stage (as flash_bwd_wide_sm90.cu's); the consumers' waits
// are the unguarded mbar_spin (the guarded wait's clock spilled the grouped
// forward's registers). Each block owns a group of up to four 64-column
// panels of its output: G = ceil(D / 256) groups, the last one partial (D
// 576: 4 + 4 + 1 panels); the group blocks of a tile are neighbours in the
// grid (they read the same operands), and every group block of a tile runs
// the same first-product arithmetic in the same order. A partial group runs
// the products of all four panels, so every register index stays static:
// the panels past its own read slots it never loads and are never stored.
//
// dq: one block per (b * h, q tile of BQ = 128 rows, group); q tiles handed
// out longest first; a consumer owns 64 rows. For each key tile of BK = 64
// keys the producer streams, for each 64-column panel p of D, a (Q_p, K_p)
// stage and a (dO_p, V_p) stage (16 + 8 KB) through one ring, and the key
// tile's group panels of K (64 keys x 256 columns, 32 KB) into a ring of
// their own; the consumers build S and dP over all of D (wgmma m64n64k16,
// four k-steps a stage, one stage's products in flight while the next is
// issued), then add dS_hi.K[:, group] + dS_lo.K[:, group] into the group's
// dQ slices (wgmma m64n64k16 with A from registers). dQ is 4 x 32 = 128 f32
// a thread beside S and dP (32 each) and dS's halves (16 words each); ptxas
// fits that in setmaxnreg's 232 without a spill. The D 256 wide dq kernel's
// BK = 32 re-reads Q and dO from L2 twice as often and ran 28-30 % slower
// here (scripts/torch_kernel_variants.py bwd_grouped). Causal key tiles
// wholly in the q tile's future are skipped.
//
// dk/dv: one block per (b * h, k tile of BK = 64 keys, group); k tiles
// handed out ascending (under the causal mask k tile 0 sees every q tile).
// Of the two layouts with the same tensor work, (a) both consumers take the
// same 64 keys and each owns two of the group's four panels of dK and dV,
// building S^T and dP^T over all of D itself, and (b) each consumer owns 64
// keys of its own with groups of two panels, (a) is taken: per q tile it
// streams 64 keys of K and V where (b) streams 128 for the same output
// columns, so it reads about a third fewer bytes from L2 (416 against 656 KB
// a q tile for 64 keys x 256 columns of output at D 1024), and it is the D
// 256 wide kernel's layout and register budget (dK and dV 2 x 2 x 32 = 128
// f32 a thread, S^T and dP^T 16 each, four split halves of 8 words). For
// each q tile of BQ = 32 rows the producer streams, for each panel p, a (K_p,
// Q_p) stage and a (V_p, dO_p) stage (8 + 4 KB) through one ring, and the q
// tile's group panels of Q and dO (32 rows x 256 columns each, 32 KB) with
// its rows' lse and delta (written to shared memory by the producer
// warpgroup's threads before they arrive on the stage's full barrier) into
// a ring of their own; the consumers build S^T = K.Q^T and dP^T = V.dO^T
// over D, then dV[:, c] += P^T_hi.dO[:, c] + P^T_lo.dO[:, c] and dK[:, c] +=
// dS^T_hi.Q[:, c] + dS^T_lo.Q[:, c] for their two panels c. Causal q tiles
// that cannot see the k tile are skipped (the q loop starts at floor(k0 /
// 32) * 32).
//
// Shared memory: dq 6 x 24 KB + 2 x 32 KB = 208 KB, dk/dv 12 x 12 KB + 2 x
// (32 KB + 256 B) = 208.5 KB, of the 227 KB a block has.
//
// Interface: p2pfl::launch_flash_bwd_dq_grouped_sm90 and
// launch_flash_bwd_dkv_grouped_sm90, called by p2pfl_flash_bwd_dq /
// p2pfl_flash_bwd_dkv in flash_attn.cu for bf16 above 256; each encodes the
// tensor maps on each call, allocates nothing, launches on the given stream
// and returns a CUDA error code (cudaErrorInvalidValue for a head size that
// is not a multiple of 64 or is 256 or below, or a tensor map that cannot be
// encoded).

#include "sm90_common.cuh"

namespace {

constexpr int kPanelCols = 64;   // the columns of one TMA box and one 128-byte swizzled panel
constexpr int kGroupPanels = 4;  // 64-column panels of a block's output: 256 columns
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kKStepRows = 16 * kRowBytes;  // an MN-major operand's k-step: 16 rows of a panel

static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");
static_assert(kPanelCols * 2 == int(kRowBytes), "a panel row is the 128-byte swizzle atom");
static_assert(kGroupPanels % kConsumers == 0, "dk/dv: each consumer owns as many of a group's panels");

// The work of a block: its (b, h), its output group g (panels [kGroupPanels
// g, kGroupPanels g + group_panels) of D / 64), the first row of its own
// tile (q rows in dq, keys in dk/dv) and its count of tiles of the other side.
struct Work {
  int bh, b, h, g, tile0, n_tiles;
  int panels;        // D / 64: the first products' panel pairs a tile
  int group_panels;  // this block's output panels: kGroupPanels, or fewer in the last group
};

__device__ __forceinline__ Work block_work(int H, int head_dim) {
  Work w;
  w.panels = head_dim / kPanelCols;
  const int groups = (w.panels + kGroupPanels - 1) / kGroupPanels;
  w.g = blockIdx.x % groups;
  w.bh = blockIdx.x / groups;
  w.b = w.bh / H;
  w.h = w.bh % H;
  w.group_panels = min(kGroupPanels, w.panels - kGroupPanels * w.g);
  return w;
}

// Store mul * acc[p] for the first n of NP m64n64 accumulators, one consumer
// thread's rows row0 and row0 + 8, as bf16 into columns [col + 64 p, col + 64
// p + 64) of a [B, S, H, head_dim] tensor; rows past S are not written.
template <int NP>
__device__ __forceinline__ void store_group(__nv_bfloat16* __restrict__ out, const float (&acc)[NP][32], float mul,
                                            int n, int row0, int col0, int col, int b, int h, int S, int H,
                                            int head_dim) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + ((int64_t(b) * S + row) * H + h) * head_dim + col;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (p >= n) break;
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j) {
        const __nv_bfloat162 pair =
            __float22bfloat162_rn(make_float2(mul * acc[p][4 * j + 2 * i], mul * acc[p][4 * j + 2 * i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(orow + kPanelCols * p + 8 * j + col0) = pair;
      }
    }
  }
}

// --- dq ---------------------------------------------------------------------------

struct DqTiles {
  static constexpr int BQ = 128;          // q rows per block (two consumers of 64)
  static constexpr int BK = 64;           // keys per K / V tile
  static constexpr int kStages = 6;       // dq ring: (Q_p, K_p) and (dO_p, V_p) stages
  static constexpr int kGroupStages = 2;  // dq ring of a key tile's group panels of K
  static constexpr uint32_t kQPanelBytes = BQ * kRowBytes;                 // 16 KB, as a dO panel
  static constexpr uint32_t kKPanelBytes = BK * kRowBytes;                 // 8 KB, as a V panel
  static constexpr uint32_t kStageBytes = kQPanelBytes + kKPanelBytes;     // 24 KB
  static constexpr uint32_t kGroupBytes = kGroupPanels * kKPanelBytes;     // 32 KB
  static constexpr uint32_t kRingBytes = kStages * kStageBytes + kGroupStages * kGroupBytes;
  static constexpr uint32_t kBarrierBytes = 8 * 2 * (kStages + kGroupStages);  // a full and an empty one a stage
  static constexpr size_t kSmemBytes = 1024 + kRingBytes + kBarrierBytes;      // 1024: alignment
};
static_assert(DqTiles::BQ == 64 * kConsumers, "each dq consumer owns 64 q rows");
static_assert(DqTiles::kStageBytes % 1024 == 0 && DqTiles::kKPanelBytes % 1024 == 0, "panels stay 1024-byte aligned");
static_assert(DqTiles::kSmemBytes == 214144, "dq tiles changed");
static_assert(DqTiles::kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");

// Where a dq block's panels and barriers lie in shared memory; each role
// computes it after its setmaxnreg.
struct DqBlock {
  using T = DqTiles;
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  Work w;

  __device__ uint32_t q_panel(int s) const { return base + s * T::kStageBytes; }  // Q_p, or dO_p
  __device__ uint32_t k_panel(int s) const { return q_panel(s) + T::kQPanelBytes; }  // K_p, or V_p
  __device__ uint32_t k_group(int s, int j) const {
    return base + T::kStages * T::kStageBytes + s * T::kGroupBytes + j * T::kKPanelBytes;
  }
  __device__ uint32_t bar(int i) const { return base + T::kRingBytes + 8 * i; }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(T::kStages + s); }
  __device__ uint32_t full_k(int s) const { return bar(2 * T::kStages + s); }
  __device__ uint32_t empty_k(int s) const { return bar(2 * T::kStages + T::kGroupStages + s); }
};

__device__ __forceinline__ DqBlock dq_block(const uint8_t* smem, int Sk, int H, int head_dim, int causal) {
  using T = DqTiles;
  DqBlock blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.w = block_work(H, head_dim);
  blk.w.tile0 = (gridDim.y - 1 - blockIdx.y) * T::BQ;            // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.w.tile0 + T::BQ) : Sk;  // causal: future tiles skipped
  blk.w.n_tiles = (k_end + T::BK - 1) / T::BK;
  return blk;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_grouped_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int head_dim, float scale,
                                 int causal) {
  using T = DqTiles;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DqBlock blk = dq_block(smem_raw, Sk, H, head_dim, causal);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), 128 * kConsumers);
    }
    for (int s = 0; s < T::kGroupStages; ++s) {
      mbar_init(blk.full_k(s), 1);
      mbar_init(blk.empty_k(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread loads each key tile's group panels of K, then
    // streams its (Q_p, K_p) and (dO_p, V_p) stages over all of D.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const DqBlock blk = dq_block(smem_raw, Sk, H, head_dim, causal);
      const Work& w = blk.w;
      Ring ring;
      for (int t = 0; t < w.n_tiles; ++t) {
        const int k0 = t * BK;
        const int sk = t % T::kGroupStages;
        mbar_wait(blk.empty_k(sk), ((t / T::kGroupStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_k(sk), w.group_panels * T::kKPanelBytes);
        for (int j = 0; j < w.group_panels; ++j)
          tma_load(blk.k_group(sk, j), &tm_k, w.h, k0, w.b, blk.full_k(sk), (kGroupPanels * w.g + j) * kPanelCols);
        for (int p = 0; p < w.panels; ++p) {
          mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
          mbar_expect_tx(blk.full(ring.stage), T::kStageBytes);
          tma_load(blk.q_panel(ring.stage), &tm_q, w.h, w.tile0, w.b, blk.full(ring.stage), p * kPanelCols);
          tma_load(blk.k_panel(ring.stage), &tm_k, w.h, k0, w.b, blk.full(ring.stage), p * kPanelCols);
          ring.next(T::kStages);
          mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
          mbar_expect_tx(blk.full(ring.stage), T::kStageBytes);
          tma_load(blk.q_panel(ring.stage), &tm_do, w.h, w.tile0, w.b, blk.full(ring.stage), p * kPanelCols);
          tma_load(blk.k_panel(ring.stage), &tm_v, w.h, k0, w.b, blk.full(ring.stage), p * kPanelCols);
          ring.next(T::kStages);
        }
      }
      for (int s = 0; s < T::kStages; ++s) {  // outlive the consumers (see the top)
        mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
        ring.next(T::kStages);
      }
      for (int t = w.n_tiles; t < w.n_tiles + T::kGroupStages; ++t)
        mbar_wait(blk.empty_k(t % T::kGroupStages), ((t / T::kGroupStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [tile0 + 64 wg, tile0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const DqBlock blk = dq_block(smem_raw, Sk, H, head_dim, causal);
  const Work& w = blk.w;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = w.tile0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = wg * 64 * kRowBytes;  // this warpgroup's rows within each Q / dO panel

  float lse_r[2], delta_r[2];  // rows past Sq read 0: their dS is 0 and they are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse_r[i] = row < Sq ? lse[int64_t(w.bh) * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[int64_t(w.bh) * Sq + row] : 0.f;
  }
  float acc[kGroupPanels][32];  // dQ's columns [256 g + 64 p, 256 g + 64 p + 64) in the m64n64 accumulator layout
#pragma unroll
  for (int p = 0; p < kGroupPanels; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;

  Ring ring;
  for (int t = 0; t < w.n_tiles; ++t) {
    const int k0 = t * BK;

    // S = Q . K^T and dP = dO . V^T over D, a (Q_p, K_p) stage then a (dO_p,
    // V_p) stage per panel, four k-steps each; a stage is released once the
    // products that read it are done.
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = dp[e] = 0.f;
    int read = 0;  // the stage whose products are still in flight
#pragma unroll 1
    for (int p = 0; p < w.panels; ++p) {
      mbar_spin(blk.full(ring.stage), ring.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_first(sc, smem_desc(blk.q_panel(ring.stage) + q_rows + 32 * kk),
                    smem_desc(blk.k_panel(ring.stage) + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_one();  // the previous stage's products are done
      if (p > 0) mbar_arrive(blk.empty(read));
      read = ring.stage;
      ring.next(T::kStages);
      mbar_spin(blk.full(ring.stage), ring.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_first(dp, smem_desc(blk.q_panel(ring.stage) + q_rows + 32 * kk),
                    smem_desc(blk.k_panel(ring.stage) + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_one();
      mbar_arrive(blk.empty(read));
      read = ring.stage;
      ring.next(T::kStages);
    }
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(blk.empty(read));

    // Scale and mask; keys past Sk get -inf, so that P is exactly 0 there
    // (TMA's zero rows would otherwise score 0).
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > w.tile0 + 64 * wg);
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

    // dQ[:, panel p] += dS_hi . K[:, panel p] + dS_lo . K[:, panel p] for the
    // group's panels; within a panel, K rows of 16 keys are 2048 bytes apart.
    const int sk = t % T::kGroupStages;
    mbar_spin(blk.full_k(sk), (t / T::kGroupStages) & 1);
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) fence_regs(acc[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p)
        wgmma_m64n64k16_rs(acc[p], ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2], ds_hi[4 * kk + 3],
                           smem_desc(blk.k_group(sk, p) + kk * kKStepRows));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p)
        wgmma_m64n64k16_rs(acc[p], ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2], ds_lo[4 * kk + 3],
                           smem_desc(blk.k_group(sk, p) + kk * kKStepRows));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) fence_regs(acc[p]);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_k(sk));  // this stage's K panels are no longer read
  }

  store_group(dq, acc, scale, w.group_panels, row0, col0, kGroupPanels * kPanelCols * w.g, w.b, w.h, Sq, H,
              head_dim);
}

// --- dk / dv ------------------------------------------------------------------------

struct DkvTiles {
  static constexpr int BK = 64;           // keys per block (both consumers)
  static constexpr int BQ = 32;           // q rows per streamed Q / dO tile
  static constexpr int kOwnPanels = kGroupPanels / kConsumers;  // the dK and dV panels a consumer owns
  static constexpr int kStages = 12;      // dk/dv ring: (K_p, Q_p) and (V_p, dO_p) stages
  static constexpr int kGroupStages = 2;  // dk/dv ring of a q tile's group panels of Q and dO
  static constexpr uint32_t kKPanelBytes = BK * kRowBytes;                  // 8 KB, as a V panel
  static constexpr uint32_t kQPanelBytes = BQ * kRowBytes;                  // 4 KB, as a dO panel
  static constexpr uint32_t kStageBytes = kKPanelBytes + kQPanelBytes;      // 12 KB
  static constexpr uint32_t kGroupBytes = 2 * kGroupPanels * kQPanelBytes;  // Q's group panels, then dO's: 32 KB
  static constexpr uint32_t kStatBytes = 2 * BQ * 4;                        // a q tile's lse rows, then its delta rows
  static constexpr uint32_t kRingBytes = kStages * kStageBytes + kGroupStages * kGroupBytes;
  static constexpr uint32_t kBarrierBytes = 8 * 2 * (kStages + kGroupStages);
  static constexpr size_t kSmemBytes = 1024 + kRingBytes + kGroupStages * kStatBytes + kBarrierBytes;
};
static_assert(DkvTiles::kStageBytes % 1024 == 0 && DkvTiles::kKPanelBytes % 1024 == 0 &&
                  DkvTiles::kQPanelBytes % 1024 == 0,
              "panels stay 1024-byte aligned");
static_assert(DkvTiles::kSmemBytes == 214752, "dk/dv tiles changed");
static_assert(DkvTiles::kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");
static_assert(2 * DkvTiles::BQ <= 128, "the producer warpgroup writes one lse or delta value a thread");

struct DkvBlock {
  using T = DkvTiles;
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  Work w;        // tile0: the block's first key; n_tiles: its q tiles, from q_begin
  int q_begin;   // the first q row of its first q tile
  __device__ uint32_t k_panel(int s) const { return base + s * T::kStageBytes; }     // K_p, or V_p
  __device__ uint32_t q_panel(int s) const { return k_panel(s) + T::kKPanelBytes; }  // Q_p, or dO_p
  __device__ uint32_t q_group(int s, int j) const {
    return base + T::kStages * T::kStageBytes + s * T::kGroupBytes + j * T::kQPanelBytes;
  }
  __device__ uint32_t do_group(int s, int j) const { return q_group(s, j) + kGroupPanels * T::kQPanelBytes; }
  __device__ uint32_t stats(int s) const { return base + T::kRingBytes + s * T::kStatBytes; }
  __device__ uint32_t bar(int i) const { return base + T::kRingBytes + T::kGroupStages * T::kStatBytes + 8 * i; }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(T::kStages + s); }
  __device__ uint32_t full_g(int s) const { return bar(2 * T::kStages + s); }
  __device__ uint32_t empty_g(int s) const { return bar(2 * T::kStages + T::kGroupStages + s); }
};

__device__ __forceinline__ DkvBlock dkv_block(const uint8_t* smem, int Sq, int H, int head_dim, int causal) {
  using T = DkvTiles;
  DkvBlock blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.w = block_work(H, head_dim);
  blk.w.tile0 = blockIdx.y * T::BK;                           // ascending: the longest causal tiles first
  blk.q_begin = causal ? (blk.w.tile0 / T::BQ) * T::BQ : 0;   // causal: q tiles that cannot see these keys skipped
  blk.w.n_tiles = max(0, (Sq - blk.q_begin + T::BQ - 1) / T::BQ);
  return blk;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_grouped_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                                  int H, int head_dim, float scale, int causal) {
  using T = DkvTiles;
  constexpr int BQ = T::BQ, OWN = T::kOwnPanels;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const DkvBlock blk = dkv_block(smem_raw, Sq, H, head_dim, causal);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), 128 * kConsumers);
    }
    for (int s = 0; s < T::kGroupStages; ++s) {
      mbar_init(blk.full_g(s), 128);  // every producer thread: 127 after their row statistic, one with the bytes
      mbar_init(blk.empty_g(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: thread 0 loads each q tile's group panels of Q and dO, then
    // streams its (K_p, Q_p) and (V_p, dO_p) stages over all of D; thread p <
    // 2 BQ writes the q tile's lse (p < BQ) or delta (p >= BQ) of row p % BQ.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const DkvBlock blk = dkv_block(smem_raw, Sq, H, head_dim, causal);
    const Work& w = blk.w;
    const int p = threadIdx.x - 128 * kConsumers;
    const float* stat = (p < BQ ? lse : delta) + int64_t(w.bh) * Sq;
    Ring ring;
    for (int t = 0; t < w.n_tiles; ++t) {
      const int q0 = blk.q_begin + t * BQ;
      const int sg = t % T::kGroupStages;
      mbar_wait(blk.empty_g(sg), ((t / T::kGroupStages) & 1) ^ 1);  // the first pass finds every stage free
      if (p < 2 * BQ) {
        const int row = q0 + p % BQ;
        sts_f32(blk.stats(sg) + 4 * p, row < Sq ? stat[row] : 0.f);  // rows past Sq: P is 0 there anyway
      }
      if (p != 0) {
        mbar_arrive(blk.full_g(sg));
        continue;
      }
      mbar_expect_tx(blk.full_g(sg), 2 * w.group_panels * T::kQPanelBytes);
      for (int j = 0; j < w.group_panels; ++j) {
        const int col = (kGroupPanels * w.g + j) * kPanelCols;
        tma_load(blk.q_group(sg, j), &tm_q, w.h, q0, w.b, blk.full_g(sg), col);
        tma_load(blk.do_group(sg, j), &tm_do, w.h, q0, w.b, blk.full_g(sg), col);
      }
      for (int c = 0; c < w.panels; ++c) {
        mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
        mbar_expect_tx(blk.full(ring.stage), T::kStageBytes);
        tma_load(blk.k_panel(ring.stage), &tm_k, w.h, w.tile0, w.b, blk.full(ring.stage), c * kPanelCols);
        tma_load(blk.q_panel(ring.stage), &tm_q, w.h, q0, w.b, blk.full(ring.stage), c * kPanelCols);
        ring.next(T::kStages);
        mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
        mbar_expect_tx(blk.full(ring.stage), T::kStageBytes);
        tma_load(blk.k_panel(ring.stage), &tm_v, w.h, w.tile0, w.b, blk.full(ring.stage), c * kPanelCols);
        tma_load(blk.q_panel(ring.stage), &tm_do, w.h, q0, w.b, blk.full(ring.stage), c * kPanelCols);
        ring.next(T::kStages);
      }
    }
    if (p == 0) {
      for (int s = 0; s < T::kStages; ++s) {  // outlive the consumers (see the top)
        mbar_wait(blk.empty(ring.stage), ring.phase ^ 1);
        ring.next(T::kStages);
      }
      for (int t = w.n_tiles; t < w.n_tiles + T::kGroupStages; ++t)
        mbar_wait(blk.empty_g(t % T::kGroupStages), ((t / T::kGroupStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: both own keys [k0, k0 + 64) and warpgroup wg the group's
  // panels own0 = OWN wg .. own0 + OWN - 1 of dK and dV. The first products'
  // accumulators hold rows = keys, columns = q rows of the streamed tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const DkvBlock blk = dkv_block(smem_raw, Sq, H, head_dim, causal);
  const Work& w = blk.w;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int k0 = w.tile0;
  const int key0 = k0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (tid % 4);
  const int own0 = OWN * wg;  // this warpgroup's first dK / dV panel within the group

  float dk_acc[OWN][32], dv_acc[OWN][32];
#pragma unroll
  for (int c = 0; c < OWN; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  Ring ring;
  for (int t = 0; t < w.n_tiles; ++t) {
    const int q0 = blk.q_begin + t * BQ;

    // S^T = K . Q^T and dP^T = V . dO^T over D, a (K_p, Q_p) stage then a
    // (V_p, dO_p) stage per panel, as dq's first products.
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] = dpt[e] = 0.f;
    int read = 0;
#pragma unroll 1
    for (int c = 0; c < w.panels; ++c) {
      mbar_spin(blk.full(ring.stage), ring.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_first(st, smem_desc(blk.k_panel(ring.stage) + 32 * kk), smem_desc(blk.q_panel(ring.stage) + 32 * kk),
                    1);
      wgmma_commit();
      wgmma_wait_one();
      if (c > 0) mbar_arrive(blk.empty(read));
      read = ring.stage;
      ring.next(T::kStages);
      mbar_spin(blk.full(ring.stage), ring.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_first(dpt, smem_desc(blk.k_panel(ring.stage) + 32 * kk), smem_desc(blk.q_panel(ring.stage) + 32 * kk),
                    1);
      wgmma_commit();
      wgmma_wait_one();
      mbar_arrive(blk.empty(read));
      read = ring.stage;
      ring.next(T::kStages);
    }
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    mbar_arrive(blk.empty(read));

    // Scale and mask (q before key); q rows past Sq get -inf, so that P is
    // exactly 0 there.
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) st[e] *= scale;
    const bool edge = q0 + BQ > Sq || (causal && q0 < k0 + T::BK - 1);
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
    const int sg = t % T::kGroupStages;
    mbar_spin(blk.full_g(sg), (t / T::kGroupStages) & 1);
    uint32_t p_hi[BQ / 4], p_lo[BQ / 4], ds_hi[BQ / 4], ds_lo[BQ / 4];
    const uint32_t stats = blk.stats(sg);
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
        const uint64_t b_do = smem_desc(blk.do_group(sg, own0 + c) + kk * kKStepRows);
        wgmma_m64n64k16_rs(dv_acc[c], p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], b_do);
        wgmma_m64n64k16_rs(dv_acc[c], p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3], b_do);
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < OWN; ++c) {
        const uint64_t b_q = smem_desc(blk.q_group(sg, own0 + c) + kk * kKStepRows);
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
    mbar_arrive(blk.empty_g(sg));  // this stage's Q / dO group panels and row statistics are no longer read
  }

  const int n_own = w.group_panels - own0;  // panels of this warpgroup that exist (none past a partial group's)
  const int col = (kGroupPanels * w.g + own0) * kPanelCols;
  store_group(dk, dk_acc, scale, n_own, key0, col0, col, w.b, w.h, Sk, H, head_dim);
  store_group(dv, dv_acc, 1.f, n_own, key0, col0, col, w.b, w.h, Sk, H, head_dim);
}

// --- host side -------------------------------------------------------------------

int groups_of(int head_dim) { return (head_dim / kPanelCols + kGroupPanels - 1) / kGroupPanels; }

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / dout / dq with head_dim a multiple of
// 64 above 256, 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dq_grouped_sm90(const void* q, const void* k, const void* v, const void* dout,
                                             const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                                             int H, int head_dim, float scale, bool causal, cudaStream_t stream) {
  using T = DqTiles;
  if (head_dim <= 256 || head_dim % kPanelCols != 0) return cudaErrorInvalidValue;
  const auto kern = flash_bwd_dq_grouped_sm90_kernel;
  // Once: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, head_dim, T::BQ, T::BK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H * groups_of(head_dim), (Sq + T::BQ - 1) / T::BQ);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                  static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, head_dim, scale,
                                                  causal ? 1 : 0);
  return cudaGetLastError();
}

// bf16 [B, S, H, head_dim] q / k / v / dout / dk / dv with head_dim a multiple
// of 64 above 256, 16-byte aligned; lse and delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dkv_grouped_sm90(const void* q, const void* k, const void* v, const void* dout,
                                              const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                              int Sk, int H, int head_dim, float scale, bool causal,
                                              cudaStream_t stream) {
  using T = DkvTiles;
  if (head_dim <= 256 || head_dim % kPanelCols != 0) return cudaErrorInvalidValue;
  const auto kern = flash_bwd_dkv_grouped_sm90_kernel;
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap maps[4];
  const cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, head_dim, T::BQ, T::BK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H * groups_of(head_dim), (Sk + T::BK - 1) / T::BK);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                                                  static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                                                  Sq, Sk, H, head_dim, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace p2pfl
