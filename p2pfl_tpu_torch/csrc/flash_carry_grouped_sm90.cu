// Ring attention's bf16 fold of one kv chunk into an online-softmax carry on
// Hopper's tensor cores (sm_90a) at every head size from 128 up, with the
// head size a run-time argument.
//
// Replaces the Pallas TPU kernel of p2pfl_tpu/ops/attention.py:
//   flash_carry_grouped_sm90  <- _flash_carry_kernel  (pallas_call at :590)
// for bf16 q / k / v at a head size D that is a multiple of 64 from 128 up
// (ops/_kernels.py zero-pads 128 < D < 256 to 256, 256 < D <= 512 to 512 and
// larger D to the next multiple of 64). The TPU kernel keeps (block, D) f32
// scratch in VMEM and takes any D; at D 64 the bf16 fold is
// flash_fwd_sm90.cu's flash_carry_sm90_kernel, below 64
// flash_carry_narrow_sm90.cu's, and the f32 fold at
// every D stays on the CUDA cores (flash_attn.cu, flash_chunked.cu), the
// 1e-5 parity path.
//
// What it computes is ops/attention.py plain_flash_chunk_update, the
// reference's _flash_carry_kernel, from an incoming carry (m, l [B, H, Sq];
// acc [B, Sq, H, D]; f32) into new buffers, unnormalized: m_new = max(m_in,
// rowmax S), l = exp(m_in - m_new) l_in + sum p, acc = exp(m_in - m_new)
// acc_in + P.V, with no clamp and no log. S = Q.K^T is exact bf16 products
// summed in f32 (by wgmma over chains of kChainPanels 64-column panels, the
// chains' sums in f32 registers), then multiplied by the scale in f32. q rows
// sit at global positions q_offset + [0, Sq) and keys at kv_offset + [0,
// Sk); the causal mask (-0.7 * FLT_MAX; keys past Sk: -inf) and the
// future-tile skip compare those. P.V is P_hi.V + P_lo.V with P_hi =
// bf16(P), P_lo = bf16(P - P_hi), into one f32 accumulator, as every bf16
// kernel of the port does (a single bf16 P fails the port's bar). acc is
// held to the plain version within 1e-5 + 1e-5 |ref| + 1e-6 l + 2^-15 of the
// fold's mass exp(S - m_new) @ |V| (plain_flash_chunk_mass), m within 1e-5.
//
// What bounds it on this card: at the ring's chunk shapes ([2, 1024, H, D],
// H D = 512 or 1024) the bytes: q, k, v in bf16 and the f32 carry read and
// written once (~4.4 us at H D 512, ~8.8 us at 1024, at 3.35 TB/s); a past
// fold does 4 B H Sq Sk D FLOP (~4.3 us of tensor work at H D 512). The
// kernel does more tensor work than that count: P.V twice (the split) and S
// once per group of acc's columns (below), 2x at D 512 and 4x at D 1024.
// The grid is under one wave at those shapes (128 / 64 / 64 / 128 blocks at
// D 128 / 256 / 512 / 1024 on 132 SMs), so a past fold's time is one block's
// walk over all 16 key tiles.
//
// Design (flash_fwd_grouped_sm90.cu's tile loop around an incoming carry):
//   * one block per (b * h, q tile of BQ = 64 rows, group of up to four
//     64-column panels of acc): G = ceil(D / 256) groups, the last one
//     partial (D 128: 2 panels; D 576: 4 + 4 + 1); the group blocks of a q
//     tile are neighbours in the grid (they read the same Q and K); a TMA
//     producer warpgroup (one thread; setmaxnreg 40) and one 64-row wgmma
//     consumer (setmaxnreg 240). The grouped forward's 128-row tile of two
//     consumers halves the grid, and a block's walk then takes ~1.4-1.5x as
//     long (scripts/torch_kernel_variants.py carry_grouped);
//   * S over all of D: the producer streams D / 64 pairs of one Q panel and
//     one K panel (64 keys) per key tile through a ring of kQKStages stages,
//     each a TMA box {64, 1, rows, 1} landing as a 128-byte-swizzled panel,
//     and the group's V panels (64 keys x up to 256 columns) through a
//     2-stage ring; the consumer issues wgmma m64n64k16 for S, four k-steps a
//     panel, one panel's products in flight while the next panel's are
//     issued, and adds each chain's sum into S in f32 registers: one wgmma
//     chain over all of D lets its rounding grow with D (m 6.4e-6 off the
//     exact row max at D 1024, against ~1e-6 here at every D);
//   * acc += P_hi.V + P_lo.V with P from registers: one m64n64k16 per V
//     panel per k-step of 16 keys into that panel's 32 f32 of acc (at most
//     128 a thread). A partial group runs the products of all four slices,
//     so every register index stays static: the slices past its panels read
//     V slots it never loads and are never stored (guarding them made ptxas
//     serialize the wgmma, C7515);
//   * prologue: the consumer reads its rows' m_in, l_in and its group's
//     slice of acc_in once, straight into the registers the loop keeps them
//     in (acc as float2 in the accumulator layout; l as this thread's share:
//     l_in on the quad's lane with col0 == 0, 0 on the other three, so the
//     quad's sum at the end is the fold's l); a partial group reads nothing
//     past D, and its unused slices start at 0;
//   * m and l across groups: every group block runs the same S arithmetic in
//     the same order, so all reach bit-identical m and l; only group 0
//     writes m_out / l_out; every group writes its own columns of acc_out;
//   * causal key tiles wholly in a q tile's future are skipped.
// Where trouble lies:
//   * a skipped fold: a q tile that sees no key of the chunk (a chunk wholly
//     in its future) runs no tile; its consumer waits on no barrier at all
//     and writes the carry back bit-identical (m_in; l_in + 0 + 0 + 0 over
//     the quad; acc_in);
//   * the producer outlives the consumer: after its last load it waits until
//     every stage is released, so a consumer stuck on a tile traps there
//     (~17 s) instead of hanging the card. The consumer's per-tile waits stay
//     unguarded: a guarded wait spilled 640 B in the grouped backward;
//   * rows whose first processed tile holds no real key: a row with m_in =
//     -inf whose first tile is all masked gets m = MASK_VALUE and p = 1 per
//     masked key, as the reference and the plain version do, but the result
//     then depends on the tile size. The ring never folds such a chunk: it
//     folds the self chunk first, and kv_offset <= q_offset on every fold it
//     does not skip, so every row sees key 0 of the chunk in its first tile.
//
// Interface: p2pfl::launch_flash_carry_grouped_sm90, called by
// p2pfl_flash_carry in flash_attn.cu for bf16 above 64; it encodes the
// tensor maps on each call, allocates nothing, launches on the given stream
// and returns a CUDA error code (cudaErrorInvalidValue for a head size that
// is not a multiple of 64 from 128 up, or a tensor map that cannot be
// encoded).

#include "sm90_common.cuh"

#include <algorithm>

namespace {

constexpr int kConsumers = 1;    // consumer warpgroups of 64 q rows each
constexpr int BQ = 64 * kConsumers;  // q rows per block
constexpr int BK = 64;           // keys per K / V tile
constexpr int kPanelCols = 64;   // the columns of one TMA box and one 128-byte swizzled panel
constexpr int kGroupPanels = 4;  // 64-column panels of acc per block: 256 columns
constexpr int kQKStages = 6;     // Q / K panel-pair ring depth
constexpr int kChainPanels = 2;  // panels whose products one wgmma chain sums before an f32 add
constexpr int kVStages = 2;      // V tile ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 240;

constexpr uint32_t kQPanelBytes = BQ * kRowBytes;                  // 8 KB
constexpr uint32_t kKPanelBytes = BK * kRowBytes;                  // 8 KB, as a V panel
constexpr uint32_t kQKStageBytes = kQPanelBytes + kKPanelBytes;
constexpr uint32_t kVStageBytes = kGroupPanels * kKPanelBytes;     // 32 KB
constexpr uint32_t kRingBytes = kQKStages * kQKStageBytes + kVStages * kVStageBytes;
constexpr uint32_t kBarrierBytes = 8 * 2 * (kQKStages + kVStages);  // a full and an empty barrier per stage
constexpr size_t kSmemBytes = 1024 + kRingBytes + kBarrierBytes;    // 1024: alignment

static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");
static_assert(kPanelCols * 2 == int(kRowBytes), "a panel row is the 128-byte swizzle atom");
static_assert(kQKStageBytes % 1024 == 0 && kVStageBytes % 1024 == 0, "panels stay 1024-byte aligned");
static_assert(kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");

// Where a block's panels and barriers lie in shared memory, and its work;
// each role computes it after its setmaxnreg.
struct Block {
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  int bh, b, h, g, q0, n_tiles;
  int panels;        // D / 64: the Q / K panel pairs of a key tile
  int group_panels;  // this block's panels of acc and V: 4, or fewer in the last group

  __device__ uint32_t q_panel(int s) const { return base + s * kQKStageBytes; }
  __device__ uint32_t k_panel(int s) const { return q_panel(s) + kQPanelBytes; }
  __device__ uint32_t v_panel(int s, int j) const {
    return base + kQKStages * kQKStageBytes + s * kVStageBytes + j * kKPanelBytes;
  }
  __device__ uint32_t bar(int i) const { return base + kRingBytes + 8 * i; }
  __device__ uint32_t full_qk(int s) const { return bar(s); }
  __device__ uint32_t empty_qk(int s) const { return bar(kQKStages + s); }
  __device__ uint32_t full_v(int s) const { return bar(2 * kQKStages + s); }
  __device__ uint32_t empty_v(int s) const { return bar(2 * kQKStages + kVStages + s); }
};

// A key tile is in the q tile's future when kv_offset + k0 >= q_offset + q0
// + BQ, i.e. past k_end = q0 + BQ + diag with diag = q_offset - kv_offset; a
// q tile that sees no key of the chunk (k_end <= 0) runs no tile.
__device__ __forceinline__ Block this_block(const uint8_t* smem, int Sk, int H, int head_dim, int causal,
                                            int diag) {
  Block blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.panels = head_dim / kPanelCols;
  const int groups = (blk.panels + kGroupPanels - 1) / kGroupPanels;
  blk.g = blockIdx.x % groups;
  blk.bh = blockIdx.x / groups;
  blk.b = blk.bh / H;
  blk.h = blk.bh % H;
  blk.group_panels = min(kGroupPanels, blk.panels - kGroupPanels * blk.g);
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ + diag) : Sk;
  blk.n_tiles = max(0, (k_end + BK - 1) / BK);
  return blk;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_carry_grouped_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ m_in,
                                const float* __restrict__ l_in, const float* __restrict__ acc_in,
                                float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
                                int Sq, int Sk, int H, int head_dim, float scale, int causal, int diag) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block blk = this_block(smem_raw, Sk, H, head_dim, causal, diag);
    for (int s = 0; s < kQKStages; ++s) {
      mbar_init(blk.full_qk(s), 1);
      mbar_init(blk.empty_qk(s), 128 * kConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(blk.full_v(s), 1);
      mbar_init(blk.empty_v(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread streams each key tile's Q / K panel pairs over
    // all of D, then the tile's V panels of this block's group; then it
    // outlives the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block blk = this_block(smem_raw, Sk, H, head_dim, causal, diag);
      Ring qk;
      for (int t = 0; t < blk.n_tiles; ++t) {
        for (int p = 0; p < blk.panels; ++p) {
          mbar_wait(blk.empty_qk(qk.stage), qk.phase ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(blk.full_qk(qk.stage), kQKStageBytes);
          tma_load(blk.q_panel(qk.stage), &tm_q, blk.h, blk.q0, blk.b, blk.full_qk(qk.stage), p * kPanelCols);
          tma_load(blk.k_panel(qk.stage), &tm_k, blk.h, t * BK, blk.b, blk.full_qk(qk.stage), p * kPanelCols);
          qk.next(kQKStages);
        }
        const int sv = t % kVStages;
        mbar_wait(blk.empty_v(sv), ((t / kVStages) & 1) ^ 1);
        mbar_expect_tx(blk.full_v(sv), blk.group_panels * kKPanelBytes);
        for (int j = 0; j < blk.group_panels; ++j)
          tma_load(blk.v_panel(sv, j), &tm_v, blk.h, t * BK, blk.b, blk.full_v(sv),
                   (kGroupPanels * blk.g + j) * kPanelCols);
      }
      for (int s = 0; s < kQKStages; ++s) {  // every stage released: the consumers are past their loads
        mbar_wait(blk.empty_qk(qk.stage), qk.phase ^ 1);
        qk.next(kQKStages);
      }
      for (int t = blk.n_tiles; t < blk.n_tiles + kVStages; ++t)
        mbar_wait(blk.empty_v(t % kVStages), ((t / kVStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers (one at BQ = 64): warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = this_block(smem_raw, Sk, H, head_dim, causal, diag);
  const int q0 = blk.q0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = wg * 64 * kRowBytes;  // this warpgroup's rows within each Q panel
  const int64_t col_g = kGroupPanels * kPanelCols * blk.g;  // the group's first column of acc

  // Prologue: the incoming carry, read once into the loop's registers (acc
  // in the m64n64 accumulator layout, columns col_g + 64 p + 8 j + col0, as
  // float2). Rows past Sq and the slices past the group's panels start
  // empty and are not stored.
  float o[kGroupPanels][32], m[2], l_part[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < Sq;
    m[i] = in ? m_in[int64_t(blk.bh) * Sq + row] : -INFINITY;
    l_part[i] = in && col0 == 0 ? l_in[int64_t(blk.bh) * Sq + row] : 0.f;
    const float* arow = acc_in + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim + col_g + col0;
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) {
      const bool load = in && p < blk.group_panels;
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j) {
        const float2 a =
            load ? *reinterpret_cast<const float2*>(arow + kPanelCols * p + 8 * j) : make_float2(0.f, 0.f);
        o[p][4 * j + 2 * i] = a.x;
        o[p][4 * j + 2 * i + 1] = a.y;
      }
    }
  }

  Ring qk;
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int k0 = t * BK;

    // S = Q . K^T over D, one Q / K panel pair (four k-steps of 16) per stage,
    // in chains of kChainPanels panels: wgmma sums a chain into sp, one
    // panel's products in flight while the next panel's are issued, and each
    // chain's sum is added into sc in f32 registers. A stage is released once
    // the products that read it are done.
    float sc[BK / 2], sp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    int read = 0;  // the stage whose products are still in flight
#pragma unroll 1
    for (int p = 0; p < blk.panels; ++p) {
      const bool first = p % kChainPanels == 0;  // a chain starts: sp is overwritten
      mbar_spin(blk.full_qk(qk.stage), qk.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(sp, smem_desc(blk.q_panel(qk.stage) + q_rows + 32 * kk),
                           smem_desc(blk.k_panel(qk.stage) + 32 * kk), kk > 0 || !first);
      wgmma_commit();
      wgmma_wait_one();  // the previous panel's products are done
      if (!first) mbar_arrive(blk.empty_qk(read));
      read = qk.stage;
      qk.next(kQKStages);
      if (p % kChainPanels == kChainPanels - 1 || p == blk.panels - 1) {  // the chain ends: its sum into sc
        wgmma_wait_all();
        fence_regs(sp);
        mbar_arrive(blk.empty_qk(read));
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] += sp[e];
      }
    }
    // Scale, mask at global positions (key col is masked for q row `row`,
    // both chunk positions, when col > row + diag), and the online softmax,
    // two rows per thread.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + 64 * wg + diag);
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
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
          const float pv = expf(sc[4 * j + 2 * i + c] - mx);
          sc[4 * j + 2 * i + c] = pv;
          ps += pv;
        }
      }
      l_part[i] = corr[i] * l_part[i] + ps;
    }
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e / 2) % 2];

    // P as A fragments: k-step kk of P . V covers keys [16 kk, 16 kk + 16),
    // which are accumulator elements [8 kk, 8 kk + 8) in fragment order.
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) split_bf16x2(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

    // acc[:, panel p] += P_hi . V[:, panel p] + P_lo . V[:, panel p] for all
    // four slices (a partial group's extra slices are never stored); within a
    // panel, V rows of 16 keys are 2048 bytes apart.
    const int sv = t % kVStages;
    mbar_spin(blk.full_v(sv), (t / kVStages) & 1);
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) fence_regs(o[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p)
        wgmma_m64n64k16_rs(o[p], p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
                           smem_desc(blk.v_panel(sv, p) + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < kGroupPanels; ++p)
        wgmma_m64n64k16_rs(o[p], p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                           smem_desc(blk.v_panel(sv, p) + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) fence_regs(o[p]);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(blk.empty_v(sv));  // this stage's V is no longer read
  }

  // Epilogue: the new carry, unnormalized and in f32: group 0 writes m and
  // the quad-summed l (no clamp, no log); every group its columns of acc.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l = quad_sum(l_part[i]);
    if (row >= Sq) continue;
    if (blk.g == 0 && col0 == 0) {
      m_out[int64_t(blk.bh) * Sq + row] = m[i];
      l_out[int64_t(blk.bh) * Sq + row] = l;
    }
    float* arow = acc_out + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim + col_g + col0;
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) {
      if (p >= blk.group_panels) break;
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j)
        *reinterpret_cast<float2*>(arow + kPanelCols * p + 8 * j) =
            make_float2(o[p][4 * j + 2 * i], o[p][4 * j + 2 * i + 1]);
    }
  }
}

// --- host side -------------------------------------------------------------------

// Once: the shared-memory limit and the register-split guard.
cudaError_t prepare() {
  static const cudaError_t status =
      prepare_split(reinterpret_cast<const void*>(flash_carry_grouped_sm90_kernel), kThreads, kProducerRegs,
                    kConsumerRegs, kConsumers, kSmemBytes);
  return status;
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v with head_dim a multiple of 64 from 128
// up, 16-byte aligned; m / l [B, H, Sq] and acc [B, Sq, H, head_dim] f32, acc
// 8-byte aligned; *_in and *_out must not overlap.
cudaError_t launch_flash_carry_grouped_sm90(const void* q, const void* k, const void* v, const float* m_in,
                                            const float* l_in, const float* acc_in, float* m_out, float* l_out,
                                            float* acc_out, int B, int Sq, int Sk, int H, int head_dim, float scale,
                                            bool causal, int q_offset, int kv_offset, cudaStream_t stream) {
  if (head_dim < 2 * kPanelCols || head_dim % kPanelCols != 0) return cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, Sq, H, BQ, head_dim) || !encode_bshd(encode, &tk, k, B, Sk, H, BK, head_dim) ||
      !encode_bshd(encode, &tv, v, B, Sk, H, BK, head_dim))
    return cudaErrorInvalidValue;
  const cudaError_t e = prepare();
  if (e != cudaSuccess) return e;
  // Rows run below Sq + BQ and columns below Sk, so any diag past either end
  // of [-(Sq + BQ), Sk] masks (and skips tiles) as that end does; the clamp
  // keeps row + diag and q0 + BQ + diag inside int.
  const long long diag = std::min<long long>(Sk, std::max<long long>(-(Sq + BQ), (long long)q_offset - kv_offset));
  const int groups = (head_dim / kPanelCols + kGroupPanels - 1) / kGroupPanels;
  const dim3 grid(B * H * groups, (Sq + BQ - 1) / BQ);
  flash_carry_grouped_sm90_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, m_in, l_in, acc_in, m_out, l_out, acc_out, Sq, Sk, H, head_dim, scale, causal ? 1 : 0, int(diag));
  return cudaGetLastError();
}

}  // namespace p2pfl
