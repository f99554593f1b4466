// Flash-attention forward for Hopper's tensor cores (sm_90a) at every head
// size above 256: the bf16 forward, with and without the per-row logsumexp,
// with the head size a run-time argument.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_fwd_grouped_sm90<with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd_grouped_sm90<with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
// for bf16 inputs at a head size D that is a multiple of 64 above 256
// (ops/_kernels.py zero-pads 256 < D <= 512 to 512 and larger D to the next
// multiple of 64). The TPU kernels keep (block, D) f32 scratch in VMEM and
// take any D; up to 256 the bf16 forward is flash_fwd_sm90.cu's (D 64) and
// flash_fwd_wide_sm90.cu's (D 128 / 256) kernel, which this one follows.
// The bf16 backward pair above 256 is flash_bwd_grouped_sm90.cu's; the bf16
// carry fold above 64 and the f32 forward at every D are the CUDA-core
// kernels of flash_attn.cu and flash_chunked.cu.
//
// What it computes is what flash_fwd_wide_sm90.cu computes: scores S = Q.K^T
// are exact bf16 products summed in f32 by wgmma, then multiplied by the
// scale 1/sqrt(D) in f32 (one rounding where the reference rounds q * scale
// first: about one f32 ulp of each score). The causal mask writes -0.7 *
// FLT_MAX (columns past Sk: -inf), the online softmax uses expf, l is
// clamped at 1e-30 and lse = m + log(l), all in f32. P . V is P_hi . V +
// P_lo . V with P_hi = bf16(P), P_lo = bf16(P - P_hi), both into one f32
// accumulator, so the output is held to the plain version within 1e-6 + 1
// bf16 ulp + 2^-15 of its row's mass sum_j (p_j / l) |v_j| (ops/attention.py
// plain_flash_row_mass), and lse within 1e-5.
//
// What bounds it on this card: at the paths' shapes ([8, 1024, 1, 512] and
// [8, 1024, 1, 1024] causal; [16, 1024, 1, D] without lse) the work is that
// of the D 64 forward at [8, 1024, 8, 64] times D / 512: ~254 FLOP per byte
// of q, k, v and out, under the bf16 ridge (~295), so the bound is the
// bytes (10 / 20 us at D 512, 20 / 40 us at D 1024, at 3.35 TB/s). The
// tensor work exceeds the bound's count twice over: P . V is done twice
// (the split), and S once per group of O's columns (below), 2x at D 512 and
// 4x at D 1024; the Q panels are re-read from L2 once per key tile.
//
// Design (flash_fwd_wide_sm90.cu's, with D split two ways):
//   * one block per (b * h, q tile of BQ = 128 rows, group of up to four
//     64-column panels of O): G = ceil(D / 256) groups, the last one partial
//     (D 576: 4 + 4 + 1 panels); the group blocks of a q tile are neighbours
//     in the grid (they read the same Q and K), and q tiles are handed out
//     longest first; three warpgroups: a TMA producer (one thread;
//     setmaxnreg 40) and two consumers of 64 q rows each (setmaxnreg 232);
//   * S = Q.K^T over all of D on the tensor cores, for each key tile of BK =
//     64: the producer streams D / 64 pairs of one Q panel (128 x 64 bf16,
//     16 KB) and one K panel (64 x 64, 8 KB) through a ring of six stages;
//     each is a TMA box {64, 1, rows, 1} of one tensor map over [B, S, H, D]
//     (sm90_common.cuh encode_bshd) landing as its own 128-byte-swizzled
//     panel. A whole Q tile (256 KB at D 1024) does not fit beside K and V,
//     so Q is streamed, not resident. The consumers issue wgmma m64n64k16,
//     four k-steps a panel, into one S accumulator of 32 f32 a thread, one
//     panel's products in flight while the next panel's are issued; a stage
//     is released when the products that read it are done;
//   * every group block of a q tile runs the same S arithmetic in the same
//     order, so all reach bit-identical m and l; only group 0 writes lse;
//   * the online softmax runs in the accumulator's layout (two rows per
//     thread, row max and sum over the 4-lane quad), as the wide kernel's;
//   * O += P_hi.V + P_lo.V for the block's own group only: the producer
//     loads the group's V panels (64 keys x up to 256 columns, 32 KB) into a
//     2-stage ring; wgmma m64n64k16 with A from registers (the S
//     accumulator's layout is the next A fragment's), one per V panel per
//     k-step of 16 keys, each into its own 32-register slice of O (at most 4
//     x 32 = 128 f32 a thread, the D 256 wide kernel's budget). A partial
//     group runs the products of all four slices, so every register index
//     stays static: the slices past its panels read V slots it never loads
//     and are never stored;
//   * shared memory: 6 x 24 KB (Q / K) + 2 x 32 KB (V) = 208 KB of the 227 KB
//     a block has; a panel pair is ~0.14 us of tensor work for the block, so
//     six stages keep ~0.8 us of loads in flight;
//   * causal k tiles wholly in a q tile's future are skipped.
//
// Interface: p2pfl::launch_flash_fwd_grouped_sm90, called by p2pfl_flash_fwd
// in flash_attn.cu for bf16 above 256; it encodes the tensor maps on each
// call, allocates nothing, launches on the given stream and returns a CUDA
// error code (cudaErrorInvalidValue for a head size that is not a multiple of
// 64 or is 256 or below, or a tensor map that cannot be encoded).

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;          // q rows per block (two consumer warpgroups of 64)
constexpr int BK = 64;           // keys per K / V tile
constexpr int kPanelCols = 64;   // the columns of one TMA box and one 128-byte swizzled panel
constexpr int kGroupPanels = 4;  // 64-column panels of O per block: 256 columns
constexpr int kQKStages = 6;     // Q / K panel-pair ring depth
constexpr int kVStages = 2;      // V tile ring depth
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

constexpr uint32_t kQPanelBytes = BQ * kRowBytes;                  // 16 KB
constexpr uint32_t kKPanelBytes = BK * kRowBytes;                  // 8 KB, as a V panel
constexpr uint32_t kQKStageBytes = kQPanelBytes + kKPanelBytes;    // 24 KB
constexpr uint32_t kVStageBytes = kGroupPanels * kKPanelBytes;     // 32 KB
constexpr uint32_t kRingBytes = kQKStages * kQKStageBytes + kVStages * kVStageBytes;
constexpr uint32_t kBarrierBytes = 8 * 2 * (kQKStages + kVStages);  // a full and an empty barrier per stage
constexpr size_t kSmemBytes = 1024 + kRingBytes + kBarrierBytes;    // 1024: alignment

static_assert(BQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");
static_assert(kPanelCols * 2 == int(kRowBytes), "a panel row is the 128-byte swizzle atom");
static_assert(kQKStageBytes % 1024 == 0 && kVStageBytes % 1024 == 0, "panels stay 1024-byte aligned");
static_assert(kSmemBytes == 214144, "tiles changed");
static_assert(kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");

// Where a block's panels and barriers lie in shared memory, and its work;
// each role computes it after its setmaxnreg.
struct Block {
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  int bh, b, h, g, q0, n_tiles;
  int panels;        // D / 64: the Q / K panel pairs of a key tile
  int group_panels;  // this block's panels of O and V: 4, or fewer in the last group

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

__device__ __forceinline__ Block this_block(const uint8_t* smem, int Sk, int H, int head_dim, int causal) {
  Block blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.panels = head_dim / kPanelCols;
  const int groups = (blk.panels + kGroupPanels - 1) / kGroupPanels;
  blk.g = blockIdx.x % groups;
  blk.bh = blockIdx.x / groups;
  blk.b = blk.bh / H;
  blk.h = blk.bh % H;
  blk.group_panels = min(kGroupPanels, blk.panels - kGroupPanels * blk.g);
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;            // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + BK - 1) / BK;
  return blk;
}

template <bool WITH_LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_grouped_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int Sq, int Sk, int H, int head_dim, float scale,
                              int causal) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block blk = this_block(smem_raw, Sk, H, head_dim, causal);
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
    // all of D, then the tile's V panels of this block's group.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block blk = this_block(smem_raw, Sk, H, head_dim, causal);
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
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = this_block(smem_raw, Sk, H, head_dim, causal);
  const int q0 = blk.q0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = wg * 64 * kRowBytes;  // this warpgroup's rows within each Q panel

  float o[kGroupPanels][32];  // O's columns [256 g + 64 p, 256 g + 64 p + 64) in the m64n64 accumulator layout
#pragma unroll
  for (int p = 0; p < kGroupPanels; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this thread's share of l; summed over the quad at the end

  Ring qk;
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int k0 = t * BK;

    // S = Q . K^T over D, one Q / K panel pair (four k-steps of 16) per stage;
    // a stage is released once the products that read it are done.
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    int read = 0;  // the stage whose products are still in flight
#pragma unroll 1
    for (int p = 0; p < blk.panels; ++p) {
      mbar_spin(blk.full_qk(qk.stage), qk.phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(sc, smem_desc(blk.q_panel(qk.stage) + q_rows + 32 * kk),
                           smem_desc(blk.k_panel(qk.stage) + 32 * kk), 1);
      wgmma_commit();
      wgmma_wait_one();  // the previous panel's products are done
      if (p > 0) mbar_arrive(blk.empty_qk(read));
      read = qk.stage;
      qk.next(kQKStages);
    }
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(blk.empty_qk(read));

    // Scale, mask, and the online softmax, two rows per thread.
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + 64 * wg);
    if (edge) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
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

    // O[:, panel p] += P_hi . V[:, panel p] + P_lo . V[:, panel p] for the
    // group's panels; within a panel, V rows of 16 keys are 2048 bytes apart.
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

  // Epilogue: the group's columns of out = acc / max(l, 1e-30) in bf16;
  // group 0 writes lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l_safe = fmaxf(quad_sum(l_part[i]), 1e-30f);
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim +
                          kGroupPanels * kPanelCols * blk.g;
#pragma unroll
    for (int p = 0; p < kGroupPanels; ++p) {
      if (p >= blk.group_panels) break;
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j) {
        const __nv_bfloat162 pair = __float22bfloat162_rn(
            make_float2(o[p][4 * j + 2 * i] / l_safe, o[p][4 * j + 2 * i + 1] / l_safe));
        *reinterpret_cast<__nv_bfloat162*>(orow + kPanelCols * p + 8 * j + col0) = pair;
      }
    }
    if (WITH_LSE && blk.g == 0 && col0 == 0) lse[int64_t(blk.bh) * Sq + row] = m[i] + logf(l_safe);
  }
}

// --- host side -------------------------------------------------------------------

template <bool WITH_LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk, int H,
                   int head_dim, float scale, bool causal, cudaStream_t stream) {
  const auto kern = flash_fwd_grouped_sm90_kernel<WITH_LSE>;
  // Once per instance: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, Sq, H, BQ, head_dim) || !encode_bshd(encode, &tk, k, B, Sk, H, BK, head_dim) ||
      !encode_bshd(encode, &tv, v, B, Sk, H, BK, head_dim))
    return cudaErrorInvalidValue;
  const int groups = (head_dim / kPanelCols + kGroupPanels - 1) / kGroupPanels;
  const dim3 grid(B * H * groups, (Sq + BQ - 1) / BQ);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H,
                                               head_dim, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / o with head_dim a multiple of 64
// above 256, 16-byte aligned; lse [B, H, Sq] f32 or nullptr (the forward
// that writes no logsumexp).
cudaError_t launch_flash_fwd_grouped_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                          int Sq, int Sk, int H, int head_dim, float scale, bool causal,
                                          cudaStream_t stream) {
  if (head_dim <= 256 || head_dim % kPanelCols != 0) return cudaErrorInvalidValue;
  return lse != nullptr ? launch<true>(q, k, v, o, lse, B, Sq, Sk, H, head_dim, scale, causal, stream)
                        : launch<false>(q, k, v, o, nullptr, B, Sq, Sk, H, head_dim, scale, causal, stream);
}

}  // namespace p2pfl
