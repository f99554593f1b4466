// Flash-attention forward for Hopper's tensor cores (sm_90a) at head sizes
// 128 and 256: the bf16 forward, with and without the per-row logsumexp.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_fwd_wide_sm90<D, with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd_wide_sm90<D, with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
// for bf16 inputs at D = 128 and 256 (ops/_kernels.py zero-pads 64 < D < 128
// to 128 and 128 < D < 256 to 256). D = 64 is flash_fwd_sm90.cu's kernel,
// which this one follows; it is a template of its own so that the D = 64
// kernel keeps its code. The bf16 backward pair and carry fold at these
// widths, and the f32 forward at every width, are the CUDA-core kernels of
// flash_attn.cu.
//
// What it computes is what flash_fwd_sm90.cu computes: scores S = Q.K^T are
// exact bf16 products summed in f32 by wgmma, then multiplied by the scale
// 1/sqrt(D) in f32. Unlike D = 64's 2^-3, 1/sqrt(128) is not a power of
// two, so this rounds once where the reference's (q * scale) . k rounds
// each q element first: the two differ by about one f32 ulp of each score,
// as in the zero-padded D = 32 / 48 calls of the D = 64 kernel, and the bars
// below are the D = 64 ones. The causal mask writes -0.7 * FLT_MAX (columns
// past Sk: -inf), the online softmax uses expf, l is clamped at 1e-30 and
// lse = m + log(l), all in f32. P . V is P_hi . V + P_lo . V with P_hi =
// bf16(P), P_lo = bf16(P - P_hi), both into one f32 accumulator, so the
// output is held to the plain version within 1e-6 + 1 bf16 ulp + 2^-15 of
// its row's mass sum_j (p_j / l) |v_j| (ops/attention.py
// plain_flash_row_mass), and lse within 1e-5.
//
// What bounds it on this card: at the paths' shapes ([8, 1024, 4, 128] and
// [8, 1024, 2, 256] causal; [16, 1024, H, D] without lse) the FLOPs and
// bytes are those of the D = 64 forward at [8, 1024, 8, 64]: ~254 FLOP per
// byte of q, k, v and out, under the bf16 ridge (~295), so the bound is the
// bytes (~10 / 20 us at 3.35 TB/s). The split adds half again to the
// tensor cores' work; per score the CUDA cores do an expf and a handful of
// other instructions, as at D = 64, but each score now costs the tensor
// cores twice (D 128) or four times (D 256) as many products, so the
// per-score CUDA-core work weighs less than at D = 64. D = 256 has a
// quarter of D = 64's blocks: [8, 1024, 2, 256] is 128 blocks, one wave on
// 132 SMs, so the last causal q tile's 16 key tiles set its time.
//
// Design (flash_fwd_sm90.cu's, with D split into panels):
//   * one block per (b * h, q tile of BQ = 128 rows), q tiles handed out
//     longest first; three warpgroups: a TMA producer (one thread;
//     setmaxnreg 40) and two consumers of 64 q rows each (setmaxnreg 232);
//   * a bf16 row is 256 / 512 bytes but the 128-byte swizzle atom is 64
//     columns, so every tile is D / 64 panels: TMA boxes {64, 1, rows, 1}
//     of one tensor map over [B, S, H, D] (sm90_common.cuh encode_bshd),
//     each landing as its own rows x 128-byte swizzled panel;
//   * tiles: D = 128 takes K / V tiles of BK = 128 keys, D = 256 of 64, in
//     a 2-stage ring: shared memory Q 32 KB + 2 x (K 32 + V 32) = 160 KB
//     at D = 128, Q 64 KB + 2 x (32 + 32) = 192 KB at D = 256, of the
//     227 KB a block has; BK = 64 at D = 256 keeps S (BK / 2 f32 per
//     thread) and P's halves (BK / 4 words each) small beside O's 128 f32;
//   * S = Q.K^T: wgmma m64n128k16 (D 128) or m64n64k16 (D 256) from shared
//     memory, D / 16 k-steps, k-step kk reading 32 bytes at 32 (kk % 4) in
//     panel kk / 4 of both operands;
//   * the online softmax runs in the accumulator's layout (two rows per
//     thread, row max and sum over the 4-lane quad);
//   * O += P_hi.V + P_lo.V: one wgmma m64n64k16 per 64-column panel of V
//     per k-step of 16 keys, each into its own 32-register slice of O (A
//     from registers: the S accumulator's layout is the next A fragment's;
//     the V panel MN-major in shared memory, as at D = 64);
//   * causal k tiles wholly in a q tile's future are skipped.
//
// Interface: p2pfl::launch_flash_fwd_wide_sm90, called by p2pfl_flash_fwd
// in flash_attn.cu; it encodes the tensor maps on each call, launches on the
// given stream and returns a CUDA error code (cudaErrorInvalidValue if a
// tensor map cannot be encoded or the head size is not 128 or 256).

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block (two consumer warpgroups of 64)
constexpr int kStages = 2;     // K / V ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPanelCols = 64;  // the columns of one TMA box and one 128-byte swizzled panel

static_assert(BQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");
static_assert(kPanelCols * 2 == int(kRowBytes), "a panel row is the 128-byte swizzle atom");

// The tiles of head size HD: BK keys per K / V tile, HD / 64 panels per row.
template <int HD>
struct Tiles {
  static constexpr int BK = HD == 128 ? 128 : 64;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr uint32_t kQPanelBytes = BQ * kRowBytes;  // 16 KB
  static constexpr uint32_t kKPanelBytes = BK * kRowBytes;  // 16 KB (D 128) or 8 KB (D 256)
  static constexpr uint32_t kQBytes = kPanels * kQPanelBytes;
  static constexpr uint32_t kTileBytes = kPanels * kKPanelBytes;  // K, and as much for V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr size_t kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + kBarrierBytes;  // 1024: alignment
};
static_assert(Tiles<128>::kSmemBytes == 164904 && Tiles<256>::kSmemBytes == 197672, "tiles changed");
static_assert(Tiles<256>::kSmemBytes <= 232448, "a block has at most 232,448 bytes of shared memory");

// Where a block's panels and barriers lie in shared memory, and its work;
// each role computes it after its setmaxnreg (flash_fwd_sm90.cu's Block).
template <int HD>
struct Block {
  using T = Tiles<HD>;
  uint32_t base;  // the panels' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_panel(int p) const { return base + p * T::kQPanelBytes; }
  __device__ uint32_t k_panel(int s, int p) const {
    return base + T::kQBytes + s * T::kStageBytes + p * T::kKPanelBytes;
  }
  __device__ uint32_t v_panel(int s, int p) const { return k_panel(s, p) + T::kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + T::kQBytes + kStages * T::kStageBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t q_bar() const { return full_bar(2 * kStages); }
};

template <int HD>
__device__ __forceinline__ Block<HD> this_block(const uint8_t* smem, int Sk, int H, int causal) {
  Block<HD> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;             // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + Tiles<HD>::BK - 1) / Tiles<HD>::BK;
  return blk;
}

// S (+)= Q . K^T for one k-step, by the width of the K tile.
__device__ __forceinline__ void wgmma_qk(float (&sc)[64], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n128k16_ss(sc, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_qk(float (&sc)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n64k16_ss(sc, a, b, scale_d);
}

template <int HD, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H, float scale, int causal) {
  using T = Tiles<HD>;
  constexpr int BK = T::BK, P = T::kPanels;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block<HD> blk = this_block<HD>(smem_raw, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: one thread loads Q and keeps the K / V ring full, a box per panel.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block<HD> blk = this_block<HD>(smem_raw, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), T::kQBytes);
      for (int p = 0; p < P; ++p)
        tma_load(blk.q_panel(p), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar(), p * kPanelCols);
      for (int t = 0; t < blk.n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(s), T::kStageBytes);
        for (int p = 0; p < P; ++p) {
          tma_load(blk.k_panel(s, p), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(s), p * kPanelCols);
          tma_load(blk.v_panel(s, p), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(s), p * kPanelCols);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block<HD> blk = this_block<HD>(smem_raw, Sk, H, causal);
  const int b = blk.b, h = blk.h, q0 = blk.q0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = wg * 64 * kRowBytes;  // this warpgroup's rows within each Q panel

  float o[P][32];  // O's columns [64 p, 64 p + 64) in the m64n64 accumulator layout
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this thread's share of l; summed over the quad at the end

  mbar_wait(blk.q_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S = Q . K^T over D in D / 16 k-steps of 16 (32 bytes of a panel's row).
    float sc[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk(sc, smem_desc(blk.q_panel(kk / 4) + q_rows + 32 * (kk % 4)),
               smem_desc(blk.k_panel(s, kk / 4) + 32 * (kk % 4)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

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
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e / 2) % 2];

    // P as A fragments: k-step kk of P . V covers keys [16 kk, 16 kk + 16),
    // which are accumulator elements [8 kk, 8 kk + 8) in fragment order.
    uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) split_bf16x2(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

    // O[:, panel p] += P_hi . V[:, panel p] + P_lo . V[:, panel p]; within a
    // panel, V rows of 16 keys are 2048 bytes apart.
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(o[p]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgmma_m64n64k16_rs(o[p], p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
                           smem_desc(blk.v_panel(s, p) + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < P; ++p)
        wgmma_m64n64k16_rs(o[p], p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                           smem_desc(blk.v_panel(s, p) + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(o[p]);
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
    __nv_bfloat16* orow = out + ((int64_t(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < kPanelCols / 8; ++j) {
        const __nv_bfloat162 pair = __float22bfloat162_rn(
            make_float2(o[p][4 * j + 2 * i] / l_safe, o[p][4 * j + 2 * i + 1] / l_safe));
        *reinterpret_cast<__nv_bfloat162*>(orow + kPanelCols * p + 8 * j + col0) = pair;
      }
    if (WITH_LSE && col0 == 0) lse[int64_t(blockIdx.x) * Sq + row] = m[i] + logf(l_safe);
  }
}

// --- host side -------------------------------------------------------------------

template <int HD, bool WITH_LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk, int H,
                   float scale, bool causal, cudaStream_t stream) {
  using T = Tiles<HD>;
  const auto kern = flash_fwd_wide_sm90_kernel<HD, WITH_LSE>;
  // Once per instance: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads, kProducerRegs,
                                                    kConsumerRegs, kConsumers, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(encode, &tq, q, B, Sq, H, BQ, HD) || !encode_bshd(encode, &tk, k, B, Sk, H, T::BK, HD) ||
      !encode_bshd(encode, &tv, v, B, Sk, H, T::BK, HD))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, scale,
                                                  causal ? 1 : 0);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_with_lse(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
                            int H, float scale, bool causal, cudaStream_t stream) {
  return lse != nullptr ? launch<HD, true>(q, k, v, o, lse, B, Sq, Sk, H, scale, causal, stream)
                        : launch<HD, false>(q, k, v, o, nullptr, B, Sq, Sk, H, scale, causal, stream);
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / o with head_dim 128 or 256, 16-byte
// aligned; lse [B, H, Sq] f32 or nullptr (the forward that writes no
// logsumexp).
cudaError_t launch_flash_fwd_wide_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                       int Sq, int Sk, int H, int head_dim, float scale, bool causal,
                                       cudaStream_t stream) {
  switch (head_dim) {
    case 128: return launch_with_lse<128>(q, k, v, o, lse, B, Sq, Sk, H, scale, causal, stream);
    case 256: return launch_with_lse<256>(q, k, v, o, lse, B, Sq, Sk, H, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace p2pfl
