// Flash-attention forward for Hopper's tensor cores (sm_90a) at head sizes
// below 64: the bf16 forward, with and without the per-row logsumexp, read
// at the true head size.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_fwd_narrow_sm90<W, with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd_narrow_sm90<W, with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
// for bf16 inputs at a head size D below 64 that is a multiple of 8, in
// instances of box width W = 16, 32 and 64 (D 8 and 16 take W 16, D 24 and
// 32 take W 32, D 40, 48 and 56 take W 64). ops/_kernels.py zero-pads any
// other D below 57 to the next multiple of 8 (TMA strides in multiples of 16
// bytes) and D 57-63 to 64, which run flash_fwd_sm90.cu's D 64 kernel. The
// bf16 backward pair below 64 runs flash_bwd_narrow_sm90.cu and the carry
// fold flash_carry_narrow_sm90.cu, read the same way.
//
// What it computes is what flash_fwd_sm90.cu computes: scores S = Q.K^T are
// exact bf16 products summed in f32 by wgmma, then multiplied by the scale
// 1/sqrt(D) in f32 (not a power of two at D 8, 24, 32, 40, 48 and 56: one
// rounding where the reference rounds q * scale first, about one f32 ulp of
// each score). The causal mask writes -0.7 * FLT_MAX (columns past Sk:
// -inf), the online softmax uses expf, l is clamped at 1e-30 and lse = m +
// log(l), all in f32. P . V is P_hi . V + P_lo . V with P_hi = bf16(P),
// P_lo = bf16(P - P_hi), both into one f32 accumulator, so the output is
// held to the plain version within 1e-6 + 1 bf16 ulp + 2^-15 of its row's
// mass sum_j (p_j / l) |v_j| (ops/attention.py plain_flash_row_mass), and
// lse within 1e-5. The forward without lse is bit-equal to the one with it.
//
// What bounds it on this card: at the paths' shapes ([8, 1024, 16, 32] and
// [8, 1024, 32, 16] causal; [16, 1024, H, D] without lse) the bytes of q, k,
// v and out take ~10 / 20 us at 3.35 TB/s and the products ~9 / 4 us at
// 989 TFLOP/s, but the per-score arithmetic on the CUDA cores (one expf, the
// scale, max and sum, and the split of P into two bf16 halves) costs the
// same at every D, and narrow heads come with more heads: 67M causal scores
// at [8, 1024, 16, 32], 134M at [8, 1024, 32, 16], whose expf alone at the
// SFUs' ~3.7e12 a second take 18 / 36 us. That floor sits above the bytes
// bound; the padded D 64 kernel added to it the pads' copies and the tensor
// work and K / V bytes of the zero columns.
//
// Design (flash_fwd_sm90.cu's, with each row read at its true width, one
// consumer a block and several blocks an SM):
//   * TMA reads the API's [B, S, H, D] tensors through 4-D tensor maps
//     encoded on the true D (dims {D, H, S, B}, strides 2 D / 2 H D /
//     2 S H D bytes), in boxes {W, 1, rows, 1} under the swizzle of 2 W bytes
//     (32, 64 or 128: sm90_common.cuh encode_bshd_box); TMA fills the columns
//     D..W-1 with zeros, as it fills rows past S, so no host copy is made;
//   * one block per (b * h, q tile of 64 rows), q tiles handed out longest
//     first; two warpgroups: a TMA producer (one thread) and one consumer.
//     The per-score work on the CUDA cores is what bounds this kernel, and
//     more warps an SM hide its latencies: four blocks an SM at W 16 / 32
//     (64 registers a thread at launch, split 24 / 104 by setmaxnreg), three
//     at W 64 (80, split 24 / 136). The D 64 kernel's layout, two consumers
//     sharing one block's ring at 232 registers, ran 7-33 % slower, and
//     2.2x at the flash classifier's sequence of 64, where it leaves one
//     consumer idle (PERF.md);
//   * Q is loaded once; K and V tiles of BK = 64 keys stream through a ring
//     of two stages with full / empty mbarriers (three stages ran within
//     2 %; 128-key tiles at two blocks an SM ran 8-17 % slower, 32-key tiles
//     at five 9-11 % slower at D 16 / 32);
//   * S = Q.K^T: wgmma m64n64k16 in W / 16 k-steps (1 at W 16, 2 at W 32,
//     4 at W 64), both operands K-major under the narrow swizzles
//     (smem_desc_span); the online softmax runs in the accumulator's layout
//     (two rows per thread, row max and sum over the 4-lane quad). Issuing
//     the next tile's S before this tile's softmax spilled, serialized the
//     wgmma and ran 9-77 % slower;
//   * O += P_hi.V + P_lo.V: wgmma m64nWk16 (wgmma_rs) with A from registers
//     (the S accumulator's layout is the next A fragment's) and the V tile
//     as the MN-major B operand; O is W / 2 f32 a thread;
//   * causal key tiles wholly in a q tile's future, or past its last row
//     (Sq < Sk), are skipped;
//   * the epilogue stores only columns below D, at the row stride H D.
//
// Interface: p2pfl::launch_flash_fwd_narrow_sm90, called by p2pfl_flash_fwd
// in flash_attn.cu for bf16 below 64; it encodes the tensor maps on each
// call, allocates nothing, launches on the given stream and returns a CUDA
// error code (cudaErrorInvalidValue for a head size that is not a multiple of
// 8 in [8, 56], or a tensor map that cannot be encoded).

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block: the consumer warpgroup's
constexpr int BK = 64;         // keys per K / V tile: S is one wgmma m64n64k16 per k-step
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's

// Blocks an SM (by box width W) and the ring's depth
// (scripts/torch_kernel_variants.py narrow times other values).
template <int W>
constexpr int kBlocksW = W < 64 ? 4 : 3;
constexpr int kStages = 2;

template <int W>
struct Tiles {
  static constexpr int kBlocksPerSM = kBlocksW<W>;
  // setmaxnreg's split of the registers a block launches with (the register
  // file's share, a multiple of 8 a thread): at four blocks an SM 64, split
  // 24 / 104, at three 80 (24 / 136), at two 128 (40 / 216).
  static constexpr int kLaunchRegs = 65536 / (kBlocksPerSM * kThreads) / 8 * 8;
  static constexpr int kProducerRegs = kBlocksPerSM > 2 ? 24 : 40;
  static constexpr int kFreeRegs = (kLaunchRegs * kThreads - 128 * kProducerRegs) / 128 / 8 * 8;
  static constexpr int kConsumerRegs = kFreeRegs < 232 ? kFreeRegs : 232;
  static constexpr uint32_t kSpan = 2 * W;             // bytes of one box row: the swizzle span
  static constexpr uint32_t kQBytes = BQ * kSpan;      // the block's q rows
  static constexpr uint32_t kTileBytes = BK * kSpan;   // one K or V tile
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kRingBytes = kQBytes + kStages * kStageBytes;
  static constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
  static constexpr size_t kSmemBytes = 1024 + kRingBytes + kBarrierBytes;  // 1024: alignment slack

  static_assert(W == 16 || W == 32 || W == 64, "box widths 16, 32 and 64");
  static_assert((kProducerRegs + kConsumerRegs) * 128 * kBlocksPerSM <= 65536, "register file");
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(kSmemBytes * kBlocksPerSM <= 232448, "shared memory of the blocks an SM holds");
};

static_assert(Tiles<16>::kSmemBytes == 11304 && Tiles<32>::kSmemBytes == 21544 && Tiles<64>::kSmemBytes == 42024,
              "tiles changed");

// S = Q.K^T over the box's W columns (zeros past D) in W / 16 k-steps of 16
// (32 bytes along the row), issued and committed, not waited for.
template <int W>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
  constexpr uint32_t span = Tiles<W>::kSpan;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_m64n64k16_ss(sc, smem_desc_span<span>(q_rows + 32 * kk), smem_desc_span<span>(k_tile + 32 * kk), kk > 0);
  wgmma_commit();
}

// One key tile's online softmax and P . V for the block's 64 q rows, on its
// scores sc (done): scale, mask, the running max m and this thread's share
// of l updated and o rescaled, then O += P_hi.V + P_lo.V, waited for. k0:
// the tile's first key; first: the block's first q row; row0, col0: this
// thread's accumulator position.
template <int W>
__device__ __forceinline__ void softmax_pv(float (&sc)[BK / 2], float (&o)[W / 2], float (&m)[2],
                                           float (&l_part)[2], uint32_t v_tile, int k0, int Sk, int first,
                                           int row0, int col0, float scale, int causal) {
  constexpr uint32_t span = Tiles<W>::kSpan;
  // Scale, mask, and the online softmax, two rows per thread.
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
  const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first);
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
        const float p = expf(sc[4 * j + 2 * i + c] - mx);
        sc[4 * j + 2 * i + c] = p;
        ps += p;
      }
    }
    l_part[i] = corr[i] * l_part[i] + ps;
  }
#pragma unroll
  for (int e = 0; e < W / 2; ++e) o[e] *= corr[(e / 2) % 2];

  // P as A fragments: k-step kk of P . V covers keys [16 kk, 16 kk + 16),
  // which are accumulator elements [8 kk, 8 kk + 8) in fragment order.
  uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
  for (int r = 0; r < BK / 4; ++r) split_bf16x2(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

  // O += P_hi . V + P_lo . V; V rows of 16 keys are 16 * 2 W bytes apart.
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
             smem_desc_span<span>(v_tile + kk * 16 * span));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
             smem_desc_span<span>(v_tile + kk * 16 * span));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(p_hi);
  fence_regs(p_lo);
}

// Where a block's tiles and barriers lie in shared memory, and its work.
// Each role computes it after its setmaxnreg, so that no value is live
// across the register split.
template <int W>
struct Block {
  using T = Tiles<W>;
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_rows() const { return base; }
  __device__ uint32_t k_tile(int s) const { return base + T::kQBytes + s * T::kStageBytes; }
  __device__ uint32_t v_tile(int s) const { return k_tile(s) + T::kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + T::kRingBytes + 8 * s; }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t q_bar() const { return full_bar(2 * kStages); }
};

template <int W>
__device__ __forceinline__ Block<W> this_block(const uint8_t* smem, int Sq, int Sk, int H, int causal) {
  Block<W> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int k_end = causal ? min(Sk, min(Sq, blk.q0 + BQ)) : Sk;  // causal: future tiles skipped
  blk.n_tiles = (k_end + BK - 1) / BK;
  return blk;
}

template <int W, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads, Tiles<W>::kBlocksPerSM)
flash_fwd_narrow_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Sk, int H, int head_dim, float scale,
                             int causal) {
  using T = Tiles<W>;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block<W> blk = this_block<W>(smem_raw, Sq, Sk, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: one thread loads Q, then keeps the K / V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 128) {
      const Block<W> blk = this_block<W>(smem_raw, Sq, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), T::kQBytes);
      tma_load(blk.q_rows(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      Ring ring;
      for (int t = 0; t < blk.n_tiles; ++t) {
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(ring.stage), T::kStageBytes);
        tma_load(blk.k_tile(ring.stage), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        tma_load(blk.v_tile(ring.stage), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        ring.next(kStages);
      }
    }
    return;
  }

  // Consumer: the block's 64 q rows from q0 on.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const Block<W> blk = this_block<W>(smem_raw, Sq, Sk, H, causal);
  const int tid = threadIdx.x;
  const int row0 = blk.q0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);

  float o[W / 2];
#pragma unroll
  for (int e = 0; e < W / 2; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l_part[2] = {0.f, 0.f};  // this thread's share of l; summed over the quad at the end

  mbar_wait(blk.q_bar(), 0);
  Ring ring;
  for (int t = 0; t < blk.n_tiles; ++t) {
    mbar_spin(blk.full_bar(ring.stage), ring.phase);
    float sc[BK / 2];
    issue_scores<W>(sc, blk.q_rows(), blk.k_tile(ring.stage));
    wgmma_wait_all();
    fence_regs(sc);
    softmax_pv<W>(sc, o, m, l_part, blk.v_tile(ring.stage), t * BK, Sk, blk.q0, row0, col0, scale, causal);
    mbar_arrive(blk.empty_bar(ring.stage));  // this stage's K and V are no longer read
    ring.next(kStages);
  }

  // Epilogue: out = acc / max(l, 1e-30) in bf16, columns below D only;
  // lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l_safe = fmaxf(quad_sum(l_part[i]), 1e-30f);
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j >= head_dim) break;  // head_dim is a multiple of 8: a pair is all in or all out
      const __nv_bfloat162 pair =
          __float22bfloat162_rn(make_float2(o[4 * j + 2 * i] / l_safe, o[4 * j + 2 * i + 1] / l_safe));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) = pair;
    }
    if (WITH_LSE && col0 == 0) lse[int64_t(blockIdx.x) * Sq + row] = m[i] + logf(l_safe);
  }
}

// --- host side -------------------------------------------------------------------

template <int W, bool WITH_LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk, int H,
                   int head_dim, float scale, bool causal, cudaStream_t stream) {
  using T = Tiles<W>;
  const auto kern = flash_fwd_narrow_sm90_kernel<W, WITH_LSE>;
  // Once per instance: the shared-memory limit and the register-split guard.
  static const cudaError_t prepared = prepare_split(reinterpret_cast<const void*>(kern), kThreads,
                                                    T::kProducerRegs, T::kConsumerRegs, 1, T::kSmemBytes);
  if (prepared != cudaSuccess) return prepared;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd_box(encode, &tq, q, B, Sq, H, head_dim, BQ, W) ||
      !encode_bshd_box(encode, &tk, k, B, Sk, H, head_dim, BK, W) ||
      !encode_bshd_box(encode, &tv, v, B, Sk, H, head_dim, BK, W))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H,
                                                     head_dim, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq, int Sk,
                         int H, int head_dim, float scale, bool causal, cudaStream_t stream) {
  return lse != nullptr ? launch<W, true>(q, k, v, o, lse, B, Sq, Sk, H, head_dim, scale, causal, stream)
                        : launch<W, false>(q, k, v, o, nullptr, B, Sq, Sk, H, head_dim, scale, causal, stream);
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v / o with head_dim a multiple of 8 in
// [8, 56], 16-byte aligned; lse [B, H, Sq] f32 or nullptr (the forward that
// writes no logsumexp).
cudaError_t launch_flash_fwd_narrow_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                                         int Sq, int Sk, int H, int head_dim, float scale, bool causal,
                                         cudaStream_t stream) {
  if (head_dim < 8 || head_dim > 56 || head_dim % 8 != 0) return cudaErrorInvalidValue;
  if (head_dim <= 16) return launch_width<16>(q, k, v, o, lse, B, Sq, Sk, H, head_dim, scale, causal, stream);
  if (head_dim <= 32) return launch_width<32>(q, k, v, o, lse, B, Sq, Sk, H, head_dim, scale, causal, stream);
  return launch_width<64>(q, k, v, o, lse, B, Sq, Sk, H, head_dim, scale, causal, stream);
}

}  // namespace p2pfl
