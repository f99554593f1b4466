// Ring attention's bf16 fold of one kv chunk into an online-softmax carry on
// Hopper's tensor cores (sm_90a) at head sizes below 64, read at the true
// head size.
//
// Replaces the Pallas TPU kernel of p2pfl_tpu/ops/attention.py:
//   flash_carry_narrow_sm90<W>  <- _flash_carry_kernel  (pallas_call at :590)
// for bf16 q / k / v at a head size D below 64 that is a multiple of 8, in
// instances of box width W = 16, 32 and 64 (D 8 and 16 take W 16, D 24 and
// 32 take W 32, D 40, 48 and 56 take W 64). ops/_kernels.py zero-pads any
// other D below 57 to the next multiple of 8 (TMA strides in multiples of 16
// bytes) and D 57-63 to 64, which run flash_fwd_sm90.cu's D 64 carry kernel;
// above 64 the bf16 fold is flash_carry_grouped_sm90.cu's, and the f32 fold
// at every D stays on the CUDA cores (flash_attn.cu, flash_chunked.cu), the
// 1e-5 parity path.
//
// What it computes is ops/attention.py plain_flash_chunk_update, the
// reference's _flash_carry_kernel, from an incoming carry (m, l [B, H, Sq];
// acc [B, Sq, H, D]; f32) into new buffers, unnormalized: m_new = max(m_in,
// rowmax S), l = exp(m_in - m_new) l_in + sum p, acc = exp(m_in - m_new)
// acc_in + P.V, with no clamp and no log. S = Q.K^T is exact bf16 products
// summed in f32 by one wgmma chain of W / 16 (at most four) k-steps, then
// multiplied by the scale in f32. q rows sit at global positions q_offset +
// [0, Sq) and keys at kv_offset + [0, Sk); the causal mask (-0.7 * FLT_MAX;
// keys past Sk: -inf) and the future-tile skip compare those. P.V is
// P_hi.V + P_lo.V with P_hi = bf16(P), P_lo = bf16(P - P_hi), into one f32
// accumulator, as every bf16 kernel of the port does (a single bf16 P fails
// the port's bar). acc is held to the plain version within 1e-5 + 1e-5 |ref|
// + 1e-6 l + 2^-15 of the fold's mass exp(S - m_new) @ |V|
// (plain_flash_chunk_mass), m within 1e-5.
//
// What bounds it on this card: at the ring's chunk shapes ([2, 1024, H, D],
// H D = 512) the bytes (q, k, v in bf16 and the f32 carry read and written
// once) take ~4.5 us at 3.35 TB/s and the products ~2.2 us at 989 TFLOP/s,
// but a past fold computes every score of the chunk (16.8M at D 48, 33.5M at
// D 32, 67M at D 16), and the per-score arithmetic on the CUDA cores (one
// expf, the scale, max and sum, the split of P into two bf16 halves) costs
// the same at every D: at the narrow forward's ~1e12 scores a second, ~17 /
// 34 / 67 us. That floor sits above the bytes bound. The D 64 kernel on
// padded heads added to it the host's four pad copies and one slice copy
// per fold, the f32 acc's padded bytes, and the tensor work and K / V bytes
// of the zero columns.
//
// Design (flash_fwd_narrow_sm90.cu's tile loop around an incoming carry):
//   * TMA reads q, k and v through 4-D tensor maps encoded on the true D
//     (dims {D, H, S, B}) in boxes {W, 1, 64, 1} under the swizzle of 2 W
//     bytes (sm90_common.cuh encode_bshd_box); TMA fills the columns D..W-1
//     with zeros, as it fills rows past S, so no host copy is made;
//   * one block per (b * h, q tile of 64 rows), q tiles handed out longest
//     first; two warpgroups: a TMA producer (one thread) and one consumer.
//     Four blocks an SM at W 16 / 32 (64 registers a thread at launch, split
//     24 / 104 by setmaxnreg), three at W 64 (80, split 24 / 136), as the
//     narrow forward, whose per-score work is the same;
//   * Q is loaded once; K and V tiles of BK = 64 keys stream through a ring
//     of two stages with full / empty mbarriers
//     (scripts/torch_kernel_variants.py carry_narrow times three stages and
//     three blocks an SM at W 16 / 32);
//   * S = Q.K^T: wgmma m64n64k16 in W / 16 k-steps, both operands K-major
//     under the narrow swizzles (smem_desc_span); the online softmax in the
//     accumulator's layout (two rows per thread, row max and sum over the
//     4-lane quad); O += P_hi.V + P_lo.V by wgmma m64nWk16 with A from
//     registers (wgmma_rs) and the V tile as the MN-major B operand;
//   * prologue, once Q has landed: the consumer reads its rows' m_in and
//     l_in once into the loop's registers, and acc_in at the true D (row
//     stride H D f32) as float2 into the O accumulator's layout (W / 2 f32 a
//     thread); columns past D and rows past Sq start at 0 and are never
//     stored. l is kept as this thread's share: l_in on the quad's lane with
//     col0 == 0, 0 on the other three (corr is the same on all four, so the
//     quad's sum at the end is the fold's l);
//   * causal key tiles wholly in a q tile's future are skipped;
//   * epilogue: m, the quad-summed l, and acc at the columns below D only.
// Where trouble lies:
//   * a skipped fold: a q tile that sees no key of the chunk (a chunk wholly
//     in its future) runs no tile; its producer loads nothing, its consumer
//     waits on no barrier at all and writes the carry back bit-identical
//     (m_in; l_in + 0 + 0 + 0 over the quad; acc_in);
//   * the producer outlives the consumer: after its last load it waits until
//     every stage is released, so a consumer stuck on a tile traps there
//     (~17 s) instead of hanging the card. The consumer's per-tile wait stays
//     unguarded, as in the narrow forward; its Q wait is guarded and comes
//     before the carry read: the same wait after it, with the incoming acc
//     in registers across the wait's clock loop, made ptxas spill that acc
//     (64 / 128 / 256 bytes at W 16 / 32 / 64) and serialize the wgmma
//     (C7512), 8-41 % slower (scripts/torch_kernel_variants.py carry_narrow;
//     the narrow forward's acc is still 0 there, which ptxas rematerializes);
//   * rows whose first processed tile holds no real key: a row with m_in =
//     -inf whose first tile is all masked gets m = MASK_VALUE and p = 1 per
//     masked key, as the reference and the plain version do, but the result
//     then depends on the tile size (64 keys here, 128 in the D 64 kernel).
//     The ring never folds such a chunk: it folds the self chunk first, and
//     kv_offset <= q_offset on every fold it does not skip, so every row sees
//     key 0 of the chunk in its first tile;
//   * under one wave: at the ring's chunk shapes the grid is 256 blocks at D
//     48 (396 slots at three an SM) and 512 at D 32 (528 slots), so a past
//     fold's time there is one block's walk over all 16 key tiles; at D 16
//     1024 blocks take about two waves.
//
// Interface: p2pfl::launch_flash_carry_narrow_sm90, called by
// p2pfl_flash_carry in flash_attn.cu for bf16 below 64; it encodes the tensor
// maps on each call, allocates nothing, launches on the given stream and
// returns a CUDA error code (cudaErrorInvalidValue for a head size that is
// not a multiple of 8 in [8, 56], or a tensor map that cannot be encoded).

#include "sm90_common.cuh"

#include <algorithm>

namespace {

constexpr int BQ = 64;         // q rows per block: the consumer warpgroup's
constexpr int BK = 64;         // keys per K / V tile: S is one wgmma m64n64k16 per k-step
constexpr int kThreads = 256;  // the consumer warpgroup, then the producer's

// Blocks an SM (by box width W) and the ring's depth
// (scripts/torch_kernel_variants.py carry_narrow times other values).
template <int W>
constexpr int kBlocksW = W < 64 ? 4 : 3;
constexpr int kStages = 2;

template <int W>
struct Tiles {
  static constexpr int kBlocksPerSM = kBlocksW<W>;
  // setmaxnreg's split of the registers a block launches with (the register
  // file's share, a multiple of 8 a thread): at four blocks an SM 64, split
  // 24 / 104, at three 80 (24 / 136).
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

// One key tile's fold for the block's 64 q rows, on its scores sc (done):
// scale, mask at global positions, the running max m and this thread's share
// of l updated and o rescaled, then O += P_hi.V + P_lo.V, waited for. Rows
// and columns are positions within the chunk (this thread's q rows row0 and
// row0 + 8; keys k0 + ...), and key col is masked for q row `row` when col >
// row + diag, where diag = q_offset - kv_offset. first: the block's first q
// row; col0: this thread's first accumulator column.
template <int W>
__device__ __forceinline__ void fold_tile(float (&sc)[BK / 2], float (&o)[W / 2], float (&m)[2], float (&l_part)[2],
                                          uint32_t v_tile, int k0, int Sk, int first, int row0, int col0,
                                          float scale, int causal, int diag) {
  constexpr uint32_t span = Tiles<W>::kSpan;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) sc[e] *= scale;
  const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > first + diag);
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

// A key tile is in the q tile's future when kv_offset + k0 >= q_offset + q0
// + BQ, i.e. past k_end = q0 + BQ + diag with diag = q_offset - kv_offset; a
// q tile that sees no key of the chunk (k_end <= 0) runs no tile.
template <int W>
__device__ __forceinline__ Block<W> this_block(const uint8_t* smem, int Sk, int H, int causal, int diag) {
  Block<W> blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const int k_end = causal ? min(Sk, blk.q0 + BQ + diag) : Sk;
  blk.n_tiles = max(0, (k_end + BK - 1) / BK);
  return blk;
}

template <int W>
__global__ void __launch_bounds__(kThreads, Tiles<W>::kBlocksPerSM)
flash_carry_narrow_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ m_in,
                               const float* __restrict__ l_in, const float* __restrict__ acc_in,
                               float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
                               int Sq, int Sk, int H, int head_dim, float scale, int causal, int diag) {
  using T = Tiles<W>;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block<W> blk = this_block<W>(smem_raw, Sk, H, causal, diag);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 1);
      mbar_init(blk.empty_bar(s), 128);
    }
    mbar_init(blk.q_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer: one thread loads Q and keeps the K / V ring full, then
    // outlives the consumer; a q tile with no key to fold loads nothing.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kProducerRegs));
    if (threadIdx.x == 128) {
      const Block<W> blk = this_block<W>(smem_raw, Sk, H, causal, diag);
      if (blk.n_tiles > 0) {
        mbar_expect_tx(blk.q_bar(), T::kQBytes);
        tma_load(blk.q_rows(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      }
      Ring ring;
      for (int t = 0; t < blk.n_tiles; ++t) {
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(ring.stage), T::kStageBytes);
        tma_load(blk.k_tile(ring.stage), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        tma_load(blk.v_tile(ring.stage), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(ring.stage));
        ring.next(kStages);
      }
      for (int s = 0; s < kStages; ++s) {  // every stage released: the consumer is past its tiles
        mbar_wait(blk.empty_bar(ring.stage), ring.phase ^ 1);
        ring.next(kStages);
      }
    }
    return;
  }

  // Consumer: the block's 64 q rows from q0 on.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kConsumerRegs));
  const Block<W> blk = this_block<W>(smem_raw, Sk, H, causal, diag);
  const int tid = threadIdx.x;
  const int row0 = blk.q0 + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const int64_t bh = blockIdx.x;  // b * H + h: the row statistics' [B, H, Sq] slice

  if (blk.n_tiles > 0) mbar_wait(blk.q_bar(), 0);  // before the carry read: see the header

  // Prologue: the incoming carry, read once into the loop's registers (acc
  // at the true D, pairs of columns 8 j + col0 as float2; head_dim is a
  // multiple of 8, so a pair is all in or all out).
  float o[W / 2], m[2], l_part[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < Sq;
    m[i] = in ? m_in[bh * Sq + row] : -INFINITY;
    l_part[i] = in && col0 == 0 ? l_in[bh * Sq + row] : 0.f;
    const float* arow = acc_in + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim + col0;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 a =
          in && 8 * j < head_dim ? *reinterpret_cast<const float2*>(arow + 8 * j) : make_float2(0.f, 0.f);
      o[4 * j + 2 * i] = a.x;
      o[4 * j + 2 * i + 1] = a.y;
    }
  }

  Ring ring;
  for (int t = 0; t < blk.n_tiles; ++t) {
    mbar_spin(blk.full_bar(ring.stage), ring.phase);
    float sc[BK / 2];
    issue_scores<W>(sc, blk.q_rows(), blk.k_tile(ring.stage));
    wgmma_wait_all();
    fence_regs(sc);
    fold_tile<W>(sc, o, m, l_part, blk.v_tile(ring.stage), t * BK, Sk, blk.q0, row0, col0, scale, causal, diag);
    mbar_arrive(blk.empty_bar(ring.stage));  // this stage's K and V are no longer read
    ring.next(kStages);
  }

  // Epilogue: the new carry, unnormalized and in f32: m, the quad-summed l
  // (no clamp, no log) and acc at the columns below D.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l = quad_sum(l_part[i]);
    if (row >= Sq) continue;
    if (col0 == 0) {
      m_out[bh * Sq + row] = m[i];
      l_out[bh * Sq + row] = l;
    }
    float* arow = acc_out + ((int64_t(blk.b) * Sq + row) * H + blk.h) * head_dim + col0;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j >= head_dim) break;
      *reinterpret_cast<float2*>(arow + 8 * j) = make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
  }
}

// --- host side -------------------------------------------------------------------

template <int W>
cudaError_t launch(const void* q, const void* k, const void* v, const float* m_in, const float* l_in,
                   const float* acc_in, float* m_out, float* l_out, float* acc_out, int B, int Sq, int Sk, int H,
                   int head_dim, float scale, bool causal, int diag, cudaStream_t stream) {
  using T = Tiles<W>;
  const auto kern = flash_carry_narrow_sm90_kernel<W>;
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
  kern<<<grid, kThreads, T::kSmemBytes, stream>>>(tq, tk, tv, m_in, l_in, acc_in, m_out, l_out, acc_out, Sq, Sk, H,
                                                     head_dim, scale, causal ? 1 : 0, diag);
  return cudaGetLastError();
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, head_dim] q / k / v with head_dim a multiple of 8 in [8,
// 56], 16-byte aligned; m / l [B, H, Sq] and acc [B, Sq, H, head_dim] f32,
// acc 8-byte aligned; *_in and *_out must not overlap.
cudaError_t launch_flash_carry_narrow_sm90(const void* q, const void* k, const void* v, const float* m_in,
                                           const float* l_in, const float* acc_in, float* m_out, float* l_out,
                                           float* acc_out, int B, int Sq, int Sk, int H, int head_dim, float scale,
                                           bool causal, int q_offset, int kv_offset, cudaStream_t stream) {
  if (head_dim < 8 || head_dim > 56 || head_dim % 8 != 0) return cudaErrorInvalidValue;
  // Rows run below Sq + BQ and columns below Sk, so any diag past either end
  // of [-(Sq + BQ), Sk] masks (and skips tiles) as that end does; the clamp
  // keeps row + diag and q0 + BQ + diag inside int.
  const int diag =
      int(std::min<long long>(Sk, std::max<long long>(-(Sq + BQ), (long long)q_offset - kv_offset)));
  if (head_dim <= 16)
    return launch<16>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B, Sq, Sk, H, head_dim, scale, causal,
                      diag, stream);
  if (head_dim <= 32)
    return launch<32>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B, Sq, Sk, H, head_dim, scale, causal,
                      diag, stream);
  return launch<64>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, B, Sq, Sk, H, head_dim, scale, causal, diag,
                    stream);
}

}  // namespace p2pfl
