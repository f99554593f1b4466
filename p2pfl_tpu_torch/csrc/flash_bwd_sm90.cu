// Flash-attention backward for Hopper's tensor cores (sm_90a): the bf16 dq
// kernel and the bf16 dk/dv kernel, two launches per backward.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_bwd_dq_sm90_kernel   <- _flash_bwd_dq_kernel   (pallas_call at :446)
//   flash_bwd_dkv_sm90_kernel  <- _flash_bwd_dkv_kernel  (pallas_call at :463)
// for bf16 inputs at head size 64. The f32 backward stays the CUDA-core pair
// of flash_attn.cu: f32 parity holds its gradients to 1e-4 and forbids TF32.
//
// What it computes is what the TPU kernels compute, from the forward's lse
// and delta = rowsum(dO * O) (f32, [B, H, Sq]) and dO in bf16, with one
// difference in rounding. Scores S = Q.K^T and dP = dO.V^T are exact bf16
// products summed in f32 by wgmma; S is scaled by 1/sqrt(64) = 2^-3 after
// the product (equal to the reference's (q * scale) . k up to the order of
// the f32 sums), causal-masked entries get the finite -0.7 * FLT_MAX,
// P = expf(S - lse), P = 0 exactly for keys (queries) past the sequence, and
// dS = P * (dP - delta), all in f32 in the accumulators' registers. The new
// choice is the second product of each kernel: the tensor cores take bf16
// operands, so its f32 A operand (dS in dq; P^T and dS^T in dk/dv) is split
// as X = X_hi + X_lo with X_hi = bf16(X), X_lo = bf16(X - X_hi), and both
// halves are multiplied into the same f32 accumulator. X_hi + X_lo equals X
// to within 2^-17 X, so the products keep ~16 bits of the operand where one
// bf16 would keep 8 (a different function: the TPU kernel's jnp.dot(ds, kb)
// is f32). The checks hold each gradient to 1 bf16 ulp + 2^-15 of its
// weighted mass (ops/attention.py plain_flash_grad_mass) of the plain
// version.
//
// What bounds it on this card: at the slice's shape ([8, 1024, 8, 64] bf16
// causal) the pair does ~300-340 FLOP per byte it must move, above the
// H100's bf16 ridge (~295), so its bound is the operations (~13 / 17 us at
// 989 TFLOP/s). Both kernels recompute S and dP (7 products per tile pair
// where a fused backward with an atomic f32 dQ does 5) so that each owns
// its outputs and the result is deterministic; the split adds one product
// per split operand. Per score the CUDA cores do an expf, the mask on edge
// tiles, dS and one or two splits, as in the forward.
//
// Design, both kernels:
//   * three warpgroups: warpgroup 2 is the producer (TMA loads; setmaxnreg
//     gives its registers away), warpgroups 0 and 1 are consumers of 64 rows
//     each (setmaxnreg raises them to 232);
//   * TMA reads the API's [B, S, H, D] tensors directly through 4-D tensor
//     maps with the 128-byte swizzle (sm90_common.cuh), rows past S zero-
//     filled; the streamed operands pass through a ring of kStages stages
//     with full / empty mbarriers; the producer's waits trap after ~17 s,
//     and after its last load it waits until the consumers have released
//     every stage, so that a consumer stuck on a tile traps there too;
//   * first products from shared memory (both operands K-major, the D = 64
//     contiguous elements of a row), second products with A from registers
//     (an accumulator's layout is the next A fragment's) and B MN-major in
//     shared memory (the tile read along its rows), as the forward's P.V.
//
// dq: one block per (b * h, q tile of 128 rows), q tiles handed out longest
// first. Q, dO and the rows' lse / delta are loaded once; K and V tiles of
// 128 keys stream. Per tile: S = Q.K^T and dP = dO.V^T (wgmma m64n128k16),
// P and dS in registers, dQ += dS_hi.K + dS_lo.K (m64n64k16). Causal k tiles
// wholly in the q tile's future are skipped. dq = 2^-3 acc.
//
// dk/dv: one block per (b * h, k tile of 128 keys), k tiles handed out in
// ascending order (under the causal mask k tile 0 sees every q tile: longest
// first). K and V are loaded once; Q and dO tiles of 64 rows stream, each
// stage carrying its rows' lse and delta in shared memory (written by the
// producer warpgroup's 128 threads, one value each, before they arrive on
// the stage's full barrier beside the TMA bytes). Per tile: S^T = K.Q^T and
// dP^T = V.dO^T (m64n64k16), whose accumulators hold P^T and dS^T in the
// layout the next products take as A; dV += P^T_hi.dO + P^T_lo.dO and
// dK += dS^T_hi.Q + dS^T_lo.Q (m64n64k16). Causal q tiles that cannot see
// the k tile are skipped (the q loop starts at floor(k0 / 64) * 64).
// dk = 2^-3 dK, dv = dV. 64 q rows per step keep the four f32 accumulators
// at 32 registers each (S^T, dP^T, dK, dV).
//
// Interface: host functions called by p2pfl_flash_bwd_dq / p2pfl_flash_bwd_dkv
// in flash_attn.cu for bf16, which encode the tensor maps on each call,
// launch on the given stream and return a CUDA error code
// (cudaErrorInvalidValue if a tensor map cannot be encoded).

#include "sm90_common.cuh"

namespace {

constexpr int kConsumers = 2;  // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536, "register file");

// Store mul * acc, one consumer thread's rows row0 and row0 + 8 of an
// m64n64 accumulator, as bf16 into a [B, S, H, 64] tensor; rows past S are
// not written.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&acc)[32], float mul,
                                           int row0, int col0, int b, int h, int S, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + ((int64_t(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 pair =
          __float22bfloat162_rn(make_float2(mul * acc[4 * j + 2 * i], mul * acc[4 * j + 2 * i + 1]));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) = pair;
    }
  }
}

// --- dq ---------------------------------------------------------------------------

namespace dq_cfg {

constexpr int BQ = 128;     // q rows per block (two consumer warpgroups of 64)
constexpr int BK = 128;     // keys per K / V tile
constexpr int kStages = 2;  // K / V ring depth
constexpr uint32_t kQBytes = BQ * kRowBytes;     // 16 KB for Q, as much for dO
constexpr uint32_t kTileBytes = BK * kRowBytes;  // 16 KB for K, as much for V
constexpr uint32_t kStageBytes = 2 * kTileBytes;
constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
constexpr size_t kSmemBytes = 1024 + 2 * kQBytes + kStages * kStageBytes + kBarrierBytes;  // 1024: alignment slack

static_assert(BQ == 64 * kConsumers, "each consumer warpgroup owns 64 q rows");

// Where a block's tiles and barriers lie in shared memory, and its work.
// Each role computes it after its setmaxnreg, so that no value is live
// across the register split.
struct Block {
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, q0, n_tiles;

  __device__ uint32_t q_tile() const { return base; }
  __device__ uint32_t do_tile() const { return base + kQBytes; }
  __device__ uint32_t k_tile(int s) const { return base + 2 * kQBytes + s * kStageBytes; }
  __device__ uint32_t v_tile(int s) const { return k_tile(s) + kTileBytes; }
  __device__ uint32_t full_bar(int s) const { return base + 2 * kQBytes + kStages * kStageBytes + 8 * s; }
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

}  // namespace dq_cfg

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, float scale, int causal) {
  using namespace dq_cfg;
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
    // Producer: one thread loads Q and dO, then keeps the K / V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const Block blk = this_block(smem_raw, Sk, H, causal);
      mbar_expect_tx(blk.q_bar(), 2 * kQBytes);
      tma_load(blk.q_tile(), &tm_q, blk.h, blk.q0, blk.b, blk.q_bar());
      tma_load(blk.do_tile(), &tm_do, blk.h, blk.q0, blk.b, blk.q_bar());
      for (int t = 0; t < blk.n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(blk.full_bar(s), kStageBytes);
        tma_load(blk.k_tile(s), &tm_k, blk.h, t * BK, blk.b, blk.full_bar(s));
        tma_load(blk.v_tile(s), &tm_v, blk.h, t * BK, blk.b, blk.full_bar(s));
      }
      for (int t = blk.n_tiles; t < blk.n_tiles + kStages; ++t)  // outlive the consumers (see the top)
        mbar_wait(blk.empty_bar(t % kStages), ((t / kStages) & 1) ^ 1);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = this_block(smem_raw, Sk, H, causal);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int row0 = blk.q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t q_rows = blk.q_tile() + wg * 64 * kRowBytes;
  const uint32_t do_rows = blk.do_tile() + wg * 64 * kRowBytes;

  float lse_r[2], delta_r[2];  // rows past Sq read 0: their dS is 0 and they are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lse_r[i] = row < Sq ? lse[int64_t(blockIdx.x) * Sq + row] : 0.f;
    delta_r[i] = row < Sq ? delta[int64_t(blockIdx.x) * Sq + row] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  mbar_wait(blk.q_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * BK;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S = Q . K^T and dP = dO . V^T over D = 64, 4 k-steps each, one group.
    float sc[64], dp[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(sc, smem_desc(q_rows + 32 * kk), smem_desc(blk.k_tile(s) + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(dp, smem_desc(do_rows + 32 * kk), smem_desc(blk.v_tile(s) + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // Scale and mask; keys past Sk get -inf, so that P is exactly 0 there
    // (TMA's zero rows would otherwise score 0).
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] *= scale;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > blk.q0 + 64 * wg);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int col = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2);
        if (col >= Sk) sc[e] = -INFINITY;
        else if (causal && col > row) sc[e] = MASK_VALUE;
      }
    }
    // dS = P * (dP - delta) with P = exp(S - lse), split into A fragments:
    // k-step kk of dS . K covers keys [16 kk, 16 kk + 16), pairs [4 kk, 4 kk + 4).
    uint32_t ds_hi[32], ds_lo[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = r % 2;
      const float d0 = expf(sc[2 * r] - lse_r[i]) * (dp[2 * r] - delta_r[i]);
      const float d1 = expf(sc[2 * r + 1] - lse_r[i]) * (dp[2 * r + 1] - delta_r[i]);
      split_bf16x2(d0, d1, ds_hi[r], ds_lo[r]);
    }

    // dQ += dS_hi . K + dS_lo . K; K is MN-major here, rows of 16 keys 2048 bytes apart.
    const uint32_t k_tile = blk.k_tile(s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs(acc, ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2], ds_hi[4 * kk + 3],
                         smem_desc(k_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_rs(acc, ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2], ds_lo[4 * kk + 3],
                         smem_desc(k_tile + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(s));  // this stage's K and V are no longer read
  }

  store_rows(dq, acc, scale, row0, col0, blk.b, blk.h, Sq, H);
}

// --- dk / dv ------------------------------------------------------------------------

namespace dkv_cfg {

constexpr int BK = 128;     // keys per block (two consumer warpgroups of 64)
constexpr int BQ = 64;      // q rows per streamed Q / dO tile
constexpr int kStages = 2;  // Q / dO ring depth
constexpr uint32_t kKBytes = BK * kRowBytes;  // 16 KB for K, as much for V
constexpr uint32_t kQBytes = BQ * kRowBytes;  // 8 KB for a Q tile, as much for dO
constexpr uint32_t kStageBytes = 2 * kQBytes;
constexpr uint32_t kStatBytes = 2 * BQ * 4;   // a Q tile's lse rows, then its delta rows
constexpr uint32_t kBarrierBytes = 8 * (2 * kStages + 1);
constexpr size_t kSmemBytes = 1024 + 2 * kKBytes + kStages * (kStageBytes + kStatBytes) + kBarrierBytes;

static_assert(BK == 64 * kConsumers, "each consumer warpgroup owns 64 keys");
static_assert(2 * BQ == 128, "the producer warpgroup's 128 threads load one lse or delta value each");

struct Block {
  uint32_t base;  // the tiles' start, 1024-byte aligned as the swizzle needs
  int b, h, k0, q_begin, n_tiles;

  __device__ uint32_t k_tile() const { return base; }
  __device__ uint32_t v_tile() const { return base + kKBytes; }
  __device__ uint32_t q_tile(int s) const { return base + 2 * kKBytes + s * kStageBytes; }
  __device__ uint32_t do_tile(int s) const { return q_tile(s) + kQBytes; }
  __device__ uint32_t stats(int s) const { return base + 2 * kKBytes + kStages * kStageBytes + s * kStatBytes; }
  __device__ uint32_t full_bar(int s) const {
    return base + 2 * kKBytes + kStages * (kStageBytes + kStatBytes) + 8 * s;
  }
  __device__ uint32_t empty_bar(int s) const { return full_bar(kStages + s); }
  __device__ uint32_t kv_bar() const { return full_bar(2 * kStages); }
};

__device__ __forceinline__ Block this_block(const uint8_t* smem, int Sq, int H, int causal) {
  Block blk;
  blk.base = (smem_u32(smem) + 1023u) & ~1023u;
  blk.b = blockIdx.x / H;
  blk.h = blockIdx.x % H;
  blk.k0 = blockIdx.y * BK;                           // ascending: the longest causal tiles first
  blk.q_begin = causal ? (blk.k0 / BQ) * BQ : 0;      // causal: q tiles that cannot see these keys skipped
  blk.n_tiles = max(0, (Sq - blk.q_begin + BQ - 1) / BQ);
  return blk;
}

}  // namespace dkv_cfg

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                          float scale, int causal) {
  using namespace dkv_cfg;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const Block blk = this_block(smem_raw, Sq, H, causal);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full_bar(s), 128);  // every producer thread: 127 after their row statistic, one with the bytes
      mbar_init(blk.empty_bar(s), 128 * kConsumers);
    }
    mbar_init(blk.kv_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == kConsumers) {
    // Producer: thread 0 loads K and V, then each stage's Q and dO tiles;
    // thread p writes the stage's lse (p < 64) or delta (p >= 64) of row p % 64.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const Block blk = this_block(smem_raw, Sq, H, causal);
    const int p = threadIdx.x - 128 * kConsumers;
    if (p == 0) {
      mbar_expect_tx(blk.kv_bar(), 2 * kKBytes);
      tma_load(blk.k_tile(), &tm_k, blk.h, blk.k0, blk.b, blk.kv_bar());
      tma_load(blk.v_tile(), &tm_v, blk.h, blk.k0, blk.b, blk.kv_bar());
    }
    const float* stat = (p < BQ ? lse : delta) + int64_t(blockIdx.x) * Sq;
    for (int t = 0; t < blk.n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = blk.q_begin + t * BQ;
      mbar_wait(blk.empty_bar(s), ((t / kStages) & 1) ^ 1);  // the first pass finds every stage free
      const int row = q0 + p % BQ;
      sts_f32(blk.stats(s) + 4 * p, row < Sq ? stat[row] : 0.f);  // rows past Sq: P is 0 there anyway
      if (p == 0) {
        mbar_expect_tx(blk.full_bar(s), kStageBytes);
        tma_load(blk.q_tile(s), &tm_q, blk.h, q0, blk.b, blk.full_bar(s));
        tma_load(blk.do_tile(s), &tm_do, blk.h, q0, blk.b, blk.full_bar(s));
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

  // Consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64); its
  // accumulators hold rows = keys, columns = q rows of the streamed tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Block blk = this_block(smem_raw, Sq, H, causal);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int key0 = blk.k0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (tid % 4);
  const uint32_t k_rows = blk.k_tile() + wg * 64 * kRowBytes;
  const uint32_t v_rows = blk.v_tile() + wg * 64 * kRowBytes;

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  mbar_wait(blk.kv_bar(), 0);
  for (int t = 0; t < blk.n_tiles; ++t) {
    const int s = t % kStages;
    const int q0 = blk.q_begin + t * BQ;
    mbar_spin(blk.full_bar(s), (t / kStages) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T over D = 64, 4 k-steps each, one group.
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(st, smem_desc(k_rows + 32 * kk), smem_desc(blk.q_tile(s) + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dpt, smem_desc(v_rows + 32 * kk), smem_desc(blk.do_tile(s) + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // Scale and mask (q before key); q rows past Sq get -inf, so that P is
    // exactly 0 there.
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= scale;
    const bool edge = q0 + BQ > Sq || (causal && q0 < blk.k0 + 64 * wg + 63);
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

    // dV += P^T_hi . dO + P^T_lo . dO and dK += dS^T_hi . Q + dS^T_lo . Q;
    // dO and Q are MN-major here, rows of 16 q positions 2048 bytes apart.
    const uint32_t q_tile = blk.q_tile(s), do_tile = blk.do_tile(s);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n64k16_rs(dv_acc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3],
                         smem_desc(do_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n64k16_rs(dv_acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3],
                         smem_desc(do_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n64k16_rs(dk_acc, ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2], ds_hi[4 * kk + 3],
                         smem_desc(q_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n64k16_rs(dk_acc, ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2], ds_lo[4 * kk + 3],
                         smem_desc(q_tile + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(blk.empty_bar(s));  // this stage's Q, dO and row statistics are no longer read
  }

  store_rows(dk, dk_acc, scale, key0, col0, blk.b, blk.h, Sk, H);
  store_rows(dv, dv_acc, 1.f, key0, col0, blk.b, blk.h, Sk, H);
}

// --- host side -------------------------------------------------------------------

// Once per kernel: the shared-memory limit and the register-split guard.
cudaError_t prepare_dq() {
  static const cudaError_t status = prepare_split(reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel),
                                                  kThreads, kProducerRegs, kConsumerRegs, kConsumers,
                                                  dq_cfg::kSmemBytes);
  return status;
}

cudaError_t prepare_dkv() {
  static const cudaError_t status = prepare_split(reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel),
                                                  kThreads, kProducerRegs, kConsumerRegs, kConsumers,
                                                  dkv_cfg::kSmemBytes);
  return status;
}

}  // namespace

namespace p2pfl {

// bf16 [B, S, H, 64] q / k / v / dout / dq, 16-byte aligned; lse and delta
// [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                     const float* lse, const float* delta, void* dq, int B, int Sq, int Sk, int H,
                                     float scale, bool causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, D, dq_cfg::BQ, dq_cfg::BK);
  if (e != cudaSuccess) return e;
  e = prepare_dq();
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + dq_cfg::BQ - 1) / dq_cfg::BQ);
  flash_bwd_dq_sm90_kernel<<<grid, kThreads, dq_cfg::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, scale,
      causal ? 1 : 0);
  return cudaGetLastError();
}

// bf16 [B, S, H, 64] q / k / v / dout / dk / dv, 16-byte aligned; lse and
// delta [B, H, Sq] f32.
cudaError_t launch_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                                      int Sk, int H, float scale, bool causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = encode_qkvo(maps, q, k, v, dout, B, Sq, Sk, H, D, dkv_cfg::BQ, dkv_cfg::BK);
  if (e != cudaSuccess) return e;
  e = prepare_dkv();
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sk + dkv_cfg::BK - 1) / dkv_cfg::BK);
  flash_bwd_dkv_sm90_kernel<<<grid, kThreads, dkv_cfg::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, scale, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace p2pfl
