// Flash-attention forward for Hopper's tensor cores (sm_90a): the bf16
// forward, with and without the per-row logsumexp.
//
// Replaces the Pallas TPU kernels of p2pfl_tpu/ops/attention.py:
//   flash_fwd_sm90<with_lse=true>   <- _flash_kernel          (pallas_call at :308)
//   flash_fwd_sm90<with_lse=false>  <- _flash_kernel_no_lse   (pallas_call at :298)
// for bf16 inputs at head size 64. The f32 forward stays the CUDA-core
// kernel of flash_attn.cu: f32 parity holds it to 1e-5 and forbids TF32.
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
// What bounds it on this card: at the slice's shapes ([8, 1024, 8, 64]
// causal; [16, 1024, 8, 64] for the forward without lse) the algorithm does
// ~254 FLOP per byte of q, k, v and out, under the H100's bf16 ridge (~295),
// so its bound is the bytes (~10 / 20 us at 3.35 TB/s). The split adds half
// again to the tensor cores' work, and the online softmax costs one expf
// and a handful of other CUDA-core instructions per score, so the kernel
// is held above that bound by its per-score arithmetic on the CUDA cores
// rather than by the tensor cores or memory.
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
//   * causal k tiles wholly in a q tile's future are skipped.
//
// The PTX wrappers, the tensor-map encoder and the launch guard are in
// sm90_common.cuh, shared with the backward pair (flash_bwd_sm90.cu).
//
// Interface: a host function called by p2pfl_flash_fwd in flash_attn.cu,
// which encodes the tensor maps on each call, launches on the given stream
// and returns a CUDA error code (cudaErrorInvalidValue if a tensor map
// cannot be encoded).

#include "sm90_common.cuh"

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

// Max / sum over the 4-lane quad that holds one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --- the kernel ----------------------------------------------------------------
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

}  // namespace p2pfl
