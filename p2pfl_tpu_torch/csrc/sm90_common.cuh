// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (the *_sm90.cu sources): mbarriers and a ring's (stage, phase) walk, TMA
// loads through 4-D tensor maps over the API's [B, S, H, D] layout in boxes
// of 64 columns (one 128-byte swizzle span; all of a row at D = 64) or, for
// the narrow kernels, of 16 or 32 columns under the 32- or 64-byte swizzle
// over the true head size, wgmma descriptors and instructions, the bf16
// split of an f32 operand, the row reductions over an accumulator's quad,
// the tensor-map encoders and the launch guard for setmaxnreg's register
// split.
//
// Everything here sits in an anonymous namespace: each source that
// includes it gets its own copy, and the compiled code is what it was when
// these lines lived inside flash_fwd_sm90.cu.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int D = 64;                          // head size of the D = 64 kernels; the columns of one TMA box
constexpr uint32_t kRowBytes = D * 2;          // one bf16 row at D = 64: the 128-byte swizzle atom
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // ops/attention.py DEFAULT_MASK_VALUE
constexpr long long kHangCycles = 1ll << 35;   // ~17 s: a barrier wait this long is a fault, not a wait

static_assert(D == 64, "a box's 64 bf16 columns must be exactly the 128-byte swizzle atom");

// --- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds means a lost arrival: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kHangCycles) __trap();
  }
}

// The same wait without the guard, for the consumers' per-tile wait: there
// the guard's clock costs registers, ptxas spills 24 bytes of loop
// invariants and the kernel runs a few percent slower
// (scripts/torch_kernel_variants.py).
__device__ __forceinline__ void mbar_spin(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a [B, S, H, D] tensor: rows [row, row + box rows) of head h,
// batch b, columns [col, col + 64) (all of a row at D = 64).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int h, int row, int b,
                                         uint32_t bar, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows under the
// 128-byte swizzle: start address, leading and stride byte offsets (both
// 1024 B, the stride between groups of 8 rows; the other one is unused at
// these widths), layout type 1 (B128). A K-major operand advances 32 bytes
// along its rows per k-step of 16; an MN-major one 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// wgmma shared-memory descriptor for a tile of SPAN-byte rows under the
// swizzle of that span (32, 64 or 128 bytes: layout types 3, 2 and 1), for
// boxes narrower than 64 columns (the *_narrow_sm90.cu sources): start
// address, leading and stride byte offsets both 8 * SPAN (the stride between
// groups of 8 rows; the leading offset is unused at these widths: a K-major
// operand's 16-column k-step and an MN-major operand's N both lie within one
// span).
// A K-major operand advances 32 bytes along its rows per k-step of 16; an
// MN-major one 16 rows (16 * SPAN bytes). At SPAN 128 it is smem_desc.
template <uint32_t SPAN>
__device__ __forceinline__ uint64_t smem_desc_span(uint32_t addr) {
  static_assert(SPAN == 32 || SPAN == 64 || SPAN == 128, "a swizzle spans 32, 64 or 128 bytes");
  constexpr uint64_t layout = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((8 * SPAN) >> 4) << 16) | (uint64_t((8 * SPAN) >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most one committed group of wgmma is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// that is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T, both operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// A second product with A from registers and B MN-major in shared memory,
// by the width N of its accumulator (N / 2 f32 a thread): m64n16k16,
// m64n32k16 or m64n64k16, the narrow kernels' products at N = W.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  wgmma_m64n16k16_rs(d, a0, a1, a2, a3, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  wgmma_m64n32k16_rs(d, a0, a1, a2, a3, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  wgmma_m64n64k16_rs(d, a0, a1, a2, a3, b);
}

// A first product (S, dP, S^T or dP^T) for one k-step, by the width of its
// accumulator: m64n64k16 (32 f32) or m64n32k16 (16 f32).
__device__ __forceinline__ void wgmma_first(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n64k16_ss(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_first(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  wgmma_m64n32k16_ss(d, a, b, scale_d);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi); x in the low half.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(x, y));
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __float22bfloat162_rn(make_float2(x - hf.x, y - hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator layout of wgmma m64nN (f32), thread t of a warpgroup, warp
// w = t / 32, lane l: element e = 4 j + 2 i + c (j < N / 8, i, c < 2) holds
// row 16 w + l / 4 + 8 i, column 8 j + 2 (l % 4) + c. Read as pairs
// (e, e + 1), the accumulator is also the A fragment of the next wgmma:
// k-step kk of 16 columns takes pairs 4 kk .. 4 kk + 3.

// Max / sum over the 4-lane quad that holds one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A float2 load and a float store in shared memory (row statistics).
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// A ring's position: its stage and the parity of the pass over it.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// --- host side -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: no -lcuda needed.
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A [B, S, H, head_dim] bf16 tensor as 4-D TMA boxes of `box_rows` rows of
// one head and 64 columns, each landing as one 128-byte-swizzled panel of
// box_rows x 128 bytes (tma_load's `col` picks the panel's columns); rows
// past S are zero-filled. At head_dim = 64 a box is a whole row.
bool encode_bshd(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int H, int box_rows,
                 int head_dim = D) {
  const cuuint64_t row_bytes = cuuint64_t(head_dim) * 2;
  const cuuint64_t dims[4] = {cuuint64_t(head_dim), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {row_bytes, cuuint64_t(H) * row_bytes, cuuint64_t(S) * H * row_bytes};
  const cuuint32_t box[4] = {D, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, S, H, head_dim] bf16 tensor as 4-D TMA boxes of `box_rows` rows of
// one head and `box_cols` columns (16, 32 or 64), each landing as one panel
// of box_rows x 2 box_cols bytes under the swizzle of that span (32, 64 or
// 128 bytes); head_dim may be below box_cols: TMA fills the columns past it
// with zeros, as it fills rows past S, so a narrow head is read at its true
// size (the *_narrow_sm90.cu sources). TMA strides in multiples of 16 bytes:
// head_dim must be a multiple of 8.
bool encode_bshd_box(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S, int H, int head_dim,
                     int box_rows, int box_cols) {
  const CUtensorMapSwizzle swizzle = box_cols == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t row_bytes = cuuint64_t(head_dim) * 2;
  const cuuint64_t dims[4] = {cuuint64_t(head_dim), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {row_bytes, cuuint64_t(H) * row_bytes, cuuint64_t(S) * H * row_bytes};
  const cuuint32_t box[4] = {cuuint32_t(box_cols), 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four tensor maps of a backward kernel: q and dO in boxes of `q_rows`
// rows, k and v in boxes of `k_rows`, 64 columns each.
cudaError_t encode_qkvo(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout, int B,
                        int Sq, int Sk, int H, int head_dim, int q_rows, int k_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const bool ok = encode_bshd(encode, &maps[0], q, B, Sq, H, q_rows, head_dim) &&
                  encode_bshd(encode, &maps[1], k, B, Sk, H, k_rows, head_dim) &&
                  encode_bshd(encode, &maps[2], v, B, Sk, H, k_rows, head_dim) &&
                  encode_bshd(encode, &maps[3], dout, B, Sq, H, q_rows, head_dim);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// Once per kernel (the caller keeps the result in a static): set the
// shared-memory limit, and refuse to launch if the compiled register count
// cannot fund setmaxnreg's split of `producer_regs` for one warpgroup and
// `consumer_regs` for each of `consumers` (the consumers would wait for
// registers forever).
cudaError_t prepare_split(const void* kern, int threads, int producer_regs, int consumer_regs, int consumers,
                          size_t smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  if (attr.numRegs * threads < producer_regs * 128 + consumer_regs * 128 * consumers)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
}

}  // namespace
