// The products of the ViT-block kernels (K1 and K4 in fused_vit_block.cu,
// K5 in fused_block_bwd_mlp.cu, K6 in fused_block_bwd_attn.cu, K8 in
// fused_vit_block_int8.cu) and of K7 (dino_head_loss.cu) on Hopper's
// wgmma + TMA (sm_90a):
//
//   C = epilogue(A @ B), f32 accumulation of bf16 operands, where
//     A (M, K) is stored row-major (K-major), or as (K, M) row-major
//       (A_MN: the activations of a weight gradient, read transposed);
//     B (K, N) is stored row-major (MN-major: the port's (in, out)
//       weights, or the activations of a weight gradient), or as (N, K)
//       row-major (B_NK: a weight read as its transpose in the backward);
//   or s32 accumulation of int8 operands (K8's W8A8 products), both
//     K-major, as 8-bit wgmma requires: A (M, K) the quantized
//     activations, B stored (N, K), the quantized weights as K8 writes them.
//
// They replace the products inside the TPU kernels of
// sais_tpu/kernels/fused_mha.py: _block_kernel (K1) and
// _block_fwd_train_kernel (K4): qkv, proj, fc1, fc2; _mlp_bwd_kernel (K5):
// the fc1 recompute, dh, dy, dW2, dW1; _attn_bwd_kernel and _attn_bwd_tail
// (K6): the qkv recompute, dctx, dy, dWproj, dWqkv; _block_kernel_int8
// (K8): qkv, proj, fc1, fc2 in int8; and of
// sais_tpu/kernels/dino_head_loss.py: _stats_kernel and _grad_kernel (K7):
// the student and teacher logits, dw and dh_s.
//
// Bound: at K = 384 a product is close to the card's ridge (768 flops per
// 2-byte output), so its epilogue traffic matters nearly as much as its
// tensor-core rate; a weight gradient (K = B*L rows, a 384 x 1536 output)
// is far above it.  An mma.sync GEMM ran them at about 190 TFLOP/s (240
// TOP/s in int8): mma.sync cannot reach the card's full rate, and its
// ldmatrix / cp.async traffic runs on the SM's threads.  This design:
//
// - one 128 x 192 output tile a block (grid (N / 192, M / 128, splits);
//   K7's modes (M / 128, N / 192), so that the blocks of a column tile run
//   together); 192 columns cover N = 384 in two tiles and divide 1152 and
//   1536;
// - TMA 2-D tensor maps with a 128-byte swizzle carry A and B into a
//   4-stage ring of 40 KB stages: a stage holds 128 bytes of K (64 bf16 or
//   128 int8): A as one 128-row box (K-major) or two 64 x 64 boxes (A_MN),
//   B as three 64 x 64 boxes (MN-major) or one 192-row box (B_NK); one full
//   and one empty mbarrier a stage; what lies past M, N or K arrives as
//   zeros; the first stages are requested before the block's first barrier;
// - warpgroup 0 is the producer: one thread issues the loads, then the
//   residual or saved-h tile (EPI_RESIDUAL, EPI_DGELU, EPI_I8_RESID) into
//   the C tile; setmaxnreg gives the group's registers to the consumers;
// - warpgroups 1 and 2 consume 64 rows each with wgmma.mma_async
//   m64n192k16 (bf16 in, f32 accumulators) or m64n192k32 (s8 in, s32
//   accumulators) in registers, each bf16 operand's major-ness set by the
//   instruction's transpose bits (no copy of any operand); one wgmma group
//   stays in flight, and a stage is released when the group that read it
//   has completed;
// - a weight gradient splits K over blockIdx.z into about one block an SM
//   (wgrad_splits); each split writes its own f32 partial, which the caller
//   sums in split order: no atomics, no read-modify-write across blocks,
//   results independent of block order;
// - the epilogue reads the accumulators in wgmma's fragment layout, keeps
//   the JAX kernels' rounding points, and either writes a 48 KB bf16 C
//   tile in shared memory that a TMA store copies out (TMA clips rows >= M,
//   boxes past N are neither loaded nor stored), or writes f32 straight
//   from the accumulators (EPI_F32: a 128 x 192 f32 tile, 96 KB, does not
//   fit beside the ring; each warp's store covers whole 32-byte sectors).
//   EPI_GELU_SAVE has two bf16 outputs: each consumer stores h through its
//   half of the C tile, waits until the TMA has read it
//   (cp.async.bulk.wait_group.read), then writes and stores g through the
//   same half; the ring keeps its four stages.  The int8 epilogues
//   dequantize first: v = f32(acc) * row scale * column scale + bias, in
//   f32 (int32 to f32 rounded to nearest: at K = 1536 |acc| can pass 2^24).
//   K7's EPI_STATS and EPI_DL keep each row's softmax statistics, the
//   teacher's logits and column sums, and dl, per tile (below).
// - EPI_I8_MLP (K8's MLP, fc1 -> GELU -> per-row int8 -> fc2) is the one
//   mode with another schedule (mlp_i8 below, a 256-thread kernel): h
//   never reaches device memory.
//
// With one block an SM and one tile a block, each tile pays in full the
// latency of its first loads, its epilogue and its store; at K = 384 that
// is as long as its products (PERF.md).  Later work: a persistent
// scheduler so that one tile's epilogue overlaps the next tile's loads and
// products, LayerNorm in the prologue, and the LayerNorm backward in the
// epilogue of K5's and K6's dy.

#pragma once

#include <cuda.h>

#include <initializer_list>
#include <type_traits>

#include "vit_block_common.cuh"

namespace {

// Epilogues (per element, on the accumulator acc):
//   EPI_BIAS      C = bf16(bf16(acc) + bias)
//   EPI_GELU      C = bf16(gelu(bf16(bf16(acc) + bias)))
//   EPI_RESIDUAL  v = bf16(bf16(acc) + bias) [v = bf16(v * row_scale[row])];
//                 C = bf16(residual + v)
//   EPI_NONE      C = bf16(acc)
//   EPI_GELU_SAVE h = bf16(bf16(acc) + bias); C = h; C2 = bf16(gelu(h))
//   EPI_DGELU     C = bf16(acc * gelu'(aux)), aux the saved h (C may be
//                 aux); optionally each 64-row half's column sums of C
//   EPI_F32       C (f32) = acc, split z at offset z * M * N
// int8 operands, v = f32(acc) * a_scale[row] * b_scale[col] + bias[col]:
//   EPI_I8_BF16   C = bf16(v)
//   EPI_I8_RESID  C = bf16(residual + bf16(v))
//   EPI_I8_MLP    K8's MLP (mlp_i8): C = bf16(residual + bf16(fc2(quant(
//                 gelu(fc1)))))
// K7 (bf16 operands, f32 x = acc * scale, the teacher's x = (acc -
// center[col]) / temp):
//   EPI_STATS     each row's (max, sum exp(x - max)) over the tile; the
//                 teacher also stores acc (tl, f32) and each 64-row half's
//                 column sums of it
//   EPI_DL        C = bf16((c p - qbar) dl_scale), p = exp(x - lse[row]),
//                 qbar = the row's paired q rows summed in order; each
//                 64-row half's sum of -qbar x
enum Epilogue {
  EPI_BIAS = 0,
  EPI_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_NONE = 3,
  EPI_GELU_SAVE = 4,
  EPI_DGELU = 5,
  EPI_F32 = 6,
  EPI_I8_BF16 = 7,
  EPI_I8_RESID = 8,
  EPI_I8_MLP = 9,
  EPI_STATS = 10,
  EPI_DL = 11
};

// K8's quantizers (JAX quantize_weight / _quant_rows): scale =
// max(amax, 1e-8) * (1/127), q = clip(rint(y / scale), -127, 127).
constexpr float kInv127 = 1.0f / 127.0f;   // the f32 constant JAX multiplies by

// clip(rint(y / s), -127, 127) for a scale s and r = RN(1 / s), computed
// once for a row's or a column's values: the quotient by Markstein's
// correction, q0 = RN(y r), q = RN(q0 + RN(y - q0 s) r) (two FMAs; y - q0 s
// is exact), which is y / s rounded to nearest whenever it is a normal
// number (smaller ones round to 0 either way): the division's bits at a
// third of its instructions (rint: half to even).
__device__ __forceinline__ int8_t quant_one(float y, float s, float r) {
  const float q0 = __fmul_rn(y, r);
  const int q = __float2int_rn(__fmaf_rn(__fmaf_rn(-q0, s, y), r, q0));
  return (int8_t)max(-127, min(127, q));
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
}

// f32(acc) * row scale * column scale + bias, in JAX _int8_mm's order.
__device__ __forceinline__ float dequant(int acc, float rs, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), ws), b);
}

// K8's tanh GELU of an f32 value, every operation rounded on its own (no
// contraction), so that every copy of it gives the same bits: K8's MLP
// computes h twice and relies on that.  |gelu_i8(v)| <= |v|: the factor
// 0.5 (1 + tanh) rounds into [0, 1].
__device__ __forceinline__ float gelu_i8(float v) {
  const float u = __fmul_rn(
      0.7978845608028654f,
      __fadd_rn(v, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(v, v), v))));
  const float th = tanhf(u);
  return __fmul_rn(v, __fmul_rn(0.5f, __fadd_rn(1.f, th)));
}

namespace sm90 {

constexpr int BM = 128, BN = 192, BK = 64, STAGES = 4;
constexpr int BK8 = 128;                    // int8 k a stage: 128 bytes too
constexpr int THREADS = 384;                // producer + 2 consumer warpgroups
constexpr int BOX = 64;                     // 64 bf16: the 128-byte swizzle span
constexpr int A_BYTES = BM * BK * 2;        // the A tile, 16 KB
constexpr int B_BOX_BYTES = BK * BOX * 2;   // a 64 x 64 box, 8 KB
constexpr int STAGE_BYTES = A_BYTES + BN / BOX * B_BOX_BYTES;
constexpr int C_BYTES = BM * BN * 2;        // the C tile, 48 KB
// the ring, the C tile, and slack to align both to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + C_BYTES + 1024;
// blocks a weight gradient's splits aim at: the H100 SXM's SM count (a
// constant, so that the split, and with it every bit of the result, does
// not depend on the card)
constexpr int WAVE = 132;

// EPI_I8_MLP: 64 rows a block; fc1 in slices of 256 hidden columns (128
// a consumer); each consumer owns 192 of the block's 384 output columns;
// each consumer has its own 3-stage ring of 24 KB stages (its 128 rows of
// an fc1 k tile, 16 KB, or its 192 rows of an fc2 k tile); the tile's LN2
// rows (64 x D int8) and two buffers of one slice of int8 h (64 x 256)
// stay in shared memory.
constexpr int MLP_BM = 64, MLP_SLICE = 256, MLP_NC = 192, MLP_STAGES = 3;
constexpr int MLP_THREADS = 256;   // two consumer warpgroups (mlp_i8)
constexpr int CHUNK8 = MLP_BM * BK8;               // 64 rows x 128 bytes
constexpr int MLP_STAGE_BYTES = MLP_NC * BK8;   // 24 KB
constexpr int MLP_MAX_D = 768;

inline int mlp_smem(int D) {
  return 2 * MLP_STAGES * MLP_STAGE_BYTES + (D / BK8) * CHUNK8 +
         4 * CHUNK8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `bar` with this parity.  A wait of more than
// about ten seconds (a lost TMA completion) traps instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Box (c0, c1) of a 2-D tensor map (c0 along the contiguous dimension)
// into shared memory; completion is counted on `bar` in bytes (a box that
// reaches past the tensor counts in full: TMA fills the rest with zeros).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (all >> 4), layout 128B.
//   K-major (A, or B_NK, and both int8 operands): rows of 128 bytes of k
//     (64 bf16 or 128 int8), 8-row groups 1024 bytes apart (stride
//     offset); the leading offset is unused.  A k16 (bf16) or k32 (int8)
//     step adds 32 bytes to the start address.
//   MN-major (B, or A_MN): rows of 64 m or n per k, 8-k groups 1024 bytes
//     apart (stride offset), 64-column boxes B_BOX_BYTES apart (leading
//     offset).  A k16 step adds 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int kk) {
  return MN ? smem_desc(tile + kk * 16 * 128, B_BOX_BYTES, 1024)
            : smem_desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers while wgmma owns
// them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 16) @ B (16 x 192), both from shared memory; TA, TB the
// transpose bits (1: the operand is MN-major).  Fragment: register
// 4j + 2h + e of thread t holds row 16 (t / 32) + (t % 32) / 4 + 8h,
// column 8j + 2 (t % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A (64 x 32) @ B (32 x N), s8 operands, both K-major from shared
// memory (8-bit wgmma has no transpose bits), s32 accumulators in the
// fragment layout of wgmma_192 (N = 192: 96 registers; N = 128: 64).
__device__ __forceinline__ void wgmma_s8_192(int (&d)[96], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

struct GemmArgs {
  const bf16* bias;        // (N,): the epilogues that add a bias
  const bf16* row_scale;   // (M,) or null: EPI_RESIDUAL
  float* out32;            // EPI_F32: (splits, M, N); EPI_STATS: tl (M, N)
  float* colsum;           // EPI_DGELU or EPI_STATS, or null: (ceil(M / 64), N)
  int M, N, K;
  int kt_split;            // k tiles a split (blockIdx.z)
  // int8 modes: per-row scales of A (M,) and per-column scales of B (N,)
  const float* a_scale;
  const float* b_scale;
  // EPI_I8_MLP: fc1 is (M, K = D) x (D, H) with b_scale and bias; fc2
  // (M, H) x (H, N = D) with b2_scale and bias2; resid (M, N) bf16
  const float* b2_scale;
  const bf16* bias2;
  const bf16* resid;
  int H;
  // K7 (EPI_STATS, EPI_DL): the student's scale (1 / temp_s), or, with a
  // center, the teacher's temperature read on the device
  float scale;
  const float* temp;
  const float* center;     // (N,) or null
  float* m_part;           // (M, tiles): row max of the tile
  float* l_part;           // (M, tiles): row sum of exp(x - max)
  const float* lse;        // (M,): EPI_DL
  const float* c;          // (M,): pair counts
  const int* pair_n;       // (M,): the teacher rows each row pairs with,
  const int* pair_t;       //   ascending, pair_stride apart
  const float* pair_w;
  int pair_stride;
  const float* q;          // (teacher rows, N) f32
  float dl_scale;
  float* loss_part;        // (ceil(M / 64), tiles)
};

static_assert(BN == 192, "wgmma_192 is the consumers' instruction");
static_assert(BK / 16 == BK8 / 32, "four wgmma k steps a stage");

// K8's MLP (EPI_I8_MLP) for 64 rows of LN2(x1) quantized (A, K = D) and
// 384 output columns (n0 = 384 blockIdx.x):
//
//   h   = gelu(f32(A @ W1^T) * a_scale * w1_scale + b1)       (64, H) f32
//   out = x1 + bf16(f32(quant(h) @ W2^T) * h_scale * w2_scale + b2)
//
// h is quantized per row from f32, so each row's max |h| over all H
// columns is needed before any of it is quantized, and no tile holds a
// row's H columns.  Two designs keep h out of device memory: a cluster of
// blocks over H that exchanges the row maxima and then reduces fc2's int32
// partials through distributed shared memory (about 168 KB of remote reads
// a block for a 128 x 384 output, more than its products take), or one
// block that computes fc1 twice.  This is the second:
//
//   pass 1: fc1 slice by slice (256 columns, 128 a consumer); only each
//           row's max |h| is kept;
//   pass 2: fc1 again, h quantized with the final scale into one of two
//           int8 slice buffers, then fc2's k slice from it: acc2 += h_q @
//           W2[:, slice]^T.
//
// The int32 products are exact and dequantize + GELU run the same code in
// both passes, so pass 2's h equals pass 1's bit for bit and the scale is
// exactly _quant_rows' one.  Pass 1 evaluates GELU only where it can matter:
// |gelu(v)| <= |v| (gelu_i8), so once the running max A is known, a value
// with |v| <= A cannot raise it; each slice first takes the GELU of its
// row maximum (v over the row's 256 columns), then of each value with
// |v| > A.  The result is the exact max, the same as over all columns.
// Cost: fc1 twice (+59.5 G int8 operations at (256, 197)), and W1 read
// twice and W2 once from L2 per 64 rows (1.7 MB).
//
// Two consumer warpgroups and no producer: a block of 256 threads may hold
// 255 registers a thread (fc1's 64 accumulators beside fc2's 96), where a
// block with a producer warpgroup holds 168 (setmaxnreg does not raise
// what ptxas allocates).  Each consumer streams its own halves of the
// weight tiles, in consumption order (pass 1's fc1 k tiles, then per
// slice fc1's and fc2's), through its own ring: one of its threads issues
// a stage's load again as soon as the wgmma group that read it has
// completed, so neither consumer waits for the other outside the slice
// barriers.
// The output goes through a C tile over the ring (both consumers done with
// it) and a TMA store.
__device__ __forceinline__ void mlp_i8(const CUtensorMap& map_a,
                                       const CUtensorMap& map_w1,
                                       const CUtensorMap& map_c,
                                       const CUtensorMap& map_w2,
                                       const GemmArgs& p, uint64_t* full,
                                       uint64_t* a_full,
                                       unsigned char* smem_raw) {
  __shared__ float rmax[2][MLP_BM];
  const int D = p.K, kt1 = D / BK8, slices = p.H / MLP_SLICE;
  const int m0 = blockIdx.y * MLP_BM, n0 = blockIdx.x * 2 * MLP_NC;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t a_tile = ring + 2 * MLP_STAGES * MLP_STAGE_BYTES;
  const uint32_t hq = a_tile + kt1 * CHUNK8;   // [buffer][chunk]: 4 chunks
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * MLP_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init(smem_u32(a_full), 1);
    // the initialized barriers must be visible to the TMA (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(smem_u32(a_full), kt1 * CHUNK8);
    for (int t = 0; t < kt1; ++t)
      tma_load(a_tile + t * CHUNK8, &map_a, t * BK8, m0, smem_u32(a_full));
  }
  __syncthreads();

  const int c = threadIdx.x / 128;   // fc1 columns 128 c, fc2 columns 192 c
  const int t = threadIdx.x % 128, q4 = t % 4;
  const int rl = (t / 32) * 16 + (t % 32) / 4;   // rows rl and rl + 8
  // this consumer's ring: its halves of the stages in consumption order,
  // pass 1's fc1 k tiles, then per slice fc1's k tiles and fc2's two
  const uint32_t my_ring = ring + c * MLP_STAGES * MLP_STAGE_BYTES;
  uint64_t* my_full = full + c * MLP_STAGES;
  const int loads = slices * kt1 + slices * (kt1 + MLP_SLICE / BK8);
  auto issue = [&](int seq) {   // stage seq % MLP_STAGES is free
    const int s = seq % MLP_STAGES;
    const uint32_t dst = my_ring + s * MLP_STAGE_BYTES;
    const uint32_t bar = smem_u32(&my_full[s]);
    int j = seq / kt1, kt = seq % kt1;
    if (seq >= slices * kt1) {
      const int r = seq - slices * kt1, per = kt1 + MLP_SLICE / BK8;
      j = r / per;
      kt = r % per;
    }
    if (kt < kt1) {   // this consumer's 128 rows of W1's k tile
      mbar_expect_tx(bar, MLP_SLICE / 2 * BK8);
      tma_load(dst, &map_w1, kt * BK8, j * MLP_SLICE + c * MLP_SLICE / 2,
               bar);
    } else {          // its 192 rows of W2's
      mbar_expect_tx(bar, MLP_NC * BK8);
      tma_load(dst, &map_w2, j * MLP_SLICE + (kt - kt1) * BK8,
               n0 + c * MLP_NC, bar);
    }
  };
  if (t == 0)
    for (int s = 0; s < MLP_STAGES && s < loads; ++s) issue(s);
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + rl + 8 * h;
    rs[h] = row < p.M ? p.a_scale[row] : 0.f;
  }
  int acc1[64], acc2[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc2[i] = 0;
  fence_acc(acc2);
  float amax[2] = {0.f, 0.f}, hscale[2] = {1.f, 1.f}, hrcp[2] = {1.f, 1.f};
  int seq = 0;
  // the wgmma group that read stage use `r` has completed: refill the
  // stage with load r + MLP_STAGES (only this consumer reads its ring)
  auto release = [&](int r) {
    if (t == 0 && r + MLP_STAGES < loads) issue(r + MLP_STAGES);
  };
  mbar_wait(smem_u32(a_full), 0);

  for (int pass = 0; pass < 2; ++pass) {
    for (int j = 0; j < slices; ++j) {
      // fc1: this consumer's 128 columns of slice j
#pragma unroll
      for (int i = 0; i < 64; ++i) acc1[i] = 0;
      fence_acc(acc1);
      int prev = -1;
      for (int kt = 0; kt < kt1; ++kt) {
        const int s = seq % MLP_STAGES;
        mbar_wait(smem_u32(&my_full[s]), (seq / MLP_STAGES) & 1);
        const uint32_t sa = a_tile + kt * CHUNK8;
        const uint32_t sb = my_ring + s * MLP_STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_128(acc1, operand_desc<false>(sa, kk),
                       operand_desc<false>(sb, kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = seq;
        ++seq;
      }
      wgmma_wait<0>();
      fence_acc(acc1);
      release(prev);
      // v = dequantized fc1, in place (f32 bits)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = j * MLP_SLICE + c * (MLP_SLICE / 2) + 8 * jj + 2 * q4;
        const float2 ws = *reinterpret_cast<const float2*>(p.b_scale + col);
        const __nv_bfloat162 b =
            *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc1[4 * jj + 2 * h] = __float_as_int(
              dequant(acc1[4 * jj + 2 * h], rs[h], ws.x, __low2float(b)));
          acc1[4 * jj + 2 * h + 1] = __float_as_int(
              dequant(acc1[4 * jj + 2 * h + 1], rs[h], ws.y, __high2float(b)));
        }
      }

      if (pass == 0) {   // the running max |h| of rows rl, rl + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float vmax = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              vmax = fmaxf(vmax, __int_as_float(acc1[4 * jj + 2 * h + e]));
          vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 1));
          vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 2));
          amax[h] = fmaxf(amax[h], fabsf(gelu_i8(vmax)));
          uint32_t pending = 0;   // values that may still raise the max
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (fabsf(__int_as_float(acc1[4 * (i / 2) + 2 * h + i % 2])) >
                amax[h])
              pending |= 1u << i;
          while (pending != 0) {
            const int pick = __ffs(pending) - 1;
            pending &= pending - 1;
            float v = 0.f;
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if (i == pick)
                v = __int_as_float(acc1[4 * (i / 2) + 2 * h + i % 2]);
            if (fabsf(v) > amax[h]) amax[h] = fmaxf(amax[h], fabsf(gelu_i8(v)));
          }
        }
        continue;
      }

      // pass 2: h quantized into buffer j % 2, chunk c (64 rows x 128
      // bytes in the 128-byte swizzle of a K-major wgmma operand)
      unsigned char* chunk =
          ring_ptr + (hq - ring) + ((j % 2) * 2 + c) * CHUNK8;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const int8_t lo = quant_one(
              gelu_i8(__int_as_float(acc1[4 * jj + 2 * h])), hscale[h],
              hrcp[h]);
          const int8_t hi = quant_one(
              gelu_i8(__int_as_float(acc1[4 * jj + 2 * h + 1])), hscale[h],
              hrcp[h]);
          *reinterpret_cast<uint16_t*>(
              chunk + r * BK8 + (((jj / 2) ^ (r % 8)) * 16) + 8 * (jj % 2) +
              2 * q4) = (uint16_t)(uint8_t)lo | (uint16_t)(uint8_t)hi << 8;
        }
      // the generic-proxy writes must be visible to wgmma (async proxy),
      // and both consumers' chunks written, before fc2 reads them
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 3, 256;" ::: "memory");
      prev = -1;
      for (int kt = 0; kt < MLP_SLICE / BK8; ++kt) {
        const int s = seq % MLP_STAGES;
        mbar_wait(smem_u32(&my_full[s]), (seq / MLP_STAGES) & 1);
        const uint32_t sa = hq + ((j % 2) * 2 + kt) * CHUNK8;
        const uint32_t sb = my_ring + s * MLP_STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_192(acc2, operand_desc<false>(sa, kk),
                       operand_desc<false>(sb, kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = seq;
        ++seq;
      }
      // done before this buffer is written again (slice j + 2): the other
      // consumer finishes its fc2 of slice j before the barrier of j + 1
      wgmma_wait<0>();
      fence_acc(acc2);
      release(prev);
    }
    if (pass == 0) {   // each row's max over both consumers' columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
        amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
        if (q4 == 0) rmax[c][rl + 8 * h] = amax[h];
      }
      asm volatile("bar.sync 3, 256;" ::: "memory");
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hscale[h] =
            quant_scale(fmaxf(rmax[0][rl + 8 * h], rmax[1][rl + 8 * h]));
        hrcp[h] = __frcp_rn(hscale[h]);
      }
    }
  }

  // out = x1 + bf16(fc2), through a C tile over the ring: both consumers
  // must be done reading it
  asm volatile("bar.sync 3, 256;" ::: "memory");
  unsigned char* half = ring_ptr + c * (MLP_NC / BOX) * B_BOX_BYTES;
  const uint32_t half_u32 = ring + c * (MLP_NC / BOX) * B_BOX_BYTES;
#pragma unroll
  for (int j = 0; j < MLP_NC / 8; ++j) {
    const int col = n0 + c * MLP_NC + 8 * j + 2 * q4;
    const float2 ws = *reinterpret_cast<const float2*>(p.b2_scale + col);
    const __nv_bfloat162 b =
        *reinterpret_cast<const __nv_bfloat162*>(p.bias2 + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h, row = m0 + r;
      __nv_bfloat162 x1 = __floats2bfloat162_rn(0.f, 0.f);
      if (row < p.M)
        x1 = *reinterpret_cast<const __nv_bfloat162*>(
            p.resid + (size_t)row * p.N + col);
      const float v0 = dequant(acc2[4 * j + 2 * h], hscale[h], ws.x,
                               __low2float(b));
      const float v1 = dequant(acc2[4 * j + 2 * h + 1], hscale[h], ws.y,
                               __high2float(b));
      *reinterpret_cast<__nv_bfloat162*>(
          half + (j / 8) * B_BOX_BYTES + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
          4 * q4) = __floats2bfloat162_rn(__low2float(x1) + bf16_round(v0),
                                          __high2float(x1) + bf16_round(v1));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  if (t == 0) {
    for (int b = 0; b < MLP_NC / BOX; ++b)
      tma_store(&map_c, half_u32 + b * B_BOX_BYTES,
                n0 + c * MLP_NC + b * BOX, m0);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// K7's EPI_STATS on a consumer's accumulators (rows rl, rl + 8 of its 64;
// red: 4 x BN floats of scratch): the teacher's tl stored in f32 and the
// half's column sums of it (rows past M hold zeros: TMA filled A with
// them), then each row's (max, sum exp(x - max)) over the tile's valid
// columns, summed in column order and across the quad in a fixed order.
__device__ __forceinline__ void stats_epilogue(float (&acc)[BN / 2],
                                               const GemmArgs& p, int m0,
                                               int n0, int boxes, int c,
                                               int t, int rl, float* red) {
  const int tiles = (p.N + BN - 1) / BN, tile = n0 / BN;
  m0 += 64 * c;
  const int q4 = t % 4;
  if (p.center != nullptr) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j / 8 >= boxes) continue;
      const int col = n0 + 8 * j + 2 * q4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        if (row < p.M)
          *reinterpret_cast<float2*>(p.out32 + (size_t)row * p.N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // over the warp's 16 rows
        float s = acc[4 * j + e] + acc[4 * j + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (t % 32 < 4) red[(t / 32) * BN + 8 * j + 2 * q4 + e] = s;
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    for (int col = t; col < boxes * BOX; col += 128)
      p.colsum[(size_t)(m0 / 64) * p.N + n0 + col] =
          ((red[col] + red[BN + col]) + red[2 * BN + col]) + red[3 * BN + col];
    const float inv_tt = __fdiv_rn(1.f, *p.temp);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j / 8 >= boxes) continue;
      const int col = n0 + 8 * j + 2 * q4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[4 * j + i] = __fmul_rn(
            __fsub_rn(acc[4 * j + i], p.center[col + i % 2]), inv_tt);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = __fmul_rn(acc[i], p.scale);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (j / 8 < boxes)
        m = fmaxf(m, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (j / 8 < boxes)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          l = __fadd_rn(l, expf(__fsub_rn(acc[4 * j + 2 * h + e], m)));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
    const int row = m0 + rl + 8 * h;
    if (q4 == 0 && row < p.M) {
      p.m_part[(size_t)row * tiles + tile] = m;
      p.l_part[(size_t)row * tiles + tile] = l;
    }
  }
}

// K7's EPI_DL for a thread's two rows: p = exp(x - lse), qbar = the row's
// paired q rows summed in ascending order, dl = bf16((c p - qbar)
// dl_scale) (rounded at the store), and the loss term -qbar x.  The q rows
// the block's rows pair with are gathered from shared memory: once the
// products are done, the block copies the tile's columns of the teacher
// rows its rows pair with (a range [t0, t1], at most QS_ROWS of them, e.g.
// all 128 for the pretrain step's global crops, 32 for a tile of local
// crops) into the ring with whole-row loads; a gather straight from
// device memory, 8 rows' 32-byte pieces a warp load, took 2.4x the whole
// GEMM.  A wider range is gathered from device memory.
constexpr int QS = BN + 8;   // staged q row stride (floats): 2-way banks
constexpr int QS_ROWS = STAGES * STAGE_BYTES / (QS * 4);
struct DlRows {
  int row[2], n[2], M;
  float lse[2], cr[2];
  const int* pt[2];
  const float* pw[2];

  __device__ __forceinline__ void load(const GemmArgs& p, int r0) {
    M = p.M;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r0 + 8 * h;
      n[h] = 0;
      if (row[h] < M) {
        n[h] = p.pair_n[row[h]];
        lse[h] = p.lse[row[h]];
        cr[h] = p.c[row[h]];
        pt[h] = p.pair_t + (size_t)row[h] * p.pair_stride;
        pw[h] = p.pair_w + (size_t)row[h] * p.pair_stride;
      }
    }
  }

  // qbar of this thread's columns of row h (48: 8j + 2 (t % 4) + e of
  // the tile at n0), from the block's staged q rows (rows t0.. at a stride
  // of QS floats) or, with staged null, from device memory
  __device__ __forceinline__ void qbar(const GemmArgs& p, int h, int n0,
                                       int q4, int boxes, const float* staged,
                                       int t0, float (&qb)[BN / 4]) const {
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) qb[i] = 0.f;
    for (int i = 0; i < n[h]; ++i) {
      const float w = pw[h][i];
      const float* qrow =
          staged != nullptr ? staged + (pt[h][i] - t0) * QS + 2 * q4
                            : p.q + (size_t)pt[h][i] * p.N + n0 + 2 * q4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j / 8 >= boxes) continue;
        const float2 v = *reinterpret_cast<const float2*>(qrow + 8 * j);
        qb[2 * j] = __fadd_rn(qb[2 * j], __fmul_rn(w, v.x));
        qb[2 * j + 1] = __fadd_rn(qb[2 * j + 1], __fmul_rn(w, v.y));
      }
    }
  }

  // dl of one value of row h (x = acc scale) into d; returns -qbar x
  __device__ __forceinline__ float dl(const GemmArgs& p, int h, float a,
                                      float qb, float& d) const {
    const float x = __fmul_rn(a, p.scale);
    const float pr = expf(__fsub_rn(x, lse[h]));
    d = __fmul_rn(__fsub_rn(__fmul_rn(cr[h], pr), qb), p.dl_scale);
    return __fmul_rn(-qb, x);
  }
};

// One tile of the standard schedule (every mode but EPI_I8_MLP).
template <int EPI, bool A_MN, bool B_NK>
__device__ __forceinline__ void gemm_tile(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const CUtensorMap& map_c, const CUtensorMap& map_r,
    const CUtensorMap& map_c2, const GemmArgs& p,
    uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES],
    uint64_t& res_full, unsigned char* sm90_smem) {
  constexpr bool I8 = EPI == EPI_I8_BF16 || EPI == EPI_I8_RESID;
  constexpr int KT = I8 ? BK8 : BK;   // k elements a stage
  constexpr bool AUX =
      EPI == EPI_RESIDUAL || EPI == EPI_DGELU || EPI == EPI_I8_RESID;
  constexpr bool BIAS = EPI == EPI_BIAS || EPI == EPI_GELU ||
                        EPI == EPI_RESIDUAL || EPI == EPI_GELU_SAVE;
  using Acc = typename std::conditional<I8, int, float>::type;
  // K7's modes: grid (M tiles, N tiles), so that the blocks of one column
  // tile run together and its w and q columns stay in L2
  constexpr bool M_FASTEST = EPI == EPI_STATS || EPI == EPI_DL;
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(sm90_smem) + 1023) & ~1023u;
  unsigned char* ring_ptr = sm90_smem + (ring - smem_u32(sm90_smem));
  const uint32_t ctile = ring + STAGES * STAGE_BYTES;
  const int m0 = (M_FASTEST ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (M_FASTEST ? blockIdx.y : blockIdx.x) * BN;
  const int kt0 = blockIdx.z * p.kt_split;   // this split's first k tile
  const int ktiles = min((p.K + KT - 1) / KT - kt0, p.kt_split);
  // whole 64-column boxes inside N (N is a multiple of 64); the columns of
  // a skipped box are computed from stale shared memory (MN-major B) or
  // zeros (B_NK) and never stored
  const int boxes = min(BN, p.N - n0) / BOX;
  const int wg = threadIdx.x / 128;

  const uint32_t stage_bytes =
      A_BYTES + (B_NK ? BN / BOX : boxes) * B_BOX_BYTES;
  // this split's k tile i into stage i % STAGES
  auto load_stage = [&](int i) {
    const uint32_t bar = smem_u32(&full[i % STAGES]);
    const uint32_t sa = ring + (i % STAGES) * STAGE_BYTES, sb = sa + A_BYTES;
    const int k = (kt0 + i) * KT;
    mbar_expect_tx(bar, stage_bytes);
    if (A_MN) {
      tma_load(sa, &map_a, m0, k, bar);
      tma_load(sa + A_BYTES / 2, &map_a, m0 + 64, k, bar);
    } else {
      tma_load(sa, &map_a, k, m0, bar);
    }
    if (B_NK) {
      tma_load(sb, &map_b, k, n0, bar);
    } else {
      for (int j = 0; j < boxes; ++j)
        tma_load(sb + j * B_BOX_BYTES, &map_b, n0 + j * BOX, k, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);    // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 2);   // one arrival per consumer
    }
    mbar_init(smem_u32(&res_full), 1);
    // the initialized barriers must be visible to the TMA (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // the first stages are empty: fill them before the block syncs
    for (int i = 0; i < min(ktiles, STAGES); ++i) load_stage(i);
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int i = STAGES; i < ktiles; ++i) {
        // stage i % STAGES is free once both consumers released tile
        // i - STAGES
        mbar_wait(smem_u32(&empty[i % STAGES]), (i / STAGES - 1) & 1);
        load_stage(i);
      }
      if (AUX) {   // the residual or saved-h tile, behind the products
        const int halves = p.M - m0 > 64 ? 2 : 1;
        const uint32_t bar = smem_u32(&res_full);
        mbar_expect_tx(bar, halves * boxes * B_BOX_BYTES);
        for (int h = 0; h < halves; ++h)
          for (int j = 0; j < boxes; ++j)
            tma_load(ctile + (h * BN / BOX + j) * B_BOX_BYTES, &map_r,
                     n0 + j * BOX, m0 + 64 * h, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;   // this consumer's rows: m0 + 64 c ... + 63
  const int t = threadIdx.x % 128;
  const int rl = (t / 32) * 16 + (t % 32) / 4;   // rows rl and rl + 8
  // epilogue operands, read while the products run
  uint32_t bias2[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (t % 4);
    bias2[j] = BIAS && col < p.N
                   ? *reinterpret_cast<const uint32_t*>(p.bias + col)
                   : 0u;
  }
  float scale[2] = {1.f, 1.f};   // EPI_RESIDUAL's row scale, int8's a_scale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 64 * c + rl + 8 * h;
    if (EPI == EPI_RESIDUAL && p.row_scale != nullptr && row < p.M)
      scale[h] = __bfloat162float(p.row_scale[row]);
    if (I8 && row < p.M) scale[h] = p.a_scale[row];
  }

  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int i = 0; i < ktiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
    // consumer c's 64 rows of A lie 8 KB into the stage in both layouts
    const uint32_t sa = ring + s * STAGE_BYTES + c * (A_BYTES / 2);
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // k16 (bf16) or k32 (int8) steps
      if constexpr (I8)
        wgmma_s8_192(acc, operand_desc<false>(sa, kk),
                     operand_desc<false>(sb, kk));
      else
        wgmma_192<A_MN, !B_NK>(acc, operand_desc<A_MN>(sa, kk),
                               operand_desc<!B_NK>(sb, kk));
    }
    wgmma_commit();
    if (i > 0) {   // the group of tile i - 1 has completed: free its stage
      wgmma_wait<1>();
      if (t == 0) mbar_arrive(smem_u32(&empty[(i - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // every row of this half is past M (EPI_DL's halves both take part in
  // its block-wide staging)
  if (m0 + 64 * c >= p.M && EPI != EPI_DL) return;

  if constexpr (EPI == EPI_F32) {   // f32 straight from the accumulators
    float* out = p.out32 + (size_t)blockIdx.z * p.M * p.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (t % 4);
      if (j / 8 >= boxes) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * c + rl + 8 * h;
        if (row < p.M)
          *reinterpret_cast<float2*>(out + (size_t)row * p.N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  if constexpr (EPI == EPI_STATS) {
    stats_epilogue(acc, p, m0, n0, boxes, c, t, rl,
                   reinterpret_cast<float*>(ring_ptr + STAGES * STAGE_BYTES) +
                       c * 4 * BN);
    return;
  }

  // Epilogue, in this consumer's half of the C tile in shared memory (the
  // TMA box layout: 64-column boxes of 64 rows x 128 bytes, 16-byte chunks
  // swizzled by row % 8, so a warp's stores hit every bank once), the
  // residual or saved h read from the same place, where TMA put it.
  if (AUX) mbar_wait(smem_u32(&res_full), 0);
  unsigned char* half = ring_ptr + STAGES * STAGE_BYTES +
                        c * (BN / BOX) * B_BOX_BYTES;
  const uint32_t half_u32 = ctile + c * (BN / BOX) * B_BOX_BYTES;
  auto slot = [&](int j, int r) {   // columns 8j + 2 (t % 4), + 1 of row r
    return reinterpret_cast<__nv_bfloat162*>(
        half + (j / 8) * B_BOX_BYTES + r * 128 +
        (((j % 8) ^ (r % 8)) * 16) + 4 * (t % 4));
  };
  // the generic-proxy writes to the half must be visible to the TMA (async
  // proxy) before one thread stores it; the half is free again once the
  // TMA has read it
  auto store_half = [&](const CUtensorMap* map) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    if (t == 0) {
      for (int j = 0; j < boxes; ++j)
        tma_store(map, half_u32 + j * B_BOX_BYTES, n0 + j * BOX,
                  m0 + 64 * c);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  };
  float loss = 0.f;   // EPI_DL: this thread's sum of -qbar x
  if constexpr (EPI == EPI_DL) {
    __shared__ int lims[2][8];
    DlRows rows;
    rows.load(p, m0 + 64 * c + rl);
    int lo = 0x7fffffff, hi = -1;   // the teacher rows these rows pair with
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows.n[h] > 0) {
        lo = min(lo, rows.pt[h][0]);
        hi = max(hi, rows.pt[h][rows.n[h] - 1]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    const int warp = (threadIdx.x - 128) / 32;
    if (t % 32 == 0) {
      lims[0][warp] = lo;
      lims[1][warp] = hi;
    }
    // both consumers are done reading the ring
    asm volatile("bar.sync 3, 256;" ::: "memory");
    int t0 = lims[0][0], t1 = lims[1][0];
#pragma unroll
    for (int w = 1; w < 8; ++w) {
      t0 = min(t0, lims[0][w]);
      t1 = max(t1, lims[1][w]);
    }
    const float* staged = nullptr;
    if (t1 >= t0 && t1 - t0 < QS_ROWS) {
      float* qs = reinterpret_cast<float*>(ring_ptr);
      const int f4 = boxes * BOX / 4;   // float4s of a row's valid columns
      for (int i = threadIdx.x - 128; i < (t1 - t0 + 1) * f4; i += 256)
        *reinterpret_cast<float4*>(qs + (i / f4) * QS + 4 * (i % f4)) =
            *reinterpret_cast<const float4*>(
                p.q + (size_t)(t0 + i / f4) * p.N + n0 + 4 * (i % f4));
      asm volatile("bar.sync 3, 256;" ::: "memory");
      staged = qs;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float qb[BN / 4];
      rows.qbar(p, h, n0, t % 4, boxes, staged, t0, qb);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float d[2] = {0.f, 0.f};
        if (j / 8 < boxes && rows.row[h] < rows.M)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            loss = __fadd_rn(loss, rows.dl(p, h, acc[4 * j + 2 * h + e],
                                           qb[2 * j + e], d[e]));
        *slot(j, rl + 8 * h) = __floats2bfloat162_rn(d[0], d[1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
          &bias2[j]);
      const int col = n0 + 8 * j + 2 * (t % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* sl = slot(j, rl + 8 * h);
        __nv_bfloat162 v;
        if constexpr (I8) {   // the column scales and bias read here
          float2 ws = make_float2(0.f, 0.f);
          __nv_bfloat162 b = __floats2bfloat162_rn(0.f, 0.f);
          if (j / 8 < boxes) {
            ws = *reinterpret_cast<const float2*>(p.b_scale + col);
            b = *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
          }
          const float v0 = dequant(acc[4 * j + 2 * h], scale[h], ws.x,
                                   __low2float(b));
          const float v1 = dequant(acc[4 * j + 2 * h + 1], scale[h], ws.y,
                                   __high2float(b));
          if (EPI == EPI_I8_BF16) {
            v = __floats2bfloat162_rn(v0, v1);
          } else {   // bf16 add of the residual and bf16(v)
            const __nv_bfloat162 rv = *sl;
            v = __floats2bfloat162_rn(__low2float(rv) + bf16_round(v0),
                                      __high2float(rv) + bf16_round(v1));
          }
        } else {
          const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          if (EPI == EPI_NONE) {
            v = __floats2bfloat162_rn(a0, a1);
          } else if (EPI == EPI_DGELU) {   // f32 product times f32 gelu'(h)
            const __nv_bfloat162 hv = *sl;
            v = __floats2bfloat162_rn(a0 * gelu_tanh_grad(__low2float(hv)),
                                      a1 * gelu_tanh_grad(__high2float(hv)));
          } else {
            // each pair converted by one cvt.rn.bf16x2: the same rounding
            const __nv_bfloat162 a = __floats2bfloat162_rn(a0, a1);
            v = __floats2bfloat162_rn(__low2float(a) + __low2float(bv),
                                      __high2float(a) + __high2float(bv));
            if (EPI == EPI_GELU) {   // f32 GELU, rounded at the store
              v = __floats2bfloat162_rn(gelu_tanh(__low2float(v)),
                                        gelu_tanh(__high2float(v)));
            } else if (EPI == EPI_RESIDUAL) {
              if (p.row_scale != nullptr)
                v = __floats2bfloat162_rn(__low2float(v) * scale[h],
                                          __high2float(v) * scale[h]);
              const __nv_bfloat162 rv = *sl;
              v = __floats2bfloat162_rn(__low2float(rv) + __low2float(v),
                                        __high2float(rv) + __high2float(v));
            }
          }
        }
        *sl = v;
      }
    }
  }
  if (m0 + 64 * c >= p.M) return;   // EPI_DL's half past M
  store_half(&map_c);

  if constexpr (EPI == EPI_DL) {   // the half's loss partial, warps in order
    __shared__ float warp_loss[2][4];
    loss = warp_sum(loss);
    if (t % 32 == 0) warp_loss[c][t / 32] = loss;
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
    if (t == 0)
      p.loss_part[(size_t)(m0 / 64 + c) * ((p.N + BN - 1) / BN) + n0 / BN] =
          __fadd_rn(__fadd_rn(warp_loss[c][0], warp_loss[c][1]),
                    __fadd_rn(warp_loss[c][2], warp_loss[c][3]));
  }

  if (EPI == EPI_GELU_SAVE) {   // g = bf16(gelu(h)) through the same half
    asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* sl = slot(j, rl + 8 * h);
        const __nv_bfloat162 hv = *sl;
        *sl = __floats2bfloat162_rn(gelu_tanh(__low2float(hv)),
                                    gelu_tanh(__high2float(hv)));
      }
    store_half(&map_c2);
  }

  if (EPI == EPI_DGELU && p.colsum != nullptr) {
    // sums of the half's bf16 columns over its rows < M, one partial row
    // per 64-row half; a thread takes a column pair (a warp one box's row,
    // 128 bytes, every bank once) and sums rows r % 4 apart, then the four
    // in order (the TMA store only reads the half)
    const int rows = min(64, p.M - (m0 + 64 * c));
    if (t < boxes * BOX / 2) {
      const int chunk = (t % 32) / 4;
      const unsigned char* col = half + (t / 32) * B_BOX_BYTES + (t % 4) * 4;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r0 = 0; r0 < rows; r0 += 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (r0 + i < rows) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                col + (r0 + i) * 128 + ((chunk ^ i) * 16));
            lo[i % 4] += __low2float(v);
            hi[i % 4] += __high2float(v);
          }
        }
      }
      *reinterpret_cast<float2*>(p.colsum + (size_t)(m0 / 64 + c) * p.N +
                                 n0 + 2 * t) =
          make_float2((lo[0] + lo[1]) + (lo[2] + lo[3]),
                      (hi[0] + hi[1]) + (hi[2] + hi[3]));
    }
  }
}

// map_a: A in (128, 64) boxes, or (64, 64) for A_MN (int8: (128, 128));
// map_b: B in (64, 64) boxes, or (192, 64) for B_NK (int8: (192, 128));
// map_c, map_c2: C, C2 (M, N) and map_r: the residual or saved h (M, N)
// in (64, 64) boxes (map_r is read by EPI_RESIDUAL, EPI_DGELU and
// EPI_I8_RESID, map_c2 by EPI_GELU_SAVE, neither map by EPI_F32 or
// EPI_STATS).  EPI_I8_MLP: map_b is W1, map_r W2 (mlp_i8).
template <int EPI, bool A_MN, bool B_NK>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_r,
                     const __grid_constant__ CUtensorMap map_c2,
                     GemmArgs p) {
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], res_full;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  gemm_tile<EPI, A_MN, B_NK>(map_a, map_b, map_c, map_r, map_c2, p, full,
                             empty, res_full, sm90_smem);
}

// The MLP mode: 256 threads (mlp_i8), so that the launch bound lets each
// thread hold 255 registers.
template <>
__global__ void __launch_bounds__(MLP_THREADS, 1)
    gemm_sm90_kernel<EPI_I8_MLP, false, true>(
        const __grid_constant__ CUtensorMap map_a,
        const __grid_constant__ CUtensorMap map_b,
        const __grid_constant__ CUtensorMap map_c,
        const __grid_constant__ CUtensorMap map_r,
        const __grid_constant__ CUtensorMap map_c2, GemmArgs p) {
  __shared__ __align__(8) uint64_t full[2 * MLP_STAGES], a_full;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  mlp_i8(map_a, map_b, map_c, map_r, p, full, &a_full, sm90_smem);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's
// entry-point query, so the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &status);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &status);
#endif
    return e == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a (rows, cols) row-major bf16 (or int8) matrix read in
// boxes of (box_rows, 128 bytes) with the 128-byte swizzle; elements past
// the edges read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows, bool i8 = false) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int elem = i8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map,
                i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t a = 0;
  for (const void* p : ptrs) a |= reinterpret_cast<uintptr_t>(p);
  return a % 16 == 0;
}

// One launch of gemm_sm90_kernel on the caller's stream.
template <int EPI, bool A_MN, bool B_NK>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b,
                   const CUtensorMap& c, const CUtensorMap& r,
                   const CUtensorMap& c2, const GemmArgs& args, dim3 grid,
                   int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_sm90_kernel<EPI, A_MN, B_NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  gemm_sm90_kernel<EPI, A_MN, B_NK>
      <<<grid, EPI == EPI_I8_MLP ? MLP_THREADS : THREADS, smem, stream>>>(
          a, b, c, r, c2, args);
  return cudaGetLastError();
}

}  // namespace sm90

// C (M, N) = epilogue(A @ B) on the caller's stream (layouts as the
// header says; EPI_F32 writes f32 to C).  aux: the residual
// (EPI_RESIDUAL) or the saved h (EPI_DGELU); C2: g (EPI_GELU_SAVE);
// colsum: EPI_DGELU's per-half column sums, or null; kt_split: k tiles a
// split of K over blockIdx.z (0: no split; EPI_F32 only).  Takes any
// M, K >= 1, N a multiple of 64, every contiguous dimension a multiple of
// 8 (TMA row strides are multiples of 16 bytes) and 16-byte aligned
// operands.
template <int EPI, bool A_MN = false, bool B_NK = false>
cudaError_t gemm_sm90(const bf16* A, const bf16* B, const bf16* bias,
                      void* C, int M, int N, int K, cudaStream_t stream,
                      const bf16* aux = nullptr,
                      const bf16* row_scale = nullptr, bf16* C2 = nullptr,
                      float* colsum = nullptr, int kt_split = 0) {
  static_assert(EPI <= EPI_F32, "the bf16 modes");
  constexpr bool AUX = EPI == EPI_RESIDUAL || EPI == EPI_DGELU;
  const int ktiles = (K + sm90::BK - 1) / sm90::BK;
  if (kt_split <= 0 || kt_split > ktiles) kt_split = ktiles;
  if (M < 1 || K < 1 || N < sm90::BOX || N % sm90::BOX ||
      (A_MN ? M : K) % 8 || (B_NK ? K : N) % 8 ||
      !sm90::aligned16({A, B, C, aux, C2}) ||
      AUX != (aux != nullptr) || (EPI == EPI_GELU_SAVE) != (C2 != nullptr) ||
      (EPI != EPI_F32 && kt_split != ktiles))
    return cudaErrorInvalidValue;
  // the maps an epilogue does not read stay zero
  CUtensorMap map_a, map_b, map_c{}, map_r{}, map_c2{};
  const bool ok =
      (A_MN ? sm90::make_map(&map_a, A, K, M, sm90::BOX)
            : sm90::make_map(&map_a, A, M, K, sm90::BM)) &&
      (B_NK ? sm90::make_map(&map_b, B, N, K, sm90::BN)
            : sm90::make_map(&map_b, B, K, N, sm90::BK)) &&
      (EPI == EPI_F32 || sm90::make_map(&map_c, C, M, N, 64)) &&
      (aux == nullptr || sm90::make_map(&map_r, aux, M, N, 64)) &&
      (C2 == nullptr || sm90::make_map(&map_c2, C2, M, N, 64));
  if (!ok) return cudaErrorInvalidValue;
  sm90::GemmArgs args{};
  args.bias = bias;
  args.row_scale = row_scale;
  args.out32 = static_cast<float*>(C);
  args.colsum = colsum;
  args.M = M;
  args.N = N;
  args.K = K;
  args.kt_split = kt_split;
  const dim3 grid((N + sm90::BN - 1) / sm90::BN,
                  (M + sm90::BM - 1) / sm90::BM,
                  (ktiles + kt_split - 1) / kt_split);
  return sm90::launch<EPI, A_MN, B_NK>(map_a, map_b, map_c, map_r, map_c2,
                                       args, grid, sm90::SMEM, stream);
}

// The int8 products of K8 (EPI_I8_BF16, EPI_I8_RESID): C (M, N) bf16 =
// epilogue(A (M, K) int8 @ B^T), B stored (N, K) int8, a_scale (M,) and
// b_scale (N,) f32, bias (N,) bf16, aux the residual (M, N) bf16
// (EPI_I8_RESID).  K a multiple of 16, N of 64, 16-byte aligned operands.
template <int EPI>
cudaError_t gemm_sm90_i8(const int8_t* A, const float* a_scale,
                         const int8_t* B, const float* b_scale,
                         const bf16* bias, bf16* C, int M, int N, int K,
                         cudaStream_t stream, const bf16* aux = nullptr) {
  static_assert(EPI == EPI_I8_BF16 || EPI == EPI_I8_RESID, "int8 modes");
  if (M < 1 || K < 1 || K % 16 || N < sm90::BOX || N % sm90::BOX ||
      !sm90::aligned16({A, B, C, aux}) ||
      (EPI == EPI_I8_RESID) != (aux != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_c, map_r{}, map_c2{};
  const bool ok = sm90::make_map(&map_a, A, M, K, sm90::BM, true) &&
                  sm90::make_map(&map_b, B, N, K, sm90::BN, true) &&
                  sm90::make_map(&map_c, C, M, N, 64) &&
                  (aux == nullptr || sm90::make_map(&map_r, aux, M, N, 64));
  if (!ok) return cudaErrorInvalidValue;
  sm90::GemmArgs args{};
  args.bias = bias;
  args.M = M;
  args.N = N;
  args.K = K;
  args.kt_split = (K + sm90::BK8 - 1) / sm90::BK8;
  args.a_scale = a_scale;
  args.b_scale = b_scale;
  const dim3 grid((N + sm90::BN - 1) / sm90::BN,
                  (M + sm90::BM - 1) / sm90::BM, 1);
  return sm90::launch<EPI, false, true>(map_a, map_b, map_c, map_r, map_c2,
                                        args, grid, sm90::SMEM, stream);
}

// K8's MLP (EPI_I8_MLP, mlp_i8): out (M, D) = resid + bf16(fc2(quant(
// gelu(fc1(A))))), A (M, D) int8 with a_scale (M,); W1 stored (H, D) int8
// with w1_scale (H,) and b1 (H,); W2 stored (D, H) int8 with w2_scale (D,)
// and b2 (D,); resid and out (M, D) bf16.  D a multiple of 384 up to 768,
// H of 256.
template <int = 0>   // a template: instantiated only where it is called
cudaError_t mlp_sm90_i8(const int8_t* A, const float* a_scale,
                        const int8_t* W1, const float* w1_scale,
                        const bf16* b1, const int8_t* W2,
                        const float* w2_scale, const bf16* b2,
                        const bf16* resid, bf16* out, int M, int D, int H,
                        cudaStream_t stream) {
  using namespace sm90;
  if (M < 1 || D % (2 * MLP_NC) || D > MLP_MAX_D || H < MLP_SLICE ||
      H % MLP_SLICE || !aligned16({A, W1, W2, resid, out}))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w1, map_c, map_w2, map_c2{};
  const bool ok =
      make_map(&map_a, A, M, D, MLP_BM, true) &&
      make_map(&map_w1, W1, H, D, MLP_SLICE / 2, true) &&
      make_map(&map_w2, W2, D, H, MLP_NC, true) &&
      make_map(&map_c, out, M, D, 64);
  if (!ok) return cudaErrorInvalidValue;
  GemmArgs args{};
  args.bias = b1;
  args.M = M;
  args.N = D;
  args.K = D;
  args.a_scale = a_scale;
  args.b_scale = w1_scale;
  args.b2_scale = w2_scale;
  args.bias2 = b2;
  args.resid = resid;
  args.H = H;
  const dim3 grid(D / (2 * MLP_NC), (M + MLP_BM - 1) / MLP_BM, 1);
  return launch<EPI_I8_MLP, false, true>(map_a, map_w1, map_c, map_w2,
                                         map_c2, args, grid, mlp_smem(D),
                                         stream);
}

// K7's products with a row epilogue (EPI_STATS, EPI_DL): A (M, K) bf16
// K-major @ B (K, N) bf16 MN-major, C the dl output (M, N) bf16 (EPI_DL);
// args carries the epilogue's operands (M, N, K are set here).  The
// per-tile partials are indexed by column tile, ceil(N / 192) of them; the
// blocks of one column tile run together.
template <int EPI>
cudaError_t gemm_sm90_k7(const bf16* A, const bf16* B, bf16* C, int M,
                         int N, int K, sm90::GemmArgs args,
                         cudaStream_t stream) {
  static_assert(EPI == EPI_STATS || EPI == EPI_DL, "K7's modes");
  if (M < 1 || K < 1 || K % 8 || N < sm90::BOX || N % sm90::BOX ||
      !sm90::aligned16({A, B, C}) || (EPI == EPI_DL) != (C != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_c{}, map_r{}, map_c2{};
  const bool ok = sm90::make_map(&map_a, A, M, K, sm90::BM) &&
                  sm90::make_map(&map_b, B, K, N, sm90::BK) &&
                  (C == nullptr || sm90::make_map(&map_c, C, M, N, 64));
  if (!ok) return cudaErrorInvalidValue;
  args.M = M;
  args.N = N;
  args.K = K;
  args.kt_split = (K + sm90::BK - 1) / sm90::BK;
  const dim3 grid((M + sm90::BM - 1) / sm90::BM,
                  (N + sm90::BN - 1) / sm90::BN, 1);
  return sm90::launch<EPI, false, false>(map_a, map_b, map_c, map_r, map_c2,
                                         args, grid, sm90::SMEM, stream);
}

// The split of a K = rows reduction for an (M, N) f32 output (a weight
// gradient, or K7's dh_s over out_dim): about one block an SM in all
// (sm90::WAVE), each split a whole number of k tiles.  Returns the number
// of splits; *kt_split gets the k tiles of each.
inline int wgrad_splits(int M, int N, int rows, int* kt_split) {
  const int tiles = ((M + sm90::BM - 1) / sm90::BM) *
                    ((N + sm90::BN - 1) / sm90::BN);
  const int ktiles = (rows + sm90::BK - 1) / sm90::BK;
  int want = sm90::WAVE / tiles;
  if (want > ktiles) want = ktiles;
  if (want < 1) want = 1;
  *kt_split = (ktiles + want - 1) / want;
  return (ktiles + *kt_split - 1) / *kt_split;
}

// f32 elements of a weight gradient's partials (wgrad_splits x M x N).
inline size_t wgrad_partials(int M, int N, int rows) {
  int kt_split;
  return (size_t)wgrad_splits(M, N, rows, &kt_split) * M * N;
}

// The split partials of dW (M, N) = A^T B over K = rows, A stored (rows,
// M), B (rows, N), into partial (wgrad_splits, M, N) f32; the caller sums
// them in split order (sum_parts).
inline cudaError_t wgrad_sm90(const bf16* A, const bf16* B, float* partial,
                              int M, int N, int rows, cudaStream_t stream) {
  int kt_split;
  wgrad_splits(M, N, rows, &kt_split);
  return gemm_sm90<EPI_F32, true, false>(A, B, nullptr, partial, M, N, rows,
                                         stream, nullptr, nullptr, nullptr,
                                         nullptr, kt_split);
}

}  // namespace
