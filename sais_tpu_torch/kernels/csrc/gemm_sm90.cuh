// The products of the ViT-block kernels (K1 and K4 in fused_vit_block.cu,
// K5 in fused_block_bwd_mlp.cu, K6 in fused_block_bwd_attn.cu) on Hopper's
// wgmma + TMA (sm_90a):
//
//   C = epilogue(A @ B),  bf16 operands, f32 accumulation, where
//     A (M, K) is stored row-major (K-major), or as (K, M) row-major
//       (A_MN: the activations of a weight gradient, read transposed);
//     B (K, N) is stored row-major (MN-major: the port's (in, out)
//       weights, or the activations of a weight gradient), or as (N, K)
//       row-major (B_NK: a weight read as its transpose in the backward).
//
// They replace the products inside the TPU kernels of
// sais_tpu/kernels/fused_mha.py: _block_kernel (K1) and
// _block_fwd_train_kernel (K4): qkv, proj, fc1, fc2; _mlp_bwd_kernel (K5):
// the fc1 recompute, dh, dy, dW2, dW1; _attn_bwd_kernel and _attn_bwd_tail
// (K6): the qkv recompute, dctx, dy, dWproj, dWqkv.
//
// Bound: at K = 384 a product is close to the card's ridge (768 flops per
// 2-byte output), so its epilogue traffic matters nearly as much as its
// tensor-core rate; a weight gradient (K = B*L rows, a 384 x 1536 output)
// is far above it.  An mma.sync GEMM ran them at about 190 TFLOP/s:
// mma.sync cannot reach the card's full rate, and its ldmatrix / cp.async
// traffic runs on the SM's threads.  This design:
//
// - one 128 x 192 output tile a block (grid (N / 192, M / 128, splits));
//   192 columns cover N = 384 in two tiles and divide 1152 and 1536;
// - TMA 2-D tensor maps with a 128-byte swizzle carry A and B into a
//   4-stage ring of 40 KB stages: A as one 64 x 128 box (K-major) or two
//   64 x 64 boxes (A_MN), B as three 64 x 64 boxes (MN-major) or one
//   64 x 192 box (B_NK); one full and one empty mbarrier a stage; what lies
//   past M, N or K arrives as zeros; the first stages are requested before
//   the block's first barrier;
// - warpgroup 0 is the producer: one thread issues the loads, then the
//   residual or saved-h tile (EPI_RESIDUAL, EPI_DGELU) into the C tile;
//   setmaxnreg gives the group's registers to the consumers;
// - warpgroups 1 and 2 consume 64 rows each with wgmma.mma_async
//   m64n192k16 (bf16 in, f32 accumulators in registers), each operand's
//   major-ness set by the instruction's transpose bits (no copy of any
//   operand); one wgmma group stays in flight, and a stage is released
//   when the group that read it has completed;
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
//   same half; the ring keeps its four stages.
//
// With one block an SM and one tile a block, each tile pays in full the
// latency of its first loads, its epilogue and its store; at K = 384 that
// is as long as its products (PERF.md).  Later work: a persistent
// scheduler so that one tile's epilogue overlaps the next tile's loads and
// products, LayerNorm in the prologue, the MLP fused so that h stays on
// chip, and the LayerNorm backward in the epilogue of K5's and K6's dy.

#pragma once

#include <cuda.h>

#include "vit_block_common.cuh"

namespace {

// Epilogues (per element, on the f32 accumulator acc):
//   EPI_BIAS      C = bf16(bf16(acc) + bias)
//   EPI_GELU      C = bf16(gelu(bf16(bf16(acc) + bias)))
//   EPI_RESIDUAL  v = bf16(bf16(acc) + bias) [v = bf16(v * row_scale[row])];
//                 C = bf16(residual + v)
//   EPI_NONE      C = bf16(acc)
//   EPI_GELU_SAVE h = bf16(bf16(acc) + bias); C = h; C2 = bf16(gelu(h))
//   EPI_DGELU     C = bf16(acc * gelu'(aux)), aux the saved h (C may be
//                 aux); optionally each 64-row half's column sums of C
//   EPI_F32       C (f32) = acc, split z at offset z * M * N
enum Epilogue {
  EPI_BIAS = 0,
  EPI_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_NONE = 3,
  EPI_GELU_SAVE = 4,
  EPI_DGELU = 5,
  EPI_F32 = 6
};

namespace sm90 {

constexpr int BM = 128, BN = 192, BK = 64, STAGES = 4;
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
//   K-major (A, or B_NK): rows of 64 k (128 bytes), 8-row groups 1024
//     bytes apart (stride offset); the leading offset is unused.  A k16
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
  float* out32;            // EPI_F32: (splits, M, N)
  float* colsum;           // EPI_DGELU, or null: (ceil(M / 64), N)
  int M, N, K;
  int kt_split;            // k tiles a split (blockIdx.z)
};

static_assert(BN == 192, "wgmma_192 is the consumers' instruction");

// map_a: A in (128, 64) boxes, or (64, 64) for A_MN; map_b: B in (64, 64)
// boxes, or (192, 64) for B_NK; map_c, map_c2: C, C2 (M, N) and map_r: the
// residual or saved h (M, N) in (64, 64) boxes (map_r is read by
// EPI_RESIDUAL and EPI_DGELU, map_c2 by EPI_GELU_SAVE, neither map by
// EPI_F32).
template <int EPI, bool A_MN, bool B_NK>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_r,
                     const __grid_constant__ CUtensorMap map_c2,
                     GemmArgs p) {
  constexpr bool AUX = EPI == EPI_RESIDUAL || EPI == EPI_DGELU;
  constexpr bool BIAS = EPI == EPI_BIAS || EPI == EPI_GELU ||
                        EPI == EPI_RESIDUAL || EPI == EPI_GELU_SAVE;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], res_full;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(sm90_smem) + 1023) & ~1023u;
  unsigned char* ring_ptr = sm90_smem + (ring - smem_u32(sm90_smem));
  const uint32_t ctile = ring + STAGES * STAGE_BYTES;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * p.kt_split;   // this split's first k tile
  const int ktiles = min((p.K + BK - 1) / BK - kt0, p.kt_split);
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
    const int k = (kt0 + i) * BK;
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
  float scale[2] = {1.f, 1.f};
  if (EPI == EPI_RESIDUAL && p.row_scale != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * c + rl + 8 * h;
      if (row < p.M) scale[h] = __bfloat162float(p.row_scale[row]);
    }
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int i = 0; i < ktiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
    // consumer c's 64 rows of A lie 8 KB into the stage in both layouts
    const uint32_t sa = ring + s * STAGE_BYTES + c * (A_BYTES / 2);
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_192<A_MN, !B_NK>(acc, operand_desc<A_MN>(sa, kk),
                             operand_desc<!B_NK>(sb, kk));
    wgmma_commit();
    if (i > 0) {   // the group of tile i - 1 has completed: free its stage
      wgmma_wait<1>();
      if (t == 0) mbar_arrive(smem_u32(&empty[(i - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (m0 + 64 * c >= p.M) return;   // every row of this half is past M

  if (EPI == EPI_F32) {   // f32 straight from the accumulators
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
        &bias2[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162* sl = slot(j, rl + 8 * h);
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      __nv_bfloat162 v;
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
      *sl = v;
    }
  }
  store_half(&map_c);

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

// Tensor map of a (rows, cols) row-major bf16 matrix read in boxes of
// (box_rows, 64) with the 128-byte swizzle; elements past the edges read
// as zeros.
inline bool make_map(CUtensorMap* map, const bf16* ptr, int rows, int cols,
                     int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  constexpr bool AUX = EPI == EPI_RESIDUAL || EPI == EPI_DGELU;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(A) |
                              reinterpret_cast<uintptr_t>(B) |
                              reinterpret_cast<uintptr_t>(C) |
                              reinterpret_cast<uintptr_t>(aux) |
                              reinterpret_cast<uintptr_t>(C2);
  const int ktiles = (K + sm90::BK - 1) / sm90::BK;
  if (kt_split <= 0 || kt_split > ktiles) kt_split = ktiles;
  if (M < 1 || K < 1 || N < sm90::BOX || N % sm90::BOX ||
      (A_MN ? M : K) % 8 || (B_NK ? K : N) % 8 || addresses % 16 ||
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
      (EPI == EPI_F32 ||
       sm90::make_map(&map_c, static_cast<bf16*>(C), M, N, 64)) &&
      (aux == nullptr || sm90::make_map(&map_r, aux, M, N, 64)) &&
      (C2 == nullptr || sm90::make_map(&map_c2, C2, M, N, 64));
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sm90::gemm_sm90_kernel<EPI, A_MN, B_NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + sm90::BN - 1) / sm90::BN,
                  (M + sm90::BM - 1) / sm90::BM,
                  (ktiles + kt_split - 1) / kt_split);
  sm90::GemmArgs args{bias, row_scale, static_cast<float*>(C), colsum,
                      M, N, K, kt_split};
  sm90::gemm_sm90_kernel<EPI, A_MN, B_NK>
      <<<grid, sm90::THREADS, sm90::SMEM, stream>>>(map_a, map_b, map_c,
                                                     map_r, map_c2, args);
  return cudaGetLastError();
}

// The split of a weight gradient's K = rows reduction for an (M, N)
// output: about one block an SM in all (sm90::WAVE), each split a whole
// number of k tiles.  Returns the number of splits; *kt_split gets the k
// tiles of each.
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
