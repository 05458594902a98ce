// The four products of the ViT-block forward (K1 and K4 in
// fused_vit_block.cu) on Hopper's wgmma + TMA (sm_90a):
//
//   C = epilogue(A @ B),  A (M, K) row-major bf16 activations,
//                         B (K, N) row-major bf16 weight (the port's layout),
//                         f32 accumulation.
//
// They replace, inside K1 and K4, the products of the TPU kernels
// sais_tpu/kernels/fused_mha.py::_block_kernel (reached through
// fused_vit_block) and ::_block_fwd_train_kernel (reached through
// _fused_block_fwd_train): qkv, proj, fc1 and fc2.
//
// Bound: at (B, L) = (256, 197), D = 384, MLP 1536 the four products are
// 24 L D^2 B = 178.5 GFLOP and the block's attention 15.3 more, 0.1959 ms
// at the card's 989 TFLOP/s bf16.  With K = 384 a product is close to the
// card's ridge (768 flops per 2-byte output), so its epilogue traffic
// matters nearly as much as its tensor-core rate.  The mma.sync template
// (vit_block_common.cuh) ran them at about 190 TFLOP/s: mma.sync cannot
// reach the card's full rate, and its ldmatrix / cp.async traffic runs on
// the SM's threads.  This design:
//
// - one 128 x 192 output tile a block (grid (N / 192, M / 128)); 192
//   columns cover N = 384 in two tiles and divide 1152 and 1536;
// - TMA 2-D tensor maps with a 128-byte swizzle carry A (a 64 x 128 box)
//   and B (three 64 x 64 boxes) into a 4-stage ring of 40 KB stages; one
//   full and one empty mbarrier a stage; rows of A past M arrive as zeros;
//   the first stages are requested before the block's first barrier;
// - warpgroup 0 is the producer: one thread issues the loads, then the
//   residual tile (EPI_RESIDUAL) into the C tile; setmaxnreg gives the
//   group's registers to the consumers;
// - warpgroups 1 and 2 consume 64 rows each with wgmma.mma_async
//   m64n192k16 (bf16 in, f32 accumulators in registers), A K-major and B
//   MN-major through the descriptor's transpose bit (no copy of the
//   weight); one wgmma group stays in flight, and a stage is released when
//   the group that read it has completed;
// - the epilogue reads the accumulators in wgmma's fragment layout, keeps
//   the mma.sync template's rounding points (EPI_BIAS, EPI_GELU,
//   EPI_RESIDUAL with the optional per-row scale) and writes a 48 KB C
//   tile in shared memory, which a TMA store copies out; TMA clips rows
//   >= M, and boxes past N are neither loaded nor stored.
//
// With one block an SM and one tile a block, each tile pays in full the
// latency of its first loads, its epilogue (tanh GELU the most) and its
// store; at K = 384 that is as long as its products (PERF.md).  Later
// work: a persistent scheduler so that one tile's epilogue overlaps the
// next tile's loads and products, LayerNorm in the prologue (a consumer
// pass over the A tile), and the MLP fused so that h stays on chip.

#pragma once

#include <cuda.h>

#include "vit_block_common.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128, BN = 192, BK = 64, STAGES = 4;
constexpr int THREADS = 384;                // producer + 2 consumer warpgroups
constexpr int BOX = 64;                     // 64 bf16: the 128-byte swizzle span
constexpr int A_BYTES = BM * BK * 2;        // one A box, 16 KB
constexpr int B_BOX_BYTES = BK * BOX * 2;   // a 64 x 64 box, 8 KB
constexpr int STAGE_BYTES = A_BYTES + BN / BOX * B_BOX_BYTES;
constexpr int C_BYTES = BM * BN * 2;        // the C tile, 48 KB
// the ring, the C tile, and slack to align both to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + C_BYTES + 1024;

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
// into shared memory; completion is counted on `bar` in bytes.
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
//   A, K-major: rows of 64 k (128 bytes), 8-row groups 1024 bytes apart
//     (stride offset); the leading offset is unused.  A k16 step adds 32
//     bytes to the start address.
//   B, MN-major (transposed): rows of 64 n per k, 8-k groups 1024 bytes
//     apart (stride offset), 64-column boxes B_BOX_BYTES apart (leading
//     offset).  A k16 step adds 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
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

// d += A (64 x 16, K-major) @ B (16 x 192, MN-major), both from shared
// memory.  Fragment: register 4j + 2h + e of thread t holds row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e.
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
      "}, %96, %97, p, 1, 1, 0, 1;\n"
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
  const bf16* bias;        // (N,)
  const bf16* row_scale;   // (M,) or null, EPI_RESIDUAL
  int M, N, K;
};

static_assert(BN == 192, "wgmma_192 is the consumers' instruction");

// map_a: A (M, K) in (128, 64) boxes; map_b: B (K, N) in (64, 64) boxes;
// map_c: C (M, N) and map_r: the residual (M, N) in (64, 64) boxes (map_r
// is read by EPI_RESIDUAL only).
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c,
                     const __grid_constant__ CUtensorMap map_r,
                     GemmArgs p) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_GELU || EPI == EPI_RESIDUAL,
                "epilogues of the block forward");
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], res_full;
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t ring = (smem_u32(sm90_smem) + 1023) & ~1023u;
  unsigned char* ring_ptr = sm90_smem + (ring - smem_u32(sm90_smem));
  const uint32_t ctile = ring + STAGES * STAGE_BYTES;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (p.K + BK - 1) / BK;
  // whole 64-column boxes inside N (N is a multiple of 64); the columns of
  // a skipped box are computed from stale shared memory and never stored
  const int boxes = min(BN, p.N - n0) / BOX;
  const int wg = threadIdx.x / 128;

  const uint32_t stage_bytes = A_BYTES + boxes * B_BOX_BYTES;
  auto load_stage = [&](int kt) {   // k tile kt into stage kt % STAGES
    const uint32_t bar = smem_u32(&full[kt % STAGES]);
    const uint32_t sa = ring + (kt % STAGES) * STAGE_BYTES, sb = sa + A_BYTES;
    mbar_expect_tx(bar, stage_bytes);
    tma_load(sa, &map_a, kt * BK, m0, bar);
    for (int j = 0; j < boxes; ++j)
      tma_load(sb + j * B_BOX_BYTES, &map_b, n0 + j * BOX, kt * BK, bar);
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
    for (int kt = 0; kt < min(ktiles, STAGES); ++kt) load_stage(kt);
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int kt = STAGES; kt < ktiles; ++kt) {
        // stage kt % STAGES is free once both consumers released tile
        // kt - STAGES
        mbar_wait(smem_u32(&empty[kt % STAGES]), (kt / STAGES - 1) & 1);
        load_stage(kt);
      }
      if (EPI == EPI_RESIDUAL) {   // the residual tile, behind the products
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
    bias2[j] = col < p.N
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
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
    const uint32_t sa = ring + s * STAGE_BYTES + c * 64 * 128;
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_192(acc, smem_desc(sa + kk * 32, 16, 1024),
                smem_desc(sb + kk * 16 * 128, B_BOX_BYTES, 1024));
    wgmma_commit();
    if (kt > 0) {   // the group of tile kt - 1 has completed: free its stage
      wgmma_wait<1>();
      if (t == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (m0 + 64 * c >= p.M) return;   // every row of this half is past M

  // Epilogue, in this consumer's half of the C tile in shared memory (the
  // TMA box layout: 64-column boxes of 64 rows x 128 bytes, 16-byte chunks
  // swizzled by row % 8, so a warp's stores hit every bank once):
  //   v = bf16(bf16(acc) + bias); EPI_BIAS C = v; EPI_GELU C = bf16(gelu(v));
  //   EPI_RESIDUAL [v = bf16(v * row_scale)], C = bf16(residual + v),
  // the residual read from the same place, where TMA put it.
  if (EPI == EPI_RESIDUAL) mbar_wait(smem_u32(&res_full), 0);
  unsigned char* half = ring_ptr + STAGES * STAGE_BYTES +
                        c * (BN / BOX) * B_BOX_BYTES;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
        &bias2[j]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
          half + (j / 8) * B_BOX_BYTES + r * 128 +
          (((j % 8) ^ (r % 8)) * 16) + 4 * (t % 4));
      // each pair converted by one cvt.rn.bf16x2: the same rounding
      const __nv_bfloat162 a =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      __nv_bfloat162 v = __floats2bfloat162_rn(
          __low2float(a) + __low2float(bv), __high2float(a) + __high2float(bv));
      if (EPI == EPI_GELU) {   // f32 GELU, rounded at the store
        v = __floats2bfloat162_rn(gelu_tanh(__low2float(v)),
                                  gelu_tanh(__high2float(v)));
      } else if (EPI == EPI_RESIDUAL) {
        if (p.row_scale != nullptr)
          v = __floats2bfloat162_rn(__low2float(v) * scale[h],
                                    __high2float(v) * scale[h]);
        const __nv_bfloat162 rv = *slot;
        v = __floats2bfloat162_rn(__low2float(rv) + __low2float(v),
                                  __high2float(rv) + __high2float(v));
      }
      *slot = v;
    }
  }
  // the generic-proxy writes above must be visible to the TMA (async
  // proxy) before one thread stores the half; TMA clips rows >= M
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
  if (t == 0) {
    const uint32_t src = ctile + c * (BN / BOX) * B_BOX_BYTES;
    for (int j = 0; j < boxes; ++j)
      tma_store(&map_c, src + j * B_BOX_BYTES, n0 + j * BOX, m0 + 64 * c);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // shared memory must outlive the TMA's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
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

// C (M, N) = epilogue(A (M, K) @ B (K, N)), all bf16 row-major, on the
// caller's stream.  Takes any M >= 1, N a multiple of 64, K a multiple of
// 8 (TMA row strides are multiples of 16 bytes) and 16-byte aligned A, B.
template <int EPI>
cudaError_t gemm_sm90(const bf16* A, const bf16* B, const bf16* bias,
                      bf16* C, int M, int N, int K, cudaStream_t stream,
                      const bf16* residual = nullptr,
                      const bf16* row_scale = nullptr) {
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(A) |
                              reinterpret_cast<uintptr_t>(B) |
                              reinterpret_cast<uintptr_t>(C) |
                              reinterpret_cast<uintptr_t>(residual);
  if (M < 1 || N < sm90::BOX || N % sm90::BOX || K < 8 || K % 8 ||
      addresses % 16 || (EPI == EPI_RESIDUAL) != (residual != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_c, map_r;
  if (!sm90::make_map(&map_a, A, M, K, sm90::BM) ||
      !sm90::make_map(&map_b, B, K, N, sm90::BK) ||
      !sm90::make_map(&map_c, C, M, N, 64) ||
      !sm90::make_map(&map_r, residual ? residual : C, M, N, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sm90::gemm_sm90_kernel<EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + sm90::BN - 1) / sm90::BN,
                  (M + sm90::BM - 1) / sm90::BM);
  sm90::gemm_sm90_kernel<EPI><<<grid, sm90::THREADS, sm90::SMEM, stream>>>(
      map_a, map_b, map_c, map_r, sm90::GemmArgs{bias, row_scale, M, N, K});
  return cudaGetLastError();
}

}  // namespace
