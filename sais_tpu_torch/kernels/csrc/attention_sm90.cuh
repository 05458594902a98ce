// The key-tiled masked softmax attention past 256 tokens (the patch-8 ViTs:
// 785 tokens at 224 px), on Hopper's wgmma + TMA (sm_90a): the forward that
// K1, K4 (fused_vit_block.cu) and K8 (fused_vit_block_int8.cu) run through
// `attention`, and the pieces K6's backward pair (fused_block_bwd_attn.cu)
// shares with it.  Up to 256 tokens `attention` runs the register kernel of
// vit_block_common.cuh.
//
// Replaces the head loop of sais_tpu/kernels/fused_mha.py::_packed_attn_ctx
// (inside _block_kernel, _block_fwd_train_kernel and _block_kernel_int8)
// for L > 256, where a head's K and V (200 KB at 785 rows) no longer fit
// beside a block's other tiles, nor a query's scores in registers.  Per
// (image, head), at the JAX kernel's rounding points:
//
//   s   = (q dh^-0.5) k^T + mask   keys >= valid_len -1e30, tile padding -inf
//   p   = softmax_f32(s), pb = bf16(p), the *normalised* p rounded
//   ctx = bf16(pb v)
//
// Because pb is formed from the normalised p, an online softmax that
// rescales an unnormalised accumulator would round elsewhere; so the keys
// are swept twice: sweep 1 (K tiles only) keeps each lane's running max m
// and sum l of exp(s - m) for its two rows, merged over the quad at the
// end; sweep 2 (K and V tiles) recomputes s, forms p = exp(s - m) / l in
// registers, rounds it to bf16 as the A operand of the next product and
// accumulates ctx += pb v in f32.  Scores live in the log2 domain (t = s
// dh^-0.5 log2 e, one multiply), exp(s - m) is ex2.approx(t - m) and p
// multiplies by 1 / l: the same f32 p up to ulps.
//
// What bounds it on an H100: the design executes 6 L^2 Dh flops a head (two
// sweeps; 204 GFLOP at (128, 785, 384) with 64-row tiles, 0.21 ms at 989
// TFLOP/s) and 2 L^2 ex2 (1.06 G, about 0.29 ms on the SMs' 16 MUFU lanes
// each), and streams K twice and V once from L2 for every group of query
// tiles; the exponentials and the products take about as long as each
// other, so the kernel is only fast if one hides under the other.  The
// design:
//
// - a persistent grid (one block an SM) walks units of (image, head, three
//   64-query tiles); a block is three consumer warpgroups, each owning one
//   64-query tile, so wgmma m64 fits it and all three share the K / V
//   stream (a third of the L2 traffic of one tile a block), and a producer
//   warp.  A block of 416 threads leaves 128 registers a thread, which the
//   forward fits without spilling (ptxas allocates no more, whatever
//   setmaxnreg asks); a consumer with no tile in a unit (the last group of
//   a head) only keeps pace with the ring;
// - the producer's lane 0 issues the TMA loads (`produce`): the unit's Q
//   tiles into a double buffer (the next unit's arrive while this one
//   ends), then the keys through a ring of STAGES 16 KB stages with full
//   and empty mbarriers (sweep 1: K tiles; sweep 2: K and V).  A tile is
//   64 rows x 64 bf16 with the 128-byte swizzle: a head row is exactly 128
//   bytes.  The tensor map is 3-D over qkv, (3D columns, L rows, B
//   images), so a tile past L arrives as zeros, not as the next image's
//   rows;
// - S = Q K^T is an RS wgmma (m64n64k16): Q is loaded once into registers
//   as A fragments (ldmatrix from its swizzled tile), so only K streams
//   from shared memory through it, K-major.  ctx += pb V is an RS wgmma
//   too: pb is packed from S's accumulators in registers (the f32
//   accumulator of a thread holds 2 adjacent columns of every 8 in its two
//   rows, the A fragment's layout) and V is read MN-major through the
//   transpose bit.  No operand is copied or transposed;
// - overlap: in sweep 1 a consumer issues two tiles' S before the first
//   tile's statistics; in sweep 2 it issues tile j's S with tile j - 1's
//   ctx product and takes tile j's exponentials while the latter runs; and
//   the consumers interleave on the SM's schedulers.  No wgmma is in flight
//   across a loop's back edge and none follows a branch or a wait loop
//   after its fence: ptxas serializes the wgmmas otherwise.  The per-lane
//   statistics are those of the mma.sync kernel this replaces (each
//   tile's 16 values a row reduced as trees), as are the quad merge and the
//   masks (only a tile that reaches valid_len or L is masked).
//
// Nothing here allocates: the callers pass every buffer.

#pragma once

#include "gemm_sm90.cuh"

namespace {

constexpr int SHORT_ATT_LEN = 16 * 16;   // the register kernels' reach
// DH ** -0.5 * log2(e): scores to the log2 domain of the key-tiled kernels
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

namespace katt {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int ROWS = 64;                  // rows a consumer, rows a tile
constexpr int TILE = ROWS * DH * 2;       // a 64 x 64 bf16 tile, 8 KB
constexpr int STAGES = 8;
// consumer warpgroups a block: the forward three (its registers fit the
// 128 a thread that 416 threads leave), the backward two (168 a thread)
constexpr int FWD_CONS = 3, BWD_CONS = 2;
// and a producer warp
constexpr int threads(int consumers) { return 128 * consumers + 32; }

static_assert(DH * 2 == 128, "a head row is one 128-byte swizzle span");

// N stages with full and empty mbarriers, used in sequence: use n lives in
// stage n % N.  The producer acquires a stage for use n (use n - N
// released) and arms its full barrier; consumers wait for use n's data and
// release it (lane 0 of each consumer warp).
template <int N>
struct Ring {
  uint32_t full, empty;   // shared addresses of N mbarriers each

  __device__ Ring(uint64_t* bars)
      : full(smem_u32(bars)), empty(smem_u32(bars + N)) {}
  __device__ void init(int consumers) const {
    for (int s = 0; s < N; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * consumers);
    }
  }
  __device__ uint32_t bar(int n) const { return full + 8 * (n % N); }
  __device__ void acquire(int n) const {
    if (n >= N) mbar_wait(empty + 8 * (n % N), (n / N - 1) & 1);
  }
  __device__ void wait(int n) const {
    mbar_wait(full + 8 * (n % N), (n / N) & 1);
  }
  __device__ void release(int n) const { mbar_arrive(empty + 8 * (n % N)); }
};

// The producer warp's lane 0 (the block's last warp) issues the block's
// loads in order (a block without it may hold 255 registers a thread, but
// loads issued by a consumer warp between its own products were slower on
// the card than the register pressure this warp costs):
// for its k-th unit, head(k, bar) loads the unit's own tiles (one per
// consumer) into head buffer k % 2, then use(k, i, n, bar) the unit's
// `per` ring uses (n counts them over the units), each once its stage is
// released.
template <class Head, class Use>
__device__ __forceinline__ void produce(const Ring<STAGES>& ring,
                                        const Ring<2>& heads, int per,
                                        int units, Head head, Use use) {
  int n = 0, k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    heads.acquire(k);
    head(k, heads.bar(k));
    for (int i = 0; i < per; ++i, ++n) {
      ring.acquire(n);
      use(k, i, n, ring.bar(n));
    }
  }
}

// A box (c0, c1, c2) of a 3-D tensor map into shared memory, completion
// counted on `bar` in bytes (a box past the tensor counts in full: TMA
// fills the rest with zeros).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Descriptors of a 64 x 64 bf16 tile (rows of 128 bytes, 128-byte swizzle)
// at its k16 step kk: K-major (the contraction runs along the row) or
// MN-major (down the rows; the instruction's transpose bit set).
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return sm90::operand_desc<false>(tile, kk);
}
__device__ __forceinline__ uint64_t mdesc(uint32_t tile, int kk) {
  return sm90::operand_desc<true>(tile, kk);
}

// d (64 x 64 f32) (+)= A (64 x 16) @ B (16 x 64), A and B K-major in
// shared memory; acc = 0 overwrites d.  Fragment as wgmma_192: register 4j
// + 2h + e of thread t holds row 16 (t / 32) + (t % 32) / 4 + 8h, column
// 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A (64 x 16, bf16 pairs in registers: the m16n8k16 A fragment of
// each warp's 16 rows) @ B (16 x 64) from shared memory (TB: transpose);
// acc = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// acc = A @ B over the 64-deep contraction of two K-major tiles.
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(d, kdesc(a, kk), kdesc(b, kk), kk);
}

// acc = A @ B^T, A (64 x 64) as four bf16 A fragments in registers, B a
// 64 x 64 tile read K-major (S = Q K^T with Q in registers).
__device__ __forceinline__ void product_rk(float (&d)[32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_rs<0>(d, a[kk], kdesc(b, kk), kk);
}

// The A fragments of warp w's 16 rows of a 64 x 64 bf16 tile in shared
// memory (at `tile`, rows of 128 bytes in the 128-byte swizzle: 16-byte
// chunk c of row r at chunk c ^ (r % 8)), for its four k16 steps.
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4],
                                           const unsigned char* tile,
                                           int warp, int lane) {
  const int r = 16 * warp + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], reinterpret_cast<const bf16*>(
                           tile + r * 128 +
                           (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4)));
}

// acc += P @ B, P (64 x 64) as four bf16 A fragments in registers, B a
// 64 x 64 tile read MN-major.
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&p)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < ROWS / 16; ++kc) wgmma_rs<1>(d, p[kc], mdesc(b, kc));
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// The bf16 A fragments (key steps kc = 0..3) of a 64 x 64 f32 accumulator:
// rows g, g + 8, keys 16 kc + 2 (t % 4) + {0, 1} and + 8.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&v)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kc][i] = pack_bf16(v[8 * kc + 2 * i], v[8 * kc + 2 * i + 1]);
}

// The scores of an accumulator (q . k, rows g and g + 8, keys k0 + 8j +
// 2 (t % 4) + e) in the log2 domain, t = q . k dh^-0.5 log2 e, masked past
// valid_len (-1e30) and past L (-inf) unless `full` says no key of the
// tile is either.
__device__ __forceinline__ void log2_scores(float (&s)[32], int k0, int tq,
                                            bool full, int L, int valid_len) {
  if (full) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= kScaleLog2;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * tq + e;
      const float add = col >= valid_len ? kNegInf : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[4 * j + 2 * h + e] =
            col >= L ? -INFINITY : s[4 * j + 2 * h + e] * kScaleLog2 + add;
    }
}

// The 16 values of row h (0: g, 1: g + 8) of a 64 x 64 accumulator.
__device__ __forceinline__ void row_values(float (&v)[16], const float (&a)[32],
                                           int h) {
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = a[4 * (i / 2) + 2 * h + i % 2];
}

// Max and sum of 16 values as balanced trees (4 dependent steps, not 15).
__device__ __forceinline__ float tree_max(float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], v[i + 4]);
  return fmaxf(fmaxf(v[0], v[2]), fmaxf(v[1], v[3]));
}
__device__ __forceinline__ float tree_sum(float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] += v[i + 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] += v[i + 4];
  return (v[0] + v[2]) + (v[1] + v[3]);
}

// One tile into this lane's running max m and sum l of exp(s - m) of its
// two rows (and, with dp, d = sum exp(s - m) dp): each row's 16 values of
// the tile reduced as trees, then merged into the running values.
template <bool DP>
__device__ __forceinline__ void lane_stats(const float (&s)[32],
                                           const float (&dp)[32],
                                           float (&m)[2], float (&l)[2],
                                           float (&d)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[16], p[16];
    row_values(v, s, r);
    const float mx = fmaxf(m[r], tree_max(v));
    if (mx == -INFINITY) continue;   // no key of this lane yet
    const float alpha = m[r] == -INFINITY ? 0.f : ex2(m[r] - mx);
    row_values(p, s, r);
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = ex2(p[i] - mx);
    if (DP) {
      row_values(v, dp, r);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] *= p[i];
      d[r] = d[r] * alpha + tree_sum(v);
    }
    l[r] = l[r] * alpha + tree_sum(p);
    m[r] = mx;
  }
}

// The quad's four lanes of each row merged: m the row max, l the sum, d
// the sum of exp(s - m) dp.
__device__ __forceinline__ void quad_merge(float (&m)[2], float (&l)[2],
                                           float (&d)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mq = m[r];
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    const float a = m[r] == -INFINITY ? 0.f : ex2(m[r] - mq);
    float lq = l[r] * a, dq = d[r] * a;
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    dq += __shfl_xor_sync(0xffffffffu, dq, 1);
    dq += __shfl_xor_sync(0xffffffffu, dq, 2);
    m[r] = mq;
    l[r] = lq;
    d[r] = dq;
  }
}

// Tensor map of a 3-D array (d0 contiguous, d1 rows s1 bytes apart, d2
// planes s2 bytes apart) read in (box0, 64, 1) boxes: bf16 with the
// 128-byte swizzle (box0 = 64), or f32 unswizzled.  Elements past an edge
// read as zeros.
inline bool make_map_3d(CUtensorMap* map, const void* ptr, bool f32, int d0,
                        int d1, int d2, size_t s1, size_t s2, int box0) {
  const sm90::EncodeTiledFn encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)ROWS, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// qkv (B*L, 3D) as (3D, L, B), or dctx (B*L, D) as (D, L, B).
inline bool make_rows_map(CUtensorMap* map, const bf16* ptr, int cols, int L,
                          int B) {
  return sm90::aligned16({ptr}) &&
         make_map_3d(map, ptr, false, cols, L, B, (size_t)cols * 2,
                     (size_t)L * cols * 2, DH);
}

// Blocks of a persistent launch: one an SM, at most `units`.
inline int persistent_grid(int units) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return units < sms ? units : sms;
}

// A unit: (image b, head h, the pair-th group of consumers' 64-row tiles),
// consecutive units in one head.
struct Unit {
  int b, h, pair;
  __device__ Unit(int u, int pairs, int heads)
      : b(u / (pairs * heads)), h((u / pairs) % heads), pair(u % pairs) {}
};

}  // namespace katt

// ---------------------------------------------------------------------------
// The forward past 256 tokens.  qkv: (B*L, 3D) rows [q heads | k heads | v
// heads] (map_qkv, 3-D); ctx: (B*L, D).
// ---------------------------------------------------------------------------
constexpr int KATT_FWD_SMEM =
    2 * katt::FWD_CONS * katt::TILE + katt::STAGES * 2 * katt::TILE + 1024;

__global__ void __launch_bounds__(katt::threads(katt::FWD_CONS), 1)
    long_attention_sm90_kernel(const __grid_constant__ CUtensorMap map_qkv,
                               bf16* __restrict__ ctx, int B, int L, int D,
                               int heads, int valid_len) {
  using namespace katt;
  constexpr int CONS = FWD_CONS;
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 4];
  extern __shared__ __align__(1024) unsigned char katt_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_u32(katt_smem) + 1023) & ~1023u;
  const uint32_t qbuf = base;                          // [2][CONS] Q tiles
  const uint32_t kv = base + 2 * CONS * TILE;          // [STAGES] K, V
  const Ring<STAGES> ring(bars);
  const Ring<2> qring(bars + 2 * STAGES);
  const int nt = (L + ROWS - 1) / ROWS;                // key and query tiles
  const int pairs = (nt + CONS - 1) / CONS;
  const int units = B * heads * pairs;
  if (threadIdx.x == 0) {
    ring.init(CONS);
    qring.init(CONS);
    // the initialized barriers must be visible to the TMA (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // the producer warp: a unit's Q tiles, then its K tiles (sweep 1) and K
  // and V tiles (sweep 2)
  if (threadIdx.x >= 128 * CONS) {
    if (threadIdx.x != 128 * CONS) return;
    produce(
        ring, qring, 2 * nt, units,
        [&](int k, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          mbar_expect_tx(bar, CONS * TILE);
          for (int c = 0; c < CONS; ++c)
            tma_load_3d(qbuf + ((k & 1) * CONS + c) * TILE, &map_qkv,
                        w.h * DH, (w.pair * CONS + c) * ROWS, w.b, bar);
        },
        [&](int k, int i, int n, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          const uint32_t st = kv + (n % STAGES) * 2 * TILE;
          const int k0 = (i % nt) * ROWS;
          mbar_expect_tx(bar, (i < nt ? 1 : 2) * TILE);
          tma_load_3d(st, &map_qkv, D + w.h * DH, k0, w.b, bar);
          if (i >= nt)
            tma_load_3d(st + TILE, &map_qkv, 2 * D + w.h * DH, k0, w.b, bar);
        });
    return;
  }
  // Every wgmma batch follows its waits and a fence, with no branch or
  // loop in between, and none is in flight across an iteration's end;
  // within an iteration a tile's exponentials run while the tensor cores
  // work on another tile.
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  int use = 0, it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it, use += 2 * nt) {
    const Unit w(u, pairs, heads);
    const int q0 = (w.pair * CONS + c) * ROWS;
    qring.wait(it);
    if (q0 >= L) {   // no tile of this consumer in the unit: keep pace
      for (int i = 0; i < 2 * nt; ++i) {
        ring.wait(use + i);
        if (lane == 0) ring.release(use + i);
      }
      if (lane == 0) qring.release(it);
      continue;
    }
    // Q as the A operand of S in registers (only K streams from shared
    // memory through the S products)
    uint32_t qa[4][4];
    load_frags(qa, katt_smem + (qbuf - smem_u32(katt_smem)) +
                       ((it & 1) * CONS + c) * TILE,
               warp, lane);
    if (lane == 0) qring.release(it);
    auto ktile = [&](int n) { return kv + (n % STAGES) * 2 * TILE; };

    // sweep 1, two key tiles an iteration (the second's S runs during the
    // first's statistics): per lane m, l
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    float sa[32], sb[32];
    auto stats = [&](float(&s)[32], int j) {
      sm90::fence_acc(s);
      if (lane == 0) ring.release(use + j);
      log2_scores(s, j * ROWS, tq, (j + 1) * ROWS <= valid_len, L,
                  valid_len);
      lane_stats<false>(s, s, m, l, d);
    };
    int j = 0;
    for (; j + 1 < nt; j += 2) {
      ring.wait(use + j);
      ring.wait(use + j + 1);
      sm90::wgmma_fence();
      product_rk(sa, qa, ktile(use + j));
      sm90::wgmma_commit();
      product_rk(sb, qa, ktile(use + j + 1));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      stats(sa, j);
      sm90::wgmma_wait<0>();
      stats(sb, j + 1);
    }
    if (j < nt) {
      ring.wait(use + j);
      sm90::wgmma_fence();
      product_rk(sa, qa, ktile(use + j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      stats(sa, j);
    }
    quad_merge(m, l, d);
    l[0] = 1.f / l[0];
    l[1] = 1.f / l[1];

    // sweep 2: tile j's S issued with tile j - 1's ctx += pb v; p = exp(s
    // - m) / l of tile j while the latter runs
    const int u2 = use + nt;
    float o[32];
    uint32_t pa[4][4];
    auto probs = [&](int j) {   // sa: tile j's S -> p, packed
      sm90::fence_acc(sa);
      log2_scores(sa, j * ROWS, tq, (j + 1) * ROWS <= valid_len, L,
                  valid_len);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sa[i] = ex2(sa[i] - m[(i / 2) % 2]) * l[(i / 2) % 2];
    };
    zero(o);
    ring.wait(u2);
    sm90::wgmma_fence();
    product_rk(sa, qa, ktile(u2));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    probs(0);
    pack_frags(pa, sa);
    for (j = 1; j < nt; ++j) {
      ring.wait(u2 + j);
      sm90::wgmma_fence();
      product_rk(sa, qa, ktile(u2 + j));
      sm90::wgmma_commit();
      product_rs(o, pa, ktile(u2 + j - 1) + TILE);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      probs(j);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(o);
      if (lane == 0) ring.release(u2 + j - 1);
      pack_frags(pa, sa);
    }
    sm90::wgmma_fence();
    product_rs(o, pa, ktile(u2 + nt - 1) + TILE);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(o);
    if (lane == 0) ring.release(u2 + nt - 1);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * warp + g + 8 * h;
      if (row >= L) continue;
      bf16* out = ctx + ((size_t)w.b * L + row) * D + w.h * DH + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
            __floats2bfloat162_rn(o[4 * jj + 2 * h], o[4 * jj + 2 * h + 1]);
    }
  }
}

inline cudaError_t launch_long_attention(const bf16* qkv, bf16* ctx, int B,
                                         int L, int D, int heads,
                                         int valid_len, cudaStream_t stream) {
  CUtensorMap map;
  if (!katt::make_rows_map(&map, qkv, 3 * D, L, B))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      long_attention_sm90_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, KATT_FWD_SMEM);
  if (e != cudaSuccess) return e;
  const int groups = ((L + katt::ROWS - 1) / katt::ROWS + katt::FWD_CONS -
                      1) / katt::FWD_CONS;
  const int grid = katt::persistent_grid(B * heads * groups);
  if (grid < 1) return cudaErrorInvalidValue;
  long_attention_sm90_kernel<<<grid, katt::threads(katt::FWD_CONS),
                               KATT_FWD_SMEM, stream>>>(
      map, ctx, B, L, D, heads, valid_len);
  return cudaGetLastError();
}

// Up to 256 tokens the register kernel, past them the key-tiled one.
inline cudaError_t attention(const bf16* qkv, bf16* ctx, int B, int L, int D,
                             int heads, int valid_len, cudaStream_t stream) {
  if (L > SHORT_ATT_LEN)
    return launch_long_attention(qkv, ctx, B, L, D, heads, valid_len,
                                 stream);
  switch ((L + 15) / 16) {
#define SAIS_ATT_CASE(kt) \
  case kt:                \
    return launch_attention<kt>(qkv, ctx, B, L, D, heads, valid_len, stream);
    SAIS_ATT_CASE(1) SAIS_ATT_CASE(2) SAIS_ATT_CASE(3) SAIS_ATT_CASE(4)
    SAIS_ATT_CASE(5) SAIS_ATT_CASE(6) SAIS_ATT_CASE(7) SAIS_ATT_CASE(8)
    SAIS_ATT_CASE(9) SAIS_ATT_CASE(10) SAIS_ATT_CASE(11) SAIS_ATT_CASE(12)
    SAIS_ATT_CASE(13) SAIS_ATT_CASE(14) SAIS_ATT_CASE(15) SAIS_ATT_CASE(16)
#undef SAIS_ATT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
