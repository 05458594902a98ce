// Device code shared by the ViT-block kernels (K1 and K4 in
// fused_vit_block.cu, K5 in fused_block_bwd_mlp.cu, K6 in
// fused_block_bwd_attn.cu, K8 in fused_vit_block_int8.cu) and K7
// (dino_head_loss.cu, through gemm_sm90.cuh), for Hopper (sm_90a).
//
// - LayerNorm forward in f32 rounded to bf16 (K1, K4);
// - the row passes of the training backward (K5, K6): a prologue that
//   recomputes the LayerNorm, saving each row's mean and 1/std, and scales
//   the branch cotangent, and the LayerNorm backward; both also write
//   fixed-order partial column sums;
// - mma.sync m16n8k16 building blocks (ldmatrix fragments, cp.async) for
//   the register attention kernels (every other product runs on the wgmma
//   + TMA GEMM of gemm_sm90.cuh);
// - K1's masked softmax attention, bf16 in and out (K1, K4 and K8 run it)
//   up to 256 tokens per (image, head), each query's score row in
//   registers (past 256 tokens attention_sm90.cuh's key-tiled kernel);
// - fixed-order sums of partials: every weight, bias and LayerNorm gradient
//   is reduced over the B*L rows (and K7's dh_s over out_dim) without
//   atomics and without read-modify-write across blocks, so results do not
//   depend on the order blocks run in.
//
// Nothing here allocates: the callers pass every buffer.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;   // the JAX kernels' additive key mask
constexpr int DH = 64;              // head dim the attention kernels take

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm in f32, rounded to bf16.  One warp per row.
// ---------------------------------------------------------------------------
__global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                  const bf16* __restrict__ scale,
                                  const bf16* __restrict__ bias,
                                  bf16* __restrict__ y, int rows, int d,
                                  float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += __bfloat162float(xr[c]);
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = __bfloat162float(xr[c]) - mean;
    sq += t * t;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
  bf16* yr = y + (size_t)row * d;
  for (int c = lane; c < d; c += 32) {
    const float v = (__bfloat162float(xr[c]) - mean) * rstd *
                        __bfloat162float(scale[c]) +
                    __bfloat162float(bias[c]);
    yr[c] = __float2bfloat16(v);
  }
}

cudaError_t layer_norm(const bf16* x, const bf16* s, const bf16* b, bf16* y,
                       int rows, int d, float eps, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, threads,
                      0, stream>>>(x, s, b, y, rows, d, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row passes of the training backward (K5, K6).  A block of ROW_WARPS warps
// takes a chunk of ROW_CHUNK rows, each warp ROW_CHUNK / ROW_WARPS of them
// in turn; lane l owns columns l + 32 i, i < CPL = D / 32, and loads all of
// a row's values at once into registers.  Column sums over the chunk stay
// in each lane's registers, then are summed over the warps in warp order
// into one partial row a chunk, which sum_parts adds up in chunk order: no
// atomics, results independent of block order.
// ---------------------------------------------------------------------------
constexpr int ROW_WARPS = 8, ROW_CHUNK = 32;
constexpr int MAX_BWD_DIM = 768;   // ViT-B; a lane keeps D / 32 values a row

inline int row_chunks(int rows) { return (rows + ROW_CHUNK - 1) / ROW_CHUNK; }

// partial[c] = sum over the block's warps, in warp order, of their acc.
template <int CPL>
__device__ __forceinline__ void chunk_sum(const float (&acc)[CPL], float* red,
                                          float* partial) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();   // red is free
#pragma unroll
  for (int i = 0; i < CPL; ++i) red[warp * 32 * CPL + lane + 32 * i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < 32 * CPL; c += 32 * ROW_WARPS) {
    float s = 0.f;
    for (int w = 0; w < ROW_WARPS; ++w) s += red[w * 32 * CPL + c];
    partial[c] = s;
  }
}

// The backward's row prologue, one pass over x and the branch cotangent g:
// y = bf16(LN(x)) with each row's mean and 1/std saved (LN in f32, as
// layer_norm_kernel computes it); gs = bf16(g * s[row]) when s is given
// (JAX `dout * s2_ref`, a bf16 product; otherwise the branch sees g itself
// and gs is not written); partial[chunk] = the chunk's column sums of the
// branch cotangent (db2 in K5, dbproj in K6).
template <int CPL>
__global__ void __launch_bounds__(32 * ROW_WARPS)
    bwd_prep_kernel(const bf16* __restrict__ x,
                    const bf16* __restrict__ ln_s,
                    const bf16* __restrict__ ln_b,
                    const bf16* __restrict__ g, const bf16* __restrict__ s,
                    bf16* __restrict__ y, float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, bf16* __restrict__ gs,
                    float* __restrict__ partial, int rows, float eps) {
  constexpr int D = 32 * CPL;
  __shared__ float red[ROW_WARPS * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[CPL], bi[CPL], acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    sc[i] = __bfloat162float(ln_s[lane + 32 * i]);
    bi[i] = __bfloat162float(ln_b[lane + 32 * i]);
    acc[i] = 0.f;
  }
  const int r0 = blockIdx.x * ROW_CHUNK + warp * (ROW_CHUNK / ROW_WARPS);
  for (int row = r0; row < min(rows, r0 + ROW_CHUNK / ROW_WARPS); ++row) {
    const size_t base = (size_t)row * D + lane;
    float xv[CPL];
    bf16 gv[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      xv[i] = __bfloat162float(x[base + 32 * i]);
      gv[i] = g[base + 32 * i];
    }
    const float rs = s != nullptr ? __bfloat162float(s[row]) : 1.f;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) sum += xv[i];
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) sq += (xv[i] - mean) * (xv[i] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      y[base + 32 * i] =
          __float2bfloat16((xv[i] - mean) * rstd * sc[i] + bi[i]);
      bf16 v = gv[i];
      if (s != nullptr) {
        v = __float2bfloat16(__bfloat162float(v) * rs);
        gs[base + 32 * i] = v;
      }
      acc[i] += __bfloat162float(v);
    }
  }
  chunk_sum<CPL>(acc, red, partial + (size_t)blockIdx.x * D);
}

// LayerNorm backward of y = xhat * scale + bias for upstream dy (f32), plus
// a residual cotangent: dx = bf16(rstd (dxh - mean(dxh) - xhat
// mean(dxh xhat)) + f32(resid)) with dxh = dy * scale (JAX `_ln_bwd`);
// partial_b, partial_s[chunk] = the chunk's column sums of dy and of
// dy * xhat (the LayerNorm's bias and scale gradients).
template <int CPL>
__global__ void __launch_bounds__(32 * ROW_WARPS)
    ln_bwd_kernel(const float* __restrict__ dy, const bf16* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const bf16* __restrict__ scale,
                  const bf16* __restrict__ resid, bf16* __restrict__ dx,
                  float* __restrict__ partial_b,
                  float* __restrict__ partial_s, int rows) {
  constexpr int D = 32 * CPL;
  __shared__ float red[ROW_WARPS * D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[CPL], acc_b[CPL], acc_s[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    sc[i] = __bfloat162float(scale[lane + 32 * i]);
    acc_b[i] = acc_s[i] = 0.f;
  }
  const int r0 = blockIdx.x * ROW_CHUNK + warp * (ROW_CHUNK / ROW_WARPS);
  for (int row = r0; row < min(rows, r0 + ROW_CHUNK / ROW_WARPS); ++row) {
    const size_t base = (size_t)row * D + lane;
    float gv[CPL], xh[CPL];
    bf16 rv[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      gv[i] = dy[base + 32 * i];
      xh[i] = __bfloat162float(x[base + 32 * i]);
      rv[i] = resid[base + 32 * i];
    }
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      xh[i] = (xh[i] - mu) * rs;
      const float dxh = gv[i] * sc[i];
      s1 += dxh;
      s2 += dxh * xh[i];
      acc_b[i] += gv[i];
      acc_s[i] += gv[i] * xh[i];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      dx[base + 32 * i] = __float2bfloat16(
          rs * (gv[i] * sc[i] - m1 - xh[i] * m2) + __bfloat162float(rv[i]));
  }
  chunk_sum<CPL>(acc_b, red, partial_b + (size_t)blockIdx.x * D);
  chunk_sum<CPL>(acc_s, red, partial_s + (size_t)blockIdx.x * D);
}

// The row passes for D = 32 CPL, D a multiple of 64 up to MAX_BWD_DIM.
#define SAIS_ROW_CASES(X)                                                  \
  X(2) X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(18) X(20) X(22) X(24)
static_assert(MAX_BWD_DIM == 24 * 32, "SAIS_ROW_CASES covers MAX_BWD_DIM");

cudaError_t bwd_prep(const bf16* x, const bf16* ln_s, const bf16* ln_b,
                     const bf16* g, const bf16* s, bf16* y, float* mean,
                     float* rstd, bf16* gs, float* partial, int rows, int d,
                     float eps, cudaStream_t stream) {
  if (d % 64 != 0) return cudaErrorInvalidValue;
  switch (d / 32) {
#define SAIS_PREP_CASE(cpl)                                                \
  case cpl:                                                                \
    bwd_prep_kernel<cpl><<<row_chunks(rows), 32 * ROW_WARPS, 0, stream>>>( \
        x, ln_s, ln_b, g, s, y, mean, rstd, gs, partial, rows, eps);       \
    return cudaGetLastError();
    SAIS_ROW_CASES(SAIS_PREP_CASE)
#undef SAIS_PREP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t ln_bwd(const float* dy, const bf16* x, const float* mean,
                   const float* rstd, const bf16* scale, const bf16* resid,
                   bf16* dx, float* partial_b, float* partial_s, int rows,
                   int d, cudaStream_t stream) {
  if (d % 64 != 0) return cudaErrorInvalidValue;
  switch (d / 32) {
#define SAIS_LN_BWD_CASE(cpl)                                              \
  case cpl:                                                                \
    ln_bwd_kernel<cpl><<<row_chunks(rows), 32 * ROW_WARPS, 0, stream>>>(   \
        dy, x, mean, rstd, scale, resid, dx, partial_b, partial_s, rows);  \
    return cudaGetLastError();
    SAIS_ROW_CASES(SAIS_LN_BWD_CASE)
#undef SAIS_LN_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Fixed-order sums of partials.
// ---------------------------------------------------------------------------

// Up to six sums of partials in one launch (every weight, bias and
// LayerNorm gradient of one K5 or K6 call): out[i] = sum_p part[p][i] for
// each segment, in a fixed order.  A block of 256 threads takes 256 / G
// consecutive outputs of one segment; G groups of threads each sum a
// contiguous run of the parts in order, then one thread a column sums the
// groups in order.  G = 1 for a split weight gradient (a few parts, many
// outputs); G = 32 for a column sum (hundreds of parts, few outputs), so
// that its long sums run in parallel.
struct PartSum {
  const float* part;   // (parts, n)
  float* out;          // (n,)
  int n, parts;
  int groups, block0;  // set by sum_parts
};
constexpr int MAX_PART_SUMS = 6, SUM_THREADS = 256;
struct PartSums {
  PartSum s[MAX_PART_SUMS];
  int count;
};

__global__ void __launch_bounds__(SUM_THREADS) sum_parts_kernel(PartSums a) {
  __shared__ float red[SUM_THREADS];
  int k = 0;
  while (k + 1 < a.count && (int)blockIdx.x >= a.s[k + 1].block0) ++k;
  const PartSum& s = a.s[k];
  const int cols = SUM_THREADS / s.groups;
  const int col = ((int)blockIdx.x - s.block0) * cols + threadIdx.x % cols;
  const int grp = threadIdx.x / cols;
  const int per = (s.parts + s.groups - 1) / s.groups;
  float acc = 0.f;
  if (col < s.n)
    for (int p = grp * per; p < min(s.parts, (grp + 1) * per); ++p)
      acc += s.part[(size_t)p * s.n + col];
  if (s.groups == 1) {
    if (col < s.n) s.out[col] = acc;
    return;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (grp == 0 && col < s.n) {
    float t = 0.f;
    for (int g = 0; g < s.groups; ++g) t += red[g * cols + threadIdx.x];
    s.out[col] = t;
  }
}

cudaError_t sum_parts(PartSums a, cudaStream_t stream) {
  int blocks = 0;
  for (int k = 0; k < a.count; ++k) {
    a.s[k].groups = a.s[k].parts >= 64 ? 32 : 1;
    a.s[k].block0 = blocks;
    const int cols = SUM_THREADS / a.s[k].groups;
    blocks += (a.s[k].n + cols - 1) / cols;
  }
  sum_parts_kernel<<<blocks, SUM_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks: mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with fragments loaded from shared memory by ldmatrix.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8.  Without .trans, lane (g, t) = (lane / 4, lane % 4) receives
// elements [g][2t, 2t+1] of each matrix; with .trans, [2t, 2t+1][g].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// B fragments of two adjacent n8 tiles from a row-major (k, n) tile (K1's
// attention; K6 has swizzled variants):
// b[0..1] for columns 0..7, b[2..3] for columns 8..15.
__device__ __forceinline__ void load_b_frags_kn(uint32_t* b, const bf16* tile,
                                                int ld, int lane) {
  ldmatrix_x4_trans(b, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// The same from a row-major (n, k) tile, i.e. B stored column by column.
__device__ __forceinline__ void load_b_frags_nk(uint32_t* b, const bf16* tile,
                                                int ld, int lane) {
  ldmatrix_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                     ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;   // 0 source bytes: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
  return v * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                  (v + 0.044715f * (v * v * v)))));
}

// d gelu_tanh / dh, as JAX `_gelu_tanh_and_grad` writes it.
__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (h + a * (h * h * h)));
  return 0.5f * (1.f + t) +
         0.5f * h * (1.f - t * t) * c * (1.f + 3.f * a * (h * h));
}

// ---------------------------------------------------------------------------
// Masked softmax attention for head dim 64.  A block of 4 warps takes every
// query of one (image, head), whose K and V are loaded once into shared
// memory.  A warp holds the scores of 16 queries against all 16*KT keys in
// registers.
// ---------------------------------------------------------------------------
constexpr int ATT_THREADS = 128;
constexpr int ATT_LD = DH + 8;   // padded smem rows: ldmatrix without conflicts

template <int KT>
constexpr size_t attention_smem() {
  return 2 * (size_t)(16 * KT) * ATT_LD * sizeof(bf16);
}

// qkv: (B*L, 3D) rows laid out [q heads | k heads | v heads]; ctx: (B*L, D).
template <int KT>
__global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx,
                     int L, int D, int valid_len) {
  constexpr int LK = 16 * KT;     // keys, padded to the mma k tile
  constexpr int NT = 2 * KT;      // n8 score tiles per query row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // (LK, ATT_LD) row-major
  bf16* Vs = Ks + LK * ATT_LD;                    // (LK, ATT_LD) row-major

  const int b = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * row_stride;

  // K and V of this (image, head) into shared memory; rows past L are
  // zero-filled (p = 0 there, and 0 * 0 stays 0).
  for (int i = tid; i < LK * (DH / 8); i += ATT_THREADS) {
    const int j = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bf16* src = base + (size_t)(j < L ? j : 0) * row_stride + h * DH + c;
    cp_async16(Ks + j * ATT_LD + c, src + D, j < L);
    cp_async16(Vs + j * ATT_LD + c, src + 2 * D, j < L);
  }
  cp_async_commit();

  cp_async_wait<0>();
  __syncthreads();

  // Warp w takes the 16-row query tiles w, w + 4, ...
  for (int qt = warp; qt < (L + 15) / 16; qt += ATT_THREADS / 32) {
    const int q0 = qt * 16;
    const int r0 = q0 + g, r1 = q0 + g + 8;
    const bf16* qr0 = base + (size_t)r0 * row_stride + h * DH;
    const bf16* qr1 = base + (size_t)r1 * row_stride + h * DH;

    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kq = 0; kq < DH / 16; ++kq) {
      const int c = kq * 16 + 2 * t;
      qa[kq][0] = r0 < L ? ld_u32(qr0 + c) : 0u;
      qa[kq][1] = r1 < L ? ld_u32(qr1 + c) : 0u;
      qa[kq][2] = r0 < L ? ld_u32(qr0 + c + 8) : 0u;
      qa[kq][3] = r1 < L ? ld_u32(qr1 + c + 8) : 0u;
    }

    // S = Q K^T.  s[j][0..1]: row g, keys 8j+2t, 8j+2t+1; s[j][2..3]: row g+8.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        uint32_t kb[4];
        load_b_frags_nk(kb, Ks + j * 8 * ATT_LD + kq * 16, ATT_LD, lane);
        mma_bf16_16816(s[j], qa[kq], kb[0], kb[1]);
        mma_bf16_16816(s[j + 1], qa[kq], kb[2], kb[3]);
      }
    }

    // scale (a power of two: the same as scaling q first), mask, f32 softmax
    const float scale = 0.125f;   // DH ** -0.5
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const float add = col >= valid_len ? kNegInf : 0.f;
        float v0 = s[j][e] * scale + add;
        float v1 = s[j][2 + e] * scale + add;
        if (col >= L) v0 = v1 = -INFINITY;   // tile padding: no key at all
        s[j][e] = v0;
        s[j][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mx0);
        s[j][2 + e] = expf(s[j][2 + e] - mx1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

    // ctx = bf16(P) @ V: the score accumulators of key tile kt are exactly the
    // A fragment of the next mma once normalized and packed to bf16.
    float o[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0] / sum0, s[2 * kt][1] / sum0);
      pa[1] = pack_bf16(s[2 * kt][2] / sum1, s[2 * kt][3] / sum1);
      pa[2] = pack_bf16(s[2 * kt + 1][0] / sum0, s[2 * kt + 1][1] / sum0);
      pa[3] = pack_bf16(s[2 * kt + 1][2] / sum1, s[2 * kt + 1][3] / sum1);
#pragma unroll
      for (int nd = 0; nd < DH / 8; nd += 2) {
        uint32_t vb[4];
        load_b_frags_kn(vb, Vs + kt * 16 * ATT_LD + nd * 8, ATT_LD, lane);
        mma_bf16_16816(o[nd], pa, vb[0], vb[1]);
        mma_bf16_16816(o[nd + 1], pa, vb[2], vb[3]);
      }
    }

    bf16* out0 = ctx + ((size_t)b * L + r0) * D + h * DH;
    bf16* out1 = ctx + ((size_t)b * L + r1) * D + h * DH;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (r0 < L)
        *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
            __floats2bfloat162_rn(o[nd][0], o[nd][1]);
      if (r1 < L)
        *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
            __floats2bfloat162_rn(o[nd][2], o[nd][3]);
    }
  }
}

template <int KT>
cudaError_t launch_attention(const bf16* qkv, bf16* ctx, int B, int L, int D,
                             int heads, int valid_len, cudaStream_t stream) {
  constexpr size_t smem = attention_smem<KT>();
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(heads, B);
  attention_kernel<KT><<<grid, ATT_THREADS, smem, stream>>>(qkv, ctx, L, D,
                                                            valid_len);
  return cudaGetLastError();
}

}  // namespace
