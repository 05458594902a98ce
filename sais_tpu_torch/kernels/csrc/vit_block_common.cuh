// Device code shared by the ViT-block kernels (K1 and K4 in
// fused_vit_block.cu, K5 in fused_block_bwd_mlp.cu, K6 in
// fused_block_bwd_attn.cu, K8 in fused_vit_block_int8.cu) and K7
// (dino_head_loss.cu), for Hopper (sm_90a).
//
// - LayerNorm forward in f32 rounded to bf16 (optionally saving each row's
//   mean and 1/std) and its backward;
// - one tensor-core GEMM template: mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with ldmatrix fragments, 128 x 128 x 64 block tiles in a
//   3-stage cp.async ring, either operand read transposed, optional split
//   of K over blockIdx.z (each split writes its own f32 partial), and
//   epilogues on the accumulators that keep the JAX kernels' rounding
//   points;
// - K1's masked softmax attention per (image, head), bf16 in and out, each
//   query's score row in registers (K1, K4 and K8 run it);
// - fixed-order column sums and split reductions: every weight, bias and
//   LayerNorm gradient is reduced over the B*L rows without atomics and
//   without read-modify-write across blocks, so results do not depend on
//   the order blocks run in.
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
// LayerNorm in f32, rounded to bf16.  One warp per row.  With `mean` and
// `rstd` given, each row's statistics are saved for the backward.
// ---------------------------------------------------------------------------
__global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                  const bf16* __restrict__ scale,
                                  const bf16* __restrict__ bias,
                                  bf16* __restrict__ y,
                                  float* __restrict__ mean_out,
                                  float* __restrict__ rstd_out, int rows,
                                  int d, float eps) {
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
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  bf16* yr = y + (size_t)row * d;
  for (int c = lane; c < d; c += 32) {
    const float v = (__bfloat162float(xr[c]) - mean) * rstd *
                        __bfloat162float(scale[c]) +
                    __bfloat162float(bias[c]);
    yr[c] = __float2bfloat16(v);
  }
}

cudaError_t layer_norm(const bf16* x, const bf16* s, const bf16* b, bf16* y,
                       float* mean, float* rstd, int rows, int d, float eps,
                       cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, threads,
                      0, stream>>>(x, s, b, y, mean, rstd, rows, d, eps);
  return cudaGetLastError();
}

// LayerNorm backward of y = xhat * scale + bias for upstream dy (f32), plus
// a residual cotangent: dx = bf16(rstd (dxh - mean(dxh) - xhat
// mean(dxh xhat)) + f32(resid)) with dxh = dy * scale (JAX `_ln_bwd`).
// One warp per row.
__global__ void ln_bwd_kernel(const float* __restrict__ dy,
                              const bf16* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const bf16* __restrict__ scale,
                              const bf16* __restrict__ resid,
                              bf16* __restrict__ dx, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  const float mu = mean[row], rs = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xhat = (__bfloat162float(x[base + c]) - mu) * rs;
    const float dxh = dy[base + c] * __bfloat162float(scale[c]);
    s1 += dxh;
    s2 += dxh * xhat;
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane; c < d; c += 32) {
    const float xhat = (__bfloat162float(x[base + c]) - mu) * rs;
    const float dxh = dy[base + c] * __bfloat162float(scale[c]);
    dx[base + c] = __float2bfloat16(rs * (dxh - m1 - xhat * m2) +
                                    __bfloat162float(resid[base + c]));
  }
}

cudaError_t ln_bwd(const float* dy, const bf16* x, const float* mean,
                   const float* rstd, const bf16* scale, const bf16* resid,
                   bf16* dx, int rows, int d, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  ln_bwd_kernel<<<(rows + rows_per_block - 1) / rows_per_block, threads, 0,
                  stream>>>(dy, x, mean, rstd, scale, resid, dx, rows, d);
  return cudaGetLastError();
}

// y = bf16(x * s[row]): a branch cotangent times the stochastic-depth scale
// of its row (JAX `dout * s2_ref`, a bf16 product).
__global__ void scale_rows_kernel(const bf16* __restrict__ x,
                                  const bf16* __restrict__ s,
                                  bf16* __restrict__ y, int rows, int d) {
  const size_t n = (size_t)rows * d;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16(__bfloat162float(x[i]) *
                            __bfloat162float(s[i / d]));
}

cudaError_t scale_rows(const bf16* x, const bf16* s, bf16* y, int rows,
                       int d, cudaStream_t stream) {
  const size_t n = (size_t)rows * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  scale_rows_kernel<<<blocks, 256, 0, stream>>>(x, s, y, rows, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fixed-order reductions over rows.
// ---------------------------------------------------------------------------
enum ColSum { COLSUM_BF16 = 0, COLSUM_F32 = 1, COLSUM_F32_XHAT = 2 };
constexpr int COLSUM_ROWS = 128;   // rows per split of a column sum

// partial[split][col] = sum over the split's rows of src[row][col]
// (COLSUM_F32_XHAT: of src * xhat, xhat recomputed from x, mean, rstd).
template <int MODE>
__global__ void colsum_partial_kernel(const void* __restrict__ src,
                                      const bf16* __restrict__ x,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      float* __restrict__ partial, int rows,
                                      int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  const int r1 = min(rows, r0 + COLSUM_ROWS);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * cols + col;
    float v;
    if (MODE == COLSUM_BF16) {
      v = __bfloat162float(static_cast<const bf16*>(src)[i]);
    } else {
      v = static_cast<const float*>(src)[i];
      if (MODE == COLSUM_F32_XHAT)
        v *= (__bfloat162float(x[i]) - mean[r]) * rstd[r];
    }
    acc += v;
  }
  partial[(size_t)blockIdx.y * cols + col] = acc;
}

// out[i] = sum_s partial[s][i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * n + i];
    out[i] = acc;
  }
}

cudaError_t reduce_splits(const float* partial, float* out, size_t n,
                          int splits, cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(partial, out, n, splits);
  return cudaGetLastError();
}

inline int colsum_splits(int rows) {
  return (rows + COLSUM_ROWS - 1) / COLSUM_ROWS;
}

template <int MODE>
cudaError_t colsum(const void* src, const bf16* x, const float* mean,
                   const float* rstd, float* partial, float* out, int rows,
                   int cols, cudaStream_t stream) {
  const int splits = colsum_splits(rows);
  dim3 grid((cols + 127) / 128, splits);
  colsum_partial_kernel<MODE><<<grid, 128, 0, stream>>>(src, x, mean, rstd,
                                                        partial, rows, cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_splits(partial, out, (size_t)cols, splits, stream);
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

// The A fragment (16 x 16) at the top left of a row-major (m, k) tile; ld
// in elements.
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* tile,
                                            int ld, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// The same A fragment from a (k, m) tile, i.e. A stored column by column.
__device__ __forceinline__ void load_a_frag_km(uint32_t* a, const bf16* tile,
                                               int ld, int lane) {
  ldmatrix_x4_trans(a, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                           ((lane >> 3) & 1) * 8);
}

// B fragments of two adjacent n8 tiles from a row-major (k, n) tile:
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
// C = epilogue(A @ B), A (M, K), B (K, N), bf16, f32 accumulation.
//   AT: A is stored transposed, (K, M) row-major;
//   BT: B is stored transposed, (N, K) row-major (a torch-style (out, in)
//       weight, or a weight read as its transpose).
// Epilogues (per element, on the accumulator):
//   EPI_BIAS      C = bf16(bf16(acc) + bias)
//   EPI_GELU      C = bf16(gelu(bf16(bf16(acc) + bias)))
//   EPI_RESIDUAL  v = bf16(bf16(acc) + bias) [v = bf16(v * row_scale[row])];
//                 C = bf16(residual + v)
//   EPI_NONE      C = bf16(acc)
//   EPI_GELU_SAVE h = bf16(bf16(acc) + bias); C = h; C2 = bf16(gelu(h))
//   EPI_DGELU     C = bf16(acc * gelu'(aux))   (aux: the saved h; C may be aux)
//   EPI_F32       C (f32) = acc, at offset blockIdx.z * M * N (split-K)
// K is split over blockIdx.z in chunks of k_split (a multiple of BK).
// ---------------------------------------------------------------------------
enum Epilogue {
  EPI_BIAS = 0,
  EPI_GELU = 1,
  EPI_RESIDUAL = 2,
  EPI_NONE = 3,
  EPI_GELU_SAVE = 4,
  EPI_DGELU = 5,
  EPI_F32 = 6
};

struct GemmParams {
  const bf16* A;
  const bf16* B;
  const bf16* bias;
  const bf16* residual;
  const bf16* row_scale;
  const bf16* aux;
  void* C;
  bf16* C2;
  int M, N, K;
  int k_split;
};

// 128 x 128 x 64 block tiles in a 3-stage cp.async ring; 8 warps (2 x 4),
// each a 64 x 32 tile of m16n8k16 accumulators.  Two blocks fit an SM
// (at most 110,592 bytes of shared memory each); taller or wider tiles,
// 64 x 64 warp tiles and a 4th stage all measured slower in K1.
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WTM = 64, WTN = 32;   // one warp's output tile
constexpr int BM = WARPS_M * WTM, BN = WARPS_N * WTN;
constexpr int BK = 64, STAGES = 3;
constexpr int GEMM_THREADS = 32 * WARPS_M * WARPS_N;

// Shared-memory tile shapes, padded by 8 elements a row so that ldmatrix
// reads are free of bank conflicts.
template <bool AT>
struct ATile {
  static constexpr int LD = AT ? BM + 8 : BK + 8;
  static constexpr int ELEMS = AT ? BK * (BM + 8) : BM * (BK + 8);
};
template <bool BT>
struct BTile {
  static constexpr int LD = BT ? BK + 8 : BN + 8;
  static constexpr int ELEMS = BT ? BN * (BK + 8) : BK * (BN + 8);
};

template <bool AT, bool BT>
constexpr size_t gemm_smem() {
  return (size_t)STAGES * (ATile<AT>::ELEMS + BTile<BT>::ELEMS) * sizeof(bf16);
}

template <int EPI, bool AT, bool BT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmParams p) {
  constexpr int MT = WTM / 16, NT = WTN / 8;   // m16 and n8 tiles per warp
  constexpr int LDA = ATile<AT>::LD, LDB = BTile<BT>::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * ATile<AT>::ELEMS;

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.k_split;
  const int kend = min(K, kbeg + p.k_split);

  auto load_stage = [&](int slot, int k0) {
    bf16* as = As + slot * ATile<AT>::ELEMS;
    bf16* bs = Bs + slot * BTile<BT>::ELEMS;
    if (AT) {   // rows k, 16-byte chunks along m
      for (int i = tid; i < BK * (BM / 8); i += GEMM_THREADS) {
        const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
        const bool ok = k0 + r < kend && m0 + c < M;
        cp_async16(as + r * LDA + c,
                   p.A + (ok ? (size_t)(k0 + r) * M + m0 + c : 0), ok);
      }
    } else {    // rows m, chunks along k
      for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + c < kend;
        cp_async16(as + r * LDA + c,
                   p.A + (ok ? (size_t)(m0 + r) * K + k0 + c : 0), ok);
      }
    }
    if (BT) {   // rows n, chunks along k
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = n0 + r < N && k0 + c < kend;
        cp_async16(bs + r * LDB + c,
                   p.B + (ok ? (size_t)(n0 + r) * K + k0 + c : 0), ok);
      }
    } else {    // rows k, chunks along n
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < kend && n0 + c < N;
        cp_async16(bs + r * LDB + c,
                   p.B + (ok ? (size_t)(k0 + r) * N + n0 + c : 0), ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int ktiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... and every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_stage(nk % STAGES, kbeg + nk * BK);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * ATile<AT>::ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * BTile<BT>::ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mrow = warp_m * WTM + i * 16;
        if (AT)
          load_a_frag_km(a[i], as + kk * LDA + mrow, LDA, lane);
        else
          load_a_frag(a[i], as + mrow * LDA + kk, LDA, lane);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int ncol = warp_n * WTN + j * 8;
        if (BT)
          load_b_frags_nk(&b[j][0], bs + ncol * LDB + kk, LDB, lane);
        else
          load_b_frags_kn(&b[j][0], bs + kk * LDB + ncol, LDB, lane);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: lane (g, t) holds columns 2t, 2t+1 of
  // rows g and g + 8 of each m16 x n8 tile.
  constexpr bool HAS_BIAS = EPI == EPI_BIAS || EPI == EPI_GELU ||
                            EPI == EPI_RESIDUAL || EPI == EPI_GELU_SAVE;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + warp_n * WTN + j * 8 + 2 * t;
    if (col >= N) continue;   // N is a multiple of 8: col + 1 < N as well
    float bb[2] = {0.f, 0.f};
    if (HAS_BIAS) {
      const __nv_bfloat162 bv =
          *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
      bb[0] = __low2float(bv);
      bb[1] = __high2float(bv);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * WTM + i * 16 + g + 8 * half;
        if (row >= M) continue;
        const size_t idx = (size_t)row * N + col;
        float v[2] = {acc[i][j][2 * half], acc[i][j][2 * half + 1]};
        if (EPI == EPI_F32) {
          float* C = static_cast<float*>(p.C) + (size_t)blockIdx.z * M * N;
          *reinterpret_cast<float2*>(C + idx) = make_float2(v[0], v[1]);
          continue;
        }
        bf16* C = static_cast<bf16*>(p.C);
        if (EPI == EPI_DGELU) {
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(p.aux + idx);
          v[0] *= gelu_tanh_grad(__low2float(hv));
          v[1] *= gelu_tanh_grad(__high2float(hv));
        } else if (EPI != EPI_NONE) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = bf16_round(bf16_round(v[e]) + bb[e]);   // bf16(acc) + bias in bf16
        }
        if (EPI == EPI_GELU) {
          v[0] = gelu_tanh(v[0]);   // f32 GELU, rounded at the store
          v[1] = gelu_tanh(v[1]);
        } else if (EPI == EPI_GELU_SAVE) {
          *reinterpret_cast<__nv_bfloat162*>(p.C2 + idx) =
              __floats2bfloat162_rn(gelu_tanh(v[0]), gelu_tanh(v[1]));
        } else if (EPI == EPI_RESIDUAL) {
          if (p.row_scale != nullptr) {
            const float s = __bfloat162float(p.row_scale[row]);
            v[0] = bf16_round(v[0] * s);
            v[1] = bf16_round(v[1] * s);
          }
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(p.residual + idx);
          v[0] += __low2float(rv);
          v[1] += __high2float(rv);
        }
        *reinterpret_cast<__nv_bfloat162*>(C + idx) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int EPI, bool AT, bool BT>
cudaError_t gemm(const GemmParams& p, int splits, cudaStream_t stream) {
  constexpr size_t smem = gemm_smem<AT, BT>();
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI, AT, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm_kernel<EPI, AT, BT><<<grid, GEMM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// One product without a K split.
template <int EPI, bool AT, bool BT>
cudaError_t gemm(const bf16* A, const bf16* B, const bf16* bias, void* C,
                 int M, int N, int K, cudaStream_t stream,
                 const bf16* residual = nullptr,
                 const bf16* row_scale = nullptr, const bf16* aux = nullptr,
                 bf16* C2 = nullptr) {
  GemmParams p{A, B, bias, residual, row_scale, aux, C, C2, M, N, K, K};
  return gemm<EPI, AT, BT>(p, 1, stream);
}

// Number of K splits of a weight-gradient product with an (M, N) output and
// K = rows: enough blocks to cover the card twice, each split a whole
// number of BK tiles.
inline void wgrad_split(int M, int N, int K, int* splits, int* k_split) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ktiles = (K + BK - 1) / BK;
  int want = (2 * 132 + tiles - 1) / tiles;
  if (want > ktiles) want = ktiles;
  if (want < 1) want = 1;
  const int per = (ktiles + want - 1) / want;
  *k_split = per * BK;
  *splits = (ktiles + per - 1) / per;
}

inline size_t wgrad_workspace(int M, int N, int K) {
  int splits, k_split;
  wgrad_split(M, N, K, &splits, &k_split);
  return (size_t)splits * M * N;
}

// dW (M, N) f32 = A^T B over K = rows: A stored (rows, M), B (rows, N),
// split over K into f32 partials, then summed in split order.
cudaError_t wgrad(const bf16* A, const bf16* B, float* out, float* workspace,
                  int M, int N, int rows, cudaStream_t stream) {
  int splits, k_split;
  wgrad_split(M, N, rows, &splits, &k_split);
  GemmParams p{A, B, nullptr, nullptr, nullptr, nullptr, workspace, nullptr,
               M, N, rows, k_split};
  cudaError_t e = gemm<EPI_F32, true, false>(p, splits, stream);
  if (e != cudaSuccess) return e;
  return reduce_splits(workspace, out, (size_t)M * N, splits, stream);
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

cudaError_t attention(const bf16* qkv, bf16* ctx, int B, int L, int D,
                      int heads, int valid_len, cudaStream_t stream) {
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
