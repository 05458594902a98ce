// K1: forward of one pre-norm ViT block in bf16, for Hopper (sm_90a).
//
// Replaces sais_tpu/kernels/fused_mha.py::_block_kernel (reached through
// fused_vit_block), the Pallas kernel that keeps a whole block for a few
// images in TPU VMEM.  It computes, with the same rounding points:
//
//   y    = bf16(LN1(x))                          LN in f32
//   qkv  = bf16(y @ Wqkv) + bqkv                 f32 accumulation, bias in bf16
//   s    = (q_f32 * dh^-0.5) @ k_f32^T + mask    mask -1e30 at keys >= valid_len
//   ctx  = bf16(bf16(softmax_f32(s)) @ v)        per image, per head
//   x1   = x + (bf16(ctx @ Wproj) + bproj)       bf16 adds
//   h    = bf16(gelu_tanh(f32(bf16(LN2(x1)) @ W1 -> bf16, + b1)))
//   out  = x1 + (bf16(h @ W2) + b2)
//
// What bounds it on an H100: at ViT-S/16 (L = 197, D = 384, MLP 1536) a
// block is 0.757 GFLOP per image against ~0.3 MB of activations, far above
// the card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations
// (0.196 ms for 256 images at 989 TFLOP/s bf16).  A TPU-style single
// program per image does not fit: the qkv of one image alone is 454 KB and
// a block has at most 227 KB of shared memory.  So this first design is one
// C entry point that enqueues a short sequence of kernels on the caller's
// stream, every product on the tensor cores with f32 accumulation:
//
//   (1) layer_norm_kernel           LN1 -> y
//   (2) gemm_kernel<EPI_BIAS>        y @ Wqkv + b -> qkv
//   (3) attention_kernel<KT>        per (head, image): K and V loaded once
//                                   into shared memory; a warp keeps a query
//                                   tile's whole key row of scores in
//                                   registers, two-pass f32 softmax, P
//                                   re-used as the A operand
//   (4) gemm_kernel<EPI_RESIDUAL>    ctx @ Wproj + b + x -> x1
//   (5) layer_norm_kernel           LN2 -> y
//   (6) gemm_kernel<EPI_GELU>        y @ W1 + b1, tanh-GELU -> h
//   (7) gemm_kernel<EPI_RESIDUAL>    h @ W2 + b2 + x1 -> out
//
// Every product is mma.sync m16n8k16 with ldmatrix fragments; the GEMMs'
// epilogues work on the accumulators in registers.  The intermediates (y,
// qkv / h, x1) round-trip through device memory, about 4x the bytes of the
// TPU kernel; still far below the compute bound.  Later work: wgmma + TMA
// GEMMs (mma.sync reaches about two thirds of the card's bf16 peak at
// best), LN fused into the GEMM prologue.
//
// The kernels allocate nothing: the caller passes the scratch buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;   // the JAX kernel's additive key mask

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

// The A fragment (16 x 16) at the top left of a row-major tile; ld in
// elements.
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* tile,
                                            int ld, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
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

// ---------------------------------------------------------------------------
// C = epilogue(bf16(A @ W) + bias): A (M, K) and W (K, N) bf16 row-major.
// ---------------------------------------------------------------------------
enum Epilogue { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// 128 x 128 x 64 block tiles in a 3-stage cp.async ring; 8 warps (2 x 4),
// each a 64 x 32 tile of m16n8k16 accumulators.  Two blocks fit an SM
// (125 registers a thread, 108 KB of shared memory each); taller or wider
// tiles, 64 x 64 warp tiles and a 4th stage all measured slower.
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WTM = 64, WTN = 32;   // one warp's output tile
constexpr int BM = WARPS_M * WTM, BN = WARPS_N * WTN;
constexpr int BK = 64, STAGES = 3;
constexpr int LDA_S = BK + 8;   // padded smem rows: ldmatrix without conflicts
constexpr int LDB_S = BN + 8;
constexpr int GEMM_THREADS = 32 * WARPS_M * WARPS_N;
constexpr size_t GEMM_SMEM =
    (size_t)STAGES * (BM * LDA_S + BK * LDB_S) * sizeof(bf16);

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

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
  return v * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                  (v + 0.044715f * (v * v * v)))));
}

template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const bf16* __restrict__ bias,
                const bf16* __restrict__ residual, bf16* __restrict__ C,
                int M, int N, int K) {
  constexpr int MT = WTM / 16, NT = WTN / 8;   // m16 and n8 tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * BM * LDA_S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int slot, int k0) {
    bf16* as = As + slot * BM * LDA_S;
    bf16* bs = Bs + slot * BK * LDB_S;
    for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(as + r * LDA_S + c,
                 A + (size_t)(ok ? m0 + r : 0) * K + k0 + c, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = n0 + c < N;
      cp_async16(bs + r * LDB_S + c,
                 W + (size_t)(k0 + r) * N + (ok ? n0 + c : 0), ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int ktiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... and every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * BM * LDA_S + warp_m * WTM * LDA_S;
    const bf16* bs = Bs + (kt % STAGES) * BK * LDB_S + warp_n * WTN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a_frag(a[i], as + i * 16 * LDA_S + kk, LDA_S, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        load_b_frags_kn(&b[j][0], bs + kk * LDB_S + j * 8, LDB_S, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: lane (g, t) holds columns 2t, 2t+1 of
  // rows g and g + 8 of each m16 x n8 tile.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + warp_n * WTN + j * 8 + 2 * t;
    if (col >= N) continue;   // N is a multiple of 8: col + 1 < N as well
    const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * WTM + i * 16 + g + 8 * half;
        if (row >= M) continue;
        float v[2] = {acc[i][j][2 * half], acc[i][j][2 * half + 1]};
        float res[2] = {0.f, 0.f};
        if (EPI == EPI_RESIDUAL) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(
              residual + (size_t)row * N + col);
          res[0] = __low2float(rv);
          res[1] = __high2float(rv);
        }
        const float bb[2] = {__low2float(bv), __high2float(bv)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = bf16_round(bf16_round(v[e]) + bb[e]);          // bf16(acc) + bias in bf16
          if (EPI == EPI_GELU) v[e] = bf16_round(gelu_tanh(v[e])); // f32 GELU -> bf16
          if (EPI == EPI_RESIDUAL) v[e] = res[e] + v[e];
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Masked softmax attention for head dim 64.  A block of 4 warps takes every
// query of one (image, head), whose K and V are loaded once into shared
// memory.  A warp holds the scores of 16 queries against all 16*KT keys in
// registers.
// ---------------------------------------------------------------------------
constexpr int DH = 64;
constexpr int ATT_THREADS = 128;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

template <int EPI>
cudaError_t gemm(const bf16* A, const bf16* W, const bf16* bias,
                 const bf16* residual, bf16* C, int M, int N, int K,
                 cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(A, W, bias,
                                                              residual, C, M,
                                                              N, K);
  return cudaGetLastError();
}

cudaError_t layer_norm(const bf16* x, const bf16* s, const bf16* b, bf16* y,
                       int rows, int d, float eps, cudaStream_t stream) {
  const int threads = 256, rows_per_block = threads / 32;
  layer_norm_kernel<<<(rows + rows_per_block - 1) / rows_per_block, threads, 0,
                      stream>>>(x, s, b, y, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Return codes: 0 on success, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernels do not take (the Python
// wrapper checks those first).
int fused_vit_block_fwd(const void* x, const void* qkv_w, const void* qkv_b,
                        const void* proj_w, const void* proj_b,
                        const void* fc1_w, const void* fc1_b,
                        const void* fc2_w, const void* fc2_b,
                        const void* ln1_s, const void* ln1_b,
                        const void* ln2_s, const void* ln2_b, void* out,
                        void* buf_y, void* buf_big, void* buf_x1, int batch,
                        int seq, int dim, int heads, int mlp, int valid_len,
                        float eps, void* stream_ptr) {
  if (heads <= 0 || dim != heads * DH || dim % BK != 0 || mlp % BK != 0 ||
      seq < 1 || seq > 16 * 16 || valid_len < 1 || valid_len > seq ||
      batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(buf_y);      // LN output, later ctx
  bf16* big = static_cast<bf16*>(buf_big);  // qkv, later the MLP hidden
  bf16* x1 = static_cast<bf16*>(buf_x1);
  bf16* o = static_cast<bf16*>(out);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaError_t e;
  if ((e = layer_norm(xb, w(ln1_s), w(ln1_b), y, M, dim, eps, stream))) return e;
  if ((e = gemm<EPI_BIAS>(y, w(qkv_w), w(qkv_b), nullptr, big, M, 3 * dim,
                          dim, stream))) return e;
  if ((e = attention(big, y, batch, seq, dim, heads, valid_len, stream))) return e;
  if ((e = gemm<EPI_RESIDUAL>(y, w(proj_w), w(proj_b), xb, x1, M, dim, dim,
                              stream))) return e;
  if ((e = layer_norm(x1, w(ln2_s), w(ln2_b), y, M, dim, eps, stream))) return e;
  if ((e = gemm<EPI_GELU>(y, w(fc1_w), w(fc1_b), nullptr, big, M, mlp, dim,
                          stream))) return e;
  if ((e = gemm<EPI_RESIDUAL>(big, w(fc2_w), w(fc2_b), x1, o, M, dim, mlp,
                              stream))) return e;
  return 0;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
