// K8: forward of one pre-norm ViT block with W8A8 products, for Hopper
// (sm_90a).
//
// Replaces sais_tpu/kernels/fused_mha.py::_block_kernel_int8 (reached
// through fused_vit_block_int8, :227), the opt-in Pallas block whose qkv,
// proj, fc1 and fc2 products run int8 x int8 -> int32 with per-output-
// channel weight scales and per-token activation scales, attention in bf16.
// With quant(y) = clip(rint(y / s), -127, 127), s = max(amax_row |y|,
// 1e-8) * (1/127), the weights quantized the same way per column, and
// mm(q, s, W) = f32(q @ Wq) * s * ws + b (f32 bias), it computes
//
//   qkv  = bf16(mm(quant(LN1(x))))               LN in f32, not rounded
//   ctx  = K1's attention of qkv, bf16
//   x1   = x + bf16(mm(quant(f32(ctx))))         bf16 add
//   h    = gelu_tanh(mm(quant(LN2(x1))))          f32 throughout
//   out  = x1 + bf16(mm(quant(h)))
//
// The weights are quantized at every call, as the JAX package does inside
// its jit.  Rounding points differ from K1's: the activations are quantized
// from f32 (LN output and h never rounded to bf16), the bias is added in
// f32 before the bf16 cast.
//
// What bounds it on an H100: at ViT-S/16 (L 197, D 384, MLP 1536), 256
// images, the four int8 products are 178.5 G integer operations (0.090 ms
// at 1,979 TOP/s) and the bf16 attention 15.3 GFLOP (0.015 ms at 989
// TFLOP/s), against about 81 MB that must move (x in and out in bf16, the
// bf16 weights; 0.024 ms at 3.35 TB/s): operations bound it.  One C entry point enqueues, on the caller's stream:
//
//   (0) quant_weight_kernel x 4     per column: scale, int8 weights stored
//                                   transposed (N, K) for the B operand
//                                   (32 x 32 tiles through shared memory)
//   (1) ln_quant_kernel             LN1 in f32 -> int8 rows + row scales
//   (2) gemm_i8_kernel<I8_BF16>      qkv
//   (3) attention_kernel<KT>         (vit_block_common.cuh, K1's)
//   (4) quant_rows_kernel<bf16>      ctx -> int8 rows
//   (5) gemm_i8_kernel<I8_RESID>     x1 = x + bf16(proj)
//   (6) ln_quant_kernel             LN2
//   (7) gemm_i8_kernel<I8_GELU_F32>  h = gelu_tanh(fc1), f32
//   (8) quant_rows_kernel<float>     h -> int8 rows
//   (9) gemm_i8_kernel<I8_RESID>     out = x1 + bf16(fc2)
//
// The integer products are mma.sync m16n8k32 (s8 x s8 -> s32) on 128 x
// 128 x 64 block tiles in a 3-stage cp.async ring, fragments by ldmatrix;
// the dequantizing epilogue works on the accumulators.  The intermediates
// round-trip through device memory (h in f32), as K1's do; later work:
// wgmma, quantization fused into the producing epilogues.
//
// The kernels allocate nothing: the caller passes the workspace.

#include "vit_block_common.cuh"

namespace {

constexpr float kInv127 = 1.0f / 127.0f;   // the f32 constant JAX multiplies by

__device__ __forceinline__ int8_t quant_one(float y, float scale) {
  const int q = __float2int_rn(__fdiv_rn(y, scale));   // rint: half to even
  return (int8_t)max(-127, min(127, q));
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// wq (N, K) int8 and ws (N,) f32 of w (K, N) bf16, per output column.  A
// block of 8 warps takes 32 columns: the column maxima over 8 row groups
// (max is exact in any order), then 32 x 32 tiles transposed through
// shared memory so that both the reads and the writes are coalesced.
constexpr int QW_COLS = 32;

__global__ void __launch_bounds__(256)
    quant_weight_kernel(const bf16* __restrict__ w, int8_t* __restrict__ wq,
                        float* __restrict__ ws, int K, int N) {
  __shared__ float red[8][QW_COLS];
  __shared__ int8_t tile[QW_COLS][QW_COLS + 4];   // [column][row]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n0 = blockIdx.x * QW_COLS, n = n0 + tx;
  float amax = 0.f;
  if (n < N)
    for (int k = ty; k < K; k += 8)
      amax = fmaxf(amax, fabsf(__bfloat162float(w[(size_t)k * N + n])));
  red[ty][tx] = amax;
  __syncthreads();
  if (ty == 0) {
    float m = red[0][tx];
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i][tx]);
    red[0][tx] = quant_scale(m);
    if (n < N) ws[n] = red[0][tx];
  }
  __syncthreads();
  const float s = red[0][tx];
  for (int k0 = 0; k0 < K; k0 += QW_COLS) {
    for (int kk = ty; kk < QW_COLS; kk += 8)
      tile[tx][kk] = n < N ? quant_one(
          __bfloat162float(w[(size_t)(k0 + kk) * N + n]), s) : (int8_t)0;
    __syncthreads();
    for (int r = ty; r < QW_COLS; r += 8)
      if (n0 + r < N) wq[(size_t)(n0 + r) * K + k0 + tx] = tile[r][tx];
    __syncthreads();
  }
}

// LayerNorm in f32 (not rounded), then per-row int8: one warp per row.
__global__ void ln_quant_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ scale,
                                const bf16* __restrict__ bias,
                                int8_t* __restrict__ q,
                                float* __restrict__ qs, int rows, int d,
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
  auto ln = [&](int c) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__bfloat162float(xr[c]) - mean, rstd),
                               __bfloat162float(scale[c])),
                     __bfloat162float(bias[c]));
  };
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(ln(c)));
  const float s = quant_scale(warp_max(amax));
  if (lane == 0) qs[row] = s;
  int8_t* qr = q + (size_t)row * d;
  for (int c = lane; c < d; c += 32) qr[c] = quant_one(ln(c), s);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Per-row int8 of y (rows, d), bf16 or f32: one warp per row.
template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ y,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ qs, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* yr = y + (size_t)row * d;
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(to_f32(yr[c])));
  const float s = quant_scale(warp_max(amax));
  if (lane == 0) qs[row] = s;
  int8_t* qr = q + (size_t)row * d;
  for (int c = lane; c < d; c += 32) qr[c] = quant_one(to_f32(yr[c]), s);
}

template <typename T>
cudaError_t quant_rows(const T* y, int8_t* q, float* qs, int rows, int d,
                       cudaStream_t stream) {
  quant_rows_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(y, q, qs, rows, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C = epilogue(f32(A @ B^T) * a_scale[row] * b_scale[col] + bias[col]),
// A (M, K) int8, B (N, K) int8 (the transposed quantized weight).
//   I8_BF16      C = bf16(v)
//   I8_RESID     C = bf16(resid + bf16(v))
//   I8_GELU_F32  C (f32) = gelu_tanh(v)
// K is a multiple of 64, N of 8.
// ---------------------------------------------------------------------------
enum I8Epilogue { I8_BF16 = 0, I8_RESID = 1, I8_GELU_F32 = 2 };

constexpr int I8_BM = 128, I8_BN = 128, I8_BK = 64;   // BK in int8 elements
constexpr int I8_LD = I8_BK + 16;   // smem row stride in bytes: ldmatrix
                                    // rows land on distinct banks
constexpr int I8_STAGES = 3;
constexpr int I8_THREADS = 256;     // 8 warps, 2 x 4, each 64 x 32
constexpr size_t I8_SMEM = (size_t)I8_STAGES * (I8_BM + I8_BN) * I8_LD;

struct I8Params {
  const int8_t* A;
  const float* a_scale;
  const int8_t* B;
  const float* b_scale;
  const bf16* bias;
  const bf16* resid;
  void* C;
  int M, N, K;
};

__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix on int8 tiles: an 8 x 8 b16 matrix is 8 rows of 16 int8, so
// lane (g, t) receives bytes 4t..4t+3 of row g, the m16n8k32 layout.
__device__ __forceinline__ void ldmatrix_x4_i8(uint32_t* r, const int8_t* p) {
  ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
}

template <int EPI>
__global__ void __launch_bounds__(I8_THREADS) gemm_i8_kernel(I8Params p) {
  constexpr int WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Bs = As + I8_STAGES * I8_BM * I8_LD;
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * I8_BM, n0 = blockIdx.x * I8_BN;

  auto load_stage = [&](int slot, int k0) {
    int8_t* as = As + slot * I8_BM * I8_LD;
    int8_t* bs = Bs + slot * I8_BN * I8_LD;
    for (int i = tid; i < I8_BM * (I8_BK / 16); i += I8_THREADS) {
      const int r = i / (I8_BK / 16), c = (i % (I8_BK / 16)) * 16;
      const bool ok = m0 + r < M;
      cp_async16(as + r * I8_LD + c,
                 p.A + (ok ? (size_t)(m0 + r) * K + k0 + c : 0), ok);
    }
    for (int i = tid; i < I8_BN * (I8_BK / 16); i += I8_THREADS) {
      const int r = i / (I8_BK / 16), c = (i % (I8_BK / 16)) * 16;
      const bool ok = n0 + r < N;
      cp_async16(bs + r * I8_LD + c,
                 p.B + (ok ? (size_t)(n0 + r) * K + k0 + c : 0), ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int ktiles = K / I8_BK;
#pragma unroll
  for (int s = 0; s < I8_STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * I8_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<I8_STAGES - 2>();
    __syncthreads();
    const int nk = kt + I8_STAGES - 1;
    if (nk < ktiles) load_stage(nk % I8_STAGES, nk * I8_BK);
    cp_async_commit();
    const int8_t* as = As + (kt % I8_STAGES) * I8_BM * I8_LD;
    const int8_t* bs = Bs + (kt % I8_STAGES) * I8_BN * I8_LD;
#pragma unroll
    for (int kk = 0; kk < I8_BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4_i8(a[i], as + (warp_m * WM + i * 16 + (lane & 15)) * I8_LD +
                                 kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2)
        ldmatrix_x4_i8(&b[j][0],
                       bs + (warp_n * WN + j * 8 + (lane & 7) +
                             ((lane >> 4) << 3)) * I8_LD +
                           kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8_16832(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + warp_n * WN + j * 8 + 2 * t;
    if (col >= N) continue;
    const float ws[2] = {p.b_scale[col], p.b_scale[col + 1]};
    const float bb[2] = {__bfloat162float(p.bias[col]),
                         __bfloat162float(p.bias[col + 1])};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * WM + i * 16 + g + 8 * half;
        if (row >= M) continue;
        const float rs = p.a_scale[row];
        const size_t idx = (size_t)row * N + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + e]), rs),
                        ws[e]),
              bb[e]);
        if (EPI == I8_GELU_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.C) + idx) =
              make_float2(gelu_tanh(v[0]), gelu_tanh(v[1]));
          continue;
        }
        if (EPI == I8_RESID) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(p.resid + idx);
          v[0] = __low2float(r) + bf16_round(v[0]);
          v[1] = __high2float(r) + bf16_round(v[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + idx) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int EPI>
cudaError_t gemm_i8(const int8_t* A, const float* a_scale, const int8_t* B,
                    const float* b_scale, const bf16* bias, const bf16* resid,
                    void* C, int M, int N, int K, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_i8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)I8_SMEM);
  if (e != cudaSuccess) return e;
  I8Params p{A, a_scale, B, b_scale, bias, resid, C, M, N, K};
  dim3 grid((N + I8_BN - 1) / I8_BN, (M + I8_BM - 1) / I8_BM);
  gemm_i8_kernel<EPI><<<grid, I8_THREADS, I8_SMEM, stream>>>(p);
  return cudaGetLastError();
}

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// Byte layout of the workspace: the four quantized weights and their
// scales, then the activations.
struct Workspace {
  int8_t *wq[4], *q, *hq;
  float *ws[4], *qs, *hs, *h;
  bf16 *qkv, *ctx, *x1;
};

size_t carve(unsigned char* base, int M, int D, int MLP, Workspace* w) {
  const size_t wn[4][2] = {{(size_t)D, (size_t)3 * D}, {(size_t)D, (size_t)D},
                           {(size_t)D, (size_t)MLP}, {(size_t)MLP, (size_t)D}};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base == nullptr ? nullptr : base + off;
    off += align256(bytes);
    return p;
  };
  for (int i = 0; i < 4; ++i) {
    w->wq[i] = reinterpret_cast<int8_t*>(take(wn[i][0] * wn[i][1]));
    w->ws[i] = reinterpret_cast<float*>(take(wn[i][1] * 4));
  }
  w->q = reinterpret_cast<int8_t*>(take((size_t)M * D));
  w->qs = reinterpret_cast<float*>(take((size_t)M * 4));
  w->hq = reinterpret_cast<int8_t*>(take((size_t)M * MLP));
  w->hs = reinterpret_cast<float*>(take((size_t)M * 4));
  w->h = reinterpret_cast<float*>(take((size_t)M * MLP * 4));
  w->qkv = reinterpret_cast<bf16*>(take((size_t)M * 3 * D * 2));
  w->ctx = reinterpret_cast<bf16*>(take((size_t)M * D * 2));
  w->x1 = reinterpret_cast<bf16*>(take((size_t)M * D * 2));
  return off;
}

}  // namespace

extern "C" {

size_t fused_vit_block_int8_workspace(int rows, int dim, int mlp) {
  Workspace w;
  return carve(nullptr, rows, dim, mlp, &w);
}

// Return codes: 0 on success, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernels do not take (the Python
// wrapper checks those first).  Weights (in, out) bf16 as K1 takes them.
int fused_vit_block_int8(const void* x, const void* qkv_w, const void* qkv_b,
                         const void* proj_w, const void* proj_b,
                         const void* fc1_w, const void* fc1_b,
                         const void* fc2_w, const void* fc2_b,
                         const void* ln1_s, const void* ln1_b,
                         const void* ln2_s, const void* ln2_b, void* out,
                         void* workspace, int batch, int seq, int dim,
                         int heads, int mlp, int valid_len, float eps,
                         void* stream_ptr) {
  if (heads <= 0 || dim != heads * DH || dim % I8_BK != 0 ||
      mlp % I8_BK != 0 || seq < 1 || seq > 16 * 16 || valid_len < 1 ||
      valid_len > seq || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  Workspace w;
  carve(static_cast<unsigned char*>(workspace), M, dim, mlp, &w);
  auto bw = [](const void* p) { return static_cast<const bf16*>(p); };
  const bf16* xb = bw(x);
  const void* wts[4] = {qkv_w, proj_w, fc1_w, fc2_w};
  const int kn[4][2] = {{dim, 3 * dim}, {dim, dim}, {dim, mlp}, {mlp, dim}};
  cudaError_t e;
  for (int i = 0; i < 4; ++i) {
    quant_weight_kernel<<<(kn[i][1] + QW_COLS - 1) / QW_COLS, 256, 0,
                          stream>>>(
        bw(wts[i]), w.wq[i], w.ws[i], kn[i][0], kn[i][1]);
    if ((e = cudaGetLastError())) return (int)e;
  }
  const int ln_blocks = (M + 7) / 8;
  ln_quant_kernel<<<ln_blocks, 256, 0, stream>>>(xb, bw(ln1_s), bw(ln1_b),
                                                 w.q, w.qs, M, dim, eps);
  if ((e = cudaGetLastError())) return (int)e;
  if ((e = gemm_i8<I8_BF16>(w.q, w.qs, w.wq[0], w.ws[0], bw(qkv_b), nullptr,
                            w.qkv, M, 3 * dim, dim, stream))) return (int)e;
  if ((e = attention(w.qkv, w.ctx, batch, seq, dim, heads, valid_len,
                     stream))) return (int)e;
  if ((e = quant_rows<bf16>(w.ctx, w.q, w.qs, M, dim, stream))) return (int)e;
  if ((e = gemm_i8<I8_RESID>(w.q, w.qs, w.wq[1], w.ws[1], bw(proj_b), xb,
                             w.x1, M, dim, dim, stream))) return (int)e;
  ln_quant_kernel<<<ln_blocks, 256, 0, stream>>>(w.x1, bw(ln2_s), bw(ln2_b),
                                                 w.q, w.qs, M, dim, eps);
  if ((e = cudaGetLastError())) return (int)e;
  if ((e = gemm_i8<I8_GELU_F32>(w.q, w.qs, w.wq[2], w.ws[2], bw(fc1_b),
                                nullptr, w.h, M, mlp, dim, stream)))
    return (int)e;
  if ((e = quant_rows<float>(w.h, w.hq, w.hs, M, mlp, stream))) return (int)e;
  if ((e = gemm_i8<I8_RESID>(w.hq, w.hs, w.wq[3], w.ws[3], bw(fc2_b), w.x1,
                             out, M, dim, mlp, stream))) return (int)e;
  return 0;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
