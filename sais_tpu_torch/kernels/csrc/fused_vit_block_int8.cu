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
// f32 before the bf16 cast, int32 converts to f32 rounded to nearest.
//
// What bounds it on an H100: at ViT-S/16 (L 197, D 384, MLP 1536), 256
// images, the four int8 products are 178.5 G integer operations (0.090 ms
// at 1,979 TOP/s) and the bf16 attention 15.3 GFLOP (0.015 ms at 989
// TFLOP/s), against about 81 MB that must move (x in and out in bf16, the
// bf16 weights; 0.024 ms at 3.35 TB/s): operations bound it.  One C entry
// point enqueues, on the caller's stream:
//
//   (1) prep_kernel                 the four weights' column maxima, in
//                                   blocks of 128 rows, and LN1 in f32 ->
//                                   int8 rows + row scales
//   (2) quant_weights_kernel        per column scale; the weights in int8
//                                   stored transposed (N, K), the K-major
//                                   B of 8-bit wgmma
//   (3) gemm_sm90 EPI_I8_BF16       qkv
//   (4) attention_kernel<KT>        K1's (vit_block_common.cuh; past 256
//       or long_attention_sm90_     tokens the key-tiled one on wgmma,
//       kernel                      attention_sm90.cuh)
//   (5) quant_rows_kernel           ctx -> int8 rows
//   (6) gemm_sm90 EPI_I8_RESID      x1 = x + bf16(proj)
//   (7) ln_quant_kernel             LN2
//   (8) gemm_sm90 EPI_I8_MLP        out = x1 + bf16(fc2(quant(gelu(fc1))))
//
// Every product runs on the wgmma + TMA GEMM of gemm_sm90.cuh in its int8
// mode (s8 x s8 -> s32, 128 bytes of K a stage); the dequantizing
// epilogues work on the accumulators.  The MLP is one launch that computes
// fc1 twice (gemm_sm90.cuh, mlp_i8): h never reaches device memory, where
// an f32 h would be 310 MB at (256, 197).
//
// The kernels allocate nothing: the caller passes the workspace.

#include "attention_sm90.cuh"

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The four weights of a block: w (K, N) bf16 -> wq (N, K) int8 and ws
// (N,) f32, per output column, in two passes over blocks of (64 columns,
// 128 rows) of each weight (blocks [block0[i], block0[i + 1]) weight i,
// strip-major): the first writes each block's column maxima (max is exact
// in any order), the second takes a column's maximum over its blocks,
// quantizes the block into shared memory and writes it transposed, 128
// bytes a row.  Each block's warps read whole 128-byte row segments.
constexpr int QW_COLS = 64, QW_K = 128, QW_WARPS = 8;

struct QuantWeights {
  const bf16* w[4];
  int8_t* wq[4];
  float* ws[4];
  float* part[4];   // (K / 128, N): the blocks' column maxima
  int K[4], N[4];
  int block0[5];
};

// This block's weight, first column and chunk of 128 rows.
__device__ __forceinline__ int qw_block(const QuantWeights& a, int b,
                                        int* n0, int* k0) {
  int i = 0;
  while (i < 3 && b >= a.block0[i + 1]) ++i;
  const int chunks = a.K[i] / QW_K, r = b - a.block0[i];
  *n0 = r / chunks * QW_COLS;
  *k0 = r % chunks * QW_K;
  return i;
}

__device__ __forceinline__ void weight_max_block(const QuantWeights& a,
                                                 int b) {
  __shared__ float red[QW_WARPS][QW_COLS];
  int n0, k0;
  const int i = qw_block(a, b, &n0, &k0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* col = a.w[i] + (size_t)k0 * a.N[i] + n0 + 2 * lane;
  float m0 = 0.f, m1 = 0.f;
#pragma unroll 4
  for (int k = warp; k < QW_K; k += QW_WARPS) {
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(col + (size_t)k * a.N[i]);
    m0 = fmaxf(m0, fabsf(__low2float(v)));
    m1 = fmaxf(m1, fabsf(__high2float(v)));
  }
  red[warp][2 * lane] = m0;
  red[warp][2 * lane + 1] = m1;
  __syncthreads();
  if (threadIdx.x < QW_COLS) {
    float m = red[0][threadIdx.x];
    for (int r = 1; r < QW_WARPS; ++r) m = fmaxf(m, red[r][threadIdx.x]);
    a.part[i][(size_t)(k0 / QW_K) * a.N[i] + n0 + threadIdx.x] = m;
  }
}

__global__ void __launch_bounds__(32 * QW_WARPS)
    quant_weights_kernel(QuantWeights a) {
  __shared__ float scale[QW_COLS], rcp[QW_COLS];
  __shared__ __align__(16) int8_t tile[QW_COLS][QW_K + 16];   // [column][k]
  int n0, k0;
  const int i = qw_block(a, blockIdx.x, &n0, &k0);
  const int K = a.K[i], N = a.N[i];
  if (threadIdx.x < QW_COLS) {
    float m = 0.f;
    for (int c = 0; c < K / QW_K; ++c)
      m = fmaxf(m, a.part[i][(size_t)c * N + n0 + threadIdx.x]);
    scale[threadIdx.x] = quant_scale(m);
    rcp[threadIdx.x] = __frcp_rn(scale[threadIdx.x]);
    if (k0 == 0) a.ws[i][n0 + threadIdx.x] = scale[threadIdx.x];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float s0 = scale[2 * lane], s1 = scale[2 * lane + 1];
  const float r0 = rcp[2 * lane], r1 = rcp[2 * lane + 1];
  const bf16* col = a.w[i] + (size_t)k0 * N + n0 + 2 * lane;
#pragma unroll 4
  for (int k = warp; k < QW_K; k += QW_WARPS) {
    const __nv_bfloat162 v =
        *reinterpret_cast<const __nv_bfloat162*>(col + (size_t)k * N);
    tile[2 * lane][k] = quant_one(__low2float(v), s0, r0);
    tile[2 * lane + 1][k] = quant_one(__high2float(v), s1, r1);
  }
  __syncthreads();
  // a thread writes 32 bytes of one column's row of wq
  const int c = threadIdx.x / 4, part = threadIdx.x % 4;
  const int4* src = reinterpret_cast<const int4*>(&tile[c][32 * part]);
  int4* dst = reinterpret_cast<int4*>(a.wq[i] + (size_t)(n0 + c) * K + k0 +
                                      32 * part);
  dst[0] = src[0];
  dst[1] = src[1];
}

// LayerNorm in f32 (not rounded), then per-row int8 of one row, by one
// warp, the row's D = 32 CPL values held in registers (lane l: columns
// l + 32 i).
template <int CPL>
__device__ __forceinline__ void ln_quant_row(const bf16* __restrict__ x,
                                             const bf16* __restrict__ scale,
                                             const bf16* __restrict__ bias,
                                             int8_t* __restrict__ q,
                                             float* __restrict__ qs, int row,
                                             float eps) {
  constexpr int D = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const bf16* xr = x + (size_t)row * D;
  float v[CPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    v[i] = __bfloat162float(xr[lane + 32 * i]);
    sum += v[i];
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const float t = v[i] - mean;
    sq += t * t;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i] - mean, rstd),
                               __bfloat162float(scale[c])),
                     __bfloat162float(bias[c]));
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float s = quant_scale(warp_max(amax)), r = __frcp_rn(s);
  if (lane == 0) qs[row] = s;
  int8_t* qr = q + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i) qr[lane + 32 * i] = quant_one(v[i], s, r);
}

template <int CPL>
__global__ void __launch_bounds__(256)
    ln_quant_kernel(const bf16* __restrict__ x,
                    const bf16* __restrict__ scale,
                    const bf16* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ qs, int rows, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row < rows) ln_quant_row<CPL>(x, scale, bias, q, qs, row, eps);
}

// The weights' column maxima and LN1's rows in one launch (independent
// work): blocks below block0[4] take a weight block, the rest 8 rows each.
template <int CPL>
__global__ void __launch_bounds__(32 * QW_WARPS)
    prep_kernel(QuantWeights a, const bf16* __restrict__ x,
                const bf16* __restrict__ scale,
                const bf16* __restrict__ bias, int8_t* __restrict__ q,
                float* __restrict__ qs, int rows, float eps) {
  if ((int)blockIdx.x < a.block0[4]) {
    weight_max_block(a, blockIdx.x);
    return;
  }
  const int row = ((int)blockIdx.x - a.block0[4]) * QW_WARPS +
                  (int)threadIdx.x / 32;
  if (row < rows) ln_quant_row<CPL>(x, scale, bias, q, qs, row, eps);
}

// Per-row int8 of y (rows, D) bf16, quantized from f32: one warp per row,
// the row in registers.
template <int CPL>
__global__ void __launch_bounds__(256)
    quant_rows_kernel(const bf16* __restrict__ y, int8_t* __restrict__ q,
                      float* __restrict__ qs, int rows) {
  constexpr int D = 32 * CPL;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* yr = y + (size_t)row * D;
  float v[CPL];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    v[i] = __bfloat162float(yr[lane + 32 * i]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float s = quant_scale(warp_max(amax)), r = __frcp_rn(s);
  if (lane == 0) qs[row] = s;
  int8_t* qr = q + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i) qr[lane + 32 * i] = quant_one(v[i], s, r);
}

// The row quantizers at D = 384 or 768 (the widths K8 takes): with qw,
// the weights' column maxima and LN(x) in one launch; else LN (ln_s
// given) then per-row int8, or per-row int8 of x alone.
template <int CPL>
cudaError_t row_quant(const QuantWeights* qw, const bf16* x,
                      const bf16* ln_s, const bf16* ln_b, int8_t* q,
                      float* qs, int rows, float eps, cudaStream_t stream) {
  const int blocks = (rows + 7) / 8;
  if (qw != nullptr)
    prep_kernel<CPL><<<qw->block0[4] + (rows + QW_WARPS - 1) / QW_WARPS,
                       32 * QW_WARPS, 0, stream>>>(*qw, x, ln_s, ln_b, q, qs,
                                                   rows, eps);
  else if (ln_s != nullptr)
    ln_quant_kernel<CPL><<<blocks, 256, 0, stream>>>(x, ln_s, ln_b, q, qs,
                                                     rows, eps);
  else
    quant_rows_kernel<CPL><<<blocks, 256, 0, stream>>>(x, q, qs, rows);
  return cudaGetLastError();
}

cudaError_t row_quant(const QuantWeights* qw, const bf16* x,
                      const bf16* ln_s, const bf16* ln_b, int8_t* q,
                      float* qs, int rows, int d, float eps,
                      cudaStream_t stream) {
  switch (d) {
    case 384:
      return row_quant<12>(qw, x, ln_s, ln_b, q, qs, rows, eps, stream);
    case 768:
      return row_quant<24>(qw, x, ln_s, ln_b, q, qs, rows, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

inline size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// Byte layout of the workspace: the four quantized weights and their
// scales, then the activations.
struct Workspace {
  int8_t *wq[4], *q;
  float *ws[4], *wpart[4], *qs;
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
    w->wpart[i] = reinterpret_cast<float*>(
        take(wn[i][0] / QW_K * wn[i][1] * 4));
  }
  w->q = reinterpret_cast<int8_t*>(take((size_t)M * D));
  w->qs = reinterpret_cast<float*>(take((size_t)M * 4));
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
// wrapper checks those first): D a multiple of 384 up to 768 (the MLP
// launch's two consumers take 192 output columns each), MLP a multiple of
// 256.  Weights (in, out) bf16 as K1 takes them.
int fused_vit_block_int8(const void* x, const void* qkv_w, const void* qkv_b,
                         const void* proj_w, const void* proj_b,
                         const void* fc1_w, const void* fc1_b,
                         const void* fc2_w, const void* fc2_b,
                         const void* ln1_s, const void* ln1_b,
                         const void* ln2_s, const void* ln2_b, void* out,
                         void* workspace, int batch, int seq, int dim,
                         int heads, int mlp, int valid_len, float eps,
                         void* stream_ptr) {
  if (heads <= 0 || dim != heads * DH || dim % (2 * sm90::MLP_NC) != 0 ||
      dim > sm90::MLP_MAX_D || mlp % sm90::MLP_SLICE != 0 || seq < 1 ||
      valid_len < 1 || valid_len > seq || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  Workspace w;
  carve(static_cast<unsigned char*>(workspace), M, dim, mlp, &w);
  auto bw = [](const void* p) { return static_cast<const bf16*>(p); };
  const bf16* xb = bw(x);
  QuantWeights qw;
  const void* wts[4] = {qkv_w, proj_w, fc1_w, fc2_w};
  const int kn[4][2] = {{dim, 3 * dim}, {dim, dim}, {dim, mlp}, {mlp, dim}};
  qw.block0[0] = 0;
  for (int i = 0; i < 4; ++i) {
    qw.w[i] = bw(wts[i]);
    qw.wq[i] = w.wq[i];
    qw.ws[i] = w.ws[i];
    qw.part[i] = w.wpart[i];
    qw.K[i] = kn[i][0];
    qw.N[i] = kn[i][1];
    qw.block0[i + 1] =
        qw.block0[i] + kn[i][1] / QW_COLS * (kn[i][0] / QW_K);
  }
  cudaError_t e;
  if ((e = row_quant(&qw, xb, bw(ln1_s), bw(ln1_b), w.q, w.qs, M, dim, eps,
                     stream))) return (int)e;
  quant_weights_kernel<<<qw.block0[4], 32 * QW_WARPS, 0, stream>>>(qw);
  if ((e = cudaGetLastError())) return (int)e;
  if ((e = gemm_sm90_i8<EPI_I8_BF16>(w.q, w.qs, w.wq[0], w.ws[0], bw(qkv_b),
                                     w.qkv, M, 3 * dim, dim, stream)))
    return (int)e;
  if ((e = attention(w.qkv, w.ctx, batch, seq, dim, heads, valid_len,
                     stream))) return (int)e;
  if ((e = row_quant(nullptr, w.ctx, nullptr, nullptr, w.q, w.qs, M, dim,
                     eps, stream))) return (int)e;
  if ((e = gemm_sm90_i8<EPI_I8_RESID>(w.q, w.qs, w.wq[1], w.ws[1],
                                      bw(proj_b), w.x1, M, dim, dim, stream,
                                      xb))) return (int)e;
  if ((e = row_quant(nullptr, w.x1, bw(ln2_s), bw(ln2_b), w.q, w.qs, M,
                     dim, eps, stream))) return (int)e;
  return (int)mlp_sm90_i8(w.q, w.qs, w.wq[2], w.ws[2], bw(fc1_b), w.wq[3],
                          w.ws[3], bw(fc2_b), w.x1, static_cast<bf16*>(out),
                          M, dim, mlp, stream);
}

// The int8 GEMM alone (the card tests hold it against an exact integer
// product): C (M, N) bf16 = epilogue(A (M, K) int8 @ B^T), B stored (N, K)
// int8, a_scale (M,), b_scale (N,) f32, bias (N,) bf16; epilogue 0: C =
// bf16(v); 1: C = bf16(aux + bf16(v)), aux (M, N) bf16.
int vit_block_gemm_i8(const void* a, const void* a_scale, const void* b,
                      const void* b_scale, const void* bias, const void* aux,
                      void* c, int M, int N, int K, int epilogue,
                      void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* cc = static_cast<bf16*>(c);
  if (epilogue == 0 && aux == nullptr)
    return (int)gemm_sm90_i8<EPI_I8_BF16>(i8(a), f(a_scale), i8(b),
                                          f(b_scale), bb, cc, M, N, K,
                                          stream);
  if (epilogue == 1)
    return (int)gemm_sm90_i8<EPI_I8_RESID>(i8(a), f(a_scale), i8(b),
                                           f(b_scale), bb, cc, M, N, K,
                                           stream,
                                           static_cast<const bf16*>(aux));
  return (int)cudaErrorInvalidValue;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
