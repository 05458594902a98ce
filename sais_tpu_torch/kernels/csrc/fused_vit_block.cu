// K1 and K4: forward of one pre-norm ViT block in bf16, for Hopper (sm_90a).
//
// K1 replaces sais_tpu/kernels/fused_mha.py::_block_kernel (reached through
// fused_vit_block), the Pallas kernel that keeps a whole block for a few
// images in TPU VMEM.  K4 replaces _block_fwd_train_kernel (reached through
// _fused_block_fwd_train), the training forward: the same block, which also
// keeps the post-attention residual x1 for the backward (K5, K6) and can
// scale each residual branch per row (stochastic depth, s1 and s2 in
// {0, 1/keep}, constant within an image).  Both compute, with the same
// rounding points:
//
//   y    = bf16(LN1(x))                          LN in f32
//   qkv  = bf16(y @ Wqkv) + bqkv                 f32 accumulation, bias in bf16
//   s    = (q_f32 * dh^-0.5) @ k_f32^T + mask    mask -1e30 at keys >= valid_len
//   ctx  = bf16(bf16(softmax_f32(s)) @ v)        per image, per head
//   x1   = x + [s1 *] (bf16(ctx @ Wproj) + bproj)       bf16 adds and product
//   h    = bf16(gelu_tanh(f32(bf16(LN2(x1)) @ W1 -> bf16, + b1)))
//   out  = x1 + [s2 *] (bf16(h @ W2) + b2)
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
//   (4) gemm_kernel<EPI_RESIDUAL>    [s1 *] (ctx @ Wproj + b) + x -> x1
//   (5) layer_norm_kernel           LN2 -> y
//   (6) gemm_kernel<EPI_GELU>        y @ W1 + b1, tanh-GELU -> h
//   (7) gemm_kernel<EPI_RESIDUAL>    [s2 *] (h @ W2 + b2) + x1 -> out
//
// Every product is mma.sync m16n8k16 with ldmatrix fragments
// (vit_block_common.cuh); the GEMMs' epilogues work on the accumulators in
// registers.  The intermediates (y, qkv / h, x1) round-trip through device
// memory, about 4x the bytes of the TPU kernel; still far below the compute
// bound.  Later work: wgmma + TMA GEMMs (mma.sync reaches about two thirds
// of the card's bf16 peak at best), LN fused into the GEMM prologue.
//
// The kernels allocate nothing: the caller passes the scratch buffers.

#include "vit_block_common.cuh"

namespace {

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

cudaError_t block_forward(const void* x, const void* qkv_w,
                          const void* qkv_b, const void* proj_w,
                          const void* proj_b, const void* fc1_w,
                          const void* fc1_b, const void* fc2_w,
                          const void* fc2_b, const void* ln1_s,
                          const void* ln1_b, const void* ln2_s,
                          const void* ln2_b, const void* s1, const void* s2,
                          void* out, void* buf_y, void* buf_big, void* buf_x1,
                          int batch, int seq, int dim, int heads, int mlp,
                          int valid_len, float eps, void* stream_ptr) {
  if (heads <= 0 || dim != heads * DH || dim % BK != 0 || mlp % BK != 0 ||
      seq < 1 || seq > 16 * 16 || valid_len < 1 || valid_len > seq ||
      batch < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(buf_y);      // LN output, later ctx
  bf16* big = static_cast<bf16*>(buf_big);  // qkv, later the MLP hidden
  bf16* x1 = static_cast<bf16*>(buf_x1);
  bf16* o = static_cast<bf16*>(out);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaError_t e;
  if ((e = layer_norm(xb, w(ln1_s), w(ln1_b), y, nullptr, nullptr, M, dim,
                      eps, stream))) return e;
  if ((e = gemm<EPI_BIAS, false, false>(y, w(qkv_w), w(qkv_b), big, M,
                                        3 * dim, dim, stream))) return e;
  if ((e = attention(big, y, batch, seq, dim, heads, valid_len, stream))) return e;
  if ((e = gemm<EPI_RESIDUAL, false, false>(y, w(proj_w), w(proj_b), x1, M,
                                            dim, dim, stream, xb, w(s1))))
    return e;
  if ((e = layer_norm(x1, w(ln2_s), w(ln2_b), y, nullptr, nullptr, M, dim,
                      eps, stream))) return e;
  if ((e = gemm<EPI_GELU, false, false>(y, w(fc1_w), w(fc1_b), big, M, mlp,
                                        dim, stream))) return e;
  if ((e = gemm<EPI_RESIDUAL, false, false>(big, w(fc2_w), w(fc2_b), o, M,
                                            dim, mlp, stream, x1, w(s2))))
    return e;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Return codes: 0 on success, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernels do not take (the Python
// wrapper checks those first).

// K1: the inference block; x1 lives in the caller's scratch buffer.
int fused_vit_block_fwd(const void* x, const void* qkv_w, const void* qkv_b,
                        const void* proj_w, const void* proj_b,
                        const void* fc1_w, const void* fc1_b,
                        const void* fc2_w, const void* fc2_b,
                        const void* ln1_s, const void* ln1_b,
                        const void* ln2_s, const void* ln2_b, void* out,
                        void* buf_y, void* buf_big, void* buf_x1, int batch,
                        int seq, int dim, int heads, int mlp, int valid_len,
                        float eps, void* stream_ptr) {
  return (int)block_forward(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                            fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, nullptr,
                            nullptr, out, buf_y, buf_big, buf_x1, batch, seq,
                            dim, heads, mlp, valid_len, eps, stream_ptr);
}

// K4: the training forward.  x1 is an output; s1 and s2 (one bf16 scale a
// row, (B*L,)) may both be null.
int fused_block_fwd_train(const void* x, const void* qkv_w,
                          const void* qkv_b, const void* proj_w,
                          const void* proj_b, const void* fc1_w,
                          const void* fc1_b, const void* fc2_w,
                          const void* fc2_b, const void* ln1_s,
                          const void* ln1_b, const void* ln2_s,
                          const void* ln2_b, const void* s1, const void* s2,
                          void* out, void* x1, void* buf_y, void* buf_big,
                          int batch, int seq, int dim, int heads, int mlp,
                          int valid_len, float eps, void* stream_ptr) {
  if ((s1 == nullptr) != (s2 == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)block_forward(x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b,
                            fc2_w, fc2_b, ln1_s, ln1_b, ln2_s, ln2_b, s1, s2,
                            out, buf_y, buf_big, x1, batch, seq, dim, heads,
                            mlp, valid_len, eps, stream_ptr);
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
