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
// the card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations:
// for 256 images 178.5 GFLOP of products and 15.3 of attention, 0.1959 ms
// at 989 TFLOP/s bf16.  A TPU-style single program per image does not
// fit: the qkv of one image alone is 454 KB and a block has at most 227 KB
// of shared memory.  So this design is one C entry point that enqueues
// seven kernels on the caller's stream:
//
//   (1) layer_norm_kernel              LN1 -> y
//   (2) gemm_sm90_kernel<EPI_BIAS>     y @ Wqkv + b -> qkv
//   (3) attention_kernel<KT>           up to 256 tokens, per (head,
//                                      image): K and V loaded once into
//                                      shared memory; a warp keeps a query
//                                      tile's whole key row of scores in
//                                      registers, two-pass f32 softmax, P
//                                      re-used as the A operand; past 256
//       long_attention_sm90_kernel     per (image, head, three 64-query
//                                      tiles), K and V streamed by TMA in
//                                      64-key tiles, two sweeps on wgmma
//                                      (attention_sm90.cuh)
//   (4) gemm_sm90_kernel<EPI_RESIDUAL> [s1 *] (ctx @ Wproj + b) + x -> x1
//   (5) layer_norm_kernel              LN2 -> y
//   (6) gemm_sm90_kernel<EPI_GELU>     y @ W1 + b1, tanh-GELU -> h
//   (7) gemm_sm90_kernel<EPI_RESIDUAL> [s2 *] (h @ W2 + b2) + x1 -> out
//
// The four products, 92% of the flops, run on gemm_sm90.cuh: TMA loads
// into a 4-stage shared-memory ring, wgmma.mma_async on two consumer
// warpgroups, the epilogues on the accumulators, a TMA store.  Up to 256
// tokens the attention stays on mma.sync (vit_block_common.cuh), past them
// it runs on wgmma + TMA (attention_sm90.cuh); K8 runs both.  The
// intermediates (y, qkv / h, x1) round-trip through device memory, about
// 4x the bytes of the TPU kernel.  Later work: LayerNorm in the GEMM
// prologue, the MLP fused (h kept on chip), a persistent GEMM scheduler.
//
// The kernels allocate nothing: the caller passes the scratch buffers.

#include "attention_sm90.cuh"

namespace {

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
  if (heads <= 0 || dim != heads * DH || dim % sm90::BK != 0 ||
      mlp % sm90::BK != 0 || seq < 1 || valid_len < 1 || valid_len > seq ||
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
  if ((e = layer_norm(xb, w(ln1_s), w(ln1_b), y, M, dim, eps, stream)))
    return e;
  if ((e = gemm_sm90<EPI_BIAS>(y, w(qkv_w), w(qkv_b), big, M, 3 * dim, dim,
                               stream))) return e;
  if ((e = attention(big, y, batch, seq, dim, heads, valid_len, stream))) return e;
  if ((e = gemm_sm90<EPI_RESIDUAL>(y, w(proj_w), w(proj_b), x1, M, dim, dim,
                                   stream, xb, w(s1)))) return e;
  if ((e = layer_norm(x1, w(ln2_s), w(ln2_b), y, M, dim, eps, stream)))
    return e;
  if ((e = gemm_sm90<EPI_GELU>(y, w(fc1_w), w(fc1_b), big, M, mlp, dim,
                               stream))) return e;
  if ((e = gemm_sm90<EPI_RESIDUAL>(big, w(fc2_w), w(fc2_b), o, M, dim, mlp,
                                   stream, x1, w(s2)))) return e;
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

// The blocks' GEMM alone (the card tests hold it against torch), epilogue
// codes as fused_mha.GEMM_EPILOGUES:
//   0 bias, 1 gelu, 2 residual [* row_scale]: C (M, N) = epilogue(A (M, K)
//     @ B (K, N)), aux the residual;
//   3 none: C = bf16(A @ B^T), B stored (N, K);
//   4 gelu_save: C = h, C2 = gelu(h), h = bf16(A @ B) + bias, B (K, N);
//   5 dgelu: C = bf16((A @ B^T) * gelu'(aux)), B (N, K);
//   6 f32: C (f32) = A @ B^T, B (N, K);
//   7 wgrad: C (f32, M x N) = A^T B, A stored (K, M), B (K, N): split over
//     K into workspace (vit_block_gemm_workspace f32), then summed.
// Pointers a mode does not read may be null.
constexpr int GEMM_WGRAD = 7;

size_t vit_block_gemm_workspace(int M, int N, int K) {
  return wgrad_partials(M, N, K);
}

int vit_block_gemm(const void* a, const void* b, const void* bias,
                   const void* aux, const void* row_scale, void* c, void* c2,
                   void* workspace, int M, int N, int K, int epilogue,
                   void* stream_ptr) {
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (epilogue) {
    case EPI_BIAS:
      return (int)gemm_sm90<EPI_BIAS>(w(a), w(b), w(bias), c, M, N, K,
                                      stream);
    case EPI_GELU:
      return (int)gemm_sm90<EPI_GELU>(w(a), w(b), w(bias), c, M, N, K,
                                      stream);
    case EPI_RESIDUAL:
      return (int)gemm_sm90<EPI_RESIDUAL>(w(a), w(b), w(bias), c, M, N, K,
                                          stream, w(aux), w(row_scale));
    case EPI_NONE:
      return (int)gemm_sm90<EPI_NONE, false, true>(w(a), w(b), nullptr, c, M,
                                                   N, K, stream);
    case EPI_GELU_SAVE:
      return (int)gemm_sm90<EPI_GELU_SAVE>(w(a), w(b), w(bias), c, M, N, K,
                                           stream, nullptr, nullptr,
                                           static_cast<bf16*>(c2));
    case EPI_DGELU:
      return (int)gemm_sm90<EPI_DGELU, false, true>(w(a), w(b), nullptr, c, M,
                                                    N, K, stream, w(aux));
    case EPI_F32:
      return (int)gemm_sm90<EPI_F32, false, true>(w(a), w(b), nullptr, c, M,
                                                  N, K, stream);
    case GEMM_WGRAD: {
      float* ws = static_cast<float*>(workspace);
      int kt;
      const int splits = wgrad_splits(M, N, K, &kt);
      cudaError_t e = wgrad_sm90(w(a), w(b), ws, M, N, K, stream);
      if (e != cudaSuccess) return (int)e;
      PartSums sums{{{ws, static_cast<float*>(c), M * N, splits}}, 1};
      return (int)sum_parts(sums, stream);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
