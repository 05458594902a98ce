// K5: backward of the MLP half of a pre-norm ViT block in bf16, for Hopper
// (sm_90a).
//
// Replaces sais_tpu/kernels/fused_mha.py::_mlp_bwd_kernel (reached through
// _fused_block_bwd_mlp), the backward through
//
//   out = x1 + [s2 *] fc2(gelu_tanh(fc1(LN2(x1))))
//
// with the JAX kernel's rounding points:
//
//   y    = bf16(LN2(x1))                       recomputed, LN in f32
//   h    = bf16(y @ W1) + b1                   bf16 add
//   g    = bf16(gelu(h)),  dg32 = gelu'(h)     f32 from the bf16 h
//   do2  = bf16(dout * s2)                     (dout without scales)
//   dW2  = g^T do2,  db2 = sum do2             f32 over all B*L rows
//   dh   = bf16((do2 @ W2^T) * dg32)
//   dW1  = y^T dh,   db1 = sum dh
//   dy   = dh @ W1^T                           f32
//   dln2_s = sum dy * xhat,  dln2_b = sum dy
//   dx1  = bf16(LN2_bwd(dy) + f32(dout))       the residual passes unscaled
//
// What bounds it on an H100: 40 L D^2 flops an image (the five products of
// 2 L D 4D each) against ~0.5 MB of activations, so tensor-core operations
// (3.1 TFLOP a DINO step at batch 64, about 3.1 ms at 989 TFLOP/s bf16).
// The TPU kernel adds each grid step's weight gradients into f32 VMEM
// outputs, which is safe only because a TPU grid runs one step at a time.
// Here blocks run concurrently, so every weight gradient is a product with
// K = B*L rows, split over K into per-block f32 partials that one more
// kernel sums in split order, and every bias and LayerNorm gradient is a
// column sum over fixed row chunks, summed the same way: no atomics, no
// read-modify-write across blocks, results independent of block order.
//
// One C entry point enqueues the sequence on the caller's stream; every
// product runs on the tensor cores (the GEMM of vit_block_common.cuh with
// transposed operands where the backward needs them), intermediates (y, h
// then dh, g, do2, dy) round-trip through device memory.

#include "vit_block_common.cuh"

extern "C" {

// f32 elements of the workspace fused_block_bwd_mlp needs (the caller
// allocates it).
size_t fused_block_bwd_mlp_workspace(int rows, int dim, int mlp) {
  size_t n = wgrad_workspace(mlp, dim, rows);
  const size_t w1 = wgrad_workspace(dim, mlp, rows);
  if (w1 > n) n = w1;
  const size_t cs = (size_t)colsum_splits(rows) * mlp;
  return cs > n ? cs : n;
}

// x1, dout: (rows, dim) bf16; s2: (rows,) bf16 or null; weights bf16 as
// the JAX package lays them out (fc1_w (dim, mlp), fc2_w (mlp, dim)).
// Outputs: dx1 (rows, dim) bf16; dfc1_w (dim, mlp), dfc1_b (mlp), dfc2_w
// (mlp, dim), dfc2_b, dln2_s, dln2_b (dim) f32.  Scratch: buf_y, buf_do2
// (rows, dim) bf16 (buf_do2 only read when s2 is given), buf_h, buf_g
// (rows, mlp) bf16, buf_dy (rows, dim) f32, buf_stats (2 rows) f32,
// workspace (fused_block_bwd_mlp_workspace) f32.
int fused_block_bwd_mlp(const void* x1, const void* dout, const void* s2,
                        const void* fc1_w, const void* fc1_b,
                        const void* fc2_w, const void* fc2_b,
                        const void* ln2_s, const void* ln2_b, void* dx1,
                        void* dfc1_w, void* dfc1_b, void* dfc2_w,
                        void* dfc2_b, void* dln2_s, void* dln2_b, void* buf_y,
                        void* buf_do2, void* buf_h, void* buf_g, void* buf_dy,
                        void* buf_stats, void* workspace, int rows, int dim,
                        int mlp, float eps, void* stream_ptr) {
  if (rows < 1 || dim % BK != 0 || mlp % BK != 0 || dim < BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  const bf16* x1b = w(x1);
  bf16* y = static_cast<bf16*>(buf_y);
  bf16* h = static_cast<bf16*>(buf_h);   // h, then dh in place
  bf16* g = static_cast<bf16*>(buf_g);
  float* dy = static_cast<float*>(buf_dy);
  float* mean = static_cast<float*>(buf_stats);
  float* rstd = mean + rows;
  float* ws = static_cast<float*>(workspace);
  const bf16* do2 = w(dout);
  cudaError_t e;
  if ((e = layer_norm(x1b, w(ln2_s), w(ln2_b), y, mean, rstd, rows, dim, eps,
                      stream))) return (int)e;
  if ((e = gemm<EPI_GELU_SAVE, false, false>(y, w(fc1_w), w(fc1_b), h, rows,
                                             mlp, dim, stream, nullptr,
                                             nullptr, nullptr, g)))
    return (int)e;
  if (s2 != nullptr) {
    if ((e = scale_rows(w(dout), w(s2), static_cast<bf16*>(buf_do2), rows,
                        dim, stream))) return (int)e;
    do2 = w(buf_do2);
  }
  // dh = bf16((do2 @ W2^T) * gelu'(h)), written over h
  if ((e = gemm<EPI_DGELU, false, true>(do2, w(fc2_w), nullptr, h, rows, mlp,
                                        dim, stream, nullptr, nullptr, h)))
    return (int)e;
  // dy = dh @ W1^T in f32
  if ((e = gemm<EPI_F32, false, true>(h, w(fc1_w), nullptr, dy, rows, dim,
                                      mlp, stream))) return (int)e;
  if ((e = ln_bwd(dy, x1b, mean, rstd, w(ln2_s), w(dout),
                  static_cast<bf16*>(dx1), rows, dim, stream))) return (int)e;
  if ((e = wgrad(g, do2, static_cast<float*>(dfc2_w), ws, mlp, dim, rows,
                 stream))) return (int)e;
  if ((e = wgrad(y, h, static_cast<float*>(dfc1_w), ws, dim, mlp, rows,
                 stream))) return (int)e;
  if ((e = colsum<COLSUM_BF16>(do2, nullptr, nullptr, nullptr, ws,
                               static_cast<float*>(dfc2_b), rows, dim,
                               stream))) return (int)e;
  if ((e = colsum<COLSUM_BF16>(h, nullptr, nullptr, nullptr, ws,
                               static_cast<float*>(dfc1_b), rows, mlp,
                               stream))) return (int)e;
  if ((e = colsum<COLSUM_F32>(dy, nullptr, nullptr, nullptr, ws,
                              static_cast<float*>(dln2_b), rows, dim,
                              stream))) return (int)e;
  if ((e = colsum<COLSUM_F32_XHAT>(dy, x1b, mean, rstd, ws,
                                   static_cast<float*>(dln2_s), rows, dim,
                                   stream))) return (int)e;
  return 0;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
