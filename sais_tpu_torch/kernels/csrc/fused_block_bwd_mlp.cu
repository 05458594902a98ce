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
// K = B*L rows, split over K into per-block f32 partials, and every bias
// and LayerNorm gradient is a set of per-chunk partial column sums; one
// launch at the end sums them all in a fixed order: no atomics, no
// read-modify-write across blocks, results independent of block order.
//
// One C entry point enqueues eight launches on the caller's stream; every
// product runs on the wgmma + TMA GEMM of gemm_sm90.cuh, its operands read
// in place (W2 and W1 as their transposes, g and y transposed for the
// weight gradients):
//
//   (1) bwd_prep_kernel          LN2(x1) -> y, mean, 1/std; do2; db2 parts
//   (2) gemm_sm90 EPI_GELU_SAVE  y @ W1 + b1 -> h, g
//   (3) gemm_sm90 EPI_DGELU      do2 @ W2^T, * gelu'(h) -> dh over h;
//                                db1 parts (per 64-row half)
//   (4) gemm_sm90 EPI_F32        dh @ W1^T -> dy (f32)
//   (5) ln_bwd_kernel            dx1; dln2_b, dln2_s parts
//   (6) gemm_sm90 A_MN, split K  g^T do2 -> dW2 parts
//   (7) gemm_sm90 A_MN, split K  y^T dh -> dW1 parts
//   (8) sum_parts_kernel         every gradient, parts in fixed order
//
// Intermediates (y, h then dh, g, do2, dy) round-trip through device
// memory.

#include "gemm_sm90.cuh"

namespace {

// The workspace: each gradient's partials, in floats, in the order the
// final sum reads them.
struct MlpParts {
  size_t db2, db1, dln_b, dln_s, dw2, dw1, total;
  MlpParts(int rows, int dim, int mlp) {
    const size_t chunks = row_chunks(rows), halves = (rows + 63) / 64;
    db2 = 0;
    db1 = db2 + chunks * dim;
    dln_b = db1 + halves * mlp;
    dln_s = dln_b + chunks * dim;
    dw2 = dln_s + chunks * dim;
    dw1 = dw2 + wgrad_partials(mlp, dim, rows);
    total = dw1 + wgrad_partials(dim, mlp, rows);
  }
};

}  // namespace

extern "C" {

// f32 elements of the workspace fused_block_bwd_mlp needs (the caller
// allocates it).
size_t fused_block_bwd_mlp_workspace(int rows, int dim, int mlp) {
  return MlpParts(rows, dim, mlp).total;
}

// x1, dout: (rows, dim) bf16; s2: (rows,) bf16 or null; weights bf16 as
// the JAX package lays them out (fc1_w (dim, mlp), fc2_w (mlp, dim)).
// Outputs: dx1 (rows, dim) bf16; dfc1_w (dim, mlp), dfc1_b (mlp), dfc2_w
// (mlp, dim), dfc2_b, dln2_s, dln2_b (dim) f32.  Scratch: buf_y, buf_do2
// (rows, dim) bf16 (buf_do2 only written when s2 is given), buf_h, buf_g
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
  if (rows < 1 || dim % sm90::BK != 0 || mlp % sm90::BK != 0 ||
      dim < sm90::BK || dim > MAX_BWD_DIM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const bf16* x1b = w(x1);
  bf16* y = static_cast<bf16*>(buf_y);
  bf16* h = static_cast<bf16*>(buf_h);   // h, then dh in place
  bf16* g = static_cast<bf16*>(buf_g);
  float* dy = f(buf_dy);
  float* mean = f(buf_stats);
  float* rstd = mean + rows;
  float* ws = f(workspace);
  const MlpParts parts(rows, dim, mlp);
  const bf16* do2 = s2 != nullptr ? w(buf_do2) : w(dout);
  cudaError_t e;
  if ((e = bwd_prep(x1b, w(ln2_s), w(ln2_b), w(dout), w(s2), y, mean, rstd,
                    static_cast<bf16*>(buf_do2), ws + parts.db2, rows, dim,
                    eps, stream))) return (int)e;
  if ((e = gemm_sm90<EPI_GELU_SAVE>(y, w(fc1_w), w(fc1_b), h, rows, mlp, dim,
                                    stream, nullptr, nullptr, g)))
    return (int)e;
  // dh = bf16((do2 @ W2^T) * gelu'(h)), written over h
  if ((e = gemm_sm90<EPI_DGELU, false, true>(do2, w(fc2_w), nullptr, h, rows,
                                             mlp, dim, stream, h, nullptr,
                                             nullptr, ws + parts.db1)))
    return (int)e;
  // dy = dh @ W1^T in f32
  if ((e = gemm_sm90<EPI_F32, false, true>(h, w(fc1_w), nullptr, dy, rows,
                                           dim, mlp, stream))) return (int)e;
  if ((e = ln_bwd(dy, x1b, mean, rstd, w(ln2_s), w(dout),
                  static_cast<bf16*>(dx1), ws + parts.dln_b,
                  ws + parts.dln_s, rows, dim, stream))) return (int)e;
  if ((e = wgrad_sm90(g, do2, ws + parts.dw2, mlp, dim, rows, stream)))
    return (int)e;
  if ((e = wgrad_sm90(y, h, ws + parts.dw1, dim, mlp, rows, stream)))
    return (int)e;
  int kt;
  const int chunks = row_chunks(rows), halves = (rows + 63) / 64;
  PartSums sums{{{ws + parts.db1, f(dfc1_b), mlp, halves},
                 {ws + parts.db2, f(dfc2_b), dim, chunks},
                 {ws + parts.dln_b, f(dln2_b), dim, chunks},
                 {ws + parts.dln_s, f(dln2_s), dim, chunks},
                 {ws + parts.dw2, f(dfc2_w), mlp * dim,
                  wgrad_splits(mlp, dim, rows, &kt)},
                 {ws + parts.dw1, f(dfc1_w), dim * mlp,
                  wgrad_splits(dim, mlp, rows, &kt)}},
                6};
  return (int)sum_parts(sums, stream);
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
