// A probe of where the 3xTF32 sums of K2 and K3 (flash_tf32.cuh) gather a
// signed error: one warp a tile computes C (16 x 8) = A (16 x K) B (K x 8)
// a k-step of 8 at a time, in one of these modes:
//
// mode 0  mma3<kKeysTie>, as K2's P V ran before it moved to FFMA: the
//         three TF32 products of a k-step run into one fragment of zeros
//         (small x big, big x small, big x big), the part gets `unbias` and
//         is added to C with f32 round-to-nearest
// mode 1  as 0, but each product runs into its own fragment of zeros and
//         the three are added in f32 round-to-nearest, small ones first
// mode 2  as 0 without `unbias`: mma3<kWidth>, the sums over the head width
// mode 3  f32 FFMA with round-to-nearest, k in order (no tensor core)
//
// chip_smoke.py's classification phase feeds it P V's operands (p in
// [0, 1), v of one sign; also with p or v rounded to TF32 first) and q' K^T's
// (both of either sign) and holds each against float64: the share of the
// signed error a case removes says where it enters.
//
// a: (tiles, 16, K) f32, b: (tiles, K, 8) f32, c: (tiles, 16, 8) f32; K a
// multiple of 8.  Not a port of a TPU kernel: a measurement.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tf32.cuh"

namespace {

using namespace tf32x3;

__global__ void probe_kernel(const float* __restrict__ p,
                             const float* __restrict__ v,
                             float* __restrict__ c, int kdim, int mode) {
  const int tile = blockIdx.x;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float* pt = p + (size_t)tile * 16 * kdim;
  const float* vt = v + (size_t)tile * kdim * 8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode == 3) {
    for (int k = 0; k < kdim; ++k) {
      const float p0 = pt[g * kdim + k], p1 = pt[(g + 8) * kdim + k];
      const float v0 = vt[k * 8 + 2 * t], v1 = vt[k * 8 + 2 * t + 1];
      acc[0] = __fmaf_rn(p0, v0, acc[0]);
      acc[1] = __fmaf_rn(p0, v1, acc[1]);
      acc[2] = __fmaf_rn(p1, v0, acc[2]);
      acc[3] = __fmaf_rn(p1, v1, acc[3]);
    }
  } else {
    for (int k0 = 0; k0 < kdim; k0 += 8) {
      const FragA a = split_a(pt[g * kdim + k0 + t],
                              pt[(g + 8) * kdim + k0 + t],
                              pt[g * kdim + k0 + t + 4],
                              pt[(g + 8) * kdim + k0 + t + 4]);
      const Split s0 = split(vt[(k0 + t) * 8 + g]);
      const Split s1 = split(vt[(k0 + t + 4) * 8 + g]);
      if (mode == 1) {
        float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f},
              z[4] = {0.f, 0.f, 0.f, 0.f};
        mma(x, a.small, s0.big, s1.big);
        mma(y, a.big, s0.small, s1.small);
        mma(z, a.big, s0.big, s1.big);
        for (int e = 0; e < 4; ++e)
          acc[e] = __fadd_rn(acc[e],
                             unbias(__fadd_rn(__fadd_rn(x[e], y[e]), z[e])));
      } else if (mode == 2) {
        mma3<kWidth>(acc, a, s0, s1);
      } else {
        mma3<kKeysTie>(acc, a, s0, s1);
      }
    }
  }
  float* ct = c + (size_t)tile * 128;
  ct[g * 8 + 2 * t] = acc[0];
  ct[g * 8 + 2 * t + 1] = acc[1];
  ct[(g + 8) * 8 + 2 * t] = acc[2];
  ct[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t value; launches on the caller's stream.
int tf32_sum_probe(const void* p, const void* v, void* c, int tiles, int kdim,
                   int mode, void* stream_ptr) {
  if (tiles < 1 || kdim < 8 || kdim % 8 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  probe_kernel<<<tiles, 32, 0, reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(p), static_cast<const float*>(v),
      static_cast<float*>(c), kdim, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
