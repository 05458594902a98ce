// Shared by K2 (flash_attention.cu, its q' K^T) and K3
// (flash_attention_bwd.cu): f32 products on Hopper's tensor cores through a
// 3xTF32 split, and the cp.async copies that stage their tiles.
//
// The split (the "3xTF32" of CUTLASS's fast-accurate f32 GEMM):
//
//   x_big   = rna_tf32(x)     (bits + 0x1000) & 0xffffe000: x rounded to the
//                             11 significant bits of TF32, ties away
//   x_small = x - x_big       exact in f32; the tensor core reads its top
//                             11 significant bits (the low 13 are ignored)
//   a b    ~= a_small b_big + a_big b_small + a_big b_big
//
// Each TF32 product is exact in f32 (11 x 11 bits fit the 24 of f32), and the
// three of a k-step run into one fragment of zeros, small terms first, that is
// then added to the running sum in f32 (mma3), so a product keeps about 22 bits
// of each operand: f32 FFMA's accuracy, where a single TF32 pass keeps three
// decimal digits.  a_small b_small (2^-22 relative) is dropped, and so is what
// the tensor core cuts off x_small (at most 2^-10 of a term at most 2^-12 of x,
// with x_small's random sign). x_big is the value cvt.rna.tf32.f32 gives; it is
// computed with an integer add and a mask, and x_small is not rounded again: a
// split is then three integer and f32 instructions, and two cvt.rna.tf32.f32
// per value ran K2 and K3 markedly slower on the card.  A tile that many warps
// read as B operands is split once, when it lands in shared memory, into a big
// and a small plane (split_planes, load_b): split at each use, every warp
// re-split the same values at every k-step, and those splits were the bulk of
// K3's instructions outside the tensor cores.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 g + t:
//   A (16 x 8):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8):   b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8):  c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                c3 = C[g+8][2t+1]
// A C tile that feeds the next product as its A operand (P in P V, dS in
// dS K) is used where it lies: the product contracts over the tile's
// columns, so their order within a k-step of 8 is free.  A k-index t is
// taken to mean column 2t and k-index t + 4 column 2t + 1; then
// (a0, a1, a2, a3) = (c0, c2, c1, c3) of the same thread, and the B rows
// are read in the same order (b0 from row 2t, b1 from row 2t + 1).  No
// shuffle and no trip through shared memory.
//
// What this costs on an H100: mma.sync TF32 peaks near 320 TFLOP/s on the card
// (65% of the dense TF32 rate; tools/mma_sync_rate.cu); a 3xTF32 k-step is 3
// HMMA and, with the tie (unbias) and the f32 add, 12 instructions beside them
// for its 4 values a thread, plus 3 for each value split at use.  So K2's
// scores and K3 are bound by issue slots and by shared-memory bandwidth (the
// fragment loads) more than by the tensor cores: planes that remove the splits
// of B and ldmatrix (ldsm4) that loads four 8 x 4 blocks in one instruction pay
// where warps re-read the same tile.
//
// Shared-memory tiles are f32, row-major, with a row stride of Dh + 4
// floats (= 4 mod 32 banks).  That one padding serves both ways a tile is
// read: by row, B[t][g] = T[g][t] at bank 4 g + t, and by column in the
// permuted order, T[2t][g] and T[2t+1][g] at banks 8 t + g and 8 t + 4 + g:
// 32 distinct banks each time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct Split {
  uint32_t big, small;
};

// x rounded to TF32, ties away from zero (cvt.rna.tf32.f32 for finite x)
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ Split split(float x) {
  const float big = rna_tf32(x);
  return {__float_as_uint(big), __float_as_uint(x - big)};
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment, split.
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const Split s0 = split(a0), s1 = split(a1), s2 = split(a2),
              s3 = split(a3);
  return {{s0.big, s1.big, s2.big, s3.big},
          {s0.small, s1.small, s2.small, s3.small}};
}

// A C fragment (rows g, g + 8; columns 2t, 2t + 1) as the A operand of a
// product over its columns, in the permuted k order above.
__device__ __forceinline__ FragA split_c_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// t, a k-step's part as the tensor core sums it (truncated toward zero),
// plus half an ulp of t with t's sign, rounded to nearest even: the sum is
// a tie, so it goes up or down by t's last bit, and the truncation no
// longer pulls every part the same way.  (Half an ulp from the sign and
// exponent of t, 2^-24 |t| rounded down to a power of two; 0 stays 0.)
__device__ __forceinline__ float unbias(float t) {
  return __fmaf_rn(__uint_as_float(__float_as_uint(t) & 0xff800000u),
                   0x1p-24f, t);
}

// What a running sum adds up, which decides how mma3 treats its parts:
//   kWidth     a sum over the head width (K3's scores s and dp): parts of
//              either sign, added as they are; the part starts from c * 0
//              (c is finite), so each k-step waits for the last one's sum:
//              without that dependency ptxas ran many k-steps' parts at
//              once and spilled.
//   kWidthTie  as kWidth, each part `unbias`ed (K2's scores): the parts'
//              truncations are of either sign, but each one shrinks the
//              part's magnitude, and the part's sign leans to the sum's,
//              so the sum's magnitude shrank (-3.8e-8 of the mean |s| over
//              a width of 96; tf32_sum_probe.cu) and the softmax flattened.
//   kKeysTie   a sum over keys whose parts may share one sign (dS K, P^T
//              dO, dS^T q' in K3): p >= 0, so wherever v's column or the
//              cotangent's keeps its sign every part has that sign, and
//              each part is `unbias`ed; the sum starts from plain zeros,
//              which ptxas keeps in registers and schedules faster than
//              c * 0 there.
enum Sum { kWidth, kKeysTie, kWidthTie };

// c += a b in 3xTF32 for one k-step of 8, b given as its split (s0 the value at
// row t, s1 at row t + 4): the three products run into a fragment of zeros,
// small terms first, and the k-step's part is then added to c with f32
// round-to-nearest.  SERIAL (kWidth, kWidthTie): the fragment starts from c * 0
// (the same zeros), which makes each k-step wait for the last one's sum;
// without it ptxas may run many k-steps' products at once (K2 does, within its
// registers; K3's kernels spilled).  The tensor core truncates its sum toward
// zero: run into c itself, every product cut c's low bits in the same
// direction, and a sum of many k-steps shrank coherently (K2's output sat
// -1.4e-7 of its mean |value| from the dense f32 path's at the MIL fit's
// shapes, a signed error several times f32's).  Here the truncation is relative
// to one k-step's part, and the running sum rounds to nearest.
template <Sum S = kWidth, bool SERIAL = true>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, Split s0,
                                     Split s1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if (S != kKeysTie && SERIAL)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] = c[e] * 0.f;
  mma(t, a.small, s0.big, s1.big);
  mma(t, a.big, s0.small, s1.small);
  mma(t, a.big, s0.big, s1.big);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    c[e] = __fadd_rn(c[e], S == kWidth ? t[e] : unbias(t[e]));
}

// A B value from shared memory.  PLANE == 0: the tile holds f32 values,
// split here at each use.  PLANE > 0: the tile was split once, when it
// landed, into a big plane (p) and a small plane PLANE floats further on
// (split_planes), and a use only loads the two.
template <int PLANE>
__device__ __forceinline__ Split load_b(const float* p) {
  if constexpr (PLANE == 0)
    return split(p[0]);
  else
    return {__float_as_uint(p[0]), __float_as_uint(p[PLANE])};
}

// Four values x split into the big plane at p and the small plane PLANE
// floats further on (p 16-byte aligned).
template <int PLANE>
__device__ __forceinline__ void split_planes(float* p, float4 x) {
  const float4 big = make_float4(rna_tf32(x.x), rna_tf32(x.y),
                                 rna_tf32(x.z), rna_tf32(x.w));
  *reinterpret_cast<float4*>(p) = big;
  *reinterpret_cast<float4*>(p + PLANE) =
      make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
}

// acc[j] = pre(acc[j], e) + C B[:, 8j .. 8j + 7] for j < NT, where the A
// operand is a tile of C fragments c (NK k-steps of 8 columns, in the
// permuted k order) and B a row-major tile read by column from b =
// &B[2t][g] (raw, or split into planes PLANE floats apart), all NT output
// n-tiles in one pass over the k-steps.  Each k-step's part is rounded
// into acc by mma3 in a fixed order.
template <int NK, int NT, int LD, int PLANE, Sum S, typename Pre>
__device__ __forceinline__ void accumulate_product(float (&acc)[NT][4],
                                                   const float (&c)[NK][4],
                                                   const float* b, Pre pre) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = pre(acc[j][e], e);
#pragma unroll
  for (int kn = 0; kn < NK; ++kn) {
    const FragA a = split_c_as_a(c[kn]);
    const float* br = b + 8 * kn * LD;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma3<S>(acc[j], a, load_b<PLANE>(br + 8 * j),
              load_b<PLANE>(br + LD + 8 * j));
  }
}

// Four 8 x 4 blocks of 32-bit values from shared memory in one
// instruction (ldmatrix .b16 reads a 32-bit value as two 16-bit ones):
// lane 8 j + r gives the address of row r of block j (16 bytes, 16-byte
// aligned), and r[j] gets the value at row g, column t of block j.  So
// the blocks (rows 0-7, cols 0-3), (rows 8-15, cols 0-3), (rows 0-7, cols
// 4-7), (rows 8-15, cols 4-7) of a row-major tile are an A fragment, and
// (rows 0-7, cols 0-3), (rows 0-7, cols 4-7) of a tile whose rows are the
// n index are the B fragment (b0, b1) of a product that reads it by row.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ldsm4's row offset (in floats) of lane `lane` for an A fragment (rows
// 0-15, k 0-7) and for the B fragments of two n-tiles (n rows 0-15, k 0-7)
// of a row-major tile with rows of `ld` floats.
__device__ __forceinline__ int ldsm_a(int lane, int ld) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4);
}
__device__ __forceinline__ int ldsm_b(int lane, int ld) {
  return ((lane & 7) + 8 * (lane >> 4)) * ld + 4 * ((lane >> 3) & 1);
}

// A barrier of the `threads` threads (whole warps) that name barrier `id`
// (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once a
// device: the attribute belongs to the device's context, and setting it
// at every launch cost a runtime call on the host each time.
template <auto Kernel>
__host__ cudaError_t allow_shared_once(size_t bytes) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  return e;
}

}  // namespace tf32x3
