// Shared by K2 (flash_attention.cu) and K3 (flash_attention_bwd.cu): f32
// products on Hopper's tensor cores through a 3xTF32 split, and the
// cp.async copies that stage their tiles.
//
// The split (the "3xTF32" of CUTLASS's fast-accurate f32 GEMM):
//
//   x_big   = rna_tf32(x)     (bits + 0x1000) & 0xffffe000: x rounded to the
//                             11 significant bits of TF32, ties away
//   x_small = x - x_big       exact in f32; the tensor core reads its top
//                             11 significant bits (the low 13 are ignored)
//   a b    ~= a_small b_big + a_big b_small + a_big b_big
//
// Each TF32 product is exact in f32 (11 x 11 bits fit the 24 of f32), and
// the three run into one f32 accumulator, small terms first, so a product
// keeps about 22 bits of each operand: f32 FFMA's accuracy, where a single
// TF32 pass keeps three decimal digits.  a_small b_small (2^-22 relative)
// is dropped, and so is what the tensor core cuts off x_small (at most
// 2^-10 of a term at most 2^-12 of x, with x_small's random sign).
// x_big is the value cvt.rna.tf32.f32 gives; it is computed with an integer
// add and a mask, and x_small is not rounded again: a split is then three
// integer and f32 instructions, and two cvt.rna.tf32.f32 per value ran
// K2 and K3 markedly slower on the card.  The splits are the bulk of the
// kernels' instructions outside the tensor cores.
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

// c += a b in 3xTF32: one accumulator, small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0,
                                     float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  mma(c, a.small, s0.big, s1.big);
  mma(c, a.big, s0.small, s1.small);
  mma(c, a.big, s0.big, s1.big);
}

// acc[j] = fold(acc[j], C B[:, 8j .. 8j + 7], e) for j < NT, where the A
// operand is a tile of C fragments c (NK k-steps of 8 columns, in the
// permuted k order) and B a row-major tile read by column from b =
// &B[2t][g].  Each group of CG output n-tiles is summed into a zeroed
// temporary first and then folded into acc with f32 rounding: the tensor
// core truncates as it accumulates, so a running sum over a whole sequence
// would gather that error tile after tile, while the temporary's error is
// relative to one tile's part.
template <int NK, int NT, int CG, int LD, typename Fold>
__device__ __forceinline__ void accumulate_product(float (&acc)[NT][4],
                                                   const float (&c)[NK][4],
                                                   const float* b, Fold fold) {
  static_assert(NT % CG == 0, "column groups must tile the output");
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += CG) {
    float tmp[CG][4];
#pragma unroll
    for (int jj = 0; jj < CG; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[jj][e] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NK; ++kn) {
      const FragA a = split_c_as_a(c[kn]);
      const float* br = b + 8 * kn * LD + 8 * j0;
#pragma unroll
      for (int jj = 0; jj < CG; ++jj)
        mma3(tmp[jj], a, br[8 * jj], br[LD + 8 * jj]);
    }
#pragma unroll
    for (int jj = 0; jj < CG; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j0 + jj][e] = fold(acc[j0 + jj][e], tmp[jj][e], e);
  }
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

}  // namespace tf32x3
