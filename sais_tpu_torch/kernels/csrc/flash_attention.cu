// K2: masked flash-attention forward in f32, for Hopper (sm_90a): q' K^T
// on the tensor cores in 3xTF32, P V on f32 FFMA.
//
// Replaces sais_tpu/kernels/flash_attention.py::_flash_fwd_kernel (reached
// through flash_attention -> _run_fwd), the Pallas kernel that streams key
// blocks of one (batch*head, query block) through an online softmax in TPU
// VMEM.  It computes, in f32 as the TPU kernel does:
//
//   q'   = f32(q * Dh^-0.5)                       the query pre-scaled once
//   s    = q' k^T + bias[key]                     bias 0 or -1e30 (masked)
//   m    = running row max, starting at -1e30     (no inf - inf can arise)
//   l    = l * exp(m_old - m) + sum exp(s - m)
//   acc  = acc * exp(m_old - m) + exp(s - m) @ v
//   out  = acc / max(l, 1e-30),  lse = m + log(max(l, 1e-30))
//
// and, when asked (flash_attention with a key mask), writes zeros for every
// row of a batch element whose keys are all masked (flash_attention.py:496).
//
// Products: the JAX kernel rounds nowhere below f32, and a single TF32
// pass keeps about three decimal digits.  q' K^T runs as three TF32
// products of a big / small split (flash_tf32.cuh): f32 FFMA's accuracy
// on the tensor cores.  q' is split after the scaling; the bias is added
// after the product and never split, so a masked score is exactly -1e30
// and an all-masked element's lse exactly -1e30.  P V runs on f32 FFMA
// with round-to-nearest sums (below).
//
// Where the signed error came from (chip_smoke.py's classification
// phase, the tf32_sum_probe micro-kernel): the tensor core truncates each
// k-step's part of a score toward zero, so every score's magnitude shrank
// (-3.8e-8 of the mean |score| over a head width of 96) and the softmax
// came out flatter; at the MIL fit's first layer K2's output sat 18.6x the
// dense f32 path's signed error from float64.  Each score's k-step parts
// now get `unbias` (mma3<kWidthTie>).  P V's sums over keys in 3xTF32
// with the same tie erred the other way as much, so together they read
// 34.5x; P V on FFMA and the tied scores read 1.42x.
//
// What bounds it on an H100 (SXM data-sheet peaks at 700 W): two chained
// products of 2 Dh flops per (query, valid key) pair, q' K^T's three TF32
// products at 494.7 TFLOP/s dense TF32 and P V's one at 67 TFLOP/s f32,
// against reading q, k, v and the bias and writing out and lse once at
// 3.35 TB/s.  At the steps path's (B*S = 132, H = 4, L = 301, Dh = 96)
// that is 18.4 GFLOP against 245 MB: 0.193 ms against 0.073 ms, bound by
// operations.  At (8, 4, 2001, 96) masked, 40.7 GFLOP against 99 MB:
// 0.427 ms.
//
// Design:
//
// - One block of 4 warps per (batch*head, tile of 64 queries), the grid
//   flattened to one dimension; each warp owns 16 query rows.  The q' tile
//   is split once, into big and small planes resident in shared memory,
//   from which a warp reads its A fragments as they are (held in
//   registers beside the rest, q' made ptxas spill).
// - Keys in tiles of 32, double-buffered: K, V and the bias of tile i + 1
//   are requested with cp.async before tile i's products.  Tiles of 32
//   keep the block at 102,656 bytes at Dh 96 (the two q' planes, two
//   stages of K and V), so two blocks share an SM.  Rows are padded to
//   Dh + 4 floats; q' and K are read by row (s = q' K^T), V by row (P V),
//   all free of bank conflicts.
// - s = q' K^T, 16 x 32 a warp, lands in the m16n8 C fragments: each row's
//   32 scores lie in the 4 threads of a quad, which reduce the row max and
//   sum with two shuffles.  Each k-step's part of a score is rounded into
//   the score with `unbias` (mma3<kWidthTie>).  P = exp(s - m) stays in
//   those registers.  At Dh 192 the k-steps of q' K^T run in a loop that
//   is not unrolled, which keeps the kernel in registers.
// - acc = acc * alpha, then P V on FFMA, keys in order: each p of the
//   thread's two rows comes from the quad lane that holds it (a shuffle),
//   and V's row is read from shared memory as float2 at the thread's
//   output columns, the same row for the whole warp (a broadcast).
// - The last key tile is zero-filled and its missing keys get a bias of
//   -inf, so their p is exactly 0 (the TPU's -1e30 pad keys give 0 on every
//   row that has a valid key).  Rows past Lq are zero and never stored.
// - No length ceiling: K and V stream from device memory tile by tile.
// - Any head width up to 192 (a rep_dim of up to 768 over 4 heads): the
//   kernel is compiled for DH = 32, 64, 96, 128 and 192 and takes a
//   runtime width dh <= DH, a multiple of 4.  Columns dh .. DH - 1 are
//   zero-filled in every tile and never stored, and the scale is the
//   caller's dh^-0.5: the zero padding of the JAX package's kernel, which
//   pads every width to 128 lanes, and the same values.  The Python
//   wrapper packs a width that is not a multiple of 4 into an aligned
//   buffer first.  At DH 192 the block holds 200,960 bytes (one block an
//   SM).
//
// Operands take strides (in elements) for batch, head and row; the last
// axis must be contiguous and every row 16-byte aligned.  So the temporal
// encoder hands q, k and v as views of its (B, L, 3 D) projection, and the
// output lands in a (B, L, H, Dh) buffer, with no transposing copy either
// way.  bias is (B, Lk) and lse (B, H, Lq), both contiguous.  The order of
// every sum is fixed by the tiles, not by the strides.
//
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr float kNegInf = -1e30f;   // the JAX kernel's masked bias and m0
constexpr int BQ = 64;              // query rows per block
constexpr int BKEY = 32;            // keys per tile
constexpr int THREADS = 128;        // 4 warps of 16 query rows
constexpr int NKT = BKEY / 8;       // key n-tiles of a score tile

template <int DH>
struct Layout {
  static constexpr int LD = DH + 4;           // = 4 (mod 32) banks
  static constexpr int TILE = BKEY * LD;      // one K or V tile
  static constexpr int QBIG = 0;              // q' split: BQ rows each
  static constexpr int QSMALL = BQ * LD;
  // stage s: K at KV + 2 s TILE, V at KV + (2 s + 1) TILE
  static constexpr int KV = 2 * BQ * LD;
  static constexpr int BIAS = KV + 4 * TILE;  // 2 stages x BKEY
  static constexpr size_t bytes = (size_t)(BIAS + 2 * BKEY) * sizeof(float);
};

struct Strides {
  long long b, h, l;
};

// max / sum over the 4 threads of a quad (one row's scores of a tile)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int lq, int lk,
                     int dh, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int zero_masked_rows) {
  using LY = Layout<DH>;
  constexpr int LD = LY::LD;
  constexpr int KS = DH / 8;     // k-steps of q' K^T; n-tiles of P V
  constexpr int CH = DH / 4;     // 16-byte chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + LY::BIAS;

  const int nqt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;   // the thread's rows

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  int valid = 0;   // a key of this element with bias > -1e30
  auto load_tile = [&](int stage, int k0) {
    float* Ks = smem + LY::KV + 2 * stage * LY::TILE;
    float* Vs = Ks + LY::TILE;
    for (int i = tid; i < BKEY * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk && c < dh;   // else zero-filled
      const long long row = ok ? k0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
      cp_async16(Vs + r * LD + c, vb + row * sv.l + col, ok);
    }
    cp_async_commit();
    if (tid < BKEY) {
      float bv = -INFINITY;   // no key at all: p = 0 exactly
      if (k0 + tid < lk) bv = biasb ? biasb[k0 + tid] : 0.f;
      Bs[stage * BKEY + tid] = bv;
      valid |= bv > kNegInf;
    }
  };
  load_tile(0, 0);

  // the q' tile, split (rows past lq and columns past dh are zero and
  // never stored)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < lq && c < dh)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    const float4 big = make_float4(rna_tf32(x.x), rna_tf32(x.y),
                                   rna_tf32(x.z), rna_tf32(x.w));
    *reinterpret_cast<float4*>(smem + LY::QBIG + r * LD + c) = big;
    *reinterpret_cast<float4*>(smem + LY::QSMALL + r * LD + c) =
        make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
  }
  const int qa = (16 * warp + g) * LD + t;   // the warp's A fragments

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nkt = (lk + BKEY - 1) / BKEY;
  for (int it = 0; it < nkt; ++it) {
    const int cur = it & 1;
    if (it + 1 < nkt) {
      load_tile(cur ^ 1, (it + 1) * BKEY);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, q') complete
    const float* Ks = smem + LY::KV + 2 * cur * LY::TILE;
    const float* Vs = Ks + LY::TILE;
    const float* Bc = Bs + cur * BKEY;

    // s = q' K^T: 16 x 32 a warp, rows g / g + 8, keys 8 n + 2t (+1)
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll(DH > 128 ? 1 : DH / 8)
    for (int kk = 0; kk < KS; ++kk) {
      FragA a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = qa + 8 * kk + (e & 1) * 8 * LD + (e >> 1) * 4;
        a.big[e] = __float_as_uint(smem[LY::QBIG + at]);
        a.small[e] = __float_as_uint(smem[LY::QSMALL + at]);
      }
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        const float* kr = Ks + (8 * n + g) * LD + 8 * kk + t;
        mma3<kWidthTie>(s[n], a, split(kr[0]), split(kr[4]));
      }
    }

    // online softmax: + bias, row max and sum over the quad, rescale acc
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(Bc + 8 * n + 2 * t);
      s[n][0] += bb.x;
      s[n][1] += bb.y;
      s[n][2] += bb.x;
      s[n][3] += bb.y;
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];   // the rescale of rows g and g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mt[i]));
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        s[n][2 * i] = expf(s[n][2 * i] - m_new);
        s[n][2 * i + 1] = expf(s[n][2 * i + 1] - m_new);
        ps += s[n][2 * i];
        ps += s[n][2 * i + 1];
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + quad_sum(ps);
      m[i] = m_new;
    }

    // acc = acc * alpha + P V on f32 FFMA, keys in order: each p of the
    // thread's two rows comes from the quad lane that holds it, V's row
    // is read as float2 at the thread's columns 8 j + 2 t (+1), one row
    // for the whole warp (a broadcast, no bank conflict)
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    const int quad = lane & ~3;
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int src = 0; src < 4; ++src)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p0 = __shfl_sync(0xffffffffu, s[n][c], quad | src);
          const float p1 = __shfl_sync(0xffffffffu, s[n][2 + c], quad | src);
          const float* vr = Vs + (8 * n + 2 * src + c) * LD + 2 * t;
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * j);
            acc[j][0] = __fmaf_rn(p0, vv.x, acc[j][0]);
            acc[j][1] = __fmaf_rn(p0, vv.y, acc[j][1]);
            acc[j][2] = __fmaf_rn(p1, vv.x, acc[j][2]);
            acc[j][3] = __fmaf_rn(p1, vv.y, acc[j][3]);
          }
        }
    __syncthreads();   // stage cur free for tile it + 2
  }

  const int any_valid = __syncthreads_or(valid);
  const bool zero = zero_masked_rows && !any_valid;
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    if (r >= lq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (8 * j + 2 * t >= dh) continue;   // dh is even: both or neither
      float2 y = make_float2(acc[j][2 * i] / l_safe, acc[j][2 * i + 1] / l_safe);
      if (zero) y = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(ob + r * so.l + 8 * j + 2 * t) = y;
    }
    if (t == 0) lse[(size_t)bh * lq + r] = m[i] + logf(l_safe);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float* lse, int batch,
                   int heads, int lq, int lk, int dh, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int zero_masked_rows,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<DH>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)batch * heads * ((lq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<DH><<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, k, v, bias, o, lse, heads, lq, lk, dh, sq, sk, sv, so, scale,
      zero_masked_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, L, Dh) f32 with the given element strides for batch,
// head and row (the last axis contiguous); bias: (B, Lk) f32 or null (no
// key masked); lse: (B, H, Lq) f32; dh a multiple of 4 up to 192, scale
// dh^-0.5 or the caller's (an unpadded width's).  zero_masked_rows != 0: a
// batch element whose every bias is <= -1e30 gets zero output rows.
// Returns 0, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper checks those first).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* o, void* lse, int batch,
                        int heads, int lq, int lk, int dh, long long q_sb,
                        long long q_sh, long long q_sl, long long k_sb,
                        long long k_sh, long long k_sl, long long v_sb,
                        long long v_sh, long long v_sl, long long o_sb,
                        long long o_sh, long long o_sl, float scale,
                        int zero_masked_rows, void* stream_ptr) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || dh < 4 || dh % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, so{o_sb, o_sh, o_sl};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  // the smallest instance that holds the width
#define SAIS_FLASH_CASE(d)                                                  \
  if (dh <= d)                                                              \
    return (int)launch<d>(f(q), f(k), f(v), f(bias), of, lf, batch, heads, \
                          lq, lk, dh, sq, sk, sv, so, scale,                \
                          zero_masked_rows, stream);
  SAIS_FLASH_CASE(32) SAIS_FLASH_CASE(64) SAIS_FLASH_CASE(96)
  SAIS_FLASH_CASE(128) SAIS_FLASH_CASE(192)
#undef SAIS_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
