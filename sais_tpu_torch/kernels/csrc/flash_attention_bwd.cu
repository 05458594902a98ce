// K3: masked flash-attention backward in f32, for Hopper (sm_90a), its
// products on the tensor cores in 3xTF32.
//
// Replaces sais_tpu/kernels/flash_attention.py::_run_bwd, which launches
// two Pallas kernels: _flash_bwd_dq_kernel (dq over query blocks) and
// _flash_bwd_dkv_kernel (dk and dv over key blocks).  From the forward's
// row logsumexp (lse, K2's second output) and delta = rowsum(dO * O),
// computed outside the kernels as JAX does, it recomputes in f32:
//
//   q'  = f32(q * Dh^-0.5)                     the query pre-scaled once
//   s   = q' k^T                               (Lq x Lk per batch*head)
//   p   = exp((s + bias[key]) - lse[query])    bias 0 or -1e30 (masked)
//   dp  = dO v^T
//   ds  = p * (dp - delta[query])
//   dv  = p^T dO
//   dk  = ds^T q'      (q' carries one factor of Dh^-0.5 already)
//   dq  = (ds k) * Dh^-0.5
//
// Lq and Lk may differ (the sequence-parallel ring feeds key chunks against
// the full query).  The bias gets no gradient.
//
// Products: the JAX kernels round nowhere below f32, so each f32 product
// runs as three TF32 products of a big / small split into one f32
// accumulator (flash_tf32.cuh): f32 FFMA's accuracy on the tensor cores,
// where one TF32 pass would keep three decimal digits.  q' is split after
// the scaling; P and dS are formed in f32 and split before they feed the
// next product; the bias is added after the product and never split.
//
// What bounds it on an H100 (SXM data-sheet peaks at 700 W): the least
// work is five products of 2 Dh flops per (query, valid key) pair (s, dp,
// dv, dk, dq), 10 Dh flops, each run as three TF32 products at 494.7
// TFLOP/s dense TF32, against q, k, v, out, dO, lse and the bias read once
// and dq, dk, dv written once at 3.35 TB/s.  At the steps path's (B*H =
// 528, L = 301, Dh = 96) that is 45.9 GFLOP (137.8 of TF32) against 489
// MB: 0.278 ms against 0.146 ms, bound by operations (the same work on
// f32 FFMA, 67 TFLOP/s, would take 0.685 ms).
// At (8, 4, 2001, 96) masked 0.616 ms, at (2, 4, 8193, 96) 3.126 ms.  The
// two-kernel split, like JAX's, computes s and dp in both kernels, 14 Dh
// flops a pair.
//
// Design:
//
// - Two kernels, as in JAX, so that each output tile has exactly one
//   owner: no atomics, and the result does not depend on block order.
//   dq: one block of 8 warps per (batch*head, tile of 64 queries), looping
//   over key tiles of 64.  dk / dv: one block of 8 warps per (batch*head,
//   tile of 64 keys), looping over query tiles of 64.
// - Warp w owns 16 rows (16 (w mod 4)) of the block's tile and one half
//   (w / 4) of the 64 columns of every tile it meets: 16 x 32 score tiles,
//   so that 8 warps share the loads, and each output row's sum is split
//   over two warps in a fixed way.  At the end the second half's partial
//   goes through shared memory and the first half adds it: dq = (its keys
//   32 i + 0..31 summed tile by tile) + (keys 32 i + 32..63), the same
//   order every run, whatever the strides.
// - The dk / dv kernel computes the TRANSPOSED tiles s^T = K q'^T and
//   dp^T = V dO^T (its rows are keys), so p^T and ds^T are the A operands
//   of p^T dO and ds^T q' where they lie, in the m16n8 C fragments (the
//   permuted k order of flash_tf32.cuh); likewise ds for ds K in the dq
//   kernel.  Nothing is transposed and nothing goes through shared memory
//   between products.
// - Each k-step's part of dq, dk and dv, and of each score, is rounded
//   into its running sum in f32 (mma3, accumulate_product): the tensor
//   core truncates as it accumulates, and summed straight into the running
//   sums that error shrank them coherently (K3's dq sat -9e-7 of its mean
//   from float64 at the MIL fit's shapes, 20x the dense f32 path's).  The
//   parts of the sums over keys (dq, dk, dv) are also unbiased (`unbias`
//   in flash_tf32.cuh, kKeysTie), and so are the parts of each recomputed
//   score (kWidthTie), as K2 forms them: p = exp(s - lse) must see the
//   scores whose lse K2 saved (with untied scores here, each p came out
//   low and dv read 4.7x the dense path's signed error).  The
//   dq kernel forms s, then dp, one product at a time.  Up to Dh 96 dk and
//   dv are one launch; at Dh 96 its thread forms p^T and adds it into dv
//   before it forms dp^T, so that the two running sums (96 floats) never
//   sit beside both tiles of scores, and ptxas keeps it in registers (two
//   launches, the second recomputing s^T, left K3 slower than SDPA's
//   backward).  From Dh 128 the running sums of dk and dv do not fit one
//   thread's registers beside the rest: dv and dk are two launches of the
//   kernel, each recomputing p^T (one product in four more), and at Dh
//   192 the dq kernel takes half of the columns a block (blockIdx.y),
//   recomputing s and dp for it.
// - Tiles in shared memory have rows of Dh + 4 floats, read by row (K in
//   q' K^T, V in dO V^T, q' and dO in the dk / dv kernel's score
//   products) and by column (K in ds K, dO in p^T dO, q' in ds^T q'), both
//   free of bank conflicts.  The streaming tiles (K and V in the dq
//   kernel, q' and dO in the dk / dv kernel) are the B operands of every
//   product that reads them, met by all 8 warps at every k-step: up to Dh
//   96 each is split once, when it lands, into a big and a small plane
//   (split_stream), and a k-step only loads its fragments and runs its
//   mmas (split at each use, those splits were most of the kernels'
//   instructions outside the tensor cores, and ran K3 slower than its
//   plain version).  The resident tiles (q' and dO in the dq kernel, K and
//   V in the dk / dv kernel) are A operands, 4 values a k-step a warp, and
//   stay f32, split at each use.
// - The streaming tiles are double-buffered with cp.async: the next key
//   tile (K, V, bias) in the dq kernel, the next query tile (q, dO, lse,
//   delta) in the dk / dv kernel is requested before the current tile's
//   products.  Up to Dh 96 it lands raw in a staging pair; when its turn
//   comes each thread splits the chunks it copied into the planes (q'
//   scaled first), and the next request follows.  Shared memory at Dh
//   96: the resident pair, four planes and the staging pair, 8 tiles of
//   64 x 100 floats, 206,080 bytes; one block of 8 warps an SM.  At Dh 128
//   two planes a streaming tile do not fit beside double buffering (270
//   KB), and the tiles stay f32 in two stages, split at each use: 6 tiles,
//   203 KB; the dk / dv kernel scales its q tile in place.
// - Exact shapes: rows past Lq or Lk are zero-filled in shared memory;
//   missing keys get a bias of -inf and missing queries an lse of +inf, so
//   their p is exactly 0 and they contribute nothing.  Masked keys keep
//   the -1e30 bias, so p is what the TPU computes, also for the rows of an
//   all-masked element (there the caller zeroes dO, and ds = 0 exactly).
//
// - Any head width up to 192, as K2 (flash_attention.cu): instances at DH
//   = 32, 64, 96, 128 and 192 take a runtime width dh <= DH, a multiple of
//   4; columns dh .. DH - 1 are zero-filled in every tile and never
//   stored, and the scale is the caller's.  At DH 192 six tiles of 64 x
//   196 floats (301 KB) do not fit an SM's 227 KB, so both kernels keep
//   one stage of their streaming tiles there (four tiles, 200,960 and
//   201,216 bytes): the next tile is requested after the current one's
//   products, not during them.  The dq, dk and dv launches each take half
//   of the columns a block there (blockIdx.y), recomputing the scores for
//   it: a running sum of all 192 columns spilled.
//
// Operands take element strides for batch, head and row; the last axis
// must be contiguous and every row 16-byte aligned.  So q, k, v, dO and the
// outputs dq, dk, dv may be (B, H, L, Dh) views of the temporal encoder's
// (B, L, 3 D) projection and of its gradient buffer.  bias is (B, Lk), lse
// and delta (B, H, Lq), all contiguous.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 8 warps: 4 row groups x 2 column halves
constexpr int HALF = 32;        // the columns a warp takes of a tile
constexpr int NH = HALF / 8;    // its n-tiles


// the dq kernel's column parts: at DH 192 a running sum of all 192
// columns spills, so each block takes half of them (blockIdx.y)
template <int DH>
constexpr int kDqParts = DH > 128 ? 2 : 1;

// stages of the streaming tiles: two (double-buffered) where they fit
template <int DH>
constexpr int kStages = DH > 128 ? 1 : 2;

// Up to Dh 96 the streaming tiles are split into planes when they land:
// the raw tile of the next step lands in a staging pair while the planes
// of this one are read, 8 tiles of 64 x (Dh + 4) floats (204,800 bytes at
// Dh 96).  At Dh 128 and 192 that does not fit an SM's 227 KB beside
// double buffering, and the tiles stay f32, split at each use.
template <int DH>
constexpr bool kPlanes = DH <= 96;

// The resident pair (q' and dO in the dq kernel, K and V in the dk / dv
// kernel) at 0 and TILE, then the streaming pair: with planes, their four
// planes (first big, first small, second big, second small) at STREAM
// and the raw staging pair at STAGE; without, S stages of the raw pair at
// STREAM + 2 s TILE.  Then per-row values (S stages, or 2 slots with
// planes), and the dk / dv kernel's 64 keys' bias.
template <int DH>
struct Layout {
  static constexpr bool P = kPlanes<DH>;
  static constexpr int S = kStages<DH>;
  static constexpr int SLOTS = P ? 2 : S;
  static constexpr int LD = DH + 4;     // = 4 (mod 32) banks
  static constexpr int TILE = 64 * LD;
  static constexpr int PLANE = P ? TILE : 0;   // big to small plane (load_b)
  static constexpr int STREAM = 2 * TILE;
  static constexpr int STAGE = STREAM + 4 * TILE;
  static constexpr int ROWS = P ? STAGE + 2 * TILE : STREAM + 2 * S * TILE;
  static constexpr int KEYS = ROWS + 2 * SLOTS * 64;
  static constexpr size_t bytes = (size_t)(KEYS + 64) * sizeof(float);
};

// Before tile `it`'s products: with two stages, request tile it + 1 into
// the other stage and wait for tile it; with one, request tile it (tile 0
// was requested before the loop) and wait for it.  Returns tile it's stage.
template <int S, typename Load>
__device__ __forceinline__ int next_tile(int it, int n, Load load) {
  if constexpr (S == 2) {
    const int cur = it & 1;
    if (it + 1 < n) {
      load(cur ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    return cur;
  } else {
    if (it > 0) load(0, it);
    cp_async_wait<0>();
    return 0;
  }
}

struct Strides {
  long long b, h, l;
};

// accumulate_product's prescale for a plain running sum
struct Keep {
  __device__ __forceinline__ float operator()(float x, int) const {
    return x;
  }
};

// Split one streaming tile's raw pair (staged at `raw`, second TILE
// floats on; the chunks this thread copied) into its four planes at
// `planes`, the first scaled by `scale`.
template <int DH>
__device__ __forceinline__ void split_stream(float* planes, const float* raw,
                                             float scale, int tid) {
  constexpr int LD = Layout<DH>::LD, TILE = Layout<DH>::TILE, CH = DH / 4;
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int at = (i / CH) * LD + (i % CH) * 4;
    float4 x = *reinterpret_cast<const float4*>(raw + at);
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    split_planes<TILE>(planes + at, x);
    split_planes<TILE>(planes + 2 * TILE + at,
                       *reinterpret_cast<const float4*>(raw + TILE + at));
  }
}

// The A fragment of rows g, g + 8 at k-step columns c, c + 4 of a
// row-major tile (p points at row g, column c).
template <int LD>
__device__ __forceinline__ FragA load_a(const float* p) {
  return split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}

// The second column half's partial sums, in their C fragments, go through
// shared memory (`red`, 4 x NT x 128 floats) to the first half, which
// adds them: acc = first + second, the same order every run.  Returns
// true in the warps that now hold the sums.
template <int NT>
__device__ __forceinline__ bool reduce_halves(float (&acc)[NT][4], float* red,
                                              int warp, int lane) {
  float* mine = red + (warp & 3) * NT * 128 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (warp >= 4) return false;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] + mine[(4 * j + e) * 32];
  return true;
}

// ---------------------------------------------------------------- dq --

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int heads, int lq, int lk,
                        int dh, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, float scale) {
  using LY = Layout<DH>;
  constexpr int LD = LY::LD;
  constexpr int PL = LY::PLANE;
  constexpr int KS = DH / 8;   // k-steps of the score products
  constexpr int CH = DH / 4;   // 16-byte chunks per row
  constexpr int NT = KS / kDqParts<DH>;   // the block's dq n-tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* DOs = smem + LY::TILE;
  float* Bs = smem + LY::ROWS;

  const int nqt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);      // the warp's query rows in the tile
  const int c0 = HALF * (warp >> 2);   // its keys in each key tile
  const int col0 = 8 * NT * blockIdx.y;   // the block's dq columns

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  // key tile kt's K and V: into the staging pair (planes), else into
  // stage `slot`; its bias into slot `slot`
  auto load_tile = [&](int slot, int kt) {
    const int k0 = kt * BK;
    float* Ks = smem + (LY::P ? LY::STAGE : LY::STREAM + 2 * slot * LY::TILE);
    float* Vs = Ks + LY::TILE;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk && c < dh;   // else zero-filled
      const long long row = ok ? k0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
      cp_async16(Vs + r * LD + c, vb + row * sv.l + col, ok);
    }
    cp_async_commit();
    if (tid < BK)   // keys past lk: bias -inf, p = 0 exactly
      Bs[slot * BK + tid] =
          k0 + tid < lk ? (biasb ? biasb[k0 + tid] : 0.f) : -INFINITY;
  };
  load_tile(0, 0);

  // q' and dO tiles, resident (rows past lq and columns past dh are zero
  // and never stored)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xd = xq;
    if (q0 + r < lq && c < dh) {
      xq = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
      xd = *reinterpret_cast<const float4*>(dob + (q0 + r) * sdo.l + c);
    }
    xq = make_float4(xq.x * scale, xq.y * scale, xq.z * scale, xq.w * scale);
    *reinterpret_cast<float4*>(Qs + r * LD + c) = xq;
    *reinterpret_cast<float4*>(DOs + r * LD + c) = xd;
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw + g + 8 * i;
    lse_r[i] = r < lq ? lse[(size_t)bh * lq + r] : INFINITY;   // p = 0
    delta_r[i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const float* qa = Qs + (rw + g) * LD + t;
  const float* da = DOs + (rw + g) * LD + t;
  const int nkt = (lk + BK - 1) / BK;
  for (int it = 0; it < nkt; ++it) {
    int cur = it & 1;
    if constexpr (LY::P) {   // split tile it, then request tile it + 1
      cp_async_wait<0>();
      split_stream<DH>(smem + LY::STREAM, smem + LY::STAGE, 1.f, tid);
      __syncthreads();   // planes of tile it (and q', dO) complete
      if (it + 1 < nkt) load_tile(cur ^ 1, it + 1);
    } else {
      cur = next_tile<LY::S>(it, nkt, load_tile);
      __syncthreads();   // tile it (and, the first time, q' and dO) complete
    }
    // K's big plane (or raw K), V's two planes (or raw V) further on
    const float* Ks = smem + LY::STREAM + 2 * cur * (LY::P ? 0 : LY::TILE);
    const float* Vs = Ks + (LY::P ? 2 : 1) * LY::TILE;
    const float* Bc = Bs + cur * BK;

    // s = q' K^T, then dp = dO V^T, over the warp's 32 keys
    float s[NH][4], dp[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA aq = load_a<LD>(qa + 8 * kk);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float* kr = Ks + (c0 + 8 * n + g) * LD + 8 * kk + t;
        mma3<kWidthTie>(s[n], aq, load_b<PL>(kr), load_b<PL>(kr + 4));
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const FragA ad = load_a<LD>(da + 8 * kk);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float* vr = Vs + (c0 + 8 * n + g) * LD + 8 * kk + t;
        mma3(dp[n], ad, load_b<PL>(vr), load_b<PL>(vr + 4));
      }
    }
    // ds = p (dp - delta), p = exp((s + bias) - lse), in s
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(Bc + c0 + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf((s[n][e] + ((e & 1) ? bb.y : bb.x)) - lse_r[i]);
        s[n][e] = p * (dp[n][e] - delta_r[i]);
      }
    }
    // acc += ds K (the block's columns, all NT n-tiles in one pass): K
    // read by column in the permuted order, each k-step's part rounded in
    // (accumulate_product)
    accumulate_product<NH, NT, LD, PL, kKeysTie>(
        acc, s, Ks + (c0 + 2 * t) * LD + g + col0, Keep());
    __syncthreads();   // the planes (or stage cur) free for the next tile
  }

  if (!reduce_halves<NT>(acc, smem + LY::STREAM, warp, lane)) return;
  float* dqb = dq + b * sdq.b + h * sdq.h + col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw + g + 8 * i;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (col0 + 8 * j + 2 * t < dh)   // dh is even: both or neither
        *reinterpret_cast<float2*>(dqb + r * sdq.l + 8 * j + 2 * t) =
            make_float2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// ------------------------------------------------------------- dk, dv --

// What a dk / dv launch writes: both, or from Dh 128 one of them, where
// dk's and dv's running sums together (128 floats a thread and more) leave
// too few registers for the rest and ptxas spills.
constexpr int kDk = 1, kDv = 2;

// The column parts of a dk / dv launch's output: at DH 192 one running sum
// of 96 floats a thread still spilled, so blockIdx.y picks one half of the
// columns (each block recomputes p^T, and dp^T for dk, for its half).
template <int DH>
constexpr int kParts = DH > 128 ? 2 : 1;

template <int DH, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int lq, int lk, int dh, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, float scale) {
  using LY = Layout<DH>;
  constexpr int LD = LY::LD;
  constexpr int PL = LY::PLANE;
  constexpr int KS = DH / 8;
  constexpr int CH = DH / 4;
  constexpr int NT = KS / kParts<DH>;   // the block's output n-tiles
  constexpr bool DK = OUT & kDk, DV = OUT & kDv;
  // dk and dv in one launch at Dh 96 (their running sums take 96 floats
  // a thread): p^T and dv come before dp^T is formed, so that p^T and
  // dp^T are not both live beside the sums, and the score products unroll
  // 4 k-steps at a time; fully unrolled, or in the order below, ptxas
  // spills there.
  constexpr bool DV_FIRST = DK && DV && NT > 8;
  constexpr int KU = DV_FIRST ? 4 : KS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + LY::TILE;
  float* LSE = smem + LY::ROWS;
  float* DELTA = LSE + LY::SLOTS * BQ;

  const int nkt = (lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x % nkt;
  const int b = bh / heads, h = bh % heads;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);      // the warp's key rows in the tile
  const int c0 = HALF * (warp >> 2);   // its queries in each query tile
  const int col0 = 8 * NT * blockIdx.y;   // the block's first output column

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;

  // K and V tiles, resident for the whole query loop
  for (int i = tid; i < BK * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < lk && c < dh;   // else zero-filled
    const long long row = ok ? k0 + r : 0;
    const int col = ok ? c : 0;
    cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
    cp_async16(Vs + r * LD + c, vb + row * sv.l + col, ok);
  }
  cp_async_commit();

  // query tile qt's q and dO: into the staging pair (planes), else into
  // stage `slot`; its lse and delta into slot `slot`
  auto load_tile = [&](int slot, int qt) {
    const int q0 = qt * BQ;
    float* Qs = smem + (LY::P ? LY::STAGE : LY::STREAM + 2 * slot * LY::TILE);
    float* DOs = Qs + LY::TILE;
    for (int i = tid; i < BQ * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = q0 + r < lq && c < dh;   // else zero-filled
      const long long row = ok ? q0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Qs + r * LD + c, qb + row * sq.l + col, ok);
      cp_async16(DOs + r * LD + c, dob + row * sdo.l + col, ok);
    }
    cp_async_commit();
    if (tid < BQ) {   // queries past lq: lse +inf, p = 0 exactly
      const int r = q0 + tid;
      LSE[slot * BQ + tid] = r < lq ? lse[(size_t)bh * lq + r] : INFINITY;
      DELTA[slot * BQ + tid] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    }
  };
  load_tile(0, 0);

  // the block's keys' bias, read from shared memory where p is formed:
  // held in registers, it made the dk / dv launch at Dh 96 spill
  float* KB = smem + LY::KEYS;
  if (tid < BK)
    KB[tid] = k0 + tid < lk ? (bias ? bias[(size_t)b * lk + k0 + tid] : 0.f)
                            : -INFINITY;   // no key at all: p = 0
  float dk_acc[DK ? NT : 1][4], dv_acc[DV ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DK) dk_acc[j][e] = 0.f;
      if constexpr (DV) dv_acc[j][e] = 0.f;
    }

  const float* ka = Ks + (rw + g) * LD + t;
  const float* va = Vs + (rw + g) * LD + t;
  const int nqt = (lq + BQ - 1) / BQ;
  for (int it = 0; it < nqt; ++it) {
    int cur = it & 1;
    if constexpr (LY::P) {   // split tile it (q' = q * scale), request it + 1
      cp_async_wait<0>();
      split_stream<DH>(smem + LY::STREAM, smem + LY::STAGE, scale, tid);
      __syncthreads();   // planes of tile it (and K, V) complete
      if (it + 1 < nqt) load_tile(cur ^ 1, it + 1);
    } else {
      cur = next_tile<LY::S>(it, nqt, load_tile);
      // q' = f32(q * scale) in place: the chunks this thread copied
      float* Qs = smem + LY::STREAM + 2 * cur * LY::TILE;
      for (int i = tid; i < BQ * CH; i += THREADS) {
        float4* x =
            reinterpret_cast<float4*>(Qs + (i / CH) * LD + (i % CH) * 4);
        const float4 y = *x;
        *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
      }
      __syncthreads();   // q', dO, lse, delta of tile it (and K, V) complete
    }
    // q''s big plane (or raw q'), dO's two planes (or raw dO) further on
    const float* Qs = smem + LY::STREAM + 2 * cur * (LY::P ? 0 : LY::TILE);
    const float* DOs = Qs + (LY::P ? 2 : 1) * LY::TILE;
    const float* LSEs = LSE + cur * BQ;
    const float* DELTAs = DELTA + cur * BQ;

    // s^T = K q'^T, then dp^T = V dO^T: rows the warp's keys, columns its
    // 32 queries (one product at a time, to stay in registers)
    float st[NH][4], dpt[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll(KU)
    for (int kk = 0; kk < KS; ++kk) {
      const FragA a = load_a<LD>(ka + 8 * kk);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float* qr = Qs + (c0 + 8 * n + g) * LD + 8 * kk + t;
        mma3<kWidthTie>(st[n], a, load_b<PL>(qr), load_b<PL>(qr + 4));
      }
    }
    const int row = (c0 + 2 * t) * LD + g + col0;
    if constexpr (DV_FIRST) {   // p^T, dv, then dp^T: fewer sums live
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float2 ls =
            *reinterpret_cast<const float2*>(LSEs + c0 + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[n][e] = expf((st[n][e] + KB[rw + g + 4 * (e & 2)]) -
                          ((e & 1) ? ls.y : ls.x));
      }
      accumulate_product<NH, NT, LD, PL, kKeysTie>(dv_acc, st, DOs + row,
                                                   Keep());
    }
#pragma unroll(KU)
    for (int kk = 0; kk < (DK ? KS : 0); ++kk) {
      const FragA a = load_a<LD>(va + 8 * kk);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const float* dr = DOs + (c0 + 8 * n + g) * LD + 8 * kk + t;
        mma3(dpt[n], a, load_b<PL>(dr), load_b<PL>(dr + 4));
      }
    }
    // p^T = exp((s^T + bias) - lse), ds^T = p^T (dp^T - delta)
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(LSEs + col);
      const float2 dl = *reinterpret_cast<const float2*>(DELTAs + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            DV_FIRST ? st[n][e]
                     : expf((st[n][e] + KB[rw + g + 4 * (e & 2)]) -
                            ((e & 1) ? ls.y : ls.x));
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    // dv += p^T dO, then dk += ds^T q': dO and q' read by column, each
    // k-step's part rounded in (accumulate_product)
    if constexpr (DV && !DV_FIRST)
      accumulate_product<NH, NT, LD, PL, kKeysTie>(dv_acc, st, DOs + row,
                                                   Keep());
    if constexpr (DK)
      accumulate_product<NH, NT, LD, PL, kKeysTie>(dk_acc, dpt, Qs + row,
                                                   Keep());
    __syncthreads();   // the planes (or stage cur) free for the next tile
  }

  bool first = true;
  if constexpr (DK)
    first = reduce_halves<NT>(dk_acc, smem + LY::STREAM, warp, lane);
  if constexpr (DV)
    first = reduce_halves<NT>(dv_acc, smem + LY::STREAM + LY::TILE, warp,
                              lane);
  if (!first) return;
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rw + g + 8 * i;
    if (key >= lk) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      if (c >= dh) continue;   // dh is even: both columns or neither
      if constexpr (DK)
        *reinterpret_cast<float2*>(dkb + key * sdk.l + c) =
            make_float2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      if constexpr (DV)
        *reinterpret_cast<float2*>(dvb + key * sdv.l + c) =
            make_float2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int DH, int OUT>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* bias, const float* dout,
                       const float* lse, const float* delta, float* dk,
                       float* dv, unsigned blocks, int heads, int lq, int lk,
                       int dh, Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdk, Strides sdv, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = Layout<DH>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DH, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<DH, OUT>
      <<<dim3(blocks, kParts<DH>), THREADS, smem, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, heads, lq, lk, dh, sq, sk, sv,
      sdo, sdk, sdv, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* dout, const float* lse,
                   const float* delta, float* dq, float* dk, float* dv,
                   int batch, int heads, int lq, int lk, int dh, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   Strides sdk, Strides sdv, float scale,
                   cudaStream_t stream) {
  constexpr size_t dq_smem = Layout<DH>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (e != cudaSuccess) return e;
  const long long bh = (long long)batch * heads;
  const long long dq_blocks = bh * ((lq + BQ - 1) / BQ);
  const long long dkv_blocks = bh * ((lk + BK - 1) / BK);
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<DH>
      <<<dim3((unsigned)dq_blocks, kDqParts<DH>), THREADS, dq_smem, stream>>>(
      q, k, v, bias, dout, lse, delta, dq, heads, lq, lk, dh, sq, sk, sv, sdo,
      sdq, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned nb = (unsigned)dkv_blocks;
  if constexpr (DH > 96) {   // dv, then dk, each recomputing p
    e = launch_dkv<DH, kDv>(q, k, v, bias, dout, lse, delta, dk, dv, nb,
                            heads, lq, lk, dh, sq, sk, sv, sdo, sdk, sdv,
                            scale, stream);
    if (e != cudaSuccess) return e;
    return launch_dkv<DH, kDk>(q, k, v, bias, dout, lse, delta, dk, dv, nb,
                               heads, lq, lk, dh, sq, sk, sv, sdo, sdk, sdv,
                               scale, stream);
  } else {
    return launch_dkv<DH, kDk | kDv>(q, k, v, bias, dout, lse, delta, dk, dv,
                                     nb, heads, lq, lk, dh, sq, sk, sv, sdo,
                                     sdk, sdv, scale, stream);
  }
}

}  // namespace

extern "C" {

// q, dout, dq: (B, H, Lq, Dh); k, v, dk, dv: (B, H, Lk, Dh); all f32 with
// the given element strides for batch, head and row (the last axis
// contiguous); dh a multiple of 4 up to 192, scale dh^-0.5 or the
// caller's (an unpadded width's).  bias: (B, Lk) f32 or null (no key
// masked); lse, delta: (B, H, Lq) f32 contiguous.  Returns 0, a cudaError_t value after a failed
// launch, or cudaErrorInvalidValue for shapes the kernels do not take (the
// Python wrapper checks those first).
int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, int batch, int heads, int lq, int lk, int dh, long long q_sb,
    long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl,
    long long do_sb, long long do_sh, long long do_sl, long long dq_sb,
    long long dq_sh, long long dq_sl, long long dk_sb, long long dk_sh,
    long long dk_sl, long long dv_sb, long long dv_sh, long long dv_sl,
    float scale, void* stream_ptr) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || dh < 4 || dh % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, sdo{do_sb, do_sh, do_sl},
      sdq{dq_sb, dq_sh, dq_sl}, sdk{dk_sb, dk_sh, dk_sl},
      sdv{dv_sb, dv_sh, dv_sl};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  // the smallest instance that holds the width
#define SAIS_FLASH_BWD_CASE(d)                                              \
  if (dh <= d)                                                              \
    return (int)launch<d>(f(q), f(k), f(v), f(bias), f(dout), f(lse),       \
                          f(delta), w(dq), w(dk), w(dv), batch, heads, lq,  \
                          lk, dh, sq, sk, sv, sdo, sdq, sdk, sdv, scale,    \
                          stream);
  SAIS_FLASH_BWD_CASE(32) SAIS_FLASH_BWD_CASE(64) SAIS_FLASH_BWD_CASE(96)
  SAIS_FLASH_BWD_CASE(128) SAIS_FLASH_BWD_CASE(192)
#undef SAIS_FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
