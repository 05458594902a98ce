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
// f32 FFMA, 67 TFLOP/s, would take 0.685 ms).  At (8, 4, 2001, 96) masked
// 0.616 ms, at (2, 4, 8193, 96) 3.126 ms, at (8, 4, 2001, 192) masked
// 1.233 ms.  Two kernels without atomics, like JAX's, compute s and dp in
// both: every instance executes 14 Dh flops a pair (with the columns
// split over blockIdx.y and dk, dv in two launches, the Dh 192 instance
// had executed 26 Dh, the Dh 128 one 16 Dh).  In practice a 3xTF32
// k-step on mma.sync costs 12 instructions beside its 3 HMMA for the tie
// and the f32 add, plus the splits and the fragment loads, and the
// kernels are bound by issue slots and shared-memory bandwidth well
// before the tensor cores (mma.sync TF32 peaks near 320 TFLOP/s on the
// card, tools/mma_sync_rate.cu).
//
// Design up to Dh 96 (the narrow kernels):
//
// - dq: one block of 8 warps per (batch*head, tile of 64 queries), looping
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
//   between products.  At Dh 96 the dk / dv thread forms p^T and adds it
//   into dv before it forms dp^T, so that the two running sums (96 floats)
//   never sit beside both tiles of scores.
// - The streaming tiles (K and V in the dq kernel, q' and dO in the dk /
//   dv kernel) are the B operands of every product that reads them, met
//   by all 8 warps at every k-step: each is split once, when it lands,
//   into a big and a small plane (split_stream), and a k-step only loads
//   its fragments.  The resident tiles (q' and dO in the dq kernel, K and
//   V in the dk / dv kernel) are A operands, 4 values a k-step a warp, and
//   stay f32, split at each use.  The next streaming tile lands raw in a
//   staging pair while the planes of this one are read: the resident
//   pair, four planes and the staging pair, 8 tiles of 64 x 100 floats at
//   Dh 96, 206,080 bytes; one block of 8 warps an SM.
//
// Design at Dh 128 and 192 (the wide kernels): each score tile is formed
// once per output it feeds, and the running sums are spread over more
// threads (splitting the columns over blockIdx.y recomputes s and dp at
// full width for each half, and dk and dv in two launches recompute p^T
// twice), with two stages of streaming tiles.
//
// - dq (flash_bwd_dq_kernel_wide): one block of 8 warps per (batch*head, 64
//   queries), key tiles of 32 in two stages (raw; with the resident q' and dO
//   and the ds exchange 209,152 bytes at Dh 192).  Warps w and w + 4 share 16
//   query rows: each forms s and dp for 16 of the tile's keys, hands its ds
//   fragments to the other through shared memory (a named barrier of the pair),
//   and sums ds K over all 32 keys, in key order, into its half of the dq
//   columns: 48 running sums a thread at Dh 192.
// - dk and dv (flash_bwd_dkv_kernel_wide), one launch: one block of 8 warps per
//   (batch*head, 32 keys), query tiles of 32 whose q' and dO are split once
//   into planes (split_stream) while the next tile lands in a staging pair
//   (210,560 bytes at Dh 192).  Each warp first forms one 16 x 16 quarter of
//   s^T (warps 0-3) or dp^T (warps 4-7) and writes p^T or dp^T to shared
//   memory; then warp w sums dv += p^T dO and dk += ds^T q' over the tile's
//   queries, in order, for key rows 16 (w & 1) and a quarter of the columns
//   (w >> 1): 48 running sums a thread, ds^T = p^T (dp^T - delta) formed as
//   the fragments are loaded (ldsm4).
// - 14 Dh flops a pair: s, dp and ds K in the dq kernel, s^T, dp^T, p^T dO
//   and ds^T q' in the dk / dv kernel.
//
// Both designs:
//
// - Each k-step's part of dq, dk and dv, and of each score, is rounded
//   into its running sum in f32 (mma3, accumulate_product): the tensor
//   core truncates as it accumulates, and summed straight into the running
//   sums that error shrank them coherently (K3's dq sat -9e-7 of its mean
//   from float64 at the MIL fit's shapes, 20x the dense f32 path's).  The
//   parts of the sums over keys (dq, dk, dv) are also unbiased (`unbias`
//   in flash_tf32.cuh, kKeysTie), and so are the parts of each recomputed
//   score (kWidthTie), as K2 forms them: p = exp(s - lse) must see the
//   scores whose lse K2 saved (with untied scores here, each p came out
//   low and dv read 4.7x the dense path's signed error).  Every sum runs
//   in a fixed order with no atomics, so two runs give the same bits.
// - Tiles in shared memory have rows of Dh + 4 floats, read by row and by
//   column without bank conflicts.
// - Exact shapes: rows past Lq or Lk are zero-filled in shared memory;
//   missing keys get a bias of -inf and missing queries an lse of +inf, so
//   their p is exactly 0 and they contribute nothing.  Masked keys keep
//   the -1e30 bias, so p is what the TPU computes, also for the rows of an
//   all-masked element (there the caller zeroes dO, and ds = 0 exactly).
// - Any head width up to 192, as K2 (flash_attention.cu): instances at DH
//   = 32, 64, 96, 128 and 192 take a runtime width dh <= DH, a multiple of
//   4; columns dh .. DH - 1 are zero-filled in every tile and never
//   stored, and the scale is the caller's.
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
constexpr int THREADS = 256;    // 8 warps
constexpr int HALF = 32;        // the columns a warp takes of a tile
constexpr int NH = HALF / 8;    // its n-tiles

// Up to Dh 96 (the "narrow" kernels) the streaming tiles are split into
// planes when they land: the raw tile of the next step lands in a staging
// pair while the planes of this one are read, 8 tiles of 64 x (Dh + 4)
// floats (204,800 bytes at Dh 96).  The resident pair (q' and dO in the dq
// kernel, K and V in the dk / dv kernel) at 0 and TILE, then the streaming
// pair's four planes (first big, first small, second big, second small)
// at STREAM and the raw staging pair at STAGE, per-row values in 2 slots,
// and the dk / dv kernel's 64 keys' bias.
template <int DH>
struct Layout {
  static_assert(DH <= 96, "the narrow kernels take Dh up to 96");
  static constexpr int LD = DH + 4;     // = 4 (mod 32) banks
  static constexpr int TILE = 64 * LD;
  static constexpr int PLANE = TILE;    // big to small plane (load_b)
  static constexpr int STREAM = 2 * TILE;
  static constexpr int STAGE = STREAM + 4 * TILE;
  static constexpr int ROWS = STAGE + 2 * TILE;
  static constexpr int KEYS = ROWS + 4 * 64;
  static constexpr size_t bytes = (size_t)(KEYS + 64) * sizeof(float);
};

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
// `planes`, the first scaled by `scale`; tiles of ROWS rows of DH + 4
// floats.
template <int ROWS, int DH>
__device__ __forceinline__ void split_stream(float* planes, const float* raw,
                                             float scale, int tid) {
  constexpr int LD = DH + 4, TILE = ROWS * LD, CH = DH / 4;
  for (int i = tid; i < ROWS * CH; i += THREADS) {
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
  constexpr int NT = KS;       // dq n-tiles
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  // key tile kt's K and V into the staging pair, its bias into slot `slot`
  auto load_tile = [&](int slot, int kt) {
    const int k0 = kt * BK;
    float* Ks = smem + LY::STAGE;
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
    const int cur = it & 1;
    // split tile it, then request tile it + 1
    cp_async_wait<0>();
    split_stream<BQ, DH>(smem + LY::STREAM, smem + LY::STAGE, 1.f, tid);
    __syncthreads();   // planes of tile it (and q', dO) complete
    if (it + 1 < nkt) load_tile(cur ^ 1, it + 1);
    // K's big plane, V's two planes further on
    const float* Ks = smem + LY::STREAM;
    const float* Vs = Ks + 2 * LY::TILE;
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
        acc, s, Ks + (c0 + 2 * t) * LD + g, Keep());
    __syncthreads();   // the planes free for the next tile
  }

  if (!reduce_halves<NT>(acc, smem + LY::STREAM, warp, lane)) return;
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rw + g + 8 * i;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (8 * j + 2 * t < dh)   // dh is even: both or neither
        *reinterpret_cast<float2*>(dqb + r * sdq.l + 8 * j + 2 * t) =
            make_float2(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// ------------------------------------------------------------- dk, dv --

template <int DH>
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
  constexpr int NT = KS;       // dk and dv n-tiles
  // At Dh 96 (the running sums of dk and dv take 96 floats a thread): p^T
  // and dv come before dp^T is formed, so that p^T and dp^T are not both
  // live beside the sums, and the score products unroll 4 k-steps at a
  // time; fully unrolled, or in the order below, ptxas spills there.
  constexpr bool DV_FIRST = NT > 8;
  constexpr int KU = DV_FIRST ? 4 : KS;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + LY::TILE;
  float* LSE = smem + LY::ROWS;
  float* DELTA = LSE + 2 * BQ;

  const int nkt = (lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x % nkt;
  const int b = bh / heads, h = bh % heads;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);      // the warp's key rows in the tile
  const int c0 = HALF * (warp >> 2);   // its queries in each query tile

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

  // query tile qt's q and dO into the staging pair, its lse and delta
  // into slot `slot`
  auto load_tile = [&](int slot, int qt) {
    const int q0 = qt * BQ;
    float* Qs = smem + LY::STAGE;
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
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const float* ka = Ks + (rw + g) * LD + t;
  const float* va = Vs + (rw + g) * LD + t;
  const int nqt = (lq + BQ - 1) / BQ;
  for (int it = 0; it < nqt; ++it) {
    const int cur = it & 1;
    // split tile it (q' = q * scale), then request tile it + 1
    cp_async_wait<0>();
    split_stream<BQ, DH>(smem + LY::STREAM, smem + LY::STAGE, scale, tid);
    __syncthreads();   // planes of tile it (and K, V) complete
    if (it + 1 < nqt) load_tile(cur ^ 1, it + 1);
    // q''s big plane, dO's two planes further on
    const float* Qs = smem + LY::STREAM;
    const float* DOs = Qs + 2 * LY::TILE;
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
    const int row = (c0 + 2 * t) * LD + g;
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
    for (int kk = 0; kk < KS; ++kk) {
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
    if constexpr (!DV_FIRST)
      accumulate_product<NH, NT, LD, PL, kKeysTie>(dv_acc, st, DOs + row,
                                                   Keep());
    accumulate_product<NH, NT, LD, PL, kKeysTie>(dk_acc, dpt, Qs + row,
                                                 Keep());
    __syncthreads();   // the planes free for the next tile
  }

  reduce_halves<NT>(dk_acc, smem + LY::STREAM, warp, lane);
  if (!reduce_halves<NT>(dv_acc, smem + LY::STREAM + LY::TILE, warp, lane))
    return;
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rw + g + 8 * i;
    if (key >= lk) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      if (c >= dh) continue;   // dh is even: both columns or neither
      *reinterpret_cast<float2*>(dkb + key * sdk.l + c) =
          make_float2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvb + key * sdv.l + c) =
          make_float2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------- Dh 128 and 192 (wide) --

constexpr int WQ = 64;   // query rows of a wide dq block
constexpr int WK = 32;   // keys of a wide tile; queries of a dk / dv tile

// The wide dq kernel: q' and dO resident (raw), K and V in two stages of
// 32 keys (raw), each warp's ds fragments for its partner, the bias.
template <int DH>
struct WideDq {
  static constexpr int LD = DH + 4;
  static constexpr int TW = WK * LD;          // one K or V tile
  static constexpr int DO = WQ * LD;
  static constexpr int KV = 2 * WQ * LD;      // stage s: K at KV + 2 s TW
  static constexpr int DSX = KV + 4 * TW;     // 8 warps x 2 x 128
  static constexpr int BIAS = DSX + 8 * 256;  // 2 stages x WK
  static constexpr size_t bytes = (size_t)(BIAS + 2 * WK) * sizeof(float);
};

// The wide dk / dv kernel: K and V resident (raw), query tile it's four
// planes (q' big, q' small, dO big, dO small), tile it + 1's raw staging
// pair, p^T and dp^T of the tile, lse and delta in 2 slots, the keys'
// bias.
template <int DH>
struct WideDkv {
  static constexpr int LD = DH + 4;
  static constexpr int TW = WK * LD;          // a tile, or one plane
  static constexpr int STREAM = 2 * TW;
  static constexpr int STAGE = STREAM + 4 * TW;
  static constexpr int PLD = WK + 4;          // ldsm4 rows 16 B (mod 128)
  static constexpr int PT = STAGE + 2 * TW;   // WK x PLD
  static constexpr int DPT = PT + WK * PLD;
  static constexpr int ROWS = DPT + WK * PLD;
  static constexpr int KEYS = ROWS + 4 * WK;
  static constexpr size_t bytes = (size_t)(KEYS + WK) * sizeof(float);
};

// c[n] (+)= A B^T for a 16 x 16 tile (two n-tiles) over KS k-steps: A a
// raw f32 row-major tile read by ldsm4 at `a` (split here), B by row from
// a big plane at `b` with its small plane PLANE floats on (0: raw, split
// here).  Each k-step's part rounded into c (mma3<S>).
template <Sum S, int KS, int PLANE>
__device__ __forceinline__ void score_tile(float (&c)[2][4], const float* a,
                                           const float* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t x[4], big[4], small[4];
    ldsm4(x, a + 8 * kk);
    const FragA fa = split_a(__uint_as_float(x[0]), __uint_as_float(x[1]),
                             __uint_as_float(x[2]), __uint_as_float(x[3]));
    ldsm4(big, b + 8 * kk);
    if constexpr (PLANE > 0) {
      ldsm4(small, b + 8 * kk + PLANE);
      mma3<S>(c[0], fa, Split{big[0], small[0]},
                           Split{big[1], small[1]});
      mma3<S>(c[1], fa, Split{big[2], small[2]},
                           Split{big[3], small[3]});
    } else {
      auto sp = [](uint32_t u) { return split(__uint_as_float(u)); };
      mma3<S>(c[0], fa, sp(big[0]), sp(big[1]));
      mma3<S>(c[1], fa, sp(big[2]), sp(big[3]));
    }
  }
}

// dq at Dh 128 and 192: one block of 8 warps per (batch*head, 64 queries),
// key tiles of 32.  Warps w and w + 4 share 16 query rows: each forms s
// and dp over its 16 keys of the tile, hands its ds to the other through
// shared memory, and sums ds K over all 32 keys, in key order, into its
// half of the dq columns (48 or 32 floats a thread).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel_wide(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ bias,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int heads, int lq,
                             int lk, int dh, Strides sq, Strides sk,
                             Strides sv, Strides sdo, Strides sdq,
                             float scale) {
  using LY = WideDq<DH>;
  constexpr int LD = LY::LD, TW = LY::TW;
  constexpr int KS = DH / 8, CH = DH / 4;
  constexpr int NT = DH / 16;   // a warp's dq n-tiles: half the columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* DOs = smem + LY::DO;
  float* Bs = smem + LY::BIAS;

  const int nqt = (lq + WQ - 1) / WQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * WQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);   // the warp's query rows in the tile
  const int kh = warp >> 2;         // its keys 16 kh.. of a tile
  const int col0 = kh * (DH / 2);   // its dq columns

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  // key tile kt's K and V into stage `stage`, its bias into slot `stage`
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * WK;
    float* Ks = smem + LY::KV + 2 * stage * TW;
    float* Vs = Ks + TW;
#pragma unroll
    for (int j = 0; j < WK * CH / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk && c < dh;   // else zero-filled
      const long long row = ok ? k0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
      cp_async16(Vs + r * LD + c, vb + row * sv.l + col, ok);
    }
    cp_async_commit();
    if (tid < WK)   // keys past lk: bias -inf, p = 0 exactly
      Bs[stage * WK + tid] =
          k0 + tid < lk ? (biasb ? biasb[k0 + tid] : 0.f) : -INFINITY;
  };
  load_tile(0, 0);

  // q' and dO, resident (rows past lq and columns past dh are zero)
  for (int i = tid; i < WQ * CH; i += THREADS) {
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

  const float* qa = Qs + rw * LD + ldsm_a(lane, LD);
  const float* da = DOs + rw * LD + ldsm_a(lane, LD);
  const int kbo = 16 * kh * LD + ldsm_b(lane, LD);
  float* mine = smem + LY::DSX + 256 * warp + 4 * lane;
  const float* theirs = smem + LY::DSX + 256 * (warp ^ 4) + 4 * lane;
  const int nkt = (lk + WK - 1) / WK;
  for (int it = 0; it < nkt; ++it) {
    const int cur = it & 1;
    if (it + 1 < nkt) {
      load_tile(cur ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile it (and, the first time, q' and dO) complete
    const float* Ks = smem + LY::KV + 2 * cur * TW;
    const float* Bc = Bs + cur * WK;

    // s = q' K^T, then dp = dO V^T, over the warp's 16 keys
    float s[2][4], dp[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    score_tile<kWidthTie, KS, 0>(s, qa, Ks + kbo);
    score_tile<kWidth, KS, 0>(dp, da, Ks + TW + kbo);
    // ds = p (dp - delta), p = exp((s + bias) - lse), in s
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(Bc + 16 * kh + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf((s[n][e] + ((e & 1) ? bb.y : bb.x)) - lse_r[i]);
        s[n][e] = p * (dp[n][e] - delta_r[i]);
      }
      *reinterpret_cast<float4*>(mine + 128 * n) =
          make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    }
    named_sync(1 + (warp & 3), 64);   // the partner's ds complete
    // the tile's 4 k-steps of 8 keys in key order: keys 0-15 from the
    // warp with kh = 0, keys 16-31 from kh = 1
    float c[4][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 o = *reinterpret_cast<const float4*>(theirs + 128 * n);
      const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[n][e] = kh ? other[e] : s[n][e];
        c[2 + n][e] = kh ? s[n][e] : other[e];
      }
    }
    // acc += ds K over the 32 keys (the warp's columns): K read by column
    // in the permuted order, each k-step's part rounded in
    accumulate_product<4, NT, LD, 0, kKeysTie>(
        acc, c, Ks + (2 * t) * LD + g + col0, Keep());
    __syncthreads();   // stage cur and the ds exchange free
  }

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

// dk and dv at Dh 128 and 192, one launch: one block of 8 warps per
// (batch*head, 32 keys), query tiles of 32.  Every warp forms one 16 x 16
// quarter of s^T (warps 0-3) or dp^T (warps 4-7) of a tile and writes p^T
// or dp^T to shared memory; warp w sums dv += p^T dO and dk += ds^T q' of
// a tile, in query order, for key rows 16 (w & 1) and a quarter of the
// columns (w >> 1): 48 or 32 floats a thread, ds^T formed from p^T and
// dp^T as they are loaded.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel_wide(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int heads, int lq, int lk, int dh, Strides sq,
                              Strides sk, Strides sv, Strides sdo,
                              Strides sdk, Strides sdv, float scale) {
  using LY = WideDkv<DH>;
  constexpr int LD = LY::LD, TW = LY::TW, PLD = LY::PLD;
  constexpr int KS = DH / 8, CH = DH / 4;
  constexpr int NQ = DH / 32;   // a warp's dk and dv n-tiles
  constexpr int J = WK / 8;     // k-steps of the sums over a query tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + TW;
  float* LSE = smem + LY::ROWS;
  float* DELTA = LSE + 2 * WK;
  float* KB = smem + LY::KEYS;

  const int nkt = (lk + WK - 1) / WK;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x % nkt;
  const int b = bh / heads, h = bh % heads;
  const int k0 = kt * WK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = 16 * (warp & 1);        // the warp's key rows
  const bool dpw = warp >= 4;            // forms dp^T (else s^T)
  const int qh = 16 * ((warp >> 1) & 1); // its queries of a tile
  const int c0 = (DH / 4) * (warp >> 1); // its dk / dv columns

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;

  // K and V, resident for the whole query loop
#pragma unroll
  for (int j = 0; j < WK * CH / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < lk && c < dh;   // else zero-filled
    const long long row = ok ? k0 + r : 0;
    const int col = ok ? c : 0;
    cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
    cp_async16(Vs + r * LD + c, vb + row * sv.l + col, ok);
  }
  cp_async_commit();

  // query tile qt's q and dO into the staging pair, its lse and delta
  // into slot qt & 1
  auto load_tile = [&](int qt) {
    const int q0 = qt * WK, slot = qt & 1;
    float* Qs = smem + LY::STAGE;
    float* DOs = Qs + TW;
#pragma unroll
    for (int j = 0; j < WK * CH / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = q0 + r < lq && c < dh;   // else zero-filled
      const long long row = ok ? q0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Qs + r * LD + c, qb + row * sq.l + col, ok);
      cp_async16(DOs + r * LD + c, dob + row * sdo.l + col, ok);
    }
    cp_async_commit();
    if (tid < WK) {   // queries past lq: lse +inf, p = 0 exactly
      const int r = q0 + tid;
      LSE[slot * WK + tid] = r < lq ? lse[(size_t)bh * lq + r] : INFINITY;
      DELTA[slot * WK + tid] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    }
  };
  load_tile(0);
  if (tid < WK)
    KB[tid] = k0 + tid < lk ? (bias ? bias[(size_t)b * lk + k0 + tid] : 0.f)
                            : -INFINITY;   // no key at all: p = 0

  float dk_acc[NQ][4], dv_acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // the score quarter: A = K or V rows kr.. (raw), B = q' or dO planes by
  // row; p^T = exp((s^T + bias) - lse) or dp^T to shared memory
  const float* a1 = (dpw ? Vs : Ks) + kr * LD + ldsm_a(lane, LD);
  const float* b1 =
      smem + LY::STREAM + (dpw ? 2 * TW : 0) + qh * LD + ldsm_b(lane, LD);
  float* w1 = smem + (dpw ? LY::DPT : LY::PT) + (kr + g) * PLD + qh + 2 * t;
  const int a2 = kr * PLD + ldsm_a(lane, PLD);
  const int nqt = (lq + WK - 1) / WK;
  for (int it = 0; it < nqt; ++it) {
    const int cur = it & 1;
    // split tile it (q' = q * scale), then request tile it + 1
    cp_async_wait<0>();
    split_stream<WK, DH>(smem + LY::STREAM, smem + LY::STAGE, scale, tid);
    __syncthreads();   // planes of tile it (and K, V) complete
    if (it + 1 < nqt) load_tile(it + 1);
    const float* LSEs = LSE + cur * WK;
    const float* DELTAs = DELTA + cur * WK;

    float c[2][4] = {};
    if (dpw) {
      score_tile<kWidth, KS, TW>(c, a1, b1);
    } else {
      score_tile<kWidthTie, KS, TW>(c, a1, b1);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 ls =
            *reinterpret_cast<const float2*>(LSEs + qh + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[n][e] = expf((c[n][e] + KB[kr + g + 4 * (e & 2)]) -
                         ((e & 1) ? ls.y : ls.x));
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<float2*>(w1 + 8 * n) = make_float2(c[n][0], c[n][1]);
      *reinterpret_cast<float2*>(w1 + 8 * PLD + 8 * n) =
          make_float2(c[n][2], c[n][3]);
    }
    __syncthreads();   // p^T and dp^T of the tile complete
    // dv += p^T dO, dk += ds^T q', ds^T = p^T (dp^T - delta): k-steps of
    // 8 queries in order, dO and q' read by column from their planes
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t xp[4], xd[4];
      ldsm4(xp, smem + LY::PT + a2 + 8 * j);
      ldsm4(xd, smem + LY::DPT + a2 + 8 * j);
      const float dl0 = DELTAs[8 * j + t], dl1 = DELTAs[8 * j + t + 4];
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __uint_as_float(xp[e]);
        ds[e] = p[e] * (__uint_as_float(xd[e]) - (e < 2 ? dl0 : dl1));
      }
      const FragA ap = split_a(p[0], p[1], p[2], p[3]);
      const FragA ads = split_a(ds[0], ds[1], ds[2], ds[3]);
      const float* bq = smem + LY::STREAM + (8 * j + t) * LD + c0 + g;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma3<kKeysTie>(dv_acc[n], ap, load_b<TW>(bq + 2 * TW + 8 * n),
                       load_b<TW>(bq + 2 * TW + 4 * LD + 8 * n));
        mma3<kKeysTie>(dk_acc[n], ads, load_b<TW>(bq + 8 * n),
                       load_b<TW>(bq + 4 * LD + 8 * n));
      }
    }
    __syncthreads();   // the planes, p^T and dp^T free for the next tile
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr + g + 8 * i;
    if (key >= lk) continue;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      if (c >= dh) continue;   // dh is even: both columns or neither
      *reinterpret_cast<float2*>(dkb + key * sdk.l + c) =
          make_float2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<float2*>(dvb + key * sdv.l + c) =
          make_float2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* dout, const float* lse,
                   const float* delta, float* dq, float* dk, float* dv,
                   int batch, int heads, int lq, int lk, int dh, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   Strides sdk, Strides sdv, float scale,
                   cudaStream_t stream) {
  constexpr bool wide = DH > 96;
  constexpr int bq = wide ? WQ : BQ, bk = wide ? WK : BK;
  const long long bh = (long long)batch * heads;
  const long long dq_blocks = bh * ((lq + bq - 1) / bq);
  const long long dkv_blocks = bh * ((lk + bk - 1) / bk);
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (wide) {
    constexpr size_t dq_smem = WideDq<DH>::bytes, dkv_smem = WideDkv<DH>::bytes;
    e = allow_shared_once<flash_bwd_dq_kernel_wide<DH>>(dq_smem);
    if (e != cudaSuccess) return e;
    e = allow_shared_once<flash_bwd_dkv_kernel_wide<DH>>(dkv_smem);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_kernel_wide<DH>
        <<<(unsigned)dq_blocks, THREADS, dq_smem, stream>>>(
            q, k, v, bias, dout, lse, delta, dq, heads, lq, lk, dh, sq, sk, sv,
            sdo, sdq, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_kernel_wide<DH>
        <<<(unsigned)dkv_blocks, THREADS, dkv_smem, stream>>>(
            q, k, v, bias, dout, lse, delta, dk, dv, heads, lq, lk, dh, sq, sk,
            sv, sdo, sdk, sdv, scale);
  } else {
    constexpr size_t smem = Layout<DH>::bytes;
    e = allow_shared_once<flash_bwd_dq_kernel<DH>>(smem);
    if (e != cudaSuccess) return e;
    e = allow_shared_once<flash_bwd_dkv_kernel<DH>>(smem);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_kernel<DH><<<(unsigned)dq_blocks, THREADS, smem, stream>>>(
        q, k, v, bias, dout, lse, delta, dq, heads, lq, lk, dh, sq, sk, sv, sdo,
        sdq, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_kernel<DH><<<(unsigned)dkv_blocks, THREADS, smem, stream>>>(
        q, k, v, bias, dout, lse, delta, dk, dv, heads, lq, lk, dh, sq, sk, sv,
        sdo, sdk, sdv, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout, dq: (B, H, Lq, Dh); k, v, dk, dv: (B, H, Lk, Dh); all f32 with the
// given element strides for batch, head and row (the last axis contiguous); dh
// a multiple of 4 up to 192, scale dh^-0.5 or the caller's (an unpadded
// width's).  bias: (B, Lk) f32 or null (no key masked); lse, delta: (B, H, Lq)
// f32 contiguous.  Returns 0, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernels do not take (the Python wrapper
// checks those first).
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
