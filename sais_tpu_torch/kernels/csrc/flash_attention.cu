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
// Arithmetic: q' K^T runs as three TF32 products of a big / small split
// (flash_tf32.cuh), each k-step's part tied into the score
// (mma3<kWidthTie>); the bias is added after the product and never split,
// so a masked score is exactly -1e30 and an all-masked element's lse
// exactly -1e30.  P V runs on f32 FFMA: acc = acc * alpha once a tile,
// then one FMA a key, keys in order, each rounded to nearest.  At the MIL
// fit's first layer this reads 1.42x the dense f32 path's signed error
// against float64 (PERF.md §6); P V's sums over keys on the tensor cores,
// tied or not, read 34.5x and 23.2x.  Up to Dh 96 the output is bit for
// bit that of the previous design, whose P V took each p from its quad by
// shuffle.
//
// What bounds it on an H100 (SXM data-sheet peaks at 700 W): 4 Dh flops a
// (query, valid key) pair, both products f32-accurate, at 494.7 TFLOP/s
// dense TF32 three times over: 0.111 ms at the steps path's (B*S = 132, H
// = 4, L = 301, Dh = 96), 0.247 ms at (8, 4, 2001, 96) masked, against
// reading q, k, v, the bias and writing out, lse once (0.073 / 0.030 ms).
// The route taken is bound by P V's FFMA at 67 TFLOP/s: 0.193 / 0.427 ms.
// Issue slots and shared-memory bandwidth bound it in practice: a TF32
// mma.sync of a 3xTF32 k-step costs, beside its 3 HMMA, 12 instructions for
// the tie and the f32 add and 3 a value for each split; and P V's FFMA is
// fed from shared memory, one float4 of P a row and one of V a column
// group for every 4 keys (16 x 16-byte loads for 192 FFMA a lane), which
// the card delivers at 128 bytes a cycle an SM.
//
// Design:
//
// - One block per (batch*head, tile of 64 queries), the grid flattened to
//   one dimension; 4 row groups of 16 queries.  Up to Dh 96 a warp owns a
//   row group (4 warps, 113,920 bytes of shared memory at Dh 96, two
//   blocks an SM).  From Dh 128 two warps share a row group (8 warps, one
//   block an SM): each forms the scores of 16 of a tile's 32 keys, the two
//   exchange their row maxima and sums through shared memory (and a named
//   barrier), and each sums P V into half of the columns.
// - q' lands raw in shared memory and a warp splits its A fragment at each
//   k-step (q' planes beside double-buffered K planes would leave one
//   block an SM at Dh 96).  K lands raw in its stage's big plane and each
//   thread splits the chunks it copied into the big and small planes once;
//   every warp then loads its B fragments from the planes with ldmatrix
//   (ldsm4: one instruction for the big values of two n-tiles); split at
//   each use, every warp re-split every K value at every k-step.
// - Keys in tiles of 32, double-buffered.  Up to Dh 96: K, V and the bias
//   of tile it + 1 are requested with cp.async before tile it's products,
//   and each k-step's part waits for the last one's sum (c * 0: ptxas
//   spilled without).  From Dh 128: V runs one tile behind K, a cp.async
//   group bringing K tile it + 2 and V tile it + 1 while tile it + 1's
//   scores and tile it's P V run in one basic block, P in two buffers (the
//   partner warp reads it), and the k-steps of a score are independent up
//   to their final add (mma3<kWidthTie, false>): 7-9% faster at Dh 128 /
//   192 than the Dh 96 schedule, which this one ran slower (ptxas issued
//   the products, then the FFMA, even when the source interleaved them).
// - P = exp(s - m) goes from the score fragments to shared memory (64 x 40
//   floats, conflict-free both ways) with the rows' alpha.  P V then gives each
//   lane 4 rows x 4 CG columns (CG = 1-3 float4 column groups, 48 accumulators
//   at Dh 96 and 192): a float4 load of P serves 4 keys of a row, a float4 load
//   of V a key of a column group, and each feeds 4 CG or 4 FFMA (a shuffle of
//   every p from its quad and float2 loads of V for 4 FFMA each had run P V at
//   a fifth of its FFMA bound).  The output is stored as float4.  Those loads
//   still bound P V: 16 float4 loads (64 cycles of the SM's shared-memory port)
//   for 192 FFMA (48 cycles of its four schedulers) every 4 keys.
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
//   buffer first.  At DH 192 the block holds 223,488 bytes.
// - Work a (query, key) pair: 2 Dh flops of q' K^T as 6 Dh on the tensor
//   cores, 2 Dh of FFMA, at every width.
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

// A block holds 64 query rows in 4 row groups of 16.  Up to Dh 96 one
// warp owns a row group (4 warps, two blocks an SM); from Dh 128 two warps
// share it (8 warps, one block an SM): each forms the scores of half of
// every key tile and the P V sums of half of the columns.
template <int DH>
struct Cfg {
  static constexpr int PAIR = DH > 96 ? 2 : 1;   // warps a row group
  // Up to Dh 96: mma3's k-steps wait for the last one's sum (without,
  // ptxas spilled); tile it + 1 is loaded whole during tile it.  From Dh
  // 128: the k-steps run ahead, and V runs a tile behind K so that tile it
  // + 1's scores and tile it's P V share a basic block.
  static constexpr bool SERIAL = DH <= 96;
  static constexpr int WARPS = 4 * PAIR;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = DH <= 32 ? 4 : DH <= 96 ? 2 : 1;
  static constexpr int NKT = BKEY / 8 / PAIR;    // a warp's score n-tiles
  static constexpr int COLS = DH / PAIR;         // a warp's P V columns
  static constexpr int CG = COLS / 32;           // float4 groups a lane
  static constexpr int LD = DH + 4;              // = 4 (mod 32) banks
  static constexpr int PLD = BKEY + 8;           // P rows: = 8 (mod 32)
  static constexpr int TILE = BKEY * LD;         // one K plane or V tile
  static constexpr int K = BQ * LD;              // after q' (raw, BQ rows)
  // stage s: K's big plane at K + 2 s TILE, its small plane TILE further
  static constexpr int V = K + 4 * TILE;         // stage s at V + s TILE
  // P: BQ x PLD, a second buffer from Dh 128 (the next tile's P is written
  // while the partner warp may still read this one's)
  static constexpr int P = V + 2 * TILE;
  static constexpr int BIAS = P + PAIR * BQ * PLD;   // 2 stages x BKEY
  // a warp's 64 row values: alpha, l, the partial max and sum of a tile
  static constexpr int ROW = BIAS + 2 * BKEY;
  static constexpr size_t bytes = (size_t)(ROW + 64 * WARPS) * sizeof(float);
  static_assert(COLS % 32 == 0 && (BKEY * DH / 4) % THREADS == 0 &&
                    (BQ * DH / 4) % THREADS == 0,
                "tile copies must divide evenly among the threads");
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

__device__ __forceinline__ float lane_of(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, Cfg<DH>::MIN_BLOCKS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int lq, int lk,
                     int dh, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int zero_masked_rows) {
  using C = Cfg<DH>;
  constexpr int LD = C::LD, PLD = C::PLD, NKT = C::NKT, CG = C::CG;
  constexpr int KS = DH / 8;     // k-steps of q' K^T
  constexpr int CH = DH / 4;     // 16-byte chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + C::BIAS;

  const int nqt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp & 3);           // the warp's rows in the tile
  const int half = warp >> 2;               // its half (PAIR 2)
  const int key0 = 8 * NKT * half;          // its first key of a tile
  const int pr = lane >> 3, pc = lane & 7;  // P V: rows rw + pr + 4 i
  const int col0 = C::COLS * half + 4 * pc; // columns col0 + 32 m (+0..3)
  // From Dh 128 a row group past lq (the last query tile) only loads and
  // syncs: its rows are never stored and its pair exchanges nothing with
  // others (2.5% faster at (32, 4, 129, 192); 2-4% slower up to Dh 96)
  const bool active = C::PAIR == 1 || q0 + rw < lq;
  float* rowv = smem + C::ROW + 64 * warp;
  const float* partner = smem + C::ROW + 64 * (warp ^ 4);

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;
  const int nkt = (lk + BKEY - 1) / BKEY;

  // V tile vt into stage vt & 1; K tile kt (raw, into its big plane) with
  // its bias and (with_v) its V into stage kt & 1.  The caller commits the
  // cp.async group.
  int valid = 0;   // a key of this element with bias > -1e30
  auto load_v = [&](int vt) {
    const int k0 = vt * BKEY;
    float* Vs = smem + C::V + (vt & 1) * C::TILE;
#pragma unroll
    for (int j = 0; j < BKEY * CH / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk && c < dh;   // else zero-filled
      cp_async16(Vs + r * LD + c, vb + (ok ? k0 + r : 0) * sv.l + (ok ? c : 0),
                 ok);
    }
  };
  auto load = [&](int kt, bool with_v) {
    const int k0 = kt * BKEY;
    float* Ks = smem + C::K + 2 * (kt & 1) * C::TILE;
#pragma unroll
    for (int j = 0; j < BKEY * CH / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk && c < dh;   // else zero-filled
      const long long row = ok ? k0 + r : 0;
      const int col = ok ? c : 0;
      cp_async16(Ks + r * LD + c, kb + row * sk.l + col, ok);
    }
    if (with_v) load_v(kt);
    if (tid < BKEY) {
      float bv = -INFINITY;   // no key at all: p = 0 exactly
      if (k0 + tid < lk) bv = biasb ? biasb[k0 + tid] : 0.f;
      Bs[(kt & 1) * BKEY + tid] = bv;
      valid |= bv > kNegInf;
    }
  };
  // split the chunks of K tile kt this thread copied into big and small
  // planes (the raw values landed in the big plane)
  auto split_k = [&](int kt) {
    float* Ks = smem + C::K + 2 * (kt & 1) * C::TILE;
#pragma unroll
    for (int j = 0; j < BKEY * CH / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      float* at = Ks + (i / CH) * LD + (i % CH) * 4;
      split_planes<C::TILE>(at, *reinterpret_cast<const float4*>(at));
    }
  };
  if constexpr (C::PAIR == 1) {
    load(0, true);
    cp_async_commit();
  } else {
    load(0, false);
    cp_async_commit();
    if (nkt > 1) load(1, false);
    load_v(0);
    cp_async_commit();
  }

  // the q' tile, raw f32 (rows past lq and columns past dh are zero and
  // never stored); a warp splits its A fragments as it loads them
#pragma unroll
  for (int j = 0; j < BQ * CH / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / CH, c = (i % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < lq && c < dh)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
    *reinterpret_cast<float4*>(smem + r * LD + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  // ldsm4 rows: an A fragment of q' (rows rw + 0..15), B fragments of K
  // (keys key0 + 8 n + 0..7, two n-tiles a load)
  const float* qa = smem + rw * LD + ldsm_a(lane, LD);
  const int kbo = key0 * LD + ldsm_b(lane, LD);

  // s = q' K^T of tile kt: 16 x 8 NKT a warp, rows g / g + 8, keys key0 +
  // 8 n + 2t (+1); k-step kk's part tied into the score (mma3<kWidthTie>)
  auto score_step = [&](float (&s)[NKT][4], int kt, int kk) {
    const float* Kb = smem + C::K + 2 * (kt & 1) * C::TILE + kbo;
    uint32_t x[4];
    ldsm4(x, qa + 8 * kk);
    const FragA a = split_a(__uint_as_float(x[0]), __uint_as_float(x[1]),
                            __uint_as_float(x[2]), __uint_as_float(x[3]));
#pragma unroll
    for (int n = 0; n < NKT; n += 2) {
      uint32_t big[4], small[4];
      ldsm4(big, Kb + 8 * n * LD + 8 * kk);
      ldsm4(small, Kb + 8 * n * LD + 8 * kk + C::TILE);
      mma3<kWidthTie, C::SERIAL>(s[n], a, Split{big[0], small[0]},
                                 Split{big[1], small[1]});
      mma3<kWidthTie, C::SERIAL>(s[n + 1], a, Split{big[2], small[2]},
                                 Split{big[3], small[3]});
    }
  };

  // online softmax of tile kt: + bias, row max (over the quad, and the
  // partner warp for PAIR 2), P = exp(s - m) to shared memory, the rescale
  // alpha and this warp's part of the row sum (rowv)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  auto softmax = [&](float (&s)[NKT][4], int kt) {
    const float* Bc = Bs + (kt & 1) * BKEY;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const float2 bb =
          *reinterpret_cast<const float2*>(Bc + key0 + 8 * n + 2 * t);
      s[n][0] += bb.x;
      s[n][1] += bb.y;
      s[n][2] += bb.x;
      s[n][3] += bb.y;
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) mt[i] = quad_max(mt[i]);
    if constexpr (C::PAIR > 1) {
      if (t == 0) {
        rowv[32 + g] = mt[0];
        rowv[40 + g] = mt[1];
      }
      named_sync(1 + (warp & 3), 64);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mt[i] = fmaxf(mt[i], partner[32 + g + 8 * i]);
    }
    float alpha[2], ps[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      ps[i] = 0.f;
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        s[n][2 * i] = expf(s[n][2 * i] - m_new);
        s[n][2 * i + 1] = expf(s[n][2 * i + 1] - m_new);
        ps[i] += s[n][2 * i];
        ps[i] += s[n][2 * i + 1];
      }
      ps[i] = quad_sum(ps[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      if constexpr (C::PAIR == 1) l[i] = l[i] * alpha[i] + ps[i];
    }
    if constexpr (C::PAIR > 1) __syncwarp();   // tile kt - 1's alpha, ps read
    float* Pw = smem + C::P + (C::PAIR > 1 ? (kt & 1) * BQ * PLD : 0) +
                (rw + g) * PLD + key0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      *reinterpret_cast<float2*>(Pw + 8 * n) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(Pw + 8 * PLD + 8 * n) =
          make_float2(s[n][2], s[n][3]);
    }
    if (t == 0) {
      rowv[g] = alpha[0];
      rowv[8 + g] = alpha[1];
      rowv[48 + g] = ps[0];
      rowv[56 + g] = ps[1];
    }
  };

  // acc = acc * alpha, then P V of tile vt on f32 FFMA, keys in order: the
  // lane's rows rw + pr + 4 i, columns col0 + 32 c (+0..3); 4 keys of P a
  // float4 load a row, one V row a float4 load a column group
  float4 acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto pv_begin = [&]() {
    if constexpr (C::PAIR > 1) {   // l with both halves' row sums
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mine = rowv[48 + g + 8 * i];
        const float other = partner[48 + g + 8 * i];
        l[i] = l[i] * rowv[g + 8 * i] + (half ? other + mine : mine + other);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = rowv[pr + 4 * i];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        acc[i][c].x *= al;
        acc[i][c].y *= al;
        acc[i][c].z *= al;
        acc[i][c].w *= al;
      }
    }
  };
  // keys 4 kq .. 4 kq + 3 of tile vt
  auto pv_step = [&](int vt, int kq) {
    const float* Pr = smem + C::P + (C::PAIR > 1 ? (vt & 1) * BQ * PLD : 0) +
                      (rw + pr) * PLD;
    const float* Vc = smem + C::V + (vt & 1) * C::TILE + col0;
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p4[i] = *reinterpret_cast<const float4*>(Pr + 4 * i * PLD + 4 * kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 vv[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c)
        vv[c] = *reinterpret_cast<const float4*>(Vc + (4 * kq + kk) * LD +
                                                 32 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = lane_of(p4[i], kk);
#pragma unroll
        for (int c = 0; c < CG; ++c) {
          acc[i][c].x = __fmaf_rn(p, vv[c].x, acc[i][c].x);
          acc[i][c].y = __fmaf_rn(p, vv[c].y, acc[i][c].y);
          acc[i][c].z = __fmaf_rn(p, vv[c].z, acc[i][c].z);
          acc[i][c].w = __fmaf_rn(p, vv[c].w, acc[i][c].w);
        }
      }
    }
  };

  auto scores = [&](float (&s)[NKT][4], int kt) {
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) score_step(s, kt, kk);
  };
  auto pv = [&](int vt) {
    pv_begin();
#pragma unroll
    for (int kq = 0; kq < BKEY / 4; ++kq) pv_step(vt, kq);
  };

  if constexpr (C::PAIR == 1) {
    // tile it + 1 requested before tile it's scores, softmax and P V
    for (int it = 0; it < nkt; ++it) {
      if (it + 1 < nkt) {
        load(it + 1, true);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      split_k(it);
      __syncthreads();   // tile it split (and, the first time, q') complete
      if (active) {
        float s[NKT][4];
        scores(s, it);
        softmax(s, it);
        __syncwarp();    // P and alpha of the warp's rows
        pv(it);
      }
      __syncthreads();   // stage it & 1 and P free
    }
  } else {
    // tile 0's scores; then tile it + 1's scores beside tile it's P V,
    // and tile it + 1's softmax; last, the last tile's P V
    cp_async_wait<1>();
    split_k(0);
    __syncthreads();     // K tile 0 split, q' complete
    if (active) {
      float s[NKT][4];
      scores(s, 0);
      softmax(s, 0);
    }
    for (int it = 0; it + 1 < nkt; ++it) {
      cp_async_wait<0>();   // K tile it + 1 and V tile it
      split_k(it + 1);
      // K it + 1 split, V it and P it complete; K tile it's stage, V tile
      // it - 1's and P it - 1's free
      __syncthreads();
      if (it + 2 < nkt) load(it + 2, false);
      load_v(it + 1);
      cp_async_commit();
      if (active) {
        float s[NKT][4];
        pv_begin();
        scores(s, it + 1);
#pragma unroll
        for (int kq = 0; kq < BKEY / 4; ++kq) pv_step(it, kq);
        softmax(s, it + 1);
      }
    }
    cp_async_wait<0>();   // V tile nkt - 1
    __syncthreads();
    if (active) pv(nkt - 1);
  }

  const int any_valid = __syncthreads_or(valid);
  const bool zero = zero_masked_rows && !any_valid;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(l[i], 1e-30f);
    const int r = q0 + rw + g + 8 * i;
    if (t == 0) {
      rowv[16 + g + 8 * i] = l_safe;
      if (half == 0 && r < lq) lse[(size_t)bh * lq + r] = m[i] + logf(l_safe);
    }
  }
  __syncwarp();
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rw + pr + 4 * i;
    if (r >= lq) continue;
    const float l_safe = rowv[16 + pr + 4 * i];
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = col0 + 32 * c;
      if (col >= dh) continue;   // dh is a multiple of 4: all four or none
      float4 y = make_float4(acc[i][c].x / l_safe, acc[i][c].y / l_safe,
                             acc[i][c].z / l_safe, acc[i][c].w / l_safe);
      if (zero) y = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(ob + r * so.l + col) = y;
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float* lse, int batch,
                   int heads, int lq, int lk, int dh, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, int zero_masked_rows,
                   cudaStream_t stream) {
  constexpr size_t smem = Cfg<DH>::bytes;
  const cudaError_t e = allow_shared_once<flash_fwd_kernel<DH>>(smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)batch * heads * ((lq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<DH><<<(unsigned)blocks, Cfg<DH>::THREADS, smem, stream>>>(
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
