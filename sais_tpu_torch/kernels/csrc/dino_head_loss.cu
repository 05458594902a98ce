// K7: the DINO head's weight-normed last layer and the DINO loss with their
// gradients, tiled over out_dim, for Hopper (sm_90a).
//
// Replaces sais_tpu/kernels/dino_head_loss.py::_fused_loss_and_grads, the
// two Pallas passes _stats_kernel (:95) and _grad_kernel (:131).  With
// w = v / ||v||_col [* g] rounded to bf16, s = hs . ws / temp_s and the
// teacher's ts = (ht . wt - center) / temp_t, it computes
//
//   loss   = (sum_r -qbar_r . s_r + sum_r c_r lse_s_r) / (B n_terms)
//   center = column means of ht . wt over the teacher rows
//   dl     = bf16((c p - qbar) / (temp_s B n_terms)),  p = softmax(s),
//            q = softmax(ts), qbar = sel . q
//   dh_s   = dl . ws^T,   dw = hs^T . dl,
//   dv     = (du - u sum_k(u du)) / ||v||, du = dw [* g], dg = sum_k(u dw)
//
// with the Pallas bodies' rounding points (bf16 operands, f32 accumulation,
// dl rounded to bf16 before both of its products).  The (rows, out_dim)
// logits never reach device memory: every kernel recomputes its tile of
// them from hs and the bf16 weights.
//
// What bounds it on an H100: at the pretrain step (640 student rows, 128
// teacher rows, bottleneck 256, out_dim 65536) the function needs s = hs . ws
// (student rows), tl = ht . wt (teacher rows), dh_s = dl . ws^T and dw =
// hs^T . dl: 2 db k (3 rs + rt) = 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s
// bf16, against about 204 MB that must move (v of student and teacher read
// once, dv written once: 0.061 ms at 3.35 TB/s), so operations bound it.
// That the kernels below recompute s and tl instead of storing them is this
// design's own overhead, outside the bound.
//
// The TPU grid runs in order, so the Pallas bodies carry three sums across
// grid steps (the running row max and sum, the loss, dh_s).  Here blocks
// run in any order, so each sum is written as per-block partials that a
// later kernel reduces in a fixed order: no atomics, and the result does
// not depend on the order blocks run in.  The sequence, on the caller's
// stream:
//
//   (1) pair_index_kernel  the nonzeros of sel per student row (the pair
//                          structure: at most a few teacher rows a row)
//   (1b) normalize_kernel  w = bf16(v / ||v|| [* g]) of student and teacher
//                          into the workspace (db x out_dim bf16 each), the
//                          column norms summed in float64
//   (2) stats_kernel       per 64-column tile: each row's (max, sum exp) of
//                          s and of ts over the tile, and the tile's center
//   (3) merge_stats_kernel per row, the tiles' statistics merged in tile
//                          order into lse_s and lse_t
//   (4) grad_v_kernel      per 64-column tile, over 64-row chunks of hs:
//                          the q of the teacher rows the chunk pairs with
//                          (a window of up to QW teacher rows in shared
//                          memory, kept while later chunks pair inside
//                          it), then s, p, qbar, the loss partial, dl, and
//                          dw in registers; then dv and dg of the tile
//   (5) grad_h_kernel      per (64 student rows, run of tiles; one wave):
//                          s, the paired teacher rows' q (in windows of up
//                          to QW rows), and dl again, dh_s of the rows over
//                          the run in registers, written as the run's
//                          partial
//   (6) reduce_splits      dh_s = the runs' partials summed in run order
//   (7) loss_kernel        the loss partials and sum c lse_s, in order
//
// Every product is mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// ldmatrix fragments (vit_block_common.cuh); tiles of the logits, p, q and
// dl exist only in registers and shared memory.  Any number of teacher rows
// is taken: each student row's qbar is summed in registers over the windows
// of teacher rows it pairs with, in ascending row order.
//
// The kernels allocate nothing: the caller passes the workspace.

#include <climits>

#include "vit_block_common.cuh"

namespace {

constexpr int TN = 64;             // out_dim columns per tile
constexpr int RCH = 64;            // rows per chunk
constexpr int K7_THREADS = 256;    // 8 warps
constexpr int LDW = TN + 8;        // bf16 weight tile (db x TN) row stride
constexpr int LDS = TN + 4;        // f32 staging row stride
constexpr int LDD = TN + 8;        // bf16 dl tile row stride
constexpr int QW = 256;            // teacher rows whose q of a tile sit in smem

template <int DB>
__host__ __device__ constexpr int lda() { return DB + 8; }   // bf16 row chunk (RCH x DB)

struct K7Params {
  const bf16* hs;
  const bf16* ht;
  const float* vs;
  const float* vt;
  const float* gs;
  const float* gt;
  const float* center;
  const float* temp_t;
  const float* sel;
  const float* c;
  int* pair_n;
  int* pair_t;
  float* pair_w;
  float* ms_part;
  float* ls_part;
  float* mt_part;
  float* lt_part;
  float* lse_s;
  float* lse_t;
  float* bc;
  float* loss_part;
  float* dvs;
  float* dgs;
  float* dh_part;
  bf16* ws_g;     // (db, k) bf16 normalized student weights
  bf16* wt_g;     // (db, k) bf16 normalized teacher weights
  float* nrm_s;   // (k,) the student's clamped column norms
  int rs, rt, k, ntiles, tiles_per_run;
  int use_g;
  float inv_ts, dl_scale;
};

// ---------------------------------------------------------------------------
// Building blocks shared by the kernels.  Products and sums that two
// kernels must agree on (the normalized weights, s, ts) use the _rn
// intrinsics, so the compiler contracts nothing differently between them.
// ---------------------------------------------------------------------------

// W (DB x TN, bf16) = bf16(v / ||v||_col [* g]) of columns c0..c0+63, and
// nrm = the clamped column norms.  The sums of squares run in float64 (16
// row groups per column, then the groups in order), so that the f32 norm is
// the correctly rounded one whatever the summation order, and the plain
// version, which sums in float64 too, rounds w to bf16 identically.
// W has row stride ldw; dscratch: 16 x TN doubles.
template <int DB>
__device__ void prep_w(const float* __restrict__ v, const float* __restrict__ g,
                       int use_g, int K, int c0, bf16* W, int ldw, float* nrm,
                       double* dscratch, int tid) {
  const int cq = (tid & 15) * 4, r0 = tid >> 4;
  double ss[4] = {0.0, 0.0, 0.0, 0.0};
  for (int r = r0; r < DB; r += 16) {
    const float4 x =
        *reinterpret_cast<const float4*>(v + (size_t)r * K + c0 + cq);
    ss[0] = __dadd_rn(ss[0], __dmul_rn(x.x, x.x));
    ss[1] = __dadd_rn(ss[1], __dmul_rn(x.y, x.y));
    ss[2] = __dadd_rn(ss[2], __dmul_rn(x.z, x.z));
    ss[3] = __dadd_rn(ss[3], __dmul_rn(x.w, x.w));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dscratch[r0 * TN + cq + i] = ss[i];
  __syncthreads();
  if (tid < TN) {
    double s = 0.0;
    for (int i = 0; i < 16; ++i) s = __dadd_rn(s, dscratch[i * TN + tid]);
    nrm[tid] = fmaxf(__double2float_rn(__dsqrt_rn(s)), 1e-12f);
  }
  __syncthreads();
  for (int r = r0; r < DB; r += 16) {
    const float4 x =
        *reinterpret_cast<const float4*>(v + (size_t)r * K + c0 + cq);
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float u = __fdiv_rn(xv[i], nrm[cq + i]);
      if (use_g) u = __fmul_rn(u, g[c0 + cq + i]);
      W[(size_t)r * ldw + cq + i] = __float2bfloat16(u);
    }
  }
  __syncthreads();
}

// A (RCH x DB, bf16) = rows r0..r0+63 of src (n x DB); rows >= n are 0.
template <int DB>
__device__ void load_rows(bf16* A, const bf16* __restrict__ src, int r0,
                          int n, int tid) {
  constexpr int CPR = DB / 8;   // 16-byte chunks a row
  for (int i = tid; i < RCH * CPR; i += K7_THREADS) {
    const int r = i / CPR, cc = (i % CPR) * 8;
    const bool ok = r0 + r < n;
    cp_async16(A + r * lda<DB>() + cc,
               src + (ok ? (size_t)(r0 + r) * DB + cc : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// W (DB x TN, bf16, row stride LDW) = columns c0..c0+63 of src (DB x K).
template <int DB>
__device__ void load_w(bf16* W, const bf16* __restrict__ src, int c0, int K,
                       int tid) {
  for (int i = tid; i < DB * (TN / 8); i += K7_THREADS) {
    const int r = i / (TN / 8), cc = (i % (TN / 8)) * 8;
    cp_async16(W + r * LDW + cc, src + (size_t)r * K + c0 + cc, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// acc = A (RCH x DB) . W (DB x TN): warp (wm, wn) = (warp / 2, warp % 2)
// owns rows 16 wm.., columns 32 wn.. (four m16n8 tiles).
template <int DB>
__device__ void gemm_chunk(float (&acc)[4][4], const bf16* A, const bf16* W,
                           int warp, int lane) {
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DB; kk += 16) {
    uint32_t a[4], b[4][2];
    load_a_frag(a, A + (wm * 16) * lda<DB>() + kk, lda<DB>(), lane);
    load_b_frags_kn(&b[0][0], W + kk * LDW + wn * 32, LDW, lane);
    load_b_frags_kn(&b[2][0], W + kk * LDW + wn * 32 + 16, LDW, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[j], a, b[j][0], b[j][1]);
  }
}

// S (RCH x TN, f32) = acc * scale.
__device__ void stage(const float (&acc)[4][4], float* S, float scale,
                      int warp, int lane) {
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = wm * 16 + g, col = wn * 32 + j * 8 + 2 * t;
    S[row * LDS + col] = __fmul_rn(acc[j][0], scale);
    S[row * LDS + col + 1] = __fmul_rn(acc[j][1], scale);
    S[(row + 8) * LDS + col] = __fmul_rn(acc[j][2], scale);
    S[(row + 8) * LDS + col + 1] = __fmul_rn(acc[j][3], scale);
  }
}

// ts = (tl - center) / temp_t of a staged teacher value.
__device__ __forceinline__ float teacher_score(float tl, float center,
                                               float inv_tt) {
  return __fmul_rn(__fsub_rn(tl, center), inv_tt);
}

// Per row of S (4 threads a row, 16 columns each): the tile's max and sum of
// exp(x - max), x = S (student, already scaled) or the teacher score.
__device__ void row_stats(const float* S, const float* __restrict__ center,
                          int c0, float inv_tt, int r0, int n, float* m_out,
                          float* l_out, int stride, int tid) {
  const int row = tid >> 2, cg = (tid & 3) * 16;
  float x[16];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = S[row * LDS + cg + j];
    if (center != nullptr) v = teacher_score(v, center[c0 + cg + j], inv_tt);
    x[j] = v;
    m = fmaxf(m, v);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) l = __fadd_rn(l, expf(__fsub_rn(x[j], m)));
  l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 1));
  l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, 2));
  if ((tid & 3) == 0 && r0 + row < n) {
    m_out[(size_t)(r0 + row) * stride] = m;
    l_out[(size_t)(r0 + row) * stride] = l;
  }
}

// Q[t - qlo] (f32, rows of LDS) = exp(ts - lse_t[t]) for staged teacher
// rows t = r0.. below qhi.
__device__ void teacher_q(const K7Params& p, const float* S, float* Q,
                          int c0, float inv_tt, int r0, int qlo, int qhi,
                          int tid) {
  const int row = tid >> 2, cg = (tid & 3) * 16, t = r0 + row;
  if (t >= qhi) return;
  const float lse = p.lse_t[t];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float ts =
        teacher_score(S[row * LDS + cg + j], p.center[c0 + cg + j], inv_tt);
    Q[(t - qlo) * LDS + cg + j] = expf(__fsub_rn(ts, lse));
  }
}

// Q = the q of teacher rows [qlo, qhi) (at most QW) of the tile at c0: W
// holds the tile's teacher weights, A and S stage 64 teacher rows at a time.
template <int DB>
__device__ void teacher_window(const K7Params& p, const bf16* W, bf16* A,
                               float* S, float* Q, int c0, float inv_tt,
                               int qlo, int qhi, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  float acc[4][4];
  for (int tr = qlo; tr < qhi; tr += RCH) {
    load_rows<DB>(A, p.ht, tr, p.rt, tid);
    gemm_chunk<DB>(acc, A, W, warp, lane);
    stage(acc, S, 1.f, warp, lane);
    __syncthreads();
    teacher_q(p, S, Q, c0, inv_tt, tr, qlo, qhi, tid);
    __syncthreads();
  }
}

// [tlo, thi): the teacher rows that student rows r0..r0+63 pair with
// (tlo >= thi when they pair with none).  lims: 16 ints of shared memory.
__device__ void pair_range(const K7Params& p, int r0, int* lims, int tid,
                           int& tlo, int& thi) {
  const int warp = tid >> 5, lane = tid & 31;
  int lo = INT_MAX, hi = -1;
  if (tid < RCH && r0 + tid < p.rs) {
    const int r = r0 + tid, n = p.pair_n[r];
    if (n > 0) {
      lo = p.pair_t[(size_t)r * p.rt];
      hi = p.pair_t[(size_t)r * p.rt + n - 1];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __syncthreads();   // earlier readers of lims are done
  if (lane == 0) {
    lims[2 * warp] = lo;
    lims[2 * warp + 1] = hi;
  }
  __syncthreads();
  tlo = INT_MAX;
  thi = -1;
  for (int w = 0; w < K7_THREADS / 32; ++w) {
    tlo = min(tlo, lims[2 * w]);
    thi = max(thi, lims[2 * w + 1]);
  }
  thi += 1;   // no pairs: thi = 0 <= tlo
}

// qb += sel . q over the teacher rows [qlo, qhi) staged in Q, for this
// thread's row r0 + tid / 4 and its 16 columns.  The pairs are in ascending
// teacher row, so over windows taken in ascending order each qb is summed
// in the order of the dense product's nonzero terms.
__device__ void add_qbar(const K7Params& p, const float* Q, int qlo, int qhi,
                         int r0, int tid, float (&qb)[16]) {
  const int row = tid >> 2, cg = (tid & 3) * 16, r = r0 + row;
  if (r >= p.rs) return;
  const int n = p.pair_n[r];
  const int* pt = p.pair_t + (size_t)r * p.rt;
  const float* pw = p.pair_w + (size_t)r * p.rt;
  for (int i = 0; i < n; ++i) {
    const int t = pt[i];
    if (t < qlo) continue;
    if (t >= qhi) break;
    const float w = pw[i];
    const float* q = Q + (t - qlo) * LDS + cg;
#pragma unroll
    for (int j = 0; j < 16; ++j) qb[j] = __fadd_rn(qb[j], __fmul_rn(w, q[j]));
  }
}

// DL (RCH x TN, bf16) = bf16((c p - qbar) dl_scale) of the staged student
// scores S of rows r0.. (0 past rs), qbar this thread's qb; returns this
// thread's share of sum -qbar s.
__device__ float make_dl(const K7Params& p, const float* S,
                         const float (&qb)[16], bf16* DL, int r0, int tid) {
  const int row = tid >> 2, cg = (tid & 3) * 16, r = r0 + row;
  float loss = 0.f;
  if (r >= p.rs) {
#pragma unroll
    for (int j = 0; j < 16; ++j) DL[row * LDD + cg + j] = __float2bfloat16(0.f);
    return loss;
  }
  const float lse = p.lse_s[r], cr = p.c[r];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = cg + j;
    const float s = S[row * LDS + col];
    const float pr = expf(__fsub_rn(s, lse));
    loss = __fadd_rn(loss, __fmul_rn(-qb[j], s));
    DL[row * LDD + col] = __float2bfloat16(
        __fmul_rn(__fsub_rn(__fmul_rn(cr, pr), qb[j]), p.dl_scale));
  }
  return loss;
}

// ---------------------------------------------------------------------------
// (1) The pair structure: per student row, the teacher rows t with
// sel[r][t] != 0 in ascending order and their weights.  Summing the
// selected q in that order gives exactly the dense sel . q (the other terms
// are exact zeros).
// ---------------------------------------------------------------------------
__global__ void pair_index_kernel(K7Params p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.rs) return;
  int n = 0;
  for (int t = 0; t < p.rt; ++t) {
    const float w = p.sel[(size_t)r * p.rt + t];
    if (w != 0.f) {
      p.pair_t[(size_t)r * p.rt + n] = t;
      p.pair_w[(size_t)r * p.rt + n] = w;
      ++n;
    }
  }
  p.pair_n[r] = n;
}

// ---------------------------------------------------------------------------
// (1b) The bf16 weights w = bf16(v / ||v|| [* g]) of student (blockIdx.y 0)
// and teacher (1), one 64-column tile a block, and the student's norms.
// Every later kernel loads its tiles of them.
// ---------------------------------------------------------------------------
template <int DB>
__global__ void __launch_bounds__(K7_THREADS) normalize_kernel(K7Params p) {
  __shared__ double dscratch[16 * TN];
  __shared__ float nrm[TN];
  const int tid = threadIdx.x, c0 = blockIdx.x * TN;
  const bool teacher = blockIdx.y == 1;
  prep_w<DB>(teacher ? p.vt : p.vs, teacher ? p.gt : p.gs, p.use_g, p.k, c0,
             (teacher ? p.wt_g : p.ws_g) + c0, p.k, nrm, dscratch, tid);
  if (!teacher && tid < TN) p.nrm_s[c0 + tid] = nrm[tid];
}

// ---------------------------------------------------------------------------
// (2) Statistics of one 64-column tile (Pallas _stats_kernel).
// ---------------------------------------------------------------------------
template <int DB>
constexpr size_t stats_smem() {
  return (size_t)DB * LDW * 2 + (size_t)RCH * lda<DB>() * 2 +
         (size_t)RCH * LDS * 4;
}

template <int DB>
__global__ void __launch_bounds__(K7_THREADS) stats_kernel(K7Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* W = reinterpret_cast<bf16*>(smem_raw);
  bf16* A = W + DB * LDW;
  float* S = reinterpret_cast<float*>(A + RCH * lda<DB>());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, c0 = tile * TN;
  const float inv_tt = __fdiv_rn(1.f, p.temp_t[0]);
  float acc[4][4];

  // teacher: row statistics of ts and the column means of tl
  load_w<DB>(W, p.wt_g, c0, p.k, tid);
  float colsum = 0.f;
  for (int r0 = 0; r0 < p.rt; r0 += RCH) {
    load_rows<DB>(A, p.ht, r0, p.rt, tid);
    gemm_chunk<DB>(acc, A, W, warp, lane);
    stage(acc, S, 1.f, warp, lane);
    __syncthreads();
    if (tid < TN)
      for (int i = 0; i < RCH && r0 + i < p.rt; ++i)
        colsum = __fadd_rn(colsum, S[i * LDS + tid]);
    row_stats(S, p.center, c0, inv_tt, r0, p.rt, p.mt_part + tile,
              p.lt_part + tile, p.ntiles, tid);
    __syncthreads();
  }
  if (tid < TN) p.bc[c0 + tid] = __fdiv_rn(colsum, (float)p.rt);

  // student: row statistics of s = hs . ws / temp_s
  load_w<DB>(W, p.ws_g, c0, p.k, tid);
  for (int r0 = 0; r0 < p.rs; r0 += RCH) {
    load_rows<DB>(A, p.hs, r0, p.rs, tid);
    gemm_chunk<DB>(acc, A, W, warp, lane);
    stage(acc, S, p.inv_ts, warp, lane);
    __syncthreads();
    row_stats(S, nullptr, c0, 0.f, r0, p.rs, p.ms_part + tile,
              p.ls_part + tile, p.ntiles, tid);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// (3) lse of each row from its tiles' (max, sum exp) (row-major partials,
// one row a warp): lanes take strided tiles, then a fixed butterfly.
// ---------------------------------------------------------------------------
__global__ void merge_stats_kernel(const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   float* __restrict__ lse, int n,
                                   int ntiles) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const float* mr = m_part + (size_t)r * ntiles;
  const float* lr = l_part + (size_t)r * ntiles;
  float m = -INFINITY;
  for (int i = lane; i < ntiles; i += 32) m = fmaxf(m, mr[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int i = lane; i < ntiles; i += 32)
    l = __fadd_rn(l, __fmul_rn(lr[i], expf(__fsub_rn(mr[i], m))));
  l = warp_sum(l);
  if (lane == 0) lse[r] = m + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// (4) dv, dg and the loss partial of one 64-column tile (Pallas
// _grad_kernel without dh_s).
// ---------------------------------------------------------------------------
// Teacher rows whose q the gradient kernels keep in shared memory.
__host__ __device__ inline int k7_qrows(int rt) { return rt < QW ? rt : QW; }

template <int DB>
constexpr size_t grad_v_smem(int qrows) {
  return 2 * (size_t)DB * LDW * 2 + (size_t)RCH * lda<DB>() * 2 +
         (size_t)RCH * LDS * 4 + (size_t)RCH * LDD * 2 +
         (size_t)qrows * LDS * 4 + (16 * TN + 8) * 4 + 16 * 4;
}

template <int DB>
__global__ void __launch_bounds__(K7_THREADS) grad_v_kernel(K7Params p) {
  constexpr int MT = DB / 128;   // m16 tiles of dw rows per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* Wt = Ws + DB * LDW;
  bf16* A = Wt + DB * LDW;
  float* S = reinterpret_cast<float*>(A + RCH * lda<DB>());
  bf16* DL = reinterpret_cast<bf16*>(S + RCH * LDS);
  float* Q = reinterpret_cast<float*>(DL + RCH * LDD);
  float* scratch = Q + k7_qrows(p.rt) * LDS;
  float* red = scratch + 16 * TN;
  int* lims = reinterpret_cast<int*>(red + 8);
  float* DW = reinterpret_cast<float*>(smem_raw);   // DB x LDS over Ws, Wt
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, c0 = tile * TN;
  const float inv_tt = __fdiv_rn(1.f, p.temp_t[0]);
  float acc[4][4];

  load_w<DB>(Wt, p.wt_g, c0, p.k, tid);
  load_w<DB>(Ws, p.ws_g, c0, p.k, tid);
  // student rows in chunks: qbar, dl, the loss, dw = hs^T dl in registers
  float dw[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dw[i][j][0] = dw[i][j][1] = dw[i][j][2] = dw[i][j][3] = 0.f;
  float loss = 0.f;
  int qlo = 0, qhi = 0;   // the teacher rows whose q Q holds
  for (int r0 = 0; r0 < p.rs; r0 += RCH) {
    int tlo, thi;
    pair_range(p, r0, lims, tid, tlo, thi);
    float qb[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) qb[j] = 0.f;
    // the QW-aligned windows of teacher rows the chunk pairs with
    for (int w0 = tlo; w0 < thi;) {
      const int wlo = w0 / QW * QW, whi = min(wlo + QW, p.rt);
      if (wlo != qlo || whi != qhi) {
        teacher_window<DB>(p, Wt, A, S, Q, c0, inv_tt, wlo, whi, tid);
        qlo = wlo;
        qhi = whi;
      }
      add_qbar(p, Q, qlo, qhi, r0, tid, qb);
      w0 = whi;
    }
    load_rows<DB>(A, p.hs, r0, p.rs, tid);
    gemm_chunk<DB>(acc, A, Ws, warp, lane);
    stage(acc, S, p.inv_ts, warp, lane);
    __syncthreads();
    loss = __fadd_rn(loss, make_dl(p, S, qb, DL, r0, tid));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RCH; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a_frag_km(a[i], A + kk * lda<DB>() + (warp * MT + i) * 16,
                       lda<DB>(), lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        load_b_frags_kn(b, DL + kk * LDD + j * 8, LDD, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(dw[i][j], a[i], b[0], b[1]);
          mma_bf16_16816(dw[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // the tile's loss partial: lanes, then warps in order
  loss = warp_sum(loss);
  if (lane == 0) red[warp] = loss;
  // dw to shared memory (over Ws and Wt, no longer read)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = (warp * MT + i) * 16 + g, col = j * 8 + 2 * t;
      DW[row * LDS + col] = dw[i][j][0];
      DW[row * LDS + col + 1] = dw[i][j][1];
      DW[(row + 8) * LDS + col] = dw[i][j][2];
      DW[(row + 8) * LDS + col + 1] = dw[i][j][3];
    }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < K7_THREADS / 32; ++w) s = __fadd_rn(s, red[w]);
    p.loss_part[tile] = s;
  }

  // dv = (du - u sum(u du)) / n, dg = sum(u dw): four row quarters a
  // column, combined in order
  const int col = tid & (TN - 1), part = tid >> 6;
  constexpr int QR = DB / 4;
  const float n = p.nrm_s[c0 + col];
  const float gcol = p.use_g ? p.gs[c0 + col] : 1.f;
  float sud = 0.f, sdg = 0.f;
  for (int r = part * QR; r < (part + 1) * QR; ++r) {
    const float u = __fdiv_rn(p.vs[(size_t)r * p.k + c0 + col], n);
    const float w = DW[r * LDS + col];
    if (p.use_g) {
      sdg = __fadd_rn(sdg, __fmul_rn(u, w));
      sud = __fadd_rn(sud, __fmul_rn(u, __fmul_rn(w, gcol)));
    } else {
      sud = __fadd_rn(sud, __fmul_rn(u, w));
    }
  }
  scratch[part * TN + col] = sud;
  scratch[(4 + part) * TN + col] = sdg;
  __syncthreads();
  if (part == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < 4; ++i) {
      a = __fadd_rn(a, scratch[i * TN + col]);
      b = __fadd_rn(b, scratch[(4 + i) * TN + col]);
    }
    scratch[8 * TN + col] = a;
    p.dgs[c0 + col] = p.use_g ? b : 0.f;
  }
  __syncthreads();
  sud = scratch[8 * TN + col];
  for (int r = part * QR; r < (part + 1) * QR; ++r) {
    const float u = __fdiv_rn(p.vs[(size_t)r * p.k + c0 + col], n);
    const float w = DW[r * LDS + col];
    const float du = p.use_g ? __fmul_rn(w, gcol) : w;
    p.dvs[(size_t)r * p.k + c0 + col] =
        __fdiv_rn(__fsub_rn(du, __fmul_rn(u, sud)), n);
  }
}

// ---------------------------------------------------------------------------
// (5) dh_s of 64 student rows over a run of tiles (the Pallas body's dh_s
// accumulator), kept in registers and written as the run's partial.
// ---------------------------------------------------------------------------
template <int DB>
constexpr size_t grad_h_smem(int qrows) {
  return (size_t)DB * LDW * 2 + 2 * (size_t)RCH * lda<DB>() * 2 +
         (size_t)RCH * LDS * 4 + (size_t)RCH * LDD * 2 +
         (size_t)qrows * LDS * 4 + 16 * 4;
}

template <int DB>
__global__ void __launch_bounds__(K7_THREADS) grad_h_kernel(K7Params p) {
  constexpr int NT = DB / 32;   // n8 tiles of dh columns per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* W = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ah = W + DB * LDW;
  bf16* At = Ah + RCH * lda<DB>();
  float* S = reinterpret_cast<float*>(At + RCH * lda<DB>());
  bf16* DL = reinterpret_cast<bf16*>(S + RCH * LDS);
  float* Q = reinterpret_cast<float*>(DL + RCH * LDD);
  int* lims = reinterpret_cast<int*>(Q + k7_qrows(p.rt) * LDS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * RCH, run = blockIdx.y;
  const int t_begin = run * p.tiles_per_run;
  const int t_end = min(p.ntiles, t_begin + p.tiles_per_run);
  const float inv_tt = __fdiv_rn(1.f, p.temp_t[0]);
  float acc[4][4];

  int tlo, thi;   // the teacher rows these student rows pair with
  pair_range(p, r0, lims, tid, tlo, thi);
  load_rows<DB>(Ah, p.hs, r0, p.rs, tid);

  float dh[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) dh[i][j][0] = dh[i][j][1] = dh[i][j][2] = dh[i][j][3] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int c0 = tile * TN;
    float qb[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) qb[j] = 0.f;
    if (tlo < thi) load_w<DB>(W, p.wt_g, c0, p.k, tid);
    for (int wlo = tlo; wlo < thi; wlo += QW) {
      const int whi = min(wlo + QW, thi);
      teacher_window<DB>(p, W, At, S, Q, c0, inv_tt, wlo, whi, tid);
      add_qbar(p, Q, wlo, whi, r0, tid, qb);
    }
    load_w<DB>(W, p.ws_g, c0, p.k, tid);
    gemm_chunk<DB>(acc, Ah, W, warp, lane);
    stage(acc, S, p.inv_ts, warp, lane);
    __syncthreads();
    make_dl(p, S, qb, DL, r0, tid);
    __syncthreads();
    // dh += dl (RCH x TN) . ws^T (TN x DB): warp (wm, wn) owns rows 32 wm..,
    // columns wn DB/4..
#pragma unroll
    for (int kk = 0; kk < TN; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a_frag(a[i], DL + (wm * 32 + i * 16) * LDD + kk, LDD, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        load_b_frags_nk(b, W + (wn * (DB / 4) + j * 8) * LDW + kk, LDW, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16_16816(dh[i][j], a[i], b[0], b[1]);
          mma_bf16_16816(dh[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  float* out = p.dh_part + (size_t)run * p.rs * DB;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = r0 + wm * 32 + i * 16 + g;
      const int col = wn * (DB / 4) + j * 8 + 2 * t;
      if (row < p.rs)
        *reinterpret_cast<float2*>(out + (size_t)row * DB + col) =
            make_float2(dh[i][j][0], dh[i][j][1]);
      if (row + 8 < p.rs)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * DB + col) =
            make_float2(dh[i][j][2], dh[i][j][3]);
    }
}

// ---------------------------------------------------------------------------
// (7) loss = (sum of the tiles' partials + sum_r c_r lse_s_r) * inv_norm,
// each sum over 256 strided lanes then a fixed tree.
// ---------------------------------------------------------------------------
__global__ void loss_kernel(const float* __restrict__ loss_part, int ntiles,
                            const float* __restrict__ c,
                            const float* __restrict__ lse_s, int rs,
                            float inv_norm, float* __restrict__ loss) {
  __shared__ float a[256], b[256];
  const int tid = threadIdx.x;
  float sa = 0.f, sb = 0.f;
  for (int i = tid; i < ntiles; i += 256) sa = __fadd_rn(sa, loss_part[i]);
  for (int i = tid; i < rs; i += 256)
    sb = __fadd_rn(sb, __fmul_rn(c[i], lse_s[i]));
  a[tid] = sa;
  b[tid] = sb;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (tid < s) {
      a[tid] = __fadd_rn(a[tid], a[tid + s]);
      b[tid] = __fadd_rn(b[tid], b[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) *loss = __fmul_rn(__fadd_rn(a[0], b[0]), inv_norm);
}

// Runs of tiles for grad_h_kernel: at most one (row chunk, run) block per
// SM of the card (one block fits an SM), so all run in one wave.
inline void k7_runs(int rs, int ntiles, int* runs, int* per) {
  const int chunks = (rs + RCH - 1) / RCH;
  int want = 132 / chunks;
  if (want > ntiles) want = ntiles;
  if (want < 1) want = 1;
  *per = (ntiles + want - 1) / want;
  *runs = (ntiles + *per - 1) / *per;
}

template <int DB>
cudaError_t k7_launch(K7Params p, float* loss, float* dhs, float inv_norm,
                      int runs, cudaStream_t stream) {
  cudaError_t e;
  pair_index_kernel<<<(p.rs + 127) / 128, 128, 0, stream>>>(p);
  if ((e = cudaGetLastError())) return e;
  normalize_kernel<DB><<<dim3(p.ntiles, 2), K7_THREADS, 0, stream>>>(p);
  if ((e = cudaGetLastError())) return e;

  const size_t s1 = stats_smem<DB>();
  if ((e = cudaFuncSetAttribute(stats_kernel<DB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s1))) return e;
  stats_kernel<DB><<<p.ntiles, K7_THREADS, s1, stream>>>(p);
  if ((e = cudaGetLastError())) return e;

  merge_stats_kernel<<<(p.rs + 7) / 8, 256, 0, stream>>>(
      p.ms_part, p.ls_part, p.lse_s, p.rs, p.ntiles);
  if ((e = cudaGetLastError())) return e;
  merge_stats_kernel<<<(p.rt + 7) / 8, 256, 0, stream>>>(
      p.mt_part, p.lt_part, p.lse_t, p.rt, p.ntiles);
  if ((e = cudaGetLastError())) return e;

  const size_t s2 = grad_v_smem<DB>(k7_qrows(p.rt));
  if ((e = cudaFuncSetAttribute(grad_v_kernel<DB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s2))) return e;
  grad_v_kernel<DB><<<p.ntiles, K7_THREADS, s2, stream>>>(p);
  if ((e = cudaGetLastError())) return e;

  const size_t s3 = grad_h_smem<DB>(k7_qrows(p.rt));
  if ((e = cudaFuncSetAttribute(grad_h_kernel<DB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s3))) return e;
  dim3 grid((p.rs + RCH - 1) / RCH, runs);
  grad_h_kernel<DB><<<grid, K7_THREADS, s3, stream>>>(p);
  if ((e = cudaGetLastError())) return e;

  if ((e = reduce_splits(p.dh_part, dhs, (size_t)p.rs * DB, runs, stream)))
    return e;
  loss_kernel<<<1, 256, 0, stream>>>(p.loss_part, p.ntiles, p.c, p.lse_s,
                                     p.rs, inv_norm, loss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace dino_head_loss needs (int arrays share the f32 slots).
size_t dino_head_loss_workspace(int rs, int rt, int db, int k) {
  const int ntiles = k / TN;
  int runs, per;
  k7_runs(rs, ntiles, &runs, &per);
  return (size_t)db * k + k + (size_t)rs + 2 * (size_t)rs * rt +
         2 * (size_t)ntiles * (rs + rt) + rs + rt + ntiles +
         (size_t)runs * rs * db;
}

// Return codes: 0 on success, a cudaError_t value after a failed launch, or
// cudaErrorInvalidValue for shapes the kernels do not take (the Python
// wrapper checks those first).  hs (rs, db) and ht (rt, db) bf16; vs, vt
// (db, k), gs, gt, center (k,), sel (rs, rt), c (rs,) and temp_t (1,) f32;
// outputs loss (1,), bc (k,), dhs (rs, db), dvs (db, k), dgs (k,) f32.
int dino_head_loss(const void* hs, const void* ht, const void* vs,
                   const void* vt, const void* gs, const void* gt,
                   const void* center, const void* temp_t, const void* sel,
                   const void* c, void* loss, void* bc, void* dhs, void* dvs,
                   void* dgs, void* workspace, int rs, int rt, int db, int k,
                   int use_g, float inv_ts, float dl_scale, float inv_norm,
                   void* stream_ptr) {
  if (rs < 1 || rt < 1 || k < 128 || k % 128 != 0 ||
      (db != 128 && db != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int ntiles = k / TN;
  int runs, per;
  k7_runs(rs, ntiles, &runs, &per);
  float* ws = static_cast<float*>(workspace);
  K7Params p;
  p.ws_g = reinterpret_cast<bf16*>(ws);   // first, so 16-byte aligned
  p.wt_g = p.ws_g + (size_t)db * k;
  ws += (size_t)db * k;
  p.nrm_s = ws;
  ws += k;
  p.hs = static_cast<const bf16*>(hs);
  p.ht = static_cast<const bf16*>(ht);
  p.vs = static_cast<const float*>(vs);
  p.vt = static_cast<const float*>(vt);
  p.gs = static_cast<const float*>(gs);
  p.gt = static_cast<const float*>(gt);
  p.center = static_cast<const float*>(center);
  p.temp_t = static_cast<const float*>(temp_t);
  p.sel = static_cast<const float*>(sel);
  p.c = static_cast<const float*>(c);
  p.pair_n = reinterpret_cast<int*>(ws);
  ws += rs;
  p.pair_t = reinterpret_cast<int*>(ws);
  ws += (size_t)rs * rt;
  p.pair_w = ws;
  ws += (size_t)rs * rt;
  p.ms_part = ws;
  ws += (size_t)ntiles * rs;
  p.ls_part = ws;
  ws += (size_t)ntiles * rs;
  p.mt_part = ws;
  ws += (size_t)ntiles * rt;
  p.lt_part = ws;
  ws += (size_t)ntiles * rt;
  p.lse_s = ws;
  ws += rs;
  p.lse_t = ws;
  ws += rt;
  p.loss_part = ws;
  ws += ntiles;
  p.dh_part = ws;
  p.bc = static_cast<float*>(bc);
  p.dvs = static_cast<float*>(dvs);
  p.dgs = static_cast<float*>(dgs);
  p.rs = rs;
  p.rt = rt;
  p.k = k;
  p.ntiles = ntiles;
  p.tiles_per_run = per;
  p.use_g = use_g;
  p.inv_ts = inv_ts;
  p.dl_scale = dl_scale;
  float* lp = static_cast<float*>(loss);
  float* dh = static_cast<float*>(dhs);
  if (db == 128)
    return (int)k7_launch<128>(p, lp, dh, inv_norm, runs, stream);
  return (int)k7_launch<256>(p, lp, dh, inv_norm, runs, stream);
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
