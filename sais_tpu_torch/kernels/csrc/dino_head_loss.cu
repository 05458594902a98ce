// K7: the DINO head's weight-normed last layer and the DINO loss with their
// gradients, for Hopper (sm_90a).
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
// with the Pallas bodies' rounding points (bf16 operands, f32 accumulation;
// s, tl, q and qbar in f32; dl rounded to bf16 before both of its
// products).
//
// What bounds it on an H100: at the pretrain step (640 student rows, 128
// teacher rows, bottleneck 256, out_dim 65536) the function needs s = hs . ws
// (student rows), tl = ht . wt (teacher rows), dh_s = dl . ws^T and dw =
// hs^T . dl: 2 db k (3 rs + rt) = 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s
// bf16, against about 204 MB that must move (v of student and teacher read
// once, dv written once: 0.061 ms at 3.35 TB/s), so operations bound it.
//
// The TPU grid runs in order, so the Pallas bodies carry three sums across
// grid steps (the running row max and sum, the loss, dh_s).  Here blocks
// run in any order, so each sum is written as per-block partials that a
// later launch reduces in a fixed order: no atomics, and the result does
// not depend on the order blocks run in.  Every product runs on the wgmma
// + TMA GEMM of gemm_sm90.cuh (128 x 192 tiles: out_dim 65536 is 341
// tiles and a 64-column one).  dl is rounded to bf16 before both of its
// products anyway, so it is stored once, in bf16, and read by both (84 MB
// at the pretrain step, 335 MB at batch 256); s is computed twice (its
// statistics, then dl), tl once and kept in f32 for q.  The sequence, on
// the caller's stream:
//
//   (1) pair_index_kernel    the nonzeros of sel per student row, in
//                            ascending teacher order
//   (2) normalize_kernel     w = bf16(v / ||v|| [* g]) of student and
//                            teacher (db x out_dim each), the column norms
//                            summed in float64; v read once
//   (3) gemm_sm90 EPI_STATS  tl = ht . wt: tl kept in f32, each row's (max,
//                            sum exp) of ts per tile, each 64-row half's
//                            column sums of tl
//   (4) gemm_sm90 EPI_STATS  s = hs . ws: each row's (max, sum exp) per tile
//   (5) merge_kernel         per row, the tiles' statistics merged in tile
//                            order into lse_t (and q = exp(ts - lse_t)
//                            written over tl) and lse_s; the batch center
//   (6) gemm_sm90 EPI_DL     s again: p, qbar (the paired q rows, copied
//                            to shared memory, summed in ascending
//                            order), the loss partial of each (64-row
//                            half, tile), dl stored in bf16
//   (7) gemm_sm90 EPI_F32    dw = hs^T . dl (hs read transposed) into dvs
//   (8) dv_kernel            per column: dg and dv = (du - u sum(u du)) / n
//                            over dw, in place
//   (9) gemm_sm90 EPI_F32    dh_s = dl . ws^T (ws read as its transpose),
//                            K = out_dim split into about 132 blocks' f32
//                            partials
//  (10) sum_parts_kernel     dh_s = the partials summed in split order
//  (11) loss_kernel          the loss partials and sum c lse_s, in order
//
// Any number of teacher rows is taken.  The kernels allocate nothing: the
// caller passes the workspace.

#include "gemm_sm90.cuh"

namespace {

constexpr int K7_TN = sm90::BN;   // out_dim columns a GEMM tile

inline int k7_tiles(int k) { return (k + K7_TN - 1) / K7_TN; }

// ---------------------------------------------------------------------------
// (1) The pair structure: per student row, the teacher rows t with
// sel[r][t] != 0 in ascending order and their weights.  Summing the
// selected q in that order gives exactly the dense sel . q (the other terms
// are exact zeros).  One warp a row: 32 teacher rows a step, compacted in
// order by a ballot.
// ---------------------------------------------------------------------------
__global__ void pair_index_kernel(const float* __restrict__ sel, int rs,
                                  int rt, int* __restrict__ pair_n,
                                  int* __restrict__ pair_t,
                                  float* __restrict__ pair_w) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rs) return;
  int n = 0;
  for (int t0 = 0; t0 < rt; t0 += 32) {
    const int t = t0 + lane;
    const float w = t < rt ? sel[(size_t)r * rt + t] : 0.f;
    const uint32_t mask = __ballot_sync(0xffffffffu, w != 0.f);
    if (w != 0.f) {
      const int at = n + __popc(mask & ((1u << lane) - 1));
      pair_t[(size_t)r * rt + at] = t;
      pair_w[(size_t)r * rt + at] = w;
    }
    n += __popc(mask);
  }
  if (lane == 0) pair_n[r] = n;
}

// ---------------------------------------------------------------------------
// (2) w = bf16(v / ||v|| [* g]) of student (blockIdx.y 0) and teacher (1),
// 64 columns a block, and the student's clamped norms.  A thread holds 4
// columns of DB / 16 rows in registers, so v is read once; the sums of
// squares run in float64 (16 row groups per column, then the groups in
// order), so that the f32 norm is the correctly rounded one whatever the
// summation order, and the plain version, which sums in float64 too,
// rounds w to bf16 identically.  Each thread stores 8 bytes of w a row.
// ---------------------------------------------------------------------------
template <int DB>
__global__ void __launch_bounds__(256)
    normalize_kernel(const float* __restrict__ vs,
                     const float* __restrict__ vt,
                     const float* __restrict__ gs,
                     const float* __restrict__ gt, int use_g, int k,
                     bf16* __restrict__ ws, bf16* __restrict__ wt,
                     float* __restrict__ nrm_s) {
  constexpr int RPT = DB / 16;
  __shared__ double part[16][64];
  __shared__ float nrm[64];
  const bool teacher = blockIdx.y == 1;
  const float* v = teacher ? vt : vs;
  const float* g = teacher ? gt : gs;
  bf16* w = teacher ? wt : ws;
  const int tid = threadIdx.x, c0 = blockIdx.x * 64;
  const int cq = (tid & 15) * 4, r0 = tid >> 4;
  float4 x[RPT];
  double ss[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    x[i] = *reinterpret_cast<const float4*>(v + (size_t)(r0 + 16 * i) * k +
                                            c0 + cq);
    ss[0] = __dadd_rn(ss[0], __dmul_rn(x[i].x, x[i].x));
    ss[1] = __dadd_rn(ss[1], __dmul_rn(x[i].y, x[i].y));
    ss[2] = __dadd_rn(ss[2], __dmul_rn(x[i].z, x[i].z));
    ss[3] = __dadd_rn(ss[3], __dmul_rn(x[i].w, x[i].w));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[r0][cq + j] = ss[j];
  __syncthreads();
  if (tid < 64) {
    double s = 0.0;
    for (int i = 0; i < 16; ++i) s = __dadd_rn(s, part[i][tid]);
    nrm[tid] = fmaxf(__double2float_rn(__dsqrt_rn(s)), 1e-12f);
    if (!teacher) nrm_s[c0 + tid] = nrm[tid];
  }
  __syncthreads();
  const float n[4] = {nrm[cq], nrm[cq + 1], nrm[cq + 2], nrm[cq + 3]};
  float gg[4] = {1.f, 1.f, 1.f, 1.f};
  if (use_g)
#pragma unroll
    for (int j = 0; j < 4; ++j) gg[j] = g[c0 + cq + j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float xv[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
    float u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u[j] = __fdiv_rn(xv[j], n[j]);
      if (use_g) u[j] = __fmul_rn(u[j], gg[j]);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(u[0], u[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(u[2], u[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(w + (size_t)(r0 + 16 * i) * k + c0 + cq) =
        packed;
  }
}

// ---------------------------------------------------------------------------
// (5) lse of a row from its tiles' (max, sum exp) (row-major partials, one
// warp): lanes take strided tiles, then a fixed butterfly.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float merge_row(const float* mr, const float* lr,
                                           int ntiles, int lane) {
  float m = -INFINITY;
  for (int i = lane; i < ntiles; i += 32) m = fmaxf(m, mr[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int i = lane; i < ntiles; i += 32)
    l = __fadd_rn(l, __fmul_rn(lr[i], expf(__fsub_rn(mr[i], m))));
  l = warp_sum(l);
  return m + logf(fmaxf(l, 1e-30f));
}

struct K7Merge {
  const float *mt_part, *lt_part, *ms_part, *ls_part;
  const float* colsum;     // (ceil(rt / 64), k)
  const float* center;
  const float* temp_t;
  float* tlq;              // (rt, k): tl in, q out
  float* lse_s;
  float* bc;
  int rs, rt, k, ntiles, s_blocks;
};

// Blocks [0, 8 rt): an eighth of teacher row b / 8: lse_t (each of the
// row's blocks merges it alike), then q = exp(ts - lse_t) over tl in place
// (ts = (tl - center) / temp_t as the statistics took it); the next
// s_blocks: 8 student rows each, lse_s; the rest: 256 columns each of the
// batch center, the halves' column sums in order over rt.
constexpr int Q_PARTS = 8;

__global__ void __launch_bounds__(256) merge_kernel(K7Merge a) {
  __shared__ float lse_sh;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  if (b < Q_PARTS * a.rt) {
    const int t = b / Q_PARTS, part = b % Q_PARTS;
    if (tid < 32) {
      const float lse = merge_row(a.mt_part + (size_t)t * a.ntiles,
                                  a.lt_part + (size_t)t * a.ntiles,
                                  a.ntiles, lane);
      if (lane == 0) lse_sh = lse;
    }
    __syncthreads();
    const float lse = lse_sh, inv_tt = __fdiv_rn(1.f, *a.temp_t);
    const int per = a.k / 4 / Q_PARTS;   // float4s a part
    float4* row = reinterpret_cast<float4*>(a.tlq + (size_t)t * a.k);
    for (int i = part * per + tid; i < (part + 1) * per; i += 256) {
      const float4 tl = row[i];
      const float* c = a.center + 4 * i;
      float4 q;
      q.x = expf(__fsub_rn(__fmul_rn(__fsub_rn(tl.x, c[0]), inv_tt), lse));
      q.y = expf(__fsub_rn(__fmul_rn(__fsub_rn(tl.y, c[1]), inv_tt), lse));
      q.z = expf(__fsub_rn(__fmul_rn(__fsub_rn(tl.z, c[2]), inv_tt), lse));
      q.w = expf(__fsub_rn(__fmul_rn(__fsub_rn(tl.w, c[3]), inv_tt), lse));
      row[i] = q;
    }
  } else if (b < Q_PARTS * a.rt + a.s_blocks) {
    const int r = (b - Q_PARTS * a.rt) * 8 + tid / 32;
    if (r >= a.rs) return;
    const float lse = merge_row(a.ms_part + (size_t)r * a.ntiles,
                                a.ls_part + (size_t)r * a.ntiles, a.ntiles,
                                lane);
    if (lane == 0) a.lse_s[r] = lse;
  } else {
    const int col = (b - Q_PARTS * a.rt - a.s_blocks) * 256 + tid;
    if (col >= a.k) return;
    float s = 0.f;
    for (int h = 0; h < (a.rt + 63) / 64; ++h)
      s = __fadd_rn(s, a.colsum[(size_t)h * a.k + col]);
    a.bc[col] = __fdiv_rn(s, (float)a.rt);
  }
}

// ---------------------------------------------------------------------------
// (8) dv = (du - u sum(u du)) / n and dg = sum(u dw) of 32 columns a block
// (a warp reads 128 bytes of a row), dw read from dvs and dv written over
// it; 8 row parts a column, each holding its DB / 8 rows of u and dw in
// registers, the parts' sums added in order.
// ---------------------------------------------------------------------------
constexpr int DV_COLS = 32;

template <int DB>
__global__ void __launch_bounds__(256)
    dv_kernel(const float* __restrict__ vs, const float* __restrict__ nrm,
              const float* __restrict__ gs, int use_g, int k,
              float* __restrict__ dvs, float* __restrict__ dgs) {
  constexpr int RP = DB / 8;
  __shared__ float sud_p[8][DV_COLS], sdg_p[8][DV_COLS], sud_all[DV_COLS];
  const int col_l = threadIdx.x % DV_COLS, part = threadIdx.x / DV_COLS;
  const int col = blockIdx.x * DV_COLS + col_l;
  const float n = nrm[col];
  const float gc = use_g ? gs[col] : 1.f;
  float u[RP], w[RP];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const size_t idx = (size_t)(part * RP + i) * k + col;
    u[i] = vs[idx];
    w[i] = dvs[idx];
  }
  float sud = 0.f, sdg = 0.f;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    u[i] = __fdiv_rn(u[i], n);
    if (use_g) {
      sdg = __fadd_rn(sdg, __fmul_rn(u[i], w[i]));
      sud = __fadd_rn(sud, __fmul_rn(u[i], __fmul_rn(w[i], gc)));
    } else {
      sud = __fadd_rn(sud, __fmul_rn(u[i], w[i]));
    }
  }
  sud_p[part][col_l] = sud;
  sdg_p[part][col_l] = sdg;
  __syncthreads();
  if (part == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < 8; ++i) {
      a = __fadd_rn(a, sud_p[i][col_l]);
      b = __fadd_rn(b, sdg_p[i][col_l]);
    }
    sud_all[col_l] = a;
    dgs[col] = use_g ? b : 0.f;
  }
  __syncthreads();
  const float s = sud_all[col_l];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const float du = use_g ? __fmul_rn(w[i], gc) : w[i];
    dvs[(size_t)(part * RP + i) * k + col] =
        __fdiv_rn(__fsub_rn(du, __fmul_rn(u[i], s)), n);
  }
}

// ---------------------------------------------------------------------------
// (11) loss = (sum of the partials + sum_r c_r lse_s_r) * inv_norm, each
// sum over 256 strided lanes then a fixed tree.
// ---------------------------------------------------------------------------
__global__ void loss_kernel(const float* __restrict__ loss_part, int nparts,
                            const float* __restrict__ c,
                            const float* __restrict__ lse_s, int rs,
                            float inv_norm, float* __restrict__ loss) {
  __shared__ float a[256], b[256];
  const int tid = threadIdx.x;
  float sa = 0.f, sb = 0.f;
  for (int i = tid; i < nparts; i += 256) sa = __fadd_rn(sa, loss_part[i]);
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

// The workspace, in floats, each piece 16-byte aligned: the bf16 weights
// and dl first, then the pair structure, the statistics' partials, tl / q,
// the loss partials and dh_s's split partials.  `off` keeps each piece's
// offset (the card tests read the intermediates through it).
struct K7Work {
  enum Piece { WS, WT, DL, NRM, PAIR_N, PAIR_T, PAIR_W, MS, LS, MT, LT,
               COLSUM, LSE_S, TLQ, LOSS, DH, PIECES };
  size_t off[PIECES];
  size_t total;   // floats
  int splits, kt_split;
  bf16 *ws, *wt, *dl;
  float *nrm, *pair_w, *ms, *ls, *mt, *lt, *colsum, *lse_s, *tlq, *loss_part,
      *dh_part;
  int *pair_n, *pair_t;

  K7Work(float* base, int rs, int rt, int db, int k) {
    const size_t nt = k7_tiles(k);
    splits = wgrad_splits(rs, db, k, &kt_split);
    const size_t size[PIECES] = {
        (size_t)db * k / 2, (size_t)db * k / 2, ((size_t)rs * k + 1) / 2,
        (size_t)k, (size_t)rs, (size_t)rs * rt, (size_t)rs * rt, rs * nt,
        rs * nt, rt * nt, rt * nt, (size_t)((rt + 63) / 64) * k,
        (size_t)rs, (size_t)rt * k, (size_t)((rs + 63) / 64) * nt,
        (size_t)splits * rs * db};
    total = 0;
    for (int i = 0; i < PIECES; ++i) {
      off[i] = total;
      total += (size[i] + 3) & ~(size_t)3;
    }
    auto at = [&](Piece i) {
      return base == nullptr ? nullptr : base + off[i];
    };
    ws = reinterpret_cast<bf16*>(at(WS));
    wt = reinterpret_cast<bf16*>(at(WT));
    dl = reinterpret_cast<bf16*>(at(DL));
    nrm = at(NRM);
    pair_n = reinterpret_cast<int*>(at(PAIR_N));
    pair_t = reinterpret_cast<int*>(at(PAIR_T));
    pair_w = at(PAIR_W);
    ms = at(MS);
    ls = at(LS);
    mt = at(MT);
    lt = at(LT);
    colsum = at(COLSUM);
    lse_s = at(LSE_S);
    tlq = at(TLQ);
    loss_part = at(LOSS);
    dh_part = at(DH);
  }
};

template <int DB>
cudaError_t k7_launch(const bf16* hs, const bf16* ht, const float* vs,
                      const float* vt, const float* gs, const float* gt,
                      const float* center, const float* temp_t,
                      const float* sel, const float* c, float* loss,
                      float* bc, float* dhs, float* dvs, float* dgs,
                      const K7Work& w, int rs, int rt, int k, int use_g,
                      float inv_ts, float dl_scale, float inv_norm,
                      cudaStream_t stream) {
  cudaError_t e;
  const int nt = k7_tiles(k);
  pair_index_kernel<<<(rs + 7) / 8, 256, 0, stream>>>(
      sel, rs, rt, w.pair_n, w.pair_t, w.pair_w);
  if ((e = cudaGetLastError())) return e;
  normalize_kernel<DB><<<dim3(k / 64, 2), 256, 0, stream>>>(
      vs, vt, gs, gt, use_g, k, w.ws, w.wt, w.nrm);
  if ((e = cudaGetLastError())) return e;

  sm90::GemmArgs teacher{};
  teacher.temp = temp_t;
  teacher.center = center;
  teacher.out32 = w.tlq;
  teacher.colsum = w.colsum;
  teacher.m_part = w.mt;
  teacher.l_part = w.lt;
  if ((e = gemm_sm90_k7<EPI_STATS>(ht, w.wt, nullptr, rt, k, DB, teacher,
                                   stream))) return e;
  sm90::GemmArgs student{};
  student.scale = inv_ts;
  student.m_part = w.ms;
  student.l_part = w.ls;
  if ((e = gemm_sm90_k7<EPI_STATS>(hs, w.ws, nullptr, rs, k, DB, student,
                                   stream))) return e;

  K7Merge m{w.mt, w.lt, w.ms, w.ls, w.colsum, center, temp_t, w.tlq,
            w.lse_s, bc, rs, rt, k, nt, (rs + 7) / 8};
  merge_kernel<<<Q_PARTS * rt + m.s_blocks + (k + 255) / 256, 256, 0,
                 stream>>>(m);
  if ((e = cudaGetLastError())) return e;

  sm90::GemmArgs dl{};
  dl.scale = inv_ts;
  dl.lse = w.lse_s;
  dl.c = c;
  dl.pair_n = w.pair_n;
  dl.pair_t = w.pair_t;
  dl.pair_w = w.pair_w;
  dl.pair_stride = rt;
  dl.q = w.tlq;
  dl.dl_scale = dl_scale;
  dl.loss_part = w.loss_part;
  if ((e = gemm_sm90_k7<EPI_DL>(hs, w.ws, w.dl, rs, k, DB, dl, stream)))
    return e;

  // dw = hs^T dl into dvs, then dv and dg over it
  if ((e = gemm_sm90<EPI_F32, true, false>(hs, w.dl, nullptr, dvs, DB, k, rs,
                                           stream))) return e;
  dv_kernel<DB><<<k / DV_COLS, 256, 0, stream>>>(vs, w.nrm, gs, use_g, k,
                                                dvs, dgs);
  if ((e = cudaGetLastError())) return e;

  // dh_s = dl ws^T, K = out_dim split, then the splits summed in order
  if ((e = gemm_sm90<EPI_F32, false, true>(w.dl, w.ws, nullptr, w.dh_part,
                                           rs, DB, k, stream, nullptr,
                                           nullptr, nullptr, nullptr,
                                           w.kt_split))) return e;
  PartSums sums{{{w.dh_part, dhs, rs * DB, w.splits}}, 1};
  if ((e = sum_parts(sums, stream))) return e;
  loss_kernel<<<1, 256, 0, stream>>>(w.loss_part, ((rs + 63) / 64) * nt, c,
                                     w.lse_s, rs, inv_norm, loss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of workspace dino_head_loss needs (int and bf16 arrays share the
// f32 slots).
size_t dino_head_loss_workspace(int rs, int rt, int db, int k) {
  return K7Work(nullptr, rs, rt, db, k).total;
}

// Float offsets in that workspace of the intermediates the card tests read
// (dino_head_loss.k7_intermediates): the student's and the teacher's
// per-(row, tile) max and sum exp, lse_s, q (over tl) and dl (bf16).
void dino_head_loss_offsets(int rs, int rt, int db, int k, size_t* out) {
  const K7Work w(nullptr, rs, rt, db, k);
  const K7Work::Piece pieces[7] = {K7Work::MS, K7Work::LS, K7Work::MT,
                                   K7Work::LT, K7Work::LSE_S, K7Work::TLQ,
                                   K7Work::DL};
  for (int i = 0; i < 7; ++i) out[i] = w.off[pieces[i]];
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
  const K7Work w(static_cast<float*>(workspace), rs, rt, db, k);
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (db == 128)
    return (int)k7_launch<128>(b(hs), b(ht), f(vs), f(vt), f(gs), f(gt),
                               f(center), f(temp_t), f(sel), f(c), o(loss),
                               o(bc), o(dhs), o(dvs), o(dgs), w, rs, rt, k,
                               use_g, inv_ts, dl_scale, inv_norm, stream);
  return (int)k7_launch<256>(b(hs), b(ht), f(vs), f(vt), f(gs), f(gt),
                             f(center), f(temp_t), f(sel), f(c), o(loss),
                             o(bc), o(dhs), o(dvs), o(dgs), w, rs, rt, k,
                             use_g, inv_ts, dl_scale, inv_norm, stream);
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
