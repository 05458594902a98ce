// K6: backward of the attention half of a pre-norm ViT block in bf16, for
// Hopper (sm_90a).
//
// Replaces sais_tpu/kernels/fused_mha.py::_attn_bwd_kernel and its tail
// _attn_bwd_tail (reached through _fused_block_bwd_attn), the backward
// through
//
//   x1 = x + [s1 *] proj(attn(qkv(LN1(x))))
//
// with the JAX kernel's rounding points:
//
//   y     = bf16(LN1(x)), qkv = bf16(y @ Wqkv) + bqkv      recomputed
//   dbr   = bf16(dx1 * s1)                                 (dx1 unscaled)
//   dctx  = bf16(dbr @ Wproj^T)
//   per (image, head): s = (q * dh^-0.5) k^T + mask, p = softmax_f32(s),
//     pb = bf16(p), ctx = bf16(pb v), dp = dctx v^T (f32),
//     ds = bf16(p (dp - rowsum(dp p))),
//     dq = bf16((ds k) dh^-0.5), dk = bf16((ds^T q) dh^-0.5), dv = bf16(pb^T dctx)
//   dqkv  = [dq heads | dk heads | dv heads]               as Wqkv's columns
//   dWproj = ctx^T dbr, dbproj = sum dbr, dWqkv = y^T dqkv, dbqkv = sum dqkv
//   dy    = dqkv @ Wqkv^T (f32), dln1_s = sum dy * xhat, dln1_b = sum dy
//   dx    = bf16(LN1_bwd(dy) + f32(dx1))
//
// What bounds it on an H100: 22 L D^2 + 12 L^2 D flops an image against
// ~0.6 MB of activations, so tensor-core operations (2.0 TFLOP a DINO step
// at batch 64).  As in K5, the weight gradients are products with K = B*L
// rows split into f32 partials, and the bias and LayerNorm gradients
// per-chunk partial column sums, all summed in a fixed order by the last
// launch: no atomics.
//
// One C entry point enqueues nine launches on the caller's stream (ten past
// 256 tokens, where (4) is two); the five products run on the wgmma + TMA
// GEMM of gemm_sm90.cuh (Wproj and Wqkv read as their transposes, ctx and
// y transposed for the weight gradients):
//
//   (1) bwd_prep_kernel          LN1(x) -> y, mean, 1/std; dbr; dbproj parts
//   (2) gemm_sm90 EPI_BIAS       y @ Wqkv + bqkv -> qkv
//   (3) gemm_sm90 EPI_NONE       dbr @ Wproj^T -> dctx
//   (4) attention_bwd_kernel     ctx, dqkv; dbqkv parts (per 16-row tile);
//       past 256 tokens attention_bwd_rows_sm90_kernel (ctx, dq, the
//       saved m, 1 / l, r, lse) then attention_bwd_cols_sm90_kernel (dk,
//       dv), key-tiled on wgmma + TMA
//   (5) gemm_sm90 A_MN, split K  ctx^T dbr -> dWproj parts
//   (6) gemm_sm90 A_MN, split K  y^T dqkv -> dWqkv parts
//   (7) gemm_sm90 EPI_F32        dqkv @ Wqkv^T -> dy (f32)
//   (8) ln_bwd_kernel            dx; dln1_b, dln1_s parts
//   (9) sum_parts_kernel         every gradient, parts in fixed order
//
// The attention backward (attention_bwd_kernel) takes, up to 256 tokens, one
// (image, head) a block: Q, K, V and dctx of the head (L <= 256 rows of 64)
// live in shared memory (at most 131 KB; swizzled, not padded, so that up to
// 208 rows two blocks share an SM).  p of a whole head is 256 x 256 f32 = 256
// KB, so it is never stored: phase A gives each warp 16-query tiles and walks
// the keys in 16-key chunks twice, first for each row's max, sum and rowsum(dp
// p) (per lane, online, merged over the quad), then for p, ds, ctx and dq in
// registers; phase B gives each warp 16-key tiles and walks the queries,
// computing s^T and dp^T directly from the saved row statistics, for dk and
// dv.  Every product is mma.sync m16n8k16; the score accumulators are
// re-packed to bf16 A fragments in registers.  Keys at or past valid_len score
// -1e30 (p exactly 0), tile padding -inf.  Each 16-row tile's bf16 dq, dk and
// dv are also summed over its rows (a shuffle tree over the fragment's row
// lanes) into one partial row of dbqkv.

#include "attention_sm90.cuh"

namespace {

constexpr int ATTB_WARPS = 8;
constexpr int ATTB_THREADS = 32 * ATTB_WARPS;

template <int KT>
constexpr size_t attention_bwd_smem() {
  return 4 * (size_t)(16 * KT) * DH * sizeof(bf16) +
         3 * (size_t)(16 * KT) * sizeof(float);
}

// Q, K, V and dctx of the head in shared memory: unpadded rows of DH = 64
// bf16 (128 bytes), the 16-byte chunk c of row r stored at chunk c ^ (r %
// 8), so that the 8 row addresses of an ldmatrix hit 8 different bank
// groups.  Without the padding, up to 208 rows (KT 13: 109 KB) leave room
// for two blocks an SM.
__device__ __forceinline__ bf16* swz(bf16* t, int row, int chunk) {
  return t + row * DH + ((chunk ^ (row & 7)) << 3);
}

// mma.sync fragments from a swizzled tile, at (row0, col0) with col0 a
// multiple of 8: the A fragment (16 x 16) of a row-major (m, k) tile, and
// the B fragments of two adjacent n8 tiles of an (n, k) or a (k, n) tile
// (as load_b_frags_nk and load_b_frags_kn in vit_block_common.cuh).
__device__ __forceinline__ void lda_sw(uint32_t* a, bf16* t, int row0,
                                       int col0, int lane) {
  ldmatrix_x4(a, swz(t, row0 + (lane & 15), (col0 >> 3) + (lane >> 4)));
}
__device__ __forceinline__ void ldb_nk_sw(uint32_t* b, bf16* t, int row0,
                                          int col0, int lane) {
  ldmatrix_x4(b, swz(t, row0 + (lane & 7) + ((lane >> 4) << 3),
                     (col0 >> 3) + ((lane >> 3) & 1)));
}
__device__ __forceinline__ void ldb_kn_sw(uint32_t* b, bf16* t, int row0,
                                          int col0, int lane) {
  ldmatrix_x4_trans(b, swz(t, row0 + (lane & 15), (col0 >> 3) + (lane >> 4)));
}

// Column sums of one 16-row tile's bf16 output fragment (rows g and g + 8
// of each n8 tile, where `ok0` / `ok1`) into part[0 .. DH): a shuffle tree
// over the row lanes, in a fixed order.
__device__ __forceinline__ void tile_colsum(float (*o)[4], float mul,
                                            bool ok0, bool ok1,
                                            float* part, int lane) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    float c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      c[e] = (ok0 ? bf16_round(o[nd][e] * mul) : 0.f) +
             (ok1 ? bf16_round(o[nd][2 + e] * mul) : 0.f);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 4);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 8);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 16);
    }
    if (lane < 4)
      *reinterpret_cast<float2*>(part + nd * 8 + 2 * lane) =
          make_float2(c[0], c[1]);
  }
}

// pack_bf16 of a 16 x 16 chunk's accumulators (two n8 tiles) as the A
// fragment of the next mma.
__device__ __forceinline__ void pack_a(uint32_t* a, const float (*v)[4]) {
  a[0] = pack_bf16(v[0][0], v[0][1]);
  a[1] = pack_bf16(v[0][2], v[0][3]);
  a[2] = pack_bf16(v[1][0], v[1][1]);
  a[3] = pack_bf16(v[1][2], v[1][3]);
}

// qkv: (B*L, 3D) [q heads | k heads | v heads]; dctx, ctx: (B*L, D);
// dqkv: (B*L, 3D) in qkv's layout; dqkv_part: (B * ceil(L / 16), 3D), the
// column sums of each image's 16-row tiles of dqkv.
// Up to 208 rows (KT <= 13, at most 109 KB of shared memory) two blocks
// share an SM, which caps a thread at 128 registers.
template <int KT>
__global__ void __launch_bounds__(ATTB_THREADS, KT <= 13 ? 2 : 1)
    attention_bwd_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ dctx,
                         bf16* __restrict__ ctx, bf16* __restrict__ dqkv,
                         float* __restrict__ dqkv_part, int L, int D,
                         int valid_len) {
  constexpr int LK = 16 * KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // (LK, DH) each, swizzled
  bf16* Ks = Qs + LK * DH;
  bf16* Vs = Ks + LK * DH;
  bf16* Cs = Vs + LK * DH;                         // dctx of the head
  float* row_m = reinterpret_cast<float*>(Cs + LK * DH);
  float* row_l = row_m + LK;
  float* row_d = row_l + LK;

  const int b = blockIdx.y, h = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qkv_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * qkv_stride + h * DH;
  const bf16* dbase = dctx + (size_t)b * L * D + h * DH;
  const float scale = 0.125f;   // DH ** -0.5, a power of two

  // rows past L are zero-filled
  for (int i = tid; i < LK * (DH / 8); i += ATTB_THREADS) {
    const int j = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bool ok = j < L;
    const bf16* src = base + (size_t)(ok ? j : 0) * qkv_stride + c;
    cp_async16(swz(Qs, j, c / 8), src, ok);
    cp_async16(swz(Ks, j, c / 8), src + D, ok);
    cp_async16(swz(Vs, j, c / 8), src + 2 * D, ok);
    cp_async16(swz(Cs, j, c / 8), dbase + (size_t)(ok ? j : 0) * D + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase A: query rows; dq and ctx --------------------------------
  for (int qt = warp; qt < (L + 15) / 16; qt += ATTB_WARPS) {
    const int q0 = qt * 16;
    uint32_t qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
    for (int kq = 0; kq < DH / 16; ++kq) {
      lda_sw(qa[kq], Qs, q0, kq * 16, lane);
      lda_sw(da[kq], Cs, q0, kq * 16, lane);
    }
    // s and dp of key chunk kt (16 keys): [n8 tile][4] accumulators, rows
    // g (elements 0, 1) and g + 8 (2, 3), keys 16 kt + 8 j + 2 t + e.
    auto scores = [&](int kt, float (*s)[4], float (*dp)[4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
            dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        uint32_t kb[4], vb[4];
        ldb_nk_sw(kb, Ks, kt * 16, kq * 16, lane);
        ldb_nk_sw(vb, Vs, kt * 16, kq * 16, lane);
        mma_bf16_16816(s[0], qa[kq], kb[0], kb[1]);
        mma_bf16_16816(s[1], qa[kq], kb[2], kb[3]);
        mma_bf16_16816(dp[0], da[kq], vb[0], vb[1]);
        mma_bf16_16816(dp[1], da[kq], vb[2], vb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kt * 16 + j * 8 + 2 * t + e;
          const float add = col >= valid_len ? kNegInf : 0.f;
          s[j][e] = col >= L ? -INFINITY : s[j][e] * scale + add;
          s[j][2 + e] = col >= L ? -INFINITY : s[j][2 + e] * scale + add;
        }
    };

    // pass 1: per lane, online over chunks: max m, sum l of exp(s - m) and
    // d = sum dp exp(s - m); then merged over the 4 lanes of the quad
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4], dp[2][4];
      scores(kt, s, dp);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        if (mx == -INFINITY) continue;   // no key of this lane yet
        const float alpha = m[r] == -INFINITY ? 0.f : __expf(m[r] - mx);
        l[r] *= alpha;
        d[r] *= alpha;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = s[j][2 * r + e];
            const float pe = v == -INFINITY ? 0.f : expf(v - mx);
            l[r] += pe;
            d[r] += pe * dp[j][2 * r + e];
          }
        m[r] = mx;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mq = m[r];
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      const float a = m[r] == -INFINITY ? 0.f : expf(m[r] - mq);
      float lq = l[r] * a, dq = d[r] * a;
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      dq += __shfl_xor_sync(0xffffffffu, dq, 1);
      dq += __shfl_xor_sync(0xffffffffu, dq, 2);
      m[r] = mq;
      l[r] = lq;
      d[r] = dq / lq;   // rowsum(dp * p)
    }
    if (t == 0) {
      row_m[q0 + g] = m[0];
      row_l[q0 + g] = l[0];
      row_d[q0 + g] = d[0];
      row_m[q0 + g + 8] = m[1];
      row_l[q0 + g + 8] = l[1];
      row_d[q0 + g + 8] = d[1];
    }

    // pass 2: p, ds; ctx += pb v, dq += ds k
    float oc[DH / 8][4], oq[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      oc[nd][0] = oc[nd][1] = oc[nd][2] = oc[nd][3] = oq[nd][0] = oq[nd][1] =
          oq[nd][2] = oq[nd][3] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      float s[2][4], dp[2][4];
      scores(kt, s, dp);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[r]) / l[r];
          ds[j][e] = p[j][e] * (dp[j][e] - d[r]);
        }
      uint32_t pa[4], sa[4];
      pack_a(pa, p);
      pack_a(sa, ds);
#pragma unroll
      for (int nd = 0; nd < DH / 8; nd += 2) {
        uint32_t vb[4], kb[4];
        ldb_kn_sw(vb, Vs, kt * 16, nd * 8, lane);
        ldb_kn_sw(kb, Ks, kt * 16, nd * 8, lane);
        mma_bf16_16816(oc[nd], pa, vb[0], vb[1]);
        mma_bf16_16816(oc[nd + 1], pa, vb[2], vb[3]);
        mma_bf16_16816(oq[nd], sa, kb[0], kb[1]);
        mma_bf16_16816(oq[nd + 1], sa, kb[2], kb[3]);
      }
    }
    const int r0 = q0 + g, r1 = q0 + g + 8;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (r0 < L) {
        const size_t row = (size_t)b * L + r0;
        *reinterpret_cast<__nv_bfloat162*>(ctx + row * D + h * DH + col) =
            __floats2bfloat162_rn(oc[nd][0], oc[nd][1]);
        *reinterpret_cast<__nv_bfloat162*>(dqkv + row * 3 * D + h * DH +
                                           col) =
            __floats2bfloat162_rn(oq[nd][0] * scale, oq[nd][1] * scale);
      }
      if (r1 < L) {
        const size_t row = (size_t)b * L + r1;
        *reinterpret_cast<__nv_bfloat162*>(ctx + row * D + h * DH + col) =
            __floats2bfloat162_rn(oc[nd][2], oc[nd][3]);
        *reinterpret_cast<__nv_bfloat162*>(dqkv + row * 3 * D + h * DH +
                                           col) =
            __floats2bfloat162_rn(oq[nd][2] * scale, oq[nd][3] * scale);
      }
    }
    tile_colsum(oq, scale, r0 < L, r1 < L,
                dqkv_part + ((size_t)b * KT + qt) * 3 * D + h * DH, lane);
  }
  __syncthreads();   // every query row's m, l and rowsum(dp p) are saved

  // ---- phase B: key rows; dk and dv -----------------------------------
  for (int kt = warp; kt < (L + 15) / 16; kt += ATTB_WARPS) {
    const int k0 = kt * 16;
    uint32_t ka[DH / 16][4], va[DH / 16][4];
#pragma unroll
    for (int kq = 0; kq < DH / 16; ++kq) {
      lda_sw(ka[kq], Ks, k0, kq * 16, lane);
      lda_sw(va[kq], Vs, k0, kq * 16, lane);
    }
    // rows of this lane: keys k0 + g and k0 + g + 8
    const float add0 = k0 + g >= valid_len ? kNegInf : 0.f;
    const float add1 = k0 + g + 8 >= valid_len ? kNegInf : 0.f;
    const bool key0 = k0 + g < L, key1 = k0 + g + 8 < L;
    float ok_[DH / 8][4], ov[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      ok_[nd][0] = ok_[nd][1] = ok_[nd][2] = ok_[nd][3] = ov[nd][0] =
          ov[nd][1] = ov[nd][2] = ov[nd][3] = 0.f;
    for (int qc = 0; qc < KT; ++qc) {
      // s^T = K Q^T and dp^T = V dctx^T for 16 keys x 16 queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = dpt[j][0] = dpt[j][1] =
            dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        uint32_t qb[4], cb[4];
        ldb_nk_sw(qb, Qs, qc * 16, kq * 16, lane);
        ldb_nk_sw(cb, Cs, qc * 16, kq * 16, lane);
        mma_bf16_16816(st[0], ka[kq], qb[0], qb[1]);
        mma_bf16_16816(st[1], ka[kq], qb[2], qb[3]);
        mma_bf16_16816(dpt[0], va[kq], cb[0], cb[1]);
        mma_bf16_16816(dpt[1], va[kq], cb[2], cb[3]);
      }
      float p[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = qc * 16 + j * 8 + 2 * t + (e & 1);
          const bool key_ok = (e >> 1) ? key1 : key0;
          const float add = (e >> 1) ? add1 : add0;
          float pe = 0.f, de = 0.f;
          if (q < L && key_ok) {
            pe = expf(st[j][e] * scale + add - row_m[q]) / row_l[q];
            de = pe * (dpt[j][e] - row_d[q]);
          }
          p[j][e] = pe;
          ds[j][e] = de;
        }
      uint32_t pa[4], sa[4];
      pack_a(pa, p);
      pack_a(sa, ds);
#pragma unroll
      for (int nd = 0; nd < DH / 8; nd += 2) {
        uint32_t cb[4], qb[4];
        ldb_kn_sw(cb, Cs, qc * 16, nd * 8, lane);
        ldb_kn_sw(qb, Qs, qc * 16, nd * 8, lane);
        mma_bf16_16816(ov[nd], pa, cb[0], cb[1]);
        mma_bf16_16816(ov[nd + 1], pa, cb[2], cb[3]);
        mma_bf16_16816(ok_[nd], sa, qb[0], qb[1]);
        mma_bf16_16816(ok_[nd + 1], sa, qb[2], qb[3]);
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (key0) {
        bf16* out = dqkv + ((size_t)b * L + k0 + g) * 3 * D + h * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(out + D) =
            __floats2bfloat162_rn(ok_[nd][0] * scale, ok_[nd][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(out + 2 * D) =
            __floats2bfloat162_rn(ov[nd][0], ov[nd][1]);
      }
      if (key1) {
        bf16* out = dqkv + ((size_t)b * L + k0 + g + 8) * 3 * D + h * DH + col;
        *reinterpret_cast<__nv_bfloat162*>(out + D) =
            __floats2bfloat162_rn(ok_[nd][2] * scale, ok_[nd][3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(out + 2 * D) =
            __floats2bfloat162_rn(ov[nd][2], ov[nd][3]);
      }
    }
    float* part = dqkv_part + ((size_t)b * KT + kt) * 3 * D + h * DH;
    tile_colsum(ok_, scale, key0, key1, part + D, lane);
    tile_colsum(ov, 1.f, key0, key1, part + 2 * D, lane);
  }
}

template <int KT>
cudaError_t launch_attention_bwd(const bf16* qkv, const bf16* dctx, bf16* ctx,
                                 bf16* dqkv, float* dqkv_part, int B, int L,
                                 int D, int heads, int valid_len,
                                 cudaStream_t stream) {
  constexpr size_t smem = attention_bwd_smem<KT>();
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  // all of the SM's unified memory as shared memory: room for two blocks
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_bwd_kernel<KT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  dim3 grid(heads, B);
  attention_bwd_kernel<KT><<<grid, ATTB_THREADS, smem, stream>>>(
      qkv, dctx, ctx, dqkv, dqkv_part, L, D, valid_len);
  return cudaGetLastError();
}

cudaError_t attention_bwd(const bf16* qkv, const bf16* dctx, bf16* ctx,
                          bf16* dqkv, float* dqkv_part, int B, int L, int D,
                          int heads, int valid_len, cudaStream_t stream) {
  switch ((L + 15) / 16) {
#define SAIS_ATTB_CASE(kt)                                                   \
  case kt:                                                                   \
    return launch_attention_bwd<kt>(qkv, dctx, ctx, dqkv, dqkv_part, B, L,  \
                                    D, heads, valid_len, stream);
    SAIS_ATTB_CASE(1) SAIS_ATTB_CASE(2) SAIS_ATTB_CASE(3) SAIS_ATTB_CASE(4)
    SAIS_ATTB_CASE(5) SAIS_ATTB_CASE(6) SAIS_ATTB_CASE(7) SAIS_ATTB_CASE(8)
    SAIS_ATTB_CASE(9) SAIS_ATTB_CASE(10) SAIS_ATTB_CASE(11) SAIS_ATTB_CASE(12)
    SAIS_ATTB_CASE(13) SAIS_ATTB_CASE(14) SAIS_ATTB_CASE(15) SAIS_ATTB_CASE(16)
#undef SAIS_ATTB_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The key-tiled attention backward past 256 tokens (patch-8 ViTs: 785
// tokens), where a head's Q, K, V and dctx (402 KB at 785 rows) no longer
// fit a block's shared memory.  Two launches on wgmma + TMA, built like the
// forward of attention_sm90.cuh: a persistent grid; a block is two
// consumer warpgroups of 64 rows of one (image, head) each and a producer
// warp that streams 64 x 64 bf16 tiles with the 128-byte swizzle through
// 3-D tensor maps, zeros past L, into a ring of STAGES stages with full and
// empty mbarriers; every product an m64n64k16 wgmma with no operand copied
// or transposed:
//
// - attention_bwd_rows_sm90_kernel, per 64 queries (Q and dctx loaded once
//   into a double buffer), sweeps the K and V tiles twice.  Sweep 1: S = Q
//   K^T and dP = dctx V^T (SS), each lane's running max m, sum l of exp(s
//   - m) and d = sum exp(s - m) dp, merged over the quad into m, l and r =
//   d / l = rowsum(dp p) (summed from the f32 p, as the JAX kernel does,
//   not FlashAttention's rowsum(dO O)), saved to stats (B, H, L, 4) as (m,
//   1 / l, r, lse = m + log2 l): a row is the 16 bytes of a TMA box.
//   Sweep 2: S and dP again, p = exp(s - m) / l and ds = p (dp - r) in
//   registers, then ctx += bf16(p) V and dq += bf16(ds) K as RS wgmmas (V
//   and K read MN-major).
// - attention_bwd_cols_sm90_kernel, per 64 keys (K and V loaded once as
//   the A operands), sweeps the Q, dctx and saved-statistics tiles once:
//   S^T = K Q^T and dP^T = V dctx^T (SS), p = exp2(t - lse) and ds = p (dp
//   - r) from the saved (r, lse), then dv += bf16(p)^T dctx and dk +=
//   bf16(ds)^T Q (RS, dctx and Q read MN-major).
//
// A block of 288 threads holds 168 registers a thread: s, dp and the two
// 64 x 64 output accumulators take 128 of them, so a consumer waits for
// each group of products before it issues the next (a second tile's s and
// dp, or the next tile's products in flight beside the bf16 fragments of
// this one, would spill); the two consumers' products and exponentials
// interleave on the SM instead.  p and ds are rounded to bf16 fragments as
// they are formed, so the f32 values die as they are used.
//
// Both keep the register kernel's rounding points, the log2 domain of the
// forward (ex2.approx, p times 1 / l) and its 16-row dbqkv partials: warp
// w of a consumer holds rows 16w .. 16w + 15 of the m64 accumulator, whose
// layout is the mma.sync fragment's, so each 16-row tile's columns are
// summed by the one warp that owns it; nothing is accumulated across
// blocks, so two runs agree to the bit.  They execute 12 L^2 Dh (rows: s
// and dp twice, ctx, dq) + 8 L^2 Dh (columns: s^T, dp^T, dv, dk) flops a
// head against the 12 L^2 Dh the function needs, and 3 L^2 ex2.
// ---------------------------------------------------------------------------
constexpr int KATT_STATS = katt::ROWS * 16;   // a tile's (m, 1 / l, r, 0)
constexpr int KATT_COLS_STAGE = 2 * katt::TILE + KATT_STATS;
constexpr int KATT_ROWS_SMEM =
    4 * katt::BWD_CONS * katt::TILE + katt::STAGES * 2 * katt::TILE + 1024;
constexpr int KATT_COLS_SMEM =
    4 * katt::BWD_CONS * katt::TILE + katt::STAGES * KATT_COLS_STAGE + 1024;
static_assert(KATT_COLS_STAGE % 1024 == 0,
              "stages keep the swizzle's alignment");

// tile_colsum of a wgmma accumulator (its register 4 nd + i is element i
// of the mma.sync fragment's n8 tile nd).
__device__ __forceinline__ void acc_colsum(const float (&o)[32], float mul,
                                           bool ok0, bool ok1, float* part,
                                           int lane) {
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    float c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      c[e] = (ok0 ? bf16_round(o[4 * nd + e] * mul) : 0.f) +
             (ok1 ? bf16_round(o[4 * nd + 2 + e] * mul) : 0.f);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 4);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 8);
      c[e] += __shfl_xor_sync(0xffffffffu, c[e], 16);
    }
    if (lane < 4)
      *reinterpret_cast<float2*>(part + nd * 8 + 2 * lane) =
          make_float2(c[0], c[1]);
  }
}

// Rows row0 + {g, g + 8} (where below L) of a 64 x 64 accumulator times
// mul into the bf16 matrix at out (row stride ld), columns 8j + 2 (t % 4).
__device__ __forceinline__ void store_rows(const float (&o)[32], float mul,
                                           bf16* out, size_t ld, int row0,
                                           int L, int g, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= L) continue;
    bf16* dst = out + (size_t)row * ld + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * mul, o[4 * j + 2 * h + 1] * mul);
  }
}

// qkv: (B*L, 3D) (map_qkv), dctx: (B*L, D) (map_dctx), both 3-D maps;
// ctx: (B*L, D); dqkv: (B*L, 3D), the dq columns written here;
// dqkv_part: (B * ceil(L / 16), 3D); stats: (B, H, L) float4.
__global__ void __launch_bounds__(katt::threads(katt::BWD_CONS), 1)
    attention_bwd_rows_sm90_kernel(
        const __grid_constant__ CUtensorMap map_qkv,
        const __grid_constant__ CUtensorMap map_dctx,
        bf16* __restrict__ ctx, bf16* __restrict__ dqkv,
        float* __restrict__ dqkv_part, float4* __restrict__ stats, int B,
        int L, int D, int heads, int valid_len) {
  using namespace katt;
  constexpr int CONS = BWD_CONS;
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 4];
  extern __shared__ __align__(1024) unsigned char katt_smem[];
  const uint32_t base = (smem_u32(katt_smem) + 1023) & ~1023u;
  const uint32_t hbuf = base;                       // [2][CONS] Q, dctx
  const uint32_t kv = base + 4 * CONS * TILE;       // [STAGES] K, V
  const Ring<STAGES> ring(bars);
  const Ring<2> hring(bars + 2 * STAGES);
  const int nt = (L + ROWS - 1) / ROWS;
  const int pairs = (nt + CONS - 1) / CONS;
  const int units = B * heads * pairs;
  if (threadIdx.x == 0) {
    ring.init(CONS);
    hring.init(CONS);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // the producer warp: a unit's Q and dctx tiles, then its K and V tiles
  // twice
  if (threadIdx.x >= 128 * CONS) {
    if (threadIdx.x != 128 * CONS) return;
    produce(
        ring, hring, 2 * nt, units,
        [&](int k, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          mbar_expect_tx(bar, CONS * 2 * TILE);
          for (int c = 0; c < CONS; ++c) {
            const uint32_t dst = hbuf + ((k & 1) * CONS + c) * 2 * TILE;
            const int row = (w.pair * CONS + c) * ROWS;
            tma_load_3d(dst, &map_qkv, w.h * DH, row, w.b, bar);
            tma_load_3d(dst + TILE, &map_dctx, w.h * DH, row, w.b, bar);
          }
        },
        [&](int k, int i, int n, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          const uint32_t st = kv + (n % STAGES) * 2 * TILE;
          const int k0 = (i % nt) * ROWS;
          mbar_expect_tx(bar, 2 * TILE);
          tma_load_3d(st, &map_qkv, D + w.h * DH, k0, w.b, bar);
          tma_load_3d(st + TILE, &map_qkv, 2 * D + w.h * DH, k0, w.b, bar);
        });
    return;
  }
  auto ktile = [&](int n) { return kv + (n % STAGES) * 2 * TILE; };

  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const float scale = 0.125f;   // DH ** -0.5, a power of two
  int use = 0, it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it, use += 2 * nt) {
    const Unit w(u, pairs, heads);
    const int q0 = (w.pair * CONS + c) * ROWS;
    hring.wait(it);
    if (q0 >= L) {   // no tile of this consumer in the unit: keep pace
      for (int i = 0; i < 2 * nt; ++i) {
        ring.wait(use + i);
        if (lane == 0) ring.release(use + i);
      }
      if (lane == 0) hring.release(it);
      continue;
    }
    const uint32_t qt = hbuf + ((it & 1) * CONS + c) * 2 * TILE;
    // S = Q K^T and dP = dctx V^T of ring use n, one commit group
    auto issue_sdp = [&](float(&s)[32], float(&dp)[32], int n) {
      product_ss(s, qt, ktile(n));
      product_ss(dp, qt + TILE, ktile(n) + TILE);
      sm90::wgmma_commit();
    };

    // sweep 1: per lane m, l, d; merged, saved
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
    float s[32], dp[32];
    for (int j = 0; j < nt; ++j) {
      ring.wait(use + j);
      sm90::wgmma_fence();
      issue_sdp(s, dp, use + j);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      if (lane == 0) ring.release(use + j);
      log2_scores(s, j * ROWS, tq, (j + 1) * ROWS <= valid_len, L,
                  valid_len);
      lane_stats<true>(s, dp, m, l, d);
    }
    quad_merge(m, l, d);
    float4* st = stats + ((size_t)w.b * heads + w.h) * L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lse = m[h] + log2f(l[h]);   // log2 domain
      d[h] = d[h] / l[h];   // r = rowsum(dp p)
      l[h] = 1.f / l[h];
      const int row = q0 + 16 * warp + g + 8 * h;
      if (tq == 0 && row < L) st[row] = make_float4(m[h], l[h], d[h], lse);
    }

    // sweep 2: p = exp(s - m) / l and ds = p (dp - r), then ctx += pb v and
    // dq += ds k
    const int u2 = use + nt;
    float oc[32], oq[32];
    zero(oc);
    zero(oq);
    for (int j = 0; j < nt; ++j) {
      ring.wait(u2 + j);
      sm90::wgmma_fence();
      issue_sdp(s, dp, u2 + j);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      log2_scores(s, j * ROWS, tq, (j + 1) * ROWS <= valid_len, L,
                  valid_len);
      // p and ds, rounded to bf16 pairs in the A fragments' layout as they
      // are formed
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pe[2], de[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * h + e;
            pe[e] = ex2(s[i] - m[h]) * l[h];
            de[e] = pe[e] * (dp[i] - d[h]);
          }
          pa[jj / 2][2 * (jj % 2) + h] = pack_bf16(pe[0], pe[1]);
          da[jj / 2][2 * (jj % 2) + h] = pack_bf16(de[0], de[1]);
        }
      sm90::wgmma_fence();
      product_rs(oc, pa, ktile(u2 + j) + TILE);
      product_rs(oq, da, ktile(u2 + j));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(oc);
      sm90::fence_acc(oq);
      if (lane == 0) ring.release(u2 + j);
    }
    if (lane == 0) hring.release(it);

    const int r0 = q0 + 16 * warp;
    const size_t row0 = (size_t)w.b * L;
    store_rows(oc, 1.f, ctx + row0 * D + w.h * DH, D, r0, L, g, tq);
    store_rows(oq, scale, dqkv + row0 * 3 * D + w.h * DH, 3 * D, r0, L, g,
               tq);
    if (r0 < L)
      acc_colsum(oq, scale, r0 + g < L, r0 + g + 8 < L,
                 dqkv_part + ((size_t)w.b * ((L + 15) / 16) + r0 / 16) * 3 *
                     D + w.h * DH,
                 lane);
  }
}

// map_stats: the rows pass's stats as (4, L, B*H) f32; dqkv: the dk and
// dv columns written here.
__global__ void __launch_bounds__(katt::threads(katt::BWD_CONS), 1)
    attention_bwd_cols_sm90_kernel(
        const __grid_constant__ CUtensorMap map_qkv,
        const __grid_constant__ CUtensorMap map_dctx,
        const __grid_constant__ CUtensorMap map_stats,
        bf16* __restrict__ dqkv, float* __restrict__ dqkv_part, int B, int L,
        int D, int heads, int valid_len) {
  using namespace katt;
  constexpr int CONS = BWD_CONS;
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 4];
  extern __shared__ __align__(1024) unsigned char katt_smem[];
  const uint32_t base = (smem_u32(katt_smem) + 1023) & ~1023u;
  const uint32_t hbuf = base;                       // [2][CONS] K, V
  const uint32_t qd = base + 4 * CONS * TILE;       // [STAGES] Q, dctx, stats
  const Ring<STAGES> ring(bars);
  const Ring<2> hring(bars + 2 * STAGES);
  const int nt = (L + ROWS - 1) / ROWS;
  const int pairs = (nt + CONS - 1) / CONS;
  const int units = B * heads * pairs;
  if (threadIdx.x == 0) {
    ring.init(CONS);
    hring.init(CONS);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // the producer warp: a unit's K and V tiles, then its Q, dctx and stats
  // tiles
  if (threadIdx.x >= 128 * CONS) {
    if (threadIdx.x != 128 * CONS) return;
    produce(
        ring, hring, nt, units,
        [&](int k, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          mbar_expect_tx(bar, CONS * 2 * TILE);
          for (int c = 0; c < CONS; ++c) {
            const uint32_t dst = hbuf + ((k & 1) * CONS + c) * 2 * TILE;
            const int row = (w.pair * CONS + c) * ROWS;
            tma_load_3d(dst, &map_qkv, D + w.h * DH, row, w.b, bar);
            tma_load_3d(dst + TILE, &map_qkv, 2 * D + w.h * DH, row, w.b,
                        bar);
          }
        },
        [&](int k, int i, int n, uint32_t bar) {
          const Unit w(blockIdx.x + k * gridDim.x, pairs, heads);
          const uint32_t st = qd + (n % STAGES) * KATT_COLS_STAGE;
          mbar_expect_tx(bar, KATT_COLS_STAGE);
          tma_load_3d(st, &map_qkv, w.h * DH, i * ROWS, w.b, bar);
          tma_load_3d(st + TILE, &map_dctx, w.h * DH, i * ROWS, w.b, bar);
          tma_load_3d(st + 2 * TILE, &map_stats, 0, i * ROWS,
                      w.b * heads + w.h, bar);
        });
    return;
  }
  auto qtile = [&](int n) { return qd + (n % STAGES) * KATT_COLS_STAGE; };

  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const float scale = 0.125f;
  int use = 0, it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it, use += nt) {
    const int k0 = ((u % pairs) * CONS + c) * ROWS;
    hring.wait(it);
    if (k0 >= L) {   // no tile of this consumer in the unit: keep pace
      for (int i = 0; i < nt; ++i) {
        ring.wait(use + i);
        if (lane == 0) ring.release(use + i);
      }
      if (lane == 0) hring.release(it);
      continue;
    }
    const uint32_t kt = hbuf + ((it & 1) * CONS + c) * 2 * TILE;
    const int r0 = k0 + 16 * warp;   // this warp's keys
    // s^T = K Q^T and dp^T = V dctx^T of ring use n, one commit group
    float s[32], dp[32], dk[32], dv[32];
    uint32_t pa[4][4], da[4][4];
    auto issue_sdp = [&](int n) {
      product_ss(s, kt, qtile(n));
      product_ss(dp, kt + TILE, qtile(n) + TILE);
      sm90::wgmma_commit();
    };
    // p = exp2(t - lse) and ds = p (dp - r) of ring use n from its saved
    // (r, lse) (lse = m + log2 l: the normalised p of the rows pass up to
    // f32 rounding of the exponent), rounded to bf16 pairs in the A
    // fragments' layout as they are formed.  Columns past L need no mask:
    // their Q, dctx and statistics rows arrive as zeros, so ds = p (0 - 0)
    // = 0 there and p multiplies a zero dctx row.
    auto probs = [&](int n) {
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      // (r, lse) of query column q at sv + 16 q
      const uint32_t sv = qtile(n) + 2 * TILE + 8;
      // the mask added to the scores of this thread's keys r0 + g, r0 + g
      // + 8: -inf past L (p = 0 there)
      float kadd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = r0 + g + 8 * h;
        kadd[h] = key >= L ? -INFINITY : key >= valid_len ? kNegInf : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float2 v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                       : "=f"(v[e].x), "=f"(v[e].y)
                       : "r"(sv + 16 * (8 * jj + 2 * tq + e)));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pe[2], de[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * h + e;
            pe[e] = ex2(s[i] * kScaleLog2 + kadd[h] - v[e].y);
            de[e] = pe[e] * (dp[i] - v[e].x);
          }
          pa[jj / 2][2 * (jj % 2) + h] = pack_bf16(pe[0], pe[1]);
          da[jj / 2][2 * (jj % 2) + h] = pack_bf16(de[0], de[1]);
        }
      }
    };
    zero(dk);
    zero(dv);
    for (int j = 0; j < nt; ++j) {
      const int n = use + j;
      ring.wait(n);
      sm90::wgmma_fence();
      issue_sdp(n);
      sm90::wgmma_wait<0>();
      probs(n);
      sm90::wgmma_fence();
      product_rs(dv, pa, qtile(n) + TILE);   // dv += pb^T dctx
      product_rs(dk, da, qtile(n));          // dk += ds^T q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      if (lane == 0) ring.release(n);
    }
    if (lane == 0) hring.release(it);

    const Unit wo(u, pairs, heads);   // recomputed: fewer live registers
    bf16* out = dqkv + (size_t)wo.b * L * 3 * D + wo.h * DH;
    store_rows(dk, scale, out + D, 3 * D, r0, L, g, tq);
    store_rows(dv, 1.f, out + 2 * D, 3 * D, r0, L, g, tq);
    if (r0 < L) {
      float* part = dqkv_part +
                    ((size_t)wo.b * ((L + 15) / 16) + r0 / 16) * 3 * D +
                    wo.h * DH;
      acc_colsum(dk, scale, r0 + g < L, r0 + g + 8 < L, part + D, lane);
      acc_colsum(dv, 1.f, r0 + g < L, r0 + g + 8 < L, part + 2 * D, lane);
    }
  }
}

cudaError_t long_attention_bwd(const bf16* qkv, const bf16* dctx, bf16* ctx,
                               bf16* dqkv, float* dqkv_part, float* stats,
                               int B, int L, int D, int heads, int valid_len,
                               cudaStream_t stream) {
  CUtensorMap map_qkv, map_dctx, map_stats;
  if (!katt::make_rows_map(&map_qkv, qkv, 3 * D, L, B) ||
      !katt::make_rows_map(&map_dctx, dctx, D, L, B) ||
      !sm90::aligned16({stats}) ||
      !katt::make_map_3d(&map_stats, stats, true, 4, L, B * heads, 16,
                         (size_t)L * 16, 4))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_rows_sm90_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, KATT_ROWS_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_bwd_cols_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KATT_COLS_SMEM);
  if (e != cudaSuccess) return e;
  const int pairs = ((L + katt::ROWS - 1) / katt::ROWS + katt::BWD_CONS -
                     1) / katt::BWD_CONS;
  const int grid = katt::persistent_grid(B * heads * pairs);
  if (grid < 1) return cudaErrorInvalidValue;
  constexpr int threads = katt::threads(katt::BWD_CONS);
  attention_bwd_rows_sm90_kernel<<<grid, threads, KATT_ROWS_SMEM, stream>>>(
      map_qkv, map_dctx, ctx, dqkv, dqkv_part,
      reinterpret_cast<float4*>(stats), B, L, D, heads, valid_len);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attention_bwd_cols_sm90_kernel<<<grid, threads, KATT_COLS_SMEM, stream>>>(
      map_qkv, map_dctx, map_stats, dqkv, dqkv_part, B, L, D, heads,
      valid_len);
  return cudaGetLastError();
}

// The workspace: each gradient's partials, in floats, in the order the
// final sum reads them.
struct AttnParts {
  size_t dbqkv, dbproj, dln_b, dln_s, dwproj, dwqkv, stats, total;
  AttnParts(int batch, int seq, int dim) {
    const int rows = batch * seq;
    const size_t chunks = row_chunks(rows);
    dbqkv = 0;
    dbproj = dbqkv + (size_t)batch * ((seq + 15) / 16) * 3 * dim;
    dln_b = dbproj + chunks * dim;
    dln_s = dln_b + chunks * dim;
    dwproj = dln_s + chunks * dim;
    dwqkv = dwproj + wgrad_partials(dim, dim, rows);
    stats = dwqkv + wgrad_partials(dim, 3 * dim, rows);
    // past 256 tokens the key-tiled backward's saved (m, 1 / l, r, 0),
    // (B, H, L, 4)
    total = stats + (seq > SHORT_ATT_LEN
                         ? (size_t)batch * (dim / DH) * seq * 4 : 0);
  }
};

}  // namespace

extern "C" {

// f32 elements of the workspace fused_block_bwd_attn needs.
size_t fused_block_bwd_attn_workspace(int batch, int seq, int dim) {
  return AttnParts(batch, seq, dim).total;
}

// x, dx1: (B*L, dim) bf16; s1: (B*L,) bf16 or null; weights bf16 in the
// JAX layout (qkv_w (dim, 3 dim), proj_w (dim, dim)).  Outputs: dx (B*L,
// dim) bf16; dqkv_w (dim, 3 dim), dqkv_b (3 dim), dproj_w (dim, dim),
// dproj_b, dln1_s, dln1_b (dim) f32.  Scratch: buf_y, buf_dbr, buf_dctx,
// buf_ctx (B*L, dim) bf16 (buf_dbr only written when s1 is given),
// buf_qkv, buf_dqkv (B*L, 3 dim) bf16, buf_dy (B*L, dim) f32, buf_stats
// (2 B*L) f32, workspace (fused_block_bwd_attn_workspace) f32.
int fused_block_bwd_attn(const void* x, const void* dx1, const void* s1,
                         const void* qkv_w, const void* qkv_b,
                         const void* proj_w, const void* proj_b,
                         const void* ln1_s, const void* ln1_b, void* dx,
                         void* dqkv_w, void* dqkv_b, void* dproj_w,
                         void* dproj_b, void* dln1_s, void* dln1_b,
                         void* buf_y, void* buf_dbr, void* buf_dctx,
                         void* buf_ctx, void* buf_qkv, void* buf_dqkv,
                         void* buf_dy, void* buf_stats, void* workspace,
                         int batch, int seq, int dim, int heads, int valid_len,
                         float eps, void* stream_ptr) {
  if (heads <= 0 || dim != heads * DH || dim > MAX_BWD_DIM || seq < 1 ||
      valid_len < 1 || valid_len > seq || batch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  const int rows = batch * seq;
  const bf16* xb = w(x);
  bf16* y = static_cast<bf16*>(buf_y);
  bf16* dctx = static_cast<bf16*>(buf_dctx);
  bf16* ctx = static_cast<bf16*>(buf_ctx);
  bf16* qkv = static_cast<bf16*>(buf_qkv);
  bf16* dqkv = static_cast<bf16*>(buf_dqkv);
  float* dy = f(buf_dy);
  float* mean = f(buf_stats);
  float* rstd = mean + rows;
  float* ws = f(workspace);
  const AttnParts parts(batch, seq, dim);
  const bf16* dbr = s1 != nullptr ? w(buf_dbr) : w(dx1);
  cudaError_t e;
  if ((e = bwd_prep(xb, w(ln1_s), w(ln1_b), w(dx1), w(s1), y, mean, rstd,
                    static_cast<bf16*>(buf_dbr), ws + parts.dbproj, rows,
                    dim, eps, stream))) return (int)e;
  if ((e = gemm_sm90<EPI_BIAS>(y, w(qkv_w), w(qkv_b), qkv, rows, 3 * dim,
                               dim, stream))) return (int)e;
  // dctx = bf16(dbr @ Wproj^T)
  if ((e = gemm_sm90<EPI_NONE, false, true>(dbr, w(proj_w), nullptr, dctx,
                                            rows, dim, dim, stream)))
    return (int)e;
  if (seq > SHORT_ATT_LEN)
    e = long_attention_bwd(qkv, dctx, ctx, dqkv, ws + parts.dbqkv,
                           ws + parts.stats, batch, seq, dim, heads,
                           valid_len, stream);
  else
    e = attention_bwd(qkv, dctx, ctx, dqkv, ws + parts.dbqkv, batch, seq,
                      dim, heads, valid_len, stream);
  if (e) return (int)e;
  if ((e = wgrad_sm90(ctx, dbr, ws + parts.dwproj, dim, dim, rows, stream)))
    return (int)e;
  if ((e = wgrad_sm90(y, dqkv, ws + parts.dwqkv, dim, 3 * dim, rows,
                      stream))) return (int)e;
  // dy = dqkv @ Wqkv^T in f32
  if ((e = gemm_sm90<EPI_F32, false, true>(dqkv, w(qkv_w), nullptr, dy, rows,
                                           dim, 3 * dim, stream)))
    return (int)e;
  if ((e = ln_bwd(dy, xb, mean, rstd, w(ln1_s), w(dx1),
                  static_cast<bf16*>(dx), ws + parts.dln_b, ws + parts.dln_s,
                  rows, dim, stream))) return (int)e;
  int kt;
  const int chunks = row_chunks(rows);
  PartSums sums{{{ws + parts.dbqkv, f(dqkv_b), 3 * dim,
                  batch * ((seq + 15) / 16)},
                 {ws + parts.dbproj, f(dproj_b), dim, chunks},
                 {ws + parts.dln_b, f(dln1_b), dim, chunks},
                 {ws + parts.dln_s, f(dln1_s), dim, chunks},
                 {ws + parts.dwproj, f(dproj_w), dim * dim,
                  wgrad_splits(dim, dim, rows, &kt)},
                 {ws + parts.dwqkv, f(dqkv_w), dim * 3 * dim,
                  wgrad_splits(dim, 3 * dim, rows, &kt)}},
                6};
  return (int)sum_parts(sums, stream);
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
