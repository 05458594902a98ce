// K3: masked flash-attention backward in f32, for Hopper (sm_90a).
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
// What bounds it on an H100 (SXM data-sheet peaks at 700 W): the least
// work is five products of 2 Dh flops per (query, valid key) pair (s, dp,
// dv, dk, dq), 10 Dh flops.  At
// the steps path's (B*H = 528, L = 301, Dh = 96) that is 47.8 M pairs and
// 45.9 GFLOP against 488 MB of q, k, v, out, dO, dq, dk and dv: 0.686 ms
// at the card's 67 TFLOP/s of f32 FFMA against 0.146 ms at 3.35 TB/s, so
// it is bound by operations.  The two-kernel split, like JAX's, computes
// s and dp in both kernels, 14 Dh flops a pair (0.960 ms at that shape).
// The products stay in f32 FFMA: the JAX kernels round nowhere below f32,
// and TF32 tensor cores would move their rounding points.
//
// Design (a first version that is right before it is fast):
//
// - Two kernels, as in JAX, so that each output tile has exactly one
//   owner: no atomics, and the result does not depend on block order.
//   dq: one block of 256 threads per (batch*head, tile of 64 queries),
//   looping over key tiles of 64.  dk / dv: one block per (batch*head,
//   tile of 64 keys), looping over query tiles of 64.
// - Thread (ty, tx) of the 16 x 16 layout owns 4 rows (ty*4 .. ty*4+3) and
//   columns tx + 16 j of each 64 x 64 score tile, and output columns
//   tx + 16 j of its rows.  The dk / dv kernel computes the TRANSPOSED
//   tiles s^T and dp^T directly (its rows are keys), so p^T and ds^T land
//   in shared memory row-major by key, and the products p^T dO and ds^T q'
//   read them as float4 rows and dO / q' by column: no transposed
//   shared-memory reads, no bank conflicts.  The score products read two
//   padded rows (Dh + 4 floats) as float4, as K2 does.
// - Exact shapes: rows past Lq or Lk are zero-filled in shared memory;
//   missing keys get a bias of -inf and missing queries an lse of +inf, so
//   their p is exactly 0 and they contribute nothing.  Masked keys keep
//   the -1e30 bias, so p is what the TPU computes, also for the rows of an
//   all-masked element (there the caller zeroes dO, and ds = 0 exactly).
// - Shared memory, f32 at Dh = 96: dq kernel Q', dO, K, V tiles (64 x 100
//   each), ds (64 x 68) and the bias tile, 120,064 bytes; dk / dv kernel
//   K, V, Q', dO tiles, p^T and ds^T (64 x 68 each), lse and delta,
//   137,728 bytes.  Dynamic shared memory after cudaFuncSetAttribute; one
//   block (8 warps) an SM at Dh 96 and 128; at Dh 64 shared memory would
//   allow two.
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

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int TR = 4;           // rows a thread owns in a 64 x 64 tile
constexpr int TC = 4;           // columns a thread owns in a 64 x 64 tile
constexpr int LDS = 64 + 4;     // row stride of the ds / p tiles

template <int DH>
struct DqLayout {
  static constexpr int LD = DH + 4;   // float4 reads, 4-bank row offset
  static constexpr int Q = 0;
  static constexpr int DO = Q + BQ * LD;
  static constexpr int K = DO + BQ * LD;
  static constexpr int V = K + BK * LD;
  static constexpr int DS = V + BK * LD;
  static constexpr int BIAS = DS + BQ * LDS;
  static constexpr size_t bytes = (size_t)(BIAS + BK) * sizeof(float);
};

template <int DH>
struct DkvLayout {
  static constexpr int LD = DH + 4;
  static constexpr int K = 0;
  static constexpr int V = K + BK * LD;
  static constexpr int Q = V + BK * LD;
  static constexpr int DO = Q + BQ * LD;
  static constexpr int PT = DO + BQ * LD;
  static constexpr int DST = PT + BK * LDS;
  static constexpr int LSE = DST + BK * LDS;
  static constexpr int DELTA = LSE + BQ;
  static constexpr size_t bytes = (size_t)(DELTA + BQ) * sizeof(float);
};

struct Strides {
  long long b, h, l;
};

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float t) {
  t = fmaf(a.x, b.x, t);
  t = fmaf(a.y, b.y, t);
  t = fmaf(a.z, b.z, t);
  return fmaf(a.w, b.w, t);
}

// acc[i][j] += A[row_i] . B[col_j] over DH for the thread's TR rows of A
// (ra = first row, shared by the half warp) and TC rows of B (tx + 16 j),
// both tiles row-major with stride LD.
template <int DH, int LD>
__device__ __forceinline__ void tile_dot(float (&acc)[TR][TC],
                                         const float* A, const float* B,
                                         int ra, int tx) {
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[TR], bv[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ra + i) * LD + d);
#pragma unroll
    for (int j = 0; j < TC; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_t W[ra + i][t] * X[t][tx + 16 c] over the 64 columns of
// W (row-major, stride LDS) and the 64 rows of X (row-major, stride LD).
template <int DH, int LD>
__device__ __forceinline__ void tile_matmul(float (&acc)[TR][DH / 16],
                                            const float* W, const float* X,
                                            int ra, int tx) {
#pragma unroll 2
  for (int t = 0; t < 64; t += 4) {
    float4 wv[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + (ra + i) * LDS + t);
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const int col = tx + 16 * c;
      const float x0 = X[(t + 0) * LD + col];
      const float x1 = X[(t + 1) * LD + col];
      const float x2 = X[(t + 2) * LD + col];
      const float x3 = X[(t + 3) * LD + col];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float a = acc[i][c];
        a = fmaf(wv[i].x, x0, a);
        a = fmaf(wv[i].y, x1, a);
        a = fmaf(wv[i].z, x2, a);
        a = fmaf(wv[i].w, x3, a);
        acc[i][c] = a;
      }
    }
  }
}

// ---------------------------------------------------------------- dq --

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int heads, int lq, int lk,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale) {
  using LY = DqLayout<DH>;
  constexpr int LD = LY::LD;
  constexpr int NDT = DH / 16;   // output columns per thread
  constexpr int CH = DH / 4;     // float4 chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + LY::Q;
  float* DOs = smem + LY::DO;
  float* Ks = smem + LY::K;
  float* Vs = smem + LY::V;
  float* DSs = smem + LY::DS;
  float* Bs = smem + LY::BIAS;

  const int nqt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ra = ty * TR;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  // Q' and dO tiles (rows past lq are zero and never stored)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xd = xq;
    if (q0 + r < lq) {
      xq = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
      xd = *reinterpret_cast<const float4*>(dob + (q0 + r) * sdo.l + c);
    }
    *reinterpret_cast<float4*>(Qs + r * LD + c) = scaled(xq, scale);
    *reinterpret_cast<float4*>(DOs + r * LD + c) = xd;
  }
  float lse_r[TR], delta_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ra + i;
    lse_r[i] = r < lq ? lse[(size_t)bh * lq + r] : INFINITY;   // p = 0
    delta_r[i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
  }
  float acc[TR][NDT];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < NDT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    // K and V tiles; keys past lk are zero-filled with a bias of -inf
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(Ks + r * LD + c, kb + row * sk.l + c, ok);
      cp_async16(Vs + r * LD + c, vb + row * sv.l + c, ok);
    }
    cp_async_commit();
    if (tid < BK)
      Bs[tid] = k0 + tid < lk ? (biasb ? biasb[k0 + tid] : 0.f) : -INFINITY;
    cp_async_wait_all();
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<DH, LD>(s, Qs, Ks, ra, tx);
    tile_dot<DH, LD>(dp, DOs, Vs, ra, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf((s[i][j] + Bs[tx + 16 * j]) - lse_r[i]);
        DSs[(ra + i) * LDS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();   // ds complete

    tile_matmul<DH, LD>(acc, DSs, Ks, ra, tx);   // acc += ds K
    __syncthreads();   // K, V, ds and the bias tile free for the next tile
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ra + i;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      dqb[r * sdq.l + tx + 16 * j] = acc[i][j] * scale;
  }
}

// ------------------------------------------------------------- dk, dv --

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int lq, int lk, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv,
                         float scale) {
  using LY = DkvLayout<DH>;
  constexpr int LD = LY::LD;
  constexpr int NDT = DH / 16;
  constexpr int CH = DH / 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem + LY::K;
  float* Vs = smem + LY::V;
  float* Qs = smem + LY::Q;
  float* DOs = smem + LY::DO;
  float* PTs = smem + LY::PT;
  float* DSTs = smem + LY::DST;
  float* LSEs = smem + LY::LSE;
  float* DELTAs = smem + LY::DELTA;

  const int nkt = (lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt, kt = blockIdx.x % nkt;
  const int b = bh / heads, h = bh % heads;
  const int k0 = kt * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ra = ty * TR;   // the thread's first key row in the tile

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;

  // K and V tiles, resident for the whole query loop
  for (int i = tid; i < BK * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + r < lk;
    const long long row = ok ? k0 + r : 0;
    cp_async16(Ks + r * LD + c, kb + row * sk.l + c, ok);
    cp_async16(Vs + r * LD + c, vb + row * sv.l + c, ok);
  }
  cp_async_commit();
  float bias_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int key = k0 + ra + i;
    bias_r[i] = key < lk ? (bias ? bias[(size_t)b * lk + key] : 0.f)
                         : -INFINITY;   // no key at all: p = 0
  }
  float dk_acc[TR][NDT], dv_acc[TR][NDT];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < NDT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < lq; q0 += BQ) {
    // Q' and dO tiles; queries past lq are zero with lse = +inf (p = 0)
    for (int i = tid; i < BQ * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      float4 xq = make_float4(0.f, 0.f, 0.f, 0.f), xd = xq;
      if (q0 + r < lq) {
        xq = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
        xd = *reinterpret_cast<const float4*>(dob + (q0 + r) * sdo.l + c);
      }
      *reinterpret_cast<float4*>(Qs + r * LD + c) = scaled(xq, scale);
      *reinterpret_cast<float4*>(DOs + r * LD + c) = xd;
    }
    if (tid < BQ) {
      const int r = q0 + tid;
      LSEs[tid] = r < lq ? lse[(size_t)bh * lq + r] : INFINITY;
      DELTAs[tid] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
    }
    cp_async_wait_all();   // the K / V tiles (first pass only)
    __syncthreads();

    // s^T and dp^T: rows are the thread's keys, columns queries tx + 16 j
    float st[TR][TC], dpt[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_dot<DH, LD>(st, Ks, Qs, ra, tx);
    tile_dot<DH, LD>(dpt, Vs, DOs, ra, tx);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = tx + 16 * j;
        const float p = expf((st[i][j] + bias_r[i]) - LSEs[col]);
        PTs[(ra + i) * LDS + col] = p;
        DSTs[(ra + i) * LDS + col] = p * (dpt[i][j] - DELTAs[col]);
      }
    __syncthreads();   // p^T and ds^T complete

    tile_matmul<DH, LD>(dv_acc, PTs, DOs, ra, tx);   // dv += p^T dO
    tile_matmul<DH, LD>(dk_acc, DSTs, Qs, ra, tx);   // dk += ds^T q'
    __syncthreads();   // Q', dO, p^T, ds^T, lse and delta free
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int key = k0 + ra + i;
    if (key >= lk) continue;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      dkb[key * sdk.l + tx + 16 * j] = dk_acc[i][j];
      dvb[key * sdv.l + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* dout, const float* lse,
                   const float* delta, float* dq, float* dk, float* dv,
                   int batch, int heads, int lq, int lk, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   Strides sdk, Strides sdv, float scale,
                   cudaStream_t stream) {
  constexpr size_t dq_smem = DqLayout<DH>::bytes;
  constexpr size_t dkv_smem = DkvLayout<DH>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_smem);
  if (e != cudaSuccess) return e;
  const long long bh = (long long)batch * heads;
  const long long dq_blocks = bh * ((lq + BQ - 1) / BQ);
  const long long dkv_blocks = bh * ((lk + BK - 1) / BK);
  if (dq_blocks > 0x7fffffffLL || dkv_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<DH><<<(unsigned)dq_blocks, THREADS, dq_smem, stream>>>(
      q, k, v, bias, dout, lse, delta, dq, heads, lq, lk, sq, sk, sv, sdo,
      sdq, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<DH>
      <<<(unsigned)dkv_blocks, THREADS, dkv_smem, stream>>>(
          q, k, v, bias, dout, lse, delta, dk, dv, heads, lq, lk, sq, sk, sv,
          sdo, sdk, sdv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout, dq: (B, H, Lq, Dh); k, v, dk, dv: (B, H, Lk, Dh); all f32 with
// the given element strides for batch, head and row (the last axis
// contiguous).  bias: (B, Lk) f32 or null (no key masked); lse, delta:
// (B, H, Lq) f32 contiguous.  Returns 0, a cudaError_t value after a failed
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
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, sdo{do_sb, do_sh, do_sl},
      sdq{dq_sb, dq_sh, dq_sl}, sdk{dk_sb, dk_sh, dk_sl},
      sdv{dv_sb, dv_sh, dv_sl};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  switch (dh) {
#define SAIS_FLASH_BWD_CASE(d)                                              \
  case d:                                                                   \
    return (int)launch<d>(f(q), f(k), f(v), f(bias), f(dout), f(lse),       \
                          f(delta), w(dq), w(dk), w(dv), batch, heads, lq,  \
                          lk, sq, sk, sv, sdo, sdq, sdk, sdv, scale, stream);
    SAIS_FLASH_BWD_CASE(64) SAIS_FLASH_BWD_CASE(96) SAIS_FLASH_BWD_CASE(128)
#undef SAIS_FLASH_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
