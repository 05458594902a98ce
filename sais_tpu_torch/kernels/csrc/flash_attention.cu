// K2: masked flash-attention forward in f32, for Hopper (sm_90a).
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
// What bounds it on an H100: two chained products of 2 Dh flops per
// (query, key) pair, against reading q, k, v and writing out once.  At the
// steps path's (B*S = 132, H = 4, L = 301, Dh = 96) that is 18.4 GFLOP
// against 244 MB: 0.274 ms at the card's 67 TFLOP/s of f32 FFMA against
// 0.073 ms at 3.35 TB/s, so it is bound by operations (75 flops a byte,
// where the card balances at 20).  At (8, 4, 2001, 96) it is 49.2 GFLOP
// against 98 MB: 0.734 ms against 0.029 ms.  The products stay in f32
// FFMA: the JAX kernel rounds nowhere below f32, and TF32 tensor cores
// would move its rounding points.
//
// Design (a first version that is right before it is fast):
//
// - One block of 256 threads per (batch*head, tile of 64 queries), the
//   grid flattened to one dimension.  The block walks the keys in tiles of
//   64, copied with cp.async into dynamic shared memory (Q 64 x Dh, K 64 x
//   Dh, V 64 x Dh, P 64 x 64 and the tile's bias: 93 KB at Dh = 96, so two
//   blocks fit an SM).  The TPU's padding of L to its blocks and of Dh to
//   128 lanes is not needed: the last key tile is zero-filled and its
//   missing keys get a bias of -inf, which gives them p = 0 exactly, as
//   the TPU's -1e30 pad keys get on every row that has a valid key.
// - Thread (ty, tx) of the 16 x 16 layout holds rows 4ty..4ty+3 and keys
//   tx + 16j of the score tile in registers, its rows' m and l (the same in
//   all 16 threads of a half warp, which reduce a row with shuffles), and
//   the output columns tx + 16j of its rows.  P goes through shared memory
//   into the P V product.
// - Products with f32 FFMA, the Q and K operands read as float4 from rows
//   padded by 4 floats (no bank conflicts).
// - No length ceiling: K and V stream from device memory tile by tile.
//
// Operands take strides (in elements) for batch, head and row; the last
// axis must be contiguous and every row 16-byte aligned.  So the temporal
// encoder hands q, k and v as views of its (B, L, 3 D) projection, and the
// output lands in a (B, L, H, Dh) buffer, with no transposing copy either
// way.  bias is (B, Lk) and lse (B, H, Lq), both contiguous.
//
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the JAX kernel's masked bias and m0
constexpr int BQ = 64;              // query rows per block
constexpr int BKEY = 64;            // keys per tile
constexpr int THREADS = 256;        // 16 x 16
constexpr int TR = BQ / 16;         // query rows per thread
constexpr int TC = BKEY / 16;       // keys per thread
constexpr int LDP = BKEY + 4;

template <int DH>
struct Layout {
  static constexpr int LDQK = DH + 4;   // float4 reads, 4-bank row offset
  static constexpr int LDV = DH;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQK;
  static constexpr int V = K + BKEY * LDQK;
  static constexpr int P = V + BKEY * LDV;
  static constexpr int BIAS = P + BQ * LDP;
  static constexpr size_t bytes = (size_t)(BIAS + BKEY) * sizeof(float);
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

// max / sum over the 16 threads of a half warp (one row's key columns)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int heads, int lq, int lk,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int zero_masked_rows) {
  using LY = Layout<DH>;
  constexpr int NDT = DH / 16;   // output columns per thread
  constexpr int CH = DH / 4;     // float4 chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + LY::Q;
  float* Ks = smem + LY::K;
  float* Vs = smem + LY::V;
  float* Ps = smem + LY::P;
  float* Bs = smem + LY::BIAS;

  const int nqt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias ? bias + (size_t)b * lk : nullptr;

  // Q tile, pre-scaled in f32 (rows past lq are zero and never stored)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < lq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * LY::LDQK + c) = x;
  }

  float m[TR], l[TR], acc[TR][NDT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NDT; ++j) acc[i][j] = 0.f;
  }
  int any_valid = 0;

  for (int k0 = 0; k0 < lk; k0 += BKEY) {
    // K and V tiles; keys past lk are zero-filled
    for (int i = tid; i < BKEY * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = k0 + r < lk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(Ks + r * LY::LDQK + c, kb + row * sk.l + c, ok);
      cp_async16(Vs + r * LY::LDV + c, vb + row * sv.l + c, ok);
    }
    cp_async_commit();
    int valid = 0;
    if (tid < BKEY) {
      float bv = -INFINITY;   // no key at all: p = 0 exactly
      if (k0 + tid < lk) bv = biasb ? biasb[k0 + tid] : 0.f;
      Bs[tid] = bv;
      valid = bv > kNegInf;
    }
    cp_async_wait_all();
    any_valid |= __syncthreads_or(valid);

    // S = Q' K^T + bias
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (ty * TR + i) * LY::LDQK + d);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            Ks + (tx + 16 * j) * LY::LDQK + d);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // online softmax: m, l and the rescale of acc, per row
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] += Bs[tx + 16 * j];
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * TR + i) * LDP + tx + 16 * j] = p;
        ps += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NDT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // P complete

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < BKEY; kk += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * TR + i) * LDP + kk);
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        const int c = tx + 16 * j;
        const float v0 = Vs[(kk + 0) * LY::LDV + c];
        const float v1 = Vs[(kk + 1) * LY::LDV + c];
        const float v2 = Vs[(kk + 2) * LY::LDV + c];
        const float v3 = Vs[(kk + 3) * LY::LDV + c];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float t = acc[i][j];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][j] = t;
        }
      }
    }
    __syncthreads();   // K, V, P and the bias tile free for the next tile
  }

  const bool zero = zero_masked_rows && !any_valid;
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty * TR + i;
    if (r >= lq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      ob[r * so.l + tx + 16 * j] = zero ? 0.f : acc[i][j] / l_safe;
    if (tx == 0) lse[(size_t)bh * lq + r] = m[i] + logf(l_safe);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, float* o, float* lse, int batch,
                   int heads, int lq, int lk, Strides sq, Strides sk,
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
      q, k, v, bias, o, lse, heads, lq, lk, sq, sk, sv, so, scale,
      zero_masked_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, L, Dh) f32 with the given element strides for batch,
// head and row (the last axis contiguous); bias: (B, Lk) f32 or null (no
// key masked); lse: (B, H, Lq) f32.  zero_masked_rows != 0: a batch element
// whose every bias is <= -1e30 gets zero output rows.
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
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, so{o_sb, o_sh, o_sl};
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  switch (dh) {
#define SAIS_FLASH_CASE(d)                                                  \
  case d:                                                                   \
    return (int)launch<d>(f(q), f(k), f(v), f(bias), of, lf, batch, heads, \
                          lq, lk, sq, sk, sv, so, scale, zero_masked_rows,  \
                          stream);
    SAIS_FLASH_CASE(64) SAIS_FLASH_CASE(96) SAIS_FLASH_CASE(128)
#undef SAIS_FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* sais_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
