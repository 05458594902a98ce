// Throughput of the instructions K2 and K3 are made of, on one card:
// mma.sync m16n8k8 TF32 (their 3xTF32 products), m16n8k16 bf16 for
// comparison, and f32 FFMA (K2's P V), each with independent chains in
// every warp, 4 blocks an SM, at 4, 8 and 16 warps a block.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_rate \
//        tools/mma_sync_rate.cu && build/mma_sync_rate
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tf32_kernel(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, 3};
  uint32_t b0 = threadIdx.x * 7, b1 = 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void bf16_kernel(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, 3};
  uint32_t b0 = threadIdx.x * 7, b1 = 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_kernel(float* out, int iters) {
  float c[16];
  for (int j = 0; j < 16; ++j) c[j] = threadIdx.x * 0.001f + j;
  const float x = out[0] * 0.5f, y = 1.0001f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) c[j] = __fmaf_rn(c[j], y, x);
  }
  float s = 0;
  for (int j = 0; j < 16; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename K>
float time_ms(K kernel, int blocks, int threads, float* out, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kernel<<<blocks, threads>>>(out, iters);   // warm-up
  cudaEventRecord(e0);
  kernel<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 4 * 16 * 32 * sizeof(float));
  cudaMemset(out, 0, sizeof(float));
  const int iters = 4096, blocks = sms * 4;
  for (int warps = 4; warps <= 16; warps *= 2) {
    const double mmas = (double)blocks * warps * iters * 8;
    const double fmas = (double)blocks * warps * 32 * iters * 128;
    const float t = time_ms(tf32_kernel, blocks, 32 * warps, out, iters);
    const float b = time_ms(bf16_kernel, blocks, 32 * warps, out, iters);
    const float f = time_ms(ffma_kernel, blocks, 32 * warps, out, iters);
    printf("%d warps a block: mma.sync tf32 m16n8k8 %.1f TFLOP/s, bf16 "
           "m16n8k16 %.1f TFLOP/s, FFMA %.1f TFLOP/s\n", warps,
           mmas * 2048 / t / 1e9, mmas * 4096 / b / 1e9, fmas * 2 / f / 1e9);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
