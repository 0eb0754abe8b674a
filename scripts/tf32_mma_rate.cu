// Rate of the warp-level TF32 matrix multiply (mma.sync) on this card.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tf32_mma_rate scripts/tf32_mma_rate.cu
//     ./tf32_mma_rate
//
// Each warp runs mma.sync.m16n8k8 TF32 products from registers into CHAINS
// independent accumulators, with no memory traffic, one block per SM. Prints
// TFLOP/s for 8 and 16 warps a block and 4 and 8 chains, and the same loop
// with the integer split of an operand (add, mask, subtract, add: what the
// 3xTF32 product of quake_tpu_torch/csrc/common.cuh does per loaded value)
// beside each product. It bounds what kernels K1 and K4 can reach with
// mma.sync.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int CHAINS, bool SPLIT>
__global__ void rate_kernel(float* out, int iters, float seed) {
  float acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  uint32_t a[4], b[2];
  float x = seed + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x + i) & 0xffffe000u;
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (SPLIT) {  // four operations per mma, as two split values per three products
        const uint32_t hi = (b[0] + 0x1000u) & 0xffffe000u;
        b[1] = __float_as_uint(__uint_as_float(b[0]) - __uint_as_float(hi)) + 0x1000u + b[1];
        b[0] = hi + c;
      }
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS, bool SPLIT>
void run(int sms, int warps, float* out) {
  const int iters = 20000;
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  rate_kernel<CHAINS, SPLIT><<<sms, warps * 32>>>(out, iters / 10, 1.0f);
  cudaEventRecord(t0);
  rate_kernel<CHAINS, SPLIT><<<sms, warps * 32>>>(out, iters, 1.0f);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, t0, t1);
  const double flops = 2.0 * 16 * 8 * 8 * (double)CHAINS * iters * warps * sms;
  printf("warps/block %2d chains %d split %d: %.3f ms, %.1f TFLOP/s (%s)\n", warps, CHAINS,
         (int)SPLIT, ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  printf("%s, %d SMs, %d kHz\n", prop.name, sms, prop.clockRate);
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  run<4, false>(sms, 8, out);
  run<8, false>(sms, 8, out);
  run<4, false>(sms, 16, out);
  run<8, false>(sms, 16, out);
  run<8, false>(sms, 32, out);
  run<8, true>(sms, 8, out);
  run<8, true>(sms, 16, out);
  cudaFree(out);
  return 0;
}
