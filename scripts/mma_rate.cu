// Issue rate of the mma.sync shapes the port's attention kernels use, on
// one card: TF32 m16n8k8 and bf16 m16n8k16, with 1, 4 or 8 independent
// accumulator chains per warp and 4 to 32 warps per SM. A dependent chain
// gives the instruction's latency, many chains its throughput.
//
//   nvcc -O3 -std=c++17 -gencode=arch=compute_90a,code=sm_90a \
//        -o mma_rate scripts/mma_rate.cu && ./mma_rate
//
// Prints one line per configuration: time, TFLOP/s and ns per mma per SM
// sub-partition (132 SMs x 4). The inputs are constants; only the rate
// matters.

#include <cuda_runtime.h>
#include <stdio.h>

#include "../paddle_tpu_torch/ops/cuda/attention_tile.cuh"

using attn_tile::mma_bf16;
using attn_tile::mma_tf32;

template <int CHAINS, bool BF16>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  float c[CHAINS][4];
  for (int i = 0; i < CHAINS; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  const uint32_t a[4] = {seed, seed ^ 1u, seed ^ 2u, seed ^ 3u};
  const uint32_t b0 = seed * 3u, b1 = seed * 5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
      if (BF16) {
        mma_bf16(c[i], a, b0, b1);
      } else {
        mma_tf32(c[i], a, b0, b1);
      }
    }
  }
  float s = 0.f;
  for (int i = 0; i < CHAINS; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the loop alive
}

template <int CHAINS, bool BF16>
float time_ms(float* out, int blocks, int iters) {
  mma_loop<CHAINS, BF16><<<blocks, 128>>>(out, iters, 7);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_loop<CHAINS, BF16><<<blocks, 128>>>(out, iters, 7);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}

int main() {
  float* out = nullptr;
  cudaMalloc(&out, 4096);
  const int iters = 4096, sms = 132;
  for (int bf16 = 0; bf16 < 2; ++bf16)
    for (int warps : {4, 8, 16, 32})
      for (int chains : {1, 4, 8}) {
        const int blocks = sms * warps / 4;  // 4 warps a block
        float ms;
        if (bf16) {
          ms = chains == 1   ? time_ms<1, true>(out, blocks, iters)
               : chains == 4 ? time_ms<4, true>(out, blocks, iters)
                             : time_ms<8, true>(out, blocks, iters);
        } else {
          ms = chains == 1   ? time_ms<1, false>(out, blocks, iters)
               : chains == 4 ? time_ms<4, false>(out, blocks, iters)
                             : time_ms<8, false>(out, blocks, iters);
        }
        const double mmas = double(blocks) * 4 * iters * chains;
        const double flops = mmas * (bf16 ? 4096.0 : 2048.0);
        printf("%s warps/SM %2d chains %d: %.3f ms, %.1f TFLOP/s, %.2f ns "
               "per mma per SM sub-partition\n",
               bf16 ? "bf16 m16n8k16" : "tf32 m16n8k8 ", warps, chains, ms,
               flops / ms / 1e9, ms * 1e6 / (mmas / (sms * 4.0)));
      }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  cudaFree(out);
  return err == cudaSuccess ? 0 : 1;
}
