// The rate of mma.sync.m16n8k8 TF32 on this card: a yardstick for the
// kernels built on it (K5/K6's implicit GEMM, the attention body of
// K2/K8/K9/K10), not a port of a TPU kernel. Each warp runs `iters` rounds
// of 8 independent m16n8k8 products on register operands, with no memory
// traffic; scripts/kernel_times.py times it and reports TFLOP/s
// (2 * 16 * 8 * 8 flops a product).

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

__global__ void __launch_bounds__(256) mma_tf32_rate_kernel(float* out, int iters) {
  const unsigned a[4] = {threadIdx.x * 0x1000u, threadIdx.x * 0x3000u, 0x3f800000u,
                         0x3f000000u};
  const unsigned b0 = 0x3f800000u + threadIdx.x, b1 = 0x3e800000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], a, b0, b1);
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

}  // namespace

// out: blocks * 256 floats; 8 warps a block, each 8 * iters products.
extern "C" int qvc_mma_tf32_rate(void* out, int blocks, int iters, void* stream) {
  mma_tf32_rate_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
