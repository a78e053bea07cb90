// The split-K sum of K6's bf16 dW, both of its bodies (fused_disc_conv.cu's
// mma.sync body, conv5_wgmma.cu's wgmma body): the float32 partials of the
// splits summed in split order and rounded to bf16 once. Included by those
// sources, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_gemm.cuh"  // bf16_t, pack_bf16

namespace {
namespace bf16core {

// out[i] = bf16(sum over z = 0..splits-1, in that order, of ws[z count + i]):
// split partials summed in float32 and rounded once (K6's bf16 dW, both of
// its bodies). vec: four values a thread a step, count % 4 == 0.
__global__ void __launch_bounds__(256)
splitk_sum_bf16_kernel(const float* __restrict__ ws, bf16_t* __restrict__ out,
                       long long count, int splits, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    const long long n4 = count / 4;
    for (; i < n4; i += stride) {
      float4 s = w4[i];
      for (int z = 1; z < splits; ++z) {
        const float4 p = w4[z * n4 + i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      reinterpret_cast<uint2*>(out)[i] = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
  } else {
    for (; i < count; i += stride) {
      float s = ws[i];
      for (int z = 1; z < splits; ++z) s += ws[z * count + i];
      out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
    }
  }
}

// splitk_sum_bf16_kernel's launch on `stream`, float4 reads where count and
// the pointers allow them
inline cudaError_t splitk_sum_bf16(const float* ws, bf16_t* out, long long count, int splits,
                                   cudaStream_t stream) {
  const bool vec = count % 4 == 0 && reinterpret_cast<unsigned long long>(ws) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(out) % 8 == 0;
  const long long work = vec ? count / 4 : count;
  const int blocks = (int)((work + 255) / 256 < 4096 ? (work + 255) / 256 : 4096);
  splitk_sum_bf16_kernel<<<blocks, 256, 0, stream>>>(ws, out, count, splits, vec);
  return cudaGetLastError();
}

}  // namespace bf16core
}  // namespace
