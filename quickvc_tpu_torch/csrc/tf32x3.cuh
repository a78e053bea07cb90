// Float32-accurate products on Hopper's TF32 tensor cores (3xTF32) and the
// cp.async copies that feed them, for sm_90a. Shared by the attention body
// of K2/K8/K9/K10 (fused_attention.cuh), the implicit GEMM of K5/K6
// (fused_disc_conv.cu), K7's conv1 (fused_extractor.cu) and K8's linear
// layers (fused_transformer.cu); the last two also take the exact GELU of
// their epilogues from here.
//
// 3xTF32: each float32 operand x is split into big, x rounded to TF32 as
// cvt.rna.tf32.f32 rounds (done as an integer add and mask: cvt.rna itself
// compiles to a compare-and-select sequence on sm_90a), and small = x - big,
// exact in float32, of which the tensor core reads the top 10 mantissa
// bits. A product is small*big + big*small, then big*big, on
// mma.sync.m16n8k8 tf32 with float32 accumulation: about 2^-21 relative a
// product, against 2^-11 for one TF32 pass. tests/test_torch_attention_tf32.py
// and tests/test_torch_conv5_tf32.py emulate it in numpy.
//
// Included by several sources, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 (or 4) bytes from global to shared memory, asynchronously; an invalid
// copy reads nothing and zero-fills its destination (src-size 0), and src
// must still be a valid address.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: the bits cvt.rna.tf32.f32 gives, here one integer
// add and mask), small the exact float32 remainder, of which the tensor
// core reads the top 10 mantissa bits.
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b on one m16n8k8 TF32 tile, float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment split once, reused across the B fragments it meets
__device__ __forceinline__ void split_a(const float (&a)[4], unsigned (&big)[4],
                                        unsigned (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
}

// d = a b on one m16n8k8 TF32 tile, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                              unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// c += a b in 3xTF32 for a long reduction, on operands split beforehand (a
// GEMM splits each B fragment once for all the A fragments it meets): the
// three products of this k8 step are summed from zero inside the tensor
// core, then added to c by float32 adds. The sum inside an mma truncates (measured on the H100:
// 3xTF32 chained into one accumulator over k = 5,120 erred by 2.4e-4 on
// O(1) outputs, this order by 6.9e-6), and its error scales with |c|, so c
// itself never enters an mma.
__device__ __forceinline__ void mma_3xtf32_promoted(float (&c)[4], const unsigned (&ab)[4],
                                                    const unsigned (&as)[4], unsigned bb0,
                                                    unsigned bs0, unsigned bb1, unsigned bs1) {
  float t[4];
  mma_tf32_zero(t, as, bb0, bb1);
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// c += a b in 3xTF32: the small cross terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ab)[4],
                                           const unsigned (&as)[4], float b0, float b1) {
  unsigned bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// Exact GELU, x * Phi(x), as torch.nn.functional.gelu(approximate="none").
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

}  // namespace
