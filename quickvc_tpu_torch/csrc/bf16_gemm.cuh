// The bf16 tensor-core GEMM core of the port, for sm_90a: bfloat16 operands,
// float32 accumulation on mma.sync.m16n8k16, fed by cp.async and ldmatrix.
// It holds the fragment helpers that K2's bf16 attention body
// (fused_attention_bf16.cuh), K7's bf16 conv1 (fused_extractor.cu), the
// bf16 implicit GEMM of K5/K6 (fused_disc_conv.cu) and the LSTM recurrence
// (lstm_recurrence.cu) share, the tiling K5/K6's bf16 mode takes, and the
// bf16 epilogues and split-K sum that K8's bf16 GEMMs take (wgmma_bf16.cuh).
// Included by several sources, so everything here has internal linkage.
//
// The arithmetic is what the TPU kernels' bf16 modes ask of the MXU: every
// product of two bf16 values is exact in float32 and summed in float32, and
// the epilogue works in float32 and rounds once where the JAX kernel rounds
// (quickvc_tpu/ops/fused_transformer.py:63-117 for K8).
//
// - Tiling (BM .. NT): a block of 4 warps (2 x 2) computes a 128 x 128
//   output tile, 64 x 64 a warp (4 x 8 m16n8k16 tiles, 128 float32
//   accumulators a lane), two blocks an SM, walking K in tiles of 64 through
//   a ring of 3 cp.async stages (ops/fused_disc_conv.py:BF16_TILING).
// - Fragments: an A fragment (16 rows x 16 k) is one ldmatrix.x4 (lane l
//   gives the address of row l % 16, k 8 (l / 16)); the B fragments of two
//   8-column tiles are one ldmatrix.x4 (lane l: row 8 (l / 16) + l % 8,
//   k 8 ((l / 8) % 2)), as K2's bf16 body reads its K tiles.
// - Split-K: a host plan may cut a reduction into `splits` ranges on k-tile
//   edges (valid_plan); split z stores its float32 partial tile to
//   workspace z and linear_bf16_splitk_kernel sums the partials in split
//   order and applies the epilogue (K6's bf16 dW only rounds:
//   splitk_bf16.cuh). No atomics: the same inputs give the
//   same bits on every launch.
// - Epilogues on column pairs (store_pair): the float32 bias, then
//     ROUND:     round to bf16 (in_proj's qkv);
//     GELU:      round to bf16, tanh GELU in float32, round again (linear1);
//     RESIDUAL:  add the bf16 residual in float32, store float32 (out_proj
//                and linear2, whose sums the LayerNorms read).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"  // the cp.async copies

namespace {
namespace bf16core {

typedef unsigned short bf16_t;  // raw bfloat16 bits; the tensor cores read them

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b on one m16n8k16 bf16 tile, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float bf16_to_float(bf16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

// x rounded to bf16 (to nearest even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// GELU in its tanh form, in float32 (jax.nn.gelu(approximate=True), torch's
// approximate="tanh"): the bf16 policy's GELU
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------------------
// the tiling (see the head note)

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 2, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 2;                         // blocks an SM
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 64 x 64 tile
constexpr int MT = WM / 16, NT = WN / 8;             // its m16n8k16 tiles
constexpr int MAX_SPLITS = 4;  // ops/fused_transformer.py:MAX_SPLITS

enum Epilogue { ROUND = 0, GELU = 1, RESIDUAL = 2 };

// Columns col and col + 1 of row `row`: v + bias, then the epilogue; stored
// to C (bf16 for ROUND and GELU, float32 for RESIDUAL). col is even.
template <int EPI>
__device__ __forceinline__ void store_pair(void* C, const float* __restrict__ bias,
                                           const bf16_t* __restrict__ res, long long row,
                                           int col, int N, float v0, float v1) {
  const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
  v0 += b.x;
  v1 += b.y;
  const long long at = row * N + col;
  if (EPI == RESIDUAL) {
    const unsigned r = __ldg(reinterpret_cast<const unsigned*>(res + at));
    v0 += __uint_as_float(r << 16);
    v1 += __uint_as_float(r & 0xffff0000u);
    *reinterpret_cast<float2*>(static_cast<float*>(C) + at) = make_float2(v0, v1);
  } else {
    if (EPI == GELU) {
      v0 = gelu_tanh(round_bf16(v0));
      v1 = gelu_tanh(round_bf16(v1));
    }
    *reinterpret_cast<unsigned*>(static_cast<bf16_t*>(C) + at) = pack_bf16(v0, v1);
  }
}

// C = epi(sum over z = 0..splits-1, in that order, of ws[z]): a block a
// row at a time, a column pair a thread.
template <int EPI>
__global__ void __launch_bounds__(256)
linear_bf16_splitk_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                          const bf16_t* __restrict__ res, void* C, int M, int N, int splits) {
  const long long mn = (long long)M * N;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    for (int col = 2 * threadIdx.x; col < N; col += 2 * blockDim.x) {
      const float* p = ws + (long long)row * N + col;
      float2 s = *reinterpret_cast<const float2*>(p);
      for (int z = 1; z < splits; ++z) {
        p += mn;
        const float2 v = *reinterpret_cast<const float2*>(p);
        s = make_float2(s.x + v.x, s.y + v.y);
      }
      store_pair<EPI>(C, bias, res, row, col, N, s.x, s.y);
    }
  }
}

// A split-K plan on the tiling's 64-wide k tiles: every split non-empty and
// on k-tile edges (ops/fused_disc_conv.py:dw_plan).
inline bool valid_plan(int K, int splits, int k_chunk) {
  return splits >= 1 && splits <= MAX_SPLITS && k_chunk >= 1 && k_chunk % BK == 0 &&
         (long long)(splits - 1) * k_chunk < K && (long long)splits * k_chunk >= K;
}

}  // namespace bf16core
}  // namespace
