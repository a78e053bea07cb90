// The float32 register-tile core of the port's GEMM-shaped kernels: K5/K6
// (fused_disc_conv.cu), K7 (fused_extractor.cu) and K8's linear layers
// (fused_transformer.cu), for sm_90a.
//
// A block of TILE_THREADS = 256 threads owns a TILE_M x TILE_N = 128 x 128
// output tile. Thread (tx, ty) = (tid % 16, tid / 16) holds an 8 x 8 register
// tile: rows tile_row(ty, 0..7) and columns tile_row(tx, 0..7), i.e. two
// groups of 4 at 0 and 64, so that the float4 shared-memory reads of a warp
// are conflict-free. The kernels stage each K slice of both operands
// transposed, k-major, as As[k][m] and Bs[k][n]; rows carry TILE_PAD floats
// of padding so that the transposed stores of the k-contiguous loads hit
// distinct banks, and stay 16-byte aligned for the float4 reads.
//
// Included by several sources, so everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE_M = 128, TILE_N = 128;
constexpr int TILE_THREADS = 256;
constexpr int TILE_PAD = 4;
constexpr int TILE_LD = TILE_M + TILE_PAD;  // row length of As and Bs (TILE_M == TILE_N)

// Row (or column) of the tile that register index i (0..7) of thread
// coordinate t (ty for rows, tx for columns) covers.
__device__ __forceinline__ int tile_row(int t, int i) {
  return i < 4 ? t * 4 + i : 60 + t * 4 + i;
}

// acc[i][j] += sum over k < KSTEPS of As[k][tile_row(ty, i)] * Bs[k][tile_row(tx, j)].
template <int KSTEPS>
__device__ __forceinline__ void tile_mma(const float (*As)[TILE_LD], const float (*Bs)[TILE_LD],
                                         float (&acc)[8][8], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void tile_zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

// Exact GELU, x * Phi(x), as torch.nn.functional.gelu(approximate="none").
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

}  // namespace
