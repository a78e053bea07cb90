// Kernel K7: HuBERT's feature-extractor front, conv0 (k=10, stride 5,
// 1 -> C, no bias) -> per-(batch, channel) affine -> GELU -> conv1 (k=3,
// stride 2, C -> C, no bias) -> GELU, float32, for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_extractor.py:
// fused_extractor_front (pallas_call at fused_extractor.py:187; body _kernel
// at :92-110). The affine (scale, shift) is GroupNorm(C, C) of conv0's output
// in closed form from the wave (groupnorm_affine_closed_form), computed
// outside the kernel in plain PyTorch, as JAX computes it outside its kernel.
// With h[t, c] = gelu(scale[c] * sum_k wav[5t + k] w0[c, k] + shift[c]):
//
//   out[b, u, o] = gelu(sum_{j < 3, c < C} h[2u + j, c] * w1[j, c, o])
//
// What bounds it on this card: operations. At the encoding batch (16, 96080)
// conv1 alone is 2 * 16 * 9607 * 512 * 1536 = 242 GFLOP against ~320 MB moved
// (the (16, 9607, 512) output dominates); in float32 the ceiling is the
// 67 TFLOP/s FMA rate.
//
// Design: conv1 is an implicit GEMM, M = output rows u of one batch item,
// N = C output channels, K = 3 taps x C in-channels, on the 128 x 128 tile
// core of sgemm_tile.cuh. Its A operand is never read from memory: for each
// K slice of KC in-channels the block computes the 2 * 128 + 1 conv0 rows
// its 128 output rows need, straight from the wave segment it staged in
// shared memory once (10 FMAs each), applies the affine and the exact erf
// GELU, and stores each value where the three taps read it (row 2m to tap 0
// of output row m and tap 2 of row m - 1, row 2m + 1 to tap 1 of row m), so
// conv0's (B, T/5, C) output never reaches device memory, which is what the
// TPU kernel bought. The TPU kernel's phase packing of the wave into a
// 128-lane array (for Mosaic's alignment) and its A&S erf polynomial (Mosaic
// has no erf) have no counterpart here. Each of the C / 128 column blocks of
// a row tile recomputes its conv0 rows: ~5% of the GEMM's operations at
// C = 512.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

namespace {

constexpr int KC = 8;                  // in-channels per K slice
constexpr int BK = 3 * KC;             // K slice: 3 taps x KC channels
constexpr int HROWS = 2 * TILE_M + 1;  // conv0 rows one row tile needs
constexpr int WAVE = 5 * HROWS + 5;    // wave samples those rows read
constexpr int ROWS_PER_PASS = TILE_THREADS / KC;  // conv0 rows computed per pass

// Two blocks per SM: at most 128 registers a thread.
__global__ void __launch_bounds__(TILE_THREADS, 2)
extractor_front_kernel(const float* __restrict__ wav, const float* __restrict__ w0,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       const float* __restrict__ w1t, float* __restrict__ out, int T, int C,
                       int n1) {
  __shared__ float ws[WAVE];
  __shared__ __align__(16) float As[BK][TILE_LD];
  __shared__ __align__(16) float Bs[BK][TILE_LD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE_N;
  const int u0 = blockIdx.y * TILE_M;
  const int b = blockIdx.z;

  // conv0 row r of this tile is t = 2 * u0 + r and reads wav[5t .. 5t + 9]
  const float* wb = wav + (long long)b * T;
  const long long base = 10LL * u0;
  for (int i = tid; i < WAVE; i += TILE_THREADS)
    ws[i] = base + i < T ? wb[base + i] : 0.0f;

  // this thread's conv0 channel within each K slice never changes
  const int c = tid % KC;
  const int r_first = tid / KC;

  float acc[8][8];
  tile_zero(acc);
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // previous slice consumed (first pass: ws staged)
    const int ch = c0 + c;
    float w[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) w[k] = __ldg(w0 + ch * 10 + k);
    const float sc = __ldg(scale + (long long)b * C + ch);
    const float sh = __ldg(shift + (long long)b * C + ch);
    // rows past the wave's end read zeros and feed only output rows >= n1
    for (int r = r_first; r < HROWS; r += ROWS_PER_PASS) {
      float x = 0.0f;
#pragma unroll
      for (int k = 0; k < 10; ++k) x = fmaf(ws[5 * r + k], w[k], x);
      const float h = gelu_erf(fmaf(x, sc, sh));
      const int m = r >> 1;
      if (r & 1) {
        As[KC + c][m] = h;
      } else {
        if (m < TILE_M) As[c][m] = h;
        if (m > 0) As[2 * KC + c][m - 1] = h;
      }
    }
    // B slice: row kk = j * KC + cc holds w1t[j, c0 + cc, n0 .. n0 + 127]
    for (int e = tid; e < BK * TILE_N / 4; e += TILE_THREADS) {
      const int kk = e / (TILE_N / 4), n = (e % (TILE_N / 4)) * 4;
      const int j = kk / KC, cc = kk - j * KC;
      const int col = n0 + n;  // C % 4 == 0: a float4 is all in or all out
      const float4 v = col < C
          ? __ldg(reinterpret_cast<const float4*>(w1t + ((long long)j * C + c0 + cc) * C + col))
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&Bs[kk][n]) = v;
    }
    __syncthreads();
    tile_mma<BK>(As, Bs, acc, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = u0 + tile_row(ty, i);
    if (u >= n1) continue;
    float* orow = out + ((long long)b * n1 + u) * C;
#pragma unroll
    for (int jg = 0; jg < 8; jg += 4) {
      const int col = n0 + tile_row(tx, jg);
      if (col >= C) continue;
      *reinterpret_cast<float4*>(orow + col) =
          make_float4(gelu_erf(acc[i][jg]), gelu_erf(acc[i][jg + 1]),
                      gelu_erf(acc[i][jg + 2]), gelu_erf(acc[i][jg + 3]));
    }
  }
}

}  // namespace

// out (B, n1, C) from wav (B, T), w0 (C, 10), scale/shift (B, C) and
// w1t (3, C, C) = conv1's weight as [tap][in][out]. Needs C % 8 == 0 and
// n1 = ((T - 10) / 5 + 1 - 3) / 2 + 1 >= 1.
extern "C" int qvc_extractor_front(const void* wav, const void* w0, const void* scale,
                                   const void* shift, const void* w1t, void* out, int batch,
                                   int T, int C, int n1, void* stream) {
  dim3 grid((C + TILE_N - 1) / TILE_N, (n1 + TILE_M - 1) / TILE_M, batch);
  extractor_front_kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)w0, (const float*)scale, (const float*)shift,
      (const float*)w1t, (float*)out, T, C, n1);
  return (int)cudaGetLastError();
}
