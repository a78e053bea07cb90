// Kernels K5 (k=5 conv + bias + LeakyReLU, also its dx) and K6 (its dW),
// float32, for sm_90a.
//
// K5 replaces the TPU kernel quickvc_tpu/ops/fused_disc_conv.py:conv5_lrelu
// forward (pallas_call at fused_disc_conv.py:117; body _fwd_kernel at :41-67);
// its dx is the same kernel on the flipped, transposed filter with slope 1
// (fused_disc_conv.py:146-147). K6 replaces the dW pallas_call at
// fused_disc_conv.py:156 (body _dw_kernel at :70-90). With x (N, R, C_in),
// filter K (5, C_in, C_out), dym (N, R, C_out):
//
//   K5:  y[n, r, o]  = lrelu(sum_{dr, c} x[n, r + dr - 2, c] K[dr, c, o] + b[o])
//   K6:  dW[dr, c, o] = sum_{n, r} x[n, r + dr - 2, c] dym[n, r, o]
//
// (rows outside [0, R) read as zero: 'SAME' padding of 2 each side).
//
// What bounds them on this card: operations. At DiscriminatorP's fifth conv
// (x (128, 64, 1024), 1024 -> 1024) each is 2*N*R*5*C_in*C_out = 86 GFLOP
// against ~60 MB moved, far above the flop-per-byte balance; in float32
// (no TF32: multiplicands keep 24 bits) the ceiling is the 67 TFLOP/s FMA
// rate.
//
// Design: both are one implicit GEMM, out (M x Nc) = A (M x Kd) @ B (Kd x Nc),
// where B is a row-major matrix in memory (K5: the filter as (5*C_in, C_out);
// K6: dym as (N*R, C_out)) and A is gathered from x with the row shift, so
// no im2col copy is made. K5: A[(n, r), (dr, c)]; K6: A[(dr, c), (n, r)].
// A block computes a 128 x 128 tile of the output with 256 threads, each
// holding an 8 x 8 register tile (the core in sgemm_tile.cuh); K is walked
// in slices of 8 through a double-buffered shared-memory ring, the next
// slice being fetched into registers while the current one is multiplied.
// The epilogue adds the bias and applies the LeakyReLU.

#include <cuda_runtime.h>

#include "sgemm_tile.cuh"

namespace {

constexpr int BM = TILE_M, BN = TILE_N, BK = 8;
constexpr int THREADS = TILE_THREADS;
constexpr int LOADS = BM * BK / THREADS;  // A (and B) elements per thread per slice

enum AMode { A_CONV = 0, A_DW = 1 };

// Where this thread's LOADS elements of each K slice of the gathered A come
// from, kept incrementally so that the K loop does no integer division.
// A_CONV (A[(n, r), (dr, c)]): each element has its own fixed row (n, r);
// all share one column (dr, c) that advances by BK per slice.
// A_DW (A[(dr, c), (n, r)]): all share one fixed row (dr, c); each element
// has its own column (n, r) that advances by BK per slice.
template <int MODE>
struct AGather {
  int n[LOADS], r[LOADS];
  bool row_ok[LOADS];       // A_CONV: the element's row is inside A
  int dr, c;
  bool m_ok;                // A_DW: the shared row is inside A

  __device__ __forceinline__ AGather(int tid, int m0, int M, int R, int C) {
    if (MODE == A_CONV) {
      const int kl = tid % BK;
      dr = kl / C;
      c = kl - dr * C;
      m_ok = true;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int m = m0 + (tid + i * THREADS) / BK;
        row_ok[i] = m < M;
        n[i] = m / R;
        r[i] = m - n[i] * R;
      }
    } else {
      const int m = m0 + tid % BM;
      m_ok = m < M;
      dr = m / C;
      c = m - dr * C;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int k = (tid + i * THREADS) / BM;
        row_ok[i] = true;
        n[i] = k / R;
        r[i] = k - n[i] * R;
      }
    }
  }

  // element i of the current slice: zero outside A and in the SAME padding
  __device__ __forceinline__ float load(const float* __restrict__ x, int i, int R, int C,
                                        int n_batch) const {
    const bool inside = MODE == A_CONV ? (row_ok[i] && dr < 5) : (m_ok && n[i] < n_batch);
    const int rr = r[i] + dr - 2;
    if (!inside || rr < 0 || rr >= R) return 0.0f;
    return __ldg(x + ((long long)n[i] * R + rr) * C + c);
  }

  __device__ __forceinline__ void advance(int R, int C) {
    if (MODE == A_CONV) {
      c += BK;
      while (c >= C) { c -= C; ++dr; }
    } else {
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        r[i] += BK;
        while (r[i] >= R) { r[i] -= R; ++n[i]; }
      }
    }
  }
};

// Two blocks per SM: at most 128 registers a thread.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
conv5_gemm_kernel(const float* __restrict__ x, const float* __restrict__ bmat,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int M, int Nc, int K, int R, int C, float slope) {
  __shared__ __align__(16) float As[2][BK][TILE_LD];
  __shared__ __align__(16) float Bs[2][BK][TILE_LD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_batch = K / R;  // A_DW: the batch whose rows K counts

  AGather<MODE> ga(tid, m0, M, R, C);
  float a_reg[LOADS], b_reg[LOADS];
  auto fetch = [&](int k0) {  // the slice at k0 into registers
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      a_reg[i] = ga.load(x, i, R, C, n_batch);
      const int e = tid + i * THREADS;
      const int kb = k0 + e / BN, nb = n0 + e % BN;
      b_reg[i] = (kb < K && nb < Nc) ? __ldg(bmat + (long long)kb * Nc + nb) : 0.0f;
    }
    ga.advance(R, C);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * THREADS;
      if (MODE == A_CONV) As[buf][e % BK][e / BK] = a_reg[i];  // runs along k (= c)
      else As[buf][e / BM][e % BM] = a_reg[i];                 // runs along m (= c)
      Bs[buf][e / BN][e % BN] = b_reg[i];
    }
  };

  float acc[8][8];
  tile_zero(acc);

  const int n_slices = (K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < n_slices; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_slices) fetch((t + 1) * BK);
    tile_mma<BK>(As[cur], Bs[cur], acc, tx, ty);
    if (t + 1 < n_slices) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_row(tx, j);
      if (col >= Nc) continue;
      float v = acc[i][j] + (bias != nullptr ? __ldg(bias + col) : 0.0f);
      out[(long long)row * Nc + col] = v > 0.0f ? v : slope * v;
    }
  }
}

}  // namespace

// K5: y (N, R, C_out) = lrelu(conv5(x (N, R, C_in), w (5, C_in, C_out)) + bias).
// bias may be null (the dx launch); slope 1 makes the activation the identity.
extern "C" int qvc_conv5_lrelu(const void* x, const void* w, const void* bias,
                               void* y, int n, int rows, int c_in, int c_out,
                               float slope, void* stream) {
  const int M = n * rows, K = 5 * c_in;
  dim3 grid((c_out + BN - 1) / BN, (M + BM - 1) / BM);
  conv5_gemm_kernel<A_CONV><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y,
      M, c_out, K, rows, c_in, slope);
  return (int)cudaGetLastError();
}

// K6: dw (5, C_in, C_out) = sum over (n, r) of shifted x^T @ dym.
extern "C" int qvc_conv5_dw(const void* x, const void* dym, void* dw, int n,
                            int rows, int c_in, int c_out, void* stream) {
  const int M = 5 * c_in, K = n * rows;
  dim3 grid((c_out + BN - 1) / BN, (M + BM - 1) / BM);
  conv5_gemm_kernel<A_DW><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dym, nullptr, (float*)dw,
      M, c_out, K, rows, c_in, 1.0f);
  return (int)cudaGetLastError();
}
