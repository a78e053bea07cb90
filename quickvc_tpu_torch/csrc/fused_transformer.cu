// Kernel K8: one post-norm HuBERT transformer layer, float32, for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_transformer.py:
// fused_transformer_layer (pallas_call at fused_transformer.py:155; body
// _kernel at :63-117). With x (M = B*T, D) and torch's Linear weights
// (out, in):
//
//   qkv = x Win^T + bin
//   a   = per head h: softmax(q_h k_h^T * scale) v_h      (heads of 64)
//   x1  = LN1(x + a Wout^T + bout)
//   out = LN2(x1 + gelu(x1 W1^T + b1) W2^T + b2)            (LN eps 1e-5)
//
// What bounds it on this card: operations. At the encoding batch
// (16, 300, 768) the four products are 2 * 4800 * 768 * (2304 + 768 + 2 *
// 3072) = 68 GFLOP and the attention 4.4 GFLOP, against ~60 MB of weights
// and activations; in float32 the ceiling is the 67 TFLOP/s FMA rate.
//
// Design: the TPU kernel holds the whole layer in one grid step per batch
// item, every weight resident in VMEM; a block here has 227 KB of shared
// memory, less than one of the 2.4-9.4 MB weight matrices. So one call,
// qvc_transformer_layer, makes LAUNCHES = 7 launches on the caller's stream:
// four linear_kernel GEMMs on the 128 x 128 tile core of sgemm_tile.cuh
// (x W^T with W in torch's (out, in) layout: both operands are read
// k-contiguous, one float4 a thread per slice, rows past M or N clamped to
// the last and their results dropped) whose epilogues add the bias and then
// the residual or the exact erf GELU; K2's attention kernel
// (fused_attention.cuh) on the q/k/v column blocks of qkv, read in place
// through their row stride 3D; and row_layer_norm_kernel twice, a warp per
// row with the row in registers and the variance taken about the mean (two
// passes, as the TPU kernel's _layer_norm). The TPU kernel folds the
// out-projection into the per-head loop so that no (T, D) attention buffer
// exists; here the attention output goes through device memory once (15 MB
// at the encoding batch) and the out-projection is one GEMM. Every product
// is computed by this file's code; no cuBLAS.

#include <cuda_runtime.h>

#include "fused_attention.cuh"
#include "sgemm_tile.cuh"

namespace {

constexpr int LAUNCHES = 7;
constexpr int BK = 8;
constexpr int LN_ROWS = TILE_THREADS / 32;  // rows per layer-norm block, one warp each
constexpr int LN_PER_LANE = 32;             // D <= 32 * 32

enum Epilogue { BIAS = 0, BIAS_GELU = 1, BIAS_RESIDUAL = 2 };

// C (M, N) = epi(A (M, K) W (N, K)^T + bias), K % 8 == 0, N % 4 == 0.
// Two blocks per SM: at most 128 registers a thread.
template <int EPI>
__global__ void __launch_bounds__(TILE_THREADS, 2)
linear_kernel(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, const float* __restrict__ res,
              float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][TILE_LD];
  __shared__ __align__(16) float Bs[2][BK][TILE_LD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  // this thread loads k = kq .. kq + 3 of tile row lr of both operands
  const int lr = tid / 2, kq = (tid % 2) * 4;
  const float* a_src = A + (long long)min(m0 + lr, M - 1) * K + kq;
  const float* w_src = W + (long long)min(n0 + lr, N - 1) * K + kq;

  float4 a_reg = __ldg(reinterpret_cast<const float4*>(a_src));
  float4 w_reg = __ldg(reinterpret_cast<const float4*>(w_src));
  auto stash = [&](int buf) {
    As[buf][kq + 0][lr] = a_reg.x;
    As[buf][kq + 1][lr] = a_reg.y;
    As[buf][kq + 2][lr] = a_reg.z;
    As[buf][kq + 3][lr] = a_reg.w;
    Bs[buf][kq + 0][lr] = w_reg.x;
    Bs[buf][kq + 1][lr] = w_reg.y;
    Bs[buf][kq + 2][lr] = w_reg.z;
    Bs[buf][kq + 3][lr] = w_reg.w;
  };

  float acc[8][8];
  tile_zero(acc);
  const int n_slices = K / BK;
  stash(0);
  __syncthreads();
  for (int t = 0; t < n_slices; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_slices) {
      a_reg = __ldg(reinterpret_cast<const float4*>(a_src + (t + 1) * BK));
      w_reg = __ldg(reinterpret_cast<const float4*>(w_src + (t + 1) * BK));
    }
    tile_mma<BK>(As[cur], Bs[cur], acc, tx, ty);
    if (t + 1 < n_slices) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int jg = 0; jg < 8; jg += 4) {
      const int col = n0 + tile_row(tx, jg);
      if (col >= N) continue;  // N % 4 == 0: a float4 is all in or all out
      const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + col));
      float4 v = make_float4(acc[i][jg] + bb.x, acc[i][jg + 1] + bb.y, acc[i][jg + 2] + bb.z,
                             acc[i][jg + 3] + bb.w);
      if (EPI == BIAS_GELU) {
        v = make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z), gelu_erf(v.w));
      } else if (EPI == BIAS_RESIDUAL) {
        const float4 rr = __ldg(reinterpret_cast<const float4*>(res + (long long)row * N + col));
        v = make_float4(v.x + rr.x, v.y + rr.y, v.z + rr.z, v.w + rr.w);
      }
      *reinterpret_cast<float4*>(C + (long long)row * N + col) = v;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y (M, D) = (x - mean) / sqrt(var + eps) * g + b over each row, D <= 1024.
__global__ void __launch_bounds__(TILE_THREADS)
row_layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ b, float* __restrict__ y, int M, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const float* xr = x + (long long)row * D;
  float v[LN_PER_LANE];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? xr[c] : 0.0f;
    s += v[i];
  }
  const float mean = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_PER_LANE; ++i) {
    const float d = lane + 32 * i < D ? v[i] - mean : 0.0f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
  float* yr = y + (long long)row * D;
#pragma unroll
  for (int i = 0; i < LN_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < D) yr[c] = (v[i] - mean) * rstd * __ldg(g + c) + __ldg(b + c);
  }
}

template <int EPI>
cudaError_t linear(const float* A, const float* W, const float* bias, const float* res,
                   float* C, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + TILE_N - 1) / TILE_N, (M + TILE_M - 1) / TILE_M);
  linear_kernel<EPI><<<grid, TILE_THREADS, 0, stream>>>(A, W, bias, res, C, M, N, K);
  return cudaGetLastError();
}

cudaError_t layer_norm(const float* x, const float* g, const float* b, float* y, int M, int D,
                       cudaStream_t stream) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  row_layer_norm_kernel<<<blocks, TILE_THREADS, 0, stream>>>(x, g, b, y, M, D, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qvc_transformer_layer_launches() { return LAUNCHES; }

// out (B, T, D) from x (B, T, D) and the layer's weights in torch's layout
// (in_proj (3D, D), out_proj (D, D), linear1 (F, D), linear2 (D, F)); the
// caller allocates the scratch qkv (B*T, 3D), heads (the attention
// output), sum and x1 (B*T, D) and mid (B*T, F). Needs D = H * 64 <= 1024
// and F % 8 == 0.
extern "C" int qvc_transformer_layer(
    const void* x, const void* w_in, const void* b_in, const void* w_out, const void* b_out,
    const void* ln1_g, const void* ln1_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* ln2_g, const void* ln2_b, void* qkv, void* heads, void* sum,
    void* x1, void* mid, void* out, int batch, int T, int D, int H, int F, float scale,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int M = batch * T;
  const float* xf = (const float*)x;
  float* qkv_f = (float*)qkv;
  float* heads_f = (float*)heads;
  float* sum_f = (float*)sum;
  float* x1_f = (float*)x1;
  float* mid_f = (float*)mid;
  cudaError_t err;
  if ((err = linear<BIAS>(xf, (const float*)w_in, (const float*)b_in, nullptr, qkv_f, M, 3 * D,
                          D, s)))
    return (int)err;
  constexpr int HD = 64;  // head dim
  const attn::Strides qkv_s{(long long)T * 3 * D, HD, 3 * D};
  const attn::Strides heads_s{(long long)T * D, HD, D};
  if ((err = attn::launch<HD>(qkv_f, qkv_f + D, qkv_f + 2 * D, heads_f, batch, T, H, qkv_s,
                              qkv_s, qkv_s, heads_s, scale, s)))
    return (int)err;
  if ((err = linear<BIAS_RESIDUAL>(heads_f, (const float*)w_out, (const float*)b_out, xf, sum_f,
                                   M, D, D, s)))
    return (int)err;
  if ((err = layer_norm(sum_f, (const float*)ln1_g, (const float*)ln1_b, x1_f, M, D, s)))
    return (int)err;
  if ((err = linear<BIAS_GELU>(x1_f, (const float*)w1, (const float*)b1, nullptr, mid_f, M, F, D,
                               s)))
    return (int)err;
  if ((err = linear<BIAS_RESIDUAL>(mid_f, (const float*)w2, (const float*)b2, x1_f, sum_f, M, D,
                                   F, s)))
    return (int)err;
  return (int)layer_norm(sum_f, (const float*)ln2_g, (const float*)ln2_b, (float*)out, M, D, s);
}
