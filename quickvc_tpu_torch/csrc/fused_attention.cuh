// The body of kernel K2 (see fused_attention.cu), shared with K8's layer
// (fused_transformer.cu), which runs it on the strided q/k/v column blocks
// of its qkv projection. Included by several sources, so everything here
// has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
namespace attn {  // K2's tile sizes stay out of the including file's names

constexpr int D = 64;        // head dim
constexpr int BM = 64;       // query rows per block
constexpr int BN = 32;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr int SPT = BN / 4;  // scores per thread per key tile
constexpr int OPT = D / 4;   // output columns per thread

__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T,
                 int H, long long q_bs, long long q_ts, long long k_bs,
                 long long k_ts, long long v_bs, long long v_ts, float scale) {
  __shared__ float qs[BM][D + 1];
  __shared__ float ks[BN][D + 1];
  __shared__ float vs[BN][D];
  __shared__ float ps[BM][BN + 1];

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c0 = tid & 3;
  const float* qb = q + b * q_bs + h * D;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int rr = i / D, d = i - rr * D;
    const int t = q0 + rr;
    qs[rr][d] = t < T ? qb[t * q_ts + d] : 0.0f;
  }

  float m_i = -CUDART_INF_F, l_i = 0.0f;
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.0f;

  for (int n0 = 0; n0 < T; n0 += BN) {
    __syncthreads();  // previous tile fully consumed (and qs staged)
    for (int i = tid; i < BN * D; i += THREADS) {
      const int rr = i / D, d = i - rr * D;
      const int t = n0 + rr;
      ks[rr][d] = t < T ? kb[t * k_ts + d] : 0.0f;
      vs[rr][d] = t < T ? vb[t * v_ts + d] : 0.0f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r][d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[j] = fmaf(qv, ks[c0 + 4 * j][d], s[j]);
    }
    float m_loc = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      s[j] = (n0 + c0 + 4 * j < T) ? s[j] * scale : -CUDART_INF_F;
      m_loc = fmaxf(m_loc, s[j]);
    }
    m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
    m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 2));
    // the first tile always holds key 0, so m_new is finite from then on
    const float m_new = fmaxf(m_i, m_loc);
    const float alpha = expf(m_i - m_new);
    float l_loc = 0.0f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r][c0 + 4 * j] = p;
      l_loc += p;
    }
    l_loc += __shfl_xor_sync(0xffffffffu, l_loc, 1);
    l_loc += __shfl_xor_sync(0xffffffffu, l_loc, 2);
    l_i = l_i * alpha + l_loc;
    m_i = m_new;
    __syncwarp();  // row r's probabilities come from its own warp
#pragma unroll
    for (int i = 0; i < OPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BN; ++c) {
      const float p = ps[r][c];
#pragma unroll
      for (int i = 0; i < OPT; ++i) acc[i] = fmaf(p, vs[c][c0 + 4 * i], acc[i]);
    }
  }

  const int t = q0 + r;
  if (t < T) {
    float* ob = o + ((long long)b * T + t) * (H * D) + h * D;
    const float inv = 1.0f / l_i;
#pragma unroll
    for (int i = 0; i < OPT; ++i) ob[c0 + 4 * i] = acc[i] * inv;
  }
}

// Launches attention_kernel on the strided q/k/v rows (row strides q_ts,
// k_ts, v_ts; batch strides q_bs, k_bs, v_bs) into the packed (B, T, H*64)
// output o; returns the launch's error.
inline cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                          int batch, int T, int H, long long q_bs, long long q_ts,
                          long long k_bs, long long k_ts, long long v_bs, long long v_ts,
                          float scale, cudaStream_t stream) {
  dim3 grid((T + BM - 1) / BM, H, batch);
  attention_kernel<<<grid, THREADS, 0, stream>>>(q, k, v, o, T, H, q_bs, q_ts, k_bs, k_ts,
                                                 v_bs, v_ts, scale);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace

