// The body of kernels K2, K9 and K10 (see fused_attention.cu), shared with
// K8's layer (fused_transformer.cu), which runs it on the strided q/k/v
// column blocks of its qkv projection. Templated on the head dim D (16, 32,
// 64 or 128); every operand is addressed through a (batch, head, row) stride
// triple with unit stride along the head dim, so one body serves the packed
// (B, T, H*D) layout, heads padded to 128 lanes and the headed (B, H, T, D)
// layout. Included by several sources, so everything here has internal
// linkage.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
namespace attn {  // K2's tile sizes stay out of the including file's names

constexpr int BM = 64;       // query rows per block
constexpr int BN = 32;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr int SPT = BN / 4;  // scores per thread per key tile

// Strides in floats of one operand: batch item, head, row (time step).
struct Strides {
  long long b, h, t;
};

// Shared memory of one block: qs (BM, D+1), ks (BN, D+1), vs (BN, D), ps (BM, BN+1).
// At D = 128 that is 74,368 bytes, above the 48 KB a block gets without asking,
// so the tiles live in dynamic shared memory and launch() raises the limit.
template <int D>
constexpr int smem_bytes() {
  return (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1)) * (int)sizeof(float);
}

// Blocks an SM is asked to hold at once, which caps a thread's registers at
// 65536 / (256 * blocks). Left unasked, ptxas keeps 256-thread blocks to 64
// registers, as 4 blocks would ask: enough for D <= 64, but at D = 128 (32
// accumulators a thread) it spilled 24 bytes. The D = 128 tiles leave room
// for 3 blocks in shared memory, so that instantiation asks for 3 (up to 85
// registers); the others ask for the 4 they were built for.
template <int D>
constexpr int min_blocks() {
  return D == 128 ? 3 : 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale) {
  constexpr int OPT = D / 4;  // output columns per thread
  extern __shared__ float smem[];
  float(*qs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem);
  float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem + BM * (D + 1));
  float(*vs)[D] = reinterpret_cast<float(*)[D]>(smem + (BM + BN) * (D + 1));
  float(*ps)[BN + 1] = reinterpret_cast<float(*)[BN + 1]>(smem + (BM + BN) * (D + 1) + BN * D);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c0 = tid & 3;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int rr = i / D, d = i - rr * D;
    const int t = q0 + rr;
    qs[rr][d] = t < T ? qb[t * sq.t + d] : 0.0f;
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
      ks[rr][d] = t < T ? kb[t * sk.t + d] : 0.0f;
      vs[rr][d] = t < T ? vb[t * sv.t + d] : 0.0f;
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
    float* ob = o + b * so.b + h * so.h + t * so.t;
    const float inv = 1.0f / l_i;
#pragma unroll
    for (int i = 0; i < OPT; ++i) ob[c0 + 4 * i] = acc[i] * inv;
  }
}

// Launches attention_kernel<D> over (query tiles, H, batch) on the caller's
// stream, q/k/v read and o written through their stride triples; returns
// the launch's error.
template <int D>
inline cudaError_t launch(const float* q, const float* k, const float* v, float* o, int batch,
                          int T, int H, Strides sq, Strides sk, Strides sv, Strides so,
                          float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if constexpr (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((T + BM - 1) / BM, H, batch);
  attention_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, o, T, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

// launch<D> for a head dim known at run time; any D but 16, 32, 64 or 128
// is refused with cudaErrorInvalidValue before anything is launched.
inline cudaError_t launch_any(int D, const float* q, const float* k, const float* v, float* o,
                              int batch, int T, int H, Strides sq, Strides sk, Strides sv,
                              Strides so, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 32: return launch<32>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 64: return launch<64>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 128: return launch<128>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace
