// The bf16 body of kernel K2 (see fused_attention.cu): multi-head attention
// on bfloat16 q/k/v with float32 scores and accumulation, for sm_90a. K9
// and K10 run it in their bf16 modes, K8's bf16 layer on its qkv columns.
// Included by fused_attention.cu and fused_transformer.cu; everything here
// has internal linkage.
//
// Replaces the bf16 mode of the TPU kernel quickvc_tpu/ops/fused_attention.py
// fused_attention_packed (pallas_call at :113, body _packed_kernel :58-85):
// for bf16 inputs _prec() leaves the MXU one bf16 pass with float32 results,
// so per head s = q k^T * scale in float32, padded keys masked, p =
// softmax(s) in float32, o = p.astype(bf16) @ v with float32 accumulation,
// o stored in bf16.
//
// What bounds it on this card: bytes. Per (batch, head) it moves 4*T*D bf16
// values (8*T*D bytes) and does 4*T*T*D flops; at the conversion's HuBERT
// shape (8, 250, 12*64) that is 12.3 MB at 3.35 TB/s = 0.0037 ms against
// 1.54 GFLOP at the 989 TFLOP/s dense bf16 rate = 0.0016 ms. At such sizes
// the launch and one pass over the key tiles per query tile are the cost.
//
// Design: the flash-attention-2 layout of the float32 body
// (fused_attention.cuh) on one bf16 tensor-core pass instead of three TF32
// ones:
// - mma.sync.m16n8k16 bf16 with float32 accumulation. A block is 4 warps
//   and 64 query rows, 16 a warp; the warp's q rows go straight from global
//   memory into A fragments (pairs of bf16 in a 32-bit register), once.
// - K and V tiles of 64 keys are double-buffered in shared memory with
//   cp.async 16-byte copies of 8 bf16 (plain loads where a pointer or stride
//   is not a multiple of 8 values). Shared rows are padded to D + 8 values,
//   so the 8 rows an ldmatrix phase reads land on 32 distinct banks. Rows
//   past T are zero-filled.
// - K's B fragments come from shared memory through ldmatrix.x4 (two 8-key
//   tiles a call); V's through ldmatrix.x4.trans (the keys run down the k
//   slots of a fragment, so V is read transposed).
// - The online softmax (running max and sum in float32, in log2 units) runs
//   in registers as in the float32 body; keys past T are masked to -inf.
// - P feeds the PV product without a shuffle: for m16n8k16 the C fragments
//   of score tiles 2kk and 2kk+1 hold keys 16kk + 2t, 2t+1 and 16kk + 8 +
//   2t, 2t+1 of rows g and g + 8, exactly the A fragment of key chunk kk.
//   P is rounded to bf16 there; the row sums keep the float32 values.
// - The output is divided by the row sum and rounded to bf16 once, at the
//   end.
//
// What "the same function" means: the Pallas body normalises p before it
// rounds it to bf16; this body rounds the unnormalised exp(s - m) of each
// tile and divides at the end. The two differ by bf16 rounding of p, which
// tests/test_torch_attention_bf16.py models in numpy against float64
// attention. wgmma and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_gemm.cuh"  // the bf16 fragment helpers
#include "tf32x3.cuh"     // the cp.async copies

namespace {
namespace attn_bf16 {

// the fragment helpers, shared with the bf16 GEMM core
using bf16core::bf16_t;
using bf16core::ldmatrix_x4;
using bf16core::ldmatrix_x4_trans;
using bf16core::mma_bf16;
using bf16core::pack_bf16;

constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // query rows per block
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 64;          // keys per tile
constexpr int MIN_BLOCKS = 2;

// padded shared row in bf16 values: 16 bytes of padding keep rows 16-byte
// aligned for cp.async and ldmatrix and spread 8 rows over all 32 banks
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

// K and V, two buffers each of BN x (D + 8) bf16: 36 KB at D = 64
template <int D>
constexpr int smem_bytes() {
  return 4 * BN * ld<D>() * (int)sizeof(bf16_t);
}

// Strides in bf16 values of one operand: batch item, head, row (time step).
struct Strides {
  long long b, h, t;
};

// values (r, c) and (r, c + 1) of a row-major operand as one A-fragment
// register; zero past T
__device__ __forceinline__ unsigned load_pair(const bf16_t* p, int r, int c, int T,
                                              long long ts) {
  if (r >= T) return 0u;
  const bf16_t* x = p + r * ts + c;
  return (unsigned)x[0] | ((unsigned)x[1] << 16);
}

// Rows [n0, n0 + BN) of one operand (row stride ts) into a padded shared
// tile; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16_t* dst, const bf16_t* src, long long ts, int n0,
                                          int T, bool vec) {
  constexpr int LD = ld<D>();
  if (vec) {
    constexpr int CPR = D / 8;  // 16-byte chunks a row
    static_assert(BN * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int u = 0; u < BN * CPR / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / CPR, c = 8 * (i - r * CPR);
      const bool ok = n0 + r < T;
      cp_async16(reinterpret_cast<float*>(dst + r * LD + c),
                 reinterpret_cast<const float*>(ok ? src + (n0 + r) * ts + c : src), ok);
    }
  } else {
    static_assert(BN * D % THREADS == 0, "whole values a thread");
#pragma unroll 8
    for (int u = 0; u < BN * D / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / D, c = i - r * D;
      dst[r * LD + c] = n0 + r < T ? src[(n0 + r) * ts + c] : (bf16_t)0;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attention_bf16_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                      const bf16_t* __restrict__ v, bf16_t* __restrict__ o, int T, Strides sq,
                      Strides sk, Strides sv, Strides so, float scale, bool vec) {
  constexpr int LD = ld<D>();
  constexpr int KC = D / 16;  // 16-wide chunks of the head dim (the k of S = q k^T)
  constexpr int NT = BN / 8;  // 8-key score tiles
  constexpr int DN = D / 8;   // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char attn_bf16_smem[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(attn_bf16_smem);  // K tiles, two buffers
  bf16_t* vs = ks + 2 * BN * LD;                           // V tiles, two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and lane in the quad
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16_t* kb = k + b * sk.b + h * sk.h;
  const bf16_t* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T + BN - 1) / BN;

  load_tile<D>(ks, kb, sk.t, 0, T, vec);
  load_tile<D>(vs, vb, sv.t, 0, T, vec);
  cp_async_commit();

  // this warp's rows r0 and r0 + 8 of q as A fragments: a0 (r0, c..c+1),
  // a1 (r0 + 8, c..c+1), a2 (r0, c+8..c+9), a3 (r0 + 8, c+8..c+9), c = 16 kc + 2 t4
  const int r0 = blockIdx.x * BM + warp * 16 + g;
  const bf16_t* qb = q + b * sq.b + h * sq.h;
  unsigned qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = 16 * kc + 2 * t4;
    qf[kc][0] = load_pair(qb, r0, c, T, sq.t);
    qf[kc][1] = load_pair(qb, r0 + 8, c, T, sq.t);
    qf[kc][2] = load_pair(qb, r0, c + 8, T, sq.t);
    qf[kc][3] = load_pair(qb, r0 + 8, c + 8, T, sq.t);
  }

  // ldmatrix row addresses of this lane: matrix m = lane / 8, row lane % 8.
  // K (two score tiles a call): key 8 (m / 2) + row of the tile pair, head
  // columns 8 (m % 2) of the k chunk. V (transposed, two output tiles a
  // call): key 8 (m % 2) + row of the key chunk, columns 8 (m / 2).
  const int lm = lane >> 3, lr = lane & 7;
  const int k_off = (8 * (lm >> 1) + lr) * LD + 8 * (lm & 1);
  const int v_off = (8 * (lm & 1) + lr) * LD + 8 * (lm >> 1);
  const unsigned ks_addr = (unsigned)__cvta_generic_to_shared(ks);
  const unsigned vs_addr = (unsigned)__cvta_generic_to_shared(vs);

  // O's C fragments: rows r0 / r0 + 8, columns 8 dn + 2 t4 + {0, 1}
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max (log2 units)
  float l0 = 0.0f, l1 = 0.0f;                    // this lane's part of the running sum
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<D>(ks + (buf ^ 1) * BN * LD, kb, sk.t, (it + 1) * BN, T, vec);
      load_tile<D>(vs + (buf ^ 1) * BN * LD, vb, sv.t, (it + 1) * BN, T, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    const unsigned kt = ks_addr + 2 * (buf * BN * LD + k_off);
    const unsigned vt = vs_addr + 2 * (buf * BN * LD + v_off);

    // S = q k^T: s[j] holds rows r0 / r0 + 8, keys 8 j + 2 t4 + {0, 1}
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned bk[4];
        ldmatrix_x4(bk, kt + 2 * (16 * jp * LD + 16 * kc));
        mma_bf16(s[2 * jp], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // mask keys past T, scale into log2 units, online softmax per row
    const int n0 = it * BN;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = n0 + 8 * j + 2 * t4 + e < T;
        s[j][e] = ok ? s[j][e] * sl2 : -CUDART_INF_F;
        s[j][2 + e] = ok ? s[j][2 + e] * sl2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        ls0 += s[j][e];
        ls1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // O += P V over the key chunks of 16: P's A fragment is the C fragments
    // of score tiles 2 kk and 2 kk + 1, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + 2 * (16 * kk * LD + 16 * dp));
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  bf16_t* ob = o + b * so.b + h * so.h + 2 * t4;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    if (r0 < T)
      *reinterpret_cast<unsigned*>(ob + r0 * so.t + 8 * dn) =
          pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (r0 + 8 < T)
      *reinterpret_cast<unsigned*>(ob + (r0 + 8) * so.t + 8 * dn) =
          pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

inline bool aligned16(const bf16_t* p, Strides s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.t % 8 == 0;
}

// Launches attention_bf16_kernel<D> over (query tiles, H, batch) on the
// caller's stream; returns the launch's error. q is read one value at a
// time, so it takes any alignment and strides; o and its strides must be
// 4-byte aligned (the caller's output is a fresh (.., D) buffer with even D).
template <int D>
inline cudaError_t launch(const bf16_t* q, const bf16_t* k, const bf16_t* v, bf16_t* o,
                          int batch, int T, int H, Strides sq, Strides sk, Strides sv,
                          Strides so, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if constexpr (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const bool vec = aligned16(k, sk) && aligned16(v, sv);
  dim3 grid((T + BM - 1) / BM, H, batch);
  attention_bf16_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, o, T, sq, sk, sv, so,
                                                             scale, vec);
  return cudaGetLastError();
}

// launch<D> for a head dim known at run time; any D but 16, 32, 64 or 128
// is refused with cudaErrorInvalidValue before anything is launched.
inline cudaError_t launch_any(int D, const bf16_t* q, const bf16_t* k, const bf16_t* v,
                              bf16_t* o, int batch, int T, int H, Strides sq, Strides sk,
                              Strides sv, Strides so, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 32: return launch<32>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 64: return launch<64>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 128: return launch<128>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn_bf16
}  // namespace
