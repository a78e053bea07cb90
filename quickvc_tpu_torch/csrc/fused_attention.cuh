// The body of kernels K2, K9 and K10 (see fused_attention.cu), shared with
// K8's layer (fused_transformer.cu), which runs it on the strided q/k/v
// column blocks of its qkv projection. Templated on the head dim D (16, 32,
// 64 or 128); every operand is addressed through a (batch, head, row) stride
// triple with unit stride along the head dim, so one body serves the packed
// (B, T, H*D) layout, heads padded to 128 lanes and the headed (B, H, T, D)
// layout. Included by several sources, so everything here has internal
// linkage.
//
// Replaces the bodies of the TPU kernels quickvc_tpu/ops/fused_attention.py
// _packed_kernel (:58-85, K2), _packed_kernel_aligned (:137-161, K9) and
// _attn_kernel (:39-55, K10), which compute softmax(q k^T * scale) v per
// head at Precision.HIGHEST.
//
// What bounds it: operations, 4*T*T*D flops per (batch, head) against 4*T*D
// floats moved. Float32-accurate products on tensor cores take three TF32
// products each (below), so the least time is 3 * flops at the dense TF32
// rate (495 TFLOP/s on an H100 SXM): 2.4x less than flops at the 67
// TFLOP/s of the float32 FMA units. Single-pass TF32 would round q, k, p and v to 10
// mantissa bits; that is not float32 attention.
//
// Design (the flash-attention-2 layout on mma.sync):
// - 3xTF32 (the helpers in tf32x3.cuh): each float32 operand x is split
//   into big, x rounded to TF32 as cvt.rna.tf32.f32 rounds (done as an
//   integer add and mask: cvt.rna itself compiles to a compare-and-select
//   sequence on sm_90a, which cost more than the tensor-core work here),
//   and small = x - big, exact in
//   float32, of which the tensor core reads the top 10 mantissa bits. A
//   product is small*big + big*small, then big*big, on mma.sync.m16n8k8
//   tf32 with float32 accumulation: about 2^-21 relative a product, against
//   2^-11 for one TF32 pass, as JAX's multi-pass HIGHEST does on the MXU.
// - A block is 4 warps and 64 query rows; each warp owns 16 rows. The
//   warp's q rows go straight from global memory into A fragments, once.
// - K and V tiles (64 keys, 16 at D = 128, where the O accumulator and the
//   q fragments take 64 registers a lane each) are double-buffered in
//   shared memory with cp.async: 16-byte copies when k and v and all their
//   strides are multiples of 4 floats, 4-byte copies otherwise (K10 takes
//   any strides). Shared rows are padded to D + 4 floats, so the fragment
//   loads of a warp hit 32 distinct banks. Rows past T are zero-filled
//   (src-size 0).
// - Scores stay in registers. The online softmax keeps a running max and
//   sum in float32 per row; a row's four lanes (a quad) reduce the max with
//   two shuffles, and each lane's partial sum is reduced once at the end.
//   Keys past T are masked to -inf before the max; key 0 is in tile 0, so
//   the max is finite from the first tile on.
// - P feeds the PV product without leaving registers: the score C fragment
//   holds keys 2t and 2t+1 of each 8-key chunk in lane t of a quad, where
//   the A fragment wants keys t and t+4. A product is a sum over keys in any
//   order, so the body relabels the k slots (key 2t -> slot t, key 2t+1 ->
//   slot t+4) and reads V's B fragment with the same relabelling: no
//   shuffle and no shared-memory round trip.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "tf32x3.cuh"

namespace {
namespace attn {  // the body's tile sizes stay out of the including file's names

constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;        // query rows per block
constexpr int THREADS = 32 * WARPS;

// keys per tile: 64, and 16 at D = 128, where 32 spilled 40 bytes at 255
// registers
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D == 128 ? 16 : 64;
}

// padded shared row: 4 floats keep 16-byte alignment and spread a warp's
// fragment loads over all 32 banks
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 4;
}

// Strides in floats of one operand: batch item, head, row (time step).
struct Strides {
  long long b, h, t;
};

// Shared memory of one block: K and V, two buffers each of key_tile x (D+4)
// floats: 68 KB at D = 64, above the 48 KB a block gets without asking, so
// the tiles live in dynamic shared memory and launch() raises the limit
// where needed.
template <int D>
constexpr int smem_bytes() {
  return 4 * key_tile<D>() * ld<D>() * (int)sizeof(float);
}

// Blocks an SM is asked to hold at once, which caps a thread's registers at
// 65536 / (128 * 2) = 255, the most a thread can have. Asking for 3 (170
// registers) spilled the D = 64 body and made it slower.
constexpr int MIN_BLOCKS = 2;

// Rows [n0, n0 + key_tile) of one operand (row stride ts) into a padded
// shared tile; rows past T are zero-filled and read nothing.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ts, int n0,
                                          int T, bool vec) {
  constexpr int BN = key_tile<D>(), LD = ld<D>();
  if (vec) {
    constexpr int CPR = D / 4;  // 16-byte chunks a row
    static_assert(BN * CPR % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int u = 0; u < BN * CPR / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / CPR, c = 4 * (i - r * CPR);
      const bool ok = n0 + r < T;
      cp_async16(dst + r * LD + c, ok ? src + (n0 + r) * ts + c : src, ok);
    }
  } else {
    static_assert(BN * D % THREADS == 0, "whole floats a thread");
#pragma unroll 8
    for (int u = 0; u < BN * D / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / D, c = i - r * D;
      const bool ok = n0 + r < T;
      cp_async4(dst + r * LD + c, ok ? src + (n0 + r) * ts + c : src, ok);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale, bool vec) {
  constexpr int BN = key_tile<D>(), LD = ld<D>();
  constexpr int KC = D / 8;   // 8-wide chunks of the head dim
  constexpr int NT = BN / 8;  // 8-key chunks of a tile
  extern __shared__ __align__(16) float attn_smem[];
  float* ks = attn_smem;                // K tiles, two buffers
  float* vs = attn_smem + 2 * BN * LD;  // V tiles, two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group and lane in the quad
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (T + BN - 1) / BN;

  load_tile<D>(ks, kb, sk.t, 0, T, vec);
  load_tile<D>(vs, vb, sv.t, 0, T, vec);
  cp_async_commit();

  // this warp's rows r0 and r0 + 8 of q as A fragments: a0 (r0, c), a1
  // (r0 + 8, c), a2 (r0, c + 4), a3 (r0 + 8, c + 4), c = 8 kc + t4
  const int r0 = blockIdx.x * BM + warp * 16 + g;
  const float* qb = q + b * sq.b + h * sq.h;
  float qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = 8 * kc + t4;
    qf[kc][0] = r0 < T ? qb[r0 * sq.t + c] : 0.0f;
    qf[kc][1] = r0 + 8 < T ? qb[(r0 + 8) * sq.t + c] : 0.0f;
    qf[kc][2] = r0 < T ? qb[r0 * sq.t + c + 4] : 0.0f;
    qf[kc][3] = r0 + 8 < T ? qb[(r0 + 8) * sq.t + c + 4] : 0.0f;
  }

  // O's C fragments: rows r0 / r0 + 8, columns 8 dn + 2 t4 + {0, 1}
  float acc[KC][4];
#pragma unroll
  for (int dn = 0; dn < KC; ++dn)
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
    const float* kt = ks + buf * BN * LD;
    const float* vt = vs + buf * BN * LD;

    // S = q k^T: s[j] holds rows r0 / r0 + 8, keys 8 j + 2 t4 + {0, 1}
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned qbig[4], qsmall[4];
      split_a(qf[kc], qbig, qsmall);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = kt + (8 * j + g) * LD + 8 * kc + t4;  // B[d][key] = K[key][d]
        mma_3xtf32(s[j], qbig, qsmall, kr[0], kr[4]);
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
    for (int dn = 0; dn < KC; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // O += P V. The A fragment of key chunk j is its C fragment with the k
    // slots relabelled: slot t4 <- key 2 t4, slot t4 + 4 <- key 2 t4 + 1;
    // V's B fragment reads the same keys: b0 = V[2 t4][col], b1 = V[2 t4 + 1][col].
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      unsigned pbig[4], psmall[4];
      split_a(pa, pbig, psmall);
#pragma unroll
      for (int dn = 0; dn < KC; ++dn) {
        const float* vr = vt + (8 * j + 2 * t4) * LD + 8 * dn + g;
        mma_3xtf32(acc[dn], pbig, psmall, vr[0], vr[LD]);
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
  float* ob = o + b * so.b + h * so.h + 2 * t4;
#pragma unroll
  for (int dn = 0; dn < KC; ++dn) {
    if (r0 < T)
      *reinterpret_cast<float2*>(ob + r0 * so.t + 8 * dn) =
          make_float2(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (r0 + 8 < T)
      *reinterpret_cast<float2*>(ob + (r0 + 8) * so.t + 8 * dn) =
          make_float2(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

inline bool aligned16(const float* p, Strides s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.t % 4 == 0;
}

// Launches attention_kernel<D> over (query tiles, H, batch) on the caller's
// stream, q/k/v read and o written through their stride triples; returns
// the launch's error. o and its strides must be 8-byte aligned (every
// caller's output is a fresh (.., D) buffer with even D).
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
  const bool vec = aligned16(k, sk) && aligned16(v, sv);
  dim3 grid((T + BM - 1) / BM, H, batch);
  attention_kernel<D><<<grid, THREADS, bytes, stream>>>(q, k, v, o, T, sq, sk, sv, so, scale,
                                                        vec);
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
