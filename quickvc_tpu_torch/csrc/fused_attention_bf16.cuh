// The bf16 body of kernel K2 (see fused_attention.cu): multi-head attention
// on bfloat16 q/k/v with float32 scores and accumulation, for sm_90a. K9
// and K10 run it in their bf16 modes, K8's bf16 layer on its qkv columns.
// Included by fused_attention.cu and fused_transformer.cu; everything here
// has internal linkage.
//
// Replaces the bf16 mode of the TPU kernel quickvc_tpu/ops/fused_attention.py
// fused_attention_packed (pallas_call at :113, body _packed_kernel :58-85),
// and of fused_attention_packed_aligned (:194) and fused_attention (:231):
// for bf16 inputs _prec() leaves the MXU one bf16 pass with float32 results,
// so per head s = q k^T * scale in float32, padded keys masked, p =
// softmax(s) in float32, o = p.astype(bf16) @ v with float32 accumulation,
// o stored in bf16.
//
// What bounds it on this card: bytes. Per (batch, head) it moves 4*T*D bf16
// values (8*T*D bytes) and does 4*T*T*D flops; at the conversion's HuBERT
// shape (8, 250, 12*64) that is 12.3 MB at 3.35 TB/s = 0.0037 ms against
// 1.54 GFLOP at the 989 TFLOP/s dense bf16 rate = 0.0016 ms. At such sizes
// the grid's waves, the first tile's load and one pass over the key tiles
// per query tile are the cost.
//
// Two bodies, one arithmetic (the flash-attention-2 recurrence of the
// float32 body, fused_attention.cuh, on one bf16 tensor-core pass):
//
// attention_wgmma_kernel (D = 64 and 128, q/k/v 16-byte aligned with strides
// of whole 16-byte chunks; ops/fused_attention.py:bf16_attention_plan picks
// its configuration, Cfg below):
// - A CTA takes 64 C query rows of one (batch, head): C consumer warpgroups
//   of 64 rows each, and one producer warp after them.
// - The producer's lane 0 loads the CTA's Q tile and the K and V tiles of
//   BN keys by TMA (cp.async.bulk.tensor, 4-D tensor maps of the strided
//   (batch, head, row, lane) views, 128-byte swizzle, boxes of 64 lanes) into
//   a ring of STAGES stages, K and V each on their own "full" mbarrier; a
//   stage comes back on its "empty" mbarrier once every consumer warpgroup
//   is done with it. The first K/V stages are issued with Q, before any
//   consumer waits. Rows past T arrive as zeros (TMA's fill). No
//   __syncthreads is left in the key loop.
// - Each consumer warpgroup: S (64 x BN) = Q K^T as wgmma.mma_async
//   m64nBNk16, Q and K both K-major from descriptors (one instruction reads
//   a K tile once for all 64 rows); the online softmax on the accumulator
//   fragments (running max and sum in float32, log2 units, keys past T at
//   -inf); P rounded to bf16 stays in registers as the A operand of O (64 x
//   D) += P V, wgmma m64nDk16 with V the B operand read MN-major (the
//   transpose-B immediate). For m64nN the C fragments of score columns 16kk
//   .. 16kk + 15 are exactly the A fragment of key chunk kk, so P needs no
//   shuffle.
// - The accumulators are fenced (fence_operands) around each wgmma chain,
//   as K11 and the GEMM core do.
// - At D = 128 one warpgroup's O is 64 of a thread's registers: the
//   compiled configuration is one warpgroup, 32-key tiles, three stages
//   (64 KB: three CTAs an SM); at D = 64 one or two warpgroups, 64-key
//   tiles, two stages.
//
// attention_bf16_kernel, the first mma.sync body, serves D = 16 and 32
// (wgmma's 128-byte swizzled K-major operands want 64 lanes) and views TMA
// does not take: a block of 4 warps and 64 query rows, q straight from
// global memory into mma.sync.m16n8k16 A fragments, K and V tiles of 64
// keys double-buffered in shared memory with cp.async 16-byte copies (plain
// loads where a pointer or stride is not a multiple of 8 values), ldmatrix
// (.trans for V), P from the score fragments without a shuffle.
//
// What "the same function" means: the Pallas body normalises p before it
// rounds it to bf16; both bodies round the unnormalised exp(s - m) of each
// key tile and divide at the end. The two differ by bf16 rounding of p,
// which tests/test_torch_attention_bf16.py models in numpy, tile by tile as
// the plan cuts them, against float64 attention.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_gemm.cuh"  // the bf16 fragment helpers
#include "tf32x3.cuh"     // the cp.async copies
#include "tma_wgmma.cuh"  // mbarriers, TMA, wgmma and tensor maps

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

// ---- the TMA + wgmma body --------------------------------------------------------

// The compiled configurations: head dim D, C consumer warpgroups (64 C query
// rows a CTA), BN keys a tile, STAGES ring stages, and the CTAs an SM the
// launch bounds leave registers for (ops/fused_attention.py:WGMMA_CONFIGS).
template <int D, int C>
struct Cfg;
template <>
struct Cfg<64, 1> {
  static constexpr int BN = 64, STAGES = 2, MIN_BLOCKS = 3;
};
template <>
struct Cfg<64, 2> {
  static constexpr int BN = 64, STAGES = 2, MIN_BLOCKS = 2;
};
template <>
struct Cfg<128, 1> {
  static constexpr int BN = 32, STAGES = 3, MIN_BLOCKS = 3;
};

template <int D, int C>
struct Wg {
  static constexpr int BN = Cfg<D, C>::BN, STAGES = Cfg<D, C>::STAGES;
  static constexpr int ROWS = 64 * C;
  static constexpr int THREADS = 128 * C + 32;       // consumers, then the producer warp
  static constexpr int ATOMS = D / 64;               // 64-lane (128-byte) column atoms
  static constexpr int Q_ATOM = ROWS * 128, KV_ATOM = BN * 128;   // bytes
  static constexpr int Q_BYTES = ATOMS * Q_ATOM, KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
};

// One operand's 4-D tensor map is (lane, then the three of row, head and
// batch in the order of their strides, smallest first); pos says where row,
// head and batch sit in it (1 .. 3).
struct Dims {
  int t, h, b;
};

template <int D, int C>
__global__ void __launch_bounds__(Wg<D, C>::THREADS, Cfg<D, C>::MIN_BLOCKS)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16_t* __restrict__ o,
                       int T, Dims pos, Strides so, float scale) {
  using namespace tmawg;
  using W = Wg<D, C>;
  constexpr int BN = W::BN, STAGES = W::STAGES;
  extern __shared__ uint8_t attn_wg_smem[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
  // 128-byte swizzle wants each atom on a 1024-byte boundary
  uint8_t* smem = attn_wg_smem + ((1024 - (smem_u32(attn_wg_smem) & 1023)) & 1023);
  uint8_t* sq = smem;                              // [ATOMS][ROWS][128 bytes]
  uint8_t* sk = sq + W::Q_BYTES;                   // [STAGES][ATOMS][BN][128 bytes]
  uint8_t* sv = sk + STAGES * W::KV_BYTES;         // the same for V

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * W::ROWS;
  const int n_tiles = (T + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], C);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C) {
    // the producer: Q once, then K and V stage by stage
    if (lane == 0) {
      auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int atom, int row) {
        int c[4];
        c[0] = 64 * atom;
        c[pos.t] = row;
        c[pos.h] = h;
        c[pos.b] = b;
        tma_load_4d(dst, map, bar, c[0], c[1], c[2], c[3]);
      };
      mbar_expect_tx(&q_full, W::Q_BYTES);
      for (int a = 0; a < W::ATOMS; ++a) load(sq + a * W::Q_ATOM, &map_q, &q_full, a, q0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], W::KV_BYTES);
        for (int a = 0; a < W::ATOMS; ++a)
          load(sk + s * W::KV_BYTES + a * W::KV_ATOM, &map_k, &k_full[s], a, it * BN);
        mbar_expect_tx(&v_full[s], W::KV_BYTES);
        for (int a = 0; a < W::ATOMS; ++a)
          load(sv + s * W::KV_BYTES + a * W::KV_ATOM, &map_v, &v_full[s], a, it * BN);
      }
    }
    return;
  }

  // consumer warpgroup c: rows [64 c, 64 c + 64) of the CTA's tile; warp w of
  // it holds rows 16 w + lane / 4 (r0) and + 8 (r1) of those
  const int c = warp / 4, t = threadIdx.x % 128, w = t / 32, t4 = lane % 4;
  const int r0 = q0 + 64 * c + 16 * w + lane / 4, r1 = r0 + 8;
  float acc[D / 2];  // O: register 4 i + {0, 1} row r0, columns 8 i + 2 t4 + {0, 1}; + {2, 3} r1
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;   // running max (log2 units)
  float l0 = 0.0f, l1 = 0.0f;                     // this lane's part of the running sum
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  mbar_wait(&q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    // S = Q K^T over D / 16 chunks of 16 lanes: +32 bytes along a K-major
    // row (+2 in the descriptor) within a 64-lane atom
    float sacc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.0f;
    mbar_wait(&k_full[s], ph);
    fence_operands(sacc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint64_t da = desc_k_major(sq + (kc / 4) * W::Q_ATOM + c * 64 * 128) + 2 * (kc % 4);
      const uint64_t db = desc_k_major(sk + s * W::KV_BYTES + (kc / 4) * W::KV_ATOM) + 2 * (kc % 4);
      wgmma_bf16<0>(sacc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sacc);

    // mask keys past T, scale into log2 units, online softmax per row
    const int n0 = it * BN;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = n0 + 8 * i + 2 * t4 + e < T;
        sacc[4 * i + e] = ok ? sacc[4 * i + e] * sl2 : -CUDART_INF_F;
        sacc[4 * i + 2 + e] = ok ? sacc[4 * i + 2 + e] * sl2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, sacc[4 * i + e]);
        mx1 = fmaxf(mx1, sacc[4 * i + 2 + e]);
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
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sacc[4 * i + e] = exp2f(sacc[4 * i + e] - mn0);
        sacc[4 * i + 2 + e] = exp2f(sacc[4 * i + 2 + e] - mn1);
        ls0 += sacc[4 * i + e];
        ls1 += sacc[4 * i + 2 + e];
      }
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }
    // P's A fragments, rounded to bf16: key chunk kk is score columns
    // 16 kk .. 16 kk + 15, registers 8 kk .. 8 kk + 7
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sacc[8 * kk + 2 * j], sacc[8 * kk + 2 * j + 1]);

    // O += P V: V (BN keys x D) MN-major, 16 key rows (2048 bytes, +128) a chunk
    mbar_wait(&v_full[s], ph);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_bf16_rs<1>(acc, pa[kk], desc_mn_major<W::KV_ATOM>(sv + s * W::KV_BYTES) + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    if (t == 0) mbar_arrive(&empty[s]);  // this warpgroup is done with stage s
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  bf16_t* ob = o + b * so.b + h * so.h + 2 * t4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (r0 < T)
      *reinterpret_cast<unsigned*>(ob + r0 * so.t + 8 * i) =
          pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (r1 < T)
      *reinterpret_cast<unsigned*>(ob + r1 * so.t + 8 * i) =
          pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
}

// One operand's tensor map: its (batch, head, row) strides in values,
// sorted smallest first after the lane dim; `box_rows` rows of 64 lanes.
inline bool attention_map(CUtensorMap* map, Dims* pos, const bf16_t* p, int batch, int H, int T,
                          int D, Strides st, int box_rows) {
  struct Dim {
    long long size, stride;
    int box, which;  // which: 0 row, 1 head, 2 batch
  } d[3] = {{T, st.t, box_rows, 0}, {H, st.h, 1, 1}, {batch, st.b, 1, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim x = d[j];
      d[j] = d[j - 1];
      d[j - 1] = x;
    }
  const long long dims[4] = {D, d[0].size, d[1].size, d[2].size};
  const long long strides[3] = {2 * d[0].stride, 2 * d[1].stride, 2 * d[2].stride};
  const int box[4] = {64, d[0].box, d[1].box, d[2].box};
  int at[3];
  for (int i = 0; i < 3; ++i) at[d[i].which] = i + 1;
  *pos = Dims{at[0], at[1], at[2]};
  return tmawg::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides, box);
}

template <int D, int C>
cudaError_t launch_wgmma(const bf16_t* q, const bf16_t* k, const bf16_t* v, bf16_t* o,
                         int batch, int T, int H, Strides sq, Strides sk, Strides sv, Strides so,
                         float scale, cudaStream_t stream) {
  using W = Wg<D, C>;
  CUtensorMap mq, mk, mv;
  Dims pq, pk, pv;
  if (!attention_map(&mq, &pq, q, batch, H, T, D, sq, W::ROWS) ||
      !attention_map(&mk, &pk, k, batch, H, T, D, sk, W::BN) ||
      !attention_map(&mv, &pv, v, batch, H, T, D, sv, W::BN) || pq.t != pk.t || pq.h != pk.h ||
      pk.t != pv.t || pk.h != pv.h)
    return cudaErrorInvalidValue;  // one coordinate order serves all three maps
  const auto kernel = attention_wgmma_kernel<D, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         W::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((T + W::ROWS - 1) / W::ROWS, H, batch);
  kernel<<<grid, W::THREADS, W::SMEM, stream>>>(mq, mk, mv, o, T, pq, so, scale);
  return cudaGetLastError();
}

// ---- the plan, the launch and the occupancy ---------------------------------------

// ops/fused_attention.py:bf16_attention_plan: rows 0 is the mma.sync body;
// else 64 C rows with that configuration's BN and stages.
struct Plan {
  int rows, bn, stages;
};

template <int D, int C>
constexpr bool is_cfg(Plan p) {
  return p.rows == 64 * C && p.bn == Cfg<D, C>::BN && p.stages == Cfg<D, C>::STAGES;
}

// Launches attention_bf16_kernel<D> over (query tiles, H, batch) on the
// caller's stream; returns the launch's error. q is read one value at a
// time, so it takes any alignment and strides; o and its strides must be
// 4-byte aligned (the caller's output is a fresh (.., D) buffer with even D).
template <int D>
inline cudaError_t launch_mma_sync(const bf16_t* q, const bf16_t* k, const bf16_t* v, bf16_t* o,
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

// The plan's body for head dim D; a plan the build does not hold, or a
// wgmma plan on views TMA does not take, is refused (cudaErrorInvalidValue).
template <int D>
inline cudaError_t launch(Plan plan, const bf16_t* q, const bf16_t* k, const bf16_t* v,
                          bf16_t* o, int batch, int T, int H, Strides sq, Strides sk, Strides sv,
                          Strides so, float scale, cudaStream_t stream) {
  if (plan.rows == 0)
    return launch_mma_sync<D>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
  if constexpr (D == 64) {
    if (is_cfg<64, 1>(plan))
      return launch_wgmma<64, 1>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    if (is_cfg<64, 2>(plan))
      return launch_wgmma<64, 2>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
  } else if constexpr (D == 128) {
    if (is_cfg<128, 1>(plan))
      return launch_wgmma<128, 1>(q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
  }
  return cudaErrorInvalidValue;
}

// launch<D> for a head dim known at run time; any D but 16, 32, 64 or 128
// is refused with cudaErrorInvalidValue before anything is launched.
inline cudaError_t launch_any(int D, Plan plan, const bf16_t* q, const bf16_t* k,
                              const bf16_t* v, bf16_t* o, int batch, int T, int H, Strides sq,
                              Strides sk, Strides sv, Strides so, float scale,
                              cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(plan, q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 32: return launch<32>(plan, q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 64: return launch<64>(plan, q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    case 128: return launch<128>(plan, q, k, v, o, batch, T, H, sq, sk, sv, so, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// CTAs an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the
// registers a thread and the dynamic shared memory of a kernel and its launch
template <typename Kernel>
inline cudaError_t occupancy(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
  out[1] = attr.numRegs;
  out[2] = smem;
  return err;
}

inline cudaError_t occupancy_any(int D, Plan plan, int* out) {
  if (plan.rows == 0) {
    switch (D) {
      case 16: return occupancy(attention_bf16_kernel<16>, THREADS, smem_bytes<16>(), out);
      case 32: return occupancy(attention_bf16_kernel<32>, THREADS, smem_bytes<32>(), out);
      case 64: return occupancy(attention_bf16_kernel<64>, THREADS, smem_bytes<64>(), out);
      case 128: return occupancy(attention_bf16_kernel<128>, THREADS, smem_bytes<128>(), out);
      default: return cudaErrorInvalidValue;
    }
  }
  if (D == 64 && is_cfg<64, 1>(plan))
    return occupancy(attention_wgmma_kernel<64, 1>, Wg<64, 1>::THREADS, Wg<64, 1>::SMEM, out);
  if (D == 64 && is_cfg<64, 2>(plan))
    return occupancy(attention_wgmma_kernel<64, 2>, Wg<64, 2>::THREADS, Wg<64, 2>::SMEM, out);
  if (D == 128 && is_cfg<128, 1>(plan))
    return occupancy(attention_wgmma_kernel<128, 1>, Wg<128, 1>::THREADS, Wg<128, 1>::SMEM,
                     out);
  return cudaErrorInvalidValue;
}

}  // namespace attn_bf16
}  // namespace
