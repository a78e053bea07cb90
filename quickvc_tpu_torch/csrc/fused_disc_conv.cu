// Kernels K5 (k=5 conv + bias + LeakyReLU, also its dx) and K6 (its dW),
// float32 products on TF32 tensor cores (3xTF32), for sm_90a.
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
// What bounds them on this card: operations. At DiscriminatorP(2)'s fifth
// conv of the paired D phase (x (128, 64, 1024), 1024 -> 1024) each call is
// 2*N*R*5*C_in*C_out = 86 GFLOP against ~60 MB moved. A float32-accurate
// product takes three TF32 products (3xTF32, tf32x3.cuh), so the least time
// is 3 * 86e9 / 495e12 = 0.521 ms at the dense TF32 rate (0.516-0.541 ms
// over the five periods' row counts); on the float32 FMA units (67 TFLOP/s)
// it would be 1.282 ms.
//
// Design: both are one implicit GEMM, out (M x Nc) = A (M x Kd) @ B (Kd x Nc),
// on mma.sync.m16n8k8 TF32 in 3xTF32.
// - B is a row-major matrix in memory, contiguous along Nc (K5: the filter
//   as (5*C_in, C_out); K6: dym as (N*R, C_out)). A is gathered from x with
//   the row shift, so no im2col copy is made. K5: A[(n, r), (dr, c)] =
//   x[n, r + dr - 2, c], contiguous along k = c, staged m-major (As[m][k]);
//   K6: A[(dr, c), (n, r)], contiguous along m = c, staged k-major (As[k][m]).
//   A row whose shifted x row falls outside [0, R) (the SAME padding and the
//   item boundaries every R rows) is zero-filled by the copy (src-size 0).
// - A block of 8 warps (4 x 2) computes a 256 x 128 tile, 64 x 64 a warp
//   (4 x 8 m16n8k8 tiles, 128 accumulators a lane), one block an SM (255
//   registers a thread). Each k8 step splits the warp's eight B fragments
//   once and each A fragment once, and runs three mma.sync for each of the
//   32 tile pairs. (Channels that are not multiples of 4 take 4-byte copies
//   on a 128 x 64 tiling of 4 warps.)
// - Accumulation: the tensor core's sum inside an mma truncates, with an
//   error that scales with the accumulator, so the three products of a k8
//   step are summed from zero and added to the float32 accumulators by
//   float32 adds (tf32x3.cuh:mma_3xtf32_promoted): 6.9e-6 off float64 on
//   O(1) outputs at k = 5,120, where chaining them into the accumulators
//   gave 2.4e-4 and ran 18-20% faster on the tilings tried.
// - K is walked in tiles of 32 through a ring of 3 cp.async stages in
//   dynamic shared memory (151-174 KB), one barrier a K tile. Copies are
//   16 bytes when C_in and C_out are multiples of 4 floats and x and B are
//   16-byte aligned, 4 bytes otherwise (any shape is taken). ptxas holds
//   K5's body at 255 registers without a spill with the k8 steps of a K tile
//   in a loop, K6's with them unrolled.
// - Fragments load as float2: the k slots of an m16n8k8 step are relabelled
//   (slot t <- k 2t, slot t+4 <- k 2t+1, the same for A and B: a product
//   sums over k in any order); K6's A rows and every B column are permuted
//   within the warp tile so that one float2 holds two rows (two n tiles).
//   Shared rows are padded (As[m][k] to 40 floats, As[k][m] and Bs[k][n] to
//   the tile width + 4) so that each half-warp's 64-bit loads hit distinct
//   banks. The permuted columns put four consecutive outputs in a lane,
//   stored as float4.
// - The epilogue adds the bias and applies the LeakyReLU (K5), and stores
//   float32 from the accumulators.
// - K6's grid (5*C_in/256 x C_out/128 = 160 tiles at full width) is 1.2
//   waves on 132 SMs, each tile walking the 8,192-long reduction, so the
//   reduction is split (split-K): the host plan (ops/fused_disc_conv.py
//   :dw_plan) cuts [0, N*R) into `splits` ranges on K-tile edges; split z
//   writes its float32 partial tile to workspace[z] (splits x 5*C_in*C_out
//   floats), and a second kernel sums the partials in split order 0..s-1
//   into dW. No atomics: every launch on the same inputs gives the same bits.
//
// The bf16 mode of both is the same implicit GEMM on bf16 tensor cores: on
// the persistent TMA + wgmma ring (conv5_wgmma.cu) where C_in is a multiple
// of 64, C_out of 8 and the tensors 16-byte aligned (every period shape),
// else on the mma.sync core of bf16_gemm.cuh (qvc_conv5_lrelu_bf16,
// qvc_conv5_dw_bf16), whose note is at the end of this file.

#include <cuda_runtime.h>

#include "bf16_gemm.cuh"  // the bf16 mode's fragments and mma
#include "splitk_bf16.cuh"  // its split-K sum
#include "tf32x3.cuh"

namespace {

enum AMode { A_CONV = 0, A_DW = 1 };

// A block tiling. Wide (the 16-byte path, every shape the discriminator
// runs): 8 warps (4 x 2) over a 256 x 128 tile, 64 x 64 a warp (4 x 8
// m16n8k8 tiles, 128 accumulators a lane), one block an SM (up to 255
// registers a thread; two blocks an SM spilled). Narrow (the 4-byte path,
// channels that are not multiples of 4): 4 warps (2 x 2) over 128 x 64, 64 x
// 32 a warp, whose lighter register load leaves room for the 4-byte copies'
// address arithmetic. K walks in tiles of 32 through a ring of 3 stages.
//
// Padded shared rows for the float2 fragment loads of a half-warp (lanes
// g = 0..3 or 4..7, t4 = 0..3): As[m][k] (K5) reads word 40 g + 2 t4, banks
// 8 g + 2 t4 (+1); As[k][m] (K6) and Bs[k][n] read word (2 t4) LD + 2 g with
// LD = 4 mod 16, banks 8 t4 + 2 g (+1). All stay multiples of 4 floats for
// the 16-byte copies.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, bool VEC_>
struct Tiling {
  static constexpr bool VEC = VEC_;  // 16-byte copies, else 4-byte
  static constexpr int BM = BM_, BN = BN_, BK = 32, STAGES = 3;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // its m16n8k8 tiles
  static constexpr int LDA_CONV = BK + 8, LDA_DW = BM + 4, LDB = BN + 4;
  static_assert(LDA_DW % 16 == 4 && LDB % 16 == 4 && LDA_CONV % 32 == 8, "bank spread");
  static_assert(WN % 16 == 0, "n tiles in pairs");

  template <int MODE>
  __host__ __device__ static constexpr int a_stage_floats() {
    return MODE == A_CONV ? BM * LDA_CONV : BK * LDA_DW;
  }
  static constexpr int B_STAGE_FLOATS = BK * LDB;
  template <int MODE>
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * (a_stage_floats<MODE>() + B_STAGE_FLOATS) * (int)sizeof(float);
  }
  // k8 steps unrolled a K tile: on the Wide tiling ptxas keeps K5's rolled
  // loop and K6's unrolled one within 255 registers without a spill
  template <int MODE>
  __host__ __device__ static constexpr int kk_unroll() {
    return BM == 256 && MODE == A_CONV ? 1 : BK / 8;
  }
};
using Wide = Tiling<256, 128, 4, 2, true>;
using Narrow = Tiling<128, 64, 2, 2, false>;
constexpr int BK = Wide::BK;

// Copies of this thread that fill one K tile of A and of B: W floats each
// (16 bytes when VEC, else 4), laid out so that a thread's column along the
// contiguous axis stays fixed from one K tile to the next.
template <class T, int MODE>
struct Loader {
  static constexpr bool VEC = T::VEC;
  static constexpr int BM = T::BM, BN = T::BN, BK = T::BK, THREADS = T::THREADS;
  static constexpr int LDA_CONV = T::LDA_CONV, LDA_DW = T::LDA_DW, LDB = T::LDB;
  static constexpr int W = VEC ? 4 : 1;
  // A_CONV: rows of A run along m, columns (W wide) along k
  // A_DW:   rows of As run along k, columns along m
  static constexpr int A_COLS = (MODE == A_CONV ? BK : BM) / W;  // copies a row
  static constexpr int A_ROWS = THREADS / A_COLS;                // rows a pass
  static constexpr int A_PASSES = (MODE == A_CONV ? BM : BK) / A_ROWS;
  static constexpr int B_COLS = BN / W;
  static constexpr int B_ROWS = THREADS / B_COLS;
  static constexpr int B_PASSES = BK / B_ROWS;
  static_assert(THREADS % A_COLS == 0 && THREADS % B_COLS == 0, "whole rows a pass");
  static_assert(A_PASSES * A_ROWS == (MODE == A_CONV ? BM : BK), "whole passes");
  static_assert(B_PASSES * B_ROWS == BK, "whole passes");
  // VEC keeps a register of each row's r; the 4-byte path recomputes it
  static constexpr int R_KEPT = VEC ? A_PASSES : 1;

  const float* __restrict__ x;
  const float* __restrict__ b;
  int R, C, M, Nc, k_end;
  int a_row0, a_col;  // this thread's first row and its column in the tile
  int b_row0, b_col;
  int m0, n0, k0;     // tile origin; k0 of the next K tile to load
  int dr, c;          // A_CONV: (dr, c) of column k0 + a_col; A_DW: of row m0 + a_col
  int r_step;         // A_DW: BK mod R
  int r[R_KEPT];      // VEC: the r of each row this thread copies (A_CONV: m; A_DW: k)

  __device__ __forceinline__ Loader(const float* x_, const float* b_, int R_, int C_, int M_,
                                    int Nc_, int m0_, int n0_, int k_begin, int k_end_)
      : x(x_), b(b_), R(R_), C(C_), M(M_), Nc(Nc_), k_end(k_end_), m0(m0_), n0(n0_),
        k0(k_begin) {
    const int tid = threadIdx.x;
    a_row0 = tid / A_COLS;
    a_col = W * (tid % A_COLS);
    b_row0 = tid / B_COLS;
    b_col = W * (tid % B_COLS);
    if (MODE == A_CONV) {
      const int k = k0 + a_col;
      dr = k / C;
      c = k - dr * C;
      r_step = 0;
#pragma unroll
      for (int i = 0; i < R_KEPT; ++i) {
        const int m = m0 + a_row0 + i * A_ROWS;
        r[i] = m < M ? m % R : -(1 << 20);  // a row past M never lands in [0, R)
      }
    } else {
      const int m = m0 + a_col;
      dr = m < M ? m / C : 1 << 20;  // a column past M never lands in [0, R)
      c = m < M ? m - dr * C : 0;
      r_step = BK % R;
#pragma unroll
      for (int i = 0; i < R_KEPT; ++i) r[i] = (k0 + a_row0 + i * A_ROWS) % R;
    }
  }

  // The next K tile of A and B into As and Bs; advances to the one after.
  // The 4-byte path (a few odd shapes) runs its copies in a loop, keeping
  // its address registers out of the way of the MMA loop's.
  __device__ __forceinline__ void load(float* As, float* Bs) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) load_a(As, i);
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) load_b(Bs, i);
    } else {
#pragma unroll 1
      for (int i = 0; i < A_PASSES; ++i) load_a(As, i);
#pragma unroll 1
      for (int i = 0; i < B_PASSES; ++i) load_b(Bs, i);
    }
    advance();
  }

  // copy i of this thread's share of A's K tile
  __device__ __forceinline__ void load_a(float* As, int i) {
    const int row = a_row0 + i * A_ROWS;
    int r_row, xrow;  // the r of this row (A_CONV: of m; A_DW: of k), its shifted row in x
    bool ok;
    if constexpr (MODE == A_CONV) {
      const int m = m0 + row;
      if constexpr (VEC) r_row = r[i];
      else r_row = m < M ? m % R : -(1 << 20);
      xrow = m + dr - 2;
      ok = dr < 5;
    } else {
      const int k = k0 + row;
      if constexpr (VEC) r_row = r[i];
      else r_row = k % R;
      xrow = k + dr - 2;
      ok = k < k_end;
    }
    ok = ok && (unsigned)(r_row + dr - 2) < (unsigned)R;
    const float* src = ok ? x + (long long)xrow * C + c : x;
    float* dst = As + (MODE == A_CONV ? row * LDA_CONV : row * LDA_DW) + a_col;
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }

  // copy i of this thread's share of B's K tile
  __device__ __forceinline__ void load_b(float* Bs, int i) {
    const int row = b_row0 + i * B_ROWS;
    const int k = k0 + row, n = n0 + b_col;
    const bool ok = k < k_end && n < Nc;
    const float* src = ok ? b + (long long)k * Nc + n : b;
    if constexpr (VEC) cp_async16(Bs + row * LDB + b_col, src, ok);
    else cp_async4(Bs + row * LDB + b_col, src, ok);
  }

  // on to the next K tile
  __device__ __forceinline__ void advance() {
    k0 += BK;
    if constexpr (MODE == A_CONV) {
      c += BK;
      while (c >= C) {
        c -= C;
        ++dr;
      }
    } else if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < R_KEPT; ++i) {
        r[i] += r_step;
        if (r[i] >= R) r[i] -= R;
      }
    }
  }
};

// acc += the K tile in As, Bs: four k8 steps of 3xTF32 products. The k
// slots are relabelled (slot t4 <- k 2 t4, slot t4 + 4 <- k 2 t4 + 1), B's
// columns permuted (n tile j, lane g <- column 16 (j / 2) + 2 g + j % 2) and,
// for K6, A's rows (row g <- 2 g, row g + 8 <- 2 g + 1 of each 16), so that
// every fragment comes in float2 loads.
template <class T, int MODE>
__device__ __forceinline__ void mma_tile(const float* As, const float* Bs,
                                         float (&acc)[T::MT][T::NT][4], int wm0, int wn0,
                                         int g, int t4) {
  constexpr int MT = T::MT, NT = T::NT, LDA_CONV = T::LDA_CONV, LDA_DW = T::LDA_DW,
                LDB = T::LDB, KK_UNROLL = T::template kk_unroll<MODE>();
#pragma unroll(KK_UNROLL)
  for (int kk = 0; kk < T::BK; kk += 8) {
    unsigned bb[NT][2], bs[NT][2];
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {  // b of n tiles 2 jj and 2 jj + 1
      const float* bp = Bs + (kk + 2 * t4) * LDB + wn0 + 16 * jj + 2 * g;
      const float2 v0 = *reinterpret_cast<const float2*>(bp);
      const float2 v1 = *reinterpret_cast<const float2*>(bp + LDB);
      split(v0.x, bb[2 * jj][0], bs[2 * jj][0]);
      split(v0.y, bb[2 * jj + 1][0], bs[2 * jj + 1][0]);
      split(v1.x, bb[2 * jj][1], bs[2 * jj][1]);
      split(v1.y, bb[2 * jj + 1][1], bs[2 * jj + 1][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float a[4];  // a0 (row g, slot t4), a1 (row g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
      if (MODE == A_CONV) {  // rows 16 i + g and + 8
        const float* ap = As + (wm0 + 16 * i + g) * LDA_CONV + kk + 2 * t4;
        const float2 r0 = *reinterpret_cast<const float2*>(ap);
        const float2 r1 = *reinterpret_cast<const float2*>(ap + 8 * LDA_CONV);
        a[0] = r0.x;
        a[1] = r1.x;
        a[2] = r0.y;
        a[3] = r1.y;
      } else {  // rows 16 i + 2 g and + 1
        const float* ap = As + (kk + 2 * t4) * LDA_DW + wm0 + 16 * i + 2 * g;
        const float2 s0 = *reinterpret_cast<const float2*>(ap);
        const float2 s1 = *reinterpret_cast<const float2*>(ap + LDA_DW);
        a[0] = s0.x;
        a[1] = s0.y;
        a[2] = s1.x;
        a[3] = s1.y;
      }
      unsigned ab[4], as[4];
      split_a(a, ab, as);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_3xtf32_promoted(acc[i][j], ab, as, bb[j][0], bs[j][0], bb[j][1], bs[j][1]);
    }
  }
}

// One BM x BN tile (tiling T) of out = A @ B over K range [z k_chunk, (z + 1) k_chunk)
// of block z (blockIdx.z), into out + z M Nc. K5 (A_CONV) runs one range and
// applies bias (may be null) and LeakyReLU; K6 (A_DW) stores the raw sums.
template <class T, int MODE>
__global__ void __launch_bounds__(T::THREADS, 1)
conv5_gemm_kernel(const float* __restrict__ x, const float* __restrict__ bmat,
                  const float* __restrict__ bias, float* __restrict__ out, int M, int Nc,
                  int Kd, int R, int C, int k_chunk, float slope, bool store4) {
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES, WARPS_N = T::WARPS_N;
  constexpr int WM = T::WM, WN = T::WN, MT = T::MT, NT = T::NT;
  constexpr int A_ST = T::template a_stage_floats<MODE>(), B_ST = T::B_STAGE_FLOATS;
  extern __shared__ __align__(16) float conv5_smem[];
  float* As = conv5_smem;
  float* Bs = conv5_smem + STAGES * A_ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(Kd, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + T::BK - 1) / T::BK;

  Loader<T, MODE> ld(x, bmat, R, C, M, Nc, m0, n0, k_begin, k_end);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) ld.load(As + s * A_ST, Bs + s * B_ST);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed for every thread, and every warp is
                      // done with the slot that the next copy refills
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) {
      const int s = nxt % STAGES;
      ld.load(As + s * A_ST, Bs + s * B_ST);
    }
    cp_async_commit();
    const int s = t % STAGES;
    mma_tile<T, MODE>(As + s * A_ST, Bs + s * B_ST, acc, wm0, wn0, g, t4);
  }
  cp_async_wait<0>();

  float* o = out + (long long)blockIdx.z * M * Nc;
  // tile pair (2 jj, 2 jj + 1) holds columns 16 jj + 4 t4 + {0, 1, 2, 3} of
  // rows (A_CONV) 16 i + g, + 8 or (A_DW) 16 i + 2 g, + 1
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    const int col = n0 + wn0 + 16 * jj + 4 * t4;
    float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (MODE == A_CONV && bias != nullptr) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < Nc) bv[q] = __ldg(bias + col + q);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + 16 * i + (MODE == A_CONV ? g + 8 * h : 2 * g + h);
        if (row >= M) continue;
        float v[4] = {acc[i][2 * jj][2 * h], acc[i][2 * jj + 1][2 * h],
                      acc[i][2 * jj][2 * h + 1], acc[i][2 * jj + 1][2 * h + 1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] += bv[q];
          if (MODE == A_CONV) v[q] = v[q] > 0.0f ? v[q] : slope * v[q];
        }
        float* p = o + (long long)row * Nc + col;
        if (store4 && col + 3 < Nc) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < Nc) p[q] = v[q];
        }
      }
    }
  }
}

// out[i] = sum over z = 0..splits-1, in that order, of ws[z * count + i].
__global__ void __launch_bounds__(256)
splitk_sum_kernel(const float* __restrict__ ws, float* __restrict__ out, long long count,
                  int splits, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    const long long n4 = count / 4;
    for (; i < n4; i += stride) {
      float4 s = w4[i];
      for (int z = 1; z < splits; ++z) {
        const float4 p = w4[z * n4 + i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    }
  } else {
    for (; i < count; i += stride) {
      float s = ws[i];
      for (int z = 1; z < splits; ++z) s += ws[z * count + i];
      out[i] = s;
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// One launch of conv5_gemm_kernel on tiling T: the grid covers M x Nc in
// T's tiles and `splits` K ranges.
template <class T, int MODE>
cudaError_t launch_gemm(const float* x, const float* bmat, const float* bias, float* out,
                        int M, int Nc, int Kd, int R, int C, int splits, int k_chunk,
                        float slope, cudaStream_t stream) {
  constexpr int bytes = T::template smem_bytes<MODE>();
  const auto kernel = conv5_gemm_kernel<T, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // all of the SM's shared memory: 151-174 KB a Wide block
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nc + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  const bool store4 = Nc % 4 == 0 && aligned(out, 16);
  kernel<<<grid, T::THREADS, bytes, stream>>>(x, bmat, bias, out, M, Nc, Kd, R, C, k_chunk,
                                              slope, store4);
  return cudaGetLastError();
}

// The Wide tiling on 16-byte copies where every channel count is a multiple
// of 4 floats and x and B are 16-byte aligned, else the Narrow one on
// 4-byte copies.
template <int MODE>
cudaError_t launch_any(const void* x, const void* b, const float* bias, float* out, int M,
                       int Nc, int Kd, int R, int C, int c_in, int c_out, int splits,
                       int k_chunk, float slope, cudaStream_t stream) {
  const bool vec = c_in % 4 == 0 && c_out % 4 == 0 && aligned(x, 16) && aligned(b, 16);
  return vec ? launch_gemm<Wide, MODE>((const float*)x, (const float*)b, bias, out, M, Nc, Kd,
                                       R, C, splits, k_chunk, slope, stream)
             : launch_gemm<Narrow, MODE>((const float*)x, (const float*)b, bias, out, M, Nc,
                                         Kd, R, C, splits, k_chunk, slope, stream);
}

}  // namespace

// K5: y (N, R, C_out) = lrelu(conv5(x (N, R, C_in), w (5, C_in, C_out)) + bias).
// bias may be null (the dx launch); slope 1 makes the activation the identity.
extern "C" int qvc_conv5_lrelu(const void* x, const void* w, const void* bias,
                               void* y, int n, int rows, int c_in, int c_out,
                               float slope, void* stream) {
  const int M = n * rows, K = 5 * c_in;
  return (int)launch_any<A_CONV>(x, w, (const float*)bias, (float*)y, M, c_out, K, rows, c_in,
                                 c_in, c_out, 1, K, slope, (cudaStream_t)stream);
}

// K6: dw (5, C_in, C_out) = sum over (n, r) of shifted x^T @ dym, the
// reduction cut into `splits` ranges of k_chunk rows (a multiple of the K
// tile, every range non-empty: ops/fused_disc_conv.py:dw_plan). With more
// than one split the partials go to workspace (splits x 5*C_in*C_out
// floats) and a second kernel sums them in split order.
extern "C" int qvc_conv5_dw(const void* x, const void* dym, void* dw, void* workspace, int n,
                            int rows, int c_in, int c_out, int splits, int k_chunk,
                            void* stream) {
  const int M = 5 * c_in, K = n * rows;
  if (splits < 1 || k_chunk < 1 || k_chunk % BK != 0 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  float* part = splits > 1 ? (float*)workspace : (float*)dw;
  const cudaError_t err = launch_any<A_DW>(x, dym, nullptr, part, M, c_out, K, rows, c_in,
                                           c_in, c_out, splits, k_chunk, 1.0f, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long count = (long long)M * c_out;
  const bool vec = count % 4 == 0 && aligned(workspace, 16) && aligned(dw, 16);
  const long long work = vec ? count / 4 : count;
  const int blocks = (int)((work + 255) / 256 < 4096 ? (work + 255) / 256 : 4096);
  splitk_sum_kernel<<<blocks, 256, 0, s>>>((const float*)workspace, (float*)dw, count, splits,
                                           vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 mode of K5 and K6: the TPU kernels' bf16 branch (their dots drop
// Precision.HIGHEST for bf16 operands, quickvc_tpu/ops/fused_disc_conv.py
// :64-65, 88-89). With x, the filter and dym in bf16:
//
//   K5:  y  = bf16(lrelu(sum_{dr, c} x[n, r + dr - 2, c] K[dr, c, o] + float(b[o])))
//   K6:  dW = bf16(sum_{n, r} x[n, r + dr - 2, c] dym[n, r, o])
//
// every product of two bf16 values exact in float32, the sums, the bias and
// the LeakyReLU in float32, and the result rounded to bf16 once (K5 as the
// TPU kernel's out_shape x.dtype at :126; K6 after its float32 output, :164,
// 166). dx is K5 on the flipped, transposed bf16 filter with slope 1.
//
// What bounds them on this card: operations. At DiscriminatorP(2)'s fifth
// conv of the paired D phase (x (128, 64, 1024)) each call is 85.9 GFLOP,
// 0.087 ms at the 989 TFLOP/s dense bf16 rate, against ~44 MB of bf16
// moved (0.013 ms).
//
// The host sends the shapes conv5_wgmma.cu takes there
// (ops/fused_disc_conv.py:takes_wgmma); this body takes every other shape
// the JAX kernel takes: channels off multiples of 64 or 8, offset views.
//
// Design: the float32 kernel's implicit GEMM, out (M x Nc) = A (M x Kd) @
// B (Kd x Nc), on the bf16 core (bf16_gemm.cuh): mma.sync.m16n8k16 bf16 with
// float32 accumulators, 128 x 128 tiles of 4 warps (64 x 64 a warp), two
// blocks an SM, K walked in tiles of 64 through a ring of 3 cp.async stages.
// - The core stages both operands k-contiguous. Here only K5's A is:
//   A[(n, r), (dr, c)] = x[n, r + dr - 2, c], staged As[m][k] (72-value
//   rows) and read with ldmatrix.x4 as the core reads it. K5's B (the
//   filter as (5 C_in, C_out)), K6's A (x shifted, [k = (n, r)][m = (dr,
//   c)]) and K6's B (dym, [k][n]) are contiguous along m or n: they are
//   staged as they lie, [k][m] or [k][n] in 136-value rows (17 16-byte
//   units: the 8 rows of an ldmatrix phase land on 8 bank groups), and read
//   with ldmatrix.x4.trans, as K7's bf16 conv1 reads its weight.
// - A row whose shifted x row falls outside [0, R) (the SAME padding, the
//   item edges every R rows) and anything past M, Nc or the block's K range
//   is zero-filled by the copy (src-size 0). 16-byte copies of 8 values need
//   C_in % 8 == 0, C_out % 8 == 0 and 16-byte aligned pointers; any other
//   shape takes the same body with each value gathered on its own and
//   stored to shared memory by the threads (every channel count the JAX
//   kernel takes).
// - K5's epilogue adds the bias, applies the LeakyReLU and rounds to bf16,
//   storing bf16 pairs. K6 splits its reduction as dw_plan plans it for this
//   tiling (40 x 8 = 320 tiles on 264 block slots at full width): split z
//   stores its float32 partial to workspace z and splitk_sum_bf16_kernel
//   (bf16_gemm.cuh) sums the partials in split order and rounds once. No atomics: every
//   launch on the same inputs gives the same bits.

namespace {
namespace conv5_bf16 {

using bf16core::bf16_t;

constexpr int BM = bf16core::BM, BN = bf16core::BN, BK = bf16core::BK;
constexpr int STAGES = bf16core::STAGES, THREADS = bf16core::THREADS;
constexpr int WARPS_N = bf16core::WARPS_N, MIN_BLOCKS = bf16core::MIN_BLOCKS;
constexpr int WM = bf16core::WM, WN = bf16core::WN, MT = bf16core::MT, NT = bf16core::NT;
constexpr int LDMK = BK + 8;   // [m][k] rows (K5's A): 72 values, 9 16-byte units
constexpr int LDKN = BN + 8;   // [k][m] and [k][n] rows: 136 values, 17 16-byte units
static_assert(BM == BN, "[k][m] and [k][n] rows share a pitch");
static_assert((LDMK * 2 / 16) % 2 == 1 && (LDKN * 2 / 16) % 2 == 1, "ldmatrix bank spread");

template <int MODE>
__host__ __device__ constexpr int a_stage() {
  return MODE == A_CONV ? BM * LDMK : BK * LDKN;
}
constexpr int B_STAGE = BK * LDKN;
template <int MODE>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * (a_stage<MODE>() + B_STAGE) * (int)sizeof(bf16_t);  // 107,520 / 104,448
}

// 8 bf16 values as one 16-byte word, the first in the low half
__device__ __forceinline__ uint4 pack8(const bf16_t (&v)[8]) {
  return make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                    v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
}

// This thread's copies of one K tile of A and B, 8 values each. A_CONV:
// A's rows run along m, its 8-value chunks along k; A_DW: As's rows run
// along k, chunks along m; B's rows along k, chunks along n. A thread's
// chunk column stays fixed from one K tile to the next. VEC: one 16-byte
// cp.async a chunk; otherwise each value gathered on its own (any shape).
template <int MODE, bool VEC>
struct Loader {
  static constexpr int A_COLS = (MODE == A_CONV ? BK : BM) / 8;  // chunks a row: 8 or 16
  static constexpr int A_ROWS = THREADS / A_COLS;                // rows a pass: 16 or 8
  static constexpr int A_PASSES = (MODE == A_CONV ? BM : BK) / A_ROWS;
  static constexpr int LDA = MODE == A_CONV ? LDMK : LDKN;
  static constexpr int B_COLS = BN / 8, B_ROWS = THREADS / B_COLS, B_PASSES = BK / B_ROWS;
  static_assert(A_PASSES * A_ROWS == (MODE == A_CONV ? BM : BK) && B_PASSES * B_ROWS == BK,
                "whole passes");

  const bf16_t* __restrict__ x;
  const bf16_t* __restrict__ b;
  int R, C, M, Nc, k_end;
  int a_row0, a_col, b_row0, b_col;
  int m0, n0, k0;  // tile origin; k0 of the next K tile to load
  int dr, c;       // A_CONV: (dr, c) of column k0 + a_col; A_DW: of row m0 + a_col
  int r_step;      // A_DW: BK mod R
  int r[A_PASSES]; // the r of each row this thread copies (A_CONV: of m; A_DW: of k)

  __device__ __forceinline__ Loader(const bf16_t* x_, const bf16_t* b_, int R_, int C_, int M_,
                                    int Nc_, int m0_, int n0_, int k_begin, int k_end_)
      : x(x_), b(b_), R(R_), C(C_), M(M_), Nc(Nc_), k_end(k_end_), m0(m0_), n0(n0_),
        k0(k_begin) {
    const int tid = threadIdx.x;
    a_row0 = tid / A_COLS;
    a_col = 8 * (tid % A_COLS);
    b_row0 = tid / B_COLS;
    b_col = 8 * (tid % B_COLS);
    if (MODE == A_CONV) {
      const int k = k0 + a_col;
      dr = k / C;
      c = k - dr * C;
      r_step = 0;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        const int m = m0 + a_row0 + i * A_ROWS;
        r[i] = m < M ? m % R : -(1 << 20);  // a row past M never lands in [0, R)
      }
    } else {
      const int m = m0 + a_col;
      dr = m < M ? m / C : 1 << 20;  // a column past M never lands in [0, R)
      c = m < M ? m - dr * C : 0;
      r_step = BK % R;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) r[i] = (k0 + a_row0 + i * A_ROWS) % R;
    }
  }

  // The next K tile of A and B into As and Bs; advances to the one after.
  __device__ __forceinline__ void load(bf16_t* As, bf16_t* Bs) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) load_a(As, i);
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) load_b(Bs, i);
    } else {
#pragma unroll 1
      for (int i = 0; i < A_PASSES; ++i) gather_a(As, i);
#pragma unroll 1
      for (int i = 0; i < B_PASSES; ++i) gather_b(Bs, i);
    }
    advance();
  }

  __device__ __forceinline__ void load_a(bf16_t* As, int i) {
    const int row = a_row0 + i * A_ROWS;
    bool ok;
    long long src;
    if constexpr (MODE == A_CONV) {
      ok = dr < 5 && (unsigned)(r[i] + dr - 2) < (unsigned)R;
      src = (long long)(m0 + row + dr - 2) * C + c;
    } else {
      const int k = k0 + row;
      ok = k < k_end && (unsigned)(r[i] + dr - 2) < (unsigned)R;
      src = (long long)(k + dr - 2) * C + c;
    }
    cp_async16(reinterpret_cast<float*>(As + row * LDA + a_col),
               reinterpret_cast<const float*>(ok ? x + src : x), ok);
  }

  __device__ __forceinline__ void load_b(bf16_t* Bs, int i) {
    const int row = b_row0 + i * B_ROWS;
    const int k = k0 + row, n = n0 + b_col;
    const bool ok = k < k_end && n < Nc;
    cp_async16(reinterpret_cast<float*>(Bs + row * LDKN + b_col),
               reinterpret_cast<const float*>(ok ? b + (long long)k * Nc + n : b), ok);
  }

  // The gathered forms of load_a and load_b: each value's own (dr, c) and
  // bounds, 8 values stored to shared memory as one 16-byte store.
  __device__ __forceinline__ void gather_a(bf16_t* As, int i) {
    const int row = a_row0 + i * A_ROWS;
    bf16_t v[8];
    if constexpr (MODE == A_CONV) {
      const int m = m0 + row;
      const int rr = m < M ? m % R : -(1 << 20);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + a_col + e, d = k / C;
        const bool ok = k < k_end && (unsigned)(rr + d - 2) < (unsigned)R;
        v[e] = ok ? x[(long long)(m + d - 2) * C + (k - d * C)] : (bf16_t)0;
      }
    } else {
      const int k = k0 + row, rr = k % R;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int m = m0 + a_col + e, d = m / C;
        const bool ok = k < k_end && m < M && (unsigned)(rr + d - 2) < (unsigned)R;
        v[e] = ok ? x[(long long)(k + d - 2) * C + (m - d * C)] : (bf16_t)0;
      }
    }
    *reinterpret_cast<uint4*>(As + row * LDA + a_col) = pack8(v);
  }

  __device__ __forceinline__ void gather_b(bf16_t* Bs, int i) {
    const int row = b_row0 + i * B_ROWS;
    const int k = k0 + row;
    bf16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + b_col + e;
      v[e] = k < k_end && n < Nc ? b[(long long)k * Nc + n] : (bf16_t)0;
    }
    *reinterpret_cast<uint4*>(Bs + row * LDKN + b_col) = pack8(v);
  }

  __device__ __forceinline__ void advance() {
    k0 += BK;
    if constexpr (!VEC) return;  // the gathers recompute everything from k0
    if constexpr (MODE == A_CONV) {
      c += BK;
      while (c >= C) {
        c -= C;
        ++dr;
      }
    } else {
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        r[i] += r_step;
        if (r[i] >= R) r[i] -= R;
      }
    }
  }
};

// One BM x BN tile of out = A @ B over the K range [z k_chunk, (z + 1)
// k_chunk) of block z (blockIdx.z). With one split: K5 (A_CONV) adds the
// bias (bf16, may be null), applies the LeakyReLU and stores bf16; K6 (A_DW)
// stores its sums rounded to bf16. With several (K6), block z stores its
// float32 sums to the workspace out + z M Nc.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv5_bf16_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ bmat,
                  const bf16_t* __restrict__ bias, void* out, int M, int Nc, int Kd, int R,
                  int C, int k_chunk, float slope) {
  constexpr int A_ST = a_stage<MODE>();
  extern __shared__ __align__(16) unsigned char conv5_bf16_smem[];
  bf16_t* As = reinterpret_cast<bf16_t*>(conv5_bf16_smem);
  bf16_t* Bs = As + STAGES * A_ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(Kd, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  Loader<MODE, VEC> ld(x, bmat, R, C, M, Nc, m0, n0, k_begin, k_end);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) ld.load(As + s * A_ST, Bs + s * B_STAGE);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses of this lane, in bytes from a stage's start.
  // A [m][k] (ldmatrix.x4): row wm0 + l % 16, k 8 (l / 16). A [k][m] and B
  // [k][n] (.trans): matrix j = l / 8 of a fragment is A's (m 8 (j % 2), k
  // 8 (j / 2)) block and B's (k 8 (j % 2), n 8 (j / 2)) one, so lane l
  // gives A's k row 8 (l / 16) + l % 8 at m 8 ((l / 8) % 2) and B's k row
  // 8 ((l / 8) % 2) + l % 8 at n 8 (l / 16).
  const unsigned a_lane =
      MODE == A_CONV
          ? 2u * ((wm0 + (lane & 15)) * LDMK + 8 * (lane >> 4))
          : 2u * ((8 * (lane >> 4) + (lane & 7)) * LDKN + wm0 + 8 * ((lane >> 3) & 1));
  const unsigned b_lane = 2u * ((8 * ((lane >> 3) & 1) + (lane & 7)) * LDKN + wn0 + 8 * (lane >> 4));
  const unsigned as_addr = (unsigned)__cvta_generic_to_shared(As);
  const unsigned bs_addr = (unsigned)__cvta_generic_to_shared(Bs);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed (or was stored) for every thread, and
                      // every warp is done with the slot that the next load refills
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) ld.load(As + (nxt % STAGES) * A_ST, Bs + (nxt % STAGES) * B_STAGE);
    cp_async_commit();
    const int s = t % STAGES;
    const unsigned at = as_addr + 2u * s * A_ST + a_lane;
    const unsigned bt = bs_addr + 2u * s * B_STAGE + b_lane;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (MODE == A_CONV)
          bf16core::ldmatrix_x4(af[i], at + 2u * (16 * i * LDMK + kk));
        else
          bf16core::ldmatrix_x4_trans(af[i], at + 2u * (kk * LDKN + 16 * i));
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned bf[4];
        bf16core::ldmatrix_x4_trans(bf, bt + 2u * (kk * LDKN + 16 * jp));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          bf16core::mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          bf16core::mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool partial = gridDim.z > 1;
  float* part = static_cast<float*>(out) + (long long)blockIdx.z * M * Nc;
  bf16_t* y = static_cast<bf16_t*>(out);
  // acc[i][j]: rows 16 i + g (e 0, 1) and + 8 (e 2, 3), columns 8 j + 2 t4 + {0, 1}
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + 8 * j + 2 * t4;
    if (col >= Nc) continue;
    float bv[2] = {0.0f, 0.0f};
    if (MODE == A_CONV && bias != nullptr) {
      bv[0] = bf16core::bf16_to_float(bias[col]);
      if (col + 1 < Nc) bv[1] = bf16core::bf16_to_float(bias[col + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + 16 * i + g + 8 * h;
        if (row >= M) continue;
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        const long long at = (long long)row * Nc + col;
        if (partial) {
          if (VEC) {  // Nc % 8 == 0: the pair is in, 8-byte aligned
            *reinterpret_cast<float2*>(part + at) = make_float2(v[0], v[1]);
          } else {
            part[at] = v[0];
            if (col + 1 < Nc) part[at + 1] = v[1];
          }
          continue;
        }
        if (MODE == A_CONV) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] += bv[e];
            v[e] = v[e] > 0.0f ? v[e] : slope * v[e];
          }
        }
        if (VEC) {
          *reinterpret_cast<unsigned*>(y + at) = bf16core::pack_bf16(v[0], v[1]);
        } else {
          y[at] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
          if (col + 1 < Nc) y[at + 1] = __bfloat16_as_ushort(__float2bfloat16_rn(v[1]));
        }
      }
    }
  }
}

template <int MODE, bool VEC>
cudaError_t launch(const bf16_t* x, const bf16_t* bmat, const bf16_t* bias, void* out, int M,
                   int Nc, int Kd, int R, int C, int splits, int k_chunk, float slope,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<MODE>();
  const auto kernel = conv5_bf16_kernel<MODE, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // two blocks an SM: 210-215 KB of its shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nc + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, bytes, stream>>>(x, bmat, bias, out, M, Nc, Kd, R, C, k_chunk, slope);
  return cudaGetLastError();
}

// 16-byte copies where the channel counts are multiples of 8 values and
// the pointers 16-byte aligned, else the gathered copies.
template <int MODE>
cudaError_t launch_any(const void* x, const void* bmat, const void* bias, void* out,
                       const void* y, int M, int Nc, int Kd, int R, int C, int c_in, int c_out,
                       int splits, int k_chunk, float slope, cudaStream_t stream) {
  const bool vec = c_in % 8 == 0 && c_out % 8 == 0 && aligned(x, 16) && aligned(bmat, 16) &&
                   aligned(y, 16);
  const auto* xb = static_cast<const bf16_t*>(x);
  const auto* bb = static_cast<const bf16_t*>(bmat);
  const auto* biasb = static_cast<const bf16_t*>(bias);
  return vec ? launch<MODE, true>(xb, bb, biasb, out, M, Nc, Kd, R, C, splits, k_chunk, slope,
                                  stream)
             : launch<MODE, false>(xb, bb, biasb, out, M, Nc, Kd, R, C, splits, k_chunk, slope,
                                   stream);
}

}  // namespace conv5_bf16
}  // namespace

// K5 at bf16: y (N, R, C_out) bf16 = lrelu(conv5(x (N, R, C_in), w (5, C_in,
// C_out)) + bias (C_out)), all bf16, float32 sums and activation, rounded
// once. bias may be null (the dx launch); slope 1 makes the activation the
// identity.
extern "C" int qvc_conv5_lrelu_bf16(const void* x, const void* w, const void* bias, void* y,
                                    int n, int rows, int c_in, int c_out, float slope,
                                    void* stream) {
  const int M = n * rows, K = 5 * c_in;
  return (int)conv5_bf16::launch_any<A_CONV>(x, w, bias, y, y, M, c_out, K, rows, c_in, c_in,
                                             c_out, 1, K, slope, (cudaStream_t)stream);
}

// K6 at bf16: dw (5, C_in, C_out) bf16 = the float32 sum over (n, r) of
// shifted x^T @ dym, rounded once; the reduction cut into `splits` ranges
// of k_chunk rows (a multiple of the bf16 K tile, every range non-empty:
// ops/fused_disc_conv.py:dw_plan on BF16_TILING). With more than one split
// the float32 partials go to workspace (splits x 5*C_in*C_out floats) and a
// second kernel sums them in split order and rounds.
extern "C" int qvc_conv5_dw_bf16(const void* x, const void* dym, void* dw, void* workspace,
                                 int n, int rows, int c_in, int c_out, int splits, int k_chunk,
                                 void* stream) {
  const int M = 5 * c_in, K = n * rows;
  if (!bf16core::valid_plan(K, splits, k_chunk) || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  void* part = splits > 1 ? workspace : dw;
  const cudaError_t err = conv5_bf16::launch_any<A_DW>(x, dym, nullptr, part, dw, M, c_out, K,
                                                       rows, c_in, c_in, c_out, splits, k_chunk,
                                                       1.0f, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)bf16core::splitk_sum_bf16((const float*)workspace, (bf16core::bf16_t*)dw,
                                        (long long)M * c_out, splits, s);
}
