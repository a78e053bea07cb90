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

#include <cuda_runtime.h>

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
