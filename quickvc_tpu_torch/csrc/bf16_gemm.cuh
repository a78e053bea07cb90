// The bf16 tensor-core GEMM core of the port, for sm_90a: bfloat16 operands,
// float32 accumulation on mma.sync.m16n8k16, fed by cp.async and ldmatrix.
// It holds the fragment helpers that K2's bf16 attention body
// (fused_attention_bf16.cuh) and K7's bf16 conv1 (fused_extractor.cu) share,
// and the linear layer that K8's bf16 mode runs its four GEMMs on
// (fused_transformer.cu). Included by several sources, so everything here
// has internal linkage.
//
// The arithmetic is what the TPU kernels' bf16 modes ask of the MXU: every
// product of two bf16 values is exact in float32 and summed in float32, and
// the epilogue works in float32 and rounds once where the JAX kernel rounds
// (quickvc_tpu/ops/fused_transformer.py:63-117 for K8).
//
// linear_bf16: C = epi(A W^T + bias), A (M, K) and W (N, K) bf16, both
// k-contiguous (activations and torch's Linear weights as they lie).
// - Tiles: a block of 4 warps (2 x 2) computes a 128 x 128 output tile,
//   64 x 64 a warp (4 x 8 m16n8k16 tiles, 128 float32 accumulators a lane),
//   two blocks an SM. The 3xTF32 GEMMs of K8 take 256 x 128 tiles at one
//   block an SM and 32-wide k tiles; a bf16 k16 step reads half the bytes
//   of a k8 3xTF32 one and makes one mma, not three, so the block walks K in
//   tiles of 64 and twice as many blocks fit the SMs' registers.
// - Both operands are staged m/n-major with k contiguous (As[m][k],
//   Bs[n][k]) by 16-byte cp.async copies of 8 values through a ring of 3
//   stages; a row past M or N, or a chunk past the block's K range, is
//   zero-filled by the copy (src-size 0). Rows are padded to 72 values (144
//   bytes, 9 16-byte units), so the 8 rows of an ldmatrix phase land on 8
//   distinct 16-byte bank groups.
// - Fragments: an A fragment (16 rows x 16 k) is one ldmatrix.x4 (lane l
//   gives the address of row l % 16, k 8 (l / 16)); the B fragments of two
//   8-column tiles are one ldmatrix.x4 (lane l: row 8 (l / 16) + l % 8,
//   k 8 ((l / 8) % 2)), as K2's bf16 body reads its K tiles.
// - Split-K: the host plan (ops/fused_transformer.py:linear_plan with
//   BF16_TILING) may cut the reduction into `splits` ranges on k-tile edges;
//   split z stores its float32 partial tile to workspace z and
//   linear_bf16_splitk_kernel sums the partials in split order and applies
//   the epilogue. No atomics: the same inputs give the same bits on every
//   launch.
// - Epilogues on column pairs (row g or g + 8, columns 2 t4 and + 1 of each
//   C fragment): the float32 bias, then
//     ROUND:     round to bf16 (in_proj's qkv);
//     GELU:      round to bf16, tanh GELU in float32, round again (linear1);
//     RESIDUAL:  add the bf16 residual in float32, store float32 (out_proj
//                and linear2, whose sums the LayerNorms read).
//
// It need not be fast yet: wgmma and TMA (csrc/int8_mm.cu's pattern) are
// the next step for it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"  // the cp.async copies

namespace {
namespace bf16core {

typedef unsigned short bf16_t;  // raw bfloat16 bits; the tensor cores read them

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b on one m16n8k16 bf16 tile, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float bf16_to_float(bf16_t x) {
  return __uint_as_float((unsigned)x << 16);
}

// x rounded to bf16 (to nearest even), as a float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// GELU in its tanh form, in float32 (jax.nn.gelu(approximate=True), torch's
// approximate="tanh"): the bf16 policy's GELU
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------------------
// linear_bf16 (see the head note)

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 2, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 2;                         // blocks an SM
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 64 x 64 tile
constexpr int MT = WM / 16, NT = WN / 8;             // its m16n8k16 tiles
constexpr int LDS = BK + 8;                          // padded row, in bf16 values
static_assert((LDS * 2 / 16) % 2 == 1, "8 rows of an ldmatrix phase on 8 bank groups");
constexpr int A_STAGE = BM * LDS, B_STAGE = BN * LDS;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16_t);  // 110,592
constexpr int CHUNKS_ROW = BK / 8;                   // 16-byte copies a row of a k tile
constexpr int ROWS_PASS = THREADS / CHUNKS_ROW;      // rows a pass of the copies: 16
constexpr int A_PASSES = BM / ROWS_PASS, B_PASSES = BN / ROWS_PASS;
constexpr int MAX_SPLITS = 4;  // ops/fused_transformer.py:MAX_SPLITS

enum Epilogue { ROUND = 0, GELU = 1, RESIDUAL = 2 };

// Columns col and col + 1 of row `row`: v + bias, then the epilogue; stored
// to C (bf16 for ROUND and GELU, float32 for RESIDUAL). col is even.
template <int EPI>
__device__ __forceinline__ void store_pair(void* C, const float* __restrict__ bias,
                                           const bf16_t* __restrict__ res, long long row,
                                           int col, int N, float v0, float v1) {
  const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
  v0 += b.x;
  v1 += b.y;
  const long long at = row * N + col;
  if (EPI == RESIDUAL) {
    const unsigned r = __ldg(reinterpret_cast<const unsigned*>(res + at));
    v0 += __uint_as_float(r << 16);
    v1 += __uint_as_float(r & 0xffff0000u);
    *reinterpret_cast<float2*>(static_cast<float*>(C) + at) = make_float2(v0, v1);
  } else {
    if (EPI == GELU) {
      v0 = gelu_tanh(round_bf16(v0));
      v1 = gelu_tanh(round_bf16(v1));
    }
    *reinterpret_cast<unsigned*>(static_cast<bf16_t*>(C) + at) = pack_bf16(v0, v1);
  }
}

// One BM x BN tile of C = epi(A W^T + bias) over the K range [z k_chunk,
// (z + 1) k_chunk) of block z (blockIdx.z). With one split the epilogue is
// applied and C written; with several, block z stores its raw float32 sums
// to ws + z M N. K % 8 == 0, N % 8 == 0, A and W 16-byte aligned.
template <int EPI>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
linear_bf16_kernel(const bf16_t* __restrict__ A, const bf16_t* __restrict__ W,
                   const float* __restrict__ bias, const bf16_t* __restrict__ res, void* C,
                   float* __restrict__ ws, int M, int N, int K, int k_chunk) {
  extern __shared__ __align__(16) unsigned char linear_bf16_smem[];
  bf16_t* As = reinterpret_cast<bf16_t*>(linear_bf16_smem);
  bf16_t* Bs = As + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // this thread copies 8 values at column c_col of rows c_row + 16 i of
  // both operands' k tiles; rows past M or N read nothing
  const int c_row = tid / CHUNKS_ROW, c_col = 8 * (tid % CHUNKS_ROW);
  const bf16_t* a_src = A + (long long)(m0 + c_row) * K + k_begin + c_col;
  const bf16_t* w_src = W + (long long)(n0 + c_row) * K + k_begin + c_col;
  unsigned a_rows = 0, w_rows = 0;  // bit i: row c_row + 16 i is in range
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) a_rows |= (unsigned)(m0 + c_row + i * ROWS_PASS < M) << i;
#pragma unroll
  for (int i = 0; i < B_PASSES; ++i) w_rows |= (unsigned)(n0 + c_row + i * ROWS_PASS < N) << i;

  auto load = [&](int t, int s) {
    const int kofs = t * BK;
    const bool k_ok = k_begin + kofs + c_col < k_end;  // K % 8 == 0: all in or all out
    bf16_t* as = As + s * A_STAGE + c_row * LDS + c_col;
    bf16_t* bs = Bs + s * B_STAGE + c_row * LDS + c_col;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const bool ok = k_ok && ((a_rows >> i) & 1u);
      cp_async16(reinterpret_cast<float*>(as + i * ROWS_PASS * LDS),
                 reinterpret_cast<const float*>(
                     ok ? a_src + (long long)i * ROWS_PASS * K + kofs : A), ok);
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const bool ok = k_ok && ((w_rows >> i) & 1u);
      cp_async16(reinterpret_cast<float*>(bs + i * ROWS_PASS * LDS),
                 reinterpret_cast<const float*>(
                     ok ? w_src + (long long)i * ROWS_PASS * K + kofs : W), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses of this lane (bytes from a stage's tile start)
  const unsigned a_lane = 2u * ((wm0 + (lane & 15)) * LDS + 8 * (lane >> 4));
  const unsigned b_lane = 2u * ((wn0 + 8 * (lane >> 4) + (lane & 7)) * LDS + 8 * ((lane >> 3) & 1));
  const unsigned as_addr = (unsigned)__cvta_generic_to_shared(As);
  const unsigned bs_addr = (unsigned)__cvta_generic_to_shared(Bs);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed for every thread, and every warp is
                      // done with the slot that the next copy refills
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) load(nxt, nxt % STAGES);
    cp_async_commit();
    const int s = t % STAGES;
    const unsigned at = as_addr + 2u * s * A_STAGE + a_lane;
    const unsigned bt = bs_addr + 2u * s * B_STAGE + b_lane;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(af[i], at + 2u * (16 * i * LDS + kk));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned bf[4];
        ldmatrix_x4(bf, bt + 2u * (16 * jp * LDS + kk));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool partial = gridDim.z > 1;
  float* part = ws + (long long)blockIdx.z * M * N;
  // acc[i][j]: rows 16 i + g (e 0, 1) and + 8 (e 2, 3), columns 8 j + 2 t4 + {0, 1}
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn0 + 8 * j + 2 * t4;
    if (col >= N) continue;  // N even: a pair is all in or all out
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (partial)
          *reinterpret_cast<float2*>(part + (long long)row * N + col) = make_float2(v0, v1);
        else
          store_pair<EPI>(C, bias, res, row, col, N, v0, v1);
      }
    }
  }
}

// C = epi(sum over z = 0..splits-1, in that order, of ws[z]): a block a
// row at a time, a column pair a thread.
template <int EPI>
__global__ void __launch_bounds__(256)
linear_bf16_splitk_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                          const bf16_t* __restrict__ res, void* C, int M, int N, int splits) {
  const long long mn = (long long)M * N;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    for (int col = 2 * threadIdx.x; col < N; col += 2 * blockDim.x) {
      const float* p = ws + (long long)row * N + col;
      float2 s = *reinterpret_cast<const float2*>(p);
      for (int z = 1; z < splits; ++z) {
        p += mn;
        const float2 v = *reinterpret_cast<const float2*>(p);
        s = make_float2(s.x + v.x, s.y + v.y);
      }
      store_pair<EPI>(C, bias, res, row, col, N, s.x, s.y);
    }
  }
}

// A plan linear_bf16 takes: every split non-empty and on k-tile edges
// (ops/fused_transformer.py:linear_plan).
inline bool valid_plan(int K, int splits, int k_chunk) {
  return splits >= 1 && splits <= MAX_SPLITS && k_chunk >= 1 && k_chunk % BK == 0 &&
         (long long)(splits - 1) * k_chunk < K && (long long)splits * k_chunk >= K;
}

// C = epi(A W^T + bias) in `splits` K ranges of k_chunk (float32 partials
// in ws), launched on `stream`; returns the launch's error.
template <int EPI>
cudaError_t linear_bf16(const bf16_t* A, const bf16_t* W, const float* bias, const bf16_t* res,
                        void* C, float* ws, int M, int N, int K, int splits, int k_chunk,
                        cudaStream_t stream) {
  const auto kernel = linear_bf16_kernel<EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(A, W, bias, res, C, ws, M, N, K, k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  linear_bf16_splitk_kernel<EPI><<<M < 4096 ? M : 4096, 256, 0, stream>>>(ws, bias, res, C, M,
                                                                         N, splits);
  return cudaGetLastError();
}

}  // namespace bf16core
}  // namespace
