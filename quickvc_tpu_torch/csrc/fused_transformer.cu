// Kernel K8: one post-norm HuBERT transformer layer, float32, for sm_90a;
// its bf16 mode, qvc_transformer_layer_bf16, is at the end of this file.
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
// 3072) = 67.9 GFLOP and the attention 4.4 GFLOP, against ~60 MB of weights
// and activations. Every product is float32-accurate on the TF32 tensor
// cores in 3xTF32 (three TF32 products each, tf32x3.cuh), so the least time
// is 3 * 72.3e9 / 495e12 = 0.437 ms at the dense TF32 rate (1.04 ms on the
// float32 FMA units).
//
// Design: the TPU kernel holds the whole layer in one grid step per batch
// item, every weight resident in VMEM; a block here has 227 KB of shared
// memory, less than one of the 2.4-9.4 MB weight matrices. So one call,
// qvc_transformer_layer, launches on the caller's stream: four linear_kernel
// GEMMs (in_proj N 2304, out_proj N 768, linear1 N 3072 at K 768; linear2
// N 768 at K 3072); K2's attention kernel (fused_attention.cuh) on the
// q/k/v column blocks of qkv, read in place through their row stride 3D;
// and row_layer_norm_kernel twice, a warp per row with the row in registers
// and the variance taken about the mean (two passes, as the TPU kernel's
// _layer_norm). The TPU kernel folds the out-projection into the per-head
// loop so that no (T, D) attention buffer exists; here the attention output
// goes through device memory once (15 MB at the encoding batch) and the
// out-projection is one GEMM. Every product is computed by this file's
// code; no cuBLAS.
//
// linear_kernel: C = epi(A W^T + bias), on mma.sync.m16n8k8 TF32 in 3xTF32.
// - Both operands are k-contiguous (A (M, K), W (N, K)), so both are staged
//   m/n-major with k contiguous (As[m][k], Bs[n][k]) by 16-byte cp.async
//   copies through a ring of 3 stages of 32 k; a row past M or N is
//   zero-filled by the copy (src-size 0) and its result dropped.
// - A block of 8 warps (4 x 2) computes a 256 x 128 tile, 64 x 64 a warp
//   (4 x 8 m16n8k8 tiles, 128 accumulators a lane), one block an SM (up to
//   255 registers a thread), as K5 (fused_disc_conv.cu). Each k8 step loads
//   and splits the warp's eight B fragments once for the four A fragments
//   they meet, and each A fragment once for the eight B fragments. (16
//   warps of 64 x 32 or 32 x 64 at 128 registers ran no faster on the H100.)
// - Fragments load as float2: the k slots of an m16n8k8 step are relabelled
//   (slot t <- k 2t, slot t+4 <- k 2t+1, the same for A and B), and the B
//   rows of each pair of n tiles are interleaved (n tile j, lane g <- row
//   16 (j / 2) + 2 g + j % 2), so that a lane's accumulators hold four
//   consecutive output columns, stored as float4. Shared rows are padded
//   (As to 40 floats, Bs to 36) so that each half-warp's 64-bit loads hit
//   distinct banks.
// - Each k8 step's three products are summed from zero and added to the
//   float32 accumulators by float32 adds (mma_3xtf32_promoted): the sum
//   inside an mma truncates with an error that scales with the accumulator,
//   and linear2 reduces over 3,072.
// - The epilogue adds the bias, then the exact erf GELU (linear1) or the
//   residual (out_proj, linear2), on the accumulator fragments.
// - Waves: the host plan (ops/fused_transformer.py:linear_plan) may cut a
//   GEMM's reduction into `splits` ranges on K-tile edges when the grid is
//   too small to fill the card (a small batch); split z writes its float32
//   partial tile to workspace[z], and linear_splitk_kernel sums the
//   partials in split order 0..s-1 and applies the epilogue. No atomics:
//   every launch on the same inputs gives the same bits. At 16 x 300 frames
//   every GEMM runs unsplit: its partials would cost more memory traffic
//   than the last wave's idle SMs.

#include <cuda_runtime.h>

#include "bf16_gemm.cuh"
#include "fused_attention.cuh"
#include "fused_attention_bf16.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = LN_THREADS / 32;  // rows per layer-norm block, one warp each
constexpr int LN_PER_LANE = 32;           // D <= 32 * 32

// The GEMM tiling (ops/fused_transformer.py: TILE_M, TILE_N, K_TILE)
constexpr int BM = 256, BN = 128, BK = 32, STAGES = 3;
constexpr int WARPS_M = 4, WARPS_N = 2, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's 64 x 64 tile
constexpr int MT = WM / 16, NT = WN / 8;             // its m16n8k8 tiles
// Padded rows for the float2 fragment loads of a half-warp (g = 0..3, t4 =
// 0..3): A reads word 40 g + 2 t4 (banks 8 g + 2 t4), B word 36 (2 g) + 2 t4
// (the same banks); both multiples of 4 floats for the 16-byte copies.
constexpr int LDA = BK + 8, LDB = BK + 4;
static_assert(LDA % 32 == 8 && (2 * LDB) % 32 == 8, "bank spread");
constexpr int A_STAGE = BM * LDA, B_STAGE = BN * LDB;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(float);  // 178,176
constexpr int COPIES_A_ROW = BK / 4;                 // 16-byte copies a row of a K tile
constexpr int ROWS_A_PASS = THREADS / COPIES_A_ROW;  // rows a pass: 32
constexpr int A_PASSES = BM / ROWS_A_PASS, B_PASSES = BN / ROWS_A_PASS;
constexpr int MAX_SPLITS = 4;  // ops/fused_transformer.py:MAX_SPLITS

enum Epilogue { BIAS = 0, BIAS_GELU = 1, BIAS_RESIDUAL = 2 };

// v (four consecutive columns col.. of row `row`) + bias, then GELU or the
// residual; N % 4 == 0
template <int EPI>
__device__ __forceinline__ float4 epilogue(float4 v, const float* __restrict__ bias,
                                           const float* __restrict__ res, long long row,
                                           int col, int N) {
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
  v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  if (EPI == BIAS_GELU) {
    v = make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z), gelu_erf(v.w));
  } else if (EPI == BIAS_RESIDUAL) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(res + row * N + col));
    v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
  }
  return v;
}

// acc += the K tile in As, Bs: four k8 steps of 3xTF32 products (k slots
// relabelled, B's rows interleaved by n-tile pair; see the head note).
__device__ __forceinline__ void mma_tile(const float* As, const float* Bs,
                                         float (&acc)[MT][NT][4], int wm0, int wn0, int g,
                                         int t4) {
#pragma unroll 1
  for (int kk = 0; kk < BK; kk += 8) {
    unsigned bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(
          Bs + (wn0 + 16 * (j / 2) + 2 * g + j % 2) * LDB + kk + 2 * t4);
      split(v.x, bb[j][0], bs[j][0]);
      split(v.y, bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // a0 (row g, slot t4), a1 (row g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
      const float* ap = As + (wm0 + 16 * i + g) * LDA + kk + 2 * t4;
      const float2 r0 = *reinterpret_cast<const float2*>(ap);
      const float2 r1 = *reinterpret_cast<const float2*>(ap + 8 * LDA);
      const float a[4] = {r0.x, r1.x, r0.y, r1.y};
      unsigned ab[4], as[4];
      split_a(a, ab, as);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_3xtf32_promoted(acc[i][j], ab, as, bb[j][0], bs[j][0], bb[j][1], bs[j][1]);
    }
  }
}

// One BM x BN tile of C = epi(A (M, K) W (N, K)^T + bias) over the K range
// [z k_chunk, (z + 1) k_chunk) of block z (blockIdx.z). With one split the
// epilogue is applied and C written; with several, block z stores its raw
// sums to C + z M N (the workspace). K % 4 == 0, N % 4 == 0.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
linear_kernel(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, const float* __restrict__ res,
              float* __restrict__ C, int M, int N, int K, int k_chunk) {
  extern __shared__ __align__(16) float linear_smem[];
  float* As = linear_smem;
  float* Bs = linear_smem + STAGES * A_STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // this thread copies 4 floats at column c_col of rows c_row + 32 i of
  // both operands' K tiles; rows past M or N read nothing
  const int c_row = tid / COPIES_A_ROW, c_col = 4 * (tid % COPIES_A_ROW);
  const float* a_src = A + (long long)(m0 + c_row) * K + k_begin + c_col;
  const float* w_src = W + (long long)(n0 + c_row) * K + k_begin + c_col;
  unsigned a_rows = 0, w_rows = 0;  // bit i: row c_row + 32 i is in range
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) a_rows |= (unsigned)(m0 + c_row + i * ROWS_A_PASS < M) << i;
#pragma unroll
  for (int i = 0; i < B_PASSES; ++i) w_rows |= (unsigned)(n0 + c_row + i * ROWS_A_PASS < N) << i;

  auto load = [&](int t, int s) {
    const int kofs = t * BK;
    const bool k_ok = k_begin + kofs + c_col < k_end;
    float* as = As + s * A_STAGE + c_row * LDA + c_col;
    float* bs = Bs + s * B_STAGE + c_row * LDB + c_col;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const bool ok = k_ok && ((a_rows >> i) & 1u);
      cp_async16(as + i * ROWS_A_PASS * LDA,
                 ok ? a_src + (long long)i * ROWS_A_PASS * K + kofs : A, ok);
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const bool ok = k_ok && ((w_rows >> i) & 1u);
      cp_async16(bs + i * ROWS_A_PASS * LDB,
                 ok ? w_src + (long long)i * ROWS_A_PASS * K + kofs : W, ok);
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

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed for every thread, and every warp is
                      // done with the slot that the next copy refills
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) load(nxt, nxt % STAGES);
    cp_async_commit();
    const int s = t % STAGES;
    mma_tile(As + s * A_STAGE, Bs + s * B_STAGE, acc, wm0, wn0, g, t4);
  }
  cp_async_wait<0>();

  const bool partial = gridDim.z > 1;
  float* out = C + (long long)blockIdx.z * M * N;
  // tile pair (2 jj, 2 jj + 1) holds columns 16 jj + 4 t4 + {0, 1, 2, 3} of
  // rows 16 i + g and + 8
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    const int col = n0 + wn0 + 16 * jj + 4 * t4;
    if (col >= N) continue;  // N % 4 == 0: a float4 is all in or all out
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + 16 * i + g + 8 * h;
        if (row >= M) continue;
        float4 v = make_float4(acc[i][2 * jj][2 * h], acc[i][2 * jj + 1][2 * h],
                               acc[i][2 * jj][2 * h + 1], acc[i][2 * jj + 1][2 * h + 1]);
        if (!partial) v = epilogue<EPI>(v, bias, res, row, col, N);
        *reinterpret_cast<float4*>(out + (long long)row * N + col) = v;
      }
    }
  }
}

// C = epi(sum over z = 0..splits-1, in that order, of ws[z]): a block a
// row at a time, a float4 a thread.
template <int EPI>
__global__ void __launch_bounds__(256)
linear_splitk_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                     const float* __restrict__ res, float* __restrict__ C, int M, int N,
                     int splits) {
  const long long mn = (long long)M * N;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    for (int col = 4 * threadIdx.x; col < N; col += 4 * blockDim.x) {
      const float* p = ws + (long long)row * N + col;
      float4 s = *reinterpret_cast<const float4*>(p);
      for (int z = 1; z < splits; ++z) {
        p += mn;
        const float4 v = *reinterpret_cast<const float4*>(p);
        s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
      }
      *reinterpret_cast<float4*>(C + (long long)row * N + col) =
          epilogue<EPI>(s, bias, res, row, col, N);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(bf16core::bf16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// y (M, D) = (x - mean) / sqrt(var + eps) * g + b over each row, D <= 1024;
// y float32, or rounded once to bf16 (the bf16 layer's x1 and output).
template <typename OutT>
__global__ void __launch_bounds__(LN_THREADS)
row_layer_norm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, OutT* __restrict__ y, int M, int D,
                      float eps) {
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
  OutT* yr = y + (long long)row * D;
#pragma unroll
  for (int i = 0; i < LN_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < D) store_value(yr + c, (v[i] - mean) * rstd * __ldg(g + c) + __ldg(b + c));
  }
}

// A plan the kernel takes: every split non-empty and on K-tile edges
// (ops/fused_transformer.py:linear_plan).
bool valid_plan(int K, int splits, int k_chunk) {
  return splits >= 1 && splits <= MAX_SPLITS && k_chunk >= 1 && k_chunk % BK == 0 &&
         (long long)(splits - 1) * k_chunk < K && (long long)splits * k_chunk >= K;
}

// C = epi(A W^T + bias) in `splits` K ranges of k_chunk (partials in ws).
template <int EPI>
cudaError_t linear(const float* A, const float* W, const float* bias, const float* res,
                   float* C, float* ws, int M, int N, int K, int splits, int k_chunk,
                   cudaStream_t stream) {
  const auto kernel = linear_kernel<EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(A, W, bias, res, splits > 1 ? ws : C, M, N, K,
                                                k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  linear_splitk_kernel<EPI><<<M < 4096 ? M : 4096, 256, 0, stream>>>(ws, bias, res, C, M, N,
                                                                    splits);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t layer_norm(const float* x, const float* g, const float* b, OutT* y, int M, int D,
                       cudaStream_t stream) {
  const int blocks = (M + LN_ROWS - 1) / LN_ROWS;
  row_layer_norm_kernel<OutT><<<blocks, LN_THREADS, 0, stream>>>(x, g, b, y, M, D, 1e-5f);
  return cudaGetLastError();
}

}  // namespace

// Kernel launches one qvc_transformer_layer call makes for these split
// counts (in_proj, out_proj, linear1, linear2): the four GEMMs, the
// attention, two LayerNorms, and a split-K sum for each split GEMM.
extern "C" int qvc_transformer_layer_launches(int s_in, int s_out, int s_1, int s_2) {
  return 7 + (s_in > 1) + (s_out > 1) + (s_1 > 1) + (s_2 > 1);
}

// out (B, T, D) from x (B, T, D) and the layer's weights in torch's layout
// (in_proj (3D, D), out_proj (D, D), linear1 (F, D), linear2 (D, F)); the
// caller allocates the scratch qkv (B*T, 3D), heads (the attention
// output), sum and x1 (B*T, D), mid (B*T, F) and, where a GEMM is split,
// the workspace (splits x B*T x N floats of the largest split GEMM). plans
// holds (splits, k_chunk) of in_proj, out_proj, linear1 and linear2 in turn.
// Needs D = H * 64 <= 1024, F % 8 == 0 and 16-byte aligned tensors.
extern "C" int qvc_transformer_layer(
    const void* x, const void* w_in, const void* b_in, const void* w_out, const void* b_out,
    const void* ln1_g, const void* ln1_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* ln2_g, const void* ln2_b, void* qkv, void* heads, void* sum,
    void* x1, void* mid, void* workspace, void* out, int batch, int T, int D, int H, int F,
    float scale, int s_in, int kc_in, int s_out, int kc_out, int s_1, int kc_1, int s_2,
    int kc_2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int M = batch * T;
  if (!valid_plan(D, s_in, kc_in) || !valid_plan(D, s_out, kc_out) ||
      !valid_plan(D, s_1, kc_1) || !valid_plan(F, s_2, kc_2) ||
      (workspace == nullptr && (s_in > 1 || s_out > 1 || s_1 > 1 || s_2 > 1)))
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  float* qkv_f = (float*)qkv;
  float* heads_f = (float*)heads;
  float* sum_f = (float*)sum;
  float* x1_f = (float*)x1;
  float* mid_f = (float*)mid;
  float* ws = (float*)workspace;
  cudaError_t err;
  if ((err = linear<BIAS>(xf, (const float*)w_in, (const float*)b_in, nullptr, qkv_f, ws, M,
                          3 * D, D, s_in, kc_in, s)))
    return (int)err;
  constexpr int HD = 64;  // head dim
  const attn::Strides qkv_s{(long long)T * 3 * D, HD, 3 * D};
  const attn::Strides heads_s{(long long)T * D, HD, D};
  if ((err = attn::launch<HD>(qkv_f, qkv_f + D, qkv_f + 2 * D, heads_f, batch, T, H, qkv_s,
                              qkv_s, qkv_s, heads_s, scale, s)))
    return (int)err;
  if ((err = linear<BIAS_RESIDUAL>(heads_f, (const float*)w_out, (const float*)b_out, xf, sum_f,
                                   ws, M, D, D, s_out, kc_out, s)))
    return (int)err;
  if ((err = layer_norm<float>(sum_f, (const float*)ln1_g, (const float*)ln1_b, x1_f, M, D, s)))
    return (int)err;
  if ((err = linear<BIAS_GELU>(x1_f, (const float*)w1, (const float*)b1, nullptr, mid_f, ws, M,
                               F, D, s_1, kc_1, s)))
    return (int)err;
  if ((err = linear<BIAS_RESIDUAL>(mid_f, (const float*)w2, (const float*)b2, x1_f, sum_f, ws,
                                   M, D, F, s_2, kc_2, s)))
    return (int)err;
  return (int)layer_norm<float>(sum_f, (const float*)ln2_g, (const float*)ln2_b, (float*)out, M,
                                D, s);
}

// The bf16 mode of the layer (the TPU kernel's cdt = bf16): x, the four
// weight matrices, the scratch qkv, heads, x1 and mid, and out are bf16;
// the biases and LayerNorm affines, the scratch sum and the workspace
// float32. It rounds where the TPU kernel rounds (fused_transformer.py:
// 63-117), every product a bf16 x bf16 -> float32 one on the persistent
// TMA + wgmma core of wgmma_bf16.cuh and every bias, LayerNorm and GELU in
// float32:
//
//   qkv = bf16(x Win^T + bin)
//   o_h = bf16(softmax(q_h k_h^T * scale) v_h)   K2's bf16 body (float32
//                                                scores, softmax and sums)
//   sum = f32(x) + heads Wout^T + bout            (= bout + sum_h o_h Wout_h)
//   x1  = bf16(LN1(sum))
//   mid = bf16(gelu_tanh(bf16(x1 W1^T + b1)))
//   sum = f32(x1) + mid W2^T + b2
//   out = bf16(LN2(sum))
//
// One difference in where it rounds: K2's bf16 body is an online softmax
// that rounds each key tile's unnormalised exp(s - m) to bf16 for the PV
// product and divides by the row sum at the end; the TPU kernel rounds the
// normalised p. Both lie within the bf16 gates (PERF.md section 2,
// tests/test_torch_attention_bf16.py's model of the body).
//
// What bounds it on this card: operations. At the encoding batch (16, 300,
// 768) the 72.3 GFLOP take 0.073 ms at the 989 TFLOP/s dense bf16 rate,
// against ~29 MB of bf16 weights and activations (0.009 ms). The GEMMs
// (67.9 of the 72.3 GFLOP) run on wgmma, the only way to the bf16 rate
// (mma.sync took them to ~150 TFLOP/s; PERF.md, K8 bf16's row).
//
// The same launches as the float32 entry (qvc_transformer_layer_launches);
// plans hold (BN, splits, k_chunk) of in_proj, out_proj, linear1 and
// linear2 from ops/fused_transformer.py:wgmma_plan, and (rows, bn, stages)
// of the attention from ops/fused_attention.py:bf16_attention_plan. Needs D = H * 64 <=
// 1024, F % 8 == 0 and 16-byte aligned tensors.
extern "C" int qvc_transformer_layer_bf16(
    const void* x, const void* w_in, const void* b_in, const void* w_out, const void* b_out,
    const void* ln1_g, const void* ln1_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* ln2_g, const void* ln2_b, void* qkv, void* heads, void* sum,
    void* x1, void* mid, void* workspace, void* out, int batch, int T, int D, int H, int F,
    float scale, int bn_in, int s_in, int kc_in, int bn_out, int s_out, int kc_out, int bn_1,
    int s_1, int kc_1, int bn_2, int s_2, int kc_2, int attn_rows, int attn_bn, int attn_stages,
    void* stream) {
  using bf16core::bf16_t;
  using wg::linear;
  const cudaStream_t s = (cudaStream_t)stream;
  const int M = batch * T;
  if (!wg::valid_plan(D, bn_in, s_in, kc_in) || !wg::valid_plan(D, bn_out, s_out, kc_out) ||
      !wg::valid_plan(D, bn_1, s_1, kc_1) || !wg::valid_plan(F, bn_2, s_2, kc_2) ||
      (workspace == nullptr && (s_in > 1 || s_out > 1 || s_1 > 1 || s_2 > 1)))
    return (int)cudaErrorInvalidValue;
  const bf16_t* xb = (const bf16_t*)x;
  bf16_t* qkv_b = (bf16_t*)qkv;
  bf16_t* heads_b = (bf16_t*)heads;
  float* sum_f = (float*)sum;
  bf16_t* x1_b = (bf16_t*)x1;
  bf16_t* mid_b = (bf16_t*)mid;
  float* ws = (float*)workspace;
  using bf16core::GELU;
  using bf16core::RESIDUAL;
  using bf16core::ROUND;
  cudaError_t err;
  if ((err = linear<ROUND>(xb, (const bf16_t*)w_in, (const float*)b_in, nullptr, qkv_b, ws, M,
                           3 * D, D, bn_in, s_in, kc_in, s)))
    return (int)err;
  constexpr int HD = 64;  // head dim
  const attn_bf16::Strides qkv_s{(long long)T * 3 * D, HD, 3 * D};
  const attn_bf16::Strides heads_s{(long long)T * D, HD, D};
  if ((err = attn_bf16::launch<HD>({attn_rows, attn_bn, attn_stages}, qkv_b, qkv_b + D,
                                   qkv_b + 2 * D, heads_b, batch, T, H, qkv_s, qkv_s, qkv_s,
                                   heads_s, scale, s)))
    return (int)err;
  if ((err = linear<RESIDUAL>(heads_b, (const bf16_t*)w_out, (const float*)b_out, xb, sum_f, ws,
                              M, D, D, bn_out, s_out, kc_out, s)))
    return (int)err;
  if ((err = layer_norm<bf16_t>(sum_f, (const float*)ln1_g, (const float*)ln1_b, x1_b, M, D, s)))
    return (int)err;
  if ((err = linear<GELU>(x1_b, (const bf16_t*)w1, (const float*)b1, nullptr, mid_b, ws, M, F,
                          D, bn_1, s_1, kc_1, s)))
    return (int)err;
  if ((err = linear<RESIDUAL>(mid_b, (const bf16_t*)w2, (const float*)b2, x1_b, sum_f, ws, M, D,
                              F, bn_2, s_2, kc_2, s)))
    return (int)err;
  return (int)layer_norm<bf16_t>(sum_f, (const float*)ln2_g, (const float*)ln2_b, (bf16_t*)out,
                                 M, D, s);
}
