// Kernel K7: HuBERT's feature-extractor front, conv0 (k=10, stride 5,
// 1 -> C, no bias) -> per-(batch, channel) affine -> GELU -> conv1 (k=3,
// stride 2, C -> C, no bias) -> GELU, float32, for sm_90a; its bf16 mode,
// qvc_extractor_front_bf16, is at the end of this file.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_extractor.py:
// fused_extractor_front (pallas_call at fused_extractor.py:187; body _kernel
// at :92-110). The affine (scale, shift) is GroupNorm(C, C) of conv0's output
// in closed form from the wave (groupnorm_affine_closed_form), computed
// outside the kernel in plain PyTorch, as JAX computes it outside its kernel.
// With h[t, c] = gelu(scale[c] * sum_k wav[5t + k] w0[c, k] + shift[c]):
//
//   out[b, u, o] = gelu(sum_{j < 3, c < C} h[2u + j, c] * w1[j, c, o])
//
// What bounds it on this card: operations. At the encoding batch (16, 96080)
// conv1 is 2 * 16 * 9607 * 512 * 1536 = 242 GFLOP against ~320 MB moved
// (the (16, 9607, 512) output dominates). conv1 is float32-accurate on the
// TF32 tensor cores in 3xTF32 (three TF32 products each, tf32x3.cuh), so its
// least time is 3 * 242e9 / 495e12 = 1.47 ms at the dense TF32 rate; conv0
// (3.1 GFLOP, on the FMA units) adds 0.05 ms.
//
// Design: conv1 is an implicit GEMM on mma.sync.m16n8k8 TF32 in 3xTF32 over
// K = 3 taps x C in-channels, whose h operand never comes from memory, so
// conv0's (B, T/5, C) output (630 MB at the encoding batch) never reaches
// device memory, which is what the TPU kernel bought.
// - The mma computes out^T: its A operand is conv1's weight (M = output
//   channels), its B operand h (N = output rows u). A B fragment is one
//   row's two k slots, so a lane loads it with one float2 straight into the
//   register pair the mma reads. With h as the A operand, each A fragment
//   came from two loads in the wrong register order and ptxas rebuilt it
//   with moves before every mma.
// - A block of 8 warps computes 64 output rows x 512 channels, 64 x 64 a
//   warp (4 x 8 m16n8k8 tiles, 128 accumulators a lane), one block an SM.
//   Covering all 512 channels means each conv0 value is computed once (a
//   128-channel tile would compute it four times).
// - The block stages its wave segment once. K walks in slices of KC = 8
//   in-channels, all three taps: for each slice the block computes the 129
//   conv0 rows its 64 output rows need (10 FMAs from the staged wave, the
//   affine, the exact erf GELU) and stores each value once, already split
//   into its TF32 big and small parts (tf32x3.cuh:split), in H[row][c]:
//   the mainloop never splits h. Tap j of output row u reads row 2u + j:
//   row 2u feeds tap 0 of row u and tap 2 of row u - 1, row 2u + 1 tap 1 of
//   row u. The k8 step of tap j is (j, the slice's 8 channels); the k order
//   is slice, tap, channel.
// - conv1's weight, w1t [tap][in][out], comes by 16-byte cp.async copies,
//   the slice's 3 x 8 rows of 512 channels staged k-major (W[k][o], padded
//   to 516 floats) through a ring of 3 stages, with the next slice's conv0
//   weights, scale and shift, so that production reads them from shared
//   memory. An A fragment is two float2 loads (output channels 16 i + 2 g
//   and + 1 as the tile's rows g and g + 8, so that a lane's two rows are
//   adjacent), split once for the eight B fragments it meets. Each B
//   fragment meets the tap's four A fragments in turn, the three passes of
//   those four products issued pass by pass (summed as mma_3xtf32_promoted
//   sums them): 52 registers of fragments and partial sums live, not the
//   72 of one A fragment meeting eight B fragments, which spilled.
// - Overlap: H is double-buffered, one barrier a slice: each warp produces
//   its share of slice t + 1 into the other buffer, then runs its mmas of
//   slice t, so that a warp's conv0 (FMA and SFU pipes) can fill the issue
//   slots the other warps' mma chains leave. On the H100 it hides little of
//   the production; placing it between the m-tiles of a tap, or by half the
//   warps after their mmas, spilled and ran slower.
// - Each k8 step's three products are summed from zero and added to the
//   float32 accumulators (mma_3xtf32_promoted), as in K5/K6. The epilogue
//   applies the exact erf GELU to the accumulators and stores a lane's two
//   adjacent channels as float2.

#include <cuda_runtime.h>

#include "bf16_gemm.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int KC = 8;               // in-channels a K slice
constexpr int BK = 3 * KC;          // K slice: 3 taps x KC channels, one k8 step a tap
constexpr int BM = 64, BN = 512;    // output rows x output channels a block
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WN = BN / WARPS;            // a warp's channels, of all BM rows
constexpr int MT = WN / 16, NT = BM / 8;  // its m16n8k8 tiles
constexpr int STAGES = 3;           // ring of conv1 weight slices
constexpr int HROWS = 2 * BM + 1;   // conv0 rows a row tile needs
// Padded rows for the float2 fragment loads of a half-warp (g = 0..3, t4 =
// 0..3): H reads word 12 (2 g) + 2 t4 (banks 24 g + 2 t4 mod 32), W word
// 516 (2 t4) + 2 g (banks 8 t4 + 2 g); the producers' stores of four
// consecutive row pairs x 8 channels hit 32 distinct banks.
constexpr int LDH = KC + 4, LDW = BN + 4;
static_assert((2 * LDH) % 32 == 24 && LDW % 16 == 4, "bank spread");
constexpr int H_FLOATS = HROWS * LDH;  // one part (big or small) of one buffer
// A stage of the ring: conv1's BK x LDW weight rows of slice t, then the
// conv0 weights (KC x 10), scale and shift (KC each) of slice t + 1
constexpr int V_FLOATS = KC * 10 + 2 * KC;
constexpr int STAGE = BK * LDW + V_FLOATS;
// wave samples a row tile reads: rows 0..128 read [5r, 5r + 10); the
// producers read 16 from each even row
constexpr int WAVE = 5 * (HROWS - 1) + 16;
constexpr int SMEM_BYTES = (4 * H_FLOATS + STAGES * STAGE + WAVE) * (int)sizeof(float);
constexpr int PAIRS_PASS = THREADS / KC;  // row pairs a pass of the producers: 32
constexpr int PAIR_PASSES = (HROWS - 1) / (2 * PAIRS_PASS);
static_assert(2 * PAIRS_PASS * PAIR_PASSES == HROWS - 1, "whole passes of row pairs, then one row");
constexpr int W_COPIES_ROW = BN / 4;  // 16-byte copies a weight row
constexpr int W_ROWS_PASS = THREADS / W_COPIES_ROW;
constexpr int W_PASSES = BK / W_ROWS_PASS;
static_assert(W_PASSES * W_ROWS_PASS == BK && KC % W_ROWS_PASS == 0,
              "whole passes, each within one tap");

// conv0 row r (of the tile) in channel cc -> affine -> GELU, stored split
// into big (Hb) and small (Hs); s holds wave[5 r .. 5 r + 9]
__device__ __forceinline__ void store_row(const float* s, const float (&w)[10], float sc,
                                          float sh, float* Hb, float* Hs, int r, int cc) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k) x = fmaf(s[k], w[k], x);
  unsigned big, small;
  split(gelu_erf(fmaf(x, sc, sh)), big, small);
  Hb[r * LDH + cc] = __uint_as_float(big);
  Hs[r * LDH + cc] = __uint_as_float(small);
}

// This thread's share of one slice of H: channel cc of the row pairs
// (2P, 2P + 1), P = p + 32 q, and the last row where p == 0, from the
// channel's conv0 weights w, scale sc and shift sh.
__device__ __forceinline__ void produce(const float* __restrict__ ws, float* Hb, float* Hs,
                                        const float (&w)[10], float sc, float sh, int cc,
                                        int p) {
#pragma unroll
  for (int q = 0; q < PAIR_PASSES; ++q) {
    const int P = p + PAIRS_PASS * q;
    float s[16];  // wave[10 P .. 10 P + 15]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(ws + 10 * P + 2 * i);
      s[2 * i] = v.x;
      s[2 * i + 1] = v.y;
    }
    store_row(s, w, sc, sh, Hb, Hs, 2 * P, cc);
    store_row(s + 5, w, sc, sh, Hb, Hs, 2 * P + 1, cc);
  }
  if (p == 0) store_row(ws + 5 * (HROWS - 1), w, sc, sh, Hb, Hs, HROWS - 1, cc);
}

// acc += the k8 step of tap j: A from the slice's weight rows j KC .. j KC
// + 7 (channels wc0 + 16 i + 2 g and + 1 as rows g and g + 8), B from H
// (rows 2 u + j of the tile's output rows u = 8 jn + g, split at
// production). The MT A fragments are split once; each B fragment then
// meets them in turn, its products issued pass by pass over the MT tiles.
__device__ __forceinline__ void mma_tap(const float* Hb, const float* Hs, const float* W, int j,
                                        float (&acc)[MT][NT][4], int wc0, int g, int t4) {
  unsigned ab[MT][4], as[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* wp = W + (j * KC + 2 * t4) * LDW + wc0 + 16 * i + 2 * g;
    const float2 w0 = *reinterpret_cast<const float2*>(wp);
    const float2 w1 = *reinterpret_cast<const float2*>(wp + LDW);
    // a0 (row g, slot t4), a1 (row g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
    const float a[4] = {w0.x, w0.y, w1.x, w1.y};
    split_a(a, ab[i], as[i]);
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {  // b0 (slot t4) = channel 2 t4, b1 (slot t4 + 4) = 2 t4 + 1
    const int r = 2 * (8 * jn + g) + j;
    const uint2 bb = *reinterpret_cast<const uint2*>(Hb + r * LDH + 2 * t4);
    const uint2 bs = *reinterpret_cast<const uint2*>(Hs + r * LDH + 2 * t4);
    float t[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_tf32_zero(t[i], as[i], bb.x, bb.y);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_tf32(t[i], ab[i], bs.x, bs.y);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_tf32(t[i], ab[i], bb.x, bb.y);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] += t[i][e];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
extractor_front_kernel(const float* __restrict__ wav, const float* __restrict__ w0,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       const float* __restrict__ w1t, float* __restrict__ out, int T, int C,
                       int n1) {
  extern __shared__ __align__(16) float front_smem[];
  float* H = front_smem;                  // [buffer][big, small][HROWS][LDH]
  float* Ring = front_smem + 4 * H_FLOATS;  // [stage][BK x LDW weights, V_FLOATS]
  float* ws = Ring + STAGES * STAGE;      // [WAVE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc0 = warp * WN;
  const int c0 = blockIdx.x * BN;
  const int u0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int n_slices = C / KC;
  scale += (long long)b * C;
  shift += (long long)b * C;

  // conv0 row r of this tile is t = 2 u0 + r and reads wav[5t .. 5t + 9];
  // samples past the wave's end read as zeros and feed only rows u >= n1
  const float* wb = wav + (long long)b * T;
  const long long base = 10LL * u0;
  for (int i = tid; i < WAVE; i += THREADS) ws[i] = base + i < T ? wb[base + i] : 0.0f;

  // stage s: weight row kk = j KC + cc of slice t is w1t[j, KC t + cc, c0 ..
  // c0 + BN - 1]; then w0, scale and shift of slice t + 1's channels. Pass i
  // copies row w_row0 + 2 i: tap 2 i / KC, channel w_row0 + 2 i % KC, so one
  // pointer a slice and offsets known at compile time address them all.
  const int w_row0 = tid / W_COPIES_ROW, w_col = 4 * (tid % W_COPIES_ROW);
  const bool w_ok = c0 + w_col < C;  // C % 4 == 0: a copy is all in or all out
  const float* w_src = w1t + (long long)w_row0 * C + c0 + w_col;
  // this thread's copy of the next slice's w0 (threads 0-19), scale (20, 21)
  // or shift (22, 23)
  const float* v_src = tid < 5 * KC / 2 ? w0 + 4 * tid
                       : tid < 5 * KC / 2 + KC / 4 ? scale + 4 * (tid - 5 * KC / 2)
                                                   : shift + 4 * (tid - 5 * KC / 2 - KC / 4);
  const int v_stride = tid < 5 * KC / 2 ? 10 : 1;  // floats a channel
  auto load_stage = [&](int t, int s) {
    float* st = Ring + s * STAGE;
    const float* src_t = w_src + (long long)KC * t * C;
#pragma unroll
    for (int i = 0; i < W_PASSES; ++i) {
      const int j = i * W_ROWS_PASS / KC, c = i * W_ROWS_PASS % KC;
      cp_async16(st + (w_row0 + i * W_ROWS_PASS) * LDW + w_col,
                 w_ok ? src_t + (j * C + c) * C : w1t, w_ok);
    }
    if (tid < V_FLOATS / 4 && t + 1 < n_slices)
      cp_async16(st + BK * LDW + 4 * tid, v_src + KC * (t + 1) * v_stride, true);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) load_stage(s, s);
    cp_async_commit();
  }

  // this thread produces channel cc of row pairs p + 32 q of every slice
  const int cc = tid % KC, p = tid / KC;
  {
    float w[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) w[k] = __ldg(w0 + cc * 10 + k);
    __syncthreads();  // the wave is staged
    produce(ws, H, H + H_FLOATS, w, __ldg(scale + cc), __ldg(shift + cc), cc, p);
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice t's H is produced and its stage has landed for
                      // every thread; every warp is done with slice t - 1's
    const int nxt = t + STAGES - 1;
    if (nxt < n_slices) load_stage(nxt, nxt % STAGES);
    cp_async_commit();
    const float* hb = H + (t & 1) * 2 * H_FLOATS;
    const float* st = Ring + (t % STAGES) * STAGE;
    if (t + 1 < n_slices) {  // slice t + 1 into the other buffer
      const float* v = st + BK * LDW;  // its w0, scale and shift
      float* nb = H + ((t + 1) & 1) * 2 * H_FLOATS;
      float w[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) w[k] = v[cc * 10 + k];
      produce(ws, nb, nb + H_FLOATS, w, v[10 * KC + cc], v[11 * KC + cc], cc, p);
    }
#pragma unroll 1  // the three taps in a loop: unrolled, ptxas spilled
    for (int j = 0; j < 3; ++j) mma_tap(hb, hb + H_FLOATS, st, j, acc, wc0, g, t4);
  }
  cp_async_wait<0>();

  // acc[i][jn]: channels c (row g) and c + 1 (row g + 8), c = 16 i + 2 g, of
  // output rows u = 8 jn + 2 t4 (e 0, 2) and u + 1 (e 1, 3)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int c = c0 + wc0 + 16 * i + 2 * g;
    if (c >= C) continue;  // C % 2 == 0: a pair is all in or all out
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + 8 * jn + 2 * t4 + h;
        if (u >= n1) continue;
        *reinterpret_cast<float2*>(out + ((long long)b * n1 + u) * C + c) =
            make_float2(gelu_erf(acc[i][jn][h]), gelu_erf(acc[i][jn][2 + h]));
      }
    }
  }
}

}  // namespace

// out (B, n1, C) from wav (B, T), w0 (C, 10), scale/shift (B, C) and
// w1t (3, C, C) = conv1's weight as [tap][in][out]. Needs C % 8 == 0,
// n1 = ((T - 10) / 5 + 1 - 3) / 2 + 1 >= 1, and w0, scale, shift and w1t
// 16-byte aligned.
extern "C" int qvc_extractor_front(const void* wav, const void* w0, const void* scale,
                                   const void* shift, const void* w1t, void* out, int batch,
                                   int T, int C, int n1, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      extractor_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(extractor_front_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BN - 1) / BN, (n1 + BM - 1) / BM, batch);
  extractor_front_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)w0, (const float*)scale, (const float*)shift,
      (const float*)w1t, (float*)out, T, C, n1);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 mode of K7 (the TPU kernel's cdt = bf16, _kernel at
// fused_extractor.py:92-110 with a bf16 wave): the wave and conv1's weight
// are bf16 and the output is bf16. As the TPU kernel computes it:
//
//   h[t, c]      = bf16(gelu_tanh(bf16(scale[c] * sum_k wav[5t + k] w0b[c, k] + shift[c])))
//   out[b, u, o] = bf16(gelu_tanh(bf16(sum_{j < 3, c < C} h[2u + j, c] * w1[j, c, o])))
//
// with w0b = conv0's weight rounded to bf16 (the MXU's operand) and (scale,
// shift) from the closed form on the unrounded weight, computed outside the
// kernel as JAX computes them (groupnorm_affine_closed_form). A product of
// two bf16 values is exact in float32, so conv0's 10 float32 FMAs give what
// the MXU's bf16 x bf16 -> float32 product gives, up to the order of the sum.
//
// What bounds it on this card: operations. At the encoding batch (16, 96080)
// conv1's 242 GFLOP take 0.245 ms at the 989 TFLOP/s dense bf16 rate and
// conv0's 3.1 GFLOP 0.046 ms on the float32 FMA units, against ~157 MB of
// bf16 wave, weights and output (0.047 ms).
//
// Design: the float32 kernel's, on the bf16 core's fragments (bf16_gemm.cuh):
// - conv1 is the implicit GEMM out^T = w1^T h: A = conv1's weight (M = output
//   channels), B = h (N = output rows u), K = 3 taps x C, walked in slices
//   of KC = 16 in-channels, one m16n8k16 step a tap. A block of 8 warps
//   computes 64 rows x 512 channels, 64 channels x 64 rows a warp (4 x 8
//   tiles, 128 float32 accumulators a lane), one block an SM.
// - h is produced on chip a slice ahead, as bf16 (no TF32 split, half the
//   float32 kernel's bytes), double-buffered, with the even conv0 rows and
//   the odd ones in two arrays: tap j of output row u reads row 2u + j, so
//   the 8 rows of an ldmatrix phase are consecutive rows of one array, whose
//   48-byte pitch puts them on 8 distinct 16-byte bank groups.
// - w1t [tap][in][out] (bf16) comes by 16-byte cp.async copies through a
//   ring of 3 stages, the slice's 3 x 16 rows of 512 channels staged k-major
//   (W[k][o], padded to 520 values), with the next slice's bf16-valued conv0
//   weights, scale and shift in float32. A fragments come from it through
//   ldmatrix.x4.trans, B fragments from h through ldmatrix.x4.
// - The host permutes the output channels within each group of 16 (position
//   q < 8 holds channel 2q, position 8 + q channel 2q + 1), so that a lane's
//   accumulators hold two adjacent channels of two rows: one 4-byte store of
//   a bf16 pair each.

namespace {
namespace front_bf16 {

using bf16core::bf16_t;

constexpr int KC = 16;              // in-channels a K slice: one k16 step a tap
constexpr int BK = 3 * KC;          // K slice: 3 taps x KC channels
constexpr int BM = 64, BN = 512;    // output rows x output channels a block
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WN = BN / WARPS;            // a warp's channels, of all BM rows
constexpr int MT = WN / 16, NT = BM / 8;  // its m16n8k16 tiles
constexpr int STAGES = 3;           // ring of conv1 weight slices
constexpr int HROWS = 2 * BM + 1;   // conv0 rows a row tile needs
constexpr int HEVEN = BM + 1, HODD = BM;
constexpr int LDH = KC + 8;         // 48 bytes: 3 16-byte units, odd
constexpr int LDW = BN + 8;         // 1040 bytes: 65 16-byte units, odd
static_assert((LDH * 2 / 16) % 2 == 1 && (LDW * 2 / 16) % 2 == 1, "ldmatrix bank spread");
constexpr int H_VALUES = (HEVEN + HODD) * LDH;  // one buffer: even rows, then odd rows
// A stage of the ring: conv1's BK x LDW weight rows of slice t (bf16), then
// the conv0 weights (KC x 10), scale and shift (KC each) of slice t + 1
// (float32)
constexpr int V_FLOATS = KC * 10 + 2 * KC;
constexpr int W_BYTES = BK * LDW * (int)sizeof(bf16_t);
constexpr int STAGE_BYTES = W_BYTES + V_FLOATS * (int)sizeof(float);
static_assert(W_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte aligned stages");
// wave samples a row tile reads: rows 0..128 read [5r, 5r + 10); the
// producers read 16 from each even row
constexpr int WAVE = 5 * (HROWS - 1) + 16;
constexpr int SMEM_BYTES =
    2 * H_VALUES * (int)sizeof(bf16_t) + STAGES * STAGE_BYTES + WAVE * (int)sizeof(float);
constexpr int PAIRS_PASS = THREADS / KC;  // row pairs a pass of the producers: 16
constexpr int PAIR_PASSES = (HROWS - 1) / (2 * PAIRS_PASS);
static_assert(2 * PAIRS_PASS * PAIR_PASSES == HROWS - 1, "whole passes of row pairs, then one row");
constexpr int W_COPIES_ROW = BN / 8;  // 16-byte copies a weight row
constexpr int W_ROWS_PASS = THREADS / W_COPIES_ROW;
constexpr int W_PASSES = BK / W_ROWS_PASS;
static_assert(W_PASSES * W_ROWS_PASS == BK && KC % W_ROWS_PASS == 0,
              "whole passes, each within one tap");
static_assert(V_FLOATS / 4 <= THREADS, "one copy a thread for the slice's conv0 values");

// conv0 row r of the tile in channel cc -> affine -> GELU, stored as bf16 in
// H (even rows first, then odd); s holds wave[5 r .. 5 r + 9]
__device__ __forceinline__ void store_row(const float* s, const float (&w)[10], float sc,
                                          float sh, bf16_t* H, int r, int cc) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k) x = fmaf(s[k], w[k], x);
  const float h = bf16core::gelu_tanh(bf16core::round_bf16(fmaf(x, sc, sh)));
  const int row = (r & 1) ? HEVEN + (r >> 1) : r >> 1;
  H[row * LDH + cc] = __bfloat16_as_ushort(__float2bfloat16_rn(h));
}

// This thread's share of one slice of H: channel cc of the row pairs
// (2P, 2P + 1), P = p + 16 q, and the last row where p == 0.
__device__ __forceinline__ void produce(const float* __restrict__ ws, bf16_t* H,
                                        const float (&w)[10], float sc, float sh, int cc,
                                        int p) {
#pragma unroll
  for (int q = 0; q < PAIR_PASSES; ++q) {
    const int P = p + PAIRS_PASS * q;
    float s[16];  // wave[10 P .. 10 P + 15]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(ws + 10 * P + 2 * i);
      s[2 * i] = v.x;
      s[2 * i + 1] = v.y;
    }
    store_row(s, w, sc, sh, H, 2 * P, cc);
    store_row(s + 5, w, sc, sh, H, 2 * P + 1, cc);
  }
  if (p == 0) store_row(ws + 5 * (HROWS - 1), w, sc, sh, H, HROWS - 1, cc);
}

// acc += the k16 step of tap j: A from the stage's weight rows j KC ..
// j KC + 15 (output positions wc0 + 16 i ..), B from H rows 2 u + j of
// the tile's rows u = 16 jp .. 16 jp + 15.
__device__ __forceinline__ void mma_tap(unsigned h_addr, unsigned w_addr, int j,
                                        float (&acc)[MT][NT][4]) {
  unsigned af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    bf16core::ldmatrix_x4_trans(af[i], w_addr + 2u * (j * KC * LDW + 16 * i));
  // tap 0 reads even row u, tap 1 odd row u, tap 2 even row u + 1
  const unsigned hj = h_addr + 2u * (j == 1 ? HEVEN * LDH : (j == 2 ? LDH : 0));
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    unsigned bf[4];
    bf16core::ldmatrix_x4(bf, hj + 2u * (16 * jp * LDH));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      bf16core::mma_bf16(acc[i][2 * jp], af[i], bf[0], bf[1]);
      bf16core::mma_bf16(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
extractor_front_bf16_kernel(const bf16_t* __restrict__ wav, const float* __restrict__ w0,
                            const float* __restrict__ scale, const float* __restrict__ shift,
                            const bf16_t* __restrict__ w1t, bf16_t* __restrict__ out, int T,
                            int C, int n1) {
  extern __shared__ __align__(16) unsigned char front_bf16_smem[];
  bf16_t* H = reinterpret_cast<bf16_t*>(front_bf16_smem);  // [buffer][even, odd rows][LDH]
  unsigned char* Ring = front_bf16_smem + 2 * H_VALUES * sizeof(bf16_t);
  float* ws = reinterpret_cast<float*>(Ring + STAGES * STAGE_BYTES);  // [WAVE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wc0 = warp * WN;
  const int c0 = blockIdx.x * BN;
  const int u0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int n_slices = C / KC;
  scale += (long long)b * C;
  shift += (long long)b * C;

  // conv0 row r of this tile is t = 2 u0 + r and reads wav[5t .. 5t + 9];
  // samples past the wave's end read as zeros and feed only rows u >= n1
  const bf16_t* wb = wav + (long long)b * T;
  const long long base = 10LL * u0;
  for (int i = tid; i < WAVE; i += THREADS)
    ws[i] = base + i < T ? bf16core::bf16_to_float(wb[base + i]) : 0.0f;

  // stage s: weight row kk = j KC + cc of slice t is w1t[j, KC t + cc, c0 ..
  // c0 + BN - 1]; then w0, scale and shift of slice t + 1's channels. Pass i
  // copies row w_row0 + 4 i: tap 4 i / KC, channel w_row0 + 4 i % KC.
  const int w_row0 = tid / W_COPIES_ROW, w_col = 8 * (tid % W_COPIES_ROW);
  const bool w_ok = c0 + w_col < C;  // C % 8 == 0: a copy is all in or all out
  const bf16_t* w_src = w1t + (long long)w_row0 * C + c0 + w_col;
  // this thread's copy of the next slice's w0 (threads 0-39), scale (40-43)
  // or shift (44-47)
  const float* v_src = tid < 5 * KC / 2 ? w0 + 4 * tid
                       : tid < 5 * KC / 2 + KC / 4 ? scale + 4 * (tid - 5 * KC / 2)
                                                   : shift + 4 * (tid - 5 * KC / 2 - KC / 4);
  const int v_stride = tid < 5 * KC / 2 ? 10 : 1;  // floats a channel
  auto load_stage = [&](int t, int s) {
    unsigned char* st = Ring + s * STAGE_BYTES;
    const bf16_t* src_t = w_src + (long long)KC * t * C;
#pragma unroll
    for (int i = 0; i < W_PASSES; ++i) {
      const int j = i * W_ROWS_PASS / KC, c = i * W_ROWS_PASS % KC;
      cp_async16(reinterpret_cast<float*>(st) + ((w_row0 + i * W_ROWS_PASS) * LDW + w_col) / 2,
                 reinterpret_cast<const float*>(w_ok ? src_t + (long long)(j * C + c) * C : w1t),
                 w_ok);
    }
    if (tid < V_FLOATS / 4 && t + 1 < n_slices)
      cp_async16(reinterpret_cast<float*>(st + W_BYTES) + 4 * tid,
                 v_src + KC * (t + 1) * v_stride, true);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) load_stage(s, s);
    cp_async_commit();
  }

  // this thread produces channel cc of row pairs p + 16 q of every slice
  const int cc = tid % KC, p = tid / KC;
  {
    float w[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) w[k] = __ldg(w0 + cc * 10 + k);
    __syncthreads();  // the wave is staged
    produce(ws, H, w, __ldg(scale + cc), __ldg(shift + cc), cc, p);
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses of this lane: A (transposed, from W[k][o]): k row
  // 8 (l / 16) + l % 8, channels 8 ((l / 8) % 2) of the m tile; B (from H):
  // row u = 8 (l / 16) + l % 8 of the tile pair, channels 8 ((l / 8) % 2)
  const int lrow = 8 * (lane >> 4) + (lane & 7), lcol = 8 * ((lane >> 3) & 1);
  const unsigned h_lane = (unsigned)__cvta_generic_to_shared(H) + 2u * (lrow * LDH + lcol);
  const unsigned w_lane =
      (unsigned)__cvta_generic_to_shared(Ring) + 2u * (lrow * LDW + wc0 + lcol);

  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice t's H is produced and its stage has landed for
                      // every thread; every warp is done with slice t - 1's
    const int nxt = t + STAGES - 1;
    if (nxt < n_slices) load_stage(nxt, nxt % STAGES);
    cp_async_commit();
    const unsigned char* st = Ring + (t % STAGES) * STAGE_BYTES;
    if (t + 1 < n_slices) {  // slice t + 1 into the other buffer
      const float* v = reinterpret_cast<const float*>(st + W_BYTES);  // its w0, scale, shift
      float w[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) w[k] = v[cc * 10 + k];
      produce(ws, H + ((t + 1) & 1) * H_VALUES, w, v[10 * KC + cc], v[11 * KC + cc], cc, p);
    }
    const unsigned hb = h_lane + 2u * (t & 1) * H_VALUES;
    const unsigned wt = w_lane + (t % STAGES) * STAGE_BYTES;
#pragma unroll 1  // the three taps in a loop, as in the float32 kernel
    for (int j = 0; j < 3; ++j) mma_tap(hb, wt, j, acc);
  }
  cp_async_wait<0>();

  // acc[i][jn]: channels c (e 0, 1) and c + 1 (e 2, 3), c = 16 i + 2 g after
  // the host's permutation, of output rows u = 8 jn + 2 t4 (e 0, 2) and
  // u + 1 (e 1, 3)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int c = c0 + wc0 + 16 * i + 2 * g;
    if (c >= C) continue;  // C % 16 == 0: a pair is all in or all out
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + 8 * jn + 2 * t4 + h;
        if (u >= n1) continue;
        *reinterpret_cast<unsigned*>(out + ((long long)b * n1 + u) * C + c) =
            bf16core::pack_bf16(
                bf16core::gelu_tanh(bf16core::round_bf16(acc[i][jn][h])),
                bf16core::gelu_tanh(bf16core::round_bf16(acc[i][jn][2 + h])));
      }
    }
  }
}

}  // namespace front_bf16

}  // namespace

// The bf16 mode: out (B, n1, C) bf16 from wav (B, T) bf16, w0 (C, 10)
// float32 holding bf16 values (conv0's weight rounded), scale/shift (B, C)
// float32 (the closed form on the unrounded weight) and w1t (3, C, C) bf16 =
// conv1's weight as [tap][in][out], its output channels permuted within
// each group of 16 (position q < 8 holds channel 2q, 8 + q channel 2q + 1;
// ops/fused_extractor.py:bf16_channel_order). Needs C % 16 == 0,
// n1 >= 1, and w0, scale, shift and w1t 16-byte aligned.
extern "C" int qvc_extractor_front_bf16(const void* wav, const void* w0, const void* scale,
                                        const void* shift, const void* w1t, void* out,
                                        int batch, int T, int C, int n1, void* stream) {
  namespace fb = front_bf16;
  cudaError_t err = cudaFuncSetAttribute(
      fb::extractor_front_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fb::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fb::extractor_front_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (C % fb::KC) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + fb::BN - 1) / fb::BN, (n1 + fb::BM - 1) / fb::BM, batch);
  fb::extractor_front_bf16_kernel<<<grid, fb::THREADS, fb::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const fb::bf16_t*)wav, (const float*)w0, (const float*)scale, (const float*)shift,
      (const fb::bf16_t*)w1t, (fb::bf16_t*)out, T, C, n1);
  return (int)cudaGetLastError();
}
