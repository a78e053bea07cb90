// K5 (k=5 conv + bias + LeakyReLU, and its dx) and K6 (its dW) at bf16 on
// TMA + wgmma, for sm_90a: the persistent ring of wgmma_bf16.cuh over the
// discriminator's implicit GEMM.
//
// Replaces the bf16 branch of the TPU kernels
// quickvc_tpu/ops/fused_disc_conv.py:conv5_lrelu (forward pallas_call at :117,
// body :41-67; dx :146-147) and its dW pallas_call (:156, body :70-90). With
// x (N, R, C_in), the filter K (5, C_in, C_out), dym (N, R, C_out), bf16:
//
//   K5:  y[n, r, o]   = bf16(lrelu(sum_{dr, c} x[n, r + dr - 2, c] K[dr, c, o] + float(b[o])))
//   K6:  dW[dr, c, o] = bf16(sum_{n, r} x[n, r + dr - 2, c] dym[n, r, o])
//
// rows outside [0, R) read as zero; every product of two bf16 values exact
// in float32, the sums, bias and LeakyReLU in float32, one rounding at the
// end. dx is K5 on dym with the flipped, transposed filter, no bias, slope 1.
// This is the same function as fused_disc_conv.cu's bf16 mode (the mma.sync
// body), which keeps the shapes this one does not take.
//
// What bounds them on this card: operations. At DiscriminatorP(2)'s fifth
// conv of the paired D phase (x (128, 64, 1024)) each call is 85.9 GFLOP,
// 0.087 ms at the 989 TFLOP/s dense bf16 rate, against ~44 MB of bf16 moved
// (0.013 ms). Only wgmma reaches that rate; the GEMMs are long (K5 reduces
// over 5 C_in = 5,120, K6 over N R = 8,192-8,512), K11's regime.
//
// The operands, as wgmma reads them (one implicit GEMM, no im2col copy):
//
//   GEMM                      A (M x K)                        B (K x N)
//   K5: (N R) x C_out         rows (n, r), k = (dr, c): x       the filter (5 C_in, C_out),
//                             shifted by dr - 2, K-major        MN-major
//   K6: (5 C_in) x C_out      rows (dr, c), k = (n, r): x       dym (N R, C_out), MN-major
//                             shifted, MN-major (contiguous in c)
//
// The shift, by TMA: x is one 2-D tensor map, (N R, C_in) in boxes of 64 rows
// x 64 channels (128 bytes, 128-byte swizzle), and B another, (K, C_out) in
// boxes of 64 k rows x 64 columns. A stage of A is two boxes: K5's box j
// holds rows m0 + 64 j .. + 63 of the tile at k-slice (dr, c .. c + 63), so
// it starts at x row m0 + 64 j + dr - 2; K6's box j holds the 64 columns
// m0 + 64 j .. + 63 = (dr_j, c_j ..) at k rows k0 .. k0 + 63, so it starts
// at x row k0 + dr_j - 2. With C_in a multiple of 64 a box has one shift.
// TMA's out-of-bounds fill zeroes the rows before x's first and past its
// last; the rows whose shifted row crosses an item edge (r + dr - 2 outside
// [0, R), every R rows, R = 12-64 at the period shapes) are zeroed by hand:
// route (a) of the design, a 2-D tiled map with the edge rows zeroed in
// shared memory. (TMA's im2col mode would fill the padding in hardware;
// its traversal of the pixels of a 3-D (C, R, N) map cannot be checked off
// the card, while this route's every byte is modelled on the CPU, by
// tests/test_torch_conv5_wgmma.py, and costs one warp.) Under the 128-byte
// swizzle each box row is one whole 128-byte row of shared memory, so a
// zeroed row does not depend on the swizzle. The order, per stage: the
// fix-up warp (warp 1 of the producer warpgroup) waits on the stage's "full"
// barrier (TMA landed), each lane zeroes its rows that cross an edge with
// shared-memory stores (the generic proxy), runs
// fence.proxy.async.shared::cta (the wgmmas read through the async proxy:
// without it they may read the stale rows) and arrives on the stage's
// "ready" barrier, on which the consumers wait (wgmma_bf16.cuh:gemm_ring).
// (Lanes that stored nothing skipping the fence timed 1-2% slower on the
// card, not faster: the fence costs little.) A lane takes rows lane and
// lane + 32 of each box, and writes a row's 16-byte chunks starting at
// chunk lane % 8, so the lanes of a phase hit distinct banks.
//
// The body: wg::gemm_ring of wgmma_bf16.cuh (one producer thread, a ring of
// STAGES stages on full/empty mbarriers, two consumer warpgroups of 64 rows
// issuing wgmma.m64nBNk16 from shared-memory descriptors with one commit
// group in flight, the accumulators fenced around the chain, setmaxnreg 40 /
// 232), a persistent grid of one block an SM walking 128 x BN work items in
// tmawg::Schedule's grouped raster. BN (64, 128, 192, 256) and K6's split
// come from the host plan (ops/fused_disc_conv.py:conv5_wgmma_plan); K5
// never splits.
// - K5's epilogue: the float32 sums + float(b) (the bf16 bias converted
//   exactly; none for dx), LeakyReLU at slope, rounded to bf16 once, stored
//   as column pairs.
// - K6's epilogue: the float32 sums rounded to bf16 once; where the plan
//   splits K, float32 partials to workspace split z, and
//   bf16core::splitk_sum_bf16_kernel sums them in split order 0..s-1 and
//   rounds. No atomics: every launch on the same inputs gives the same bits.
//
// Takes C_in % 64 == 0, C_out % 8 == 0 and 16-byte aligned x, filter or dym
// and output (a 4-byte aligned bias); the host routes any other shape to the
// mma.sync body (ops/fused_disc_conv.py:takes_wgmma).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"    // the bf16 conversions
#include "splitk_bf16.cuh"  // the split-K sum
#include "wgmma_bf16.cuh"   // the ring, on tma_wgmma.cuh's machinery

namespace {
namespace conv5wg {

using namespace wg;
using bf16core::bf16_t;

// The implicit GEMM of K5 (DW false) or K6 (DW true) as the ring's Op.
template <bool DW, int BN_>
struct Conv5Op {
  static constexpr int BN = BN_;
  static constexpr bool TRANS_A = DW, TRANS_B = true, FIX = true;
  static constexpr int ATOM = Ring<BN>::ATOM;
  const CUtensorMap* map_x;   // x as (N R, C_in)
  const CUtensorMap* map_b;   // the filter (5 C_in, C_out) or dym (N R, C_out)
  const bf16_t* __restrict__ bias;   // K5: (C_out) or null
  void* out;                  // y (N R, C_out) or dW (5 C_in, C_out), bf16
  float* __restrict__ ws;     // K6 split: float32 partials
  int M, N, K, R, C;
  float slope;
  bool partial;

  // The two boxes of A's stage at k: the index of each one's first row (K5:
  // the output row m; K6: the reduction row k), its tap dr and first channel
  // c. One division a stage: K6's second box is the first's next 64
  // channels, in the next tap where those end one.
  __device__ __forceinline__ void boxes(int3 item, int k, int (&first)[2], int (&dr)[2],
                                        int (&c)[2]) const {
    if (DW) {
      const unsigned m = item.y * BM;
      dr[0] = m / (unsigned)C;
      c[0] = m - dr[0] * C;
      const bool next_tap = c[0] + 64 == C;
      dr[1] = dr[0] + next_tap;
      c[1] = next_tap ? 0 : c[0] + 64;
      first[0] = first[1] = k;
    } else {
      dr[0] = dr[1] = (unsigned)k / (unsigned)C;
      c[0] = c[1] = k - dr[0] * C;
      first[0] = item.y * BM;
      first[1] = first[0] + 64;
    }
  }

  __device__ __forceinline__ void load(uint8_t* sa, uint8_t* sb, uint64_t* bar, int3 item,
                                       int k) const {
    int first[2], dr[2], c[2];
    boxes(item, k, first, dr, c);
#pragma unroll
    for (int j = 0; j < 2; ++j) tma_load_2d(sa + j * ATOM, map_x, bar, c[j], first[j] + dr[j] - 2);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) tma_load_2d(sb + j * ATOM, map_b, bar, item.z * BN + 64 * j, k);
  }

  // Zero each row of the landed A stage whose shifted x row crosses an item
  // edge: row i of box j is index first + i, whose r + dr - 2 must lie in [0,
  // R). A lane takes rows lane and lane + 32 of each box, by 16-byte shared
  // stores from chunk lane % 8 on.
  __device__ __forceinline__ void fix(uint8_t* sa, int3 item, int k, int lane) const {
    int first[2], dr[2], c[2];
    boxes(item, k, first, dr, c);
    const uint32_t base = smem_u32(sa);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        const int r = (unsigned)(first[j] + i) % (unsigned)R;
        if ((unsigned)(r + dr[j] - 2) < (unsigned)R) continue;
        const uint32_t row = base + j * ATOM + i * 128;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                       :: "r"(row + 16 * ((q + lane) & 7)), "r"(0) : "memory");
      }
    }
  }

  __device__ __forceinline__ void store(const float (&acc)[BN / 2], int3 item, int r, int lane)
      const {
    const int row0 = item.y * BM + r;
    bf16_t* y = static_cast<bf16_t*>(out);
    float* part = ws + (long long)item.x * M * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = item.z * BN + 8 * i + 2 * (lane % 4);
      if (col >= N) continue;  // N even: a pair is all in or all out
      float b0 = 0.0f, b1 = 0.0f;
      if (!DW && bias != nullptr) {
        const unsigned bb = __ldg(reinterpret_cast<const unsigned*>(bias + col));
        b0 = __uint_as_float(bb << 16);
        b1 = __uint_as_float(bb & 0xffff0000u);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        const long long at = (long long)row * N + col;
        if (DW && partial) {
          *reinterpret_cast<float2*>(part + at) = make_float2(v0, v1);
          continue;
        }
        if (!DW) {
          if (bias != nullptr) {
            v0 += b0;
            v1 += b1;
          }
          v0 = v0 > 0.0f ? v0 : slope * v0;
          v1 = v1 > 0.0f ? v1 : slope * v1;
        }
        *reinterpret_cast<unsigned*>(y + at) = bf16core::pack_bf16(v0, v1);
      }
    }
  }
};

template <bool DW, int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv5_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_b, const bf16_t* __restrict__ bias,
                   void* out, float* __restrict__ ws, Sched sched, int M, int N, int K, int R,
                   int C, float slope) {
  const Conv5Op<DW, BN> op{&map_x, &map_b, bias, out, ws, M, N, K, R, C, slope,
                           sched.splits > 1};
  gemm_ring(op, sched);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// The shapes and pointers this body takes (ops/fused_disc_conv.py:takes_wgmma).
bool takes(const void* x, const void* b, const void* out, const void* bias, int n, int rows,
           int c_in, int c_out) {
  return n > 0 && rows > 0 && c_in > 0 && c_out > 0 && c_in % 64 == 0 && c_out % 8 == 0 &&
         aligned(x, 16) && aligned(b, 16) && aligned(out, 16) &&
         (bias == nullptr || aligned(bias, 4));
}

template <bool DW, int BN>
cudaError_t run(const void* x, const void* b, const void* bias, void* out, float* ws, int n,
                int rows, int c_in, int c_out, int splits, int k_chunk, float slope,
                cudaStream_t stream) {
  const int NR = n * rows;
  const int M = DW ? 5 * c_in : NR, N = c_out, K = DW ? NR : 5 * c_in;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_x, map_b;
  // boxes of 64 rows x 64 values; loads past the edges give zeros
  if (!make_map(&map_x, BF16, 2, x, NR, c_in, 64, 64) ||
      !make_map(&map_b, BF16, 2, b, K, c_out, 64, 64))
    return cudaErrorInvalidValue;
  const auto kernel = conv5_wgmma_kernel<DW, BN>;
  const Sched sched{(M + BM - 1) / BM, (N + BN - 1) / BN, splits, k_chunk};
  int blocks = 0;
  cudaError_t err = prepare<BN>(kernel, sched, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, Ring<BN>::SMEM, stream>>>(
      map_x, map_b, static_cast<const bf16_t*>(bias), out, ws, sched, M, N, K, rows, c_in,
      slope);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return bf16core::splitk_sum_bf16(ws, static_cast<bf16_t*>(out), (long long)M * N, splits,
                                   stream);
}

template <bool DW>
cudaError_t run_bn(int bn, const void* x, const void* b, const void* bias, void* out, float* ws,
                   int n, int rows, int c_in, int c_out, int splits, int k_chunk, float slope,
                   cudaStream_t s) {
  switch (bn) {
    case 64: return run<DW, 64>(x, b, bias, out, ws, n, rows, c_in, c_out, splits, k_chunk, slope, s);
    case 128: return run<DW, 128>(x, b, bias, out, ws, n, rows, c_in, c_out, splits, k_chunk, slope, s);
    case 192: return run<DW, 192>(x, b, bias, out, ws, n, rows, c_in, c_out, splits, k_chunk, slope, s);
    case 256: return run<DW, 256>(x, b, bias, out, ws, n, rows, c_in, c_out, splits, k_chunk, slope, s);
    default: return cudaErrorInvalidValue;
  }
}

// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), a thread's
// registers at launch, its local (spill and stack) bytes, the dynamic
// shared memory
template <bool DW, int BN>
cudaError_t attributes(int* out) {
  const auto kernel = conv5_wgmma_kernel<DW, BN>;
  constexpr int smem = Ring<BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, THREADS, smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = smem;
  return err;
}

}  // namespace conv5wg
}  // namespace

// K5 at bf16 on this body: y (N, R, C_out) = lrelu(conv5(x (N, R, C_in), w
// (5, C_in, C_out)) + bias (C_out)), all bf16, float32 sums and activation,
// rounded once, on 128 x bn tiles. bias may be null (the dx launch); slope 1
// makes the activation the identity.
extern "C" int qvc_conv5_lrelu_bf16_wgmma(const void* x, const void* w, const void* bias,
                                          void* y, int n, int rows, int c_in, int c_out,
                                          float slope, int bn, void* stream) {
  if (!conv5wg::takes(x, w, y, bias, n, rows, c_in, c_out)) return (int)cudaErrorInvalidValue;
  return (int)conv5wg::run_bn<false>(bn, x, w, bias, y, nullptr, n, rows, c_in, c_out, 1,
                                     5 * c_in, slope, (cudaStream_t)stream);
}

// K6 at bf16 on this body: dw (5, C_in, C_out) bf16 = the float32 sum over
// (n, r) of shifted x^T @ dym, rounded once, on 128 x bn tiles; the
// reduction cut into `splits` ranges of k_chunk rows (64-row tiles, every
// range non-empty). With more than one split the float32 partials go to
// workspace (splits x 5 C_in C_out floats) and a second kernel sums them in
// split order and rounds.
extern "C" int qvc_conv5_dw_bf16_wgmma(const void* x, const void* dym, void* dw,
                                       void* workspace, int n, int rows, int c_in, int c_out,
                                       int bn, int splits, int k_chunk, void* stream) {
  if (!conv5wg::takes(x, dym, dw, nullptr, n, rows, c_in, c_out) ||
      !wg::valid_plan(n * rows, bn, splits, k_chunk) || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)conv5wg::run_bn<true>(bn, x, dym, nullptr, dw, (float*)workspace, n, rows, c_in,
                                    c_out, splits, k_chunk, 1.0f, (cudaStream_t)stream);
}

// The compiled body of K5 (dw 0) or K6 (dw 1) at bn on this card: out[0]
// blocks an SM, out[1] registers a thread at launch, out[2] local bytes a
// thread (spills), out[3] dynamic shared memory a block.
extern "C" int qvc_conv5_wgmma_attributes(int dw, int bn, int* out) {
  using namespace conv5wg;
  switch (bn) {
    case 64: return (int)(dw ? attributes<true, 64>(out) : attributes<false, 64>(out));
    case 128: return (int)(dw ? attributes<true, 128>(out) : attributes<false, 128>(out));
    case 192: return (int)(dw ? attributes<true, 192>(out) : attributes<false, 192>(out));
    case 256: return (int)(dw ? attributes<true, 256>(out) : attributes<false, 256>(out));
    default: return (int)cudaErrorInvalidValue;
  }
}
