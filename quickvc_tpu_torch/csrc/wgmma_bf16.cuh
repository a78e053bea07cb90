// The persistent TMA + wgmma bf16 GEMM core of the port, for sm_90a: K8's
// bf16 mode runs its four GEMMs on it (fused_transformer.cu), K5/K6's bf16
// implicit GEMM its ring (conv5_wgmma.cu). Included by sources, so
// everything here has internal linkage.
//
// wg::gemm_ring is the ring, generic over the GEMM (an Op: how a stage is
// loaded, whether a warp fixes it up, how a tile is stored); wg::linear
// runs K8's GEMMs on it: C = epi(A W^T + bias), A (M, K) bf16 activations
// and W (N, K) bf16 in torch's Linear layout, both K-major; float32 sums.
// The epilogues are bf16_gemm.cuh's (bf16core::store_pair): the float32
// bias, then ROUND (round to bf16), GELU (round, tanh GELU in float32, round
// again) or RESIDUAL (add the bf16 residual, store float32), the arithmetic
// of the TPU kernel's bf16 branch (quickvc_tpu/ops/fused_transformer.py:63-117).
//
// It follows K11's body (int8_mm.cu), on the machinery the two share
// (tma_wgmma.cuh):
// - A persistent grid of one block an SM walks work items, a 128 x BN tile
//   of C and one split of the reduction each, in a grouped raster (Schedule;
//   the host twin is ops/fused_transformer.py:wgmma_schedule). BN is 64,
//   128, 192 or 256, from the host plan (wgmma_plan), as is the split.
// - Warpgroup 0 is the producer: one thread keeps a ring of STAGES stages
//   filled, across items, each stage 64 k-values (128 bytes) of the A tile
//   (128 rows) and of the B tile (BN rows), loaded by TMA with the 128-byte
//   swizzle and signalled on a "full" mbarrier with the stage's bytes.
//   Ragged M, N and K read zeros (TMA's fill). Where the Op asks for it,
//   warp 1 fixes each landed A stage up before the consumers read it.
// - Warpgroups 1 and 2 are the consumers, 64 rows of the tile each: per
//   stage four wgmma.mma_async.m64nBNk16.f32.bf16.bf16 from shared-memory
//   descriptors (K-major or MN-major, the transpose flags), one commit group
//   a stage with one in flight; a stage goes back on its "empty" mbarrier
//   once its group is done. setmaxnreg moves registers from the producer
//   (40) to the consumers (232): BN / 2 float32 accumulators a thread.
// - The accumulators are fenced (fence_operands) before each stage's
//   wgmma.fence and after the item's last wgmma.wait_group: without the
//   second fence nvcc 12.9 copied K11's bf16 accumulators before the wait,
//   and the sums lost their last products (int8_mm.cu's head note).
// - Epilogue on the accumulator fragments, in registers: a consumer stores
//   its 64 x BN sums as column pairs (row 16 w + lane / 4 and + 8 of warp w,
//   columns 8 i + 2 (lane % 4) and + 1), through the epilogue, or, where
//   the plan splits K, as float32 partials to workspace split z;
//   bf16core::linear_bf16_splitk_kernel then sums the partials in split
//   order and applies the epilogue. No atomics: the same inputs give the
//   same bits on every launch. The producer meanwhile loads the consumers'
//   next item.
// - Tensor maps: encoded on the host (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, nothing links libcuda) and passed as
//   __grid_constant__ parameters.
//
// wg::linear needs K % 8 == 0 and N % 8 == 0 (16-byte rows for TMA, column
// pairs for the stores), A and W 16-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"  // the epilogues and the split-K sum
#include "tma_wgmma.cuh"  // the schedule, mbarriers, TMA, wgmma and tensor maps

namespace {
namespace wg {

using namespace tmawg;
using bf16core::bf16_t;

constexpr int BM = 128;          // rows of C a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // k-values a stage: one 128-byte swizzle row
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int RING_BYTES = 192 * 1024;
constexpr int GROUP_M = 8;       // tile rows a raster group (ops/fused_transformer.py)
constexpr int MAX_SPLITS = 4;    // ops/fused_transformer.py:MAX_SPLITS

using Sched = Schedule<GROUP_M>;

template <int BN>
struct Ring {
  static constexpr int ATOM = 64 * 128;    // 64 rows of 128 bytes: one box, one atom
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGES = RING_BYTES / (A_BYTES + B_BYTES);  // 4, 4, 6, 8 at BN 256..64
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 1024;  // + alignment slack
};

// generic-proxy writes to shared memory made visible to the async proxy
// (the wgmma reads and TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The core's ring over one GEMM, Op, which says how a stage is loaded and
// what a tile's sums become:
//   Op::BN, Op::TRANS_A, Op::TRANS_B  the tile width; A and B MN-major (1)
//                                     or K-major (0) in shared memory
//   Op::FIX                           a fix-up warp writes the A stage once
//                                     TMA has landed it (below)
//   op.K                              the reduction's length
//   op.load(sa, sb, bar, item, k)     the producer thread's TMA loads of the
//                                     stage at k: A_BYTES into sa, B_BYTES
//                                     into sb, signalled on bar
//   op.fix(sa, item, k, lane)         (FIX) a lane's generic stores into it
//   op.store(acc, item, row, lane)    the epilogue on a consumer thread's
//                                     accumulators (rows row and row + 8 of
//                                     the tile)
// Both operands' stages are 1024-aligned 64-row boxes of 128-byte rows:
// K-major (a row is 64 k-values of one m or n) or MN-major (a row is 64 m or
// n values of one k, ATOM bytes between 64-column atoms). With FIX, warp 1
// of the producer warpgroup waits on a stage's "full" barrier, makes its
// stores, fences them into the async proxy (the wgmmas read through it) and
// arrives on the stage's "ready" barrier, on which the consumers wait; a
// stage that needs no fix-up takes the same hop.
template <class Op>
__device__ __forceinline__ void gemm_ring(const Op& op, const Sched& sched) {
  constexpr int BN = Op::BN;
  using R = Ring<BN>;
  constexpr int STAGES = R::STAGES;
  // a k16 step in the descriptors: 32 bytes along a K-major row (+2), 16
  // rows of an MN-major atom (2048 bytes, +128)
  constexpr int A_STEP = Op::TRANS_A ? 128 : 2, B_STEP = Op::TRANS_B ? 128 : 2;
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], ready[STAGES];
  // 128-byte swizzle wants each tile on a 1024-byte boundary
  uint8_t* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                        // [STAGES][BM][128 bytes]
  uint8_t* sb = sa + STAGES * R::A_BYTES;    // [STAGES][BN][128 bytes]

  const int total = sched.total();
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
      if (Op::FIX) mbar_init(&ready[s], 32);  // one from each lane of the fix-up warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint64_t* landed = Op::FIX ? ready : full;   // what the consumers wait on

  auto k_range = [&](int z, int& k0, int& n_k) {
    k0 = z * sched.k_chunk;
    const int k1 = min(op.K, k0 + sched.k_chunk);
    n_k = (k1 - k0 + BK - 1) / BK;
  };

  if (wgi == 0) {
    // producer: one thread keeps the ring full, item after item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int3 item = sched.item(t);
        int k0, n_k;
        k_range(item.x, k0, n_k);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], R::A_BYTES + R::B_BYTES);
          op.load(sa + s * R::A_BYTES, sb + s * R::B_BYTES, &full[s], item, k0 + kt * BK);
        }
      }
    } else if (Op::FIX && threadIdx.x / 32 == 1) {
      // fix-up warp: each landed A stage, in ring order
      const int lane = threadIdx.x % 32;
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int3 item = sched.item(t);
        int k0, n_k;
        k_range(item.x, k0, n_k);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          op.fix(sa + s * R::A_BYTES, item, k0 + kt * BK, lane);
          fence_async_shared();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {
    // consumers: warpgroup c takes rows [64 c, 64 c + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wgi - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    int it = 0;
    for (int tt = blockIdx.x; tt < total; tt += gridDim.x) {
      const int3 item = sched.item(tt);
      int k0, n_k;
      k_range(item.x, k0, n_k);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&landed[s], (it / STAGES) & 1);
        const uint8_t* a = sa + s * R::A_BYTES + c * R::ATOM;   // this warpgroup's 64 rows
        const uint8_t* b = sb + s * R::B_BYTES;
        const uint64_t da = Op::TRANS_A ? desc_mn_major<R::ATOM>(a) : desc_k_major(a);
        const uint64_t db = Op::TRANS_B ? desc_mn_major<R::ATOM>(b) : desc_k_major(b);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16<Op::TRANS_B, Op::TRANS_A>(acc, da + A_STEP * kk, db + B_STEP * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done: hand its stage back
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      // fragment -> (row, col): warp w holds rows 16 w + lane / 4 and + 8;
      // register 4 i + {0, 1} is column 8 i + 2 (lane % 4) + {0, 1} of the
      // first row, 4 i + {2, 3} the same columns of the second
      op.store(acc, item, 64 * c + 16 * w + lane / 4, lane);
    }
  }
}

// K8's GEMMs: C = epi(A W^T + bias), A (M, K) and W (N, K) both K-major.
template <int EPI, int BN_>
struct LinearOp {
  static constexpr int BN = BN_;
  static constexpr bool TRANS_A = false, TRANS_B = false, FIX = false;
  const CUtensorMap* map_a;
  const CUtensorMap* map_w;
  const float* __restrict__ bias;
  const bf16_t* __restrict__ res;
  void* C;
  float* __restrict__ ws;
  int M, N, K;
  bool partial;   // split K: float32 partials to workspace split z

  __device__ __forceinline__ void load(uint8_t* sa, uint8_t* sb, uint64_t* bar, int3 item,
                                       int k) const {
    tma_load_2d(sa, map_a, bar, k, item.y * BM);
    tma_load_2d(sb, map_w, bar, k, item.z * BN);
  }
  __device__ __forceinline__ void fix(uint8_t*, int3, int, int) const {}
  __device__ __forceinline__ void store(const float (&acc)[BN / 2], int3 item, int r, int lane)
      const {
    const int row0 = item.y * BM + r;
    float* part = ws + (long long)item.x * M * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = item.z * BN + 8 * i + 2 * (lane % 4);
      if (col >= N) continue;  // N even: a pair is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (partial)
          *reinterpret_cast<float2*>(part + (long long)row * N + col) = make_float2(v0, v1);
        else
          bf16core::store_pair<EPI>(C, bias, res, row, col, N, v0, v1);
      }
    }
  }
};

template <int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                    const bf16_t* __restrict__ res, void* C, float* __restrict__ ws,
                    Sched sched, int M, int N, int K) {
  const LinearOp<EPI, BN> op{&map_a, &map_w, bias, res, C, ws, M, N, K, sched.splits > 1};
  gemm_ring(op, sched);
}

// ---- host side -----------------------------------------------------------------

// A plan the core takes (ops/fused_transformer.py:wgmma_plan): a compiled
// BN, every split non-empty and on 64-wide k-tile edges.
inline bool valid_plan(int K, int bn, int splits, int k_chunk) {
  return (bn == 64 || bn == 128 || bn == 192 || bn == 256) && splits >= 1 &&
         splits <= MAX_SPLITS && k_chunk >= 1 && k_chunk % BK == 0 &&
         (long long)(splits - 1) * k_chunk < K && (long long)splits * k_chunk >= K;
}

// A ring kernel's launch: its dynamic shared memory allowed, and the
// persistent grid's blocks, one an SM and no more than the work items.
template <int BN, typename Kernel>
cudaError_t prepare(Kernel kernel, const Sched& sched, int& blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<BN>::SMEM);
  int dev = 0, sms = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  blocks = sms < sched.total() ? sms : sched.total();
  return cudaSuccess;
}

template <int EPI, int BN>
cudaError_t run(const bf16_t* A, const bf16_t* W, const float* bias, const bf16_t* res, void* C,
                float* ws, int M, int N, int K, int splits, int k_chunk, cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  // (rows, K) bf16 as boxes of rows x 64 k-values; loads past the edges give zeros
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&map_a, BF16, 2, A, M, K, BM, BK) ||
      !make_map(&map_w, BF16, 2, W, N, K, BN, BK))
    return cudaErrorInvalidValue;
  const auto kernel = linear_wgmma_kernel<EPI, BN>;
  const Sched sched{(M + BM - 1) / BM, (N + BN - 1) / BN, splits, k_chunk};
  int blocks = 0;
  cudaError_t err = prepare<BN>(kernel, sched, blocks);
  if (err != cudaSuccess || blocks == 0) return err;  // blocks 0: an empty C
  kernel<<<blocks, THREADS, Ring<BN>::SMEM, stream>>>(map_a, map_w, bias, res, C, ws, sched, M,
                                                      N, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  bf16core::linear_bf16_splitk_kernel<EPI><<<M < 4096 ? M : 4096, 256, 0, stream>>>(
      ws, bias, res, C, M, N, splits);
  return cudaGetLastError();
}

// C = epi(A W^T + bias) on a 128 x bn tile in `splits` K ranges of k_chunk
// (float32 partials in ws), launched on `stream`; returns the launch's error.
template <int EPI>
cudaError_t linear(const bf16_t* A, const bf16_t* W, const float* bias, const bf16_t* res,
                   void* C, float* ws, int M, int N, int K, int bn, int splits, int k_chunk,
                   cudaStream_t stream) {
  switch (bn) {
    case 64: return run<EPI, 64>(A, W, bias, res, C, ws, M, N, K, splits, k_chunk, stream);
    case 128: return run<EPI, 128>(A, W, bias, res, C, ws, M, N, K, splits, k_chunk, stream);
    case 192: return run<EPI, 192>(A, W, bias, res, C, ws, M, N, K, splits, k_chunk, stream);
    case 256: return run<EPI, 256>(A, W, bias, res, C, ws, M, N, K, splits, k_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wg
}  // namespace
