// Kernel K11: C (M, N) = A (M, K) @ B (K, N), s8 x s8 -> s32 and bf16 x bf16
// -> f32, on TMA and wgmma, for sm_90a.
//
// Replaces the TPU kernel scripts/int8_matmul_probe.py:pallas_mm (pallas_call
// at :85, body _mm_kernel :66-79): A and B row-major, summed in int32 for s8
// and in float32 for bf16. The probe asks whether a hand-written kernel
// reaches the card's int8 rate, twice its bf16 rate.
//
// What bounds it on this card: operations. At the probe's shape
// (16384 x 12288) @ (12288 x 3072) the product is 1.24 TOP against 0.44 GB
// moved in s8 (0.68 GB in bf16): 0.625 ms at the dense int8 rate of 1,979
// TOP/s and 1.25 ms at 989 bf16 TFLOP/s, against 0.13 / 0.20 ms of bytes.
// Only wgmma reaches those rates.
//
// Design. A persistent grid, one block an SM, each block of three
// warpgroups walking 128 x BN tiles of C in a static schedule
// (tma_wgmma.cuh's Schedule with one split: tile index -> (row, col), a
// grouped raster of GROUP_M tile rows, so the tiles that run at the same
// time share B's columns in L2; the host twin is
// ops/int8_mm.py:tile_schedule). Warpgroup 0 is the producer: one thread
// keeps a ring of STAGES shared-memory stages filled by TMA
// (cp.async.bulk.tensor, 128-byte swizzle) across tile boundaries, each
// stage 128 bytes of k of the A tile and of the B tile, signalled on a
// "full" mbarrier with the stage's byte count; it runs on into the next
// tile's stages while the consumers store the last one. Warpgroups 1 and 2
// are the consumers, 64 rows of the tile each: per stage four
// wgmma.mma_async of 32 bytes of k (m64nBNk16 bf16, m64nBNk32 s8), both
// operands read from shared memory through descriptors, one commit group a
// stage with one group left in flight; a stage goes back to the producer on
// its "empty" mbarrier once its group is done. setmaxnreg moves registers
// from the producer (40) to the consumers (232): BN/2 accumulators a thread.
//
// Operand layouts. A is read K-major (its rows). wgmma reads 8-bit operands
// K-major only, so for s8 a pre-pass (transpose_kernel, through a padded
// 32 x 32 shared tile, coalesced both ways) writes B^T (N, K) into scratch
// the host allocates. bf16 needs none: TMA reads B (K, N) as it lies, in
// boxes of 64 columns (128 bytes) x 64 k rows, and the descriptors read it
// MN-major (the transpose-B immediate; 1024 bytes between 8-row k groups,
// 8 KB between 64-column atoms).
//
// Accumulators. The consumers fence them (fence_operands, an empty asm that
// reads and writes each) before each stage's wgmma.fence and after the
// tile's last wgmma.wait_group, as CUTLASS does: the compiler cannot see
// that a wait changes them, and without the fence after it nvcc 12.9 copied
// the bf16 accumulators to other registers (or spilled them, at 128 x 256)
// before the wait, while the last wgmmas were still writing them, and the
// epilogue stored sums short of their last products (qvc_mm_probe's
// NO_OPERAND_FENCE keeps that body).
//
// Epilogue. Each consumer warpgroup writes its 64 x BN accumulators to C in
// 64 x 32 slices through two 8 KB shared buffers (128-byte swizzled, so the
// fragment stores are conflict-free) and a TMA store each, which clips
// ragged M and N; the consumers go on to the next tile's mainloop while the
// stores drain. TMA's zero fill covers ragged M, N and K on the loads. The
// tensor maps are encoded on the host (cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint, so nothing links libcuda) and passed as
// __grid_constant__ parameters.
//
// The schedule, the mbarrier, TMA-load and wgmma helpers, the accumulator
// fence and the tensor maps are tma_wgmma.cuh's, which K8's bf16 GEMM core
// (wgmma_bf16.cuh) shares; this file keeps the pre-pass, the TMA stores,
// the s8 wgmmas and the body with its epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"  // the schedule, mbarriers, TMA, wgmma and tensor maps

namespace {

using namespace tmawg;

constexpr int BM = 128;            // rows of C a tile
constexpr int BK_BYTES = 128;      // bytes of k a stage: one 128-byte swizzle row
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int RING_BYTES = 192 * 1024;
constexpr int GROUP_M = 16;        // tile rows a raster group (ops/int8_mm.py:GROUP_M)
constexpr int EPI_COLS = 32;       // columns of C a consumer stores at once: 128 bytes
constexpr int EPI_BYTES = 64 * EPI_COLS * 4;  // one 64-row slice, 8 KB
constexpr int EPI_BUFS = 2;        // slices in flight a consumer warpgroup

// ---- the B^T pre-pass (s8) --------------------------------------------------

__global__ void __launch_bounds__(256)
transpose_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows, int cols) {
  __shared__ uint8_t tile[32][33];
  int x = blockIdx.x * 32 + threadIdx.x;
  int y = blockIdx.y * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (x < cols && y + j < rows)
      tile[threadIdx.y + j][threadIdx.x] = in[(long long)(y + j) * cols + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (x < rows && y + j < cols)
      out[(long long)(y + j) * rows + x] = tile[threadIdx.x][threadIdx.y + j];
}

using Sched = Schedule<GROUP_M>;   // splits 1: item t -> (0, tile row, tile col)

// ---- PTX helpers beyond tma_wgmma.cuh's ---------------------------------------

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk stores but the newest N have finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// s8 reads B^T K-major
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      WG_REGS_0_31 ", " WG_REGS_32_63 ", " WG_REGS_64_95 ", " WG_REGS_96_127 "},"
      " %128, %129, p;\n"
      "}\n"
      : WG_ACC32("+r", d, 0), WG_ACC32("+r", d, 32), WG_ACC32("+r", d, 64),
        WG_ACC32("+r", d, 96)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      WG_REGS_0_31 ", " WG_REGS_32_63 "},"
      " %64, %65, p;\n"
      "}\n"
      : WG_ACC32("+r", d, 0), WG_ACC32("+r", d, 32)
      : "l"(da), "l"(db), "r"(1));
}

// The two types: element bytes, accumulator and its TMA type, how B is read
// (B_MN: B (K, N) MN-major as it lies; else B^T (N, K) K-major), one wgmma
// of 32 bytes of k over a BN-wide tile and the descriptor step it takes.
struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2;
  static constexpr bool B_MN = true;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType ACC_TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
    wgmma_bf16<1>(d, da, db);   // B MN-major: the transpose-B immediate
  }
  static __device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
};

struct S8 {
  using Acc = int;
  static constexpr int BYTES = 1;
  static constexpr bool B_MN = false;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType ACC_TMA = CU_TENSOR_MAP_DATA_TYPE_INT32;
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
    if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
    else wgmma_s8_n128(d, da, db);
  }
  static __device__ __forceinline__ uint32_t bits(int x) { return (uint32_t)x; }
};

template <int BN>
struct Ring {
  static constexpr int A_BYTES = BM * BK_BYTES;
  static constexpr int B_BYTES = BN * BK_BYTES;
  static constexpr int B_ATOM = 64 * BK_BYTES;   // MN-major B: 64 columns x one stage of k
  static constexpr int STAGES = RING_BYTES / (A_BYTES + B_BYTES);  // 4 at BN 256, 6 at 128
  static constexpr int EPI = 2 * EPI_BUFS * EPI_BYTES;              // two consumers' slices
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + EPI + 1024;  // + alignment slack
};

// Bring-up probes, compiled only for qvc_mm_probe (PROBE 0 is the product):
// NO_STORE leaves C unwritten (the mainloop alone); NO_LOAD has the producer
// hand over stages it never loaded (the wgmma rate on stale shared memory);
// NO_OPERAND_FENCE leaves out fence_operands (the fault it prevents).
constexpr int NO_STORE = 1, NO_LOAD = 2, NO_OPERAND_FENCE = 4;

// The body of K11 and of its probes; the tensor maps are the kernels'
// __grid_constant__ parameters.
template <typename Op, int BN, int PROBE>
__device__ __forceinline__ void mm_body(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                        const CUtensorMap& map_c, Sched sched, int M, int N,
                                        int K) {
  using Acc = typename Op::Acc;
  using R = Ring<BN>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle wants each tile on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                              // [STAGES][BM][128 bytes]
  uint8_t* sb = sa + STAGES * R::A_BYTES;          // [STAGES][BN x 128 bytes]
  uint8_t* se = sb + STAGES * R::B_BYTES;          // [2 consumers][EPI_BUFS][64][128 bytes]

  const int n_k = (K * Op::BYTES + BK_BYTES - 1) / BK_BYTES;
  const int total = sched.total();
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      constexpr int K_ELEMS = BK_BYTES / Op::BYTES;
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int3 tile = sched.item(t);
        const int m0 = tile.y * BM, n0 = tile.z * BN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if constexpr ((PROBE & NO_LOAD) != 0) {
            mbar_arrive(&full[s]);
            continue;
          }
          mbar_expect_tx(&full[s], R::A_BYTES + R::B_BYTES);
          tma_load_2d(sa + s * R::A_BYTES, &map_a, &full[s], kt * K_ELEMS, m0);
          if constexpr (Op::B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(sb + s * R::B_BYTES + j * R::B_ATOM, &map_b, &full[s], n0 + 64 * j,
                          kt * K_ELEMS);
          } else {
            tma_load_2d(sb + s * R::B_BYTES, &map_b, &full[s], kt * K_ELEMS, n0);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c takes rows [64c, 64c + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    uint8_t* slices = se + c * EPI_BUFS * EPI_BYTES;
    int it = 0, slice = 0;
    for (int tt = blockIdx.x; tt < total; tt += gridDim.x) {
      const int3 tile = sched.item(tt);
      const int m0 = tile.y * BM, n0 = tile.z * BN;
      Acc acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da = desc_k_major(sa + s * R::A_BYTES + c * 64 * BK_BYTES);
        uint64_t db;
        if constexpr (Op::B_MN) db = desc_mn_major<R::B_ATOM>(sb + s * R::B_BYTES);
        else db = desc_k_major(sb + s * R::B_BYTES);
        if constexpr ((PROBE & NO_OPERAND_FENCE) == 0) fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK_BYTES / 32; ++kk) {
          // 32 bytes of k: 32 bytes along a K-major row (+2 in the descriptor),
          // 16 k rows of an MN-major atom (2048 bytes, +128)
          Op::template mma<BN>(acc, da + 2 * kk, db + (Op::B_MN ? 128 : 2) * kk);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous stage's group is done: hand its stage back
        if (kt > 0 && t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if constexpr ((PROBE & NO_OPERAND_FENCE) == 0) fence_operands(acc);
      if (t == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      if constexpr ((PROBE & NO_STORE) != 0) {
        // keep the sums live: the compiler drops wgmmas whose sums nobody reads
        Acc sum = Acc(0);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum += acc[i];
        if (M < 0) *reinterpret_cast<volatile Acc*>(slices) = sum;   // never taken
        continue;
      }

      // fragment -> (row, col): warp w of the group holds rows 16w + lane/4
      // and +8; register 4i + {0, 1, 2, 3} is column 8i + 2*(lane%4) + {0, 1}
      // of the first row, then of the second. Slice j takes i = 4j .. 4j+3;
      // in its 128-byte swizzled rows the 16-byte chunk q of row r sits at
      // chunk q ^ (r % 8).
      const int r0 = 16 * w + lane / 4;
      const int row_m = m0 + 64 * c;
#pragma unroll
      for (int j = 0; j < BN / EPI_COLS; ++j, ++slice) {
        uint8_t* buf = slices + (slice % EPI_BUFS) * EPI_BYTES;
        if (t == 0) bulk_wait_read<EPI_BUFS - 1>();   // buf's last store has read it
        named_sync(1 + c, 128);
#pragma unroll
        for (int q = 0; q < EPI_COLS / 8; ++q) {
          const int i = (EPI_COLS / 8) * j + q;
          const int chunk = 2 * q + (lane % 4) / 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            *reinterpret_cast<uint2*>(buf + r * 128 + ((chunk ^ (r % 8)) << 4) + 8 * (lane % 2)) =
                make_uint2(Op::bits(acc[4 * i + 2 * h]), Op::bits(acc[4 * i + 2 * h + 1]));
          }
        }
        fence_async_shared();
        named_sync(1 + c, 128);
        if (t == 0) {
          // a slice wholly past M or N has nothing to store (TMA clips the rest)
          if (row_m < M && n0 + EPI_COLS * j < N)
            tma_store_2d(&map_c, buf, n0 + EPI_COLS * j, row_m);
          bulk_commit();
        }
      }
    }
    if (t == 0) bulk_wait_all();   // shared memory must outlive its stores
  }
}

template <typename Op, int BN>
__global__ void __launch_bounds__(THREADS, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, Sched sched, int M, int N, int K) {
  mm_body<Op, BN, 0>(map_a, map_b, map_c, sched, M, N, K);
}

// The probes apart from the product kernel, so that its name (which the
// profiler reports and chip_smoke.py watches for spills) is the product's
// alone.
template <typename Op, int BN, int PROBE>
__global__ void __launch_bounds__(THREADS, 1)
mm_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, Sched sched, int M, int N, int K) {
  mm_body<Op, BN, PROBE>(map_a, map_b, map_c, sched, M, N, K);
}

// ---- host side ----------------------------------------------------------------

// blocks: the persistent grid's size, 0 for one block an SM (never more
// blocks than tiles).
template <typename Op, int BN, int PROBE = 0>
cudaError_t run(const void* a, const void* b, void* c, int M, int N, int K, int blocks,
                cudaStream_t stream) {
  constexpr int K_ELEMS = BK_BYTES / Op::BYTES;
  CUtensorMap map_a, map_b, map_c;
  const bool b_ok = Op::B_MN ? make_map(&map_b, Op::TMA, Op::BYTES, b, K, N, K_ELEMS, 64)
                             : make_map(&map_b, Op::TMA, Op::BYTES, b, N, K, BN, K_ELEMS);
  if (!b_ok || !make_map(&map_a, Op::TMA, Op::BYTES, a, M, K, BM, K_ELEMS) ||
      !make_map(&map_c, Op::ACC_TMA, 4, c, M, N, 64, EPI_COLS))
    return cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (PROBE == 0) return mm_wgmma_kernel<Op, BN>;
    else return mm_probe_kernel<Op, BN, PROBE>;
  }();
  constexpr int bytes = Ring<BN>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const Sched sched{(M + BM - 1) / BM, (N + BN - 1) / BN, 1, K};
  if (blocks <= 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return err;
  }
  blocks = blocks < sched.total() ? blocks : sched.total();
  if (blocks == 0) return cudaSuccess;   // an empty C
  kernel<<<blocks, THREADS, bytes, stream>>>(map_a, map_b, map_c, sched, M, N, K);
  return cudaGetLastError();
}

// The compiled tiles, by index: 0: 128 x 256, 1: 128 x 128.
template <typename Op>
cudaError_t run_tile(int tile, const void* a, const void* b, void* c, int M, int N, int K,
                     cudaStream_t stream) {
  switch (tile) {
    case 0: return run<Op, 256>(a, b, c, M, N, K, 0, stream);
    case 1: return run<Op, 128>(a, b, c, M, N, K, 0, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The probes of the 128 x 256 tile that both types take.
template <typename Op>
cudaError_t run_probe(int probe, const void* a, const void* b, void* c, int M, int N, int K,
                      int blocks, cudaStream_t stream) {
  switch (probe) {
    case 0: return run<Op, 256>(a, b, c, M, N, K, blocks, stream);
    case NO_STORE: return run<Op, 256, NO_STORE>(a, b, c, M, N, K, blocks, stream);
    case NO_STORE | NO_LOAD:
      return run<Op, 256, NO_STORE | NO_LOAD>(a, b, c, M, N, K, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B^T (cols, rows) = B (rows, cols) transposed, int8 (s8's pre-pass).
extern "C" int qvc_mm_transpose(const void* b, void* bt, int rows, int cols, void* stream) {
  dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const uint8_t*)b, (uint8_t*)bt,
                                                             rows, cols);
  return (int)cudaGetLastError();
}

// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, given A and B^T (N, K),
// both row-major and 16-byte aligned; K % 64 == 0 (16-byte rows), N % 8 == 0.
extern "C" int qvc_mm_s8(const void* a, const void* bt, void* c, int M, int N, int K, int tile,
                         void* stream) {
  return (int)run_tile<S8>(tile, a, bt, c, M, N, K, (cudaStream_t)stream);
}

// C (M, N) float32 = A (M, K) bf16 @ B (K, N) bf16, both row-major and
// 16-byte aligned; K % 32 == 0, N % 8 == 0.
extern "C" int qvc_mm_bf16(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                           void* stream) {
  return (int)run_tile<Bf16>(tile, a, b, c, M, N, K, (cudaStream_t)stream);
}

// Bring-up probes of the 128 x 256 tile (scripts/kernel_times.py), with the
// operands of qvc_mm_bf16 (bf16 != 0) or qvc_mm_s8: probe 0 (the product),
// NO_STORE, NO_STORE | NO_LOAD, and for bf16 also NO_OPERAND_FENCE; a
// grid of `blocks` blocks (0: one an SM).
extern "C" int qvc_mm_probe(int bf16, int probe, const void* a, const void* b, void* c, int M,
                            int N, int K, int blocks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!bf16) return (int)run_probe<S8>(probe, a, b, c, M, N, K, blocks, st);
  switch (probe) {
    case NO_OPERAND_FENCE:
      return (int)run<Bf16, 256, NO_OPERAND_FENCE>(a, b, c, M, N, K, blocks, st);
    default: return (int)run_probe<Bf16>(probe, a, b, c, M, N, K, blocks, st);
  }
}
