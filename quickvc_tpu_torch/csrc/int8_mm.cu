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
// warpgroups walking 128 x BN tiles of C in a static schedule (Schedule:
// tile index -> (row, col), a grouped raster of GROUP_M tile rows, so the
// tiles that run at the same time share B's columns in L2; the host twin is
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---- the tile schedule --------------------------------------------------------

// Tile t -> (tile row, tile col): groups of GROUP_M tile rows (fewer in the
// last), walked column by column, the rows of a column one after another.
struct Schedule {
  int tiles_m, tiles_n;
  __host__ __device__ int total() const { return tiles_m * tiles_n; }
  __host__ __device__ int2 tile(int t) const {
    const int per_group = GROUP_M * tiles_n;
    const int g = t / per_group;
    const int first = g * GROUP_M;
    const int rows = tiles_m - first < GROUP_M ? tiles_m - first : GROUP_M;
    const int local = t - g * per_group;
    return make_int2(first + local % rows, local / rows);
  }
};

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait of
// 2^35 cycles (~20 s) is a broken pipeline, not a slow one: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

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

// wgmma shared-memory descriptors, 128-byte swizzle (mode 1), start >> 4.
// K-major: a tile of 128-byte rows of k, 1024 bytes between 8-row groups
// (leading offset unused).
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// MN-major: k rows of 64 columns (128 bytes), 1024 bytes between 8-row k
// groups (stride offset), ATOM bytes between 64-column atoms (leading offset).
template <int ATOM>
__device__ __forceinline__ uint64_t desc_mn_major(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(ATOM >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Ties the accumulators to the order of the asm statements around them. The
// wgmmas write them asynchronously, but to the compiler they are plain
// registers that wgmma.wait_group does not touch: without this it may copy
// or spill them before the wait has let the last wgmmas finish (nvcc 12.9
// did, in the bf16 body, and the copies lost the last products).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the accumulator operands of one wgmma: %0 .. %63, then %64 .. %127 (n256)
#define REGS_0_63                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define REGS_64_127                                                                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "  \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127"
#define ACC8(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), \
                      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])

#define ACC128(c, d)                                                                   \
  ACC8(c, d, 0), ACC8(c, d, 8), ACC8(c, d, 16), ACC8(c, d, 24), ACC8(c, d, 32),        \
      ACC8(c, d, 40), ACC8(c, d, 48), ACC8(c, d, 56), ACC8(c, d, 64), ACC8(c, d, 72),  \
      ACC8(c, d, 80), ACC8(c, d, 88), ACC8(c, d, 96), ACC8(c, d, 104), ACC8(c, d, 112), \
      ACC8(c, d, 120)
#define ACC64(c, d)                                                                    \
  ACC8(c, d, 0), ACC8(c, d, 8), ACC8(c, d, 16), ACC8(c, d, 24), ACC8(c, d, 32),        \
      ACC8(c, d, 40), ACC8(c, d, 48), ACC8(c, d, 56)

// bf16 reads B MN-major: the transpose-B immediate (the last operand) is 1
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      REGS_0_63 ", " REGS_64_127 "},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC128("+f", d)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      REGS_0_63 "},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : ACC64("+f", d)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      REGS_0_63 ", " REGS_64_127 "},"
      " %128, %129, p;\n"
      "}\n"
      : ACC128("+r", d)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      REGS_0_63 "},"
      " %64, %65, p;\n"
      "}\n"
      : ACC64("+r", d)
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
    if constexpr (BN == 256) wgmma_bf16_n256(d, da, db);
    else wgmma_bf16_n128(d, da, db);
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
                                        const CUtensorMap& map_c, Schedule sched, int M, int N,
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
        const int2 tile = sched.tile(t);
        const int m0 = tile.x * BM, n0 = tile.y * BN;
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
      const int2 tile = sched.tile(tt);
      const int m0 = tile.x * BM, n0 = tile.y * BN;
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
                const __grid_constant__ CUtensorMap map_c, Schedule sched, int M, int N, int K) {
  mm_body<Op, BN, 0>(map_a, map_b, map_c, sched, M, N, K);
}

// The probes apart from the product kernel, so that its name (which the
// profiler reports and chip_smoke.py watches for spills) is the product's
// alone.
template <typename Op, int BN, int PROBE>
__global__ void __launch_bounds__(THREADS, 1)
mm_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, Schedule sched, int M, int N, int K) {
  mm_body<Op, BN, PROBE>(map_a, map_b, map_c, sched, M, N, K);
}

// ---- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix as boxes of box_rows x box_cols elements
// (box_cols * bytes <= 128), 128-byte swizzled; loads past rows or cols give
// zeros, stores there are dropped.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int rows,
              int cols, int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  const Schedule sched{(M + BM - 1) / BM, (N + BN - 1) / BN};
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
