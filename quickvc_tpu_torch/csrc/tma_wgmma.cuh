// The TMA + wgmma machinery of the port's Hopper bodies, for sm_90a: K11
// (int8_mm.cu), the bf16 wgmma GEMM core (wgmma_bf16.cuh, which K8's bf16
// GEMMs and K5/K6's bf16 implicit GEMM run on) and the bf16 attention body
// (fused_attention_bf16.cuh) share it, and keep only their
// kernel bodies and epilogues. Included by several sources, so everything
// here has internal linkage.
//
// - Schedule: work item t of a persistent grid -> (split, tile row, tile
//   col), a grouped raster of GROUP_M tile rows, so that the tiles that run
//   at the same time share the second operand's tiles in L2 (host twins:
//   ops/int8_mm.py:tile_schedule, ops/fused_transformer.py:wgmma_schedule).
// - mbarrier and TMA: the producer's loads (cp.async.bulk.tensor of 2-D
//   and 4-D boxes, 128-byte swizzle) signal a stage's "full" barrier with
//   its byte count.
// - wgmma: descriptors of K-major and MN-major 128-byte swizzled tiles,
//   fence, commit and wait, the accumulator fence (fence_operands), the
//   accumulator operand lists and the bf16 m64nNk16 instructions: A and B
//   from shared memory for N 32 .. 256 (either K-major or MN-major: the
//   transpose immediates), A from registers for N 64, 128 and 256.
// - Clusters: TMA multicast of a box to every CTA of a cluster mask, a
//   barrier arrival in another CTA of the cluster (mapa), and the cluster
//   barrier.
// - Host: tensor maps encoded by cuTensorMapEncodeTiled, found through
//   cudaGetDriverEntryPoint (nothing links libcuda), passed to the kernels
//   as __grid_constant__ parameters: row-major matrices, and strided 4-D
//   views.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tmawg {

// Work item t -> (split z, tile row, tile col): the splits one after
// another; within a split, groups of GROUP_M tile rows (fewer in the last),
// walked column by column, the rows of a column one after another.
template <int GROUP_M>
struct Schedule {
  int tiles_m, tiles_n, splits, k_chunk;
  __host__ __device__ int total() const { return tiles_m * tiles_n * splits; }
  __host__ __device__ int3 item(int t) const {
    const int tiles = tiles_m * tiles_n;
    const int z = t / tiles, local = t % tiles;
    const int per_group = GROUP_M * tiles_n;
    const int grp = local / per_group, first = grp * GROUP_M;
    const int rows = tiles_m - first < GROUP_M ? tiles_m - first : GROUP_M;
    const int in = local - grp * per_group;
    return make_int3(z, first + in % rows, in / rows);
  }
};

// ---- mbarrier and TMA ----------------------------------------------------------

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

// A 2-D box loaded into the same shared-memory offset of every CTA of the
// cluster in `mask`, each signalling its own barrier at bar's offset with
// the box's bytes
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// ---- clusters ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// One arrival on the barrier at bar's offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

// Every thread of every CTA of the cluster: shared-memory writes (remote ones
// too) and barrier inits visible cluster-wide before any thread goes on
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A box of a 4-D tensor map at coordinates (c0 innermost .. c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------------

// wgmma shared-memory descriptor, 128-byte swizzle (mode 1), start >> 4, of
// a K-major tile: 128-byte rows of k, 1024 bytes between 8-row groups
// (stride offset; the leading offset unused).
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma shared-memory descriptor, 128-byte swizzle (mode 1), start >> 4, of
// an MN-major tile: k rows of 64 columns (128 bytes), 1024 bytes between 8-row k
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
// did, in K11's bf16 body, and the copies lost the last products). Fence
// them before each stage's wgmma.fence and after the last wait_group.
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

// the accumulator operands of one wgmma, %0 .. %127 in lists of 32
#define WG_REGS_0_31                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS_32_63                                                                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_REGS_64_95                                                                   \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_REGS_96_127                                                                  \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "   \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "     \
  "%123, %124, %125, %126, %127"
#define WG_REGS_0_15 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
// 8 and 32 accumulators d[i] .. as read-write operands of constraint c
#define WG_ACC8(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), \
                         c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define WG_ACC32(c, d, i) WG_ACC8(c, d, i), WG_ACC8(c, d, i + 8), WG_ACC8(c, d, i + 16), \
                          WG_ACC8(c, d, i + 24)

// d (64 x N) += A (64 x 16) B (16 x N), bf16 from two descriptors, float32
// sums; N = 2 x the accumulators a thread. A is K-major for TRANS_A 0 (A (M,
// K) as it lies) and MN-major for TRANS_A 1 (A^T (K, M)); B is K-major for
// TRANS_B 0 (B^T (N, K) as it lies) and MN-major for TRANS_B 1 (B (K, N)).
// %N, %N+1 are the descriptors and %N+2 the scale-d predicate after the N/2
// accumulators, then the two transpose immediates.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_REGS_0_15 "},"
               " %16, %17, p, 1, 1, %20, %19;\n}\n"
               : WG_ACC8("+f", d, 0), WG_ACC8("+f", d, 8)
               : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS_0_31 "},"
               " %32, %33, p, 1, 1, %36, %35;\n}\n"
               : WG_ACC32("+f", d, 0)
               : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS_0_31 ", "
               WG_REGS_32_63 "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
               : WG_ACC32("+f", d, 0), WG_ACC32("+f", d, 32)
               : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WG_REGS_0_31 ", "
               WG_REGS_32_63 ", " WG_REGS_64_95 "}, %96, %97, p, 1, 1, %100, %99;\n}\n"
               : WG_ACC32("+f", d, 0), WG_ACC32("+f", d, 32), WG_ACC32("+f", d, 64)
               : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS_0_31 ", "
               WG_REGS_32_63 ", " WG_REGS_64_95 ", " WG_REGS_96_127
               "}, %128, %129, p, 1, 1, %132, %131;\n}\n"
               : WG_ACC32("+f", d, 0), WG_ACC32("+f", d, 32), WG_ACC32("+f", d, 64),
                 WG_ACC32("+f", d, 96)
               : "l"(da), "l"(db), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

// d (64 x N) += A (64 x 16) B (16 x N) with A from registers: a[4] is the
// thread's A fragment, the m16n8k16 layout per warp (warp w of the
// warpgroup holds rows 16 w .. 16 w + 15: a[0] row lane / 4, k 2 (lane % 4)
// and + 1; a[1] the row + 8; a[2], a[3] the same at k + 8). B from a
// descriptor as above.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS_0_31 "},"
               " {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
               : WG_ACC32("+f", d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B), "r"(1));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS_0_31 ", "
               WG_REGS_32_63 "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
               : WG_ACC32("+f", d, 0), WG_ACC32("+f", d, 32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS_0_31 ", "
               WG_REGS_32_63 ", " WG_REGS_64_95 ", " WG_REGS_96_127
               "}, {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
               : WG_ACC32("+f", d, 0), WG_ACC32("+f", d, 32), WG_ACC32("+f", d, 64),
                 WG_ACC32("+f", d, 96)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B), "r"(1));
}

// ---- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A row-major (rows, cols) matrix of `bytes`-byte elements as boxes of
// box_rows x box_cols elements (box_cols * bytes <= 128), 128-byte swizzled;
// loads past rows or cols give zeros, stores there are dropped.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base,
                     int rows, int cols, int box_rows, int box_cols) {
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

// A strided 4-D view of `bytes`-byte elements, dims[0] innermost (unit
// stride) and strides[i] the bytes between steps of dims[i + 1], as boxes of
// box[0] x .. x box[3] elements (box[0] * bytes <= 128), 128-byte swizzled;
// loads past a dim's end give zeros. TMA takes a base and strides that are
// multiples of 16 bytes; anything else is refused here (false).
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        const long long (&dims)[4], const long long (&strides)[3],
                        const int (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t b[4], elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < 3; ++i) {
    if (strides[i] % 16 != 0 || strides[i] <= 0) return false;
    st[i] = (cuuint64_t)strides[i];
  }
  return encode(map, type, 4, const_cast<void*>(base), d, st, b, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tmawg
}  // namespace
