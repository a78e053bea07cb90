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
// Design. wgmma reads 8-bit operands K-major only, and B is N-major, so a
// pre-pass (transpose_kernel, through a padded 32 x 32 shared tile, coalesced
// both ways) writes B^T (N, K) into scratch the host allocates; bf16 takes
// the same pre-pass, so one layout and one descriptor scheme serve both
// types. The TPU kernel's sequential k axis becomes a loop inside a block of
// three warpgroups that owns a 128 x BN tile of C. Warpgroup 0 is the
// producer: one thread keeps a ring of STAGES shared-memory stages filled by
// TMA (cp.async.bulk.tensor, 128-byte swizzle), each stage 128 bytes of k of
// the A tile (128 rows) and of the B^T tile (BN rows), signalled on a "full"
// mbarrier with the stage's byte count. Warpgroups 1 and 2 are the
// consumers, 64 rows of the tile each: per stage four wgmma.mma_async of 32
// bytes of k (m64nBNk16 bf16, m64nBNk32 s8), both operands read from shared
// memory through descriptors (128-byte swizzle, 1024 bytes between 8-row
// groups), one commit group a stage with one group left in flight; a stage
// goes back to the producer on its "empty" mbarrier once its group is done.
// setmaxnreg moves registers from the producer (40) to the consumers (232):
// BN/2 accumulators a thread. The epilogue writes the accumulator fragments
// straight to C, masked at ragged M and N; TMA's zero fill covers ragged M,
// N and K. The tensor maps are encoded on the host (cuTensorMapEncodeTiled,
// found through cudaGetDriverEntryPoint, so nothing links libcuda) and
// passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // rows of C a block
constexpr int BK_BYTES = 128;      // bytes of k a stage: one 128-byte swizzle row
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int RING_BYTES = 192 * 1024;

// ---- the B^T pre-pass ------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols) {
  __shared__ T tile[32][33];
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

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// 128-byte swizzle: start >> 4, leading offset 16 bytes (unused by this
// layout), 1024 bytes between 8-row groups, swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
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

#define ACC8(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), \
                      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24),
        ACC8("+f", d, 32), ACC8("+f", d, 40), ACC8("+f", d, 48), ACC8("+f", d, 56),
        ACC8("+f", d, 64), ACC8("+f", d, 72), ACC8("+f", d, 80), ACC8("+f", d, 88),
        ACC8("+f", d, 96), ACC8("+f", d, 104), ACC8("+f", d, 112), ACC8("+f", d, 120)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8("+f", d, 0), ACC8("+f", d, 8), ACC8("+f", d, 16), ACC8("+f", d, 24),
        ACC8("+f", d, 32), ACC8("+f", d, 40), ACC8("+f", d, 48), ACC8("+f", d, 56)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p;\n"
      "}\n"
      : ACC8("+r", d, 0), ACC8("+r", d, 8), ACC8("+r", d, 16), ACC8("+r", d, 24),
        ACC8("+r", d, 32), ACC8("+r", d, 40), ACC8("+r", d, 48), ACC8("+r", d, 56),
        ACC8("+r", d, 64), ACC8("+r", d, 72), ACC8("+r", d, 80), ACC8("+r", d, 88),
        ACC8("+r", d, 96), ACC8("+r", d, 104), ACC8("+r", d, 112), ACC8("+r", d, 120)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "},"
      " %64, %65, p;\n"
      "}\n"
      : ACC8("+r", d, 0), ACC8("+r", d, 8), ACC8("+r", d, 16), ACC8("+r", d, 24),
        ACC8("+r", d, 32), ACC8("+r", d, 40), ACC8("+r", d, 48), ACC8("+r", d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// The two types: element bytes, accumulator, TMA element type, one wgmma
// of 32 bytes of k over a BN-wide tile, a store of two accumulators.
struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
    if constexpr (BN == 256) wgmma_bf16_n256(d, da, db);
    else wgmma_bf16_n128(d, da, db);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

struct S8 {
  using Acc = int;
  static constexpr int BYTES = 1;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  template <int BN>
  static __device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t da, uint64_t db) {
    if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
    else wgmma_s8_n128(d, da, db);
  }
  static __device__ __forceinline__ void store2(int* p, int x, int y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

template <int BN>
struct Ring {
  static constexpr int A_BYTES = BM * BK_BYTES;
  static constexpr int B_BYTES = BN * BK_BYTES;
  static constexpr int STAGES = RING_BYTES / (A_BYTES + B_BYTES);  // 4 at BN 256, 6 at 128
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES) + 1024;  // + alignment slack
};

template <typename Op, int BN>
__global__ void __launch_bounds__(THREADS, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, typename Op::Acc* __restrict__ C,
                int M, int N, int K) {
  using Acc = typename Op::Acc;
  using R = Ring<BN>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle wants each tile on a 1024-byte boundary
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                           // [STAGES][BM][128 bytes]
  uint8_t* sb = smem + STAGES * R::A_BYTES;     // [STAGES][BN][128 bytes]

  const int n_k = (K * Op::BYTES + BK_BYTES - 1) / BK_BYTES;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      constexpr int K_ELEMS = BK_BYTES / Op::BYTES;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], R::A_BYTES + R::B_BYTES);
        tma_load_2d(sa + s * R::A_BYTES, &map_a, &full[s], kt * K_ELEMS, m0);
        tma_load_2d(sb + s * R::B_BYTES, &map_b, &full[s], kt * K_ELEMS, n0);
      }
    }
  } else {
    // consumers: warpgroup c takes rows [64c, 64c + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint64_t da = smem_desc(sa + s * R::A_BYTES + c * 64 * BK_BYTES);
      const uint64_t db = smem_desc(sb + s * R::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK_BYTES / 32; ++kk)   // 32 bytes of k: +2 in the descriptor
        Op::template mma<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's group is done: hand its stage back
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();

    // fragment -> (row, col): warp w of the group holds rows 16w + lane/4 and
    // +8; register 4i + {0, 1, 2, 3} is column 8i + 2*(lane%4) + {0, 1} of
    // the first row, then of the second
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    const int row = m0 + c * 64 + 16 * w + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col >= N) continue;   // N is even: a pair is all in or all out (8-byte aligned)
      if (row < M) Op::store2(C + (long long)row * N + col, acc[4 * i], acc[4 * i + 1]);
      if (row + 8 < M)
        Op::store2(C + (long long)(row + 8) * N + col, acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
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

// A row-major (rows, k) operand as tiles of box_rows x 128 bytes of k, 128-byte
// swizzled; reads past rows or k give zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int rows,
              int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(BK_BYTES / bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Op, int BN>
cudaError_t run(const void* a, const void* bt, void* c, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, Op::TMA, Op::BYTES, a, M, K, BM) ||
      !make_map(&map_b, Op::TMA, Op::BYTES, bt, N, K, BN))
    return cudaErrorInvalidValue;
  auto kernel = mm_wgmma_kernel<Op, BN>;
  constexpr int bytes = Ring<BN>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(map_a, map_b, static_cast<typename Op::Acc*>(c), M, N,
                                          K);
  return cudaGetLastError();
}

// The compiled tiles, by index: 0: 128 x 256, 1: 128 x 128.
template <typename Op>
cudaError_t run_tile(int tile, const void* a, const void* bt, void* c, int M, int N, int K,
                     cudaStream_t stream) {
  switch (tile) {
    case 0: return run<Op, 256>(a, bt, c, M, N, K, stream);
    case 1: return run<Op, 128>(a, bt, c, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B^T (cols, rows) = B (rows, cols) transposed, elements of elem_bytes (1 or 2).
extern "C" int qvc_mm_transpose(const void* b, void* bt, int rows, int cols, int elem_bytes,
                                void* stream) {
  dim3 grid((cols + 31) / 32, (rows + 31) / 32), block(32, 8);
  if (elem_bytes == 1)
    transpose_kernel<uint8_t><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)b, (uint8_t*)bt, rows, cols);
  else if (elem_bytes == 2)
    transpose_kernel<uint16_t><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)b, (uint16_t*)bt, rows, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, given A and B^T (N, K),
// both row-major and 16-byte aligned; K % 64 == 0 (16-byte rows), N % 8 == 0.
extern "C" int qvc_mm_s8(const void* a, const void* bt, void* c, int M, int N, int K, int tile,
                         void* stream) {
  return (int)run_tile<S8>(tile, a, bt, c, M, N, K, (cudaStream_t)stream);
}

// C (M, N) float32 = A (M, K) bf16 @ B (K, N) bf16, given A and B^T (N, K),
// both row-major and 16-byte aligned; K % 32 == 0, N % 8 == 0.
extern "C" int qvc_mm_bf16(const void* a, const void* bt, void* c, int M, int N, int K, int tile,
                           void* stream) {
  return (int)run_tile<Bf16>(tile, a, bt, c, M, N, K, (cudaStream_t)stream);
}
