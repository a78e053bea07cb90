// Kernel K11: a tiled GEMM on the tensor cores through mma.sync, s8 x s8 ->
// s32 and bf16 x bf16 -> f32, for sm_90a.
//
// Replaces the TPU kernel scripts/int8_matmul_probe.py:pallas_mm (pallas_call
// at :85, body _mm_kernel :66-79): C (M, N) = A (M, K) B (K, N), A and B
// row-major, summed in int32 for s8 and in float32 for bf16. The probe asks
// whether a hand-written kernel reaches the card's int8 rate, twice its bf16
// rate.
//
// What bounds it on this card: operations. At the probe's shape
// (16384 x 12288) @ (12288 x 3072) the product is 1.24 TOP against 0.44 GB
// moved in s8 (0.68 GB in bf16): 0.625 ms at the dense int8 rate of 1,979
// TOP/s and 1.25 ms at 989 bf16 TFLOP/s, against 0.13 / 0.20 ms of bytes.
//
// Design: the TPU kernel walks a (M/bm, N/bn, K/bk) grid whose last axis is
// sequential and carries the sum in a VMEM scratch block. Blocks here run in
// no order, so one block owns a BM x BN output tile and loops over K itself,
// 64 bytes of k a stage (64 s8 or 32 bf16 values), double-buffered: the next
// stage is fetched into registers while the warps multiply the current one
// from shared memory. The 8 warps split the tile WARPS_M x WARPS_N; a warp
// issues mma.sync m16n8k32 (s8) or m16n8k16 (bf16) over its 16 x 8 tiles,
// both of which read 32 bytes of k per operand. Both operands are staged
// k-contiguous, As[m][k] and Bs[n][k], rows padded by 16 bytes, so every
// fragment register is one conflict-free 32-bit shared load whatever the
// type. A is k-contiguous in memory already; B is (K, N) row-major while
// mma's "col" operand wants k-contiguous columns, and ldmatrix.trans moves
// 16-bit elements only, so each thread transposes a 4-byte x 4-byte unit of
// B in registers (__byte_perm) as it stages it. Tile sizes are template
// parameters; three variants are compiled (TILES below) and the probe sweeps
// them. Rows past M and columns past N are read as clamped or zero and not
// written; K is whole stages. No cp.async, TMA or wgmma yet: a first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 64;        // bytes of k per stage
constexpr int LDS = BK + 16;  // bytes per staged row
constexpr int KSTEP = 32;     // bytes of k per mma, both types

template <typename T>
struct Traits;

template <>
struct Traits<int8_t> {
  using Acc = int;
  static constexpr int R = 4;  // a B unit: 4 k rows x 4 columns, one byte each
  static __device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // w[r] holds columns n..n+3 of k row r; o[j] gets k rows 0..3 of column n+j
  static __device__ __forceinline__ void transpose(const uint32_t (&w)[4], uint32_t (&o)[4]) {
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    o[0] = __byte_perm(t0, t2, 0x5410);
    o[1] = __byte_perm(t0, t2, 0x7632);
    o[2] = __byte_perm(t1, t3, 0x5410);
    o[3] = __byte_perm(t1, t3, 0x7632);
  }
  static __device__ __forceinline__ void store2(int* p, int x, int y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int R = 2;  // a B unit: 2 k rows x 2 columns, two bytes each
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void transpose(const uint32_t (&w)[2], uint32_t (&o)[2]) {
    o[0] = __byte_perm(w[0], w[1], 0x5410);
    o[1] = __byte_perm(w[0], w[1], 0x7632);
  }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

template <typename T, int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(THREADS, 1)
mm_kernel(const T* __restrict__ A, const T* __restrict__ B, typename Traits<T>::Acc* __restrict__ C,
          int M, int N, int K) {
  using Tr = Traits<T>;
  using Acc = typename Tr::Acc;
  constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;             // its mma tiles
  constexpr int R = Tr::R;
  constexpr int KG = BK / 4;                            // 4-byte k groups of a stage
  constexpr int A_CHUNKS = BM * (BK / 16) / THREADS;    // 16-byte A loads a thread
  constexpr int B_UNITS = KG * (BN / R) / THREADS;      // B units a thread
  static_assert(MT * 16 == WM && NT * 8 == WN && A_CHUNKS * THREADS == BM * (BK / 16) &&
                B_UNITS * THREADS == KG * (BN / R), "tile shape");

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;                 // [2][BM][LDS]
  uint8_t* Bs = smem + 2 * BM * LDS;  // [2][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint8_t* Ab = reinterpret_cast<const uint8_t*>(A);
  const uint8_t* Bb = reinterpret_cast<const uint8_t*>(B);
  const long long lda = (long long)K * sizeof(T), ldb = (long long)N * sizeof(T);

  uint4 a_reg[A_CHUNKS];
  uint32_t b_reg[B_UNITS][R];

  auto load = [&](int kt) {  // stage kt: global -> registers
    const int kb0 = kt * BK;
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = tid + c * THREADS, row = idx / (BK / 16), ch = idx % (BK / 16);
      const int m = min(m0 + row, M - 1);
      a_reg[c] = __ldg(reinterpret_cast<const uint4*>(Ab + m * lda + kb0 + ch * 16));
    }
#pragma unroll
    for (int u = 0; u < B_UNITS; ++u) {
      const int idx = tid + u * THREADS, kg = idx % KG, ng = idx / KG;
      const int n = n0 + ng * R;
      const int k = (kb0 + kg * 4) / (int)sizeof(T);
#pragma unroll
      for (int r = 0; r < R; ++r)
        b_reg[u][r] = n < N ? __ldg(reinterpret_cast<const uint32_t*>(
                                  Bb + (k + r) * ldb + (long long)n * sizeof(T)))
                            : 0u;
    }
  };
  auto stash = [&](int buf) {  // registers -> shared buffer buf, B transposed
    uint8_t* as = As + buf * BM * LDS;
    uint8_t* bs = Bs + buf * BN * LDS;
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = tid + c * THREADS, row = idx / (BK / 16), ch = idx % (BK / 16);
      *reinterpret_cast<uint4*>(as + row * LDS + ch * 16) = a_reg[c];
    }
#pragma unroll
    for (int u = 0; u < B_UNITS; ++u) {
      const int idx = tid + u * THREADS, kg = idx % KG, ng = idx / KG;
      uint32_t o[R];
      Tr::transpose(b_reg[u], o);
#pragma unroll
      for (int j = 0; j < R; ++j)
        *reinterpret_cast<uint32_t*>(bs + (ng * R + j) * LDS + kg * 4) = o[j];
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int n_k = (int)(lda / BK);
  load(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) load(kt + 1);
    const uint8_t* as = As + cur * BM * LDS + wm * WM * LDS;
    const uint8_t* bs = Bs + cur * BN * LDS + wn * WN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += KSTEP) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // rows g and g+8, k bytes 4*tig and 16+4*tig
        const uint8_t* p = as + (i * 16 + g) * LDS + ks + 4 * tig;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // column g, k bytes 4*tig and 16+4*tig
        const uint8_t* p = bs + (j * 8 + g) * LDS + ks + 4 * tig;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) Tr::mma(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < n_k) stash(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = m0 + wm * WM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WN + j * 8 + 2 * tig;
      if (col >= N) continue;  // N % 8 == 0: an 8-column tile is all in or all out
      if (row < M) Tr::store2(C + (long long)row * N + col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M) Tr::store2(C + (long long)(row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <typename T, int BM, int BN, int WARPS_M>
cudaError_t run(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  constexpr int bytes = 2 * (BM + BN) * LDS;
  auto kernel = mm_kernel<T, BM, BN, WARPS_M>;
  if constexpr (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                           static_cast<typename Traits<T>::Acc*>(c), M, N, K);
  return cudaGetLastError();
}

// The compiled tile variants, by index: BM x BN (WARPS_M x WARPS_N warps).
//   0: 128 x 128 (2 x 4)   1: 128 x 256 (2 x 4)   2: 256 x 128 (4 x 2)
template <typename T>
cudaError_t run_tile(int tile, const void* a, const void* b, void* c, int M, int N, int K,
                     cudaStream_t stream) {
  switch (tile) {
    case 0: return run<T, 128, 128, 2>(a, b, c, M, N, K, stream);
    case 1: return run<T, 128, 256, 2>(a, b, c, M, N, K, stream);
    case 2: return run<T, 256, 128, 4>(a, b, c, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, all row-major and 16-byte
// aligned; K % 64 == 0, N % 8 == 0.
extern "C" int qvc_mm_s8(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                         void* stream) {
  return (int)run_tile<int8_t>(tile, a, b, c, M, N, K, (cudaStream_t)stream);
}

// C (M, N) float32 = A (M, K) bf16 @ B (K, N) bf16, all row-major and 16-byte
// aligned; K % 32 == 0, N % 8 == 0.
extern "C" int qvc_mm_bf16(const void* a, const void* b, void* c, int M, int N, int K, int tile,
                           void* stream) {
  return (int)run_tile<__nv_bfloat16>(tile, a, b, c, M, N, K, (cudaStream_t)stream);
}
