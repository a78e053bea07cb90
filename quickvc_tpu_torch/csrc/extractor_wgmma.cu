// K7's bf16 mode on a persistent, warp-specialised TMA + wgmma body, for
// sm_90a: HuBERT's extractor front, conv0 (k=10, stride 5, 1 -> C) ->
// per-(batch, channel) affine -> tanh GELU -> conv1 (k=3, stride 2, C -> C)
// -> tanh GELU, at C = 512 (HuBERT's width).
//
// Replaces the bf16 branch of the TPU kernel
// quickvc_tpu/ops/fused_extractor.py:fused_extractor_front (pallas_call at
// :187, body _kernel at :92-110), as fused_extractor.cu's bf16 mode does (the
// mma.sync body, which keeps the shapes this one does not take; the host
// routes by shape before the launch, ops/fused_extractor.py:takes_wgmma).
// The same function, rounded where the TPU kernel rounds:
//
//   h[t, c]      = bf16(gelu_tanh(bf16(scale[c] * sum_k wav[5t + k] w0b[c, k] + shift[c])))
//   out[b, u, o] = bf16(gelu_tanh(bf16(sum_{j < 3, c < C} h[2u + j, c] * w1[j, c, o])))
//
// w0b conv0's weight rounded to bf16, (scale, shift) the closed form on the
// unrounded weight (computed outside, as JAX does); conv0's 10 products of
// bf16 values are exact in float32, summed in the mma.sync body's order, so
// h has that body's bits.
//
// What bounds it on this card: operations. At the encoding batch (16, 96080)
// conv1 is 2 x 16 x 9607 x 512 x 1536 = 242 GFLOP, 0.245 ms at the 989
// TFLOP/s dense bf16 rate, and conv0 3.1 GFLOP (0.046 ms on the float32
// units), against ~157 MB of wave, weights and output (0.047 ms). Producing
// h (157 M values, each 10 FMAs, the affine, two roundings and a tanh GELU
// in float32) takes tens of instructions a value, a large share of the
// card's issue slots, which have to run beside the tensor cores, not in
// turn with them.
//
// Design (the mma.sync body's GEMM turned over: A = h, B = w1):
// - A cluster of 2 CTAs, one an SM, persistent: cluster k walks pairs of
//   64-row tiles p = k, k + clusters, ... (host twin
//   ops/fused_extractor.py:front_wgmma_plan), CTA r of it tile 2p + r, a
//   tile being 64 output rows u of one batch item and all 512 channels
//   (tiles of a batch item: ceil(n1 / 64); a last odd tile's partner stores
//   nothing). A tile covers every channel so that each h value is produced
//   once; 64 x 512 float32 sums are all two warpgroups' registers hold.
// - conv1 is the implicit GEMM out (64 x 512) = sum over K = 3 taps x 512
//   in-channels, walked as 8 slices of 64 in-channels, 3 taps each: 24
//   stages a tile. A stage of w1 is its 512 output rows x 64 in-channels
//   of one tap, K-major ([tap][out][in], 128-byte swizzled), 64 KB, by TMA
//   into a ring of 3; each CTA of the pair loads its half (256 outputs) and
//   multicasts it to both, so w1 leaves L2 once per 128 output rows (1.8
//   GB a call at the encoding batch, not the mma.sync body's 3.7). A
//   stage's "empty" barrier takes 4 arrivals, the two consumer warpgroups
//   of both CTAs, before either CTA's TMA refills it.
// - Warpgroup 0 produces h: each thread 2 channels of every fourth conv0
//   row pair of the tile (conv0 -> affine -> GELU, as the mma.sync body's
//   store_row computes it), into a double buffer of 129 rows x 64 channels
//   a slice, bf16, even conv0 rows first (tap 0 reads row 2u, tap 1 row
//   2u + 1, tap 2 row 2u + 2: 64 consecutive rows of one half), each row's
//   16-byte chunk q at chunk q ^ (row % 8) (host twin front_h_offset), so
//   that the 8 rows of every ldmatrix phase hit 8 bank groups, tap 2's
//   one-row shift included. Slices go by "h full"/"h empty" barriers; each
//   slice's conv0 weights, scale and shift are loaded a slice ahead.
// - The w1 ring is kept full by the first consumer warpgroup's thread 0:
//   once both CTAs' consumers have handed a stage back it issues the TMA
//   that refills it. (Issued from the producer between row pairs, the
//   loads waited on production, and the two sides' times added up.)
// - Warpgroups 1 and 2 consume: warpgroup c takes output channels [256 c,
//   256 c + 256) of the tile's 64 rows. Tap 2's one-row shift breaks the
//   128-byte swizzle atom's 8-row alignment of a shared-memory A
//   descriptor, so A comes from registers: each warp ldmatrix-es its 16
//   rows' fragments of the stage's four k16 steps (rows h_row(2u + j)), then
//   four wgmma.m64n256k16 with A in registers and B from the stage's
//   descriptor, float32 sums, one commit group, waited before the stage
//   goes back (the other warpgroup's group keeps the tensor cores busy
//   meanwhile). setmaxnreg moves registers from the producer (112) to the
//   consumers (192: 128 accumulators).
// - Epilogue on the accumulators in registers: round to bf16, tanh GELU in
//   float32, round again, stored as bf16 pairs (rows past n1 dropped). No
//   atomics: every launch on the same inputs gives the same bits.
//
// Where its time goes (a one-off probe of this body with parts of its work
// taken out, not kept): production-bound, h alone takes most of the body's
// time, the weights and wgmma alone less. Each SM still takes in all of w1
// (1.5 MB) per 64-row tile, multicast or not. A second producer
// warpgroup does not fit: at 512 threads ptxas has 128 registers a thread,
// and m64n256k16 with A in registers needs 158.
//
// Takes C == 512 and any T >= 20; 16-byte aligned w1k; wav, w0, scale and
// shift as the mma.sync body takes them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"   // gelu_tanh, round_bf16, pack_bf16, ldmatrix
#include "tma_wgmma.cuh"   // mbarriers, TMA (multicast), wgmma, clusters, tensor maps

namespace {
namespace frontwg {

using namespace tmawg;
using bf16core::bf16_t;

constexpr int C = 512;                     // channels: the body's only width
constexpr int HALF = 256;                  // output channels a consumer warpgroup
constexpr int BM = 64;                     // output rows a tile
constexpr int KC = 64;                     // in-channels a slice: one 128-byte row
constexpr int SLICES = C / KC;
constexpr int TAPS = 3;
constexpr int STEPS = SLICES * TAPS;       // w1 stages a tile
constexpr int STAGES = 3;                  // the w1 ring
constexpr int STAGE_BYTES = C * KC * 2;    // 512 output rows x 64 in-channels, bf16
constexpr int HROWS = 2 * BM + 1;          // conv0 rows a tile reads
constexpr int HEVEN = BM + 1;              // even rows first, then the odd ones
constexpr int H_BYTES = HROWS * 128;       // one slice of h
constexpr int WAVE = 5 * (HROWS - 1) + 10; // wave samples a tile reads
constexpr int WAVE_BYTES = (2 * WAVE + 15) / 16 * 16;
constexpr int PRODUCERS = 128;             // one producer warpgroup
constexpr int THREADS = PRODUCERS + 256;   // and two consumer warpgroups
constexpr int CLUSTER = 2;                 // CTAs sharing each w1 stage by multicast
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * H_BYTES + WAVE_BYTES + 1024;  // + alignment
static_assert(SMEM + 10 * 8 <= 232448, "the ring, h, the wave and the barriers fit a CTA");

// The slice row of conv0 row t (0 .. 128) of the tile, and the byte offset
// of its channel c (0 .. 63): 16-byte chunk c / 8 at chunk (c / 8) ^ (row % 8)
// (host twins: ops/fused_extractor.py:front_h_row, front_h_offset)
__host__ __device__ constexpr int h_row(int t) { return (t & 1) ? HEVEN + (t >> 1) : t >> 1; }
__host__ __device__ constexpr int h_offset(int row, int c) {
  return row * 128 + (((c >> 3) ^ (row & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// conv0 row (10 samples s) -> affine -> GELU for one channel (w, sc, sh), as
// fused_extractor.cu's bf16 store_row computes it
__device__ __forceinline__ float front_h(const float* s, const float (&w)[10], float sc,
                                         float sh) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k) x = fmaf(s[k], w[k], x);
  return bf16core::gelu_tanh(bf16core::round_bf16(fmaf(x, sc, sh)));
}

struct Tile {
  int b, u0;
  bool valid;
};

__device__ __forceinline__ Tile tile_of(int pair, int rank, int tiles, int tiles_per_batch) {
  const int t = 2 * pair + rank;
  const bool valid = t < tiles;
  const int tt = valid ? t : 0;
  return Tile{tt / tiles_per_batch, BM * (tt % tiles_per_batch), valid};
}

__global__ void __launch_bounds__(THREADS, 1)
extractor_front_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                             const bf16_t* __restrict__ wav, const float* __restrict__ w0,
                             const float* __restrict__ scale, const float* __restrict__ shift,
                             bf16_t* __restrict__ out, int T, int n1, int tiles_per_batch,
                             int tiles) {
  extern __shared__ uint8_t front_wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], h_full[2], h_empty[2];
  // 128-byte swizzle wants each stage on a 1024-byte boundary; both CTAs of
  // the cluster lay it out alike, so a multicast lands at the same offsets
  uint8_t* smem = front_wg_smem_raw + ((1024 - (smem_u32(front_wg_smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;                                 // [STAGES][C rows][128 bytes]
  uint8_t* hbuf = ring + STAGES * STAGE_BYTES;          // [2][HROWS][128 bytes]
  bf16_t* ws = reinterpret_cast<bf16_t*>(hbuf + 2 * H_BYTES);  // the tile's wave samples
  const uint32_t rank = cluster_ctarank();
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  const int pairs = (tiles + 1) / 2;
  const int items = cluster < pairs ? (pairs - 1 - cluster) / clusters + 1 : 0;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * CLUSTER);  // both consumer warpgroups of both CTAs
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&h_full[i], PRODUCERS / 32);  // every producer warp
      mbar_init(&h_empty[i], 2);  // both consumer warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every barrier of both CTAs initialised before any multicast or arrival

  if (threadIdx.x < PRODUCERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 112;\n");
    constexpr int WARPS = PRODUCERS / 32;
    const int tid = threadIdx.x, pw = tid / 32, lane = tid % 32;
    int hs = 0;  // slices produced
    for (int it = 0; it < items; ++it) {
      const Tile tile = tile_of(cluster + it * clusters, rank, tiles, tiles_per_batch);
      // the tile's wave: conv0 row r reads samples [5r, 5r + 10) of its
      // segment; samples past the wave's end read as zeros and feed only
      // rows u >= n1
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");  // last tile's rows done
      const bf16_t* wb = wav + (long long)tile.b * T;
      const long long base = 10LL * tile.u0;
      for (int i = tid; i < WAVE; i += PRODUCERS)
        ws[i] = tile.valid && base + i < T ? wb[base + i] : (bf16_t)0;
      asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS) : "memory");
      const float* sc_b = scale + (long long)tile.b * C;
      const float* sh_b = shift + (long long)tile.b * C;
      // this thread's channels 2 lane, 2 lane + 1 of each slice: conv0's
      // weights, scale and shift, loaded a slice ahead
      float wn[2][10], scn[2], shn[2];
      auto load_slice = [&](int sl) {
        const int c0 = KC * sl + 2 * lane;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int k = 0; k < 10; ++k) wn[e][k] = __ldg(w0 + (c0 + e) * 10 + k);
          scn[e] = __ldg(sc_b + c0 + e);
          shn[e] = __ldg(sh_b + c0 + e);
        }
      };
      load_slice(0);
      for (int sl = 0; sl < SLICES; ++sl, ++hs) {
        uint8_t* hb = hbuf + (hs & 1) * H_BYTES;
        float w[2][10], sc[2], sh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int k = 0; k < 10; ++k) w[e][k] = wn[e][k];
          sc[e] = scn[e];
          sh[e] = shn[e];
        }
        if (sl + 1 < SLICES) load_slice(sl + 1);
        mbar_wait(&h_empty[hs & 1], ((hs >> 1) & 1) ^ 1);
        // row pairs (2P, 2P + 1), P = pw + 4 i, then row 128 by warp 0
#pragma unroll 1
        for (int P = pw; P <= BM; P += WARPS) {
          const int rows = P < BM ? 2 : 1;
          float s[16];  // wave samples 10 P .. 10 P + 15 (as 8 bf16 pairs)
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(ws + 10 * P);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t v = i < 5 || rows == 2 ? wp[i] : 0u;
            s[2 * i] = lo_bf16(v);
            s[2 * i + 1] = hi_bf16(v);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r >= rows) break;
            const int row = h_row(2 * P + r);
            const uint32_t pair = bf16core::pack_bf16(front_h(s + 5 * r, w[0], sc[0], sh[0]),
                                                      front_h(s + 5 * r, w[1], sc[1], sh[1]));
            *reinterpret_cast<uint32_t*>(hb + h_offset(row, 2 * lane)) = pair;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&h_full[hs & 1]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n");
    const int cw = wgi - PRODUCERS / 128;  // output channels [256 cw, 256 cw + 256)
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
    // ldmatrix rows of this lane: tile row i = 16 w + lane % 16, k chunk
    // lane / 16 of each k16 step; tap j reads slice row h_row(2 i + j)
    const int i_row = 16 * w + (lane & 15), half = lane >> 4;
    int tap_row[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) tap_row[j] = h_row(2 * i_row + j);
    const uint32_t h_base = smem_u32(hbuf);
    // warpgroup 1's thread 0 keeps the ring full: stage n of this CTA's
    // sequence is stage n % STEPS of its tile (slice kt / 3, tap kt % 3),
    // this CTA's half of it multicast to both; it refills a stage once
    // both CTAs' consumers have handed it back
    const bool issuer = cw == 0 && t == 0;
    const int total = items * STEPS;
    auto issue = [&](int m) {
      const int s = m % STAGES, kt = m % STEPS;
      mbar_expect_tx(&full[s], STAGE_BYTES);
      tma_load_2d_multicast(ring + s * STAGE_BYTES + rank * (STAGE_BYTES / 2), &map_w1, &full[s],
                            KC * (kt / TAPS), (kt % TAPS) * C + (int)rank * HALF,
                            (uint16_t)((1u << CLUSTER) - 1));
    };
    if (issuer)
      for (int m = 0; m < STAGES && m < total; ++m) issue(m);
    int n = 0, hs = 0;
    for (int it = 0; it < items; ++it) {
      const Tile tile = tile_of(cluster + it * clusters, rank, tiles, tiles_per_batch);
      float acc[HALF / 2];
#pragma unroll
      for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.0f;
      for (int sl = 0; sl < SLICES; ++sl, ++hs) {
        mbar_wait(&h_full[hs & 1], (hs >> 1) & 1);
        const uint32_t hb = h_base + (hs & 1) * H_BYTES;
#pragma unroll
        for (int j = 0; j < TAPS; ++j, ++n) {
          const int s = n % STAGES;
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int row = tap_row[j];
            bf16core::ldmatrix_x4(a[kk], hb + row * 128 + (((2 * kk + half) ^ (row & 7)) << 4));
          }
          mbar_wait(&full[s], (n / STAGES) & 1);
          const uint64_t db = desc_k_major(ring + s * STAGE_BYTES + cw * (STAGE_BYTES / 2));
          fence_operands(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_bf16_rs<0>(acc, a[kk], db + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(acc);
          if (t == 0)
            for (uint32_t r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(&empty[s], r);
          if (issuer && n + STAGES < total) {
            mbar_wait(&empty[s], (n / STAGES) & 1);
            issue(n + STAGES);
          }
        }
        if (t == 0) mbar_arrive(&h_empty[hs & 1]);
      }
      if (!tile.valid) continue;
      // register 4 i + {0, 1}: row 16 w + lane / 4, channels 8 i + 2 (lane % 4)
      // + {0, 1}; 4 i + {2, 3} the same channels 8 rows down
      const int ch0 = HALF * cw + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int u = tile.u0 + 16 * w + lane / 4 + 8 * hh;
        if (u >= n1) continue;
        bf16_t* row = out + ((long long)tile.b * n1 + u) * C + ch0;
#pragma unroll
        for (int i = 0; i < HALF / 8; ++i)
          *reinterpret_cast<uint32_t*>(row + 8 * i) = bf16core::pack_bf16(
              bf16core::gelu_tanh(bf16core::round_bf16(acc[4 * i + 2 * hh])),
              bf16core::gelu_tanh(bf16core::round_bf16(acc[4 * i + 2 * hh + 1])));
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while its partner may still multicast or arrive into it
}

}  // namespace frontwg
}  // namespace

// K7's bf16 mode on the TMA + wgmma body: out (B, n1, 512) bf16 from wav (B,
// T) bf16, w0 (512, 10) float32 holding bf16 values, scale/shift (B, 512)
// float32 and w1k (3, 512, 512) bf16 = conv1's weight as [tap][out][in],
// 16-byte aligned; `clusters` clusters of 2 CTAs walk the tile pairs
// (ops/fused_extractor.py:front_wgmma_plan). Refuses C != 512.
extern "C" int qvc_extractor_front_bf16_wgmma(const void* wav, const void* w0,
                                              const void* scale, const void* shift,
                                              const void* w1k, void* out, int batch, int T,
                                              int C, int n1, int clusters, void* stream) {
  namespace fw = frontwg;
  if (C != fw::C || n1 < 1 || batch < 1 || clusters < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!tmawg::make_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w1k, fw::TAPS * C, C, fw::HALF,
                       fw::KC))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fw::extractor_front_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, fw::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_batch = (n1 + fw::BM - 1) / fw::BM, tiles = batch * tiles_per_batch;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(clusters * fw::CLUSTER);
  cfg.blockDim = dim3(fw::THREADS);
  cfg.dynamicSmemBytes = fw::SMEM;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = fw::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fw::extractor_front_wgmma_kernel, map,
                           (const bf16core::bf16_t*)wav, (const float*)w0, (const float*)scale,
                           (const float*)shift, (bf16core::bf16_t*)out, T, n1, tiles_per_batch,
                           tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
