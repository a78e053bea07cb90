// The speaker LSTM's bf16 recurrence, forward and backward, for sm_90a.
//
// Replaces no TPU kernel. The JAX package runs this recurrence as a
// lax.scan (quickvc_tpu/models/encoders.py:89-125; the sequential order it
// is exact against at :74-87), which XLA compiles; at bf16 it carries h and
// c in bf16 and rounds every op of the cell. cuDNN's bf16 LSTM keeps its
// own precision, and its gradients leave the JAX semantics (fault F2 of
// ROADMAP.md). So the port runs the JAX recurrence in these two kernels
// (ops/lstm_recurrence.py): the forward of every layer in one launch, the
// backward of every layer in another.
//
//   forward   xp_0 (B, T, 4H) = x W_ih,0^T + b_0, every step (the caller's
//             matmul); for layer l >= 1, per step from layer l-1's new h:
//                       xp_l,t = bf16(bf16(h_l-1,t W_ih,l^T) + b_l)
//             (a float32 sum rounded once, then the bias, as the caller's
//             bf16 matmul and add round); per step of each layer:
//                       hw = bf16(h_{t-1} W_hh^T)        float32 sum, one rounding
//                       i, f, g, o = bf16(xp_t + hw)     (gate order of torch)
//                       si, sf, so = bf16(sigmoid(.)), tg = bf16(tanh(g))
//                       c_t = bf16(bf16(sf c_{t-1}) + bf16(si tg))
//                       h_t = bf16(so bf16(tanh(c_t)))
//             out: h (L, B, T, H) (the last layer's is the output); saved for
//             the backward: act (L, B, T, 4H) = (si, sf, tg, so) and c (L, B,
//             T, H) (saving the activations costs one 4H-wide store a step,
//             recomputing them the step's product again, so the forward
//             saves them)
//   backward  dh_out (B, T, H), the gradient of the top layer's h; a lower
//             layer's is the projection of the layer above's gate gradients,
//                       dh_l-1,t = bf16(dgates_l,t W_ih,l)    (float32 sum, one rounding,
//             as autograd's bf16 mm of the per-layer chain rounds); per layer,
//             in reverse time:
//             dh = bf16(dh_t + bf16(dgates_{t+1} W_hh))   (no second term at T-1)
//             the cell's gradient rounded as torch's autograd of the bf16 ops
//             rounds on the CPU (each product, each gate's sigmoid/tanh
//             gradient computed in float32 from bf16 operands and rounded
//             once, the carried dc = bf16(its two terms))
//             out: dgates (L, B, T, 4H), each layer's xp gradient. W_hh's, sum_t
//             dgates_t^T h_{t-1}, and W_ih's and the biases' gradients are large
//             products the wrapper leaves to torch.
//
// What bounds them on this card: the serial chain, not operations or
// bytes. Each step depends on the last through h (forward) or dgates
// (backward), and each step of a layer is a small product: at the training
// batch (B 32, H 256) 2 x 32 x 1024 x 256 = 16.8 MFLOP, 0.017 us at the
// 989 TFLOP/s bf16 rate; T = 512 steps x 3 layers of it is 0.026 ms a pass,
// and the bytes (xp in, h, act and c out: ~84 MB a pass) 0.025 ms at 3.35
// TB/s. The steps themselves cost a product on a few SMs, a cell, an
// exchange of the new h (or dgates) between SMs and a barrier each: the
// chain of them bounds a pass.
//
// Design. A thread-block cluster of CLUSTER = 8 CTAs runs a chunk of at
// most 32 batch rows of one layer (more rows take more clusters,
// ops/lstm_recurrence.py:lstm_plan); CTA j owns hidden units [j U, (j + 1)
// U), U = H / 8.
// - Forward (lstm_stack_kernel): one launch runs L x ceil(B / chunk)
//   clusters, cluster (l, k) layer l of chunk k, as the JAX package's
//   wavefront schedule (quickvc_tpu/models/encoders.py:_wavefront) runs the
//   layers: layer l works on step t while layer l - 1 is on a later step,
//   so the serial chain is T + (L - 1) skew steps, not L T. CTA j computes
//   the (rows x 4U) gate block of its units each step, h_{t-1} (rows x H,
//   in its own shared memory) times its 4U rows of W_hh, on
//   mma.sync.m16n8k16 bf16 (bf16_gemm.cuh's fragment helpers). Its W_hh
//   rows stay in registers for the whole sequence, as the mma's B
//   fragments: warp w takes the 8-column tiles w and w + 8 of the block,
//   whose columns interleave the four gates of a unit (column 4u + q), so a
//   lane and its neighbour hold the four gates of one (row, unit) and one
//   shuffle gives each lane a whole cell; c stays in that lane's registers.
//   Layer 0 reads xp_t by cp.async FORWARD_STAGES - 1 steps ahead. A layer
//   l >= 1 holds its 4U rows of W_ih,l in shared memory (ldmatrix B
//   fragments) and reads h_l-1,t of the whole chunk from layer l - 1's
//   output by cp.async, skew - 1 steps ahead, into a ring of skew stages;
//   both products run in one k loop. The new h goes to the output and,
//   through distributed shared memory (mapa + st.shared::cluster, 16-byte
//   stores where U % 8 == 0), into every CTA's other h buffer; one cluster
//   barrier ends the step.
// - Hand-over between layers goes through global memory (the forward's h,
//   the backward's dh): after the cluster barrier that ends step t, CTA 0's
//   first thread of cluster (l, k) stores t + 1 to the counter of (l, k) with
//   st.release.gpu (the barrier orders every CTA's h stores before it). Before it loads h_l,t
//   of the layer below, cluster (l + 1, k)'s CTAs wait for that counter
//   with ld.acquire.gpu, one thread each, then a CTA barrier. A producer
//   never waits on a consumer (its sequence is whole), so the launch cannot
//   deadlock if every cluster is resident at once: the host launches with
//   cudaLaunchKernelEx and the cluster dimension only after
//   cudaOccupancyMaxActiveClusters says the card holds them all, and a wait
//   of a second (%globaltimer) traps with a message instead of hanging.
// - Backward (lstm_stack_backward_kernel): one launch runs L x ceil(B /
//   chunk) clusters, cluster (l, k) layer l of chunk k, in reverse time, the
//   forward's wavefront run backwards: layer l - 1 runs behind layer l,
//   which hands it dh_l-1 through global memory. CTA j holds W_hh's columns
//   of its units, (4H x U), in registers as B fragments; the 4H-long
//   reduction of dgates_{t+1} W_hh is split over the 8 warps (k-steps w, w +
//   8, ...) and their float32 partials summed in warp order in shared
//   memory. A thread a (row, unit) then runs the cell's gradient, dc carried
//   in its registers, writes the unit's four gate gradients to dgates and
//   into every CTA's dgates buffer by DSMEM (the buffer's columns grouped by
//   CTA, so a CTA's slice is 8U contiguous bytes a row), and one cluster
//   barrier ends the step. act, c and dh arrive by cp.async
//   BACKWARD_STAGES - 1 steps ahead.
//   A layer l >= 1 also projects: after the exchange every CTA holds the
//   whole chunk's dgates_t, so CTA j computes the layer below's dh_l-1,t of
//   its units, dgates_t (rows x 4H) times W_ih,l's columns of its units
//   (4H x U), in the next step's k loop, from the same A fragments as the
//   recurrence's product; its partials are summed like the recurrence's,
//   rounded once and stored to dh_mid, and after the cluster barrier CTA 0
//   releases the step count to the layer below (one more iteration
//   projects dgates_0). W_ih's slice lies in shared memory (ldmatrix B
//   fragments), not in registers beside W_hh's 64: so a cluster takes 16
//   rows, not 32, and its gate buffers leave room for it (Backward:
//   190,464 bytes at H = 256); a layer of the training batch (B 32) is two
//   clusters. The lower layer loads dh two steps ahead, so it waits for a
//   count four steps ahead of its own: T + 4 (L - 1) serial steps.
// - Both double-buffer the exchanged state, so a CTA that runs ahead never
//   writes a buffer another is still reading: it crosses the barrier that
//   ends the step only after every CTA has read that buffer.
//
// Both kernels take any T, H a multiple of 16 up to 256 and 1 to MAX_LAYERS
// layers; the forward a chunk of up to 32 rows and a skew of 2 to MAX_SKEW,
// the backward a chunk of up to 16 rows; the C entries refuse anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "bf16_gemm.cuh"  // ldmatrix, mma.sync bf16, rounding; tf32x3.cuh's cp.async

namespace {
namespace lstm {

using bf16core::bf16_t;
using bf16core::bf16_to_float;
using bf16core::ldmatrix_x4;
using bf16core::mma_bf16;
using bf16core::round_bf16;

constexpr int CLUSTER = 8;
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_H = 256, MAX_CHUNK = 32, MAX_MT = MAX_CHUNK / 16;
constexpr int MAX_BACKWARD_CHUNK = 16;     // the backward's rows a cluster (one 16-row m tile)
constexpr int FORWARD_STAGES = 4, BACKWARD_STAGES = 3;
constexpr int MAX_LAYERS = 4, MAX_SKEW = 3;  // the forward's layers a launch; the skew's range
constexpr unsigned long long WAIT_LIMIT_NS = 1000000000ull;  // a hand-over wait of 1 s traps
constexpr int F_NTW = 2;                   // forward: 8-column tiles a warp (of U / 2 <= 16)
constexpr int F_KS = MAX_H / 16;           // forward: k-steps of 16 over H
constexpr int B_NT = MAX_H / CLUSTER / 8;  // backward: 8-unit tiles a CTA (U <= 32)
constexpr int B_KSW = 4 * MAX_H / 16 / WARPS;  // backward: k-steps a warp (of 4H / 16 <= 64)
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layouts, in bf16 values unless named; at H = 256 the
// forward's of a deep stack (chunk 32, skew 2) is 157,440 bytes of the
// H100's 232,448, the backward's (chunk 16) 190,464 for a layer >= 1 (W_ih's
// slice, 66,048, included) and 124,416 for layer 0.
struct Stack {
  int rows, ldh, u, skew;  // rows: the chunk padded to 16; ldh: an h row, padded
  bool deep;               // more than one layer: a W_ih slice and the ring of h_l-1
  __device__ __host__ Stack(int chunk, int H, int layers, int skew_)
      : rows((chunk + 15) / 16 * 16), ldh(H + 8), u(H / CLUSTER), skew(skew_),
        deep(layers > 1) {}
  __device__ __host__ int hbuf() const { return rows * ldh; }          // one h buffer
  __device__ __host__ int xstage() const { return rows * 4 * u; }      // one step of xp_0
  __device__ __host__ int ring() const {  // layer 0's xp stages, or a deeper layer's h stages
    const int x = FORWARD_STAGES * xstage(), h = deep ? skew * hbuf() : 0;
    return x > h ? x : h;
  }
  __device__ __host__ int wih() const { return deep ? 4 * u * ldh : 0; }  // W_ih's 4U rows
  __device__ __host__ int bytes() const {
    return 2 * (2 * hbuf() + ring() + wih() + rows * u);
  }
};

struct Backward {
  int rows, ldg, u, up;  // ldg: a dgates row, padded; up: U padded to 8
  bool project;          // a layer >= 1: W_ih's slice and the projection's partials
  __device__ __host__ Backward(int chunk, int H, bool project_)
      : rows((chunk + 15) / 16 * 16), ldg(4 * H + 8), u(H / CLUSTER),
        up(H / CLUSTER < 8 ? 8 : H / CLUSTER), project(project_) {}
  __device__ __host__ int gbuf() const { return rows * ldg; }      // one dgates buffer
  __device__ __host__ int red() const { return WARPS * rows * up; }  // one set of partials (float)
  __device__ __host__ int stage() const { return rows * 7 * u; }   // act 4U, c_t, c_{t-1}, dh
  __device__ __host__ int bytes() const {
    return 2 * 2 * gbuf() + 4 * (project ? 2 : 1) * red() + 2 * rows * 4 * u +
           2 * BACKWARD_STAGES * stage() + (project ? 2 * up * ldg : 0);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared-memory location in CTA `rank` of the cluster
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(unsigned addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned addr, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}
// every thread of the cluster: its shared-memory writes (remote ones too)
// visible to the whole cluster before any thread goes on
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the hand-over counters between layers: release by the layer below, acquire by the one above
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// until *cnt >= need (steps of the layer feeding `layer` published); a
// second of waiting is a broken schedule, not a slow one: trap, so the
// launch fails
__device__ __noinline__ void wait_count(const unsigned* cnt, unsigned need, const char* kernel,
                                        int layer, int chunk) {
  if (ld_acquire(cnt) >= need) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(cnt) < need) {
    if (global_ns() - t0 > WAIT_LIMIT_NS) {
      printf("%s: layer %d, chunk %d waited 1 s for count %u\n", kernel, layer, chunk, need);
      __trap();
    }
  }
}
// cp.async.wait_group n for n in 0 .. 2
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ bf16_t to_bf16(float x) {
  __nv_bfloat16 v = __float2bfloat16_rn(x);
  return *reinterpret_cast<bf16_t*>(&v);
}
__device__ __forceinline__ float ld_bf16(const bf16_t* p) { return bf16_to_float(*p); }
// two bf16 values of a row (k even), packed as an mma operand register
__device__ __forceinline__ unsigned ld_pair(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
__device__ __forceinline__ unsigned pack(bf16_t lo, bf16_t hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// `runs` runs of `len` bf16 values (len even) for each of `rows` rows:
// run q of row r from src + r * src_row + q * src_run to dst + r * dst_row +
// q * len, by 16-byte copies where len % 8 == 0 and 4-byte ones otherwise.
__device__ __forceinline__ void copy_runs(bf16_t* dst, int dst_row, const bf16_t* src,
                                          long long src_row, int src_run, int rows, int runs,
                                          int len, bool valid) {
  const int per = len % 8 == 0 ? 8 : 2;  // values a copy
  const int chunks = len / per, total = rows * runs * chunks;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / (runs * chunks), rest = i % (runs * chunks);
    const int q = rest / chunks, ch = rest % chunks;
    bf16_t* d = dst + r * dst_row + q * len + ch * per;
    const bf16_t* s = src + r * src_row + (long long)q * src_run + ch * per;
    if (per == 8)
      cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(s), valid);
    else
      cp_async4(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(s), valid);
  }
}

// Rows [0, rows) of `cols` bf16 values (cols even) at local shared memory
// `src` (row stride src_row), stored at `dst` (row stride dst_row) in every
// CTA of the cluster, by 16-byte stores where cols % 8 == 0 (and the
// offsets allow) and 4-byte ones otherwise.
__device__ __forceinline__ void push_rows(const bf16_t* src, int src_row, bf16_t* dst,
                                          int dst_row, int rows, int cols) {
  const unsigned base = smem_addr(dst);
  if (cols % 8 == 0) {
    const int chunks = cols / 8, total = rows * chunks * CLUSTER;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int rank = i % CLUSTER, rest = i / CLUSTER;
      const int r = rest / chunks, ch = rest % chunks;
      const uint4 v = *reinterpret_cast<const uint4*>(src + r * src_row + 8 * ch);
      st_cluster(map_rank(base + 2u * (r * dst_row + 8 * ch), rank), v);
    }
  } else {
    const int words = cols / 2, total = rows * words * CLUSTER;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int rank = i % CLUSTER, rest = i / CLUSTER;
      const int r = rest / words, wd = rest % words;
      const unsigned v = *reinterpret_cast<const unsigned*>(src + r * src_row + 2 * wd);
      st_cluster(map_rank(base + 2u * (r * dst_row + 2 * wd), rank), v);
    }
  }
}

// ---------------------------------------------------------------------------
// forward, every layer in one launch

// One cluster's layer of the stack: layer 0 (DEEP false) reads xp_0 and
// runs today's one-layer forward; a deeper layer (DEEP true) also projects
// the layer below's h. Two instances, so that neither carries the other's
// branches or a run-time ring depth.
template <bool DEEP>
__device__ __forceinline__ void stack_layer(
    const bf16_t* __restrict__ xp0, const bf16_t* __restrict__ w_ih,
    const bf16_t* __restrict__ bias, const bf16_t* __restrict__ w_hh, bf16_t* __restrict__ h_out,
    bf16_t* __restrict__ act, bf16_t* __restrict__ c_out, unsigned* __restrict__ counters,
    int B, int T, int H, int chunk, int layers, int skew, int layer, int kc, int chunks) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const Stack L(chunk, H, layers, skew);
  const int U = L.u, G4 = 4 * H;
  const int rank = (int)cluster_rank();
  const bool publish = layer + 1 < layers;
  const int b0 = kc * chunk;
  const int rows = min(chunk, B - b0);
  const int u0 = rank * U;
  const int mtiles = (rows + 15) / 16;
  const int NT = U / 2, KS = H / 16;  // 8-column tiles of the gate block; k-steps
  bf16_t* hbuf = reinterpret_cast<bf16_t*>(lstm_smem);  // [2][rows][ldh]
  bf16_t* ring = hbuf + 2 * L.hbuf();                    // layer 0: [4][rows][4U]; else [skew][rows][ldh]
  bf16_t* wih_s = ring + L.ring();                       // [4U][ldh], layers >= 1
  bf16_t* stage_h = wih_s + L.wih();                     // [rows][U]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const long long lay = (long long)B * T * H;             // one layer of h or c
  bf16_t* h_l = h_out + layer * lay;
  bf16_t* c_l = c_out + layer * lay;
  bf16_t* act_l = act + layer * 4 * lay;

  // this warp's tiles of W_hh as B fragments: tile nt, column 8 nt + g is
  // gate q = (8 nt + g) % 4 of unit u0 + (8 nt + g) / 4, row q H + unit
  const bf16_t* whh_l = w_hh + (long long)layer * G4 * H;
  unsigned wf[F_NTW][F_KS][2];
#pragma unroll
  for (int i = 0; i < F_NTW; ++i) {
    const int nt = warp + WARPS * i, col = 8 * nt + g;
    const bf16_t* wr = whh_l + (long long)((col % 4) * H + u0 + col / 4) * H;
#pragma unroll
    for (int ks = 0; ks < F_KS; ++ks) {
      const bool ok = nt < NT && ks < KS;
      wf[i][ks][0] = ok ? ld_pair(wr + 16 * ks + 2 * t4) : 0u;
      wf[i][ks][1] = ok ? ld_pair(wr + 16 * ks + 2 * t4 + 8) : 0u;
    }
  }
  // a layer >= 1: its W_ih rows in the same column order into shared memory
  // (row r: gate r % 4 of unit u0 + r / 4), the bias of this lane's units
  float bq[F_NTW][4] = {};
  if constexpr (DEEP) {
    const bf16_t* wih_l = w_ih + (long long)(layer - 1) * G4 * H;
    const int per = H / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < 4 * U * per; i += THREADS) {
      const int r = i / per, ch = i % per;
      cp_async16(reinterpret_cast<float*>(wih_s + r * L.ldh + 8 * ch),
                 reinterpret_cast<const float*>(wih_l + (long long)((r % 4) * H + u0 + r / 4) * H +
                                                8 * ch),
                 true);
    }
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < F_NTW; ++i) {
      const int nt = warp + WARPS * i;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bq[i][q] = nt < NT ? ld_bf16(bias + (layer - 1) * G4 + q * H + u0 + 2 * nt + t4 / 2) : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < 2 * L.hbuf(); i += THREADS) hbuf[i] = 0;

  // the input of step s into its ring stage: layer 0 four runs of U values
  // of xp_0 a row (one a gate); a deeper layer the whole row of h_l-1,s,
  // once the layer below has published step s (thread 0 waits; a CTA
  // barrier between that wait and these loads)
  const int stages = DEEP ? skew : FORWARD_STAGES, ahead = stages - 1;
  const bf16_t* xp_rows = xp0 + (long long)b0 * T * G4 + u0;
  const bf16_t* h_below = !DEEP ? nullptr : h_out + (layer - 1) * lay + (long long)b0 * T * H;
  const unsigned* cnt_below = !DEEP ? nullptr : counters + (layer - 1) * chunks + kc;
  auto load_in = [&](int s) {
    if constexpr (!DEEP)
      copy_runs(ring + (s % stages) * L.xstage(), 4 * U, xp_rows + (long long)s * G4,
                (long long)T * G4, H, rows, 4, U, true);
    else
      copy_runs(ring + (s % stages) * L.hbuf(), L.ldh, h_below + (long long)s * H,
                (long long)T * H, 0, rows, 1, H, true);
  };
  for (int s = 0; s < ahead; ++s) {
    if (s < T) {
      if constexpr (DEEP) {
        if (threadIdx.x == 0) wait_count(cnt_below, s + 1, "lstm_stack_kernel", layer, kc);
        __syncthreads();
      }
      load_in(s);
    }
    cp_async_commit();
  }
  cluster_sync();  // every CTA's h buffers zeroed before any is written remotely

  float c_reg[MAX_MT][F_NTW];
#pragma unroll
  for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
    for (int i = 0; i < F_NTW; ++i) c_reg[mt][i] = 0.0f;
  const bool even = (t4 & 1) == 0;
  // ldmatrix row addresses of this lane: A (h rows) row lane % 16, columns
  // 8 (lane / 16); B (W_ih rows) matrix m = lane / 8: tile w (m < 2) or w + 8,
  // k half m % 2 (the two tiles' b0, b1 fragments in order)
  const unsigned a_off = 2u * ((lane & 15) * L.ldh + 8 * (lane >> 4));
  const int b_tile = min((lane & 16) ? warp + WARPS : warp, NT - 1);
  const unsigned b_lane =
      smem_addr(wih_s) + 2u * ((8 * b_tile + (lane & 7)) * L.ldh + 8 * ((lane >> 3) & 1));

  for (int s = 0; s < T; ++s) {
    const int next = s + ahead;
    if (DEEP && next < T && threadIdx.x == 0)
      wait_count(cnt_below, next + 1, "lstm_stack_kernel", layer, kc);
    if constexpr (DEEP)
      cp_async_wait_upto(ahead - 1);  // step s's input (and W_ih) has landed for this thread
    else
      cp_async_wait<FORWARD_STAGES - 2>();
    __syncthreads();                // ... for every thread; the counter's acquire before the loads
    if (next < T) load_in(next);
    cp_async_commit();
    const bf16_t* hcur = hbuf + (s & 1) * L.hbuf();
    const bf16_t* in = ring + (s % stages) * (DEEP ? L.hbuf() : L.xstage());

    // acc: h_{t-1} W_hh^T; accx (layers >= 1): h_l-1,t W_ih^T
    float acc[MAX_MT][F_NTW][4], accx[MAX_MT][F_NTW][4];
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
      for (int i = 0; i < F_NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = accx[mt][i][e] = 0.0f;
    const unsigned a_h = smem_addr(hcur) + a_off, a_x = smem_addr(in) + a_off;
#pragma unroll
    for (int ks = 0; ks < F_KS; ++ks) {
      if (ks >= KS) break;
      unsigned bx[4];
      if (DEEP && warp < NT) ldmatrix_x4(bx, b_lane + 2u * 16 * ks);
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt) {
        if (mt >= mtiles) break;
        unsigned af[4];
        ldmatrix_x4(af, a_h + 2u * (16 * mt * L.ldh + 16 * ks));
#pragma unroll
        for (int i = 0; i < F_NTW; ++i)
          if (warp + WARPS * i < NT) mma_bf16(acc[mt][i], af, wf[i][ks][0], wf[i][ks][1]);
        if (DEEP && warp < NT) {
          ldmatrix_x4(af, a_x + 2u * (16 * mt * L.ldh + 16 * ks));
#pragma unroll
          for (int i = 0; i < F_NTW; ++i)
            if (warp + WARPS * i < NT) mma_bf16(accx[mt][i], af, bx[2 * i], bx[2 * i + 1]);
        }
      }
    }

    // the cells: lane pair (t4, t4 ^ 1) holds gates (i, f) and (g, o) of
    // one unit for rows g and g + 8; the even lane takes row g, the odd g + 8
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt) {
      if (mt >= mtiles) break;
#pragma unroll
      for (int i = 0; i < F_NTW; ++i) {
        const int nt = warp + WARPS * i;
        if (nt >= NT) break;
        float pre[4], xq[4];
        {
          const float a0 = acc[mt][i][0], a1 = acc[mt][i][1];
          const float a2 = acc[mt][i][2], a3 = acc[mt][i][3];
          const float r0 = __shfl_xor_sync(FULL, even ? a2 : a0, 1);
          const float r1 = __shfl_xor_sync(FULL, even ? a3 : a1, 1);
          pre[0] = even ? a0 : r0;
          pre[1] = even ? a1 : r1;
          pre[2] = even ? r0 : a2;
          pre[3] = even ? r1 : a3;
        }
        const int row = 16 * mt + g + (even ? 0 : 8);
        const int up = 2 * nt + t4 / 2;  // the unit, in this CTA's U
        if constexpr (!DEEP) {
          const bf16_t* xr = in + row * 4 * U + up;
#pragma unroll
          for (int q = 0; q < 4; ++q) xq[q] = ld_bf16(xr + q * U);
        } else {
          const float a0 = accx[mt][i][0], a1 = accx[mt][i][1];
          const float a2 = accx[mt][i][2], a3 = accx[mt][i][3];
          const float r0 = __shfl_xor_sync(FULL, even ? a2 : a0, 1);
          const float r1 = __shfl_xor_sync(FULL, even ? a3 : a1, 1);
          const float px[4] = {even ? a0 : r0, even ? a1 : r1, even ? r0 : a2, even ? r1 : a3};
#pragma unroll
          for (int q = 0; q < 4; ++q) xq[q] = round_bf16(round_bf16(px[q]) + bq[i][q]);
        }
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] = round_bf16(xq[q] + round_bf16(pre[q]));
        const float si = round_bf16(sigmoid(gate[0])), sf = round_bf16(sigmoid(gate[1]));
        const float tg = round_bf16(tanhf(gate[2])), so = round_bf16(sigmoid(gate[3]));
        const float c = round_bf16(round_bf16(sf * c_reg[mt][i]) + round_bf16(si * tg));
        c_reg[mt][i] = c;
        const float h = round_bf16(so * round_bf16(tanhf(c)));
        if (row < rows) {
          const long long at = ((long long)(b0 + row) * T + s) * H + u0 + up;
          h_l[at] = to_bf16(h);
          c_l[at] = to_bf16(c);
          bf16_t* ar = act_l + ((long long)(b0 + row) * T + s) * G4 + u0 + up;
          ar[0] = to_bf16(si);
          ar[H] = to_bf16(sf);
          ar[2 * H] = to_bf16(tg);
          ar[3 * H] = to_bf16(so);
        }
        stage_h[row * U + up] = to_bf16(h);
      }
    }
    const bool last = s + 1 == T;
    if (!last) {
      __syncthreads();  // stage_h complete
      push_rows(stage_h, U, hbuf + ((s + 1) & 1) * L.hbuf() + u0, L.ldh, rows, U);
    }
    // nothing reads the last h through the cluster; the layer above waits for it
    if (!last || publish) cluster_sync();
    if (publish && rank == 0 && threadIdx.x == 0) st_release(counters + layer * chunks + kc, s + 1);
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_stack_kernel(const bf16_t* __restrict__ xp0, const bf16_t* __restrict__ w_ih,
                  const bf16_t* __restrict__ bias, const bf16_t* __restrict__ w_hh,
                  bf16_t* __restrict__ h_out, bf16_t* __restrict__ act,
                  bf16_t* __restrict__ c_out, unsigned* __restrict__ counters, int B, int T,
                  int H, int chunk, int layers, int skew) {
  const int chunks = (B + chunk - 1) / chunk;
  const int cid = blockIdx.x / CLUSTER, layer = cid / chunks, kc = cid % chunks;
  if (layer == 0)
    stack_layer<false>(xp0, w_ih, bias, w_hh, h_out, act, c_out, counters, B, T, H, chunk,
                       layers, skew, layer, kc, chunks);
  else
    stack_layer<true>(xp0, w_ih, bias, w_hh, h_out, act, c_out, counters, B, T, H, chunk,
                      layers, skew, layer, kc, chunks);
}

// ---------------------------------------------------------------------------
// backward, every layer in one launch

// One cluster's layer of the backward stack, in reverse time. PROJECT (a
// layer l >= 1) also computes the layer below's output gradient from the
// dgates every CTA holds after the exchange; the top layer reads dh_out,
// a lower one the projection of the layer above (dh_mid), once published.
template <bool PROJECT>
__device__ __forceinline__ void backward_layer(
    const bf16_t* __restrict__ dh_out, const bf16_t* __restrict__ w_ih,
    const bf16_t* __restrict__ w_hh, const bf16_t* __restrict__ act,
    const bf16_t* __restrict__ c_seq, bf16_t* __restrict__ dgates, bf16_t* __restrict__ dh_mid,
    unsigned* __restrict__ counters, int B, int T, int H, int chunk, int layers, int layer,
    int kc, int chunks) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const Backward L(chunk, H, PROJECT);
  const int U = L.u, G4 = 4 * H;
  const int rank = (int)cluster_rank();
  const int b0 = kc * chunk;
  const int rows = min(chunk, B - b0);
  const int u0 = rank * U;
  const int NT = L.up / 8, KS = G4 / 16;
  const bool top = layer + 1 == layers;
  bf16_t* gbuf = reinterpret_cast<bf16_t*>(lstm_smem);                  // [2][rows][ldg]
  float* red = reinterpret_cast<float*>(gbuf + 2 * L.gbuf());           // [WARPS][rows][up]
  float* red_x = red + L.red();                                         // PROJECT: the same
  bf16_t* stage_g = reinterpret_cast<bf16_t*>(red + (PROJECT ? 2 : 1) * L.red());  // [rows][4U]
  bf16_t* ring = stage_g + L.rows * 4 * U;                              // [STAGES][rows][7U]
  bf16_t* wih_s = ring + BACKWARD_STAGES * L.stage();                   // PROJECT: [up][ldg]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const long long lay = (long long)B * T * H;  // one layer of h, c or dh
  const bf16_t* act_l = act + layer * 4 * lay;
  const bf16_t* c_l = c_seq + layer * lay;
  bf16_t* dgates_l = dgates + layer * 4 * lay;
  // the output gradient this layer reads, and who publishes it
  const bf16_t* dh_in = top ? dh_out : dh_mid + layer * lay;
  const unsigned* cnt_in = top ? nullptr : counters + layer * chunks + kc;
  bf16_t* dh_below = PROJECT ? dh_mid + (layer - 1) * lay : nullptr;
  unsigned* cnt_out = PROJECT ? counters + (layer - 1) * chunks + kc : nullptr;

  // W_hh's columns of this CTA's units as B fragments over the gates buffer's
  // columns k' = 4U jj + 4 u' + q (CTA jj's unit u', gate q: row q H + jj U + u')
  const bf16_t* whh_l = w_hh + (long long)layer * G4 * H;
  auto w_row = [&](int k) { return (k % (4 * U) % 4) * H + k / (4 * U) * U + k % (4 * U) / 4; };
  unsigned wf[B_KSW][B_NT][2];
#pragma unroll
  for (int j = 0; j < B_KSW; ++j) {
    const int ks = warp + WARPS * j;
#pragma unroll
    for (int nt = 0; nt < B_NT; ++nt) {
      const int k = 16 * ks + 2 * t4, n = 8 * nt + g;
      const bool ok = ks < KS && nt < NT && n < U;
      auto w_at = [&](int kk) { return ok ? whh_l[(long long)w_row(kk) * H + u0 + n] : (bf16_t)0; };
      wf[j][nt][0] = pack(w_at(k), w_at(k + 1));
      wf[j][nt][1] = pack(w_at(k + 8), w_at(k + 9));
    }
  }
  // a layer >= 1: W_ih,l's columns of this CTA's units in shared memory,
  // unit-major over the same k' (row n, zeros past U), for ldmatrix B fragments
  if constexpr (PROJECT) {
    const bf16_t* wih_l = w_ih + (long long)(layer - 1) * G4 * H;
    for (int i = threadIdx.x; i < G4 * L.up; i += THREADS) {
      const int k = i / L.up, n = i % L.up;
      wih_s[n * L.ldg + k] = n < U ? wih_l[(long long)w_row(k) * H + u0 + n] : (bf16_t)0;
    }
  }
  for (int i = threadIdx.x; i < 2 * L.gbuf(); i += THREADS) gbuf[i] = 0;

  // step s's saved state, a row of 7U values: act's four gates, c_t,
  // c_{t-1} (zeros at s = 0), dh_t; a lower layer's dh_t once the layer
  // above has published it (thread 0 waits; a CTA barrier before the loads)
  const long long row_g4 = (long long)T * G4, row_h = (long long)T * H;
  auto load = [&](int s) {
    bf16_t* st = ring + (s % BACKWARD_STAGES) * L.stage();
    const long long first = (long long)b0 * T + s;
    copy_runs(st, 7 * U, act_l + first * G4 + u0, row_g4, H, rows, 4, U, true);
    copy_runs(st + 4 * U, 7 * U, c_l + first * H + u0, row_h, 0, rows, 1, U, true);
    copy_runs(st + 5 * U, 7 * U, c_l + (s > 0 ? first - 1 : first) * H + u0, row_h, 0, rows, 1,
              U, s > 0);
    copy_runs(st + 6 * U, 7 * U, dh_in + first * H + u0, row_h, 0, rows, 1, U, true);
  };
  // steps T-1 .. s of dh_in published: the layer above's count T - s
  auto wait_for = [&](int s) {
    if (!top && threadIdx.x == 0)
      wait_count(cnt_in, T - s, "lstm_stack_backward_kernel", layer, kc);
  };
#pragma unroll
  for (int i = 0; i < BACKWARD_STAGES - 1; ++i) {
    if (T - 1 - i >= 0) {
      wait_for(T - 1 - i);
      if (!top) __syncthreads();
      load(T - 1 - i);
    }
    cp_async_commit();
  }
  cluster_sync();  // every CTA's gate buffers zeroed, W_ih staged, before remote writes

  constexpr int CELLS = MAX_BACKWARD_CHUNK * (MAX_H / CLUSTER) / THREADS;  // (row, unit)s a thread
  float dc_next[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) dc_next[k] = 0.0f;
  // ldmatrix row addresses of this lane into W_ih's slice: the 8-unit tiles
  // 2p and 2p + 1 (the last where NT is odd), k half (lane / 8) % 2
  unsigned x_lane[(B_NT + 1) / 2];
#pragma unroll
  for (int p = 0; p < (B_NT + 1) / 2; ++p) {
    const int tile = min(2 * p + ((lane >> 4) & 1), NT - 1);
    x_lane[p] = smem_addr(wih_s) + 2u * ((8 * tile + (lane & 7)) * L.ldg + 8 * ((lane >> 3) & 1));
  }

  // a projecting layer runs one more iteration: the projection of dgates_0
  const int iters = T + (PROJECT ? 1 : 0);
  for (int it = 0; it < iters; ++it) {
    const int s = T - 1 - it;  // -1 in the projection's last iteration
    if (s >= 0) {
      const int next = s - (BACKWARD_STAGES - 1);
      if (next >= 0) wait_for(next);
      cp_async_wait<BACKWARD_STAGES - 2>();
      __syncthreads();  // step s's state has landed for every thread; the count's acquire
      if (next >= 0) load(next);
      cp_async_commit();
    }

    if (it > 0) {
      // this warp's partials over its k-steps of dgates_{s+1} W_hh (the
      // recurrence) and, for a layer >= 1, of dgates_{s+1} W_ih (the layer
      // below's dh_{s+1}); one A fragment feeds both
      const bf16_t* gcur = gbuf + ((it - 1) & 1) * L.gbuf();
      const unsigned a_lane = smem_addr(gcur) + 2u * ((lane & 15) * L.ldg + 8 * (lane >> 4));
      float acc[B_NT][4], accx[B_NT][4];
#pragma unroll
      for (int nt = 0; nt < B_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = accx[nt][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < B_KSW; ++j) {
        const int ks = warp + WARPS * j;
        if (ks >= KS) break;
        unsigned af[4];
        ldmatrix_x4(af, a_lane + 2u * 16 * ks);
        if (s >= 0) {
#pragma unroll
          for (int nt = 0; nt < B_NT; ++nt)
            if (nt < NT) mma_bf16(acc[nt], af, wf[j][nt][0], wf[j][nt][1]);
        }
        if constexpr (PROJECT) {
#pragma unroll
          for (int p = 0; p < (B_NT + 1) / 2; ++p) {
            if (2 * p >= NT) break;
            unsigned bx[4];
            ldmatrix_x4(bx, x_lane[p] + 2u * 16 * ks);
            mma_bf16(accx[2 * p], af, bx[0], bx[1]);
            if (2 * p + 1 < NT) mma_bf16(accx[2 * p + 1], af, bx[2], bx[3]);
          }
        }
      }
      float* mine = red + warp * L.rows * L.up;
      float* mine_x = red_x + warp * L.rows * L.up;
#pragma unroll
      for (int nt = 0; nt < B_NT; ++nt) {
        if (nt >= NT) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (g + 8 * hh) * L.up + 8 * nt + 2 * t4;
          if (s >= 0)
            *reinterpret_cast<float2*>(mine + at) =
                make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
          if (PROJECT)
            *reinterpret_cast<float2*>(mine_x + at) =
                make_float2(accx[nt][2 * hh], accx[nt][2 * hh + 1]);
        }
      }
      __syncthreads();
    }

    if (s >= 0) {
      const bf16_t* st = ring + (s % BACKWARD_STAGES) * L.stage();
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int cell = threadIdx.x + THREADS * k;
        const int row = cell / U, up = cell % U;
        if (row >= rows) break;
        const bf16_t* sr = st + row * 7 * U + up;
        const float si = ld_bf16(sr), sf = ld_bf16(sr + U), tg = ld_bf16(sr + 2 * U);
        const float so = ld_bf16(sr + 3 * U), ct = ld_bf16(sr + 4 * U);
        const float c_prev = ld_bf16(sr + 5 * U);
        float dh = ld_bf16(sr + 6 * U);
        if (it > 0) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) sum += red[(w * L.rows + row) * L.up + up];
          dh = round_bf16(dh + round_bf16(sum));
        }
        const float tc = round_bf16(tanhf(ct));
        const float d_so = round_bf16(dh * tc), d_tc = round_bf16(dh * so);
        float dc = round_bf16(d_tc * (1.0f - tc * tc));
        if (it > 0) dc = round_bf16(dc + dc_next[k]);
        const float d_sf = round_bf16(dc * c_prev);
        dc_next[k] = round_bf16(dc * sf);
        const float d_si = round_bf16(dc * tg), d_tg = round_bf16(dc * si);
        const bf16_t dg[4] = {to_bf16(d_si * (1.0f - si) * si), to_bf16(d_sf * (1.0f - sf) * sf),
                              to_bf16(d_tg * (1.0f - tg * tg)), to_bf16(d_so * (1.0f - so) * so)};
        bf16_t* out = dgates_l + ((long long)(b0 + row) * T + s) * G4 + u0 + up;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          out[q * H] = dg[q];
          stage_g[row * 4 * U + 4 * up + q] = dg[q];
        }
      }
    }
    if (PROJECT && it > 0) {
      // dh_{l-1, s+1} of this CTA's units: the warps' partials summed in
      // warp order in float32, rounded once
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int cell = threadIdx.x + THREADS * k;
        const int row = cell / U, up = cell % U;
        if (row >= rows) break;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += red_x[(w * L.rows + row) * L.up + up];
        dh_below[((long long)(b0 + row) * T + s + 1) * H + u0 + up] = to_bf16(sum);
      }
    }
    if (!PROJECT && s == 0) break;  // nothing reads dgates_0 through the cluster
    if (s >= 0) {
      __syncthreads();  // stage_g complete
      push_rows(stage_g, 4 * U, gbuf + (it & 1) * L.gbuf() + rank * 4 * U, L.ldg, rows, 4 * U);
    }
    cluster_sync();
    // dh_{l-1} of steps T-1 .. T-it published (the barrier orders every CTA's stores)
    if (PROJECT && it > 0 && rank == 0 && threadIdx.x == 0) st_release(cnt_out, it);
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS, 1)
lstm_stack_backward_kernel(const bf16_t* __restrict__ dh_out, const bf16_t* __restrict__ w_ih,
                           const bf16_t* __restrict__ w_hh, const bf16_t* __restrict__ act,
                           const bf16_t* __restrict__ c_seq, bf16_t* __restrict__ dgates,
                           bf16_t* __restrict__ dh_mid, unsigned* __restrict__ counters, int B,
                           int T, int H, int chunk, int layers) {
  const int chunks = (B + chunk - 1) / chunk;
  const int cid = blockIdx.x / CLUSTER, layer = cid / chunks, kc = cid % chunks;
  if (layer == 0)
    backward_layer<false>(dh_out, w_ih, w_hh, act, c_seq, dgates, dh_mid, counters, B, T, H,
                          chunk, layers, layer, kc, chunks);
  else
    backward_layer<true>(dh_out, w_ih, w_hh, act, c_seq, dgates, dh_mid, counters, B, T, H,
                         chunk, layers, layer, kc, chunks);
}

inline bool valid(int B, int T, int H, int chunk, int max_chunk) {
  return B >= 1 && T >= 1 && H % 16 == 0 && H >= 16 && H <= MAX_H && chunk >= 1 &&
         chunk <= max_chunk;
}
inline bool valid_stack(int B, int T, int H, int chunk, int layers, int skew) {
  return valid(B, T, H, chunk, MAX_CHUNK) && layers >= 1 && layers <= MAX_LAYERS && skew >= 2 &&
         skew <= MAX_SKEW;
}
inline bool valid_backward(int B, int T, int H, int chunk, int layers) {
  return valid(B, T, H, chunk, MAX_BACKWARD_CHUNK) && layers >= 1 && layers <= MAX_LAYERS;
}

// A stack kernel's launch: layers x ceil(B / chunk) clusters of CLUSTER
// CTAs with `bytes` of shared memory each; *max_clusters the clusters of it
// the card holds at once.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  template <typename Kernel>
  cudaError_t prepare(Kernel kernel, int bytes, int B, int chunk, int layers,
                      cudaStream_t stream, int* max_clusters) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    clusters = layers * ((B + chunk - 1) / chunk);
    cfg.gridDim = dim3(clusters * CLUSTER);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  }
};

}  // namespace lstm
}  // namespace

// The forward of `layers` layers: h, c (layers, B, T, H) and act (layers, B,
// T, 4H) from xp0 (B, T, 4H), w_ih (layers - 1, 4H, H), bias (layers - 1, 4H)
// and w_hh (layers, 4H, H), all bf16, contiguous and 16-byte aligned;
// counters (layers, ceil(B / chunk)) unsigned zeros; batch chunks of `chunk`
// rows a cluster, layer l + 1 at least `skew` steps behind layer l
// (ops/lstm_recurrence.py:lstm_stack_plan). A deeper stack than the card
// holds at once is refused with cudaErrorCooperativeLaunchTooLarge.
extern "C" int qvc_lstm_stack_bf16(const void* xp0, const void* w_ih, const void* bias,
                                   const void* w_hh, void* h, void* act, void* c, void* counters,
                                   int B, int T, int H, int chunk, int layers, int skew,
                                   void* stream) {
  using namespace lstm;
  if (!valid_stack(B, T, H, chunk, layers, skew)) return (int)cudaErrorInvalidValue;
  ClusterLaunch ln;
  int held = 0;
  cudaError_t err = ln.prepare(lstm_stack_kernel, Stack(chunk, H, layers, skew).bytes(), B, chunk,
                               layers, (cudaStream_t)stream, &held);
  if (err != cudaSuccess) return (int)err;
  if (layers > 1 && held < ln.clusters) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&ln.cfg, lstm_stack_kernel, (const bf16_t*)xp0, (const bf16_t*)w_ih,
                           (const bf16_t*)bias, (const bf16_t*)w_hh, (bf16_t*)h, (bf16_t*)act,
                           (bf16_t*)c, (unsigned*)counters, B, T, H, chunk, layers, skew);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of the stack kernel's launch at these sizes that the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int qvc_lstm_stack_max_clusters(int B, int T, int H, int chunk, int layers,
                                           int skew) {
  using namespace lstm;
  if (!valid_stack(B, T, H, chunk, layers, skew)) return -(int)cudaErrorInvalidValue;
  ClusterLaunch ln;
  int held = 0;
  const cudaError_t err = ln.prepare(lstm_stack_kernel, Stack(chunk, H, layers, skew).bytes(), B,
                                     chunk, layers, nullptr, &held);
  return err == cudaSuccess ? held : -(int)err;
}

// The backward of `layers` layers: dgates (layers, B, T, 4H) from dh_out (B,
// T, H), the top layer's output gradient, w_ih (layers - 1, 4H, H), w_hh
// (layers, 4H, H) and the forward's act (layers, B, T, 4H) and c (layers, B,
// T, H), all bf16, contiguous and 16-byte aligned; dh_mid (layers - 1, B, T,
// H) bf16 scratch (the lower layers' output gradients, written here) and
// counters (layers - 1, ceil(B / chunk)) unsigned zeros; null for one layer.
// Batch chunks of `chunk` <= 16 rows a cluster
// (ops/lstm_recurrence.py:lstm_stack_backward_plan). A deeper stack than the
// card holds at once is refused with cudaErrorCooperativeLaunchTooLarge.
extern "C" int qvc_lstm_stack_backward_bf16(const void* dh_out, const void* w_ih,
                                            const void* w_hh, const void* act, const void* c,
                                            void* dgates, void* dh_mid, void* counters, int B,
                                            int T, int H, int chunk, int layers, void* stream) {
  using namespace lstm;
  if (!valid_backward(B, T, H, chunk, layers)) return (int)cudaErrorInvalidValue;
  ClusterLaunch ln;
  int held = 0;
  cudaError_t err = ln.prepare(lstm_stack_backward_kernel, Backward(chunk, H, layers > 1).bytes(),
                               B, chunk, layers, (cudaStream_t)stream, &held);
  if (err != cudaSuccess) return (int)err;
  if (layers > 1 && held < ln.clusters) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&ln.cfg, lstm_stack_backward_kernel, (const bf16_t*)dh_out,
                           (const bf16_t*)w_ih, (const bf16_t*)w_hh, (const bf16_t*)act,
                           (const bf16_t*)c, (bf16_t*)dgates, (bf16_t*)dh_mid,
                           (unsigned*)counters, B, T, H, chunk, layers);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of the backward stack's launch at these sizes that the card
// holds at once, or minus a CUDA error.
extern "C" int qvc_lstm_stack_backward_max_clusters(int B, int T, int H, int chunk, int layers) {
  using namespace lstm;
  if (!valid_backward(B, T, H, chunk, layers)) return -(int)cudaErrorInvalidValue;
  ClusterLaunch ln;
  int held = 0;
  const cudaError_t err = ln.prepare(lstm_stack_backward_kernel,
                                     Backward(chunk, H, layers > 1).bytes(), B, chunk, layers,
                                     nullptr, &held);
  return err == cudaSuccess ? held : -(int)err;
}
