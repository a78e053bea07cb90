// The speaker LSTM's bf16 recurrence, forward and backward, for sm_90a.
//
// Replaces no TPU kernel. The JAX package runs this recurrence as a
// lax.scan (quickvc_tpu/models/encoders.py:89-125; the sequential order it
// is exact against at :74-87), which XLA compiles; at bf16 it carries h and
// c in bf16 and rounds every op of the cell. cuDNN's bf16 LSTM keeps its
// own precision, and its gradients leave the JAX semantics (fault F2 of
// ROADMAP.md). So the port runs the JAX recurrence in these two kernels,
// one launch a layer each (ops/lstm_recurrence.py):
//
//   forward   xp (B, T, 4H) = x W_ih^T + b, every step (the caller's matmul)
//             per step: hw = bf16(h_{t-1} W_hh^T)        float32 sum, one rounding
//                       i, f, g, o = bf16(xp_t + hw)     (gate order of torch)
//                       si, sf, so = bf16(sigmoid(.)), tg = bf16(tanh(g))
//                       c_t = bf16(bf16(sf c_{t-1}) + bf16(si tg))
//                       h_t = bf16(so bf16(tanh(c_t)))
//             out: h (B, T, H); saved for the backward: act (B, T, 4H) =
//             (si, sf, tg, so) and c (B, T, H) (saving the activations costs
//             one 4H-wide store a step, recomputing them the step's product
//             again, so the forward saves them)
//   backward  dh_out (B, T, H), the gradient of h; in reverse time:
//             dh = bf16(dh_out_t + bf16(dgates_{t+1} W_hh))   (no second term at T-1)
//             the cell's gradient rounded as torch's autograd of the bf16 ops
//             rounds on the CPU (each product, each gate's sigmoid/tanh
//             gradient computed in float32 from bf16 operands and rounded
//             once, the carried dc = bf16(its two terms))
//             out: dgates (B, T, 4H), xp's gradient. W_hh's, sum_t dgates_t^T
//             h_{t-1}, is one large product the wrapper leaves to torch.
//
// What bounds them on this card: the serial chain, not operations or
// bytes. Each step depends on the last through h (forward) or dgates
// (backward), and each step of a layer is a small product: at the training
// batch (B 32, H 256) 2 x 32 x 1024 x 256 = 16.8 MFLOP, 0.017 us at the
// 989 TFLOP/s bf16 rate; T = 512 steps x 3 layers of it is 0.026 ms a pass,
// and the bytes (xp in, h, act and c out: ~84 MB a pass) 0.025 ms at 3.35
// TB/s. The steps themselves cost a product on a few SMs, a cell, an
// exchange of the new h (or dgates) between SMs and a barrier each: the
// chain of 1,536 of them bounds a pass.
//
// Design. One thread-block cluster of CLUSTER = 8 CTAs runs a chunk of at
// most 32 batch rows (more rows take more clusters, ops/lstm_recurrence.py:
// lstm_plan); CTA j owns hidden units [j U, (j + 1) U), U = H / 8.
// - Forward: CTA j computes the (rows x 4U) gate block of its units each
//   step, h_{t-1} (rows x H, in its own shared memory) times its 4U rows of
//   W_hh, on mma.sync.m16n8k16 bf16 (bf16_gemm.cuh's fragment helpers).
//   Its W_hh rows stay in registers for the whole sequence, as the mma's B
//   fragments: warp w takes the 8-column tiles w and w + 8 of the block,
//   whose columns interleave the four gates of a unit (column 4u + q), so a
//   lane and its neighbour hold the four gates of one (row, unit) and one
//   shuffle gives each lane a whole cell; c stays in that lane's registers.
//   xp_t arrives by cp.async FORWARD_STAGES - 1 steps ahead. The new h goes
//   to the output and, through distributed shared memory (mapa +
//   st.shared::cluster, 16-byte stores where U % 8 == 0), into every CTA's
//   other h buffer; one cluster barrier ends the step.
// - Backward: CTA j holds W_hh's columns of its units, (4H x U), in
//   registers as B fragments; the 4H-long reduction of dgates_{t+1} W_hh is
//   split over the 8 warps (k-steps w, w + 8, ...) and their float32
//   partials summed in warp order in shared memory. A thread a (row, unit)
//   then runs the cell's gradient, dc carried in its registers, writes the
//   unit's four gate gradients to dgates and into every CTA's dgates buffer
//   by DSMEM (the buffer's columns grouped by CTA, so a CTA's slice is 8U
//   contiguous bytes a row), and one cluster barrier ends the step. act, c
//   and dh_out arrive by cp.async BACKWARD_STAGES - 1 steps ahead.
// - Both double-buffer the exchanged state, so a CTA that runs ahead never
//   writes a buffer another is still reading: it crosses the barrier that
//   ends the step only after every CTA has read that buffer.
//
// Both kernels take any T, H a multiple of 16 up to 256 and a chunk of up
// to 32 rows; the C entries refuse anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int FORWARD_STAGES = 4, BACKWARD_STAGES = 3;
constexpr int F_NTW = 2;                   // forward: 8-column tiles a warp (of U / 2 <= 16)
constexpr int F_KS = MAX_H / 16;           // forward: k-steps of 16 over H
constexpr int B_NT = MAX_H / CLUSTER / 8;  // backward: 8-unit tiles a CTA (U <= 32)
constexpr int B_KSW = 4 * MAX_H / 16 / WARPS;  // backward: k-steps a warp (of 4H / 16 <= 64)
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layouts, in bf16 values unless named; at the largest chunk
// and H (32, 256) the backward's is 216,064 bytes of the H100's 232,448.
struct Forward {
  int rows, ldh, u;  // rows: the chunk padded to 16; ldh: an h row, padded
  __device__ __host__ Forward(int chunk, int H)
      : rows((chunk + 15) / 16 * 16), ldh(H + 8), u(H / CLUSTER) {}
  __device__ __host__ int hbuf() const { return rows * ldh; }          // one h buffer
  __device__ __host__ int xstage() const { return rows * 4 * u; }      // one step of xp
  __device__ __host__ int bytes() const {
    return 2 * (2 * hbuf() + FORWARD_STAGES * xstage() + rows * u);
  }
};

struct Backward {
  int rows, ldg, u, up;  // ldg: a dgates row, padded; up: U padded to 8
  __device__ __host__ Backward(int chunk, int H)
      : rows((chunk + 15) / 16 * 16), ldg(4 * H + 8), u(H / CLUSTER),
        up(H / CLUSTER < 8 ? 8 : H / CLUSTER) {}
  __device__ __host__ int gbuf() const { return rows * ldg; }   // one dgates buffer
  __device__ __host__ int stage() const { return rows * 7 * u; }  // act 4U, c_t, c_{t-1}, dh_out
  __device__ __host__ int bytes() const {
    return 2 * 2 * gbuf() + 4 * WARPS * rows * up + 2 * rows * 4 * u +
           2 * BACKWARD_STAGES * stage();
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
// forward

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
lstm_forward_kernel(const bf16_t* __restrict__ xp, const bf16_t* __restrict__ w_hh,
                    bf16_t* __restrict__ h_out, bf16_t* __restrict__ act,
                    bf16_t* __restrict__ c_out, int B, int T, int H, int chunk) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const Forward L(chunk, H);
  const int U = L.u, G4 = 4 * H;
  const int rank = (int)cluster_rank();
  const int b0 = (blockIdx.x / CLUSTER) * chunk;
  const int rows = min(chunk, B - b0);
  const int u0 = rank * U;
  const int mtiles = (rows + 15) / 16;
  const int NT = U / 2, KS = H / 16;  // 8-column tiles of the gate block; k-steps
  bf16_t* hbuf = reinterpret_cast<bf16_t*>(lstm_smem);          // [2][rows][ldh]
  bf16_t* xs = hbuf + 2 * L.hbuf();                              // [STAGES][rows][4U]
  bf16_t* stage_h = xs + FORWARD_STAGES * L.xstage();            // [rows][U]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  // this warp's tiles of W_hh as B fragments: tile nt, column 8 nt + g is
  // gate q = (8 nt + g) % 4 of unit u0 + (8 nt + g) / 4, row q H + unit
  unsigned wf[F_NTW][F_KS][2];
#pragma unroll
  for (int i = 0; i < F_NTW; ++i) {
    const int nt = warp + WARPS * i, col = 8 * nt + g;
    const bf16_t* wr = w_hh + (long long)((col % 4) * H + u0 + col / 4) * H;
#pragma unroll
    for (int ks = 0; ks < F_KS; ++ks) {
      const bool ok = nt < NT && ks < KS;
      wf[i][ks][0] = ok ? ld_pair(wr + 16 * ks + 2 * t4) : 0u;
      wf[i][ks][1] = ok ? ld_pair(wr + 16 * ks + 2 * t4 + 8) : 0u;
    }
  }
  for (int i = threadIdx.x; i < 2 * L.hbuf(); i += THREADS) hbuf[i] = 0;

  // xp of step s: four runs of U values a row (one a gate) into stage s % STAGES
  const bf16_t* xp_rows = xp + (long long)b0 * T * G4 + u0;
  auto load_x = [&](int s) {
    copy_runs(xs + (s % FORWARD_STAGES) * L.xstage(), 4 * U, xp_rows + (long long)s * G4,
              (long long)T * G4, H, rows, 4, U, true);
  };
#pragma unroll
  for (int s = 0; s < FORWARD_STAGES - 1; ++s) {
    if (s < T) load_x(s);
    cp_async_commit();
  }
  cluster_sync();  // every CTA's h buffers zeroed before any is written remotely

  float c_reg[MAX_MT][F_NTW];
#pragma unroll
  for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
    for (int i = 0; i < F_NTW; ++i) c_reg[mt][i] = 0.0f;
  const bool even = (t4 & 1) == 0;

  for (int s = 0; s < T; ++s) {
    cp_async_wait<FORWARD_STAGES - 2>();
    __syncthreads();  // step s's xp has landed for every thread
    if (s + FORWARD_STAGES - 1 < T) load_x(s + FORWARD_STAGES - 1);
    cp_async_commit();
    const bf16_t* hcur = hbuf + (s & 1) * L.hbuf();
    const bf16_t* xcur = xs + (s % FORWARD_STAGES) * L.xstage();

    float acc[MAX_MT][F_NTW][4];
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
      for (int i = 0; i < F_NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.0f;
    const unsigned a_lane = smem_addr(hcur) + 2u * ((lane & 15) * L.ldh + 8 * (lane >> 4));
#pragma unroll
    for (int ks = 0; ks < F_KS; ++ks) {
      if (ks >= KS) break;
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt) {
        if (mt >= mtiles) break;
        unsigned af[4];
        ldmatrix_x4(af, a_lane + 2u * (16 * mt * L.ldh + 16 * ks));
#pragma unroll
        for (int i = 0; i < F_NTW; ++i)
          if (warp + WARPS * i < NT) mma_bf16(acc[mt][i], af, wf[i][ks][0], wf[i][ks][1]);
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
        const float a0 = acc[mt][i][0], a1 = acc[mt][i][1];
        const float a2 = acc[mt][i][2], a3 = acc[mt][i][3];
        const float r0 = __shfl_xor_sync(FULL, even ? a2 : a0, 1);
        const float r1 = __shfl_xor_sync(FULL, even ? a3 : a1, 1);
        const float pre[4] = {even ? a0 : r0, even ? a1 : r1, even ? r0 : a2, even ? r1 : a3};
        const int row = 16 * mt + g + (even ? 0 : 8);
        const int up = 2 * nt + t4 / 2;  // the unit, in this CTA's U
        const bf16_t* xr = xcur + row * 4 * U + up;
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gate[q] = round_bf16(ld_bf16(xr + q * U) + round_bf16(pre[q]));
        const float si = round_bf16(sigmoid(gate[0])), sf = round_bf16(sigmoid(gate[1]));
        const float tg = round_bf16(tanhf(gate[2])), so = round_bf16(sigmoid(gate[3]));
        const float c = round_bf16(round_bf16(sf * c_reg[mt][i]) + round_bf16(si * tg));
        c_reg[mt][i] = c;
        const float h = round_bf16(so * round_bf16(tanhf(c)));
        if (row < rows) {
          const long long at = ((long long)(b0 + row) * T + s) * H + u0 + up;
          h_out[at] = to_bf16(h);
          c_out[at] = to_bf16(c);
          bf16_t* ar = act + ((long long)(b0 + row) * T + s) * G4 + u0 + up;
          ar[0] = to_bf16(si);
          ar[H] = to_bf16(sf);
          ar[2 * H] = to_bf16(tg);
          ar[3 * H] = to_bf16(so);
        }
        stage_h[row * U + up] = to_bf16(h);
      }
    }
    if (s + 1 == T) break;  // nothing reads the last h through the cluster
    __syncthreads();        // stage_h complete
    push_rows(stage_h, U, hbuf + ((s + 1) & 1) * L.hbuf() + u0, L.ldh, rows, U);
    cluster_sync();
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// backward

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
lstm_backward_kernel(const bf16_t* __restrict__ dh_out, const bf16_t* __restrict__ w_hh,
                     const bf16_t* __restrict__ act, const bf16_t* __restrict__ c_seq,
                     bf16_t* __restrict__ dgates, int B, int T, int H, int chunk) {
  extern __shared__ __align__(16) unsigned char lstm_smem[];
  const Backward L(chunk, H);
  const int U = L.u, G4 = 4 * H;
  const int rank = (int)cluster_rank();
  const int b0 = (blockIdx.x / CLUSTER) * chunk;
  const int rows = min(chunk, B - b0);
  const int u0 = rank * U;
  const int mtiles = (rows + 15) / 16;
  const int NT = L.up / 8, KS = G4 / 16;
  bf16_t* gbuf = reinterpret_cast<bf16_t*>(lstm_smem);                 // [2][rows][ldg]
  float* red = reinterpret_cast<float*>(gbuf + 2 * L.gbuf());          // [WARPS][rows][up]
  bf16_t* stage_g = reinterpret_cast<bf16_t*>(red + WARPS * L.rows * L.up);  // [rows][4U]
  bf16_t* ring = stage_g + L.rows * 4 * U;                             // [STAGES][rows][7U]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  // W_hh's columns of this CTA's units as B fragments over the gates buffer's
  // columns k' = 4U jj + 4 u' + q (CTA jj's unit u', gate q: row q H + jj U + u')
  auto w_at = [&](int k, int n) -> bf16_t {
    const int jj = k / (4 * U), rest = k % (4 * U);
    const int row = (rest % 4) * H + jj * U + rest / 4;
    return n < U ? w_hh[(long long)row * H + u0 + n] : (bf16_t)0;
  };
  unsigned wf[B_KSW][B_NT][2];
#pragma unroll
  for (int j = 0; j < B_KSW; ++j) {
    const int ks = warp + WARPS * j;
#pragma unroll
    for (int nt = 0; nt < B_NT; ++nt) {
      const bool ok = ks < KS && nt < NT;
      const int k = 16 * ks + 2 * t4, n = 8 * nt + g;
      wf[j][nt][0] = ok ? pack(w_at(k, n), w_at(k + 1, n)) : 0u;
      wf[j][nt][1] = ok ? pack(w_at(k + 8, n), w_at(k + 9, n)) : 0u;
    }
  }
  for (int i = threadIdx.x; i < 2 * L.gbuf(); i += THREADS) gbuf[i] = 0;

  // step s's saved state, a row of 7U values: act's four gates, c_t,
  // c_{t-1} (zeros at s = 0), dh_out_t
  const long long row_g4 = (long long)T * G4, row_h = (long long)T * H;
  auto load = [&](int s) {
    bf16_t* st = ring + (s % BACKWARD_STAGES) * L.stage();
    const long long first = (long long)b0 * T + s;
    copy_runs(st, 7 * U, act + first * G4 + u0, row_g4, H, rows, 4, U, true);
    copy_runs(st + 4 * U, 7 * U, c_seq + first * H + u0, row_h, 0, rows, 1, U, true);
    copy_runs(st + 5 * U, 7 * U, c_seq + (s > 0 ? first - 1 : first) * H + u0, row_h, 0, rows,
              1, U, s > 0);
    copy_runs(st + 6 * U, 7 * U, dh_out + first * H + u0, row_h, 0, rows, 1, U, true);
  };
#pragma unroll
  for (int i = 0; i < BACKWARD_STAGES - 1; ++i) {
    if (T - 1 - i >= 0) load(T - 1 - i);
    cp_async_commit();
  }
  cluster_sync();  // every CTA's gate buffers zeroed before any is written remotely

  constexpr int CELLS = MAX_CHUNK * (MAX_H / CLUSTER) / THREADS;  // a thread's (row, unit)s
  float dc_next[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) dc_next[k] = 0.0f;

  for (int it = 0; it < T; ++it) {
    const int s = T - 1 - it;
    cp_async_wait<BACKWARD_STAGES - 2>();
    __syncthreads();  // step s's state has landed for every thread
    if (s - (BACKWARD_STAGES - 1) >= 0) load(s - (BACKWARD_STAGES - 1));
    cp_async_commit();

    if (it > 0) {
      // this warp's partial of dgates_{s+1} W_hh over its k-steps
      const bf16_t* gcur = gbuf + ((it - 1) & 1) * L.gbuf();
      const unsigned a_lane = smem_addr(gcur) + 2u * ((lane & 15) * L.ldg + 8 * (lane >> 4));
      float acc[MAX_MT][B_NT][4];
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < B_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < B_KSW; ++j) {
        const int ks = warp + WARPS * j;
        if (ks >= KS) break;
#pragma unroll
        for (int mt = 0; mt < MAX_MT; ++mt) {
          if (mt >= mtiles) break;
          unsigned af[4];
          ldmatrix_x4(af, a_lane + 2u * (16 * mt * L.ldg + 16 * ks));
#pragma unroll
          for (int nt = 0; nt < B_NT; ++nt)
            if (nt < NT) mma_bf16(acc[mt][nt], af, wf[j][nt][0], wf[j][nt][1]);
        }
      }
      float* mine = red + warp * L.rows * L.up;
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt) {
        if (mt >= mtiles) break;
#pragma unroll
        for (int nt = 0; nt < B_NT; ++nt) {
          if (nt >= NT) break;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(mine + (16 * mt + g + 8 * hh) * L.up + 8 * nt + 2 * t4) =
                make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
        }
      }
      __syncthreads();
    }

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
      bf16_t* out = dgates + ((long long)(b0 + row) * T + s) * G4 + u0 + up;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = dg[q];
        stage_g[row * 4 * U + 4 * up + q] = dg[q];
      }
    }
    if (s == 0) break;  // nothing reads dgates_0 through the cluster
    __syncthreads();    // stage_g complete
    push_rows(stage_g, 4 * U, gbuf + (it & 1) * L.gbuf() + rank * 4 * U, L.ldg, rows, 4 * U);
    cluster_sync();
  }
  cp_async_wait<0>();
}

inline bool valid(int B, int T, int H, int chunk) {
  return B >= 1 && T >= 1 && H % 16 == 0 && H >= 16 && H <= MAX_H && chunk >= 1 &&
         chunk <= MAX_CHUNK;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int bytes, int B, int chunk, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int clusters = (B + chunk - 1) / chunk;
  kernel<<<clusters * CLUSTER, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace lstm
}  // namespace

// One layer's forward: h, c (B, T, H) and act (B, T, 4H) from xp (B, T, 4H)
// and w_hh (4H, H), all bf16, contiguous and 16-byte aligned; batch chunks
// of `chunk` rows a cluster (ops/lstm_recurrence.py:lstm_plan).
extern "C" int qvc_lstm_forward_bf16(const void* xp, const void* w_hh, void* h, void* act,
                                     void* c, int B, int T, int H, int chunk, void* stream) {
  using namespace lstm;
  if (!valid(B, T, H, chunk)) return (int)cudaErrorInvalidValue;
  return (int)launch(lstm_forward_kernel, Forward(chunk, H).bytes(), B, chunk,
                     (cudaStream_t)stream, (const bf16_t*)xp, (const bf16_t*)w_hh, (bf16_t*)h,
                     (bf16_t*)act, (bf16_t*)c, B, T, H, chunk);
}

// One layer's backward: dgates (B, T, 4H) from dh_out (B, T, H), w_hh and the
// forward's act and c; the same layout rules.
extern "C" int qvc_lstm_backward_bf16(const void* dh_out, const void* w_hh, const void* act,
                                      const void* c, void* dgates, int B, int T, int H,
                                      int chunk, void* stream) {
  using namespace lstm;
  if (!valid(B, T, H, chunk)) return (int)cudaErrorInvalidValue;
  return (int)launch(lstm_backward_kernel, Backward(chunk, H).bytes(), B, chunk,
                     (cudaStream_t)stream, (const bf16_t*)dh_out, (const bf16_t*)w_hh,
                     (const bf16_t*)act, (const bf16_t*)c, (bf16_t*)dgates, B, T, H, chunk);
}
