// Kernel K3: fused polar decode + inverse STFT head of the decoder, float32,
// for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_istft.py:
// polar_inverse_stft_pallas (pallas_call at fused_istft.py:159; body _kernel
// at :74-115). Same function as dsp/istft.py:polar_inverse_stft, i.e.
// torch.istft(exp(log_mag) * exp(i*pi*sin(phase)), n_fft, hop, Hann,
// center=True): (rows, F, n_fft/2+1) x2 -> (rows, hop*(F-1)). It takes the
// sizes the TPU kernel asserts (hop | n_fft, n_fft/hop even and at most 128)
// with n_fft up to 2048 (ops/fused_istft.py:istft_route).
//
// What bounds it on this card at the decoder's n_fft 16 / hop 4: bytes in
// principle (each frame reads 2 x 9 floats and adds 4 output samples, 16
// bytes; its 144 FMAs are far below the card's flop-per-byte balance), the
// issue of instructions in fact: the decode's accurate expf, sinf and
// sincospif of a frame's 9 bins take ~600 instructions, more than the rest
// of its work together, and a frame of 72 bytes then costs as much issue as
// the byte bound allows for ~2.5 times its bytes. An output sample costs
// about 2 * n_fft FMAs (n_fft/hop frames of n_fft/2+1 bins), so at n_fft in
// the hundreds the operations bound it.
//
// Two bodies, one entry point:
//
// polar_istft_kernel, compiled for the decoder's 16 / 4. The rows are laid
// end to end as one sequence of virtual frames: row r holds frames
// t in [-EDGE, F + EDGE) (EDGE = R/2 - 1 = 1, R = n_fft/hop frames overlap a
// chunk) at v = r*(F + 2 EDGE) + t + EDGE, the frames outside [0, F) zero,
// and chunk slot c = r*(F + 2 EDGE) + p, which sums frames v in [c, c+R),
// is output chunk p of row r for p < F-1 (the other R-1 slots of a row are
// dead). The host plans a persistent grid (ops/fused_istft.py:istft_plan:
// every block resident, a few an SM, the batch in as few full steps a block
// as they allow, a small batch spread over the SMs), and hands the kernel
// each block's span of slots and the row divider's multiplier, so no
// thread divides. A block walks its span in steps of THREADS chunks (its
// first step R - 1 fewer). At each step thread i decodes one frame (expf,
// sinf, sincospif: accurate library calls, no fast math) and contracts it
// against the windowed inverse-DFT basis into its 16 samples in shared
// memory (four float4s), then, after one barrier, sums one chunk's four
// frame-shifted pieces (the overlap-add folded into the contraction, as the
// TPU kernel does), scales them by the inverse squared-window envelope and
// writes the 4 samples as one float4. The R-1 frames a step shares with
// the next are copied into the other of two frame buffers after the
// barrier, so one barrier a step suffices. The raw log_mag / phase of the
// next step's frame are loaded into registers before this step's frame is
// decoded, contracted and stored, so the loads of one step overlap the
// work of the one before (a 2-stage ring of 4-byte cp.async copies in
// shared memory was slower on the H100, PERF.md; the views' row stride,
// 4 F bytes with F odd, rules out TMA and 16-byte copies). The basis and the envelope come from the host
// (ops/fused_istft.py:compiled_tables, float32 of the float64 values
// dsp/istft.py builds) as a by-value kernel parameter, i.e. the constant
// bank: the basis as the half its symmetry does not repeat (see Tables),
// the envelope as its EDGE first chunks, its hop-periodic interior and its
// EDGE last chunks, which is all of it.
//
// polar_istft_kernel_rt, any other (n_fft, hop): an (n_fft/2+1, n_fft) basis
// would not fit in shared memory (4 MB at n_fft 2048), so the block stages
// a table the host builds once per size, cos and sin(2 pi j / n_fft), the
// window over n_fft and its square (4 n_fft floats), and forms each basis
// term from it as it goes: thread s owns output sample s of a 256-sample
// tile and sums, over the frames t that cover it (n = s + n_fft/2 - t*hop in
// [0, n_fft)), w[n]/n_fft * (re_0 + (-1)^n re_{n/2} + 2 sum_k (re_k cos -
// im_k sin)(2 pi k n / n_fft)), walking k n mod n_fft by additions. The
// frames that cover the tile are decoded into shared memory a group at a
// time, reading frame-fastest (coalesced when the frame axis has unit
// stride); the envelope is summed in double over the same frames.
//
// In both, frames outside [0, F) add exactly nothing, as in the reference
// OLA, no sum depends on the launch (no atomics), and inputs may be strided:
// the decoder passes a view of its conv output without copying it.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstring>

namespace {

constexpr int THREADS = 128;            // chunks a step, one a thread (ops/fused_istft.py:TILE)
constexpr int BLOCKS_PER_SM = 6;        // resident blocks an SM (ops/fused_istft.py:BLOCKS_PER_SM)

template <int N_FFT, int HOP>
struct Head {
  static constexpr int N_FREQ = N_FFT / 2 + 1;
  static constexpr int R = N_FFT / HOP;      // frames overlapping one chunk
  static constexpr int EDGE = R / 2 - 1;     // chunks at each end of a row that miss a frame
  static constexpr int SLOTS = THREADS + R - 1;  // frames a step reads
  static constexpr int LDF = N_FFT + 4;      // a frame's stride in shared memory: float4
                                             // rows, no bank conflict
};

// v / d for 0 <= v < 2^31 and 4 <= d < 2^31 by a multiply: with
// m = 2^32 / d + 1 (from the host, divider_magic), v m / 2^32 is the
// quotient or one more (it is under v / d + 1/2), which one check settles.
struct Divider {
  unsigned d, m;
  __device__ __forceinline__ int operator()(int v) const {
    const unsigned q = __umulhi((unsigned)v, m);
    return (int)(q * d > (unsigned)v ? q - 1 : q);
  }
};

__host__ unsigned divider_magic(unsigned d) { return (unsigned)(0x100000000ull / d) + 1u; }

// What the compiled body reads besides the spectra, built on the host
// (ops/fused_istft.py:compiled_tables) and passed by value: the windowed
// inverse-DFT basis of dsp/istft.py:_inverse_dft_matrices where its
// symmetry does not repeat it, and the inverse envelope. The periodic Hann
// window is symmetric, w[N - n] = w[n], so the basis' re part at N - n is
// its re part at n and its im part the negative of its im part at n; a
// frame is a[n] - b[n] at n <= N/2 and a[n] + b[n] at N - n, with
// a = re @ basis_re[:, :N/2+1] and b = im @ -basis_im (0 < k, n < N/2; the
// rest of the im part is 0): 130 products and 14 sums, not the full
// basis' 288 products.
template <int N_FFT, int HOP>
struct Tables {
  float re[N_FFT / 2 + 1][N_FFT / 2 + 1];  // basis_re[k][n], k, n <= N/2
  float im[N_FFT / 2 - 1][N_FFT / 2 - 1];  // -basis_im[k][n], 0 < k, n < N/2
  float env[(N_FFT / HOP - 1) * HOP];  // inverse envelope: EDGE first chunks, interior, EDGE last
};

// What a frame outside [0, F) reads for every bin: log_mag -inf and phase
// 0 decode to exactly 0, so such a frame adds nothing.
__device__ const float OUTSIDE[2] = {-INFINITY, 0.0f};

// One frame: decode its bins and contract them with the basis into its
// N_FFT windowed samples at dst, 16-byte aligned.
template <int N_FFT, int HOP>
__device__ __forceinline__ void synth_frame(const float* lm, const float* ph,
                                            const Tables<N_FFT, HOP>& tab, float* dst) {
  constexpr int NF = N_FFT / 2 + 1;
  float a[NF], b[NF - 2];  // a[n], n <= N/2; b[n - 1], 0 < n < N/2
#pragma unroll
  for (int n = 0; n < NF; ++n) a[n] = 0.0f;
#pragma unroll
  for (int n = 0; n < NF - 2; ++n) b[n] = 0.0f;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    const float mag = expf(lm[k]);
    float sn, cs;
    sincospif(sinf(ph[k]), &sn, &cs);  // cos and sin of pi * sin(phase)
    const float re = mag * cs, im = mag * sn;
#pragma unroll
    for (int n = 0; n < NF; ++n) a[n] = fmaf(re, tab.re[k][n], a[n]);
    if (k > 0 && k < NF - 1) {  // the im part is 0 at k = 0 and N/2
#pragma unroll
      for (int n = 0; n < NF - 2; ++n) b[n] = fmaf(im, tab.im[k - 1][n], b[n]);
    }
  }
  float y[N_FFT];
  y[0] = a[0];
  y[NF - 1] = a[NF - 1];
#pragma unroll
  for (int n = 1; n < NF - 1; ++n) {
    y[n] = a[n] - b[n - 1];
    y[N_FFT - n] = a[n] + b[n - 1];
  }
#pragma unroll
  for (int n = 0; n < N_FFT; n += 4)
    *reinterpret_cast<float4*>(dst + n) = make_float4(y[n], y[n + 1], y[n + 2], y[n + 3]);
}

template <int N_FFT, int HOP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
polar_istft_kernel(const float* __restrict__ log_mag, const float* __restrict__ phase,
                   long long lm_rs, long long lm_ts, long long lm_ks, long long ph_rs,
                   long long ph_ts, long long ph_ks, float* __restrict__ out, int n_frames,
                   unsigned row_magic, int span, int longer,
                   const __grid_constant__ Tables<N_FFT, HOP> tab) {
  using H = Head<N_FFT, HOP>;
  constexpr int NF = H::N_FREQ, R = H::R, EDGE = H::EDGE, LDF = H::LDF;
  constexpr int FIRST = THREADS - (R - 1);  // chunks of a span's first step
  static_assert(HOP == 4 && N_FFT % 4 == 0, "a chunk is one float4");
  __shared__ __align__(16) float frames[2][H::SLOTS][LDF];

  const int i = threadIdx.x;
  const int row_len = n_frames + 2 * EDGE;
  const Divider row_of{(unsigned)row_len, row_magic};
  const int n_chunks = n_frames - 1;
  // this block's span: the slots split evenly, the first `longer` blocks
  // one longer (ops/fused_istft.py:IstftPlan.span)
  const int b = blockIdx.x;
  const int c_begin = b * span + min(b, longer);
  const int c_end = c_begin + span + (b < longer);

  // A step at chunk c0 stores chunks [c0, c0 + n) and reads frames
  // [c0, c0 + n + R - 1), frame c0 + s at slot s. The span's first step
  // decodes all of its frames (FIRST chunks, one frame a thread); each later
  // one THREADS chunks, the R - 1 frames it shares with the step before
  // (slots [0, R-1), lead = R - 1) copied over. Thread i decodes the frame
  // at slot lead + i, its raw spectra loaded one step ahead.
  auto step_chunks = [&](int c0, int lead) { return min(FIRST + lead, c_end - c0); };
  float lm_next[NF], ph_next[NF];
  auto fetch = [&](int c0, int lead) {
    const int v = c0 + lead + i;
    // a frame outside [0, F), or that the step does not read, reads every
    // bin from OUTSIDE
    const float* lm_src = &OUTSIDE[0];
    const float* ph_src = &OUTSIDE[1];
    bool ok = false;
    if (i + lead < step_chunks(c0, lead) + R - 1) {
      const int r = row_of(v);
      const int t = v - r * row_len - EDGE;
      ok = t >= 0 && t < n_frames;
      if (ok) {
        lm_src = log_mag + r * lm_rs + t * lm_ts;
        ph_src = phase + r * ph_rs + t * ph_ts;
      }
    }
    const long long lm_step = ok ? lm_ks : 0, ph_step = ok ? ph_ks : 0;
#pragma unroll
    for (int k = 0; k < NF; ++k, lm_src += lm_step, ph_src += ph_step) {
      lm_next[k] = __ldg(lm_src);
      ph_next[k] = __ldg(ph_src);
    }
  };

  fetch(c_begin, 0);
  int buf = 0, lead = 0;
  for (int c0 = c_begin; c0 < c_end; lead = R - 1, buf ^= 1) {
    const int n = step_chunks(c0, lead);
    float lm[NF], ph[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) {
      lm[k] = lm_next[k];
      ph[k] = ph_next[k];
    }
    if (c0 + n < c_end) fetch(c0 + n, R - 1);
    if (i + lead < n + R - 1) synth_frame<N_FFT, HOP>(lm, ph, tab, frames[buf][lead + i]);
    __syncthreads();
    // the next step's first R - 1 frames (slots [n, n + R - 1) of a full
    // step) into the other buffer, whose last readers passed the barrier
    if (i >= FIRST && c0 + n < c_end) {
#pragma unroll
      for (int m = 0; m < N_FFT; m += 4)
        *reinterpret_cast<float4*>(&frames[buf ^ 1][i - FIRST][m]) =
            *reinterpret_cast<const float4*>(&frames[buf][lead + i][m]);
    }
    if (i < n) {
      const int c = c0 + i;
      const int r = row_of(c);
      const int p = c - r * row_len;
      if (p < n_chunks) {
        float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < R; ++j) {  // frame p + R/2 - j, its samples [j hop, (j+1) hop)
          const float4 f = *reinterpret_cast<const float4*>(&frames[buf][i + R - 1 - j][j * HOP]);
          y.x += f.x;
          y.y += f.y;
          y.z += f.z;
          y.w += f.w;
        }
        // the envelope's chunk: the interior, or one of the row's first or last
        const float* env = &tab.env[EDGE * HOP];
        if (p < EDGE || p >= n_chunks - EDGE)
          env = &tab.env[(p < EDGE ? p : 2 * EDGE + 1 - (n_chunks - p)) * HOP];
        reinterpret_cast<float4*>(out)[(long long)r * n_chunks + p] =
            make_float4(y.x * env[0], y.y * env[1], y.z * env[2], y.w * env[3]);
      }
    }
    c0 += n;
  }
}

constexpr int RT_THREADS = 256;  // output samples per block, one a thread
constexpr int RT_STAGE = 8192;   // floats of decoded spectra (re and im) staged at once
constexpr int MAX_N_FFT = 2048;  // ops/fused_istft.py:MAX_N_FFT
constexpr int MAX_R = 128;       // n_fft / hop, the TPU kernel's bound

__global__ void __launch_bounds__(RT_THREADS)
polar_istft_kernel_rt(const float* __restrict__ log_mag, const float* __restrict__ phase,
                      long long lm_rs, long long lm_ts, long long lm_ks, long long ph_rs,
                      long long ph_ts, long long ph_ks, float* __restrict__ out,
                      int n_frames, int n_fft, int hop, const float* __restrict__ table,
                      int group) {
  extern __shared__ float smem[];
  const int half = n_fft / 2;
  const int n_freq = half + 1;
  float* cs = smem;             // cos(2 pi j / n_fft)
  float* sn = cs + n_fft;       // sin(2 pi j / n_fft)
  float* wn = sn + n_fft;       // window / n_fft
  float* w2 = wn + n_fft;       // window^2
  float* re_s = w2 + n_fft;     // (group, n_freq) decoded frames
  float* im_s = re_s + group * n_freq;
  for (int i = threadIdx.x; i < 4 * n_fft; i += RT_THREADS) smem[i] = table[i];

  const int row = blockIdx.y;
  const int s0 = blockIdx.x * RT_THREADS;
  const int s = s0 + threadIdx.x;
  const int u = s + half;  // position in the untrimmed overlap-add
  const int u0 = s0 + half;
  const int t_lo = u0 - n_fft + 1 <= 0 ? 0 : (u0 - n_fft + hop) / hop;
  const int t_hi = min(n_frames - 1, (u0 + RT_THREADS - 1) / hop);
  const float* lm_row = log_mag + row * lm_rs;
  const float* ph_row = phase + row * ph_rs;

  float y = 0.0f;
  double env = 0.0;
  for (int tg = t_lo; tg <= t_hi; tg += group) {
    const int nt = min(group, t_hi - tg + 1);
    __syncthreads();  // the previous group is consumed (and the table staged)
    for (int i = threadIdx.x; i < nt * n_freq; i += RT_THREADS) {
      const int k = i / nt;  // frame index fastest
      const int tt = i - k * nt;
      const int t = tg + tt;
      const float mag = expf(lm_row[t * lm_ts + k * lm_ks]);
      float sv, cv;
      sincosf(3.14159265358979f * sinf(ph_row[t * ph_ts + k * ph_ks]), &sv, &cv);
      re_s[tt * n_freq + k] = mag * cv;
      im_s[tt * n_freq + k] = mag * sv;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const int n = u - (tg + tt) * hop;
      if (n < 0 || n >= n_fft) continue;
      const float* re = re_s + tt * n_freq;
      const float* im = im_s + tt * n_freq;
      float acc = 0.0f;
      int idx = n;  // k n mod n_fft, from k = 1
      for (int k = 1; k < half; ++k) {
        acc = fmaf(re[k], cs[idx], acc);
        acc = fmaf(-im[k], sn[idx], acc);
        idx += n;
        if (idx >= n_fft) idx -= n_fft;
      }
      const float edge = re[0] + ((n & 1) ? -re[half] : re[half]);
      y = fmaf(fmaf(2.0f, acc, edge), wn[n], y);
      env += (double)w2[n];
    }
  }
  if (s < hop * (n_frames - 1))
    out[(long long)row * hop * (n_frames - 1) + s] =
        y * (env < 1e-11 ? 1.0f : (float)(1.0 / env));
}

}  // namespace

using Compiled = Tables<16, 4>;  // the compiled body's sizes, ops/fused_istft.py:COMPILED
static_assert(sizeof(Compiled) == (9 * 9 + 7 * 7 + 3 * 4) * sizeof(float),
              "ops/fused_istft.py:compiled_tables layout");

static int launch_compiled(const void* log_mag, const void* phase, long long lm_rs,
                           long long lm_ts, long long lm_ks, long long ph_rs, long long ph_ts,
                           long long ph_ks, void* out, int rows, int n_frames,
                           const void* host_tables, int blocks, void* stream) {
  const long long row_len = n_frames + 2;                 // F + 2 EDGE
  if (host_tables == nullptr || blocks < 1 || rows * row_len > INT_MAX)  // int slot indices
    return (int)cudaErrorInvalidValue;
  Compiled tab;
  memcpy(&tab, host_tables, sizeof(tab));
  const int slots = (int)(rows * row_len - 3);            // less the last row's R - 1 dead slots
  polar_istft_kernel<16, 4><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)log_mag, (const float*)phase, lm_rs, lm_ts, lm_ks, ph_rs, ph_ts, ph_ks,
      (float*)out, n_frames, divider_magic((unsigned)row_len), slots / blocks, slots % blocks,
      tab);
  return (int)cudaGetLastError();
}

// log_mag, phase: (rows, F, n_fft/2+1) through their (row, frame, bin)
// strides; out: contiguous (rows, hop*(F-1)). (16, 4) runs the compiled
// body on a grid of `blocks` (ops/fused_istft.py:istft_plan) with the
// host's basis and envelope (host_tables, host memory: Tables<16, 4>,
// ops/fused_istft.py:compiled_tables), and ignores table; any other pair
// that the TPU kernel asserts, with n_fft <= MAX_N_FFT, runs the run-time
// body on table (device memory, 4 n_fft floats, see
// ops/fused_istft.py:istft_table) and ignores host_tables and blocks; the
// rest is refused.
extern "C" int qvc_polar_istft(const void* log_mag, const void* phase,
                               long long lm_rs, long long lm_ts, long long lm_ks,
                               long long ph_rs, long long ph_ts, long long ph_ks,
                               void* out, int rows, int n_frames, int n_fft, int hop,
                               const void* table, const void* host_tables, int blocks,
                               void* stream) {
  if (n_fft == 16 && hop == 4)
    return launch_compiled(log_mag, phase, lm_rs, lm_ts, lm_ks, ph_rs, ph_ts, ph_ks, out, rows,
                           n_frames, host_tables, blocks, stream);
  const float* lm = (const float*)log_mag;
  const float* ph = (const float*)phase;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hop < 1 || n_fft > MAX_N_FFT || n_fft % hop || (n_fft / hop) % 2 ||
      n_fft / hop > MAX_R || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n_freq = n_fft / 2 + 1;
  const int covering = (RT_THREADS - 1) / hop + n_fft / hop + 1;  // frames a tile can need
  int group = RT_STAGE / (2 * n_freq);
  group = group < 1 ? 1 : group > covering ? covering : group;
  const size_t smem = sizeof(float) * (4 * (size_t)n_fft + 2 * (size_t)group * n_freq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        polar_istft_kernel_rt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_out = (long long)hop * (n_frames - 1);
  dim3 grid((unsigned)((n_out + RT_THREADS - 1) / RT_THREADS), rows);
  polar_istft_kernel_rt<<<grid, RT_THREADS, smem, st>>>(lm, ph, lm_rs, lm_ts, lm_ks, ph_rs,
                                                        ph_ts, ph_ks, (float*)out, n_frames,
                                                        n_fft, hop, (const float*)table, group);
  return (int)cudaGetLastError();
}
