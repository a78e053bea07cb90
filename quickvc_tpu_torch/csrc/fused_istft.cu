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
// What bounds it on this card at the decoder's n_fft 16 / hop 4: bytes. Each
// frame reads 2 x 9 floats and adds 4 output samples (16 bytes); the
// arithmetic, 18 FMAs per frame sample, is far below the card's flop-per-byte
// balance. An output sample costs about 2 * n_fft FMAs (n_fft/hop frames of
// n_fft/2+1 bins), so at n_fft in the hundreds the operations bound it.
//
// Two bodies, one entry point:
//
// polar_istft_kernel, compiled for the decoder's 16 / 4: one block per
// (tile of TILE_P output hop-chunks, row). The block reads the TILE_P + 3
// frames its chunks need once, in coalesced order along the frame axis,
// decodes each spectrum element once (expf, sinf, sincosf: accurate library
// calls, no fast math) into shared memory, and builds the 9 x 16 windowed
// inverse-DFT basis there. Thread p then forms output chunk p as the sum over
// j of frame (p + 2 - j)'s samples [4j, 4j+4), which folds the overlap-add
// into the contraction, multiplies by the inverse squared-window envelope,
// and writes 4 samples as one float4.
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
// The table body runs 16 / 4 too, but 4.4x slower than the compiled one
// (0.068 against 0.0154 ms of device time at the conversion's (32, 5001, 9),
// in turns on an H100: scripts/kernel_times.py), which is why both stay.
//
// In both, frames outside [0, F) add exactly nothing, as in the reference
// OLA, and inputs may be strided: the decoder passes a view of its conv
// output without copying it.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 16;  // the compiled body's sizes
constexpr int HOP = 4;
constexpr int N_FREQ = N_FFT / 2 + 1;
constexpr int R = N_FFT / HOP;           // frames overlapping one chunk
constexpr int TILE_P = 256;              // output chunks per block, one per thread
constexpr int N_STAGE = TILE_P + R - 1;  // frames staged per block

__global__ void __launch_bounds__(TILE_P)
polar_istft_kernel(const float* __restrict__ log_mag,
                   const float* __restrict__ phase, long long lm_rs,
                   long long lm_ts, long long lm_ks, long long ph_rs,
                   long long ph_ts, long long ph_ks, float* __restrict__ out,
                   int n_frames) {
  __shared__ float br[N_FREQ][N_FFT];
  __shared__ float bi[N_FREQ][N_FFT];
  __shared__ float w2[N_FFT];
  __shared__ float re_s[N_STAGE][N_FREQ];
  __shared__ float im_s[N_STAGE][N_FREQ];

  const int row = blockIdx.y;
  const int p0 = blockIdx.x * TILE_P;
  const int t_lo = p0 + R / 2 - (R - 1);  // first frame any chunk of the tile reads

  for (int i = threadIdx.x; i < N_FREQ * N_FFT; i += TILE_P) {
    const int k = i / N_FFT;
    const int n = i - k * N_FFT;
    const double c = (k == 0 || k == N_FFT / 2) ? 1.0 : 2.0;
    const double w = 0.5 * (1.0 - cospi(2.0 * n / N_FFT));
    double sn, cs;
    sincospi(2.0 * ((k * n) % N_FFT) / N_FFT, &sn, &cs);
    br[k][n] = (float)(c * cs / N_FFT * w);
    bi[k][n] = (float)(-c * sn / N_FFT * w);
    if (k == 0) w2[n] = (float)(w * w);
  }
  const float* lm_row = log_mag + row * lm_rs;
  const float* ph_row = phase + row * ph_rs;
  for (int i = threadIdx.x; i < N_STAGE * N_FREQ; i += TILE_P) {
    const int k = i / N_STAGE;   // frame index fastest: coalesced when the
    const int tt = i - k * N_STAGE;  // frame axis has unit stride
    const int t = t_lo + tt;
    float re = 0.0f, im = 0.0f;
    if (t >= 0 && t < n_frames) {
      const float mag = expf(lm_row[t * lm_ts + k * lm_ks]);
      float sn, cs;
      sincosf(3.14159265358979f * sinf(ph_row[t * ph_ts + k * ph_ks]), &sn, &cs);
      re = mag * cs;
      im = mag * sn;
    }
    re_s[tt][k] = re;
    im_s[tt][k] = im;
  }
  __syncthreads();

  const int p = p0 + threadIdx.x;
  if (p >= n_frames - 1) return;
  float y[HOP];
  double env[HOP];
#pragma unroll
  for (int q = 0; q < HOP; ++q) { y[q] = 0.0f; env[q] = 0.0; }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int tt = threadIdx.x + R - 1 - j;  // frame p + R/2 - j
    const int t = p + R / 2 - j;
#pragma unroll
    for (int k = 0; k < N_FREQ; ++k) {
      const float re = re_s[tt][k];
      const float im = im_s[tt][k];
#pragma unroll
      for (int q = 0; q < HOP; ++q)
        y[q] = fmaf(re, br[k][j * HOP + q], fmaf(im, bi[k][j * HOP + q], y[q]));
    }
    if (t >= 0 && t < n_frames) {
#pragma unroll
      for (int q = 0; q < HOP; ++q) env[q] += w2[j * HOP + q];
    }
  }
  float4 o;
  float* of = &o.x;
#pragma unroll
  for (int q = 0; q < HOP; ++q)
    of[q] = y[q] * (env[q] < 1e-11 ? 1.0f : (float)(1.0 / env[q]));
  reinterpret_cast<float4*>(out + (long long)row * (n_frames - 1) * HOP)[p] = o;
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

// log_mag, phase: (rows, F, n_fft/2+1) through their (row, frame, bin)
// strides; out: contiguous (rows, hop*(F-1)). (16, 4) runs the compiled
// body and ignores table; any other pair that the TPU kernel asserts, with
// n_fft <= MAX_N_FFT, runs the run-time body on table (4 n_fft floats, see
// ops/fused_istft.py:istft_table); the rest is refused.
extern "C" int qvc_polar_istft(const void* log_mag, const void* phase,
                               long long lm_rs, long long lm_ts, long long lm_ks,
                               long long ph_rs, long long ph_ts, long long ph_ks,
                               void* out, int rows, int n_frames, int n_fft, int hop,
                               const void* table, void* stream) {
  const float* lm = (const float*)log_mag;
  const float* ph = (const float*)phase;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_fft == N_FFT && hop == HOP) {
    dim3 grid((n_frames - 1 + TILE_P - 1) / TILE_P, rows);
    polar_istft_kernel<<<grid, TILE_P, 0, st>>>(lm, ph, lm_rs, lm_ts, lm_ks, ph_rs, ph_ts,
                                                ph_ks, (float*)out, n_frames);
    return (int)cudaGetLastError();
  }
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
