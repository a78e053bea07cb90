// Kernel K3: fused polar decode + inverse STFT head of the decoder, float32,
// for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_istft.py:
// polar_inverse_stft_pallas (pallas_call at fused_istft.py:159; body _kernel
// at :74-115). Same function as dsp/istft.py:polar_inverse_stft, i.e.
// torch.istft(exp(log_mag) * exp(i*pi*sin(phase)), n_fft 16, hop 4, Hann,
// center=True): (rows, F, 9) x2 -> (rows, 4*(F-1)).
//
// What bounds it on this card: bytes. Each frame reads 2 x 9 floats and
// adds 4 output samples (16 bytes); the arithmetic, 18 FMAs per frame
// sample, is far below the card's flop-per-byte balance.
//
// Design: one block per (tile of TILE_P output hop-chunks, row). The block
// reads the TILE_P + 3 frames its chunks need once, in coalesced order
// along the frame axis, decodes each spectrum element once (expf, sinf,
// sincosf: accurate library calls, no fast math) into shared memory, and
// builds the 9 x 16 windowed inverse-DFT basis there. Thread p then forms
// output chunk p as the sum over j of frame (p + 2 - j)'s samples
// [4j, 4j+4), which folds the overlap-add into the contraction, multiplies
// by the inverse squared-window envelope, and writes 4 samples as one
// float4. Frames outside [0, F) are zero in shared memory, so they add
// exactly nothing, as in the reference OLA. Inputs may be strided: the
// decoder passes a view of its conv output without copying it.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 16;
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

}  // namespace

extern "C" int qvc_polar_istft(const void* log_mag, const void* phase,
                               long long lm_rs, long long lm_ts, long long lm_ks,
                               long long ph_rs, long long ph_ts, long long ph_ks,
                               void* out, int rows, int n_frames, void* stream) {
  dim3 grid((n_frames - 1 + TILE_P - 1) / TILE_P, rows);
  polar_istft_kernel<<<grid, TILE_P, 0, (cudaStream_t)stream>>>(
      (const float*)log_mag, (const float*)phase, lm_rs, lm_ts, lm_ks, ph_rs,
      ph_ts, ph_ks, (float*)out, n_frames);
  return (int)cudaGetLastError();
}
