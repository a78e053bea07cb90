// Kernel K1: fused wave -> log-mel featurization, float32, for sm_90a.
//
// Replaces the TPU kernel quickvc_tpu/ops/fused_mel.py:wave_to_mel_pallas
// (pallas_call at fused_mel.py:227; body _kernel at :95-123). Same function
// as reference mel_processing.py:wave_to_mel: reflect pad (n_fft-hop)/2,
// periodic Hann window, |DFT| as sqrt(re^2 + im^2 + 1e-6), Slaney mel
// projection, log(clamp(., 1e-5)). (B, T) -> (B, T//hop, n_mels).
//
// What bounds it on this card: operations. A frame costs 2*n_fft*(n_fft+2)
// flops of real DFT plus 2*n_freq*n_mels of mel projection, about 3.4 MFLOP
// at n_fft 1280, against ~5 KB of wave read: far above the card's
// flop-per-byte balance. The DFT must be full float32 (TF32 or bf16
// multiplicands cost ~1% of spectrogram accuracy, the fault the round-5
// TPU gate found at fused_mel.py:110-116), so the ceiling is the 67 TFLOP/s
// float32 FMA rate, not the tensor cores.
//
// Design: one block per (tile of TILE_F frames, batch item). The block
// stages the tile's haloed wave window ((TILE_F-1)*hop + n_fft samples) in
// shared memory, doing the reflect pad by index reflection, and builds a
// one-period cos/sin table of n_fft entries indexed by (n*k mod n_fft)
// instead of streaming a 6.5 MB DFT basis from memory. The window is
// folded into the twiddle once per (n, bin) and shared by all TILE_F
// frames, so each twiddle load feeds 2*TILE_F FMAs held in registers. The
// magnitudes then overwrite the staging buffer, and each (frame, mel)
// pair sums only its filter's nonzero band of the filterbank (read through
// L1/L2), then takes the log.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_F = 8;      // frames per block
constexpr int THREADS = 256;   // bins are spread over the threads
constexpr int KPT = 3;         // bins per thread: 3 * 256 >= 641

__global__ void __launch_bounds__(THREADS)
wave_to_mel_kernel(const float* __restrict__ y, const float* __restrict__ mel_fb,
                   const int* __restrict__ mel_range, float* __restrict__ out,
                   int t_len, int n_frames, int n_fft, int hop, int win,
                   int n_freq, int n_mels) {
  extern __shared__ float smem[];
  const int pad = (n_fft - hop) / 2;
  const int span = (TILE_F - 1) * hop + n_fft;
  float* xs = smem;              // staged wave window
  float* ct = xs + span;         // cos(2 pi j / n_fft)
  float* st = ct + n_fft;        // sin(2 pi j / n_fft)
  float* wn = st + n_fft;        // window, centred in n_fft
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TILE_F;
  const float* yb = y + (long long)b * t_len;

  for (int i = threadIdx.x; i < span; i += THREADS) {
    // padded index -> original index with reflection at both ends
    int s = p0 * hop + i - pad;
    if (s < 0) s = -s;
    if (s >= t_len) s = 2 * (t_len - 1) - s;
    xs[i] = (s >= 0 && s < t_len) ? yb[s] : 0.0f;
  }
  const int woff = (n_fft - win) / 2;
  for (int j = threadIdx.x; j < n_fft; j += THREADS) {
    double sn, cs;
    sincospi(2.0 * j / n_fft, &sn, &cs);
    ct[j] = (float)cs;
    st[j] = (float)sn;
    const int jw = j - woff;
    // periodic Hann, rounded once to float32 like dsp/stft.py:hann_window
    wn[j] = (jw >= 0 && jw < win)
        ? (float)(0.5 * (1.0 - cospi(2.0 * jw / win))) : 0.0f;
  }
  __syncthreads();

  int kk[KPT], idx[KPT];
  float re[KPT][TILE_F], im[KPT][TILE_F];
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int k = threadIdx.x + u * THREADS;
    kk[u] = k < n_freq ? k : 0;  // idle lanes compute bin 0 and store nothing
    idx[u] = 0;
#pragma unroll
    for (int f = 0; f < TILE_F; ++f) { re[u][f] = 0.0f; im[u][f] = 0.0f; }
  }
  for (int n = 0; n < n_fft; ++n) {
    float xv[TILE_F];
#pragma unroll
    for (int f = 0; f < TILE_F; ++f) xv[f] = xs[f * hop + n];
    const float w = wn[n];
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const float c = ct[idx[u]] * w;
      const float s = st[idx[u]] * w;
#pragma unroll
      for (int f = 0; f < TILE_F; ++f) {
        re[u][f] = fmaf(xv[f], c, re[u][f]);
        im[u][f] = fmaf(-xv[f], s, im[u][f]);
      }
      idx[u] += kk[u];
      if (idx[u] >= n_fft) idx[u] -= n_fft;
    }
  }
  __syncthreads();  // the staging buffer is reused for the magnitudes

  float* spec = smem;  // (TILE_F, n_freq); host checks it fits in the buffer
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int k = threadIdx.x + u * THREADS;
    if (k < n_freq) {
#pragma unroll
      for (int f = 0; f < TILE_F; ++f)
        spec[f * n_freq + k] =
            sqrtf(re[u][f] * re[u][f] + im[u][f] * im[u][f] + 1e-6f);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE_F * n_mels; i += THREADS) {
    const int f = i / n_mels;
    const int m = i - f * n_mels;
    const int p = p0 + f;
    if (p >= n_frames) continue;
    const float* fb = mel_fb + (long long)m * n_freq;
    const float* sp = spec + f * n_freq;
    float acc = 0.0f;
    for (int k = mel_range[2 * m]; k < mel_range[2 * m + 1]; ++k)
      acc = fmaf(__ldg(fb + k), sp[k], acc);
    out[((long long)b * n_frames + p) * n_mels + m] = logf(fmaxf(acc, 1e-5f));
  }
}

}  // namespace

extern "C" int qvc_wave_to_mel(const void* y, const void* mel_fb,
                               const void* mel_range, void* out, int batch,
                               int t_len, int n_frames, int n_fft, int hop,
                               int win, int n_freq, int n_mels, void* stream) {
  const int span = (TILE_F - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * (size_t)(span + 3 * n_fft);
  if (n_freq > KPT * THREADS ||
      (size_t)TILE_F * n_freq > (size_t)(span + 3 * n_fft))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wave_to_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n_frames + TILE_F - 1) / TILE_F, batch);
  wave_to_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)mel_fb, (const int*)mel_range,
      (float*)out, t_len, n_frames, n_fft, hop, win, n_freq, n_mels);
  return (int)cudaGetLastError();
}
