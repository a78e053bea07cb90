// Kernels K1 (wave -> log-mel) and K4 (halo'd wave -> linear spectrogram),
// float32, for sm_90a.
//
// K1 replaces the TPU kernel quickvc_tpu/ops/fused_mel.py:wave_to_mel_pallas
// (pallas_call at fused_mel.py:227; body _kernel at :95-123). Same function
// as reference mel_processing.py:wave_to_mel: reflect pad (n_fft-hop)/2,
// periodic Hann window, |DFT| as sqrt(re^2 + im^2 + 1e-6), Slaney mel
// projection, log(clamp(., 1e-5)). (B, T) -> (B, T//hop, n_mels).
//
// K4 replaces quickvc_tpu/ops/fused_mel.py:wave_to_spec_halo_pallas
// (pallas_call at fused_mel.py:177; body _spec_kernel at :126-145), the
// compact-transfer training spectrogram: the same framing, window, DFT and
// magnitude on a wave that already carries its (n_fft-hop)/2 halo, so no
// pad and no mel. (B, T + 2*pad) -> (B, T//hop, n_fft/2+1).
//
// What bounds both on this card: operations. A frame costs 2*n_fft*(n_fft+2)
// flops of real DFT (plus 2*n_freq*n_mels of mel projection for K1), about
// 3.3 MFLOP at n_fft 1280, against ~5 KB of wave read: far above the card's
// flop-per-byte balance. The DFT must be full float32 (TF32 or bf16
// multiplicands cost ~1% of spectrogram accuracy, the fault the round-5
// TPU gate found at fused_mel.py:110-116), so the ceiling is the 67 TFLOP/s
// float32 FMA rate, not the tensor cores.
//
// Design: one block per (tile of TILE_F frames, batch item). The block
// stages the tile's wave window ((TILE_F-1)*hop + n_fft samples) in shared
// memory (K1 does the reflect pad by index reflection) and builds a
// one-period cos/sin table of n_fft entries indexed by (n*k mod n_fft)
// instead of streaming a 6.5 MB DFT basis from memory. The window is folded
// into the twiddle once per (n, bin) and shared by all TILE_F frames, so
// each twiddle load feeds 2*TILE_F FMAs held in registers. K4 writes the
// magnitudes straight from registers; K1 stages them in shared memory, and
// each (frame, mel) pair sums only its filter's nonzero band of the
// filterbank (read through L1/L2), then takes the log.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_F = 8;      // frames per block
constexpr int THREADS = 256;   // bins are spread over the threads
constexpr int KPT = 3;         // bins per thread: 3 * 256 >= 641

// Twiddle table cos/sin(2 pi j / n_fft) and the Hann(win) window centred in
// n_fft samples (periodic, rounded once to float32 like dsp/stft.py).
__device__ __forceinline__ void stage_tables(float* ct, float* st, float* wn,
                                             int n_fft, int win) {
  const int woff = (n_fft - win) / 2;
  for (int j = threadIdx.x; j < n_fft; j += THREADS) {
    double sn, cs;
    sincospi(2.0 * j / n_fft, &sn, &cs);
    ct[j] = (float)cs;
    st[j] = (float)sn;
    const int jw = j - woff;
    wn[j] = (jw >= 0 && jw < win)
        ? (float)(0.5 * (1.0 - cospi(2.0 * jw / win))) : 0.0f;
  }
}

// Real DFT of TILE_F frames (frame f starts at xs[f * hop]) at this thread's
// KPT bins; bins >= n_freq compute bin 0 and must not be stored.
__device__ __forceinline__ void dft_tile(const float* xs, const float* ct,
                                         const float* st, const float* wn,
                                         int n_fft, int hop, int n_freq,
                                         float (&re)[KPT][TILE_F],
                                         float (&im)[KPT][TILE_F]) {
  int kk[KPT], idx[KPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int k = threadIdx.x + u * THREADS;
    kk[u] = k < n_freq ? k : 0;
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
}

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
  stage_tables(ct, st, wn, n_fft, win);
  __syncthreads();

  float re[KPT][TILE_F], im[KPT][TILE_F];
  dft_tile(xs, ct, st, wn, n_fft, hop, n_freq, re, im);
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

__global__ void __launch_bounds__(THREADS)
wave_to_spec_halo_kernel(const float* __restrict__ y, float* __restrict__ out,
                         int t_len, int n_frames, int n_fft, int hop, int win,
                         int n_freq) {
  extern __shared__ float smem[];
  const int span = (TILE_F - 1) * hop + n_fft;
  float* xs = smem;
  float* ct = xs + span;
  float* st = ct + n_fft;
  float* wn = st + n_fft;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TILE_F;
  const float* yb = y + (long long)b * t_len;

  for (int i = threadIdx.x; i < span; i += THREADS) {
    const int s = p0 * hop + i;  // past the end only for frames not stored
    xs[i] = s < t_len ? yb[s] : 0.0f;
  }
  stage_tables(ct, st, wn, n_fft, win);
  __syncthreads();

  float re[KPT][TILE_F], im[KPT][TILE_F];
  dft_tile(xs, ct, st, wn, n_fft, hop, n_freq, re, im);

#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    const int k = threadIdx.x + u * THREADS;
    if (k >= n_freq) continue;
#pragma unroll
    for (int f = 0; f < TILE_F; ++f) {
      const int p = p0 + f;
      if (p < n_frames)
        out[((long long)b * n_frames + p) * n_freq + k] =
            sqrtf(re[u][f] * re[u][f] + im[u][f] * im[u][f] + 1e-6f);
    }
  }
}

// Dynamic shared memory of both kernels: the wave window plus three tables.
size_t smem_bytes(int n_fft, int hop) {
  return sizeof(float) * (size_t)((TILE_F - 1) * hop + n_fft + 3 * n_fft);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int qvc_wave_to_mel(const void* y, const void* mel_fb,
                               const void* mel_range, void* out, int batch,
                               int t_len, int n_frames, int n_fft, int hop,
                               int win, int n_freq, int n_mels, void* stream) {
  const size_t smem = smem_bytes(n_fft, hop);
  if (n_freq > KPT * THREADS ||
      sizeof(float) * (size_t)TILE_F * n_freq > smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(wave_to_mel_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_frames + TILE_F - 1) / TILE_F, batch);
  wave_to_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)mel_fb, (const int*)mel_range,
      (float*)out, t_len, n_frames, n_fft, hop, win, n_freq, n_mels);
  return (int)cudaGetLastError();
}

extern "C" int qvc_wave_to_spec_halo(const void* y, void* out, int batch,
                                     int t_len, int n_frames, int n_fft,
                                     int hop, int win, int n_freq,
                                     void* stream) {
  const size_t smem = smem_bytes(n_fft, hop);
  if (n_freq > KPT * THREADS) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(wave_to_spec_halo_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_frames + TILE_F - 1) / TILE_F, batch);
  wave_to_spec_halo_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (float*)out, t_len, n_frames, n_fft, hop, win, n_freq);
  return (int)cudaGetLastError();
}
