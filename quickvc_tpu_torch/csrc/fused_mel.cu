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
// K1: a dense DFT. A frame costs 2*n_fft*(n_fft+2) flops (plus
// 2*n_freq*n_mels of mel projection), about 3.3 MFLOP at n_fft 1280, against
// ~5 KB of wave read, so the 67 TFLOP/s float32 FMA rate bounds it (the DFT
// must be full float32: TF32 or bf16 multiplicands cost ~1% of spectrogram
// accuracy, the fault the round-5 TPU gate found at fused_mel.py:110-116).
// One block per (tile of TILE_F frames, batch item) stages the tile's wave
// window in shared memory (reflect pad by index reflection) and a one-period
// cos/sin table indexed by (n*k mod n_fft); the window is folded into the
// twiddle once per (n, bin) and shared by all TILE_F frames. The magnitudes
// go through shared memory, and each (frame, mel) pair sums only its
// filter's nonzero band of the filterbank, then takes the log.
//
// K4: a real FFT, so the bytes bound it (the wave in, the spectrogram out:
// 63 MB at the training batch (32, 164800) -> (32, 512, 641), against ~0.6
// GFLOP). One block of SPEC_THREADS takes SPEC_TILE_F frames of one batch
// row and stages their wave span once in shared memory; the spans of
// neighbouring blocks overlap, and L2 (50 MB) can hold the batch's whole
// 21 MB wave for those re-reads. A real frame of
// n_fft samples, windowed as it is read, becomes an n_fft/2-point complex
// FFT (even samples as re, odd as im), run as Stockham (autosort) passes
// between two shared-memory buffers (re and im apart, one float of padding
// every 32 against the power-of-two strides). A pass is one radix: 5, or 16,
// 8, 4 or 2, where 16 and 8 are two radix-4/2 stages in registers, so
// n_fft 1280 takes 3 passes (5, 16, 8) where radix 4/2 alone takes 5. The
// plan is compiled per n_fft (make_plan; the host builds the same one,
// hands it over and is refused if it differs), so every index is a
// constant division. A last pass recombines Z[k] and conj(Z[n/2-k]) with
// exp(-2 pi i k / n_fft) into the n_fft/2+1 bins (bins 0 and n_fft/2 apart,
// exactly) and writes the tile's frames x bins as one contiguous span with
// scalar stores (a 641-float row is not 16-byte aligned). Twiddles between
// passes and for the recombination, and the window, come from one float32
// table the host rounds once from float64 (ops/fused_mel.py:spec_fft_table):
// per pass exp(-2 pi i k r / (Ns R)) as (Ns, R-1) complex, then the
// recombination twiddles, then the window. n_fft is 2^a * 5^b, b <= 1, 256
// to 2048; the host refuses any other.

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

// 2 frames to a block of 128 threads (64 threads a frame, 21 KB of shared
// memory at n_fft 1280): the fastest block shape tried on an H100, from 2 to
// 16 frames and 128 to 512 threads; 64 threads a frame did best throughout
constexpr int SPEC_TILE_F = 2;
constexpr int SPEC_THREADS = 128;

// The radix plan of an m-point complex FFT, one Stockham pass a radix: a 5
// first where m has one, then m's power of two 2^e in ceil(e/4) passes of
// 16, 8, 4 or 2, the larger first (ops/fused_mel.py:fft_plan, the same rule).
struct Plan {
  int n;
  int r[4];
};

constexpr Plan make_plan(int m) {
  Plan p{0, {1, 1, 1, 1}};
  if (m % 5 == 0) {
    p.r[p.n++] = 5;
    m /= 5;
  }
  int e = 0;
  while (m > 1) {
    m /= 2;
    ++e;
  }
  const int passes = (e + 3) / 4;
  for (int i = 0; i < passes; ++i) p.r[p.n++] = 1 << ((e + passes - 1 - i) / passes);
  return p;
}

constexpr int plan_word(const Plan& p) {  // eight bits a pass, the first lowest
  int w = 0;
  for (int i = 0; i < p.n; ++i) w |= p.r[i] << (8 * i);
  return w;
}

template <int M>
struct Spec {
  static constexpr Plan plan = make_plan(M);
  static constexpr int LDF = (M + ((M - 1) >> 5)) | 1;  // padded frame stride, odd
  // points before pass s: the product of the earlier radices
  __host__ __device__ static constexpr int ns(int s) {
    return s == 0 ? 1 : ns(s - 1) * plan.r[s - 1];
  }
};

// a frame buffer's index with one float of padding every 32
__device__ __forceinline__ int spad(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i e / 16) for e = 0..15, rounded once from the exact values
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f;
  constexpr float h = 0.707106781186547524f;
  constexpr float cs[16] = {1.0f, c1,  h,   s1,  0.0f, -s1, -h, -c1,
                            -1.0f, -c1, -h, -s1, 0.0f, s1,  h,  c1};
  return make_float2(cs[e & 15], -cs[(e + 12) & 15]);
}

// v * exp(-2 pi i e / R) for a compile-time e and R in {4, 8, 16}
template <int R>
__device__ __forceinline__ float2 rot(float2 v, int e) {
  const int q = (e % R) * (16 / R);
  if (q == 0) return v;
  if (q == 4) return make_float2(v.y, -v.x);
  if (q == 8) return make_float2(-v.x, -v.y);
  if (q == 12) return make_float2(-v.y, v.x);
  return cmul(v, w16(q));
}

// Forward DFT of R points in registers, exp(-2 pi i r q / R).
template <int R>
struct Dft;

template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float2 (&v)[2]) {
    const float2 a = v[0], b = v[1];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[1] = make_float2(a.x - b.x, a.y - b.y);
  }
};

template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float2 (&v)[4]) {
    const float2 s0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
    const float2 d0 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
    const float2 s1 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
    const float2 d1 = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);  // -i d1 = (d1.y, -d1.x)
    v[0] = make_float2(s0.x + s1.x, s0.y + s1.y);
    v[2] = make_float2(s0.x - s1.x, s0.y - s1.y);
    v[1] = make_float2(d0.x + d1.y, d0.y - d1.x);
    v[3] = make_float2(d0.x - d1.y, d0.y + d1.x);
  }
};

template <>
struct Dft<5> {
  static __device__ __forceinline__ void run(float2 (&v)[5]) {
    constexpr float c1 = 0.309016994374947424f;   // cos(2 pi / 5)
    constexpr float c2 = -0.809016994374947424f;  // cos(4 pi / 5)
    constexpr float s1 = 0.951056516295153572f;   // sin(2 pi / 5)
    constexpr float s2 = 0.587785252292473129f;   // sin(4 pi / 5)
    const float2 t1 = make_float2(v[1].x + v[4].x, v[1].y + v[4].y);
    const float2 t2 = make_float2(v[2].x + v[3].x, v[2].y + v[3].y);
    const float2 t3 = make_float2(v[1].x - v[4].x, v[1].y - v[4].y);
    const float2 t4 = make_float2(v[2].x - v[3].x, v[2].y - v[3].y);
    const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
    const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
    // -i * u = (u.y, -u.x)
    const float2 u1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
    const float2 u2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
    v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
    v[1] = make_float2(a1.x + u1.y, a1.y - u1.x);
    v[4] = make_float2(a1.x - u1.y, a1.y + u1.x);
    v[2] = make_float2(a2.x + u2.y, a2.y - u2.x);
    v[3] = make_float2(a2.x - u2.y, a2.y + u2.x);
  }
};

// R = 4 * R2 (8 or 16): radix-4 butterflies over the R2 interleaved columns,
// the twiddles exp(-2 pi i n2 k1 / R), then radix-R2 butterflies; output k1
// + 4 k2.
template <int R>
struct Dft {
  static constexpr int R2 = R / 4;
  static __device__ __forceinline__ void run(float2 (&v)[R]) {
    float2 t[R2][4];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) {
      float2 u[4];
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) u[n1] = v[R2 * n1 + n2];
      Dft<4>::run(u);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) t[n2][k1] = rot<R>(u[k1], n2 * k1);
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 u[R2];
#pragma unroll
      for (int n2 = 0; n2 < R2; ++n2) u[n2] = t[n2][k1];
      Dft<R2>::run(u);
#pragma unroll
      for (int k2 = 0; k2 < R2; ++k2) v[k1 + 4 * k2] = u[k2];
    }
  }
};

// One Stockham pass S of the plan over the block's SPEC_TILE_F frames of M
// complex points, radix R after NS points: butterfly j < M/R of a frame takes
// points j + r*M/R, twiddled by exp(-2 pi i k r / (NS R)) with k = j mod NS,
// and writes point (j - k)*R + k + r*NS. Pass 0 reads the points from the
// staged wave instead (frame f at xs[f*hop], even samples re, odd im, times
// the window; NS = 1, so no twiddle).
template <int M, int S>
__device__ __forceinline__ void spec_pass(const float* __restrict__ src, float* __restrict__ dst,
                                          const float2* __restrict__ tw,
                                          const float* __restrict__ wn, int hop) {
  constexpr int R = Spec<M>::plan.r[S];
  constexpr int NS = Spec<M>::ns(S);
  constexpr int NB = M / R;
  constexpr int LDF = Spec<M>::LDF;
  float* dre = dst;
  float* dim = dst + SPEC_TILE_F * LDF;
  for (int g = threadIdx.x; g < SPEC_TILE_F * NB; g += SPEC_THREADS) {
    const int f = g / NB;
    const int j = g - f * NB;
    const int k = j % NS;
    float2 v[R];
    if constexpr (S == 0) {
      const float* x = src + f * hop;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = 2 * (j + r * NB);
        const float2 w = __ldg(reinterpret_cast<const float2*>(wn + n));
        v[r] = make_float2(x[n] * w.x, x[n + 1] * w.y);
      }
    } else {
      const float* sre = src + f * LDF;
      const float* sim = sre + SPEC_TILE_F * LDF;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = spad(j + r * NB);
        v[r] = make_float2(sre[i], sim[i]);
      }
      const float2* twk = tw + k * (R - 1) - 1;
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(twk + r));
    }
    Dft<R>::run(v);
    const int o = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = f * LDF + spad(o + r * NS);
      dre[i] = v[r].x;
      dim[i] = v[r].y;
    }
  }
}

// Pass S and the ones after it. Buffers: pass 0 reads the wave (xs) and
// writes b0; pass s > 0 reads b0 / b1 and writes b1 / b0 (b1 shares xs's
// space: the wave is no longer read). Returns the buffer of the last pass.
template <int M, int S>
__device__ __forceinline__ const float* spec_passes(const float* xs, float* b0, float* b1,
                                                    const float2* tw, const float* wn,
                                                    int hop) {
  if constexpr (S == Spec<M>::plan.n) {
    return (S & 1) ? b0 : b1;
  } else {
    spec_pass<M, S>(S == 0 ? xs : (S & 1) ? b0 : b1, (S & 1) ? b1 : b0, tw, wn, hop);
    __syncthreads();
    return spec_passes<M, S + 1>(xs, b0, b1, tw + Spec<M>::ns(S) * (Spec<M>::plan.r[S] - 1),
                                 wn, hop);
  }
}

template <int M>
size_t spec_smem_bytes(int hop) {  // xs / b1 shared, then b0
  const size_t span = (size_t)(SPEC_TILE_F - 1) * hop + 2 * M;
  const size_t frames = 2 * (size_t)SPEC_TILE_F * Spec<M>::LDF;
  return sizeof(float) * ((span > frames ? span : frames) + frames);
}

template <int M>
__global__ void __launch_bounds__(SPEC_THREADS)
wave_to_spec_halo_kernel(const float* __restrict__ y, const float* __restrict__ table,
                         float* __restrict__ out, int t_len, int n_frames, int hop) {
  constexpr int N_FREQ = M + 1;
  constexpr int LDF = Spec<M>::LDF;
  extern __shared__ float smem[];
  const int span = (SPEC_TILE_F - 1) * hop + 2 * M;
  const int frames = 2 * SPEC_TILE_F * LDF;
  float* xs = smem;                                  // the tile's wave span
  float* b1 = smem;                                  // later: frame buffer, re | im
  float* b0 = smem + (span > frames ? span : frames);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * SPEC_TILE_F;
  const float* yb = y + (long long)b * t_len + (long long)p0 * hop;
  const long long left = t_len - (long long)p0 * hop;

  for (int i = threadIdx.x; i < span; i += SPEC_THREADS)
    xs[i] = i < left ? yb[i] : 0.0f;  // past the end only for frames not stored
  __syncthreads();

  // table: per pass (ns, R-1) complex twiddles (M-1 in all), then N_FREQ
  // recombination twiddles, then the window (2M floats)
  const float2* tw = reinterpret_cast<const float2*>(table);
  const float* zre = spec_passes<M, 0>(xs, b0, b1, tw, table + 2 * (M - 1) + 2 * N_FREQ, hop);
  const float* zim = zre + SPEC_TILE_F * LDF;
  const float2* rc = tw + (M - 1);

  // X[k] = (Z[k] + conj Z[M-k]) / 2 - i/2 e^{-2 pi i k/(2M)} (Z[k] - conj Z[M-k])
  const int valid = min(SPEC_TILE_F, n_frames - p0) * N_FREQ;
  float* ob = out + ((long long)b * n_frames + p0) * N_FREQ;
  for (int g = threadIdx.x; g < valid; g += SPEC_THREADS) {
    const int f = g / N_FREQ;
    const int k = g - f * N_FREQ;
    const int base = f * LDF;
    float re, im;
    if (k == 0 || k == M) {
      const float a = zre[base], c = zim[base];
      re = k == 0 ? a + c : a - c;
      im = 0.0f;
    } else {
      const int i = base + spad(k), ic = base + spad(M - k);
      const float2 zk = make_float2(zre[i], zim[i]);
      const float2 zc = make_float2(zre[ic], -zim[ic]);
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
      const float2 o = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));
      const float2 t = cmul(__ldg(rc + k), o);
      re = e.x + t.x;
      im = e.y + t.y;
    }
    ob[g] = sqrtf(re * re + im * im + 1e-6f);
  }
}

// Dynamic shared memory of K1: the wave window plus three tables.
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

template <int M>
cudaError_t launch_spec(const float* y, const float* table, float* out, int batch, int t_len,
                        int n_frames, int hop, int plan, cudaStream_t stream) {
  if (plan != plan_word(Spec<M>::plan)) return cudaErrorInvalidValue;
  const size_t smem = spec_smem_bytes<M>(hop);
  cudaError_t e = allow_smem(wave_to_spec_halo_kernel<M>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n_frames + SPEC_TILE_F - 1) / SPEC_TILE_F, batch);
  wave_to_spec_halo_kernel<M><<<grid, SPEC_THREADS, smem, stream>>>(y, table, out, t_len,
                                                                     n_frames, hop);
  return cudaGetLastError();
}

// K4: n_fft = 2^a * 5^b (b <= 1), 256..2048, hop <= n_fft; plan = the host's
// radices of the n_fft/2-point FFT, eight bits a pass from the lowest, which
// must be the compiled plan; table as above.
extern "C" int qvc_wave_to_spec_halo(const void* y, const void* table, void* out,
                                     int batch, int t_len, int n_frames, int n_fft,
                                     int hop, int plan, void* stream) {
  if (hop < 1 || hop > n_fft) return (int)cudaErrorInvalidValue;
  const float* yf = (const float*)y;
  const float* tf = (const float*)table;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_fft) {
    case 256: return (int)launch_spec<128>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 320: return (int)launch_spec<160>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 512: return (int)launch_spec<256>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 640: return (int)launch_spec<320>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 1024: return (int)launch_spec<512>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 1280: return (int)launch_spec<640>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    case 2048: return (int)launch_spec<1024>(yf, tf, of, batch, t_len, n_frames, hop, plan, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
