// Log-mel for Hopper (sm_90a) as a real FFT, float32 throughout: the FFT
// body of the three log-mel tiers.
//
// Replaces, on the card, the TPU kernels audax/ops/pallas_mel.py:_kernel
// (fused_logmel_frames, K5: any spectrogram power != 2) for power-of-two
// n_fft from 256 to 2048, and, at power 2, _kernel_overlap (log_mel_overlap,
// K1) and _kernel_packed (fused_logmel_packed, K4) for those n_fft and
// Whisper's 400; csrc/log_mel_overlap.cu and csrc/log_mel_direct.cu keep
// every other n_fft (ops/fused_mel.py:BODIES routes). For each frame x of
// n_fft samples (read in place from the padded signal) it computes
//
//   X = rfft(w * x)                          w [n_fft]: the centre-padded Hann
//   p = (sqrt(max(Re X^2 + Im X^2, 0)))^power      (power 2: Re^2 + Im^2)
//   mel[m] = sum_{k in [lo_m, hi_m)} fb[k, m] p[k]
//   out = log(mel + 1e-6)  or  log10(max(mel, 1e-10))
//
// where [lo_m, hi_m) holds every non-zero of filterbank column m (computed
// on the host from the fb passed; a dense fb is one range [0, F)).
//
// What bounds it on this card: a 1024-point real FFT is ~25 k operations a
// frame against ~2.1 M for the direct DFT, and the triangular filterbank
// touches each bin at most twice. At UrbanSound's magnitude batch (64 clips
// of 4 s, 32,064 frames) that is ~1 GFLOP against 16 MB of signal in and
// 16 MB of mel out: ~17 us of float32 work and ~10 us of memory, so
// neither dominates by much, and the work that remains is the FFT's data
// movement between lanes. Whisper's 30 s window (3,001 frames of 400) is
// ~30 MFLOP a clip against 1.9 MB in and 1 MB out (80 bands): bytes bound
// it there.
//
// Design: 8 frames per block of 8 warps, one warp a frame (8 frames keep
// shared memory at ~50 KB, so four blocks -- 32 warps -- share an SM; 16
// or 32 frames a block, in fewer blocks, ran slower on the card). The
// n_fft real samples of a frame are taken as L = n_fft / 2 complex values
// z[m] = x[2m] + i x[2m+1], and the warp runs the L-point complex FFT in
// registers, as a four-step FFT with L = P * LANES: lane j holds
// z[j + LANES p] for p < P (consecutive lanes read consecutive samples, so
// overlapping frames come from L1/L2), runs a P-point radix-2 DFT over p in
// registers, multiplies by the twiddles W_L^(j k2), and runs a LANES-point
// DFT across the lanes by shuffles (no shared memory):
//   * a power of two: LANES = 32, five radix-2 stages of xor shuffles;
//   * n_fft 400: L = 200 = 8 * 25, LANES = 25, two radix-5 stages. Lane
//     l = u + 5 v first takes the 5-point DFT over v' of lanes u + 5 v',
//     keeps output v and multiplies it by W_25^(u v); then the 5-point DFT
//     over u' of lanes u' + 5 v, keeping output u, so lane l ends up with
//     k1 = v + 5 u (base-5 digits reversed). Each output is a sum of five
//     shuffled values by the lane's own roots W_5^(v' v) (W_5^(u' u)),
//     read once, before the frames, from the float64-rounded table. Lanes
//     25-31 hold no point: they run every shuffle (full mask), carry zeros
//     (zero roots) and write nothing.
// The spectrum goes once through shared memory (skewed by one slot per 32,
// free of bank conflicts) for the real split
//   X[k] = E[k] + W_N^k O[k],  E = (Z[k] + conj Z[L-k]) / 2,
//                              O = (Z[k] - conj Z[L-k]) / 2i,   k <= L,
// and |X|^power lands in an [8 frames][F] tile (F odd: conflict-free by
// frame). Then each group of 8 lanes takes the 8 frames of one mel band,
// each warp 4 bands at a time: a band sums its own bin range, its weight
// read once for the 8 frames (one broadcast load), and the log runs in
// registers. The [8, M] tile leaves through shared memory in coalesced
// rows: nothing but the output goes back to device memory. The twiddles
// are a table the host computes in float64 and rounds once to float32
// (ops/mel.py:fft_twiddles, fft_twiddles_400); the FFT's rounding grows
// as log n_fft, against n_fft for the direct sum. Samples are read as
// scalars, so a frame may start at any sample (an odd hop).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FRAMES = 8;             // frames per block: one per warp
constexpr int PER_WARP = FRAMES / WARPS;
constexpr int MEL_LANES = 32 / FRAMES;  // bands a warp takes at once
constexpr int RADIX = 5;              // of n_fft 400's lane stages

__host__ __device__ constexpr int skewed(int n) { return n + (n >> 5); }

// lanes that hold points: 32 for a power-of-two n_fft, 25 for 400
__host__ __device__ constexpr int lanes_of(int n_fft) {
  return (n_fft & (n_fft - 1)) ? 25 : 32;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// floats of shared memory: the power tile, and (one after the other) the
// warps' spectra and the output tile
__host__ __device__ constexpr int smem_floats(int n_fft, int n_mels) {
  return FRAMES * (n_fft / 2 + 1) +
         imax(WARPS * 2 * skewed(n_fft / 2), FRAMES * (n_mels | 1));
}

__device__ __forceinline__ void cmul(float& re, float& im, float2 w) {
  const float r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

template <int P>
__device__ __forceinline__ int bitrev(int i) {
  int r = 0;
#pragma unroll
  for (int b = 1; b < P; b <<= 1) r = (r << 1) | ((i & b) ? 1 : 0);
  return r;
}

// W_N^k for any k >= 0 from the table's W_N^0 .. W_N^(N/2)
template <int N>
__device__ __forceinline__ float2 root(const float2* tw_post, int k) {
  k %= N;
  if (k <= N / 2) return __ldg(tw_post + k);
  const float2 w = __ldg(tw_post + N - k);
  return make_float2(w.x, -w.y);
}

// tw: [L] W_L^(j k2) at k2 * LANES + j, then [L + 1] W_N^k (cos, -sin)
template <int N>
__global__ void __launch_bounds__(THREADS)
log_mel_fft_kernel(const float* __restrict__ sig, long long clip_stride,
                   int hop, int n_frames, long long n_rows,
                   const float* __restrict__ window,
                   const float2* __restrict__ tw, const float* __restrict__ fb,
                   const int2* __restrict__ ranges, float* __restrict__ out,
                   int nm, int log_mode, float power) {
  constexpr int L = N / 2;              // complex points
  constexpr int F = L + 1;              // bins
  constexpr int LANES = lanes_of(N);    // lanes that hold points
  constexpr int P = L / LANES;          // points per lane
  static_assert(P * LANES == L && (P & (P - 1)) == 0,
                "L = P * LANES with P a power of two");
  static_assert(LANES == 32 || LANES == RADIX * RADIX, "lane stages");
  constexpr int ZS = skewed(L);
  extern __shared__ float smem[];
  float* pw = smem;                                   // [FRAMES][F]
  float* zr = pw + FRAMES * F + (threadIdx.x / 32) * 2 * ZS;  // this warp's
  float* zi = zr + ZS;
  float* os = pw + FRAMES * F;                        // [FRAMES][nm | 1]
  const float2* tw_lane = tw;
  const float2* tw_post = tw + L;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool holds = LANES == 32 || lane < LANES;
  const long long f0 = (long long)blockIdx.x * FRAMES;

  // radix 2: the twiddles of the five lane stages (h = 16 .. 1),
  // W_{2h}^(lane mod h) for the upper lane of a pair, 1 for the lower; and
  // the sign of own. Radix 5 (lane = u + 5 v): stage 1's roots W_5^(v' v)
  // and twiddle W_25^(u v), stage 2's roots W_5^(u' u); zero past lane 24.
  float2 wl[5], r1[RADIX], r2[RADIX], t1;
  float sg[5];
  const int u = lane % RADIX, v = lane / RADIX;
  if constexpr (LANES == 32) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int h = 16 >> s;
      const bool up = lane & h;
      wl[s] = up ? __ldg(tw_post + (lane % h) * (N / (2 * h)))
                 : make_float2(1.f, 0.f);
      sg[s] = up ? -1.f : 1.f;
    }
  } else {
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int s = 0; s < RADIX; ++s) {
      r1[s] = holds ? root<N>(tw_post, N / RADIX * (s * v % RADIX)) : zero;
      r2[s] = holds ? root<N>(tw_post, N / RADIX * (s * u % RADIX)) : zero;
    }
    t1 = holds ? root<N>(tw_post, N / (RADIX * RADIX) * (u * v)) : zero;
  }
  // lane l ends up holding k1 = bitrev5(l), or v + 5 u
  const int k1 = LANES == 32 ? (int)(__brev(lane) >> 27) : v + RADIX * u;

  for (int n = 0; n < PER_WARP; ++n) {
    const int fl = warp * PER_WARP + n;
    const long long f = f0 + fl;
    if (f >= n_rows) break;
    const float* x = sig + (f / n_frames) * clip_stride +
                     (long long)(f % n_frames) * hop;
    float re[P], im[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = 2 * (lane + LANES * p);
      re[p] = holds ? x[i] * __ldg(window + i) : 0.f;
      im[p] = holds ? x[i + 1] * __ldg(window + i + 1) : 0.f;
    }
    // P-point DFT over p, radix-2 decimation in frequency: register i ends
    // up holding bin bitrev(i)
#pragma unroll
    for (int st = 1; st < P; st <<= 1) {
      const int h = P / (2 * st);
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (!(i & h)) {
          const float ar = re[i], ai = im[i];
          re[i] = ar + re[i + h];
          im[i] = ai + im[i + h];
          re[i + h] = ar - re[i + h];
          im[i + h] = ai - im[i + h];
          if (i % h) cmul(re[i + h], im[i + h],
                          __ldg(tw_post + (i % h) * (N / (2 * h))));
        }
    }
#pragma unroll
    for (int i = 1; i < P; ++i)
      cmul(re[i], im[i],
           __ldg(tw_lane + bitrev<P>(i) * LANES + (holds ? lane : 0)));
    // LANES-point DFT across the lanes
    if constexpr (LANES == 32) {
      // radix-2 decimation in frequency
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int h = 16 >> s;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float orr = __shfl_xor_sync(~0u, re[i], h);
          const float oi = __shfl_xor_sync(~0u, im[i], h);
          re[i] = fmaf(sg[s], re[i], orr);
          im[i] = fmaf(sg[s], im[i], oi);
          cmul(re[i], im[i], wl[s]);
        }
      }
    } else {
      // two radix-5 stages, each output a sum of five shuffled values
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int s = 0; s < RADIX; ++s) {
          const float xr = __shfl_sync(~0u, re[i], u + RADIX * s);
          const float xi = __shfl_sync(~0u, im[i], u + RADIX * s);
          ar += xr * r1[s].x - xi * r1[s].y;
          ai += xr * r1[s].y + xi * r1[s].x;
        }
        re[i] = ar;
        im[i] = ai;
        cmul(re[i], im[i], t1);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int s = 0; s < RADIX; ++s) {
          const int src = (RADIX * v + s) & 31;
          const float xr = __shfl_sync(~0u, re[i], src);
          const float xi = __shfl_sync(~0u, im[i], src);
          ar += xr * r2[s].x - xi * r2[s].y;
          ai += xr * r2[s].y + xi * r2[s].x;
        }
        re[i] = ar;
        im[i] = ai;
      }
    }
    if (holds) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int k = skewed(bitrev<P>(i) + P * k1);
        zr[k] = re[i];
        zi[k] = im[i];
      }
    }
    __syncwarp();
    // the real split, |X|^power into the frame's row of the power tile
    for (int k = lane; k <= L; k += 32) {
      const int a = skewed(k == L ? 0 : k), b = skewed(k == 0 ? 0 : L - k);
      const float ar = zr[a], ai = zi[a], br = zr[b], bi = zi[b];
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float orr = 0.5f * (ai + bi), oi = -0.5f * (ar - br);
      const float2 w = __ldg(tw_post + k);
      const float xr = er + orr * w.x - oi * w.y;
      const float xi = ei + orr * w.y + oi * w.x;
      float p = xr * xr + xi * xi;
      if (power != 2.f) {
        p = sqrtf(fmaxf(p, 0.f));
        if (power != 1.f) p = powf(p, power);
      }
      pw[fl * F + k] = p;
    }
    __syncwarp();
  }
  __syncthreads();

  // mel bands: lane % FRAMES = frame, MEL_LANES bands at once per warp
  const int ms = nm | 1;
  const int fr = lane % FRAMES;
  if (f0 + fr < n_rows)
    for (int m = warp * MEL_LANES + lane / FRAMES; m < nm;
         m += WARPS * MEL_LANES) {
      const int2 r = __ldg(ranges + m);
      const float* row = pw + fr * F;
      float acc = 0.f;
      for (int k = max(r.x, 0); k < min(r.y, F); ++k)
        acc = fmaf(__ldg(fb + (long long)k * nm + m), row[k], acc);
      os[fr * ms + m] = log_mode == 0 ? logf(acc + 1e-6f)
                                      : log10f(fmaxf(acc, 1e-10f));
    }
  __syncthreads();
  const long long rows = n_rows - f0 < FRAMES ? n_rows - f0 : FRAMES;
  float* og = out + f0 * nm;
  for (int i = threadIdx.x; i < rows * nm; i += THREADS)
    og[i] = os[(i / nm) * ms + i % nm];
}

template <int N>
int launch(const float* sig, long long clip_stride, int hop, int n_frames,
           long long n_rows, const float* window, const float2* tw,
           const float* fb, const int2* ranges, float* out, int nm,
           int log_mode, float power, cudaStream_t stream) {
  if (nm < 1 || nm > 8192) return (int)cudaErrorInvalidValue;
  const int smem = 4 * smem_floats(N, nm);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = log_mel_fft_kernel<N>;
  // raised once per instantiation and tile size, on its first (eager)
  // launch: a later call captured into a CUDA graph records the launch alone
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const long long blocks = (n_rows + FRAMES - 1) / FRAMES;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      sig, clip_stride, hop, n_frames, n_rows, window, tw, fb, ranges, out,
      nm, log_mode, power);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames: frame t of clip b starts at sig + b * clip_stride + t * hop
// (n_frames frames a clip, n_rows = clips * n_frames in all; unit sample
// stride). window [n_fft], tw [(n_fft + 1) * 2] (the layout above), fb
// [n_fft / 2 + 1, n_mels], ranges [n_mels, 2] int32, out [n_rows, n_mels];
// log_mode 0 = log(x + 1e-6), 1 = log10(max(x, 1e-10)). n_fft is one of the
// AUDAX_FFT sizes below. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another n_fft, or a tile past shared memory).
int log_mel_fft_f32(const float* sig, long long clip_stride, int hop,
                    int n_frames, long long n_rows, int n_fft,
                    const float* window, const float* tw, const float* fb,
                    const int* ranges, float* out, int n_mels, int log_mode,
                    float power, void* stream) {
  const float2* t2 = reinterpret_cast<const float2*>(tw);
  const int2* r2 = reinterpret_cast<const int2*>(ranges);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
#define AUDAX_FFT(N)                                                       \
  case N:                                                                  \
    return launch<N>(sig, clip_stride, hop, n_frames, n_rows, window, t2, \
                     fb, r2, out, n_mels, log_mode, power, s);
    AUDAX_FFT(256)
    AUDAX_FFT(400)
    AUDAX_FFT(512)
    AUDAX_FFT(1024)
    AUDAX_FFT(2048)
#undef AUDAX_FFT
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
