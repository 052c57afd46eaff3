// Overlap-reuse log-mel for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel audax/ops/pallas_mel.py:_kernel_overlap (called by
// log_mel_overlap). It computes, for every frame t of a reflect-padded clip:
//
//   Z_b[k] = sum_{n<g} x[b*g + n] * (cos, -sin)(2 pi k n / N)      zoom-DFT
//   X_t[k] = sum_{j<NB} tw_j[k] * Z_{t*a + j}[k]                   recombine
//   W_t[k] = 0.5 X_t[k] - 0.25 (X_t[k-1] + X_t[k+1])               periodic Hann
//            with X_{-1} = conj(X_1), X_F = conj(X_{F-2})
//   mel_t[m] = sum_k |W_t[k]|^2 fb[k, m]
//   out = log(mel + 1e-6)   or   log10(max(mel, 1e-10))
//
// with g = gcd(n_fft, hop), NB = n_fft / g blocks per frame and a = hop / g
// blocks of advance per frame (Whisper: g=80, NB=5, a=2; UrbanSound v2:
// g=128, NB=8, a=1). The constants (dftc, dfts [g, F]; tw [2*NB, F];
// fb [F, M]) are the float32 roundings of the same float64 tables the JAX
// package uses (ops/mel.py:overlap_frontend_constants).
//
// What bounds it on this card: about 0.5 GFLOP of float32 work per 30 s
// chunk against 2 MB of signal in and 1 MB of mel out, so the card's float32
// rate outside the tensor cores (67 TFLOP/s) bounds it, not memory. The TPU
// ran the zoom-DFT and the mel projection on its matrix unit at HIGHEST
// precision; here they stay float32 FMAs on the CUDA cores, because TF32
// would lose the log-domain parity (the reference is exact float32).
//
// Design: one block per (clip, tile of TT frames). The tile's signal,
// including the NB-a blocks of halo the next tile also reads, is loaded
// once into shared memory straight from the padded clip -- no duplicated
// halo in device memory as the TPU's BlockSpec layout needed. Then four
// phases, each a loop over independent work items spread over all threads:
//   1. zoom-DFT: item (frequency k, chunk of ZB blocks). The ZB block
//      accumulators live in registers, so each basis value is read once per
//      chunk (coalesced over k) and each sample is a shared-memory broadcast.
//   2. recombination of the NB twiddled block spectra into frame spectra.
//   3. the 3-tap Hann and the power, with the conjugate-symmetric edges.
//   4. the mel projection (coalesced over m) and the log.
// Shared memory holds Z [NBLK, F] and X [TT, F] (real and imaginary); the
// power overwrites Z. The wrapper picks TT so a block fits in ~100 KB and
// two blocks share an SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ZB = 8;          // zoom-DFT blocks accumulated in registers
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
log_mel_overlap_kernel(const float* __restrict__ sig, long long n_pad,
                       int n_frames, int tile_t,
                       const float* __restrict__ dftc,
                       const float* __restrict__ dfts,
                       const float* __restrict__ tw,
                       const float* __restrict__ fb,
                       float* __restrict__ out,
                       int g, int nb, int adv, int nf, int nm, int log_mode) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile_t;
  const int tt = min(tile_t, n_frames - t0);          // frames in this tile
  const int nblk = (tt - 1) * adv + nb;                // blocks they span
  const int nchunk = (nblk + ZB - 1) / ZB;
  const int nblk_pad = nchunk * ZB;

  float* xs = smem;                                    // [nblk_pad * g]
  float* zr = xs + nblk_pad * g;                       // [nblk_pad * nf]
  float* zi = zr + nblk_pad * nf;
  float* xr = zi + nblk_pad * nf;                      // [tile_t * nf]
  float* xi = xr + tile_t * nf;
  float* pw = zr;                                      // power reuses Z

  // ---- load the tile's signal (zeros past the clip's padded end) -------
  const float* src = sig + (long long)b * n_pad;
  const long long s0 = (long long)t0 * adv * g;
  for (int i = threadIdx.x; i < nblk_pad * g; i += THREADS) {
    const long long s = s0 + i;
    xs[i] = (i < nblk * g && s < n_pad) ? src[s] : 0.f;
  }
  __syncthreads();

  // ---- 1. zoom-DFT of every block: Z_b[k] -------------------------------
  for (int item = threadIdx.x; item < nchunk * nf; item += THREADS) {
    const int k = item % nf;
    const int c0 = (item / nf) * ZB;
    float ar[ZB], ai[ZB];
#pragma unroll
    for (int j = 0; j < ZB; ++j) { ar[j] = 0.f; ai[j] = 0.f; }
    const float* xc = xs + c0 * g;
    for (int n = 0; n < g; ++n) {
      const float c = __ldg(dftc + n * nf + k);
      const float s = __ldg(dfts + n * nf + k);
#pragma unroll
      for (int j = 0; j < ZB; ++j) {
        const float x = xc[j * g + n];
        ar[j] = fmaf(x, c, ar[j]);
        ai[j] = fmaf(x, s, ai[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < ZB; ++j) {
      zr[(c0 + j) * nf + k] = ar[j];
      zi[(c0 + j) * nf + k] = ai[j];
    }
  }
  __syncthreads();

  // ---- 2. frames from twiddle-shifted block spectra ----------------------
  for (int item = threadIdx.x; item < tt * nf; item += THREADS) {
    const int k = item % nf;
    const int t = item / nf;
    float re = 0.f, im = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float c = __ldg(tw + j * nf + k);
      const float s = __ldg(tw + (nb + j) * nf + k);
      const float a_r = zr[(t * adv + j) * nf + k];
      const float a_i = zi[(t * adv + j) * nf + k];
      re = re + c * a_r - s * a_i;
      im = im + c * a_i + s * a_r;
    }
    xr[t * nf + k] = re;
    xi[t * nf + k] = im;
  }
  __syncthreads();

  // ---- 3. periodic Hann as a 3-tap spectral convolution, then |W|^2 ------
  for (int item = threadIdx.x; item < tt * nf; item += THREADS) {
    const int k = item % nf;
    const int t = item / nf;
    const float* rr = xr + t * nf;
    const float* ri = xi + t * nf;
    float lr, li, rgt_r, rgt_i;
    if (k == 0) { lr = rr[1]; li = -ri[1]; }           // X_{-1} = conj(X_1)
    else        { lr = rr[k - 1]; li = ri[k - 1]; }
    if (k == nf - 1) { rgt_r = rr[nf - 2]; rgt_i = -ri[nf - 2]; }
    else             { rgt_r = rr[k + 1]; rgt_i = ri[k + 1]; }
    const float wr = 0.5f * rr[k] - 0.25f * (lr + rgt_r);
    const float wi = 0.5f * ri[k] - 0.25f * (li + rgt_i);
    pw[t * nf + k] = wr * wr + wi * wi;
  }
  __syncthreads();

  // ---- 4. mel projection and log ----------------------------------------
  float* dst = out + ((long long)b * n_frames + t0) * nm;
  for (int item = threadIdx.x; item < tt * nm; item += THREADS) {
    const int m = item % nm;
    const int t = item / nm;
    const float* p = pw + t * nf;
    float acc = 0.f;
    for (int k = 0; k < nf; ++k) acc = fmaf(p[k], __ldg(fb + k * nm + m), acc);
    dst[t * nm + m] = log_mode == 0 ? logf(acc + 1e-6f)
                                    : log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" {

// Shared memory bytes one block of tile_t frames needs.
long long log_mel_overlap_smem_bytes(int tile_t, int g, int nb, int adv,
                                     int nf) {
  const int nblk = (tile_t - 1) * adv + nb;
  const int nblk_pad = (nblk + ZB - 1) / ZB * ZB;
  return 4LL * ((long long)nblk_pad * g + 2LL * nblk_pad * nf
                + 2LL * tile_t * nf);
}

// sig [batch, n_pad] float32 (already reflect-padded); out [batch,
// n_frames, nm] float32. log_mode 0 = log(x + 1e-6), 1 = log10(max(x,
// 1e-10)). Returns cudaGetLastError() after the launch.
int log_mel_overlap_f32(const float* sig, int batch, long long n_pad,
                        int n_frames, int tile_t, const float* dftc,
                        const float* dfts, const float* tw, const float* fb,
                        float* out, int g, int nb, int adv, int nf, int nm,
                        int log_mode, void* stream) {
  const long long smem = log_mel_overlap_smem_bytes(tile_t, g, nb, adv, nf);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + tile_t - 1) / tile_t, batch);
  log_mel_overlap_kernel<<<grid, THREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(
      sig, n_pad, n_frames, tile_t, dftc, dfts, tw, fb, out, g, nb, adv, nf,
      nm, log_mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
