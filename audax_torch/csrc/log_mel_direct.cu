// Direct log-mel for Hopper (sm_90a), float32 throughout: kernels K4 and K5.
//
// Replaces two TPU kernels of audax/ops/pallas_mel.py:
//   K4  _kernel_packed (fused_logmel_packed), the tier for power-2 configs
//       the overlap kernel does not cover:
//         ri  = frames @ dft          dft [n_fft, W], W = 2 * (n_fft / 2)
//         mel = (ri * ri) @ fb2       fb2 [W, M] routes re^2 and im^2 of a bin
//   K5  _kernel (fused_logmel_frames), the tier for any power != 2:
//         re = frames @ cos ; im = frames @ sin        cos, sin [n_fft, F]
//         p  = (sqrt(max(re^2 + im^2, 0)))^power       (power 2: re^2 + im^2)
//         mel = p @ fb                                 fb [F, M], F odd
//   then out = log(mel + 1e-6)  or  log10(max(mel, 1e-10)).
// The window is folded into the bases (ops/mel.py), so frames are raw
// samples. The constants are the float32 roundings of the float64 tables the
// JAX package uses.
//
// What bounds it on this card: 2 * N * n_fft * (W + M) operations (K4) or
// 2 * N * (2 * n_fft * F + F * M) (K5) on N frames, against 4 bytes per
// signal sample in and per mel value out. For every real config that is
// hundreds of operations per byte, so the float32 rate outside the tensor
// cores (67 TFLOP/s) bounds it, not memory. The TPU ran both products at
// HIGHEST precision; here they are float32 FMAs on the CUDA cores, because
// near-silent bins come out of cancelling sums and TF32's 10-bit mantissa
// would break the log-domain parity. K5 at n_fft 256, 400, 512, 1024 and
// 2048 moved to the FFT body, csrc/log_mel_fft.cu (ops/direct_mel.py:
// fft_applicable routes it); this body keeps K5 at every other n_fft (1000
// among them) and K4 wherever the FFT body is not built.
//
// Design: one block of 256 threads owns 64 frames and loops over column
// tiles of the basis (K4: 64 packed columns; K5: 32 bins, their cos and sin
// columns interleaved). For each tile it accumulates frames @ basis over
// n_fft in slices of 32, both operands staged in shared memory, 4 x 4
// outputs per thread in registers; squares them in registers (K5: re and
// im of a bin sit in one thread, so the power is taken there too); writes
// the power tile to shared memory with the tile's filterbank rows; and adds
// power @ fb into a [64, M] mel accumulator held in registers (4 rows x
// M / 16 columns per thread). The log is taken once, at the end. Nothing
// but the output goes back to device memory. One launch holds at most 256
// bands; above that the wrapper launches once per chunk of 256 bands
// (ops/direct_mel.py:band_chunks), each chunk writing its own columns of
// the output (row stride ld) and computing the spectrum again.
//
// Frames are read in place from the padded signal: frame t of clip b starts
// at sig + b * clip_stride + t * hop, so the [N, n_fft] frame matrix is never
// materialised. Ragged edges (the last frames, n_fft not a multiple of 32,
// K5's odd F, M not a multiple of 16) are bound-checked and read as zeros;
// the constants are never padded in device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;        // frames per block
constexpr int COLS = 64;        // basis columns per tile
constexpr int KT = 32;          // depth of one staged slice of n_fft
constexpr int AS = ROWS + 4;    // padded row of the transposed tiles

__host__ __device__ constexpr int power_cols(int generic) {
  return generic ? COLS / 2 : COLS;
}

__host__ __device__ constexpr long long smem_bytes(int generic, int mj) {
  return 8LL * ROWS
         + 4LL * (KT * AS + KT * COLS + power_cols(generic) * AS
                  + power_cols(generic) * 16 * mj);
}

template <int GENERIC, int MJ>
__global__ void __launch_bounds__(THREADS)
log_mel_direct_kernel(const float* __restrict__ sig, long long clip_stride,
                      int hop, int n_frames, long long n_rows, int n_fft,
                      const float* __restrict__ basis0,
                      const float* __restrict__ basis1, int width,
                      const float* __restrict__ fb,
                      float* __restrict__ out, int nm, int ld, int log_mode,
                      float power) {
  constexpr int PW = power_cols(GENERIC);   // power columns per tile
  constexpr int MW = 16 * MJ;               // mel columns held (zero-padded)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* roff = reinterpret_cast<long long*>(smem_raw);  // [ROWS]
  float* As = reinterpret_cast<float*>(roff + ROWS);  // [KT][AS] frames^T
  float* Bs = As + KT * AS;                            // [KT][COLS] basis
  float* Pt = Bs + KT * COLS;                          // [PW][AS] power^T
  float* Fs = Pt + PW * AS;                            // [PW][MW] fb rows

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = (long long)blockIdx.x * ROWS;

  // offset of each frame of the block in the signal; -1 past the last frame
  if (tid < ROWS) {
    const long long g = row0 + tid;
    roff[tid] = g < n_rows ? (g / n_frames) * clip_stride
                                 + (g % n_frames) * (long long)hop
                           : -1LL;
  }

  float mel[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) mel[i][j] = 0.f;

  // the frames this thread stages: rows tid/32 + 8s at depth tid % 32
  const int a_k = tid % KT, a_r = tid / KT;
  // the basis values it stages: columns tid % 64 at depths tid/64 + 4s
  const int b_j = tid % COLS, b_k = tid / COLS;

  const int n_tiles = (width + PW - 1) / PW;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * PW;          // first basis column (K5: first bin)
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += KT) {
      __syncthreads();                 // the previous slice is consumed
      const int ka = k0 + a_k;
#pragma unroll
      for (int s = 0; s < ROWS * KT / THREADS; ++s) {
        const int r = a_r + s * (THREADS / KT);
        const long long off = roff[r];
        As[a_k * AS + r] = (off >= 0 && ka < n_fft) ? __ldg(sig + off + ka)
                                                    : 0.f;
      }
#pragma unroll
      for (int s = 0; s < KT * COLS / THREADS; ++s) {
        const int k = b_k + s * (THREADS / COLS);
        const int kb = k0 + k;
        float v = 0.f;
        if (kb < n_fft) {
          if (GENERIC) {               // column 2j: cos of bin c0+j; 2j+1: sin
            const int f = c0 + b_j / 2;
            if (f < width)
              v = __ldg((b_j & 1 ? basis1 : basis0) + (long long)kb * width
                        + f);
          } else {
            const int c = c0 + b_j;
            if (c < width) v = __ldg(basis0 + (long long)kb * width + c);
          }
        }
        Bs[k * COLS + b_j] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KT; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(As + k * AS
                                                          + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Bs + k * COLS
                                                          + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // ---- power in registers, then the tile's power and filterbank rows ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (GENERIC) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float re = acc[i][2 * q], im = acc[i][2 * q + 1];
          float p = re * re + im * im;
          if (power != 2.f) p = powf(sqrtf(fmaxf(p, 0.f)), power);
          Pt[(tx * 2 + q) * AS + ty * 4 + i] = p;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Pt[(tx * 4 + j) * AS + ty * 4 + i] = acc[i][j] * acc[i][j];
      }
    }
    for (int e = tid; e < PW * MW; e += THREADS) {
      const int c = e / MW, m = e % MW;
      const int row = c0 + c;
      Fs[e] = (row < width && m < nm) ? __ldg(fb + (long long)row * ld + m)
                                      : 0.f;
    }
    __syncthreads();

    // ---- mel += power @ fb[c0 : c0 + PW] ------------------------------------
#pragma unroll 4
    for (int c = 0; c < PW; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + c * AS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const float f = Fs[c * MW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) mel[i][j] = fmaf(av[i], f, mel[i][j]);
      }
    }
    __syncthreads();                   // Pt and Fs are rewritten next tile
  }

  // ---- log, once ------------------------------------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long g = row0 + ty * 4 + i;
    if (g >= n_rows) continue;
    float* dst = out + g * ld;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = tx + 16 * j;
      if (m < nm)
        dst[m] = log_mode == 0 ? logf(mel[i][j] + 1e-6f)
                               : log10f(fmaxf(mel[i][j], 1e-10f));
    }
  }
}

template <int GENERIC, int MJ>
int launch(const float* sig, long long clip_stride, int hop, int n_frames,
           long long n_rows, int n_fft, const float* basis0,
           const float* basis1, int width, const float* fb, float* out,
           int nm, int ld, int log_mode, float power, cudaStream_t stream) {
  const long long smem = smem_bytes(GENERIC, MJ);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_direct_kernel<GENERIC, MJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + ROWS - 1) / ROWS;
  log_mel_direct_kernel<GENERIC, MJ><<<(unsigned)blocks, THREADS,
                                       (size_t)smem, stream>>>(
      sig, clip_stride, hop, n_frames, n_rows, n_fft, basis0, basis1, width,
      fb, out, nm, ld, log_mode, power);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sig: the padded clips, frame t of clip b at sig + b * clip_stride + t * hop
// (n_frames frames per clip, n_rows = batch * n_frames in all). generic 0
// (K4): basis0 = dft [n_fft, width], basis1 unused, fb = fb2 [width, nm].
// generic 1 (K5): basis0 = cos, basis1 = sin [n_fft, width = F], fb [F, nm].
// fb's rows and out's rows are ld floats apart (ld >= nm): a launch computes
// nm bands, the columns of a wider filterbank and output that the two
// pointers start at, so a wrapper covers more than 256 bands in chunks.
// out [n_rows, ld] float32. log_mode 0 = log(x + 1e-6), 1 = log10(max(x,
// 1e-10)). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for nm outside [1, 256] or ld < nm.
int log_mel_direct_f32(int generic, const float* sig, long long clip_stride,
                       int hop, int n_frames, long long n_rows, int n_fft,
                       const float* basis0, const float* basis1, int width,
                       const float* fb, float* out, int nm, int ld,
                       int log_mode, float power, void* stream) {
  if (nm < 1 || nm > 256 || ld < nm || n_frames < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AUDAX_LAUNCH(G, MJ)                                                  \
  return launch<G, MJ>(sig, clip_stride, hop, n_frames, n_rows, n_fft,       \
                       basis0, basis1, width, fb, out, nm, ld, log_mode,     \
                       power, s)
  if (generic) {
    if (nm <= 64) AUDAX_LAUNCH(1, 4);
    if (nm <= 128) AUDAX_LAUNCH(1, 8);
    AUDAX_LAUNCH(1, 16);
  }
  if (nm <= 64) AUDAX_LAUNCH(0, 4);
  if (nm <= 128) AUDAX_LAUNCH(0, 8);
  AUDAX_LAUNCH(0, 16);
#undef AUDAX_LAUNCH
}

}  // extern "C"
