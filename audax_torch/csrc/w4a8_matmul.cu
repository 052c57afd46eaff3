// W4A8 matmul -- int8 activations times int4 weights in the integer units
// -- for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/w4a8_probe.py:_w4a8_kernel_zp (called by
// w4a8_matmul). The activations arrive quantized per row (xq int8 [M, K],
// row scales xs float32 [M]; the wrapper quantizes them as the JAX function
// does, outside its kernel); the weights are kernel K9's split-half uint8
// layout (packed [K/2, N]: byte (c, n) holds K-row c in its low nibble and
// K-row c + K/2 in its high nibble, each stored as q + 8) with float32
// scales [G, N], group = K/G dividing K/2. It writes
//
//   y[m, n] = xs[m] * sum_g s[g, n] * (int32) sum_{k in g} xq[m, k] * (nib[k, n] - 8)
//
// in the output's dtype: each group's sum is an exact int32 (|sum| <=
// 127 * 7 * group), converted to float32 once and scaled by s_g; the row
// scale is applied last. The zero point is folded into the nibble, which
// becomes the int8 value nib - 8.
//
// What bounds it: at decode (M = 8) 16 integer operations per weight. On an
// H100 SXM's data-sheet peaks (3.35 TB/s; 1,979 TOP/s int8 on tensor cores)
// the packed bytes and scales bound it, by a wide margin. This first
// version uses no tensor core: __dp4a, four int8 products summed into an
// int32 per instruction, on the CUDA cores (mma.sync .s8 and wgmma are
// later work).
//
// Design (K9's geometry, so the A/B isolates the integer products): a block
// of 64 threads owns 256 output columns (4 per thread) for 8 rows of x and
// one slice of the packed rows. A thread loads the 4 bytes of its columns
// for 4 consecutive packed rows (a warp reads 4 x 128 contiguous bytes) and
// transposes them with byte permutes (__byte_perm) into one register per
// column holding 4 consecutive K-rows; masking gives the low (K-rows
// c..c+3) and high (c+K/2..c+K/2+3) nibbles, and a per-byte subtract
// (__vsub4) makes them int8 nib - 8. The block's int8 x for the slice is
// staged once in shared memory as 32-bit words of 4 consecutive K values,
// read as broadcasts; __dp4a pairs each with the weight word of the same 4
// K-rows. To fill 132 SMs at N = 1280 the packed rows are split across
// blocks (grid.y) and a second kernel sums the float32 partials in a fixed
// order (no atomics) and applies the row scales; a group that a split
// boundary cuts is converted and scaled once per piece, each piece an exact
// integer. A ragged N takes 2-byte or 1-byte loads and a bounds-checked
// tail; the weights are never padded.

#include "int4_common.cuh"

namespace {

using int4mm::ceil_div;
using int4mm::COLS;
using int4mm::from_f32;
using int4mm::load_cols;
using int4mm::MAX_ROWS;
using int4mm::MIN_ROWS;
using int4mm::MT;
using int4mm::TARGET_BLOCKS;

constexpr int THREADS = 64;
constexpr int TILE_N = THREADS * COLS;     // 256 columns per block

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const uint8_t* __restrict__ w, const float* __restrict__ s,
            T* __restrict__ y, float* __restrict__ ws, int m, int k, int n,
            int group, int rows_per_split, int direct) {
  // [half][(row - c0) / 4][x row]: 4 consecutive int8 K values per word
  __shared__ int xw[2][MAX_ROWS / 4][MT];
  const int kh = k / 2, num_g = k / group;
  const int n0 = blockIdx.x * TILE_N + threadIdx.x * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int c0 = split * rows_per_split;
  const int c1 = min(kh, c0 + rows_per_split);
  const int quads = (c1 - c0) / 4;

  for (int i = threadIdx.x; i < MT * quads; i += THREADS) {
    const int mm = i % MT, q = i / MT;
    const bool ok = m0 + mm < m;
    const long long base = (long long)(m0 + mm) * k + c0 + 4 * q;
    xw[0][q][mm] = ok ? *reinterpret_cast<const int*>(xq + base) : 0;
    xw[1][q][mm] = ok ? *reinterpret_cast<const int*>(xq + base + kh) : 0;
  }
  __syncthreads();

  float acc[MT][COLS];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[mm][j] = 0.f;

  for (int cs = c0; cs < c1;) {            // one group's share of the slice
    const int g = cs / group;
    const int ce = min(c1, (g + 1) * group);
    int ilo[MT][COLS], ihi[MT][COLS];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int j = 0; j < COLS; ++j) ilo[mm][j] = ihi[mm][j] = 0;
    for (int c = cs; c < ce; c += 4) {
      const uint8_t* row = w + (long long)c * n;
      const uint32_t b0 = load_cols<VW>(row, n0, n);
      const uint32_t b1 = load_cols<VW>(row + n, n0, n);
      const uint32_t b2 = load_cols<VW>(row + 2 * n, n0, n);
      const uint32_t b3 = load_cols<VW>(row + 3 * n, n0, n);
      // 4x4 byte transpose: col[j] = byte j of b0, b1, b2, b3
      const uint32_t t0 = __byte_perm(b0, b1, 0x5140);
      const uint32_t t1 = __byte_perm(b2, b3, 0x5140);
      const uint32_t t2 = __byte_perm(b0, b1, 0x7362);
      const uint32_t t3 = __byte_perm(b2, b3, 0x7362);
      const uint32_t cols[COLS] = {__byte_perm(t0, t1, 0x5410),
                                   __byte_perm(t0, t1, 0x7632),
                                   __byte_perm(t2, t3, 0x5410),
                                   __byte_perm(t2, t3, 0x7632)};
      int wlo[COLS], whi[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        wlo[j] = (int)__vsub4(cols[j] & 0x0F0F0F0Fu, 0x08080808u);
        whi[j] = (int)__vsub4((cols[j] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
      }
      const int q = (c - c0) / 4;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) {
        const int xl = xw[0][q][mm], xh = xw[1][q][mm];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          ilo[mm][j] = __dp4a(xl, wlo[j], ilo[mm][j]);
          ihi[mm][j] = __dp4a(xh, whi[j], ihi[mm][j]);
        }
      }
    }
    // the group ends (or the slice does): its exact sums, scaled once
    const float* slo = s + (long long)g * n;
    const float* shi = s + (long long)(g + num_g / 2) * n;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const bool ok = n0 + j < n;
      const float a = ok ? __ldg(slo + n0 + j) : 0.f;
      const float h = ok ? __ldg(shi + n0 + j) : 0.f;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm)
        acc[mm][j] += (float)ilo[mm][j] * a + (float)ihi[mm][j] * h;
    }
    cs = ce;
  }

#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    if (m0 + mm >= m) break;
    const float rs = xs[m0 + mm];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (n0 + j >= n) break;
      const long long o = (long long)(m0 + mm) * n + n0 + j;
      if (direct)
        y[o] = from_f32<T>(acc[mm][j] * rs);
      else
        ws[(long long)split * m * n + o] = acc[mm][j];
    }
  }
}

// y[i] = (sum over splits of ws[split][i], in split order) * xs[row of i].
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws,
                              const float* __restrict__ xs,
                              T* __restrict__ y, long long mn, int n,
                              int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float t = 0.f;
    for (int sp = 0; sp < splits; ++sp) t += ws[sp * mn + i];
    y[i] = from_f32<T>(t * xs[i / n]);
  }
}

// Packed rows per split: a multiple of 4 (one __dp4a word of K-rows).
int rows_per_split(int kh, int splits) {
  return 4 * ceil_div(ceil_div(kh, splits), 4);
}

template <typename T>
int launch(const int8_t* xq, const float* xs, const uint8_t* w,
           const float* s, void* y, float* ws, int m, int k, int n, int group,
           int splits, cudaStream_t stream) {
  const int kh = k / 2;
  const int rows = rows_per_split(kh, splits);
  if (rows > MAX_ROWS || ceil_div(kh, rows) != splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, TILE_N), splits, ceil_div(m, MT));
  const int direct = splits == 1;
  T* yt = static_cast<T*>(y);
  if (n % 4 == 0)
    w4a8_kernel<T, 4><<<grid, THREADS, 0, stream>>>(xq, xs, w, s, yt, ws, m,
                                                    k, n, group, rows, direct);
  else if (n % 2 == 0)
    w4a8_kernel<T, 2><<<grid, THREADS, 0, stream>>>(xq, xs, w, s, yt, ws, m,
                                                    k, n, group, rows, direct);
  else
    w4a8_kernel<T, 1><<<grid, THREADS, 0, stream>>>(xq, xs, w, s, yt, ws, m,
                                                    k, n, group, rows, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long long mn = (long long)m * n;
  reduce_splits<T><<<int4mm::reduce_blocks(mn), 256, 0, stream>>>(ws, xs, yt,
                                                               mn, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of packed-row splits for an [m, 2*kh] x [kh, n] product: enough
// blocks to fill the card, at least MIN_ROWS and at most MAX_ROWS packed
// rows per split, each split a multiple of 4 rows. With more than one split
// the wrapper allocates a float32 workspace of splits * m * n.
int w4a8_matmul_splits(int m, int kh, int n) {
  const long long tiles = (long long)ceil_div(n, TILE_N) * ceil_div(m, MT);
  int splits = ceil_div(TARGET_BLOCKS, tiles);
  const int most = ceil_div(kh, MIN_ROWS);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int rows = rows_per_split(kh, splits);
  if (rows > MAX_ROWS) rows = MAX_ROWS;
  return ceil_div(kh, rows);
}

// xq int8 [m, k], xs float32 [m], packed uint8 [k/2, n], scales float32
// [k/group, n], y [m, n] (dtype 0 = float32, 1 = bfloat16); ws: float32
// [splits, m, n] when splits > 1 (ignored otherwise). k % 8 == 0 and
// group % 4 == 0 (so 4-row words never cross a group or the half
// boundary). All contiguous, on the device. Returns cudaGetLastError()
// after the launches.
int w4a8_matmul(const void* xq, const void* xs, const void* packed,
                const void* scales, void* y, void* ws, int m, int k, int n,
                int group, int splits, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || k < 8 || k % 8 || n < 1 || group < 4 || group % 4 ||
      (k / 2) % group || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int8_t* xqi = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(xqi, xsf, w, s, y, wsf, m, k, n, group, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xqi, xsf, w, s, y, wsf, m, k, n, group,
                                 splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
