// Int4 weight-only matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel audax/ops/int4_matmul.py:_int4_kernel (called by
// int4_matmul). For x [M, K] (float32 or bfloat16, M <= 256), packed uint8
// [K/2, N] and float32 scales [G, N] (one layer's slice: the wrapper passes
// the pointer of the selected layer, never a copy) it writes
//
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (nib[k, n] - 8)
//
// in x's dtype, summed in float32. Packed byte (c, n) holds K-row c in its
// low nibble and K-row c + K/2 in its high nibble, each stored as q + 8;
// group g < G/2 covers packed rows [g*group, (g+1)*group) through the low
// nibbles, group g + G/2 the same rows through the high nibbles. The zero
// point is folded into each nibble before the product (nib - 8 is exact in
// float32), so no separate sum of x is needed.
//
// What bounds it: decode runs it at M = 8 (slots), 2*M = 16 FLOPs per
// weight, 32 per packed byte. On an H100 SXM's data-sheet peaks (3.35 TB/s,
// 67 TFLOP/s float32 on CUDA cores: 20 FLOPs per byte) the float32 FMAs
// done here bound it by operations, barely: ~0.39 us for a 1280x1280
// projection and ~15.9 us for the tied 1280 x 51,866 logits, against bytes
// bounds of ~0.28 and ~11 us. Products on tensor cores would leave it bound
// by the packed bytes and scales.
//
// Design (simple first): a block of 64 threads owns 256 output columns (4
// per thread) for 8 rows of x and one slice of the packed rows. Per packed
// row a thread loads 4 bytes -- a warp reads 128 contiguous bytes -- and
// unpacks 8 nibbles into float32 weights; the block's x rows for that slice
// (both halves) are staged once in shared memory and read as broadcasts.
// Partials are scaled at each group's end. To fill 132 SMs at N = 1280 the
// packed rows are split across blocks (grid.y); each split writes its own
// float32 partial to a workspace and a second kernel sums the splits in a
// fixed order, so results do not change from run to run (no atomics).
// A ragged N (odd, or not a multiple of 4) takes 2-byte or 1-byte loads and
// a bounds-checked tail; the weights are never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int COLS = 4;                    // output columns per thread
constexpr int TILE_N = THREADS * COLS;     // 256 columns per block
constexpr int MT = 8;                      // rows of x per block
constexpr int MAX_ROWS = 256;              // packed rows per split (smem)
constexpr int MIN_ROWS = 32;               // fewest packed rows per split
constexpr int TARGET_BLOCKS = 1024;        // ~8 blocks per SM on 132 SMs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 4 packed bytes of columns [n0, n0 + 4) of one packed row. VW is the
// widest load the row alignment allows (4: N % 4 == 0; 2: N even; else 1).
// Columns past N read as 0x88 (both nibbles 8, i.e. weight 0).
template <int VW>
__device__ __forceinline__ uint32_t load_cols(const uint8_t* row, int n0,
                                              int n) {
  if (n0 + COLS <= n) {
    if (VW == 4) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
    if (VW == 2) {
      const uint32_t a = __ldg(reinterpret_cast<const unsigned short*>(row + n0));
      const uint32_t b =
          __ldg(reinterpret_cast<const unsigned short*>(row + n0 + 2));
      return a | (b << 16);
    }
  }
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    v |= (n0 + j < n ? (uint32_t)__ldg(row + n0 + j) : 0x88u) << (8 * j);
  return v;
}

template <typename T, int VW>
__global__ void __launch_bounds__(THREADS)
int4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
            const float* __restrict__ s, T* __restrict__ y,
            float* __restrict__ ws, int m, int k, int n, int group,
            int rows_per_split, int direct) {
  __shared__ __align__(16) float xs[2][MAX_ROWS][MT];  // [half][row][x row]
  const int kh = k / 2, num_g = k / group;
  const int n0 = blockIdx.x * TILE_N + threadIdx.x * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int c0 = split * rows_per_split;
  const int c1 = min(kh, c0 + rows_per_split);
  const int rows = c1 - c0;

  // stage x[m0 : m0+MT, c0 : c1] and x[.., kh+c0 : kh+c1], zero past M
  for (int i = threadIdx.x; i < MT * rows; i += THREADS) {
    const int mm = i / rows, r = i % rows;
    const bool ok = m0 + mm < m;
    const long long base = (long long)(m0 + mm) * k + c0 + r;
    xs[0][r][mm] = ok ? to_f32(x[base]) : 0.f;
    xs[1][r][mm] = ok ? to_f32(x[base + kh]) : 0.f;
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
    float plo[MT][COLS], phi[MT][COLS];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int j = 0; j < COLS; ++j) plo[mm][j] = phi[mm][j] = 0.f;
#pragma unroll 4
    for (int c = cs; c < ce; ++c) {
      const uint32_t b = load_cols<VW>(w + (long long)c * n, n0, n);
      float wl[COLS], wh[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const uint32_t byte = (b >> (8 * j)) & 0xFFu;
        wl[j] = (float)(int)(byte & 0xFu) - 8.f;
        wh[j] = (float)(int)(byte >> 4) - 8.f;
      }
      const float4* xl4 = reinterpret_cast<const float4*>(xs[0][c - c0]);
      const float4* xh4 = reinterpret_cast<const float4*>(xs[1][c - c0]);
      float xl[MT], xh[MT];
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 a = xl4[q], h = xh4[q];
        xl[4 * q] = a.x; xl[4 * q + 1] = a.y; xl[4 * q + 2] = a.z; xl[4 * q + 3] = a.w;
        xh[4 * q] = h.x; xh[4 * q + 1] = h.y; xh[4 * q + 2] = h.z; xh[4 * q + 3] = h.w;
      }
#pragma unroll
      for (int mm = 0; mm < MT; ++mm)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          plo[mm][j] = fmaf(xl[mm], wl[j], plo[mm][j]);
          phi[mm][j] = fmaf(xh[mm], wh[j], phi[mm][j]);
        }
    }
    // the group ends (or the slice does): scale its partial sums
    const float* slo = s + (long long)g * n;
    const float* shi = s + (long long)(g + num_g / 2) * n;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const bool ok = n0 + j < n;
      const float a = ok ? __ldg(slo + n0 + j) : 0.f;
      const float h = ok ? __ldg(shi + n0 + j) : 0.f;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm)
        acc[mm][j] += plo[mm][j] * a + phi[mm][j] * h;
    }
    cs = ce;
  }

#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    if (m0 + mm >= m) break;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (n0 + j >= n) break;
      const long long o = (long long)(m0 + mm) * n + n0 + j;
      if (direct)
        y[o] = from_f32<T>(acc[mm][j]);
      else
        ws[(long long)split * m * n + o] = acc[mm][j];
    }
  }
}

// y[i] = sum over splits of ws[split][i], in split order.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws, T* __restrict__ y,
                              long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float t = 0.f;
    for (int sp = 0; sp < splits; ++sp) t += ws[sp * mn + i];
    y[i] = from_f32<T>(t);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

int rows_per_split(int kh, int splits) { return ceil_div(kh, splits); }

template <typename T>
int launch(const void* x, const uint8_t* w, const float* s, void* y,
           float* ws, int m, int k, int n, int group, int splits,
           cudaStream_t stream) {
  const int kh = k / 2;
  const int rows = rows_per_split(kh, splits);
  if (rows > MAX_ROWS || ceil_div(kh, rows) != splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, TILE_N), splits, ceil_div(m, MT));
  const int direct = splits == 1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (n % 4 == 0)
    int4_kernel<T, 4><<<grid, THREADS, 0, stream>>>(xt, w, s, yt, ws, m, k, n,
                                                    group, rows, direct);
  else if (n % 2 == 0)
    int4_kernel<T, 2><<<grid, THREADS, 0, stream>>>(xt, w, s, yt, ws, m, k, n,
                                                    group, rows, direct);
  else
    int4_kernel<T, 1><<<grid, THREADS, 0, stream>>>(xt, w, s, yt, ws, m, k, n,
                                                    group, rows, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long long mn = (long long)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  reduce_splits<T><<<blocks, 256, 0, stream>>>(ws, yt, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of packed-row splits for an [m, 2*kh] x [kh, n] product: enough
// blocks to fill the card, at least MIN_ROWS and at most MAX_ROWS packed
// rows per split. With more than one split the wrapper allocates a float32
// workspace of splits * m * n.
int int4_matmul_splits(int m, int kh, int n) {
  const long long tiles = (long long)ceil_div(n, TILE_N) * ceil_div(m, MT);
  int splits = ceil_div(TARGET_BLOCKS, tiles);
  const int most = ceil_div(kh, MIN_ROWS);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int rows = rows_per_split(kh, splits);
  if (rows > MAX_ROWS) rows = MAX_ROWS;
  return ceil_div(kh, rows);
}

// x [m, k] (dtype 0 = float32, 1 = bfloat16), packed [k/2, n] uint8,
// scales [k/group, n] float32, y [m, n] in x's dtype; ws: float32 [splits,
// m, n] when splits > 1 (ignored otherwise). All contiguous, on the device.
// Returns cudaGetLastError() after the launches.
int int4_matmul(const void* x, const void* packed, const void* scales,
                void* y, void* ws, int m, int k, int n, int group, int splits,
                int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || k < 2 || k % 2 || n < 1 || group < 1 || (k / 2) % group ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(x, w, s, y, wsf, m, k, n, group, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, s, y, wsf, m, k, n, group, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
