// What the int4 matmul kernels share (csrc/int4_matmul.cu, K9's split-half
// body; csrc/int4_word_matmul.cu; csrc/w4a8_matmul.cu;
// csrc/int4_unpack_variants.cu): conversions, the 4-column load of K9's
// packed bytes, the fixed-order sum of split-K partials, and split_half_kernel
// itself, templated on the threads per block and on how a nibble becomes a
// float, so that the unpack variant shares every other line with it.
//
// split_half_kernel is K9's first body on the CUDA cores, kept for P5 v1
// (csrc/int4_unpack_variants.cu) and for the calls K9's tensor-core body
// (csrc/int4_matmul_mma.cu) does not take: a group that is not a multiple
// of 16 packed rows, or K/2 past that body's 16 splits of 512 rows
// (ops/int4_matmul.py:BODIES). It computes, for x [M, K] (float32 or
// bfloat16), packed uint8 [K/2, N] (byte (c, n) holds K-row c in its low
// nibble and K-row c + K/2 in its high nibble, each stored as q + 8) and
// float32 scales [G, N] (group = K/G divides K/2),
//
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (nib[k, n] - 8)
//
// in x's dtype, summed in float32. A block of NT threads owns 4 * NT output
// columns (4 per thread) for 8 rows of x and one slice of the packed rows;
// per packed row a thread loads 4 bytes -- a warp reads 128 contiguous
// bytes -- and unpacks 8 nibbles into float32 weights with the zero point
// folded in (nib - 8 is exact); the block's x rows for the slice (both
// halves) are staged once in shared memory and read as broadcasts;
// partials are scaled at each group's end. The packed rows are split
// across blocks (grid.y); each split writes a float32 partial to a
// workspace and reduce_splits sums them in a fixed order (no atomics). A
// ragged N takes 2-byte or 1-byte loads and a bounds-checked tail. Too few
// bytes in flight, the partials' round trip through device memory and a
// second launch hold it at 50-65x its bound at the decode projections on
// an H100; the tensor-core body is the answer to each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int4mm {

constexpr int COLS = 4;                    // output columns per thread
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

inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
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

// Blocks for the reduction of an [m, n] output.
inline int reduce_blocks(long long mn) {
  return (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
}

// Split-K plan of an [m, 2*kh] x [kh, n] product at tile_n columns per
// block: enough blocks to fill the card, at least MIN_ROWS and at most
// MAX_ROWS packed rows per split.
inline int split_half_splits(int m, int kh, int n, int tile_n) {
  const long long tiles = (long long)ceil_div(n, tile_n) * ceil_div(m, MT);
  int splits = ceil_div(TARGET_BLOCKS, tiles);
  const int most = ceil_div(kh, MIN_ROWS);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int rows = ceil_div(kh, splits);
  if (rows > MAX_ROWS) rows = MAX_ROWS;
  return ceil_div(kh, rows);
}

// nib - 8 as a float, for a nibble held alone in byte J of ``nibs``.
// BITCAST false: an integer-to-float conversion (K9). BITCAST true: one
// byte permute writes the nibble under the exponent of 2^23 (the bits
// nib | 0x4B000000 read as a float are 2^23 + nib) and one subtraction of
// 2^23 + 8 leaves nib - 8, exactly, with no conversion instruction.
template <bool BITCAST, int J>
__device__ __forceinline__ float nib_f32(uint32_t nibs) {
  if (BITCAST)
    return __int_as_float(__byte_perm(nibs, 0x4B000000u, 0x7540 | J))
           - 8388616.f;                    // 2^23 + 8
  return (float)(int)((nibs >> (8 * J)) & 0xFFu) - 8.f;
}

template <typename T, int VW, int NT, bool BITCAST>
__global__ void __launch_bounds__(NT)
split_half_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ s, T* __restrict__ y,
                  float* __restrict__ ws, int m, int k, int n, int group,
                  int rows_per_split, int direct) {
  __shared__ __align__(16) float xs[2][MAX_ROWS][MT];  // [half][row][x row]
  const int kh = k / 2, num_g = k / group;
  const int n0 = blockIdx.x * NT * COLS + threadIdx.x * COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int c0 = split * rows_per_split;
  const int c1 = min(kh, c0 + rows_per_split);
  const int rows = c1 - c0;

  // stage x[m0 : m0+MT, c0 : c1] and x[.., kh+c0 : kh+c1], zero past M
  for (int i = threadIdx.x; i < MT * rows; i += NT) {
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
      const uint32_t lo = b & 0x0F0F0F0Fu, hi = (b >> 4) & 0x0F0F0F0Fu;
      const float wl[COLS] = {nib_f32<BITCAST, 0>(lo), nib_f32<BITCAST, 1>(lo),
                              nib_f32<BITCAST, 2>(lo), nib_f32<BITCAST, 3>(lo)};
      const float wh[COLS] = {nib_f32<BITCAST, 0>(hi), nib_f32<BITCAST, 1>(hi),
                              nib_f32<BITCAST, 2>(hi), nib_f32<BITCAST, 3>(hi)};
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

// K9's kernel (and its reduction when split) on ``stream``; returns
// cudaGetLastError() after the launches.
template <typename T, int NT, bool BITCAST>
int launch_split_half(const void* x, const uint8_t* w, const float* s,
                      void* y, float* ws, int m, int k, int n, int group,
                      int splits, cudaStream_t stream) {
  const int kh = k / 2;
  const int rows = ceil_div(kh, splits);
  if (rows > MAX_ROWS || ceil_div(kh, rows) != splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, NT * COLS), splits, ceil_div(m, MT));
  const int direct = splits == 1;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (n % 4 == 0)
    split_half_kernel<T, 4, NT, BITCAST><<<grid, NT, 0, stream>>>(
        xt, w, s, yt, ws, m, k, n, group, rows, direct);
  else if (n % 2 == 0)
    split_half_kernel<T, 2, NT, BITCAST><<<grid, NT, 0, stream>>>(
        xt, w, s, yt, ws, m, k, n, group, rows, direct);
  else
    split_half_kernel<T, 1, NT, BITCAST><<<grid, NT, 0, stream>>>(
        xt, w, s, yt, ws, m, k, n, group, rows, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long long mn = (long long)m * n;
  reduce_splits<T><<<reduce_blocks(mn), 256, 0, stream>>>(ws, yt, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace int4mm
