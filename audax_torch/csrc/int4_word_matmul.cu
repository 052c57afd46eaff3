// Int4 matmul over int32 words of eight nibbles (split-eighth layout), for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of the int4 experiment tools, which compute the
// same function over the same layout:
//   tools/int4_layout_ab.py:_int4v2_kernel (called by int4_matmul_v2), whose
//     group divides the plane length K/8;
//   tools/int4_plane_probe.py:_plane_kernel (called by plane_matmul), whose
//     group divides only K, so a group may straddle two planes.
// For x [M, K] (float32 or bfloat16), words int32 [K/8, N] and float32
// scales [G, N] with group = K/G it writes
//
//   y[m, n] = sum_k x[m, k] * (nib[k, n] - 8) * s[k / group, n]
//
// in x's dtype, summed in float32. Nibble p of word (c, n) (bits 4p..4p+3)
// holds K-row p*K/8 + c, stored as q + 8. The zero point is folded into each
// nibble (nib - 8 is exact in float32), as kernel K9 does.
//
// What bounds it: at decode (M = 8) 16 FLOPs per weight, 32 per packed byte.
// On an H100 SXM's data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32 on CUDA
// cores) the float32 FMAs bound it by operations, as they do K9; the bytes
// bound counts the finer scales this layout needs (group 32 at K = 1280:
// 0.82 MB of scales beside 3.28 MB of words at N = 5120, 4x K9's).
//
// Design (simple first; the question is the layout, so everything but the
// load is K9's): a block of 128 threads owns 128 output columns, one per
// thread, for 8 rows of x and one slice of the word rows. Per word row a
// thread loads one 32-bit word -- a warp reads 128 contiguous bytes -- that
// holds eight weights of its column, one from each plane: K-rows c,
// c + K/8, ..., c + 7K/8. The x rows of those eight planes are staged once
// in shared memory and read as broadcasts. Each plane keeps its own float32
// partial; the rows of a slice are walked in segments that no plane's group
// boundary cuts, and at each segment's end every plane's partial is scaled
// by its own group's scale (under a straddling group the eight planes cross
// their boundaries at different rows, which only makes the segments
// shorter). To fill 132 SMs at N = 1280 the word rows are split across
// blocks (grid.y); each split writes a float32 partial to a workspace and a
// second kernel sums the splits in a fixed order (no atomics). Columns past
// a ragged N load no word and store nothing; the words are never padded.

#include "int4_common.cuh"

namespace {

using int4mm::ceil_div;
using int4mm::from_f32;
using int4mm::to_f32;

constexpr int THREADS = 128;               // = output columns per block
constexpr int MT = 8;                      // rows of x per block
constexpr int PLANES = 8;                  // nibbles per word
constexpr int MAX_ROWS = 32;               // word rows per split (smem)
constexpr int MIN_ROWS = 8;                // fewest word rows per split
constexpr int TARGET_BLOCKS = 512;         // ~4 blocks per SM on 132 SMs

template <typename T>
__global__ void __launch_bounds__(THREADS)
word_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
            const float* __restrict__ s, T* __restrict__ y,
            float* __restrict__ ws, int m, int k, int n, int group,
            int rows_per_split, int direct) {
  // [row - c0][plane][x row]: one float4 pair per plane
  __shared__ __align__(16) float xs[MAX_ROWS][PLANES][MT];
  const int plane = k / PLANES;
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const bool live = col < n;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int c0 = split * rows_per_split;
  const int c1 = min(plane, c0 + rows_per_split);
  const int rows = c1 - c0;

  // stage x[m0 : m0+MT, p*plane + c0 : p*plane + c1] for the eight planes,
  // zero past M; consecutive threads write consecutive shared words
  for (int i = threadIdx.x; i < MT * PLANES * rows; i += THREADS) {
    const int mm = i % MT, p = (i / MT) % PLANES, r = i / (MT * PLANES);
    xs[r][p][mm] = m0 + mm < m
        ? to_f32(x[(long long)(m0 + mm) * k + p * plane + c0 + r]) : 0.f;
  }
  __syncthreads();

  float acc[MT];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) acc[mm] = 0.f;

  for (int cs = c0; cs < c1;) {
    // the segment ends where the first plane's group does (or the slice)
    int ce = c1;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const int r = p * plane + cs;
      ce = min(ce, (r / group + 1) * group - p * plane);
    }
    float part[PLANES][MT];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) part[p][mm] = 0.f;
#pragma unroll 2
    for (int c = cs; c < ce; ++c) {
      const uint32_t word = live ? __ldg(w + (long long)c * n + col)
                                 : 0x88888888u;   // weight 0
      const float4* xr = reinterpret_cast<const float4*>(xs[c - c0][0]);
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const float wt = (float)(int)((word >> (4 * p)) & 0xFu) - 8.f;
        const float4 a = xr[2 * p], b = xr[2 * p + 1];
        part[p][0] = fmaf(a.x, wt, part[p][0]);
        part[p][1] = fmaf(a.y, wt, part[p][1]);
        part[p][2] = fmaf(a.z, wt, part[p][2]);
        part[p][3] = fmaf(a.w, wt, part[p][3]);
        part[p][4] = fmaf(b.x, wt, part[p][4]);
        part[p][5] = fmaf(b.y, wt, part[p][5]);
        part[p][6] = fmaf(b.z, wt, part[p][6]);
        part[p][7] = fmaf(b.w, wt, part[p][7]);
      }
    }
    // scale each plane's partial by its group's scale
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const int g = (p * plane + cs) / group;
      const float sc = live ? __ldg(s + (long long)g * n + col) : 0.f;
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) acc[mm] = fmaf(part[p][mm], sc, acc[mm]);
    }
    cs = ce;
  }

  if (!live) return;
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    if (m0 + mm >= m) break;
    const long long o = (long long)(m0 + mm) * n + col;
    if (direct)
      y[o] = from_f32<T>(acc[mm]);
    else
      ws[(long long)split * m * n + o] = acc[mm];
  }
}

template <typename T>
int launch(const void* x, const uint32_t* w, const float* s, void* y,
           float* ws, int m, int k, int n, int group, int splits,
           cudaStream_t stream) {
  const int plane = k / PLANES;
  const int rows = ceil_div(plane, splits);
  if (rows > MAX_ROWS || ceil_div(plane, rows) != splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(n, THREADS), splits, ceil_div(m, MT));
  const int direct = splits == 1;
  T* yt = static_cast<T*>(y);
  word_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, s, yt, ws, m, k, n, group, rows, direct);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  const long long mn = (long long)m * n;
  int4mm::reduce_splits<T><<<int4mm::reduce_blocks(mn), 256, 0, stream>>>(
      ws, yt, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of word-row splits for an [m, 8*plane] x [plane, n] product:
// enough blocks to fill the card, at least MIN_ROWS and at most MAX_ROWS
// word rows per split. With more than one split the wrapper allocates a
// float32 workspace of splits * m * n.
int int4_word_matmul_splits(int m, int plane, int n) {
  const long long tiles = (long long)ceil_div(n, THREADS) * ceil_div(m, MT);
  int splits = ceil_div(TARGET_BLOCKS, tiles);
  const int most = ceil_div(plane, MIN_ROWS);
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  int rows = ceil_div(plane, splits);
  if (rows > MAX_ROWS) rows = MAX_ROWS;
  return ceil_div(plane, rows);
}

// x [m, k] (dtype 0 = float32, 1 = bfloat16), words int32 [k/8, n], scales
// [k/group, n] float32, y [m, n] in x's dtype; ws: float32 [splits, m, n]
// when splits > 1 (ignored otherwise). All contiguous, on the device.
// Returns cudaGetLastError() after the launches.
int int4_word_matmul(const void* x, const void* words, const void* scales,
                     void* y, void* ws, int m, int k, int n, int group,
                     int splits, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || k < PLANES || k % PLANES || n < 1 || group < 1 ||
      k % group || splits < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const float* s = static_cast<const float*>(scales);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(x, w, s, y, wsf, m, k, n, group, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, s, y, wsf, m, k, n, group, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
