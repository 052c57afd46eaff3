// Int4 weight-only matmul for Hopper (sm_90a): K9's split-half body on the
// CUDA cores.
//
// Replaces, with K9's tensor-core body (csrc/int4_matmul_mma.cu), the TPU
// kernel audax/ops/int4_matmul.py:_int4_kernel (called by int4_matmul).
// This body serves the calls that one does not take -- a group that is not
// a multiple of 16 packed rows, or K/2 past 16 splits of 512 rows -- as
// ops/int4_matmul.py:BODIES routes them, and the A/B against it (its
// wrapper, ops/int4_matmul.py:int4_matmul_cuda, called directly); its
// kernel, int4_common.cuh's split_half_kernel, is also the base of P5 v1
// (csrc/int4_unpack_variants.cu). For x [M, K] (float32 or bfloat16, M <=
// 256), packed uint8 [K/2, N] and float32 scales [G, N] (one layer's slice:
// the wrapper passes the pointer of the selected layer, never a copy) it
// writes
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
// What bounds it: at M = 8, 2*M = 16 FLOPs per weight, 32 per packed byte.
// On an H100 SXM's data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32 on CUDA
// cores: 20 FLOPs per byte) its float32 FMAs bound it by operations,
// barely: ~0.39 us for a 1280x1280 projection and ~15.9 us for the tied
// 1280 x 51,866 logits, against bytes bounds of ~0.28 and ~11 us.
//
// Design: a block of 64 threads owns 256 output columns (4 per thread) for
// 8 rows of x and one slice of the packed rows. Per packed row a thread
// loads 4 bytes -- a warp reads 128 contiguous bytes -- and unpacks 8
// nibbles into float32 weights with an integer-to-float conversion each;
// the block's x rows for that slice (both halves) are staged once in shared
// memory and read as broadcasts. Partials are scaled at each group's end.
// To fill 132 SMs at N = 1280 the packed rows are split across blocks
// (grid.y); each split writes its own float32 partial to a workspace and a
// second kernel sums the splits in a fixed order, so results do not change
// from run to run (no atomics). A ragged N (odd, or not a multiple of 4)
// takes 2-byte or 1-byte loads and a bounds-checked tail; the weights are
// never padded.

#include "int4_common.cuh"

namespace {

constexpr int THREADS = 64;                // 256 columns per block

}  // namespace

extern "C" {

// Number of packed-row splits for an [m, 2*kh] x [kh, n] product: enough
// blocks to fill the card, at least MIN_ROWS and at most MAX_ROWS packed
// rows per split. With more than one split the wrapper allocates a float32
// workspace of splits * m * n.
int int4_matmul_splits(int m, int kh, int n) {
  return int4mm::split_half_splits(m, kh, n, THREADS * int4mm::COLS);
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
    return int4mm::launch_split_half<float, THREADS, false>(
        x, w, s, y, wsf, m, k, n, group, splits, st);
  if (dtype == 1)
    return int4mm::launch_split_half<__nv_bfloat16, THREADS, false>(
        x, w, s, y, wsf, m, k, n, group, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
