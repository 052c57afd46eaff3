// Float32 products on Hopper's tensor cores by 3xTF32, for the float32
// bodies of the flash kernels: K2's (csrc/flash_fwd_tf32x3.cu), K7's and
// K8's (csrc/flash_bwd_tf32x3.cu).
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits, so one TF32
// product is off by about 2^-11 relative: too far for the 1e-4 parity the
// float32 paths hold. 3xTF32 (CUTLASS's OpMultiplyAddFastF32, the float32
// GEMM of PyTorch's memory-efficient attention) splits each float32 x into
//
//   big   = tf32(x)            round to nearest, ties away (cvt.rna)
//   small = tf32(x - big)      the remainder, itself rounded
//
// and sums a * b as  small_a * big_b + big_a * small_b + big_a * big_b,
// the two small cross terms first, each product exact in the tensor core's
// float32 accumulate. Only small_a * small_b (about 2^-22 relative) is
// left out, so the sum keeps about 21 bits: float32 parity within ~1e-6.
//
// The product is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, one
// warp, fragments in registers (g = lane / 4, t = lane % 4):
//   A 16x8 (row): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B 8x8 (col):  b0 (k = t, n = g)         b1 (k = t + 4, n = g)
//   C 16x8:       c0, c1 (g, 2t and 2t + 1) c2, c3 (g + 8, 2t and 2t + 1)
// Any k order works as long as A and B agree on it: the sum over k is the
// same. That lets a C fragment feed the next product's A without a shuffle
// (TF32's C layout is not its A layout): c0/c2 serve as a0/a1 for
// k = t <-> column 2t, c1/c3 as a2/a3 for k = t + 4 <-> column 2t + 1, and
// B's k rows are read in the same order (b0 from row 2t, b1 from 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace tf32x3 {

// one operand element as its TF32 big and small parts (bit patterns)
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// c += a * b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split once: its four values' big and small parts.
struct FragA {
  uint32_t big[4], small[4];
};
// A B fragment split once.
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(const float (&x)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(x[i]);
    f.big[i] = s.big;
    f.small[i] = s.small;
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.big, s1.big}, {s0.small, s1.small}};
}

// c += a * b in 3xTF32: the small cross terms, then big * big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.small, b.big);
  mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// The B fragment of a row-major [K][N] tile in shared memory (row stride ld
// floats) in the permuted k order of a_from_c: b0 = tile[k0 + 2t][n0 + g],
// b1 = tile[k0 + 2t + 1][n0 + g] (O += P V with V as the tile; dQ += dS K,
// dV += P^T dO, dK += dS^T Q with K, dO, Q)
__device__ __forceinline__ FragB load_b_rows_perm(const float* tile, int ld,
                                                  int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane % 4)) * ld + n0 + lane / 4;
  return split_b(p[0], p[ld]);
}

// The B fragment of B = X^T for X row-major [N][K] in shared memory (row
// stride ld): b0 = X[n0 + g][k0 + t], b1 = X[n0 + g][k0 + t + 4]
__device__ __forceinline__ FragB load_b_t(const float* x, int ld, int n0,
                                          int k0, int lane) {
  const float* row = x + (n0 + lane / 4) * ld + k0 + lane % 4;
  return split_b(row[0], row[4]);
}

// The A fragment that the C fragment c of the previous product gives, in the
// permuted k order: a0 = c0, a1 = c2 (k = t), a2 = c1, a3 = c3 (k = t + 4)
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_a(x);
}

// acc += c in float32, rounded to nearest: a chain of products summed in c
// from zero is added so, since the tensor core's own accumulation truncates
__device__ __forceinline__ void add(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

// wait until at most N committed cp.async groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
