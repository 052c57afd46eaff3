// Two variants of the int4 weight-only matmul, for Hopper (sm_90a): how
// nibbles become the numbers the products take.
//
// Both compute kernel K9's function over K9's layout: for x [M, K] (float32
// or bfloat16), packed uint8 [K/2, N] (byte (c, n) holds K-row c in its low
// nibble and K-row c + K/2 in its high nibble, each stored as q + 8) and
// float32 scales [G, N] with group = K/G dividing K/2,
//
//   y[m, n] = sum_k x[m, k] * (nib[k, n] - 8) * s[k / group, n]
//
// in x's dtype, summed in float32 without atomics.
//
// Variant 1 replaces the TPU kernel tools/int4_unpack_probe.py:_kernel_v1
// (called by run_variant): the kernel and geometry of K9's split-half body
// (int4_common.cuh's split_half_kernel, the same template that body
// instantiates), with one difference, the unpack. That body turns each
// nibble into a float with an integer-to-float conversion, which runs at a
// fraction of the FMA rate; here one byte
// permute (__byte_perm) writes the nibble under the exponent of 2^23 (the
// bits nib | 0x4B000000 read as a float are 2^23 + nib) and one float
// subtraction of 2^23 + 8 leaves nib - 8, exactly. That is this card's
// counterpart of unpacking by mask and shift with no widen. Per group the
// float32 partials are scaled by the group's scales; the packed rows are
// split across blocks and a second kernel sums the splits in a fixed order.
// A block owns 256 columns (64 threads of 4 columns). This is its first
// body, kept for the calls that the tensor-core body (int4_matmul_mma.cu,
// ROUTE_V1) does not take; tools/int4_unpack_probe.py:V1_BODIES routes them
// before any launch.
//
// Variant 2 replaces tools/int4_unpack_probe.py:_kernel_v2: dequantize a
// tile of weights into shared memory in x's dtype, rounding as the JAX body
// does ((nib - 8) and s each cast to x's dtype, their product rounded to
// x's dtype), then one contraction over the whole K, with no per-group
// partials. This is its first body, kept for the calls that the tensor-core
// body (int4_matmul_mma.cu, ROUTE_V2) does not take -- a group that is not
// a multiple of 16 packed rows, or K/2 > 8192;
// tools/int4_unpack_probe.py:V2_BODIES routes them before any launch. K is
// streamed through shared memory in chunks of 32 packed rows (64 K-rows:
// the low and the high nibbles): a whole [5120, 64] bf16 tile would be
// 655 KB, over the 227 KB a block can use. A block owns 64 columns (one
// warp per 8) and all of K, so it needs no second pass. bfloat16 x goes
// through the tensor cores with mma.sync.m16n8k16 (bf16 products, float32
// sums), x's 8 rows padded to the instruction's 16 with zero registers;
// float32 x runs on the CUDA cores (no TF32, for parity).
//
// What bounds them: at decode (M = 8) 16 FLOPs per weight, 32 per packed
// byte. On an H100 SXM's data-sheet peaks (3.35 TB/s; 67 TFLOP/s float32
// on CUDA cores, 989 TFLOP/s bf16 on tensor cores) variant 1 and variant
// 2 in float32 are bound by their FMAs, variant 2 in bfloat16 by the
// packed bytes and scales. Neither is tuned: variant 2 waits on two
// barriers per chunk, with no copy in flight while it computes (what its
// tensor-core body does about that: int4_matmul_mma.cu).
//
// A ragged N takes narrower loads and bounds-checked tails; the weights are
// never padded.

#include "int4_common.cuh"

namespace {

using int4mm::COLS;
using int4mm::ceil_div;
using int4mm::from_f32;
using int4mm::load_cols;
using int4mm::to_f32;

constexpr int KC = 32;                     // variant 2: packed rows per chunk
constexpr int V1_BN = 256;                 // variant 1: columns per block
constexpr int V2_BN = 64;                  // variant 2: columns per block

// (nib - 8) * s rounded as the JAX body rounds in x's dtype: in float32 one
// rounding of the product; in bfloat16 s rounded to bf16 first, then the
// product (exact in float32: 8-bit significands) rounded to bf16.
template <typename T>
__device__ __forceinline__ T dequant(uint32_t nib, float s) {
  const float q = (float)((int)nib - 8);
  if constexpr (sizeof(T) == 4) {
    return q * s;
  } else {
    return __float2bfloat16(q * __bfloat162float(__float2bfloat16(s)));
  }
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T, int VW, int BN>
__global__ void __launch_bounds__(4 * BN)
v2_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ s, T* __restrict__ y, int m, int k, int n,
          int group) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NT = 4 * BN;               // BN / 8 warps
  constexpr int ROWS = BF16 ? 16 : 8;      // rows of x per block
  constexpr int KCH = 2 * KC;              // K values per chunk
  constexpr int PAD = BF16 ? 8 : 1;        // bank-conflict padding
  // weights [column][chunk K]: a column's K values contiguous, so a bf16
  // pair of consecutive K is one 32-bit fragment register
  __shared__ __align__(16) T wsm[BN][KCH + PAD];
  __shared__ __align__(16) T xsm[ROWS][KCH + PAD];
  const int kh = k / 2, num_g = k / group;
  const int nb = blockIdx.x * BN;
  const int m0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < kh; c0 += KC) {
    const int rows = min(KC, kh - c0);
    __syncthreads();                       // the last chunk's reads are done
    // chunk K order: low nibbles (K-rows c0..c0+KC), then high (kh + c0..)
    for (int i = tid; i < KC * (BN / COLS); i += NT) {
      const int q = i % (BN / COLS), r = i / (BN / COLS);
      const int n0 = nb + COLS * q;
      if (r < rows) {
        const int c = c0 + r, glo = c / group, ghi = glo + num_g / 2;
        const uint32_t b = load_cols<VW>(w + (long long)c * n, n0, n);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const bool ok = n0 + j < n;
          const float slo = ok ? __ldg(s + (long long)glo * n + n0 + j) : 0.f;
          const float shi = ok ? __ldg(s + (long long)ghi * n + n0 + j) : 0.f;
          wsm[COLS * q + j][r] = dequant<T>((b >> (8 * j)) & 0xFu, slo);
          wsm[COLS * q + j][KC + r] = dequant<T>((b >> (8 * j + 4)) & 0xFu,
                                                 shi);
        }
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          wsm[COLS * q + j][r] = wsm[COLS * q + j][KC + r] = from_f32<T>(0.f);
      }
    }
    for (int i = tid; i < ROWS * KCH; i += NT) {
      const int mm = i / KCH, kl = i % KCH, r = kl % KC;
      const int krow = (kl < KC ? 0 : kh) + c0 + r;
      xsm[mm][kl] = (m0 + mm < m && r < rows)
          ? x[(long long)(m0 + mm) * k + krow] : from_f32<T>(0.f);
    }
    __syncthreads();

    if constexpr (BF16) {
      // warp w: columns nb + 8w .. +8; lane = 4 * g + t
      const int lane = tid & 31, g = lane >> 2, t = lane & 3;
      const int col = 8 * (tid >> 5) + g;
      const bool upper = m0 + 8 < m;       // rows 8..15 hold data
#pragma unroll
      for (int k0 = 0; k0 < KCH; k0 += 16) {
        const uint32_t* xa = reinterpret_cast<const uint32_t*>(&xsm[g][k0 + 2 * t]);
        const uint32_t* xb = reinterpret_cast<const uint32_t*>(&xsm[g + 8][k0 + 2 * t]);
        const uint32_t* wb = reinterpret_cast<const uint32_t*>(&wsm[col][k0 + 2 * t]);
        mma_bf16(acc, xa[0], upper ? xb[0] : 0u, xa[4], upper ? xb[4] : 0u,
                 wb[0], wb[4]);
      }
    } else {
      // thread: column tid % BN, rows tid / BN and tid / BN + 4
      const int col = tid % BN, r0 = tid / BN;
#pragma unroll 8
      for (int kl = 0; kl < KCH; ++kl) {
        const float wv = to_f32(wsm[col][kl]);
        acc[0] = fmaf(to_f32(xsm[r0][kl]), wv, acc[0]);
        acc[1] = fmaf(to_f32(xsm[r0 + 4][kl]), wv, acc[1]);
      }
    }
  }

  if constexpr (BF16) {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int c = nb + 8 * (tid >> 5) + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m0 + g + (i >= 2 ? 8 : 0), nn = c + (i & 1);
      if (mm < m && nn < n) y[(long long)mm * n + nn] = from_f32<T>(acc[i]);
    }
  } else {
    const int nn = nb + tid % BN, r0 = tid / BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mm = m0 + r0 + 4 * i;
      if (mm < m && nn < n) y[(long long)mm * n + nn] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T, int VW>
int launch_v2(const void* x, const uint8_t* w, const float* s, void* y,
              int m, int k, int n, int group, cudaStream_t st) {
  const dim3 grid(ceil_div(n, V2_BN), ceil_div(m, sizeof(T) == 2 ? 16 : 8));
  v2_kernel<T, VW, V2_BN><<<grid, 4 * V2_BN, 0, st>>>(
      static_cast<const T*>(x), w, s, static_cast<T*>(y), m, k, n, group);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_v1(const void* x, const uint8_t* w, const float* s, void* y,
              float* ws, int m, int k, int n, int group, int splits,
              cudaStream_t st) {
  return int4mm::launch_split_half<T, V1_BN / COLS, true>(
      x, w, s, y, ws, m, k, n, group, splits, st);
}

template <typename T>
int dispatch_v2(const void* x, const uint8_t* w, const float* s, void* y,
                int m, int k, int n, int group, cudaStream_t st) {
  if (n % 4 == 0) return launch_v2<T, 4>(x, w, s, y, m, k, n, group, st);
  if (n % 2 == 0) return launch_v2<T, 2>(x, w, s, y, m, k, n, group, st);
  return launch_v2<T, 1>(x, w, s, y, m, k, n, group, st);
}

bool bad_shape(int m, int k, int n, int group) {
  return m < 1 || k < 2 || k % 2 || n < 1 || group < 1 || (k / 2) % group;
}

}  // namespace

extern "C" {

// Variant 1's packed-row splits for an [m, 2*kh] x [kh, n] product (K9's
// rule at 256 columns per block). With more than one split the wrapper
// allocates a float32 workspace of splits * m * n.
int int4_unpack_v1_splits(int m, int kh, int n) {
  return int4mm::split_half_splits(m, kh, n, V1_BN);
}

// x [m, k] (dtype 0 = float32, 1 = bfloat16), packed uint8 [k/2, n], scales
// float32 [k/group, n], y [m, n] in x's dtype; ws float32 [splits, m, n]
// when splits > 1. All contiguous, on the device. Returns
// cudaGetLastError() after the launches.
int int4_unpack_v1(const void* x, const void* packed, const void* scales,
                   void* y, void* ws, int m, int k, int n, int group,
                   int splits, int dtype, void* stream) {
  if (bad_shape(m, k, n, group) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_v1<float>(x, w, s, y, wsf, m, k, n, group, splits, st);
  if (dtype == 1)
    return launch_v1<__nv_bfloat16>(x, w, s, y, wsf, m, k, n, group, splits,
                                    st);
  return (int)cudaErrorInvalidValue;
}

// As int4_unpack_v1 without a workspace, at 64 columns per block.
int int4_unpack_v2(const void* x, const void* packed, const void* scales,
                   void* y, int m, int k, int n, int group, int dtype,
                   void* stream) {
  if (bad_shape(m, k, n, group)) return (int)cudaErrorInvalidValue;
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_v2<float>(x, w, s, y, m, k, n, group, st);
  if (dtype == 1)
    return dispatch_v2<__nv_bfloat16>(x, w, s, y, m, k, n, group, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
