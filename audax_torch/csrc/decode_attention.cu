// Small-query attention over a layer-stacked KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel audax/ops/attention.py:_dec_kernel_stacked (called
// by decode_attention_stacked). For q [B, H, Tq, D] (Tq <= 16) and the cache
// k, v [L, B, Hkv, S, D] it reads layer `layer` in place -- no sliced copy --
// and writes
//
//   o[b, h, r] = sum_j p_rj v_j / sum_j p_rj,   p_rj = exp(s_rj - max_j s_rj)
//   s_rj = scale * q_r . k_j  where  j < S  and  j <= pos[b] + r,
//
// with the kv head h / (H / Hkv). pos [B] int32 is each slot's decode
// position; cross-attention passes pos = S (every key visible). As on the
// TPU, p is cast to q's dtype before the PV product and l sums it unrounded.
//
// What bounds it on this card: memory. Each (batch, head) reads its K and V
// rows once and does 4*D FLOPs per key row of 2*D*4 bytes (f32) -- 0.5
// FLOP/byte, far below the card's balance point -- so the bound is the
// bytes of the valid K/V rows over 3.35 TB/s. At Whisper-tiny, B=4, one
// token's eight launches read about 96 MB of float32 K/V.
//
// Design: one block of 256 threads per (batch, q-head). Keys past
// pos[b] + Tq - 1 are masked for every row, so the block never reads them:
// self-attention early in a transcript touches a few rows of its 448-slot
// cache, not all of them. Pass 1: a thread per key reads the key row once
// as float4s (D/4 independent loads in flight) and scores it against all
// Tq query rows held in shared memory; scores go to shared memory. Pass 2:
// per query row, a block-wide max, exp and sum (two-pass softmax). Pass 3:
// PV with 16 threads per value row reading float4s, so a warp reads two
// whole rows with coalesced 16-byte loads; the partial sums of the key
// slices are combined through shared memory. The grid has only B*H blocks
// (24 at Whisper-tiny B=4), so most SMs idle; splitting S across blocks
// (flash-decoding) is the known next step.
//
// The int8 arm (decode_attention_stacked_q8; the TPU kernel's quant=True)
// reads k, v as int8 [L, B, Hkv, S, D] with float32 per-vector scales
// ks, vs [L, B, Hkv, S], widened to float32 in registers four at a time:
//
//   s_rj = (scale * q_r . k_j) * ks_j,   l_r = sum_j p_rj (unscaled p),
//   o[b, h, r] = sum_j round(p_rj * vs_j) v_j / l_r,
//
// where round() casts to q's dtype, as the TPU kernel casts p * vs before
// PV. It halves (bf16) or quarters (f32) the K/V bytes, which bound it. The
// same kernel with L = 1 serves decode_attention (the TPU _dec_kernel) for
// an unstacked [B, Hkv, S, D] cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXQ = 16;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Block-wide reduction of one float (max or sum) through `red` [32].
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(~0u, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                       // red is free from the last use
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? red[lane] : (MAX ? NEG : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(~0u, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// T: q and o's dtype; KV: the cache's (T, or int8_t when QUANT, with the
// per-vector scales ks, vs; unused otherwise).
template <int D, typename T, typename KV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, T* __restrict__ o,
                   const int* __restrict__ pos, int layer, int batch,
                   int heads, int hkv, int tq, int s_len, float scale) {
  constexpr int TPR = D / 4;             // threads per value row in PV
  constexpr int SLICES = THREADS / TPR;  // value rows read at once
  extern __shared__ float smem[];
  float* qs = smem;                      // [MAXQ][D]
  float* red = qs + MAXQ * D;            // [32]
  float* lsum = red + 32;                // [MAXQ]
  float* part = lsum + MAXQ;             // [SLICES][tq][D] PV partials
  float* sc = part + SLICES * tq * D;    // [tq][n_keys] scores, then p

  const int bh = blockIdx.x;             // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / hkv);
  const long long row0 = (((long long)layer * batch + b) * hkv + kvh) * s_len;
  const KV* kb = k + row0 * D;
  const KV* vb = v + row0 * D;
  const float* ksb = QUANT ? ks + row0 : nullptr;
  const float* vsb = QUANT ? vs + row0 : nullptr;
  const int p = pos[b];
  const int n_keys = max(0, min(s_len, p + tq));   // keys any row may see

  for (int i = threadIdx.x; i < tq * D; i += THREADS)
    qs[i] = to_f32(q[(long long)bh * tq * D + i]);
  __syncthreads();

  // ---- pass 1: scores, a thread per key -----------------------------------
  for (int j = threadIdx.x; j < n_keys; j += THREADS) {
    float s[MAXQ];
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) s[r] = 0.f;
    const KV* kr = kb + (long long)j * D;
    const float kj = QUANT ? __ldg(ksb + j) : 1.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 kv4 = load4(kr + d);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < tq) {
          const float* qr = qs + r * D + d;
          s[r] += qr[0] * kv4.x + qr[1] * kv4.y + qr[2] * kv4.z + qr[3] * kv4.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXQ; ++r)
      if (r < tq)
        sc[r * n_keys + j] =
            j <= p + r ? (QUANT ? s[r] * scale * kj : s[r] * scale) : NEG;
  }
  __syncthreads();

  // ---- pass 2: softmax numerator and denominator per query row ------------
  for (int r = 0; r < tq; ++r) {
    float* row = sc + r * n_keys;
    float mx = NEG;
    for (int j = threadIdx.x; j < n_keys; j += THREADS) mx = fmaxf(mx, row[j]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int j = threadIdx.x; j < n_keys; j += THREADS) {
      const float e = j <= p + r ? expf(row[j] - mx) : 0.f;
      sum += e;
      // p (times v's scale in the int8 arm) cast to q's dtype before PV
      row[j] = to_f32(from_f32<T>(QUANT ? e * __ldg(vsb + j) : e));
    }
    sum = block_reduce<false>(sum, red);
    if (threadIdx.x == 0) lsum[r] = sum;
  }
  __syncthreads();

  // ---- pass 3: PV, 16-byte loads, TPR threads per value row ----------------
  const int d0 = (threadIdx.x % TPR) * 4;
  const int slice = threadIdx.x / TPR;
  float acc[MAXQ][4];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 4
  for (int j = slice; j < n_keys; j += SLICES) {
    const float4 v4 = load4(vb + (long long)j * D + d0);
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r < tq) {
        const float pj = sc[r * n_keys + j];
        acc[r][0] += pj * v4.x;
        acc[r][1] += pj * v4.y;
        acc[r][2] += pj * v4.z;
        acc[r][3] += pj * v4.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXQ; ++r)
    if (r < tq)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[(slice * tq + r) * D + d0 + c] = acc[r][c];
  __syncthreads();
  for (int i = threadIdx.x; i < tq * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float tot = 0.f;
    for (int sl = 0; sl < SLICES; ++sl) tot += part[(sl * tq + r) * D + d];
    const float l = lsum[r] == 0.f ? 1.f : lsum[r];
    o[(long long)bh * tq * D + i] = from_f32<T>(tot / l);
  }
}

long long smem_bytes(int head_dim, int tq, int s_len) {
  const int slices = THREADS / (head_dim / 4);
  return 4LL * ((long long)MAXQ * head_dim + 32 + MAXQ
                + (long long)slices * tq * head_dim + (long long)tq * s_len);
}

template <int D, typename T, typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* pos, int layer, int batch,
           int heads, int hkv, int tq, int s_len, float scale,
           cudaStream_t stream) {
  const long long smem = smem_bytes(D, tq, s_len);
  auto kern = decode_attn_kernel<D, T, KV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<batch * heads, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, static_cast<T*>(o), pos, layer,
      batch, heads, hkv, tq, s_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory bytes of one block (the wrapper checks it against the
// card's 227 KB before launching).
long long decode_smem(int head_dim, int tq, int s_len) {
  return smem_bytes(head_dim, tq, s_len);
}

// q, o [B, H, Tq, D]; k, v [L, B, Hkv, S, D]; pos [B] int32 on the device;
// all contiguous. dtype 0 = float32, 1 = bfloat16; head_dim in {16, 32,
// 64, 128}; 1 <= Tq <= 16. Returns cudaGetLastError() after the launch.
int decode_attention_stacked(const void* q, const void* k, const void* v,
                             void* o, const int* pos, int layer, int batch,
                             int heads, int hkv, int tq, int s_len,
                             int head_dim, float scale, int dtype,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tq < 1 || tq > MAXQ) return (int)cudaErrorInvalidValue;
#define DEC_CASE(DIM)                                                       \
  case DIM:                                                                 \
    return dtype == 0                                                       \
        ? launch<DIM, float, float, false>(q, k, v, nullptr, nullptr, o,    \
                                           pos, layer, batch, heads, hkv,   \
                                           tq, s_len, scale, s)             \
        : launch<DIM, __nv_bfloat16, __nv_bfloat16, false>(                 \
              q, k, v, nullptr, nullptr, o, pos, layer, batch, heads, hkv,  \
              tq, s_len, scale, s);
  switch (head_dim) {
    DEC_CASE(16)
    DEC_CASE(32)
    DEC_CASE(64)
    DEC_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DEC_CASE
}

// The int8 arm: q, o [B, H, Tq, D] float32 or bfloat16 (dtype 0 / 1); k, v
// int8 [L, B, Hkv, S, D]; ks, vs float32 [L, B, Hkv, S]; the rest as
// decode_attention_stacked. Returns cudaGetLastError() after the launch.
int decode_attention_stacked_q8(const void* q, const void* k, const void* ks,
                                const void* v, const void* vs, void* o,
                                const int* pos, int layer, int batch,
                                int heads, int hkv, int tq, int s_len,
                                int head_dim, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tq < 1 || tq > MAXQ) return (int)cudaErrorInvalidValue;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
#define Q8_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return dtype == 0                                                       \
        ? launch<DIM, float, int8_t, true>(q, k, v, ksf, vsf, o, pos,       \
                                           layer, batch, heads, hkv, tq,    \
                                           s_len, scale, s)                 \
        : launch<DIM, __nv_bfloat16, int8_t, true>(                         \
              q, k, v, ksf, vsf, o, pos, layer, batch, heads, hkv, tq,      \
              s_len, scale, s);
  switch (head_dim) {
    Q8_CASE(16)
    Q8_CASE(32)
    Q8_CASE(64)
    Q8_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef Q8_CASE
}

}  // extern "C"
