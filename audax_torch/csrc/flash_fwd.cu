// Flash-attention forward for Hopper (sm_90a): online softmax, float32
// accumulation, float32 or bfloat16 inputs.
//
// Replaces the TPU kernel audax/ops/attention.py:_fwd_kernel (the forward of
// flash_attention, called from _fwd). For q [B, Hq, Tq, D] and k, v
// [B, Hkv, Tk, D] it writes
//
//   o[b, h, i]  = sum_j softmax_j(scale * q_i . k_j) v_j      (kv head h / G)
//   lse[b*Hq+h, i] = m_i + log(l_i)
//
// with keys j >= Tk masked (a ragged Tk needs no padding), and j > i masked
// when causal (Tq == Tk). Masked scores are -1e30 (not -inf, which would
// make the m recurrence produce NaN); a row that sees no key (l == 0)
// divides by 1. As on the TPU, the probabilities are cast to V's dtype
// before the PV product (bfloat16 rounds them), l sums them unrounded, and
// the output is cast to q's dtype.
//
// What bounds it on this card: at Whisper's encoder shape [4, 6, 1500, 64]
// the work is 4*B*H*T*T*D = 6.9 GFLOP against 9 MB of q, k, v and o, so it
// is bound by operations. In float32 those run on the CUDA cores (67
// TFLOP/s), because TF32 tensor cores would break parity with the float32
// reference; bfloat16 inputs are widened to float32 in shared memory and
// take the same path here -- moving them to wgmma is later work.
//
// Design: one block of 4 warps per (batch*head, tile of 64 query rows); a
// loop over 64-key tiles of K and V staged in shared memory (float32, rows
// padded to D+4 floats so float4 reads are free of bank conflicts). Each
// warp owns 16 query rows and keeps their running max m, sum l and output
// accumulator in registers: lane L holds dims L, L+32, ... of each row.
// Scores are computed four rows at a time, lane L taking keys L and L+32,
// so one float4 of K feeds eight FMAs; the probabilities go through a
// per-warp shared buffer for the PV product. Whole key tiles above the
// diagonal are skipped in causal mode, as the TPU kernel's pl.when did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // query rows per warp
constexpr int RG = 4;            // rows per score group
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// P cast to V's dtype before PV (a no-op for float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <int D, typename T>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int group, int tq, int tk,
                 float scale, int causal) {
  constexpr int DP = D + 4;               // padded smem row (float4 aligned)
  constexpr int DPL = (D + 31) / 32;      // output dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][DP]
  float* ks = qs + BQ * DP;               // [BK][DP]
  float* vs = ks + BK * DP;               // [BK][D]
  float* ps = vs + BK * D;                // [WARPS][RG][BK]

  const int bh = blockIdx.y;              // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qg = q + ((long long)bh * tq) * D;
  const T* kg = k + ((long long)bkv * tk) * D;
  const T* vg = v + ((long long)bkv * tk) * D;

  for (int i = threadIdx.x; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] = (q0 + r < tq) ? to_f32(qg[(long long)(q0 + r) * D + d])
                                   : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  float* pw = ps + warp * RG * BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                      // previous tile fully consumed
    for (int i = threadIdx.x; i < BK * D; i += WARPS * 32) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < tk;
      ks[r * DP + d] = in ? to_f32(kg[(long long)(k0 + r) * D + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[(long long)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int g0 = 0; g0 < RPW; g0 += RG) {
      const int row0 = warp * RPW + g0;   // row within the block's tile
      float s[RG][2];
#pragma unroll
      for (int r = 0; r < RG; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(ks + lane * DP + d);
        const float4 kb =
            *reinterpret_cast<const float4*>(ks + (lane + 32) * DP + d);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (row0 + r) * DP + d);
          s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
          s[r][1] += qv.x * kb.x + qv.y * kb.y + qv.z * kb.z + qv.w * kb.w;
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int row = q0 + row0 + r;
        float p2[2];
        bool ok[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + lane + 32 * c;
          ok[c] = col < tk && (!causal || col <= row);
          s[r][c] = ok[c] ? s[r][c] * scale : NEG;
        }
        const float m_prev = m[g0 + r];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[r][0], s[r][1])));
        const float alpha = expf(m_prev - m_new);
#pragma unroll
        for (int c = 0; c < 2; ++c) p2[c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        l[g0 + r] = alpha * l[g0 + r] + warp_sum(p2[0] + p2[1]);
        m[g0 + r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g0 + r][i] *= alpha;
        pw[r * BK + lane] = round_to<T>(p2[0]);
        pw[r * BK + lane + 32] = round_to<T>(p2[1]);
      }
      __syncwarp();
      for (int j = 0; j < BK; j += 4) {
        float4 pr[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          pr[r] = *reinterpret_cast<const float4*>(pw + r * BK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float v0 = vs[(j + 0) * D + d], v1 = vs[(j + 1) * D + d];
            const float v2 = vs[(j + 2) * D + d], v3 = vs[(j + 3) * D + d];
#pragma unroll
            for (int r = 0; r < RG; ++r)
              acc[g0 + r][i] += pr[r].x * v0 + pr[r].y * v1 + pr[r].z * v2 +
                                pr[r].w * v3;
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= tq) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
    T* og = o + ((long long)bh * tq + row) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) og[d] = from_f32<T>(acc[r][i] / ls);
    }
    if (lane == 0) lse[(long long)bh * tq + row] = m[r] + logf(ls);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int hq, int hkv, int tq, int tk, float scale,
           int causal, cudaStream_t stream) {
  constexpr int DP = D + 4;
  const int smem = 4 * (BQ * DP + BK * DP + BK * D + WARPS * RG * BK);
  auto kern = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + BQ - 1) / BQ, batch * hq);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, hq, hq / hkv, tq, tk,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int batch, int hq, int hkv, int tq, int tk,
             float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, o, lse, batch, hq, hkv, tq, tk, scale, causal, s);
    case 32: return launch<32, T>(q, k, v, o, lse, batch, hq, hkv, tq, tk, scale, causal, s);
    case 64: return launch<64, T>(q, k, v, o, lse, batch, hq, hkv, tq, tk, scale, causal, s);
    case 128: return launch<128, T>(q, k, v, o, lse, batch, hq, hkv, tq, tk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, Hq, Tq, D], k/v [B, Hkv, Tk, D], o like q, lse [B*Hq, Tq] float32;
// all contiguous. dtype 0 = float32, 1 = bfloat16. head_dim in {16, 32,
// 64, 128}. Returns cudaGetLastError() after the launch.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch, int hq, int hkv, int tq, int tk,
              int head_dim, float scale, int causal, int dtype,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(head_dim, q, k, v, o, lse, batch, hq, hkv, tq, tk,
                           scale, causal, s);
  return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch, hq, hkv,
                                 tq, tk, scale, causal, s);
}

}  // extern "C"
