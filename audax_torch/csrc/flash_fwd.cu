// Flash-attention forward for Hopper (sm_90a): online softmax, float32
// accumulation, float32 or bfloat16 inputs.
//
// Replaces the TPU kernel audax/ops/attention.py:_fwd_kernel (the forward of
// flash_attention, called from _fwd, K2) at the tiles the tensor-core
// bodies do not take; its head folds (tools/attn_headfold_probe.py:
// _fold_kernel, P1) serve only an A/B against those bodies, which run
// every fold. For q [B, Hq, Tq, D] and k, v [B, Hkv, tk_stride, D] it
// writes
//
//   o[b, h, i]  = sum_j softmax_j(scale * q_i . k_j) v_j      (kv head h / G)
//   lse[b*Hq+h, i] = m_i + log(l_i)
//
// with keys j >= kv_len masked (a ragged Tk needs no padding; kv_len may be
// below the row stride tk_stride of K/V, and key tiles wholly past kv_len are
// never read), and j > i masked when causal (Tq == Tk). Masked scores are
// -1e30 (not -inf, which would make the m recurrence produce NaN); a row
// that sees no key (l == 0) divides by 1. As on the TPU, the probabilities
// are cast to V's dtype before the PV product (bfloat16 rounds them), l sums
// them unrounded, and the output is cast to q's dtype.
//
// What bounds it on this card: at Whisper-base's encoder shape [4, 6, 1500,
// 64] the work is 4*B*H*T*T*D = 13.8 GFLOP against 9 MB of q, k, v and o,
// so it is bound by operations. Here those run on the CUDA cores (67
// TFLOP/s), because one TF32 pass on the tensor cores would break parity
// with the float32 reference. Three passes keep it: float32 at 64 query
// rows a block moved to the tensor cores in 3xTF32
// (csrc/flash_fwd_tf32x3.cu, at every head dim), and bfloat16 at 64 or
// 128 query rows to wgmma (csrc/flash_fwd_sm90.cu), the folds of both
// dtypes with them. This body keeps float32 at 32 and 128 query rows and
// bfloat16 at 32 (widened to float32 in shared memory);
// ops/attention.py:FWD_BODIES routes each call, and
// launch_flash_forward(..., body="cuda_core") forces this body, its folds
// included, for an A/B.
//
// Design: one warp group (4 warps) per (batch*head, tile of BQ query rows);
// a loop over BK-key tiles of K and V staged in shared memory (float32, rows
// padded to D+4 floats so float4 reads are free of bank conflicts). Each
// warp owns BQ/4 query rows and keeps their running max m, sum l and output
// accumulator in registers: lane L holds dims L, L+32, ... of each row.
// Scores are computed four rows at a time, lane L taking keys L, L+32, ...
// (BK/32 of them), so one float4 of K feeds 4*BK/32 FMAs; the probabilities
// go through a per-warp shared buffer for the PV product. Whole key tiles
// above the diagonal are skipped in causal mode, as the TPU kernel's pl.when
// did.
//
// Tiles and folding are template parameters (BQ, BK, FOLD). FOLD = f puts f
// consecutive heads of the fused B*H axis in one block of 4*f warps: warp
// group g owns head blockIdx.y*f + g, with its own q, K/V and probability
// buffers, and the f heads' K/V tiles are staged together under one barrier
// per key tile (the TPU probe's fold: independent heads per grid step).
// FOLD = 1 is the kernel without folding. Shared memory grows f-fold, so
// fold 4 fits only the 64x64 tile at D = 64 (221,184 of 232,448 B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;         // warps per head (one warp group)
constexpr int GROUP = WARPS * 32;
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

// floats of shared memory one warp group uses
template <int D, int BQ, int BK>
__host__ __device__ constexpr int group_floats() {
  return BQ * (D + 4) + BK * (D + 4) + BK * D + WARPS * RG * BK;
}

template <int D, int BQ, int BK, int FOLD, typename T>
__global__ void __launch_bounds__(GROUP * FOLD)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int group, int tq,
                 int kv_len, int tk_stride, float scale, int causal) {
  constexpr int DP = D + 4;               // padded smem row (float4 aligned)
  constexpr int DPL = (D + 31) / 32;      // output dims per lane
  constexpr int RPW = BQ / WARPS;         // query rows per warp
  constexpr int NC = BK / 32;             // keys per lane in a tile
  extern __shared__ float smem[];
  const int g = threadIdx.x / GROUP;      // warp group = folded head
  const int tid = threadIdx.x % GROUP;
  float* qs = smem + g * group_floats<D, BQ, BK>();   // [BQ][DP]
  float* ks = qs + BQ * DP;               // [BK][DP]
  float* vs = ks + BK * DP;               // [BK][D]
  float* ps = vs + BK * D;                // [WARPS][RG][BK]

  const int bh = blockIdx.y * FOLD + g;   // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const int warp = tid / 32, lane = tid % 32;
  const T* qg = q + ((long long)bh * tq) * D;
  const T* kg = k + ((long long)bkv * tk_stride) * D;
  const T* vg = v + ((long long)bkv * tk_stride) * D;

  for (int i = tid; i < BQ * D; i += GROUP) {
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

  // every warp group of a block shares q0, so all take the same tile count
  // and meet every barrier
  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  float* pw = ps + warp * RG * BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                      // previous tile fully consumed
    for (int i = tid; i < BK * D; i += GROUP) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < kv_len;
      ks[r * DP + d] = in ? to_f32(kg[(long long)(k0 + r) * D + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[(long long)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int g0 = 0; g0 < RPW; g0 += RG) {
      const int row0 = warp * RPW + g0;   // row within the block's tile
      float s[RG][NC];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 kc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          kc[c] = *reinterpret_cast<const float4*>(ks + (lane + 32 * c) * DP + d);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (row0 + r) * DP + d);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            s[r][c] += qv.x * kc[c].x + qv.y * kc[c].y + qv.z * kc[c].z +
                       qv.w * kc[c].w;
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int row = q0 + row0 + r;
        float pc[NC];
        bool ok[NC];
        float smax = NEG;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = k0 + lane + 32 * c;
          ok[c] = col < kv_len && (!causal || col <= row);
          s[r][c] = ok[c] ? s[r][c] * scale : NEG;
          smax = fmaxf(smax, s[r][c]);
        }
        const float m_prev = m[g0 + r];
        const float m_new = fmaxf(m_prev, warp_max(smax));
        const float alpha = expf(m_prev - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          pc[c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
          psum += pc[c];
        }
        l[g0 + r] = alpha * l[g0 + r] + warp_sum(psum);
        m[g0 + r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g0 + r][i] *= alpha;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          pw[r * BK + lane + 32 * c] = round_to<T>(pc[c]);
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

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int batch, hq, hkv, tq, kv_len, tk_stride;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int BQ, int BK, int FOLD>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * FOLD * group_floats<D, BQ, BK>();
}

template <int D, int BQ, int BK, int FOLD, typename T>
int launch(const Args& a) {
  constexpr int smem = smem_bytes<D, BQ, BK, FOLD>();
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_fwd_kernel<D, BQ, BK, FOLD, T>;
  // once per instantiation, on its first (eager) launch: nothing but the
  // launch itself is issued when a later call is captured into a CUDA graph
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  if ((a.batch * a.hq) % FOLD) return (int)cudaErrorInvalidValue;
  dim3 grid((a.tq + BQ - 1) / BQ, a.batch * a.hq / FOLD);
  kern<<<grid, GROUP * FOLD, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.hq,
      a.hq / a.hkv, a.tq, a.kv_len, a.tk_stride, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The instantiated (head_dim, block_q, block_k, fold) set; ops/attention.py
// holds the same set (TILES, FOLDS, resolve_tile) and validates a call
// against it before it reaches the card.
template <typename T>
int dispatch(int d, int bq, int bk, int fold, const Args& a) {
#define AUDAX_FWD(D_, BQ_, BK_, F_)                               \
  if (d == D_ && bq == BQ_ && bk == BK_ && fold == F_)            \
    return launch<D_, BQ_, BK_, F_, T>(a);
  AUDAX_FWD(16, 64, 64, 1)
  AUDAX_FWD(32, 64, 64, 1)
  AUDAX_FWD(128, 64, 64, 1)
  AUDAX_FWD(64, 64, 64, 1)
  AUDAX_FWD(64, 32, 32, 1)
  AUDAX_FWD(64, 32, 64, 1)
  AUDAX_FWD(64, 32, 128, 1)
  AUDAX_FWD(64, 64, 32, 1)
  AUDAX_FWD(64, 64, 128, 1)
  AUDAX_FWD(64, 128, 32, 1)
  AUDAX_FWD(64, 128, 64, 1)
  AUDAX_FWD(64, 128, 128, 1)
  AUDAX_FWD(64, 64, 64, 2)
  AUDAX_FWD(64, 64, 64, 4)
#undef AUDAX_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Hq, Tq, D], k/v [B, Hkv, tk_stride, D] (keys >= kv_len masked), o
// like q, lse [B*Hq, Tq] float32; all contiguous. dtype 0 = float32, 1 =
// bfloat16. (head_dim, block_q, block_k, fold) must be one of dispatch's
// set, and fold > 1 needs B*Hq % fold == 0. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported set).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch, int hq, int hkv, int tq, int kv_len,
              int tk_stride, int head_dim, float scale, int causal, int dtype,
              int block_q, int block_k, int fold, void* stream) {
  const Args a{q, k, v, o, lse, batch, hq, hkv, tq, kv_len, tk_stride,
               scale, causal, (cudaStream_t)stream};
  if (dtype == 0) return dispatch<float>(head_dim, block_q, block_k, fold, a);
  return dispatch<__nv_bfloat16>(head_dim, block_q, block_k, fold, a);
}

}  // extern "C"
