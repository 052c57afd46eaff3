// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, float32
// accumulation, float32 or bfloat16 inputs.
//
// Replaces the TPU kernels audax/ops/attention.py:_dq_kernel (K7) and
// _dkv_kernel (K8), both launched by _bwd_pallas. For q, dO [B, Hq, Tq, D],
// k, v [B, Hkv, Tk, D], the forward's lse [B*Hq, Tq] and
// delta = rowsum(dO * O) [B*Hq, Tq] (float32) they recompute
//
//   P  = exp(scale * Q K^T - lse)          (keys j >= Tk masked; j > i when
//   dP = dO V^T                             causal, Tq == Tk)
//   dS = P * (dP - delta) * scale
//
// and write dQ = dS K (K7) and dK = dS^T Q, dV = P^T dO (K8). As on the
// TPU, dS is cast to K's dtype before dS K, to Q's dtype before dS^T Q, and
// P to dO's dtype before P^T dO (bfloat16 rounds them; a no-op in float32).
// The q-head group of a grouped-query KV head is folded into one dK/dV
// inside the block, so no repeat of K/V is ever materialised.
//
// What bounds it on this card: at the encoder's shape [4, 8, 1500, 64] the
// two kernels do 14*B*H*T*T*D = 64.5 GFLOP (6 in dQ, 8 in dK/dV) against
// 31 MB of operands, so they are bound by operations. Here they run as
// float32 FMAs on the CUDA cores (67 TFLOP/s). The tensor cores take the
// tiles of 64 query rows (K7) or keys (K8): float32 in 3xTF32, which keeps
// float32 parity (csrc/flash_bwd_tf32x3.cu; one TF32 pass would not),
// bfloat16 on wgmma (csrc/flash_bwd_sm90.cu, also at 128). This body keeps
// the float32 tiles of 32 or 128 rows or keys, the bfloat16 tiles wgmma
// cannot take (K7 at 32 query rows, K8 at 32 keys) -- bfloat16 inputs
// widened to float32 in shared memory -- and a caller that asks for it by
// name (chip_smoke.py's A/B of the bodies).
//
// Design: both kernels follow flash_fwd.cu's layout -- 4 warps, tiles
// staged in shared memory as float32 with rows padded to D+4 floats (float4
// reads free of bank conflicts), four rows scored at a time with lane L
// taking columns L, L+32, ... of the tile, and the recomputed P or dS passed
// through a per-warp shared buffer into the accumulating product, whose
// float32 sums stay in registers (lane L holds dims L, L+32, ...).
//
//   K7: one block per (batch*q-head, tile of BQ query rows); it loops over
//       BK-key tiles of K and V, each warp accumulating dQ for its BQ/4
//       rows. Causal mode skips the key tiles wholly above the diagonal.
//   K8: one block per (batch*kv-head, tile of BK keys); it loops over the
//       group's q heads and their BQ-row query tiles, each warp
//       accumulating dK and dV for its BK/4 keys. Causal mode starts at the
//       first query tile that reaches the block's first key.
//
// The tiles (BQ, BK) are template parameters; dispatch() lists the
// instantiated set, every caller-set tile at head_dim 64, which
// ops/attention.py's body table (BWD_BODIES) holds too.
//
// Every output element is written by exactly one block and no float atomics
// are used, so the gradients are the same from run to run.
//
// The file builds two libraries (ops/native.py): with AUDAX_FLASH_BWD_DQ it
// holds K7 and flash_bwd_dq, with AUDAX_FLASH_BWD_DKV K8 and flash_bwd_dkv,
// so that the two kernels' tile instantiations compile in parallel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RG = 4;            // rows scored together

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
// the TPU kernels' casts before each product (a no-op for float32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// rows [r0, r0 + rows) of a [n, D] matrix into a [rows][DP] float tile,
// zero past row n
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int n) {
  constexpr int DP = D + 4;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * DP + d] =
        (r0 + r < n) ? to_f32(src[(long long)(r0 + r) * D + d]) : 0.f;
  }
}

// ------------------------------------------------------------------- K7 --

template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int group, int tq, int tk, float scale,
                    int causal) {
  constexpr int DP = D + 4;
  constexpr int DPL = (D + 31) / 32;      // accumulated dims per lane
  constexpr int RPW = BQ / WARPS;         // query rows per warp
  constexpr int NC = BK / 32;             // keys per lane in a tile
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][DP]
  float* dos = qs + BQ * DP;              // [BQ][DP]
  float* ks = dos + BQ * DP;              // [BK][DP]
  float* vs = ks + BK * DP;               // [BK][DP]
  float* lses = vs + BK * DP;             // [BQ]
  float* dlts = lses + BQ;                // [BQ]
  float* ps = dlts + BQ;                  // [WARPS][RG][BK]

  const int bh = blockIdx.y;              // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kg = k + (long long)bkv * tk * D;
  const T* vg = v + (long long)bkv * tk * D;

  load_tile<D>(qs, q + (long long)bh * tq * D, q0, BQ, tq);
  load_tile<D>(dos, dout + (long long)bh * tq * D, q0, BQ, tq);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < tq;
    lses[r] = in ? lse[(long long)bh * tq + q0 + r] : 0.f;
    dlts[r] = in ? delta[(long long)bh * tq + q0 + r] : 0.f;
  }

  float acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  float* pw = ps + warp * RG * BK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                      // previous tile fully consumed
    load_tile<D>(ks, kg, k0, BK, tk);
    load_tile<D>(vs, vg, k0, BK, tk);
    __syncthreads();

#pragma unroll
    for (int g0 = 0; g0 < RPW; g0 += RG) {
      const int row0 = warp * RPW + g0;   // row within the block's tile
      float s[RG][NC], dp[RG][NC];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 kc[NC], vc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          kc[c] = *reinterpret_cast<const float4*>(ks + (lane + 32 * c) * DP + d);
          vc[c] = *reinterpret_cast<const float4*>(vs + (lane + 32 * c) * DP + d);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (row0 + r) * DP + d);
          const float4 ov =
              *reinterpret_cast<const float4*>(dos + (row0 + r) * DP + d);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            s[r][c] += dot4(qv, kc[c]);
            dp[r][c] += dot4(ov, vc[c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const int row = q0 + row0 + r;
        const float l = lses[row0 + r], dl = dlts[row0 + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = k0 + lane + 32 * c;
          const bool ok = col < tk && (!causal || col <= row);
          const float p = ok ? expf(s[r][c] * scale - l) : 0.f;
          pw[r * BK + lane + 32 * c] =
              round_to<T>(p * (dp[r][c] - dl) * scale);
        }
      }
      __syncwarp();
      for (int j = 0; j < BK; j += 4) {
        float4 dsr[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          dsr[r] = *reinterpret_cast<const float4*>(pw + r * BK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float k0v = ks[(j + 0) * DP + d], k1v = ks[(j + 1) * DP + d];
            const float k2v = ks[(j + 2) * DP + d], k3v = ks[(j + 3) * DP + d];
#pragma unroll
            for (int r = 0; r < RG; ++r)
              acc[g0 + r][i] += dsr[r].x * k0v + dsr[r].y * k1v +
                                dsr[r].z * k2v + dsr[r].w * k3v;
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
    T* dqg = dq + ((long long)bh * tq + row) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dqg[d] = from_f32<T>(acc[r][i]);
    }
  }
}

// ------------------------------------------------------------------- K8 --

template <int D, int BQ, int BKV, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int tq, int tk,
                     float scale, int causal) {
  constexpr int DP = D + 4;
  constexpr int DPL = (D + 31) / 32;
  constexpr int KPW = BKV / WARPS;        // keys per warp
  constexpr int NQ = BQ / 32;             // query rows per lane in a tile
  extern __shared__ float smem[];
  float* ks = smem;                       // [BKV][DP]
  float* vs = ks + BKV * DP;              // [BKV][DP]
  float* qs = vs + BKV * DP;              // [BQ][DP]
  float* dos = qs + BQ * DP;              // [BQ][DP]
  float* lses = dos + BQ * DP;            // [BQ]
  float* dlts = lses + BQ;                // [BQ]
  float* pbuf = dlts + BQ;                // [WARPS][RG][BQ]
  float* dsbuf = pbuf + WARPS * RG * BQ;  // [WARPS][RG][BQ]

  const int bkv = blockIdx.y;             // b * hkv + kv head
  const int b = bkv / hkv, hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(ks, k + (long long)bkv * tk * D, k0, BKV, tk);
  load_tile<D>(vs, v + (long long)bkv * tk * D, k0, BKV, tk);

  float acc_k[KPW][DPL], acc_v[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  const int n_qt = (tq + BQ - 1) / BQ;
  const int first_qt = causal ? k0 / BQ : 0;   // earlier rows see no key here
  float* pw = pbuf + warp * RG * BQ;
  float* dsw = dsbuf + warp * RG * BQ;

  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + hk * group + g;
    const T* qg = q + (long long)bh * tq * D;
    const T* dog = dout + (long long)bh * tq * D;
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                    // previous tile fully consumed
      load_tile<D>(qs, qg, q0, BQ, tq);
      load_tile<D>(dos, dog, q0, BQ, tq);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const bool in = q0 + r < tq;
        lses[r] = in ? lse[(long long)bh * tq + q0 + r] : 0.f;
        dlts[r] = in ? delta[(long long)bh * tq + q0 + r] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int g0 = 0; g0 < KPW; g0 += RG) {
        const int key0 = warp * KPW + g0;   // key within the block's tile
        float s[RG][NQ], dp[RG][NQ];
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int c = 0; c < NQ; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          float4 qc[NQ], oc[NQ];
#pragma unroll
          for (int c = 0; c < NQ; ++c) {
            qc[c] = *reinterpret_cast<const float4*>(qs + (lane + 32 * c) * DP + d);
            oc[c] = *reinterpret_cast<const float4*>(dos + (lane + 32 * c) * DP + d);
          }
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float4 kv =
                *reinterpret_cast<const float4*>(ks + (key0 + r) * DP + d);
            const float4 vv =
                *reinterpret_cast<const float4*>(vs + (key0 + r) * DP + d);
#pragma unroll
            for (int c = 0; c < NQ; ++c) {
              s[r][c] += dot4(qc[c], kv);
              dp[r][c] += dot4(oc[c], vv);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int col = k0 + key0 + r;
#pragma unroll
          for (int c = 0; c < NQ; ++c) {
            const int rr = lane + 32 * c;   // row within the query tile
            const int row = q0 + rr;
            const bool ok = row < tq && col < tk && (!causal || col <= row);
            const float p = ok ? expf(s[r][c] * scale - lses[rr]) : 0.f;
            pw[r * BQ + rr] = round_to<T>(p);
            dsw[r * BQ + rr] = round_to<T>(p * (dp[r][c] - dlts[rr]) * scale);
          }
        }
        __syncwarp();
        for (int j = 0; j < BQ; j += 4) {
          float4 pr[RG], dsr[RG];
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            pr[r] = *reinterpret_cast<const float4*>(pw + r * BQ + j);
            dsr[r] = *reinterpret_cast<const float4*>(dsw + r * BQ + j);
          }
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              const float o0 = dos[(j + 0) * DP + d], o1 = dos[(j + 1) * DP + d];
              const float o2 = dos[(j + 2) * DP + d], o3 = dos[(j + 3) * DP + d];
              const float x0 = qs[(j + 0) * DP + d], x1 = qs[(j + 1) * DP + d];
              const float x2 = qs[(j + 2) * DP + d], x3 = qs[(j + 3) * DP + d];
#pragma unroll
              for (int r = 0; r < RG; ++r) {
                acc_v[g0 + r][i] += pr[r].x * o0 + pr[r].y * o1 +
                                    pr[r].z * o2 + pr[r].w * o3;
                acc_k[g0 + r][i] += dsr[r].x * x0 + dsr[r].y * x1 +
                                    dsr[r].z * x2 + dsr[r].w * x3;
              }
            }
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int key = k0 + warp * KPW + r;
    if (key >= tk) continue;
    T* dkg = dk + ((long long)bkv * tk + key) * D;
    T* dvg = dv + ((long long)bkv * tk + key) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dkg[d] = from_f32<T>(acc_k[r][i]);
        dvg[d] = from_f32<T>(acc_v[r][i]);
      }
    }
  }
}

// ------------------------------------------------------------- launches --

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;                      // dq; or dk, dv
  int batch, hq, hkv, tq, tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

// cudaFuncSetAttribute once per instantiation, on its first (eager) launch:
// a later call captured into a CUDA graph issues nothing but the launch
template <typename K>
int allow_smem(K kern, int smem, bool& ready) {
  if (ready) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ready = true;
  return 0;
}

template <int D, int BQ, int BK, typename T>
int launch_dq(const Args& a) {
  constexpr int DP = D + 4;
  constexpr int smem =
      4 * (2 * BQ * DP + 2 * BK * DP + 2 * BQ + WARPS * RG * BK);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dq_kernel<D, BQ, BK, T>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tq + BQ - 1) / BQ, a.batch * a.hq);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.hq, a.hq / a.hkv, a.tq, a.tk,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BKV, typename T>
int launch_dkv(const Args& a) {
  constexpr int DP = D + 4;
  constexpr int smem =
      4 * (2 * BKV * DP + 2 * BQ * DP + 2 * BQ + 2 * WARPS * RG * BQ);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dkv_kernel<D, BQ, BKV, T>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tk + BKV - 1) / BKV, a.batch * a.hkv);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.hq, a.hkv,
      a.tq, a.tk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The instantiated (head_dim, block_q, block_k) set of each kernel: the
// 3 x 3 grid of 32/64/128 at D = 64
#if defined(AUDAX_FLASH_BWD_DKV)
#define AUDAX_LAUNCH launch_dkv
#else
#define AUDAX_LAUNCH launch_dq
#endif

template <typename T>
int dispatch(int d, int bq, int bk, const Args& a) {
#define AUDAX_BWD(D_, BQ_, BK_)                                          \
  if (d == D_ && bq == BQ_ && bk == BK_)                                 \
    return AUDAX_LAUNCH<D_, BQ_, BK_, T>(a);
  AUDAX_BWD(64, 32, 32)
  AUDAX_BWD(64, 32, 64)
  AUDAX_BWD(64, 32, 128)
  AUDAX_BWD(64, 64, 32)
  AUDAX_BWD(64, 64, 64)
  AUDAX_BWD(64, 64, 128)
  AUDAX_BWD(64, 128, 32)
  AUDAX_BWD(64, 128, 64)
  AUDAX_BWD(64, 128, 128)
#undef AUDAX_BWD
  return (int)cudaErrorInvalidValue;
}

int run(int head_dim, int dtype, int bq, int bk, const Args& a) {
  if (dtype == 0) return dispatch<float>(head_dim, bq, bk, a);
  return dispatch<__nv_bfloat16>(head_dim, bq, bk, a);
}

}  // namespace

extern "C" {

// q, dout [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D]; lse, delta [B*Hq, Tq]
// float32; dq like q; dk, dv like k; all contiguous. dtype 0 = float32,
// 1 = bfloat16. (head_dim, block_q, block_k) must be one of dispatch's set.
// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for an unsupported set).
#if defined(AUDAX_FLASH_BWD_DKV)
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int batch, int hq, int hkv, int tq,
                  int tk, int head_dim, float scale, int causal, int dtype,
                  int block_q, int block_k, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, tq, tk,
               scale, causal, (cudaStream_t)stream};
  return run(head_dim, dtype, block_q, block_k, a);
}
#else
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int batch, int hq, int hkv, int tq, int tk,
                 int head_dim, float scale, int causal, int dtype,
                 int block_q, int block_k, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch, hq, hkv, tq,
               tk, scale, causal, (cudaStream_t)stream};
  return run(head_dim, dtype, block_q, block_k, a);
}
#endif

}  // extern "C"
