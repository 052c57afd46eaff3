// Flash-attention backward for Hopper (sm_90a) on the tensor cores: the
// bfloat16 bodies of K7 (dQ) and K8 (dK/dV), with wgmma products and
// float32 accumulators.
//
// Replaces the TPU kernels audax/ops/attention.py:_dq_kernel and
// _dkv_kernel (both launched by _bwd_pallas) for bfloat16 inputs at the
// tiles ops/attention.py's table BWD_BODIES gives this body: K7 at 64 or
// 128 query rows, K8 at 64 or 128 keys. csrc/flash_bwd.cu keeps float32
// and the bfloat16 tiles wgmma cannot take (K7 at 32 rows, K8 at 32 keys).
// For q, dO [B, Hq, Tq, D], k, v [B, Hkv, Tk, D], the forward's lse
// [B*Hq, Tq] and delta = rowsum(dO * O) [B*Hq, Tq] (float32) they compute
//
//   P  = exp(scale * Q K^T - lse)     (keys j >= Tk masked; j > i when
//   dP = dO V^T                        causal, Tq == Tk)
//   dS = P * (dP - delta) * scale
//
// and write dQ = bf16(dS) K (K7), dK = bf16(dS)^T Q and dV = bf16(P)^T dO
// (K8): every product takes bfloat16 operands and sums in float32, and the
// casts are the TPU's (dS to K's dtype before dS K, to Q's before dS^T Q,
// P to dO's before P^T dO). A kv head's dK/dV sums its whole q-head group
// inside the block. Every output element is written by exactly one block,
// with no atomics, so the gradients are the same from run to run.
//
// What bounds them on this card: at Whisper-small's encoder shape [8, 12,
// 1500, 64] K7 does 6 and K8 8 operations per query-key pair and head dim
// (82.9 and 110.6 GFLOP) against 9 to 12 MB of operands -- thousands of
// operations per byte, so the bf16 tensor cores (989 TFLOP/s dense) bound
// both. The CUDA-core body runs the same products as float32 FMAs (67
// TFLOP/s peak).
//
// Design (the pieces are csrc/sm90_wgmma.cuh's, as in K2's wgmma body):
// operands in shared memory in the 128-byte-swizzled layout, written by
// cp.async (rows past the end zero-filled), a head dim below 64 zero-padded
// to one 64-column block (the padding adds nothing to S or dP and is never
// stored), 128 as two.
//
//   K7: one block owns (b*hq, BQ = 64 or 128 query rows), one consumer
//       warp group per 64 rows. Q and dO are staged once; lse and delta of
//       a thread's two rows stay in registers. K/V tiles of BK keys go
//       through a two-stage cp.async ring. Per 64-key slice of a tile (32
//       at BK = 32):
//         S  = Q K^T, dP = dO V^T   wgmma_ss, K and V the K-major B
//         P, dS on the fragments    (masked only on a slice that crosses
//                                    Tk or the diagonal)
//         dQ += bf16(dS) K          wgmma_rs_n64: dS from registers (the
//                                    S fragment layout is the A operand's),
//                                    K the transposed (MN-major) B from the
//                                    same tile -- no transpose is made.
//       Causal: the tiles wholly above the block's diagonal are never
//       loaded, and a warp group skips the slices above its own.
//   K8: computed transposed, so that no operand is transposed in memory.
//       One block owns (b*hkv, BK = 64 or 128 keys), one warp group per 64
//       keys. K and V are staged once; the block loops over the group's q
//       heads and their BQ-row query tiles, Q, dO, lse and delta in a
//       two-stage ring. Per slice of 64 query rows (32 at BQ = 32 or
//       D = 128, so that the two [64, D] accumulators and the slice fit in
//       registers):
//         S^T = K Q^T, dP^T = V dO^T   wgmma_ss, K and V the A operand,
//                                       Q and dO the K-major B
//         P^T, dS^T on the fragments   lse and delta are per column (query)
//                                       and read from shared memory; a
//                                       slice that crosses Tq, Tk or the
//                                       diagonal is masked, so query rows
//                                       past Tq (zero-filled, lse 0, where
//                                       exp(0 - 0) = 1) give P = 0
//         dV += bf16(P^T) dO, dK += bf16(dS^T) Q
//                                       wgmma_rs_n64, dO and Q the
//                                       transposed B.
//       Causal: the loop starts at the first query tile that reaches the
//       block's first key, and a warp group skips the slices whose every
//       query lies before its first key.
// The copy of the next tile is in flight while one computes. Each product
// is waited for before the next: the simple schedule, as K2's body; a
// producer warp and overlapped products are later work.
//
// The file builds two libraries (ops/native.py), as flash_bwd.cu does: with
// AUDAX_FLASH_BWD_DQ it holds K7's body and flash_bwd_dq_sm90, with
// AUDAX_FLASH_BWD_DKV K8's and flash_bwd_dkv_sm90, so that the two compile
// in parallel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory of K7: Q and dO, two stages of K and V, and 1024
// bytes to align the swizzle atoms (8 rows x 128 bytes) on 1024 bytes
__host__ __device__ constexpr int dq_smem(int d, int bq, int bk) {
  return 2 * padded_dim(d) * (2 * bq + 4 * bk) + 1024;
}
// of K8: K and V, two stages of Q and dO, two of lse and delta (float32)
__host__ __device__ constexpr int dkv_smem(int d, int bq, int bk) {
  return 2 * padded_dim(d) * (2 * bk + 4 * bq) + 16 * bq + 1024;
}
// query rows of one K8 product: 64, or 32 where the tile or the two
// [64, 128] accumulators leave no room for more
__host__ __device__ constexpr int dkv_slice(int d, int bq) {
  return (d == 128 || bq < 64) ? 32 : 64;
}

// ------------------------------------------------------------------- K7 --

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 64 * WG)
flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int hq, int group, int tq,
                         int tk, float scale, int causal) {
  constexpr int NT = BQ / 64 * WG;
  constexpr int DP = padded_dim(D);
  constexpr int NCB = DP / CB;          // column blocks (1 or 2)
  constexpr int SK = BK < 64 ? BK : 64; // keys of one product
  constexpr int NS = SK / 2;            // S (and dP) values per thread
  constexpr int PK = SK / 16;           // k16 steps of dS K
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  const uint32_t dos = qs + Q_BYTES;
  const uint32_t ks = dos + Q_BYTES;        // stage st: ks + st * KV_BYTES
  const uint32_t vs = ks + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / WG, t = tid % WG;
  const int lane = t % 32;
  const int bh = blockIdx.y;                // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const bf16* kg = k + (long long)bkv * tk * D;
  const bf16* vg = v + (long long)bkv * tk * D;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int row_lo = q0 + wg * 64;          // this warp group's first row
  const int r0 = row_lo + (t / 32) * 16 + lane / 4;   // and r0 + 8
  const int cq = 2 * (lane % 4);            // first column of a pair

  if (D < CB) {     // the padding columns stay zero; the copies skip them
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (qs - raw));
    for (int i = tid; i < (2 * Q_BYTES + 4 * KV_BYTES) / 16; i += NT)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  stage<D, BQ, NT>(qs, q + (long long)bh * tq * D, q0, tq, tid);
  stage<D, BQ, NT>(dos, dout + (long long)bh * tq * D, q0, tq, tid);
  stage<D, BK, NT>(ks, kg, 0, tk, tid);
  stage<D, BK, NT>(vs, vg, 0, tk, tid);
  cp_async_commit();

  // lse (times log2 e) and delta of the thread's two rows; rows past tq
  // read 0 and their dQ is never stored
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool in = row < tq;
    lr[h] = in ? lse[(long long)bh * tq + row] * LOG2E : 0.f;
    dl[h] = in ? delta[(long long)bh * tq + row] : 0.f;
  }
  const float sl = scale * LOG2E;

  float acc[NCB][32];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();        // tile j landed; tile j - 1 fully consumed
    if (j + 1 < n_tiles) {
      stage<D, BK, NT>(ks + (st ^ 1) * KV_BYTES, kg, (j + 1) * BK, tk, tid);
      stage<D, BK, NT>(vs + (st ^ 1) * KV_BYTES, vg, (j + 1) * BK, tk, tid);
    }
    cp_async_commit();
    const uint32_t kt = ks + st * KV_BYTES, vt = vs + st * KV_BYTES;
#pragma unroll
    for (int sub = 0; sub < BK / SK; ++sub) {
      const int c0 = j * BK + sub * SK;     // first key of this slice
      if (causal && c0 > row_lo + 63) break;  // above this group's diagonal
      float s[NS], dp[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t row_off = (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32;
        const uint32_t key_off = (kk / 4) * (BK * 128) + sub * (SK * 128) +
                                 (kk % 4) * 32;
        wgmma_ss<SK>(s, sw128_desc(qs + row_off), sw128_desc(kt + key_off),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t row_off = (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32;
        const uint32_t key_off = (kk / 4) * (BK * 128) + sub * (SK * 128) +
                                 (kk % 4) * 32;
        wgmma_ss<SK>(dp, sw128_desc(dos + row_off), sw128_desc(vt + key_off),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = c0 + SK > tk || (causal && c0 + SK - 1 > row_lo);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i % 4) / 2;
        float p = exp2f(fmaf(s[i], sl, -lr[h]));
        if (masked) {
          const int col = c0 + 8 * (i / 4) + cq + (i % 2);
          if (col >= tk || (causal && col > r0 + 8 * h)) p = 0.f;
        }
        s[i] = p * (dp[i] - dl[h]) * scale;     // dS, in float32
      }
      uint32_t da[PK][4];                       // dS in bf16, the A operand
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          da[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int c = 0; c < NCB; ++c)
          wgmma_rs_n64(acc[c], da[kk],
                       sw128_desc(kt + c * (BK * 128) + sub * (SK * 128) +
                                  kk * 2048),
                       1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NCB; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) fence_regs(da[kk]);
    }
  }
  cp_async_wait_all();      // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    bf16* dqg = dq + ((long long)bh * tq + row) * D;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int col = c * CB + 8 * f;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dqg + col + cq) =
              __floats2bfloat162_rn(acc[c][4 * f + 2 * h],
                                    acc[c][4 * f + 2 * h + 1]);
      }
  }
}

// ------------------------------------------------------------------- K8 --

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BK / 64 * WG)
flash_bwd_dkv_sm90_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int hq, int hkv, int tq, int tk, float scale,
                          int causal) {
  constexpr int NT = BK / 64 * WG;
  constexpr int DP = padded_dim(D);
  constexpr int NCB = DP / CB;
  constexpr int SQ = dkv_slice(D, BQ);  // query rows of one product
  constexpr int NS = SQ / 2;            // S^T (and dP^T) values per thread
  constexpr int PK = SQ / 16;           // k16 steps of P^T dO and dS^T Q
  constexpr int KV_BYTES = BK * DP * 2;
  constexpr int Q_BYTES = BQ * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;
  const uint32_t vs = ks + KV_BYTES;
  const uint32_t qs = vs + KV_BYTES;        // stage st: qs + st * Q_BYTES
  const uint32_t dos = qs + 2 * Q_BYTES;    // stage st: dos + st * Q_BYTES
  const uint32_t rows = dos + 2 * Q_BYTES;  // stage st: lse [BQ], delta [BQ]
  const float* rowv = reinterpret_cast<const float*>(smem_raw + (rows - raw));

  const int tid = threadIdx.x;
  const int wg = tid / WG, t = tid % WG;
  const int lane = t % 32;
  const int bkv = blockIdx.y;               // b * hkv + kv head
  const int b = bkv / hkv, hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * BK;
  const int key_lo = k0 + wg * 64;          // this warp group's first key
  const int r0 = key_lo + (t / 32) * 16 + lane / 4;   // and r0 + 8
  const int cq = 2 * (lane % 4);

  // (q head of the group, query tile) pairs, query tiles innermost; when
  // causal, the earlier tiles see no key of this block
  const int first_qt = causal ? k0 / BQ : 0;
  const int nq = (tq + BQ - 1) / BQ - first_qt;
  const int n_it = group * nq;
  auto stage_q = [&](int it, int st) {
    const int bh = b * hq + hk * group + it / nq;
    const int q0 = (first_qt + it % nq) * BQ;
    stage<D, BQ, NT>(qs + st * Q_BYTES, q + (long long)bh * tq * D, q0, tq,
                     tid);
    stage<D, BQ, NT>(dos + st * Q_BYTES, dout + (long long)bh * tq * D, q0,
                     tq, tid);
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < tq;
      const long long at = (long long)bh * tq + (in ? q0 + i : 0);
      cp_async4(rows + (st * 2 * BQ + i) * 4, lse + at, in ? 4 : 0);
      cp_async4(rows + (st * 2 * BQ + BQ + i) * 4, delta + at, in ? 4 : 0);
    }
  };

  if (D < CB) {     // the padding columns stay zero; the copies skip them
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (ks - raw));
    for (int i = tid; i < (2 * KV_BYTES + 4 * Q_BYTES) / 16; i += NT)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  stage<D, BK, NT>(ks, k + (long long)bkv * tk * D, k0, tk, tid);
  stage<D, BK, NT>(vs, v + (long long)bkv * tk * D, k0, tk, tid);
  stage_q(0, 0);
  cp_async_commit();

  const float sl = scale * LOG2E;
  float acc_k[NCB][32], acc_v[NCB][32];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();        // tile it landed; tile it - 1 fully consumed
    if (it + 1 < n_it) stage_q(it + 1, st ^ 1);
    cp_async_commit();
    const int q0 = (first_qt + it % nq) * BQ;
    const uint32_t qt = qs + st * Q_BYTES, ot = dos + st * Q_BYTES;
    const float* lsv = rowv + st * 2 * BQ;
    const float* dlv = lsv + BQ;
#pragma unroll
    for (int sub = 0; sub < BQ / SQ; ++sub) {
      const int c0 = q0 + sub * SQ;         // first query of this slice
      if (causal && key_lo > c0 + SQ - 1) continue;   // all before our keys
      float s[NS], dp[NS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t key_off = (kk / 4) * (BK * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32;
        const uint32_t row_off = (kk / 4) * (BQ * 128) + sub * (SQ * 128) +
                                 (kk % 4) * 32;
        wgmma_ss<SQ>(s, sw128_desc(ks + key_off), sw128_desc(qt + row_off),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t key_off = (kk / 4) * (BK * 128) + wg * (64 * 128) +
                                 (kk % 4) * 32;
        const uint32_t row_off = (kk / 4) * (BQ * 128) + sub * (SQ * 128) +
                                 (kk % 4) * 32;
        wgmma_ss<SQ>(dp, sw128_desc(vs + key_off), sw128_desc(ot + row_off),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // a slice needs masks where it crosses Tq (zero-filled query rows),
      // Tk (this group's keys) or the diagonal
      const bool masked = c0 + SQ > tq || key_lo + 64 > tk ||
                          (causal && key_lo + 63 > c0);
#pragma unroll
      for (int f = 0; f < SQ / 8; ++f) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lsv + sub * SQ + 8 * f + cq);
        const float2 d2 =
            *reinterpret_cast<const float2*>(dlv + sub * SQ + 8 * f + cq);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * f + 2 * h + e;
            float p = exp2f(fmaf(s[i], sl, -(e ? l2.y : l2.x) * LOG2E));
            if (masked) {
              const int col = c0 + 8 * f + cq + e, key = r0 + 8 * h;
              if (col >= tq || key >= tk || (causal && key > col)) p = 0.f;
            }
            s[i] = p;                                          // P^T
            dp[i] = p * (dp[i] - (e ? d2.y : d2.x)) * scale;   // dS^T
          }
      }
      uint32_t pa[PK][4], da[PK][4];        // bf16 A operands
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int c = 0; c < NCB; ++c) {
          const uint32_t off = c * (BQ * 128) + sub * (SQ * 128) + kk * 2048;
          wgmma_rs_n64(acc_v[c], pa[kk], sw128_desc(ot + off), 1);
          wgmma_rs_n64(acc_k[c], da[kk], sw128_desc(qt + off), 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NCB; ++c) {
        fence_regs(acc_k[c]);
        fence_regs(acc_v[c]);
      }
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
    }
  }
  cp_async_wait_all();      // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = r0 + 8 * h;
    if (key >= tk) continue;
    bf16* dkg = dk + ((long long)bkv * tk + key) * D;
    bf16* dvg = dv + ((long long)bkv * tk + key) * D;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int col = c * CB + 8 * f;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + col + cq) =
              __floats2bfloat162_rn(acc_k[c][4 * f + 2 * h],
                                    acc_k[c][4 * f + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvg + col + cq) =
              __floats2bfloat162_rn(acc_v[c][4 * f + 2 * h],
                                    acc_v[c][4 * f + 2 * h + 1]);
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

template <int D, int BQ, int BK>
int launch_dq(const Args& a) {
  constexpr int smem = dq_smem(D, BQ, BK);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dq_sm90_kernel<D, BQ, BK>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tq + BQ - 1) / BQ, a.batch * a.hq);
  kern<<<grid, BQ / 64 * WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.out0), a.hq, a.hq / a.hkv, a.tq, a.tk,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BK>
int launch_dkv(const Args& a) {
  constexpr int smem = dkv_smem(D, BQ, BK);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dkv_sm90_kernel<D, BQ, BK>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tk + BK - 1) / BK, a.batch * a.hkv);
  kern<<<grid, BK / 64 * WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.hq,
      a.hkv, a.tq, a.tk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D]; dq like q; dk, dv like k;
// all bfloat16, contiguous and 16-byte aligned; lse, delta [B*Hq, Tq]
// float32. (head_dim, block_q, block_k) must be one of the set below,
// which ops/attention.py's body table (BWD_BODIES) holds too. Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a set not
// built).
#if defined(AUDAX_FLASH_BWD_DKV)
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int batch,
                       int hq, int hkv, int tq, int tk, int head_dim,
                       float scale, int causal, int block_q, int block_k,
                       void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, tq, tk,
               scale, causal, (cudaStream_t)stream};
#define AUDAX_DKV90(D_, BQ_, BK_)                                   \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_)           \
    return launch_dkv<D_, BQ_, BK_>(a);
  AUDAX_DKV90(64, 32, 64)
  AUDAX_DKV90(64, 64, 64)
  AUDAX_DKV90(64, 128, 64)
  AUDAX_DKV90(64, 32, 128)
  AUDAX_DKV90(64, 64, 128)
  AUDAX_DKV90(64, 128, 128)
  AUDAX_DKV90(16, 128, 128)
  AUDAX_DKV90(32, 128, 128)
  AUDAX_DKV90(128, 128, 128)
#undef AUDAX_DKV90
  return (int)cudaErrorInvalidValue;
}
#else
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, int hq, int hkv, int tq, int tk,
                      int head_dim, float scale, int causal, int block_q,
                      int block_k, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch, hq, hkv, tq,
               tk, scale, causal, (cudaStream_t)stream};
#define AUDAX_DQ90(D_, BQ_, BK_)                                    \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_)           \
    return launch_dq<D_, BQ_, BK_>(a);
  AUDAX_DQ90(64, 64, 32)
  AUDAX_DQ90(64, 64, 64)
  AUDAX_DQ90(64, 64, 128)
  AUDAX_DQ90(64, 128, 32)
  AUDAX_DQ90(64, 128, 64)
  AUDAX_DQ90(64, 128, 128)
  AUDAX_DQ90(16, 128, 128)
  AUDAX_DQ90(32, 128, 128)
  AUDAX_DQ90(128, 128, 128)
#undef AUDAX_DQ90
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
