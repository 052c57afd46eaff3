// Flash-attention backward for Hopper (sm_90a) in float32 on the tensor
// cores: the float32 bodies of K7 (dQ) and K8 (dK/dV), their products in
// 3xTF32 on mma.sync (csrc/tf32x3.cuh).
//
// Replaces the TPU kernels audax/ops/attention.py:_dq_kernel (K7) and
// _dkv_kernel (K8), both launched by _bwd_pallas, for float32 inputs at the
// tiles ops/attention.py's table BWD_BODIES gives this body: K7 at 64 query
// rows, K8 at 64 keys. csrc/flash_bwd.cu keeps the float32 tiles off this
// body (K7 at 32 or 128 rows, K8 at 32 or 128 keys) and the bfloat16 tiles
// wgmma cannot take; csrc/flash_bwd_sm90.cu runs bfloat16. For q, dO [B,
// Hq, Tq, D], k, v [B, Hkv, Tk, D], the forward's lse [B*Hq, Tq] and delta
// = rowsum(dO * O) [B*Hq, Tq] they compute
//
//   P  = exp(scale * Q K^T - lse)     (keys j >= Tk masked; j > i when
//   dP = dO V^T                        causal, Tq == Tk)
//   dS = P * (dP - delta) * scale
//
// and write dQ = dS K (K7), dK = dS^T Q and dV = P^T dO (K8), all float32
// (the TPU's casts of dS and P before the products are no-ops there). A kv
// head's dK/dV sums its whole q-head group inside the block. Every output
// element is written by exactly one block, with no atomics, so the
// gradients are the same from run to run.
//
// What bounds them on this card: at Whisper-base's encoder shape [4, 8,
// 1500, 64] K7 does 6 and K8 8 operations per query-key pair and head dim
// (27.6 and 36.9 GFLOP) against 62 and 74 MB of operands read and written
// (0.02 ms at 3.35 TB/s), so operations bound both. The CUDA cores
// (csrc/flash_bwd.cu, 67 TFLOP/s) keep float32 but take 1.8 and 2.0 ms
// there; plain TF32 (495 TFLOP/s) keeps 10 mantissa bits, too few for the
// 1e-4 float32 parity; 3xTF32 keeps about 21 on the tensor cores at a third
// of their rate, 165 TFLOP/s: 0.17 and 0.22 ms.
//
// Design (K2's float32 body's, csrc/flash_fwd_tf32x3.cu): 4 warps, each an
// m16n8k8 row tile of 16 rows; a two-stage cp.async ring of tiles, rows
// padded to D + 4 floats so that every fragment read falls on 32 distinct
// banks; each operand split into its TF32 big and small parts and each
// product taken three times; a product's k order permuted so that the C
// fragment of one product is the A fragment of the next without a shuffle.
//
//   K7: one block per (b*hq, 64 query rows). Q's and dO's A fragments come
//       from device memory, split: held in registers up to head dim 64,
//       read again at each use at 128. lse and delta of the thread's rows g
//       and g + 8 stay in registers. K/V tiles of BK keys go through the
//       ring. Per slice of SK keys (dq_slice):
//         S = Q K^T, dP = dO V^T     B from K's and V's rows (load_b_t)
//         P, dS on the C fragments   masked only on a slice that crosses
//                                    Tk or the diagonal
//         dQ += dS K                 A = a_from_c(dS), B from K's rows in
//                                    the permuted k order (load_b_rows_perm),
//                                    summed over the slice, then added
//       Causal: the tiles wholly above the block's diagonal are never
//       loaded, and a warp skips the slices above its own rows.
//   K8: computed transposed, as csrc/flash_bwd_sm90.cu does, so that no
//       operand is transposed in memory. One block per (b*hkv, 64 keys), 16
//       keys a warp; K's and V's A fragments come from device memory, split,
//       held up to head dim 64 and read at each use at 128. The block loops
//       over the group's q heads and their BQ-row query tiles; Q, dO, lse
//       and delta go through the ring. Per slice of SQ queries (dkv_slice):
//         S^T = K Q^T, dP^T = V dO^T    B from Q's and dO's rows
//         P^T, dS^T on the C fragments  lse and delta belong to columns
//                                       (queries 2t and 2t + 1 of each
//                                       n-tile), read from shared memory; a
//                                       slice that crosses Tq or the
//                                       diagonal is masked, so that query
//                                       rows past Tq (zero-filled, lse 0,
//                                       where exp(0 - 0) = 1) give P = 0
//         dV += P^T dO, dK += dS^T Q    A = a_from_c(P^T), a_from_c(dS^T);
//                                       B from dO's and Q's rows, permuted;
//                                       summed over the slice, then added
//       Keys past Tk need no mask: their rows of dK and dV are never
//       stored. Causal: the loop starts at the first query tile that
//       reaches the block's first key, and a warp skips the slices whose
//       every query lies before its first key.
// Accumulation: the tensor core adds each product into its float32
// accumulator with truncation, not rounding to nearest, so a sum taken along
// a whole key (K7) or query (K8) loop in one C fragment drifts by up to a
// unit in its last place per product, in one direction: over 1500 keys, or
// a q-head group of 1500-row queries, hundreds of ulps. So each n-tile of
// dQ, dK and dV is summed over one slice from zero and added to its
// accumulator in float32 (round to nearest).
// Registers decide the slices: holding Q and dO split (K7) or K and V split
// (K8) takes 128 registers at head dim 64, so the slice narrows to leave
// room for S, dP, the slice's A fragments and the accumulators (255 at
// most, and a spill fails chip_smoke.py). The copy of the next tile is in
// flight while one computes.
//
// The file builds two libraries (ops/native.py), as flash_bwd.cu does: with
// AUDAX_FLASH_BWD_DQ it holds K7's body and flash_bwd_dq_tf32x3, with
// AUDAX_FLASH_BWD_DKV K8's and flash_bwd_dkv_tf32x3, so that the two
// compile in parallel.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BR = 64;                 // K7's query rows, K8's keys a block
constexpr float LOG2E = 1.4426950408889634f;

// K7's dynamic shared memory: two stages of a K and a V tile of bk keys,
// rows padded to d + 4 floats
__host__ __device__ constexpr int dq_smem(int d, int bk) {
  return 4 * 2 * 2 * bk * (d + 4);
}
// K8's: two stages of a Q and a dO tile of bq rows (padded as above) and of
// their lse and delta
__host__ __device__ constexpr int dkv_smem(int d, int bq) {
  return 4 * 2 * 2 * bq * (d + 5);
}
// keys of one K7 slice: 64 up to head dim 32; 32 at 64, where Q and dO
// held split take 128 registers, at 128, where dQ and the re-read
// fragments take as many, and at a 32-key tile
__host__ __device__ constexpr int dq_slice(int d, int bk) {
  return (d >= 64 || bk < 64) ? 32 : 64;
}
// query rows of one K8 slice: 32 up to head dim 32; 8 at 64, where K and V
// held split take 128 registers beside dK's and dV's 64; 16 at 128, where
// dK and dV alone take 128
__host__ __device__ constexpr int dkv_slice(int d) {
  return d <= 32 ? 32 : d == 64 ? 8 : 16;
}

// The A fragment of k-step kk of the 16-row tile of x [n, D] (row stride D)
// that starts at row0, from device memory, split: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); rows at or past n read as 0
template <int D>
__device__ __forceinline__ tf32x3::FragA a_frag(const float* x, int row0,
                                                int n, int kk, int lane) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + lane / 4 + 8 * (i & 1);
    const int col = 8 * kk + lane % 4 + 4 * (i >> 1);
    v[i] = row < n ? __ldg(x + (long long)row * D + col) : 0.f;
  }
  return tf32x3::split_a(v);
}

// rows [r0, r0 + rows) of x [n, D] into a [rows][D + 4] tile by cp.async,
// 16 bytes a copy; rows past n are zero-filled and nothing is read
template <int D>
__device__ __forceinline__ void copy_rows(float* dst, const float* x, int r0,
                                          int rows, int n) {
  constexpr int CH = D / 4;
  for (int c = threadIdx.x; c < rows * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    const bool in = r0 + r < n;
    const long long off = in ? (long long)(r0 + r) * D + col : 0;
    sm90::cp_async16(sm90::smem_addr(dst + r * (D + 4) + col), x + off,
                     in ? 16 : 0);
  }
}

// wait for the copy of step i; start the copy of step i + 1 first
template <typename Load>
__device__ __forceinline__ void ring_step(int i, int n, Load load) {
  if (i + 1 < n) {
    load(i + 1, (i + 1) & 1);
    tf32x3::cp_async_wait<1>();
  } else {
    tf32x3::cp_async_wait<0>();
  }
  __syncthreads();
}

// ------------------------------------------------------------------- K7 --

template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int hq, int group, int tq,
                           int tk, float scale, int causal) {
  constexpr int DP = D + 4;
  constexpr int KS = D / 8;            // k-steps of S and dP, n-tiles of dQ
  constexpr int SK = dq_slice(D, BK);  // keys of one slice
  constexpr int NT = SK / 8;           // n-tiles of S, k-steps of dS K
  constexpr bool HOLD = D <= 64;       // Q and dO held split, else re-read
  static_assert(BK % SK == 0, "a key tile holds whole slices");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [2][BK][DP]
  float* vs = ks + 2 * BK * DP;        // [2][BK][DP]

  const int bh = blockIdx.y;           // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int w0 = q0 + 16 * warp;       // the warp's first row
  const int r0 = w0 + lane / 4;        // this thread's rows: r0, r0 + 8
  const float* kg = k + (long long)bkv * tk * D;
  const float* vg = v + (long long)bkv * tk * D;
  const float* qg = q + (long long)bh * tq * D;
  const float* og = dout + (long long)bh * tq * D;

  int n_tiles = (tk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BR - 1) / BK + 1);
  auto load_tile = [&](int tile, int stage) {
    copy_rows<D>(ks + stage * BK * DP, kg, tile * BK, BK, tk);
    copy_rows<D>(vs + stage * BK * DP, vg, tile * BK, BK, tk);
    sm90::cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  tf32x3::FragA qf[HOLD ? KS : 1], of[HOLD ? KS : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk] = a_frag<D>(qg, w0, tq, kk, lane);
      of[kk] = a_frag<D>(og, w0, tq, kk, lane);
    }
  }
  // lse (in log2 units) and delta of rows r0 and r0 + 8
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool in = row < tq;
    l2[h] = in ? lse[(long long)bh * tq + row] * LOG2E : 0.f;
    dl[h] = in ? delta[(long long)bh * tq + row] : 0.f;
  }
  const float sl = scale * LOG2E;

  float acc[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    ring_step(tile, n_tiles, load_tile);   // tile's K and V are in place
    const float* kt = ks + (tile & 1) * BK * DP;
    const float* vt = vs + (tile & 1) * BK * DP;
#pragma unroll
    for (int sub = 0; sub < BK / SK; ++sub) {
      const int c0 = tile * BK + sub * SK;  // first key of this slice
      if (causal && c0 > w0 + 15) break;    // above the warp's rows
      const float* kss = kt + sub * SK * DP;
      const float* vss = vt + sub * SK * DP;
      // ---- S = Q K^T, dP = dO V^T ----
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        tf32x3::FragA qa, oa;
        if constexpr (HOLD) {
          qa = qf[kk];
          oa = of[kk];
        } else {
          qa = a_frag<D>(qg, w0, tq, kk, lane);
          oa = a_frag<D>(og, w0, tq, kk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          tf32x3::mma3(s[nt], qa,
                       tf32x3::load_b_t(kss, DP, 8 * nt, 8 * kk, lane));
          tf32x3::mma3(dp[nt], oa,
                       tf32x3::load_b_t(vss, DP, 8 * nt, 8 * kk, lane));
        }
      }
      // ---- P and dS (in s): rows r0 (i = 0, 1) and r0 + 8 (i = 2, 3) ----
      const bool masked = c0 + SK > tk || (causal && c0 + SK - 1 > w0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          float p = exp2f(fmaf(s[nt][i], sl, -l2[h]));
          if (masked) {
            const int col = c0 + 8 * nt + 2 * t + (i & 1);
            if (col >= tk || (causal && col > r0 + 8 * h)) p = 0.f;
          }
          s[nt][i] = p * (dp[nt][i] - dl[h]) * scale;
        }
      // ---- dQ += dS K: dS's C fragments as A fragments; each n-tile of
      // dQ summed over the slice from zero, then added in float32 ----
      tf32x3::FragA a[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) a[j] = tf32x3::a_from_c(s[j]);
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
          tf32x3::mma3(c, a[j], tf32x3::load_b_rows_perm(kss, DP, 8 * j,
                                                         8 * nd, lane));
        tf32x3::add(acc[nd], c);
      }
    }
    __syncthreads();                   // the stage is free for tile + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    float* dqg = dq + ((long long)bh * tq + row) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
      *reinterpret_cast<float2*>(dqg + 8 * nd) =
          make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
  }
}

// ------------------------------------------------------------------- K8 --

template <int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int hq, int hkv, int tq, int tk, float scale,
                            int causal) {
  constexpr int DP = D + 4;
  constexpr int KS = D / 8;            // k-steps of S^T, n-tiles of dK, dV
  constexpr int SQ = dkv_slice(D) < BQ ? dkv_slice(D) : BQ;
  constexpr int NQ = SQ / 8;           // n-tiles of S^T, k-steps of P^T dO
  constexpr bool HOLD = D <= 64;       // K and V held split, else re-read
  static_assert(BQ % SQ == 0, "a query tile holds whole slices");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [2][BQ][DP]
  float* dos = qs + 2 * BQ * DP;       // [2][BQ][DP]
  float* rows = dos + 2 * BQ * DP;     // [2][lse BQ, delta BQ]

  const int bkv = blockIdx.y;          // b * hkv + kv head
  const int b = bkv / hkv, hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int kw0 = k0 + 16 * warp;      // the warp's first key
  const int r0 = kw0 + lane / 4;       // this thread's keys: r0, r0 + 8
  const float* kg = k + (long long)bkv * tk * D;
  const float* vg = v + (long long)bkv * tk * D;

  // (q head of the group, query tile) steps, query tiles innermost; when
  // causal, the earlier tiles see no key of this block
  const int first_qt = causal ? k0 / BQ : 0;
  const int nq = (tq + BQ - 1) / BQ - first_qt;
  const int n_it = group * nq;
  auto load_tile = [&](int it, int stage) {
    const int bh = b * hq + hk * group + it / nq;
    const int q0 = (first_qt + it % nq) * BQ;
    copy_rows<D>(qs + stage * BQ * DP, q + (long long)bh * tq * D, q0, BQ,
                 tq);
    copy_rows<D>(dos + stage * BQ * DP, dout + (long long)bh * tq * D, q0,
                 BQ, tq);
    float* rs = rows + stage * 2 * BQ;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < tq;
      const long long at = (long long)bh * tq + (in ? q0 + i : 0);
      sm90::cp_async4(sm90::smem_addr(rs + i), lse + at, in ? 4 : 0);
      sm90::cp_async4(sm90::smem_addr(rs + BQ + i), delta + at, in ? 4 : 0);
    }
    sm90::cp_async_commit();
  };
  if (n_it > 0) load_tile(0, 0);

  tf32x3::FragA kf[HOLD ? KS : 1], vf[HOLD ? KS : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      kf[kk] = a_frag<D>(kg, kw0, tk, kk, lane);
      vf[kk] = a_frag<D>(vg, kw0, tk, kk, lane);
    }
  }
  const float sl = scale * LOG2E;

  float acc_k[KS][4], acc_v[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[nd][i] = acc_v[nd][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    ring_step(it, n_it, load_tile);    // step it's Q, dO, lse, delta landed
    const int q0 = (first_qt + it % nq) * BQ;
    const float* qt = qs + (it & 1) * BQ * DP;
    const float* ot = dos + (it & 1) * BQ * DP;
    const float* lsv = rows + (it & 1) * 2 * BQ;
    const float* dlv = lsv + BQ;
#pragma unroll
    for (int sub = 0; sub < BQ / SQ; ++sub) {
      const int c0 = q0 + sub * SQ;    // first query of this slice
      if (c0 >= tq) break;             // rows past Tq only
      if (causal && kw0 > c0 + SQ - 1) continue;   // all before our keys
      const float* qss = qt + sub * SQ * DP;
      const float* oss = ot + sub * SQ * DP;
      // ---- S^T = K Q^T, dP^T = V dO^T ----
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        tf32x3::FragA ka, va;
        if constexpr (HOLD) {
          ka = kf[kk];
          va = vf[kk];
        } else {
          ka = a_frag<D>(kg, kw0, tk, kk, lane);
          va = a_frag<D>(vg, kw0, tk, kk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          tf32x3::mma3(s[nt], ka,
                       tf32x3::load_b_t(qss, DP, 8 * nt, 8 * kk, lane));
          tf32x3::mma3(dp[nt], va,
                       tf32x3::load_b_t(oss, DP, 8 * nt, 8 * kk, lane));
        }
      }
      // ---- P^T (in s) and dS^T (in dp): keys r0 (i = 0, 1) and r0 + 8
      // (i = 2, 3), queries 2t (i even) and 2t + 1 (i odd) of each n-tile
      const bool masked = c0 + SQ > tq || (causal && kw0 + 15 > c0);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int cl = sub * SQ + 8 * nt + 2 * t;   // column in the tile
        const float2 l = *reinterpret_cast<const float2*>(lsv + cl);
        const float2 d = *reinterpret_cast<const float2*>(dlv + cl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          float p = exp2f(fmaf(s[nt][i], sl, -(e ? l.y : l.x) * LOG2E));
          if (masked) {
            const int col = q0 + cl + e, key = r0 + 8 * (i >> 1);
            if (col >= tq || (causal && key > col)) p = 0.f;
          }
          s[nt][i] = p;
          dp[nt][i] = p * (dp[nt][i] - (e ? d.y : d.x)) * scale;
        }
      }
      // ---- dV += P^T dO, dK += dS^T Q: C fragments as A fragments;
      // each n-tile summed over the slice from zero, then added ----
      tf32x3::FragA pa[NQ], da[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        pa[j] = tf32x3::a_from_c(s[j]);
        da[j] = tf32x3::a_from_c(dp[j]);
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        float cv[4] = {0.f, 0.f, 0.f, 0.f}, ck[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          tf32x3::mma3(cv, pa[j], tf32x3::load_b_rows_perm(oss, DP, 8 * j,
                                                           8 * nd, lane));
          tf32x3::mma3(ck, da[j], tf32x3::load_b_rows_perm(qss, DP, 8 * j,
                                                           8 * nd, lane));
        }
        tf32x3::add(acc_v[nd], cv);
        tf32x3::add(acc_k[nd], ck);
      }
    }
    __syncthreads();                   // the stage is free for step it + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = r0 + 8 * h;
    if (key >= tk) continue;
    float* dkg = dk + ((long long)bkv * tk + key) * D + 2 * t;
    float* dvg = dv + ((long long)bkv * tk + key) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      *reinterpret_cast<float2*>(dkg + 8 * nd) =
          make_float2(acc_k[nd][2 * h], acc_k[nd][2 * h + 1]);
      *reinterpret_cast<float2*>(dvg + 8 * nd) =
          make_float2(acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------- launches --

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *out0, *out1;                  // dq; or dk, dv
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

template <int D, int BK>
int launch_dq(const Args& a) {
  constexpr int smem = dq_smem(D, BK);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dq_tf32x3_kernel<D, BK>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tq + BR - 1) / BR, a.batch * a.hq);
  kern<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                          a.delta, a.out0, a.hq,
                                          a.hq / a.hkv, a.tq, a.tk, a.scale,
                                          a.causal);
  return (int)cudaGetLastError();
}

template <int D, int BQ>
int launch_dkv(const Args& a) {
  constexpr int smem = dkv_smem(D, BQ);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_bwd_dkv_tf32x3_kernel<D, BQ>;
  static bool ready = false;
  if (int err = allow_smem(kern, smem, ready)) return err;
  dim3 grid((a.tk + BR - 1) / BR, a.batch * a.hkv);
  kern<<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                          a.delta, a.out0, a.out1, a.hq,
                                          a.hkv, a.tq, a.tk, a.scale,
                                          a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D]; dq like q; dk, dv like k;
// lse, delta [B*Hq, Tq]; all float32, contiguous, q, k, v and dout 16-byte
// aligned. (head_dim, block_q, block_k) must be one of the set below, which
// ops/attention.py's body table (BWD_BODIES) holds too: K7 at 64 query rows,
// K8 at 64 keys. Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a set not built).
#if defined(AUDAX_FLASH_BWD_DKV)
int flash_bwd_dkv_tf32x3(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int batch,
                         int hq, int hkv, int tq, int tk, int head_dim,
                         float scale, int causal, int block_q, int block_k,
                         void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, tq, tk,
               scale, causal, (cudaStream_t)stream};
#define AUDAX_DKV_TF32X3(D_, BQ_, BK_)                              \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_)           \
    return launch_dkv<D_, BQ_>(a);
  AUDAX_DKV_TF32X3(16, 64, 64)
  AUDAX_DKV_TF32X3(32, 64, 64)
  AUDAX_DKV_TF32X3(64, 64, 64)
  AUDAX_DKV_TF32X3(128, 64, 64)
  AUDAX_DKV_TF32X3(64, 32, 64)
  AUDAX_DKV_TF32X3(64, 128, 64)
#undef AUDAX_DKV_TF32X3
  return (int)cudaErrorInvalidValue;
}
#else
int flash_bwd_dq_tf32x3(const float* q, const float* k, const float* v,
                        const float* dout, const float* lse,
                        const float* delta, float* dq, int batch, int hq,
                        int hkv, int tq, int tk, int head_dim, float scale,
                        int causal, int block_q, int block_k, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch, hq, hkv, tq,
               tk, scale, causal, (cudaStream_t)stream};
#define AUDAX_DQ_TF32X3(D_, BQ_, BK_)                               \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_)           \
    return launch_dq<D_, BK_>(a);
  AUDAX_DQ_TF32X3(16, 64, 64)
  AUDAX_DQ_TF32X3(32, 64, 64)
  AUDAX_DQ_TF32X3(64, 64, 64)
  AUDAX_DQ_TF32X3(128, 64, 64)
  AUDAX_DQ_TF32X3(64, 64, 32)
  AUDAX_DQ_TF32X3(64, 64, 128)
#undef AUDAX_DQ_TF32X3
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
