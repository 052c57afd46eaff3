// Flash-attention forward for Hopper (sm_90a) on the tensor cores: the
// bfloat16 body of K2, with wgmma products and float32 accumulators.
//
// Replaces the TPU kernel audax/ops/attention.py:_fwd_kernel (the forward of
// flash_attention, called from _fwd) for bfloat16 inputs at block_q >= 64,
// and the head-folded probe tools/attn_headfold_probe.py:_fold_kernel
// (launched by fold_fwd, P1) in bfloat16; csrc/flash_fwd_tf32x3.cu keeps
// float32, csrc/flash_fwd.cu bfloat16 at block_q 32. For q [B, Hq, Tq, D]
// and k, v [B, Hkv, tk_stride, D] it writes
//
//   o[b, h, i]  = sum_j softmax_j(scale * q_i . k_j) v_j      (kv head h / G)
//   lse[b*Hq+h, i] = m_i + log(l_i)
//
// with keys j >= kv_len masked and never read, and j > i masked when causal
// (Tq == Tk). The TPU's semantics, one to one: q . k is a bfloat16 product
// with float32 accumulation, scaled in float32; masked scores are -1e30; p
// is rounded to bfloat16 for the PV product while l sums it unrounded; a row
// that sees no key divides by 1; lse is in natural log.
//
// What bounds it on this card: at Whisper-small's encoder shape [8, 12,
// 1500, 64] the work is 4*B*H*T*T*D = 6.9 GFLOP against 18 MB of q, k, v and
// o: 385 operations per byte, above the H100's bf16 ridge (295), so the
// tensor cores (989 TFLOP/s dense) bound it. The CUDA-core body runs the
// same products on float32 FMAs (67 TFLOP/s), 15x below that.
//
// Design: one block owns one (b*h) and BQ = 64 or 128 query rows, one
// consumer warp group (128 threads) per 64 rows. Q is staged once in shared
// memory; K and V tiles of BK keys go through two-stage rings, filled by
// cp.async (16 bytes a thread) into the 128-byte-swizzled layout wgmma
// reads without bank conflicts (16-byte chunk c of row r lands at chunk
// c ^ (r % 8) of the row's 128 bytes; a head dim of 128 is two such column
// blocks). Rows past kv_len are zero-filled by the copy (src-size 0) and
// never read.
//   S = Q K^T:  wgmma m64n{BK}k16, Q and K both K-major from shared memory
//               (the k16 steps advance the descriptor by 32 bytes inside a
//               swizzled row).
//   softmax:    online, on the accumulator fragments: a thread holds two
//               rows (r and r + 8 of its warp's 16), and a row's max goes
//               across the 4 lanes that hold it by shuffles; l stays a
//               per-thread partial until the end. Only tiles that cross
//               kv_len or the diagonal are masked, and a warp group skips
//               tiles wholly above its diagonal (the TPU's pl.when).
//   O += P V:   the accumulator layout of S is the register A-operand
//               layout of wgmma, so P goes to bfloat16 in registers and
//               feeds m64n64k16 directly; V is the transposed (MN-major) B
//               operand from the same swizzled tile, so no transpose is
//               made. A head dim below 64 is zero-padded to 64 in shared
//               memory (the padding adds nothing to S and is never
//               stored); 128 takes two n64 products per k-step.
// The copy of tile j + 1 is in flight while tile j computes. Two ways to
// hide the softmax behind the tensor cores were tried on the card and ran
// no faster at [8, 12, 1500, 64]: issuing S_j with P_{j-1} V_{j-1} (more
// registers a thread, a block per SM lost) and two warp groups taking
// turns at the products through named barriers. The epilogue divides by
// l, rounds to bfloat16 and stores o from the fragments (four lanes write
// a row's 16 contiguous bytes), lse in float32. The building blocks
// (cp.async staging, the swizzle and its descriptors, the wgmma products)
// live in csrc/sm90_wgmma.cuh, shared with K7/K8's bf16 body.
//
// Folding (P1): FOLD = f puts f consecutive heads of the fused B*H axis in
// one block of f warp groups at the same 64 query rows; warp group g owns
// head blockIdx.y * f + g, with its own Q tile and its own two-stage K/V
// ring (the heads share no operand), and copies its own tiles. Once per key
// tile a head's warp group meets its own named barrier (bar.sync 1 + g
// over its 128 threads, sm90_wgmma.cuh:fold_sync), so no head waits on
// another: 5 - 20 % faster on the H100 than one block barrier for all
// heads (PERF.md, P1).
// FOLD = 1 is the kernel without folding; folds are built
// at head_dim 64 with the 64 x 64 tile (fold 4: 164,864 B of shared
// memory, 512 threads, so at most 128 registers a thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory: for each folded head Q and two stages of K and V,
// and 1024 bytes to align the swizzle atoms (8 rows x 128 bytes) on 1024
// bytes (a head's share is a multiple of 1024)
__host__ __device__ constexpr int smem_bytes(int d, int bq, int bk, int fold) {
  return fold * 2 * padded_dim(d) * (bq + 4 * bk) + 1024;
}

// the two rows a thread holds in the S and O fragments (r0 and r0 + 8 of
// its warp's 16), its first column of a fragment pair, and the masks
struct Rows {
  int r0, cq, kv_len, causal;
  float scale;
};
__device__ __forceinline__ int r0_of(int row_lo, int t) {
  return row_lo + (t / 32) * 16 + (t % 32) / 4;
}

// S = Q K^T for this warp group's 64 rows against the K tile at kt (one
// commit group)
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t qs,
                                        uint32_t kt, int wg) {
#pragma unroll
  for (int kk = 0; kk < padded_dim(D) / 16; ++kk) {
    const uint32_t qa = qs + (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                        (kk % 4) * 32;
    const uint32_t kb = kt + (kk / 4) * (BK * 128) + (kk % 4) * 32;
    wgmma_ss<BK>(s, sw128_desc(qa), sw128_desc(kb), kk > 0);
  }
  wgmma_commit();
}

// O += P V against the V tile at vt (one commit group)
template <int NCB, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[NCB][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NCB; ++c)
      wgmma_rs_n64(acc[c], pa[kk], sw128_desc(vt + c * (BK * 128) + kk * 2048),
                   1);
  wgmma_commit();
}

// The online softmax of the S tile of keys [k0, k0 + BK) on its fragments:
// scores scaled in float32, masked to -1e30 (only where `masked`), the
// running max m updated across the 4 lanes of a row, alpha the factor the
// old output must be rescaled by, l the per-thread partial sum of the
// unrounded p, and P rounded to bf16 pairs in wgmma's A-operand layout.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Rows& rw, int k0,
                                             bool masked) {
  constexpr int NS = BK / 2;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i % 4) / 2;
    float x = s[i] * rw.scale;
    if (masked) {
      const int col = k0 + 8 * (i / 4) + rw.cq + (i % 2);
      if (col >= rw.kv_len || (rw.causal && col > rw.r0 + 8 * h)) x = NEG;
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float ml[2];                              // the new max, times log2(e)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2f((m[h] - m_new) * LOG2E);
    m[h] = m_new;
    ml[h] = m_new * LOG2E;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int h = (i % 4) / 2;
    float p = exp2f(fmaf(s[i], LOG2E, -ml[h]));
    if (masked) {
      const int col = k0 + 8 * (i / 4) + rw.cq + (i % 2);
      if (col >= rw.kv_len || (rw.causal && col > rw.r0 + 8 * h)) p = 0.f;
    }
    l[h] += p;                      // unrounded, as the TPU sums it
    s[i] = p;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int D, int BQ, int BK, int FOLD>
__global__ void __launch_bounds__(FOLD * BQ / 64 * WG)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int hq, int group, int tq,
                      int kv_len, int tk_stride, float scale, int causal) {
  constexpr int HT = BQ / 64 * WG;      // threads of one head
  constexpr int NT = FOLD * HT;
  constexpr int DP = padded_dim(D);
  constexpr int NCB = DP / CB;          // column blocks (1 or 2)
  constexpr int NS = BK / 2;            // S values per thread
  constexpr int PK = BK / 16;           // k16 steps of P V
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int g = tid / HT, ht = tid % HT;    // folded head, thread in it
  const int wg = ht / WG, t = ht % WG;
  const int lane = t % 32;
  const uint32_t qs = base + g * (Q_BYTES + 4 * KV_BYTES);
  const uint32_t ks = qs + Q_BYTES;         // stage st: ks + st * KV_BYTES
  const uint32_t vs = ks + 2 * KV_BYTES;
  const int bh = blockIdx.y * FOLD + g;     // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const bf16* qg = q + (long long)bh * tq * D;
  const bf16* kg = k + (long long)bkv * tk_stride * D;
  const bf16* vg = v + (long long)bkv * tk_stride * D;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int row_lo = q0 + wg * 64;          // this warp group's first row

  if (D < CB) {     // the padding columns stay zero; the copies skip them
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (base - raw));
    for (int i = tid; i < FOLD * (Q_BYTES + 4 * KV_BYTES) / 16; i += NT)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // each head's threads copy its own tiles
  stage<D, BQ, HT>(qs, qg, q0, tq, ht);
  if (n_tiles > 0) {
    stage<D, BK, HT>(ks, kg, 0, kv_len, ht);
    stage<D, BK, HT>(vs, vg, 0, kv_len, ht);
  }
  cp_async_commit();

  float acc[NCB][32];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  uint32_t pa[PK][4];                       // P of the tile, in bf16
  const Rows rows{r0_of(row_lo, t), 2 * (lane % 4), kv_len, causal, scale};
  // a tile needs masks where it crosses kv_len or this warp group's
  // diagonal
  auto masked = [&](int k0) {
    return k0 + BK > kv_len || (causal && k0 + BK - 1 > row_lo);
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    fence_proxy_async();
    fold_sync<FOLD, HT>(g);   // tile j landed; tile j - 1 fully consumed
    if (j + 1 < n_tiles) {
      stage<D, BK, HT>(ks + (st ^ 1) * KV_BYTES, kg, (j + 1) * BK, kv_len,
                       ht);
      stage<D, BK, HT>(vs + (st ^ 1) * KV_BYTES, vg, (j + 1) * BK, kv_len,
                       ht);
    }
    cp_async_commit();
    const int k0 = j * BK;
    if (causal && k0 > row_lo + 63) continue;   // wholly above the diagonal

    float s[NS], alpha[2];
    wgmma_fence();
    issue_s<D, BQ, BK>(s, qs, ks + st * KV_BYTES, wg);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<BK>(s, pa, m, l, alpha, rows, k0, masked(k0));
#pragma unroll
    for (int c = 0; c < NCB; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i % 4) / 2];
      fence_regs(acc[c]);
    }
    wgmma_fence();
    issue_pv<NCB, BK>(acc, pa, vs + st * KV_BYTES);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCB; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) fence_regs(pa[kk]);
  }
  cp_async_wait_all();      // no copy outlives the block

  // ---- epilogue ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows.r0 + 8 * h;
    const float lt = quad_sum(l[h]);
    if (row >= tq) continue;
    const float ls = lt == 0.f ? 1.f : lt;
    bf16* og = o + ((long long)bh * tq + row) * D;
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int col = c * CB + 8 * f;
        if (col < D) {
          __nv_bfloat162 w = __floats2bfloat162_rn(acc[c][4 * f + 2 * h] / ls,
                                                   acc[c][4 * f + 2 * h + 1] / ls);
          *reinterpret_cast<__nv_bfloat162*>(og + col + rows.cq) = w;
        }
      }
    if (lane % 4 == 0) lse[(long long)bh * tq + row] = m[h] + logf(ls);
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
int launch(const Args& a) {
  constexpr int smem = smem_bytes(D, BQ, BK, FOLD);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  static_assert(FOLD == 1 || BQ == 64, "a fold takes 64 query rows a head");
  auto kern = flash_fwd_sm90_kernel<D, BQ, BK, FOLD>;
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
  kern<<<grid, FOLD * BQ / 64 * WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.hq,
      a.hq / a.hkv, a.tq, a.kv_len, a.tk_stride, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hq, Tq, D], k/v [B, Hkv, tk_stride, D] (keys >= kv_len masked), o
// like q, all bfloat16, contiguous and 16-byte aligned; lse [B*Hq, Tq]
// float32; `fold` heads of the fused B*Hq axis a block. (head_dim, block_q,
// block_k, fold) must be one of the set below, which ops/attention.py's
// body table (FWD_BODIES) holds too, and B*Hq must divide by the fold.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// set not built or a fold that does not divide B*Hq).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int hq, int hkv, int tq, int kv_len,
                   int tk_stride, int head_dim, float scale, int causal,
                   int block_q, int block_k, int fold, void* stream) {
  const Args a{q, k, v, o, lse, batch, hq, hkv, tq, kv_len, tk_stride,
               scale, causal, (cudaStream_t)stream};
#define AUDAX_FWD90(D_, BQ_, BK_, F_)                               \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_ &&         \
      fold == F_)                                                   \
    return launch<D_, BQ_, BK_, F_>(a);
  AUDAX_FWD90(64, 64, 32, 1)
  AUDAX_FWD90(64, 64, 64, 1)
  AUDAX_FWD90(64, 64, 128, 1)
  AUDAX_FWD90(64, 128, 32, 1)
  AUDAX_FWD90(64, 128, 64, 1)
  AUDAX_FWD90(64, 128, 128, 1)
  AUDAX_FWD90(16, 64, 128, 1)
  AUDAX_FWD90(32, 64, 128, 1)
  AUDAX_FWD90(128, 64, 128, 1)
  AUDAX_FWD90(64, 64, 64, 2)
  AUDAX_FWD90(64, 64, 64, 4)
#undef AUDAX_FWD90
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
