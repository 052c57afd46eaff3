// Flash-attention forward for Hopper (sm_90a) in float32 on the tensor
// cores: K2's float32 body, its products in 3xTF32 on mma.sync.
//
// Replaces the TPU kernel audax/ops/attention.py:_fwd_kernel (the forward of
// flash_attention, called from _fwd) for float32 inputs at block_q 64, and
// the head-folded probe tools/attn_headfold_probe.py:_fold_kernel
// (launched by fold_fwd, P1) in float32; csrc/flash_fwd.cu keeps float32
// at block_q 32 and 128, csrc/flash_fwd_sm90.cu bfloat16. For q [B, Hq,
// Tq, D] and k, v [B, Hkv, tk_stride, D] it writes
//
//   o[b, h, i]  = sum_j softmax_j(scale * q_i . k_j) v_j      (kv head h / G)
//   lse[b*Hq+h, i] = m_i + log(l_i)
//
// with keys j >= kv_len masked and never read, and j > i masked when causal
// (Tq == Tk). Masked scores are -1e30; a row that sees no key divides by 1
// (o = 0) and gets lse = -1e30, as on the CUDA-core body.
//
// What bounds it on this card: at Whisper-base's encoder shape [4, 6, 1500,
// 64] the work is 4*B*H*T*T*D = 13.8 GFLOP against 9 MB of q, k, v and o, so
// operations bound it. Plain TF32 would run them at 495 TFLOP/s but keeps
// 10 mantissa bits, which breaks the 1e-4 float32 parity; the CUDA cores
// (67 TFLOP/s) keep it but are 7x slower. 3xTF32 (csrc/tf32x3.cuh: each
// operand split into a TF32 big and small part, three products) keeps
// float32 parity on the tensor cores at a third of their rate, 165
// TFLOP/s: 0.084 ms at that shape, against 0.206 ms on the CUDA cores.
//
// Design (simple first: no warp specialisation, no TMA): one block of 4
// warps per (b*h, 64 query rows), each warp one m16n8k8 row tile of 16
// rows. Q is read from device memory straight into the A-fragment layout,
// scaled by scale * log2(e) (the softmax runs in exp2) and split: at head
// dims up to 64 once, held as big/small fragments; at 128 again for each
// key tile (from L1/L2), since holding it (or even its unsplit values)
// beside 64 accumulators of O spilled past 255 registers on the card. K
// and V tiles of BK keys go through a two-stage ring in shared memory,
// filled by cp.async (16 bytes a copy; rows past kv_len are zero-filled and
// never read), rows padded to D + 4 floats: the B-fragment reads of K (lane
// (g, t) reads row g, column t) and of V (rows 2t and 2t + 1, column g)
// then fall on 32 distinct banks.
//   S = Q K^T:  for each k-step of 8 dims, each n-tile of 8 keys: B from K
//               split in registers, three mma.sync (small cross terms
//               first).
//   softmax:    online, per row in float32 registers: a thread holds rows g
//               and g + 8 of its warp's 16; a row's max goes across the 4
//               lanes of its quad by shuffles, its sum l stays a per-thread
//               partial until the end. Only tiles that cross kv_len or the
//               diagonal are masked, and a warp skips tiles wholly above
//               its diagonal (the TPU's pl.when).
//   O += P V:   the C fragment of S's n-tile j is the A fragment of P for
//               the keys of that tile in a permuted k order (c0/c2 for k =
//               t <-> key 2t, c1/c3 for k = t + 4 <-> key 2t + 1), so no
//               shuffle is needed: V's B fragment is read from key rows
//               2t and 2t + 1. P is split like every other operand.
// The copy of tile j + 1 is in flight while tile j computes. The epilogue
// reduces l over the quad, divides and stores o from the fragments (two
// floats a lane a row), lse in natural log.
//
// Folding (P1): FOLD = f puts f consecutive heads of the fused B*H axis in
// one block of 4f warps at the same 64 query rows; warps 4g .. 4g + 3 own
// head blockIdx.y * f + g, with their own two-stage K/V ring (the heads
// share no operand), and copy their own tiles. Twice per key tile a
// head's warps meet their own named barrier (bar.sync 1 + g over 128
// threads, sm90_wgmma.cuh:fold_sync), so no head waits on another; one
// block barrier for all heads ran no faster on the H100 (PERF.md, P1).
// Folds are built at head_dim 64
// with the 64 x 64 tile. A head's ring takes 69,632 B, so fold 4 (278,528
// B) does not fit one block: its ring holds 32-key halves of the key tile
// (ring_keys), each half one step of the online softmax, 139,264 B in all.
// Fold 4 has 512 threads, so at most 128 registers a thread: Q (64
// registers split), O (32) and S would not fit, so it reads Q at use, as
// head_dim 128 does.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 64;                 // query rows a block: 16 a warp
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of a block

// the keys of one stage of a head's ring for the key tile bk: the whole
// tile, or its half where fold rings of whole tiles exceed a block's
// shared memory
__host__ __device__ constexpr int ring_keys(int d, int bk, int fold) {
  return fold * 16 * bk * (d + 4) <= SMEM_LIMIT ? bk : bk / 2;
}

// for each folded head two stages of a K and a V tile of ring_keys rows,
// rows padded to d + 4 floats
__host__ __device__ constexpr int smem_bytes(int d, int bk, int fold) {
  return fold * 16 * ring_keys(d, bk, fold) * (d + 4);
}

// BK is the ring's keys a stage (ring_keys of the call's key tile)
template <int D, int BK, int FOLD>
__global__ void __launch_bounds__(FOLD * THREADS)
flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int hq, int group, int tq,
                        int kv_len, int tk_stride, float scale, int causal) {
  constexpr int DP = D + 4;            // padded shared-memory row
  constexpr int KS = D / 8;            // k-steps of Q K^T, n-tiles of O
  constexpr int NT = BK / 8;           // n-tiles of S, k-steps of P V
  constexpr int CH = D / 4;            // 16-byte chunks of a row
  // Q held split, else read at use
  constexpr bool HOLD = D <= 64 && FOLD < 4;
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / THREADS;  // folded head
  const int ht = threadIdx.x % THREADS; // thread in the head's warps
  float* ks = smem + g * 4 * BK * DP;  // [2][BK][DP]
  float* vs = ks + 2 * BK * DP;        // [2][BK][DP]

  const int bh = blockIdx.y * FOLD + g;  // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const int warp = ht / 32, lane = ht % 32;
  const int t = lane % 4;
  const int w0 = q0 + 16 * warp;       // the warp's first row
  const int r0 = w0 + lane / 4;        // this thread's rows: r0, r0 + 8
  const float* kg = k + (long long)bkv * tk_stride * D;
  const float* vg = v + (long long)bkv * tk_stride * D;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * BK;
    float* kd = ks + stage * BK * DP;
    float* vd = vs + stage * BK * DP;
    for (int c = ht; c < BK * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 4;
      const bool in = k0 + r < kv_len;
      const long long off = in ? (long long)(k0 + r) * D + col : 0;
      sm90::cp_async16(sm90::smem_addr(kd + r * DP + col), kg + off,
                       in ? 16 : 0);
      sm90::cp_async16(sm90::smem_addr(vd + r * DP + col), vg + off,
                       in ? 16 : 0);
    }
    sm90::cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // Q's A fragment of k-step kk from device memory: a0 (g, t), a1 (g + 8,
  // t), a2 (g, t + 4), a3 (g + 8, t + 4), scaled for exp2 and split
  const float qscale = scale * LOG2E;
  const float* qg = q + (long long)bh * tq * D;
  auto q_frag = [&](int kk) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      x[i] = row < tq ? __ldg(qg + (long long)row * D + col) * qscale : 0.f;
    }
    return tf32x3::split_a(x);
  };
  tf32x3::FragA qf[HOLD ? KS : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) qf[kk] = q_frag(kk);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int nd = 0; nd < KS; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, (tile + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    sm90::fold_sync<FOLD, THREADS>(g); // tile's K and V are in place
    const int k0 = tile * BK;
    const float* kt = ks + (tile & 1) * BK * DP;
    const float* vt = vs + (tile & 1) * BK * DP;
    if (!causal || k0 <= w0 + 15) {    // warp-uniform
      // ---- S = Q K^T (log2-scaled scores) ----
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        tf32x3::FragA a;
        if constexpr (HOLD) {
          a = qf[kk];
        } else {
          a = q_frag(kk);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tf32x3::mma3(s[nt], a, tf32x3::load_b_t(kt, DP, 8 * nt, 8 * kk,
                                                  lane));
      }
      // ---- masks: keys past kv_len, and above the diagonal ----
      if (k0 + BK > kv_len || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = k0 + 8 * nt + 2 * t + (i & 1);
            const int row = r0 + 8 * (i >> 1);
            if (col >= kv_len || (causal && col > row)) s[nt][i] = NEG;
          }
      }
      // ---- online softmax, rows r0 (i = 0, 1) and r0 + 8 (i = 2, 3) ----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = exp2f(m[h] - m_new);
        // a row that has seen only masked keys keeps p = 0 for them
        const float mu = m_new == NEG ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[nt][e] = exp2f(s[nt][e] - mu);
            sum += s[nt][e];
          }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int nd = 0; nd < KS; ++nd) {
          acc[nd][2 * h] *= alpha;
          acc[nd][2 * h + 1] *= alpha;
        }
      }
      // ---- O += P V: S's C fragments as P's A fragments ----
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const tf32x3::FragA a = tf32x3::a_from_c(s[j]);
#pragma unroll
        for (int nd = 0; nd < KS; ++nd)
          tf32x3::mma3(acc[nd], a, tf32x3::load_b_rows_perm(vt, DP, 8 * j,
                                                            8 * nd, lane));
      }
    }
    sm90::fold_sync<FOLD, THREADS>(g); // the stage is free for tile + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(~0u, lt, 1);
    lt += __shfl_xor_sync(~0u, lt, 2);
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    const float ls = lt == 0.f ? 1.f : lt;
    float* og = o + ((long long)bh * tq + row) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd)
      *reinterpret_cast<float2*>(og + 8 * nd) =
          make_float2(acc[nd][2 * h] / ls, acc[nd][2 * h + 1] / ls);
    if (t == 0)
      lse[(long long)bh * tq + row] = lt == 0.f ? NEG
                                                : m[h] * LN2 + logf(lt);
  }
}

struct Args {
  const float *q, *k, *v;
  float* o;
  float* lse;
  int batch, hq, hkv, tq, kv_len, tk_stride;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D, int BK, int FOLD>
int launch(const Args& a) {
  constexpr int smem = smem_bytes(D, BK, FOLD);
  static_assert(smem <= SMEM_LIMIT, "tile exceeds one block's shared memory");
  auto kern = flash_fwd_tf32x3_kernel<D, ring_keys(D, BK, FOLD), FOLD>;
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
  kern<<<grid, FOLD * THREADS, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.lse, a.hq, a.hq / a.hkv, a.tq, a.kv_len,
      a.tk_stride, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hq, Tq, D], k/v [B, Hkv, tk_stride, D] (keys >= kv_len masked), o
// like q, all float32, contiguous and 16-byte aligned; lse [B*Hq, Tq]
// float32; `fold` heads of the fused B*Hq axis a block. (head_dim, block_q,
// block_k, fold) must be one of the set below, which ops/attention.py's
// body table (FWD_BODIES) holds too, and B*Hq must divide by the fold.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// set not built or a fold that does not divide B*Hq).
int flash_fwd_tf32x3(const float* q, const float* k, const float* v,
                     float* o, float* lse, int batch, int hq, int hkv, int tq,
                     int kv_len, int tk_stride, int head_dim, float scale,
                     int causal, int block_q, int block_k, int fold,
                     void* stream) {
  const Args a{q, k, v, o, lse, batch, hq, hkv, tq, kv_len, tk_stride,
               scale, causal, (cudaStream_t)stream};
#define AUDAX_TF32X3(D_, BQ_, BK_, F_)                              \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_ &&         \
      fold == F_)                                                   \
    return launch<D_, BK_, F_>(a);
  AUDAX_TF32X3(16, 64, 64, 1)
  AUDAX_TF32X3(32, 64, 64, 1)
  AUDAX_TF32X3(64, 64, 64, 1)
  AUDAX_TF32X3(128, 64, 64, 1)
  AUDAX_TF32X3(64, 64, 32, 1)
  AUDAX_TF32X3(64, 64, 128, 1)
  AUDAX_TF32X3(64, 64, 64, 2)
  AUDAX_TF32X3(64, 64, 64, 4)
#undef AUDAX_TF32X3
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
