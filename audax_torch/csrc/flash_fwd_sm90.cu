// Flash-attention forward for Hopper (sm_90a) on the tensor cores: the
// bfloat16 body of K2, with wgmma products and float32 accumulators.
//
// Replaces the TPU kernel audax/ops/attention.py:_fwd_kernel (the forward of
// flash_attention, called from _fwd) for bfloat16 inputs at block_q >= 64;
// csrc/flash_fwd.cu keeps float32, bfloat16 at block_q 32 and the head
// folds. For q [B, Hq, Tq, D] and k, v [B, Hkv, tk_stride, D] it writes
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
// a row's 16 contiguous bytes), lse in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;          // threads of one warp group
constexpr int CB = 64;           // bf16 columns of one 128-byte swizzled block
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// head dim as staged: below 64 zero-padded to one column block
__host__ __device__ constexpr int padded_dim(int d) { return d < CB ? CB : d; }

// dynamic shared memory: Q, two stages of K and V, and 1024 bytes to align
// the swizzle atoms (8 rows x 128 bytes) on 1024 bytes
__host__ __device__ constexpr int smem_bytes(int d, int bq, int bk) {
  return 2 * padded_dim(d) * (bq + 4 * bk) + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// make this thread's generic-proxy writes to shared memory (cp.async, plain
// stores) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the registers of an accumulator between the asynchronous wgmma and
// the code that reads or writes them, so the compiler moves no access
// across the fence or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (unused by the layouts here: one column
// block per instruction), stride byte offset 1024 (8 rows x 128 bytes to
// the next 8-row group), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// S[64, 32] (+)= A[64, 16] * B[32, 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S[64, 64] (+)= A[64, 16] * B[64, 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S[64, 128] (+)= A[64, 16] * B[128, 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64, 64] += P[64, 16] * V[16, 64]: P in registers (bf16 pairs), V
// MN-major in shared memory (transposed B)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

// rows [row0, row0 + R) of a [*, D] bf16 matrix into the swizzled tile at
// shared address dst (column blocks of R x 128 bytes); rows at or past
// `valid` are zero-filled and not read
template <int D, int R, int NT>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* src, int row0,
                                      int valid, int tid) {
  constexpr int CH = D / 8;      // 16-byte chunks of a row
#pragma unroll
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const uint32_t off =
        (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r & 7)) << 4);
    const bool in = row0 + r < valid;
    cp_async16(dst + off, src + (long long)(in ? row0 + r : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

template <int BK>
__device__ __forceinline__ void wgmma_s(float (&s)[BK / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (BK == 32) wgmma_ss_n32(s, da, db, scale_d);
  else if constexpr (BK == 64) wgmma_ss_n64(s, da, db, scale_d);
  else wgmma_ss_n128(s, da, db, scale_d);
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
    wgmma_s<BK>(s, sw128_desc(qa), sw128_desc(kb), kk > 0);
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

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 64 * WG)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int hq, int group, int tq,
                      int kv_len, int tk_stride, float scale, int causal) {
  constexpr int NT = BQ / 64 * WG;
  constexpr int DP = padded_dim(D);
  constexpr int NCB = DP / CB;          // column blocks (1 or 2)
  constexpr int NS = BK / 2;            // S values per thread
  constexpr int PK = BK / 16;           // k16 steps of P V
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  const uint32_t ks = qs + Q_BYTES;         // stage st: ks + st * KV_BYTES
  const uint32_t vs = ks + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / WG, t = tid % WG;
  const int lane = t % 32;
  const int bh = blockIdx.y;                // b * hq + h
  const int bkv = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = blockIdx.x * BQ;
  const bf16* qg = q + (long long)bh * tq * D;
  const bf16* kg = k + (long long)bkv * tk_stride * D;
  const bf16* vg = v + (long long)bkv * tk_stride * D;

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  const int row_lo = q0 + wg * 64;          // this warp group's first row

  if (D < CB) {     // the padding columns stay zero; the copies skip them
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (qs - raw));
    for (int i = tid; i < (Q_BYTES + 4 * KV_BYTES) / 16; i += NT)
      z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  stage<D, BQ, NT>(qs, qg, q0, tq, tid);
  if (n_tiles > 0) {
    stage<D, BK, NT>(ks, kg, 0, kv_len, tid);
    stage<D, BK, NT>(vs, vg, 0, kv_len, tid);
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
    __syncthreads();        // tile j landed; tile j - 1 fully consumed
    if (j + 1 < n_tiles) {
      stage<D, BK, NT>(ks + (st ^ 1) * KV_BYTES, kg, (j + 1) * BK, kv_len,
                       tid);
      stage<D, BK, NT>(vs + (st ^ 1) * KV_BYTES, vg, (j + 1) * BK, kv_len,
                       tid);
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

template <int D, int BQ, int BK>
int launch(const Args& a) {
  constexpr int smem = smem_bytes(D, BQ, BK);
  static_assert(smem <= 232448, "tile exceeds one block's shared memory");
  auto kern = flash_fwd_sm90_kernel<D, BQ, BK>;
  // once per instantiation, on its first (eager) launch: nothing but the
  // launch itself is issued when a later call is captured into a CUDA graph
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  dim3 grid((a.tq + BQ - 1) / BQ, a.batch * a.hq);
  kern<<<grid, BQ / 64 * WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.hq,
      a.hq / a.hkv, a.tq, a.kv_len, a.tk_stride, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Hq, Tq, D], k/v [B, Hkv, tk_stride, D] (keys >= kv_len masked), o
// like q, all bfloat16, contiguous and 16-byte aligned; lse [B*Hq, Tq]
// float32. (head_dim, block_q, block_k) must be one of the set below, which
// ops/attention.py's body table (FWD_BODIES) holds too. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a set not
// built).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int hq, int hkv, int tq, int kv_len,
                   int tk_stride, int head_dim, float scale, int causal,
                   int block_q, int block_k, void* stream) {
  const Args a{q, k, v, o, lse, batch, hq, hkv, tq, kv_len, tk_stride,
               scale, causal, (cudaStream_t)stream};
#define AUDAX_FWD90(D_, BQ_, BK_)                                   \
  if (head_dim == D_ && block_q == BQ_ && block_k == BK_)           \
    return launch<D_, BQ_, BK_>(a);
  AUDAX_FWD90(64, 64, 32)
  AUDAX_FWD90(64, 64, 64)
  AUDAX_FWD90(64, 64, 128)
  AUDAX_FWD90(64, 128, 32)
  AUDAX_FWD90(64, 128, 64)
  AUDAX_FWD90(64, 128, 128)
  AUDAX_FWD90(16, 64, 128)
  AUDAX_FWD90(32, 64, 128)
  AUDAX_FWD90(128, 64, 128)
#undef AUDAX_FWD90
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
