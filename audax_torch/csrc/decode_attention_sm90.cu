// K3 and K6 redesigned for Hopper (sm_90a): decode attention over a
// layer-stacked KV cache, the keys split over a thread block cluster.
//
// Replaces the TPU kernels audax/ops/attention.py:_dec_kernel_stacked
// (called by decode_attention_stacked, float and quant=True) and
// audax/ops/attention.py:_dec_kernel (decode_attention: the same
// arithmetic on one unstacked cache, launched here at L = 1). For q [B, H,
// Tq, D] (Tq <= 16) and the cache k, v [L, B, Hkv, S, D] -- q's dtype, or
// int8 with float32 per-vector scales ks, vs [L, B, Hkv, S] -- it reads
// layer `layer` in place and writes what _dec_kernel_stacked writes:
//
//   s_rj = scale * q_r . k_j  (times ks_j in int8)  where j < S and
//          j <= pos[b] + r, else -1e30;
//   m_r  = max_j s_rj,  p_rj = exp(s_rj - m_r) (0 where masked),
//   l_r  = sum_j p_rj (unrounded),
//   o_r  = sum_j round(p_rj (* vs_j)) v_j / (l_r, or 1 where it is 0),
//
// round() the cast to q's dtype, the kv head h / (H / Hkv). pos is a
// per-slot device vector [B], or one position known on the host (a scalar,
// or S for every key) passed as an int with a null pointer.
//
// What bounds it on an H100 SXM: memory. A key row costs 2 D bytes of K/V
// (int8) or more for 4 D FLOPs per query row, far below the card's balance
// point, so the bound is the bytes of the visible K/V rows (and scales)
// over 3.35 TB/s: 5.5 us for Whisper-tiny's cross call (B 4, H 6, S 1500,
// f32: 18.4 MB), 9.8 us for serving's (B 8, H 20, S 1500, int8).
//
// The first body (decode_attention.cu) ran at 7-11x that bound: one block
// per (batch, head), 24 blocks on 132 SMs; a thread per key row, so a
// warp's load touched 32 rows; three passes of block reductions; K/V read
// again by every q-head of a kv head. What this body does:
//
// 1. Keys split over a thread block cluster: grid (B Hkv head_blocks,
//    splits), cluster (1, splits, 1), splits <= 16 (a non-portable size).
//    split_count takes the keys the call can see (min(S, pos + Tq) for a
//    host pos, S for a per-slot vector): blocks for eight per SM, at least
//    MIN_KEYS keys each, more splits where a block's K/V would not fit.
//    Transcription's cross call: 24 x 16 blocks of 94 keys (48 KB of f32
//    K/V each); serving's: 160 x 7 blocks of 215 int8 keys (27 KB). Eight
//    a SM beat four and sixteen on the card at the serving shape: its
//    layer of int8 K/V (30 MB) is about all the card's shared memory, so
//    it runs in more than one wave, and smaller blocks overlap one's copy
//    with another's arithmetic.
// 2. A block's keys of one (layer, b, kv head) are one contiguous run of
//    rows, copied whole into shared memory by 16-byte cp.async (scales by
//    4-byte ones), K and V all in flight at once, V's copy under the
//    scores. No thread reads K/V from device memory itself. A chunk too
//    large for shared memory (some thousands of keys, tile_keys) is copied
//    in tiles, one after another: K's for the scores, then V's for PV.
// 3. Scores from shared memory with D / VEC lanes across a key row (16
//    bytes a lane: a warp reads 512 contiguous bytes, no bank conflict)
//    and a shuffle sum, U keys a lane at once so that the shuffles of
//    their sums overlap; int8 widened by a byte permute and an add. A block serves every q-head of its kv head and
//    every query row, up to MAX_ROWS rows (head_block; past it the q-heads
//    are split over the grid), so K/V are read once per kv head.
// 4. The reference's roundings in one launch. Each block's row maxima go
//    to every block of the cluster through distributed shared memory
//    (stores, no remote loads); after one cluster barrier every block
//    takes the global m, and p = exp(s - m), l and
//    round(p) are exactly the reference's (no per-split rescale, which
//    rounds p differently in bf16). A block's partial l goes to every
//    block, its partial PV to the owner of each slice of the output; after
//    a second barrier each owner sums them in block order and divides. No
//    atomics, no workspace: the same bits on every run.
// 5. A block whose keys lie wholly past its slot's position (a per-slot
//    pos) skips the copy and the arithmetic but takes part in both
//    barriers with zero partials: an early return would deadlock the
//    cluster.
//
// tests/torch_port/test_torch_decode_sm90.py transcribes the schedule into
// numpy, with the plan and the shared memory read from this file.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace decsm90 {

constexpr int THREADS = 128;
constexpr int WARPS = 4;
constexpr int MAX_Q = 16;                  // query rows of one launch
constexpr int MAX_ROWS = 64;               // query rows of one block
constexpr int RG = 16;                     // query rows of one PV pass
constexpr int MAX_SPLITS = 16;             // blocks of a cluster (H100)
constexpr int MIN_KEYS = 32;               // keys a block is given at least
constexpr int SMS = 132;                   // an H100 SXM's SMs
constexpr int TARGET_BLOCKS = 8 * SMS;     // eight blocks per SM
constexpr int TILE_STEP = 32;              // a tile's keys, a multiple of it
constexpr int SMEM_LIMIT = 232448;         // an H100 block's shared memory
constexpr int SLACK = 64;                  // the layout's 16-byte roundings
constexpr int PART_BYTES = 16 * THREADS;   // PV partials of one query row
constexpr int MAX_S = 16777216;            // keys a plan is computed for
constexpr int MIN_BLOCKS = 4;              // blocks an SM's registers hold:
                                           // ptxas, left alone, spilled some
                                           // one-row instantiations at 64

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int mini(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ constexpr int maxi(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}
__host__ __device__ constexpr int a16(int bytes) {
  return 16 * cdiv(bytes, 16);
}

// The q-heads of one kv head a block serves, the blocks that share a kv
// head, and a block's query rows (q-heads x Tq)
__host__ __device__ constexpr int head_block(int group, int tq) {
  return mini(group, MAX_ROWS / tq);
}
__host__ __device__ constexpr int head_blocks(int group, int tq) {
  return cdiv(group, head_block(group, tq));
}
__host__ __device__ constexpr int block_rows(int group, int tq) {
  return head_block(group, tq) * tq;
}
// The keys a call can see: S for a per-slot pos, else min(S, pos + Tq)
__host__ __device__ constexpr int visible_keys(int s_len, int pos, int tq,
                                               int per_slot) {
  return per_slot ? s_len : clampi(pos + tq, 0, s_len);
}
// Shared memory beside the keys: q rows; m, the global m, l and the
// warps' partials of a row; every block's m and l; the owner's slots of the partial PV; the key slices' PV
// partials (held in K's space, counted here at their full size)
__host__ __device__ constexpr int fixed_bytes(int rows, int d) {
  return a16(4 * rows * d) + a16(4 * (3 * rows + WARPS)) +
         2 * a16(4 * MAX_SPLITS * rows) + a16(4 * (rows * d + MAX_SPLITS)) +
         PART_BYTES * mini(rows, RG);
}
// A key's bytes: its scores, its K and V rows, their scales
__host__ __device__ constexpr int key_bytes(int rows, int d, int elt,
                                            int quant) {
  return 4 * rows + 2 * d * elt + 8 * quant;
}
// The most keys a block holds whole
__host__ __device__ constexpr int whole_keys(int rows, int d, int elt,
                                             int quant) {
  return (SMEM_LIMIT - SLACK - fixed_bytes(rows, d)) /
         key_bytes(rows, d, elt, quant);
}
// Blocks of a cluster: eight per SM over the grid's `pairs` (B Hkv
// head_blocks), at least MIN_KEYS keys each, at least enough to hold the
// keys whole, at most MAX_SPLITS
__host__ __device__ constexpr int split_count(int keys, int pairs, int rows,
                                              int d, int elt, int quant) {
  return clampi(maxi(mini(cdiv(TARGET_BLOCKS, pairs), keys / MIN_KEYS),
                     cdiv(keys, whole_keys(rows, d, elt, quant))),
                1, MAX_SPLITS);
}
__host__ __device__ constexpr int split_chunk(int keys, int splits) {
  return maxi(1, cdiv(keys, splits));
}
// The keys of one copy: the whole chunk where it fits, else what the space
// beside the chunk's scores holds, in multiples of TILE_STEP (0: no plan)
__host__ __device__ constexpr int tile_keys(int rows, int chunk, int d,
                                            int elt, int quant) {
  return chunk <= whole_keys(rows, d, elt, quant)
             ? chunk
             : maxi(0, (SMEM_LIMIT - SLACK - fixed_bytes(rows, d) -
                        4 * rows * chunk) / (2 * d * elt + 8 * quant)) /
                   TILE_STEP * TILE_STEP;
}
// One block's shared memory, in the kernel's order
__host__ __device__ constexpr int smem_bytes(int rows, int chunk, int tile,
                                             int d, int elt, int quant) {
  return a16(4 * rows * d) + a16(4 * (3 * rows + WARPS)) +
         2 * a16(4 * MAX_SPLITS * rows) + a16(4 * (rows * d + MAX_SPLITS)) +
         a16(4 * rows * chunk) +
         maxi(tile * d * elt, PART_BYTES * mini(rows, RG)) + tile * d * elt +
         2 * quant * a16(4 * tile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// every thread of every block of the cluster; what each wrote to shared
// memory (its own or another block's) before it is visible to all after
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T (round to nearest even), as float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
// four int8 values of w as floats, exactly: byte b ^ 0x80 (= b + 128) as
// the low bits of 2^23, less 2^23 + 128 -- a byte permute and an add each,
// where a conversion instruction (I2F) runs at a quarter of their rate
__device__ __forceinline__ void s8x4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
}

// 16 bytes of a K row in shared memory as 16 / sizeof(KV) floats
template <typename KV>
__device__ __forceinline__ void load16(const uint8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(KV) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(ws[i]);
  } else if constexpr (sizeof(KV) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_lo(ws[i]);
      out[2 * i + 1] = bf16_hi(ws[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) s8x4(ws[i], out + 4 * i);
  }
}
// 4 elements of a V row in shared memory as floats
template <typename KV>
__device__ __forceinline__ void load4(const uint8_t* p, float* out) {
  if constexpr (sizeof(KV) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else if constexpr (sizeof(KV) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(w.x); out[1] = bf16_hi(w.x);
    out[2] = bf16_lo(w.y); out[3] = bf16_hi(w.y);
  } else {
    s8x4(*reinterpret_cast<const uint32_t*>(p), out);
  }
}

// `count` rows of `row_bytes` from src to dst, 16 bytes a copy
__device__ __forceinline__ void copy_rows(uint8_t* dst, const void* src,
                                          int count, int row_bytes) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int pieces = count * row_bytes / 16;
  for (int c = threadIdx.x; c < pieces; c += THREADS)
    cp_async16(dst + 16 * c, s + 16 * c);
}
__device__ __forceinline__ void copy_scales(float* dst, const float* src,
                                            int count) {
  for (int c = threadIdx.x; c < count; c += THREADS)
    cp_async4(dst + c, src + c);
}

// grid (B Hkv head_blocks, splits), cluster (1, splits, 1); T: q and o's
// dtype; KV: the cache's (T, or int8_t with the scales ks, vs when QUANT);
// RGT: the query rows of one PV pass (1 for a block of one row, else RG)
template <int D, typename T, typename KV, bool QUANT, int RGT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_cluster_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs, T* __restrict__ o,
                      const int* __restrict__ pos, int host_pos, int layer,
                      int batch, int heads, int hkv, int tq, int s_len,
                      int keys, int chunk, int tile, float scale) {
  constexpr int ELT = (int)sizeof(KV);
  constexpr int ROWB = D * ELT;            // bytes of a K or V row
  constexpr int VEC = 16 / ELT;            // elements of 16 bytes
  constexpr int LPK = D / VEC;             // lanes across a key row
  constexpr int KPW = 32 / LPK;            // key rows a warp scores at once
  constexpr int U = VEC == 16 ? 2 : 4;     // ... times U, for independent sums
  constexpr int TPR = D / 4;               // threads across a value row
  constexpr int SL = THREADS / TPR;        // key slices of the PV product
  static_assert(LPK >= 1 && LPK <= 32 && SL >= 1, "head dim");
  const float NEG = -1e30f;
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the block's (b, kv head), its q-heads h0 .. and its keys j0 .. j0 + n
  const int group = heads / hkv;
  const int hb = head_block(group, tq);
  const int nhb = head_blocks(group, tq);
  const int rows_a = hb * tq;              // the layout's rows
  const int rg_a = mini(rows_a, RG);
  const int hblk = blockIdx.x % nhb, bk = blockIdx.x / nhb;
  const int b = bk / hkv, kvh = bk % hkv;
  const int h0 = kvh * group + hblk * hb;
  const int rows = mini(hb, group - hblk * hb) * tq;
  const int p_b = pos != nullptr ? pos[b] : host_pos;
  const int j0 = rank * chunk;
  const int seen = clampi(p_b + tq, 0, s_len);  // keys slot b's rows see
  const int n = maxi(0, mini(mini(j0 + chunk, keys), seen) - j0);
  const bool whole = n <= tile;
  const long long row0 =
      (((long long)layer * batch + b) * hkv + kvh) * s_len + j0;
  const KV* kb = k + row0 * D;
  const KV* vb = v + row0 * D;
  // a row's keys over wpr warps where the block has fewer rows than warps
  const int wpr = maxi(1, WARPS / rows);
  const int sub = warp % wpr;

  float* qs = reinterpret_cast<float*>(smem);                 // [rows_a][D]
  float* mx = qs + a16(4 * rows_a * D) / 4;                   // [rows_a]
  float* gm = mx + rows_a;                                    // [rows_a]
  float* lsum = gm + rows_a;                                  // [rows_a]
  float* wtmp = lsum + rows_a;                                // [WARPS]
  float* mred = mx + a16(4 * (3 * rows_a + WARPS)) / 4;  // [MAX_SPLITS][rows_a]
  float* lred = mred + a16(4 * MAX_SPLITS * rows_a) / 4;  // the same
  float* red = lred + a16(4 * MAX_SPLITS * rows_a) / 4;  // [splits][share]
  float* sc = red + a16(4 * (rows_a * D + MAX_SPLITS)) / 4;  // [rows_a][chunk]
  uint8_t* kbuf = reinterpret_cast<uint8_t*>(sc + a16(4 * rows_a * chunk) / 4);
  float* part = reinterpret_cast<float*>(kbuf);     // [SL][rg_a][D], later
  uint8_t* vbuf = kbuf + maxi(tile * ROWB, PART_BYTES * rg_a);
  float* kss = reinterpret_cast<float*>(vbuf + tile * ROWB);  // [tile]
  float* vss = kss + a16(4 * tile) / 4;                       // [tile]

  // 1. the whole chunk's K and scales, then V: two groups in flight
  if (whole && n > 0) {
    copy_rows(kbuf, kb, n, ROWB);
    if (QUANT) {
      copy_scales(kss, ks + row0, n);
      copy_scales(vss, vs + row0, n);
    }
    cp_async_commit();
    copy_rows(vbuf, vb, n, ROWB);
    cp_async_commit();
  }
  const T* qb = q + ((long long)b * heads + h0) * tq * D;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) qs[i] = to_f32(qb[i]);

  // 2. scores of keys t0 .. t0 + cnt (at kbuf row 0 ..): LPK lanes a key
  // row, VEC elements a lane summed in order, then a butterfly over the
  // LPK lanes; U keys a lane at once; masked scores -1e30
  auto scores = [&](int t0, int cnt) {
    const int kl = lane / LPK, li = lane % LPK;
    for (int base = warp * KPW * U; base < cnt; base += WARPS * KPW * U) {
      float kf[U][VEC];
      float kscale[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jj = base + u * KPW + kl;
        const int jr = jj < cnt ? jj : 0;
        load16<KV>(kbuf + jr * ROWB + li * 16, kf[u]);
        kscale[u] = QUANT ? kss[jr] : 1.f;
      }
      for (int r = 0; r < rows; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D +
                                                           li * VEC);
        float acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qv = qr[e];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            acc[u] = fmaf(qv.x, kf[u][4 * e], acc[u]);
            acc[u] = fmaf(qv.y, kf[u][4 * e + 1], acc[u]);
            acc[u] = fmaf(qv.z, kf[u][4 * e + 2], acc[u]);
            acc[u] = fmaf(qv.w, kf[u][4 * e + 3], acc[u]);
          }
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
            acc[u] += __shfl_xor_sync(~0u, acc[u], off);
        if (li == 0) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int jj = base + u * KPW + kl;
            if (jj < cnt) {
              float s = acc[u] * scale;
              if (QUANT) s *= kscale[u];
              sc[r * chunk + t0 + jj] =
                  j0 + t0 + jj <= p_b + r % tq ? s : NEG;
            }
          }
        }
      }
    }
  };
  if (whole) {
    cp_async_wait<1>();                    // K has landed; V may not have
    __syncthreads();
    scores(0, n);
  } else {
    for (int t0 = 0; t0 < n; t0 += tile) {
      const int cnt = mini(tile, n - t0);
      __syncthreads();                     // the last tile is scored
      copy_rows(kbuf, kb + (long long)t0 * D, cnt, ROWB);
      if (QUANT) copy_scales(kss, ks + row0 + t0, cnt);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      scores(t0, cnt);
    }
  }
  __syncthreads();

  // 3. the block's row maxima (a row's keys over wpr warps, their maxima
  // then taken in warp order), then the cluster's
  for (int r = warp / wpr; r < rows; r += WARPS / wpr) {
    float m = NEG;
    for (int jj = sub * 32 + lane; jj < n; jj += 32 * wpr)
      m = fmaxf(m, sc[r * chunk + jj]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(~0u, m, off));
    if (lane == 0) {
      if (wpr == 1)
        mx[r] = m;
      else
        wtmp[warp] = m;
    }
  }
  if (wpr > 1) {
    __syncthreads();
    if (threadIdx.x < rows) {
      float m = NEG;
      for (int w = 0; w < wpr; ++w) m = fmaxf(m, wtmp[threadIdx.x * wpr + w]);
      mx[threadIdx.x] = m;
    }
  }
  // every block's maxima into slot [rank] of every block (remote stores,
  // which need no round trip), then each block takes the maximum locally
  __syncthreads();
  for (int i = threadIdx.x; i < splits * rows; i += THREADS) {
    const int qq = i / rows, r = i % rows;
    cluster.map_shared_rank(mred, qq)[rank * rows_a + r] = mx[r];
  }
  cluster_barrier();
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float m = NEG;
    for (int qq = 0; qq < splits; ++qq) m = fmaxf(m, mred[qq * rows_a + r]);
    gm[r] = m;
  }
  __syncthreads();

  // 4. p = exp(s - m) where visible, the block's l (its warps' sums in
  // warp order), and p times v's scale (int8) rounded to T in place of s
  for (int r = warp / wpr; r < rows; r += WARPS / wpr) {
    const float m = gm[r];
    const int last = p_b + r % tq;
    float l = 0.f;
    for (int jj = sub * 32 + lane; jj < n; jj += 32 * wpr) {
      const float e = j0 + jj <= last ? expf(sc[r * chunk + jj] - m) : 0.f;
      l += e;
      float pj = e;
      if (QUANT) pj *= whole ? vss[jj] : __ldg(vs + row0 + jj);
      sc[r * chunk + jj] = round_to<T>(pj);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(~0u, l, off);
    if (lane == 0) {
      if (wpr == 1)
        lsum[r] = l;
      else
        wtmp[warp] = l;
    }
  }
  __syncthreads();
  if (wpr > 1) {
    if (threadIdx.x < rows) {
      float l = 0.f;
      for (int w = 0; w < wpr; ++w) l += wtmp[threadIdx.x * wpr + w];
      lsum[threadIdx.x] = l;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < splits * rows; i += THREADS) {
    const int qq = i / rows, r = i % rows;
    cluster.map_shared_rank(lred, qq)[rank * rows_a + r] = lsum[r];
  }

  // 5. PV, RGT rows at a time: thread (slice sl, columns d0 .. d0 + 3)
  // sums keys sl, sl + SL, ...; the slices' sums are added in order and
  // the block's partial goes to the owner of its element (f / share)
  const int share = cdiv(rows * D, splits);
  const int sl = threadIdx.x / TPR, d0 = 4 * (threadIdx.x % TPR);
  if (whole) {
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int r0 = 0; r0 < rows; r0 += RGT) {
    const int nr = mini(RGT, rows - r0);
    float acc[RGT][4];
#pragma unroll
    for (int r = 0; r < RGT; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    auto pv = [&](int t0, int cnt) {
#pragma unroll 2
      for (int jj = sl; jj < cnt; jj += SL) {
        float vv[4];
        load4<KV>(vbuf + jj * ROWB + d0 * ELT, vv);
#pragma unroll
        for (int r = 0; r < RGT; ++r) {
          if (r < nr) {
            const float p = sc[(r0 + r) * chunk + t0 + jj];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
          }
        }
      }
    };
    if (whole) {
      pv(0, n);
    } else {
      for (int t0 = 0; t0 < n; t0 += tile) {
        const int cnt = mini(tile, n - t0);
        __syncthreads();                   // the last tile is summed
        copy_rows(vbuf, vb + (long long)t0 * D, cnt, ROWB);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        pv(t0, cnt);
      }
    }
#pragma unroll
    for (int r = 0; r < RGT; ++r)
      if (r < nr)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          part[(sl * rg_a + r) * D + d0 + c] = acc[r][c];
    __syncthreads();
    for (int i = threadIdx.x; i < nr * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float tot = 0.f;
#pragma unroll
      for (int s = 0; s < SL; ++s) tot += part[(s * rg_a + r) * D + d];
      const int f = (r0 + r) * D + d;
      cluster.map_shared_rank(red, f / share)[rank * share + f % share] =
          tot;
    }
    __syncthreads();                       // part is free again
  }

  // 6. every partial has landed: each owner sums its elements' partials
  // and the rows' l in block order
  cluster_barrier();
  T* ob = o + ((long long)b * heads + h0) * tq * D;
  for (int i = threadIdx.x; i < share; i += THREADS) {
    const int f = rank * share + i;
    if (f >= rows * D) break;
    const int r = f / D;
    float acc = 0.f, l = 0.f;
    for (int qq = 0; qq < splits; ++qq) {
      acc += red[qq * share + i];
      l += lred[qq * rows_a + r];
    }
    ob[f] = from_f32<T>(acc / (l == 0.f ? 1.f : l));
  }
}

namespace {  // internal linkage: each instantiation keeps its own statics

struct Plan {
  int rows, pairs, keys, splits, chunk, tile, smem;
};

Plan make_plan(int batch, int heads, int hkv, int tq, int s_len, int d,
               int host_pos, int per_slot, int elt, int quant) {
  Plan p{};
  const int group = heads / hkv;
  p.rows = block_rows(group, tq);
  p.pairs = batch * hkv * head_blocks(group, tq);
  p.keys = visible_keys(s_len, host_pos, tq, per_slot);
  p.splits = split_count(p.keys, p.pairs, p.rows, d, elt, quant);
  p.chunk = split_chunk(p.keys, p.splits);
  p.tile = tile_keys(p.rows, p.chunk, d, elt, quant);
  p.smem = p.tile > 0 ? smem_bytes(p.rows, p.chunk, p.tile, d, elt, quant)
                      : -1;
  return p;
}

bool valid_call(int batch, int heads, int hkv, int tq, int s_len, int d) {
  return batch >= 1 && hkv >= 1 && heads >= hkv && heads % hkv == 0 &&
         tq >= 1 && tq <= MAX_Q && s_len >= 1 && s_len <= MAX_S &&
         (d == 16 || d == 32 || d == 64 || d == 128);
}

template <int D, typename T, typename KV, bool QUANT, int RGT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, void* o, const int* pos, int host_pos, int layer,
           int batch, int heads, int hkv, int tq, int s_len, float scale,
           cudaStream_t stream) {
  auto kernel = decode_cluster_kernel<D, T, KV, QUANT, RGT>;
  static bool sized = false;               // once per instantiation
  // per cluster size: the most shared memory seen to fit an SM's cluster
  // slot, and the least seen not to (0: none yet)
  static int fits[MAX_SPLITS + 1] = {};
  static int refused[MAX_SPLITS + 1] = {};
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const Plan p = make_plan(batch, heads, hkv, tq, s_len, D, host_pos,
                           pos != nullptr, (int)sizeof(KV), QUANT);
  if (p.smem < 0 || p.smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.pairs, p.splits, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (p.smem > fits[p.splits]) {
    if (refused[p.splits] && p.smem >= refused[p.splits])
      return (int)cudaErrorInvalidConfiguration;
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) {
      refused[p.splits] = p.smem;
      return (int)cudaErrorInvalidConfiguration;
    }
    fits[p.splits] = p.smem;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, static_cast<T*>(o), pos, host_pos,
      layer, batch, heads, hkv, tq, s_len, p.keys, p.chunk, p.tile, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a block of one query row (Tq 1 without GQA: every Whisper decode step)
// takes the PV pass of one row, any other RG rows at a time
template <int D, typename T, typename KV, bool QUANT>
int launch_rows(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, void* o, const int* pos, int host_pos,
                int layer, int batch, int heads, int hkv, int tq, int s_len,
                float scale, cudaStream_t st) {
  if (block_rows(heads / hkv, tq) == 1)
    return launch<D, T, KV, QUANT, 1>(q, k, v, ks, vs, o, pos, host_pos,
                                      layer, batch, heads, hkv, tq, s_len,
                                      scale, st);
  return launch<D, T, KV, QUANT, RG>(q, k, v, ks, vs, o, pos, host_pos,
                                     layer, batch, heads, hkv, tq, s_len,
                                     scale, st);
}

template <typename T, typename KV, bool QUANT>
int launch_d(int d, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, void* o, const int* pos,
             int host_pos, int layer, int batch, int heads, int hkv, int tq,
             int s_len, float scale, cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_rows<16, T, KV, QUANT>(q, k, v, ks, vs, o, pos,
                                           host_pos, layer, batch, heads,
                                           hkv, tq, s_len, scale, st);
    case 32:
      return launch_rows<32, T, KV, QUANT>(q, k, v, ks, vs, o, pos,
                                           host_pos, layer, batch, heads,
                                           hkv, tq, s_len, scale, st);
    case 64:
      return launch_rows<64, T, KV, QUANT>(q, k, v, ks, vs, o, pos,
                                           host_pos, layer, batch, heads,
                                           hkv, tq, s_len, scale, st);
    case 128:
      return launch_rows<128, T, KV, QUANT>(q, k, v, ks, vs, o, pos,
                                            host_pos, layer, batch, heads,
                                            hkv, tq, s_len, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace decsm90

extern "C" {

// One block's shared memory (bytes) under the plan of a call, or -1 where
// no plan takes it. per_slot: pos is a device vector (host_pos unused);
// kv_bytes: the cache's element size (4, 2 or 1); quant: int8 with scales.
long long decode_sm90_smem(int batch, int heads, int hkv, int tq, int s_len,
                           int head_dim, int host_pos, int per_slot,
                           int kv_bytes, int quant) {
  if (!decsm90::valid_call(batch, heads, hkv, tq, s_len, head_dim))
    return -1;
  return decsm90::make_plan(batch, heads, hkv, tq, s_len, head_dim,
                            host_pos, per_slot, kv_bytes, quant)
      .smem;
}

// q, o [B, H, Tq, D] (dtype 0 = float32, 1 = bfloat16); k, v [L, B, Hkv,
// S, D] in q's dtype, or int8 with float32 scales ks, vs [L, B, Hkv, S]
// (quant = 1; ks, vs unused otherwise); pos [B] int32 on the device, or
// null with every slot at host_pos; all contiguous, k and v 16-byte
// aligned. head_dim in {16, 32, 64, 128}, 1 <= Tq <= 16. One launch;
// returns cudaGetLastError() after it, cudaErrorInvalidValue for a call no
// plan takes, cudaErrorInvalidConfiguration where no cluster of the plan
// fits the card.
int decode_sm90(const void* q, const void* k, const void* ks, const void* v,
                const void* vs, void* o, const int* pos, int host_pos,
                int layer, int batch, int heads, int hkv, int tq, int s_len,
                int head_dim, float scale, int dtype, int quant,
                void* stream) {
  using namespace decsm90;
  if (!valid_call(batch, heads, hkv, tq, s_len, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (dtype == 0 && !quant)
    return launch_d<float, float, false>(head_dim, q, k, v, ksf, vsf, o, pos,
                                         host_pos, layer, batch, heads, hkv,
                                         tq, s_len, scale, st);
  if (dtype == 1 && !quant)
    return launch_d<__nv_bfloat16, __nv_bfloat16, false>(
        head_dim, q, k, v, ksf, vsf, o, pos, host_pos, layer, batch, heads,
        hkv, tq, s_len, scale, st);
  if (dtype == 0 && quant)
    return launch_d<float, int8_t, true>(head_dim, q, k, v, ksf, vsf, o, pos,
                                         host_pos, layer, batch, heads, hkv,
                                         tq, s_len, scale, st);
  if (dtype == 1 && quant)
    return launch_d<__nv_bfloat16, int8_t, true>(
        head_dim, q, k, v, ksf, vsf, o, pos, host_pos, layer, batch, heads,
        hkv, tq, s_len, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
