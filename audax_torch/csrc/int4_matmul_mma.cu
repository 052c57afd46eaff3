// K9 redesigned for Hopper (sm_90a): the int4 weight-only decode matmul in
// one launch, its products on the tensor cores (mma.sync).
//
// Replaces the TPU kernel audax/ops/int4_matmul.py:_int4_kernel (called by
// int4_matmul). For x [M, K] (float32 or bfloat16, M <= 256), packed uint8
// [K/2, N] and float32 scales [G, N] (one layer's slice: the wrapper passes
// the pointer of the selected layer, never a copy) it writes
//
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * (nib[k, n] - 8)
//
// in x's dtype, summed in float32. Byte (c, n) holds K-row c in its low
// nibble and K-row c + K/2 in its high nibble, each stored as q + 8; group
// g < G/2 covers packed rows [g*group, (g+1)*group) through the low
// nibbles, group g + G/2 the same rows through the high nibbles.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores): the packed bytes and scales. Decode runs it at M = 8: a 1280 x
// 1280 projection moves 0.87 MB (0.26 us), the tied 1280 x 51,866 logits
// 35.3 MB (10.5 us); the products, three bf16 ones per weight for float32 x
// (below), take at least 0.08 and 3.2 us (a third of that for bf16 x).
// K9's first body (int4_common.cuh's split_half_kernel) ran at 50-65x this
// bound at 1280^2 and 5-7x at the logits, for four reasons; what this body
// does about each:
//
// 1. Products on the CUDA cores (float32 FMAs: 15.9 us at the logits, above
//    the bytes). Here mma.sync.m16n8k16 bf16 takes the weights as A (16
//    output columns x 16 packed rows, each nib - 8, exact in bf16) and the 8
//    rows of x as B, the n = 8 side, so M = 8 wastes no lane. bf16 x is B as
//    it is. float32 x is split into three bf16 parts, x = hi + mid + lo
//    (each the round-to-nearest of what the parts before it leave, so the
//    three keep x's 24 bits), and the weights meet each part in its own
//    product and its own sums: an integer weight times a bf16 part is exact
//    in the float32 accumulator. (Three bf16 products rather than
//    2xTF32: a TF32 weight takes a 32-bit register, a bf16 pair one, so the
//    unpack costs half the instructions per weight, and three k16 products
//    take less tensor time than four k8 ones.) Each group's products are
//    summed from zero, its parts added smallest first, then scaled and added
//    in float32, since the tensor core's accumulation truncates.
// 2. Too few bytes in flight (64-thread blocks, 4-byte loads, ~100 KB on the
//    card at 1280^2). Here each warp copies its 16 nt columns (nt A tiles)
//    of every packed row of its block's range with 16-byte cp.async at the
//    start, one commit group per 32 rows, and starts on the first 32 rows
//    while the rest are in flight: the whole weight matrix is requested at
//    once at the projections (0.8 - 3.3 MB) and ~100 KB per SM at the
//    logits. x's rows for the range are loaded before the copies are issued
//    and split while they fly. A block of 4 warps owns 64 nt columns; pick_nt
//    takes the widest nt (4, 2, 1) whose grid still gives every SM a block
//    (a block's row run is 64 nt bytes), and the split plan (split_range)
//    gives 200 blocks of 64 rows at 1280^2.
// 3. Split-K partials through HBM in a second launch. Here the K splits of a
//    column tile are one thread block cluster (up to MAX_SPLITS = 16 blocks,
//    the grid's y axis). Block r owns a share of the tile's fragments; every
//    block writes each of its fragments (a float4) into its slot in the
//    owner's shared memory, and after one cluster barrier each owner sums
//    its slots in block order and writes y. One launch, no workspace, no
//    atomics: the same bits on every run.
// 4. Rows 2-byte aligned at the logits (N = 51,866). A row's 16 nt columns
//    are copied as the nt + 1 aligned 16-byte chunks that cover them, and
//    each lane reads its bytes at the row's offset in the chunks (2-byte
//    reads for an even N, bytes for an odd one) instead of ldmatrix. Rows
//    that are 16-byte aligned (N % 16 == 0, as 1280 and 5120) are read by
//    ldmatrix .trans from chunks swizzled so that 8 rows hit 32 banks.
//
// The fragments (g = lane / 4, t = lane % 4). ldmatrix.x4.trans over a warp's
// 32 rows of one A tile's 16 bytes gives lane (g, t) of each 8-row matrix the
// bytes (2t, 2g), (2t, 2g+1), (2t+1, 2g), (2t+1, 2g+1) (packed row, column).
// So A row g is output column 2g and A row g + 8 column 2g + 1; A's k is
// the packed row, in order. Masking a register to its low (high) nibbles
// and one byte permute under 0x43 give two bf16 values 128 + nib, one
// bf16x2 subtraction of 136 leaves nib - 8. B = x[m0 + g][c + 2t, 2t + 1]
// and [.. + 8, + 9], bf16 pairs staged once per block in shared memory
// (split in float32). C: c0, c1 = column 2g at x rows 2t, 2t + 1; c2, c3 =
// column 2g + 1. tests/torch_port/test_torch_int4_sm90.py transcribes the
// schedule lane by lane into numpy.
//
// Calls this body does not take -- a group that is not a multiple of 16
// packed rows, or K/2 > MAX_SPLITS * MAX_RANGE -- return
// cudaErrorInvalidValue; ops/int4_matmul.py:BODIES sends them to the
// split-half body before any launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace int4mma {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 8;                      // rows of x per block (B's n)
constexpr int KSTEP = 16;                  // packed rows per product (k16)
constexpr int STAGE = 32;                  // packed rows per ldmatrix.x4
constexpr int MAX_SPLITS = 16;             // blocks of a cluster (H100)
constexpr int MAX_RANGE = 512;             // packed rows x 16 columns a warp
                                           // stages
constexpr int SMS = 132;                   // an H100 SXM's SMs
constexpr int TARGET_BLOCKS = 264;         // two blocks per SM
constexpr int XB = 4;                      // x entries a thread loads at once
constexpr int SMEM_LIMIT = 232448;         // an H100 block's shared memory

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int mini(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// Whether this body takes packed rows kh at ``group`` (K = 2 kh).
__host__ __device__ constexpr int takes(int kh, int group) {
  return group > 0 && group % KSTEP == 0 && kh % group == 0 &&
         kh <= MAX_SPLITS * MAX_RANGE;
}
// A warp owns nt A tiles (16 nt output columns), a block 64 nt; a block
// stages at most MAX_RANGE / nt packed rows.
__host__ __device__ constexpr int max_range(int nt) { return MAX_RANGE / nt; }
// Blocks of one split: column tiles times 8-row tiles of x.
__host__ __device__ constexpr int block_tiles(int m, int n, int nt) {
  return cdiv(n, 64 * nt) * cdiv(m, MT);
}
// Splits wanted: enough blocks to fill the card, at least kh / max_range,
// at most a cluster and one STAGE of rows each.
__host__ __device__ constexpr int want_splits(int tiles, int kh, int nt) {
  return clampi(cdiv(TARGET_BLOCKS, tiles), cdiv(kh, max_range(nt)),
                mini(MAX_SPLITS, cdiv(kh, STAGE)));
}
// Packed rows per split (a multiple of STAGE) and the splits that gives.
__host__ __device__ constexpr int split_range(int tiles, int kh, int nt) {
  return cdiv(cdiv(kh, want_splits(tiles, kh, nt)), STAGE) * STAGE;
}
__host__ __device__ constexpr int split_count(int tiles, int kh, int nt) {
  return cdiv(kh, split_range(tiles, kh, nt));
}
__host__ __device__ constexpr int grid_blocks(int m, int n, int kh, int nt) {
  return block_tiles(m, n, nt) * split_count(block_tiles(m, n, nt), kh, nt);
}
// The widest warp tile whose grid (tiles x splits) still gives every SM a
// block and whose K/2 fits a cluster: a block's row run is its 64 nt
// columns, so wider tiles read longer runs and split x's staging over more
// columns; on the card 4 wins at 1280 -> 5120 and the tied logits, 2 at
// 5120 -> 1280, 1 at 1280 -> 1280 (too few blocks at 2).
__host__ __device__ constexpr int pick_nt(int m, int n, int kh) {
  return grid_blocks(m, n, kh, 4) >= SMS && kh <= MAX_SPLITS * max_range(4)
             ? 4
             : grid_blocks(m, n, kh, 2) >= SMS &&
                       kh <= MAX_SPLITS * max_range(2)
                   ? 2
                   : 1;
}

// Shared memory of a block: x's bf16 parts ([half][k16 step][part][lane]
// uint2), each warp's weight rows (its nt 16-byte chunks of a row, or the
// nt + 1 aligned chunks that cover an unaligned row), each warp's scales
// ([group][half][16 nt]; a range meets at most cdiv(range, group) + 1
// groups) and the slots of the cluster's partial sums (the block's share
// of the [8][64 nt] tile from each block, see reduce below).
__host__ __device__ constexpr int x_bytes(int parts, int range) {
  return 32 * parts * range;
}
__host__ __device__ constexpr int row_bytes(int vec, int nt) {
  return vec == 16 ? 16 * nt : 16 * (nt + 1);
}
__host__ __device__ constexpr int w_bytes(int vec, int nt, int range) {
  return WARPS * range * row_bytes(vec, nt);
}
__host__ __device__ constexpr int scale_floats(int range, int group, int nt) {
  return (cdiv(range, group) + 1) * 2 * 16 * nt;
}
__host__ __device__ constexpr int red_floats(int nt) {
  return 4 * (WARPS * nt * 32 + MAX_SPLITS);
}
__host__ __device__ constexpr int smem_bytes(int parts, int vec, int nt,
                                            int range, int group) {
  return x_bytes(parts, range) + w_bytes(vec, nt, range) +
         4 * WARPS * scale_floats(range, group, nt) + 4 * red_floats(nt);
}
// The 16-byte chunk of row r where chunk c of an aligned row is stored: rows
// 128 / (16 nt) apart share banks, so their chunks are XORed apart and an
// ldmatrix of 8 rows touches 32 banks.
__host__ __device__ constexpr int swizzle(int r, int c, int nt) {
  return c ^ (r / (8 / nt)) % nt;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes (or src_size < 16 of them, the rest zero-filled) from global to
// shared memory; 4 bytes for the scales
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_size)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_size) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_size)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most ``pending`` of this thread's groups are in flight (an
// immediate operand: more than 7 waits for 7, which is stricter)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// The A fragments of one k16 product from the two ldmatrix registers that
// hold its packed rows 0-7 (r0) and 8-15 (r1): lo = the low nibbles
// (K-rows c), hi = the high nibbles (K-rows c + K/2), each as nib - 8 in
// bf16: a0a1 (A row g = column 2g; k 2t, 2t+1), a2a3 (row g + 8 = column
// 2g + 1), a4a5 and a6a7 the same at k + 8
__device__ __forceinline__ uint32_t sub136(uint32_t v) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  a = __hsub2(a, off);
  return *reinterpret_cast<uint32_t*>(&a);
}
__device__ __forceinline__ void unpack(uint32_t r0, uint32_t r1,
                                       uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const uint32_t l0 = r0 & 0x0F0F0F0Fu, h0 = (r0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t l1 = r1 & 0x0F0F0F0Fu, h1 = (r1 >> 4) & 0x0F0F0F0Fu;
  // bytes 0, 2 (column 2g) or 1, 3 (column 2g + 1), each under 0x43
  lo[0] = sub136(__byte_perm(l0, 0x43434343u, 0x4240));
  lo[1] = sub136(__byte_perm(l0, 0x43434343u, 0x4341));
  lo[2] = sub136(__byte_perm(l1, 0x43434343u, 0x4240));
  lo[3] = sub136(__byte_perm(l1, 0x43434343u, 0x4341));
  hi[0] = sub136(__byte_perm(h0, 0x43434343u, 0x4240));
  hi[1] = sub136(__byte_perm(h0, 0x43434343u, 0x4341));
  hi[2] = sub136(__byte_perm(h1, 0x43434343u, 0x4240));
  hi[3] = sub136(__byte_perm(h1, 0x43434343u, 0x4341));
}

// c += a * b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The ldmatrix-layout registers of a warp's 32 packed rows at ``rows``
// (this warp's copy in shared memory, ROWB bytes a row): r[i][j] holds
// tile i's rows 8j + 2t and 8j + 2t + 1 at its columns 2g, 2g + 1. VEC 16:
// ldmatrix .trans over the swizzled 16-byte chunks. VEC 2 / 1: each row is
// the nt + 1 aligned chunks that cover its 16 nt columns, which start at
// byte (the row's global address) % 16 of the first, read in 2-byte (even
// N) or 1-byte pieces.
template <int VEC, int NT>
__device__ __forceinline__ void load_a(uint32_t (&r)[NT][4],
                                       const uint8_t* rows, uintptr_t gaddr0,
                                       long long n, int lane) {
  constexpr int ROWB = row_bytes(VEC, NT);
  if constexpr (VEC == 16) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0, %1, %2, %3}, [%4];\n"
          : "=r"(r[i][0]), "=r"(r[i][1]), "=r"(r[i][2]), "=r"(r[i][3])
          : "r"(smem_u32(rows + ROWB * lane + 16 * swizzle(lane, i, NT)))
          : "memory");
  } else {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = 8 * j + 2 * t;
      const uint8_t* pa =
          rows + ROWB * ra + (int)((gaddr0 + ra * n) & 15) + 2 * g;
      const uint8_t* pb = rows + ROWB * (ra + 1) +
                          (int)((gaddr0 + (ra + 1) * n) & 15) + 2 * g;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if constexpr (VEC == 2) {
          const uint32_t a = *reinterpret_cast<const uint16_t*>(pa + 16 * i);
          const uint32_t b = *reinterpret_cast<const uint16_t*>(pb + 16 * i);
          r[i][j] = a | (b << 16);
        } else {
          r[i][j] = (uint32_t)pa[16 * i] | ((uint32_t)pa[16 * i + 1] << 8) |
                    ((uint32_t)pb[16 * i] << 16) |
                    ((uint32_t)pb[16 * i + 1] << 24);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// two neighbouring values of x (an even offset: 8 or 4 bytes aligned)
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(p));
  a = bf16_lo(v);
  b = bf16_hi(v);
}

// x's parts: 1 for bf16 x, 3 (hi, mid, lo) for float32 x
template <typename T>
struct Parts {
  static constexpr int N = sizeof(T) == 4 ? 3 : 1;
};

// grid (column tiles, splits, 8-row tiles of x), cluster (1, splits, 1)
template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(THREADS)
int4mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, T* __restrict__ y, int m, int kh,
               int n, int group, int range) {
  constexpr int PARTS = Parts<T>::N;
  constexpr int ROWB = row_bytes(VEC, NT);
  constexpr int NCH = ROWB / 16;           // chunks a warp copies per row
  constexpr int WCOLS = 16 * NT, BCOLS = WARPS * WCOLS;
  extern __shared__ __align__(16) uint8_t smem[];
  // every block of the cluster has started once the wait before the
  // partial sums' exchange returns
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.y;
  const int c0 = split * range, c1 = min(kh, c0 + range);
  const int rows = c1 - c0;                // > 0, a multiple of KSTEP
  const int steps = rows / KSTEP, ksteps = range / KSTEP;
  const int nb = blockIdx.x * BCOLS;       // the block's first column
  const int nw = nb + warp * WCOLS;        // this warp's first column
  const int m0 = blockIdx.z * MT;
  const int num_g = 2 * kh / group;
  const int g_first = c0 / group;
  const int sfl = scale_floats(range, group, NT);
  const long long ln = n;

  uint2* xs = reinterpret_cast<uint2*>(smem);
  uint8_t* ws = smem + x_bytes(PARTS, range) + warp * range * ROWB;
  float* ss = reinterpret_cast<float*>(smem + x_bytes(PARTS, range) +
                                       w_bytes(VEC, NT, range)) + warp * sfl;
  float* red = reinterpret_cast<float*>(smem + x_bytes(PARTS, range) +
                                        w_bytes(VEC, NT, range)) +
               WARPS * sfl;

  // 0. x's rows m0 .. m0 + 7 over the range's two halves (rows past M are
  // 0): a thread's first XB entries of [half][k16 step][lane] into
  // registers, so their latency overlaps the weights' copies
  const int entries = 2 * steps * 32;
  float v[XB][4];
  auto load_x = [&](int e0) {
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int e = e0 + b * THREADS, el = e % 32;
      const int j = (e / 32) % steps, h = e / (32 * steps);
      const int mm = m0 + el / 4;
      v[b][0] = v[b][1] = v[b][2] = v[b][3] = 0.f;
      if (e < entries && mm < m) {
        const T* xr = x + (long long)mm * 2 * kh + h * kh + c0 + j * KSTEP +
                      2 * (el % 4);
        load_pair(xr, v[b][0], v[b][1]);
        load_pair(xr + 8, v[b][2], v[b][3]);
      }
    }
  };
  load_x(threadIdx.x);

  // 1. this warp's 16 nt columns of rows [c0, c1): one commit group per
  // STAGE rows, neighbouring lanes on a row's neighbouring chunks; the
  // scales of the range's groups with the first
  const uint8_t* w_end = w + (long long)kh * ln;
  const uint8_t* w_lo = reinterpret_cast<const uint8_t*>(   // holds w[0]
      reinterpret_cast<uintptr_t>(w) & ~static_cast<uintptr_t>(15));
  const uintptr_t gaddr0 = reinterpret_cast<uintptr_t>(w + c0 * ln + nw);
  const int nst = cdiv(rows, STAGE);
  for (int st = 0; st < nst; ++st) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int e = lane + 32 * k, rr = st * STAGE + e / NCH, ch = e % NCH;
      if constexpr (VEC == 16) {
        const bool ok = rr < rows && nw + 16 * ch < n;
        cp_async16(ws + rr * ROWB + 16 * swizzle(rr, ch, NT),
                   ok ? w + (c0 + rr) * ln + nw + 16 * ch : w, ok ? 16 : 0);
      } else {
        const uint8_t* src =
            reinterpret_cast<const uint8_t*>((gaddr0 + rr * ln) &
                                             ~static_cast<uintptr_t>(15)) +
            16 * ch;
        const bool ok = rr < rows && src < w_end;
        cp_async16(ws + rr * ROWB + 16 * ch, ok ? src : w_lo, ok ? 16 : 0);
      }
    }
    if (st == 0) {
      const int ng = (c1 - 1) / group - g_first + 1;
      for (int e = lane; e < ng * 2 * WCOLS; e += 32) {
        const int gi = e / (2 * WCOLS), h = (e / WCOLS) % 2, j = e % WCOLS;
        const bool ok = nw + j < n;
        const float* src =
            s + (long long)(g_first + gi + h * (num_g / 2)) * ln + nw + j;
        cp_async4(ss + e, ok ? src : s, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  }

  // 2. split x into bf16 parts and store them as B fragments; a thread's
  // next XB entries are loaded before it splits any
  for (int e0 = threadIdx.x; e0 < entries; e0 += XB * THREADS) {
    if (e0 != threadIdx.x) load_x(e0);
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int e = e0 + b * THREADS, el = e % 32;
      if (e >= entries) break;
      const int j = (e / 32) % steps, h = e / (32 * steps);
      uint2* dst = xs + ((h * ksteps + j) * PARTS) * 32 + el;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        const uint32_t b01 = pack_bf16(v[b][0], v[b][1]);
        const uint32_t b23 = pack_bf16(v[b][2], v[b][3]);
        dst[p * 32] = make_uint2(b01, b23);
        v[b][0] -= bf16_lo(b01); v[b][1] -= bf16_hi(b01);
        v[b][2] -= bf16_lo(b23); v[b][3] -= bf16_hi(b23);
      }
    }
  }
  __syncthreads();

  // 3. the products, 32 rows at a time as they land; each tile and each
  // part of x in its own sums (independent chains), each group's sums from
  // zero, the parts added smallest first, scaled and added in float32 at the
  // group's end (or the range's)
  float tot[NT][4], plo[NT][PARTS][4], phi[NT][PARTS][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tot[i][q] = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) plo[i][p][q] = phi[i][p][q] = 0.f;
    }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait(nst - 1 - st);
    __syncwarp();
    uint32_t r[NT][4];
    load_a<VEC, NT>(r, ws + st * STAGE * ROWB, gaddr0 + st * STAGE * ln, ln,
                    lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * st + half;         // k16 step in the range
      if (j >= steps) break;
      const uint2* blo = xs + (j * PARTS) * 32 + lane;
      const uint2* bhi = xs + ((ksteps + j) * PARTS) * 32 + lane;
      uint2 bl[PARTS], bh[PARTS];
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        bl[p] = blo[p * 32];
        bh[p] = bhi[p * 32];
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t alo[4], ahi[4];
        unpack(r[i][2 * half], r[i][2 * half + 1], alo, ahi);
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          mma(plo[i][p], alo, bl[p]);
          mma(phi[i][p], ahi, bh[p]);
        }
      }
      const int c = c0 + (j + 1) * KSTEP;
      if (c % group == 0 || c >= c1) {
        const float* sg = ss + ((c - 1) / group - g_first) * 2 * WCOLS;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float sl[2] = {sg[16 * i + 2 * g], sg[16 * i + 2 * g + 1]};
          const float sh[2] = {sg[WCOLS + 16 * i + 2 * g],
                               sg[WCOLS + 16 * i + 2 * g + 1]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float lo = plo[i][PARTS - 1][q], hi = phi[i][PARTS - 1][q];
#pragma unroll
            for (int p = PARTS - 2; p >= 0; --p) {
              lo += plo[i][p][q];
              hi += phi[i][p][q];
            }
            tot[i][q] += lo * sl[q / 2] + hi * sh[q / 2];
#pragma unroll
            for (int p = 0; p < PARTS; ++p) plo[i][p][q] = phi[i][p][q] = 0.f;
          }
        }
      }
    }
  }

  // 4. the sum over the cluster's blocks in block order. A block's partial
  // is WARPS * NT * 32 fragments of 4 floats (tile i of warp w, lane l:
  // fragment (w NT + i) 32 + l); block r owns fragments [r F, (r + 1) F)
  // (F = the fragments over the splits, rounded up). Each block writes each
  // fragment, one float4, into slot [its rank] of its owner's shared memory;
  // after the barrier each owner sums its slots 0, 1, ... and writes y.
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int share = cdiv(WARPS * NT * 32, splits);
  float4* red4 = reinterpret_cast<float4*>(red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int f = (warp * NT + i) * 32 + lane;
    float4* slot = cluster.map_shared_rank(red4, f / share);
    slot[rank * share + f % share] =
        make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]);
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  for (int j = threadIdx.x; j < share; j += THREADS) {
    const int f = rank * share + j;
    if (f >= WARPS * NT * 32) break;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 v = red4[q * share + j];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    // fragment f: rows 2t, 2t + 1 of columns 2g, 2g + 1 of its tile
    const int fl = f % 32, fw = f / (32 * NT), fi = (f / 32) % NT;
    const int mm = m0 + 2 * (fl % 4);
    const int nn = nb + fw * WCOLS + 16 * fi + 2 * (fl / 4);
    const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (mm + q % 2 < m && nn + q / 2 < n)
        y[(long long)(mm + q % 2) * ln + nn + q / 2] = from_f32<T>(vals[q]);
  }
}

namespace {  // internal linkage: each library keeps its own ``sized``

template <typename T, int VEC, int NT>
int launch(const void* x, const uint8_t* w, const float* s, void* y, int m,
           int kh, int n, int group, cudaStream_t stream) {
  auto kernel = int4mma_kernel<T, VEC, NT>;
  static bool sized = false;               // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int tiles = block_tiles(m, n, NT);
  const int range = split_range(tiles, kh, NT);
  const int splits = split_count(tiles, kh, NT);
  const int smem = smem_bytes(Parts<T>::N, VEC, NT, range, group);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(n, 64 * NT), splits, cdiv(m, MT));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), w, s, static_cast<T*>(y), m, kh,
      n, group, range);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_nt(const void* x, const uint8_t* w, const float* s, void* y,
              int m, int kh, int n, int group, cudaStream_t stream) {
  const int nt = pick_nt(m, n, kh);
  if (nt == 4) return launch<T, VEC, 4>(x, w, s, y, m, kh, n, group, stream);
  if (nt == 2) return launch<T, VEC, 2>(x, w, s, y, m, kh, n, group, stream);
  return launch<T, VEC, 1>(x, w, s, y, m, kh, n, group, stream);
}

template <typename T>
int launch_vec(const void* x, const uint8_t* w, const float* s, void* y,
               int m, int kh, int n, int group, cudaStream_t stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(w);
  if (n % 16 == 0 && base % 16 == 0)
    return launch_nt<T, 16>(x, w, s, y, m, kh, n, group, stream);
  if (n % 2 == 0 && base % 2 == 0)
    return launch_nt<T, 2>(x, w, s, y, m, kh, n, group, stream);
  return launch_nt<T, 1>(x, w, s, y, m, kh, n, group, stream);
}

}  // namespace

}  // namespace int4mma

extern "C" {

// x [m, k] (dtype 0 = float32, 1 = bfloat16, 1 <= m <= 256), packed [k/2, n]
// uint8, scales [k/group, n] float32, y [m, n] in x's dtype; all
// contiguous on the device, x aligned to two of its elements. One launch;
// returns cudaGetLastError() after it, or cudaErrorInvalidValue for a call
// this body does not take (int4mma::takes).
int int4_matmul_mma(const void* x, const void* packed, const void* scales,
                    void* y, int m, int k, int n, int group, int dtype,
                    void* stream) {
  const int kh = k / 2;
  if (m < 1 || m > 256 || k < 2 || k % 2 || n < 1 ||
      !int4mma::takes(kh, group))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  if (dtype == 0)
    return int4mma::launch_vec<float>(x, w, s, y, m, kh, n, group, st);
  if (dtype == 1)
    return int4mma::launch_vec<__nv_bfloat16>(x, w, s, y, m, kh, n, group,
                                              st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
