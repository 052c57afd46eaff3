// K9 redesigned for Hopper (sm_90a): the int4 weight-only decode matmul in
// one launch, its products on the tensor cores (mma.sync). On the same
// skeleton, the int4 tool kernels redesigned: P5 v1, P5 v2, P4 (see
// "Routes" below) and the word kernel of P2 and P3 (see "The word route").
//
// Replaces the TPU kernel audax/ops/int4_matmul.py:_int4_kernel (called by
// int4_matmul). For x [M, K] (float32 or bfloat16, M <= 256), packed uint8
// [K/2, N] and float32 scales [G, N] (one slice of a stack: the wrapper
// passes the pointer of a host-known slice, never a copy, or the stack and
// a device pointer to the slice's index, which the kernel reads at entry,
// as the TPU kernel's scalar prefetch -- int4_select.cuh) it writes
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
//
// Routes. The copy plan, the swizzle, the split plan and the cluster
// reduction serve three bodies, a template argument (ROUTE) apart; the way
// from a nibble to a product differs (steps 0, 2 and 3 and the group's end
// below). Each is its own library (ops/native.py's DEFINES):
//
// ROUTE_K9: K9, as above (library int4_matmul_mma).
//
// ROUTE_V1 (library int4_unpack_v1_mma, -DAUDAX_INT4_V1) replaces the TPU
// kernel tools/int4_unpack_probe.py:_kernel_v1 (called by run_variant):
// K9's function, layout and per-group sums, its nibbles unpacked by mask
// and shift with no widen. Here that is K9 with one difference, how a
// nibble pair becomes a bf16 pair: no byte permute, one mask and magic
// (a lop3) per pair, (r >> s) & 0x000F000F | 0x43004300. Bytes 0 and 2 of
// an ldmatrix register are column 2g at packed rows 2t and 2t + 1, bytes 1
// and 3 column 2g + 1, so s = 0, 8 give the low nibbles of columns 2g and
// 2g + 1 and s = 4, 12 the high nibbles; K9's bf16x2 subtraction of 136
// leaves nib - 8. The A fragments are K9's bit for bit, so is y. Bound as
// K9 (1.0 us of bytes at [8, 1280] x [1280, 5120]).
//
// ROUTE_V2 (library int4_unpack_v2_mma, -DAUDAX_INT4_V2) replaces the TPU
// kernel tools/int4_unpack_probe.py:_kernel_v2 (called by run_variant):
// the weights dequantized in x's dtype, W~[k, n] = (nib - 8) * s[g(k), n]
// rounded there, then one contraction over the whole K with float32 sums,
// no per-group partials. bf16 x: K9's unpack gives nib - 8 as bf16 pairs,
// one mul.rn.bf16x2 by the bf16-rounded scale of the pair's column makes
// W~ (a 4-bit times an 8-bit significand is exact before its one
// rounding, so W~ is the plain version's bit for bit), then m16n8k16 as
// K9, one accumulator chain per half over all of K. float32 x: W~ = q * s
// rounded once in float32 is no bf16 value, so the products run in 3xTF32
// on m16n8k8 (tf32x3.cuh). An 8-row step's ldmatrix register is a TF32 A
// fragment once k is relabelled -- packed rows 2t and 2t + 1 are k slots t
// and t + 4: a0 = byte 0 (column 2g, row 2t), a1 = byte 1 (column 2g +
// 1), a2, a3 = bytes 2, 3 (row 2t + 1) -- and B is staged in that order:
// x's pair (2t, 2t + 1), split once into big and small TF32 parts. A
// nibble becomes a float by a byte permute under the exponent of 2^23 and
// one subtraction of 2^23 + 8; each k16 step's twelve products are summed
// from zero and added in float32. At [8, 1280] x [1280, 5120] the packed
// bytes and scales bound it (1.0 us); the products take at least 0.1 us
// in bf16, 0.6 us in 3xTF32.
//
// ROUTE_W4A8 (library w4a8_matmul_mma, -DAUDAX_INT4_W4A8) replaces the TPU
// kernel tools/w4a8_probe.py:_w4a8_kernel_zp (called by w4a8_matmul), the
// activation quantization included: xs[m] = max(absmax(x[m]), 1e-12) /
// 127, xq = clip(round_half_even(x / xs), +-127) in int8, and
//
//   y[m, n] = xs[m] * sum_g s[g, n] * (int32) sum_{k in g} xq[m, k] * (nib[k, n] - 8)
//
// in x's dtype. Each block takes the row maxima of |x| over its range
// while the weights' copies fly; after one cluster barrier each reads the
// other blocks' through distributed shared memory, so every block holds
// the maxima over all of K, and quantizes its range (IEEE division,
// round half to even, clamp): the int8 values of the wrapper-side
// quantization, with no launch before the kernel. The products run on the
// int8 tensor cores, mma.sync.m16n8k32 s8 x s8 -> s32: two byte permutes
// of a pair of ldmatrix registers give A's word of four k values of one
// column (0x6420: column 2g, 0x7531: column 2g + 1; packed rows 2t, 2t +
// 1, 2t + 8, 2t + 9 at k slots 4t .. 4t + 3), a mask and a per-byte
// subtraction of 8 (__vsub4) make them int8 nib - 8, and x's int8 B
// fragments are staged in the same k order. Each group's sums are exact
// int32 (low and high nibbles apart: two groups), converted once, scaled
// by s_g and added in float32 at the group's end; the owner applies xs
// after the cluster sum. It takes groups of whole k32 steps (takes_w4a8).
// Bound as v2 (1.0 us of bytes; the products 0.05 us).
//
// The word route (library int4_word_matmul_mma, -DAUDAX_INT4_WORD;
// int4word_kernel) replaces two TPU kernels of one function over one
// layout: tools/int4_layout_ab.py:_int4v2_kernel (called by
// int4_matmul_v2; the group divides the plane K/8) and
// tools/int4_plane_probe.py:_plane_kernel (called by plane_matmul; the
// group divides K, so it may straddle two planes). For x [M, K], words
// int32 [K/8, N] (nibble p of word (c, n) holds K-row p K/8 + c as q + 8)
// and float32 scales [K/group, N]:
//
//   y[m, n] = sum_k x[m, k] * (nib[k, n] - 8) * s[k / group, n]
//
// in x's dtype, summed in float32. K9's skeleton and split plan with words
// for rows: a warp's 16 nt columns of a word row are 64 nt contiguous
// bytes, copied by 16-byte cp.async (one commit group per 16 word rows,
// the scales of the range's groups of all eight planes with the first, 16
// bytes at a time where the rows are aligned), swizzled so that the reads
// below hit 32 banks (wswizzle); a row that is not 16-byte
// aligned (N % 4 != 0) as the 4 nt + 1 aligned chunks that cover it, read
// in 4-byte pieces at its offset. One word holds a column's eight planes
// at one word row, so one read feeds eight k16 products, one a plane.
// The k order inside a step is free as long as x's B fragments are staged
// in it: k slot 2t + e (+ 8) is word row t + 4e (+ 8) of the step, so
// lane (g, t) reads with one 8-byte load a row's words of columns 2g and
// 2g + 1 (A rows g, g + 8, as K9) at word rows t, t + 4, t + 8, t + 12.
// Two byte permutes of the words of k slots 2t, 2t + 1 (0x5410, 0x7632)
// give planes 0-3 and 4-7 of the pair in the two halves of a register;
// plane p's bf16 pair is then V1's mask and magic at s = 4 (p % 4), and
// K9's subtraction of 136. B for plane p: x[m0 + g][p K/8 + c + t + 4e
// (+ 8)], float32 x as K9's three bf16 parts. Groups: with group % 16 ==
// 0 and (K/8) % 16 == 0 no k16 step of any plane straddles a group
// (plane p's step at word row c is K-rows p K/8 + c ..+ 16); each step's
// words stay in registers while the planes are walked, each plane's
// products summed from zero over the step, scaled by its own group's
// scales of the columns and added in float32 -- one live partial per part,
// not eight. At [8, 1280] x [1280, 5120] the words and the group-32 scales
// bound it (3.28 + 0.82 MB: 1.2 us); the products take at least 0.1 us in
// bf16 (three times that in float32). Calls it does not take (takes_word)
// return cudaErrorInvalidValue; tools/int4_layout_ab.py:WORD_BODIES sends
// them to the first body (csrc/int4_word_matmul.cu) before any launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_select.cuh"
#include "tf32x3.cuh"

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
constexpr int MAX_M = MT * 65535;          // rows of x: the grid's z axis
// what the body computes from the nibbles (see "Routes" above)
constexpr int ROUTE_K9 = 0;
constexpr int ROUTE_V2 = 1;
constexpr int ROUTE_W4A8 = 2;
constexpr int ROUTE_V1 = 3;
constexpr int ROUTE_WORD = 4;              // int4word_kernel (the word route)
// the word route: nibbles a word, and word rows x 16 columns a warp stages
constexpr int PLANES = 8;
constexpr int MAX_WRANGE = 256;

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
// ROUTE_V2 takes what K9 takes; ROUTE_W4A8 groups of whole k32 steps.
__host__ __device__ constexpr int takes_w4a8(int kh, int group) {
  return group > 0 && group % STAGE == 0 && kh % group == 0 &&
         kh <= MAX_SPLITS * MAX_RANGE;
}
// The split plan, one for every route. A warp owns nt A tiles (16 nt output
// columns), a block 64 nt. kh counts the rows a split runs over: packed
// rows (K/2) on K9's routes, word rows (K/8) on the word route. A block
// stages at most plan_rows(route) / nt of them, and a split's rows are a
// multiple of plan_step(route): one ldmatrix.x4 of packed rows, one k16
// step of word rows.
__host__ __device__ constexpr int plan_rows(int route) {
  return route == ROUTE_WORD ? MAX_WRANGE : MAX_RANGE;
}
__host__ __device__ constexpr int plan_step(int route) {
  return route == ROUTE_WORD ? KSTEP : STAGE;
}
__host__ __device__ constexpr int max_range(int route, int nt) {
  return plan_rows(route) / nt;
}
// Blocks of one split: column tiles times 8-row tiles of x.
__host__ __device__ constexpr int block_tiles(int m, int n, int nt) {
  return cdiv(n, 64 * nt) * cdiv(m, MT);
}
// Splits wanted: enough blocks to fill the card, at least kh / max_range,
// at most a cluster and one step of rows each.
__host__ __device__ constexpr int want_splits(int route, int tiles, int kh,
                                              int nt) {
  return clampi(cdiv(TARGET_BLOCKS, tiles), cdiv(kh, max_range(route, nt)),
                mini(MAX_SPLITS, cdiv(kh, plan_step(route))));
}
// Rows per split (a multiple of the step) and the splits that gives.
__host__ __device__ constexpr int split_range(int route, int tiles, int kh,
                                              int nt) {
  return cdiv(cdiv(kh, want_splits(route, tiles, kh, nt)), plan_step(route)) *
         plan_step(route);
}
__host__ __device__ constexpr int split_count(int route, int tiles, int kh,
                                              int nt) {
  return cdiv(kh, split_range(route, tiles, kh, nt));
}
__host__ __device__ constexpr int grid_blocks(int route, int m, int n, int kh,
                                              int nt) {
  return block_tiles(m, n, nt) *
         split_count(route, block_tiles(m, n, nt), kh, nt);
}
// The widest warp tile whose grid (tiles x splits) still gives every SM a
// block and whose rows fit a cluster: a block's row run is its 64 nt
// columns, so wider tiles read longer runs and split x's staging over more
// columns; on the card 4 wins at 1280 -> 5120 and the tied logits, 2 at
// 5120 -> 1280, 1 at 1280 -> 1280 (too few blocks at 2).
__host__ __device__ constexpr int pick_nt(int route, int m, int n, int kh) {
  return grid_blocks(route, m, n, kh, 4) >= SMS &&
                 kh <= MAX_SPLITS * max_range(route, 4)
             ? 4
             : grid_blocks(route, m, n, kh, 2) >= SMS &&
                       kh <= MAX_SPLITS * max_range(route, 2)
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
// x's staged B fragments a route keeps, in uint2 per lane, k16 step and
// half (``parts`` above): K9 one per bf16 part (1 or 3); v2 in float32 the
// big and small TF32 parts of two pairs (4); W4A8 one int8 uint2 per k32
// step (counted as 1)
__host__ __device__ constexpr int route_parts(int route, int f32) {
  return route == ROUTE_W4A8 ? 1 : route == ROUTE_V2 ? 1 + 3 * f32
                                                     : 1 + 2 * f32;
}
// W4A8's row maxima (each warp's [MT], the block's [MT], read by the
// cluster) and row scales [MT], after the cluster's partial sums
__host__ __device__ constexpr int quant_floats(int route) {
  return route == ROUTE_W4A8 ? (WARPS + 2) * MT : 0;
}
__host__ __device__ constexpr int route_smem_bytes(int route, int f32, int vec,
                                                  int nt, int range,
                                                  int group) {
  return smem_bytes(route_parts(route, f32), vec, nt, range, group) +
         4 * quant_floats(route);
}
// The word route (int4word_kernel) runs the split plan above over word
// rows kw = K/8; a warp stages at most MAX_WRANGE / nt of them (16 KB). It
// takes groups of whole k16 steps in every plane.
__host__ __device__ constexpr int takes_word(int kw, int group) {
  return group > 0 && group % KSTEP == 0 && kw % KSTEP == 0 &&
         PLANES * kw % group == 0 && kw <= MAX_SPLITS * MAX_WRANGE;
}
// Its shared memory: x's B fragments ([plane][k16 step][part][lane]
// uint2), each warp's word rows (its 4 nt chunks of a row, or the 4 nt + 1
// aligned chunks that cover an unaligned one), each warp's scales
// ([plane][group][16 nt]: a plane's rows of a range meet at most
// cdiv(range, group) + 1 groups) and K9's slots of the cluster's sums.
__host__ __device__ constexpr int wx_bytes(int parts, int range) {
  return PLANES * 16 * parts * range;
}
__host__ __device__ constexpr int wrow_bytes(int vec, int nt) {
  return vec == 16 ? 64 * nt : 64 * nt + 16;
}
__host__ __device__ constexpr int ww_bytes(int vec, int nt, int range) {
  return WARPS * range * wrow_bytes(vec, nt);
}
__host__ __device__ constexpr int wgroups(int range, int group) {
  return cdiv(range, group) + 1;
}
__host__ __device__ constexpr int wscale_floats(int range, int group,
                                               int nt) {
  return PLANES * wgroups(range, group) * 16 * nt;
}
__host__ __device__ constexpr int word_smem_bytes(int f32, int vec, int nt,
                                                 int range, int group) {
  return wx_bytes(1 + 2 * f32, range) + ww_bytes(vec, nt, range) +
         4 * WARPS * wscale_floats(range, group, nt) + 4 * red_floats(nt);
}
// The 16-byte chunk of word row r where chunk c of an aligned row is
// stored. Lanes (g, t) of a half warp read 8 bytes of chunk 4i + g / 2 at
// rows t (+ 4 e): the four rows' two chunks are XORed onto eight distinct
// 16-byte bank groups (at nt 1 two rows share a 128-byte bank line).
__host__ __device__ constexpr int wswizzle(int r, int c, int nt) {
  return nt == 1 ? c ^ 2 * (r / 2 % 2) : c ^ 2 * (r % 4);
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

// V1 and the word route: the bf16 pair nib - 8 of the nibbles at bits s
// and 16 + s of r, by mask and magic (one lop3) and K9's subtraction
__device__ __forceinline__ uint32_t nib_pair(uint32_t r, int s) {
  return sub136(((r >> s) & 0x000F000Fu) | 0x43004300u);
}
// ROUTE_V1's unpack: K9's A fragments with no byte permute (bytes 0, 2 of
// a register: column 2g; bytes 1, 3: column 2g + 1)
__device__ __forceinline__ void unpack_v1(uint32_t r0, uint32_t r1,
                                          uint32_t (&lo)[4],
                                          uint32_t (&hi)[4]) {
  lo[0] = nib_pair(r0, 0);
  lo[1] = nib_pair(r0, 8);
  lo[2] = nib_pair(r1, 0);
  lo[3] = nib_pair(r1, 8);
  hi[0] = nib_pair(r0, 4);
  hi[1] = nib_pair(r0, 12);
  hi[2] = nib_pair(r1, 4);
  hi[3] = nib_pair(r1, 12);
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

// c += a * b, one m16n8k32 int8 product with int32 accumulation (exact)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// v2 in bf16: two bf16 products, each rounded once to nearest even
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// v2 in float32: nibble k (0-3) of a register masked to 0x0F0F0F0F as the
// float nib - 8: written under the exponent of 2^23, less 2^23 + 8 (exact)
__device__ __forceinline__ float nib_f32(uint32_t nibs, int k) {
  return __uint_as_float(__byte_perm(nibs, 0x4B000000u, 0x7540 | k)) -
         8388616.f;
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

// The sum of a tile's partials over the cluster's blocks in block order,
// written to y (times the row scale rs[8] where SCALED). A block's partial
// is WARPS * NT * 32 fragments of 4 floats (tile i of warp w, lane l:
// fragment (w NT + i) 32 + l); block r owns fragments [r F, (r + 1) F) (F
// = the fragments over the splits, rounded up). Each block writes each
// fragment, one float4, into slot [its rank] of its owner's shared memory
// (red); after the barrier each owner sums its slots 0, 1, ... and writes
// y. Every block of the cluster must have started (a wait on the
// cluster's barrier) before it is called.
template <bool SCALED, int NT, typename T>
__device__ __forceinline__ void cluster_sum(const float (&tot)[NT][4],
                                            float* red, const float* rs,
                                            T* __restrict__ y, int m, int n,
                                            int m0, int nb,
                                            cg::cluster_group& cluster) {
  constexpr int WCOLS = 16 * NT;
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int share = cdiv(WARPS * NT * 32, splits);
  float4* red4 = reinterpret_cast<float4*>(red);
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
    for (int q = 0; q < 4; ++q) {
      float val = vals[q];
      if constexpr (SCALED) val *= rs[2 * (fl % 4) + q % 2];
      if (mm + q % 2 < m && nn + q / 2 < n)
        y[(long long)(mm + q % 2) * n + nn + q / 2] = from_f32<T>(val);
    }
  }
}

// grid (column tiles, splits, 8-row tiles of x), cluster (1, splits, 1)
template <int ROUTE, typename T, int VEC, int NT>
__global__ void __launch_bounds__(THREADS)
int4mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ s, T* __restrict__ y, int m, int kh,
               int n, int group, int range, int4sel::Stacked sel) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool QUANT = ROUTE == ROUTE_W4A8;
  constexpr int PARTS = route_parts(ROUTE, F32);
  constexpr int ROWB = row_bytes(VEC, NT);
  constexpr int NCH = ROWB / 16;           // chunks a warp copies per row
  constexpr int WCOLS = 16 * NT, BCOLS = WARPS * WCOLS;
  // x values a lane stages per step (W4A8: a k32 step, else a k16 step)
  // and steps a thread loads at once
  constexpr int XV = QUANT ? 8 : 4;
  constexpr int XN = QUANT ? 2 : XB;
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (ROUTE == ROUTE_K9) {       // K9's device index, if any
    const long long l = int4sel::slice(sel);
    w += l * sel.w_stride;
    s += l * sel.s_stride;
  }
  // every block of the cluster has started once the first wait on the
  // cluster's barrier returns
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.y;
  const int c0 = split * range, c1 = min(kh, c0 + range);
  const int rows = c1 - c0;                // > 0, a multiple of KSTEP
  const int steps = rows / KSTEP, ksteps = range / KSTEP;
  const int nst = cdiv(rows, STAGE);
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
  float* quant = red + red_floats(NT);     // W4A8 only

  // 0. x's rows m0 .. m0 + 7 over the range's two halves (rows past M are
  // 0): a thread's first XN entries of [half][step][lane] into registers,
  // so their latency overlaps the weights' copies. A k16 step's entry is
  // x[.][c + 2t, 2t + 1, 2t + 8, 2t + 9]; W4A8's k32 step adds 2t + 16,
  // 2t + 17, 2t + 24, 2t + 25 (the k order of its A words)
  const int xsteps = QUANT ? nst : steps;
  const int entries = 2 * xsteps * 32;
  float v[XN][XV];
  auto load_x = [&](int e0) {
#pragma unroll
    for (int b = 0; b < XN; ++b) {
      const int e = e0 + b * THREADS, el = e % 32;
      const int j = (e / 32) % xsteps, h = e / (32 * xsteps);
      const int mm = m0 + el / 4;
#pragma unroll
      for (int q = 0; q < XV; ++q) v[b][q] = 0.f;
      if (e < entries && mm < m) {
        const T* xr = x + (long long)mm * 2 * kh + h * kh + c0 +
                      j * (QUANT ? STAGE : KSTEP) + 2 * (el % 4);
#pragma unroll
        for (int q = 0; q < XV / 2; ++q)
          load_pair(xr + 8 * q, v[b][2 * q], v[b][2 * q + 1]);
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

  cg::cluster_group cluster = cg::this_cluster();

  // 2. x's B fragments in shared memory; a thread's next XN entries are
  // loaded before it stages any
  if constexpr (QUANT) {
    // W4A8: the row maxima of |x| over this block's range, then over the
    // cluster's (all of K), then the rows quantized to int8
    float* wmax = quant;                   // [WARPS][MT]
    float* bmax = quant + WARPS * MT;      // [MT], read by the cluster
    float* rs = bmax + MT;                 // [MT], the row scales
    float amax = 0.f;
    for (int e0 = threadIdx.x; e0 < entries; e0 += XN * THREADS) {
      if (e0 != threadIdx.x) load_x(e0);
#pragma unroll
      for (int b = 0; b < XN; ++b)
#pragma unroll
        for (int q = 0; q < XV; ++q) amax = fmaxf(amax, fabsf(v[b][q]));
    }
    // a lane's entries are all of row g: the four lanes of a row, then the
    // warps
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, 2));
    if (t == 0) wmax[warp * MT + g] = amax;
    __syncthreads();
    if (threadIdx.x < MT) {
      float a = wmax[threadIdx.x];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) a = fmaxf(a, wmax[k * MT + threadIdx.x]);
      bmax[threadIdx.x] = a;
    }
    // every block has started (the first wait) and written its maxima (the
    // second barrier); the weights' copies stay in flight
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (threadIdx.x < MT) {
      const int splits = (int)cluster.num_blocks();
      float a = 0.f;
      for (int q = 0; q < splits; ++q)
        a = fmaxf(a, cluster.map_shared_rank(bmax, q)[threadIdx.x]);
      rs[threadIdx.x] = __fdiv_rn(fmaxf(a, 1e-12f), 127.f);
    }
    __syncthreads();
    const float scale = rs[g];
    const int nstr = range / STAGE;
    for (int e0 = threadIdx.x; e0 < entries; e0 += XN * THREADS) {
      if (entries > XN * THREADS) load_x(e0);   // else v holds them
#pragma unroll
      for (int b = 0; b < XN; ++b) {
        const int e = e0 + b * THREADS, el = e % 32;
        if (e >= entries) break;
        const int j = (e / 32) % nst, h = e / (32 * nst);
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int q = 0; q < XV; ++q) {
          const int iq = max(-127, min(127, __float2int_rn(
                                                __fdiv_rn(v[b][q], scale))));
          word[q / 4] |= (uint32_t)(iq & 0xFF) << (8 * (q % 4));
        }
        xs[(h * nstr + j) * 32 + el] = make_uint2(word[0], word[1]);
      }
    }
  } else {
    for (int e0 = threadIdx.x; e0 < entries; e0 += XN * THREADS) {
      if (e0 != threadIdx.x) load_x(e0);
#pragma unroll
      for (int b = 0; b < XN; ++b) {
        const int e = e0 + b * THREADS, el = e % 32;
        if (e >= entries) break;
        const int j = (e / 32) % steps, h = e / (32 * steps);
        uint2* dst = xs + ((h * ksteps + j) * PARTS) * 32 + el;
        if constexpr (ROUTE == ROUTE_V2 && F32) {
          // v2 in float32: the big TF32 parts of pairs (2t, 2t + 1) and
          // (2t + 8, 2t + 9), then their small parts
          tf32x3::Split sp[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) sp[q] = tf32x3::split(v[b][q]);
          dst[0] = make_uint2(sp[0].big, sp[1].big);
          dst[32] = make_uint2(sp[2].big, sp[3].big);
          dst[64] = make_uint2(sp[0].small, sp[1].small);
          dst[96] = make_uint2(sp[2].small, sp[3].small);
        } else {
          // K9 and v2 in bf16: x split into PARTS bf16 parts
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
    }
  }
  __syncthreads();

  // 3. the products, 32 rows at a time as they land, each tile in its own
  // sums (independent chains)
  float tot[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[i][q] = 0.f;
  if constexpr (QUANT) {
    // W4A8: one k32 product per half and tile a stage; a group's exact
    // int32 sums converted, scaled and added in float32 at its end
    const int nstr = range / STAGE;
    int ilo[NT][4], ihi[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) ilo[i][q] = ihi[i][q] = 0;
    for (int st = 0; st < nst; ++st) {
      cp_async_wait(nst - 1 - st);
      __syncwarp();
      uint32_t r[NT][4];
      load_a<VEC, NT>(r, ws + st * STAGE * ROWB, gaddr0 + st * STAGE * ln, ln,
                      lane);
      const uint2 bl = xs[st * 32 + lane], bh = xs[(nstr + st) * 32 + lane];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // rows 2t, 2t + 1, 2t + 8, 2t + 9 (+ 16) of columns 2g, 2g + 1
        const uint32_t a[4] = {__byte_perm(r[i][0], r[i][1], 0x6420),
                               __byte_perm(r[i][0], r[i][1], 0x7531),
                               __byte_perm(r[i][2], r[i][3], 0x6420),
                               __byte_perm(r[i][2], r[i][3], 0x7531)};
        uint32_t alo[4], ahi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          alo[q] = __vsub4(a[q] & 0x0F0F0F0Fu, 0x08080808u);
          ahi[q] = __vsub4((a[q] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
        }
        mma_s8(ilo[i], alo, bl);
        mma_s8(ihi[i], ahi, bh);
      }
      const int c = c0 + (st + 1) * STAGE;
      if (c % group == 0 || c >= c1) {
        const float* sg = ss + ((c - 1) / group - g_first) * 2 * WCOLS;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float sl[2] = {sg[16 * i + 2 * g], sg[16 * i + 2 * g + 1]};
          const float sh[2] = {sg[WCOLS + 16 * i + 2 * g],
                               sg[WCOLS + 16 * i + 2 * g + 1]};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            tot[i][q] += (float)ilo[i][q] * sl[q / 2] +
                         (float)ihi[i][q] * sh[q / 2];
            ilo[i][q] = ihi[i][q] = 0;
          }
        }
      }
    }
  } else if constexpr (ROUTE == ROUTE_V2 && F32) {
    // v2 in float32: W~ = (nib - 8) * s rounded in float32, split into
    // TF32 parts; a k16 step's products (two 8-row steps, two halves,
    // three each) summed from zero, then added in float32
    float sf[NT][4];                       // s of columns 2g, 2g + 1: lo, hi
    for (int st = 0; st < nst; ++st) {
      cp_async_wait(nst - 1 - st);
      __syncwarp();
      uint32_t r[NT][4];
      load_a<VEC, NT>(r, ws + st * STAGE * ROWB, gaddr0 + st * STAGE * ln, ln,
                      lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * st + half;       // k16 step in the range
        if (j >= steps) break;
        const int c = c0 + j * KSTEP;
        if (j == 0 || c % group == 0) {
          const float* sg = ss + (c / group - g_first) * 2 * WCOLS;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            sf[i][0] = sg[16 * i + 2 * g];
            sf[i][1] = sg[16 * i + 2 * g + 1];
            sf[i][2] = sg[WCOLS + 16 * i + 2 * g];
            sf[i][3] = sg[WCOLS + 16 * i + 2 * g + 1];
          }
        }
        const uint2* blo = xs + (j * PARTS) * 32 + lane;
        const uint2* bhi = xs + ((ksteps + j) * PARTS) * 32 + lane;
        uint2 bl[4], bh[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          bl[p] = blo[p * 32];
          bh[p] = bhi[p * 32];
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {    // packed rows 8e .. 8e + 7
            const uint32_t rr = r[i][2 * half + e];
            const uint32_t lo = rr & 0x0F0F0F0Fu, hi = (rr >> 4) & 0x0F0F0F0Fu;
            float wl[4], wh[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // byte k: column 2g + k % 2
              wl[k] = __fmul_rn(nib_f32(lo, k), sf[i][k % 2]);
              wh[k] = __fmul_rn(nib_f32(hi, k), sf[i][2 + k % 2]);
            }
            const tf32x3::FragB fl = {{bl[e].x, bl[e].y},
                                      {bl[2 + e].x, bl[2 + e].y}};
            const tf32x3::FragB fh = {{bh[e].x, bh[e].y},
                                      {bh[2 + e].x, bh[2 + e].y}};
            tf32x3::mma3(acc, tf32x3::split_a(wl), fl);
            tf32x3::mma3(acc, tf32x3::split_a(wh), fh);
          }
          tf32x3::add(tot[i], acc);
        }
      }
    }
  } else {
    // K9 (and V1): each part of x in its own sums, each group's sums from
    // zero, the parts added smallest first, scaled and added in float32 at
    // the group's end (or the range's). v2 in bf16: q times the bf16 scale
    // pair of its column, one chain per half over the range
    float plo[NT][PARTS][4], phi[NT][PARTS][4];
    uint32_t sv[NT][4];                    // v2: bf16 s pairs: lo, hi
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < PARTS; ++p) plo[i][p][q] = phi[i][p][q] = 0.f;
    for (int st = 0; st < nst; ++st) {
      cp_async_wait(nst - 1 - st);
      __syncwarp();
      uint32_t r[NT][4];
      load_a<VEC, NT>(r, ws + st * STAGE * ROWB, gaddr0 + st * STAGE * ln,
                      ln, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * st + half;       // k16 step in the range
        if (j >= steps) break;
        if constexpr (ROUTE == ROUTE_V2) {
          const int c = c0 + j * KSTEP;
          if (j == 0 || c % group == 0) {
            const float* sg = ss + (c / group - g_first) * 2 * WCOLS;
#pragma unroll
            for (int i = 0; i < NT; ++i) {
              const float f[4] = {sg[16 * i + 2 * g], sg[16 * i + 2 * g + 1],
                                  sg[WCOLS + 16 * i + 2 * g],
                                  sg[WCOLS + 16 * i + 2 * g + 1]};
#pragma unroll
              for (int q = 0; q < 4; ++q) sv[i][q] = pack_bf16(f[q], f[q]);
            }
          }
        }
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
          if constexpr (ROUTE == ROUTE_V1)
            unpack_v1(r[i][2 * half], r[i][2 * half + 1], alo, ahi);
          else
            unpack(r[i][2 * half], r[i][2 * half + 1], alo, ahi);
          if constexpr (ROUTE == ROUTE_V2) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // a0a1, a4a5: column 2g
              alo[q] = mul_bf16x2(alo[q], sv[i][q % 2]);
              ahi[q] = mul_bf16x2(ahi[q], sv[i][2 + q % 2]);
            }
          }
#pragma unroll
          for (int p = 0; p < PARTS; ++p) {
            mma(plo[i][p], alo, bl[p]);
            mma(phi[i][p], ahi, bh[p]);
          }
        }
        if constexpr (ROUTE == ROUTE_K9 || ROUTE == ROUTE_V1) {
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
                for (int p = 0; p < PARTS; ++p)
                  plo[i][p][q] = phi[i][p][q] = 0.f;
              }
            }
          }
        }
      }
    }
    if constexpr (ROUTE == ROUTE_V2) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[i][q] = plo[i][0][q] + phi[i][0][q];
    }
  }

  // 4. the sum over the cluster's blocks (W4A8: times the row scale)
  if constexpr (!QUANT)                    // W4A8 waited in step 2
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster_sum<QUANT, NT>(tot, red, quant + (WARPS + 1) * MT, y, m, n, m0, nb,
                         cluster);
}

// a / d for 0 <= a < 2^22 and d > 0 without an integer division (a chain
// of some twenty instructions, which on the word route's critical path
// showed in the call's time): a times inv = 1 / d rounded to nearest is
// within (a / d) 2^-23 < 1/2 of a / d, so its truncation is off by at most
// one, which the two products correct
__device__ __forceinline__ int div_by(int a, int d, float inv) {
  int q = __float2int_rz(__int2float_rz(a) * inv);
  q -= q * d > a;
  q += (q + 1) * d <= a;
  return q;
}

// one value of x as float32
__device__ __forceinline__ float load_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The word route's A registers of one k16 step of a warp, from this warp's
// copy of the step's 16 word rows at ``rows`` (ROWB bytes a row, the first
// at global address gaddr0): a[i][q][h] is A register q of tile i (q = 0:
// column 2g at k slots 2t, 2t + 1 = word rows t, t + 4; 1: column 2g + 1;
// 2, 3: the same at k slots 2t + 8, 2t + 9 = word rows t + 8, t + 12)
// holding planes 4h .. 4h + 3 of its two words, the first k slot's in the
// low half. VEC 16: one 8-byte read of a row's swizzled chunk (columns 2g,
// 2g + 1); VEC 4: each row at its offset in the 4 nt + 1 aligned chunks
// that cover it, in 4-byte reads.
template <int VEC, int NT>
__device__ __forceinline__ void load_words(uint32_t (&a)[NT][4][2],
                                           const uint8_t* rows,
                                           uintptr_t gaddr0,
                                           long long rowstride, int lane) {
  constexpr int ROWB = wrow_bytes(VEC, NT);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    uint32_t u[4][2];                      // [word row t + 4e][column]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = t + 4 * e;
      if constexpr (VEC == 16) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            rows + ROWB * r + 16 * wswizzle(r, 4 * i + g / 2, NT) +
            8 * (g % 2));
        u[e][0] = v.x;
        u[e][1] = v.y;
      } else {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(
                                rows + ROWB * r +
                                (int)((gaddr0 + r * rowstride) & 15)) +
                            16 * i + 2 * g;
        u[e][0] = p[0];
        u[e][1] = p[1];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w0 = u[2 * (q / 2)][q % 2], w1 = u[2 * (q / 2) + 1][q % 2];
      a[i][q][0] = __byte_perm(w0, w1, 0x5410);
      a[i][q][1] = __byte_perm(w0, w1, 0x7632);
    }
  }
}

// The word route (see above): x [m, 8 kw], words [kw, n], scales
// [8 kw / group, n]. grid (column tiles, splits, 8-row tiles of x),
// cluster (1, splits, 1); each block owns ``range`` word rows.
template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(THREADS)
int4word_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
                const float* __restrict__ s, T* __restrict__ y, int m, int kw,
                int n, int group, int range) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int PARTS = 1 + 2 * F32;
  constexpr int ROWB = wrow_bytes(VEC, NT);
  constexpr int NCH = ROWB / 16;           // chunks a warp copies per row
  constexpr int WCOLS = 16 * NT, BCOLS = WARPS * WCOLS;
  extern __shared__ __align__(16) uint8_t smem[];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c0 = blockIdx.y * range, c1 = min(kw, c0 + range);
  const int steps = (c1 - c0) / KSTEP, ksteps = range / KSTEP;
  const int nb = blockIdx.x * BCOLS;       // the block's first column
  const int nw = nb + warp * WCOLS;        // this warp's first column
  const int m0 = blockIdx.z * MT;
  const int ngw = wgroups(range, group);
  const int sfl = wscale_floats(range, group, NT);
  const long long ln = n, k = (long long)PLANES * kw;
  const long long rowstride = 4 * ln;      // bytes of a word row
  const float inv_group = __frcp_rn((float)group);
  const float inv_steps = __frcp_rn((float)steps);
  int g0[PLANES];                          // each plane's first group
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
    g0[p] = div_by(p * kw + c0, group, inv_group);

  uint2* xs = reinterpret_cast<uint2*>(smem);
  uint8_t* ws = smem + wx_bytes(PARTS, range) + warp * range * ROWB;
  float* ss = reinterpret_cast<float*>(smem + wx_bytes(PARTS, range) +
                                       ww_bytes(VEC, NT, range)) + warp * sfl;
  float* red = reinterpret_cast<float*>(smem + wx_bytes(PARTS, range) +
                                        ww_bytes(VEC, NT, range)) +
               WARPS * sfl;

  // 0. x's rows m0 .. m0 + 7 at every plane's word rows of the range (rows
  // past M are 0): entry [plane][step][lane] is x[.][p kw + c + t + 4e],
  // e = 0 .. 3; a thread's first XB entries into registers, so that their
  // latency overlaps the copies
  const int entries = PLANES * steps * 32;
  float v[XB][4];
  auto load_x = [&](int e0) {
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int e = e0 + b * THREADS, el = e % 32;
      const int p = div_by(e / 32, steps, inv_steps);
      const int j = e / 32 - p * steps;
      const int mm = m0 + el / 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[b][q] = 0.f;
      if (e < entries && mm < m) {
        const T* xr = x + mm * k + p * kw + c0 + j * KSTEP + el % 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[b][q] = load_one(xr + 4 * q);
      }
    }
  };
  load_x(threadIdx.x);

  // 1. this warp's 16 nt columns of word rows [c0, c1): one commit group
  // per k16 step, neighbouring lanes on a row's neighbouring chunks; the
  // scales of every plane's groups of the range with the first
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
  const uint8_t* w_end = wb + kw * rowstride;
  const uint8_t* w_lo = reinterpret_cast<const uint8_t*>(   // holds w[0]
      reinterpret_cast<uintptr_t>(wb) & ~static_cast<uintptr_t>(15));
  const uintptr_t gaddr0 = reinterpret_cast<uintptr_t>(w + c0 * ln + nw);
  for (int st = 0; st < steps; ++st) {
    for (int e = lane; e < KSTEP * NCH; e += 32) {
      const int rr = st * KSTEP + e / NCH, ch = e % NCH;
      if constexpr (VEC == 16) {
        const bool ok = nw + 4 * ch < n;
        cp_async16(ws + rr * ROWB + 16 * wswizzle(rr, ch, NT),
                   ok ? w + (c0 + rr) * ln + nw + 4 * ch : w, ok ? 16 : 0);
      } else {
        const uint8_t* src =
            reinterpret_cast<const uint8_t*>((gaddr0 + rr * rowstride) &
                                             ~static_cast<uintptr_t>(15)) +
            16 * ch;
        const bool ok = src < w_end;
        cp_async16(ws + rr * ROWB + 16 * ch, ok ? src : w_lo, ok ? 16 : 0);
      }
    }
    if (st == 0) {
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {  // groups g0[p] .. of plane p
        const int ng = div_by(p * kw + c1 - 1, group, inv_group) - g0[p] + 1;
        float* dst = ss + p * ngw * WCOLS;
        const float* src = s + (long long)g0[p] * ln + nw;
        if constexpr (VEC == 16) {        // rows 16-byte aligned, as w's
          for (int e = lane; e < ng * (WCOLS / 4); e += 32) {
            const int gi = e / (WCOLS / 4), ch = e % (WCOLS / 4);
            const bool ok = nw + 4 * ch < n;
            cp_async16(dst + gi * WCOLS + 4 * ch,
                       ok ? src + gi * ln + 4 * ch : s, ok ? 16 : 0);
          }
        } else {
          for (int e = lane; e < ng * WCOLS; e += 32) {
            const int gi = e / WCOLS, j = e % WCOLS;
            const bool ok = nw + j < n;
            cp_async4(dst + gi * WCOLS + j, ok ? src + gi * ln + j : s,
                      ok ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  }

  cg::cluster_group cluster = cg::this_cluster();

  // 2. x's B fragments in shared memory, split into PARTS bf16 parts; a
  // thread's next XB entries are loaded before it stages any
  for (int e0 = threadIdx.x; e0 < entries; e0 += XB * THREADS) {
    if (e0 != threadIdx.x) load_x(e0);
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int e = e0 + b * THREADS, el = e % 32;
      if (e >= entries) break;
      const int p = div_by(e / 32, steps, inv_steps);
      const int j = e / 32 - p * steps;
      uint2* dst = xs + ((p * ksteps + j) * PARTS) * 32 + el;
#pragma unroll
      for (int pp = 0; pp < PARTS; ++pp) {
        const uint32_t b01 = pack_bf16(v[b][0], v[b][1]);
        const uint32_t b23 = pack_bf16(v[b][2], v[b][3]);
        dst[pp * 32] = make_uint2(b01, b23);
        v[b][0] -= bf16_lo(b01); v[b][1] -= bf16_hi(b01);
        v[b][2] -= bf16_lo(b23); v[b][3] -= bf16_hi(b23);
      }
    }
  }
  __syncthreads();

  // 3. a k16 step at a time as it lands: its words in registers, then the
  // eight planes, each plane's products from zero, the parts added
  // smallest first, scaled by the plane's group's scales and added in
  // float32
  float tot[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[i][q] = 0.f;
  for (int j = 0; j < steps; ++j) {
    cp_async_wait(steps - 1 - j);
    __syncwarp();
    uint32_t aw[NT][4][2];
    load_words<VEC, NT>(aw, ws + j * KSTEP * ROWB,
                        gaddr0 + j * KSTEP * rowstride, rowstride, lane);
    const int c = c0 + j * KSTEP;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      const float* sg =
          ss + (p * ngw + div_by(p * kw + c, group, inv_group) - g0[p]) *
                   WCOLS + 2 * g;
      const uint2* bx = xs + ((p * ksteps + j) * PARTS) * 32 + lane;
      uint2 b[PARTS];
#pragma unroll
      for (int pp = 0; pp < PARTS; ++pp) b[pp] = bx[pp * 32];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = nib_pair(aw[i][q][p / 4], 4 * (p % 4));
        float acc[PARTS][4];
#pragma unroll
        for (int pp = 0; pp < PARTS; ++pp) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[pp][q] = 0.f;
          mma(acc[pp], a, b[pp]);
        }
        const float2 sc = *reinterpret_cast<const float2*>(sg + 16 * i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // q / 2: column 2g or 2g + 1
          float sum = acc[PARTS - 1][q];
#pragma unroll
          for (int pp = PARTS - 2; pp >= 0; --pp) sum += acc[pp][q];
          tot[i][q] += sum * (q < 2 ? sc.x : sc.y);
        }
      }
    }
  }

  // 4. the sum over the cluster's blocks
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster_sum<false, NT>(tot, red, nullptr, y, m, n, m0, nb, cluster);
}

namespace {  // internal linkage: each library keeps its own ``sized``

// One launch of ``kernel`` over the grid (column tiles of 64 nt, splits,
// 8-row tiles of x), the splits one thread block cluster; the kernel's
// attributes set at its first launch (``sized``, one flag an
// instantiation). Returns cudaGetLastError() after it.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), bool& sized, int m, int n, int nt,
                   int splits, int smem, cudaStream_t stream, A... args) {
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(n, 64 * nt), splits, cdiv(m, MT));
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// kh: the K/2 packed rows, or on the word route the K/8 word rows; sel:
// K9's device index (w and s then the stack's first slice), else Stacked{}
template <int ROUTE, typename T, int VEC, int NT>
int launch(const void* x, const uint8_t* w, const float* s, void* y, int m,
           int kh, int n, int group, cudaStream_t stream,
           int4sel::Stacked sel) {
  static bool sized = false;               // once per instantiation
  const int tiles = block_tiles(m, n, NT);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int range = split_range(ROUTE, tiles, kh, NT);
  const int splits = split_count(ROUTE, tiles, kh, NT);
  if constexpr (ROUTE == ROUTE_WORD) {
    return launch_cluster(
        int4word_kernel<T, VEC, NT>, sized, m, n, NT, splits,
        word_smem_bytes(sizeof(T) == 4, VEC, NT, range, group), stream, xt,
        reinterpret_cast<const uint32_t*>(w), s, yt, m, kh, n, group, range);
  } else {
    return launch_cluster(
        int4mma_kernel<ROUTE, T, VEC, NT>, sized, m, n, NT, splits,
        route_smem_bytes(ROUTE, sizeof(T) == 4, VEC, NT, range, group),
        stream, xt, w, s, yt, m, kh, n, group, range, sel);
  }
}

// nt A tiles a warp: 1, 2 or 4, or 0 for the plan's pick_nt
template <int ROUTE, typename T, int VEC>
int launch_nt(const void* x, const uint8_t* w, const float* s, void* y,
              int m, int kh, int n, int group, int nt, cudaStream_t stream,
              int4sel::Stacked sel) {
  if (nt == 0) nt = pick_nt(ROUTE, m, n, kh);
  if (nt == 4)
    return launch<ROUTE, T, VEC, 4>(x, w, s, y, m, kh, n, group, stream, sel);
  if (nt == 2)
    return launch<ROUTE, T, VEC, 2>(x, w, s, y, m, kh, n, group, stream, sel);
  return launch<ROUTE, T, VEC, 1>(x, w, s, y, m, kh, n, group, stream, sel);
}

// the copy width every slice the call may read allows (16, 2 or 1 bytes)
template <int ROUTE, typename T>
int launch_vec(const void* x, const uint8_t* w, const float* s, void* y,
               int m, int kh, int n, int group, int nt, cudaStream_t stream,
               int4sel::Stacked sel) {
  const uintptr_t base = int4sel::slice_bits(w, sel);
  if constexpr (ROUTE == ROUTE_WORD) {     // rows of 4 n bytes, as s's
    if (n % 4 == 0 && base % 16 == 0 &&
        reinterpret_cast<uintptr_t>(s) % 16 == 0)
      return launch_nt<ROUTE, T, 16>(x, w, s, y, m, kh, n, group, nt, stream,
                                     sel);
    return launch_nt<ROUTE, T, 4>(x, w, s, y, m, kh, n, group, nt, stream,
                                     sel);
  } else {
    if (n % 16 == 0 && base % 16 == 0)
      return launch_nt<ROUTE, T, 16>(x, w, s, y, m, kh, n, group, nt, stream,
                                     sel);
    if (n % 2 == 0 && base % 2 == 0)
      return launch_nt<ROUTE, T, 2>(x, w, s, y, m, kh, n, group, nt, stream,
                                     sel);
    return launch_nt<ROUTE, T, 1>(x, w, s, y, m, kh, n, group, nt, stream,
                                     sel);
  }
}

template <int ROUTE>
int launch_dtype(const void* x, const void* packed, const void* scales,
                 void* y, int m, int kh, int n, int group, int nt, int dtype,
                 void* stream, int4sel::Stacked sel = int4sel::Stacked{}) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* w = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scales);
  if (dtype == 0)
    return launch_vec<ROUTE, float>(x, w, s, y, m, kh, n, group, nt, st,
                                    sel);
  if (dtype == 1)
    return launch_vec<ROUTE, __nv_bfloat16>(x, w, s, y, m, kh, n, group, nt,
                                            st, sel);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

}  // namespace int4mma

extern "C" {

#if defined(AUDAX_INT4_V2)

// P5 v2 (ROUTE_V2): x [m, k] (dtype 0 = float32, 1 = bfloat16, 1 <= m <=
// MAX_M), packed [k/2, n] uint8, scales [k/group, n] float32, y [m, n] in
// x's dtype; all contiguous on the device, x aligned to two of its
// elements; nt A tiles a warp (64 nt columns a block: 1, 2 or 4, with
// k/2 <= MAX_SPLITS * max_range(ROUTE_V2, nt)) or 0 for the plan's
// pick_nt. One launch; returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a call this body does not take
// (int4mma::takes).
int int4_unpack_v2_mma(const void* x, const void* packed, const void* scales,
                       void* y, int m, int k, int n, int group, int nt,
                       int dtype, void* stream) {
  using namespace int4mma;
  const int kh = k / 2;
  if (m < 1 || m > MAX_M || k < 2 || k % 2 || n < 1 || !takes(kh, group) ||
      !(nt == 0 || ((nt == 1 || nt == 2 || nt == 4) &&
                    kh <= MAX_SPLITS * max_range(ROUTE_V2, nt))))
    return (int)cudaErrorInvalidValue;
  return launch_dtype<ROUTE_V2>(x, packed, scales, y, m, kh, n, group, nt,
                                dtype, stream);
}

#elif defined(AUDAX_INT4_V1)

// P5 v1 (ROUTE_V1): the arguments, rules and return of int4_unpack_v2_mma.
int int4_unpack_v1_mma(const void* x, const void* packed, const void* scales,
                       void* y, int m, int k, int n, int group, int nt,
                       int dtype, void* stream) {
  using namespace int4mma;
  const int kh = k / 2;
  if (m < 1 || m > MAX_M || k < 2 || k % 2 || n < 1 || !takes(kh, group) ||
      !(nt == 0 || ((nt == 1 || nt == 2 || nt == 4) &&
                    kh <= MAX_SPLITS * max_range(ROUTE_V1, nt))))
    return (int)cudaErrorInvalidValue;
  return launch_dtype<ROUTE_V1>(x, packed, scales, y, m, kh, n, group, nt,
                                dtype, stream);
}

#elif defined(AUDAX_INT4_WORD)

// P2 and P3 (the word route): x [m, k] (dtype 0 = float32, 1 = bfloat16,
// 1 <= m <= MAX_M), words int32 [k/8, n], scales [k/group, n] float32, y
// [m, n] in x's dtype; all contiguous on the device; nt by the plan's
// pick_nt. One launch; returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a call this body does not take
// (int4mma::takes_word).
int int4_word_matmul_mma(const void* x, const void* words,
                         const void* scales, void* y, int m, int k, int n,
                         int group, int dtype, void* stream) {
  using namespace int4mma;
  const int kw = k / PLANES;
  if (m < 1 || m > MAX_M || k < PLANES || k % PLANES || n < 1 ||
      !takes_word(kw, group))
    return (int)cudaErrorInvalidValue;
  return launch_dtype<ROUTE_WORD>(x, words, scales, y, m, kw, n, group, 0,
                                  dtype, stream);
}

#elif defined(AUDAX_INT4_W4A8)

// P4 (ROUTE_W4A8), its activation quantization inside: x [m, k] (dtype 0 =
// float32, 1 = bfloat16, 1 <= m <= MAX_M), packed [k/2, n] uint8, scales
// [k/group, n] float32, y [m, n] in x's dtype; all contiguous on the
// device, x aligned to two of its elements. One launch; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for a call this
// body does not take (int4mma::takes_w4a8).
int w4a8_matmul_mma(const void* x, const void* packed, const void* scales,
                    void* y, int m, int k, int n, int group, int dtype,
                    void* stream) {
  using namespace int4mma;
  const int kh = k / 2;
  if (m < 1 || m > MAX_M || k < 2 || k % 2 || n < 1 ||
      !takes_w4a8(kh, group))
    return (int)cudaErrorInvalidValue;
  return launch_dtype<ROUTE_W4A8>(x, packed, scales, y, m, kh, n, group, 0,
                                  dtype, stream);
}

#else

// x [m, k] (dtype 0 = float32, 1 = bfloat16, 1 <= m <= 256), packed [k/2, n]
// uint8, scales [k/group, n] float32, y [m, n] in x's dtype; all
// contiguous on the device, x aligned to two of its elements. sel:
// nullptr, or a device pointer to the index (int32 for sel_bytes 4, int64
// for 8) of the slice to use of a stack of ``count`` [k/2, n] and [k/group,
// n] slices that packed and scales start (int4_select.cuh; an index
// outside [0, count) traps). One launch; returns cudaGetLastError() after
// it, or cudaErrorInvalidValue for a call this body does not take
// (int4mma::takes).
int int4_matmul_mma(const void* x, const void* packed, const void* scales,
                    void* y, int m, int k, int n, int group, int dtype,
                    const void* sel, int sel_bytes, int count, void* stream) {
  const int kh = k / 2;
  if (m < 1 || m > 256 || k < 2 || k % 2 || n < 1 ||
      !int4mma::takes(kh, group) ||
      (sel && ((sel_bytes != 4 && sel_bytes != 8) || count < 1)))
    return (int)cudaErrorInvalidValue;
  return int4mma::launch_dtype<int4mma::ROUTE_K9>(
      x, packed, scales, y, m, kh, n, group, 0, dtype, stream,
      int4sel::stacked(sel, sel_bytes, count, k, n, group));
}

#endif

}  // extern "C"
