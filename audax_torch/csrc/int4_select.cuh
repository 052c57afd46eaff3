// K9's stacked-slice operand, shared by its two bodies (csrc/int4_matmul_mma.cu
// and csrc/int4_matmul.cu through int4_common.cuh).
//
// The TPU kernel (audax/ops/int4_matmul.py:int4_matmul) reads the index of
// its stacked weight slice from the device: a scalar prefetch that its
// index maps read. Its decode callers pass a layer (a loop counter) or, in
// the mixture-of-experts decode step, the router's top-k expert id, which
// lies on the device. Here the index is a device pointer to one int32 or
// int64; the kernel reads it once at entry and offsets the packed bytes
// and the scales by that many slices. The host never reads it. An index
// outside [0, count) traps, so a bad index fails the launch instead of
// reading another tensor's bytes.

#pragma once

#include <stdint.h>

namespace int4sel {

// A kernel parameter (trivially copyable); Stacked{} is "no index".
struct Stacked {
  const void* idx;             // nullptr: the pointers are the slice's own
  int idx_bytes;               // 4 (int32) or 8 (int64)
  int count;                   // slices in the stack
  long long w_stride;          // bytes of one slice's packed weights
  long long s_stride;          // floats of one slice's scales
};

// The slice the device index names (0 without one).
__device__ __forceinline__ long long slice(const Stacked& st) {
  if (st.idx == nullptr) return 0;
  const long long l =
      st.idx_bytes == 8 ? *static_cast<const long long*>(st.idx)
                        : (long long)*static_cast<const int*>(st.idx);
  if (l < 0 || l >= st.count) __trap();
  return l;
}

// What the host can promise of every slice's address: the stack's base
// and, with a device index, the slice stride ORed in (the two share their
// low zero bits), for the alignment tests that pick a body's copy width.
inline uintptr_t slice_bits(const void* base, const Stacked& st) {
  return reinterpret_cast<uintptr_t>(base) |
         (st.idx ? static_cast<uintptr_t>(st.w_stride) : 0);
}

// The operand for an entry point's arguments: the stack's slices are
// [k/2, n] bytes and [k/group, n] floats.
inline Stacked stacked(const void* idx, int idx_bytes, int count, int k,
                       int n, int group) {
  Stacked st{};
  st.idx = idx;
  st.idx_bytes = idx_bytes;
  st.count = count;
  st.w_stride = (long long)(k / 2) * n;
  st.s_stride = (long long)(k / group) * n;
  return st;
}

}  // namespace int4sel
