// Key rows as the kernels compare them.
//
// A key row is WK int64 columns (wk, read at run time, in the wide
// instances) compared lexicographically from the LAST column
// (ops/multiword.py: WK = 1 is the packed 2k <= 64 sortkey, whose signed
// order is the unsigned order of the key; WK > 1 are 32-bit limbs, least
// significant first). K1 (merge_path.cu), K2 (compact.cu) and K3
// (bitonic.cu) share these definitions, so a merge and a sort order rows
// alike.

#pragma once

#include <stdint.h>

// The wide instances (WK = 0) take rows of any width, read at run time
// (`wk`); the instances WK = 1 .. kNarrowCols have it at compile time and
// ignore `wk`.
constexpr int kNarrowCols = 7;

// The most shared memory a block may take on sm_90 (227 KB), all of it
// dynamic above 48 KB: the wide instances size their tiles to it.
constexpr int kSharedBytes = 232448;

template <int WK>
__device__ __forceinline__ int width(int wk) {
  return WK > 0 ? WK : wk;
}

// a <= b. Works on rows in device or shared memory and on register arrays.
template <int WK>
__device__ __forceinline__ bool row_le(const int64_t* a, const int64_t* b,
                                       int wk = WK) {
#pragma unroll
  for (int w = width<WK>(wk) - 1; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return true;
}

// x / d for the wide instances' word and row indices, d >= 2 read at run
// time: x * ceil(2^32 / d) >> 32 (`recip` on the host, `divide` on the
// device), exact while x * d < 2^32: a tile holds at most kSharedBytes / 8
// words and d is at most a few thousand columns.
__host__ __device__ inline uint32_t recip(int d) {
  return (uint32_t)((((uint64_t)1 << 32) + (uint64_t)d - 1) / (uint64_t)d);
}

__device__ __forceinline__ int divide(int x, uint32_t r) {
  return (int)__umulhi((uint32_t)x, r);
}

// Asynchronous copies from device memory to shared memory (cp.async),
// committed and awaited by the caller.
__device__ __forceinline__ void cp_async16(int64_t* dst, const int64_t* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(int64_t* dst, const int64_t* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

// a < b, the same order without branches (row_lt(a, b) == !row_le(b, a)):
// from the lowest column up, a < b holds when it holds at this column, or
// the column ties and it held below.
template <int WK>
__device__ __forceinline__ bool row_lt(const int64_t* a, const int64_t* b) {
  bool lt = false;
#pragma unroll
  for (int w = 0; w < WK; ++w) lt = (a[w] < b[w]) | ((a[w] == b[w]) & lt);
  return lt;
}
