// Key rows as the kernels compare them.
//
// A key row is WK int64 columns compared lexicographically from the LAST
// column (ops/multiword.py: WK = 1 is the packed 2k <= 64 sortkey, whose
// signed order is the unsigned order of the key; WK > 1 are 32-bit limbs,
// least significant first). K1 (merge_path.cu) and K3 (bitonic.cu) share
// these definitions, so a merge and a sort order rows alike.

#pragma once

#include <stdint.h>

// a <= b. Works on rows in device or shared memory and on register arrays.
template <int WK>
__device__ __forceinline__ bool row_le(const int64_t* a, const int64_t* b) {
#pragma unroll
  for (int w = WK - 1; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return true;
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
