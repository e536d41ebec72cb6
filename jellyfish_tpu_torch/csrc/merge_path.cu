// Merge-path merge of sorted runs of key rows, each with an optional count.
//
// Replaces the Pallas merge-path kernels of experiments/pallas_merge_probe.py
// (build_merge, build_merge3, build_merge_n, build_merge3_chunked: split
// points by binary search, then a 16-stage bitonic merger per tile).
//
// Keys are [M, WK] int64 rows compared as csrc/rows.cuh says. Two entry
// points, one tile routine:
//   - jf_merge_path: the STABLE merge of runs A and B (A's row first on
//     equal keys), with each row's count;
//   - jf_merge_pass: one pass of a merge sort. Every adjacent pair of
//     sorted runs of `run` rows in one [M, WK] array is merged the same
//     way in one launch; the last pair may be short, and a lone last run
//     is copied. The count (payload) is optional, so a sort can move keys
//     only.
//
// Bound on this card: bytes. Every input row is read once and every output
// row written once, (WK + payload) * 8 bytes each way, against a few integer
// compares per row. The design keeps the traffic at that minimum:
//   - each block owns kRows consecutive output positions of one pair and
//     finds its two diagonal splits by binary search in device memory
//     (log2(M) reads);
//   - it stages its A and B windows, which are contiguous, in shared memory
//     with coalesced loads;
//   - each thread finds its own sub-split by binary search in shared memory
//     and merges kItems outputs serially, recording only the source row;
//   - the block writes the merged tile out coalesced.
// What the TPU version needed and this one does not: the 1024-element split
// quantum, the pre-reversed B stream and the bitonic merger (Mosaic
// workarounds, pallas_merge_probe.py:3-15).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;

template <int WK>
struct Tile {
  // ~32 KB of staged rows per block whatever the key width
  static constexpr int kItems = WK == 1 ? 8 : (WK <= 3 ? 4 : 2);
  static constexpr int kRows = kThreads * kItems;
};

// Number of A rows among the first `diag` outputs of the stable merge:
// the first i with A[i] > B[diag - 1 - i] (A[i] <= B[j] means A[i] goes
// first, which is what keeps A's rows ahead on ties).
template <int WK, typename I>
__device__ __forceinline__ I split(const int64_t* a, I na, const int64_t* b,
                                   I nb, I diag) {
  I lo = diag > nb ? diag - nb : 0;
  I hi = diag < na ? diag : na;
  while (lo < hi) {
    I mid = (lo + hi) >> 1;
    if (row_le<WK>(a + mid * WK, b + (diag - 1 - mid) * WK)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Output rows [d0, d0 + kRows) of the stable merge of A and B (clipped to
// na + nb). ac, bc and oc are the counts, used only when PAY.
template <int WK, bool PAY>
__device__ __forceinline__ void merge_tile(
    const int64_t* __restrict__ ak, const int64_t* __restrict__ ac, int64_t na,
    const int64_t* __restrict__ bk, const int64_t* __restrict__ bc, int64_t nb,
    int64_t* __restrict__ ok, int64_t* __restrict__ oc, int64_t d0) {
  constexpr int kItems = Tile<WK>::kItems;
  constexpr int kRows = Tile<WK>::kRows;
  __shared__ int64_t s_key[kRows * WK];
  __shared__ int64_t s_cnt[PAY ? kRows : 1];
  __shared__ int s_src[kRows];
  __shared__ int64_t s_split[2];

  const int64_t total = na + nb;
  const int64_t d1 = d0 + kRows < total ? d0 + kRows : total;
  if (threadIdx.x < 2) {
    s_split[threadIdx.x] =
        split<WK, int64_t>(ak, na, bk, nb, threadIdx.x ? d1 : d0);
  }
  __syncthreads();
  const int64_t a0 = s_split[0];
  const int64_t b0 = d0 - a0;
  const int nA = (int)(s_split[1] - a0);
  const int n = (int)(d1 - d0);
  const int nB = n - nA;

  // A's window at rows [0, nA), B's at [nA, n)
  for (int i = threadIdx.x; i < nA * WK; i += kThreads) s_key[i] = ak[a0 * WK + i];
  for (int i = threadIdx.x; i < nB * WK; i += kThreads) s_key[nA * WK + i] = bk[b0 * WK + i];
  if constexpr (PAY) {
    for (int i = threadIdx.x; i < nA; i += kThreads) s_cnt[i] = ac[a0 + i];
    for (int i = threadIdx.x; i < nB; i += kThreads) s_cnt[nA + i] = bc[b0 + i];
  }
  __syncthreads();

  const int64_t* sa = s_key;
  const int64_t* sb = s_key + nA * WK;
  const int diag = min((int)threadIdx.x * kItems, n);
  int i = split<WK, int>(sa, nA, sb, nB, diag);
  int j = diag - i;
  const int end = min(diag + kItems, n);
  for (int p = diag; p < end; ++p) {
    const bool take_a = j >= nB || (i < nA && row_le<WK>(sa + i * WK, sb + j * WK));
    s_src[p] = take_a ? i++ : nA + j++;
  }
  __syncthreads();

  if constexpr (PAY) {
    for (int p = threadIdx.x; p < n; p += kThreads) oc[d0 + p] = s_cnt[s_src[p]];
  }
  for (int e = threadIdx.x; e < n * WK; e += kThreads) {
    const int p = e / WK;
    ok[d0 * WK + e] = s_key[s_src[p] * WK + (e - p * WK)];
  }
}

template <int WK>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ ak, const int64_t* __restrict__ ac,
                  int64_t na, const int64_t* __restrict__ bk,
                  const int64_t* __restrict__ bc, int64_t nb,
                  int64_t* __restrict__ ok, int64_t* __restrict__ oc) {
  merge_tile<WK, true>(ak, ac, na, bk, bc, nb, ok, oc,
                       (int64_t)blockIdx.x * Tile<WK>::kRows);
}

// blocks_per_pair consecutive blocks serve one pair of runs: pair p holds
// rows [2 p run, 2 p run + 2 run) of the array, A its first run rows.
template <int WK, bool PAY>
__global__ void __launch_bounds__(kThreads)
merge_pass_kernel(const int64_t* __restrict__ ik, const int64_t* __restrict__ ip,
                  int64_t m, int64_t run, int64_t blocks_per_pair,
                  int64_t* __restrict__ ok, int64_t* __restrict__ op) {
  const int64_t pair = (int64_t)blockIdx.x / blocks_per_pair;
  const int64_t d0 =
      ((int64_t)blockIdx.x - pair * blocks_per_pair) * Tile<WK>::kRows;
  const int64_t base = pair * 2 * run;
  const int64_t na = run < m - base ? run : m - base;
  const int64_t rest = m - base - na;
  const int64_t nb = run < rest ? run : rest;
  if (d0 >= na + nb) return;  // the short last pair needs fewer blocks
  const int64_t* pa = PAY ? ip + base : nullptr;
  const int64_t* pb = PAY ? ip + base + na : nullptr;
  int64_t* po = PAY ? op + base : nullptr;
  merge_tile<WK, PAY>(ik + base * WK, pa, na, ik + (base + na) * WK, pb, nb,
                      ok + base * WK, po, d0);
}

template <int WK>
int launch_merge(const void* ak, const void* ac, int64_t na, const void* bk,
                 const void* bc, int64_t nb, void* ok, void* oc,
                 cudaStream_t s) {
  const int64_t total = na + nb;
  if (total > 0) {
    const int64_t blocks = (total + Tile<WK>::kRows - 1) / Tile<WK>::kRows;
    merge_path_kernel<WK><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)ak, (const int64_t*)ac, na, (const int64_t*)bk,
        (const int64_t*)bc, nb, (int64_t*)ok, (int64_t*)oc);
  }
  return (int)cudaGetLastError();
}

template <int WK>
int launch_pass(const void* keys, const void* pay, int64_t m, int64_t run,
                void* out_keys, void* out_pay, cudaStream_t s) {
  if (m > 0) {
    const int64_t pairs = (m + 2 * run - 1) / (2 * run);
    const int64_t per_pair = (2 * run + Tile<WK>::kRows - 1) / Tile<WK>::kRows;
    const int64_t blocks = pairs * per_pair;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (pay) {
      merge_pass_kernel<WK, true><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const int64_t*)keys, (const int64_t*)pay, m, run, per_pair,
          (int64_t*)out_keys, (int64_t*)out_pay);
    } else {
      merge_pass_kernel<WK, false><<<(unsigned)blocks, kThreads, 0, s>>>(
          (const int64_t*)keys, nullptr, m, run, per_pair,
          (int64_t*)out_keys, nullptr);
    }
  }
  return (int)cudaGetLastError();
}

using MergeFn = int (*)(const void*, const void*, int64_t, const void*,
                        const void*, int64_t, void*, void*, cudaStream_t);
using PassFn = int (*)(const void*, const void*, int64_t, int64_t, void*,
                       void*, cudaStream_t);
constexpr MergeFn kMerge[] = {nullptr, launch_merge<1>, launch_merge<2>,
                              launch_merge<3>, launch_merge<4>,
                              launch_merge<5>, launch_merge<6>,
                              launch_merge<7>};
constexpr PassFn kPass[] = {nullptr, launch_pass<1>, launch_pass<2>,
                            launch_pass<3>, launch_pass<4>, launch_pass<5>,
                            launch_pass<6>, launch_pass<7>};

}  // namespace

extern "C" int jf_merge_path(const void* a_keys, const void* a_cnt, int64_t na,
                             const void* b_keys, const void* b_cnt, int64_t nb,
                             void* out_keys, void* out_cnt, int wk,
                             void* stream) {
  if (wk < 1 || wk > 7) return (int)cudaErrorInvalidValue;
  return kMerge[wk](a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt,
                    (cudaStream_t)stream);
}

// pay and out_pay NULL: keys only. run >= 1; out must not overlap the input.
extern "C" int jf_merge_pass(const void* keys, const void* pay, int64_t m,
                             int64_t run, void* out_keys, void* out_pay,
                             int wk, void* stream) {
  if (wk < 1 || wk > 7 || run < 1) return (int)cudaErrorInvalidValue;
  return kPass[wk](keys, pay, m, run, out_keys, out_pay, (cudaStream_t)stream);
}
