// Merge-path merge of two sorted runs of (key row, count) pairs.
//
// Replaces the Pallas merge-path kernels of experiments/pallas_merge_probe.py
// (build_merge, build_merge3, build_merge_n, build_merge3_chunked: split
// points by binary search, then a 16-stage bitonic merger per tile).
//
// Inputs: A and B sorted ascending; keys are [M, WK] int64 rows compared
// lexicographically from the last column (WK = 1 is the packed 2k <= 64
// sortkey, whose signed order is the unsigned order of the key). Output:
// the STABLE merge, A's row first on equal keys, with each row's count.
//
// Bound on this card: bytes. Every input row is read once and every output
// row written once, (WK + 1) * 8 bytes each way, against a few integer
// compares per row. The design keeps the traffic at that minimum:
//   - each block owns kRows consecutive output positions and finds its two
//     diagonal splits by binary search in device memory (log2(M) reads);
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

namespace {

constexpr int kThreads = 256;

template <int WK>
struct Tile {
  // ~32 KB of staged rows per block whatever the key width
  static constexpr int kItems = WK == 1 ? 8 : (WK <= 3 ? 4 : 2);
  static constexpr int kRows = kThreads * kItems;
};

template <int WK>
__device__ __forceinline__ bool row_le(const int64_t* a, const int64_t* b) {
#pragma unroll
  for (int w = WK - 1; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return true;
}

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

template <int WK>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ ak, const int64_t* __restrict__ ac,
                  int64_t na, const int64_t* __restrict__ bk,
                  const int64_t* __restrict__ bc, int64_t nb,
                  int64_t* __restrict__ ok, int64_t* __restrict__ oc) {
  constexpr int kItems = Tile<WK>::kItems;
  constexpr int kRows = Tile<WK>::kRows;
  __shared__ int64_t s_key[kRows * WK];
  __shared__ int64_t s_cnt[kRows];
  __shared__ int s_src[kRows];
  __shared__ int64_t s_split[2];

  const int64_t total = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * kRows;
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
  for (int i = threadIdx.x; i < nA; i += kThreads) s_cnt[i] = ac[a0 + i];
  for (int i = threadIdx.x; i < nB; i += kThreads) s_cnt[nA + i] = bc[b0 + i];
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

  for (int p = threadIdx.x; p < n; p += kThreads) oc[d0 + p] = s_cnt[s_src[p]];
  for (int e = threadIdx.x; e < n * WK; e += kThreads) {
    const int p = e / WK;
    ok[d0 * WK + e] = s_key[s_src[p] * WK + (e - p * WK)];
  }
}

template <int WK>
int launch(const void* ak, const void* ac, int64_t na, const void* bk,
           const void* bc, int64_t nb, void* ok, void* oc, cudaStream_t s) {
  const int64_t total = na + nb;
  if (total > 0) {
    const int64_t blocks = (total + Tile<WK>::kRows - 1) / Tile<WK>::kRows;
    merge_path_kernel<WK><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)ak, (const int64_t*)ac, na, (const int64_t*)bk,
        (const int64_t*)bc, nb, (int64_t*)ok, (int64_t*)oc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jf_merge_path(const void* a_keys, const void* a_cnt, int64_t na,
                             const void* b_keys, const void* b_cnt, int64_t nb,
                             void* out_keys, void* out_cnt, int wk,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (wk) {
    case 1: return launch<1>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 2: return launch<2>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 3: return launch<3>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 4: return launch<4>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 5: return launch<5>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 6: return launch<6>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    case 7: return launch<7>(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
