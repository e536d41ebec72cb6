// Merge-path merge of sorted runs of key rows, each with an optional count.
//
// Replaces the Pallas merge-path kernels of experiments/pallas_merge_probe.py
// (build_merge, build_merge3, build_merge_n, build_merge3_chunked: split
// points by binary search, then a 16-stage bitonic merger per tile).
//
// Keys are [M, WK] int64 rows compared as csrc/rows.cuh says. Entry points:
//   - jf_merge_path: the STABLE merge of runs A and B (A's row first on
//     equal keys), with each row's count;
//   - jf_merge_splits and jf_merge_pass: one pass of a merge sort. Every
//     adjacent pair of sorted runs of `run` rows in one [M, WK] array is
//     merged the same way; the last pair may be short, and a lone last run
//     is copied. The count (payload) is optional, so a sort can move keys
//     only. jf_merge_splits writes where each output tile of each pair
//     starts in A, jf_merge_pass merges the tiles from those splits.
//
// Bound on this card: bytes. Every input row is read once and every output
// row written once, (WK + payload) * 8 bytes each way, against a few integer
// compares per row.
//
// jf_merge_path (merge_tile): each block owns kRows consecutive output
// positions, finds its two diagonal splits by binary search in device
// memory (log2(M) dependent reads by two threads), stages its A and B
// windows in shared memory with coalesced loads, lets each thread find its
// sub-split in shared memory and merge kItems outputs serially, and writes
// the tile out coalesced.
//
// jf_merge_pass, the sort's pass, keeps the device busy moving bytes:
//   - the splits come from a partition pass (splits_kernel): one thread a
//     tile boundary, so every search is in flight at once and each boundary
//     is searched once, where merge_tile's blocks wait on two dependent
//     chains of loads and search every boundary twice;
//   - a block owns tiles of 1,280-4,352 output rows (PassTile: 5-17 rows a
//     thread, so a thread's search in shared memory serves many rows) and
//     loops over them, one or two blocks resident on each SM;
//   - a tile's A and B windows are contiguous byte ranges, staged with
//     16-byte cp.async (8-byte ones at a misaligned end) into one of two
//     shared-memory stages: the next tile's copies are in flight while this
//     tile merges and stores;
//   - the merged tile is written out from shared memory as 16-byte vectors.
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
// na + nb). ac, bc and oc are the counts.
template <int WK>
__device__ __forceinline__ void merge_tile(
    const int64_t* __restrict__ ak, const int64_t* __restrict__ ac, int64_t na,
    const int64_t* __restrict__ bk, const int64_t* __restrict__ bc, int64_t nb,
    int64_t* __restrict__ ok, int64_t* __restrict__ oc, int64_t d0) {
  constexpr int kItems = Tile<WK>::kItems;
  constexpr int kRows = Tile<WK>::kRows;
  __shared__ int64_t s_key[kRows * WK];
  __shared__ int64_t s_cnt[kRows];
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
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ ak, const int64_t* __restrict__ ac,
                  int64_t na, const int64_t* __restrict__ bk,
                  const int64_t* __restrict__ bc, int64_t nb,
                  int64_t* __restrict__ ok, int64_t* __restrict__ oc) {
  merge_tile<WK>(ak, ac, na, bk, bc, nb, ok, oc,
                       (int64_t)blockIdx.x * Tile<WK>::kRows);
}

// -- the merge sort's pass ----------------------------------------------------

// A pass tile: kRows output rows, kItems a thread. Two stages of a tile's
// windows (keys, then payload, each with a word of slack at either end for
// the 16-byte alignment of the copies) and the source row of each output
// fit in shared memory: 87-194 KB. kItems is odd: where a warp's threads
// walk one run in step (a run of equal rows, such as the PAD rows), their
// rows lie kItems * WK words apart, which spreads them over the banks
// where an even stride would put most on one bank.
template <int WK, bool PAY>
struct PassTile {
  static constexpr int kCols = WK + PAY;
  static constexpr int kItems = kCols <= 2 ? 17 : (kCols <= 5 ? 9 : 5);
  static constexpr int kRows = kThreads * kItems;
  static constexpr int kKeyWords = kRows * WK + 4;
  static constexpr int kStageWords = kKeyWords + (PAY ? kRows + 4 : 0);
  static constexpr size_t kBytes =
      2 * kStageWords * sizeof(int64_t) + kRows * sizeof(int);
};

// The pairs of one pass: pair p holds rows [2 p run, 2 p run + 2 run) of
// the array (run <= m), A its first run rows; `steps` tiles serve a pair.
struct Pairs {
  int64_t m, run, steps;

  __device__ __forceinline__ void of(int64_t pair, int64_t& base, int64_t& na,
                                     int64_t& nb) const {
    base = pair * 2 * run;
    na = run < m - base ? run : m - base;
    nb = run < m - base - na ? run : m - base - na;
  }
};

// splits[p (steps + 1) + t], t = 0 .. steps: the number of A rows among the
// first min(t tile, na + nb) rows of pair p's merge. One thread an entry.
template <int WK>
__global__ void __launch_bounds__(kThreads)
splits_kernel(const int64_t* __restrict__ keys, Pairs pr, int64_t tile,
              int64_t entries, int64_t* __restrict__ splits) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= entries) return;
  const int64_t pair = e / (pr.steps + 1);
  int64_t base, na, nb;
  pr.of(pair, base, na, nb);
  const int64_t d = (e - pair * (pr.steps + 1)) * tile;
  splits[e] = split<WK, int64_t>(keys + base * WK, na,
                                 keys + (base + na) * WK, nb,
                                 d < na + nb ? d : na + nb);
}

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

// Starts copying words src[0, n) to dst[off, off + n), off = 1 when src is
// 8 bytes past a 16-byte boundary, else 0, so that 16-byte copies line up
// on both sides (dst is 16-byte aligned); the word at a misaligned end goes
// alone. Threads `lane` and lane + 1 take the ends. Returns off.
__device__ __forceinline__ int stage(int64_t* dst, const int64_t* src, int n,
                                     int lane) {
  const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
  const int head = off < n ? off : n;
  const int body = (n - head) >> 1;
  dst += off;
  if (threadIdx.x == lane && head) cp_async8(dst, src);
  if (threadIdx.x == lane + 1 && (n - head) & 1) {
    cp_async8(dst + n - 1, src + n - 1);
  }
  for (int c = threadIdx.x; c < body; c += kThreads) {
    cp_async16(dst + head + 2 * c, src + head + 2 * c);
  }
  return off;
}

// A tile's windows: rows a, b of the array start A's and B's, row o the
// output's; and where the staged rows start in the stage (words).
struct Win {
  int64_t a, b, o;
  int na, nb;
  int ka, kb, pa, pb;
};

// Tile t of the pass from its splits s0, s1, with its copies started into
// stage `st` (committed as one group).
template <int WK, bool PAY>
__device__ __forceinline__ Win start_tile(const Pairs& pr, int64_t t,
                                          int64_t s0, int64_t s1,
                                          const int64_t* ik, const int64_t* ip,
                                          int64_t* st) {
  using P = PassTile<WK, PAY>;
  const int64_t pair = t / pr.steps;
  const int64_t d0 = (t - pair * pr.steps) * P::kRows;
  int64_t base, na, nb;
  pr.of(pair, base, na, nb);
  const int64_t d1 = d0 + P::kRows < na + nb ? d0 + P::kRows : na + nb;
  Win w;
  w.a = base + s0;
  w.b = base + na + (d0 - s0);
  w.o = base + d0;
  w.na = (int)(s1 - s0);
  w.nb = d1 > d0 ? (int)(d1 - d0) - w.na : 0;
  w.ka = stage(st, ik + w.a * WK, w.na * WK, 0);
  const int rb = (w.ka + w.na * WK + 1) & ~1;
  w.kb = rb + stage(st + rb, ik + w.b * WK, w.nb * WK, 2);
  if constexpr (PAY) {
    int64_t* sp = st + P::kKeyWords;
    w.pa = P::kKeyWords + stage(sp, ip + w.a, w.na, 4);
    const int rp = (w.pa - P::kKeyWords + w.na + 1) & ~1;
    w.pb = P::kKeyWords + rp + stage(sp + rp, ip + w.b, w.nb, 6);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return w;
}

// Merges the staged tile (each thread kItems outputs from its own split in
// shared memory, recording the source row) and writes it out, 16 bytes a
// thread a store.
template <int WK, bool PAY>
__device__ __forceinline__ void merge_staged(const int64_t* st, const Win& w,
                                             int* s_src, int64_t* ok,
                                             int64_t* op) {
  constexpr int kItems = PassTile<WK, PAY>::kItems;
  const int na = w.na, nb = w.nb, n = na + nb;
  const int64_t* sa = st + w.ka;
  const int64_t* sb = st + w.kb;
  const int diag = min((int)threadIdx.x * kItems, n);
  int i = split<WK, int>(sa, na, sb, nb, diag);
  int j = diag - i;
  const int end = min(diag + kItems, n);
  for (int p = diag; p < end; ++p) {
    const bool take_a = j >= nb || (i < na && row_le<WK>(sa + i * WK, sb + j * WK));
    s_src[p] = take_a ? i++ : na + j++;
  }
  __syncthreads();

  // output rows start at an even row (tiles and pairs hold even row
  // counts), so at a 16-byte boundary
  const int words = n * WK;
  int64_t* out = ok + w.o * WK;
  auto key = [&](int e) {
    const int p = e / WK;
    const int r = s_src[p];
    return st[(r < na ? w.ka + r * WK : w.kb + (r - na) * WK) + e - p * WK];
  };
  for (int c = threadIdx.x; 2 * c + 1 < words; c += kThreads) {
    reinterpret_cast<longlong2*>(out)[c] = make_longlong2(key(2 * c), key(2 * c + 1));
  }
  if (words & 1 && threadIdx.x == 0) out[words - 1] = key(words - 1);
  if constexpr (PAY) {
    int64_t* po = op + w.o;
    auto pay = [&](int p) {
      const int r = s_src[p];
      return st[r < na ? w.pa + r : w.pb + r - na];
    };
    for (int c = threadIdx.x; 2 * c + 1 < n; c += kThreads) {
      reinterpret_cast<longlong2*>(po)[c] = make_longlong2(pay(2 * c), pay(2 * c + 1));
    }
    if (n & 1 && threadIdx.x == 0) po[n - 1] = pay(n - 1);
  }
}

// The pairs' tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...: the
// block's k-th tile merges in stage k mod 2 while the next one's copies
// fill the other stage. Each tile's splits are read a tile ahead.
template <int WK, bool PAY>
__global__ void __launch_bounds__(kThreads, 2)
pass_kernel(const int64_t* __restrict__ ik, const int64_t* __restrict__ ip,
            Pairs pr, const int64_t* __restrict__ splits, int64_t tiles,
            int64_t* __restrict__ ok, int64_t* __restrict__ op) {
  using P = PassTile<WK, PAY>;
  extern __shared__ __align__(16) int64_t smem[];
  int* s_src = reinterpret_cast<int*>(smem + 2 * P::kStageWords);
  const int64_t step = gridDim.x;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;
  // tile u's splits are entries e and e + 1, e = u + its pair
  auto splits_of = [&](int64_t u, int64_t& s0, int64_t& s1) {
    if (u < tiles) {
      const int64_t e = u + u / pr.steps;
      s0 = splits[e];
      s1 = splits[e + 1];
    }
  };
  int64_t s0, s1, n0 = 0, n1 = 0;
  splits_of(t, s0, s1);
  Win w = start_tile<WK, PAY>(pr, t, s0, s1, ik, ip, smem);
  splits_of(t + step, n0, n1);
  for (int buf = 0;; buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t is staged; every thread is done with the other stage
    __syncthreads();
    const int64_t next = t + step;
    Win wn;
    if (next < tiles) {
      wn = start_tile<WK, PAY>(pr, next, n0, n1, ik, ip,
                               smem + (buf ^ 1) * P::kStageWords);
      splits_of(next + step, n0, n1);
    }
    merge_staged<WK, PAY>(smem + buf * P::kStageWords, w, s_src, ok, op);
    if (next >= tiles) break;
    t = next;
    w = wn;
  }
}

// -- launchers ----------------------------------------------------------------

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

// The pairs of a pass over m >= 1 rows at tiles of `tile` rows, and their
// number. A run past the array is the array.
Pairs pairs_of(int64_t m, int64_t run, int64_t tile, int64_t* pairs) {
  run = run < m ? run : m;
  *pairs = (m + 2 * run - 1) / (2 * run);
  const int64_t rows = 2 * run < m ? 2 * run : m;
  return Pairs{m, run, (rows + tile - 1) / tile};
}

template <int WK>
int launch_splits(const void* keys, int64_t m, int64_t run, int64_t tile,
                  void* splits, cudaStream_t s) {
  if (m > 0) {
    int64_t pairs;
    const Pairs pr = pairs_of(m, run, tile, &pairs);
    const int64_t blocks = (pairs * (pr.steps + 1) + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    splits_kernel<WK><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)keys, pr, tile, pairs * (pr.steps + 1),
        (int64_t*)splits);
  }
  return (int)cudaGetLastError();
}

template <int WK, bool PAY>
int launch_tiles(const void* keys, const void* pay, int64_t m, int64_t run,
                 const void* splits, void* out_keys, void* out_pay,
                 cudaStream_t s) {
  using P = PassTile<WK, PAY>;
  if (m == 0) return (int)cudaGetLastError();
  int64_t pairs;
  const Pairs pr = pairs_of(m, run, P::kRows, &pairs);
  const int64_t tiles = pairs * pr.steps;
  auto kernel = pass_kernel<WK, PAY>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, P::kBytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)grid, kThreads, P::kBytes, s>>>(
      (const int64_t*)keys, (const int64_t*)pay, pr, (const int64_t*)splits,
      tiles, (int64_t*)out_keys, (int64_t*)out_pay);
  return (int)cudaGetLastError();
}

template <int WK>
int launch_pass(const void* keys, const void* pay, int64_t m, int64_t run,
                int64_t tile, const void* splits, void* out_keys,
                void* out_pay, cudaStream_t s) {
  if (tile != (pay ? PassTile<WK, true>::kRows : PassTile<WK, false>::kRows)) {
    return (int)cudaErrorInvalidValue;
  }
  return pay ? launch_tiles<WK, true>(keys, pay, m, run, splits, out_keys,
                                      out_pay, s)
             : launch_tiles<WK, false>(keys, nullptr, m, run, splits,
                                       out_keys, nullptr, s);
}

using MergeFn = int (*)(const void*, const void*, int64_t, const void*,
                        const void*, int64_t, void*, void*, cudaStream_t);
using SplitsFn = int (*)(const void*, int64_t, int64_t, int64_t, void*,
                         cudaStream_t);
using PassFn = int (*)(const void*, const void*, int64_t, int64_t, int64_t,
                       const void*, void*, void*, cudaStream_t);
constexpr MergeFn kMerge[] = {nullptr, launch_merge<1>, launch_merge<2>,
                              launch_merge<3>, launch_merge<4>,
                              launch_merge<5>, launch_merge<6>,
                              launch_merge<7>};
constexpr SplitsFn kSplits[] = {nullptr, launch_splits<1>, launch_splits<2>,
                                launch_splits<3>, launch_splits<4>,
                                launch_splits<5>, launch_splits<6>,
                                launch_splits<7>};
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

// The splits of a pass at tiles of `tile` rows into `splits`, pairs x
// (ceil(min(2 run, m) / tile) + 1) int64 entries (kernels/merge_path.py
// split_steps). run, tile >= 1.
extern "C" int jf_merge_splits(const void* keys, int64_t m, int64_t run,
                               int64_t tile, void* splits, int wk,
                               void* stream) {
  if (wk < 1 || wk > 7 || run < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  return kSplits[wk](keys, m, run, tile, splits, (cudaStream_t)stream);
}

// The pass from jf_merge_splits' splits at `tile`, which must be the
// instance's tile rows (kernels/merge_path.py pass_tile_rows). pay and
// out_pay NULL: keys only. out must not overlap the input; out_keys and
// out_pay 16-byte aligned.
extern "C" int jf_merge_pass(const void* keys, const void* pay, int64_t m,
                             int64_t run, int64_t tile, const void* splits,
                             void* out_keys, void* out_pay, int wk,
                             void* stream) {
  if (wk < 1 || wk > 7 || run < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out_keys | (uintptr_t)out_pay) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  return kPass[wk](keys, pay, m, run, tile, splits, out_keys, out_pay,
                   (cudaStream_t)stream);
}
