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
// jf_merge_path up to 7 columns (merge_tile): each block owns kRows
// consecutive output positions, finds its two diagonal splits by binary
// search in device memory (log2(M) dependent reads by two threads), stages
// its A and B windows in shared memory with coalesced loads, lets each
// thread find its sub-split in shared memory and merge kItems outputs
// serially, and writes the tile out coalesced. Wider keys run the wide
// pass's kernels on the one pair of runs A and B (below).
//
// jf_merge_pass, the sort's pass, keeps the device busy moving bytes:
//   - the splits come from a partition pass (splits_kernel): one thread a
//     tile boundary, so every search is in flight at once and each boundary
//     is searched once, where merge_tile's blocks wait on two dependent
//     chains of loads and search every boundary twice;
//   - a block owns tiles of 1,280-4,352 output rows (pass_rows: 5-17 rows a
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
//
// Keys of any width (k > 112): each entry has template instances for 1-7
// columns and wide kernels that read the width at run time and run above
// 7 columns, with instances at Wk 8 and 13 beside the run-time width.
// jf_merge_pass runs wide_pass_kernel (rows staged at an odd stride,
// below) on tiles of 5, 3 or 1 rows a thread, or of fewer rows than
// threads, whichever is the largest whose two stages fit in 227 KB
// (pass_rows); jf_merge_splits runs wide_splits_kernel, which reads a
// probe's rows eight columns a round trip and brackets most searches by
// their neighbours'. jf_merge_path runs the same two kernels on runs A and
// B of their own, with the counts as payload (wide_merge_path, below).

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
                                   I nb, I diag, int wk) {
  const int W = width<WK>(wk);
  I lo = diag > nb ? diag - nb : 0;
  I hi = diag < na ? diag : na;
  while (lo < hi) {
    I mid = (lo + hi) >> 1;
    if (row_le<WK>(a + mid * W, b + (diag - 1 - mid) * W, wk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Output rows [d0, d0 + rows) of the stable merge of A and B (clipped to
// na + nb), `items` a thread (rows <= kThreads * items). ac, bc and oc are
// the counts; s_* the block's shared memory.
template <int WK>
__device__ __forceinline__ void merge_tile(
    const int64_t* __restrict__ ak, const int64_t* __restrict__ ac, int64_t na,
    const int64_t* __restrict__ bk, const int64_t* __restrict__ bc, int64_t nb,
    int64_t* __restrict__ ok, int64_t* __restrict__ oc, int64_t d0, int wk,
    int rows, int items, int64_t* s_key, int64_t* s_cnt, int* s_src,
    int64_t* s_split) {
  const int W = width<WK>(wk);
  const int64_t total = na + nb;
  const int64_t d1 = d0 + rows < total ? d0 + rows : total;
  if (threadIdx.x < 2) {
    s_split[threadIdx.x] =
        split<WK, int64_t>(ak, na, bk, nb, threadIdx.x ? d1 : d0, wk);
  }
  __syncthreads();
  const int64_t a0 = s_split[0];
  const int64_t b0 = d0 - a0;
  const int nA = (int)(s_split[1] - a0);
  const int n = (int)(d1 - d0);
  const int nB = n - nA;

  // A's window at rows [0, nA), B's at [nA, n)
  for (int i = threadIdx.x; i < nA * W; i += kThreads) {
    s_key[i] = ak[a0 * W + i];
  }
  for (int i = threadIdx.x; i < nB * W; i += kThreads) {
    s_key[nA * W + i] = bk[b0 * W + i];
  }
  for (int i = threadIdx.x; i < nA; i += kThreads) s_cnt[i] = ac[a0 + i];
  for (int i = threadIdx.x; i < nB; i += kThreads) s_cnt[nA + i] = bc[b0 + i];
  __syncthreads();

  const int64_t* sa = s_key;
  const int64_t* sb = s_key + nA * W;
  const int diag = min((int)threadIdx.x * items, n);
  int i = split<WK, int>(sa, nA, sb, nB, diag, wk);
  int j = diag - i;
  const int end = min(diag + items, n);
  for (int p = diag; p < end; ++p) {
    const bool take_a =
        j >= nB || (i < nA && row_le<WK>(sa + i * W, sb + j * W, wk));
    s_src[p] = take_a ? i++ : nA + j++;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < n; p += kThreads) oc[d0 + p] = s_cnt[s_src[p]];
  for (int e = threadIdx.x; e < n * W; e += kThreads) {
    const int p = e / W;
    ok[d0 * W + e] = s_key[s_src[p] * W + (e - p * W)];
  }
}

// The tile's rows in static shared memory; WK = 1 .. kNarrowCols (wider
// keys run wide_merge_path, below).
template <int WK>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const int64_t* __restrict__ ak, const int64_t* __restrict__ ac,
                  int64_t na, const int64_t* __restrict__ bk,
                  const int64_t* __restrict__ bc, int64_t nb,
                  int64_t* __restrict__ ok, int64_t* __restrict__ oc) {
  constexpr int kRows = Tile<WK>::kRows;
  __shared__ int64_t s_key[kRows * WK];
  __shared__ int64_t s_cnt[kRows];
  __shared__ int s_src[kRows];
  __shared__ int64_t s_split[2];
  merge_tile<WK>(ak, ac, na, bk, bc, nb, ok, oc, (int64_t)blockIdx.x * kRows,
                 WK, kRows, Tile<WK>::kItems, s_key, s_cnt, s_src, s_split);
}

// -- the merge sort's pass ----------------------------------------------------

// A pass tile: `rows` output rows, `items` a thread. Two stages of a
// tile's windows (keys, then payload, each with a word of slack at either
// end for the 16-byte alignment of the copies) and the source row of each
// output fit in shared memory: `bytes`, 87-227 KB. The narrow instances'
// items are odd: where a warp's threads walk one run in step (a run of
// equal rows, such as the PAD rows), their rows lie items * WK words
// apart, which spreads them over the banks where an even stride would put
// most on one bank.
struct PassShape {
  int items, rows, key_words, stage_words;
  int64_t bytes;
};

__host__ __device__ constexpr PassShape pass_shape(int rows, int wk,
                                                   bool pay) {
  const int64_t key_words = (int64_t)rows * wk + 4;
  const int64_t stage_words = key_words + (pay ? rows + 4 : 0);
  return PassShape{(rows + kThreads - 1) / kThreads, rows, (int)key_words,
                   (int)stage_words,
                   2 * stage_words * 8 + (int64_t)rows * 4};
}

// The wide pass's tile (wide_pass_kernel, below): two stages of rows at
// the odd stride wk | 1 words (and the payload), and the source row of
// each output.
struct WideShape {
  int items, rows, stride, stage_words;
  int64_t bytes;
};

__host__ __device__ constexpr WideShape wide_shape(int rows, int wk,
                                                   bool pay) {
  const int64_t stage = (int64_t)rows * ((wk | 1) + (pay ? 1 : 0));
  return WideShape{(rows + kThreads - 1) / kThreads, rows, wk | 1,
                   (int)stage, 2 * stage * 8 + (int64_t)rows * 4};
}

// The tile rows of a pass over rows of wk key columns (and a payload),
// kernels/merge_path.py pass_tile_rows: 256 threads of 17, 9 or 5 rows up
// to 7 columns; above, the most odd rows a thread of 5, 3 and 1 whose
// wide_shape fits, else the most even rows below 256 (tiles start at even
// rows, for the 16-byte stores of the write-out); fewer than 2 rows: the
// width is too wide.
__host__ __device__ constexpr int pass_rows(int wk, bool pay) {
  const int cols = wk + (pay ? 1 : 0);
  if (wk <= kNarrowCols) {
    return kThreads * (cols <= 2 ? 17 : (cols <= 5 ? 9 : 5));
  }
  for (int items = 5; items >= 1; items -= 2) {
    if (wide_shape(kThreads * items, wk, pay).bytes <= kSharedBytes) {
      return kThreads * items;
    }
  }
  const int64_t row = 16 * (int64_t)((wk | 1) + (pay ? 1 : 0)) + 4;
  return (int)(kSharedBytes / row) & ~1;
}

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
// WK = 1 .. kNarrowCols (wider keys run wide_splits_kernel, below).
template <int WK>
__global__ void __launch_bounds__(kThreads)
splits_kernel(const int64_t* __restrict__ keys, Pairs pr, int64_t tile,
              int64_t entries, int64_t* __restrict__ splits, int wk) {
  const int W = width<WK>(wk);
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= entries) return;
  const int64_t pair = e / (pr.steps + 1);
  int64_t base, na, nb;
  pr.of(pair, base, na, nb);
  const int64_t d = (e - pair * (pr.steps + 1)) * tile;
  splits[e] = split<WK, int64_t>(keys + base * W, na,
                                 keys + (base + na) * W, nb,
                                 d < na + nb ? d : na + nb, wk);
}

// -- the wide kernels' pairs -------------------------------------------------

// A pair of sorted runs as a wide kernel merges it: A's keys and payload
// at a and pa (na rows), B's at b and pb (nb rows); its merge goes to
// output rows o, o + 1, ...
struct Pair {
  const int64_t *a, *b, *pa, *pb;
  int64_t na, nb, o;
};

// The pairs of a pass over one array of keys (and a payload): Pairs' pair
// p, merged in place of its rows.
struct ArrayPairs {
  Pairs pr;
  const int64_t* keys;
  const int64_t* pay;

  __device__ __forceinline__ int64_t steps() const { return pr.steps; }

  __device__ __forceinline__ Pair of(int64_t p, int W) const {
    int64_t base, na, nb;
    pr.of(p, base, na, nb);
    return Pair{keys + base * W, keys + (base + na) * W, pay + base,
                pay + base + na, na, nb, base};
  }
};

// jf_merge_path's one pair: runs A and B of their own, with their counts,
// served by `tiles` tiles.
struct TwoRuns {
  Pair ab;
  int64_t tiles;

  __device__ __forceinline__ int64_t steps() const { return tiles; }

  __device__ __forceinline__ Pair of(int64_t, int) const { return ab; }
};

// -- the wide partition pass -------------------------------------------------

// splits_kernel above kNarrowCols columns ran far below its bound: one
// thread a boundary, each probe compared by row_le, one column pair a
// round trip from the top down, so that rows that tie (the PAD rows,
// 40-84% of a wide grain, and duplicate keys) cost wk round trips a
// probe. Every boundary of a pass is searched at once, so the kernel
// waits on the card's rate of scattered row reads, two a probe, and on
// the longest chain of probes. The wide kernel:
//   - compares a probe kProbeCols columns a round trip: a boundary has
//     kProbeLanes lanes, lane q reads kLaneCols columns of each row from
//     column top - kProbeCols + q kLaneCols (a whole row at Wk 8, so a
//     PAD or duplicate row costs one round trip), two ballots find the
//     top column that differs and whether A's is the lower, and the next
//     kProbeCols columns are read only when the whole group ties;
//   - reads fewer rows: a warp's groups are consecutive boundaries, and
//     where kBracket or more of them serve one pair, the first and the
//     last search the whole pair, then the others search only between
//     them (a split moves by 0 to tile rows from one boundary to the
//     next), in up to log2(15 tile) probes in place of log2(run), their
//     A rows shared among the warp's searches.
// Bound: scattered row reads and the chain of probes, not bytes. At the
// k = 127 grain (kernel_ab.py, PERF.md) 2 lanes of 4 columns beat 2 of
// 2, 4 of 1 and 4 of 2, and the bracketing took a third off each.
constexpr int kProbeLanes = 2;
constexpr int kLaneCols = 4;
constexpr int kProbeCols = kProbeLanes * kLaneCols;
constexpr int kBracket = 8;

// The binary search of split (A's row first on ties) for the lanes with
// `on` set, over [lo, hi) on A = a and B = b at diagonal d; every lane of
// the warp runs it, so that the ballots see the whole warp. `group` holds
// the lanes of this lane's boundary, q its place there.
__device__ __forceinline__ void wide_search(bool on, int64_t& lo, int64_t& hi,
                                            const int64_t* a,
                                            const int64_t* b, int64_t d,
                                            int wk, int q, unsigned group) {
  while (__any_sync(0xffffffffu, on && lo < hi)) {
    const bool probe = on && lo < hi;
    const int64_t mid = (lo + hi) >> 1;
    const int64_t* ra = a + mid * wk;
    const int64_t* rb = b + (d - 1 - mid) * wk;
    // open: the probe's rows tie on every column read so far
    bool open = probe, le = true;
    for (int top = wk; __any_sync(0xffffffffu, open); top -= kProbeCols) {
      int64_t x[kLaneCols], y[kLaneCols];
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        const int col = top - kProbeCols + q * kLaneCols + c;
        const bool read = open && col >= 0;
        x[c] = read ? ra[col] : 0;
        y[c] = read ? rb[col] : 0;
      }
      bool lt = false, eq = true;  // row_lt's rule over the lane's columns
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        lt = (x[c] < y[c]) | ((x[c] == y[c]) & lt);
        eq &= x[c] == y[c];
      }
      const unsigned diff = __ballot_sync(0xffffffffu, !eq) & group;
      const unsigned less = __ballot_sync(0xffffffffu, lt) & group;
      if (open && diff) {
        le = (less >> (31 - __clz(diff))) & 1;
        open = false;
      } else if (top <= kProbeCols) {
        open = false;  // equal rows: le
      }
    }
    if (probe) {
      if (le) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
  }
}

// splits_kernel's entries for rows of wk > kNarrowCols columns, on the
// pairs of Src (ArrayPairs: a pass; TwoRuns: jf_merge_path, whose runs may
// differ in length by any amount; the brackets hold for any pair, since
// both the split and d - split grow with d)
template <class Src>
__global__ void __launch_bounds__(kThreads)
wide_splits_kernel(Src src, int64_t tile, int64_t entries,
                   int64_t* __restrict__ splits, int wk) {
  const int64_t e =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kProbeLanes;
  const int lane = threadIdx.x & 31;
  const int q = lane % kProbeLanes;
  const unsigned group = ((1u << kProbeLanes) - 1u) << (lane - q);
  int64_t pair = -1, lo = 0, hi = 0, d = 0;
  const int64_t* a = nullptr;
  const int64_t* b = nullptr;
  if (e < entries) {
    pair = e / (src.steps() + 1);
    const Pair p = src.of(pair, wk);
    a = p.a;
    b = p.b;
    const int64_t t = (e - pair * (src.steps() + 1)) * tile;
    d = t < p.na + p.nb ? t : p.na + p.nb;
    lo = d > p.nb ? d - p.nb : 0;
    hi = d < p.na ? d : p.na;
  }
  // the warp's lanes of this pair: lanes first .. last
  const unsigned same = __match_any_sync(0xffffffffu, pair);
  const int first = __ffs(same) - 1;
  const int last = 31 - __clz(same) - (kProbeLanes - 1);  // its group
  const bool lead = last - first < (kBracket - 1) * kProbeLanes ||
                    lane - q == first || lane - q == last;
  wide_search(lead, lo, hi, a, b, d, wk, q, group);
  const int64_t s0 = __shfl_sync(0xffffffffu, lo, first);
  const int64_t d0 = __shfl_sync(0xffffffffu, d, first);
  const int64_t s1 = __shfl_sync(0xffffffffu, lo, last);
  const int64_t d1 = __shfl_sync(0xffffffffu, d, last);
  if (!lead) {  // s0 <= split <= s1, and d - split grows as d does
    const int64_t up = s1 - (d1 - d), down = s0 + (d - d0);
    lo = lo > s0 ? lo : s0;
    lo = lo > up ? lo : up;
    hi = hi < s1 ? hi : s1;
    hi = hi < down ? hi : down;
  }
  wide_search(!lead, lo, hi, a, b, d, wk, q, group);
  if (e < entries && q == 0) splits[e] = lo;
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
                                          int64_t* st, const PassShape& P,
                                          int wk) {
  const int W = width<WK>(wk);
  const int64_t pair = t / pr.steps;
  const int64_t d0 = (t - pair * pr.steps) * P.rows;
  int64_t base, na, nb;
  pr.of(pair, base, na, nb);
  const int64_t d1 = d0 + P.rows < na + nb ? d0 + P.rows : na + nb;
  Win w;
  w.a = base + s0;
  w.b = base + na + (d0 - s0);
  w.o = base + d0;
  w.na = (int)(s1 - s0);
  w.nb = d1 > d0 ? (int)(d1 - d0) - w.na : 0;
  w.ka = stage(st, ik + w.a * W, w.na * W, 0);
  const int rb = (w.ka + w.na * W + 1) & ~1;
  w.kb = rb + stage(st + rb, ik + w.b * W, w.nb * W, 2);
  if constexpr (PAY) {
    int64_t* sp = st + P.key_words;
    w.pa = P.key_words + stage(sp, ip + w.a, w.na, 4);
    const int rp = (w.pa - P.key_words + w.na + 1) & ~1;
    w.pb = P.key_words + rp + stage(sp + rp, ip + w.b, w.nb, 6);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return w;
}

// Merges the staged tile (each thread `items` outputs from its own split
// in shared memory, recording the source row) and writes it out, 16 bytes
// a thread a store.
template <int WK, bool PAY>
__device__ __forceinline__ void merge_staged(const int64_t* st, const Win& w,
                                             int* s_src, int64_t* ok,
                                             int64_t* op, int items, int wk) {
  const int W = width<WK>(wk);
  const int na = w.na, nb = w.nb, n = na + nb;
  const int64_t* sa = st + w.ka;
  const int64_t* sb = st + w.kb;
  const int diag = min((int)threadIdx.x * items, n);
  int i = split<WK, int>(sa, na, sb, nb, diag, wk);
  int j = diag - i;
  const int end = min(diag + items, n);
  for (int p = diag; p < end; ++p) {
    const bool take_a =
        j >= nb || (i < na && row_le<WK>(sa + i * W, sb + j * W, wk));
    s_src[p] = take_a ? i++ : na + j++;
  }
  __syncthreads();

  // output rows start at an even row (tiles and pairs hold even row
  // counts), so at a 16-byte boundary
  const int words = n * W;
  int64_t* out = ok + w.o * W;
  auto key = [&](int e) {
    const int p = e / W;
    const int r = s_src[p];
    return st[(r < na ? w.ka + r * W : w.kb + (r - na) * W) + e - p * W];
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
// fill the other stage. Each tile's splits are read a tile ahead. WK is
// 1-7 (wider keys run wide_pass_kernel, below).
template <int WK, bool PAY>
__global__ void __launch_bounds__(kThreads, 2)
pass_kernel(const int64_t* __restrict__ ik, const int64_t* __restrict__ ip,
            Pairs pr, const int64_t* __restrict__ splits, int64_t tiles,
            int64_t* __restrict__ ok, int64_t* __restrict__ op, int wk) {
  constexpr PassShape P = pass_shape(pass_rows(WK, PAY), WK, PAY);
  extern __shared__ __align__(16) int64_t smem[];
  int* s_src = reinterpret_cast<int*>(smem + 2 * P.stage_words);
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
  Win w = start_tile<WK, PAY>(pr, t, s0, s1, ik, ip, smem, P, wk);
  splits_of(t + step, n0, n1);
  for (int buf = 0;; buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t is staged; every thread is done with the other stage
    __syncthreads();
    const int64_t next = t + step;
    Win wn;
    if (next < tiles) {
      wn = start_tile<WK, PAY>(pr, next, n0, n1, ik, ip,
                               smem + (buf ^ 1) * P.stage_words, P, wk);
      splits_of(next + step, n0, n1);
    }
    merge_staged<WK, PAY>(smem + buf * P.stage_words, w, s_src, ok, op,
                          P.items, wk);
    if (next >= tiles) break;
    t = next;
    w = wn;
  }
}

// -- the wide pass ------------------------------------------------------------

// jf_merge_pass above kNarrowCols columns (k > 112): pass_kernel's scheme
// (the partition pass's splits, persistent blocks, the next tile's copies
// in flight in the other of two stages) with rows staged for rows of any
// width. What the narrow instances get from a compile-time width, and
// what the wide rows lacked:
//   - a tile's rows are staged at an odd stride of wk | 1 words (8-byte
//     cp.async, the row and column of each word by a multiply, `divide`),
//     so that the rows a warp reads at once (its threads walking one run
//     in step, or rows at random) fall on spread banks; at the even
//     stride of 8 words, the rows of a warp's compares met on 2 of the
//     16 8-byte bank slots;
//   - compares run from the top column down and stop at the first
//     difference (row_le), the width unrolled in the compile-time
//     instances for Wk 8 (k 113-128) and Wk 13 (k 193-208), the widths
//     of 150- and 250-base reads' assembly k;
//   - the merged tile is written out as 16-byte vectors whose row comes
//     from a multiply, not a division, and whose source row is recorded
//     once an output row.
// Bound on this card: bytes, as the narrow pass; a block takes 87-227 KB
// of shared memory, so one runs on each SM.
template <int WK>
__device__ __forceinline__ int wide_div(int x, uint32_t inv) {
  if constexpr (WK > 0) {
    return (int)((unsigned)x / (unsigned)WK);
  } else {
    return divide(x, inv);
  }
}

// split's rule on A and B staged at `stride` words a row
template <int WK>
__device__ __forceinline__ int split_staged(const int64_t* a, int na,
                                            const int64_t* b, int nb,
                                            int diag, int stride, int wk) {
  int lo = diag > nb ? diag - nb : 0;
  int hi = diag < na ? diag : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_le<WK>(a + mid * stride, b + (diag - 1 - mid) * stride, wk)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A wide tile's window: row o of the output starts it; staged A's na
// rows then B's nb, row r of the stage at r stride words.
struct WideWin {
  int64_t o;
  int na, nb;
};

// Tile t of Src's pairs from its splits s0, s1, with its copies started
// into stage `st` (committed as one group). Rows need only 8-byte
// alignment: every copy is 8 bytes.
template <int WK, bool PAY, class Src>
__device__ __forceinline__ WideWin wide_start(const Src& src, int64_t t,
                                              int64_t s0, int64_t s1,
                                              int64_t* st, const WideShape& P,
                                              int W, int S, uint32_t inv) {
  const int64_t pair = t / src.steps();
  const int64_t d0 = (t - pair * src.steps()) * P.rows;
  const Pair p = src.of(pair, W);
  const int64_t d1 = d0 + P.rows < p.na + p.nb ? d0 + P.rows : p.na + p.nb;
  WideWin w;
  w.o = p.o + d0;
  w.na = (int)(s1 - s0);
  w.nb = d1 > d0 ? (int)(d1 - d0) - w.na : 0;
  // word e of the window is A's word e, then B's word e - na W
  const int words_a = w.na * W;
  const int64_t* ka = p.a + s0 * W;
  const int64_t* kb = p.b + (d0 - s0) * W;
  for (int e = threadIdx.x; e < (w.na + w.nb) * W; e += kThreads) {
    const int r = wide_div<WK>(e, inv);
    cp_async8(st + r * S + (e - r * W),
              e < words_a ? ka + e : kb + (e - words_a));
  }
  if constexpr (PAY) {
    int64_t* sp = st + P.rows * S;
    const int64_t* pa = p.pa + s0;
    const int64_t* pb = p.pb + (d0 - s0);
    for (int r = threadIdx.x; r < w.na + w.nb; r += kThreads) {
      cp_async8(sp + r, r < w.na ? pa + r : pb + (r - w.na));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return w;
}

// Merges the staged tile (each thread `items` outputs from its own split,
// recording each output's source row) and writes it out, 16 bytes a thread
// a store.
template <int WK, bool PAY>
__device__ __forceinline__ void wide_merge(const int64_t* st, const WideWin& w,
                                           int* s_src, int64_t* ok,
                                           int64_t* op, const WideShape& P,
                                           int W, int S, uint32_t inv) {
  const int na = w.na, nb = w.nb, n = na + nb;
  const int64_t* sa = st;
  const int64_t* sb = st + na * S;
  const int diag = min((int)threadIdx.x * P.items, n);
  int i = split_staged<WK>(sa, na, sb, nb, diag, S, W);
  int j = diag - i;
  const int end = min(diag + P.items, n);
  for (int p = diag; p < end; ++p) {
    const bool take_a =
        j >= nb || (i < na && row_le<WK>(sa + i * S, sb + j * S, W));
    s_src[p] = take_a ? i++ : na + j++;
  }
  __syncthreads();

  // the tile starts at an even row (tiles and pairs hold even row
  // counts) of a 16-byte aligned output, so its words at a 16-byte
  // boundary; with W odd a vector's second word may start the next row
  const int words = n * W;
  int64_t* out = ok + w.o * W;
  for (int c = threadIdx.x; 2 * c + 1 < words; c += kThreads) {
    const int p = wide_div<WK>(2 * c, inv);
    const int col = 2 * c - p * W;
    const int64_t* row = st + s_src[p] * S;
    const int64_t y = col + 1 < W ? row[col + 1] : st[s_src[p + 1] * S];
    reinterpret_cast<longlong2*>(out)[c] = make_longlong2(row[col], y);
  }
  if (words & 1 && threadIdx.x == 0) {
    out[words - 1] = st[s_src[n - 1] * S + W - 1];
  }
  if constexpr (PAY) {
    const int64_t* sp = st + P.rows * S;
    int64_t* po = op + w.o;
    for (int c = threadIdx.x; 2 * c + 1 < n; c += kThreads) {
      reinterpret_cast<longlong2*>(po)[c] =
          make_longlong2(sp[s_src[2 * c]], sp[s_src[2 * c + 1]]);
    }
    if (n & 1 && threadIdx.x == 0) po[n - 1] = sp[s_src[n - 1]];
  }
}

// pass_kernel's loop over the tiles of Src's pairs on the wide stages.
// WK: 8 or 13 at compile time, or 0, the width wk read at run time.
template <int WK, bool PAY, class Src>
__global__ void __launch_bounds__(kThreads, 1)
wide_pass_kernel(Src src, const int64_t* __restrict__ splits, int64_t tiles,
                 int64_t* __restrict__ ok, int64_t* __restrict__ op, int wk,
                 uint32_t inv, WideShape P) {
  const int W = width<WK>(wk);
  const int S = WK > 0 ? (WK | 1) : P.stride;
  extern __shared__ __align__(16) int64_t smem[];
  int* s_src = reinterpret_cast<int*>(smem + 2 * P.stage_words);
  const int64_t step = gridDim.x;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;
  // tile u's splits are entries e and e + 1, e = u + its pair
  auto splits_of = [&](int64_t u, int64_t& s0, int64_t& s1) {
    if (u < tiles) {
      const int64_t e = u + u / src.steps();
      s0 = splits[e];
      s1 = splits[e + 1];
    }
  };
  int64_t s0, s1, n0 = 0, n1 = 0;
  splits_of(t, s0, s1);
  WideWin w = wide_start<WK, PAY>(src, t, s0, s1, smem, P, W, S, inv);
  splits_of(t + step, n0, n1);
  for (int buf = 0;; buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // tile t is staged; every thread is done with the other stage
    __syncthreads();
    const int64_t next = t + step;
    WideWin wn;
    if (next < tiles) {
      wn = wide_start<WK, PAY>(src, next, n0, n1,
                               smem + (buf ^ 1) * P.stage_words, P, W, S,
                               inv);
      splits_of(next + step, n0, n1);
    }
    wide_merge<WK, PAY>(smem + buf * P.stage_words, w, s_src, ok, op, P, W,
                        S, inv);
    if (next >= tiles) break;
    t = next;
    w = wn;
  }
}

// -- launchers ----------------------------------------------------------------

// jf_merge_path's instances WK = 1 .. kNarrowCols (wider keys:
// wide_merge_path, below)
template <int WK>
int launch_merge(const void* ak, const void* ac, int64_t na, const void* bk,
                 const void* bc, int64_t nb, void* ok, void* oc,
                 cudaStream_t s) {
  const int64_t total = na + nb;
  if (total > 0) {
    const int64_t blocks = (total + Tile<WK>::kRows - 1) / Tile<WK>::kRows;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
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

// The wide partition pass's launch: `entries` splits of Src's pairs
template <class Src>
int launch_wide_splits(const Src& src, int64_t tile, int64_t entries,
                       void* splits, int wk, cudaStream_t s) {
  const int64_t blocks =
      (entries * kProbeLanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  wide_splits_kernel<Src><<<(unsigned)blocks, kThreads, 0, s>>>(
      src, tile, entries, (int64_t*)splits, wk);
  return (int)cudaGetLastError();
}

template <int WK>
int launch_splits(const void* keys, int64_t m, int64_t run, int64_t tile,
                  void* splits, int wk, cudaStream_t s) {
  if (m == 0) return (int)cudaGetLastError();
  int64_t pairs;
  const Pairs pr = pairs_of(m, run, tile, &pairs);
  const int64_t entries = pairs * (pr.steps + 1);
  if constexpr (WK == 0) {
    return launch_wide_splits(
        ArrayPairs{pr, (const int64_t*)keys, nullptr}, tile, entries,
        splits, wk, s);
  } else {
    const int64_t blocks = (entries + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    splits_kernel<WK><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)keys, pr, tile, entries, (int64_t*)splits, wk);
    return (int)cudaGetLastError();
  }
}

template <int WK, bool PAY>
int launch_tiles(const void* keys, const void* pay, int64_t m, int64_t run,
                 const void* splits, void* out_keys, void* out_pay, int wk,
                 cudaStream_t s) {
  const PassShape P = pass_shape(pass_rows(wk, PAY), wk, PAY);
  if (m == 0) return (int)cudaGetLastError();
  int64_t pairs;
  const Pairs pr = pairs_of(m, run, P.rows, &pairs);
  const int64_t tiles = pairs * pr.steps;
  auto kernel = pass_kernel<WK, PAY>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, P.bytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)grid, kThreads, P.bytes, s>>>(
      (const int64_t*)keys, (const int64_t*)pay, pr, (const int64_t*)splits,
      tiles, (int64_t*)out_keys, (int64_t*)out_pay, wk);
  return (int)cudaGetLastError();
}

template <int WK>
int launch_pass(const void* keys, const void* pay, int64_t m, int64_t run,
                int64_t tile, const void* splits, void* out_keys,
                void* out_pay, int wk, cudaStream_t s) {
  const int rows = pass_rows(wk, pay != nullptr);
  if (rows < 2 || tile != rows) return (int)cudaErrorInvalidValue;
  return pay ? launch_tiles<WK, true>(keys, pay, m, run, splits, out_keys,
                                      out_pay, wk, s)
             : launch_tiles<WK, false>(keys, nullptr, m, run, splits,
                                       out_keys, nullptr, wk, s);
}

// The wide tiles' launch: `tiles` tiles of Src's pairs, of P.rows rows,
// one persistent block on each SM (more where P's stages are small)
template <int WK, bool PAY, class Src>
int launch_wide_tiles(const Src& src, int64_t tiles, const WideShape& P,
                      const void* splits, void* out_keys, void* out_pay,
                      int wk, cudaStream_t s) {
  if (tiles == 0) return (int)cudaGetLastError();
  auto kernel = wide_pass_kernel<WK, PAY, Src>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, P.bytes);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = tiles < resident ? tiles : resident;
  kernel<<<(unsigned)grid, kThreads, P.bytes, s>>>(
      src, (const int64_t*)splits, tiles, (int64_t*)out_keys,
      (int64_t*)out_pay, wk, recip(wk), P);
  return (int)cudaGetLastError();
}

template <int WK, bool PAY>
int wide_pass_tiles(const void* keys, const void* pay, int64_t m,
                    int64_t run, const void* splits, void* out_keys,
                    void* out_pay, int wk, cudaStream_t s) {
  const WideShape P = wide_shape(pass_rows(wk, PAY), wk, PAY);
  if (m == 0) return (int)cudaGetLastError();
  int64_t pairs;
  const Pairs pr = pairs_of(m, run, P.rows, &pairs);
  return launch_wide_tiles<WK, PAY>(
      ArrayPairs{pr, (const int64_t*)keys, (const int64_t*)pay},
      pairs * pr.steps, P, splits, out_keys, out_pay, wk, s);
}

template <int WK>
int launch_wide_pass(const void* keys, const void* pay, int64_t m,
                     int64_t run, const void* splits, void* out_keys,
                     void* out_pay, int wk, cudaStream_t s) {
  return pay ? wide_pass_tiles<WK, true>(keys, pay, m, run, splits,
                                         out_keys, out_pay, wk, s)
             : wide_pass_tiles<WK, false>(keys, nullptr, m, run, splits,
                                          out_keys, nullptr, wk, s);
}

// the wide pass: its compile-time instances at Wk 8 and 13, else the
// width at run time
int wide_pass(const void* keys, const void* pay, int64_t m, int64_t run,
              int64_t tile, const void* splits, void* out_keys, void* out_pay,
              int wk, cudaStream_t s) {
  const int rows = pass_rows(wk, pay != nullptr);
  if (rows < 2 || tile != rows) return (int)cudaErrorInvalidValue;
  switch (wk) {
    case 8:
      return launch_wide_pass<8>(keys, pay, m, run, splits, out_keys,
                                 out_pay, wk, s);
    case 13:
      return launch_wide_pass<13>(keys, pay, m, run, splits, out_keys,
                                  out_pay, wk, s);
  }
  return launch_wide_pass<0>(keys, pay, m, run, splits, out_keys, out_pay,
                             wk, s);
}

// -- the wide merge_path -----------------------------------------------------

// jf_merge_path above kNarrowCols columns (k > 112): the wide pass's two
// kernels on the one pair of runs A and B (TwoRuns), the counts as the
// payload. The partition pass searches each tile boundary once, 14 of a
// warp's 16 between their neighbours' splits; the tiles run on persistent
// blocks, the next tile's copies in flight in the other stage while this
// one merges, rows at the odd stride wk | 1, and go out as 16-byte stores.
// Bound on this card: bytes, (wk + 1) 8 bytes a row read and written.
//
// Its tile is one row a thread (merge_rows), fewer rows where 256 do not
// fit: small stages let several blocks share an SM, one merging while
// another's copies and stores are in flight. At A 2^22 + B 2^22 rows
// (PERF.md, kernel_ab.py) this beat tiles of 3 rows a thread by 4% at Wk
// 13 and 23% at Wk 16, and lost 4% to them at Wk 8, where 5 rows a
// thread, the pass's tile, was 14% slower than one. A single launch, each
// block's first warp searching its own tile's two boundaries, took 1.8-
// 2.8x as long at that shape and 37% less at A 2^15 + B 2^15.

// The tile rows of a wide merge_path (kernels/merge_path.py
// merge_tile_rows): 256, or pass_rows' fewer where 256 do not fit.
int merge_rows(int wk) {
  const int top = pass_rows(wk, true);
  return top < kThreads ? top : kThreads;
}

template <int WK>
int launch_wide_merge(const TwoRuns& src, const WideShape& P, void* splits,
                      void* ok, void* oc, int wk, cudaStream_t s) {
  const int rc =
      launch_wide_splits(src, P.rows, src.tiles + 1, splits, wk, s);
  if (rc != cudaSuccess) return rc;
  return launch_wide_tiles<WK, true>(src, src.tiles, P, splits, ok, oc, wk,
                                     s);
}

int wide_merge_path(const void* ak, const void* ac, int64_t na,
                    const void* bk, const void* bc, int64_t nb, void* ok,
                    void* oc, int wk, int64_t tile, void* splits,
                    cudaStream_t s) {
  if (pass_rows(wk, true) < 2 || ((uintptr_t)ok | (uintptr_t)oc) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = na + nb;
  if (tile != merge_rows(wk)) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaGetLastError();
  const TwoRuns src{
      Pair{(const int64_t*)ak, (const int64_t*)bk, (const int64_t*)ac,
           (const int64_t*)bc, na, nb, 0},
      (total + tile - 1) / tile};
  const WideShape P = wide_shape((int)tile, wk, true);
  switch (wk) {
    case 8:
      return launch_wide_merge<8>(src, P, splits, ok, oc, wk, s);
    case 13:
      return launch_wide_merge<13>(src, P, splits, ok, oc, wk, s);
  }
  return launch_wide_merge<0>(src, P, splits, ok, oc, wk, s);
}

using MergeFn = int (*)(const void*, const void*, int64_t, const void*,
                        const void*, int64_t, void*, void*, cudaStream_t);
using SplitsFn = int (*)(const void*, int64_t, int64_t, int64_t, void*, int,
                         cudaStream_t);
using PassFn = int (*)(const void*, const void*, int64_t, int64_t, int64_t,
                       const void*, void*, void*, int, cudaStream_t);
// index wk for wk <= kNarrowCols, 0 (the wide kernels) above
constexpr MergeFn kMerge[] = {nullptr,         launch_merge<1>,
                              launch_merge<2>, launch_merge<3>,
                              launch_merge<4>, launch_merge<5>,
                              launch_merge<6>, launch_merge<7>};
constexpr SplitsFn kSplits[] = {launch_splits<0>, launch_splits<1>,
                                launch_splits<2>, launch_splits<3>,
                                launch_splits<4>, launch_splits<5>,
                                launch_splits<6>, launch_splits<7>};
constexpr PassFn kPass[] = {wide_pass,      launch_pass<1>, launch_pass<2>,
                            launch_pass<3>, launch_pass<4>, launch_pass<5>,
                            launch_pass<6>, launch_pass<7>};
static_assert(sizeof(kPass) / sizeof(kPass[0]) == kNarrowCols + 1);

int instance(int wk) { return wk <= kNarrowCols ? wk : 0; }

}  // namespace

// Key widths wk >= 1; above kNarrowCols (7) the wide kernels run, up to
// the width at which a jf_merge_pass tile still holds two rows
// (kernels/merge_path.py MAX_KEY_COLS). Above kNarrowCols, `tile` must be
// merge_rows(wk) (kernels/merge_path.py merge_tile_rows), `splits` must
// hold ceil((na + nb) / tile) + 1 int64 entries, and out_keys and out_cnt
// must be 16-byte aligned; up to kNarrowCols both are ignored.
extern "C" int jf_merge_path(const void* a_keys, const void* a_cnt, int64_t na,
                             const void* b_keys, const void* b_cnt, int64_t nb,
                             void* out_keys, void* out_cnt, int wk,
                             int64_t tile, void* splits, void* stream) {
  if (wk < 1 || na < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (wk > kNarrowCols) {
    return wide_merge_path(a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys,
                           out_cnt, wk, tile, splits, (cudaStream_t)stream);
  }
  return kMerge[wk](a_keys, a_cnt, na, b_keys, b_cnt, nb, out_keys, out_cnt,
                    (cudaStream_t)stream);
}

// The splits of a pass at tiles of `tile` rows into `splits`, pairs x
// (ceil(min(2 run, m) / tile) + 1) int64 entries (kernels/merge_path.py
// split_steps). run, tile >= 1.
extern "C" int jf_merge_splits(const void* keys, int64_t m, int64_t run,
                               int64_t tile, void* splits, int wk,
                               void* stream) {
  if (wk < 1 || run < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  return kSplits[instance(wk)](keys, m, run, tile, splits, wk,
                               (cudaStream_t)stream);
}

// The pass from jf_merge_splits' splits at `tile`, which must be the
// width's tile rows (kernels/merge_path.py pass_tile_rows). pay and
// out_pay NULL: keys only. out must not overlap the input; out_keys and
// out_pay 16-byte aligned.
extern "C" int jf_merge_pass(const void* keys, const void* pay, int64_t m,
                             int64_t run, int64_t tile, const void* splits,
                             void* out_keys, void* out_pay, int wk,
                             void* stream) {
  if (wk < 1 || run < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)out_keys | (uintptr_t)out_pay) & 15) {
    return (int)cudaErrorInvalidValue;
  }
  return kPass[instance(wk)](keys, pay, m, run, tile, splits, out_keys,
                             out_pay, wk, (cudaStream_t)stream);
}
