// K3: the bitonic sorting network on tiles of key rows.
//
// Replaces the Pallas bitonic kernels of experiments/:
//   - pallas_sort_proto.py:65 pallas_sort (sort_kernel: a whole-tile
//     bitonic sort);
//   - pallas_probe2.py:84 and :103 build_stages (compare-exchange steps on
//     one array, and on (hi, lo, count) triples compared on (hi, lo));
//   - pallas_stage_probe.py:75 build (the same steps after in-tile
//     [128, 128] transposes) and :112 flip (a tile reversed).
//
// Keys are [M, WK] int64 rows compared as csrc/rows.cuh says; an optional
// int64 payload [M] travels with its row. A step is ascending (of the
// two rows it meets, the lower position gets the smaller) unless said
// otherwise. Four entry points:
//
//   jf_block_sort sorts each tile of T = 2^log_t rows by the bitonic
//     network: phase k = 2, 4, ..., T runs steps at distances k/2, ...,
//     1. A payload is compared after the key, so a row-index payload
//     makes the order stable. The last tile is padded with INT64_MAX
//     rows, which sort last, and only its real rows are written. Above
//     7 columns (k > 112) a wide kernel (wide_sort_kernel, below) sorts
//     a proxy of each row (its top 47 bits and row number) in registers
//     and checks the ties on the proxy against the whole row.
//   jf_block_merge runs only the plain steps at distances T/2, ..., 1 on
//     each tile, comparing the key and carrying the payload (row 8's
//     rule): it sorts a tile that is a bitonic sequence, as the pair sort
//     of kernels/sort.py leaves each tile after its cross-tile steps. M is
//     whole tiles.
//   jf_exchange_tiles runs g consecutive halving steps, at distances d,
//     d/2, ..., s = d / 2^(g-1), the first plain or mirrored (row j of each
//     2d-row block meets row 2d - 1 - j: the Pallas flip and the exchange
//     after it in one step), in one read and one write of the array, the
//     input read through the transpose of each 128 x 128 block of
//     positions or not (an index map rather than a data pass). The steps
//     pair rows only within the strided tile of a residue j < s in each
//     2d-row block (its T = 2d / s rows j + i s), where they are
//     block_merge's steps at tile distances T/2, ..., 1 (stride_kernel,
//     below). A payload is carried, not compared.
//   jf_flip reverses each tile of 2^log_t rows (16-byte vectors; 8-byte
//     words at odd Wk above 1 or where a pointer is not 16-byte aligned).
//
// The tile entries (one kernel, tile_kernel). A block takes B = max(T,
// 32 E) rows (several tiles when T is small); each thread holds E rows
// in registers (E = 16 in the sort of rows of up to four columns, 8 in
// their merge, else 4). Every step
// pairs row i with row i ^ 2^b, so the sort's phases run the bitonic
// network with alternating directions (phase 2^k descending in the
// blocks whose bit k is set) instead of the mirrored step. A layout
// decides which rows a thread holds: in layout j, a thread's E registers
// hold E rows 2^j apart, so the steps at distances 2^j, ..., 2^(j +
// log E - 1) pair registers of one thread and run with no traffic and no
// barrier. Between groups of log E distances the registers move to the
// next layout through shared memory (write, a barrier, read): at the
// pair sort's shape (T = 4096, two columns) the full sort's 78 steps need
// 20 such moves (E = 16), where a design with every step in shared
// memory makes 78 passes, and the merge's 12 steps need 3 (E = 8).
// Shared memory holds the block's rows row-major, row r at
// r ^ ((r >> log E) & 15), so that the rows a warp touches in one access,
// in every layout, fall on distinct banks (a row of two columns moves as
// one 16-byte access). The device is read and written once, through
// shared memory, coalesced.
//
// The strided-tile pass (stride_kernel). The steps of a pass pair rows only
// within the strided tile of a residue j < s of each 2d-row block (rows j
// + i s, i < T = 2d / s), where they are block_merge's steps at tile
// distances T/2, ..., 1; a mirrored first step is one of them once the
// tile's upper half is held reversed, from residue s - 1 - j. A block
// holds whole tiles of residues side by side (4 at Wk 1-2, 2 at Wk 3, 1
// from Wk 4; where s is smaller, whole 2d-row blocks), so that its reads
// and writes fill 32-byte sectors (blocks of fewer residues measured up to
// twice as slow on the card), residue-minor, in registers, E rows a
// thread, in tile_kernel's layouts. Rows of one or two columns, and any
// rows read through the transpose, are read straight into the registers
// of the first steps' layout (or of the layout in which neighbouring
// threads hold neighbouring rows, where that touches fewer sectors: the
// caller's pick, kernels/bitonic.py stride_layouts; a tile read through
// the transpose, row 11's, is contiguous) and written from the last's;
// wider rows go through shared memory (`staged`), neighbouring threads on
// neighbouring words. A block holds at most 128 KB, so one pass runs up
// to 12 steps at Wk 1 (a tile of 4,096 rows, four residues) and 11 with a
// payload, where the fused passes it replaces ran 4 (3 above four
// columns) and took a transposed step alone; at 2^24 rows of Wk 1 it
// reads and writes the array once where they did 3 or 4 times. The caller
// cuts a longer run into passes of equal length (a 12-step run at 11 a
// pass is 6 + 6, not 11 + 1), and where the array is too small to give
// half the SMs a block of a long pass, into passes of blocks of at most
// 4,096 rows (row 7's probe: 6 + 6), since a lone block's dependent steps
// then take longer than two short passes.
// Such a block fills its SM's registers, so its reads, steps and writes
// take turns: the pass runs at half its bound (PERF.md). Splitting its
// tiles across a cluster of smaller blocks, the rows of its first steps
// swapped through the other blocks' shared memory, or a sector's residues
// across a cluster, each block writing the others' rows into their shared
// memory, measured slower.
//
// Bound on this card. The tile entries read and write each row of device
// memory once (the bytes bound), but the full sort is bound by its
// instructions: at T = 4096 each row meets another 78 times, and each
// meeting is a compare of two 64-bit columns and the selects of two rows
// on 32-bit units. Hence the design: no pair is compared twice (as it is
// when two threads trade rows by shuffles), compares carry no branches,
// and the layout moves, which cost shared-memory traffic and barriers,
// are few. The merge, with 12 steps, is closer to the bytes bound, and so
// is a strided-tile pass. jf_flip is bound by bytes. The
// counting store merges sorted tiles with K1 passes; the pair sort of
// kernels/sort.py (BitsArray's batch updates) runs its cross-tile steps on
// jf_exchange_tiles (the phase at run L: the mirrored step at L and the
// plain steps down to a tile, 2^24 rows in 1-2 passes where step by step
// took 1-12) and finishes each tile with jf_block_merge.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kFlipThreads = 256;
constexpr int64_t kPad = INT64_MAX;  // pad rows sort last
constexpr int kTileBytes = 96 * 1024;  // kernels/bitonic.py SHARED_TILE_BYTES

// A row as the kernels hold it: [payload,] key column 0 .. WK - 1, so that
// row_lt over columns [kLo, kCols) compares the key first and the payload
// (when CMP) last.
template <int WK, bool PAY, bool CMP>
struct Row {
  static constexpr int kCols = WK + (PAY ? 1 : 0);
  static constexpr int kLo = (PAY && !CMP) ? 1 : 0;
  // b strictly before a
  __device__ static __forceinline__ bool before(const int64_t* b,
                                                const int64_t* a) {
    return row_lt<kCols - kLo>(b + kLo, a + kLo);
  }
};

// -- tiles in registers -------------------------------------------------------

constexpr int log2_floor(int x) { return x < 2 ? 0 : 1 + log2_floor(x / 2); }

// The tile kernel's shape for rows of C int64 columns: E = 2^kLogE rows
// a thread (16 in the sort of rows of up to four columns; in their merge,
// whose 12 steps at T = 4096 run faster at twice the threads, 8).
template <int C, bool MERGE>
struct Shape {
  static constexpr int kLogE = C <= 4 ? (MERGE ? 3 : 4) : 2;
  static constexpr int kE = 1 << kLogE;
  static constexpr int kLogWarp = kLogE + 5;    // rows a warp
  // the largest tile: T rows of C columns in kTileBytes
  static constexpr int kLogMaxT = log2_floor(kTileBytes / (8 * C));
  static constexpr int kMaxThreads =
      1 << ((kLogMaxT > kLogWarp ? kLogMaxT : kLogWarp) - kLogE);
};

// Where row r of a block sits in shared memory: r with bits LOGE to
// LOGE + 3 folded into bits 0-3, so that the rows one access of a warp
// touches in any layout fall on distinct banks (distinct r mod 16 for
// 8-byte rows, r mod 8 for 16-byte rows).
template <int LOGE>
__device__ __forceinline__ int swizzled(int r) {
  return r ^ ((r >> LOGE) & 15);
}

// Layout j: register e of thread t holds row t's bits below j, then e's
// LOGE bits at j, then t's other bits: steps at distances 2^j ..
// 2^(j + LOGE - 1) pair registers of one thread.
template <int LOGE>
__device__ __forceinline__ int layout_base(int j) {
  const int t = threadIdx.x;
  return ((t >> j) << (j + LOGE)) | (t & ((1 << j) - 1));
}

template <int C, int LOGE>
__device__ __forceinline__ void put_row(int64_t* s, int r,
                                        const int64_t* x) {
  int64_t* p = s + swizzled<LOGE>(r) * C;
  if constexpr (C % 2 == 0) {
#pragma unroll
    for (int h = 0; h < C / 2; ++h) {
      reinterpret_cast<longlong2*>(p)[h] = make_longlong2(x[2 * h],
                                                          x[2 * h + 1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = x[c];
  }
}

template <int C, int LOGE>
__device__ __forceinline__ void get_row(int64_t* x, const int64_t* s,
                                        int r) {
  const int64_t* p = s + swizzled<LOGE>(r) * C;
  if constexpr (C % 2 == 0) {
#pragma unroll
    for (int h = 0; h < C / 2; ++h) {
      const longlong2 y = reinterpret_cast<const longlong2*>(p)[h];
      x[2 * h] = y.x;
      x[2 * h + 1] = y.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = p[c];
  }
}

// Registers from layout `from` to layout `to`, through shared memory.
template <int C, int E, int LOGE>
__device__ __forceinline__ void relayout(int64_t (&v)[E][C], int64_t* s,
                                         int from, int to) {
  __syncthreads();  // every thread has read the rows it last fetched
  int base = layout_base<LOGE>(from);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    put_row<C, LOGE>(s, base | (e << from), v[e]);
  }
  __syncthreads();
  base = layout_base<LOGE>(to);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    get_row<C, LOGE>(v[e], s, base | (e << to));
  }
}

// Rows a (the lower position) and b meet: ascending, the smaller goes to
// a; descending (desc), the larger. Rows that compare equal are equal in
// every column compared, so swapping them or not is the same.
template <class R>
__device__ __forceinline__ void cmp_swap(int64_t* a, int64_t* b, bool desc) {
  if (R::before(b, a) != desc) {
#pragma unroll
    for (int c = 0; c < R::kCols; ++c) {
      const int64_t x = a[c];
      a[c] = b[c];
      b[c] = x;
    }
  }
}

// In layout j, the steps at distances 2^top, ..., 2^j (top - j < LOGE):
// registers e and e + 2^i meet. dir >= 0: a step of the sort's phase that
// builds sorted runs of 2^dir rows, descending where the row's bit dir is
// set; else ascending.
template <class R, int E, int LOGE>
__device__ __forceinline__ void register_steps(int64_t (&v)[E][R::kCols],
                                               int j, int top, int dir) {
  // bit e of `down`: register e's row descends (its bit dir is set)
  int down = 0;
  if (dir >= 0) {
    const int base = layout_base<LOGE>(j);
    if (dir >= j + LOGE) {
      down = ((base >> dir) & 1) ? (1 << E) - 1 : 0;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) down |= ((e >> (dir - j)) & 1) << e;
    }
  }
#pragma unroll
  for (int i = LOGE - 1; i >= 0; --i) {
    if (i <= top - j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(e & (1 << i))) {
          cmp_swap<R>(v[e], v[e | (1 << i)], (down >> e) & 1);
        }
      }
    }
  }
}

// The steps at distances 2^top, 2^(top - 1), ... of one group (at most
// LOGE of them, down to 2^to) in layout `to`, the registers moved there
// from layout j first; j becomes `to` and top the group's next distance.
template <class R, int E, int LOGE>
__device__ __forceinline__ void step_group(int64_t (&v)[E][R::kCols],
                                           int64_t* s, int& j, int& top,
                                           int dir) {
  const int to = top >= LOGE ? top - LOGE + 1 : 0;
  if (to != j) {
    relayout<R::kCols, E, LOGE>(v, s, j, to);
    j = to;
  }
  register_steps<R, E, LOGE>(v, j, top, dir);
  top = j - 1;
}

// Plain steps at distances 2^top, ..., 1, a group at a time; j is the
// layout the registers are in, and is left at the last one (0).
template <class R, int E, int LOGE>
__device__ __forceinline__ void steps_down(int64_t (&v)[E][R::kCols],
                                           int64_t* s, int& j, int top,
                                           int dir) {
  while (top >= 0) step_group<R, E, LOGE>(v, s, j, top, dir);
}

// MERGE: jf_block_merge (plain ascending steps at distances T/2, ..., 1,
// the key compared, the payload carried); else jf_block_sort (the
// bitonic sort of each tile, phase 2^lk's steps descending in the
// 2^lk-row blocks whose bit lk is set, the last phase ascending; the
// payload compared after the key). One block a run of 2^log_b rows,
// 2^(log_b - LOGE) threads. LT >= 0: the merge at tiles of 2^LT rows, its
// steps unrolled at compile time (log_t is LT).
template <int WK, bool PAY, bool MERGE, int LT>
__global__ void __launch_bounds__((Shape<WK + PAY, MERGE>::kMaxThreads), 1)
tile_kernel(const int64_t* ik, const int64_t* ip, int64_t* ok, int64_t* op,
            int64_t m, int log_t_arg, int log_b) {
  const int log_t = LT >= 0 ? LT : log_t_arg;
  using R = Row<WK, PAY, !MERGE>;
  using S = Shape<WK + PAY, MERGE>;
  constexpr int C = R::kCols, E = S::kE, LOGE = S::kLogE;
  extern __shared__ __align__(16) int64_t s[];  // the block's rows
  const int rows = 1 << log_b;
  const int threads = rows >> LOGE;
  const int64_t base = (int64_t)blockIdx.x << log_b;
  const int n = (int)(m - base < rows ? m - base : rows);

  // device memory -> shared memory, coalesced; rows from n on are pad
  // rows
  for (int g = threadIdx.x; g < rows * WK; g += threads) {
    const int r = g / WK;
    s[swizzled<LOGE>(r) * C + PAY + (g - r * WK)] =
        r < n ? ik[base * WK + g] : kPad;
  }
  if constexpr (PAY) {
    for (int r = threadIdx.x; r < rows; r += threads) {
      s[swizzled<LOGE>(r) * C] = r < n ? ip[base + r] : kPad;
    }
  }
  // the layout of the first steps: the merge's first group of distances,
  // the sort's first phase (distance 1)
  int j = MERGE && log_t > LOGE ? log_t - LOGE : 0;
  __syncthreads();
  int64_t v[E][C];
  {
    const int b = layout_base<LOGE>(j);
#pragma unroll
    for (int e = 0; e < E; ++e) get_row<C, LOGE>(v[e], s, b | (e << j));
  }

  if constexpr (MERGE && LT >= 0) {
    int top = LT - 1;
#pragma unroll
    for (int g = 0; g < (LT + LOGE - 1) / LOGE; ++g) {
      step_group<R, E, LOGE>(v, s, j, top, -1);
    }
  } else if constexpr (MERGE) {
    steps_down<R, E, LOGE>(v, s, j, log_t - 1, -1);
  } else {
    for (int lk = 1; lk <= log_t; ++lk) {
      steps_down<R, E, LOGE>(v, s, j, lk - 1, lk < log_t ? lk : -1);
    }
  }

  __syncthreads();
  {
    const int b = layout_base<LOGE>(j);
#pragma unroll
    for (int e = 0; e < E; ++e) put_row<C, LOGE>(s, b | (e << j), v[e]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n * WK; g += threads) {
    const int r = g / WK;
    ok[base * WK + g] = s[swizzled<LOGE>(r) * C + PAY + (g - r * WK)];
  }
  if constexpr (PAY) {
    for (int r = threadIdx.x; r < n; r += threads) {
      op[base + r] = s[swizzled<LOGE>(r) * C];
    }
  }
}

// -- tiles of wide rows ------------------------------------------------------

// jf_block_sort above kNarrowCols columns (k > 112), where E rows a thread
// would not fit in registers: one block a tile of T = 2^log_t rows, staged
// once in shared memory at an odd row stride (wk | 1 words), so that the
// rows a warp reads at once fall on spread banks. The network does not
// compare rows. It sorts one int64 a row, the row's proxy above its row
// number, with tile_kernel's network on rows of one column (E = 8 a
// thread in registers, T / E threads, moved between layouts through an
// 8-byte slot a row). The proxy is a 47-bit summary of the row that never
// decreases along the full order (wide_proxy): the tile's top b bits, then
// the next 47 - b bits of the two columns below, b being what the tile's
// top column needs (wide_top_bits). Rows that tie on it come out in
// row-number order; one pass over the sorted tile then checks each
// adjacent pair that ties on the proxy against the full order (the lower
// columns, then the payload). A tile whose pairs all hold is sorted: the
// PAD rows and repeated mers of a count, equal in every column, cost one
// such check each instead of a walk over every column at each of the
// network's 66 steps (T = 2048), and distinct mers of any k share 47
// bits rarely. A tile with a pair out of order (rows that tie on the
// proxy and differ below it, in the wrong order, or equal keys whose
// payloads are out of order) runs the network again on its slots, on
// every thread of the block, one a pair (wide_full_network): a compare
// orders two slots by their proxies and reads the rows only when the
// proxies tie. Tiles below 32 E rows (keys of some 110 columns or more)
// take that network alone, every proxy 0. The rows go out once, in the
// final order. Row numbers from n on stand for the last tile's pad rows,
// which sort after every real row.
//
// Bound on this card: bytes, 2 (wk + payload) 8 bytes a row. A block, with
// its tile of up to 227 KB, holds its SM alone, so its copies do not
// overlap another tile's network: the copies in and out alone take about
// 1.1 times the bound, and the network (66 steps of E / 2 compares a
// thread at T = 2048, 26 layout moves) comes on top.
constexpr int kWideLogE = 3;
constexpr int kWideE = 1 << kWideLogE;
constexpr int kWideThreads = 1024;

__host__ __device__ inline int wide_stride(int wk) { return wk | 1; }

// the tile's rows at the odd stride, the payload, and an 8-byte slot a
// row for the proxies the layouts move
__host__ __device__ inline size_t wide_tile_bytes(int wk, bool pay,
                                                  int log_t) {
  return ((size_t)(wide_stride(wk) + (pay ? 1 : 0) + 1) * 8) << log_t;
}

// threads of a wide tile: one a pair of rows (the whole-row network's), at
// least a warp, at most kWideThreads; the proxy network runs on the first
// T / E of them
__host__ __device__ inline int wide_threads(int log_t) {
  const int half = (1 << log_t) / 2;
  return half < 32 ? 32 : half > kWideThreads ? kWideThreads : half;
}

// A slot packs a proxy of 47 bits above its 16-bit row number; pad rows
// take kProxyTop, and sort after every real row by their numbers.
constexpr int kProxyBits = 16;
constexpr int64_t kProxyTop = ((int64_t)1 << (63 - kProxyBits)) - 1;
constexpr int64_t kRowMask = (1 << kProxyBits) - 1;
constexpr int64_t kLimb = 0xffffffffLL;

// The staged tile as the wide kernel reads it: row r at s + r rs, its
// payload at pay[r], position p's slot (proxy, row number) at
// slot[swizzled(p)].
template <bool PAY>
struct WideTile {
  const int64_t* s;
  const int64_t* pay;
  int64_t* slot;
  int rs, wk, n;

  __device__ __forceinline__ int64_t& at(int p) const {
    return slot[swizzled<kWideLogE>(p)];
  }
  __device__ __forceinline__ int64_t top(int r) const {
    return s[r * rs + wk - 1];
  }
  // row a strictly before row b in the full order: the key from the last
  // column down, then the payload; pad rows last
  __device__ __forceinline__ bool before(int a, int b) const {
    if (a >= n) return false;
    if (b >= n) return true;
    const int64_t* x = s + a * rs;
    const int64_t* y = s + b * rs;
    for (int w = wk - 1; w >= 0; --w) {
      if (x[w] != y[w]) return x[w] < y[w];
    }
    return PAY && pay[a] < pay[b];
  }
  // slot x strictly before slot y: the proxies, then, when they tie, the
  // rows (the same order, as a proxy never decreases along it)
  __device__ __forceinline__ bool slot_before(int64_t x, int64_t y) const {
    if ((x >> kProxyBits) != (y >> kProxyBits)) return x < y;
    return before((int)(x & kRowMask), (int)(y & kRowMask));
  }
};

// The largest of x over the block, through *cell (INT64_MIN beforehand);
// every thread arrives.
__device__ __forceinline__ int64_t block_max(int64_t x, int64_t* cell) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(reinterpret_cast<long long*>(cell), (long long)x);
  }
  __syncthreads();
  return *cell;
}

// b, the bits the proxy gives the top column: the bit length of the second
// largest of the real rows' top columns (the largest when they all tie),
// at most 47. In a count the largest is the PAD row's all-ones limb, and
// the second the largest real top column, which holds 2k - 32 (wk - 1)
// bits. A choice for speed only: any b leaves the proxy order-preserving.
// Uses slot[0] and slot[1] as scratch; every thread arrives.
template <bool PAY>
__device__ int wide_top_bits(const WideTile<PAY>& t) {
  int64_t hi = INT64_MIN;
  for (int r = threadIdx.x; r < t.n; r += blockDim.x) {
    hi = t.top(r) > hi ? t.top(r) : hi;
  }
  hi = block_max(hi, t.slot);
  int64_t next = INT64_MIN;
  for (int r = threadIdx.x; r < t.n; r += blockDim.x) {
    const int64_t x = t.top(r);
    next = x < hi && x > next ? x : next;
  }
  next = block_max(next, t.slot + 1);
  const int64_t v = next == INT64_MIN ? hi : next;
  const int b = v <= 0 ? 0 : 64 - __clzll(v);
  return b < 47 ? b : 47;
}

// Row r's proxy: 0 below a top column of 0; kProxyTop from a top column
// of 2^b up (and for the pad rows from n on); else the top column's b
// bits above the next 47 - b bits of the two columns below, each read as
// a 32-bit limb (a column below 0 reads as zeros from there down, one
// above 2^32 - 1 as ones). Every map here keeps the order, so the proxy
// never decreases along the full order, whatever the columns hold.
template <bool PAY>
__device__ __forceinline__ int64_t wide_proxy(const WideTile<PAY>& t, int r,
                                              int b) {
  if (r >= t.n) return kProxyTop;
  const int64_t* x = t.s + r * t.rs + t.wk;
  const int64_t top = x[-1];
  if (top < 0) return 0;
  if ((top >> b) != 0) return kProxyTop;
  const int64_t c2 = x[-2], c3 = x[-3];
  uint64_t low;
  if (c2 < 0) {
    low = 0;
  } else if (c2 > kLimb) {
    low = ~(uint64_t)0;
  } else {
    low = ((uint64_t)c2 << 32) |
          (uint64_t)(c3 < 0 ? 0 : c3 > kLimb ? kLimb : c3);
  }
  const int sh = 47 - b;
  return (top << sh) | (sh ? (int64_t)(low >> (64 - sh)) : 0);
}

// the T / E threads of the proxy network meet at barrier 1 without the
// rest of the block
__device__ __forceinline__ void network_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The bitonic network of tile_kernel's sort on the tile's slots (a
// proxy above a row number, one int64 each), run by threads 0 .. T / E - 1
// and moved between layouts through the slots: leaves position p's slot
// in t.at(p).
template <bool PAY>
__device__ __forceinline__ void proxy_network(const WideTile<PAY>& t,
                                              int log_t, int b) {
  using R = Row<1, false, true>;
  const int threads = 1 << (log_t - kWideLogE);
  int64_t v[kWideE][1];
  int j = 0;
  int base = layout_base<kWideLogE>(j);
#pragma unroll
  for (int e = 0; e < kWideE; ++e) {
    const int r = base | e;
    v[e][0] = (wide_proxy<PAY>(t, r, b) << kProxyBits) | r;
  }
  for (int lk = 1; lk <= log_t; ++lk) {
    const int dir = lk < log_t ? lk : -1;
    for (int top = lk - 1; top >= 0; top = j - 1) {
      const int to = top >= kWideLogE ? top - kWideLogE + 1 : 0;
      if (to != j) {  // tile_kernel's relayout, on this barrier
        network_sync(threads);
#pragma unroll
        for (int e = 0; e < kWideE; ++e) t.at(base | (e << j)) = v[e][0];
        network_sync(threads);
        j = to;
        base = layout_base<kWideLogE>(j);
#pragma unroll
        for (int e = 0; e < kWideE; ++e) v[e][0] = t.at(base | (e << j));
      }
      register_steps<R, kWideE, kWideLogE>(v, j, top, dir);
    }
  }
  network_sync(threads);
#pragma unroll
  for (int e = 0; e < kWideE; ++e) t.at(base | (e << j)) = v[e][0];
}

// The bitonic network on the slots by slot_before, one thread a pair each
// step.
template <bool PAY>
__device__ void wide_full_network(const WideTile<PAY>& t, int log_t) {
  const int t_rows = 1 << log_t;
  for (int k = 2; k <= t_rows; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < t_rows / 2; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int64_t a = t.at(i), b = t.at(i + j);
        // ascending in the k-row blocks whose bit k is clear
        if ((i & k) ? t.slot_before(a, b) : t.slot_before(b, a)) {
          t.at(i) = b;
          t.at(i + j) = a;
        }
      }
      __syncthreads();
    }
  }
}

template <bool PAY>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_sort_kernel(const int64_t* __restrict__ ik,
                 const int64_t* __restrict__ ip, int64_t* __restrict__ ok,
                 int64_t* __restrict__ op, int64_t m, int wk, uint32_t wk_inv,
                 int log_t) {
  extern __shared__ __align__(16) int64_t s[];
  const int t_rows = 1 << log_t;
  const int rs = wide_stride(wk);
  int64_t* s_pay = s + (size_t)rs * t_rows;
  const int64_t base = (int64_t)blockIdx.x << log_t;
  const int n = (int)(m - base < t_rows ? m - base : t_rows);
  const WideTile<PAY> t{s, s_pay, s_pay + (PAY ? t_rows : 0), rs, wk, n};
  const bool proxied = t_rows >= 32 * kWideE;

  // word e of the tile is column e mod wk of row e / wk
  const int64_t* src = ik + base * wk;
  for (int e = threadIdx.x; e < n * wk; e += blockDim.x) {
    const int r = divide(e, wk_inv);
    cp_async8(s + r * rs + (e - r * wk), src + e);
  }
  if constexpr (PAY) {
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      cp_async8(s_pay + r, ip + base + r);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (proxied && threadIdx.x < 2) t.slot[threadIdx.x] = INT64_MIN;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (proxied) {
    const int b = wide_top_bits<PAY>(t);
    if (threadIdx.x < t_rows >> kWideLogE) proxy_network<PAY>(t, log_t, b);
  } else {
    for (int p = threadIdx.x; p < t_rows; p += blockDim.x) t.at(p) = p;
  }
  __syncthreads();
  // a pair out of order among the real rows (pads follow them all)
  bool unsorted = !proxied;
  if (proxied) {
    for (int p = threadIdx.x + 1; p < n; p += blockDim.x) {
      if (t.slot_before(t.at(p), t.at(p - 1))) unsorted = true;
    }
  }
  if (__syncthreads_or(unsorted)) wide_full_network<PAY>(t, log_t);

  int64_t* dst = ok + base * wk;
  for (int e = threadIdx.x; e < n * wk; e += blockDim.x) {
    const int p = divide(e, wk_inv);
    dst[e] = s[(t.at(p) & kRowMask) * rs + (e - p * wk)];
  }
  if constexpr (PAY) {
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      op[base + p] = s_pay[t.at(p) & kRowMask];
    }
  }
}

// -- rows in device memory ---------------------------------------------------

// position x as read through the transpose of its 128 x 128 block
__device__ __forceinline__ int64_t transposed(int64_t x) {
  return (x & ~(int64_t)16383) | ((x & 127) << 7) | ((x >> 7) & 127);
}

template <class R, int WK>
__device__ __forceinline__ void load_row(int64_t* r, const int64_t* k,
                                         const int64_t* p, int64_t x) {
  if constexpr (R::kCols > WK) r[0] = p[x];
#pragma unroll
  for (int w = 0; w < WK; ++w) r[R::kCols - WK + w] = k[x * WK + w];
}

template <class R, int WK>
__device__ __forceinline__ void store_row(int64_t* k, int64_t* p, int64_t x,
                                          const int64_t* r) {
  if constexpr (R::kCols > WK) p[x] = r[0];
#pragma unroll
  for (int w = 0; w < WK; ++w) k[x * WK + w] = r[R::kCols - WK + w];
}

// -- strided tiles in registers ----------------------------------------------

// A block of the strided-tile pass holds at most kStrideBytes of rows (the
// rows its registers hold while the steps run), in 2^kLogE rows a thread
// (16 at one column, 8 at 2-4, else 4) and at most kStrideThreads threads.
constexpr int kStrideBytes = 128 * 1024;  // kernels/bitonic.py STRIDE_BYTES
constexpr int kStrideThreads = 1024;

template <int C>
struct StrideShape {
  static constexpr int kLogE = C > 4 ? 2 : C == 1 ? 4 : 3;
  static constexpr int kE = 1 << kLogE;
  static constexpr int kLogWarp = kLogE + 5;  // rows a warp
  static constexpr int kLogBytes = log2_floor(kStrideBytes / (8 * C));
  static constexpr int kLogThreads = log2_floor(kStrideThreads);
  // the largest block, in rows
  static constexpr int kLogMaxB = kLogBytes < kLogThreads + kLogE
                                      ? kLogBytes
                                      : kLogThreads + kLogE;
  static constexpr int kMaxThreads = 1 << (kLogMaxB - kLogE);
};

// The rows of one strided-tile pass (steps at d = s T/2, ..., s, T =
// 2^log_t) and where a block of 2^log_b rows finds them. Tile q (the
// block's first tile is blockIdx 2^(log_b - log_t)) is residue j = q mod s
// of the 2d-row block q / s, its row i at x_v = blk + j + i s. The block
// holds its tiles residue-minor, in x_v order: bits [0, a_lo) of a block
// row r (a_lo = min(log_b - log_t, log_s)) are the tile's low bits, bits
// [a_lo, a_lo + log_t) its row i, the rest the tile's other bits, so that
// the steps are at bits a_lo + log_t - 1, ..., a_lo of r and x_v is the
// block's first row plus r with those fields moved to their places. A
// mirrored pass holds the upper half of each tile reversed, from residue s
// - 1 - j: tile row T/2 + i' is x = x_v ^ (d - 1) = blk + 2d - 1 - (j + i'
// s), so that the mirrored step is a plain one at tile distance T/2 and
// the upper half's steps after it descend. A transposed read takes row x
// from transposed(x). The caller gives the layouts the rows are read in and
// written from (kernels/bitonic.py stride_layouts), and the host the x_v
// offset of each of their registers (xv_in, xv_out).
struct StrideMap {
  int64_t m;
  int log_s, log_t, log_b, transpose;
  int staged;       // read and write through shared memory, by words
  int j_in, j_out;  // the layouts of the read and of the write
  int64_t xv_in[16], xv_out[16];

  // x_v of block row r less that of the block's row 0
  __host__ __device__ __forceinline__ int64_t offset(int r) const {
    const int a_lo = log_b - log_t < log_s ? log_b - log_t : log_s;
    const int64_t lo = r & ((1 << a_lo) - 1);
    const int64_t i = (r >> a_lo) & ((1 << log_t) - 1);
    const int64_t hi = r >> (a_lo + log_t);
    return lo + (i << log_s) + (hi << (log_s + log_t));
  }
  // x_v of this block's row r
  __device__ __forceinline__ int64_t place(int r) const {
    const int64_t q0 = (int64_t)blockIdx.x << (log_b - log_t);
    return ((q0 >> log_s) << (log_s + log_t)) +
           (q0 & (((int64_t)1 << log_s) - 1)) + offset(r);
  }
  // the device row of x_v (before the transpose)
  template <bool MIRROR>
  __device__ __forceinline__ int64_t pos(int64_t xv) const {
    const int log_d = log_s + log_t - 1;
    return MIRROR && ((xv >> log_d) & 1) ? xv ^ (((int64_t)1 << log_d) - 1)
                                         : xv;
  }
};

// Rows a (the lower position) and b meet with the payload carried:
// ascending, b goes first only when strictly before a; descending (desc),
// a goes last only when strictly before b. Equal keys stay, as in
// exchange_stages_plain.
template <class R, bool DESC>
__device__ __forceinline__ void carry_swap(int64_t* a, int64_t* b,
                                           bool desc) {
  if (DESC && desc ? R::before(a, b) : R::before(b, a)) {
#pragma unroll
    for (int c = 0; c < R::kCols; ++c) {
      const int64_t x = a[c];
      a[c] = b[c];
      b[c] = x;
    }
  }
}

// In layout j, the steps at bits top, ..., lo of the block row (j <= lo <=
// top < j + LOGE): registers e and e + 2^(b - j) meet; with DESC,
// descending where the row's bit dir (>= top) is set.
template <class R, int E, int LOGE, bool DESC>
__device__ __forceinline__ void carry_steps(int64_t (&v)[E][R::kCols], int j,
                                            int top, int lo, int dir) {
  int down = 0;  // bit e: register e's row descends
  if constexpr (DESC) {
    if (dir >= j + LOGE) {
      down = ((layout_base<LOGE>(j) >> dir) & 1) ? (1 << E) - 1 : 0;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) down |= ((e >> (dir - j)) & 1) << e;
    }
  }
#pragma unroll
  for (int i = LOGE - 1; i >= 0; --i) {
    if (i <= top - j && i >= lo - j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!(e & (1 << i))) {
          carry_swap<R, DESC>(v[e], v[e | (1 << i)], (down >> e) & 1);
        }
      }
    }
  }
}

// The steps at distances s 2^(log_t - 1), ..., s in one read and one
// write of the block's rows, in registers: each thread reads its E rows
// of layout j_in from device memory (pad rows past m), the registers move
// between layouts through shared memory as tile_kernel's do, a group of
// up to log E steps in each, and each thread writes its rows of layout
// j_out (the caller's pick between the first, or last, steps' layout and
// the one in which neighbouring threads hold neighbouring block rows).
// Rows of several columns (`staged`) go through shared memory instead,
// neighbouring threads on neighbouring words, as tile_kernel's do. In
// place when ik is ok and the read is not transposed: a block reads and
// writes only its own rows.
template <int WK, bool PAY, bool MIRROR>
__global__ void __launch_bounds__(StrideShape<WK + PAY>::kMaxThreads, 1)
stride_kernel(const int64_t* ik, const int64_t* ip, int64_t* ok, int64_t* op,
              const StrideMap map) {
  using R = Row<WK, PAY, false>;
  using S = StrideShape<WK + PAY>;
  constexpr int C = R::kCols, E = S::kE, LOGE = S::kLogE;
  extern __shared__ __align__(16) int64_t s[];  // the layout moves
  const int a_lo = min(map.log_b - map.log_t, map.log_s);
  const int jmax = map.log_b - LOGE;
  const int rows = 1 << map.log_b, threads = rows >> LOGE;

  int64_t v[E][C];
  int j = map.j_in;
  if (map.staged) {
    for (int g = threadIdx.x; g < rows * WK; g += threads) {
      const int r = g / WK, w = g - r * WK;
      const int64_t xv = map.place(r);
      int64_t* dst = s + swizzled<LOGE>(r) * C + PAY + w;
      if (xv >= map.m) {
        *dst = kPad;
      } else {
        cp_async8(dst, ik + map.pos<MIRROR>(xv) * WK + w);
      }
    }
    if constexpr (PAY) {
      for (int r = threadIdx.x; r < rows; r += threads) {
        const int64_t xv = map.place(r);
        int64_t* dst = s + swizzled<LOGE>(r) * C;
        if (xv >= map.m) {
          *dst = kPad;
        } else {
          cp_async8(dst, ip + map.pos<MIRROR>(xv));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const int b = layout_base<LOGE>(j);
#pragma unroll
    for (int e = 0; e < E; ++e) get_row<C, LOGE>(v[e], s, b | (e << j));
  } else {
    const int64_t x0 = map.place(layout_base<LOGE>(j));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t xv = x0 + map.xv_in[e];
      if (xv >= map.m) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[e][c] = kPad;
        continue;
      }
      int64_t x = map.pos<MIRROR>(xv);
      if (map.transpose) x = transposed(x);
      load_row<R, WK>(v[e], ik, ip, x);
    }
  }
  int top = a_lo + map.log_t - 1;  // the bit of the next step
  const int dir = top;  // a mirrored pass's upper halves descend
  while (top >= a_lo) {
    const int to = min(max(top - LOGE + 1, a_lo), jmax);
    if (to != j) {
      relayout<C, E, LOGE>(v, s, j, to);
      j = to;
    }
    const int lo = max(j, a_lo);
    carry_steps<R, E, LOGE, MIRROR>(v, j, top, lo, dir);
    top = lo - 1;
  }
  if (map.staged) {
    __syncthreads();
    const int b = layout_base<LOGE>(j);
#pragma unroll
    for (int e = 0; e < E; ++e) put_row<C, LOGE>(s, b | (e << j), v[e]);
    __syncthreads();
    for (int g = threadIdx.x; g < rows * WK; g += threads) {
      const int r = g / WK, w = g - r * WK;
      const int64_t xv = map.place(r);
      if (xv < map.m) {
        ok[map.pos<MIRROR>(xv) * WK + w] = s[swizzled<LOGE>(r) * C + PAY + w];
      }
    }
    if constexpr (PAY) {
      for (int r = threadIdx.x; r < rows; r += threads) {
        const int64_t xv = map.place(r);
        if (xv < map.m) op[map.pos<MIRROR>(xv)] = s[swizzled<LOGE>(r) * C];
      }
    }
    return;
  }
  if (j != map.j_out) relayout<C, E, LOGE>(v, s, j, map.j_out);
  const int64_t x0 = map.place(layout_base<LOGE>(map.j_out));
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int64_t xv = x0 + map.xv_out[e];
    if (xv < map.m) store_row<R, WK>(ok, op, map.pos<MIRROR>(xv), v[e]);
  }
}

// -- the flip -------------------------------------------------------------------

// Each tile of 2^log_t rows reversed, a thread a unit of the output,
// neighbouring threads on neighbouring units: with VEC a 16-byte vector
// (at WK 1 rows p, p + 1 (p even) of a tile, read as the vector of rows
// T - 2 - p, T - 1 - p with its halves swapped; at even WK a row's
// vectors move whole), else an 8-byte word (odd WK above 1, or an input
// or output not 16-byte aligned). Two to eight vectors a thread measured
// no faster.
template <int WK, bool VEC>
__global__ void __launch_bounds__(kFlipThreads)
flip_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
            int64_t m, int log_t) {
  constexpr int kRowUnits = !VEC ? WK : WK == 1 ? 1 : WK / 2;  // units a row
  const int64_t t_mask = ((int64_t)1 << log_t) - 1;
  const int64_t e = (int64_t)blockIdx.x * kFlipThreads + threadIdx.x;
  if (e >= (VEC ? m * WK / 2 : m * WK)) return;
  if constexpr (VEC && WK == 1) {
    const int64_t p = 2 * e;  // rows p, p + 1 <- T - 2 - p, T - 1 - p
    const longlong2 y = reinterpret_cast<const longlong2*>(
        in)[((p & ~t_mask) | (t_mask - 1 - (p & t_mask))) / 2];
    reinterpret_cast<longlong2*>(out)[e] = make_longlong2(y.y, y.x);
  } else {
    const int64_t r = e / kRowUnits, h = e - r * kRowUnits;
    const int64_t src = ((r & ~t_mask) | (t_mask - (r & t_mask))) *
                            kRowUnits + h;
    if constexpr (VEC) {
      reinterpret_cast<longlong2*>(out)[e] =
          reinterpret_cast<const longlong2*>(in)[src];
    } else {
      out[e] = in[src];
    }
  }
}

// -- launchers ----------------------------------------------------------------

template <int WK, bool PAY, bool MERGE>
int launch_tiles(const void* keys, const void* pay, void* out_keys,
                 void* out_pay, int64_t m, int log_t, cudaStream_t s) {
  using S = Shape<WK + PAY, MERGE>;
  if (log_t > S::kLogMaxT) return (int)cudaErrorInvalidValue;
  if (MERGE && (m & ((1 << log_t) - 1))) return (int)cudaErrorInvalidValue;
  const int log_b = log_t > S::kLogWarp ? log_t : S::kLogWarp;
  const size_t bytes = (((size_t)WK + PAY) << log_b) * sizeof(int64_t);
  // the merge at the largest tile (the pair sort's) has its own instance
  auto kernel = MERGE && log_t == S::kLogMaxT
                    ? tile_kernel<WK, PAY, MERGE, MERGE ? S::kLogMaxT : -1>
                    : tile_kernel<WK, PAY, MERGE, -1>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (m + ((int64_t)1 << log_b) - 1) >> log_b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, 1u << (log_b - S::kLogE), bytes, s>>>(
        (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
        (int64_t*)out_pay, m, log_t, log_b);
  }
  return (int)cudaGetLastError();
}

template <int WK, bool MERGE>
int tiles_wk(const void* keys, const void* pay, void* out_keys,
             void* out_pay, int64_t m, int log_t, cudaStream_t s) {
  return pay ? launch_tiles<WK, true, MERGE>(keys, pay, out_keys, out_pay, m,
                                             log_t, s)
             : launch_tiles<WK, false, MERGE>(keys, pay, out_keys, out_pay,
                                              m, log_t, s);
}

template <int WK, bool PAY>
int launch_stride(const void* keys, const void* pay, void* out_keys,
                  void* out_pay, int64_t m, int log_s, int g, int mirror,
                  int transpose, int log_b, int staged, int j_in,
                  int j_out, cudaStream_t s) {
  using S = StrideShape<WK + PAY>;
  const int jmax = log_b - S::kLogE;
  if (log_b < S::kLogWarp || log_b > S::kLogMaxB || g > log_b ||
      (staged && transpose) || j_in < 0 || j_in > jmax || j_out < 0 ||
      j_out > jmax) {
    return (int)cudaErrorInvalidValue;
  }
  StrideMap map{};
  map.m = m;
  map.log_s = log_s;
  map.log_t = g;
  map.log_b = log_b;
  map.transpose = transpose;
  map.staged = staged;
  map.j_in = j_in;
  map.j_out = j_out;
  for (int e = 0; e < S::kE; ++e) {
    map.xv_in[e] = map.offset(e << j_in);
    map.xv_out[e] = map.offset(e << j_out);
  }
  const size_t bytes = ((size_t)(WK + PAY) << log_b) * sizeof(int64_t);
  auto kernel = mirror ? stride_kernel<WK, PAY, true>
                       : stride_kernel<WK, PAY, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  // blocks of whole 2d-row blocks (a tile a residue of each) or of 2^a
  // residues of one
  const int64_t blocks = (m + ((int64_t)1 << log_b) - 1) >> log_b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, 1u << (log_b - S::kLogE), bytes, s>>>(
        (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
        (int64_t*)out_pay, map);
  }
  return (int)cudaGetLastError();
}

template <int WK>
int stride_wk(const void* keys, const void* pay, void* out_keys,
              void* out_pay, int64_t m, int log_s, int g, int mirror,
              int transpose, int log_b, int staged, int j_in, int j_out,
              cudaStream_t s) {
  return pay ? launch_stride<WK, true>(keys, pay, out_keys, out_pay, m,
                                       log_s, g, mirror, transpose, log_b,
                                       staged, j_in, j_out, s)
             : launch_stride<WK, false>(keys, pay, out_keys, out_pay, m,
                                        log_s, g, mirror, transpose, log_b,
                                        staged, j_in, j_out, s);
}

template <int WK>
int flip_wk(const void* keys, void* out_keys, int64_t m, int log_t,
            cudaStream_t s) {
  const bool vec = (WK == 1 || WK % 2 == 0) &&
                   (((uintptr_t)keys | (uintptr_t)out_keys) & 15) == 0;
  const int64_t units = vec ? m * WK / 2 : m * WK;
  const int64_t blocks = (units + kFlipThreads - 1) / kFlipThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    auto kernel = vec ? flip_kernel<WK, WK == 1 || WK % 2 == 0>
                      : flip_kernel<WK, false>;
    kernel<<<(unsigned)blocks, kFlipThreads, 0, s>>>(
        (const int64_t*)keys, (int64_t*)out_keys, m, log_t);
  }
  return (int)cudaGetLastError();
}

int launch_wide_sort(const void* keys, const void* pay, void* out_keys,
                     void* out_pay, int64_t m, int wk, int log_t,
                     cudaStream_t s) {
  const size_t bytes = wide_tile_bytes(wk, pay != nullptr, log_t);
  if (bytes > (size_t)kSharedBytes ||
      ((1 << log_t) >> kWideLogE) > kWideThreads) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = pay ? wide_sort_kernel<true> : wide_sort_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (m + ((int64_t)1 << log_t) - 1) >> log_t;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, wide_threads(log_t), bytes, s>>>(
        (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
        (int64_t*)out_pay, m, wk, recip(wk), log_t);
  }
  return (int)cudaGetLastError();
}

using TileFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                       cudaStream_t);
using StrideFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                         int, int, int, int, int, int, int, cudaStream_t);
using FlipFn = int (*)(const void*, void*, int64_t, int, cudaStream_t);
constexpr TileFn kSort[] = {
    nullptr,           tiles_wk<1, false>, tiles_wk<2, false>,
    tiles_wk<3, false>, tiles_wk<4, false>, tiles_wk<5, false>,
    tiles_wk<6, false>, tiles_wk<7, false>};
constexpr TileFn kMerge[] = {
    nullptr,          tiles_wk<1, true>, tiles_wk<2, true>,
    tiles_wk<3, true>, tiles_wk<4, true>, tiles_wk<5, true>,
    tiles_wk<6, true>, tiles_wk<7, true>};
constexpr StrideFn kStride[] = {
    nullptr,      stride_wk<1>, stride_wk<2>, stride_wk<3>,
    stride_wk<4>, stride_wk<5>, stride_wk<6>, stride_wk<7>};
constexpr FlipFn kFlipWk[] = {nullptr,    flip_wk<1>, flip_wk<2>, flip_wk<3>,
                              flip_wk<4>, flip_wk<5>, flip_wk<6>, flip_wk<7>};

}  // namespace

// Sort each tile of 2^log_t rows; the tile, (wk + payload) * 8 bytes a
// row, must fit in 96 KiB up to 7 columns; above (any width), at the
// wide kernel's row stride with a slot a row (wide_tile_bytes), in 227 KB
// (kernels/bitonic.py tile_rows). pay and out_pay NULL: keys only; a
// payload is compared after the key.
extern "C" int jf_block_sort(const void* keys, const void* pay,
                             void* out_keys, void* out_pay, int64_t m, int wk,
                             int log_t, void* stream) {
  if (wk < 1 || log_t < 0 || log_t > 16) return (int)cudaErrorInvalidValue;
  if (wk > kNarrowCols) {
    return launch_wide_sort(keys, pay, out_keys, out_pay, m, wk, log_t,
                            (cudaStream_t)stream);
  }
  return kSort[wk](keys, pay, out_keys, out_pay, m, log_t,
                   (cudaStream_t)stream);
}

// The plain steps at distances 2^(log_t - 1), ..., 1 on each tile of
// 2^log_t rows (m a multiple of it; the tile as for jf_block_sort); the
// key is compared and a payload carried. Keys of up to 7 columns, as for
// jf_exchange_tiles and jf_flip: the pair sort's rows have 1-2.
extern "C" int jf_block_merge(const void* keys, const void* pay,
                              void* out_keys, void* out_pay, int64_t m,
                              int wk, int log_t, void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_t < 0 || log_t > 16) {
    return (int)cudaErrorInvalidValue;
  }
  return kMerge[wk](keys, pay, out_keys, out_pay, m, log_t,
                    (cudaStream_t)stream);
}

// g >= 1 consecutive halving steps at distances 2^(log_s + g - 1), ...,
// 2^log_s over m rows (m a multiple of 2^(log_s + g)) in one pass of
// strided tiles, blocks of 2^log_b >= 2^g rows (kernels/bitonic.py
// pass_block_rows), read and written through shared memory by words when
// `staged` is set (not with `transpose`), else read in layout j_in and
// written from layout j_out (stride_layouts); the first step mirrored when
// `mirror` is set, the input read through the 128 x 128 transpose when
// `transpose` is (m a multiple of 16384; out must not be the input). A
// payload is carried. Otherwise out may be the input.
extern "C" int jf_exchange_tiles(const void* keys, const void* pay,
                                 void* out_keys, void* out_pay, int64_t m,
                                 int wk, int log_s, int g, int mirror,
                                 int transpose, int log_b, int staged,
                                 int j_in, int j_out, void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_s < 0 || g < 1 ||
      log_s + g > 62 || (transpose && (m & 16383))) {
    return (int)cudaErrorInvalidValue;
  }
  return kStride[wk](keys, pay, out_keys, out_pay, m, log_s, g, mirror,
                     transpose, log_b, staged, j_in, j_out,
                     (cudaStream_t)stream);
}

// Each tile of 2^log_t rows (1 <= log_t, m a multiple) reversed; out must
// not be the input.
extern "C" int jf_flip(const void* keys, void* out_keys, int64_t m, int wk,
                       int log_t, void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_t < 1 || log_t > 62 ||
      (m & (((int64_t)1 << log_t) - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  return kFlipWk[wk](keys, out_keys, m, log_t, (cudaStream_t)stream);
}
