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
// otherwise. Three entry points:
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
//   jf_exchange runs one step over the whole array in device memory, one
//     thread a pair of rows: a plain step at distance d (row i meets
//     i + d inside each 2d-row block), a flip (row j of each 2d-row
//     block swapped with row 2d - 1 - j), or a mirrored step (the flip's
//     partner with the plain step's compare: the Pallas flip and the
//     exchange after it in one pass, as block_sort's first step of a
//     phase, over the whole array). A payload is carried, not compared.
//     `transpose` reads the input through the transpose of each 128 x 128
//     block of positions, an index map rather than a data pass.
//   jf_exchange_group runs 2 <= g <= 4 consecutive halving steps, at
//     distances d, d/2, ..., s = d / 2^(g-1), the first plain or
//     mirrored, in one read and one write of the array: the steps pair
//     rows only within sets of 2^g rows, which one thread holds in
//     registers (below).
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
// Bound on this card. The tile entries read and write each row of device
// memory once (the bytes bound), but the full sort is bound by its
// instructions: at T = 4096 each row meets another 78 times, and each
// meeting is a compare of two 64-bit columns and the selects of two rows
// on 32-bit units. Hence the design: no pair is compared twice (as it is
// when two threads trade rows by shuffles), compares carry no branches,
// and the layout moves, which cost shared-memory traffic and barriers,
// are few. The merge, with 12 steps, is closer to the bytes bound.
// jf_exchange is bound by bytes: each step reads and writes every row
// once, which is why the tile entries keep their steps on chip, and why
// jf_exchange_group runs up to four cross-tile steps a pass. The counting
// store merges sorted tiles with K1 passes; the pair sort of
// kernels/sort.py (BitsArray's batch updates) runs its cross-tile steps on
// jf_exchange_group (the phase at run L: the mirrored step at L and the
// plain steps down to a tile, 2^24 rows in 1-3 passes where step by step
// took 1-12) and finishes each tile with jf_block_merge.
//
// The fused pass (group_kernel). Thread p of m / 2^g takes the low part j
// = p mod s in the 2d-row block at blk = (p / s) 2d. Its registers i < H =
// 2^(g-1) hold the lower half's rows blk + j + i s; registers H + i hold
// the upper half's rows up + i s, with up = blk + d + j for a plain first
// step and up = blk + d + (s - 1 - j) for a mirrored one: there the
// upper rows are the mirror partners of the lower ones (row u < d of the
// block meets 2d - 1 - u), and j -> s - 1 - j is a bijection, so every row
// is held once. The first step pairs register i with i + H (plain) or
// 2H - 1 - i (mirrored); the step at s 2^t pairs i with i + 2^t (bit t of
// i clear), inside either half. Neighbouring threads hold neighbouring
// rows in each register (in reverse order in a mirrored upper half), so
// each register's loads and stores are coalesced once s >= 32; on the
// route s is at least a tile (4096 rows at Wk 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kStepThreads = 256;
constexpr int64_t kPad = INT64_MAX;  // pad rows sort last
constexpr int kTileBytes = 96 * 1024;  // kernels/bitonic.py SHARED_TILE_BYTES

enum Mode { kExchange = 0, kFlip = 1, kMirror = 2 };

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

// -- one step in device memory ----------------------------------------------

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

// ik may equal ok: each thread reads and writes only its own pair's rows
// (when transposing, the wrapper passes another output).
template <int WK, bool PAY>
__global__ void __launch_bounds__(kStepThreads)
exchange_kernel(const int64_t* ik, const int64_t* ip, int64_t* ok,
                int64_t* op, int64_t m, int log_d, int mode, int transpose) {
  using R = Row<WK, PAY, false>;
  const int64_t p = (int64_t)blockIdx.x * kStepThreads + threadIdx.x;
  if (p >= (m >> 1)) return;
  const int64_t d = (int64_t)1 << log_d;
  const int64_t blk = (p >> log_d) << (log_d + 1);
  const int64_t j = p & (d - 1);
  const int64_t a = blk + j;
  // kFlip and kMirror meet the mirrored partner
  const int64_t b = mode == kExchange ? a + d : blk + 2 * d - 1 - j;
  int64_t ra[R::kCols], rb[R::kCols];
  load_row<R, WK>(ra, ik, ip, transpose ? transposed(a) : a);
  load_row<R, WK>(rb, ik, ip, transpose ? transposed(b) : b);
  if (mode == kFlip || R::before(rb, ra)) {
    store_row<R, WK>(ok, op, a, rb);
    store_row<R, WK>(ok, op, b, ra);
  } else {
    store_row<R, WK>(ok, op, a, ra);
    store_row<R, WK>(ok, op, b, rb);
  }
}

// The most steps of a fused pass for rows of `cols` int64 columns: 2^G
// rows a thread (16 for up to four columns, else 8), in registers.
constexpr int max_group(int cols) { return cols <= 4 ? 4 : 3; }

// G steps in one pass (the map is above), the first mirrored when MIRROR;
// in place when ik equals ok.
template <int WK, bool PAY, int G, bool MIRROR>
__global__ void __launch_bounds__(kStepThreads, 1)
group_kernel(const int64_t* ik, const int64_t* ip, int64_t* ok, int64_t* op,
             int64_t m, int log_s) {
  using R = Row<WK, PAY, false>;
  constexpr int N = 1 << G, H = N / 2;
  const int64_t p = (int64_t)blockIdx.x * kStepThreads + threadIdx.x;
  if (p >= (m >> G)) return;
  const int64_t s = (int64_t)1 << log_s;
  const int64_t j = p & (s - 1);
  const int64_t blk = (p >> log_s) << (log_s + G);
  const int64_t lo = blk + j;
  const int64_t up = blk + ((int64_t)H << log_s) + (MIRROR ? s - 1 - j : j);
  int64_t v[N][R::kCols];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    load_row<R, WK>(v[i], ik, ip,
                    (i < H ? lo : up) + ((int64_t)(i & (H - 1)) << log_s));
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    cmp_swap<R>(v[i], v[MIRROR ? N - 1 - i : i + H], false);
  }
#pragma unroll
  for (int t = G - 2; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!(i & (1 << t))) cmp_swap<R>(v[i], v[i | (1 << t)], false);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    store_row<R, WK>(ok, op,
                     (i < H ? lo : up) + ((int64_t)(i & (H - 1)) << log_s),
                     v[i]);
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
int launch_step(const void* keys, const void* pay, void* out_keys,
                void* out_pay, int64_t m, int log_d, int mode, int transpose,
                cudaStream_t s) {
  const int64_t blocks = ((m >> 1) + kStepThreads - 1) / kStepThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    exchange_kernel<WK, PAY><<<(unsigned)blocks, kStepThreads, 0, s>>>(
        (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
        (int64_t*)out_pay, m, log_d, mode, transpose);
  }
  return (int)cudaGetLastError();
}

template <int WK>
int step_wk(const void* keys, const void* pay, void* out_keys, void* out_pay,
            int64_t m, int log_d, int mode, int transpose, cudaStream_t s) {
  return pay ? launch_step<WK, true>(keys, pay, out_keys, out_pay, m, log_d,
                                     mode, transpose, s)
             : launch_step<WK, false>(keys, pay, out_keys, out_pay, m, log_d,
                                      mode, transpose, s);
}

template <int WK, bool PAY, int G>
int launch_group(const void* keys, const void* pay, void* out_keys,
                 void* out_pay, int64_t m, int log_s, int mirror,
                 cudaStream_t s) {
  if constexpr (G > max_group(WK + PAY)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int64_t blocks = ((m >> G) + kStepThreads - 1) / kStepThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (blocks > 0) {
      auto kernel = mirror ? group_kernel<WK, PAY, G, true>
                           : group_kernel<WK, PAY, G, false>;
      kernel<<<(unsigned)blocks, kStepThreads, 0, s>>>(
          (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
          (int64_t*)out_pay, m, log_s);
    }
    return (int)cudaGetLastError();
  }
}

template <int WK, bool PAY>
int group_g(const void* keys, const void* pay, void* out_keys, void* out_pay,
            int64_t m, int log_s, int g, int mirror, cudaStream_t s) {
  switch (g) {
    case 2:
      return launch_group<WK, PAY, 2>(keys, pay, out_keys, out_pay, m,
                                      log_s, mirror, s);
    case 3:
      return launch_group<WK, PAY, 3>(keys, pay, out_keys, out_pay, m,
                                      log_s, mirror, s);
    case 4:
      return launch_group<WK, PAY, 4>(keys, pay, out_keys, out_pay, m,
                                      log_s, mirror, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int WK>
int group_wk(const void* keys, const void* pay, void* out_keys,
             void* out_pay, int64_t m, int log_s, int g, int mirror,
             cudaStream_t s) {
  return pay ? group_g<WK, true>(keys, pay, out_keys, out_pay, m, log_s, g,
                                 mirror, s)
             : group_g<WK, false>(keys, pay, out_keys, out_pay, m, log_s, g,
                                  mirror, s);
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
using StepFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                       int, int, cudaStream_t);
constexpr TileFn kSort[] = {
    nullptr,           tiles_wk<1, false>, tiles_wk<2, false>,
    tiles_wk<3, false>, tiles_wk<4, false>, tiles_wk<5, false>,
    tiles_wk<6, false>, tiles_wk<7, false>};
constexpr TileFn kMerge[] = {
    nullptr,          tiles_wk<1, true>, tiles_wk<2, true>,
    tiles_wk<3, true>, tiles_wk<4, true>, tiles_wk<5, true>,
    tiles_wk<6, true>, tiles_wk<7, true>};
constexpr StepFn kStep[] = {nullptr,    step_wk<1>, step_wk<2>, step_wk<3>,
                            step_wk<4>, step_wk<5>, step_wk<6>, step_wk<7>};
using GroupWkFn = int (*)(const void*, const void*, void*, void*, int64_t,
                          int, int, int, cudaStream_t);
constexpr GroupWkFn kGroup[] = {
    nullptr,     group_wk<1>, group_wk<2>, group_wk<3>,
    group_wk<4>, group_wk<5>, group_wk<6>, group_wk<7>};

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
// jf_exchange and jf_exchange_group: the pair sort's rows have 1-2.
extern "C" int jf_block_merge(const void* keys, const void* pay,
                              void* out_keys, void* out_pay, int64_t m,
                              int wk, int log_t, void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_t < 0 || log_t > 16) {
    return (int)cudaErrorInvalidValue;
  }
  return kMerge[wk](keys, pay, out_keys, out_pay, m, log_t,
                    (cudaStream_t)stream);
}

// One step at distance 2^log_d over m rows (m a multiple of 2^(log_d + 1)).
// mode: 0 plain, 1 flip, 2 mirrored. A payload is carried. transpose: read
// through the 128 x 128 block transpose (m a multiple of 16384; out must
// not be the input).
extern "C" int jf_exchange(const void* keys, const void* pay, void* out_keys,
                           void* out_pay, int64_t m, int wk, int log_d,
                           int mode, int transpose, void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_d < 0 || log_d > 62 || mode < 0 ||
      mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  return kStep[wk](keys, pay, out_keys, out_pay, m, log_d, mode, transpose,
                   (cudaStream_t)stream);
}

// The most steps one jf_exchange_group pass runs on rows of wk key columns
// and a payload when `pay` is set: the launcher cuts its runs to it.
extern "C" int jf_exchange_group_limit(int wk, int pay) {
  return max_group(wk + (pay != 0));
}

// g consecutive halving steps at distances 2^(log_s + g - 1), ..., 2^log_s
// over m rows (m a multiple of 2^(log_s + g)) in one pass, the first
// mirrored when `mirror` is set; 2 <= g <= jf_exchange_group_limit(wk,
// pay) (one step is jf_exchange's). A payload is carried. out may be the
// input.
extern "C" int jf_exchange_group(const void* keys, const void* pay,
                                 void* out_keys, void* out_pay, int64_t m,
                                 int wk, int log_s, int g, int mirror,
                                 void* stream) {
  if (wk < 1 || wk > kNarrowCols || log_s < 0 || g < 2 || g > 4 ||
      log_s + g > 62) {
    return (int)cudaErrorInvalidValue;
  }
  return kGroup[wk](keys, pay, out_keys, out_pay, m, log_s, g, mirror,
                    (cudaStream_t)stream);
}
