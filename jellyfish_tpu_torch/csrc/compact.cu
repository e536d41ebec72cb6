// Order-preserving stream compaction of a sorted masked run of
// (key row, count) pairs: keep the rows whose count is nonzero.
//
// Replaces the Pallas gap-removal compaction of
// experiments/pallas_compact.py (_compact_pallas / compact_sorted_masked,
// kernel _kernel). That kernel moved rows with one-hot selection matmuls on
// the MXU (the TPU has no scatter) and left up to 127 PAD rows between
// tiles; this one scatters each kept row to its exact output position, so
// the output is the dense live prefix and nothing else.
//
// Inputs: keys [M, WK] int64 rows, counts [M] int64, and optionally a keep
// mask [M] (one byte a row). Output: the rows with count != 0, or with a
// nonzero keep byte when a mask is given, in input order, and their counts.
// The merge (merge.py) keeps rows by a mask: a merged record may hold the
// value 0 (merge -m -L 0).
//
// Bound on this card: bytes. Every count is read (8 bytes a row), every
// key row is read once and every kept row written once, against one
// compare a row. The design reads each input byte once in a pass and does
// no sorting:
//   - pass 1 (jf_compact_count) counts the kept rows of each tile of kTile
//     rows, reading only the counts;
//   - the per-tile output offsets are an exclusive scan of those counts,
//     which the wrapper takes with torch.cumsum (a few thousand values,
//     precomputed outside the kernel as the Pallas version did too);
//   - pass 2 (jf_compact_scatter) walks its tile in rounds of one row a
//     thread: a warp ballot and popc give each kept row its rank in the
//     warp, shared memory adds the ranks of the warps before it, and the
//     row is written at tile offset + running total + rank. Neighbouring
//     kept rows land on neighbouring addresses, so the stores coalesce.
// The scatter has an instance for each key width of 1-7 columns. Keys of
// any width above (k > 112) run a kernel of their own (compact_wide_kernel,
// below), which ranks the whole tile at once and then copies the tile's
// kept rows as one contiguous span of words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;  // rows a block owns

// KEEP: rows are kept by their keep byte, else by a nonzero count; the
// count-only instances read no mask
template <bool KEEP>
__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const int64_t* __restrict__ cnt,
                     const uint8_t* __restrict__ keep, int64_t m,
                     int64_t* __restrict__ tile_n) {
  __shared__ int s_warp[kWarps];
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  int c = 0;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int64_t i = row0 + r;
    c += (i < m && (KEEP ? keep[i] != 0 : cnt[i] != 0)) ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s_warp[w];
    tile_n[blockIdx.x] = t;
  }
}

// WK = 1 .. kNarrowCols (wider keys run compact_wide_kernel)
template <int WK, bool KEEP>
__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const int64_t* __restrict__ keys,
                       const int64_t* __restrict__ cnt,
                       const uint8_t* __restrict__ keep, int64_t m,
                       const int64_t* __restrict__ tile_off,
                       int64_t* __restrict__ out_keys,
                       int64_t* __restrict__ out_cnt, int wk) {
  const int W = width<WK>(wk);
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  int64_t base = tile_off[blockIdx.x];
  // Two rounds at a time, which gives the ptxas report (8 and 16 bytes
  // spilled in <1, false> and <3, true>) and the device times of the
  // build before keys wider than 7 columns were added (kernel_ab.py); one
  // round at a time, or 4 to 16, the keep-mask instance at Wk 1 ran 2-16%
  // slower.
#pragma unroll 2
  for (int r = 0; r < kTile; r += kThreads) {
    const int64_t i = row0 + r + threadIdx.x;
    const int64_t c = i < m ? cnt[i] : 0;
    const bool kept = KEEP ? i < m && keep[i] != 0 : c != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_warp[w];
      before += w < warp ? t : 0;
      total += t;
    }
    if (kept) {
      const int64_t o = base + before + __popc(ballot & below);
      out_cnt[o] = c;
#pragma unroll
      for (int w = 0; w < W; ++w) out_keys[o * W + w] = keys[i * W + w];
    }
    base += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }
}

// -- the wide scatter ---------------------------------------------------------

// compact_scatter_kernel at a width read at run time ran at 46% of its
// bound: 16 rounds a tile, each a dependent chain (count, ballot, shared
// memory, key) between two barriers, and a kept row copied by its own
// thread one column at a time, so that a warp's loads and stores lay one
// row apart (32 sectors an instruction for 256 bytes) with one row's
// loads in flight. The wide kernel runs a tile in two phases:
//   1. rank: warp w owns rows [512 w, 512 w + 512) of the tile; in step j
//      lane l reads the counts of rows 64 j + l and 64 j + 32 + l (two
//      coalesced loads a warp) and their keep bytes, stages the counts in
//      shared memory at their tile rows, and two ballots count the kept
//      rows; one barrier adds the warps before (the tile's one pair of
//      barriers), and each kept row's tile row goes to shared memory at
//      its rank (16 bits a row);
//   2. copy: the tile's kept rows land at output rows [base, base +
//      total), one contiguous span of total * wk words. Threads walk it:
//      word e comes from kept row e / wk, column e % wk (a thread's next
//      word lies kThreads words on, its row and column advanced by a
//      quotient and remainder taken once), so stores are coalesced and
//      loads contiguous within each kept row, 16 bytes a word (V =
//      longlong2) where wk is even and both key arrays are 16-byte
//      aligned, else 8 (V = int64_t); kUnroll loads in flight a thread
//      before its stores. The counts follow from shared memory.
// Bound: bytes (every count and keep byte read, each kept row read and
// written once), as the narrow instances.
constexpr int kWarpRows = kTile / kWarps;  // 512 rows a warp, 8 steps of 64
constexpr int kUnroll = 4;

template <bool KEEP, typename V>
__global__ void __launch_bounds__(kThreads)
compact_wide_kernel(const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ cnt,
                    const uint8_t* __restrict__ keep, int64_t m,
                    const int64_t* __restrict__ tile_off,
                    int64_t* __restrict__ out_keys,
                    int64_t* __restrict__ out_cnt, int wk) {
  __shared__ __align__(16) int64_t s_cnt[kTile];  // counts by tile row
  __shared__ uint16_t s_src[kTile];  // tile row of each kept row, by rank
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;

  // 1. rank: bit 2 j + b of `mine` says whether row 64 j + 32 b + l of the
  // warp's rows is kept
  unsigned mine = 0;
  int kept = 0;
#pragma unroll
  for (int j = 0; j < kWarpRows / 64; ++j) {
    const int r = warp * kWarpRows + j * 64 + lane;
    const int64_t i = row0 + r;
    const int64_t c0 = i < m ? cnt[i] : 0;
    const int64_t c1 = i + 32 < m ? cnt[i + 32] : 0;
    s_cnt[r] = c0;
    s_cnt[r + 32] = c1;
    const bool k0 = KEEP ? i < m && keep[i] != 0 : c0 != 0;
    const bool k1 = KEEP ? i + 32 < m && keep[i + 32] != 0 : c1 != 0;
    mine |= (unsigned)k0 << (2 * j) | (unsigned)k1 << (2 * j + 1);
    kept += __popc(__ballot_sync(0xffffffffu, k0)) +
            __popc(__ballot_sync(0xffffffffu, k1));
  }
  if (lane == 0) s_warp[warp] = kept;
  __syncthreads();
  int rank = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    rank += w < warp ? t : 0;
    total += t;
  }
#pragma unroll
  for (int j = 0; j < kWarpRows / 64; ++j) {
    const bool k0 = (mine >> (2 * j)) & 1, k1 = (mine >> (2 * j + 1)) & 1;
    const unsigned b0 = __ballot_sync(0xffffffffu, k0);
    const unsigned b1 = __ballot_sync(0xffffffffu, k1);
    const int r = warp * kWarpRows + j * 64 + lane;
    if (k0) s_src[rank + __popc(b0 & below)] = (uint16_t)r;
    if (k1) s_src[rank + __popc(b0) + __popc(b1 & below)] = (uint16_t)(r + 32);
    rank += __popc(b0) + __popc(b1);
  }
  __syncthreads();

  // 2. copy the kept rows' words, then their counts
  const int64_t base = tile_off[blockIdx.x];
  constexpr int kWords = sizeof(V) / 8;  // words a load
  const int W = wk;
  const V* src = reinterpret_cast<const V*>(keys + row0 * W);
  V* dst = reinterpret_cast<V*>(out_keys + base * W);
  const int n = total * W / kWords;  // loads and stores of the tile
  // a thread's words lie kThreads kWords apart: `hop` rows and `skip`
  // columns, carried
  const int hop = kThreads * kWords / W;
  const int skip = kThreads * kWords - hop * W;
  int p = threadIdx.x * kWords / W;  // kept row and column of the
  int col = threadIdx.x * kWords - p * W;  // thread's next word
  for (int v = threadIdx.x; v < n; v += kUnroll * kThreads) {
    V x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < n) {
        x[u] = src[((int)s_src[p] * W + col) / kWords];
      }
      p += hop;
      col += skip;
      if (col >= W) {
        col -= W;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * kThreads < n) dst[v + u * kThreads] = x[u];
    }
  }
  for (int r = threadIdx.x; r < total; r += kThreads) {
    out_cnt[base + r] = s_cnt[s_src[r]];
  }
}

// The wide instances: 16-byte words where wk is even and both key arrays
// are 16-byte aligned (a row then starts at a 16-byte boundary), else
// 8-byte words.
template <bool KEEP>
void launch_wide(unsigned tiles, const void* keys, const void* cnt,
                 const void* keep, int64_t m, const void* tile_off,
                 void* out_keys, void* out_cnt, int wk, cudaStream_t s) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(keys) |
                       reinterpret_cast<uintptr_t>(out_keys);
  const bool vec = wk % 2 == 0 && (at & 15) == 0;
  auto kernel = vec ? compact_wide_kernel<KEEP, longlong2>
                    : compact_wide_kernel<KEEP, int64_t>;
  kernel<<<tiles, kThreads, 0, s>>>(
      (const int64_t*)keys, (const int64_t*)cnt, (const uint8_t*)keep, m,
      (const int64_t*)tile_off, (int64_t*)out_keys, (int64_t*)out_cnt, wk);
}

template <int WK>
int scatter(const void* keys, const void* cnt, const void* keep, int64_t m,
            const void* tile_off, void* out_keys, void* out_cnt, int wk,
            cudaStream_t s) {
  const int64_t tiles = (m + kTile - 1) / kTile;
  if (tiles == 0) return (int)cudaGetLastError();
  if constexpr (WK == 0) {
    (keep != nullptr ? launch_wide<true> : launch_wide<false>)(
        (unsigned)tiles, keys, cnt, keep, m, tile_off, out_keys, out_cnt, wk,
        s);
  } else {
    auto kernel = keep != nullptr ? compact_scatter_kernel<WK, true>
                                  : compact_scatter_kernel<WK, false>;
    kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
        (const int64_t*)keys, (const int64_t*)cnt, (const uint8_t*)keep, m,
        (const int64_t*)tile_off, (int64_t*)out_keys, (int64_t*)out_cnt, wk);
  }
  return (int)cudaGetLastError();
}

using ScatterFn = int (*)(const void*, const void*, const void*, int64_t,
                          const void*, void*, void*, int, cudaStream_t);
// index wk for wk <= kNarrowCols, 0 (the wide kernel) above
constexpr ScatterFn kScatter[] = {scatter<0>, scatter<1>, scatter<2>,
                                  scatter<3>, scatter<4>, scatter<5>,
                                  scatter<6>, scatter<7>};
static_assert(sizeof(kScatter) / sizeof(kScatter[0]) == kNarrowCols + 1);

}  // namespace

extern "C" int64_t jf_compact_tile() { return kTile; }

// tile_n[ceil(m / kTile)] <- kept rows of each tile; keep may be null
extern "C" int jf_compact_count(const void* cnt, const void* keep, int64_t m,
                                void* tile_n, void* stream) {
  const int64_t tiles = (m + kTile - 1) / kTile;
  if (tiles > 0) {
    auto kernel = keep != nullptr ? compact_count_kernel<true>
                                  : compact_count_kernel<false>;
    kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)cnt, (const uint8_t*)keep, m, (int64_t*)tile_n);
  }
  return (int)cudaGetLastError();
}

// tile_off: exclusive scan of tile_n; out_* hold exactly the kept rows;
// any key width wk >= 1
extern "C" int jf_compact_scatter(const void* keys, const void* cnt,
                                  const void* keep, int64_t m,
                                  const void* tile_off, void* out_keys,
                                  void* out_cnt, int wk, void* stream) {
  if (wk < 1) return (int)cudaErrorInvalidValue;
  return kScatter[wk <= kNarrowCols ? wk : 0](keys, cnt, keep, m, tile_off,
                                              out_keys, out_cnt, wk,
                                              (cudaStream_t)stream);
}
