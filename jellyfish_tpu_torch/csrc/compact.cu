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
// The scatter has an instance for each key width of 1-7 columns, and one
// wide instance (WK = 0, rows.cuh) that reads the width at run time, for
// keys of any width above (k > 112).

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
  // The wide instance (WK = 0) is not unrolled: its rounds copy rows in a
  // loop of run-time length. The narrow ones run two rounds at a time,
  // which gives the ptxas report (8 and 16 bytes spilled in <1, false> and
  // <3, true>) and the device times of their build before the wide
  // instance was added (kernel_ab.py); one round at a time, or 4 to 16,
  // the keep-mask instance at Wk 1 ran 2-16% slower.
#pragma unroll (WK == 0 ? 1 : 2)
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

template <int WK>
int scatter(const void* keys, const void* cnt, const void* keep, int64_t m,
            const void* tile_off, void* out_keys, void* out_cnt, int wk,
            cudaStream_t s) {
  const int64_t tiles = (m + kTile - 1) / kTile;
  if (tiles > 0) {
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
// index wk for wk <= kNarrowCols, 0 (the wide instance) above
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
