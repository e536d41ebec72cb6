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
// int64 payload [M] travels with its row. Every step is ascending: of the
// two rows it meets, the lower position gets the smaller. Two entry points:
//
//   jf_block_sort sorts each tile of T = 2^log_t rows, one block a tile.
//     The tile sits in dynamic shared memory column by column, so that
//     neighbouring threads touch neighbouring words. Phase k = 2, 4, ..., T
//     starts with the mirrored step, where row j of each k-row block meets
//     row k - 1 - j (the Pallas flip, fused), then runs plain steps at
//     distances k/4, ..., 1, with __syncthreads() between steps. A payload
//     is compared after the key, so a row-index payload makes the order
//     stable. The last tile is padded in shared memory with INT64_MAX rows,
//     which sort last, and only its real rows are written.
//   jf_exchange runs one step over the whole array in device memory, one
//     thread a pair of rows: a plain step at distance d (row i meets
//     i + d inside each 2d-row block), a flip (row j of each 2d-row
//     block swapped with row 2d - 1 - j), or a mirrored step (the flip's
//     partner with the plain step's compare: the Pallas flip and the
//     exchange after it in one pass, as block_sort's first step of a
//     phase, over the whole array). A payload is carried, not compared.
//     `transpose` reads the input through the transpose of each 128 x 128
//     block of positions, an index map rather than a data pass.
//
// Bound on this card. jf_block_sort reads and writes each row of device
// memory once, and does its log_t (log_t + 1) / 2 steps in shared memory:
// it is bound by shared-memory traffic and compares, not by device memory.
// Two blocks of at most 96 KiB fit on an SM, so one block's steps overlap
// another's loads. jf_exchange is bound by bytes: each step reads and
// writes every row once, which is why block_sort keeps its steps in
// shared memory. The counting store merges sorted tiles with K1 passes;
// the pair sort of kernels/sort.py (the Bloom insert) runs only its
// cross-tile steps here and sorts each tile again with jf_block_sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kSortThreads = 512;
constexpr int kStepThreads = 256;
constexpr int64_t kPad = INT64_MAX;  // pad rows sort last

enum Mode { kExchange = 0, kFlip = 1, kMirror = 2 };

// A row as the kernels hold it: [payload,] key column 0 .. WK - 1, so that
// row_le over columns [kLo, kCols) compares the key first and the payload
// (when CMP) last.
template <int WK, bool PAY, bool CMP>
struct Row {
  static constexpr int kCols = WK + (PAY ? 1 : 0);
  static constexpr int kLo = (PAY && !CMP) ? 1 : 0;
  // b strictly before a
  __device__ static __forceinline__ bool before(const int64_t* b,
                                                const int64_t* a) {
    return !row_le<kCols - kLo>(a + kLo, b + kLo);
  }
};

// -- block sort in shared memory --------------------------------------------

template <class R>
__device__ __forceinline__ void cmp_swap_shared(int64_t* s, int t, int a,
                                                int b) {
  int64_t ra[R::kCols], rb[R::kCols];
#pragma unroll
  for (int c = 0; c < R::kCols; ++c) {
    ra[c] = s[c * t + a];
    rb[c] = s[c * t + b];
  }
  if (R::before(rb, ra)) {
#pragma unroll
    for (int c = 0; c < R::kCols; ++c) {
      s[c * t + a] = rb[c];
      s[c * t + b] = ra[c];
    }
  }
}

// one plain step at distance 2^ld over the tile
template <class R>
__device__ __forceinline__ void step_shared(int64_t* s, int t, int ld) {
  for (int p = threadIdx.x; p < (t >> 1); p += kSortThreads) {
    const int a = ((p >> ld) << (ld + 1)) | (p & ((1 << ld) - 1));
    cmp_swap_shared<R>(s, t, a, a + (1 << ld));
  }
  __syncthreads();
}

template <int WK, bool PAY>
__global__ void __launch_bounds__(kSortThreads)
block_sort_kernel(const int64_t* ik, const int64_t* ip, int64_t* ok,
                  int64_t* op, int64_t m, int log_t) {
  using R = Row<WK, PAY, true>;
  extern __shared__ int64_t s[];  // [R::kCols][t]
  const int t = 1 << log_t;
  const int64_t base = (int64_t)blockIdx.x << log_t;
  const int n = (int)(m - base < t ? m - base : t);

  for (int e = threadIdx.x; e < t * WK; e += kSortThreads) {
    const int r = e / WK;
    s[(e - r * WK + PAY) * t + r] = r < n ? ik[base * WK + e] : kPad;
  }
  if constexpr (PAY) {
    for (int r = threadIdx.x; r < t; r += kSortThreads) {
      s[r] = r < n ? ip[base + r] : kPad;
    }
  }
  __syncthreads();

  for (int lk = 1; lk <= log_t; ++lk) {
    // mirrored step: row j of each 2^lk block meets row 2^lk - 1 - j
    const int lh = lk - 1;
    for (int p = threadIdx.x; p < (t >> 1); p += kSortThreads) {
      const int blk = (p >> lh) << lk;
      const int j = p & ((1 << lh) - 1);
      cmp_swap_shared<R>(s, t, blk + j, blk + (1 << lk) - 1 - j);
    }
    __syncthreads();
    for (int ld = lk - 2; ld >= 0; --ld) step_shared<R>(s, t, ld);
  }

  for (int e = threadIdx.x; e < n * WK; e += kSortThreads) {
    const int r = e / WK;
    ok[base * WK + e] = s[(e - r * WK + PAY) * t + r];
  }
  if constexpr (PAY) {
    for (int r = threadIdx.x; r < n; r += kSortThreads) op[base + r] = s[r];
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

// -- launchers ----------------------------------------------------------------

template <int WK, bool PAY>
int launch_sort(const void* keys, const void* pay, void* out_keys,
                void* out_pay, int64_t m, int log_t, cudaStream_t s) {
  const size_t bytes = ((size_t)WK + PAY) * sizeof(int64_t) << log_t;
  cudaError_t e = cudaFuncSetAttribute(
      block_sort_kernel<WK, PAY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (m + ((int64_t)1 << log_t) - 1) >> log_t;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    block_sort_kernel<WK, PAY><<<(unsigned)tiles, kSortThreads, bytes, s>>>(
        (const int64_t*)keys, (const int64_t*)pay, (int64_t*)out_keys,
        (int64_t*)out_pay, m, log_t);
  }
  return (int)cudaGetLastError();
}

template <int WK>
int sort_wk(const void* keys, const void* pay, void* out_keys, void* out_pay,
            int64_t m, int log_t, cudaStream_t s) {
  return pay ? launch_sort<WK, true>(keys, pay, out_keys, out_pay, m, log_t, s)
             : launch_sort<WK, false>(keys, pay, out_keys, out_pay, m, log_t,
                                      s);
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

using SortFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                       cudaStream_t);
using StepFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                       int, int, cudaStream_t);
constexpr SortFn kSort[] = {nullptr,    sort_wk<1>, sort_wk<2>, sort_wk<3>,
                            sort_wk<4>, sort_wk<5>, sort_wk<6>, sort_wk<7>};
constexpr StepFn kStep[] = {nullptr,    step_wk<1>, step_wk<2>, step_wk<3>,
                            step_wk<4>, step_wk<5>, step_wk<6>, step_wk<7>};

}  // namespace

// Sort each tile of 2^log_t rows; the tile, (wk + payload) * 8 bytes a
// row, must fit in an SM's shared memory. pay and out_pay NULL: keys only;
// a payload is compared after the key.
extern "C" int jf_block_sort(const void* keys, const void* pay,
                             void* out_keys, void* out_pay, int64_t m, int wk,
                             int log_t, void* stream) {
  if (wk < 1 || wk > 7 || log_t < 0 || log_t > 16) {
    return (int)cudaErrorInvalidValue;
  }
  return kSort[wk](keys, pay, out_keys, out_pay, m, log_t,
                   (cudaStream_t)stream);
}

// One step at distance 2^log_d over m rows (m a multiple of 2^(log_d + 1)).
// mode: 0 plain, 1 flip, 2 mirrored. A payload is carried. transpose: read
// through the 128 x 128 block transpose (m a multiple of 16384; out must
// not be the input).
extern "C" int jf_exchange(const void* keys, const void* pay, void* out_keys,
                           void* out_pay, int64_t m, int wk, int log_d,
                           int mode, int transpose, void* stream) {
  if (wk < 1 || wk > 7 || log_d < 0 || log_d > 62 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  return kStep[wk](keys, pay, out_keys, out_pay, m, log_d, mode, transpose,
                   (cudaStream_t)stream);
}
