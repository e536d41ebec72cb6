// Window staging of the streaming merge: a window of rows at a runtime
// offset, and a rotation of a buffer by a runtime shift.
//
// Replaces the two Pallas probes of experiments/pallas_probe2.py that
// staged the TPU merge's windows:
//   - jf_window_rows: test_unaligned_dma's kernel (:141-167), a DMA of
//     x[off : off + 4096] into VMEM with `off` a prefetched runtime scalar
//     that need not be 128-aligned (merge-path split points are not);
//   - jf_roll_lanes: test_dynamic_roll's kernel (:182-198),
//     pltpu.roll(x, s, axis=1) with `s` a prefetched runtime scalar (the
//     carry buffer's compaction).
// On the TPU both existed because VMEM is loaded in aligned tiles. On this
// card a thread reads any 8-byte word, so each becomes a copy, with the
// offset or shift read on the device where the caller has it there (an
// int64 scalar tensor), as the Pallas kernels read their prefetched
// scalar: nothing waits for the host.
//
// Bound on this card: bytes. Each output word is written once and each
// input word it copies read once. A window of the merge (2^20 rows, 32 MiB
// moved at Wk 1) is 10 us at the bytes bound, a few launches' worth, so
// jf_window_rows spends little per word. The keys and the counts are cut
// into tiles of kTile words, one block a tile. A tile that lies
// wholly inside the run is copied with no per-word compare, each thread
// kVec 16-byte vectors (8 words) with all its loads in flight before its
// first store; where the tile's first source word is odd (an odd off *
// wk), the loads are 8-byte words, still coalesced. Only tiles that cross
// an end of the run, and the last, short tile, take the checked copy of
// one word a thread. jf_roll_lanes copies one element a thread,
// neighbouring threads on neighbouring words, the shift read once a block
// into shared memory.
//
// Rows are [M, WK] int64 key columns beside [M] int64 counts, as in K1 and
// K2. A window's rows outside [0, M) get the PAD key and count 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                        // 16-byte vectors a thread
constexpr int kTile = kThreads * kVec * 2;     // words a tile

// out[e] = src[start + e] where 0 <= start + e < src_len, else pad, for e
// in one tile [e0, e0 + kTile) of a segment of `len` words.
struct Segment {
  const int64_t* src;
  int64_t* out;
  int64_t len, start, src_len, pad;

  __device__ __forceinline__ void copy_tile(int64_t e0) const {
    const int t = threadIdx.x;
    const int64_t s0 = start + e0;
    const int64_t* in = src + s0;
    int64_t* o = out + e0;
    if (len - e0 >= kTile && s0 >= 0 && s0 + kTile <= src_len &&
        (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      longlong2 v[kVec];
      if ((reinterpret_cast<uintptr_t>(in) & 15) == 0) {
        const longlong2* in2 = reinterpret_cast<const longlong2*>(in);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[i] = __ldg(in2 + t + i * kThreads);
      } else {
        // word 2 u of the tile sits in the upper half of a 16-byte vector
        // of the source: two 8-byte loads a vector
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int u = t + i * kThreads;
          v[i] = make_longlong2(__ldg(in + 2 * u), __ldg(in + 2 * u + 1));
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        reinterpret_cast<longlong2*>(o)[t + i * kThreads] = v[i];
      }
      return;
    }
    const int64_t n = len - e0 < kTile ? len - e0 : kTile;
    for (int w = t; w < n; w += kThreads) {
      const int64_t x = s0 + w;
      o[w] = (x >= 0 && x < src_len) ? src[x] : pad;
    }
  }
};

// Key words [0, n * wk) of the window are words off * wk + e of the run,
// in range exactly when their row is; then the n counts. Block i < tk
// copies the keys' tile i, the others the counts' tiles.
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ cnt, int64_t m, int wk,
                   const int64_t* __restrict__ off_dev, int64_t off_host,
                   int64_t n, int64_t pad, int64_t* __restrict__ out_keys,
                   int64_t* __restrict__ out_cnt, int64_t tk) {
  const int64_t off = off_dev != nullptr ? __ldg(off_dev) : off_host;
  const int64_t i = blockIdx.x;
  if (i < tk) {
    const Segment k{keys, out_keys, n * wk, off * wk, m * wk, pad};
    k.copy_tile(i * kTile);
  } else {
    const Segment c{cnt, out_cnt, n, off, m, 0};
    c.copy_tile((i - tk) * kTile);
  }
}

// out[r, j] = x[r, (j - s) mod c]: np.roll(x, s, axis=1)
__global__ void __launch_bounds__(kThreads)
roll_lanes_kernel(const int64_t* __restrict__ x, int64_t rows, int64_t c,
                  const int64_t* __restrict__ shift_dev, int64_t shift_host,
                  int64_t* __restrict__ out) {
  __shared__ int64_t s_shift;
  if (threadIdx.x == 0) {
    int64_t s = (shift_dev != nullptr ? *shift_dev : shift_host) % c;
    s_shift = s < 0 ? s + c : s;
  }
  __syncthreads();
  const int64_t s = s_shift;
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= c) return;
  int64_t src = j - s;
  if (src < 0) src += c;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    out[r * c + j] = x[r * c + src];
  }
}

}  // namespace

// out_keys [n, wk], out_cnt [n] <- rows [off, off + n) of (keys [m, wk],
// cnt [m]); off is *off_dev when off_dev is not null, else off_host
extern "C" int jf_window_rows(const void* keys, const void* cnt, int64_t m,
                              int wk, const void* off_dev, int64_t off_host,
                              int64_t n, int64_t pad, void* out_keys,
                              void* out_cnt, void* stream) {
  if (wk < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const int64_t tk = (n * wk + kTile - 1) / kTile;
  const int64_t tiles = tk + (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiles > 0) {
    window_rows_kernel<<<(unsigned)tiles, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int64_t*)cnt, m, wk,
        (const int64_t*)off_dev, off_host, n, pad, (int64_t*)out_keys,
        (int64_t*)out_cnt, tk);
  }
  return (int)cudaGetLastError();
}

// out [rows, c] <- x [rows, c] rolled by s along its last axis; s is
// *shift_dev when shift_dev is not null, else shift_host
extern "C" int jf_roll_lanes(const void* x, int64_t rows, int64_t c,
                             const void* shift_dev, int64_t shift_host,
                             void* out, void* stream) {
  if (rows < 0 || c < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0 && c > 0) {
    const int64_t bx = (c + kThreads - 1) / kThreads;
    if (bx > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bx, (unsigned)(rows < 65535 ? rows : 65535));
    roll_lanes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, rows, c, (const int64_t*)shift_dev, shift_host,
        (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
