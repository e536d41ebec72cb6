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
// card a thread reads any 8-byte word, so each becomes a plain copy: one
// thread an element, neighbouring threads on neighbouring words (coalesced
// whatever the offset's alignment), the offset or shift read once a block
// into shared memory. Where the caller has the offset on the device (an
// int64 scalar tensor), the kernel reads it there, as the Pallas kernels
// read their prefetched scalar: nothing waits for the host.
//
// Bound on this card: bytes. Each output word is written once and each
// input word it copies read once, against one compare and one add a word.
//
// Rows are [M, WK] int64 key columns beside [M] int64 counts, as in K1 and
// K2. A window's rows outside [0, M) get the PAD key and count 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Elements [0, n * wk) are key words, [n * wk, n * (wk + 1)) counts:
// one launch copies both.
__global__ void __launch_bounds__(kThreads)
window_rows_kernel(const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ cnt, int64_t m, int wk,
                   const int64_t* __restrict__ off_dev, int64_t off_host,
                   int64_t n, int64_t pad, int64_t* __restrict__ out_keys,
                   int64_t* __restrict__ out_cnt) {
  __shared__ int64_t s_off;
  if (threadIdx.x == 0) s_off = off_dev != nullptr ? *off_dev : off_host;
  __syncthreads();
  const int64_t off = s_off;
  const int64_t nk = n * wk;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e < nk) {
    // key word e of the window is word off * wk + e of the run: in range
    // exactly when its row is
    const int64_t src = off * wk + e;
    out_keys[e] = (src >= 0 && src < m * wk) ? keys[src] : pad;
  } else if (e < nk + n) {
    const int64_t i = e - nk;
    const int64_t src = off + i;
    out_cnt[i] = (src >= 0 && src < m) ? cnt[src] : 0;
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
  const int64_t total = n * (wk + 1);
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    window_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const int64_t*)cnt, m, wk,
        (const int64_t*)off_dev, off_host, n, pad, (int64_t*)out_keys,
        (int64_t*)out_cnt);
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
