// Stable LSD radix sort of (int64 key, int64 payload) pairs over the key's
// low key_bits bits: the Bloom-counter insert's pair sort.
//
// It computes what jellyfish_tpu/bloom.py:137 asks of lax.sort([pos, wb],
// num_keys=1): the probe positions in ascending order, each pair's weight
// carried. The TPU has no Pallas kernel of its own for this sort; the port
// first ran it on the bitonic route that ports the Pallas sort prototype
// (kernel-table rows 6, 8 and 12: experiments/pallas_sort_proto.py:65
// pallas_sort, pallas_probe2.py:103 build_stages(arrays=3),
// pallas_stage_probe.py:112 flip), which pads to a power of two and makes
// O(log^2 n) passes over all 64 bits of keys that hold 30. This kernel
// replaces that route on the insert: ceil(key_bits / 8) passes of one
// 8-bit digit each, no padding.
//
// Bound on this card: bytes. Each pass reads and writes the 16-byte pairs
// once; the histogram pass reads the keys once. The design keeps each pass
// at one read and one write of the pairs (the onesweep shape):
//   - radix_hist_kernel reads the keys once and counts the digits of every
//     pass into shared-memory bins, added to a global [passes][2^8] table;
//     radix_scan_kernel turns each pass's counts into the digits' first
//     output positions;
//   - radix_pass_kernel: a block takes the next tile of TILE pairs from an
//     atomic counter (so every earlier tile belongs to a block that already
//     runs), holds its keys' digits in registers, ranks them stably within
//     each warp (kBits + 1 ballots give each lane the lanes of its digit,
//     and the highest of them adds their number to the warp's counter of
//     the digit with one shared-memory atomic), publishes the tile's per-digit
//     counts, and looks back over the earlier tiles' published counts for
//     each digit's exclusive prefix (the decoupled look-back: a tile's
//     status word holds its count with a flag, "aggregate" until it knows
//     its prefix, then "inclusive"). The tile is then put in digit order in
//     shared memory, keys first, then payloads, so that the writes to
//     global memory come out in runs of one digit.
// Keys are read as unsigned 64-bit patterns; with key_bits = 64 the sign
// bit is flipped first, so that any int64 sorts as a signed value. With
// key_bits < 64 the caller guarantees 0 <= key < 2^key_bits.
//
// The wrapper (kernels/radix.py) allocates the outputs, the second buffer
// pair and the scratch: hist [passes][2^8], base [passes][2^8], then the
// status area (the tile counter, then [tiles][2^8] words). Pass p reads the
// input (p = 0) or the buffer pass p - 1 wrote, and writes buffer pair a
// (p even) or b (p odd).
//
// Tuned on one H100 at the insert's shape (8,890,770 pairs below 2^30;
// PERF.md, kernel_ab.py's radix cases on variant trees): 8-bit digits (4
// passes) beat 10 and 11 bits (3 passes, each with a look-back 4x and 8x
// wider); ballots rank faster than __match_any_sync; tiles of 512 threads
// x 8 keys (two blocks an SM) beat 256 x 16; prefetching the payloads into
// L2 and publishing a tile's counts before its ranking were slower, and
// reading two tiles a look-back round gained under 1%. The keys are read
// again (from L2) when they are staged rather than held in registers,
// where they spilled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kAggregate = 1ull << 62;  // the tile's own count
constexpr u64 kInclusive = 2ull << 62;  // the count of this and every earlier tile
constexpr u64 kValue = kAggregate - 1;
constexpr int kBits = 8;  // the digit
constexpr int R = 1 << kBits;
constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 4;
// the pass kernel: threads, keys a thread, blocks an SM, warps, tile rows
constexpr int T = 512;
constexpr int I = 8;
constexpr int kBlocks = 2;
constexpr int W = T / 32;
constexpr int TILE = T * I;
static_assert(R <= T, "thread d of a pass owns digit d");

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Exclusive prefix sum of v over the block's threads in thread order; tmp
// holds one value a warp.
template <int THREADS, typename V>
__device__ __forceinline__ V block_exclusive_scan(V v, V* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  V x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  V before = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) before += w < warp ? tmp[w] : V(0);
  __syncthreads();  // tmp may be reused
  return before + x - v;
}

__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const long long* __restrict__ keys, long long n, int passes,
                  u64 flip, u64* __restrict__ hist) {
  extern __shared__ unsigned int bins[];  // [passes][R]
  const int nb = passes * R;
  for (int i = threadIdx.x; i < nb; i += kHistThreads) bins[i] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * kHistThreads * kHistUnroll;
  for (long long i0 = (long long)blockIdx.x * kHistThreads * kHistUnroll;
       i0 < n; i0 += step) {
    u64 u[kHistUnroll];
#pragma unroll
    for (int j = 0; j < kHistUnroll; ++j) {
      const long long i = i0 + j * kHistThreads + threadIdx.x;
      u[j] = i < n ? (u64)keys[i] ^ flip : 0;
    }
#pragma unroll
    for (int j = 0; j < kHistUnroll; ++j) {
      if (i0 + j * kHistThreads + threadIdx.x >= n) break;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&bins[p * R + (int)((u[j] >> (p * kBits)) & (R - 1))], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kHistThreads)
    if (bins[i]) atomicAdd(&hist[i], (u64)bins[i]);
}

// one block a pass, thread d for digit d: base[d] = the count of the
// digits below d
__global__ void __launch_bounds__(R)
radix_scan_kernel(const u64* __restrict__ hist, long long* __restrict__ base) {
  __shared__ u64 tmp[R / 32];
  const size_t d = (size_t)blockIdx.x * R + threadIdx.x;
  base[d] = (long long)block_exclusive_scan<R>(hist[d], tmp);
}

struct PassSmem {
  union {
    // each warp's count of a digit, then its exclusive prefix over the
    // warps
    unsigned int count[W][R];
    long long stage[TILE];  // the tile in digit order: keys, then payloads
  };
  long long offset[R];    // a digit's output position less its first in the tile
  unsigned int first[R];  // the tile's first position of a digit
  unsigned int scan[W];
  unsigned int tile;
};

__global__ void __launch_bounds__(T, kBlocks)
radix_pass_kernel(const long long* __restrict__ in_k,
                  const long long* __restrict__ in_p,
                  long long* __restrict__ out_k, long long* __restrict__ out_p,
                  long long n, int shift, u64 flip,
                  const long long* __restrict__ base, u64* status) {
  extern __shared__ __align__(16) unsigned char raw[];
  PassSmem& s = *reinterpret_cast<PassSmem*>(raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = threadIdx.x;  // the digit this thread owns, if below R

  for (int i = threadIdx.x; i < W * R; i += T) (&s.count[0][0])[i] = 0;
  if (threadIdx.x == 0)
    s.tile = atomicAdd(reinterpret_cast<unsigned int*>(status), 1u);
  __syncthreads();
  const long long tile = s.tile;
  const long long row0 = tile * TILE;
  const int valid = (int)min((long long)TILE, n - row0);
  u64* const tiles = status + 1;

  // 1. the digits of the tile's keys, warp-striped: item j of lane l is
  // tile row (warp I + j) 32 + l, so that a warp's items in (j, lane) order
  // are in row order
  int digit[I];
  const int row = warp * I * 32 + lane;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const int r = row + j * 32;
    digit[j] = r < valid
                   ? (int)((((u64)in_k[row0 + r] ^ flip) >> shift) & (R - 1))
                   : R;
  }

  // 2. rank each key among the warp's keys of its digit, in row order
  int rank[I];
  unsigned int* const mine = s.count[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    // the lanes of this lane's digit (the invalid rows' R apart)
    unsigned peers = __ballot_sync(0xffffffffu, digit[j] < R);
    if (digit[j] >= R) peers = ~peers;
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      const unsigned bal = __ballot_sync(0xffffffffu, (digit[j] >> b) & 1);
      peers &= (digit[j] >> b) & 1 ? bal : ~bal;
    }
    const int leader = 31 - __clz(peers);
    int c = 0;
    if (lane == leader && digit[j] < R)
      c = atomicAdd(&mine[digit[j]], (unsigned int)__popc(peers));
    rank[j] = __shfl_sync(0xffffffffu, c, leader) + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();

  // 3. per digit: the prefix over the warps, and the tile's count published
  unsigned int own = 0;
  if (d < R) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const unsigned int c = s.count[w][d];
      s.count[w][d] = own;
      own += c;
    }
    store_relaxed(&tiles[tile * R + d],
                  (tile == 0 ? kInclusive : kAggregate) | own);
  }

  // 4. the tile's first position of each digit
  const unsigned int at = block_exclusive_scan<T>(own, s.scan);
  if (d < R) s.first[d] = at;
  __syncthreads();

  // 5. each key's position in the tile in digit order (stable)
  int pos[I];
#pragma unroll
  for (int j = 0; j < I; ++j)
    pos[j] = digit[j] < R
                 ? (int)(s.first[digit[j]] + s.count[warp][digit[j]]) + rank[j]
                 : -1;

  // 6. look back: each digit's count in the earlier tiles
  if (d < R) {
    long long before = 0;
    if (tile > 0) {
      long long t = tile - 1;
      u64 v = load_relaxed(&tiles[t * R + d]);
      for (;;) {
        while (!(v & ~kValue)) v = load_relaxed(&tiles[t * R + d]);
        before += (long long)(v & kValue);
        if (v & kInclusive) break;
        --t;
        v = load_relaxed(&tiles[t * R + d]);
      }
      store_relaxed(&tiles[tile * R + d], kInclusive | (u64)(before + own));
    }
    s.offset[d] = base[d] + before - s.first[d];
  }
  __syncthreads();  // every pos read from s.count, which stage overwrites

  // 7. keys in digit order through shared memory, out in runs of a digit
#pragma unroll
  for (int j = 0; j < I; ++j)
    if (pos[j] >= 0) s.stage[pos[j]] = in_k[row0 + row + j * 32];
  __syncthreads();
  int out_digit[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int p = threadIdx.x + i * T;
    out_digit[i] = 0;
    if (p < valid) {
      const long long k = s.stage[p];
      out_digit[i] = (int)((((u64)k ^ flip) >> shift) & (R - 1));
      out_k[s.offset[out_digit[i]] + p] = k;
    }
  }
  __syncthreads();

  // 8. payloads, the same way
#pragma unroll
  for (int j = 0; j < I; ++j)
    if (pos[j] >= 0) s.stage[pos[j]] = in_p[row0 + row + j * 32];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int p = threadIdx.x + i * T;
    if (p < valid) out_p[s.offset[out_digit[i]] + p] = s.stage[p];
  }
}

}  // namespace

// rows a pass kernel's tile holds
extern "C" long long jf_radix_tile() { return TILE; }

// Sort n >= 1 (key, payload) pairs by the key's low key_bits bits (1-64),
// stably; the result lies in (ka, pa) after an odd number of passes
// (ceil(key_bits / 8)), else in (kb, pb). scratch holds 2 passes 2^8 + 1 +
// ceil(n / jf_radix_tile()) 2^8 int64 words.
extern "C" int jf_radix_sort(const void* keys_, const void* pay, void* ka,
                             void* pa, void* kb, void* pb, long long n,
                             int key_bits, void* scratch_, void* stream) {
  if (n < 1 || key_bits < 1 || key_bits > 64) return (int)cudaErrorInvalidValue;
  const long long* keys = (const long long*)keys_;
  long long* scratch = (long long*)scratch_;
  cudaStream_t st = (cudaStream_t)stream;
  const int passes = (key_bits + kBits - 1) / kBits;
  const u64 flip = key_bits == 64 ? 1ull << 63 : 0;
  u64* hist = reinterpret_cast<u64*>(scratch);
  long long* base = scratch + (size_t)passes * R;
  u64* status = reinterpret_cast<u64*>(scratch + (size_t)2 * passes * R);
  const long long tiles = (n + TILE - 1) / TILE;
  int dev = 0, sms = 0, e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return e;
  if ((e = cudaFuncSetAttribute(radix_pass_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sizeof(PassSmem))))
    return e;
  if ((e = cudaMemsetAsync(hist, 0, sizeof(u64) * passes * R, st))) return e;
  const long long chunk = (long long)kHistThreads * kHistUnroll;
  const long long hist_blocks =
      (n + chunk - 1) / chunk < 4ll * sms ? (n + chunk - 1) / chunk : 4ll * sms;
  radix_hist_kernel<<<(unsigned)hist_blocks, kHistThreads,
                      sizeof(unsigned int) * passes * R, st>>>(
      keys, n, passes, flip, hist);
  if ((e = cudaGetLastError())) return e;
  radix_scan_kernel<<<passes, R, 0, st>>>(hist, base);
  if ((e = cudaGetLastError())) return e;
  const long long* ik = keys;
  const long long* ip = (const long long*)pay;
  for (int p = 0; p < passes; ++p) {
    long long* ok = (long long*)(p % 2 ? kb : ka);
    long long* op = (long long*)(p % 2 ? pb : pa);
    if ((e = cudaMemsetAsync(status, 0, sizeof(u64) * (1 + tiles * R), st)))
      return e;
    radix_pass_kernel<<<(unsigned)tiles, T, sizeof(PassSmem), st>>>(
        ik, ip, ok, op, n, p * kBits, flip, base + (size_t)p * R, status);
    if ((e = cudaGetLastError())) return e;
    ik = ok;
    ip = op;
  }
  return 0;
}
