// The chunk pipeline in one pass: B host-packed chunks -> the premasked,
// hash-ordered sort keys of their windows, keys of one packed int64 column
// (2k <= 64), and the count of the valid windows.
//
// It replaces no Pallas kernel. The JAX package runs this step as one jitted
// program a batch (jellyfish_tpu/counter.py _chunk_pipeline_packed_batch),
// which XLA fuses; the port ran it as plain PyTorch, about 400 elementwise
// int64 launches a batch at k = 21, each writing 8 bytes a window
// (kernels/sortkeys.py sortkeys_plain, kept as the CPU route and as the
// reference this kernel is held to, bit for bit).
//
// Bound on this card: bytes, the output's. A chunk of L bases is L/4 bytes
// of codes and L/8 of validity bits, and gives 16 Mp windows of 8 bytes:
// at the count's batch (8 chunks of 2^20 bases) 3 MiB in and 67.1 MB out,
// about 21 us at 3.35 TB/s. A window's arithmetic (funnel read, invalid
// test, canonical fold, GF(2) hash, sort key) is some tens of integer
// operations. The design keeps to one write of the output and one read of
// the input:
//   - a thread takes one slot m of one chunk, the 16 windows that start at
//     16m .. 16m + 15 (one a phase). It reads the three code words and the
//     two validity words that they span once, into registers, and cuts each
//     window out of them by shifts; its neighbours' reads of the same words
//     hit L1;
//   - window (b, phi, m) is output row b 16 Mp + phi Mp + m, the
//     phase-major order of ops/mers.py: for each phase the 32 lanes of a
//     warp write 32 consecutive rows, 256 coalesced bytes, as streaming
//     stores (the store sorts them only once a grain of many batches has
//     gathered, long after they left L2);
//   - the hash by per-byte column tables in shared memory, built on the
//     host from the matrix's masks (kernels/sortkeys.py hash_tables): pos
//     is the XOR of one lookup a key byte (6 at k = 21), where the plain
//     route takes one parity a pos bit (27 at -s 100M);
//   - persistent blocks (kBlocksPerSM an SM, a grid-stride loop over the
//     slots), so that each block loads the tables once;
//   - the valid count summed in the warp and the block, then one atomicAdd
//     a block into the zeroed int64.
// The input words are 32-bit words held as int32 (numpy's uint32, copied as
// they are) or as int64 values 0 .. 2^32 - 1 (the port's older callers).
//
// Measured on one H100 at the count's batch (PERF.md, kernel_ab.py's
// pipeline cases): 0.044 ms, about half its bound, against 35 ms for the
// plain route; pos by popcount (one parity a pos bit) took 0.127 ms. What
// is left is likely the tables' bank conflicts (a warp's 32 random lookups
// into 256 words); the kernel is about 6 ms of a count job of 4-9 s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kMaxKeyBytes = 8;  // 2k <= 64
constexpr u64 kPairLow = 0x5555555555555555ull;
constexpr long long kPad = 0x7fffffffffffffffll;  // INT64_MAX

// How pos is computed: no hash (the identity matrix: the sort key is the
// key), or tables of 32-bit (lsize <= 32) or 64-bit entries
enum Hash { kIdentity = 0, kTable32 = 1, kTable64 = 2 };

// Shared words of the tables: a key byte's 256 entries, for each of up
// to 8 key bytes
template <int HASH>
struct TableWords {
  static constexpr int value =
      HASH == kIdentity ? 1 : kMaxKeyBytes * 256 * (HASH == kTable64 ? 2 : 1);
};

template <typename Word>
__device__ __forceinline__ u32 word_at(const Word* p, long long i,
                                       long long n) {
  return i < n ? (u32)__ldg(p + i) : 0u;
}

// The reverse complement of a c-bit key (mer_dna.hpp:83-90): complement
// every base, reverse the bit order, swap the two bits of each base back,
// drop the 64 - c bits below.
__device__ __forceinline__ u64 reverse_complement(u64 key, int c) {
  const u64 r = __brevll(~key);
  return (((r >> 1) & kPairLow) | ((r & kPairLow) << 1)) >> (64 - c);
}

template <typename Word, bool CANON, int HASH>
__global__ void __launch_bounds__(kThreads)
sortkeys_kernel(const Word* __restrict__ pw, const Word* __restrict__ vb,
                long long* __restrict__ out, u64* __restrict__ n_valid,
                const u32* __restrict__ tables, long long items, long long npw,
                long long nvb, long long Mp, long long N, int k, int lsize) {
  __shared__ __align__(8) u32 s_tab[TableWords<HASH>::value];
  __shared__ u32 s_count[kThreads / 32];
  const int c = 2 * k;
  const int nbytes = (c + 7) / 8;
  if (HASH != kIdentity) {
    const int words = nbytes * 256 * (HASH == kTable64 ? 2 : 1);
    for (int i = threadIdx.x; i < words; i += kThreads) s_tab[i] = tables[i];
    __syncthreads();
  }
  const u64 window_bits = (1ull << k) - 1;  // k <= 32
  u32 count = 0;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < items; t += (long long)gridDim.x * kThreads) {
    const long long b = t / Mp, m = t - b * Mp;
    const Word* p = pw + b * npw;
    const Word* v = vb + b * nvb;
    // bases 16m .. 16m + 47, big-endian 2-bit codes: x the first 32, x2
    // the next 16
    const u64 x = ((u64)word_at(p, m, npw) << 32) | word_at(p, m + 1, npw);
    const u32 x2 = word_at(p, m + 2, npw);
    // bit i: base 16m + i is not ACGT (little-endian validity words)
    const long long j = m >> 1;
    const u64 bad =
        ~((((u64)word_at(v, j + 1, nvb) << 32) | word_at(v, j, nvb)) >>
          (16 * (m & 1)));
    long long* o = out + b * 16 * Mp + m;
#pragma unroll
    for (int phi = 0; phi < 16; ++phi) {
      const u64 y = phi ? (x << (2 * phi)) | (x2 >> (32 - 2 * phi)) : x;
      u64 key = y >> (64 - c);
      if (CANON) {
        const u64 rc = reverse_complement(key, c);
        key = rc < key ? rc : key;
      }
      u64 sk = key;
      if (HASH != kIdentity) {
        u64 pos = 0;
#pragma unroll
        for (int i = 0; i < kMaxKeyBytes; ++i) {
          if (i < nbytes) {
            const int e = i * 256 + (int)((key >> (8 * i)) & 255);
            pos ^= HASH == kTable64
                       ? reinterpret_cast<const u64*>(s_tab)[e]
                       : (u64)s_tab[e];
          }
        }
        sk = (pos << (c - lsize)) | (lsize < 64 ? key >> lsize : 0);
      }
      const bool valid = 16 * m + phi < N && ((bad >> phi) & window_bits) == 0;
      count += valid;
      __stcs(o + phi * Mp,
             valid ? (long long)(sk ^ (1ull << 63)) : kPad);
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) s_count[threadIdx.x / 32] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_count[w];
    if (total) atomicAdd(n_valid, total);
  }
}

template <typename Word, bool CANON, int HASH>
int launch(const void* pw, const void* vb, void* out, void* n_valid,
           const void* tables, long long items, long long npw, long long nvb,
           long long Mp, long long N, int k, int lsize, cudaStream_t st) {
  int dev = 0, sms = 0, e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return e;
  if ((e = cudaMemsetAsync(n_valid, 0, sizeof(u64), st))) return e;
  if (items == 0) return 0;
  const long long need = (items + kThreads - 1) / kThreads;
  const long long blocks = need < (long long)kBlocksPerSM * sms
                               ? need : (long long)kBlocksPerSM * sms;
  sortkeys_kernel<Word, CANON, HASH><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const Word*)pw, (const Word*)vb, (long long*)out, (u64*)n_valid,
      (const u32*)tables, items, npw, nvb, Mp, N, k, lsize);
  return cudaGetLastError();
}

template <typename Word, bool CANON>
int by_hash(int hash, const void* pw, const void* vb, void* out, void* nv,
            const void* tab, long long items, long long npw, long long nvb,
            long long Mp, long long N, int k, int lsize, cudaStream_t st) {
  switch (hash) {
    case kIdentity:
      return launch<Word, CANON, kIdentity>(pw, vb, out, nv, tab, items, npw,
                                            nvb, Mp, N, k, lsize, st);
    case kTable32:
      return launch<Word, CANON, kTable32>(pw, vb, out, nv, tab, items, npw,
                                           nvb, Mp, N, k, lsize, st);
    case kTable64:
      return launch<Word, CANON, kTable64>(pw, vb, out, nv, tab, items, npw,
                                           nvb, Mp, N, k, lsize, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B chunks of L bases (L a multiple of 16, L >= k): pw [B][npw = L/16] and
// vb [B][nvb = ceil(L/32)] words of word_bytes (4: int32, 8: int64) ->
// out [B * 16 * Mp] int64 (Mp = (L - k) / 16 + 1, N = L - k + 1 windows
// in range) and n_valid, one int64. hash: 0 identity (tables unused), 1
// and 2 tables of ceil(2k / 8) x 256 entries of 32 and 64 bits.
extern "C" int jf_sortkeys(const void* pw, const void* vb, int word_bytes,
                           void* out, void* n_valid, const void* tables,
                           long long B, long long npw, long long nvb,
                           long long Mp, long long N, int k, int lsize,
                           int canonical, int hash, void* stream) {
  if (k < 1 || k > 32 || lsize < 1 || lsize > 2 * k || B < 0 || Mp < 1 ||
      (word_bytes != 4 && word_bytes != 8) || hash < 0 || hash > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = B * Mp;
  if (word_bytes == 4)
    return canonical
               ? by_hash<int, true>(hash, pw, vb, out, n_valid, tables, items,
                                    npw, nvb, Mp, N, k, lsize, st)
               : by_hash<int, false>(hash, pw, vb, out, n_valid, tables, items,
                                     npw, nvb, Mp, N, k, lsize, st);
  return canonical
             ? by_hash<long long, true>(hash, pw, vb, out, n_valid, tables,
                                        items, npw, nvb, Mp, N, k, lsize, st)
             : by_hash<long long, false>(hash, pw, vb, out, n_valid, tables,
                                         items, npw, nvb, Mp, N, k, lsize, st);
}
