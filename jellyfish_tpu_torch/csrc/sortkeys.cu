// The chunk pipeline in one pass: B host-packed chunks -> the premasked,
// hash-ordered sort keys of their windows and the count of the valid
// windows. Two kernels, one a key width: sortkeys_kernel for keys of one
// packed int64 column (2k <= 64), sortkeys_limbs_kernel for keys of 3 or 4
// 32-bit limb columns (64 < 2k <= 128).
//
// They replace no Pallas kernel. The JAX package runs this step as one
// jitted program a batch (jellyfish_tpu/counter.py
// _chunk_pipeline_packed_batch), which XLA fuses; the port ran it as plain
// PyTorch, about 400 elementwise int64 launches a batch, each writing 8
// bytes a window (a limb at 2k > 64) (kernels/sortkeys.py sortkeys_plain,
// kept as the CPU route and as the reference both kernels are held to, bit
// for bit).
//
// Bound on this card: bytes, the output's. A chunk of L bases is L/4 bytes
// of codes and L/8 of validity bits, and gives 16 Mp windows of 8 bytes
// (2k <= 64) or of W limbs of 8 bytes: at the count's batch (8 chunks of
// 2^20 bases) 3 MiB in and 67.1 MB out at k = 21, about 21 us at 3.35
// TB/s, and 268.4 MB out at k = 55 (W = 4), about 80 us. A window's
// arithmetic (funnel read, invalid test, canonical fold, GF(2) hash, sort
// key) is some tens of integer operations, and one table lookup a key
// byte. The design keeps to one write of the output and one read of the
// input:
//   - a thread takes one slot m of one chunk, the 16 windows that start at
//     16m .. 16m + 15 (one a phase). It reads the code words and validity
//     words that they span once, into registers (3 and 2 at 2k <= 64, 5
//     and 3 above: 16 + k - 1 <= 79 bases), and cuts each window out of
//     them by shifts (128-bit funnel shifts of two 64-bit words above);
//     its neighbours' reads of the same words hit L1;
//   - window (b, phi, m) is output row b 16 Mp + phi Mp + m, the
//     phase-major order of ops/mers.py: for each phase the 32 lanes of a
//     warp write 32 consecutive rows, 256 coalesced bytes (1 KiB at W = 4,
//     as two 16-byte vectors a lane; 768 B at W = 3, as three 8-byte
//     words), as streaming stores (the store sorts them only once a grain
//     of many batches has gathered, long after they left L2);
//   - the hash by per-byte column tables in shared memory, built on the
//     host from the matrix's masks (kernels/sortkeys.py hash_tables): pos
//     is the XOR of one lookup a key byte (6 at k = 21, 14 at k = 55),
//     where the plain route takes one parity a pos bit (27 at -s 100M);
//   - persistent blocks (kBlocksPerSM an SM at most, as many as fit; a
//     grid-stride loop over the slots), so that each block loads the
//     tables once (up to 32 KiB at 2k = 128 with 64-bit entries);
//   - the valid count summed in the warp and the block, then one atomicAdd
//     a block into the zeroed int64.
// The two widths keep separate kernels on purpose: one 64-bit register a
// key against two, and the short keys do not pay for the wider plan.
// The input words are 32-bit words held as int32 (numpy's uint32, copied as
// they are) or as int64 values 0 .. 2^32 - 1 (the port's older callers).
//
// Measured on one H100 at the count's batch (PERF.md, kernel_ab.py's
// pipeline cases): 0.044 ms at k = 21, about half its bound, against 35 ms
// for the plain route; pos by popcount (one parity a pos bit) took 0.127
// ms. At k = 55 0.155 ms, about half its 0.080 ms bound, against 59 ms for
// the plain route; lookups without the byte-count test (zeroed table rows
// past the key, or the test only past the width's fewest bytes) took
// 0.189 ms, and the limb width as a template parameter 0.152 ms. What is
// left is likely the tables' bank conflicts (a warp's 32 random lookups
// into 256 words); the kernel is about 6 ms of a k = 21 count job of 4-9
// s, and 20 ms of a k = 55 job of about 6.5 s.

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

// Copy the tables of `nbytes` key bytes (256 entries each, of 32 or 64
// bits) into shared memory
template <int HASH>
__device__ __forceinline__ void load_tables(u32* s_tab, const u32* tables,
                                            int nbytes) {
  const int words = nbytes * 256 * (HASH == kTable64 ? 2 : 1);
  for (int i = threadIdx.x; i < words; i += kThreads) s_tab[i] = tables[i];
  __syncthreads();
}

// Sum the threads' valid counts in the warp and the block, and add the
// block's total to *n_valid
__device__ __forceinline__ void add_block_count(u32 count, u32* s_count,
                                                u64* n_valid) {
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
__global__ void __launch_bounds__(kThreads)
sortkeys_kernel(const Word* __restrict__ pw, const Word* __restrict__ vb,
                long long* __restrict__ out, u64* __restrict__ n_valid,
                const u32* __restrict__ tables, long long items, long long npw,
                long long nvb, long long Mp, long long N, int k, int lsize) {
  __shared__ __align__(8) u32 s_tab[TableWords<HASH>::value];
  __shared__ u32 s_count[kThreads / 32];
  const int c = 2 * k;
  const int nbytes = (c + 7) / 8;
  if (HASH != kIdentity) load_tables<HASH>(s_tab, tables, nbytes);
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
  add_block_count(count, s_count, n_valid);
}

// -- keys of 3 or 4 limbs (64 < 2k <= 128) ----------------------------------

constexpr int kMaxLimbKeyBytes = 16;  // 2k <= 128

// Shared words of the tables: up to 16 key bytes of 256 entries (32 KiB
// of 64-bit entries at most)
template <int HASH>
struct LimbTableWords {
  static constexpr int value =
      kMaxLimbKeyBytes * 256 * (HASH == kTable64 ? 2 : 1);
};

// A key of up to 128 bits in two 64-bit registers
struct u128 {
  u64 hi, lo;
};

// x >> s for 0 <= s < 64
__device__ __forceinline__ u128 shr(u128 x, int s) {
  return {x.hi >> s, (x.lo >> s) | ((x.hi << 1) << (63 - s))};
}

// x << t as 128 bits, for a 64-bit x and 0 <= t < 128
__device__ __forceinline__ u128 shl_wide(u64 x, int t) {
  if (t >= 64) return {x << (t - 64), 0};
  return {(x >> 1) >> (63 - t), x << t};
}

__device__ __forceinline__ u64 pair_swap(u64 r) {
  return ((r >> 1) & kPairLow) | ((r & kPairLow) << 1);
}

// The reverse complement of a c-bit key, 64 < c <= 128, s = 128 - c:
// complement, reverse all 128 bits (the words' bits reversed and the words
// swapped), swap the two bits of each base back, drop the s bits below
__device__ __forceinline__ u128 reverse_complement_wide(u128 key, int s) {
  return shr({pair_swap(__brevll(~key.lo)), pair_swap(__brevll(~key.hi))},
             s);
}

__device__ __forceinline__ bool less_wide(u128 a, u128 b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

template <typename Word, bool CANON, int HASH>
__global__ void __launch_bounds__(kThreads)
sortkeys_limbs_kernel(const Word* __restrict__ pw,
                      const Word* __restrict__ vb, long long* __restrict__ out,
                      u64* __restrict__ n_valid,
                      const u32* __restrict__ tables, long long items,
                      long long npw, long long nvb, long long Mp, long long N,
                      int k, int lsize) {
  static_assert(HASH == kTable32 || HASH == kTable64, "hashed keys only");
  __shared__ __align__(8) u32 s_tab[LimbTableWords<HASH>::value];
  __shared__ u32 s_count[kThreads / 32];
  const int c = 2 * k;
  const int nbytes = (c + 7) / 8;
  load_tables<HASH>(s_tab, tables, nbytes);
  const bool four = c > 96;                   // 4 limbs a key, else 3
  const int W = four ? 4 : 3;
  const int s = 128 - c;                      // the window's drop, 0 .. 63
  const int t = c - lsize;                    // pos's shift, 2 .. 127
  const u64 window_bits = ~0ull >> (64 - k);  // 32 < k <= 64
  constexpr long long kLimb = 0xffffffffll;   // PAD, in every column
  u32 count = 0;
  for (long long it = (long long)blockIdx.x * kThreads + threadIdx.x;
       it < items; it += (long long)gridDim.x * kThreads) {
    const long long b = it / Mp, m = it - b * Mp;
    const Word* p = pw + b * npw;
    const Word* v = vb + b * nvb;
    // bases 16m .. 16m + 79, big-endian 2-bit codes: a the first 32, a2 the
    // next 32, a3 the last 16 (in its top half)
    const u64 a = ((u64)word_at(p, m, npw) << 32) | word_at(p, m + 1, npw);
    const u64 a2 =
        ((u64)word_at(p, m + 2, npw) << 32) | word_at(p, m + 3, npw);
    const u64 a3 = (u64)word_at(p, m + 4, npw) << 32;
    // bit i of (bad_hi, bad): base 16m + i is not ACGT (little-endian
    // validity words), i < 80
    const long long j = m >> 1;
    const int off = 16 * (int)(m & 1);
    const u64 v01 = ((u64)word_at(v, j + 1, nvb) << 32) | word_at(v, j, nvb);
    const u32 v2 = word_at(v, j + 2, nvb);
    const u64 bad = ~(off ? (v01 >> 16) | ((u64)v2 << 48) : v01);
    const u32 bad_hi = ~(v2 >> off);
    long long* o = out + (b * 16 * Mp + m) * W;
    const long long step = Mp * W;
#pragma unroll
    for (int phi = 0; phi < 16; ++phi) {
      const int d = 2 * phi;
      const u128 y = {d ? (a << d) | (a2 >> (64 - d)) : a,
                      d ? (a2 << d) | (a3 >> (64 - d)) : a2};
      u128 key = shr(y, s);
      if (CANON) {
        const u128 rc = reverse_complement_wide(key, s);
        key = less_wide(rc, key) ? rc : key;
      }
      const u32 kw[4] = {(u32)key.lo, (u32)(key.lo >> 32), (u32)key.hi,
                         (u32)(key.hi >> 32)};
      u64 pos = 0;
#pragma unroll
      for (int i = 0; i < kMaxLimbKeyBytes; ++i) {
        if (i < nbytes) {
          const int e = i * 256 + (int)((kw[i / 4] >> (8 * (i % 4))) & 255);
          pos ^= HASH == kTable64 ? reinterpret_cast<const u64*>(s_tab)[e]
                                  : (u64)s_tab[e];
        }
      }
      // (pos << (c - l)) | (key >> l); pos holds l <= 64 bits
      const u128 hi = shl_wide(pos, t);
      const u128 lo = lsize < 64 ? shr(key, lsize) : u128{0, key.hi};
      const u128 sk = {hi.hi | lo.hi, hi.lo | lo.lo};
      const u64 w = phi ? (bad >> phi) | ((u64)bad_hi << (64 - phi)) : bad;
      const bool valid = 16 * m + phi < N && (w & window_bits) == 0;
      count += valid;
      long long* row = o + phi * step;
      const long long l0 = valid ? (long long)(sk.lo & kLimb) : kLimb;
      const long long l1 = valid ? (long long)(sk.lo >> 32) : kLimb;
      const long long l2 = valid ? (long long)(sk.hi & kLimb) : kLimb;
      if (four) {
        const long long l3 = valid ? (long long)(sk.hi >> 32) : kLimb;
        __stcs(reinterpret_cast<longlong2*>(row), make_longlong2(l0, l1));
        __stcs(reinterpret_cast<longlong2*>(row) + 1, make_longlong2(l2, l3));
      } else {
        __stcs(row, l0);
        __stcs(row + 1, l1);
        __stcs(row + 2, l2);
      }
    }
  }
  add_block_count(count, s_count, n_valid);
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

template <typename Word, bool CANON, int HASH>
int launch_limbs(const void* pw, const void* vb, void* out, void* n_valid,
                 const void* tables, long long items, long long npw,
                 long long nvb, long long Mp, long long N, int k, int lsize,
                 cudaStream_t st) {
  const auto kernel = sortkeys_limbs_kernel<Word, CANON, HASH>;
  int dev = 0, sms = 0, fit = 0, e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                         kThreads, 0)))
    return e;
  if ((e = cudaMemsetAsync(n_valid, 0, sizeof(u64), st))) return e;
  if (items == 0) return 0;
  const long long per_sm = fit < kBlocksPerSM ? (fit > 0 ? fit : 1)
                                              : kBlocksPerSM;
  const long long need = (items + kThreads - 1) / kThreads;
  const long long blocks = need < per_sm * sms ? need : per_sm * sms;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const Word*)pw, (const Word*)vb, (long long*)out, (u64*)n_valid,
      (const u32*)tables, items, npw, nvb, Mp, N, k, lsize);
  return cudaGetLastError();
}

template <typename Word, bool CANON>
int limbs_by_hash(int hash, const void* pw, const void* vb, void* out,
                  void* nv, const void* tab, long long items, long long npw,
                  long long nvb, long long Mp, long long N, int k, int lsize,
                  cudaStream_t st) {
  if (hash == kTable32)
    return launch_limbs<Word, CANON, kTable32>(pw, vb, out, nv, tab, items,
                                               npw, nvb, Mp, N, k, lsize, st);
  if (hash == kTable64)
    return launch_limbs<Word, CANON, kTable64>(pw, vb, out, nv, tab, items,
                                               npw, nvb, Mp, N, k, lsize, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B chunks of L bases (L a multiple of 16, L >= k): pw [B][npw = L/16] and
// vb [B][nvb = ceil(L/32)] words of word_bytes (4: int32, 8: int64) ->
// out [B * 16 * Mp][Wk] int64 (Mp = (L - k) / 16 + 1, N = L - k + 1
// windows in range; Wk 1, the packed key, at k <= 32, else the W =
// ceil(2k / 32) limbs) and n_valid, one int64. hash: 0 identity (tables
// unused; k <= 32 only), 1 and 2 tables of ceil(2k / 8) x 256 entries of
// 32 and 64 bits. The key's width picks the kernel: k <= 32 the packed
// one, 32 < k <= 64 the limb one.
extern "C" int jf_sortkeys(const void* pw, const void* vb, int word_bytes,
                           void* out, void* n_valid, const void* tables,
                           long long B, long long npw, long long nvb,
                           long long Mp, long long N, int k, int lsize,
                           int canonical, int hash, void* stream) {
  if (k < 1 || k > 64 || lsize < 1 || lsize > 2 * k || lsize > 64 || B < 0 ||
      Mp < 1 || (word_bytes != 4 && word_bytes != 8) || hash < 0 ||
      hash > 2 || (k > 32 && hash == kIdentity))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = B * Mp;
  if (k > 32) {
    if (word_bytes == 4)
      return canonical ? limbs_by_hash<int, true>(hash, pw, vb, out, n_valid,
                                                  tables, items, npw, nvb, Mp,
                                                  N, k, lsize, st)
                       : limbs_by_hash<int, false>(hash, pw, vb, out, n_valid,
                                                   tables, items, npw, nvb,
                                                   Mp, N, k, lsize, st);
    return canonical
               ? limbs_by_hash<long long, true>(hash, pw, vb, out, n_valid,
                                                tables, items, npw, nvb, Mp, N,
                                                k, lsize, st)
               : limbs_by_hash<long long, false>(hash, pw, vb, out, n_valid,
                                                 tables, items, npw, nvb, Mp,
                                                 N, k, lsize, st);
  }
  if (word_bytes == 4)
    return canonical
               ? by_hash<int, true>(hash, pw, vb, out, n_valid, tables, items,
                                    npw, nvb, Mp, N, k, lsize, st)
               : by_hash<int, false>(hash, pw, vb, out, n_valid, tables,
                                     items, npw, nvb, Mp, N, k, lsize, st);
  return canonical
             ? by_hash<long long, true>(hash, pw, vb, out, n_valid, tables,
                                        items, npw, nvb, Mp, N, k, lsize, st)
             : by_hash<long long, false>(hash, pw, vb, out, n_valid, tables,
                                         items, npw, nvb, Mp, N, k, lsize, st);
}
