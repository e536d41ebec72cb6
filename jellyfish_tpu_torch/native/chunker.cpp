// Native FASTA/FASTQ chunk scanner — the host-side hot path.
//
// Role of the reference's mer_overlap_sequence_parser/whole_sequence_parser
// (+ cooperative_pool2): turn sequence streams into fixed-size uint8 chunks
// for the device pipeline with
//   - a separator byte between reads (no mer spans two reads;
//     mer_overlap_sequence_parser.hpp:88 'N'-insertion convention),
//   - a k-1 byte seam carried between consecutive chunks of one stream
//     (mer_overlap_sequence_parser.hpp:164-216),
//   - optional quality masking: bases with qual < min become 'N'
//     (mer_qual_iterator.hpp:74-84),
//   - DOS line endings and multi-line records tolerated
//     (mer_overlap_sequence_parser.hpp:266-287).
//
// Push-based FSM: python feeds raw bytes (it owns file/gzip/pipe IO),
// C++ does all per-byte work and chunk assembly. Exposed via a C ABI for
// ctypes (no pybind11 in this image).

#include <algorithm>
#include <array>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <new>
#include <string>
#include <vector>

namespace {

constexpr uint8_t SEP = 'N';

enum class Fmt : uint8_t { UNKNOWN, FASTA, FASTQ };

enum class St : uint8_t {
  START,        // expecting '>' or '@'
  HEADER,       // skipping a header line
  SEQ,          // consuming sequence lines (FASTA: until '>', FASTQ: until '+')
  PLUS,         // skipping the FASTQ '+' line
  QUAL,         // consuming quality bytes (counted against seq length)
};

struct Chunker {
  int      k;
  long     chunk_len;
  int      min_qual;       // -1: no quality filtering
  Fmt      fmt = Fmt::UNKNOWN;
  St       st = St::START;
  bool     at_line_start = true;
  uint64_t reads = 0;

  // current chunk under construction
  std::vector<uint8_t> buf;
  long fill = 0;
  bool wrote_any_base = false;   // current read contributed bytes to buf

  // FASTQ quality handling: sequence bytes of the current read are staged
  // until their quality bytes arrive, then masked and emitted.
  std::vector<uint8_t> seq_stage;
  size_t qual_seen = 0;

  std::deque<std::vector<uint8_t>> ready;

  explicit Chunker(int k_, long len, int mq)
      : k(k_), chunk_len(len), min_qual(mq) {
    buf.assign(chunk_len, SEP);
  }

  void emit_chunk_mid_read() {
    // chunk is full mid-read: publish it and seam-carry the last k-1 bytes
    ready.emplace_back(std::move(buf));
    const std::vector<uint8_t>& old = ready.back();
    buf.assign(chunk_len, SEP);
    if (k > 1) {
      std::memcpy(buf.data(), old.data() + chunk_len - (k - 1), k - 1);
      fill = k - 1;
    } else {
      fill = 0;
    }
  }

  void emit_chunk_between_reads() {
    ready.emplace_back(std::move(buf));
    buf.assign(chunk_len, SEP);
    fill = 0;
  }

  inline void push_base(uint8_t b) {
    if (fill >= chunk_len) emit_chunk_mid_read();
    buf[fill++] = b;
    wrote_any_base = true;
  }

  void end_read() {
    if (!wrote_any_base) return;
    reads++;
    wrote_any_base = false;
    if (fill >= chunk_len) {
      // exactly full of this read's end: next read starts a fresh chunk
      emit_chunk_between_reads();
    } else {
      buf[fill++] = SEP;  // separator breaks mers to the next read
    }
  }

  void flush_fastq_read() {
    // emit staged sequence with quality mask applied
    for (uint8_t b : seq_stage) push_base(b);
    seq_stage.clear();
    qual_seen = 0;
    end_read();
  }

  void feed(const uint8_t* p, long n) {
    const uint8_t* end = p + n;
    while (p < end) {
      uint8_t c = *p;
      switch (st) {
        case St::START: {
          if (c == '>') { fmt = Fmt::FASTA; st = St::HEADER; p++; }
          else if (c == '@') { fmt = Fmt::FASTQ; st = St::HEADER; p++; }
          else p++;  // skip blank/garbage between records
          break;
        }
        case St::HEADER: {
          const uint8_t* nl = static_cast<const uint8_t*>(
              std::memchr(p, '\n', end - p));
          if (!nl) { p = end; break; }
          p = nl + 1;
          st = St::SEQ;
          at_line_start = true;
          break;
        }
        case St::SEQ: {
          if (at_line_start) {
            if (fmt == Fmt::FASTA && c == '>') {
              end_read(); st = St::HEADER; p++; break;
            }
            if (fmt == Fmt::FASTQ && c == '+') {
              st = St::PLUS; p++; break;
            }
          }
          if (c == '\n') { at_line_start = true; p++; break; }
          if (c == '\r') { p++; break; }
          at_line_start = false;
          // consume a run of sequence bytes up to newline/end
          const uint8_t* nl = static_cast<const uint8_t*>(
              std::memchr(p, '\n', end - p));
          const uint8_t* stop = nl ? nl : end;
          if (fmt == Fmt::FASTQ && min_qual >= 0) {
            seq_stage.insert(seq_stage.end(), p, stop);
            // strip any trailing \r lazily when quality masks are applied:
            while (!seq_stage.empty() && seq_stage.back() == '\r')
              seq_stage.pop_back();
          } else if (fmt == Fmt::FASTQ) {
            for (const uint8_t* q = p; q < stop; ++q)
              if (*q != '\r') { push_base(*q); seq_stage.push_back(0); }
            // seq_stage tracks length only (zeros) for qual accounting
          } else {
            for (const uint8_t* q = p; q < stop; ++q)
              if (*q != '\r') push_base(*q);
          }
          p = stop;
          break;
        }
        case St::PLUS: {
          const uint8_t* nl = static_cast<const uint8_t*>(
              std::memchr(p, '\n', end - p));
          if (!nl) { p = end; break; }
          p = nl + 1;
          st = St::QUAL;
          break;
        }
        case St::QUAL: {
          if (c == '\n' || c == '\r') { p++; break; }
          const uint8_t* nl = static_cast<const uint8_t*>(
              std::memchr(p, '\n', end - p));
          const uint8_t* stop = nl ? nl : end;
          long take = stop - p;
          if (p < stop && stop[-1] == '\r') take--;
          long need = static_cast<long>(seq_stage.size() - qual_seen);
          if (take > need) take = need;
          if (min_qual >= 0) {
            for (long i = 0; i < take; ++i)
              if (p[i] < static_cast<uint8_t>(min_qual))
                seq_stage[qual_seen + i] = SEP;
          }
          qual_seen += take;
          p = stop;
          if (qual_seen >= seq_stage.size()) {
            if (min_qual >= 0) flush_fastq_read();
            else { seq_stage.clear(); qual_seen = 0; end_read(); }
            st = St::START;
          }
          break;
        }
      }
    }
  }

  void end_stream() {
    // EOF inside a record: finish whatever is staged
    if (st == St::QUAL || (fmt == Fmt::FASTQ && min_qual >= 0 &&
                           !seq_stage.empty())) {
      if (min_qual >= 0) flush_fastq_read();
      else { seq_stage.clear(); qual_seen = 0; end_read(); }
    } else {
      seq_stage.clear();
      qual_seen = 0;
      end_read();
    }
    st = St::START;
    fmt = Fmt::UNKNOWN;
    at_line_start = true;
  }

  // final partial chunk (if it holds any content)
  bool finish(uint8_t* out) {
    end_stream();
    if (!ready.empty() || fill > 0) {
      if (fill > 0) {
        std::memcpy(out, buf.data(), chunk_len);
        buf.assign(chunk_len, SEP);
        fill = 0;
        return true;
      }
    }
    return false;
  }
};

}  // namespace

extern "C" {

Chunker* jf_chunker_new(int k, long chunk_len, int min_qual) {
  return new (std::nothrow) Chunker(k, chunk_len, min_qual);
}

void jf_chunker_free(Chunker* c) { delete c; }

void jf_chunker_feed(Chunker* c, const uint8_t* data, long n) {
  c->feed(data, n);
}

void jf_chunker_end_stream(Chunker* c) { c->end_stream(); }

// pop one ready chunk into out[chunk_len]; returns 1 if popped
int jf_chunker_pop(Chunker* c, uint8_t* out) {
  if (c->ready.empty()) return 0;
  std::memcpy(out, c->ready.front().data(), c->chunk_len);
  c->ready.pop_front();
  return 1;
}

int jf_chunker_finish(Chunker* c, uint8_t* out) {
  return c->finish(out) ? 1 : 0;
}

unsigned long long jf_chunker_reads(Chunker* c) { return c->reads; }

// Pack an ASCII chunk into the device's native input layout:
//   pwords[L/16]: 2-bit codes, 16 bases per u32, big-endian within the
//                 word (A=0 C=1 G=2 T=3; the (ch>>1)&3 + Gray-swap trick)
//   validbits[L/32]: bit i (little-endian within words) = base i is ACGT
// This removes the device-side encode pass and cuts host->device traffic
// 4.25x (0.28 bytes/base instead of 1).
void jf_pack_chunk(const uint8_t* chunk, long L, uint32_t* pwords,
                   uint32_t* validbits) {
  long nw = L / 16;
  for (long j = 0; j < nw; ++j) {
    uint32_t w = 0;
    const uint8_t* p = chunk + 16 * j;
    for (int t = 0; t < 16; ++t) {
      uint8_t b = (p[t] >> 1) & 3;
      b ^= b >> 1;
      w |= static_cast<uint32_t>(b) << (2 * (15 - t));
    }
    pwords[j] = w;
  }
  long nv = L / 32;
  for (long j = 0; j < nv; ++j) {
    uint32_t v = 0;
    const uint8_t* p = chunk + 32 * j;
    for (int t = 0; t < 32; ++t) {
      uint8_t lower = p[t] | 0x20;
      bool ok = lower == 'a' || lower == 'c' || lower == 'g' || lower == 't';
      v |= static_cast<uint32_t>(ok) << t;
    }
    validbits[j] = v;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// rANS 4x8 block decoder (CRAM compression method 4) — the hot inner
// loop of native CRAM reading (io/rans.py holds the reference
// implementation and fallback). Returns decoded length, or -1 on any
// malformed input (caller falls back to python for exact errors).

namespace {

struct RansIn {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint8_t u8() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }
};

constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kTotFreq = 1u << 12;

struct RansTable {
  // per 12-bit slot: symbol, its frequency and cumulative start
  uint8_t sym[kTotFreq];
  uint16_t freq[kTotFreq];
  uint16_t cum[kTotFreq];
};

static bool read_freqs0(RansIn& in, uint32_t f[256]) {
  std::memset(f, 0, 256 * sizeof(uint32_t));
  int sym = in.u8();
  int last = sym;
  int rle = 0;
  while (in.ok) {
    uint32_t v = in.u8();
    if (v >= 0x80) v = ((v & 0x7F) << 8) | in.u8();
    if (sym > 255) return false;
    f[sym] = v;
    if (rle > 0) {
      --rle;
      ++sym;
    } else {
      sym = in.u8();
      if (sym == last + 1) rle = in.u8();
    }
    last = sym;
    if (sym == 0) break;
  }
  return in.ok;
}

static bool build_table(const uint32_t f[256], RansTable& t) {
  uint32_t c = 0;
  for (int s = 0; s < 256; ++s) {
    if (!f[s]) continue;
    if (c + f[s] > kTotFreq) return false;
    for (uint32_t i = 0; i < f[s]; ++i) {
      t.sym[c + i] = static_cast<uint8_t>(s);
      t.freq[c + i] = static_cast<uint16_t>(f[s]);
      t.cum[c + i] = static_cast<uint16_t>(c);
    }
    c += f[s];
  }
  return true;
}

static bool rans_u32x4(RansIn& in, uint32_t x[4]) {
  for (int j = 0; j < 4; ++j) {
    if (in.end - in.p < 4) return false;
    x[j] = static_cast<uint32_t>(in.p[0]) | in.p[1] << 8 | in.p[2] << 16 |
           static_cast<uint32_t>(in.p[3]) << 24;
    in.p += 4;
  }
  return true;
}

static long rans_decode0(RansIn& in, uint8_t* out, long n) {
  uint32_t f[256];
  if (!read_freqs0(in, f)) return -1;
  auto t = std::make_unique<RansTable>();
  if (!build_table(f, *t)) return -1;
  uint32_t x[4];
  if (!rans_u32x4(in, x)) return -1;
  for (long i = 0; i < n; ++i) {
    uint32_t& s = x[i & 3];
    uint32_t m = s & (kTotFreq - 1);
    out[i] = t->sym[m];
    s = t->freq[m] * (s >> 12) + m - t->cum[m];
    while (s < kRansL) {
      if (in.p >= in.end) return -1;
      s = (s << 8) | *in.p++;
    }
  }
  return n;
}

static long rans_decode1(RansIn& in, uint8_t* out, long n) {
  std::vector<std::unique_ptr<RansTable>> tabs(256);
  {
    int ctx = in.u8();
    int last = ctx;
    int rle = 0;
    while (in.ok) {
      uint32_t f[256];
      if (ctx > 255 || !read_freqs0(in, f)) return -1;
      tabs[ctx] = std::make_unique<RansTable>();
      if (!build_table(f, *tabs[ctx])) return -1;
      if (rle > 0) {
        --rle;
        ++ctx;
      } else {
        ctx = in.u8();
        if (ctx == last + 1) rle = in.u8();
      }
      last = ctx;
      if (ctx == 0) break;
    }
    if (!in.ok) return -1;
  }
  uint32_t x[4];
  if (!rans_u32x4(in, x)) return -1;
  const long q = n >> 2;
  long pos[4] = {0, q, 2 * q, 3 * q};
  uint8_t ctxs[4] = {0, 0, 0, 0};
  auto step = [&](int j, long at) -> bool {
    RansTable* t = tabs[ctxs[j]].get();
    if (!t) return false;
    uint32_t& s = x[j];
    uint32_t m = s & (kTotFreq - 1);
    uint8_t sym = t->sym[m];
    out[at] = sym;
    s = t->freq[m] * (s >> 12) + m - t->cum[m];
    while (s < kRansL) {
      if (in.p >= in.end) return false;
      s = (s << 8) | *in.p++;
    }
    ctxs[j] = sym;
    return true;
  };
  for (long i = 0; i < q; ++i)
    for (int j = 0; j < 4; ++j)
      if (!step(j, pos[j] + i)) return -1;
  for (long i = 4 * q; i < n; ++i)
    if (!step(3, i)) return -1;
  return n;
}

}  // namespace

// data = full block: [order u8][comp_size u32le][raw_size u32le][payload]
extern "C" long jf_rans_decode(const uint8_t* data, long len, uint8_t* out,
                               long out_cap) {
  if (len < 9) return -1;
  const uint8_t order = data[0];
  uint32_t comp_size, raw_size;
  std::memcpy(&comp_size, data + 1, 4);
  std::memcpy(&raw_size, data + 5, 4);
  if (static_cast<long>(raw_size) > out_cap) return -1;
  if (9 + static_cast<long>(comp_size) > len) return -1;
  if (raw_size == 0) return 0;
  RansIn in{data + 9, data + 9 + comp_size};
  if (order == 0) return rans_decode0(in, out, raw_size);
  if (order == 1) return rans_decode1(in, out, raw_size);
  return -1;
}

// ---------------------------------------------------------------------
// rANS Nx16 block decoder (CRAM 3.1 compression method 5) — the bulk
// sequence codec of 3.1 files (io/rans16.py holds the reference
// implementation and fallback). Returns decoded length, or -1 on any
// malformed input (caller falls back to python for exact errors).
// Covers the full format: order-0/1, 4/32-way interleave, PACK, RLE,
// CAT, NOSZ, recursive STRIPE, order-0-compressed order-1 frequency
// tables and RLE metadata. The frequency normalisation mirrors
// io/rans16.py:_normalise byte-for-byte (both sides of the format
// normalise, so the arithmetic must match exactly).

namespace r16 {

constexpr uint32_t kL = 1u << 15;
constexpr int kShiftO0 = 12;

constexpr uint8_t F_ORDER1 = 0x01, F_N32 = 0x04, F_STRIPE = 0x08,
                  F_NOSZ = 0x10, F_CAT = 0x20, F_RLE = 0x40, F_PACK = 0x80;

struct In {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint8_t u8() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }
  uint16_t u16() {
    if (end - p < 2) {
      ok = false;
      return 0;
    }
    uint16_t v = static_cast<uint16_t>(p[0] | p[1] << 8);
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (end - p < 4) {
      ok = false;
      return 0;
    }
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  uint64_t uint7() {
    uint64_t v = 0;
    for (int i = 0; i < 10 && ok; ++i) {
      uint8_t b = u8();
      v = (v << 7) | (b & 0x7F);
      if (!(b & 0x80)) return v;
    }
    ok = false;
    return 0;
  }
  bool take(long n, const uint8_t** out) {
    if (end - p < n) return false;
    *out = p;
    p += n;
    return true;
  }
};

static bool read_alphabet(In& in, std::vector<int>& syms) {
  int sym = in.u8();
  int last = sym;
  int rle = 0;
  while (in.ok) {
    if (sym > 255) return false;
    syms.push_back(sym);
    if (rle > 0) {
      --rle;
      ++sym;
    } else {
      sym = in.u8();
      if (sym == last + 1) rle = in.u8();
    }
    last = sym;
    if (sym == 0) break;
  }
  return in.ok && !syms.empty();
}

// mirror of io/rans16.py:_normalise — deterministic on both sides
static bool normalise(uint64_t f[256], int bits) {
  uint64_t t = 0;
  for (int s = 0; s < 256; ++s) t += f[s];
  const uint64_t tot = 1ull << bits;
  if (t == 0 || t == tot) return true;
  int m = 0;
  for (int s = 1; s < 256; ++s)
    if (f[s] > f[m]) m = s;  // first max, like python's max()
  uint64_t fsum = 0;
  for (int s = 0; s < 256; ++s) {
    if (!f[s]) continue;
    uint64_t v = f[s] * tot / t;
    f[s] = v < 1 ? 1 : v;
    fsum += f[s];
  }
  int64_t drift = static_cast<int64_t>(tot) - static_cast<int64_t>(fsum);
  if (static_cast<int64_t>(f[m]) + drift < 1) {
    std::vector<int> order;
    for (int s = 0; s < 256; ++s)
      if (f[s]) order.push_back(s);
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return f[a] > f[b]; });
    size_t i = 0;
    long guard = 0;
    while (drift < 0) {
      int s = order[i % order.size()];
      if (f[s] > 1) {
        --f[s];
        ++drift;
      }
      ++i;
      if (++guard > (1 << 22)) return false;
    }
  } else {
    f[m] = static_cast<uint64_t>(static_cast<int64_t>(f[m]) + drift);
  }
  return true;
}

struct Table {
  // per slot of the (1<<shift)-entry range: symbol, freq, cum
  std::vector<uint8_t> sym;
  std::vector<uint16_t> freq;
  std::vector<uint16_t> cum;
  bool build(const uint64_t f[256], int bits) {
    const uint32_t tot = 1u << bits;
    sym.resize(tot);
    freq.resize(tot);
    cum.resize(tot);
    uint32_t c = 0;
    for (int s = 0; s < 256; ++s) {
      if (!f[s]) continue;
      if (c + f[s] > tot) return false;
      for (uint32_t i = 0; i < f[s]; ++i) {
        sym[c + i] = static_cast<uint8_t>(s);
        freq[c + i] = static_cast<uint16_t>(f[s]);
        cum[c + i] = static_cast<uint16_t>(c);
      }
      c += f[s];
    }
    return true;
  }
};

static long decode(In& in, uint8_t* out, long out_len,
                   int depth = 0);  // fwd (STRIPE)
constexpr int kMaxDepth = 8;  // nested STRIPE recursion cap

static bool read_freqs0(In& in, uint64_t f[256]) {
  std::memset(f, 0, 256 * sizeof(uint64_t));
  std::vector<int> syms;
  if (!read_alphabet(in, syms)) return false;
  for (int s : syms) {
    uint64_t v = in.uint7();
    if (v > (1ull << 32)) return false;
    f[s] = v;
  }
  return in.ok && normalise(f, kShiftO0);
}

template <int N>
static long decode_rans0_t(In& in, uint8_t* out, long n) {
  uint64_t f[256];
  if (!read_freqs0(in, f)) return -1;
  Table t;
  if (!t.build(f, kShiftO0)) return -1;
  uint32_t x[N];
  for (int j = 0; j < N; ++j) x[j] = in.u32();
  if (!in.ok) return -1;
  const uint32_t mask = (1u << kShiftO0) - 1;
  for (long i = 0; i < n; ++i) {
    uint32_t& s = x[i % N];  // N is constexpr: compiles to a mask
    uint32_t m = s & mask;
    out[i] = t.sym[m];
    s = t.freq[m] * (s >> kShiftO0) + m - t.cum[m];
    int guard = 0;
    while (s < kL) {
      s = (s << 16) | in.u16();
      if (!in.ok || ++guard > 2) return -1;
    }
  }
  return n;
}

static long decode_rans0(In& in, uint8_t* out, long n, int N) {
  return N == 32 ? decode_rans0_t<32>(in, out, n)
                 : decode_rans0_t<4>(in, out, n);
}

static long decode_rans1(In& in, uint8_t* out, long n, int N) {
  uint8_t comp = in.u8();
  int shift = comp >> 4;
  if (!in.ok || shift < 1 || shift > 15) return -1;
  std::vector<uint8_t> tbl_buf;
  In tbl = in;
  bool inline_tbl = true;
  if (comp & 1) {
    uint64_t u_size = in.uint7();
    uint64_t c_size = in.uint7();
    const uint8_t* cp;
    if (!in.ok || u_size > (1u << 26) || !in.take(c_size, &cp)) return -1;
    tbl_buf.resize(u_size);
    In sub{cp, cp + c_size};
    if (decode_rans0(sub, tbl_buf.data(), u_size, 4) != (long)u_size)
      return -1;
    tbl = In{tbl_buf.data(), tbl_buf.data() + u_size};
    inline_tbl = false;
  }
  std::vector<int> syms;
  if (!read_alphabet(tbl, syms)) return -1;
  std::vector<std::unique_ptr<Table>> tabs(256);
  std::vector<std::array<uint64_t, 256>> rows(syms.size());
  for (size_t a = 0; a < syms.size(); ++a) {
    uint64_t* f = rows[a].data();
    std::memset(f, 0, 256 * sizeof(uint64_t));
    for (int j : syms) {
      uint64_t v = tbl.uint7();
      if (v > (1ull << 32)) return -1;
      f[j] = v;
    }
    if (!tbl.ok || !normalise(f, shift)) return -1;
    tabs[syms[a]] = std::make_unique<Table>();
    if (!tabs[syms[a]]->build(f, shift)) return -1;
  }
  if (inline_tbl) in = tbl;  // table was consumed from the main stream
  uint32_t x[32];
  for (int j = 0; j < N; ++j) x[j] = in.u32();
  if (!in.ok) return -1;
  const long q = n / N;
  const uint32_t mask = (1u << shift) - 1;
  std::vector<long> pos(N);
  for (int j = 0; j < N; ++j) pos[j] = j * q;
  std::vector<uint8_t> ctxs(N, 0);
  auto step = [&](int j, long at) -> bool {
    Table* t = tabs[ctxs[j]].get();
    if (!t) return false;
    uint32_t& s = x[j];
    uint32_t m = s & mask;
    uint8_t sym = t->sym[m];
    out[at] = sym;
    s = t->freq[m] * (s >> shift) + m - t->cum[m];
    int guard = 0;
    while (s < kL) {
      s = (s << 16) | in.u16();
      if (!in.ok || ++guard > 2) return false;
    }
    ctxs[j] = sym;
    return true;
  };
  for (long i = 0; i < q; ++i)
    for (int j = 0; j < N; ++j)
      if (!step(j, pos[j] + i)) return -1;
  for (long i = static_cast<long>(N) * q; i < n; ++i)
    if (!step(N - 1, i)) return -1;
  return n;
}

static long decode_stripe(In& in, uint8_t* out, long out_len,
                          int depth) {
  int N = in.u8();
  if (!in.ok || N <= 0) return -1;
  std::vector<uint64_t> clens(N);
  for (int j = 0; j < N; ++j) clens[j] = in.uint7();
  if (!in.ok) return -1;
  std::vector<std::vector<uint8_t>> lanes(N);
  for (int j = 0; j < N; ++j) {
    long ulen = out_len / N + ((out_len % N) > j ? 1 : 0);
    const uint8_t* cp;
    if (!in.take(clens[j], &cp)) return -1;
    lanes[j].resize(ulen);
    In sub{cp, cp + clens[j]};
    if (decode(sub, lanes[j].data(), ulen, depth + 1) != ulen) return -1;
  }
  for (int j = 0; j < N; ++j)
    for (long i = 0, m = j; m < out_len; ++i, m += N) out[m] = lanes[j][i];
  return out_len;
}

static long decode(In& in, uint8_t* out, long out_len, int depth) {
  if (depth > kMaxDepth) return -1;
  uint8_t flags = in.u8();
  if (!in.ok) return -1;
  if (!(flags & F_NOSZ)) {
    uint64_t v = in.uint7();
    if (!in.ok || static_cast<long>(v) != out_len) return -1;
  } else if (out_len < 0) {
    return -1;
  }
  if (out_len == 0) return 0;
  if (flags & F_STRIPE) return decode_stripe(in, out, out_len, depth);
  const int N = (flags & F_N32) ? 32 : 4;

  // PACK metadata
  bool do_pack = flags & F_PACK;
  uint8_t pmap[16];
  int nsym = 0;
  long pack_len = 0;
  long cur_len = out_len;
  if (do_pack) {
    pack_len = cur_len;
    nsym = in.u8();
    if (!in.ok || nsym > 16) return -1;
    for (int i = 0; i < nsym; ++i) pmap[i] = in.u8();
    uint64_t plen = in.uint7();
    // packed data is never longer than its unpacked form: also caps
    // the scratch allocation an adversarial length could force
    if (!in.ok || plen > static_cast<uint64_t>(pack_len)) return -1;
    cur_len = static_cast<long>(plen);
  }
  // RLE metadata
  bool do_rle = flags & F_RLE;
  std::vector<uint8_t> rle_meta;
  long rle_len = 0;
  if (do_rle) {
    rle_len = cur_len;
    uint64_t meta_len2 = in.uint7();
    uint64_t lit_len = in.uint7();
    if (!in.ok || lit_len > static_cast<uint64_t>(rle_len)) return -1;
    // metadata = 1 count byte + <=256 symbols + one uint7 run per
    // literal: bounds the decode allocation an adversarial length
    // could otherwise force
    if ((meta_len2 >> 1) > 257 + 10 * lit_len) return -1;
    long meta_len = static_cast<long>(meta_len2 >> 1);
    if (meta_len2 & 1) {
      const uint8_t* cp;
      if (!in.take(meta_len, &cp)) return -1;
      rle_meta.assign(cp, cp + meta_len);
    } else {
      uint64_t comp_len = in.uint7();
      const uint8_t* cp;
      if (!in.ok || !in.take(comp_len, &cp)) return -1;
      rle_meta.resize(meta_len);
      In sub{cp, cp + comp_len};
      if (decode_rans0(sub, rle_meta.data(), meta_len, 4) != meta_len)
        return -1;
    }
    cur_len = static_cast<long>(lit_len);
  }
  if (cur_len < 0 || cur_len > (1l << 40)) return -1;

  // payload: CAT or rANS, into a scratch buffer when transforms follow
  std::vector<uint8_t> buf;
  uint8_t* dst = out;
  if (do_pack || do_rle) {
    buf.resize(cur_len);
    dst = buf.data();
  }
  if (cur_len == 0) {
    // nothing coded
  } else if (flags & F_CAT) {
    const uint8_t* cp;
    if (!in.take(cur_len, &cp)) return -1;
    std::memcpy(dst, cp, cur_len);
  } else if (flags & F_ORDER1) {
    if (decode_rans1(in, dst, cur_len, N) != cur_len) return -1;
  } else {
    if (decode_rans0(in, dst, cur_len, N) != cur_len) return -1;
  }

  // undo RLE
  if (do_rle) {
    In meta{rle_meta.data(), rle_meta.data() + rle_meta.size()};
    int n_rle = meta.u8();
    if (n_rle == 0) n_rle = 256;
    bool in_rle[256] = {false};
    for (int i = 0; i < n_rle; ++i) in_rle[meta.u8()] = true;
    if (!meta.ok) return -1;
    std::vector<uint8_t> expanded;
    uint8_t* rdst = do_pack ? nullptr : out;
    if (do_pack) {
      expanded.resize(rle_len);
      rdst = expanded.data();
    }
    long j = 0;
    for (long i = 0; i < cur_len; ++i) {
      uint8_t b = buf[i];
      if (j >= rle_len) return -1;
      rdst[j++] = b;
      if (in_rle[b]) {
        uint64_t run = meta.uint7();
        if (!meta.ok || j + static_cast<long>(run) > rle_len) return -1;
        std::memset(rdst + j, b, run);
        j += run;
      }
    }
    if (j != rle_len) return -1;
    if (do_pack) buf.swap(expanded);
    cur_len = rle_len;
  }

  // undo PACK
  if (do_pack) {
    const uint8_t* src = buf.data();
    if (nsym <= 1) {
      if (nsym == 0) return -1;
      std::memset(out, pmap[0], pack_len);
    } else {
      int bits = nsym <= 2 ? 1 : nsym <= 4 ? 2 : 4;
      int per = 8 / bits;
      uint32_t vmask = (1u << bits) - 1;
      if ((pack_len + per - 1) / per > cur_len) return -1;
      for (long i = 0; i < pack_len; ++i) {
        uint32_t v = (src[i / per] >> (bits * (i % per))) & vmask;
        if (static_cast<int>(v) >= nsym) return -1;
        out[i] = pmap[v];
      }
    }
  }
  return out_len;
}

}  // namespace r16

// data = one method-5 block; out_cap = the block header's raw size.
extern "C" long jf_rans16_decode(const uint8_t* data, long len, uint8_t* out,
                                 long out_cap) {
  if (len < 1 || out_cap < 0) return -1;
  try {
    r16::In in{data, data + len};
    return r16::decode(in, out, out_cap);
  } catch (...) {  // bad_alloc etc. must not cross the C ABI
    return -1;
  }
}

// ---------------------------------------------------------------------
// Adaptive arithmetic decoder (CRAM 3.1 method 6) and fqzcomp quality
// decoder (method 7) — io/arith.py and io/fqzcomp.py hold the
// reference implementations and fallbacks. Any deviation from the
// python arithmetic would silently desync an adaptive coder, so every
// constant (STEP=16, MAX_FREQ=2^16-32, TOP=2^24, the carryless
// truncation) mirrors the python byte-for-byte; parity is asserted
// across the full flag/parameter matrix in tests/test_cram31.py.
// EXT (bzip2) payloads return -1 (python handles them).

namespace ar {

using r16::In;

constexpr uint32_t kTop = 1u << 24;
constexpr int kStep = 16;
constexpr uint32_t kMaxFreq = (1u << 16) - 32;

constexpr uint8_t F_ORDER1 = 0x01, F_EXT = 0x04, F_STRIPE = 0x08,
                  F_NOSZ = 0x10, F_CAT = 0x20, F_RLE = 0x40, F_PACK = 0x80;

struct RangeDecoder {
  // carry-propagating (LZMA-style) coder: the decoder needs only
  // (code, range); mirrors io/arith.py RangeDecoder. Reads are
  // UNCHECKED inside a symbol (the jf_arith/jf_fqz entry points copy
  // the input into a 64-byte zero-padded buffer) and validated ONCE per
  // symbol — a renorm consumes <= 4 bytes, so an overrun is caught
  // within the pad, and the caller's length checks bound every write.
  const uint8_t* p;
  const uint8_t* end;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  uint32_t r_ = 0;
  explicit RangeDecoder(In* i) : p(i->p), end(i->end) {
    uint64_t c = 0;
    for (int k = 0; k < 5; ++k) c = (c << 8) | *p++;
    code = static_cast<uint32_t>(c);
    // a truncated header leaves p > end: the first decode() reports it
  }
  bool decode(uint32_t cum, uint32_t freq) {
    code -= cum * r_;
    range = r_ * freq;
    // branchless renorm: range = r_*freq with r_ >= 2^8 (range >= 2^24,
    // tot < 2^16), so at most TWO byte pulls are ever needed — read
    // both unconditionally (padded buffer) and select, instead of a
    // data-dependent loop whose mispredict dominated the symbol cost
    uint32_t lt1 = range < kTop;
    uint32_t lt2 = range < (kTop >> 8);
    uint32_t b0 = p[0], b1 = p[1];
    uint32_t pulled = lt2 ? ((b0 << 8) | b1) : (lt1 ? b0 : 0u);
    uint32_t shift = (lt1 + lt2) * 8;
    code = (code << shift) | pulled;
    range <<= shift;
    p += lt1 + lt2;
    return p <= end;
  }
};

struct ModelArena {
  // bump allocator for model frequency tables: adaptive decoders touch
  // thousands of contexts (fqz qualities key on a 16-bit context), and
  // alphabet-sized tables keep the whole model working set cache-
  // resident (a fixed 256-entry layout costs 1 KB/context — ~64 MB of
  // scattered heap at full context spread, which is what capped
  // jf_fqz_decode at ~40 MB/s)
  std::vector<std::unique_ptr<uint8_t[]>> blocks;
  size_t off = 0, cap = 0;
  uint8_t* cur = nullptr;
  uint16_t* alloc_u16(size_t n) {
    size_t bytes = (n * sizeof(uint16_t) + 7) & ~size_t(7);
    if (off + bytes > cap) {
      cap = std::max<size_t>(size_t(256) << 10, bytes);
      blocks.emplace_back(new uint8_t[cap]);
      cur = blocks.back().get();
      off = 0;
    }
    uint16_t* p = reinterpret_cast<uint16_t*>(cur + off);
    off += bytes;
    return p;
  }
};

struct SimpleModel {
  // POD handle; storage (freqs then syms, each nsym uint16) lives in
  // the caller's arena. totals stay under 2^16 by the kMaxFreq
  // renormalisation, so uint16 frequencies are exact. nsym == 0 marks
  // an uninitialized context (lazy init at first decode).
  uint16_t* freqs = nullptr;
  uint32_t total = 0;
  uint16_t nsym = 0;
  void init(ModelArena& a, int n) {
    freqs = a.alloc_u16(2 * static_cast<size_t>(n));
    total = static_cast<uint32_t>(n);
    nsym = static_cast<uint16_t>(n);
    uint16_t* syms = freqs + n;
    for (int i = 0; i < n; ++i) {
      freqs[i] = 1;
      syms[i] = static_cast<uint16_t>(i);
    }
  }
  void bump(int i) {
    uint16_t* syms = freqs + nsym;
    freqs[i] = static_cast<uint16_t>(freqs[i] + kStep);
    total += kStep;
    if (i > 0 && freqs[i] > freqs[i - 1]) {
      std::swap(freqs[i], freqs[i - 1]);
      std::swap(syms[i], syms[i - 1]);
    }
    if (total > kMaxFreq) {
      total = 0;
      for (int k = 0; k < nsym; ++k) {
        freqs[k] = static_cast<uint16_t>(freqs[k] - (freqs[k] >> 1));
        total += freqs[k];
      }
    }
  }
  int decode(RangeDecoder& rc) {
    // one division per symbol: instead of f = code / r_ followed by a
    // cumulative-frequency scan against f, scan with the multiplied
    // threshold (acc+freq)*r_ <= code — exactly equivalent in integer
    // arithmetic (X > floor(c/r) <=> X*r > c), including the f >= tot
    // clamp (the scan cap at nsym-1 lands on the same last symbol).
    // Products stay in u32: (acc+freq) <= tot and tot*(range/tot) <=
    // range < 2^32.
    uint32_t r = rc.range / total;
    rc.r_ = r;
    uint32_t acc = 0;
    int i = 0;
    const int last = nsym - 1;
    while (i < last && (acc + freqs[i]) * r <= rc.code) {
      acc += freqs[i];
      ++i;
    }
    if (!rc.decode(acc, freqs[i])) return -1;
    int sym = freqs[nsym + i];  // syms array
    bump(i);
    return sym;
  }
};

static long decode(In& in, uint8_t* out, long out_len,
                   int depth = 0);  // fwd

static long decode_run(RangeDecoder& rc, ModelArena& arena,
                       std::vector<SimpleModel>& run_m, int first_ctx) {
  long run = 0;
  int ctx = first_ctx;
  for (;;) {
    if (!run_m[ctx].nsym) run_m[ctx].init(arena, 256);
    int r = run_m[ctx].decode(rc);
    if (r < 0) return -1;
    run += r;
    if (r != 255) return run;
    ctx = 256;
  }
}

static long decode_stream(In& in, uint8_t* out, long n, bool order1,
                          bool rle) {
  int max_sym = in.u8();
  if (!in.ok) return -1;
  if (max_sym == 0) max_sym = 256;
  ModelArena arena;
  std::vector<SimpleModel> lit(order1 ? 256 : 1);
  std::vector<SimpleModel> run_m(rle ? 257 : 0);
  RangeDecoder rc(&in);
  if (!in.ok) return -1;
  int ctx = 0;
  long i = 0;
  while (i < n) {
    if (!lit[ctx].nsym) lit[ctx].init(arena, max_sym);
    int b = lit[ctx].decode(rc);
    if (b < 0 || b > 255) return -1;
    out[i++] = static_cast<uint8_t>(b);
    if (rle) {
      if (!run_m[256].nsym) run_m[256].init(arena, 256);
      long run = decode_run(rc, arena, run_m, b);
      if (run < 0 || i + run > n) return -1;
      std::memset(out + i, b, run);
      i += run;
    }
    if (order1) ctx = b;
  }
  return n;
}

static long decode_stripe(In& in, uint8_t* out, long out_len,
                          int depth) {
  int N = in.u8();
  if (!in.ok || N <= 0) return -1;
  std::vector<uint64_t> clens(N);
  for (int j = 0; j < N; ++j) clens[j] = in.uint7();
  if (!in.ok) return -1;
  std::vector<std::vector<uint8_t>> lanes(N);
  for (int j = 0; j < N; ++j) {
    long ulen = out_len / N + ((out_len % N) > j ? 1 : 0);
    const uint8_t* cp;
    if (!in.take(clens[j], &cp)) return -1;
    lanes[j].resize(ulen);
    In sub{cp, cp + clens[j]};
    if (ar::decode(sub, lanes[j].data(), ulen, depth + 1) != ulen)
      return -1;
  }
  for (int j = 0; j < N; ++j)
    for (long i = 0, m = j; m < out_len; ++i, m += N) out[m] = lanes[j][i];
  return out_len;
}

static long decode(In& in, uint8_t* out, long out_len, int depth) {
  if (depth > r16::kMaxDepth) return -1;
  uint8_t flags = in.u8();
  if (!in.ok) return -1;
  if (!(flags & F_NOSZ)) {
    uint64_t v = in.uint7();
    if (!in.ok || static_cast<long>(v) != out_len) return -1;
  } else if (out_len < 0) {
    return -1;
  }
  if (out_len == 0) return 0;
  if (flags & F_STRIPE) return ar::decode_stripe(in, out, out_len, depth);
  if (flags & F_EXT) return -1;  // bzip2: python handles it

  bool do_pack = flags & F_PACK;
  uint8_t pmap[16];
  int nsym = 0;
  long pack_len = 0;
  long cur_len = out_len;
  if (do_pack) {
    pack_len = cur_len;
    nsym = in.u8();
    if (!in.ok || nsym > 16) return -1;
    for (int i = 0; i < nsym; ++i) pmap[i] = in.u8();
    uint64_t plen = in.uint7();
    // packed data is never longer than its unpacked form: also caps
    // the scratch allocation an adversarial length could force
    if (!in.ok || plen > static_cast<uint64_t>(pack_len)) return -1;
    cur_len = static_cast<long>(plen);
  }
  std::vector<uint8_t> buf;
  uint8_t* dst = out;
  if (do_pack) {
    buf.resize(cur_len);
    dst = buf.data();
  }
  if (cur_len == 0) {
    // nothing coded
  } else if (flags & F_CAT) {
    const uint8_t* cp;
    if (!in.take(cur_len, &cp)) return -1;
    std::memcpy(dst, cp, cur_len);
  } else {
    if (decode_stream(in, dst, cur_len, flags & F_ORDER1,
                      flags & F_RLE) != cur_len)
      return -1;
  }
  if (do_pack) {
    const uint8_t* src = buf.data();
    if (nsym <= 1) {
      if (nsym == 0) return -1;
      std::memset(out, pmap[0], pack_len);
    } else {
      int bits = nsym <= 2 ? 1 : nsym <= 4 ? 2 : 4;
      int per = 8 / bits;
      uint32_t vmask = (1u << bits) - 1;
      if ((pack_len + per - 1) / per > cur_len) return -1;
      for (long i = 0; i < pack_len; ++i) {
        uint32_t v = (src[i / per] >> (bits * (i % per))) & vmask;
        if (static_cast<int>(v) >= nsym) return -1;
        out[i] = pmap[v];
      }
    }
  }
  return out_len;
}

}  // namespace ar

extern "C" long jf_arith_decode(const uint8_t* data, long len, uint8_t* out,
                                long out_cap) {
  if (len < 1 || out_cap < 0) return -1;
  try {
    // zero-padded copy: RangeDecoder reads unchecked within a symbol
    // (validated once per symbol, overrun <= ~9 bytes — see its doc)
    std::vector<uint8_t> padded(static_cast<size_t>(len) + 64, 0);
    std::memcpy(padded.data(), data, len);
    ar::In in{padded.data(), padded.data() + len};
    return ar::decode(in, out, out_cap);
  } catch (...) {
    return -1;
  }
}

// fqzcomp (method 7) — mirrors io/fqzcomp.py
namespace fqz {

using ar::ModelArena;
using ar::RangeDecoder;
using ar::SimpleModel;
using r16::In;

constexpr uint8_t G_MULTI = 0x01, G_STAB = 0x02, G_REV = 0x04;
constexpr uint8_t P_DEDUP = 0x02, P_LEN = 0x04, P_SEL = 0x08,
                  P_QMAP = 0x10, P_PTAB = 0x20, P_DTAB = 0x40,
                  P_QTAB = 0x80;

static bool read_array(In& in, uint32_t* arr, int size) {
  int z = 0;
  uint32_t val = 0;
  long last = -1;
  while (z < size) {
    uint64_t run = 0;
    for (;;) {
      uint8_t b = in.u8();
      if (!in.ok) return false;
      run += b;
      if (b != 255) break;
    }
    int end = static_cast<int>(std::min<long>(z + run, size));
    for (int i = z; i < end; ++i) arr[i] = val;
    z += static_cast<int>(run);
    ++val;
    if (static_cast<long>(run) == last) {
      int copy = in.u8();
      if (!in.ok) return false;
      for (int c = 0; c < copy; ++c) {
        end = static_cast<int>(std::min<long>(z + run, size));
        for (int i = z; i < end; ++i) arr[i] = val;
        z += static_cast<int>(run);
        ++val;
      }
      last = -1;
    } else {
      last = static_cast<long>(run);
    }
  }
  return true;
}

struct Param {
  uint16_t context;
  uint8_t pflags;
  int max_sym;
  int qbits, qshift, qloc, sloc, ploc, dloc;
  uint8_t qmap[256];
  bool have_qmap;
  uint32_t qtab[256], ptab[1024], dtab[256];
  bool read(In& in) {
    if (in.end - in.p < 2) return false;
    context = static_cast<uint16_t>(in.p[0] | in.p[1] << 8);
    in.p += 2;
    pflags = in.u8();
    max_sym = in.u8();
    if (max_sym == 0) max_sym = 256;
    uint8_t b = in.u8();
    qbits = b >> 4;
    qshift = b & 15;
    b = in.u8();
    qloc = b >> 4;
    sloc = b & 15;
    b = in.u8();
    ploc = b >> 4;
    dloc = b & 15;
    have_qmap = pflags & P_QMAP;
    if (have_qmap)
      for (int i = 0; i < max_sym; ++i) qmap[i] = in.u8();
    if (pflags & P_QTAB) {
      if (!read_array(in, qtab, 256)) return false;
    } else {
      for (int i = 0; i < 256; ++i) qtab[i] = i;
    }
    if (pflags & P_PTAB) {
      if (!read_array(in, ptab, 1024)) return false;
    } else {
      std::memset(ptab, 0, sizeof(ptab));
    }
    if (pflags & P_DTAB) {
      if (!read_array(in, dtab, 256)) return false;
    } else {
      std::memset(dtab, 0, sizeof(dtab));
    }
    return in.ok;
  }
};

static long decode(In& in, uint8_t* out, long out_len) {
  if (in.u8() != 5) return -1;
  uint8_t gflags = in.u8();
  if (!in.ok) return -1;
  int nparam = (gflags & G_MULTI) ? in.u8() : 1;
  if (nparam <= 0 || nparam > 255) return -1;
  int max_sel;
  uint32_t stab[256];
  if (gflags & G_STAB) {
    max_sel = in.u8();
    if (!read_array(in, stab, 256)) return -1;
  } else {
    max_sel = nparam - 1;
    for (int i = 0; i < 256; ++i)
      stab[i] = static_cast<uint32_t>(std::min(i, nparam - 1));
  }
  std::vector<Param> params(nparam);
  int max_sym = 0;
  for (int x = 0; x < nparam; ++x) {
    if (!params[x].read(in)) return -1;
    max_sym = std::max(max_sym, params[x].max_sym);
  }

  ModelArena arena;
  std::vector<SimpleModel> qual(1u << 16);
  SimpleModel len_m[4], rev_m, dup_m, sel_m;
  for (int j = 0; j < 4; ++j) len_m[j].init(arena, 256);
  rev_m.init(arena, 2);
  dup_m.init(arena, 2);
  if (max_sel > 0) sel_m.init(arena, max_sel + 1);
  RangeDecoder rc(&in);
  if (!in.ok) return -1;

  struct Rec {
    long start, len;
    bool rev;
  };
  std::vector<Rec> recs;
  long i = 0;
  long rec = 0;
  long last_len = 0;
  while (i < out_len) {
    int sel = 0;
    if (sel_m.nsym) {
      sel = sel_m.decode(rc);
      if (sel < 0) return -1;
    }
    uint32_t x = stab[std::min(sel, 255)];
    if (x >= static_cast<uint32_t>(nparam)) return -1;
    const Param& p = params[x];
    long ln;
    if ((p.pflags & P_LEN) || rec == 0) {
      long b0 = len_m[0].decode(rc), b1 = len_m[1].decode(rc);
      long b2 = len_m[2].decode(rc), b3 = len_m[3].decode(rc);
      if (b0 < 0 || b1 < 0 || b2 < 0 || b3 < 0) return -1;
      ln = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
      last_len = ln;
    } else {
      ln = last_len;
    }
    if (ln <= 0 || i + ln > out_len) return -1;
    bool is_rev = false;
    if (gflags & G_REV) {
      int r = rev_m.decode(rc);
      if (r < 0) return -1;
      is_rev = r != 0;
    }
    if (p.pflags & P_DEDUP) {
      int d = dup_m.decode(rc);
      if (d < 0) return -1;
      if (d) {
        if (rec == 0 || recs.back().len != ln) return -1;
        std::memcpy(out + i, out + recs.back().start, ln);
        recs.push_back({i, ln, is_rev});
        i += ln;
        ++rec;
        continue;
      }
    }
    const uint32_t qmask = (1u << p.qbits) - 1;
    uint32_t qlast = 0;
    long delta = 0;
    int prevq = 0;
    uint32_t ctx = p.context;
    for (long j = 0; j < ln; ++j) {
      if (!qual[ctx].nsym) qual[ctx].init(arena, max_sym);
      int q = qual[ctx].decode(rc);
      if (q < 0) return -1;
      // q comes from a model sized by the GLOBAL max_sym; qmap is
      // only p.max_sym entries, so bound it like python's qmap[q]
      // IndexError (no qmap -> q passes through unbounded, as python)
      if (p.have_qmap && q >= p.max_sym) return -1;
      out[i + j] = p.have_qmap ? p.qmap[q] : static_cast<uint8_t>(q);
      qlast = ((qlast << p.qshift) + p.qtab[q]) & qmask;
      ctx = p.context;
      ctx += qlast << p.qloc;
      // position context counts bases REMAINING (spec's state.p
      // starts at the record length and decrements AFTER use)
      ctx += p.ptab[std::min<long>(ln - j, 1023)] << p.ploc;
      ctx += p.dtab[std::min<long>(delta, 255)] << p.dloc;
      if (p.pflags & P_SEL) ctx += static_cast<uint32_t>(sel) << p.sloc;
      ctx &= 0xFFFF;
      if (prevq != q) ++delta;
      prevq = q;
    }
    recs.push_back({i, ln, is_rev});
    i += ln;
    ++rec;
  }
  for (const Rec& r : recs)
    if (r.rev) std::reverse(out + r.start, out + r.start + r.len);
  return out_len;
}

}  // namespace fqz

extern "C" long jf_fqz_decode(const uint8_t* data, long len, uint8_t* out,
                              long out_cap) {
  if (len < 1 || out_cap < 0) return -1;
  try {
    std::vector<uint8_t> padded(static_cast<size_t>(len) + 64, 0);
    std::memcpy(padded.data(), data, len);
    fqz::In in{padded.data(), padded.data() + len};
    return fqz::decode(in, out, out_cap);
  } catch (...) {
    return -1;
  }
}

// name tokenizer (method 8) — mirrors io/tok3.py; sub-streams decode
// through the native rANS Nx16 / arith decoders above (EXT payloads
// inside an arith sub-stream bail to python).
namespace tok3 {

using r16::In;

enum {
  T_TYPE = 0, T_STRING = 1, T_CHAR = 2, T_DZLEN = 3, T_DIGITS0 = 4,
  T_DUP = 5, T_DIFF = 6, T_DIGITS = 7, T_DELTA = 8, T_DELTA0 = 9,
  T_MATCH = 10, T_NOP = 11, T_END = 12
};

constexpr int kMaxPos = 4096;

struct Stream {
  std::shared_ptr<std::vector<uint8_t>> buf;
  size_t pos = 0;
  bool ok() const { return static_cast<bool>(buf); }
  bool u8(uint8_t* v) {
    if (!buf || pos >= buf->size()) return false;
    *v = (*buf)[pos++];
    return true;
  }
  bool u32(uint32_t* v) {
    if (!buf || pos + 4 > buf->size()) return false;
    std::memcpy(v, buf->data() + pos, 4);
    pos += 4;
    return true;
  }
  bool string(const uint8_t** s, size_t* n) {
    if (!buf) return false;
    auto it = std::find(buf->begin() + pos, buf->end(), uint8_t(0));
    if (it == buf->end()) return false;
    *s = buf->data() + pos;
    *n = static_cast<size_t>(it - (buf->begin() + pos));
    pos = static_cast<size_t>(it - buf->begin()) + 1;
    return true;
  }
};

struct Tok {
  // POD token: the text lives in the OUTPUT buffer (every token's text
  // is appended to `out` anyway), so a token is (offset, len) plus the
  // numeric value — no std::string, no per-name vectors (the old
  // layout's allocation churn was ~30% of decode time)
  uint32_t off;
  uint32_t val;
  uint16_t len;
  uint8_t has_val;
};

static long sub_decode(const uint8_t* p, size_t n, bool use_arith,
                       std::vector<uint8_t>& out) {
  // peek the embedded size (NOSZ bails: python handles it)
  In peek{p, p + n};
  uint8_t flags = peek.u8();
  if (!peek.ok || (flags & 0x10)) return -1;
  uint64_t size = peek.uint7();
  if (!peek.ok || size > (1u << 30)) return -1;
  out.resize(size);
  In sub{p, p + n};
  long r = use_arith ? ar::decode(sub, out.data(), size)
                     : r16::decode(sub, out.data(), size);
  return r == static_cast<long>(size) ? r : -1;
}

static long decode(const uint8_t* data, long len, uint8_t* out,
                   long out_cap) {
  In in{data, data + len};
  if (len < 9) return -1;
  uint32_t ulen, nnames;
  std::memcpy(&ulen, data, 4);
  std::memcpy(&nnames, data + 4, 4);
  in.p = data + 8;
  uint8_t use_arith = in.u8();
  if (!in.ok || static_cast<long>(ulen) != out_cap) return -1;
  if (nnames > (1u << 28)) return -1;

  std::map<std::pair<int, int>, Stream> streams;
  int t = -1;
  while (in.p < in.end) {
    uint8_t desc = in.u8();
    int ttype = desc & 0x3F;
    if (desc & 0x80) ++t;
    if (t < 0 || t >= kMaxPos || ttype > T_END) return -1;
    if (desc & 0x40) {
      int dpos = in.u8();
      int dtype = in.u8();
      if (!in.ok) return -1;
      auto it = streams.find({dpos, dtype});
      if (it == streams.end()) return -1;
      streams[{t, ttype}] = Stream{it->second.buf, 0};
    } else {
      uint64_t clen = in.uint7();
      const uint8_t* cp;
      if (!in.ok || !in.take(clen, &cp)) return -1;
      auto buf = std::make_shared<std::vector<uint8_t>>();
      if (sub_decode(cp, clen, use_arith, *buf) < 0) return -1;
      streams[{t, ttype}] = Stream{std::move(buf), 0};
    }
  }

  // flatten the stream table: one indexed load per token instead of a
  // map lookup (the map find dominated the reconstruction loop)
  int max_pos = 0;
  for (const auto& kv : streams) max_pos = std::max(max_pos, kv.first.first);
  std::vector<Stream*> flat((max_pos + 1) * (T_END + 1), nullptr);
  for (auto& kv : streams)
    flat[kv.first.first * (T_END + 1) + kv.first.second] = &kv.second;
  auto get = [&](int pos, int ttype) -> Stream* {
    return pos > max_pos ? nullptr : flat[pos * (T_END + 1) + ttype];
  };

  std::vector<Tok> arena;  // all names' tokens, flat
  arena.reserve(static_cast<size_t>(nnames) * 8 + 16);
  // (arena start, token count) per name; DUP names share the source's
  // token span (no token copying at all)
  std::vector<std::pair<uint32_t, uint32_t>> tspans(nnames);
  std::vector<std::pair<long, long>> spans(nnames);  // (start, len) in out
  long o = 0;
  for (uint32_t i = 0; i < nnames; ++i) {
    Stream* ts = get(0, T_TYPE);
    uint8_t first;
    if (!ts || !ts->u8(&first)) return -1;
    if (first == T_DUP) {
      Stream* ds = get(0, T_DUP);
      uint32_t dist;
      if (!ds || !ds->u32(&dist)) return -1;
      if (dist == 0 || dist > i) return -1;
      tspans[i] = tspans[i - dist];
      auto sp = spans[i - dist];
      if (o + sp.second + 1 > out_cap) return -1;
      std::memcpy(out + o, out + sp.first, sp.second);
      spans[i] = {o, sp.second};
      o += sp.second;
      out[o++] = 0;
      continue;
    }
    if (first != T_DIFF) return -1;
    Stream* fs = get(0, T_DIFF);
    uint32_t dist;
    if (!fs || !fs->u32(&dist)) return -1;
    uint32_t pstart = 0, pcount = 0;
    if (dist > 0 && dist <= i) {
      pstart = tspans[i - dist].first;
      pcount = tspans[i - dist].second;
    }
    uint32_t tstart = static_cast<uint32_t>(arena.size());
    arena.push_back({});  // position 0 placeholder
    long start = o;
    for (int pos = 1;; ++pos) {
      if (pos >= kMaxPos) return -1;
      Stream* tys = get(pos, T_TYPE);
      uint8_t ty;
      if (!tys || !tys->u8(&ty)) return -1;
      if (ty == T_END) break;
      Tok tok{static_cast<uint32_t>(o), 0, 0, 0};
      char tmp[16];
      switch (ty) {
        case T_CHAR: {
          Stream* s = get(pos, T_CHAR);
          uint8_t c;
          if (!s || !s->u8(&c)) return -1;
          if (o + 1 > out_cap) return -1;
          out[o] = c;
          tok.len = 1;
          break;
        }
        case T_STRING: {
          Stream* s = get(pos, T_STRING);
          const uint8_t* sp;
          size_t sn;
          if (!s || !s->string(&sp, &sn)) return -1;
          if (sn > 0xFFFF || o + static_cast<long>(sn) > out_cap)
            return -1;
          std::memcpy(out + o, sp, sn);
          tok.len = static_cast<uint16_t>(sn);
          break;
        }
        case T_DIGITS: {
          Stream* s = get(pos, T_DIGITS);
          if (!s || !s->u32(&tok.val)) return -1;
          tok.has_val = 1;
          int dn = snprintf(tmp, sizeof tmp, "%u", tok.val);
          if (o + dn > out_cap) return -1;
          std::memcpy(out + o, tmp, dn);
          tok.len = static_cast<uint16_t>(dn);
          break;
        }
        case T_DIGITS0: {
          Stream* s = get(pos, T_DIGITS0);
          Stream* ls = get(pos, T_DZLEN);
          uint8_t width;
          if (!s || !s->u32(&tok.val) || !ls || !ls->u8(&width)) return -1;
          tok.has_val = 1;
          int dn = snprintf(tmp, sizeof tmp, "%u", tok.val);
          int z = dn < width ? width - dn : 0;
          if (o + z + dn > out_cap) return -1;
          std::memset(out + o, '0', z);
          std::memcpy(out + o + z, tmp, dn);
          tok.len = static_cast<uint16_t>(z + dn);
          break;
        }
        case T_DELTA:
        case T_DELTA0: {
          Stream* s = get(pos, ty);
          uint8_t d;
          if (!s || !s->u8(&d)) return -1;
          if (pos >= static_cast<int>(pcount)
              || !arena[pstart + pos].has_val)
            return -1;
          const Tok& pv = arena[pstart + pos];
          tok.val = pv.val + d;
          tok.has_val = 1;
          int dn = snprintf(tmp, sizeof tmp, "%u", tok.val);
          int z = 0;
          if (ty == T_DELTA0) {
            int width = static_cast<int>(pv.len);
            if (dn < width) z = width - dn;
          }
          if (o + z + dn > out_cap) return -1;
          std::memset(out + o, '0', z);
          std::memcpy(out + o + z, tmp, dn);
          tok.len = static_cast<uint16_t>(z + dn);
          break;
        }
        case T_MATCH: {
          if (pos >= static_cast<int>(pcount)) return -1;
          const Tok& pv = arena[pstart + pos];
          if (o + static_cast<long>(pv.len) > out_cap) return -1;
          std::memcpy(out + o, out + pv.off, pv.len);
          tok.val = pv.val;
          tok.has_val = pv.has_val;
          tok.len = pv.len;
          break;
        }
        case T_NOP:
          break;
        default:
          return -1;
      }
      o += tok.len;
      arena.push_back(tok);
    }
    spans[i] = {start, o - start};
    if (o + 1 > out_cap) return -1;
    out[o++] = 0;
    tspans[i] = {tstart, static_cast<uint32_t>(arena.size()) - tstart};
  }
  return o == out_cap ? o : -1;
}

}  // namespace tok3

extern "C" long jf_tok3_decode(const uint8_t* data, long len, uint8_t* out,
                               long out_cap) {
  if (len < 1 || out_cap < 0) return -1;
  try {
    // padded like jf_arith_decode: tok3 sub-streams may route through
    // the unchecked-read RangeDecoder (use_arith containers)
    std::vector<uint8_t> padded(static_cast<size_t>(len) + 64, 0);
    std::memcpy(padded.data(), data, len);
    return tok3::decode(padded.data(), len, out, out_cap);
  } catch (...) {
    return -1;
  }
}

// ---------------------------------------------------------------------
// CRAM slice record decoder — the record-level hot loop of native CRAM
// reading (the htslib role; io/cram.py keeps the reference python
// implementation and is the fallback whenever this returns null).
// Python parses containers / decompresses blocks and passes the raw
// encoding maps straight from the file; everything per-record runs
// here. Unsupported shapes (multi-ref slices, exotic codecs, malformed
// data) return null and the python path decides/raises.

namespace cram {

struct Cur {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint8_t u8() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }
  int32_t itf8() {
    uint32_t b0 = u8(), v;
    if (b0 < 0x80) {
      v = b0;
    } else if (b0 < 0xC0) {
      v = (b0 & 0x3F) << 8 | u8();
    } else if (b0 < 0xE0) {
      v = (b0 & 0x1F) << 16 | u8() << 8 | u8();
    } else if (b0 < 0xF0) {
      v = (b0 & 0x0F) << 24 | u8() << 16 | u8() << 8 | u8();
    } else {
      v = (b0 & 0x0F) << 28 | u8() << 20 | u8() << 12 | u8() << 4 |
          (u8() & 0x0F);
    }
    return static_cast<int32_t>(v);
  }
};

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  int bit = 0;
  bool ok = true;
  int read_bit() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    int b = (*p >> (7 - bit)) & 1;
    if (++bit == 8) {
      bit = 0;
      ++p;
    }
    return b;
  }
  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = v << 1 | read_bit();
    return v;
  }
};

struct Ctx;

struct Codec {
  int kind = 0;  // codec ids as in the spec
  int cid = -1;
  uint8_t stop = 0;
  int32_t offset = 0;
  int nbits = 0;
  int k = 0;
  bool hconst = false;
  int32_t hconst_val = 0;
  int hmax = 0;
  std::vector<uint32_t> hlen, hcode;
  std::vector<int32_t> hsym;
  std::unique_ptr<Codec> sub_len, sub_val;
  bool valid = false;
};

struct Ctx {
  Bits core;
  std::vector<int> ext_ids;
  std::vector<Cur> exts;
  bool ok = true;
  Cur* ext(int cid) {
    for (size_t i = 0; i < ext_ids.size(); ++i)
      if (ext_ids[i] == cid) return &exts[i];
    ok = false;
    return nullptr;
  }
};

static bool parse_codec(Cur& c, Codec& out) {
  int id = c.itf8();
  int32_t plen = c.itf8();
  if (!c.ok || plen < 0 || c.end - c.p < plen) return false;
  Cur params{c.p, c.p + plen};
  c.p += plen;
  out.kind = id;
  switch (id) {
    case 1:  // EXTERNAL
      out.cid = params.itf8();
      break;
    case 3: {  // HUFFMAN (canonical)
      int32_t n = params.itf8();
      if (n < 0 || n > 4096) return false;
      std::vector<int32_t> syms(n);
      for (auto& s : syms) s = params.itf8();
      int32_t m = params.itf8();
      if (m != n) return false;
      std::vector<uint32_t> lens(n);
      for (auto& l : lens) l = static_cast<uint32_t>(params.itf8());
      if (!params.ok) return false;
      if (n == 1 && lens[0] == 0) {
        out.hconst = true;
        out.hconst_val = syms[0];
        break;
      }
      std::vector<size_t> order(n);
      for (size_t i = 0; i < order.size(); ++i) order[i] = i;
      std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
        return lens[a] != lens[b] ? lens[a] < lens[b] : a < b;
      });
      uint32_t code = 0, prev = lens[order[0]];
      if (prev == 0 || prev > 31) return false;
      for (size_t oi = 0; oi < order.size(); ++oi) {
        uint32_t ln = lens[order[oi]];
        if (ln > 31) return false;
        code <<= (ln - prev);
        prev = ln;
        out.hlen.push_back(ln);
        out.hcode.push_back(code);
        out.hsym.push_back(syms[order[oi]]);
        out.hmax = static_cast<int>(ln);
        ++code;
      }
      break;
    }
    case 4:  // BYTE_ARRAY_LEN
      out.sub_len = std::make_unique<Codec>();
      out.sub_val = std::make_unique<Codec>();
      if (!parse_codec(params, *out.sub_len) ||
          !parse_codec(params, *out.sub_val))
        return false;
      break;
    case 5:  // BYTE_ARRAY_STOP
      out.stop = params.u8();
      out.cid = params.itf8();
      break;
    case 6:  // BETA
      out.offset = params.itf8();
      out.nbits = params.itf8();
      if (out.nbits < 0 || out.nbits > 32) return false;
      break;
    case 7:  // SUBEXP
      out.offset = params.itf8();
      out.k = params.itf8();
      if (out.k < 0 || out.k > 31) return false;
      break;
    case 9:  // GAMMA
      out.offset = params.itf8();
      break;
    default:
      return false;  // GOLOMB family etc. -> python
  }
  if (!params.ok) return false;
  out.valid = true;
  return true;
}

static int32_t read_int(const Codec& c, Ctx& x) {
  switch (c.kind) {
    case 1: {
      Cur* e = x.ext(c.cid);
      if (!e) return 0;
      int32_t v = e->itf8();
      if (!e->ok) x.ok = false;
      return v;
    }
    case 3: {
      if (c.hconst) return c.hconst_val;
      uint32_t code = 0;
      uint32_t ln = 0;
      size_t i = 0;
      while (ln <= static_cast<uint32_t>(c.hmax) && x.core.ok) {
        code = code << 1 | x.core.read_bit();
        ++ln;
        while (i < c.hlen.size() && c.hlen[i] < ln) ++i;
        for (size_t j = i; j < c.hlen.size() && c.hlen[j] == ln; ++j)
          if (c.hcode[j] == code) return c.hsym[j];
      }
      x.ok = false;
      return 0;
    }
    case 6: {
      int32_t v =
          static_cast<int32_t>(x.core.read_bits(c.nbits)) - c.offset;
      if (!x.core.ok) x.ok = false;
      return v;
    }
    case 7: {
      int u = 0;
      while (x.core.ok && x.core.read_bit() == 1) {
        if (++u > 40) {
          x.ok = false;
          return 0;
        }
      }
      uint32_t n;
      if (u == 0) {
        n = x.core.read_bits(c.k);
      } else {
        int b = u + c.k - 1;
        if (b > 31) {
          x.ok = false;
          return 0;
        }
        n = (1u << b) | x.core.read_bits(b);
      }
      if (!x.core.ok) x.ok = false;
      return static_cast<int32_t>(n) - c.offset;
    }
    case 9: {
      int z = 0;
      while (x.core.ok && x.core.read_bit() == 0) {
        if (++z > 31) {
          x.ok = false;
          return 0;
        }
      }
      uint32_t v = (1u << z) | x.core.read_bits(z);
      if (!x.core.ok) x.ok = false;
      return static_cast<int32_t>(v) - c.offset;
    }
    default:
      x.ok = false;
      return 0;
  }
}

static uint8_t read_byte(const Codec& c, Ctx& x) {
  if (c.kind == 1) {
    Cur* e = x.ext(c.cid);
    if (!e) return 0;
    uint8_t v = e->u8();
    if (!e->ok) x.ok = false;
    return v;
  }
  return static_cast<uint8_t>(read_int(c, x));
}

// n bytes into dst (value-level reads of a byte series)
static bool read_bytes(const Codec& c, Ctx& x, uint8_t* dst, long n) {
  if (c.kind == 1) {
    Cur* e = x.ext(c.cid);
    if (!e || e->end - e->p < n) {
      x.ok = false;
      return false;
    }
    std::memcpy(dst, e->p, n);
    e->p += n;
    return true;
  }
  if (c.kind == 4) return read_bytes(*c.sub_val, x, dst, n);
  for (long i = 0; i < n; ++i) dst[i] = read_byte(c, x);
  return x.ok;
}

// variable-length byte array; appends to out, returns length or -1
static long read_array(const Codec& c, Ctx& x, std::string& out) {
  if (c.kind == 4) {
    long n = read_int(*c.sub_len, x);
    if (!x.ok || n < 0 || n > (1 << 28)) {
      x.ok = false;
      return -1;
    }
    size_t base = out.size();
    out.resize(base + n);
    if (!read_bytes(*c.sub_val, x, reinterpret_cast<uint8_t*>(&out[base]),
                    n))
      return -1;
    return n;
  }
  if (c.kind == 5) {
    Cur* e = x.ext(c.cid);
    if (!e) return -1;
    const uint8_t* q = static_cast<const uint8_t*>(
        std::memchr(e->p, c.stop, e->end - e->p));
    if (!q) {
      x.ok = false;
      return -1;
    }
    long n = q - e->p;
    out.append(reinterpret_cast<const char*>(e->p), n);
    e->p = q + 1;
    return n;
  }
  x.ok = false;
  return -1;
}

// series slots, indexed by a dense enum
enum Series {
  S_BF, S_CF, S_RI, S_RL, S_AP, S_RG, S_RN, S_MF, S_NS, S_NP, S_TS,
  S_NF, S_TL, S_FN, S_FC, S_FP, S_BS, S_IN, S_DL, S_RS, S_SC, S_PD,
  S_HC, S_BB, S_QQ, S_MQ, S_BA, S_QS, S_COUNT
};

static int series_slot(uint8_t a, uint8_t b) {
  switch (a << 8 | b) {
    case 'B' << 8 | 'F': return S_BF;
    case 'C' << 8 | 'F': return S_CF;
    case 'R' << 8 | 'I': return S_RI;
    case 'R' << 8 | 'L': return S_RL;
    case 'A' << 8 | 'P': return S_AP;
    case 'R' << 8 | 'G': return S_RG;
    case 'R' << 8 | 'N': return S_RN;
    case 'M' << 8 | 'F': return S_MF;
    case 'N' << 8 | 'S': return S_NS;
    case 'N' << 8 | 'P': return S_NP;
    case 'T' << 8 | 'S': return S_TS;
    case 'N' << 8 | 'F': return S_NF;
    case 'T' << 8 | 'L': return S_TL;
    case 'F' << 8 | 'N': return S_FN;
    case 'F' << 8 | 'C': return S_FC;
    case 'F' << 8 | 'P': return S_FP;
    case 'B' << 8 | 'S': return S_BS;
    case 'I' << 8 | 'N': return S_IN;
    case 'D' << 8 | 'L': return S_DL;
    case 'R' << 8 | 'S': return S_RS;
    case 'S' << 8 | 'C': return S_SC;
    case 'P' << 8 | 'D': return S_PD;
    case 'H' << 8 | 'C': return S_HC;
    case 'B' << 8 | 'B': return S_BB;
    case 'Q' << 8 | 'Q': return S_QQ;
    case 'M' << 8 | 'Q': return S_MQ;
    case 'B' << 8 | 'A': return S_BA;
    case 'Q' << 8 | 'S': return S_QS;
    default: return -1;
  }
}

struct Decoder {
  Codec series[S_COUNT];
  std::vector<std::pair<uint32_t, Codec>> tags;
  std::vector<std::vector<uint32_t>> td;
  uint8_t subst[5][4];  // [ref base ACGTN][code] -> base
  bool rn_preserved, ap_delta, rr;

  const Codec* get(int slot) const {
    return series[slot].valid ? &series[slot] : nullptr;
  }
  const Codec* tag_codec(uint32_t key) const {
    for (auto& kv : tags)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

struct RefIdxInit {
  int8_t tbl[256];
  RefIdxInit() {
    std::memset(tbl, 4, sizeof(tbl));
    tbl['A'] = 0; tbl['C'] = 1; tbl['G'] = 2; tbl['T'] = 3; tbl['N'] = 4;
    tbl['a'] = 0; tbl['c'] = 1; tbl['g'] = 2; tbl['t'] = 3; tbl['n'] = 4;
  }
};
static const RefIdxInit kRefIdxInit;

struct SliceOut {
  std::string buf;
};

}  // namespace cram

extern "C" void* jf_cram_slice(
    const uint8_t* series_map, long series_len, const uint8_t* tag_map,
    long tag_len, const uint8_t* td_blob, long td_len, int rn_preserved,
    int ap_delta, int rr, const uint8_t* subst5, const uint8_t* core_buf,
    long core_len, const int* ext_ids, const uint8_t* const* ext_ptrs,
    const long* ext_lens, int n_ext, const uint8_t* ref, long ref_len,
    long ref_off, long n_records, long slice_start,
    long long counter_base, int no_qual) {
  // no_qual: caller proved the QS/QQ streams exclusive (cram.py
  // qual_skip_cids) and withheld their blocks — skip every quality
  // read (nothing else consumes those streams) and emit FASTA
  using namespace cram;
  Decoder d;
  d.rn_preserved = rn_preserved;
  d.ap_delta = ap_delta;
  d.rr = rr;
  // substitution table
  static const char kBases[] = "ACGTN";
  for (int r = 0; r < 5; ++r) {
    char cands[4];
    int ci = 0;
    for (int b = 0; b < 5; ++b)
      if (b != r) cands[ci++] = kBases[b];
    uint8_t byte = subst5 ? subst5[r] : 0x1b;
    for (int j = 0; j < 4; ++j)
      d.subst[r][(byte >> (6 - 2 * j)) & 3] = cands[j];
  }
  // series encoding map (raw bytes from the compression header)
  {
    Cur c{series_map, series_map + series_len};
    c.itf8();  // size
    int32_t n = c.itf8();
    if (!c.ok || n < 0 || n > 1024) return nullptr;
    for (int i = 0; i < n; ++i) {
      uint8_t a = c.u8(), b = c.u8();
      int slot = series_slot(a, b);
      Codec tmp;
      if (!parse_codec(c, slot < 0 ? tmp : d.series[slot]))
        return nullptr;  // unknown codec -> python decides
      // unknown series key: codec parsed and skipped
    }
  }
  // tag encoding map
  {
    Cur c{tag_map, tag_map + tag_len};
    c.itf8();
    int32_t n = c.itf8();
    if (!c.ok || n < 0 || n > 4096) return nullptr;
    for (int i = 0; i < n; ++i) {
      uint32_t key = static_cast<uint32_t>(c.itf8());
      Codec tc;
      if (!parse_codec(c, tc)) return nullptr;
      d.tags.emplace_back(key, std::move(tc));
    }
  }
  // TD dictionary: NUL-terminated lines of 3-byte (name,name,type)
  // entries; a line is committed by its NUL (content after the last
  // NUL is ignored, like python's split(b"\\x00")[:-1])
  {
    std::vector<uint32_t> line;
    long i = 0;
    while (i < td_len) {
      if (td_blob[i] == 0) {
        d.td.push_back(line);
        line.clear();
        ++i;
      } else if (i + 3 <= td_len) {
        line.push_back(td_blob[i] << 16 | td_blob[i + 1] << 8 |
                       td_blob[i + 2]);
        i += 3;
      } else {
        return nullptr;
      }
    }
    if (d.td.empty()) d.td.emplace_back();
  }

  Ctx x;
  x.core = Bits{core_buf, core_buf + core_len};
  for (int i = 0; i < n_ext; ++i) {
    x.ext_ids.push_back(ext_ids[i]);
    x.exts.push_back(Cur{ext_ptrs[i], ext_ptrs[i] + ext_lens[i]});
  }

  auto out = std::make_unique<SliceOut>();
  std::string& o = out->buf;
  std::string seq, qual, name, scratch;
  long last_pos = slice_start;

  auto iv = [&](int slot) -> int32_t {
    const Codec* c = d.get(slot);
    if (!c) {
      x.ok = false;
      return 0;
    }
    return read_int(*c, x);
  };
  auto bv = [&](int slot) -> uint8_t {
    const Codec* c = d.get(slot);
    if (!c) {
      x.ok = false;
      return 0;
    }
    return read_byte(*c, x);
  };
  auto av = [&](int slot, std::string& dst) -> long {
    const Codec* c = d.get(slot);
    if (!c) {
      x.ok = false;
      return -1;
    }
    return read_array(*c, x, dst);
  };
  auto ref_fill = [&](uint8_t* dst, long pos0, long n) {
    for (long i = 0; i < n; ++i) {
      long g = pos0 + i - ref_off;
      dst[i] = (rr && ref && g >= 0 && g < ref_len)
                   ? static_cast<uint8_t>(
                         std::toupper(static_cast<unsigned char>(ref[g])))
                   : 'N';
    }
  };

  for (long rec = 0; rec < n_records && x.ok; ++rec) {
    int32_t bf = iv(S_BF);
    int32_t cf = iv(S_CF);
    int32_t rl = iv(S_RL);
    if (rl < 0 || rl > (1 << 28)) return nullptr;
    int32_t ap = iv(S_AP);
    long pos;
    if (d.ap_delta) {
      pos = last_pos + ap;
      last_pos = pos;
    } else {
      pos = ap;
    }
    iv(S_RG);
    name.clear();
    if (d.rn_preserved) {
      if (av(S_RN, name) < 0) return nullptr;
    } else {
      name = "jf." + std::to_string(counter_base + rec);
    }
    if (cf & 2) {  // detached
      iv(S_MF);
      if (!d.rn_preserved) {
        name.clear();
        if (av(S_RN, name) < 0) return nullptr;
      }
      iv(S_NS);
      iv(S_NP);
      iv(S_TS);
    } else if (cf & 4) {
      iv(S_NF);
    }
    int32_t tl = iv(S_TL);
    if (tl < 0 || static_cast<size_t>(tl) >= d.td.size()) return nullptr;
    for (uint32_t key : d.td[tl]) {
      const Codec* tc = d.tag_codec(key);
      if (!tc) return nullptr;
      scratch.clear();
      if (read_array(*tc, x, scratch) < 0) return nullptr;
    }
    if (!x.ok) return nullptr;

    seq.assign(rl, 'N');
    qual.assign(rl, '\xff');
    bool have_qual = false;
    uint8_t* sq = reinterpret_cast<uint8_t*>(&seq[0]);
    uint8_t* qq = reinterpret_cast<uint8_t*>(&qual[0]);

    if (!(bf & 4)) {  // mapped
      if (rr && !ref) return nullptr;  // needs a reference -> python
      int32_t fn = iv(S_FN);
      if (fn < 0 || fn > rl + 64) return nullptr;
      long read_i = 0, ref_pos = pos - 1, p = 0;
      for (int32_t f = 0; f < fn && x.ok; ++f) {
        uint8_t fc = bv(S_FC);
        p += iv(S_FP);
        long idx = p - 1;
        if (idx < read_i || idx > rl) return nullptr;
        if (idx > read_i) {
          ref_fill(sq + read_i, ref_pos, idx - read_i);
          ref_pos += idx - read_i;
          read_i = idx;
        }
        switch (fc) {
          case 'B':
            if (read_i >= rl) return nullptr;
            sq[read_i] = bv(S_BA);
            if (!no_qual) {
              qq[read_i] = bv(S_QS);
              have_qual = true;
            }
            ++read_i;
            ++ref_pos;
            break;
          case 'X': {
            if (read_i >= rl) return nullptr;
            int32_t code = iv(S_BS);
            if (code < 0 || code > 3) return nullptr;
            uint8_t rb;
            ref_fill(&rb, ref_pos, 1);
            sq[read_i] = d.subst[kRefIdxInit.tbl[rb]][code];
            ++read_i;
            ++ref_pos;
            break;
          }
          case 'I': {
            scratch.clear();
            long n = av(S_IN, scratch);
            if (n < 0 || read_i + n > rl) return nullptr;
            std::memcpy(sq + read_i, scratch.data(), n);
            read_i += n;
            break;
          }
          case 'i':
            if (read_i >= rl) return nullptr;
            sq[read_i] = bv(S_BA);
            ++read_i;
            break;
          case 'D':
            ref_pos += iv(S_DL);
            break;
          case 'N':
            ref_pos += iv(S_RS);
            break;
          case 'S': {
            scratch.clear();
            long n = av(S_SC, scratch);
            if (n < 0 || read_i + n > rl) return nullptr;
            std::memcpy(sq + read_i, scratch.data(), n);
            read_i += n;
            break;
          }
          case 'P':
            iv(S_PD);
            break;
          case 'H':
            iv(S_HC);
            break;
          case 'b': {
            scratch.clear();
            long n = av(S_BB, scratch);
            if (n < 0 || read_i + n > rl) return nullptr;
            std::memcpy(sq + read_i, scratch.data(), n);
            read_i += n;
            ref_pos += n;
            break;
          }
          case 'q': {
            if (no_qual) break;
            scratch.clear();
            long n = av(S_QQ, scratch);
            if (n < 0 || idx + n > rl) return nullptr;
            std::memcpy(qq + idx, scratch.data(), n);
            have_qual = true;
            break;
          }
          case 'Q':
            if (no_qual) break;
            if (idx >= rl) return nullptr;
            qq[idx] = bv(S_QS);
            have_qual = true;
            break;
          default:
            return nullptr;
        }
      }
      if (!x.ok) return nullptr;
      if (read_i < rl) ref_fill(sq + read_i, ref_pos, rl - read_i);
      iv(S_MQ);
      if ((cf & 1) && !no_qual) {
        const Codec* c = d.get(S_QS);
        if (!c || !read_bytes(*c, x, qq, rl)) return nullptr;
        have_qual = true;
      }
    } else {  // unmapped
      if (!(cf & 8)) {
        const Codec* c = d.get(S_BA);
        if (!c || !read_bytes(*c, x, sq, rl)) return nullptr;
      }
      if ((cf & 1) && !no_qual) {
        const Codec* c = d.get(S_QS);
        if (!c || !read_bytes(*c, x, qq, rl)) return nullptr;
        have_qual = true;
      }
      if (cf & 8) continue;  // SEQ '*': nothing to count
    }
    if (!x.ok) return nullptr;

    if (have_qual) {
      o += '@';
      o += name;
      o += '\n';
      o += seq;
      o += "\n+\n";
      size_t base = o.size();
      o.resize(base + rl + 1);
      for (int32_t i = 0; i < rl; ++i) {
        uint8_t q = qq[i] == 0xFF ? 0 : qq[i];
        o[base + i] = static_cast<char>((q > 93 ? 93 : q) + 33);
      }
      o[base + rl] = '\n';
    } else {
      o += '>';
      o += name;
      o += '\n';
      o += seq;
      o += '\n';
    }
  }
  if (!x.ok) return nullptr;
  return out.release();
}

// ---------------------------------------------------------------------
// BAM record parser: takes a window of the decompressed BAM stream
// (positioned at a record boundary, after the header/ref sections) and
// emits FASTA/FASTQ bytes for every COMPLETE record in the window.
// *consumed reports how many input bytes those records spanned; the
// caller carries the remainder into the next window. Returns null on a
// malformed record (python falls back and raises the precise error).

extern "C" void* jf_bam_records(const uint8_t* buf, long len,
                                long* consumed) {
  static uint8_t nib_lut[16];
  static bool init = false;
  if (!init) {
    std::memset(nib_lut, 'N', sizeof(nib_lut));
    nib_lut[1] = 'A';
    nib_lut[2] = 'C';
    nib_lut[4] = 'G';
    nib_lut[8] = 'T';
    init = true;
  }
  auto out = std::make_unique<cram::SliceOut>();
  std::string& o = out->buf;
  long pos = 0;
  *consumed = 0;
  while (pos + 4 <= len) {
    int32_t block_size;
    std::memcpy(&block_size, buf + pos, 4);
    if (block_size < 32) return nullptr;
    if (pos + 4 + block_size > len) break;  // partial record
    const uint8_t* rec = buf + pos + 4;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, rec + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, rec + 16, 4);
    long off = 32;
    if (l_read_name < 1 || l_seq < 0 ||
        off + l_read_name + 4L * n_cigar + (l_seq + 1) / 2 + l_seq >
            block_size)
      return nullptr;
    const uint8_t* name = rec + off;
    long name_len = l_read_name - 1;  // trailing NUL dropped
    off += l_read_name + 4L * n_cigar;
    if (l_seq > 0) {
      const uint8_t* packed = rec + off;
      off += (l_seq + 1) / 2;
      const uint8_t* qual = rec + off;
      bool has_qual = qual[0] != 0xFF;
      o += has_qual ? '@' : '>';
      o.append(reinterpret_cast<const char*>(name), name_len);
      o += '\n';
      size_t base = o.size();
      o.resize(base + l_seq);
      for (int32_t i = 0; i < l_seq; ++i) {
        uint8_t nb = (i & 1) ? (packed[i >> 1] & 0x0F)
                             : (packed[i >> 1] >> 4);
        o[base + i] = static_cast<char>(nib_lut[nb]);
      }
      if (has_qual) {
        o += "\n+\n";
        base = o.size();
        o.resize(base + l_seq);
        for (int32_t i = 0; i < l_seq; ++i) {
          uint8_t q = qual[i] > 93 ? 93 : qual[i];
          o[base + i] = static_cast<char>(q + 33);
        }
      }
      o += '\n';
    }
    pos += 4 + block_size;
    *consumed = pos;
  }
  return out.release();
}

extern "C" long jf_cram_out_len(void* h) {
  return static_cast<cram::SliceOut*>(h)->buf.size();
}

extern "C" void jf_cram_out_copy(void* h, uint8_t* dst) {
  auto* s = static_cast<cram::SliceOut*>(h);
  std::memcpy(dst, s->buf.data(), s->buf.size());
}

extern "C" void jf_cram_out_free(void* h) {
  delete static_cast<cram::SliceOut*>(h);
}
