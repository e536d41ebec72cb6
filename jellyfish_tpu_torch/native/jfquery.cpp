// libjfquery: linkable C/C++ query library for jellyfish_tpu_torch databases.
//
// The reference ships its query path as a headers-only C++ library
// (jellyfish/file_header.hpp + binary_dumper.hpp:112-213 binary_query_base)
// that clients link against to read .jf files without the CLI. This is the
// equivalent for jellyfish_tpu_torch: a single translation unit, no
// dependencies, C ABI (usable from C, C++, ctypes, cffi, any FFI).
//
//   jf_query_t* q = jf_query_open("counts.jf");
//   int64_t n = jf_query_mer(q, "ACGTACGTACGTACGTACGTA");   // count, -1 bad
//   jf_query_close(q);
//
// Files are binary/sorted (binary_dumper.hpp:36-40 record layout:
// ceil(2k/8) little-endian key bytes + counter_len count bytes) behind the
// 9-digit + JSON + NUL-pad header (generic_file_header.hpp:88-143), sorted
// ascending by (pos, key) with pos = matrix1 * key & (size-1)
// (rectangular_binary_matrix.hpp times()). Canonical databases are looked
// up by min(mer, revcomp).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC jfquery.cpp -o libjfquery.so
// (the python test suite builds and exercises it via ctypes;
// examples/query_client.c is a pure-C consumer).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

// ---- minimal JSON scanner (headers are machine-written, sorted-key,
// terse JsonCpp-style JSON; strings may contain arbitrary bytes, so the
// scanner tracks string state + escapes and object depth properly) ----

struct JsonScanner {
  const char* p;
  const char* end;

  explicit JsonScanner(const char* s, size_t n) : p(s), end(s + n) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool skip_string() {  // at opening quote
    if (p >= end || *p != '"') return false;
    ++p;
    while (p < end) {
      if (*p == '\\') { p += 2; continue; }
      if (*p == '"') { ++p; return true; }
      ++p;
    }
    return false;
  }

  // skip any value (object/array/string/number/bool/null)
  bool skip_value() {
    skip_ws();
    if (p >= end) return false;
    if (*p == '"') return skip_string();
    if (*p == '{' || *p == '[') {
      char open = *p, close = (open == '{') ? '}' : ']';
      int depth = 0;
      while (p < end) {
        if (*p == '"') { if (!skip_string()) return false; continue; }
        if (*p == open) ++depth;
        else if (*p == close) { --depth; if (!depth) { ++p; return true; } }
        ++p;
      }
      return false;
    }
    while (p < end && *p != ',' && *p != '}' && *p != ']') ++p;
    return true;
  }
};

// find the value of `key` in the object starting at `obj` (top level only)
bool find_key(const char* obj, size_t n, const char* key,
              const char** val, size_t* val_len) {
  JsonScanner s(obj, n);
  s.skip_ws();
  if (s.p >= s.end || *s.p != '{') return false;
  ++s.p;
  std::string want = std::string("\"") + key + "\"";
  while (s.p < s.end) {
    s.skip_ws();
    if (s.p < s.end && *s.p == '}') return false;
    const char* kstart = s.p;
    if (!s.skip_string()) return false;
    std::string k(kstart, s.p - kstart);
    s.skip_ws();
    if (s.p >= s.end || *s.p != ':') return false;
    ++s.p;
    s.skip_ws();
    const char* vstart = s.p;
    if (!s.skip_value()) return false;
    if (k == want) {
      *val = vstart;
      *val_len = s.p - vstart;
      return true;
    }
    s.skip_ws();
    if (s.p < s.end && *s.p == ',') ++s.p;
  }
  return false;
}

bool get_u64(const char* obj, size_t n, const char* key, uint64_t* out) {
  const char* v; size_t vl;
  if (!find_key(obj, n, key, &v, &vl)) return false;
  *out = strtoull(std::string(v, vl).c_str(), nullptr, 10);
  return true;
}

bool get_bool(const char* obj, size_t n, const char* key, bool* out) {
  const char* v; size_t vl;
  if (!find_key(obj, n, key, &v, &vl)) return false;
  *out = (vl >= 4 && !strncmp(v, "true", 4));
  return true;
}

}  // namespace

// public ABI declarations — including the shipped header here makes the
// compiler reject any header/implementation signature drift
#include "jfquery.h"

extern "C" {

struct jf_query_t {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_len = 0;
  size_t offset = 0;       // first record byte
  uint64_t n_records = 0;
  unsigned k = 0;
  unsigned key_bytes = 0;
  unsigned counter_len = 0;
  unsigned rec_len = 0;
  uint64_t size_mask = 0;  // table size - 1
  bool canonical = false;
  bool identity = false;   // matrix1 is the low-identity
  unsigned mat_r = 0, mat_c = 0;
  std::vector<uint64_t> columns;  // c columns, r<=64 bits each

  const uint8_t* rec(uint64_t i) const { return map + offset + i * rec_len; }

  // key bytes (little-endian) of record i
  uint64_t count_at(uint64_t i) const {
    const uint8_t* r = rec(i) + key_bytes;
    uint64_t v = 0;
    for (unsigned b = 0; b < counter_len; ++b)
      v |= (uint64_t)r[b] << (8 * b);
    return v;
  }

  // hash position of a key given as little-endian bytes: key bit j
  // multiplies column[c-1-j] (rectangular_binary_matrix.hpp times())
  uint64_t pos_of(const uint8_t* key) const {
    if (identity) {
      uint64_t lo = 0;
      for (unsigned b = 0; b < 8 && b < key_bytes; ++b)
        lo |= (uint64_t)key[b] << (8 * b);
      return lo & size_mask;
    }
    uint64_t res = 0;
    for (unsigned j = 0; j < mat_c; ++j) {
      if ((key[j >> 3] >> (j & 7)) & 1) res ^= columns[mat_c - 1 - j];
    }
    return res & size_mask;
  }

  // compare key bytes (little-endian) as big integers
  int key_cmp(const uint8_t* a, const uint8_t* b) const {
    for (int i = (int)key_bytes - 1; i >= 0; --i) {
      if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
  }
};

const char* jf_query_error(void) { return g_error.c_str(); }

void jf_query_close(jf_query_t* q) {
  if (!q) return;
  if (q->map) munmap(q->map, q->map_len);
  if (q->fd >= 0) close(q->fd);
  delete q;
}

jf_query_t* jf_query_open(const char* path) {
  jf_query_t* q = new jf_query_t();
  q->fd = open(path, O_RDONLY);
  if (q->fd < 0) {
    set_error(std::string("cannot open ") + path);
    jf_query_close(q);
    return nullptr;
  }
  struct stat st;
  if (fstat(q->fd, &st) != 0 || st.st_size < 10) {
    set_error("stat failed or file too small");
    jf_query_close(q);
    return nullptr;
  }
  q->map_len = (size_t)st.st_size;
  q->map = (uint8_t*)mmap(nullptr, q->map_len, PROT_READ, MAP_SHARED,
                          q->fd, 0);
  if (q->map == MAP_FAILED) {
    q->map = nullptr;
    set_error("mmap failed");
    jf_query_close(q);
    return nullptr;
  }
  // 9-digit header length + JSON (+ NUL pad)
  char digits[10] = {0};
  memcpy(digits, q->map, 9);
  for (int i = 0; i < 9; ++i) {
    if (digits[i] < '0' || digits[i] > '9') {
      set_error("not a jellyfish database (bad header length)");
      jf_query_close(q);
      return nullptr;
    }
  }
  size_t hlen = strtoull(digits, nullptr, 10);
  if (9 + hlen > q->map_len) {
    set_error("truncated header");
    jf_query_close(q);
    return nullptr;
  }
  const char* json = (const char*)q->map + 9;
  q->offset = 9 + hlen;

  uint64_t key_len = 0, size = 0, counter_len = 0;
  const char* fmt; size_t fmt_len;
  if (!find_key(json, hlen, "format", &fmt, &fmt_len) ||
      std::string(fmt, fmt_len) != "\"binary/sorted\"") {
    set_error("not a binary/sorted database");
    jf_query_close(q);
    return nullptr;
  }
  if (!get_u64(json, hlen, "key_len", &key_len) ||
      !get_u64(json, hlen, "size", &size) ||
      !get_u64(json, hlen, "counter_len", &counter_len)) {
    set_error("missing key_len/size/counter_len");
    jf_query_close(q);
    return nullptr;
  }
  get_bool(json, hlen, "canonical", &q->canonical);
  q->k = (unsigned)(key_len / 2);
  q->key_bytes = (unsigned)((key_len + 7) / 8);
  q->counter_len = (unsigned)counter_len;
  q->rec_len = q->key_bytes + q->counter_len;
  q->size_mask = size - 1;

  const char* mat; size_t mat_len;
  if (!find_key(json, hlen, "matrix1", &mat, &mat_len)) {
    set_error("missing matrix1");
    jf_query_close(q);
    return nullptr;
  }
  uint64_t r = 0, c = 0;
  get_u64(mat, mat_len, "r", &r);
  get_u64(mat, mat_len, "c", &c);
  q->mat_r = (unsigned)r;
  q->mat_c = (unsigned)c;
  bool ident = false;
  get_bool(mat, mat_len, "identity", &ident);
  q->identity = ident;
  if (!ident) {
    const char* cols; size_t cols_len;
    if (!find_key(mat, mat_len, "columns", &cols, &cols_len)) {
      set_error("missing matrix1 columns");
      jf_query_close(q);
      return nullptr;
    }
    const char* p = cols;
    const char* endp = cols + cols_len;
    while (p < endp && *p != '[') ++p;
    ++p;
    while (p < endp) {
      while (p < endp && (*p == ' ' || *p == ',')) ++p;
      if (p >= endp || *p == ']') break;
      char* next;
      q->columns.push_back(strtoull(p, &next, 10));
      p = next;
    }
    if (q->columns.size() != q->mat_c) {
      set_error("matrix1 column count mismatch");
      jf_query_close(q);
      return nullptr;
    }
  }

  size_t body = q->map_len - q->offset;
  if (body % q->rec_len != 0) {
    set_error("database size is not a multiple of the record length");
    jf_query_close(q);
    return nullptr;
  }
  q->n_records = body / q->rec_len;
  return q;
}

unsigned jf_query_k(const jf_query_t* q) { return q->k; }
int jf_query_canonical(const jf_query_t* q) { return q->canonical ? 1 : 0; }
uint64_t jf_query_nb_records(const jf_query_t* q) { return q->n_records; }

// Pre-fault the mapping (the reference's query -l / mapped_file::load).
void jf_query_preload(jf_query_t* q) {
  madvise(q->map, q->map_len, MADV_WILLNEED);
  volatile uint64_t acc = 0;
  for (size_t off = 0; off < q->map_len; off += 4096) acc += q->map[off];
  (void)acc;
}

// Count of the key given as little-endian 2-bit-code bytes (already
// canonicalized if the database is canonical). Plain binary search on
// (pos, key) order — the mmap'd analogue of binary_query_base::val_id.
uint64_t jf_query_key(jf_query_t* q, const uint8_t* key) {
  uint64_t lo = 0, hi = q->n_records;
  uint64_t qpos = q->pos_of(key);
  while (lo < hi) {
    uint64_t mid = lo + (hi - lo) / 2;
    const uint8_t* mkey = q->rec(mid);
    uint64_t mpos = q->pos_of(mkey);
    int kc = q->key_cmp(mkey, key);
    if (mpos < qpos || (mpos == qpos && kc < 0)) {
      lo = mid + 1;
    } else if (mpos == qpos && kc == 0) {
      return q->count_at(mid);
    } else {
      hi = mid;
    }
  }
  return 0;
}

// Count of a mer given as an ACGT string of length k. Returns -1 on a bad
// mer (wrong length or non-ACGT base); canonicalizes when the database is
// canonical (mer_dna.hpp:428-431 min(mer, revcomp) rule).
int64_t jf_query_mer(jf_query_t* q, const char* mer) {
  unsigned k = q->k;
  if (strlen(mer) != k) return -1;
  std::vector<uint8_t> key(q->key_bytes, 0), rc(q->key_bytes, 0);
  for (unsigned i = 0; i < k; ++i) {
    int code;
    switch (mer[i]) {
      case 'A': case 'a': code = 0; break;
      case 'C': case 'c': code = 1; break;
      case 'G': case 'g': code = 2; break;
      case 'T': case 't': code = 3; break;
      default: return -1;
    }
    // big-endian base order: base i sits at bit 2*(k-1-i)
    unsigned bit = 2 * (k - 1 - i);
    key[bit >> 3] |= (uint8_t)(code << (bit & 7));
    // revcomp: complemented base at position k-1-i -> bit 2*i
    unsigned rbit = 2 * i;
    rc[rbit >> 3] |= (uint8_t)((3 - code) << (rbit & 7));
  }
  const uint8_t* use = key.data();
  if (q->canonical && q->key_cmp(rc.data(), key.data()) < 0)
    use = rc.data();
  return (int64_t)jf_query_key(q, use);
}

// Record access for sequential iteration (dump analogue): writes the mer
// string (k chars + NUL, caller provides k+1 bytes) and the count.
// Returns 0 past the end.
int jf_query_record(jf_query_t* q, uint64_t idx, char* mer_out,
                    uint64_t* count) {
  if (idx >= q->n_records) return 0;
  const uint8_t* keyb = q->rec(idx);
  static const char bases[4] = {'A', 'C', 'G', 'T'};
  for (unsigned i = 0; i < q->k; ++i) {
    unsigned bit = 2 * (q->k - 1 - i);
    mer_out[i] = bases[(keyb[bit >> 3] >> (bit & 7)) & 3];
  }
  mer_out[q->k] = '\0';
  *count = q->count_at(idx);
  return 1;
}

}  // extern "C"
