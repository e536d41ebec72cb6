/* jfquery.h — public C ABI of libjfquery, the linkable query library for
 * jellyfish_tpu_torch databases (the JAX package's format, byte for byte).
 *
 * The reference exposes its query path as a linkable C++ library
 * (jellyfish/file_header.hpp + binary_dumper.hpp:112-213 binary_query_base,
 * shipped as libjellyfish-2.0 with a pkg-config file, Makefile.am:69-126).
 * This is the equivalent surface with a plain C ABI: usable from C, C++,
 * ctypes/cffi, or any FFI.
 *
 *   jf_query_t* q = jf_query_open("counts.jf");
 *   if (!q) { fputs(jf_query_error(), stderr); ... }
 *   int64_t n = jf_query_mer(q, "ACGTACGTACGTACGTACGTA");  // count, -1 bad
 *   jf_query_close(q);
 *
 * Build/install: `make -C jellyfish_tpu_torch/native install PREFIX=...`
 * ships libjfquery.so, this header, and a jfquery.pc pkg-config file.
 */
#ifndef JFQUERY_H
#define JFQUERY_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct jf_query_t jf_query_t;

/* Open a binary/sorted database (mmap, read-only). NULL on error (see
 * jf_query_error). */
jf_query_t* jf_query_open(const char* path);

void jf_query_close(jf_query_t* q);

/* Thread-local message for the most recent failure. */
const char* jf_query_error(void);

/* k (mer length), canonical flag, and record count of the open DB. */
unsigned jf_query_k(const jf_query_t* q);
int jf_query_canonical(const jf_query_t* q);
uint64_t jf_query_nb_records(const jf_query_t* q);

/* Count of a mer given as an ACGT string of length k (canonicalized when
 * the DB is canonical). 0 = absent, -1 = malformed mer. */
int64_t jf_query_mer(jf_query_t* q, const char* mer);

/* Count of a key given as ceil(2k/8) little-endian 2-bit-code bytes
 * (already canonicalized if the DB is canonical). 0 = absent. */
uint64_t jf_query_key(jf_query_t* q, const uint8_t* key);

/* Sequential record access: writes the idx-th mer (NUL-terminated, caller
 * buffer must hold k+1 bytes) and its count. Returns 1 on success, 0 when
 * idx is past the end. Records are in hash (dump) order. */
int jf_query_record(jf_query_t* q, uint64_t idx, char* mer_out,
                    uint64_t* count);

/* Pre-fault the mmap'd database into memory (the `query -l` preload,
 * mapped_file.hpp load() analogue). */
void jf_query_preload(jf_query_t* q);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* JFQUERY_H */
