"""Jellyfish database files: binary/sorted and text/sorted readers and
writers, and random access into a binary database (the parts of
jellyfish_tpu/io/files.py that `count`, `merge`, `query` and the database
tools use, copied).

Formats (binary_dumper.hpp, text_dumper.hpp):
  binary/sorted: header, then per record ceil(2k/8) key bytes (little-endian)
                 + counter_len bytes of count (little-endian, saturated).
  text/sorted:   header, then "MER COUNT\n" lines.
Both are sorted ascending by (pos, key), pos = matrix.times(key) & (size-1).
"""

from __future__ import annotations

import mmap
import os
from typing import Iterator, Tuple

import numpy as np

from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.io.header import FileHeader, quadratic_reprobes
from jellyfish_tpu_torch.mer import MerDNA

__all__ = [
    "make_count_header",
    "write_binary_records",
    "write_text_records",
    "encode_binary_records_np",
    "mer_strings_np",
    "DBReader",
    "BinaryQuery",
]


def encode_binary_records_np(keys_u32: np.ndarray, counts: np.ndarray,
                             k: int, counter_len: int) -> bytes:
    """Vectorized binary/sorted record block: [n, W] uint32 key limbs +
    uint64 counts -> packed record bytes (binary_dumper.hpp:36-40 layout:
    ceil(2k/8) little-endian key bytes + counter_len bytes, saturated)."""
    n, W = keys_u32.shape
    key_bytes = (2 * k + 7) // 8
    rec = key_bytes + counter_len
    buf = np.empty((n, rec), dtype=np.uint8)
    kb = np.ascontiguousarray(keys_u32.astype("<u4")).view(np.uint8)
    buf[:, :key_bytes] = kb.reshape(n, 4 * W)[:, :key_bytes]
    max_val = np.uint64((1 << (8 * counter_len)) - 1)
    sat = np.minimum(counts.astype(np.uint64), max_val)
    cb = np.ascontiguousarray(sat.astype("<u8")).view(np.uint8).reshape(n, 8)
    buf[:, key_bytes:] = cb[:, :counter_len]
    return buf.tobytes()


_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def mer_strings_np(keys_u32: np.ndarray, k: int) -> np.ndarray:
    """[n, W] uint32 key limbs -> [n, k] uint8 base chars (vectorized
    to_chars, mer_dna.hpp:452-462)."""
    n, W = keys_u32.shape
    chars = np.empty((n, k), dtype=np.uint8)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        code = (keys_u32[:, bit // 32] >> np.uint32(bit % 32)) & np.uint32(3)
        chars[:, j] = _BASE_LUT[code]
    return chars


def make_count_header(
    *,
    k: int,
    size: int,
    matrix: GF2Matrix,
    canonical: bool,
    val_len_bits: int = 7,
    max_reprobe: int = 126,
    fmt: str = FileHeader.FORMAT_BINARY,
    counter_len_bytes: int = 4,
    cmdline=None,
) -> FileHeader:
    h = FileHeader()
    h.size = size
    h.key_len = 2 * k
    h.val_len = val_len_bits
    h.set_matrix(matrix)
    # cap like reprobe_limit_t (large_hash_array.hpp:29-39)
    limit = max_reprobe
    while limit >= 1 and quadratic_reprobes[limit] >= size:
        limit -= 1
    h.max_reprobe = limit
    h.set_reprobes()
    h.canonical = canonical
    h.format = fmt
    if fmt == FileHeader.FORMAT_BINARY:
        h.counter_len = counter_len_bytes
    h.fill_standard()
    if cmdline is not None:
        h.set_cmdline(cmdline)
    return h


def write_binary_records(fobj, mers, counts, k: int, counter_len: int) -> None:
    """Stream (mer int, count) records; counts saturate at the field max
    (binary_dumper.hpp:36-40)."""
    key_bytes = (2 * k + 7) // 8
    max_val = (1 << (8 * counter_len)) - 1
    recs = bytearray()
    for m, v in zip(mers, counts):
        v = int(v)
        recs += int(m).to_bytes(key_bytes, "little")
        recs += min(v, max_val).to_bytes(counter_len, "little")
        if len(recs) >= 1 << 20:
            fobj.write(recs)
            recs = bytearray()
    fobj.write(recs)


def write_text_records(fobj, mers, counts, k: int) -> None:
    lines = []
    for m, v in zip(mers, counts):
        lines.append(f"{MerDNA(k, int(m))} {int(v)}\n")
        if len(lines) >= 65536:
            fobj.write("".join(lines).encode())
            lines = []
    fobj.write("".join(lines).encode())


class DBReader:
    """Sequential reader over binary/sorted or text/sorted databases
    (binary_reader / text_reader analogue)."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        try:
            self.header = FileHeader.read(self.f)
        except BaseException:
            self.f.close()
            raise
        self.k = self.header.key_len // 2
        self.fmt = self.header.format
        if self.fmt == FileHeader.FORMAT_BINARY:
            self._key_bytes = (self.header.key_len + 7) // 8
            self._counter_len = self.header.counter_len
            self._rec_len = self._key_bytes + self._counter_len
        elif self.fmt != FileHeader.FORMAT_TEXT:
            self.f.close()
            raise ValueError(f"unknown format {self.fmt!r}")
        self._matrix = None

    @property
    def matrix(self) -> GF2Matrix:
        if self._matrix is None:
            self._matrix = self.header.matrix()
        return self._matrix

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        """Yield (mer_bits, count)."""
        if self.fmt == FileHeader.FORMAT_BINARY:
            rec = self._rec_len
            kb = self._key_bytes
            while True:
                buf = self.f.read(rec << 12)
                if not buf:
                    return
                n = len(buf) // rec
                for i in range(n):
                    off = i * rec
                    key = int.from_bytes(buf[off : off + kb], "little")
                    val = int.from_bytes(buf[off + kb : off + rec], "little")
                    yield key, val
        else:
            import io as _io

            for line in _io.TextIOWrapper(self.f):
                if not line.strip():
                    continue
                mer_s, val_s = line.split()
                yield MerDNA(mer_s).bits, int(val_s)

    def _decode_records(self, data: bytes):
        rec = self._rec_len
        n = len(data) // rec
        arr = np.frombuffer(data, dtype=np.uint8, count=n * rec).reshape(n, rec)
        kb = self._key_bytes
        keys = arr[:, :kb]
        counts = np.zeros(n, dtype=np.uint64)
        for b in range(self._counter_len):
            counts |= arr[:, kb + b].astype(np.uint64) << np.uint64(8 * b)
        return keys, counts

    def records_np(self):
        """Bulk-load a binary DB: (keys [n, key_bytes] uint8, counts
        uint64)."""
        if self.fmt != FileHeader.FORMAT_BINARY:
            raise ValueError("records_np requires binary format")
        return self._decode_records(self.f.read())

    def read_records_np(self, n: int):
        """Read up to n records: same layout as records_np; empty arrays at
        EOF."""
        if self.fmt != FileHeader.FORMAT_BINARY:
            raise ValueError("read_records_np requires binary format")
        return self._decode_records(self.f.read(n * self._rec_len))

    def counts_np(self) -> np.ndarray:
        if self.fmt == FileHeader.FORMAT_BINARY:
            return self.records_np()[1]
        return np.array([v for _, v in self], dtype=np.uint64)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _np_positions(key_limbs: np.ndarray, matrix, lsize: int) -> np.ndarray:
    """Hash positions of keys [n, W] uint32 limbs on the host: the parity
    of (key & mask) per output bit (the host twin of
    ops/hashing.gf2_apply_masks)."""
    from jellyfish_tpu_torch.ops.hashing import masks_of_matrix

    n, W = key_limbs.shape
    if matrix.is_low_identity():
        pos = key_limbs[:, 0].astype(np.uint64)
        if W > 1 and lsize > 32:
            pos |= key_limbs[:, 1].astype(np.uint64) << np.uint64(32)
        return pos & np.uint64((1 << lsize) - 1)
    masks = masks_of_matrix(matrix, W)
    pos = np.zeros(n, dtype=np.uint64)
    for j in range(matrix.r):
        t = key_limbs[:, 0] & masks[j, 0]
        for w in range(1, W):
            t = t ^ (key_limbs[:, w] & masks[j, w])
        for s in (16, 8, 4, 2, 1):
            t = t ^ (t >> np.uint32(s))
        pos |= (t & np.uint32(1)).astype(np.uint64) << np.uint64(j)
    return pos & np.uint64((1 << lsize) - 1)


class BinaryQuery:
    """Random access into a binary/sorted DB by guided binary search on hash
    position (binary_dumper.hpp:112-213)."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        self.header = FileHeader.read(self.f)
        if self.header.format != FileHeader.FORMAT_BINARY:
            raise ValueError("query requires a binary/sorted database")
        self.k = self.header.key_len // 2
        self.matrix = self.header.matrix()
        self.mask = self.header.size - 1
        self._key_bytes = (self.header.key_len + 7) // 8
        self._counter_len = self.header.counter_len
        self._rec = self._key_bytes + self._counter_len
        self.offset = self.header.offset
        size = os.fstat(self.f.fileno()).st_size - self.offset
        if size % self._rec != 0:
            raise ValueError(
                f"database size {size} is not a multiple of record length "
                f"{self._rec}"
            )
        self.n = size // self._rec
        self.mm = mmap.mmap(self.f.fileno(), 0, access=mmap.ACCESS_READ)
        if self.n:
            self._first_key = self._key_at(0)
            self._last_key = self._key_at(self.n - 1)
            self._first_pos = self._pos(self._first_key)
            self._last_pos = self._pos(self._last_key)

    def preload(self) -> None:
        """Pre-fault the whole mapping (query -l/--load; the reference's
        mapped_file::load + sequential madvise, mapped_file.hpp:24-150,
        query_main.cc:109-114)."""
        try:
            self.mm.madvise(mmap.MADV_WILLNEED)
        except (AttributeError, ValueError, OSError):
            pass
        step = mmap.PAGESIZE * 1024
        for off in range(0, len(self.mm), step):
            self.mm[off]

    def _records_view(self) -> np.ndarray:
        """[n, rec] uint8 zero-copy view over the mmap."""
        return np.frombuffer(
            self.mm, dtype=np.uint8, count=self.n * self._rec,
            offset=self.offset,
        ).reshape(self.n, self._rec)

    def check_batch(self, mer_bits: np.ndarray) -> np.ndarray:
        """Counts for a uint64 array of (already canonicalized) mers,
        2k <= 64: one vectorized binary search over (pos, key) order (the
        batch counterpart of binary_query_base::val_id)."""
        q = np.ascontiguousarray(mer_bits, dtype=np.uint64)
        out = np.zeros(len(q), dtype=np.uint64)
        if self.n == 0 or len(q) == 0:
            return out
        if self._key_bytes > 8:
            raise ValueError("check_batch requires 2k <= 64")
        recs = self._records_view()
        kb = self._key_bytes
        nw = (kb + 3) // 4

        def key_of(idx: np.ndarray) -> np.ndarray:
            b = recs[idx, :kb].astype(np.uint64)
            k = np.zeros(len(idx), dtype=np.uint64)
            for j in range(kb):
                k |= b[:, j] << np.uint64(8 * j)
            return k

        def limbs_of(v: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(np.stack(
                [(v >> np.uint64(32 * w)).astype(np.uint32)
                 for w in range(nw)], axis=1))

        lsize = max(0, (self.header.size - 1).bit_length())
        qpos = _np_positions(limbs_of(q), self.matrix, lsize)
        lo = np.zeros(len(q), dtype=np.int64)
        hi = np.full(len(q), self.n, dtype=np.int64)
        # records are sorted by (pos, key): plain vectorized binary search
        for _ in range(int(self.n).bit_length() + 1):
            mid = (lo + hi) >> 1
            live = lo < hi
            mk = key_of(np.where(live, mid, 0))
            mp = _np_positions(limbs_of(mk), self.matrix, lsize)
            less = (mp < qpos) | ((mp == qpos) & (mk < q))
            lo = np.where(live & less, mid + 1, lo)
            hi = np.where(live & ~less, mid, hi)
        found = lo < self.n
        found &= key_of(np.where(found, lo, 0)) == q
        idx = np.where(found, lo, 0)
        cb = recs[idx, kb : kb + self._counter_len].astype(np.uint64)
        vals = np.zeros(len(q), dtype=np.uint64)
        for j in range(self._counter_len):
            vals |= cb[:, j] << np.uint64(8 * j)
        out[found] = vals[found]
        return out

    def _key_at(self, i: int) -> int:
        off = self.offset + i * self._rec
        return int.from_bytes(self.mm[off : off + self._key_bytes], "little")

    def _val_at(self, i: int) -> int:
        off = self.offset + i * self._rec + self._key_bytes
        return int.from_bytes(self.mm[off : off + self._counter_len], "little")

    def _pos(self, key: int) -> int:
        return self.matrix.times(key) & self.mask

    def check(self, mer_bits: int) -> int:
        """Count of a mer (0 if absent). Guided binary search then linear
        scan, mirroring binary_query_base::val_id."""
        if self.n == 0:
            return 0
        key = int(mer_bits)
        if key == self._first_key:
            return self._val_at(0)
        if key == self._last_key:
            return self._val_at(self.n - 1)
        pos = self._pos(key)
        if pos < self._first_pos or pos > self._last_pos:
            return 0
        first, last = 0, self.n
        first_pos, last_pos = self._first_pos, self._last_pos
        while last - first >= 8:
            denom = last_pos - first_pos
            if denom <= 0:
                break
            cid = first + round((last - first) * (pos - first_pos) / denom)
            cid = max(first + 1, min(cid, last - 1))
            mid_key = self._key_at(cid)
            if mid_key == key:
                return self._val_at(cid)
            mid_pos = self._pos(mid_key)
            if mid_pos > pos or (mid_pos == pos and mid_key > key):
                last, last_pos = cid, mid_pos
            else:
                first, first_pos = cid, mid_pos
        for cid in range(first + 1, last):
            if self._key_at(cid) == key:
                return self._val_at(cid)
        return 0

    def close(self):
        self.mm.close()
        self.f.close()
