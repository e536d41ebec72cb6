"""Jellyfish database records and headers (the parts of
jellyfish_tpu/io/files.py that `count` writes with, copied).

binary/sorted (binary_dumper.hpp): header, then per record ceil(2k/8) key
bytes (little-endian) + counter_len bytes of count (little-endian,
saturated), sorted ascending by (pos, key).
"""

from __future__ import annotations

import numpy as np

from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.io.header import FileHeader, quadratic_reprobes

__all__ = ["make_count_header", "encode_binary_records_np", "mer_strings_np"]


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
