"""Memory model of the reference hash table (`jellyfish mem` backend; a
copy of jellyfish_tpu/memmodel.py).

Re-implements large_hash::array::usage_info (large_hash_array.hpp:97-147)
and the Offsets bit-packing block math (offsets_key_value.hpp:241-267,
add_key_offsets :156-173, add_val_offsets :176-183): records of
(key_len+1 large bit [+set bits when straddling words], val_len) bits are
packed into 64-bit words; a block is the run of records until a record
re-aligns to a word boundary.

Verified against the documented outputs: mem(-m 24, -s 1G) =
4,521,043,056 bytes and size(-m 31, --mem 8g) = 1,073,741,824 entries
(doc/Readme.md:262-276).
"""

from __future__ import annotations

__all__ = ["UsageInfo", "quadratic_reprobes_list"]

WORD = 64

# sizeof(array_base) + sizeof(Offsets<uint64_t>) in the reference build —
# the fixed overhead added to the table memory (large_hash_array.hpp:114).
STRUCT_OVERHEAD = 24816

quadratic_reprobes_list = [1] + [i * (i + 1) // 2 for i in range(1, 257)]


def _bitsize(n: int) -> int:
    return max(1, int(n).bit_length())


def _ceil_log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


def _add_key(cword: int, cboff: int, add: int):
    if cboff + add <= WORD:
        cboff = (cboff + add) % WORD
        if cboff == 0:
            cword += 1
        return cword, cboff
    wcap = WORD - 1  # word capacity without the set bit
    add -= wcap - cboff
    cword += 1 + add // wcap
    cboff = add % wcap
    if cboff > 0:
        cboff += 1  # set bit in the last partial word
    return cword, cboff


def _add_val(cword: int, cboff: int, add: int):
    cboff += add
    cword += cboff // WORD
    cboff %= WORD
    return cword, cboff


def block_info(key_len: int, val_len: int, reprobe_limit: int):
    """(records per block, words per block) for the packed layout."""
    cword = cboff = 0
    n = 0
    while True:
        cword, cboff = _add_key(cword, cboff, key_len + 1)
        cword, cboff = _add_val(cword, cboff, val_len)
        n += 1
        if not (cboff != 0 and cboff < WORD - 2):
            break
    return n, cword + (1 if cboff else 0)


class UsageInfo:
    """usage_info equivalent: size <-> bytes for the reference layout."""

    def __init__(self, key_len: int, val_len: int, reprobe_limit: int = 126):
        self.key_len = int(key_len)  # 2k bits
        self.val_len = int(val_len)
        self.reprobe_limit = int(reprobe_limit)

    def mem(self, size: int) -> int:
        """Bytes needed for a table of `size` entries."""
        lsize = _ceil_log2(size)
        asize = 1 << lsize
        limit = self.reprobe_limit
        while limit >= 1 and quadratic_reprobes_list[limit] >= asize:
            limit -= 1
        raw_key = self.key_len - lsize if self.key_len > lsize else 0
        bl, bw = block_info(raw_key + _bitsize(limit + 1), self.val_len, limit + 1)
        return -(-asize // bl) * bw * 8 + STRUCT_OVERHEAD

    def asize(self, size: int) -> int:
        return 1 << _ceil_log2(size)

    def size_bits(self, mem_limit: int) -> int:
        i = 0
        while i < 64 and self.mem(1 << i) < mem_limit:
            i += 1
        return i - 1 if i > 0 else 0

    def size(self, mem_limit: int) -> int:
        """Largest table size fitting in mem_limit bytes."""
        return 1 << self.size_bits(mem_limit)
