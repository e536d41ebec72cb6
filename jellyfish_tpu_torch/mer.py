"""Host-side k-mers (the parts of jellyfish_tpu/mer.py that text databases
and `query` need, copied).

A k-mer is the 2k-bit big-endian base-4 integer of its string (first base
most significant; A=0, C=1, G=2, T=3, mer_dna.hpp:38-55).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MerDNA", "string_mers", "revcomp_np", "seq_mers_np"]

_CODES = {}
for _i, _b in enumerate("ACGT"):
    _CODES[_b] = _i
    _CODES[_b.lower()] = _i
_REV_CODES = "ACGT"


class MerDNA:
    """A k-mer: its length k and its 2k-bit value, from a string or from
    (k, bits), printed back as its string."""

    __slots__ = ("k", "bits")

    def __init__(self, k_or_str, bits: int = 0):
        if isinstance(k_or_str, str):
            self.k = len(k_or_str)
            v = 0
            for ch in k_or_str:
                c = _CODES.get(ch, -1)
                if c < 0:
                    raise ValueError(f"invalid base {ch!r}")
                v = (v << 2) | c
            self.bits = v
        else:
            self.k = int(k_or_str)
            self.bits = int(bits) & ((1 << (2 * self.k)) - 1)

    def __str__(self) -> str:
        return "".join(_REV_CODES[(self.bits >> (2 * i)) & 3]
                       for i in range(self.k - 1, -1, -1))

    def __repr__(self) -> str:
        return f"MerDNA({str(self)!r})"

    def get_reverse_complement(self) -> "MerDNA":
        v = self.bits
        rc = 0
        for _ in range(self.k):
            rc = (rc << 2) | (3 - (v & 3))
            v >>= 2
        return MerDNA(self.k, rc)

    def get_canonical(self) -> "MerDNA":
        rc = self.get_reverse_complement()
        return rc if rc.bits < self.bits else MerDNA(self.k, self.bits)


def string_mers(s: str, k: int):
    """Yield every k-mer of a string, skipping windows with invalid bases
    (swig/string_mers.i: scanning restarts after the bad base)."""
    mask = (1 << (2 * k)) - 1
    bits, filled = 0, 0
    for ch in s:
        c = _CODES.get(ch, -1)
        if c < 0:
            filled = 0
            continue
        bits = ((bits << 2) | c) & mask
        filled = min(filled + 1, k)
        if filled >= k:
            yield MerDNA(k, bits)


_CODE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase


def revcomp_np(mers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of uint64 mers (2k <= 64): complement
    is code^3, reversal swaps 2-bit groups then bytes
    (mer_dna.hpp:83-113's checkered-mask trick on a numpy vector)."""
    if 2 * k > 64:
        raise ValueError("revcomp_np requires 2k <= 64")
    mask = np.uint64((1 << (2 * k)) - 1)
    x = (np.asarray(mers, dtype=np.uint64) ^ mask) & mask
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = x.byteswap()
    return x >> np.uint64(64 - 2 * k)


def seq_mers_np(seq, k: int) -> np.ndarray:
    """All valid k-mer windows of a byte sequence as uint64 (2k <= 64),
    vectorized (the batch twin of string_mers). Windows containing invalid
    bases are skipped."""
    if 2 * k > 64:
        raise ValueError("seq_mers_np requires 2k <= 64")
    b = np.frombuffer(seq, dtype=np.uint8) if isinstance(
        seq, (bytes, bytearray)
    ) else np.asarray(seq, dtype=np.uint8)
    if len(b) < k:
        return np.zeros(0, dtype=np.uint64)
    codes = _CODE_LUT[b]
    ok = codes >= 0
    cs = np.concatenate([[0], np.cumsum(ok, dtype=np.int64)])
    valid = (cs[k:] - cs[:-k]) == k  # all k bases of the window valid
    u = np.where(ok, codes, 0).astype(np.uint64)
    m = np.zeros(len(b) - k + 1, dtype=np.uint64)
    for j in range(k):
        m = (m << np.uint64(2)) | u[j : len(b) - k + 1 + j]
    return m[valid]
