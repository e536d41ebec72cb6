"""Host-side k-mer strings (the part of jellyfish_tpu/mer.py that text
databases need, copied).

A k-mer is the 2k-bit big-endian base-4 integer of its string (first base
most significant; A=0, C=1, G=2, T=3, mer_dna.hpp:38-55).
"""

from __future__ import annotations

__all__ = ["MerDNA"]

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
