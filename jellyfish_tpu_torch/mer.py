"""Host-side k-mer value type (a copy of jellyfish_tpu/mer.py): the
scripting API's MerDNA, text databases and `query`.

Mirrors the semantics of the reference `mer_dna`
(include/jellyfish/mer_dna.hpp): a k-mer is the 2k-bit big-endian base-4
integer of its string (first base most significant; A=0, C=1, G=2, T=3,
mer_dna.hpp:38-55), stored and serialized as little-endian words. The
class plays the role of the SWIG `MerDNA` binding (swig/mer_dna.i):
`MerDNA.k()` is the global k, shifts, in-place and copying
canonicalization and reverse complement, poly-bases, randomize, bit
access, bytes, ordering and hashing. Deliberately simple python: the hot
path is the device pipeline.
"""

from __future__ import annotations

__all__ = ["MerDNA", "CODES", "REV_CODES", "string_mers", "string_canonicals",
           "revcomp_np", "seq_mers_np"]

# Byte -> 2-bit code. -1 = invalid/reset (like reference CODE_RESET); the
# reference also has ignore/comment codes used only by its parsers.
CODES = {}
for _i, _b in enumerate("ACGT"):
    CODES[_b] = _i
    CODES[_b.lower()] = _i
REV_CODES = "ACGT"


def _code(ch: str) -> int:
    return CODES.get(ch, -1)


_default_k = [None]


def _k_accessor(value=None):
    """MerDNA.k() / MerDNA.k(21): global default k, mirroring the
    reference's static mer_dna::k() (mer_dna.hpp:626-671, swig/mer_dna.i)."""
    if value is not None:
        _default_k[0] = int(value)
    return _default_k[0]


class _KAttr:
    """`MerDNA.k` is the global-k accessor on the class, and the instance's
    own length on an instance (both reference behaviors)."""

    def __get__(self, obj, owner):
        if obj is None:
            return _k_accessor
        return obj._k

    def __set__(self, obj, value):
        obj._k = int(value)


class MerDNA:
    """A k-mer as an arbitrary-precision big-endian base-4 integer."""

    __slots__ = ("_k", "bits")

    k = _KAttr()

    def __init__(self, k_or_str=None, bits: int = 0):
        if k_or_str is None:
            if _default_k[0] is None:
                raise ValueError("MerDNA.k(<int>) has not been set")
            self.k = _default_k[0]
            self.bits = int(bits) & self.mask()
        elif isinstance(k_or_str, str):
            self.k = len(k_or_str)
            self.bits = 0
            self.from_str(k_or_str)
        else:
            self.k = int(k_or_str)
            self.bits = int(bits) & self.mask()

    def mask(self) -> int:
        return (1 << (2 * self.k)) - 1

    # -- string conversion ---------------------------------------------------

    def from_str(self, s: str) -> "MerDNA":
        if len(s) < self.k:
            raise ValueError("string too short")
        v = 0
        for ch in s[: self.k]:
            c = _code(ch)
            if c < 0:
                raise ValueError(f"invalid base {ch!r}")
            v = (v << 2) | c
        self.bits = v
        return self

    def __str__(self) -> str:
        out = []
        for i in range(self.k - 1, -1, -1):
            out.append(REV_CODES[(self.bits >> (2 * i)) & 3])
        return "".join(out)

    def __repr__(self) -> str:
        return f"MerDNA({str(self)!r})"

    # -- base access (mer_dna.hpp:261-262: base(i), i=0 is the LAST base / LSB)

    def base(self, i: int) -> str:
        return REV_CODES[(self.bits >> (2 * i)) & 3]

    def set_base(self, i: int, ch: str) -> None:
        c = _code(ch)
        if c < 0:
            raise ValueError(f"invalid base {ch!r}")
        self.bits = (self.bits & ~(3 << (2 * i))) | (c << (2 * i))

    def __getitem__(self, i: int) -> str:
        return self.base(i)

    # -- shifts (mer_dna.hpp:322-370) -----------------------------------------

    def shift_left(self, base) -> str:
        """Append a base at the right end (becomes the new last base / LSB);
        the leftmost base falls off and is returned."""
        c = base if isinstance(base, int) else _code(base)
        if c < 0:
            return "N"
        out = (self.bits >> (2 * (self.k - 1))) & 3
        self.bits = ((self.bits << 2) | (c & 3)) & self.mask()
        return REV_CODES[out]

    def shift_right(self, base) -> str:
        """Prepend a base at the left end (MSB); the last base falls off."""
        c = base if isinstance(base, int) else _code(base)
        if c < 0:
            return "N"
        out = self.bits & 3
        self.bits = (self.bits >> 2) | ((c & 3) << (2 * (self.k - 1)))
        return REV_CODES[out]

    # -- complement / canonical ------------------------------------------------

    def get_reverse_complement(self) -> "MerDNA":
        v = self.bits
        rc = 0
        for _ in range(self.k):
            rc = (rc << 2) | (3 - (v & 3))
            v >>= 2
        return MerDNA(self.k, rc)

    def reverse_complement(self) -> None:
        self.bits = self.get_reverse_complement().bits

    def get_canonical(self) -> "MerDNA":
        rc = self.get_reverse_complement()
        return rc if rc.bits < self.bits else MerDNA(self.k, self.bits)

    def canonicalize(self) -> None:
        self.bits = self.get_canonical().bits

    def is_homopolymer(self) -> bool:
        b = self.bits & 3
        v = self.bits
        for _ in range(self.k):
            if (v & 3) != b:
                return False
            v >>= 2
        return True

    def polyA(self):
        self.bits = 0

    def polyC(self):
        self.bits = sum(1 << (2 * i) for i in range(self.k))

    def polyG(self):
        self.bits = sum(2 << (2 * i) for i in range(self.k))

    def polyT(self):
        self.bits = self.mask()

    def randomize(self, rng) -> None:
        self.bits = int(rng.integers(0, 1 << 30)) | (
            int(rng.integers(0, 1 << 30)) << 30
        ) | (int(rng.integers(0, 1 << 30)) << 60)
        self.bits &= self.mask()

    # -- bit access (mer_dna.hpp:467-498) --------------------------------------

    def get_bits(self, start: int, length: int) -> int:
        return (self.bits >> start) & ((1 << length) - 1)

    def set_bits(self, start: int, length: int, value: int) -> None:
        m = ((1 << length) - 1) << start
        self.bits = ((self.bits & ~m) | ((value << start) & m)) & self.mask()

    # -- words / serialization (little-endian uint64 words) ---------------------

    def nb_words(self, wbits: int = 64) -> int:
        wbases = wbits // 2
        return (self.k + wbases - 1) // wbases

    def word(self, i: int, wbits: int = 64) -> int:
        return (self.bits >> (wbits * i)) & ((1 << wbits) - 1)

    def to_bytes(self) -> bytes:
        """Raw key bytes as written by binary_writer (binary_dumper.hpp:36-38):
        ceil(2k/8) bytes, little-endian."""
        nbytes = (2 * self.k + 7) // 8
        return self.bits.to_bytes(nbytes, "little")

    @classmethod
    def from_bytes(cls, k: int, data: bytes) -> "MerDNA":
        return cls(k, int.from_bytes(data, "little"))

    # -- comparisons ------------------------------------------------------------

    def __eq__(self, other):
        return isinstance(other, MerDNA) and self.k == other.k and self.bits == other.bits

    def __lt__(self, other):
        return self.bits < other.bits

    def __le__(self, other):
        return self.bits <= other.bits

    def __gt__(self, other):
        return self.bits > other.bits

    def __ge__(self, other):
        return self.bits >= other.bits

    def __hash__(self):
        return hash((self.k, self.bits))

    def dup(self) -> "MerDNA":
        return MerDNA(self.k, self.bits)


def string_mers(s: str, k: int | None = None):
    """Yield every k-mer of a string, skipping windows with invalid bases.

    Mirrors swig/string_mers.i semantics (windows containing non-ACGT
    characters are skipped, scanning restarts after the bad base). Like
    the SWIG binding, `k` defaults to the global `MerDNA.k()`.
    """
    if k is None:
        k = _default_k[0]
        if k is None:
            raise ValueError("MerDNA.k(<int>) has not been set")
    n = len(s)
    i = 0
    filled = 0
    m = MerDNA(k)
    while i < n:
        c = _code(s[i])
        i += 1
        if c < 0:
            filled = 0
            continue
        m.shift_left(c)
        filled = min(filled + 1, k)
        if filled >= k:
            yield m.dup()


def string_canonicals(s: str, k: int | None = None):
    for m in string_mers(s, k):
        yield m.get_canonical()


import numpy as np  # noqa: E402  (host batch helpers below)

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


def seq_mers_np(seq, k: int, canonical: bool = False) -> np.ndarray:
    """All valid k-mer windows of a byte sequence as uint64 (2k <= 64),
    fully vectorized (the batch twin of string_mers/string_canonicals).
    Windows containing invalid bases are skipped."""
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
    m = m[valid]
    if canonical:
        m = np.minimum(m, revcomp_np(m, k))
    return m
