"""GF(2) rectangular binary matrix hashing (host side).

A copy of jellyfish_tpu/gf2.py (numpy only), kept here so that the port
imports nothing of the JAX package: the same seed gives the same matrix.

Semantics match Jellyfish's RectangularBinaryMatrix
(include/jellyfish/rectangular_binary_matrix.hpp and
lib/rectangular_binary_matrix.cc), re-implemented in numpy:

- An r x c matrix over Z/2Z, r <= 64, stored column-major: columns[j] is a
  uint64 holding column j (bit i of columns[j] = row i, row 0 = least
  significant output bit).
- `times(v)`: matrix-vector product. The input vector is the key's bits in
  BIG-ENDIAN coordinate order: column 0 pairs with the key's most significant
  bit (bit c-1), column c-1 with the key's bit 0
  (rectangular_binary_matrix.hpp:224-261 walks x from LSB while walking
  columns from the end).
- "Pseudo-square" view: the r x c matrix is implicitly completed to a c x c
  matrix by stacking [I_{c-r} | 0] on top. The completed map sends key K
  (c bits) to H = (K >> r << r) | times(K): the high c-r bits pass through
  unchanged and the low r bits are the hash. `pseudo_inverse` returns the
  r x c bottom block of the inverse of that square matrix
  (lib/rectangular_binary_matrix.cc:160-210).
- identity: a NULL-columns matrix behaves as the identity
  (rectangular_binary_matrix.hpp:37,111).

Keys are plain python ints here (arbitrary precision); the device-side
vectorized version lives in ops/hashing.py and consumes `bit_matrix()`
through `masks_of_matrix`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GF2Matrix"]

_U64 = (1 << 64) - 1


class GF2Matrix:
    """r x c matrix over GF(2), column-major in uint64 words.

    ``columns is None`` means the identity matrix (r == c).
    """

    def __init__(self, r: int, c: int, columns=None):
        if r < 1 or r > 64:
            raise ValueError(f"invalid matrix row count {r} (need 1 <= r <= 64)")
        # r > c is allowed (used by the bloom hash_pair, which takes 64 x 2k
        # matrices, mer_dna_bloom_counter.hpp:19-27); such matrices support
        # times() but not the pseudo-square operations.
        self.r = int(r)
        self.c = int(c)
        if columns is None:
            self.columns = None
            if r != c:
                raise ValueError("identity matrix requires r == c")
        else:
            cols = np.asarray(columns, dtype=np.uint64)
            if cols.shape != (c,):
                raise ValueError(f"need {c} columns, got {cols.shape}")
            self.columns = cols & np.uint64(self._cmask())

    # -- constructors -------------------------------------------------------

    @classmethod
    def identity(cls, c: int) -> "GF2Matrix":
        return cls(c, c, None)

    @classmethod
    def low_identity(cls, r: int, c: int) -> "GF2Matrix":
        """Matrix whose bottom-right r x r block is the identity, rest zero.

        Mirrors init_low_identity (lib/rectangular_binary_matrix.cc:50-63).
        """
        # r == c materializes real columns (matching init_low_identity,
        # which never uses the NULL-columns identity representation) so
        # pseudo_inverse works on square matrices too
        cols = np.zeros(c, dtype=np.uint64)
        row = min(r, c)
        col = c - row
        v = np.uint64(1) << np.uint64(row - 1)
        for i in range(col, c):
            cols[i] = v
            v >>= np.uint64(1)
        return cls(r, c, cols)

    @classmethod
    def random(cls, r: int, c: int, rng: np.random.Generator) -> "GF2Matrix":
        cols = rng.integers(0, (1 << 64) - 1, size=c, dtype=np.uint64, endpoint=True)
        return cls(r, c, cols)

    @classmethod
    def random_invertible(cls, r: int, c: int, rng: np.random.Generator) -> "GF2Matrix":
        """Random matrix whose pseudo-square completion is invertible
        (randomize_pseudo_inverse, lib/rectangular_binary_matrix.cc:240-247)."""
        while True:
            m = cls.random(r, c, rng)
            try:
                m.pseudo_inverse()
                return m
            except np.linalg.LinAlgError:
                continue

    # -- basic ops ----------------------------------------------------------

    def _cmask(self) -> int:
        return _U64 >> (64 - self.r)

    def is_identity(self) -> bool:
        return self.columns is None

    def is_low_identity(self) -> bool:
        if self.columns is None:
            return True
        ref = GF2Matrix.low_identity(self.r, self.c)
        return bool(np.array_equal(self.columns, ref.columns))

    def __eq__(self, other) -> bool:
        if not isinstance(other, GF2Matrix):
            return NotImplemented
        if self.r != other.r or self.c != other.c:
            return False
        if (self.columns is None) != (other.columns is None):
            # reference compares pointers; semantically compare against the
            # materialized low identity.
            return self.is_low_identity() and other.is_low_identity()
        if self.columns is None:
            return True
        return bool(np.array_equal(self.columns, other.columns))

    def column(self, j: int) -> int:
        if self.columns is None:
            return 1 << j
        return int(self.columns[j])

    def times(self, key: int) -> int:
        """Hash of a c-bit key (python int)."""
        if self.columns is None:
            return key & self._cmask()
        res = 0
        # bit 0 of key pairs with the LAST column (big-endian coordinates).
        k = key
        for j in range(self.c - 1, -1, -1):
            if k & 1:
                res ^= int(self.columns[j])
            k >>= 1
        return res

    def times_full(self, key: int) -> int:
        """The pseudo-square completion applied to key: keep the high c-r
        bits, replace the low r bits with times(key)."""
        high = key >> self.r << self.r
        return high | self.times(key)

    # -- pseudo inverse (Gaussian elimination over GF(2)) --------------------

    def pseudo_inverse(self) -> "GF2Matrix":
        """Bottom r x c block of the inverse of the pseudo-square completion.

        Column-based Gaussian elimination mirroring
        lib/rectangular_binary_matrix.cc:160-210. Raises
        numpy.linalg.LinAlgError if singular.
        """
        if self.columns is None:
            return self
        if self.r > self.c:
            raise ValueError("pseudo_inverse requires r <= c")
        pivot = self.columns.copy()
        res = GF2Matrix.low_identity(self.r, self.c).columns.copy()
        c, r = self.c, self.r
        srow = min(r, c)
        scol = c - srow

        # make pivot lower triangular
        mask = np.uint64(1) << np.uint64(srow - 1)
        for i in range(scol, c):
            if not (pivot[i] & mask):
                hit = np.nonzero(pivot[i + 1 :] & mask)[0]
                if hit.size == 0:
                    raise np.linalg.LinAlgError("matrix is singular")
                j = i + 1 + int(hit[0])
                pivot[i] ^= pivot[j]
                res[i] ^= res[j]
            sel = (pivot[i + 1 :] & mask) != 0
            pivot[i + 1 :][sel] ^= pivot[i]
            res[i + 1 :][sel] ^= res[i]
            mask >>= np.uint64(1)

        # make pivot the lower identity
        mask = np.uint64(1) << np.uint64(srow - 1)
        for i in range(scol, c):
            sel = (pivot[:i] & mask) != 0
            pivot[:i][sel] ^= pivot[i]
            res[:i][sel] ^= res[i]
            mask >>= np.uint64(1)

        return GF2Matrix(r, c, res)

    def pseudo_rank(self) -> int:
        """Rank of the pseudo-square completion
        (lib/rectangular_binary_matrix.cc:124-158)."""
        if self.columns is None:
            return self.c
        pivot = self.columns.copy()
        c, r = self.c, self.r
        srow = min(r, c)
        scol = c - srow
        mask = np.uint64(1) << np.uint64(srow - 1)
        for i in range(scol, c):
            if not (pivot[i] & mask):
                hit = np.nonzero(pivot[i + 1 :] & mask)[0]
                if hit.size == 0:
                    return i
                pivot[i] ^= pivot[i + 1 + int(hit[0])]
            sel = (pivot[i + 1 :] & mask) != 0
            pivot[i + 1 :][sel] ^= pivot[i]
            mask >>= np.uint64(1)
        return c

    def pseudo_multiplication(self, rhs: "GF2Matrix") -> "GF2Matrix":
        """Product of the two pseudo-square completions (bottom block).

        Mirrors lib/rectangular_binary_matrix.cc:81-122.
        """
        if self.r != rhs.r or self.c != rhs.c:
            raise ValueError("matrices of different size")
        if self.columns is None:
            return rhs
        if rhs.columns is None:
            return self
        c, r = self.c, self.r
        out = np.zeros(c, dtype=np.uint64)
        col = c - min(r, c)
        for i in range(c):
            # column i of the rhs completion: identity part contributes the
            # unit vector at big-endian coordinate i (only for i < c-r), the
            # bottom block contributes rhs.columns[i] in the low r bits.
            v = int(rhs.columns[i])
            if i < col:
                v |= 1 << (c - 1 - i)
            out[i] = self.times(v)
        return GF2Matrix(r, c, out)

    # -- device / serialization views ---------------------------------------

    def bit_matrix(self) -> np.ndarray:
        """[c, r] uint8 bit matrix A for vectorized hashing.

        A[i, j] = bit j of the column paired with key bit i, where key bit i
        is the LITTLE-endian bit index. pos_bits = key_bits @ A (mod 2).
        """
        shifts = np.arange(self.r, dtype=np.uint64)
        if self.columns is None:
            cols = (np.uint64(1) << np.arange(self.c, dtype=np.uint64)) & np.uint64(
                self._cmask()
            )
        else:
            cols = self.columns
        rev = cols[::-1]  # key bit i pairs with column c-1-i
        return ((rev[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)

    def inverse_bit_matrix(self) -> np.ndarray:
        return self.pseudo_inverse().bit_matrix()

    def to_json(self) -> dict:
        """'matrixN' header entry (file_header.hpp:49-64)."""
        if self.is_low_identity():
            return {"r": self.r, "c": self.c, "identity": True}
        return {
            "r": self.r,
            "c": self.c,
            "identity": False,
            "columns": [int(x) for x in self.columns],
        }

    @classmethod
    def from_json(cls, d: dict) -> "GF2Matrix":
        r, c = int(d["r"]), int(d["c"])
        if d.get("identity", False):
            if r == c:
                return cls.identity(c)
            return cls.low_identity(r, c)
        return cls(r, c, np.array([int(x) for x in d["columns"]], dtype=np.uint64))
