"""Scripting API mirroring the reference SWIG bindings (swig/*.i), the
counterpart of jellyfish_tpu/api.py.

The reference exposes MerDNA, HashCounter, HashSet, QueryMerFile,
ReadMerFile, string_mers, string_canonicals to Python/Ruby/Perl
(swig/mer_dna.i, hash_counter.i, hash_set.i, mer_file.i, string_mers.i):

    import jellyfish_tpu_torch as jellyfish
    jellyfish.MerDNA.k(21)
    h = jellyfish.HashCounter(1024, 5)
    h.add(jellyfish.MerDNA("ACGT" * 5 + "A"), 1)
    for mer, count in jellyfish.ReadMerFile("db.jf"):
        ...

These are per-mer conveniences; the batch path on the GPU is
jellyfish_tpu_torch.counter.MerCounter. HashCounter and HashSet are exact
host-side tables (a python call per mer could not feed a GPU anyway),
with the add/update_add/get semantics of cooperative::hash_counter
(hash_counter.hpp:91,150; swig/hash_counter.i). QueryMerFile reads a
Bloom counter onto the GPU, unless device="cpu", and searches a binary
database on the host.
"""

from __future__ import annotations

from jellyfish_tpu_torch.mer import MerDNA, string_canonicals, string_mers

__all__ = [
    "MerDNA",
    "HashCounter",
    "HashSet",
    "QueryMerFile",
    "ReadMerFile",
    "string_mers",
    "string_canonicals",
]


class HashCounter:
    """swig/hash_counter.i surface: add/update_add/get/__getitem__."""

    def __init__(self, size: int, val_len: int, nb_threads: int = 1):
        self._size = int(size)
        self._val_len = int(val_len)
        self._d: dict[int, int] = {}

    def size(self) -> int:
        return self._size

    def val_len(self) -> int:
        return self._val_len

    def add(self, m: MerDNA, x: int) -> bool:
        self._d[m.bits] = self._d.get(m.bits, 0) + int(x)
        return True

    def update_add(self, m: MerDNA, x: int) -> bool:
        """Add x only if the mer is already present (update_add semantics,
        large_hash_array.hpp:327)."""
        if m.bits in self._d:
            self._d[m.bits] += int(x)
            return True
        return False

    def get(self, m: MerDNA):
        """Count of m, or None if absent (swig typemap behavior)."""
        return self._d.get(m.bits)

    def __getitem__(self, m: MerDNA):
        return self.get(m)

    def __iter__(self):
        k = MerDNA.k()
        for bits, count in self._d.items():
            yield MerDNA(k, bits), count


class HashSet:
    """swig/hash_set.i surface: set-only hash (val_len == 0)."""

    def __init__(self, size: int, nb_threads: int = 1):
        self._size = int(size)
        self._s: set[int] = set()

    def size(self) -> int:
        return self._size

    def add(self, m: MerDNA) -> bool:
        self._s.add(m.bits)
        return True

    def get(self, m: MerDNA) -> bool:
        return m.bits in self._s

    def __getitem__(self, m: MerDNA) -> bool:
        return self.get(m)


class QueryMerFile:
    """Random access to a database: q[mer] -> count (swig/mer_file.i:12-58).
    Supports binary/sorted and bloomcounter formats like the reference. A
    Bloom counter's cells go to `device` (None means the GPU)."""

    def __init__(self, path: str, device=None):
        from jellyfish_tpu_torch.io.header import FileHeader

        with open(path, "rb") as f:
            header = FileHeader.read(f)
        MerDNA.k(header.key_len // 2)
        self.canonical = header.canonical
        if header.format == FileHeader.FORMAT_BLOOM:
            from jellyfish_tpu_torch.bloom import read_bloom_counter

            self._bf = read_bloom_counter(path, device)
            self._bq = None
        elif header.format == FileHeader.FORMAT_BINARY:
            from jellyfish_tpu_torch.io.files import BinaryQuery

            self._bq = BinaryQuery(path)
            self._bf = None
        else:
            raise RuntimeError(f"Unsupported format '{header.format}'")

    def __getitem__(self, m: MerDNA) -> int:
        if self._bq is not None:
            return self._bq.check(m.bits)
        return self._bf.check_int(m.bits)

    get = __getitem__


class ReadMerFile:
    """Sequential iteration over a database (swig/mer_file.i:105-187):
    yields (MerDNA, count); also exposes next_mer()/mer()/count()."""

    def __init__(self, path: str):
        from jellyfish_tpu_torch.io.files import DBReader

        self._reader = DBReader(path)
        MerDNA.k(self._reader.k)
        self._it = iter(self._reader)
        self._mer = None
        self._count = None

    def next_mer(self) -> bool:
        try:
            bits, count = next(self._it)
        except StopIteration:
            self._mer = self._count = None
            return False
        self._mer = MerDNA(self._reader.k, bits)
        self._count = count
        return True

    def mer(self) -> MerDNA:
        return self._mer

    def count(self) -> int:
        return self._count

    def __iter__(self):
        while self.next_mer():
            yield self._mer.dup(), self._count
