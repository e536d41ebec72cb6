"""Jellyfish-compatible JSON file headers (a copy of jellyfish_tpu/io/header.py).

Format (generic_file_header.hpp:88-143): a 9-digit zero-padded decimal length,
the terse JSON object, then NUL padding so that 9 + length is a multiple of
the alignment (8 for hash files). Keys are emitted in sorted order like
JsonCpp's FastWriter (Json::Value is a sorted map).

Jellyfish-specific keys (file_header.hpp): size, key_len (=2k), val_len,
matrix1/matrix2, max_reprobe, reprobes[], canonical, counter_len, format,
fpr, nb_hashes; generic keys (generic_file_header.hpp:147-171): hostname,
pwd, time, exe_path, cmdline; SOURCE_DATE_EPOCH supported for reproducible
output.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time as _time

from jellyfish_tpu_torch.gf2 import GF2Matrix

__all__ = ["FileHeader", "quadratic_reprobes"]

MAX_HEADER_DIGITS = 9

# Quadratic reprobing offsets (lib/storage.cc): reprobes[i] = i*(i+1)/2 with
# reprobes[0] = 1 (the offset used for overflow/large-key entries).
quadratic_reprobes = [1] + [i * (i + 1) // 2 for i in range(1, 257)]


class FileHeader:
    """dict-backed header with typed accessors."""

    FORMAT_BINARY = "binary/sorted"
    FORMAT_TEXT = "text/sorted"
    FORMAT_BLOOM = "bloomcounter"

    def __init__(self, root: dict | None = None, alignment: int = 8):
        self.root = dict(root) if root else {"alignment": alignment}
        self.offset = 0

    # -- typed accessors ------------------------------------------------------

    def _get(self, key, default=None):
        return self.root.get(key, default)

    @property
    def alignment(self) -> int:
        return max(0, int(self._get("alignment", 0)))

    @property
    def size(self) -> int:
        return int(self._get("size", 0))

    @size.setter
    def size(self, v: int):
        self.root["size"] = int(v)

    @property
    def key_len(self) -> int:
        return int(self._get("key_len", 0))

    @key_len.setter
    def key_len(self, v: int):
        self.root["key_len"] = int(v)

    @property
    def val_len(self) -> int:
        return int(self._get("val_len", 0))

    @val_len.setter
    def val_len(self, v: int):
        self.root["val_len"] = int(v)

    @property
    def max_reprobe(self) -> int:
        return int(self._get("max_reprobe", 0))

    @max_reprobe.setter
    def max_reprobe(self, v: int):
        self.root["max_reprobe"] = int(v)

    @property
    def max_reprobe_offset(self) -> int:
        return int(self.root["reprobes"][self.max_reprobe])

    @property
    def counter_len(self) -> int:
        return int(self._get("counter_len", 0))

    @counter_len.setter
    def counter_len(self, v: int):
        self.root["counter_len"] = int(v)

    @property
    def format(self) -> str:
        return str(self._get("format", ""))

    @format.setter
    def format(self, v: str):
        self.root["format"] = v

    @property
    def canonical(self) -> bool:
        return bool(self._get("canonical", False))

    @canonical.setter
    def canonical(self, v: bool):
        self.root["canonical"] = bool(v)

    @property
    def fpr(self) -> float:
        return float(self._get("fpr", 0.0))

    @fpr.setter
    def fpr(self, v: float):
        self.root["fpr"] = float(v)

    @property
    def nb_hashes(self) -> int:
        return int(self._get("nb_hashes", 0))

    @nb_hashes.setter
    def nb_hashes(self, v: int):
        self.root["nb_hashes"] = int(v)

    def matrix(self, i: int = 1) -> GF2Matrix:
        return GF2Matrix.from_json(self.root[f"matrix{i}"])

    def set_matrix(self, m: GF2Matrix, i: int = 1):
        self.root[f"matrix{i}"] = m.to_json()

    def set_reprobes(self, reprobes=None):
        n = self.max_reprobe + 1
        table = reprobes if reprobes is not None else quadratic_reprobes
        self.root["reprobes"] = [int(x) for x in table[:n]]

    @property
    def cmdline(self):
        return list(self._get("cmdline", []))

    def set_cmdline(self, argv):
        self.root["cmdline"] = list(argv)

    def fill_standard(self):
        sde = os.environ.get("SOURCE_DATE_EPOCH")
        if sde is not None:
            self.root["hostname"] = "hostname"
            self.root["pwd"] = "."
            self.root["time"] = _time.asctime(_time.gmtime(int(sde)))
        else:
            self.root["hostname"] = socket.gethostname()
            self.root["pwd"] = os.getcwd()
            self.root["time"] = _time.asctime(_time.localtime())
        self.root["exe_path"] = os.path.realpath(sys.argv[0]) if sys.argv else ""

    # -- serialization --------------------------------------------------------

    def write(self, fobj) -> None:
        payload = json.dumps(
            self.root, sort_keys=True, separators=(",", ":")
        ).encode()
        align = self.alignment
        hlen = len(payload)
        pad = 0
        if align > 0:
            rem = (MAX_HEADER_DIGITS + hlen) % align
            if rem:
                pad = align - rem
                hlen += pad
        fobj.write(f"{hlen:0{MAX_HEADER_DIGITS}d}".encode())
        fobj.write(payload)
        if pad:
            fobj.write(b"\0" * pad)
        self.offset = MAX_HEADER_DIGITS + hlen

    @classmethod
    def read(cls, fobj) -> "FileHeader":
        digits = b""
        while len(digits) < MAX_HEADER_DIGITS:
            ch = fobj.read(1)
            if not ch or not ch.isdigit():
                raise ValueError("not a jellyfish header (bad length field)")
            digits += ch
        hlen = int(digits)
        if hlen < 2:
            raise ValueError("not a jellyfish header (length too small)")
        raw = fobj.read(hlen)
        if len(raw) != hlen:
            raise ValueError("truncated header")
        raw = raw.rstrip(b"\0")
        h = cls(json.loads(raw))
        h.offset = MAX_HEADER_DIGITS + hlen
        return h
