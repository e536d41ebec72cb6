"""The native host library: the FASTA/FASTQ chunker, the packer, the BAM
record parser and the CRAM block and slice decoders (chunker.cpp), and the
linkable query library libjfquery (jfquery.cpp).

chunker.cpp is built with g++ at first use into
build/jellyfish_tpu_torch/libjfnative.so (beside the CUDA kernels'
libraries) and loaded with ctypes through its C interface. A library is
rebuilt when its source is newer. Processes that build at once take a
file lock, and each compiles to a name of its own before the rename, so
none loads a half-written file. When g++ fails, get_lib() returns None and
the callers take their pure-python paths; `build_error()` says why.
Set JF_NO_NATIVE=1 to force the pure-python paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from jellyfish_tpu_torch.kernels._build import BUILD_DIR

__all__ = ["BUILD_DIR", "JFQUERY_PATH", "LIB_PATH", "NativeChunker",
           "build_error", "build_jfquery", "get_lib", "pack_chunk"]

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "chunker.cpp"
LIB_PATH = BUILD_DIR / "libjfnative.so"
_JFQUERY_SRC = _DIR / "jfquery.cpp"
JFQUERY_PATH = BUILD_DIR / "libjfquery.so"

_lock = threading.Lock()
_lib = None
_tried = False
_error: str | None = None

_CODEC_ARGS = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
               ctypes.c_long]


def _compile(src: Path, out: Path, flags) -> str | None:
    """Build `out` from `src` with g++ unless it is up to date; None on
    success, else g++'s message. The build holds an exclusive lock on
    BUILD_DIR/<out>.lock (each call opens the file, so threads exclude
    one another as processes do): a second caller waits and then finds
    the library current."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            return None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *flags, "-shared", "-fPIC", str(src),
                            "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, OSError) as e:
            tmp.unlink(missing_ok=True)
            return f"g++ failed for {src.name}: {getattr(e, 'stderr', e)}"
        os.replace(tmp, out)
    return None


def build_error() -> str | None:
    """Why the last get_lib() found no library (None when it loaded, or
    when JF_NO_NATIVE is set)."""
    return _error


def get_lib():
    """The loaded native library, or None when it could not be built or
    JF_NO_NATIVE is set."""
    global _lib, _tried, _error
    if os.environ.get("JF_NO_NATIVE"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        _error = _compile(_SRC, LIB_PATH,
                          ["-O3", "-march=native", "-std=c++17"])
        if _error is not None:
            return None
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.jf_chunker_new.restype = ctypes.c_void_p
        lib.jf_chunker_new.argtypes = [ctypes.c_int, ctypes.c_long,
                                       ctypes.c_int]
        lib.jf_chunker_free.argtypes = [ctypes.c_void_p]
        lib.jf_chunker_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_long]
        lib.jf_chunker_end_stream.argtypes = [ctypes.c_void_p]
        lib.jf_chunker_pop.restype = ctypes.c_int
        lib.jf_chunker_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.jf_chunker_finish.restype = ctypes.c_int
        lib.jf_chunker_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.jf_chunker_reads.restype = ctypes.c_ulonglong
        lib.jf_chunker_reads.argtypes = [ctypes.c_void_p]
        lib.jf_pack_chunk.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_void_p, ctypes.c_void_p]
        for fn in ("jf_rans_decode", "jf_rans16_decode", "jf_arith_decode",
                   "jf_fqz_decode", "jf_tok3_decode"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = _CODEC_ARGS
        lib.jf_cram_slice.restype = ctypes.c_void_p
        lib.jf_cram_slice.argtypes = [
            ctypes.c_char_p, ctypes.c_long,     # raw series map
            ctypes.c_char_p, ctypes.c_long,     # raw tag map
            ctypes.c_char_p, ctypes.c_long,     # TD blob
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # RN/AP/RR
            ctypes.c_char_p,                    # substitution matrix
            ctypes.c_char_p, ctypes.c_long,     # core block
            ctypes.c_void_p, ctypes.c_void_p,   # ext ids, ptrs
            ctypes.c_void_p, ctypes.c_int,      # ext lens, count
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,  # reference
            ctypes.c_long, ctypes.c_long, ctypes.c_longlong,
            ctypes.c_int,                       # no_qual
        ]
        lib.jf_cram_out_len.restype = ctypes.c_long
        lib.jf_cram_out_len.argtypes = [ctypes.c_void_p]
        lib.jf_cram_out_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.jf_cram_out_free.argtypes = [ctypes.c_void_p]
        lib.jf_bam_records.restype = ctypes.c_void_p
        lib.jf_bam_records.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_long)]
        _lib = lib
        return _lib


def build_jfquery() -> str | None:
    """Build the linkable query library libjfquery.so (jfquery.cpp, C
    interface in jfquery.h) into BUILD_DIR if needed and return its path,
    or None when g++ fails. It is for C, C++ and FFI clients (the
    reference's headers-as-library query role, binary_dumper.hpp:112-213);
    the package's own query path is io/files.py. `make -C
    jellyfish_tpu_torch/native install PREFIX=...` installs it with its
    header and a pkg-config file."""
    if _compile(_JFQUERY_SRC, JFQUERY_PATH, ["-O2", "-std=c++17"]):
        return None
    return str(JFQUERY_PATH)


def pack_chunk(chunk: np.ndarray):
    """jf_pack_chunk: ASCII chunk [L] uint8 (L % 32 == 0) -> (pwords
    [L/16] uint32, validbits [L/32] uint32), the layout of
    io/parse.pack_chunk. Needs the library."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    chunk = np.ascontiguousarray(chunk, dtype=np.uint8)
    L = len(chunk)
    pwords = np.empty(L // 16, dtype=np.uint32)
    valid = np.empty(L // 32, dtype=np.uint32)
    lib.jf_pack_chunk(chunk.ctypes.data_as(ctypes.c_void_p), L,
                      pwords.ctypes.data_as(ctypes.c_void_p),
                      valid.ctypes.data_as(ctypes.c_void_p))
    return pwords, valid


class NativeChunker:
    """Streaming scanner: feed file bytes, pop fixed-size chunks (the
    chunks of io/parse.SequenceChunker's python path)."""

    def __init__(self, k: int, chunk_len: int, min_qual: int | None = None):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native chunker unavailable")
        self.chunk_len = int(chunk_len)
        self.h = self.lib.jf_chunker_new(
            int(k), self.chunk_len, -1 if min_qual is None else int(min_qual))
        if not self.h:
            raise MemoryError("jf_chunker_new failed")
        self._out = np.empty(self.chunk_len, dtype=np.uint8)

    def feed(self, data: bytes):
        """Feed raw bytes; returns the chunks this feed completed."""
        self.lib.jf_chunker_feed(self.h, data, len(data))
        return self._drain()

    def _drain(self):
        out = []
        while self.lib.jf_chunker_pop(
                self.h, self._out.ctypes.data_as(ctypes.c_void_p)):
            out.append(self._out.copy())
        return out

    def end_stream(self):
        """End of one input: the next bytes start a new file."""
        self.lib.jf_chunker_end_stream(self.h)
        return self._drain()

    def finish(self):
        """The remaining chunks, the last one padded."""
        chunks = self._drain()
        if self.lib.jf_chunker_finish(
                self.h, self._out.ctypes.data_as(ctypes.c_void_p)):
            chunks.append(self._out.copy())
        return chunks

    @property
    def reads(self) -> int:
        return int(self.lib.jf_chunker_reads(self.h))

    def __del__(self):
        if getattr(self, "h", None) and getattr(self, "lib", None):
            self.lib.jf_chunker_free(self.h)
            self.h = None
