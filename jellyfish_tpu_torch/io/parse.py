"""FASTA/FASTQ streaming chunker (host side; the pure-python path of
jellyfish_tpu/io/parse.py, copied).

Turns FASTA/FASTQ files (plain or gzip) into fixed-size uint8 chunks:

- reads within a chunk are separated by a SEPARATOR byte so no mer spans
  two reads (mer_overlap_sequence_parser.hpp:88);
- consecutive chunks of one stream overlap by k-1 bytes so no mer spanning
  a chunk boundary is lost (the seam carry,
  mer_overlap_sequence_parser.hpp:164-216);
- FASTQ quality filtering replaces low-quality bases with 'N' before
  chunking (mer_qual_iterator.hpp:74-84 semantics);
- the tail of the final chunk is padded with SEPARATOR bytes.

`chunks_packed` packs each chunk to 2-bit codes and a validity bitstream,
the counter's input (`pack_chunk`, the numpy version of
jellyfish_tpu/native pack_chunk). Generator commands (`-g`, `-G`, `-S`)
run as shell children whose standard output is read like a file; a child
that exits nonzero raises, and close() terminates the live ones. SAM and
BAM files (`count --sam`) are read after the sequence files, as FASTA or
FASTQ records (sam_records_to_fastx); a CRAM file raises NotPortedError.
The JAX package's native chunker and native BAM window parser are not
part of this package: BAM records go through the pure-python loop.
"""

from __future__ import annotations

import os
import subprocess
import sys
from collections import deque
from typing import Iterable, Iterator

import numpy as np

from jellyfish_tpu_torch import NotPortedError

__all__ = ["SequenceChunker", "open_stream", "iter_reads", "sniff_format",
           "sam_records_to_fastx", "pack_chunk"]

SEPARATOR = ord("N")  # any non-ACGT byte breaks mers; 'N' matches reference


def open_stream(path: str):
    """Open a sequence file (plain or gzip) as a binary stream."""
    if path == "/dev/fd/0" or path == "-":
        return sys.stdin.buffer
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(f)
    return f


def iter_reads(stream, with_quals: bool = False) -> Iterator:
    """Yield sequence bytes per read ((seq, qual) if with_quals).

    Tolerates multi-line FASTA/FASTQ and DOS line endings
    (mer_overlap_sequence_parser.hpp:266-287).
    """
    first = stream.read(1)
    if not first:
        return
    if first == b">":
        stream.readline()  # rest of the >header line
        seq_parts = []
        for line in stream:
            if line.startswith(b">"):
                seq = b"".join(seq_parts)
                yield (seq, None) if with_quals else seq
                seq_parts = []
            else:
                seq_parts.append(line.rstrip(b"\r\n"))
        seq = b"".join(seq_parts)
        yield (seq, None) if with_quals else seq
    elif first == b"@":
        while True:
            header = stream.readline()  # rest of @header line
            if not header:
                break
            seq_parts = []
            line = stream.readline()
            while line and not line.startswith(b"+"):
                seq_parts.append(line.rstrip(b"\r\n"))
                line = stream.readline()
            seq = b"".join(seq_parts)
            qual_parts = []
            qlen = 0
            while qlen < len(seq):
                line = stream.readline()
                if not line:
                    break
                part = line.rstrip(b"\r\n")
                qual_parts.append(part)
                qlen += len(part)
            qual = b"".join(qual_parts)
            if len(qual) != len(seq):
                raise ValueError("FASTQ quality length mismatch")
            yield (seq, qual) if with_quals else seq
            nxt = stream.read(1)
            if not nxt:
                break
            if nxt != b"@":
                raise ValueError("malformed FASTQ record separator")
    else:
        raise ValueError("unrecognized sequence format (expected '>' or '@')")


def sniff_format(stream) -> str:
    ch = stream.peek(1)[:1] if hasattr(stream, "peek") else b""
    if ch == b">":
        return "fasta"
    if ch == b"@":
        return "fastq"
    raise ValueError("unrecognized sequence format (expected '>' or '@')")


# BAM 4-bit nibble codes "=ACMGRSVTWYHKDBN": only A/C/G/T decode to
# bases, everything else is 'N' (sam_format.hpp:76-83 decode()).
_BAM_NIB_LUT = np.full(16, ord("N"), dtype=np.uint8)
for _i, _b in ((1, "A"), (2, "C"), (4, "G"), (8, "T")):
    _BAM_NIB_LUT[_i] = ord(_b)


def _bam_records_to_fastx(stream) -> Iterator[bytes]:
    """Parse a decompressed BAM stream (positioned after the BAM\\x01
    magic) into FASTA/FASTQ record bytes.

    BGZF is a multi-member gzip stream, so `open_stream`'s gzip layer
    already yields the uncompressed BAM byte stream. As the reference's
    htslib consumption (sam_format.hpp:59-86 +
    mer_overlap_sequence_parser.hpp:220-253): every record's SEQ is used
    as stored, non-ACGT nibbles become N, no flag filtering. Absent
    quality (0xFF fill) yields a FASTA record; otherwise raw phred is
    re-encoded as phred+33, like `samtools view` text output.
    """
    import struct

    def take(n):
        data = stream.read(n)
        if len(data) != n:
            raise ValueError("truncated BAM file")
        return data

    (l_text,) = struct.unpack("<i", take(4))
    take(l_text)
    (n_ref,) = struct.unpack("<i", take(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", take(4))
        take(l_name + 4)  # name + l_ref

    while True:
        head = stream.read(4)
        if len(head) == 0:
            return
        if len(head) != 4:
            raise ValueError("truncated BAM record")
        (block_size,) = struct.unpack("<i", head)
        rec = take(block_size)
        l_read_name = rec[8]
        n_cigar_op, _flag = struct.unpack_from("<HH", rec, 12)
        (l_seq,) = struct.unpack_from("<i", rec, 16)
        off = 32
        name = rec[off : off + l_read_name - 1]  # drop trailing NUL
        off += l_read_name + 4 * n_cigar_op
        if l_seq == 0:
            continue
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(rec, dtype=np.uint8, count=nbytes, offset=off)
        off += nbytes
        nib = np.empty(2 * nbytes, dtype=np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0x0F
        seq = _BAM_NIB_LUT[nib[:l_seq]].tobytes()
        qual = np.frombuffer(rec, dtype=np.uint8, count=l_seq, offset=off)
        if qual[0] == 0xFF:
            yield b">" + name + b"\n" + seq + b"\n"
        else:
            q33 = (np.minimum(qual, 93) + 33).astype(np.uint8).tobytes()
            yield b"@" + name + b"\n" + seq + b"\n+\n" + q33 + b"\n"


def sam_records_to_fastx(stream) -> Iterator[bytes]:
    """Adapt SAM/BAM to FASTA/FASTQ record bytes (sam_format.hpp role).

    Text SAM: SEQ (col 10) / QUAL (col 11) of each alignment line become
    one record; records with SEQ '*' are skipped; QUAL '*' yields a FASTA
    record. BAM (behind open_stream's gzip layer) is parsed by
    _bam_records_to_fastx. CRAM raises NotPortedError.
    """
    first = stream.read(4)
    if first.startswith(b"BAM\x01"):
        yield from _bam_records_to_fastx(stream)
        return
    if first.startswith(b"CRAM"):
        raise NotPortedError(
            "CRAM input is not ported to jellyfish_tpu_torch yet (ROADMAP "
            "item A4); use python -m jellyfish_tpu count --sam")
    buf = first + stream.readline()
    while True:
        line = buf if buf is not None else stream.readline()
        buf = None
        if not line:
            return
        if line.startswith(b"@"):
            continue
        f = line.rstrip(b"\r\n").split(b"\t")
        if len(f) < 11 or f[9] == b"*":
            continue
        if f[10] == b"*":
            yield b">" + f[0] + b"\n" + f[9] + b"\n"
        else:
            yield b"@" + f[0] + b"\n" + f[9] + b"\n+\n" + f[10] + b"\n"


class _IterStream:
    """File-like read(n) view over an iterator of byte blocks; close()
    closes `source`, the stream the blocks are read from."""

    def __init__(self, blocks: Iterator[bytes], source=None):
        self._blocks = blocks
        self._source = source
        self._pending = b""

    def read(self, n: int = -1) -> bytes:
        chunks = [self._pending]
        have = len(self._pending)
        self._pending = b""
        while n < 0 or have < n:
            try:
                b = next(self._blocks)
            except StopIteration:
                break
            chunks.append(b)
            have += len(b)
        data = b"".join(chunks)
        if 0 <= n < len(data):
            self._pending = data[n:]
            data = data[:n]
        return data

    def readline(self) -> bytes:
        while b"\n" not in self._pending:
            try:
                self._pending += next(self._blocks)
            except StopIteration:
                data, self._pending = self._pending, b""
                return data
        i = self._pending.index(b"\n") + 1
        line, self._pending = self._pending[:i], self._pending[i:]
        return line

    def __iter__(self):
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def close(self):
        if self._source is not None:
            self._source.close()


def pack_chunk(chunk: np.ndarray):
    """ASCII chunk [L] uint8 (L % 32 == 0) -> (pwords [L/16] uint32,
    validbits [L/32] uint32): 16 2-bit codes per word, big-endian within
    the word (A0 C1 G2 T3), and one validity bit per base, little-endian
    within the word."""
    L = len(chunk)
    if L % 32:
        raise ValueError("chunk length must be a multiple of 32")
    t = (chunk >> 1) & 3
    code = (t ^ (t >> 1)).astype(np.uint32)
    shifts = (2 * (15 - np.arange(16, dtype=np.uint32)))[None, :]
    pwords = (code.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
    lower = chunk | 0x20
    ok = (
        (lower == ord("a")) | (lower == ord("c"))
        | (lower == ord("g")) | (lower == ord("t"))
    ).astype(np.uint32)
    vshifts = np.arange(32, dtype=np.uint32)[None, :]
    valid = (ok.reshape(-1, 32) << vshifts).sum(axis=1, dtype=np.uint32)
    return pwords, valid


class SequenceChunker:
    """Concatenate reads from many files, SAM/BAM files (`sam_paths`) and
    the output of generator commands, in that order, into fixed-size
    chunks. Use it as a context manager, or call close(), so that no
    generator child outlives it."""

    def __init__(
        self,
        paths: Iterable[str],
        k: int,
        chunk_len: int,
        min_qual: int | None = None,
        generator_cmds: Iterable[str] | None = None,
        shell: str | None = None,
        nb_generators: int = 1,
        sam_paths: Iterable[str] | None = None,
    ):
        self.paths = list(paths)
        self.k = int(k)
        self.chunk_len = int(chunk_len)
        self.min_qual = min_qual
        self.generator_cmds = list(generator_cmds or [])
        self.shell = shell or os.environ.get("SHELL", "/bin/sh")
        self.nb_generators = max(1, int(nb_generators))
        self.sam_paths = list(sam_paths or [])
        self._procs: set = set()

    def _spawn_generator(self, cmd: str):
        proc = subprocess.Popen([self.shell, "-c", cmd],
                                stdout=subprocess.PIPE)
        self._procs.add(proc)
        return proc

    def _streams(self):
        """(stream, generator child or None) per input: the files, the
        SAM/BAM files as FASTA/FASTQ, then the generators' outputs. Up to nb_generators children run at once
        (generator_manager.hpp:62-162): later commands start while an
        earlier one's output is read, and the pipe bounds their memory."""
        for path in self.paths:
            yield open_stream(path), None
        for path in self.sam_paths:
            f = open_stream(path)
            yield _IterStream(sam_records_to_fastx(f), f), None
        pending: deque = deque()
        cmds = iter(self.generator_cmds)

        def top_up():
            while len(pending) < self.nb_generators:
                cmd = next(cmds, None)
                if cmd is None:
                    return
                pending.append(self._spawn_generator(cmd))

        top_up()
        while pending:
            proc = pending.popleft()
            yield proc.stdout, proc
            top_up()

    def _finish_proc(self, proc, completed: bool) -> None:
        """Reap a generator child. After its output was read to the end,
        wait and raise on a nonzero exit status; when it was abandoned
        (an error downstream, close()), terminate it, then kill it
        (count_main.cc:209-216, lib/generator_manager.cc:186-215)."""
        self._procs.discard(proc)
        try:
            if completed:
                ret = proc.wait()
                if ret != 0:
                    raise RuntimeError(
                        f"generator subprocess exited with status {ret}")
                return
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        finally:
            proc.stdout.close()

    def close(self) -> None:
        """Terminate any live generator children (idempotent)."""
        for proc in list(self._procs):
            self._finish_proc(proc, completed=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_bytes(self):
        """Yield filtered sequence bytes per read across all inputs."""
        want_quals = self.min_qual is not None
        for stream, proc in self._streams():
            completed = False
            try:
                for item in iter_reads(stream, with_quals=want_quals):
                    if want_quals:
                        seq, qual = item
                        if qual is not None:
                            s = np.frombuffer(seq, dtype=np.uint8).copy()
                            q = np.frombuffer(qual, dtype=np.uint8)
                            s[q < self.min_qual] = SEPARATOR
                            seq = s.tobytes()
                    else:
                        seq = item
                    yield seq
                completed = True
            finally:
                if proc is not None:
                    self._finish_proc(proc, completed)
                elif stream is not sys.stdin.buffer:
                    stream.close()

    def chunks(self) -> Iterator[np.ndarray]:
        """Yield uint8 arrays of exactly chunk_len bytes."""
        L = self.chunk_len
        k = self.k
        if L <= k:
            raise ValueError("chunk_len must exceed k")
        buf = np.full(L, SEPARATOR, dtype=np.uint8)
        fill = 0
        emitted_any = False
        for seq in self._read_bytes():
            pos = 0
            n = len(seq)
            if fill >= L:  # full of finished reads: no seam needed
                yield buf
                emitted_any = True
                buf = np.full(L, SEPARATOR, dtype=np.uint8)
                fill = 0
            while pos < n:
                take = min(n - pos, L - fill)
                buf[fill : fill + take] = np.frombuffer(
                    seq[pos : pos + take], dtype=np.uint8
                )
                fill += take
                pos += take
                if pos < n:
                    # chunk boundary mid-read: emit, seam-carry k-1 bytes so
                    # boundary-spanning mers are counted exactly once
                    yield buf
                    emitted_any = True
                    tail = buf[L - (k - 1) :].copy() if k > 1 else None
                    buf = np.full(L, SEPARATOR, dtype=np.uint8)
                    if k > 1:
                        buf[: k - 1] = tail
                    fill = k - 1 if k > 1 else 0
            # end of read: a separator byte breaks mers to the next read
            if fill < L:
                buf[fill] = SEPARATOR
                fill += 1
            # else: buf is exactly full of this read's end; the fresh buffer
            # created on the next iteration starts clean (no seam).
        if fill > 0 or not emitted_any:
            yield buf

    def chunks_packed(self):
        """Yield (pwords [L/16] uint32, validbits [L/32] uint32) per chunk.
        Requires chunk_len % 32 == 0."""
        if self.chunk_len % 32:
            raise ValueError("chunk_len must be a multiple of 32 for packed")
        for chunk in self.chunks():
            yield pack_chunk(chunk)
