"""FASTA/FASTQ streaming chunker (host side; jellyfish_tpu/io/parse.py,
copied).

Turns FASTA/FASTQ files (plain or gzip) into fixed-size uint8 chunks:

- reads within a chunk are separated by a SEPARATOR byte so no mer spans
  two reads (mer_overlap_sequence_parser.hpp:88);
- consecutive chunks of one stream overlap by k-1 bytes so no mer spanning
  a chunk boundary is lost (the seam carry,
  mer_overlap_sequence_parser.hpp:164-216);
- FASTQ quality filtering replaces low-quality bases with 'N' before
  chunking (mer_qual_iterator.hpp:74-84 semantics);
- the tail of the final chunk is padded with SEPARATOR bytes.

The C++ scanner of the native library (native/chunker.cpp) makes the
chunks when it is built, several inputs at once under `nb_files` (-F);
the pure-python path below is the reference and the fallback
(JF_NO_NATIVE=1 forces it). `chunks_packed` packs each chunk to 2-bit
codes and a validity bitstream, the counter's input (`pack_chunk`).
Generator commands (`-g`, `-G`, `-S`) run as shell children whose
standard output is read like a file; a child that exits nonzero raises,
and close() terminates the live ones. SAM, BAM and CRAM files (`count
--sam`) are read after the sequence files, as FASTA or FASTQ records
(sam_records_to_fastx): BAM records through the native window parser,
CRAM slices through io/cram.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from collections import deque
from typing import Iterable, Iterator

import numpy as np

from jellyfish_tpu_torch.native import NativeChunker, get_lib
from jellyfish_tpu_torch.native import pack_chunk as _pack_chunk_native

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

    The native library parses the complete records of each 4 MB window
    (jf_bam_records) and carries the partial tail into the next. On a
    malformed window, or a record cut short at the end, the python loop
    below takes over from the first record the native parser did not
    yield and raises its own error; without the library it reads every
    record.
    """
    import struct

    pending = b""  # bytes read from the stream and not yet parsed

    def read(n):
        nonlocal pending
        if not pending:
            return stream.read(n)
        part, pending = pending[:n], pending[n:]
        if len(part) < n:
            part += stream.read(n - len(part))
        return part

    def take(n):
        data = read(n)
        if len(data) != n:
            raise ValueError("truncated BAM file")
        return data

    (l_text,) = struct.unpack("<i", take(4))
    take(l_text)
    (n_ref,) = struct.unpack("<i", take(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", take(4))
        take(l_name + 4)  # name + l_ref

    lib = get_lib()
    if lib is not None:
        import ctypes

        while True:
            block = stream.read(1 << 22)
            data = pending + block
            if not data:
                return
            consumed = ctypes.c_long(0)
            h = lib.jf_bam_records(data, len(data), ctypes.byref(consumed))
            if not h:
                # a malformed record: the python loop takes the window
                # from its first record on and raises the exact error
                pending = data
                break
            try:
                n = lib.jf_cram_out_len(h)
                if n:
                    buf = ctypes.create_string_buffer(n)
                    lib.jf_cram_out_copy(h, buf)
                    yield buf.raw
            finally:
                lib.jf_cram_out_free(h)
            pending = data[consumed.value:]
            if not block:
                if not pending:
                    return
                break  # a record cut short: the python loop raises

    while True:
        head = read(4)
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


def sam_records_to_fastx(stream, need_quals: bool = True) -> Iterator[bytes]:
    """Adapt SAM/BAM/CRAM to FASTA/FASTQ record bytes (sam_format.hpp
    role).

    Text SAM: SEQ (col 10) / QUAL (col 11) of each alignment line become
    one record; records with SEQ '*' are skipped; QUAL '*' yields a FASTA
    record. BAM (behind open_stream's gzip layer) is parsed by
    _bam_records_to_fastx. CRAM 2.1-3.1 is decoded by
    io/cram.cram_records_to_fastx; reference-compressed CRAMs find their
    reference FASTA through JF_CRAM_REF, JF_CRAM_REF_CACHE or REF_CACHE
    (an M5 cache), or a local-file UR: field of the @SQ header lines.
    need_quals=False lets the CRAM reader skip the quality blocks
    (counting without -Q never reads them).
    """
    first = stream.read(4)
    if first.startswith(b"BAM\x01"):
        yield from _bam_records_to_fastx(stream)
        return
    if first.startswith(b"CRAM"):
        from jellyfish_tpu_torch.io.cram import cram_records_to_fastx

        yield from cram_records_to_fastx(stream, need_quals=need_quals)
        return
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
    within the word. The native library's jf_pack_chunk when it is built,
    else numpy."""
    L = len(chunk)
    if L % 32:
        raise ValueError("chunk length must be a multiple of 32")
    if get_lib() is not None:
        return _pack_chunk_native(chunk)
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
    """Concatenate reads from many files, SAM/BAM/CRAM files
    (`sam_paths`) and the output of generator commands, in that order,
    into fixed-size chunks; under nb_files > 1 (-F) the native scanner
    parses that many inputs at once, and their chunks interleave. `reads`
    counts the reads once the chunks are drained. Use it as a context
    manager, or call close(), so that no generator child outlives it."""

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
        nb_files: int = 1,
    ):
        self.paths = list(paths)
        self.k = int(k)
        self.chunk_len = int(chunk_len)
        self.min_qual = min_qual
        self.generator_cmds = list(generator_cmds or [])
        self.shell = shell or os.environ.get("SHELL", "/bin/sh")
        self.nb_generators = max(1, int(nb_generators))
        self.sam_paths = list(sam_paths or [])
        self.nb_files = max(1, int(nb_files))
        self.reads = 0
        self._procs: set = set()

    def _spawn_generator(self, cmd: str):
        proc = subprocess.Popen([self.shell, "-c", cmd],
                                stdout=subprocess.PIPE)
        self._procs.add(proc)
        return proc

    def _streams(self):
        """(stream, generator child or None) per input: the files, the
        SAM/BAM/CRAM files as FASTA/FASTQ, then the generators' outputs.
        Up to nb_generators children run at once
        (generator_manager.hpp:62-162): later commands start while an
        earlier one's output is read, and the pipe bounds their memory."""
        for path in self.paths:
            yield open_stream(path), None
        need_quals = self.min_qual is not None
        for path in self.sam_paths:
            f = open_stream(path)
            yield _IterStream(sam_records_to_fastx(f, need_quals), f), None
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
                    self.reads += 1
                    yield seq
                completed = True
            finally:
                if proc is not None:
                    self._finish_proc(proc, completed)
                elif stream is not sys.stdin.buffer:
                    stream.close()

    def chunks(self) -> Iterator[np.ndarray]:
        """Yield uint8 arrays of exactly chunk_len bytes: from the native
        scanner when the library is built (several inputs at once under
        nb_files > 1), else from the python path. The path is chosen
        before the first chunk, so that an error after it (a generator
        that fails, a stream that breaks) is raised, never retried on
        another path."""
        if self.chunk_len <= self.k:
            raise ValueError("chunk_len must exceed k")
        n_inputs = (len(self.paths) + len(self.sam_paths)
                    + len(self.generator_cmds))
        if get_lib() is None:
            yield from self._chunks_python()
        elif self.nb_files > 1 and n_inputs > 1:
            yield from self._chunks_native_concurrent(
                min(self.nb_files, n_inputs))
        else:
            yield from self._chunks_native()

    def _feed(self, nc, stream, proc, stop=None) -> Iterator[np.ndarray]:
        """Feed one input to the native scanner `nc`, yield each chunk it
        completes, then close the input (reap a generator child). A set
        `stop` event abandons the input."""
        completed = False
        try:
            while stop is None or not stop.is_set():
                data = stream.read(1 << 20)
                if not data:
                    yield from nc.end_stream()
                    completed = True
                    break
                yield from nc.feed(data)
        finally:
            if proc is not None:
                self._finish_proc(proc, completed)
            elif stream is not sys.stdin.buffer:
                stream.close()

    def _chunks_native(self) -> Iterator[np.ndarray]:
        nc = NativeChunker(self.k, self.chunk_len, self.min_qual)
        emitted = False
        for stream, proc in self._streams():
            for c in self._feed(nc, stream, proc):
                emitted = True
                yield c
        for c in nc.finish():
            emitted = True
            yield c
        self.reads = nc.reads
        if not emitted:
            yield np.full(self.chunk_len, SEPARATOR, dtype=np.uint8)

    def _chunks_native_concurrent(self, n_workers: int
                                  ) -> Iterator[np.ndarray]:
        """-F: n_workers threads, each with a native scanner of its own,
        take the inputs one at a time and parse them at once (the ctypes
        calls release the GIL; stream_manager.hpp:76-145). Chunks come in
        the order they complete. A worker's exception stops the others and
        is raised here once they have ended; when the consumer stops
        early, the workers stop and the live generator children are
        terminated."""
        import queue
        import threading

        streams = self._streams()
        q: queue.Queue = queue.Queue(maxsize=4 * n_workers)
        lock = threading.Lock()
        stop = threading.Event()
        state = {"reads": 0, "error": None}

        def worker():
            try:
                nc = NativeChunker(self.k, self.chunk_len, self.min_qual)
                while not stop.is_set():
                    with lock:
                        item = next(streams, None)
                    if item is None:
                        break
                    for c in self._feed(nc, *item, stop=stop):
                        q.put(c)
                if not stop.is_set():
                    for c in nc.finish():
                        q.put(c)
                with lock:
                    state["reads"] += nc.reads
            except BaseException as e:  # re-raised by the consumer
                with lock:
                    if state["error"] is None:
                        state["error"] = e
                stop.set()
            finally:
                q.put(None)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        done = 0
        emitted = False
        try:
            while done < n_workers:
                item = q.get()
                if item is None:
                    done += 1
                    continue
                emitted = True
                yield item
        finally:
            stop.set()
            # children still writing would hold a worker in its read
            for proc in list(self._procs):
                if proc.poll() is None:
                    proc.terminate()
            while any(t.is_alive() for t in threads):
                try:
                    q.get(timeout=0.05)  # a worker may wait to put
                except queue.Empty:
                    pass
            with lock:
                streams.close()
        if state["error"] is not None:
            raise state["error"]
        self.reads = state["reads"]
        if not emitted:
            yield np.full(self.chunk_len, SEPARATOR, dtype=np.uint8)

    def _chunks_python(self) -> Iterator[np.ndarray]:
        L = self.chunk_len
        k = self.k
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
