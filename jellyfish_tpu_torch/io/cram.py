"""CRAM 2.x/3.0/3.1 reader — native sequence/quality extraction, no htslib.

The reference consumes CRAM through htslib behind `sam_format.hpp:22-57`
(only next()/seq_len()/base(i)/qual(i) — sequences and qualities, no
alignment semantics). This module implements exactly that consumption
natively: container/slice walking, block codecs (raw, gzip, bzip2,
lzma, rANS 4x8, and the CRAM 3.1 set: rANS Nx16, adaptive arithmetic,
fqzcomp, name tokenizer — io/rans16.py, io/arith.py, io/fqzcomp.py,
io/tok3.py), the CRAM bit/byte codecs (EXTERNAL, HUFFMAN, BETA,
GAMMA, SUBEXP, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP), and read
reconstruction from reference + substitution/insert/clip features.

Reference sequences, when a CRAM is reference-compressed (RR=true and
no embedded reference in the slice), are located like htslib does:
`JF_CRAM_REF=<fasta>` env (htslib's REF_PATH role) or a local-file
`UR:` field in the SAM header's @SQ lines. Slices with embedded
references and non-reference CRAMs (samtools --output-fmt-option
no_ref) need nothing.

Entry point: `cram_records_to_fastx(stream)` yields FASTA/FASTQ record
bytes exactly like the BAM adapter in parse.py.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator, Optional

from jellyfish_tpu_torch.io import rans
from jellyfish_tpu_torch.native import get_lib

__all__ = ["cram_records_to_fastx", "CramError"]


class CramError(ValueError):
    pass


# --------------------------------------------------------------- cursors


class ByteCursor:
    """Sequential reader over a bytes object: ITF-8 / LTF-8 / raw."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        d = self.buf[self.pos:self.pos + n]
        if len(d) != n:
            raise CramError("truncated CRAM structure")
        self.pos += n
        return d

    def itf8(self) -> int:
        """Signed 32-bit int, 1-5 bytes (5th byte contributes 4 bits)."""
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = (b0 & 0x3F) << 8 | self.u8()
        elif b0 < 0xE0:
            v = (b0 & 0x1F) << 16 | self.u8() << 8 | self.u8()
        elif b0 < 0xF0:
            v = ((b0 & 0x0F) << 24 | self.u8() << 16 | self.u8() << 8
                 | self.u8())
        else:
            v = ((b0 & 0x0F) << 28 | self.u8() << 20 | self.u8() << 12
                 | self.u8() << 4 | (self.u8() & 0x0F))
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        """Signed 64-bit int, 1-9 bytes."""
        b0 = self.u8()
        n = 0
        while n < 8 and (b0 << n) & 0x80:
            n += 1
        if n == 8:
            v = int.from_bytes(self.take(8), "big")
        else:
            v = b0 & (0xFF >> (n + 1))
            for _ in range(n):
                v = v << 8 | self.u8()
        return v - (1 << 64) if v >= (1 << 63) else v

    def itf8_array(self):
        return [self.itf8() for _ in range(self.itf8())]


def write_itf8(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out += bytes([0x80 | v >> 8, v & 0xFF])
    elif v < 0x200000:
        out += bytes([0xC0 | v >> 16, v >> 8 & 0xFF, v & 0xFF])
    elif v < 0x10000000:
        out += bytes([0xE0 | v >> 24, v >> 16 & 0xFF, v >> 8 & 0xFF,
                      v & 0xFF])
    else:
        out += bytes([0xF0 | v >> 28 & 0x0F, v >> 20 & 0xFF,
                      v >> 12 & 0xFF, v >> 4 & 0xFF, v & 0x0F])


def write_ltf8(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    if v < 0x80:
        out.append(v)
    elif v < 1 << 56:
        # n extra bytes carry 8n bits + (7-n) payload bits in byte 0
        n = 1
        while v >= (1 << (7 * n + 7)):
            n += 1
        lead = (0xFF << (8 - n)) & 0xFF
        body = v.to_bytes(n + 1, "big")
        out.append(lead | body[0])
        out += body[1:]
    else:
        out.append(0xFF)
        out += v.to_bytes(8, "big")


class BitReader:
    """MSB-first bit reader over a core block."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.bit = 0

    def read_bit(self) -> int:
        b = (self.buf[self.pos] >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.read_bit()
        return v


# --------------------------------------------------------------- codecs

CODEC_NULL = 0
CODEC_EXTERNAL = 1
CODEC_GOLOMB = 2
CODEC_HUFFMAN = 3
CODEC_BYTE_ARRAY_LEN = 4
CODEC_BYTE_ARRAY_STOP = 5
CODEC_BETA = 6
CODEC_SUBEXP = 7
CODEC_GOLOMB_RICE = 8
CODEC_GAMMA = 9


class _External:
    def __init__(self, params: ByteCursor):
        self.cid = params.itf8()

    def read_int(self, ctx) -> int:
        return ctx.ext(self.cid).itf8()

    def read_byte(self, ctx) -> int:
        return ctx.ext(self.cid).u8()

    def read_bytes(self, ctx, n: int) -> bytes:
        return ctx.ext(self.cid).take(n)


class _Huffman:
    """Canonical Huffman over int symbols; the ubiquitous 0-bit
    single-symbol form is a constant that consumes nothing."""

    def __init__(self, params: ByteCursor):
        syms = params.itf8_array()
        lens = params.itf8_array()
        if len(syms) != len(lens):
            raise CramError("huffman alphabet/length size mismatch")
        self.const: Optional[int] = None
        if len(syms) == 1 and lens[0] == 0:
            self.const = syms[0]
            return
        # canonical code assignment: by (length, symbol order as given)
        pairs = sorted(zip(lens, range(len(syms))))
        code = 0
        prev_len = pairs[0][0]
        self.table = {}  # (length, code) -> symbol
        for ln, idx in pairs:
            code <<= (ln - prev_len)
            prev_len = ln
            self.table[(ln, code)] = syms[idx]
            code += 1
        self.max_len = pairs[-1][0]

    def read_int(self, ctx) -> int:
        if self.const is not None:
            return self.const
        core = ctx.core
        code = 0
        ln = 0
        while ln <= self.max_len:
            code = code << 1 | core.read_bit()
            ln += 1
            sym = self.table.get((ln, code))
            if sym is not None:
                return sym
        raise CramError("invalid huffman code in core block")

    read_byte = read_int


class _Beta:
    def __init__(self, params: ByteCursor):
        self.offset = params.itf8()
        self.nbits = params.itf8()

    def read_int(self, ctx) -> int:
        return ctx.core.read_bits(self.nbits) - self.offset

    read_byte = read_int


class _Gamma:
    def __init__(self, params: ByteCursor):
        self.offset = params.itf8()

    def read_int(self, ctx) -> int:
        core = ctx.core
        z = 0
        while core.read_bit() == 0:
            z += 1
        v = (1 << z) | core.read_bits(z)
        return v - self.offset

    read_byte = read_int


class _SubExp:
    def __init__(self, params: ByteCursor):
        self.offset = params.itf8()
        self.k = params.itf8()

    def read_int(self, ctx) -> int:
        core = ctx.core
        u = 0
        while core.read_bit() == 1:
            u += 1
        if u == 0:
            n = core.read_bits(self.k)
        else:
            b = u + self.k - 1
            n = (1 << b) | core.read_bits(b)
        return n - self.offset

    read_byte = read_int


class _ByteArrayLen:
    def __init__(self, params: ByteCursor):
        self.len_codec = make_codec(params.itf8(),
                                    ByteCursor(params.take(params.itf8())))
        self.val_codec = make_codec(params.itf8(),
                                    ByteCursor(params.take(params.itf8())))

    def read_array(self, ctx) -> bytes:
        n = self.len_codec.read_int(ctx)
        return self.val_codec.read_bytes(ctx, n)

    def read_bytes(self, ctx, n: int) -> bytes:
        return self.val_codec.read_bytes(ctx, n)


class _ByteArrayStop:
    def __init__(self, params: ByteCursor):
        self.stop = params.u8()
        self.cid = params.itf8()

    def read_array(self, ctx) -> bytes:
        cur = ctx.ext(self.cid)
        end = cur.buf.index(self.stop, cur.pos)
        data = cur.buf[cur.pos:end]
        cur.pos = end + 1
        return data


def _default_read_bytes(codec, ctx, n: int) -> bytes:
    return bytes(codec.read_byte(ctx) for _ in range(n))


_CODECS = {
    CODEC_EXTERNAL: _External,
    CODEC_HUFFMAN: _Huffman,
    CODEC_BETA: _Beta,
    CODEC_GAMMA: _Gamma,
    CODEC_SUBEXP: _SubExp,
    CODEC_BYTE_ARRAY_LEN: _ByteArrayLen,
    CODEC_BYTE_ARRAY_STOP: _ByteArrayStop,
}


def make_codec(codec_id: int, params: ByteCursor):
    cls = _CODECS.get(codec_id)
    if cls is None:
        raise CramError(f"CRAM codec {codec_id} not supported "
                        "(GOLOMB family is never written by htslib)")
    c = cls(params)
    if not hasattr(c, "read_bytes"):
        c.read_bytes = lambda ctx, n, _c=c: _default_read_bytes(_c, ctx, n)
    return c


def _codec_cids(codec) -> set:
    """All external content ids a codec (recursively) reads from."""
    out = set()
    cid = getattr(codec, "cid", None)
    if cid is not None:
        out.add(cid)
    for sub in ("len_codec", "val_codec"):
        c = getattr(codec, sub, None)
        if c is not None:
            out |= _codec_cids(c)
    return out


def _codec_uses_core(codec) -> bool:
    """Whether decoding through this codec consumes CORE bits (skipping
    it would then desync every other core consumer)."""
    if isinstance(codec, _Huffman):
        return codec.const is None
    if isinstance(codec, (_Beta, _Gamma, _SubExp)):
        return True
    for sub in ("len_codec", "val_codec"):
        c = getattr(codec, sub, None)
        if c is not None and _codec_uses_core(c):
            return True
    return False


# --------------------------------------------------------------- blocks

METHOD_RAW = 0
METHOD_GZIP = 1
METHOD_BZIP2 = 2
METHOD_LZMA = 3
METHOD_RANS = 4
METHOD_RANSNX16 = 5
METHOD_ARITH = 6
METHOD_FQZ = 7
METHOD_TOK3 = 8

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5


def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == METHOD_RAW:
        out = data
    elif method == METHOD_GZIP:
        import gzip
        out = gzip.decompress(data)
    elif method == METHOD_BZIP2:
        import bz2
        out = bz2.decompress(data)
    elif method == METHOD_LZMA:
        import lzma
        out = lzma.decompress(data)
    elif method == METHOD_RANS:
        out = rans.decode(data)
    elif method == METHOD_RANSNX16:
        from jellyfish_tpu_torch.io import rans16
        out = rans16.decode(data, raw_size)
    elif method == METHOD_ARITH:
        from jellyfish_tpu_torch.io import arith
        out = arith.decode(data, raw_size)
    elif method == METHOD_FQZ:
        from jellyfish_tpu_torch.io import fqzcomp
        out = fqzcomp.decode(data, raw_size)
    elif method == METHOD_TOK3:
        from jellyfish_tpu_torch.io import tok3
        out = tok3.decode(data, raw_size)
    else:
        raise CramError(f"CRAM block compression method {method} not "
                        "supported")
    if len(out) != raw_size:
        raise CramError("CRAM block raw size mismatch")
    return out


class Block:
    __slots__ = ("method", "ctype", "cid", "data", "_comp", "_raw_size")

    def __init__(self, cur: ByteCursor, verify_crc: bool = True,
                 has_crc: bool = True, lazy: bool = False):
        """has_crc: CRAM 3.x appends a CRC32 to every block; 2.x framing
        has none (htslib cram_read_block gates the read on major >= 3).

        lazy=True defers the (expensive, GIL-releasing) decompression to
        force() so the parallel slice reader can run it on a worker
        thread; header parse + CRC stay on the caller's thread."""
        start = cur.pos
        self.method = cur.u8()
        self.ctype = cur.u8()
        self.cid = cur.itf8()
        comp_size = cur.itf8()
        raw_size = cur.itf8()
        comp = cur.take(comp_size)
        if has_crc:
            crc_calc = zlib.crc32(cur.buf[start:cur.pos])
            crc_stored = struct.unpack("<I", cur.take(4))[0]
            if verify_crc and crc_calc != crc_stored:
                raise CramError("CRAM block CRC mismatch")
        self._comp = comp
        self._raw_size = raw_size
        self.data = None if lazy else _decompress(
            self.method, comp, raw_size
        )

    def force(self) -> bytes:
        if self.data is None:
            self.data = _decompress(self.method, self._comp,
                                    self._raw_size)
            self._comp = None
        return self.data


# --------------------------------------------------- compression header


class CompressionHeader:
    def __init__(self, data: bytes):
        cur = ByteCursor(data)
        # preservation map
        self.rn_preserved = True
        self.ap_delta = True
        self.rr = True
        self.subst = None
        self.td_blob = b"\x00"
        self.tag_dict = [[]]
        cur.itf8()  # size in bytes
        for _ in range(cur.itf8()):
            key = cur.take(2)
            if key == b"RN":
                self.rn_preserved = bool(cur.u8())
            elif key == b"AP":
                self.ap_delta = bool(cur.u8())
            elif key == b"RR":
                self.rr = bool(cur.u8())
            elif key == b"SM":
                self.subst = cur.take(5)
            elif key == b"TD":
                blob = cur.take(cur.itf8())
                self.td_blob = blob
                self.tag_dict = [
                    [line[i:i + 3] for i in range(0, len(line), 3)]
                    for line in blob.split(b"\x00")[:-1]
                ] or [[]]
            elif key in (b"MI", b"UI", b"PI"):
                # CRAM 1.0-era keys (mapped/unmapped QS included, read
                # names included per pair) still emitted by cramtools-era
                # 2.x writers; htslib's cram_decode_compression_header
                # tolerates them as single-byte booleans — so do we
                cur.u8()
            else:
                raise CramError(f"unknown preservation key {key!r}")
        # data series encodings (raw bytes retained for the native
        # decoder, which re-parses them in C++)
        start = cur.pos
        self.series = {}
        cur.itf8()  # size
        for _ in range(cur.itf8()):
            key = cur.take(2).decode("ascii")
            codec_id = cur.itf8()
            params = ByteCursor(cur.take(cur.itf8()))
            self.series[key] = make_codec(codec_id, params)
        self.raw_series = data[start:cur.pos]
        # tag encodings
        start = cur.pos
        self.tags = {}
        cur.itf8()  # size
        for _ in range(cur.itf8()):
            key = cur.itf8()
            codec_id = cur.itf8()
            params = ByteCursor(cur.take(cur.itf8()))
            self.tags[key] = make_codec(codec_id, params)
        self.raw_tags = data[start:cur.pos]
        self._subst_table()

    def qual_skip_cids(self):
        """External content ids safe to leave UNDECODED when the caller
        does not need qualities (the htslib CRAM_OPT_REQUIRED_FIELDS
        optimization, sam_format.hpp's backing library): the QS/QQ
        codecs' cids, provided those codecs touch no core bits and no
        other series or tag reads the same cids. Returns None when
        skipping is unsafe (decode everything), possibly-empty set
        otherwise."""
        qual_keys = [key for key in ("QS", "QQ") if key in self.series]
        qual_cids: set = set()
        for key in qual_keys:
            c = self.series[key]
            if _codec_uses_core(c):
                return None
            qual_cids |= _codec_cids(c)
        others: set = set()
        for key, c in self.series.items():
            if key in ("QS", "QQ"):
                continue
            others |= _codec_cids(c)
        for c in self.tags.values():
            others |= _codec_cids(c)
        if qual_cids & others:
            return None
        return qual_cids

    def _subst_table(self):
        """matrix[ref_base_index]['code'] -> substituted base.
        For each reference base (order ACGTN) the SM byte assigns 2-bit
        codes to the other four bases in ACGTN order."""
        self.subst_to_base = []
        sm = self.subst or b"\x1b" * 5  # arbitrary default if absent
        bases = b"ACGTN"
        for r in range(5):
            cands = bytes(b for b in bases if b != bases[r])
            by_code = [b"N"[0]] * 4
            byte = sm[r]
            for j in range(4):
                code = (byte >> (6 - 2 * j)) & 3
                by_code[code] = cands[j]
            self.subst_to_base.append(bytes(by_code))


_REF_INDEX = bytearray([4]) * 256
for _i, _b in enumerate(b"ACGTN"):
    _REF_INDEX[_b] = _i
    _REF_INDEX[_b + 32] = _i  # lowercase


# --------------------------------------------------------------- slices


class SliceHeader:
    def __init__(self, data: bytes, v3: bool = True):
        cur = ByteCursor(data)
        self.ref_id = cur.itf8()
        self.start = cur.itf8()
        self.span = cur.itf8()
        self.n_records = cur.itf8()
        # 2.x slice headers carry the record counter as itf8 (htslib
        # cram_decode_slice_header: ltf8 only for major >= 3)
        self.record_counter = cur.ltf8() if v3 else cur.itf8()
        self.n_blocks = cur.itf8()
        self.content_ids = cur.itf8_array()
        self.embedded_ref_id = cur.itf8()
        self.ref_md5 = cur.take(16)


class _SliceCtx:
    """Decode context: the shared core bit cursor + per-content-id
    external byte cursors of one slice."""

    def __init__(self, core: BitReader, externals):
        self.core = core
        self._ext = externals

    def ext(self, cid: int) -> ByteCursor:
        try:
            return self._ext[cid]
        except KeyError:
            raise CramError(f"record references missing external "
                            f"block {cid}") from None


# ----------------------------------------------------------- references


class _RefStore:
    """Lazy reference-FASTA access for reference-compressed CRAMs.
    Sources, in order: JF_CRAM_REF env (fasta with all needed
    sequences), an M5-keyed reference cache directory
    (JF_CRAM_REF_CACHE or htslib's REF_CACHE convention: a directory
    or a %Ns/%s path template over the MD5 hex; files hold the raw
    uppercase sequence, FASTA also accepted), then a local-file UR:
    field from @SQ. Sequences are checksummed against the @SQ M5 tag
    when present (htslib rule: MD5 over the uppercase sequence)."""

    def __init__(self, sam_header_text: bytes):
        self.names = []
        self.ur = {}
        self.m5 = {}
        for line in sam_header_text.split(b"\n"):
            if not line.startswith(b"@SQ"):
                continue
            name = None
            ur = None
            m5 = None
            for f in line.rstrip(b"\r").split(b"\t")[1:]:
                if f.startswith(b"SN:"):
                    name = f[3:].decode()
                elif f.startswith(b"UR:"):
                    ur = f[3:].decode()
                elif f.startswith(b"M5:"):
                    m5 = f[3:].decode().lower()
            if name is not None:
                self.names.append(name)
                if ur:
                    self.ur[name] = ur
                if m5:
                    self.m5[name] = m5
        self._seqs = {}
        self._checked = set()
        self._env_loaded = False
        # multi-ref slices bypass the single-thread cache warm-up and
        # call get() from concurrent decode workers: serialize the LOAD
        # path so a reference is read+M5-checked exactly once (the hit
        # path stays lock-free — dict reads are GIL-atomic)
        self._load_lock = threading.Lock()

    @staticmethod
    def _cache_path(template: str, m5: str) -> str:
        """Expand htslib's REF_CACHE path template: %Ns consumes N hex
        chars of the M5, %s the remainder; a plain directory appends
        the full M5."""
        if "%" not in template:
            return os.path.join(template, m5)
        out = []
        i = 0
        pos = 0
        while i < len(template):
            c = template[i]
            if c == "%":
                j = i + 1
                while j < len(template) and template[j].isdigit():
                    j += 1
                if j < len(template) and template[j] == "s":
                    n = template[i + 1:j]
                    take = int(n) if n else len(m5) - pos
                    out.append(m5[pos:pos + take])
                    pos += take
                    i = j + 1
                    continue
            out.append(c)
            i += 1
        return "".join(out)

    def _check_m5(self, name: str, seq: bytes) -> bytes:
        want = self.m5.get(name)
        if want and name not in self._checked:
            import hashlib
            got = hashlib.md5(seq).hexdigest()
            if got != want:
                raise CramError(
                    f"reference {name!r} fails its @SQ M5 checksum "
                    f"({got} != {want}) - wrong reference file?")
            self._checked.add(name)
        return seq

    def _from_cache(self, name: str):
        m5 = self.m5.get(name)
        if not m5:
            return None
        for env in ("JF_CRAM_REF_CACHE", "REF_CACHE"):
            template = os.environ.get(env)
            if not template:
                continue
            path = self._cache_path(template, m5)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as fh:
                data = fh.read()
            if data.startswith(b">"):
                seqs = self._parse_fasta(data)
                seq = (seqs.get(name) or next(iter(seqs.values()), b""))
            else:
                seq = b"".join(data.split()).upper()
            return self._check_m5(name, seq)
        return None

    @staticmethod
    def _parse_fasta(data: bytes):
        seqs = {}
        name = None
        parts = []
        for line in data.split(b"\n"):
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(parts).upper()
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
        if name is not None:
            seqs[name] = b"".join(parts).upper()
        return seqs

    @classmethod
    def _read_fasta(cls, path: str):
        with open(path, "rb") as fh:
            return cls._parse_fasta(fh.read())

    def get(self, ref_id: int) -> bytes:
        if not 0 <= ref_id < len(self.names):
            raise CramError(f"CRAM record references @SQ index {ref_id} "
                            "absent from the SAM header")
        name = self.names[ref_id]
        if name in self._seqs:
            # re-check: bulk fasta loads cache sequences before their
            # first (validating) use
            return self._check_m5(name, self._seqs[name])
        with self._load_lock:
            if name in self._seqs:  # loaded while we waited
                return self._check_m5(name, self._seqs[name])
            env = os.environ.get("JF_CRAM_REF")
            if env and not self._env_loaded:
                self._seqs.update(self._read_fasta(env))
                self._env_loaded = True
                if name in self._seqs:
                    return self._check_m5(name, self._seqs[name])
            cached = self._from_cache(name)
            if cached is not None:
                self._seqs[name] = cached
                return cached
            ur = self.ur.get(name)
            if ur:
                path = ur[7:] if ur.startswith("file://") else ur
                if os.path.exists(path):
                    self._seqs.update(self._read_fasta(path))
                    if name in self._seqs:
                        return self._check_m5(name, self._seqs[name])
        raise CramError(
            f"reference sequence {name!r} needed to decode this CRAM: "
            "set JF_CRAM_REF=<fasta>, JF_CRAM_REF_CACHE/REF_CACHE=<M5 "
            "cache dir or %Ns template> (or provide a readable UR: "
            "path in the @SQ header); slices with embedded references "
            "and no_ref CRAMs decode without it")


# -------------------------------------------------------------- records

BAM_FUNMAP = 4
CF_QUAL_ARRAY = 1
CF_DETACHED = 2
CF_MATE_DOWNSTREAM = 4
CF_NO_SEQ = 8


def _decode_slice(comp: CompressionHeader, sh: SliceHeader, core: BitReader,
                  externals, refs: Optional[_RefStore],
                  counter_base: int,
                  no_qual: bool = False) -> Iterator[bytes]:
    # no_qual: the caller verified (qual_skip_cids) that the QS/QQ
    # streams are exclusive, so skipping their reads desyncs nothing —
    # records emit as FASTA (the htslib required-fields optimization)
    ctx = _SliceCtx(core, externals)
    s = comp.series

    def intv(key):
        return s[key].read_int(ctx)

    def bytev(key):
        return s[key].read_byte(ctx)

    def arrv(key):
        return s[key].read_array(ctx)

    embedded = None
    if sh.embedded_ref_id >= 0:
        emb = externals.get(sh.embedded_ref_id)
        if emb is None:
            raise CramError("embedded reference block missing")
        embedded = emb.buf.upper()

    def ref_fetch(ref_id: int, pos0: int, n: int) -> bytes:
        """n reference bases at 0-based pos0; out-of-range pads 'N'."""
        if n <= 0:
            return b""
        if not comp.rr:
            # non-reference CRAM: every base of a mapped read is
            # feature-covered; uncovered positions are unknowable
            return b"N" * n
        if embedded is not None:
            off = pos0 - (sh.start - 1)
            src = embedded
        else:
            off = pos0
            src = refs.get(ref_id)
        lo = max(off, 0)
        body = src[lo:max(off + n, 0)]
        return b"N" * (lo - off) + body + b"N" * (n - (lo - off) - len(body))

    last_pos = sh.start
    for rec_i in range(sh.n_records):
        bf = intv("BF")
        cf = intv("CF")
        ref_id = intv("RI") if sh.ref_id == -2 else sh.ref_id
        rl = intv("RL")
        ap = intv("AP")
        if comp.ap_delta:
            pos = last_pos + ap
            last_pos = pos
        else:
            pos = ap
        intv("RG")
        if comp.rn_preserved:
            name = arrv("RN")
        else:
            name = b"jf." + str(counter_base + rec_i).encode()
        if cf & CF_DETACHED:
            intv("MF")
            if not comp.rn_preserved:
                name = arrv("RN")
            intv("NS")
            intv("NP")
            intv("TS")
        elif cf & CF_MATE_DOWNSTREAM:
            intv("NF")
        tl = intv("TL")
        try:
            tag_ids = comp.tag_dict[tl]
        except IndexError:
            raise CramError("record TL outside the TD dictionary") from None
        for tag in tag_ids:
            key = tag[0] << 16 | tag[1] << 8 | tag[2]
            comp.tags[key].read_array(ctx)  # consumed, values unused

        seq = bytearray(b"N" * rl)
        qual = bytearray(b"\xff" * rl)
        have_qual = False

        if not bf & BAM_FUNMAP:
            # mapped: reconstruct bases from reference + features
            # (one sequential pass: each feature is FC, FP-delta, then
            # its own payload series)
            fn = intv("FN")
            read_i = 0          # 0-based index into the read
            ref_pos = pos - 1   # 0-based reference position
            p = 0               # 1-based feature position accumulator
            for _ in range(fn):
                fc = bytev("FC")
                p += intv("FP")
                idx = p - 1
                if idx > read_i:  # reference-match run up to the feature
                    seq[read_i:idx] = ref_fetch(ref_id, ref_pos,
                                                idx - read_i)
                    ref_pos += idx - read_i
                    read_i = idx
                if fc == 0x42:  # 'B' read base + quality
                    seq[read_i] = bytev("BA")
                    if not no_qual:
                        qual[read_i] = bytev("QS")
                        have_qual = True
                    read_i += 1
                    ref_pos += 1
                elif fc == 0x58:  # 'X' substitution
                    code = intv("BS")
                    rb = ref_fetch(ref_id, ref_pos, 1)
                    seq[read_i] = \
                        comp.subst_to_base[_REF_INDEX[rb[0]]][code]
                    read_i += 1
                    ref_pos += 1
                elif fc == 0x49:  # 'I' insertion
                    ins = arrv("IN")
                    seq[read_i:read_i + len(ins)] = ins
                    read_i += len(ins)
                elif fc == 0x69:  # 'i' single inserted base
                    seq[read_i] = bytev("BA")
                    read_i += 1
                elif fc == 0x44:  # 'D' deletion
                    ref_pos += intv("DL")
                elif fc == 0x4E:  # 'N' reference skip
                    ref_pos += intv("RS")
                elif fc == 0x53:  # 'S' soft clip
                    sc = arrv("SC")
                    seq[read_i:read_i + len(sc)] = sc
                    read_i += len(sc)
                elif fc == 0x50:  # 'P' padding
                    intv("PD")
                elif fc == 0x48:  # 'H' hard clip
                    intv("HC")
                elif fc == 0x62:  # 'b' bases stretch
                    bb = arrv("BB")
                    seq[read_i:read_i + len(bb)] = bb
                    read_i += len(bb)
                    ref_pos += len(bb)
                elif fc == 0x71:  # 'q' quality stretch (no seq advance)
                    if no_qual:
                        pass
                    else:
                        qq = arrv("QQ")
                        qual[idx:idx + len(qq)] = qq
                        have_qual = True
                elif fc == 0x51:  # 'Q' single quality
                    if not no_qual:
                        qual[idx] = bytev("QS")
                        have_qual = True
                else:
                    raise CramError(f"unknown CRAM feature code {fc:#x}")
            if read_i < rl:  # trailing reference-match run
                seq[read_i:rl] = ref_fetch(ref_id, ref_pos, rl - read_i)
            intv("MQ")
            if cf & CF_QUAL_ARRAY and not no_qual:
                qual = bytearray(s["QS"].read_bytes(ctx, rl))
                have_qual = True
        else:
            if not cf & CF_NO_SEQ:
                seq = bytearray(s["BA"].read_bytes(ctx, rl))
            if cf & CF_QUAL_ARRAY and not no_qual:
                qual = bytearray(s["QS"].read_bytes(ctx, rl))
                have_qual = True
        if cf & CF_NO_SEQ and bf & BAM_FUNMAP:
            continue  # SEQ '*': nothing to count (parse.py skips those)
        if have_qual:
            # unset positions (0xff) become phred 0 like `samtools view`
            qual = bytearray(0 if q == 0xFF else q for q in qual)
        yield _emit(name, seq, qual if have_qual else None)


def _emit(name: bytes, seq: bytes, qual) -> bytes:
    if qual is None:
        return b">" + name + b"\n" + bytes(seq) + b"\n"
    q33 = bytes(min(q, 93) + 33 for q in qual)
    return b"@" + name + b"\n" + bytes(seq) + b"\n+\n" + q33 + b"\n"


# --------------------------------------------------- native slice decode


def _decode_slice_native(comp: CompressionHeader, sh: SliceHeader,
                         core_data: bytes, externals_raw,
                         refs: Optional[_RefStore], counter_base: int,
                         no_qual: bool = False):
    """Decode a whole slice via native/chunker.cpp jf_cram_slice;
    returns the concatenated FASTA/FASTQ record bytes, or None to fall
    back to the python reference path (multi-ref slices, exotic input,
    or native unavailable)."""
    if sh.ref_id == -2:  # per-record RI: python path handles it
        return None
    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    ref = b""
    ref_off = 0
    have_ref = False
    if sh.embedded_ref_id >= 0:
        emb = externals_raw.get(sh.embedded_ref_id)
        if emb is None:
            return None
        ref = emb.upper()
        ref_off = sh.start - 1
        have_ref = True
    elif comp.rr and sh.ref_id >= 0 and refs is not None:
        try:
            ref = refs.get(sh.ref_id)
            have_ref = True
        except CramError:
            ref = b""  # a mapped record will fail -> python raises

    cids = sorted(externals_raw)
    n = len(cids)
    ids = (ctypes.c_int * n)(*cids)
    ptrs = (ctypes.c_char_p * n)(*[bytes(externals_raw[c]) for c in cids])
    lens = (ctypes.c_long * n)(*[len(externals_raw[c]) for c in cids])
    handle = lib.jf_cram_slice(
        comp.raw_series, len(comp.raw_series),
        comp.raw_tags, len(comp.raw_tags),
        comp.td_blob, len(comp.td_blob),
        int(comp.rn_preserved), int(comp.ap_delta), int(comp.rr),
        comp.subst or b"\x1b" * 5,
        core_data, len(core_data),
        ctypes.cast(ids, ctypes.c_void_p),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(lens, ctypes.c_void_p), n,
        ref if have_ref else None, len(ref) if have_ref else 0, ref_off,
        sh.n_records, sh.start, counter_base, int(no_qual))
    if not handle:
        return None
    try:
        out_len = lib.jf_cram_out_len(handle)
        if out_len == 0:
            return b""
        buf = ctypes.create_string_buffer(out_len)
        lib.jf_cram_out_copy(handle, buf)
        return buf.raw
    finally:
        lib.jf_cram_out_free(handle)


# ------------------------------------------------------------ containers


class StreamCursor(ByteCursor):
    """ByteCursor facade over a file-like stream (container headers are
    read field-by-field before the fixed-length body)."""

    def __init__(self, stream):
        self.stream = stream

    def u8(self) -> int:
        b = self.stream.read(1)
        if not b:
            raise CramError("truncated CRAM container header")
        return b[0]

    def take(self, n: int) -> bytes:
        d = self.stream.read(n)
        if len(d) != n:
            raise CramError("truncated CRAM container header")
        return d


EOF_POSITION = 4542278  # the spec's end-of-file container sentinel


class ContainerHeader:
    __slots__ = ("length", "ref_id", "start", "span", "n_records",
                 "record_counter", "n_blocks")

    def __init__(self, first4: bytes, cur: StreamCursor, v3: bool = True):
        (self.length,) = struct.unpack("<i", first4)
        self.ref_id = cur.itf8()
        self.start = cur.itf8()
        self.span = cur.itf8()
        self.n_records = cur.itf8()
        # 2.x: record counter is itf8 and the header carries no CRC32
        # (htslib cram_read_container gates both on major >= 3); bases
        # stays ltf8 in both
        self.record_counter = cur.ltf8() if v3 else cur.itf8()
        cur.ltf8()  # bases
        self.n_blocks = cur.itf8()
        cur.itf8_array()  # landmarks (blocks are walked sequentially)
        if v3:
            cur.take(4)  # container header CRC32

    @property
    def is_eof(self) -> bool:
        return self.n_records == 0 and self.start == EOF_POSITION


def _decode_slice_unit(comp, sh, blocks, refs, counter, skip_cids=None):
    """Worker-thread unit: force-decompress a slice's blocks (the
    adaptive codecs — fqz/rans/arith/tok3 — run native with the GIL
    released, so slices genuinely decode in parallel) then decode the
    records. Returns one bytes blob (b"" for an empty slice).

    skip_cids (a set => quality-free mode): external blocks with these
    content ids are left COMPRESSED and never decoded — on
    quality-heavy CRAMs (fqzcomp) this removes the dominant decode cost
    when the consumer only needs sequence (count without -Q)."""
    no_qual = skip_cids is not None
    core_data = b""
    externals_raw = {}
    for blk in blocks:
        if (no_qual and blk.ctype == CT_EXTERNAL
                and blk.cid in skip_cids):
            continue  # quality stream: stays compressed, never read
        blk.force()
        if blk.ctype == CT_CORE:
            core_data = blk.data
        elif blk.ctype == CT_EXTERNAL:
            externals_raw[blk.cid] = blk.data
        else:
            raise CramError("unexpected block type inside slice")
    native = _decode_slice_native(comp, sh, core_data, externals_raw,
                                  refs, counter, no_qual=no_qual)
    if native is not None:
        return native
    externals = {cid: ByteCursor(data)
                 for cid, data in externals_raw.items()}
    return b"".join(_decode_slice(comp, sh, BitReader(core_data),
                                  externals, refs, counter,
                                  no_qual=no_qual))


def cram_records_to_fastx(stream, need_quals: bool = True) -> Iterator[bytes]:
    """Yield chunks of FASTA/FASTQ record bytes from a CRAM stream
    positioned just after the 4-byte "CRAM" magic (how parse.py
    dispatches). Chunks split only at record boundaries: one chunk per
    slice.

    need_quals=False: when the compression header proves the quality
    streams exclusive (qual_skip_cids), their blocks are never even
    DECOMPRESSED and records emit as FASTA — the htslib
    required-fields optimization; on fqzcomp-quality CRAMs this removes
    the dominant decode cost for plain counting (no -Q filtering).

    Slices decode CONCURRENTLY on a small thread pool (the reference
    gets this from htslib's own thread pool; here the native block
    codecs release the GIL). The container walk, header parses and CRC
    checks stay on the consumer thread; results are yielded strictly in
    file order. JF_CRAM_THREADS overrides the pool width (<=1 =
    sequential)."""
    ver = stream.read(2)
    if len(ver) != 2:
        raise CramError("truncated CRAM file definition")
    major, minor = ver
    if major not in (2, 3):
        raise CramError(
            f"CRAM version {major}.{minor} not supported (2.x/3.x only; "
            "re-encode with `samtools view -C --output-fmt-option "
            "version=3.0`)")
    # 2.x (cramtools-era legacy) differs from 3.x only in framing: no
    # CRC32 on container headers or blocks, and itf8 record counters in
    # container/slice headers. Codecs, encodings, features and the
    # native slice decoder are shared.
    v3 = major == 3
    stream.read(20)  # file id
    refs: Optional[_RefStore] = None
    scur = StreamCursor(stream)

    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    n_threads = int(_os.environ.get(
        "JF_CRAM_THREADS", min(4, _os.cpu_count() or 1)
    ))
    pool = ThreadPoolExecutor(n_threads) if n_threads > 1 else None
    pending: deque = deque()
    window = 2 * n_threads

    def units():
        nonlocal refs
        while True:
            first4 = stream.read(4)
            if len(first4) == 0:
                return  # EOF container is recommended, not required
            if len(first4) != 4:
                raise CramError("truncated CRAM container")
            ch = ContainerHeader(first4, scur, v3)
            body = stream.read(ch.length)
            if len(body) != ch.length:
                raise CramError("truncated CRAM container body")
            if ch.is_eof:
                return
            cur = ByteCursor(body)
            first_block = Block(cur, has_crc=v3)
            if first_block.ctype == CT_FILE_HEADER:
                # SAM header text: int32 length + text
                (text_len,) = struct.unpack_from(
                    "<i", first_block.data, 0
                )
                refs = _RefStore(first_block.data[4:4 + text_len])
                continue
            if first_block.ctype != CT_COMPRESSION_HEADER:
                raise CramError("container does not start with a "
                                "compression header block")
            comp = CompressionHeader(first_block.data)
            skip_cids = None
            if not need_quals:
                skip_cids = comp.qual_skip_cids()  # None => unsafe
            counter = ch.record_counter
            while not cur.eof():
                sh_block = Block(cur, has_crc=v3)
                if sh_block.ctype != CT_SLICE_HEADER:
                    raise CramError("expected a slice header block")
                sh = SliceHeader(sh_block.data, v3)
                blocks = [Block(cur, has_crc=v3, lazy=True)
                          for _ in range(sh.n_blocks)]
                # warm the ref cache on THIS thread so _RefStore stays
                # single-writer (workers then only read the dict)
                if (refs is not None and comp.rr and sh.ref_id >= 0
                        and sh.embedded_ref_id < 0):
                    try:
                        refs.get(sh.ref_id)
                    except CramError:
                        pass  # worker's decode raises the precise error
                yield comp, sh, blocks, refs, counter, skip_cids
                counter += sh.n_records

    try:
        for unit in units():
            if pool is None:
                blob = _decode_slice_unit(*unit)
                if blob:
                    yield blob
                continue
            pending.append(pool.submit(_decode_slice_unit, *unit))
            while pending and (len(pending) >= window
                               or pending[0].done()):
                blob = pending.popleft().result()
                if blob:
                    yield blob
        while pending:
            blob = pending.popleft().result()
            if blob:
                yield blob
    finally:
        if pool is not None:
            for f in pending:
                f.cancel()
            pool.shutdown(wait=True, cancel_futures=True)
