"""Name tokenizer codec (CRAM 3.1 block compression method 8).

Pure-python implementation of the read-name tokenization codec
specified for CRAM 3.1 (hts-specs CRAMcodecs: "Name tokenisation
codec"), extending the no-htslib CRAM reading path (io/cram.py;
reference consumption surface `sam_format.hpp:22-57`).  The encoder
exists to validate the decoder without htslib in the image (strategy
of io/rans.py / io/rans16.py / io/arith.py).

Model: the block holds N names separated by NUL bytes.  Each name is
tokenised (digit runs, non-digit runs, single chars); token position t
of every name contributes to a family of byte streams B[t][type].
Each stream is individually compressed (rANS Nx16, or the adaptive
arithmetic coder when the header's use_arith byte is set).  Names are
coded against an earlier name (DIFF dist, usually 1) so repeated
structure collapses into MATCH/DELTA tokens.

Serialized layout:

    [uint32 LE ulen]  total uncompressed length (names + 1 NUL each)
    [uint32 LE nnames]
    [1 byte use_arith]
    streams: [1 byte desc][payload]...
        desc bit 0x80: this stream starts the next token position
        desc bit 0x40: duplicate - payload is [pos u8][type u8] naming
                       an earlier stream whose decoded bytes are shared
        desc low 6 bits: token type
        otherwise: payload is [uint7 clen][clen compressed bytes]

Token types and their stream payloads:

    TYPE 0 (the per-position type selector, one byte per name reaching
    that position), STRING 1 (NUL-terminated), CHAR 2 (one byte),
    DIGITS0 4 (uint32 LE, zero-padded; width from DZLEN 3),
    DUP 5 / DIFF 6 (uint32 LE distance, position 0 only),
    DIGITS 7 (uint32 LE), DELTA 8 / DELTA0 9 (uint8 delta vs the
    referenced name's numeric token), MATCH 10 (no payload),
    NOP 11, END 12 (no payload).
"""

from __future__ import annotations

import struct

from jellyfish_tpu_torch.io.rans16 import _Cur, write_uint7
from jellyfish_tpu_torch.native import get_lib

__all__ = ["decode", "encode"]

T_TYPE = 0
T_STRING = 1
T_CHAR = 2
T_DZLEN = 3
T_DIGITS0 = 4
T_DUP = 5
T_DIFF = 6
T_DIGITS = 7
T_DELTA = 8
T_DELTA0 = 9
T_MATCH = 10
T_NOP = 11
T_END = 12
N_TYPES = 13


def _peek_size(blob: bytes):
    """The embedded uncompressed length of a rans16/arith sub-stream
    (None under NOSZ): peeking it lets decode() take the native path,
    which requires a known output size."""
    try:
        cur = _Cur(blob)
        flags = cur.u8()
        if flags & 0x10:  # NOSZ (same bit in both codecs)
            return None
        return cur.uint7()
    except IndexError:
        return None


def _sub_decode(blob: bytes, use_arith: bool) -> bytes:
    size = _peek_size(blob)
    if use_arith:
        from jellyfish_tpu_torch.io import arith
        return arith.decode(blob, size)
    from jellyfish_tpu_torch.io import rans16
    return rans16.decode(blob, size)


def _sub_encode(raw: bytes, use_arith: bool) -> bytes:
    if use_arith:
        from jellyfish_tpu_torch.io import arith
        return arith.encode(raw, 0)
    from jellyfish_tpu_torch.io import rans16
    return rans16.encode(raw, 0)


class _Stream:
    __slots__ = ("cur",)

    def __init__(self, data: bytes):
        self.cur = _Cur(data)

    def u8(self) -> int:
        return self.cur.u8()

    def u32(self) -> int:
        return self.cur.u32()

    def string(self) -> bytes:
        buf = self.cur.buf
        end = buf.index(0, self.cur.pos)
        s = bytes(buf[self.cur.pos:end])
        self.cur.pos = end + 1
        return s


def decode(data: bytes, raw_size) -> bytes:
    if raw_size is not None:
        out = _decode_native(data, raw_size)
        if out is not None:
            return out
    return _decode_python(data, raw_size)


def _decode_native(data: bytes, raw_size: int):
    """native/chunker.cpp jf_tok3_decode fast path; None -> fall back
    to the pure-python reference path (which raises exact errors)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    buf = ctypes.create_string_buffer(raw_size) if raw_size else None
    n = lib.jf_tok3_decode(data, len(data), buf, raw_size)
    if n != raw_size:
        return None
    return buf.raw if raw_size else b""


def _decode_python(data: bytes, raw_size) -> bytes:
    cur = _Cur(data)
    ulen, nnames = struct.unpack_from("<II", data, 0)
    cur.pos = 8
    use_arith = bool(cur.u8())

    streams = {}  # (pos, type) -> _Stream
    t = -1
    while cur.pos < len(data):
        desc = cur.u8()
        ttype = desc & 0x3F
        if desc & 0x80:
            t += 1
        if t < 0:
            raise ValueError("tok3: stream before first position marker")
        if desc & 0x40:
            dpos = cur.u8()
            dtype = cur.u8()
            src = streams.get((dpos, dtype))
            if src is None:
                raise ValueError("tok3: duplicate references unknown stream")
            streams[(t, ttype)] = _Stream(src.cur.buf)
        else:
            clen = cur.uint7()
            blob = cur.take(clen)
            streams[(t, ttype)] = _Stream(_sub_decode(blob, use_arith))

    def stream(pos, ttype):
        s = streams.get((pos, ttype))
        if s is None:
            raise ValueError(f"tok3: missing stream ({pos},{ttype})")
        return s

    names = []
    # per-name per-position memory for MATCH/DELTA: (text, value)
    toks = []
    out = bytearray()
    for i in range(nnames):
        first = stream(0, T_TYPE).u8()
        if first == T_DUP:
            dist = stream(0, T_DUP).u32()
            if dist <= 0 or dist > i:
                raise ValueError("tok3: DUP distance out of range")
            names.append(names[i - dist])
            toks.append(toks[i - dist])
            out += names[i] + b"\x00"
            continue
        if first != T_DIFF:
            raise ValueError("tok3: name must start with DIFF or DUP")
        dist = stream(0, T_DIFF).u32()
        prev = toks[i - dist] if 0 < dist <= i else None
        mytoks = [None]  # position 0 placeholder
        parts = []
        t = 1
        while True:
            ttype = stream(t, T_TYPE).u8()
            if ttype == T_END:
                break
            if ttype == T_CHAR:
                text = bytes([stream(t, T_CHAR).u8()])
                val = None
            elif ttype == T_STRING:
                text = stream(t, T_STRING).string()
                val = None
            elif ttype == T_DIGITS:
                val = stream(t, T_DIGITS).u32()
                text = str(val).encode()
            elif ttype == T_DIGITS0:
                val = stream(t, T_DIGITS0).u32()
                width = stream(t, T_DZLEN).u8()
                text = str(val).encode().rjust(width, b"0")
            elif ttype == T_DELTA:
                if prev is None or t >= len(prev) or prev[t][1] is None:
                    raise ValueError("tok3: DELTA without numeric anchor")
                val = (prev[t][1] + stream(t, T_DELTA).u8()) & 0xFFFFFFFF
                text = str(val).encode()
            elif ttype == T_DELTA0:
                if prev is None or t >= len(prev) or prev[t][1] is None:
                    raise ValueError("tok3: DELTA0 without numeric anchor")
                val = (prev[t][1] + stream(t, T_DELTA0).u8()) & 0xFFFFFFFF
                text = str(val).encode().rjust(len(prev[t][0]), b"0")
            elif ttype == T_MATCH:
                if prev is None or t >= len(prev) or prev[t] is None:
                    raise ValueError("tok3: MATCH without anchor")
                text, val = prev[t]
            elif ttype == T_NOP:
                text, val = b"", None
            else:
                raise ValueError(f"tok3: unknown token type {ttype}")
            mytoks.append((text, val))
            parts.append(text)
            t += 1
        name = b"".join(parts)
        names.append(name)
        toks.append(mytoks)
        out += name + b"\x00"
    if len(out) != ulen or (raw_size is not None and len(out) != raw_size):
        raise ValueError("tok3: uncompressed length mismatch")
    return bytes(out)


# --------------------------------------------------------------- encode

def _tokenize(name: bytes):
    """Split into (text, value) tokens: maximal digit runs (capped at
    9 digits so values fit uint32; leading zeros get DIGITS0 form) and
    maximal non-digit runs."""
    toks = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39 and j - i < 9:
                j += 1
            text = name[i:j]
            toks.append((text, int(text)))
            i = j
        else:
            j = i
            while j < n and not (0x30 <= name[j] <= 0x39):
                j += 1
            toks.append((name[i:j], None))
            i = j
    return toks


def encode(raw: bytes, use_arith: bool = False) -> bytes:
    """Compress a NUL-separated (and NUL-terminated) name blob."""
    if raw and not raw.endswith(b"\x00"):
        raise ValueError("tok3 encoder expects NUL-terminated names")
    names = raw.split(b"\x00")[:-1] if raw else []
    streams = {}  # (pos, type) -> bytearray

    def put(pos, ttype, data=b""):
        key = (pos, ttype)
        s = streams.get(key)
        if s is None:
            s = streams[key] = bytearray()
        s += data

    toks = []
    for i, name in enumerate(names):
        if i > 0 and name == names[i - 1]:
            put(0, T_TYPE, bytes([T_DUP]))
            put(0, T_DUP, struct.pack("<I", 1))
            toks.append(toks[i - 1])
            continue
        put(0, T_TYPE, bytes([T_DIFF]))
        dist = 1 if i > 0 else 0
        put(0, T_DIFF, struct.pack("<I", dist))
        prev = toks[i - dist] if dist else None
        mytoks = [None]
        for t, (text, val) in enumerate(_tokenize(name), start=1):
            ptok = prev[t] if prev is not None and t < len(prev) else None
            if ptok is not None and ptok[0] == text:
                put(t, T_TYPE, bytes([T_MATCH]))
            elif (val is not None and ptok is not None
                    and ptok[1] is not None
                    and 0 <= val - ptok[1] <= 255
                    and text == str(val).encode()
                    and ptok[0] == str(ptok[1]).encode()):
                put(t, T_TYPE, bytes([T_DELTA]))
                put(t, T_DELTA, bytes([val - ptok[1]]))
            elif (val is not None and ptok is not None
                    and ptok[1] is not None
                    and 0 <= val - ptok[1] <= 255
                    and len(text) == len(ptok[0])):
                put(t, T_TYPE, bytes([T_DELTA0]))
                put(t, T_DELTA0, bytes([val - ptok[1]]))
            elif val is not None and text == str(val).encode():
                put(t, T_TYPE, bytes([T_DIGITS]))
                put(t, T_DIGITS, struct.pack("<I", val))
            elif val is not None:
                put(t, T_TYPE, bytes([T_DIGITS0]))
                put(t, T_DIGITS0, struct.pack("<I", val))
                put(t, T_DZLEN, bytes([len(text)]))
            elif len(text) == 1:
                put(t, T_TYPE, bytes([T_CHAR]))
                put(t, T_CHAR, text)
            else:
                put(t, T_TYPE, bytes([T_STRING]))
                put(t, T_STRING, text + b"\x00")
            mytoks.append((text, val))
        put(len(mytoks), T_TYPE, bytes([T_END]))
        toks.append(mytoks)

    out = bytearray(struct.pack("<II", len(raw), len(names)))
    out.append(1 if use_arith else 0)
    max_pos = max((p for p, _ in streams), default=-1)
    seen = {}  # bytes -> (pos, type) for duplicate elision
    for pos in range(max_pos + 1):
        new_bit = 0x80
        for ttype in range(N_TYPES):
            s = streams.get((pos, ttype))
            if s is None:
                continue
            blob = bytes(s)
            dup = seen.get(blob)
            if dup is not None and dup[0] < 256:
                out.append(new_bit | 0x40 | ttype)
                out.append(dup[0])
                out.append(dup[1])
            else:
                comp = _sub_encode(blob, use_arith)
                out.append(new_bit | ttype)
                write_uint7(out, len(comp))
                out += comp
                seen.setdefault(blob, (pos, ttype))
            new_bit = 0
    return bytes(out)
