"""fqzcomp quality codec (CRAM 3.1 block compression method 7).

Pure-python implementation of the fqzcomp context-mixing quality-score
codec specified for CRAM 3.1 (hts-specs CRAMcodecs: "FQZComp quality
codec"), extending the no-htslib CRAM reading path (io/cram.py;
reference consumption surface `sam_format.hpp:22-57` — jellyfish needs
qualities only for `-Q` filtering, `mer_qual_iterator` role).  As with
the other 3.1 codecs here, the encoder exists to validate the decoder
in an image without htslib (goldens + property fuzz in
tests/test_cram31.py; see that file's docstring for the confidence
notes on spec-from-memory details).

Layout: a version byte (5), global flags (MULTI_PARAM 0x01,
HAVE_STAB 0x02, DO_REV 0x04), an optional selector table, then one or
more parameter sets:

    context u16 LE     starting context for each record
    pflags  u8         DO_DEDUP 2, DO_LEN 4, DO_SEL 8, HAVE_QMAP 16,
                       HAVE_PTAB 32, HAVE_DTAB 64, HAVE_QTAB 128
    max_sym u8
    qbits<<4 | qshift, qloc<<4 | sloc, ploc<<4 | dloc  (u8 each)
    optional qmap (max_sym bytes) and qtab/ptab/dtab bucket arrays

followed by a single adaptive-arithmetic stream (io/arith.py range
coder + models).  Per record: a selector symbol (when several are in
play), a 4-byte length (when DO_LEN or first record), a reversal bit
(DO_REV), a dedup bit (DO_DEDUP; 1 copies the previous record), then
one quality symbol per base under a 16-bit context mixing the recent
quality history (qtab-bucketed, qshift/qbits window at qloc), the
in-read position (ptab bucket at ploc), the count of quality changes
so far (dtab bucket at dloc) and the selector (at sloc).

Bucket arrays are stored run-length encoded: successive byte run
lengths for values 0,1,2,...; two equal consecutive run lengths are
followed by a second-level repeat count.
"""

from __future__ import annotations

import struct

from jellyfish_tpu_torch.io.rans16 import _Cur
from jellyfish_tpu_torch.io.arith import RangeDecoder, RangeEncoder, SimpleModel
from jellyfish_tpu_torch.native import get_lib

__all__ = ["decode", "encode"]

VERS = 5

G_MULTI_PARAM = 0x01
G_HAVE_STAB = 0x02
G_DO_REV = 0x04

P_DO_DEDUP = 0x02
P_DO_LEN = 0x04
P_DO_SEL = 0x08
P_HAVE_QMAP = 0x10
P_HAVE_PTAB = 0x20
P_HAVE_DTAB = 0x40
P_HAVE_QTAB = 0x80

CTX_MASK = 0xFFFF


def _read_array(cur: _Cur, size: int):
    """Run-length decoded bucket map: one run length per value
    0,1,2,... (byte chunks, 255 chaining into the next byte); a run
    length equal to the previous value's is followed by a second-level
    count of further values sharing it."""
    arr = [0] * size
    z = 0
    val = 0
    last = -1
    while z < size:
        run = 0
        while True:
            b = cur.u8()
            run += b
            if b != 255:
                break
        end = min(z + run, size)
        arr[z:end] = [val] * (end - z)
        z += run
        val += 1
        if run == last:
            copy = cur.u8()
            for _ in range(copy):
                end = min(z + run, size)
                arr[z:end] = [val] * (end - z)
                z += run
                val += 1
            last = -1
        else:
            last = run
    return arr


def _write_array(out: bytearray, arr, size: int) -> None:
    runs = []  # full run length per successive value (may be 0)
    val = 0
    z = 0
    while z < size:
        run = 0
        while z + run < size and arr[z + run] == val:
            run += 1
        runs.append(run)
        z += run
        val += 1

    def put_run(r):
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)

    i = 0
    last = -1
    while i < len(runs):
        run = runs[i]
        put_run(run)
        i += 1
        if run == last:
            copy = 0
            while (i + copy < len(runs) and runs[i + copy] == run
                   and copy < 255):
                copy += 1
            out.append(copy)
            i += copy
            last = -1
        else:
            last = run


class _Param:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift",
                 "qloc", "sloc", "ploc", "dloc", "qmap", "qtab",
                 "ptab", "dtab")

    @classmethod
    def read(cls, cur: _Cur):
        p = cls()
        p.context = struct.unpack_from("<H", cur.buf, cur.pos)[0]
        cur.pos += 2
        p.pflags = cur.u8()
        p.max_sym = cur.u8() or 256
        b = cur.u8()
        p.qbits, p.qshift = b >> 4, b & 15
        b = cur.u8()
        p.qloc, p.sloc = b >> 4, b & 15
        b = cur.u8()
        p.ploc, p.dloc = b >> 4, b & 15
        p.qmap = ([cur.u8() for _ in range(p.max_sym)]
                  if p.pflags & P_HAVE_QMAP else None)
        p.qtab = (_read_array(cur, 256) if p.pflags & P_HAVE_QTAB
                  else list(range(256)))
        p.ptab = (_read_array(cur, 1024) if p.pflags & P_HAVE_PTAB
                  else [0] * 1024)
        p.dtab = (_read_array(cur, 256) if p.pflags & P_HAVE_DTAB
                  else [0] * 256)
        return p

    def write(self, out: bytearray) -> None:
        out += struct.pack("<H", self.context)
        out.append(self.pflags)
        out.append(self.max_sym & 0xFF)
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.pflags & P_HAVE_QMAP:
            out += bytes(self.qmap[:self.max_sym])
        if self.pflags & P_HAVE_QTAB:
            _write_array(out, self.qtab, 256)
        if self.pflags & P_HAVE_PTAB:
            _write_array(out, self.ptab, 1024)
        if self.pflags & P_HAVE_DTAB:
            _write_array(out, self.dtab, 256)


class _Models:
    def __init__(self, max_sym: int, max_sel: int):
        self.qual = {}
        self.max_sym = max_sym
        self.len = [SimpleModel(256) for _ in range(4)]
        self.rev = SimpleModel(2)
        self.dup = SimpleModel(2)
        self.sel = SimpleModel(max_sel + 1) if max_sel > 0 else None

    def qctx(self, ctx: int) -> SimpleModel:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = SimpleModel(self.max_sym)
        return m


def _read_header(cur: _Cur):
    vers = cur.u8()
    if vers != VERS:
        raise ValueError(f"fqzcomp version {vers} not supported ({VERS})")
    gflags = cur.u8()
    nparam = cur.u8() if gflags & G_MULTI_PARAM else 1
    if gflags & G_HAVE_STAB:
        max_sel = cur.u8()
        stab = _read_array(cur, 256)
    else:
        max_sel = nparam - 1
        stab = [min(i, nparam - 1) for i in range(256)]
    params = [_Param.read(cur) for _ in range(nparam)]
    return gflags, max_sel, stab, params


def decode(data: bytes, raw_size: int) -> bytes:
    out = _decode_native(data, raw_size)
    if out is not None:
        return out
    return _decode_python(data, raw_size)


def _decode_native(data: bytes, raw_size: int):
    """native/chunker.cpp jf_fqz_decode fast path; None -> fall back
    to the pure-python reference path (which raises exact errors)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    buf = ctypes.create_string_buffer(raw_size) if raw_size else None
    n = lib.jf_fqz_decode(data, len(data), buf, raw_size)
    if n != raw_size:
        return None
    return buf.raw if raw_size else b""


def _decode_python(data: bytes, raw_size: int) -> bytes:
    cur = _Cur(data)
    gflags, max_sel, stab, params = _read_header(cur)
    max_sym = max(p.max_sym for p in params)
    models = _Models(max_sym, max_sel)
    rc = RangeDecoder(cur)

    out = bytearray(raw_size)
    rec_starts = []  # (start, len, reversed?) for the DO_REV pass
    i = 0
    rec = 0
    last_len = 0
    while i < raw_size:
        sel = models.sel.decode(rc) if models.sel is not None else 0
        p = params[stab[min(sel, 255)]]
        if (p.pflags & P_DO_LEN) or rec == 0:
            ln = (models.len[0].decode(rc)
                  | (models.len[1].decode(rc) << 8)
                  | (models.len[2].decode(rc) << 16)
                  | (models.len[3].decode(rc) << 24))
            last_len = ln
        else:
            ln = last_len
        if ln == 0 or i + ln > raw_size:
            raise ValueError("fqzcomp record length out of range")
        is_rev = bool(gflags & G_DO_REV) and bool(models.rev.decode(rc))
        if p.pflags & P_DO_DEDUP:
            if models.dup.decode(rc):
                if rec == 0 or rec_starts[-1][1] != ln:
                    raise ValueError("fqzcomp dedup without matching "
                                     "previous record")
                prev_start = rec_starts[-1][0]
                out[i:i + ln] = out[prev_start:prev_start + ln]
                rec_starts.append((i, ln, is_rev))
                i += ln
                rec += 1
                continue
        qmask = (1 << p.qbits) - 1
        qlast = 0
        delta = 0
        prevq = 0
        ctx = p.context
        for j in range(ln):
            q = models.qctx(ctx).decode(rc)
            out[i + j] = p.qmap[q] if p.qmap is not None else q
            qlast = ((qlast << p.qshift) + p.qtab[q]) & qmask
            ctx = p.context
            ctx += qlast << p.qloc
            # position context counts bases REMAINING (the spec's
            # state.p starts at the record length and decrements
            # AFTER use)
            ctx += p.ptab[min(ln - j, 1023)] << p.ploc
            ctx += p.dtab[min(delta, 255)] << p.dloc
            if p.pflags & P_DO_SEL:
                ctx += sel << p.sloc
            ctx &= CTX_MASK
            if prevq != q:
                delta += 1
            prevq = q
        rec_starts.append((i, ln, is_rev))
        i += ln
        rec += 1
    for start, ln, is_rev in rec_starts:
        if is_rev:
            out[start:start + ln] = out[start:start + ln][::-1]
    return bytes(out)


# --------------------------------------------------------------- encode

def _default_param(quals: bytes, pflags: int, sel_bits: int) -> _Param:
    p = _Param()
    p.pflags = pflags
    syms = sorted(set(quals)) or [0]
    if pflags & P_HAVE_QMAP:
        p.qmap = syms
        p.max_sym = len(syms)
    else:
        p.qmap = None
        p.max_sym = max(syms) + 1
    p.context = 0
    p.qbits = 9
    p.qshift = 5 if p.max_sym > 16 else 3
    p.qloc = 7
    p.sloc = 0 if not (pflags & P_DO_SEL) else 13 - sel_bits
    p.ploc = 0
    p.dloc = 3
    if pflags & P_HAVE_QTAB:
        # bucket qualities coarsely: identity capped at 15
        p.qtab = [min(i, 15) for i in range(256)]
    else:
        p.qtab = list(range(256))
    if pflags & P_HAVE_PTAB:
        # bucket read position into 8 log-spaced bins at ploc 0
        p.ptab = [0] * 1024
        for i in range(1024):
            p.ptab[i] = min(7, i.bit_length())
        p.ploc = 0
    else:
        p.ptab = [0] * 1024
    if pflags & P_HAVE_DTAB:
        p.dtab = [min(i, 7) for i in range(256)]
    else:
        p.dtab = [0] * 256
    return p


def encode(lens, quals: bytes, pflags: int = P_DO_LEN,
           nparam: int = 1, do_rev=None) -> bytes:
    """Compress per-record quality strings.  `lens` gives the record
    lengths (summing to len(quals)).  `nparam` > 1 exercises the
    multi-parameter selector path (records cycle through the sets);
    `do_rev` is an optional per-record reversal-flag list."""
    if sum(lens) != len(quals):
        raise ValueError("record lengths do not sum to the data size")
    gflags = 0
    if nparam > 1:
        gflags |= G_MULTI_PARAM | G_HAVE_STAB
        pflags |= P_DO_SEL
    if do_rev is not None:
        gflags |= G_DO_REV
    sel_bits = max(1, (nparam - 1).bit_length())
    params = [_default_param(quals, pflags, sel_bits)
              for _ in range(nparam)]
    out = bytearray([VERS, gflags])
    if gflags & G_MULTI_PARAM:
        out.append(nparam)
    max_sel = nparam - 1
    stab = [min(i, max_sel) for i in range(256)]
    if gflags & G_HAVE_STAB:
        out.append(max_sel)
        _write_array(out, stab, 256)
    for p in params:
        p.write(out)

    max_sym = max(p.max_sym for p in params)
    models = _Models(max_sym, max_sel)
    rc = RangeEncoder()
    inv_qmap = [None] * nparam
    for x, p in enumerate(params):
        if p.qmap is not None:
            inv_qmap[x] = {s: i for i, s in enumerate(p.qmap)}

    i = 0
    prev_rec = None
    last_len = 0
    for rec, ln in enumerate(lens):
        body = quals[i:i + ln]
        if do_rev is not None and do_rev[rec]:
            body = body[::-1]
        sel = rec % nparam if max_sel > 0 else 0
        if models.sel is not None:
            models.sel.encode(rc, sel)
        x = stab[sel]
        p = params[x]
        if (p.pflags & P_DO_LEN) or rec == 0:
            for b in range(4):
                models.len[b].encode(rc, (ln >> (8 * b)) & 0xFF)
            last_len = ln
        elif ln != last_len:
            raise ValueError("fqzcomp without DO_LEN needs equal "
                             "record lengths")
        if do_rev is not None:
            models.rev.encode(rc, 1 if do_rev[rec] else 0)
        if p.pflags & P_DO_DEDUP:
            dup = 1 if (prev_rec is not None and body == prev_rec) else 0
            models.dup.encode(rc, dup)
            if dup:
                prev_rec = body
                i += ln
                continue
        qmask = (1 << p.qbits) - 1
        qlast = 0
        delta = 0
        prevq = 0
        ctx = p.context
        for j in range(ln):
            sym = body[j]
            q = inv_qmap[x][sym] if inv_qmap[x] is not None else sym
            models.qctx(ctx).encode(rc, q)
            qlast = ((qlast << p.qshift) + p.qtab[q]) & qmask
            ctx = p.context
            ctx += qlast << p.qloc
            # position context counts bases REMAINING (the spec's
            # state.p starts at the record length and decrements
            # AFTER use)
            ctx += p.ptab[min(ln - j, 1023)] << p.ploc
            ctx += p.dtab[min(delta, 255)] << p.dloc
            if p.pflags & P_DO_SEL:
                ctx += sel << p.sloc
            ctx &= CTX_MASK
            if prevq != q:
                delta += 1
            prevq = q
        prev_rec = body
        i += ln
    return bytes(out) + rc.finish()
