"""Adaptive arithmetic codec (CRAM 3.1 block compression method 6).

Pure-python implementation of the range-coder + adaptive-model codec
specified for CRAM 3.1 (hts-specs CRAMcodecs: "Adaptive arithmetic
coding"), extending the no-htslib CRAM reading path (io/cram.py,
reference consumption surface `sam_format.hpp:22-57`) from 3.0 to 3.1.
The encoder exists to validate the decoder in an image without htslib
(same strategy as io/rans.py / io/rans16.py).

Stream layout:

    [1 byte format flags]
    [uint7 uncompressed length]      (absent when NOSZ)
    [PACK metadata]                  (when PACK)
    [payload]

Format flags: 0x01 ORDER1, 0x04 EXT (payload is bzip2), 0x08 STRIPE,
0x10 NOSZ, 0x20 CAT (payload raw), 0x40 RLE, 0x80 PACK.  STRIPE is
exclusive at the top level (N interleaved lanes, each recursively
coded with its own flag byte).  Unlike rANS Nx16, RLE has no metadata
stream: run lengths are coded adaptively in-stream.

Range coder: carry-propagating (LZMA-style) — 32-bit range (init
2^32-1), byte renormalisation at range < 2^24; the encoder holds a
cache byte plus a pending-0xFF run so carries out of the 32-bit low
window propagate into already-buffered bytes.  The decoder needs only
(code, range): it primes 5 bytes (the first, always zero, is the
initial cache the encoder flushes) and subtracts mod 2^32.

Adaptive model: symbols start at frequency 1, +16 per observation,
frequency-ordered by adjacent swaps, all frequencies halved (rounding
up) when the total exceeds 2^16-32.  Literal models are sized by a
stored max-symbol byte (0 means 256); run-length models are always
256-ary: a run is coded as chunks r0 (context = the literal byte),
r1, r2, ... (context 256) summed while a chunk is 255.
"""

from __future__ import annotations

import bz2

from jellyfish_tpu_torch.io.rans16 import (_Cur, write_uint7, _decode_pack_meta,
                                           _decode_pack, _encode_pack)
from jellyfish_tpu_torch.native import get_lib

__all__ = ["decode", "encode"]

F_ORDER1 = 0x01
F_EXT = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

TOP = 1 << 24
W32 = 0xFFFFFFFF

STEP = 16
MAX_FREQ = (1 << 16) - 32


class RangeEncoder:
    """Carry-propagating (LZMA-style) range encoder: 32-bit range,
    32-bit low window with a cache byte + pending-0xFF run absorbing
    carries. The first emitted byte is always 0 (the initial cache);
    the decoder's 5-byte prime discards it."""

    def __init__(self):
        self.low = 0  # 33-bit: bit 32 is the pending carry
        self.range = W32
        self.cache = 0
        self.ffnum = 0
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > W32:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            while self.ffnum:
                self.out.append((0xFF + carry) & 0xFF)
                self.ffnum -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & W32

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += cum * r
        self.range = r * freq
        while self.range < TOP:
            self._shift_low()
            self.range = (self.range << 8) & W32

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, cur: _Cur):
        self.cur = cur
        self.range = W32
        code = 0
        for _ in range(5):
            code = (code << 8) | cur.u8()
        self.code = code & W32

    def get_freq(self, tot: int) -> int:
        self._r = self.range // tot
        f = self.code // self._r
        return tot - 1 if f >= tot else f

    def decode(self, cum: int, freq: int) -> None:
        self.code = (self.code - cum * self._r) & W32
        self.range = self._r * freq
        while self.range < TOP:
            self.code = ((self.code << 8) | self.cur.u8()) & W32
            self.range = (self.range << 8) & W32


class SimpleModel:
    """Adaptive frequency model, kept approximately sorted by
    frequency via adjacent swaps (a move-to-front lite)."""

    __slots__ = ("freqs", "syms", "total")

    def __init__(self, nsym: int):
        self.freqs = [1] * nsym
        self.syms = list(range(nsym))
        self.total = nsym

    def _bump(self, i: int) -> None:
        self.freqs[i] += STEP
        self.total += STEP
        if i > 0 and self.freqs[i] > self.freqs[i - 1]:
            self.freqs[i], self.freqs[i - 1] = \
                self.freqs[i - 1], self.freqs[i]
            self.syms[i], self.syms[i - 1] = \
                self.syms[i - 1], self.syms[i]
        if self.total > MAX_FREQ:
            total = 0
            freqs = self.freqs
            for k in range(len(freqs)):
                freqs[k] -= freqs[k] >> 1
                total += freqs[k]
            self.total = total

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        acc = 0
        freqs = self.freqs
        i = 0
        while acc + freqs[i] <= f:
            acc += freqs[i]
            i += 1
        rc.decode(acc, freqs[i])
        sym = self.syms[i]
        self._bump(i)
        return sym

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        i = self.syms.index(sym)
        acc = sum(self.freqs[:i])
        rc.encode(acc, self.freqs[i], self.total)
        self._bump(i)


# ---------------------------------------------------------- order 0 / 1

def _decode_run(rc, run_models, first_ctx: int) -> int:
    run = 0
    ctx = first_ctx
    while True:
        r = run_models[ctx].decode(rc)
        run += r
        if r != 255:
            return run
        ctx = 256


def _encode_run(rc, run_models, first_ctx: int, run: int) -> None:
    ctx = first_ctx
    while True:
        r = 255 if run >= 255 else run
        run_models[ctx].encode(rc, r)
        if r != 255:
            return
        run -= 255
        ctx = 256


def _decode_stream(cur: _Cur, n_out: int, order1: bool,
                   rle: bool) -> bytes:
    max_sym = cur.u8()
    if max_sym == 0:
        max_sym = 256
    n_lit = 256 if order1 else 1
    lit_models = [None] * n_lit
    run_models = [None] * 257 if rle else None
    rc = RangeDecoder(cur)
    out = bytearray(n_out)
    ctx = 0
    i = 0
    while i < n_out:
        m = lit_models[ctx]
        if m is None:
            m = lit_models[ctx] = SimpleModel(max_sym)
        b = m.decode(rc)
        out[i] = b
        i += 1
        if rle:
            if run_models[b] is None:
                run_models[b] = SimpleModel(256)
            if run_models[256] is None:
                run_models[256] = SimpleModel(256)
            run = _decode_run(rc, run_models, b)
            out[i:i + run] = bytes([b]) * run
            i += run
        if order1:
            ctx = b
    if i != n_out:
        raise ValueError("arith RLE output length mismatch")
    return bytes(out)


def _encode_stream(raw: bytes, order1: bool, rle: bool) -> bytes:
    max_sym = (max(raw) + 1) if raw else 1
    n_lit = 256 if order1 else 1
    lit_models = [None] * n_lit
    run_models = [None] * 257 if rle else None
    rc = RangeEncoder()
    ctx = 0
    i = 0
    n = len(raw)
    while i < n:
        b = raw[i]
        m = lit_models[ctx]
        if m is None:
            m = lit_models[ctx] = SimpleModel(max_sym)
        m.encode(rc, b)
        i += 1
        if rle:
            run = 0
            while i + run < n and raw[i + run] == b:
                run += 1
            if run_models[b] is None:
                run_models[b] = SimpleModel(256)
            if run_models[256] is None:
                run_models[256] = SimpleModel(256)
            _encode_run(rc, run_models, b, run)
            i += run
        if order1:
            ctx = b
    return bytes([max_sym & 0xFF]) + rc.finish()


# -------------------------------------------------------------- public

def _decode(cur: _Cur, out_len) -> bytes:
    flags = cur.u8()
    if not flags & F_NOSZ:
        out_len = cur.uint7()
    elif out_len is None:
        raise ValueError("arith NOSZ stream needs an external size")
    if out_len == 0:
        return b""
    if flags & F_STRIPE:
        N = cur.u8()
        if N < 1:
            raise ValueError("STRIPE with zero lanes")
        clens = [cur.uint7() for _ in range(N)]
        lanes = []
        for j in range(N):
            ulen = out_len // N + (1 if (out_len % N) > j else 0)
            lanes.append(_decode(_Cur(cur.take(clens[j])), ulen))
        out = bytearray(out_len)
        for j in range(N):
            out[j::N] = lanes[j]
        return bytes(out)
    pmap = None
    pack_len = 0
    if flags & F_PACK:
        pack_len = out_len
        pmap, out_len = _decode_pack_meta(cur)
        if out_len > pack_len:
            # packed data is never longer than its unpacked form; also
            # rejects adversarial allocation-bomb lengths
            raise ValueError("PACK length exceeds unpacked length")
    if out_len == 0:
        data = b""
    elif flags & F_EXT:
        data = bz2.decompress(bytes(cur.buf[cur.pos:]))
        if len(data) != out_len:
            raise ValueError("arith EXT raw size mismatch")
        cur.pos = len(cur.buf)
    elif flags & F_CAT:
        data = cur.take(out_len)
    else:
        data = _decode_stream(cur, out_len, bool(flags & F_ORDER1),
                              bool(flags & F_RLE))
    if flags & F_PACK:
        data = _decode_pack(data, pmap, pack_len)
    return data


def decode(data: bytes, raw_size) -> bytes:
    """Decompress one adaptive-arithmetic block.  `raw_size` is the
    CRAM block header's uncompressed size (used under NOSZ); None
    trusts the embedded size (nested-stream use)."""
    if raw_size is not None:
        out = _decode_native(data, raw_size)
        if out is not None:
            return out
    out = _decode(_Cur(data), raw_size)
    if raw_size is not None and len(out) != raw_size:
        raise ValueError("arith raw size mismatch")
    return out


def _decode_native(data: bytes, raw_size: int):
    """native/chunker.cpp jf_arith_decode fast path; None -> fall back
    to the pure-python reference path (exact errors, EXT/bzip2)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    buf = ctypes.create_string_buffer(raw_size) if raw_size else None
    n = lib.jf_arith_decode(data, len(data), buf, raw_size)
    if n != raw_size:
        return None
    return buf.raw if raw_size else b""


def encode(raw: bytes, flags: int = 0) -> bytes:
    """Compress to one adaptive-arithmetic block with the given
    format flags (STRIPE uses 4 order-0 lanes)."""
    out = bytearray([flags])
    if not flags & F_NOSZ:
        write_uint7(out, len(raw))
    if len(raw) == 0:
        return bytes(out)
    if flags & F_STRIPE:
        if flags & ~(F_STRIPE | F_NOSZ):
            raise ValueError("encoder: STRIPE composes only with NOSZ")
        N = 4
        out.append(N)
        blobs = [encode(raw[j::N], 0) for j in range(N)]
        for b in blobs:
            write_uint7(out, len(b))
        for b in blobs:
            out += b
        return bytes(out)
    data = raw
    if flags & F_PACK:
        meta, data = _encode_pack(data)
        out += meta
    if len(data) == 0:
        pass
    elif flags & F_EXT:
        out += bz2.compress(data)
    elif flags & F_CAT:
        out += data
    else:
        out += _encode_stream(data, bool(flags & F_ORDER1),
                              bool(flags & F_RLE))
    return bytes(out)
