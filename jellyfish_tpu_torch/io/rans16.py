"""rANS Nx16 codec (CRAM 3.1 block compression method 5).

Pure-python implementation of the N-way interleaved 16-bit-renorm rANS
coder specified for CRAM 3.1 (hts-specs CRAMcodecs: "rANS Nx16").  The
reference consumes CRAM through htslib behind `sam_format.hpp:22-57`;
this module extends the no-htslib reading path (io/cram.py) from CRAM
3.0 to 3.1.  The encoder exists so the decoder can be validated without
htslib in the image (same strategy as the 3.0 rANS 4x8 in io/rans.py:
independent spec-written encoder + golden vectors + fuzz).

Stream layout (one compressed block, no outer size prefix — CRAM 3.1
blocks carry the sizes in the block header, unlike the 3.0 rANS 4x8
9-byte prefix):

    [1 byte format flags]
    [uint7 uncompressed length]        (absent when NOSZ)
    [transform metadata: STRIPE | PACK | RLE]
    [payload: CAT raw bytes | order-0/1 rANS stream]

Format flags:  0x01 ORDER1, 0x04 N32 (32-way interleave, else 4),
0x08 STRIPE, 0x10 NOSZ, 0x20 CAT, 0x40 RLE, 0x80 PACK.

Transform pipeline: encode = pack -> rle -> rans; decode applies the
inverse in reverse order.  STRIPE is exclusive at the top level: the
data is split into N interleaved lanes, each lane recursively encoded
with its own format byte.

uint7 = big-endian base-128 varint (0x80 continuation on all but the
final byte).

rANS details: 32-bit states, 16-bit little-endian renormalisation at
lower bound 2^15; order-0 frequencies normalised (by BOTH sides, per
the spec) to a 2^12 total; order-1 tables use a per-table 4-bit shift
(12, or 10 for the "fast" profile) and may themselves be stored
order-0-compressed.  Order-0 interleaves position i on state i mod N;
order-1 splits the output into N contiguous slices (the last state
also takes the remainder), each starting at context 0.
"""

from __future__ import annotations

import struct

from jellyfish_tpu_torch.native import get_lib

__all__ = ["decode", "encode"]

F_ORDER1 = 0x01
F_N32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80

TF_SHIFT_O0 = 12
RANS_L = 1 << 15


class _Cur:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def u8(self):
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def u32(self):
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u16(self):
        v = self.buf[self.pos] | (self.buf[self.pos + 1] << 8)
        self.pos += 2
        return v

    def take(self, n):
        d = self.buf[self.pos:self.pos + n]
        if len(d) != n:
            raise ValueError("rANS Nx16 stream truncated")
        self.pos += n
        return d

    def uint7(self):
        v = 0
        while True:
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                return v


def write_uint7(out: bytearray, v: int) -> None:
    groups = []
    while True:
        groups.append(v & 0x7F)
        v >>= 7
        if not v:
            break
    for i in range(len(groups) - 1, 0, -1):
        out.append(0x80 | groups[i])
    out.append(groups[0])


# ------------------------------------------------------------- alphabet

def _read_alphabet(cur: _Cur):
    """Symbol list with the same run-length scheme as rANS 4x8: an
    explicit symbol equal to previous+1 is followed by a byte giving
    how many further consecutive symbols are implied; terminated by a
    0 symbol (symbols appear in increasing order, so a genuine 0 can
    only be first)."""
    syms = []
    sym = cur.u8()
    last = sym
    rle = 0
    while True:
        syms.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = cur.u8()
            if sym == last + 1:
                rle = cur.u8()
        last = sym
        if sym == 0:
            break
    return syms


def _write_alphabet(out: bytearray, syms) -> None:
    rle = 0
    for i, s in enumerate(syms):
        if rle > 0:
            rle -= 1
            continue
        out.append(s)
        if i > 0 and s == syms[i - 1] + 1:
            run = 0
            while (i + 1 + run < len(syms)
                   and syms[i + 1 + run] == s + 1 + run):
                run += 1
            out.append(run)
            rle = run
    out.append(0)


def _normalise(freq, bits):
    """Scale so the present-symbol frequencies sum to exactly 2^bits
    (run by both encoder and decoder, so it must be deterministic):
    proportional floor-scaling with a minimum of 1, remainder assigned
    to the most frequent symbol."""
    t = sum(freq)
    tot = 1 << bits
    if t == 0 or t == tot:
        return freq
    m = max(range(256), key=lambda s: freq[s])
    fsum = 0
    for s in range(256):
        if freq[s]:
            freq[s] = max(1, freq[s] * tot // t)
            fsum += freq[s]
    drift = tot - fsum
    if freq[m] + drift < 1:
        # pathological many-rare-symbols case: shave the largest
        # entries down deterministically
        order = sorted((s for s in range(256) if freq[s]),
                       key=lambda s: (-freq[s], s))
        i = 0
        while drift < 0:
            s = order[i % len(order)]
            if freq[s] > 1:
                freq[s] -= 1
                drift += 1
            i += 1
    else:
        freq[m] += drift
    return freq


def _cumulative(freq, bits):
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    if cum[256] > (1 << bits):
        raise ValueError("rANS Nx16 frequency table overflows precision")
    ssym = bytearray(1 << bits)
    for s in range(256):
        if freq[s]:
            ssym[cum[s]:cum[s + 1]] = bytes([s]) * freq[s]
    return cum, ssym


# -------------------------------------------------------------- order 0

def _read_freqs0(cur: _Cur):
    syms = _read_alphabet(cur)
    freq = [0] * 256
    for s in syms:
        freq[s] = cur.uint7()
    return _normalise(freq, TF_SHIFT_O0)


def _decode_rans0(cur: _Cur, n_out: int, N: int) -> bytes:
    freq = _read_freqs0(cur)
    cum, ssym = _cumulative(freq, TF_SHIFT_O0)
    states = [cur.u32() for _ in range(N)]
    out = bytearray(n_out)
    mask = (1 << TF_SHIFT_O0) - 1
    for i in range(n_out):
        j = i % N
        x = states[j]
        m = x & mask
        s = ssym[m]
        out[i] = s
        x = freq[s] * (x >> TF_SHIFT_O0) + m - cum[s]
        guard = 0
        while x < RANS_L:
            x = (x << 16) | cur.u16()
            guard += 1
            if guard > 2:
                raise ValueError("rANS Nx16 state underflow")
        states[j] = x
    return bytes(out)


def _encode_rans0(raw: bytes, N: int) -> bytes:
    counts = [0] * 256
    for b in raw:
        counts[b] += 1
    freq = _normalise(counts, TF_SHIFT_O0)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    table = bytearray()
    _write_alphabet(table, [s for s in range(256) if freq[s]])
    for s in range(256):
        if freq[s]:
            write_uint7(table, freq[s])

    states = [RANS_L] * N
    rev = bytearray()  # 16-bit words, low-word-first; reversed at the end
    for i in range(len(raw) - 1, -1, -1):
        j = i % N
        s = raw[i]
        f = freq[s]
        x = states[j]
        x_max = ((RANS_L >> TF_SHIFT_O0) << 16) * f
        while x >= x_max:
            rev.append(x & 0xFF)
            rev.append((x >> 8) & 0xFF)
            x >>= 16
        states[j] = ((x // f) << TF_SHIFT_O0) + (x % f) + cum[s]
    body = bytearray()
    for x in states:
        body += struct.pack("<I", x)
    # the 16-bit words were appended (lo, hi) in reverse stream order:
    # un-reverse word-wise so the decoder reads them little-endian
    for k in range(len(rev) - 2, -2, -2):
        body.append(rev[k])
        body.append(rev[k + 1])
    return bytes(table) + bytes(body)


# -------------------------------------------------------------- order 1

def _read_freqs1(cur: _Cur, N: int):
    comp = cur.u8()
    shift = comp >> 4
    if comp & 1:
        u_size = cur.uint7()
        c_size = cur.uint7()
        sub = _Cur(cur.take(c_size))
        tbl = _Cur(_decode_rans0(sub, u_size, 4))
    else:
        tbl = cur
    syms = _read_alphabet(tbl)
    freqs = {}
    cums = {}
    ssyms = {}
    for i in syms:
        row = [0] * 256
        for j in syms:
            row[j] = tbl.uint7()
        _normalise(row, shift)
        freqs[i] = row
        cums[i], ssyms[i] = _cumulative(row, shift)
    return shift, freqs, cums, ssyms


def _decode_rans1(cur: _Cur, n_out: int, N: int) -> bytes:
    shift, freqs, cums, ssyms = _read_freqs1(cur, N)
    states = [cur.u32() for _ in range(N)]
    out = bytearray(n_out)
    q = n_out // N
    starts = [j * q for j in range(N)]
    ctxs = [0] * N
    mask = (1 << shift) - 1

    def step(j, pos):
        x = states[j]
        m = x & mask
        c = ctxs[j]
        try:
            s = ssyms[c][m]
        except KeyError:
            raise ValueError("rANS Nx16 order-1 context missing from table")
        out[pos] = s
        x = freqs[c][s] * (x >> shift) + m - cums[c][s]
        guard = 0
        while x < RANS_L:
            x = (x << 16) | cur.u16()
            guard += 1
            if guard > 2:
                raise ValueError("rANS Nx16 state underflow")
        states[j] = x
        ctxs[j] = s

    for i in range(q):
        for j in range(N):
            step(j, starts[j] + i)
    for pos in range(N * q, n_out):
        step(N - 1, pos)
    return bytes(out)


def _encode_rans1(raw: bytes, N: int) -> bytes:
    n = len(raw)
    q = n // N
    starts = [j * q for j in range(N)]
    shift = TF_SHIFT_O0
    counts = {}
    for j in range(N):
        ctx = 0
        end = starts[j] + q if j < N - 1 else n
        for i in range(starts[j], end):
            row = counts.get(ctx)
            if row is None:
                row = counts[ctx] = [0] * 256
            row[raw[i]] += 1
            ctx = raw[i]
    # shared alphabet: every context byte and every literal byte
    present = set(counts)
    for row in counts.values():
        present.update(s for s in range(256) if row[s])
    syms = sorted(present)
    freqs = {}
    cums = {}
    for c in syms:
        row = counts.get(c)
        if row is None:
            row = [0] * 256
        row = _normalise(list(row), shift)
        cum = [0] * 257
        for s in range(256):
            cum[s + 1] = cum[s] + row[s]
        freqs[c] = row
        cums[c] = cum

    table = bytearray()
    _write_alphabet(table, syms)
    for i in syms:
        for j in syms:
            write_uint7(table, freqs[i][j])
    # store the table order-0-compressed when that helps (also exercises
    # the compressed-table path); comp byte: shift<<4 | compressed-flag
    comp_tbl = _encode_rans0(bytes(table), 4)
    hdr = bytearray()
    if len(comp_tbl) + 8 < len(table):
        hdr.append((shift << 4) | 1)
        write_uint7(hdr, len(table))
        write_uint7(hdr, len(comp_tbl))
        hdr += comp_tbl
    else:
        hdr.append(shift << 4)
        hdr += table

    states = [RANS_L] * N
    rev = bytearray()

    def enc(j, ctx, sym):
        f = freqs[ctx][sym]
        x = states[j]
        x_max = ((RANS_L >> shift) << 16) * f
        while x >= x_max:
            rev.append(x & 0xFF)
            rev.append((x >> 8) & 0xFF)
            x >>= 16
        states[j] = ((x // f) << shift) + (x % f) + cums[ctx][sym]

    # mirror of the decoder, reversed: remainder on state N-1 first
    for pos in range(n - 1, N * q - 1, -1):
        enc(N - 1, raw[pos - 1] if pos > starts[N - 1] else 0, raw[pos])
    for i in range(q - 1, -1, -1):
        for j in range(N - 1, -1, -1):
            pos = starts[j] + i
            enc(j, raw[pos - 1] if i > 0 else 0, raw[pos])
    body = bytearray()
    for x in states:
        body += struct.pack("<I", x)
    for k in range(len(rev) - 2, -2, -2):
        body.append(rev[k])
        body.append(rev[k + 1])
    return bytes(hdr) + bytes(body)


# ---------------------------------------------------------------- PACK

def _pack_bits(nsym: int) -> int:
    if nsym <= 1:
        return 0
    if nsym <= 2:
        return 1
    if nsym <= 4:
        return 2
    if nsym <= 16:
        return 4
    raise ValueError("PACK needs <= 16 distinct symbols")


def _decode_pack_meta(cur: _Cur):
    nsym = cur.u8()
    pmap = [cur.u8() for _ in range(nsym)]
    plen = cur.uint7()
    return pmap, plen


def _decode_pack(data: bytes, pmap, out_len: int) -> bytes:
    nsym = len(pmap)
    bits = _pack_bits(nsym)
    out = bytearray(out_len)
    if bits == 0:
        if nsym == 0:
            raise ValueError("PACK with empty symbol map")
        for i in range(out_len):
            out[i] = pmap[0]
        return bytes(out)
    per = 8 // bits
    mask = (1 << bits) - 1
    for i in range(out_len):
        v = (data[i // per] >> (bits * (i % per))) & mask
        if v >= nsym:
            raise ValueError("PACK index outside symbol map")
        out[i] = pmap[v]
    return bytes(out)


def _encode_pack(raw: bytes):
    syms = sorted(set(raw))
    bits = _pack_bits(len(syms))  # raises if > 16 distinct
    inv = {s: i for i, s in enumerate(syms)}
    if bits == 0:
        packed = b""
    else:
        per = 8 // bits
        packed = bytearray((len(raw) + per - 1) // per)
        for i, b in enumerate(raw):
            packed[i // per] |= inv[b] << (bits * (i % per))
        packed = bytes(packed)
    meta = bytearray([len(syms)])
    meta += bytes(syms)
    write_uint7(meta, len(packed))
    return bytes(meta), packed


# ----------------------------------------------------------------- RLE

def _decode_rle_meta(cur: _Cur, rle_len: int):
    rle_meta_len = cur.uint7()
    lit_len = cur.uint7()
    if lit_len > rle_len:
        raise ValueError("RLE literal length exceeds expanded length")
    # metadata = 1 count byte + <=256 symbols + one uint7 run per
    # literal: bounds the decode allocation an adversarial length
    # could otherwise force
    if (rle_meta_len >> 1) > 257 + 10 * lit_len:
        raise ValueError("RLE metadata length implausible")
    if rle_meta_len & 1:
        meta = cur.take(rle_meta_len >> 1)
    else:
        comp_len = cur.uint7()
        sub = _Cur(cur.take(comp_len))
        # metadata streams are always 4-way order-0, independent of the
        # outer N32 flag
        meta = _decode_rans0(sub, rle_meta_len >> 1, 4)
    return _Cur(meta), lit_len


def _decode_rle(data: bytes, meta: _Cur, out_len: int) -> bytes:
    n_rle = meta.u8()
    if n_rle == 0:
        n_rle = 256
    in_rle = bytearray(256)
    for _ in range(n_rle):
        in_rle[meta.u8()] = 1
    out = bytearray(out_len)
    j = 0
    for b in data:
        out[j] = b
        j += 1
        if in_rle[b]:
            run = meta.uint7()
            out[j:j + run] = bytes([b]) * run
            j += run
    if j != out_len:
        raise ValueError("RLE output length mismatch")
    return bytes(out)


def _encode_rle(raw: bytes):
    """Run-length all symbols whose average run length pays: here,
    simply all symbols that ever repeat (adequate for an exerciser)."""
    rle_syms = sorted({raw[i] for i in range(1, len(raw))
                       if raw[i] == raw[i - 1]})
    if not rle_syms:
        rle_syms = [raw[0]] if raw else [0]
    in_rle = bytearray(256)
    for s in rle_syms:
        in_rle[s] = 1
    lits = bytearray()
    runs = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        b = raw[i]
        lits.append(b)
        if in_rle[b]:
            run = 0
            while i + 1 + run < n and raw[i + 1 + run] == b:
                run += 1
            write_uint7(runs, run)
            i += 1 + run
        else:
            i += 1
    meta = bytearray()
    meta.append(len(rle_syms) & 0xFF)  # 256 -> 0
    meta += bytes(rle_syms)
    meta += runs
    hdr = bytearray()
    comp_meta = _encode_rans0(bytes(meta), 4)
    if len(comp_meta) + 4 < len(meta):
        write_uint7(hdr, len(meta) << 1)  # even = compressed
        write_uint7(hdr, len(lits))
        write_uint7(hdr, len(comp_meta))
        hdr += comp_meta
    else:
        write_uint7(hdr, (len(meta) << 1) | 1)  # odd = raw
        write_uint7(hdr, len(lits))
        hdr += meta
    return bytes(hdr), bytes(lits)


# -------------------------------------------------------------- STRIPE

def _decode_stripe(cur: _Cur, out_len: int) -> bytes:
    N = cur.u8()
    if N < 1:
        raise ValueError("STRIPE with zero lanes")
    clens = [cur.uint7() for _ in range(N)]
    lanes = []
    for j in range(N):
        ulen = out_len // N + (1 if (out_len % N) > j else 0)
        sub = _Cur(cur.take(clens[j]))
        lanes.append(_decode(sub, ulen))
    out = bytearray(out_len)
    for j in range(N):
        out[j::N] = lanes[j]
    return bytes(out)


# -------------------------------------------------------------- public

def _decode(cur: _Cur, out_len) -> bytes:
    flags = cur.u8()
    if not flags & F_NOSZ:
        out_len = cur.uint7()
    elif out_len is None:
        raise ValueError("rANS Nx16 NOSZ stream needs an external size")
    if out_len == 0:
        return b""
    if flags & F_STRIPE:
        return _decode_stripe(cur, out_len)
    N = 32 if flags & F_N32 else 4
    pmap = None
    pack_len = 0
    if flags & F_PACK:
        pack_len = out_len
        pmap, out_len = _decode_pack_meta(cur)
        if out_len > pack_len:
            # packed data is never longer than its unpacked form; also
            # rejects adversarial allocation-bomb lengths
            raise ValueError("PACK length exceeds unpacked length")
    rle_meta = None
    rle_len = 0
    if flags & F_RLE:
        rle_len = out_len
        rle_meta, out_len = _decode_rle_meta(cur, rle_len)
    if out_len == 0:
        data = b""
    elif flags & F_CAT:
        data = cur.take(out_len)
    elif flags & F_ORDER1:
        data = _decode_rans1(cur, out_len, N)
    else:
        data = _decode_rans0(cur, out_len, N)
    if flags & F_RLE:
        data = _decode_rle(data, rle_meta, rle_len)
    if flags & F_PACK:
        data = _decode_pack(data, pmap, pack_len)
    return data


def decode(data: bytes, raw_size) -> bytes:
    """Decompress one rANS Nx16 block. `raw_size` is the block
    header's uncompressed size (used when the NOSZ flag omits it);
    None trusts the embedded size (nested-stream use)."""
    if raw_size is not None:
        out = _decode_native(data, raw_size)
        if out is not None:
            return out
    out = _decode(_Cur(data), raw_size)
    if raw_size is not None and len(out) != raw_size:
        raise ValueError("rANS Nx16 raw size mismatch")
    return out


def _decode_native(data: bytes, raw_size: int):
    """native/chunker.cpp jf_rans16_decode fast path; None -> fall
    back to the pure-python reference path (which raises exact
    errors)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    buf = ctypes.create_string_buffer(raw_size) if raw_size else None
    n = lib.jf_rans16_decode(data, len(data), buf, raw_size)
    if n != raw_size:
        return None
    return buf.raw if raw_size else b""


def encode(raw: bytes, flags: int = 0) -> bytes:
    """Compress to one rANS Nx16 block with the given format flags.
    STRIPE uses 4 lanes, each order-0.  Unsatisfiable requests (PACK
    with >16 distinct symbols, ORDER1 of tiny input) raise."""
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
        lanes = [rawj for rawj in (raw[j::N] for j in range(N))]
        blobs = [encode(lane, 0) for lane in lanes]
        for b in blobs:
            write_uint7(out, len(b))
        for b in blobs:
            out += b
        return bytes(out)
    N = 32 if flags & F_N32 else 4
    data = raw
    if flags & F_PACK:
        meta, data = _encode_pack(data)
        out += meta
    if flags & F_RLE:
        meta, data = _encode_rle(data)
        out += meta
    if len(data) == 0:
        pass
    elif flags & F_CAT:
        out += data
    elif flags & F_ORDER1:
        if len(data) < N:
            raise ValueError("encoder: ORDER1 input shorter than N")
        out += _encode_rans1(data, N)
    else:
        out += _encode_rans0(data, N)
    return bytes(out)
