"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Pure-python implementation of the 4-way interleaved range asymmetric
numeral system coder specified for CRAM (reference consumption path:
sam_format.hpp via htslib's rANS_static; this module replaces the
htslib dependency for *reading* CRAM containers, and the encoder
exists so the decoder can be exercised without htslib in the image).

Format of one compressed block (what a CRAM block's data holds when
method == 4):

    [1 byte order (0|1)]
    [4 bytes LE compressed size  (bytes following the 9-byte prefix)]
    [4 bytes LE uncompressed size]
    [frequency table][4 x 4-byte LE initial states][byte stream]

Frequencies are normalized to sum exactly 2^12; decoding keeps 4
states, renormalizing one byte at a time from the shared stream.
Order-0 interleaves output position i on state i & 3; order-1 splits
the output into 4 contiguous quarters (state 3 also handles the
remainder) with the previous byte of the same quarter as context.
"""

from __future__ import annotations

import struct

from jellyfish_tpu_torch.native import get_lib

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT  # 4096
RANS_BYTE_L = 1 << 23

__all__ = ["decode", "encode"]


# ---------------------------------------------------------------- tables


def _read_freq(buf: bytes, pos: int):
    f = buf[pos]
    pos += 1
    if f >= 0x80:
        f = ((f & 0x7F) << 8) | buf[pos]
        pos += 1
    return f, pos


def _write_freq(out: bytearray, f: int) -> None:
    if f >= 0x80:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)
    else:
        out.append(f)


def _read_freqs0(buf: bytes, pos: int):
    """Symbol/frequency table with the run-length symbol scheme: an
    explicit symbol equal to previous+1 is followed by a byte giving
    how many further consecutive symbols are implied."""
    freq = [0] * 256
    sym = buf[pos]
    pos += 1
    last = sym
    rle = 0
    while True:
        f, pos = _read_freq(buf, pos)
        freq[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[pos]
            pos += 1
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
        last = sym
        if sym == 0:
            break
    return freq, pos


def _write_freqs0(out: bytearray, freq) -> None:
    syms = [s for s in range(256) if freq[s] > 0]
    rle = 0
    for i, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if i > 0 and s == syms[i - 1] + 1:
                run = 0
                while (i + 1 + run < len(syms)
                       and syms[i + 1 + run] == s + 1 + run):
                    run += 1
                out.append(run)
                rle = run
        _write_freq(out, freq[s])
    out.append(0)


def _normalize(counts, total=TOTFREQ):
    """Scale raw counts to sum exactly `total`, every present symbol
    keeping frequency >= 1."""
    n = sum(counts)
    if n == 0:
        return counts
    freq = [0] * 256
    # largest-remainder scaling
    scaled = [(c * total) / n for c in counts]
    for s in range(256):
        if counts[s]:
            freq[s] = max(1, int(scaled[s]))
    drift = total - sum(freq)
    # push drift onto the most frequent symbols, never below 1
    order = sorted((s for s in range(256) if freq[s]),
                   key=lambda s: -counts[s])
    i = 0
    while drift != 0 and order:
        s = order[i % len(order)]
        if drift > 0:
            freq[s] += 1
            drift -= 1
        elif freq[s] > 1:
            freq[s] -= 1
            drift += 1
        i += 1
    return freq


def _decode_tables(freq):
    """cum[s], and the 4096-entry slot -> (sym, freq, cum) lookups."""
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    if cum[256] > TOTFREQ:
        raise ValueError("rANS frequency table sums past 2^12")
    ssym = bytearray(TOTFREQ)
    for s in range(256):
        if freq[s]:
            ssym[cum[s]:cum[s + 1]] = bytes([s]) * freq[s]
    return cum, ssym


# ---------------------------------------------------------------- order 0


def _decode0(buf: bytes, pos: int, n_out: int) -> bytes:
    freq, pos = _read_freqs0(buf, pos)
    cum, ssym = _decode_tables(freq)
    x0, x1, x2, x3 = struct.unpack_from("<4I", buf, pos)
    pos += 16
    out = bytearray(n_out)
    states = [x0, x1, x2, x3]
    mask = TOTFREQ - 1
    L = RANS_BYTE_L
    for i in range(n_out):
        j = i & 3
        x = states[j]
        m = x & mask
        s = ssym[m]
        out[i] = s
        x = freq[s] * (x >> TF_SHIFT) + m - cum[s]
        while x < L:
            x = (x << 8) | buf[pos]
            pos += 1
        states[j] = x
    return bytes(out)


def _encode0(raw: bytes) -> bytes:
    counts = [0] * 256
    for b in raw:
        counts[b] += 1
    freq = _normalize(counts)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    table = bytearray()
    _write_freqs0(table, freq)

    states = [RANS_BYTE_L] * 4
    rev = bytearray()  # emitted low-byte-first, reversed at the end
    for i in range(len(raw) - 1, -1, -1):
        j = i & 3
        s = raw[i]
        f = freq[s]
        x = states[j]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + cum[s]
    body = struct.pack("<4I", *states) + bytes(reversed(rev))
    return bytes(table) + body


# ---------------------------------------------------------------- order 1


def _read_freqs1(buf: bytes, pos: int):
    tables = [None] * 256
    ctx = buf[pos]
    pos += 1
    last = ctx
    rle = 0
    while True:
        tables[ctx], pos = _read_freqs0(buf, pos)
        if rle > 0:
            rle -= 1
            ctx += 1
        else:
            ctx = buf[pos]
            pos += 1
            if ctx == last + 1:
                rle = buf[pos]
                pos += 1
        last = ctx
        if ctx == 0:
            break
    return tables, pos


def _write_freqs1(out: bytearray, tables) -> None:
    ctxs = [c for c in range(256) if tables[c] is not None]
    rle = 0
    for i, c in enumerate(ctxs):
        if rle > 0:
            rle -= 1
        else:
            out.append(c)
            if i > 0 and c == ctxs[i - 1] + 1:
                run = 0
                while (i + 1 + run < len(ctxs)
                       and ctxs[i + 1 + run] == c + 1 + run):
                    run += 1
                out.append(run)
                rle = run
        _write_freqs0(out, tables[c])
    out.append(0)


def _decode1(buf: bytes, pos: int, n_out: int) -> bytes:
    ftab, pos = _read_freqs1(buf, pos)
    ctab = [None] * 256
    stab = [None] * 256
    for c in range(256):
        if ftab[c] is not None:
            ctab[c], stab[c] = _decode_tables(ftab[c])
    states = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(n_out)
    q = n_out >> 2
    starts = (0, q, 2 * q, 3 * q)
    ctxs = [0, 0, 0, 0]
    mask = TOTFREQ - 1
    L = RANS_BYTE_L
    for i in range(q):
        for j in range(4):
            x = states[j]
            m = x & mask
            c = ctxs[j]
            s = stab[c][m]
            out[starts[j] + i] = s
            f = ftab[c][s]
            x = f * (x >> TF_SHIFT) + m - ctab[c][s]
            while x < L:
                x = (x << 8) | buf[pos]
                pos += 1
            states[j] = x
            ctxs[j] = s
    # remainder decoded by state 3, context continuing
    for i in range(4 * q, n_out):
        x = states[3]
        m = x & mask
        c = ctxs[3]
        s = stab[c][m]
        out[i] = s
        f = ftab[c][s]
        x = f * (x >> TF_SHIFT) + m - ctab[c][s]
        while x < L:
            x = (x << 8) | buf[pos]
            pos += 1
        states[3] = x
        ctxs[3] = s
    return bytes(out)


def _encode1(raw: bytes) -> bytes:
    n = len(raw)
    q = n >> 2
    starts = (0, q, 2 * q, 3 * q)
    counts = [None] * 256

    def _count(ctx, sym):
        if counts[ctx] is None:
            counts[ctx] = [0] * 256
        counts[ctx][sym] += 1

    for j in range(4):
        ctx = 0
        end = starts[j] + q if j < 3 else n
        for i in range(starts[j], end):
            _count(ctx, raw[i])
            ctx = raw[i]
    ftab = [None] * 256
    ctab = [None] * 256
    for c in range(256):
        if counts[c] is not None:
            ftab[c] = _normalize(counts[c])
            cum = [0] * 257
            for s in range(256):
                cum[s + 1] = cum[s] + ftab[c][s]
            ctab[c] = cum
    table = bytearray()
    _write_freqs1(table, ftab)

    states = [RANS_BYTE_L] * 4
    rev = bytearray()

    def _enc(j, ctx, sym):
        f = ftab[ctx][sym]
        x = states[j]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + ctab[ctx][sym]

    # exact mirror of the decoder's operation order, reversed:
    # decoder does q rounds of states 0..3, then the remainder on 3.
    for i in range(n - 1, 4 * q - 1, -1):
        _enc(3, raw[i - 1] if i > starts[3] else 0, raw[i])
    for i in range(q - 1, -1, -1):
        for j in (3, 2, 1, 0):
            p = starts[j] + i
            _enc(j, raw[p - 1] if i > 0 else 0, raw[p])
    body = struct.pack("<4I", *states) + bytes(reversed(rev))
    return bytes(table) + body


# ---------------------------------------------------------------- public


def decode(data: bytes) -> bytes:
    """Decompress one rANS 4x8 block (9-byte prefix + payload)."""
    if len(data) < 9:
        raise ValueError("rANS block shorter than its 9-byte prefix")
    order = data[0]
    comp_size, raw_size = struct.unpack_from("<II", data, 1)
    if len(data) < 9 + comp_size:
        raise ValueError("rANS block truncated")
    if raw_size == 0:
        return b""
    out = _decode_native(data, raw_size)
    if out is not None:
        return out
    if order == 0:
        return _decode0(data, 9, raw_size)
    if order == 1:
        return _decode1(data, 9, raw_size)
    raise ValueError(f"rANS order {order} not supported (0|1)")


def _decode_native(data: bytes, raw_size: int):
    """native/chunker.cpp jf_rans_decode fast path; None -> fall back
    to the pure-python reference path (which raises exact errors)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    buf = ctypes.create_string_buffer(raw_size)
    n = lib.jf_rans_decode(data, len(data), buf, raw_size)
    if n != raw_size:
        return None
    return buf.raw


def encode(raw: bytes, order: int = 0) -> bytes:
    """Compress to one rANS 4x8 block (9-byte prefix + payload)."""
    if order not in (0, 1):
        raise ValueError("rANS order must be 0 or 1")
    if len(raw) == 0:
        payload = b""
    elif order == 0 or len(raw) < 4:
        order = 0
        payload = _encode0(raw)
    else:
        payload = _encode1(raw)
    return bytes([order]) + struct.pack("<II", len(payload), len(raw)) \
        + payload
