"""Bit-packed resting runs (the counterpart of
jellyfish_tpu/ops/packed_run.py, `count --packed-store`).

A finalized run (sorted, each key once, dense) is held as:

  - a u32 BITSTREAM of fixed-width records: the (2k - p) low key bits,
    then `cbits` count bits, LSB first, record i at bit i * width (the top
    p key bits are implied by the bucket, below);
  - a BUCKET INDEX [2^p + 1]: entry e is the number of keys whose top p
    bits are below e (the PAD entry is clamped into the last bucket);
  - an ESCAPE list for counts >= 2^cbits - 1: positions (0xFFFFFFFF past
    the n_esc used slots) and the counts' low and high 32 bits.

The stream, the index, p, cbits, esc_pos and the first n_esc entries of
esc_lo/esc_hi are bit-equal to the JAX function's for the same run.
Buffers hold u32 bit patterns in int32 tensors, so a packed run takes on
the device what device_bytes reports.

The JAX package builds a [rows, width] bit matrix and folds it 32 bits at
a time. Here each record's field is cut into 32-bit pieces, and each piece
is added, shifted, into the two stream words it spans (`index_add_`;
fields never overlap, so adding is or-ing). Unpack gathers the same two
words and shifts back, with no host sync (pack syncs once, for the
number of escapes). Both work in slices of _SLICE rows, so their
temporaries stay a few times the packed size (PERF.md states the peak).

Keys come and go as store key columns (ops/multiword.py): one int64
column u64 ^ 2^63 for 2k <= 64, else the limbs. They are converted to
limbs before any shift. The port keeps a real all-ones key apart from the
PAD key where the JAX package merges them (W = 1, and W = 2 below 2k =
64); both pack to the same record, so a PackedRun keeps its last two key
rows as they were (`tail`) and unpack writes them back.
"""

from __future__ import annotations

import torch

from jellyfish_tpu_torch.ops import multiword as mw

__all__ = ["PackedRun", "pack_run", "unpack_run", "packed_nbytes",
           "default_p"]

M32 = mw.M32
_SLICE = 1 << 22  # rows a slice of the pack and unpack loops
_CBITS = 7  # count bits in a record: counts below 127 need no escape


class PackedRun:
    """A packed resting run: device buffers and its shape parameters."""

    __slots__ = ("stream", "index", "esc_pos", "esc_lo", "esc_hi", "n",
                 "key_bits", "p", "cbits", "W", "tail")

    def __init__(self, stream, index, esc_pos, esc_lo, esc_hi, n,
                 key_bits, p, cbits, W, tail):
        self.stream = stream
        self.index = index
        self.esc_pos = esc_pos
        self.esc_lo = esc_lo
        self.esc_hi = esc_hi
        self.n = int(n)
        self.key_bits = int(key_bits)
        self.p = int(p)
        self.cbits = int(cbits)
        self.W = int(W)
        self.tail = tail

    def device_bytes(self) -> int:
        """The five buffers at 4 bytes an element, as in the JAX package
        (the two tail rows are left out)."""
        return 4 * sum(x.numel() for x in (
            self.stream, self.index, self.esc_pos, self.esc_lo,
            self.esc_hi))


def default_p(n: int, key_bits: int) -> int:
    """The implied-prefix width: about log2(n) - 4, in [1, 20] and below
    key_bits (the index then costs about 2 bits in 32 entries)."""
    return min(20, key_bits - 1, max(1, max(n, 2).bit_length() - 5))


def _u32(x):
    """int64 values 0 .. 2^32-1 -> int32 tensor of the same bit pattern."""
    return x.to(torch.int32)


def _i64(x):
    """int32 bit pattern -> int64 values 0 .. 2^32-1."""
    return x.to(torch.int64) & M32


def pack_run(keys, counts, key_bits: int) -> PackedRun:
    """Pack a finalized run: keys [n, Wk] store key columns ascending,
    counts [n] int64. p is default_p(n, key_bits) and cbits 7; the escape
    list starts at max(1024, n // 64) slots and, when it overflows, takes
    four times as many, up to n (the JAX function's retry)."""
    n = keys.shape[0]
    p, cbits = default_p(n, key_bits), _CBITS
    W = mw.nwords(key_bits)
    low = key_bits - p            # key bits stored in the stream
    width = low + cbits
    F = mw.nwords(width)          # 32-bit pieces of a record's field
    esc_max = (1 << cbits) - 1
    dev = keys.device
    n_words = (n * width + 31) // 32
    stream = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
    hist = torch.zeros(1 << p, dtype=torch.int64, device=dev)
    for a in range(0, n, _SLICE):
        b = min(n, a + _SLICE)
        limbs = mw.limbs_of_key_columns(keys[a:b], W)
        top = mw.mw_shift_right(limbs, low)[:, 0].clamp_(max=(1 << p) - 1)
        hist += torch.bincount(top, minlength=1 << p)
        cfield = counts[a:b].clamp(max=esc_max)
        field = mw.mw_or(mw.mw_and_mask_top(limbs, low),
                         mw.mw_shift_left(cfield[:, None], low, W_out=F))
        off = torch.arange(a, b, dtype=torch.int64, device=dev) * width
        for j in range(F):
            o = off + 32 * j
            w, s = o >> 5, o & 31
            v = field[:, j]
            stream.index_add_(0, w, (v << s) & M32)
            stream.index_add_(0, w + 1, v >> (32 - s))
    index = torch.zeros((1 << p) + 1, dtype=torch.int64, device=dev)
    index[1:] = torch.cumsum(hist, 0)

    pos = torch.nonzero(counts[:n] >= esc_max).squeeze(1)
    n_esc = pos.numel()
    esc_cap = min(max(1024, n // 64), max(n, 1))
    while n_esc > esc_cap:
        esc_cap = min(4 * esc_cap, n)
    esc_pos = torch.full((esc_cap,), M32, dtype=torch.int64, device=dev)
    esc_pos[:n_esc] = pos
    big = counts[pos]
    esc_lo = torch.zeros(esc_cap, dtype=torch.int64, device=dev)
    esc_hi = torch.zeros(esc_cap, dtype=torch.int64, device=dev)
    esc_lo[:n_esc] = big & M32
    esc_hi[:n_esc] = big >> 32
    return PackedRun(_u32(stream[:n_words]), _u32(index), _u32(esc_pos),
                     _u32(esc_lo), _u32(esc_hi), n, key_bits, p, cbits, W,
                     keys[max(0, n - 2):n].clone())


def unpack_run(run: PackedRun):
    """Inverse of pack_run: (keys [n, Wk] store key columns, counts [n]
    int64), ascending."""
    n, W, p, cbits = run.n, run.W, run.p, run.cbits
    low = run.key_bits - p
    width = low + cbits
    F = mw.nwords(width)
    dev = run.stream.device
    stream = torch.cat([_i64(run.stream),
                        torch.zeros(1, dtype=torch.int64, device=dev)])
    index = _i64(run.index)
    keys = torch.empty((n, 1 if mw.packs(W) else W), dtype=torch.int64,
                       device=dev)
    # a spare last row takes the unused escape slots (below)
    counts = torch.empty(n + 1, dtype=torch.int64, device=dev)
    for a in range(0, n, _SLICE):
        b = min(n, a + _SLICE)
        i = torch.arange(a, b, dtype=torch.int64, device=dev)
        pieces = []
        for j in range(F):
            o = i * width + 32 * j
            w, s = o >> 5, o & 31
            v = (stream[w] >> s) | ((stream[w + 1] << (32 - s)) & M32)
            pieces.append(v & ((1 << min(32, width - 32 * j)) - 1))
        field = torch.stack(pieces, dim=1)
        lowk = mw.mw_and_mask_top(mw.mw_shift_right(field, 0, W_out=W), low)
        counts[a:b] = (mw.mw_shift_right(field, low, W_out=1)[:, 0]
                       & ((1 << cbits) - 1))
        bucket = torch.searchsorted(index, i, right=True) - 1
        topk = mw.mw_shift_left(bucket[:, None], low, W_out=W)
        keys[a:b] = mw.key_columns(mw.mw_or(topk, lowk))
    # escapes: the exact counts over the sentinel fields; the unused slots
    # (position 0xFFFFFFFF) go to the spare row and are dropped, as the
    # JAX function's scatter drops them (no host sync)
    counts.index_put_((_i64(run.esc_pos).clamp(max=n),),
                      _i64(run.esc_lo) | (_i64(run.esc_hi) << 32))
    keys[n - run.tail.shape[0]:] = run.tail
    return keys, counts[:n]


def packed_nbytes(n: int, key_bits: int, cbits: int = _CBITS,
                  esc: int = 0) -> int:
    """Bytes to hold n entries packed (the `mem --packed` model; the
    dense-sorted analogue of the reference's 2^l*(2k-l+r+1)/8,
    large_hash_array.hpp:106-115)."""
    p = default_p(n, key_bits)
    width = key_bits - p + cbits
    stream = (n * width + 31) // 32 * 4
    index = ((1 << p) + 1) * 4
    return stream + index + esc * 12
