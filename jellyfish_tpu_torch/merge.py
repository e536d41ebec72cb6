"""K-way merge of sorted databases (the counterpart of
jellyfish_tpu/merge.py, jellyfish/merge_files.cc).

Databases made with the same matrix and size are all sorted by (pos, key),
which is the order of the store's sortkeys (ops/hashing.py). Binary
databases merge on the device in streaming rounds; text databases take the
JAX package's record-streaming heap merge on the host (copied). Semantics
are the reference's: SUM, MIN (a key absent from an input counts 0), MAX
and JACCARD, then the [min_count, max_count] filter, counts compared as
unsigned 64-bit values.

The device route, per input: the host reads and decodes blocks of records
into key limbs and uploads them into the input's device buffer (its slab
of SLAB_ROWS rows), where ops/hashing.sortkey_of_mers turns them into store
key columns. Each round, for every input that still holds rows:

  1. kernels/window.window_rows (kernel-table row 9) copies the
     WINDOW_ROWS rows at the input's cursor, a device scalar, out of the
     slab;
  2. the frontier is the least of the last window rows of the inputs that
     may still hold unseen rows (rows past their window, or in the file);
     an input's take is its window's live rows <= frontier, so no later
     row of any input can precede a taken one and, since a key occurs at
     most once per input, every key's rows are taken in the same round;
  3. the takes are merged pairwise by K1 merge_path (equal keys adjacent),
     segments reduced by the op in plain PyTorch, the filter applied, and
     K2 keeps each segment's first row by a keep mask (a merged value may
     be 0);
  4. sortkeys turn back into mers on the device; the host encodes and
     writes the records.

When an input's unread rows no longer hold a full window, and its file
holds more, kernels/window.roll_lanes (row 10) rotates the slab by -cursor,
so the unread rows come first, and the host reads the freed tail from the
file. The window bounds a round's device memory, the slab the reads.
"""

from __future__ import annotations

import heapq
import os
import time
from enum import Enum

import numpy as np
import torch

from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.io.files import (
    DBReader,
    encode_binary_records_np,
    write_text_records,
)
from jellyfish_tpu_torch.io.header import FileHeader
from jellyfish_tpu_torch.kernels.compact import compact
from jellyfish_tpu_torch.kernels.merge_path import merge_path
from jellyfish_tpu_torch.kernels.window import roll_lanes, window_rows
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.count import row_order
from jellyfish_tpu_torch.ops.hashing import (
    inverse_masks_of_matrix,
    masks_of_matrix,
    mers_of_sortkeys,
    sortkey_of_mers,
)

__all__ = ["MergeOp", "merge_files", "MergeError", "WINDOW_ROWS",
           "SLAB_ROWS"]

WINDOW_ROWS = 1 << 20  # rows of each input a round sees (the JAX block)
SLAB_ROWS = 1 << 24    # rows of each input's device buffer

_U64 = (1 << 64) - 1
_SIGN = -(1 << 63)


class MergeError(RuntimeError):
    pass


class MergeOp(Enum):
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    JACCARD = "jaccard"


def _signed(v: int) -> int:
    """The int64 whose signed order is the unsigned order of the u64 v."""
    s = (v & _U64) ^ (1 << 63)
    return s - (1 << 64) if s >= 1 << 63 else s


def _rows_le(rows, bound):
    """rows [B, Wk] <= bound [Wk], rows compared from the last column."""
    lt = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    eq = torch.ones_like(lt)
    for w in range(rows.shape[1] - 1, -1, -1):
        lt |= eq & (rows[:, w] < bound[w])
        eq &= rows[:, w] == bound[w]
    return lt | eq


class _Slab:
    """One input's device buffer: rows [0, loaded) hold the file's records
    from the one at `cursor` (a host int, mirrored on the device in
    `cur`) on, as store key columns beside their counts."""

    def __init__(self, reader: DBReader, rows: int, W: int, masks, k: int,
                 lsize: int, read_block: int, dev):
        self.reader = reader
        self.W, self.masks, self.k, self.lsize = W, masks, k, lsize
        self.read_block = read_block
        size = os.fstat(reader.f.fileno()).st_size - reader.header.offset
        self.left = size // reader._rec_len  # records not read yet
        rows = max(1, min(rows, self.left))
        wk = 1 if mw.packs(W) else W
        self.keys = torch.empty((rows, wk), dtype=torch.int64, device=dev)
        self.cnt = torch.empty(rows, dtype=torch.int64, device=dev)
        self.loaded = 0
        self.cursor = 0
        self.cur = torch.zeros((), dtype=torch.int64, device=dev)
        self.rolls = 0
        self.read_s = 0.0  # host seconds reading and decoding records

    @property
    def unread(self) -> int:
        return self.loaded - self.cursor

    def fill(self) -> None:
        """Read records from the file into the free tail of the slab."""
        dev = self.keys.device
        while self.left and self.loaded < self.keys.shape[0]:
            n = min(self.keys.shape[0] - self.loaded, self.left,
                    self.read_block)
            t = time.perf_counter()
            key_bytes, counts = self.reader.read_records_np(n)
            if len(counts) != n:
                raise MergeError(f"{self.reader.path}: truncated database")
            buf = np.zeros((n, 4 * self.W), dtype=np.uint8)
            buf[:, :key_bytes.shape[1]] = key_bytes
            limbs = torch.from_numpy(buf.view(np.int32).reshape(n, self.W))
            self.read_s += time.perf_counter() - t
            limbs = limbs.to(dev).to(torch.int64) & mw.M32
            sk = sortkey_of_mers(limbs, self.masks, self.k, self.lsize)
            rows = slice(self.loaded, self.loaded + n)
            self.keys[rows] = mw.key_columns(sk)
            self.cnt[rows] = torch.from_numpy(counts.view(np.int64)).to(dev)
            self.loaded += n
            self.left -= n

    def roll(self) -> None:
        """Rotate the slab by -cursor: the unread rows come first."""
        wk = self.keys.shape[1]
        self.keys = roll_lanes(self.keys.view(1, -1),
                               self.cur * -wk).view(-1, wk)
        self.cnt = roll_lanes(self.cnt.view(1, -1), -self.cur).view(-1)
        self.loaded -= self.cursor
        self.cursor = 0
        self.cur.zero_()
        self.rolls += 1


def _merge_runs(runs):
    """Merge sorted (keys, counts) runs pairwise with K1, no fold."""
    while len(runs) > 1:
        nxt = [merge_path(*runs[i], *runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _reduce(keys, cnt, op, nb_files):
    """Segments of equal adjacent keys -> (is_new [T] bool: the segment's
    first row, value [T] int64 on every row of its segment, min and max
    for JACCARD or None)."""
    T = keys.shape[0]
    is_new = torch.ones(T, dtype=torch.bool, device=keys.device)
    is_new[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    seg = torch.cumsum(is_new, 0) - 1
    zeros = torch.zeros(T, dtype=torch.int64, device=keys.device)

    def ureduce(how):
        # unsigned order is the signed order of the values ^ 2^63
        return (zeros.scatter_reduce(0, seg, cnt ^ _SIGN, how,
                                     include_self=False) ^ _SIGN)[seg]

    if op is MergeOp.SUM:
        return is_new, zeros.index_add(0, seg, cnt)[seg], None
    full = zeros.index_add(0, seg, torch.ones_like(cnt))[seg] == nb_files
    if op is MergeOp.MAX:
        return is_new, ureduce("amax"), None
    mins = torch.where(full, ureduce("amin"), 0)
    if op is MergeOp.MIN:
        return is_new, mins, None
    return is_new, None, (mins, ureduce("amax"))


def _merge_binary_device(readers, out_file, out_header, min_count, max_count,
                         op, k, size, out_counter_len, dev):
    """Streaming k-way merge of sorted binary DBs on `dev` (see the module
    docstring). Returns the run's counts: records in and out, rounds, slab
    rotations, and the host seconds spent reading and decoding records
    (read_s) and encoding and writing them (write_s)."""
    nb_files = len(readers)
    lsize = max(0, (size - 1).bit_length())
    c = 2 * k
    W = mw.nwords(c)
    matrix = readers[0].matrix
    if matrix.is_identity() or (matrix.is_low_identity() and lsize == c):
        masks = inv_masks = None
    else:
        masks = masks_of_matrix(matrix, W)
        inv_masks = inverse_masks_of_matrix(matrix, W)
    window = WINDOW_ROWS
    slabs = [_Slab(r, SLAB_ROWS, W, masks, k, lsize, window, dev)
             for r in readers]
    records_in = sum(s.left for s in slabs)
    lo, hi = _signed(min_count), _signed(max_count)
    idx = torch.arange(window, device=dev)
    stats = dict(records_in=records_in, records_out=0, rounds=0,
                 write_s=0.0)
    jaccard = {"inter": 0, "winter": 0, "union": 0, "wunion": 0}
    with open(out_file, "wb") as out:
        if op is not MergeOp.JACCARD:
            out_header.format = FileHeader.FORMAT_BINARY
            out_header.counter_len = out_counter_len
            out_header.write(out)
        while active := [s for s in slabs if s.unread or s.left]:
            for s in active:
                if s.left and s.unread < window:
                    if s.cursor:
                        s.roll()
                    s.fill()
            wins = [window_rows(s.keys[:s.loaded], s.cnt[:s.loaded], s.cur,
                                window) for s in active]
            live = [min(window, s.unread) for s in active]
            # an input whose window may not hold all its remaining rows
            # bounds the round by its window's last row
            bound = [w[0][-1] for s, w in zip(active, wins)
                     if s.left or s.unread > window]
            if bound:
                last = torch.stack(bound)
                frontier = last[row_order(last)[0]]
                # a window's fill rows carry the PAD key, which a real row
                # may equal: a take stops at the live rows
                m = torch.stack([
                    (_rows_le(w[0], frontier) & (idx < n)).sum()
                    for w, n in zip(wins, live)]).tolist()
            else:
                m = live
            for s, n in zip(active, m):
                s.cursor += n
                s.cur += n
            stats["rounds"] += 1
            runs = [(w[0][:n], w[1][:n]) for w, n in zip(wins, m) if n]
            del wins
            if not runs:
                continue
            keys, cnt = _merge_runs(runs)
            del runs
            is_new, vals, jac = _reduce(keys, cnt, op, nb_files)
            if op is MergeOp.JACCARD:
                mins, maxs = jac
                sums = torch.stack([
                    (is_new & (mins != 0)).sum(),
                    torch.where(is_new, mins, 0).sum(),
                    is_new.sum(),
                    torch.where(is_new, maxs, 0).sum()]).tolist()
                for key, v in zip(("inter", "winter", "union", "wunion"),
                                  sums):
                    jaccard[key] += v & _U64
                continue
            u = vals ^ _SIGN
            keep = is_new & (u >= lo) & (u <= hi)
            keys, vals, n = compact(keys, vals, keep)
            if not n:
                continue
            limbs = mw.limbs_of_key_columns(keys, W)
            mers = mers_of_sortkeys(limbs, inv_masks, k, lsize)
            mers = mers.to(torch.int32).cpu().numpy().view(np.uint32)
            vals = vals.cpu().numpy().view(np.uint64)
            t = time.perf_counter()
            out.write(encode_binary_records_np(mers, vals, k,
                                               out_counter_len))
            stats["write_s"] += time.perf_counter() - t
            stats["records_out"] += n
        if op is MergeOp.JACCARD:
            union = max(jaccard["union"], 1)
            wunion = max(jaccard["wunion"], 1)
            out.write(
                f"Jaccard  {jaccard['inter'] / union}\n"
                f"wJaccard {jaccard['winter'] / wunion}\n".encode()
            )
    stats["rolls"] = [s.rolls for s in slabs]
    stats["read_s"] = sum(s.read_s for s in slabs)
    return stats


def _stream(reader: DBReader, matrix, mask):
    for key, val in reader:
        pos = matrix.times(key) & mask
        yield (pos, key, val)


def _merge_text(readers, out_file, out_header, min_count, max_count, op, k,
                mask, fmt):
    """The host heap merge of text databases (jellyfish_tpu/merge.py)."""
    nb_files = len(readers)
    merged = heapq.merge(*[_stream(r, r.matrix, mask) for r in readers])

    def groups():
        cur = None
        vals = []
        for pos, key, val in merged:
            if cur is None or key != cur:
                if cur is not None:
                    yield cur, vals
                cur, vals = key, [val]
            else:
                vals.append(val)
        if cur is not None:
            yield cur, vals

    with open(out_file, "wb") as out:
        if op is MergeOp.JACCARD:
            inter = winter = union = wunion = 0
            for key, vals in groups():
                minc = min(vals) if len(vals) == nb_files else 0
                maxc = max(vals)
                inter += minc > 0
                winter += minc
                union += 1
                wunion += maxc
            out.write(
                f"Jaccard  {inter / union}\nwJaccard {winter / wunion}\n".encode()
            )
            return

        out_header.format = fmt
        out_header.write(out)

        def records():
            for key, vals in groups():
                if op is MergeOp.SUM:
                    v = sum(vals)
                elif op is MergeOp.MIN:
                    v = min(vals) if len(vals) == nb_files else 0
                else:
                    v = max(vals)
                if min_count <= v <= max_count:
                    yield key, v

        batch_keys, batch_vals = [], []

        def flush():
            write_text_records(out, batch_keys, batch_vals, k)
            batch_keys.clear()
            batch_vals.clear()

        for key, v in records():
            batch_keys.append(key)
            batch_vals.append(v)
            if len(batch_keys) >= 65536:
                flush()
        flush()


def merge_files(
    input_files,
    out_file: str,
    min_count: int = 0,
    max_count: int | None = None,
    op: MergeOp = MergeOp.SUM,
    out_header_extra: dict | None = None,
    device=None,
):
    """Merge databases; enforces header compatibility like
    merge_files.cc:140-151, before any device work. For JACCARD, writes
    the two similarity lines instead of a database. Binary inputs merge on
    `device` (None: the GPU, raising when there is none) in rounds of
    WINDOW_ROWS rows an input, buffered in slabs of SLAB_ROWS rows; returns
    the run's counts (records in and out, rounds, slab rotations, host
    seconds)."""
    if max_count is None:
        max_count = _U64
    readers = []
    try:
        for p in input_files:
            readers.append(DBReader(p))
        h0 = readers[0].header
        key_len = h0.key_len
        size = h0.size
        fmt = h0.format
        matrix = readers[0].matrix
        out_counter_len = h0.counter_len if fmt == FileHeader.FORMAT_BINARY else 0
        for r in readers[1:]:
            h = r.header
            if h.format != fmt:
                raise MergeError(
                    f"Can't merge files with different formats ({fmt}, {h.format})"
                )
            if h.key_len != key_len:
                raise MergeError(
                    f"Can't merge hashes of different key lengths ({key_len}, {h.key_len})"
                )
            if h.max_reprobe_offset != h0.max_reprobe_offset:
                raise MergeError("Can't merge hashes with different reprobing strategies")
            if h.size != size:
                raise MergeError(
                    f"Can't merge hash with different size ({size}, {h.size})"
                )
            if r.matrix != matrix:
                raise MergeError("Can't merge hash with different hash function")
            if fmt == FileHeader.FORMAT_BINARY:
                out_counter_len = min(out_counter_len, h.counter_len)
        dev = resolve_device(device)

        out_header = FileHeader()
        out_header.size = size
        out_header.key_len = key_len
        out_header.set_matrix(matrix)
        out_header.max_reprobe = h0.max_reprobe
        out_header.root["reprobes"] = h0.root["reprobes"]
        out_header.val_len = h0.val_len
        out_header.canonical = h0.canonical
        out_header.fill_standard()
        if out_header_extra:
            out_header.root.update(out_header_extra)

        if fmt == FileHeader.FORMAT_BINARY:
            return _merge_binary_device(
                readers, out_file, out_header, min_count, max_count, op,
                key_len // 2, size, out_counter_len, dev,
            )
        _merge_text(readers, out_file, out_header, min_count, max_count, op,
                    key_len // 2, size - 1, fmt)
        return None
    finally:
        for r in readers:
            r.close()
