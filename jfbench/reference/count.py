"""The plain count that decides `correct`, and its control.

Plain PyTorch, on any device. It imports nothing of the program and
takes nothing the program made: it works the table out from the read
codes that the traffic generator makes from the seed.

A mer is held as C columns of int64, each the big-endian base-4 value of
an equal share of its k bases (k = 21: one column of 21 bases; k = 63:
three). The order of rows (column 0 first) is the order of the mers. The
canonical mer is the smaller of a window and its reverse complement.

Rows are spread over P parts by a hash of the mer, so that each part is
sorted and compared on its own and the largest sort stays small.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["spans", "canonical_columns", "part_of", "Reference",
           "columns_of_limbs", "table_columns", "diff_rows",
           "fingerprint_table"]

_MIX = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64


def spans(k: int):
    """[(first base, end base)] of each column: ceil(k / 31) columns of
    equal share, so that a column holds at most 62 bits."""
    c = -(-k // 31)
    edges = [round(i * k / c) for i in range(c + 1)]
    return list(zip(edges[:-1], edges[1:]))


def canonical_columns(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Codes [n, L] (0-3 bases, 4 N) -> the canonical columns [m, C] of
    every window that holds no N, each chunk on its own."""
    n, L = codes.shape
    N = L - k + 1
    x = codes.to(torch.int64)
    b = x & 3
    bad = (x > 3).to(torch.int32)
    cs = torch.nn.functional.pad(torch.cumsum(bad, dim=1, dtype=torch.int32),
                                 (1, 0))
    valid = (cs[:, k:] - cs[:, :N]) == 0
    del bad, cs, x
    fwd, rc = [], []
    for s, e in spans(k):
        f = torch.zeros((n, N), dtype=torch.int64, device=codes.device)
        r = torch.zeros_like(f)
        for j in range(s, e):
            f.mul_(4).add_(b[:, j:j + N])
            # base j of the reverse complement is the complement of base
            # k - 1 - j of the window
            r.mul_(4).add_(3 - b[:, k - 1 - j:k - 1 - j + N])
        fwd.append(f[valid])
        rc.append(r[valid])
        del f, r
    fwd = torch.stack(fwd, dim=1)
    rc = torch.stack(rc, dim=1)
    # lexicographic fwd <= rc, column 0 first
    le = torch.ones(fwd.shape[0], dtype=torch.bool, device=fwd.device)
    for c in reversed(range(fwd.shape[1])):
        le = (fwd[:, c] < rc[:, c]) | ((fwd[:, c] == rc[:, c]) & le)
    return torch.where(le[:, None], fwd, rc)


def part_of(cols: torch.Tensor, parts: int) -> torch.Tensor:
    """The part [m] of each row, from a multiplicative hash."""
    h = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for c in range(cols.shape[1]):
        h = (h ^ cols[:, c]) * _MIX
    return (h >> 40) & (parts - 1)


def _lex_order(cols: torch.Tensor) -> torch.Tensor:
    """Row order of cols [m, C] ascending, column 0 most significant."""
    order = torch.sort(cols[:, -1], stable=True).indices
    for c in reversed(range(cols.shape[1] - 1)):
        o = torch.sort(cols[order, c], stable=True).indices
        order = order[o]
    return order


def _count_rows(cols: torch.Tensor):
    """Rows [m, C] -> (their distinct rows ascending, counts) int64."""
    if cols.shape[1] == 1:
        u, c = torch.unique(cols[:, 0], sorted=True, return_counts=True)
        return u[:, None], c.to(torch.int64)
    s = cols[_lex_order(cols)]
    change = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    change[1:] = (s[1:] != s[:-1]).any(dim=1)
    starts = torch.nonzero(change).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([s.shape[0]])])
    return s[starts], ends - starts


class Reference:
    """The reference's table of one job, in P parts: parts[p] = (rows
    [u, C], counts [u])."""

    def __init__(self, k: int, parts: int, tables):
        self.k = k
        self.parts = parts
        self.tables = tables

    @classmethod
    def count(cls, code_blocks, k: int, parts: int) -> "Reference":
        """Count every valid window of the code blocks (an iterable of
        codes [n, L])."""
        buckets = [[] for _ in range(parts)]
        for codes in code_blocks:
            cols = canonical_columns(codes, k)
            p = part_of(cols, parts)
            for i in range(parts):
                buckets[i].append(cols[p == i])
            del cols, p
        tables = []
        for i in range(parts):
            rows = torch.cat(buckets[i])
            buckets[i] = None
            tables.append(_count_rows(rows))
            del rows
        return cls(k, parts, tables)

    def rows(self) -> int:
        return sum(int(c.shape[0]) for _, c in self.tables)

    def mers(self) -> int:
        return sum(int(c.sum()) for _, c in self.tables)

    def diff(self, cols: torch.Tensor, counts: torch.Tensor) -> int:
        """Rows in which a table (cols [n, C], counts [n]) and this one
        differ: rows of either that the other does not hold with the same
        count."""
        p = part_of(cols, self.parts)
        total = 0
        for i, (rc, cc) in enumerate(self.tables):
            m = p == i
            total += diff_rows(cols[m], counts[m], rc, cc)
        return total


def diff_rows(a_cols, a_counts, b_cols, b_counts) -> int:
    """The number of (mer, count) rows of A not matched by a row of B,
    plus those of B not matched by A (a multiset difference)."""
    rows = torch.cat([torch.cat([a_cols, a_counts[:, None]], dim=1),
                      torch.cat([b_cols, b_counts[:, None]], dim=1)])
    side = torch.cat([torch.zeros(a_cols.shape[0], dtype=torch.int64,
                                  device=rows.device),
                      torch.ones(b_cols.shape[0], dtype=torch.int64,
                                 device=rows.device)])
    if rows.shape[0] == 0:
        return 0
    order = _lex_order(rows)
    s, side = rows[order], side[order]
    change = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    change[1:] = (s[1:] != s[:-1]).any(dim=1)
    group = torch.cumsum(change.to(torch.int64), 0) - 1
    g = int(group[-1]) + 1
    nb = torch.zeros(g, dtype=torch.int64, device=s.device)
    nb.index_add_(0, group, side)
    na = torch.bincount(group, minlength=g) - nb
    matched = torch.minimum(na, nb).sum()
    return int(s.shape[0] - 2 * matched)


def columns_of_limbs(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """Mers as little-endian 32-bit limbs [n, W] (int64 values) of the
    2k-bit big-endian base-4 value -> columns [n, C]."""
    out = []
    for s, e in spans(k):
        lo, width = 2 * (k - e), 2 * (e - s)
        col = torch.zeros(limbs.shape[0], dtype=torch.int64,
                          device=limbs.device)
        for w in range(limbs.shape[1]):
            a, z = 32 * w, 32 * w + 32  # bits of limb w
            if z <= lo or a >= lo + width:
                continue
            part = limbs[:, w] & 0xFFFFFFFF
            if a < lo:
                part = part >> (lo - a)
                col |= part & ((1 << width) - 1)
            else:
                col |= (part << (a - lo)) & ((1 << width) - 1)
        out.append(col)
    return torch.stack(out, dim=1)


def table_columns(mers: np.ndarray, counts: np.ndarray, k: int, device):
    """A table as the program gives it on the host (mer limbs [n, W]
    uint32, counts [n] uint64) -> (columns [n, C], counts [n]) int64 on
    the device."""
    limbs = torch.from_numpy(np.ascontiguousarray(mers).view(np.int32))
    limbs = limbs.to(device).to(torch.int64) & 0xFFFFFFFF
    cols = columns_of_limbs(limbs, k)
    del limbs
    c = torch.from_numpy(counts.view(np.int64)).to(device)
    return cols, c


def fingerprint_table(ref: Reference, bits: int = 32):
    """The control: the plain count with each mer's identity held in a
    `bits`-bit fingerprint. Mers whose fingerprints collide are counted
    as one, under the smallest of them. Returns (columns, counts) in the
    form of a program's table."""
    cols = torch.cat([r for r, _ in ref.tables])
    counts = torch.cat([c for _, c in ref.tables])
    h = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for c in range(cols.shape[1]):
        h = (h ^ cols[:, c]) * _MIX
        h = h ^ ((h >> 29) & ((1 << 35) - 1))
    fp = h & ((1 << bits) - 1)
    order = _lex_order(cols)
    cols, counts, fp = cols[order], counts[order], fp[order]
    o = torch.sort(fp, stable=True).indices
    cols, counts, fp = cols[o], counts[o], fp[o]
    first = torch.ones(fp.shape[0], dtype=torch.bool, device=fp.device)
    first[1:] = fp[1:] != fp[:-1]
    group = torch.cumsum(first.to(torch.int64), 0) - 1
    summed = torch.zeros(int(group[-1]) + 1 if len(group) else 0,
                         dtype=torch.int64, device=fp.device)
    summed.index_add_(0, group, counts)
    return cols[first], summed
