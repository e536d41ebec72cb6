"""Sort + segment-length counting, and the fold that follows a merge.

The counterpart of the parts of jellyfish_tpu/ops/count.py that the store
needs. Keys are store key columns [M, Wk] int64 (ops/multiword.py): one
packed column for 2k <= 64, else limbs compared from the last column.
Counts are one int64 (the JAX package's lo/hi uint32 pair with explicit
carries was a TPU workaround).

A "masked" run is sorted by key, carries each real key's count on one row
and zero on every other row; kernels/compact.py drops the zero rows.
"""

from __future__ import annotations

import torch

__all__ = ["row_order", "sort_rows", "sort_rows_plain", "sort_passes",
           "segment_counts", "consolidate_premasked", "fold_adjacent"]


def row_order(keys, payload=None):
    """Stable ascending order of the rows of keys [..., N, Wk] along N,
    compared from the last column down and then by payload [..., N]:
    a chain of stable sorts from the least significant column upward (LSD
    radix order). Returns indices [..., N]."""
    cols = ([] if payload is None else [payload]) + list(keys.unbind(-1))
    order = None
    for c in cols:
        v = c if order is None else torch.gather(c, -1, order)
        o = torch.sort(v, dim=-1, stable=True).indices
        order = o if order is None else torch.gather(order, -1, o)
    return order


def sort_rows_plain(keys):
    """Stable ascending sort of key rows [M, Wk] -> (sorted keys, perm) by
    the LSD chain: the plain reference of the whole sort."""
    perm = row_order(keys)
    return keys[perm], perm


def sort_rows(keys):
    """Ascending sort of key rows [M, Wk] -> sorted keys [M, Wk].

    One torch.sort for a packed column. For Wk > 1, on every device,
    kernels/sort.sort_rows_blocked: the bitonic block sort (K3) on tiles,
    then merge passes (K1), keys only."""
    if keys.shape[1] == 1:
        return torch.sort(keys[:, 0]).values.unsqueeze(1)
    # imported here: the kernels import this module's plain sorts
    from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked

    return sort_rows_blocked(keys.contiguous())[0]


def sort_passes(m: int, wk: int) -> int:
    """The merge passes sort_rows makes over m rows of wk key columns: 0
    for the one torch.sort of a packed column, else those of
    kernels/sort.sort_rows_blocked."""
    if wk == 1:
        return 0
    from jellyfish_tpu_torch.kernels.sort import merge_passes

    return merge_passes(m, wk)


def _row_changes(keys):
    """[M-1] bool: row i+1 differs from row i."""
    return (keys[1:] != keys[:-1]).any(dim=1)


def consolidate_premasked(keys):
    """Sort a raw backlog of PREMASKED sortkeys and count by segment length.

    keys [M, Wk]: invalid windows already carry the PAD key, so every row
    has implicit weight 1, pads included: the PAD segment's count is the
    number of pad rows (plus one if a real key equals PAD), which the
    counter corrects at finalize from the exact pad total.

    Returns (sorted keys [M, Wk], counts [M] int64) masked: each segment's
    length sits on its LAST row, every other row has count 0."""
    s = sort_rows(keys)
    return s, segment_counts(s)


def segment_counts(s):
    """Sorted keys [M, Wk] -> counts [M] int64 masked: each run of equal
    rows' length on its LAST row, 0 on every other row."""
    M = s.shape[0]
    is_last = torch.ones(M, dtype=torch.bool, device=s.device)
    is_last[:-1] = _row_changes(s)
    # a segment's length is the distance from the previous segment's end
    ends = torch.nonzero(is_last).squeeze(1)
    counts = torch.zeros(M, dtype=torch.int64, device=s.device)
    counts[ends] = torch.diff(ends, prepend=ends.new_full((1,), -1))
    return counts


def fold_adjacent(keys, counts):
    """Sum the equal adjacent pairs that a merge of two deduplicated runs
    leaves (the role of merge_runs in the JAX package): the first row of a
    pair takes both counts, the second gets 0. Returns the new counts."""
    M = keys.shape[0]
    if M < 2:
        return counts
    eq = ~_row_changes(keys)
    nxt = torch.zeros_like(counts)
    nxt[:-1] = torch.where(eq, counts[1:], 0)
    second = torch.zeros(M, dtype=torch.bool, device=keys.device)
    second[1:] = eq
    return torch.where(second, 0, counts + nxt)
