"""The yardstick's arithmetic: the chip's peak and the bytes a call must
move, from its shapes.

A frozen copy of the arithmetic of PERF.md's kernel table: each input
byte read once and each output byte written once, rows of int64 key
columns and, where a call carries them, int64 counts or payload.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "BYTES"]

PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet


def _rows(t) -> int:
    return int(t.shape[0])


def _cols(t) -> int:
    return int(t.shape[1]) if t.dim() > 1 else 1


def sort_rows_bytes(args, kwargs, result) -> int:
    """ops/count.sort_rows(keys [M, Wk]) -> keys: read and write the keys."""
    keys = args[0]
    return 2 * 8 * _rows(keys) * _cols(keys)


def merge_path_bytes(args, kwargs, result) -> int:
    """K1 merge_path(A keys, A counts, B keys, B counts) -> (keys,
    counts): read both runs, write the merged one."""
    a_keys, _, b_keys, _ = args[:4]
    row = 8 * (_cols(a_keys) + 1)
    return 2 * row * (_rows(a_keys) + _rows(b_keys))


def merge_pass_bytes(args, kwargs, result) -> int:
    """K1 merge_pass(keys, run_len, payload=None): read and write every
    row, with its payload if any."""
    keys = args[0]
    payload = args[2] if len(args) > 2 else kwargs.get("payload")
    row = 8 * (_cols(keys) + (payload is not None))
    return 2 * row * _rows(keys)


def block_sort_bytes(args, kwargs, result) -> int:
    """K3 block_sort(keys, payload=None, tile=None): read and write every
    row, with its payload if any."""
    keys = args[0]
    payload = args[1] if len(args) > 1 else kwargs.get("payload")
    row = 8 * (_cols(keys) + (payload is not None))
    return 2 * row * _rows(keys)


def compact_bytes(args, kwargs, result) -> int:
    """K2 compact(keys, counts, keep=None) -> (keys, counts, n): read
    every row (and the keep mask), write the kept rows."""
    keys = args[0]
    keep = args[2] if len(args) > 2 else kwargs.get("keep")
    row = 8 * (_cols(keys) + 1)
    return (row * _rows(keys) + row * int(result[2])
            + (0 if keep is None else _rows(keys)))


BYTES = {
    "sort_rows": sort_rows_bytes,
    "merge_path": merge_path_bytes,
    "merge_pass": merge_pass_bytes,
    "block_sort": block_sort_bytes,
    "compact": compact_bytes,
}
