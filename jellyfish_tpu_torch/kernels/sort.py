"""Merge sort of key rows on the kernels: K3 block sort, then K1 passes.

The counterpart of the `lax.sort` of multi-limb keys in
jellyfish_tpu/ops/count.py. ops/count.sort_rows takes this route for
every key width above one column, on every device: on the CPU the
kernels' plain versions run the same pass loop.
"""

from __future__ import annotations

from jellyfish_tpu_torch.kernels.bitonic import block_sort, tile_rows
from jellyfish_tpu_torch.kernels.merge_path import merge_pass

__all__ = ["sort_rows_blocked"]


def sort_rows_blocked(keys, payload=None, tile=None):
    """Ascending sort of key rows [M, Wk] -> (keys, payload or None).

    block_sort sorts tiles of `tile` rows (default tile_rows(Wk, payload):
    one tile in shared memory), then ceil(log2(M / tile)) merge passes
    double the sorted runs. Each pass writes a new buffer and drops the
    one it read, which the caching allocator hands to the next pass: two
    buffers ping-pong. Both steps compare the key, then the payload in the
    block sort, and the merges keep the earlier run first on ties, so a
    row-index payload makes the sort stable and comes out as the perm."""
    m, wk = keys.shape
    tile = tile or tile_rows(wk, payload is not None)
    keys, payload = block_sort(keys, payload, tile)
    run = tile
    while run < m:
        keys, payload = merge_pass(keys, run, payload)
        run *= 2
    return keys, payload
