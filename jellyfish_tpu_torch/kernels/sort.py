"""Sorts of key rows on the kernels.

`sort_rows_blocked`: K3 block sort, then K1 passes. The counterpart of the
`lax.sort` of multi-limb keys in jellyfish_tpu/ops/count.py.
ops/count.sort_rows takes this route for every key width above one
column, on every device: on the CPU the kernels' plain versions run the
same pass loop.

`sort_pairs_bitonic`: K3 only, key rows with a carried payload. The
counterpart of the (id, seq) sort with the values carried in
jellyfish_tpu/ops/bitsarray.py (BitsArray's batch updates, its only path).
One block sort (row 6), then per doubling the cross-tile steps
(kernel-table row 8: compare the key, carry the payload, with row 12's
flip fused into the first step) and the in-tile steps by block_merge (row
8's rule on chip). The Bloom-counter insert, the counterpart of
`lax.sort([pos, wb], num_keys=1)` in jellyfish_tpu/bloom.py, took this
route until it moved to the radix sort of kernels/radix.py, which sorts
only the bits a position holds and pads nothing.
"""

from __future__ import annotations

import torch

from jellyfish_tpu_torch.kernels.bitonic import (
    PAD,
    block_merge,
    block_merge_plain,
    block_sort,
    block_sort_plain,
    exchange_stages,
    exchange_stages_plain,
    tile_rows,
)
from jellyfish_tpu_torch.kernels.merge_path import merge_pass

__all__ = ["sort_rows_blocked", "merge_passes", "sort_pairs_bitonic",
           "sort_pairs_plain"]


def merge_passes(m: int, wk: int, tile=None) -> int:
    """The merge passes sort_rows_blocked makes over m rows of wk key
    columns in tiles of `tile` rows (default: the keys-only tile),
    ceil(log2(m / tile)); 0 where one tile holds them."""
    tile = tile or tile_rows(wk, False)
    return ((m - 1) // tile).bit_length() if m > 0 else 0


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
    for p in range(merge_passes(m, wk, tile=tile)):
        keys, payload = merge_pass(keys, tile << p, payload)
    return keys, payload


def _sort_pairs(keys, payload, tile, sort, steps, merge):
    m, wk = keys.shape
    tile = tile or tile_rows(wk, True)
    size = max(tile, 1 << max(m - 1, 0).bit_length())
    pad = size - m
    if pad:
        keys = torch.cat([keys, keys.new_full((pad, wk), PAD)])
        payload = torch.cat([payload, payload.new_zeros(pad)])
    keys, payload = sort(keys, payload, tile)
    run = tile
    while run < size:
        # the mirrored step at distance run places the two sorted runs of
        # each 2 run block against each other; plain steps down to one
        # tile leave each tile a bitonic sequence among its neighbours,
        # which the in-tile steps at tile/2, ..., 1 finish
        dist = [run]
        while dist[-1] > tile:
            dist.append(dist[-1] // 2)
        keys, payload = steps(keys, payload, dist, mirror=True)
        keys, payload = merge(keys, payload, tile)
        run *= 2
    return keys[:m], payload[:m]


def sort_pairs_bitonic(keys, payload, tile=None):
    """Ascending sort of key rows [M, Wk] with an int64 payload [M] carried
    -> (keys, payload).

    M is padded with PAD rows of payload 0 to a power of two of at least
    one tile (`tile`, default tile_rows(Wk, True): 4096 rows at Wk 1).
    block_sort (row 6) sorts each tile; then for each run length L = tile,
    2 tile, ..., one exchange_stages call (row 8's steps: the mirrored
    step at L, plain steps at L/2, ..., tile) and one block_merge (the
    plain steps at tile/2, ..., 1 inside each tile) double the sorted
    runs. The padding is cut off. Keys must sort below the PAD row
    (INT64_MAX in every column). Equal keys come out in no particular
    order (block_sort compares the payload after the key, the exchange
    and merge steps do not), like `lax.sort(..., is_stable=False)`: every
    consumer folds over equal keys. On CPU tensors the wrappers run their
    plain versions, so this is sort_pairs_plain."""
    return _sort_pairs(keys, payload, tile, block_sort, exchange_stages,
                       block_merge)


def sort_pairs_plain(keys, payload, tile=None):
    """sort_pairs_bitonic's loop on the plain versions of the kernels, on
    any device: the reference the card's route is held against."""
    return _sort_pairs(keys, payload, tile, block_sort_plain,
                       exchange_stages_plain, block_merge_plain)
