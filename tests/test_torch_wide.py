"""The kernels' entries at key widths above 7 columns (k > 112), which run
the wide instances on the card and here, on CPU tensors, their plain
versions: block_sort, merge_pass, merge_splits and compact against a
torch.sort LSD chain written out here, and the tile geometry that the
wrappers share with the CUDA sources (csrc/merge_path.cu pass_rows,
csrc/bitonic.cu wide_tile_bytes). Exact: integer data."""

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.kernels.bitonic import block_sort, tile_rows
from jellyfish_tpu_torch.kernels.compact import compact
from jellyfish_tpu_torch.kernels.merge_path import (
    MAX_KEY_COLS,
    NARROW_KEY_COLS,
    SHARED_BYTES,
    _pass_bytes,
    merge_pass,
    merge_splits,
    pass_tile_rows,
    split_steps,
)
from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked
from jellyfish_tpu_torch.ops.multiword import M32

torch.set_num_threads(1)

WIDE = [8, 11, 13, 16, 32]  # k = 127, 176, 200, 256, 512


def _lsd(keys, pay=None):
    """The stable ascending order of key rows, the last column most
    significant and a payload least: one stable torch.sort a column,
    least significant first."""
    order = torch.arange(len(keys))
    cols = ([] if pay is None else [pay]) + list(keys.unbind(1))
    for c in cols:
        order = order[torch.sort(c[order], stable=True).indices]
    return order


def _rows(seed, m, wk):
    """m rows of wk 32-bit limbs drawn from m / 3 pooled rows (rows
    repeat), some pairs differing only in the lowest column, 20% of them
    the all-ones PAD row."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, (max(m // 3, 2), wk), dtype=np.int64)
    pool[1::2, 1:] = pool[::2, 1:][:len(pool[1::2])]
    x = pool[rng.integers(0, len(pool), m)]
    x[rng.random(m) < 0.2] = M32
    return torch.from_numpy(x)


def _ties(seed, m, wk):
    """m rows whose top column takes 3 values and every other column 4:
    most rows tie on the top column and differ below it, many are exact
    duplicates; 10% PAD rows."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, (256, wk), dtype=np.int64)
    pool[:, -1] = rng.integers(0, 3, 256)
    x = pool[rng.integers(0, 256, m)]
    x[rng.random(m) < 0.1] = M32
    return torch.from_numpy(x)


def _wild(seed, m, wk):
    """m rows whose top three columns are drawn from values either side of
    0, 2^32 and 2^47 and the int64 extremes (the wide kernel's proxy
    saturates there), the rest 32-bit limbs of 2 values: most rows tie
    on the proxy and differ below it."""
    rng = np.random.default_rng(seed)
    edges = np.array([-(1 << 63), -2, -1, 0, 1, 5, (1 << 32) - 1, 1 << 32,
                      (1 << 47) - 1, 1 << 47, (1 << 63) - 1], dtype=np.int64)
    x = rng.integers(0, 2, (m, wk), dtype=np.int64)
    x[:, -3:] = edges[rng.integers(0, len(edges), (m, 3))]
    return torch.from_numpy(x)


def _sorted_runs(keys, run):
    keys = keys.clone()
    for s in range(0, len(keys), run):
        keys[s:s + run] = keys[s:s + run][_lsd(keys[s:s + run])]
    return keys


@pytest.mark.parametrize("rows", [_rows, _ties, _wild])
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("wk", WIDE)
def test_block_sort_wide(wk, payload, rows):
    """Each tile sorted (the key, then the payload, shuffled so that row
    order is no guide), at the width's default tile and at 64 rows, the
    last tile ragged; on pooled rows, on rows that mostly tie on the top
    column, and on columns at the edges of the wide kernel's proxy (what
    its check holds a tile to)."""
    tile = tile_rows(wk, payload)
    m = 2 * tile + 37
    keys = rows(100 + wk, m, wk)
    pay = torch.arange(m) * 7 % m if payload else None
    for t in (tile, 64):
        got, gp = block_sort(keys, pay, t)
        for s in range(0, m, t):
            seg = slice(s, s + t)
            o = _lsd(keys[seg], None if pay is None else pay[seg])
            assert torch.equal(got[seg], keys[seg][o])
            assert gp is None if pay is None else torch.equal(gp[seg],
                                                              pay[seg][o])


@pytest.mark.parametrize("rows", [_rows, _ties])
@pytest.mark.parametrize("run", [1, 5, 64])
@pytest.mark.parametrize("wk", WIDE)
def test_merge_pass_wide(wk, run, rows):
    """Every adjacent pair of sorted runs merged stably (the earlier run
    first on ties), with a row-index payload and keys only; a short last
    pair and a lone last run; on pooled rows and on rows that mostly tie
    on the top column."""
    m = 7 * run + run // 2 + 1
    keys = _sorted_runs(rows(200 + wk + run, m, wk), run)
    pay = torch.arange(m)
    got, gp = merge_pass(keys, run, pay)
    for s in range(0, m, 2 * run):
        seg = slice(s, s + 2 * run)
        o = _lsd(keys[seg])
        assert torch.equal(got[seg], keys[seg][o])
        assert torch.equal(gp[seg], pay[seg][o])
    k2, none = merge_pass(keys, run)
    assert none is None and torch.equal(k2, got)


@pytest.mark.parametrize("wk", WIDE)
def test_merge_splits_wide(wk):
    """The partition pass: per pair and tile boundary, the first run's
    rows among the first d rows of the pair's stable merge, at tiles of
    one row, of 3 and of the width's pass tile."""
    m, run = 4 * 40 + 40 + 9, 40
    keys = _sorted_runs(_rows(300 + wk, m, wk), run)
    for tile in (1, 3, pass_tile_rows(wk, False)):
        want = []
        for s in range(0, m, 2 * run):
            from_a = (_lsd(keys[s:s + 2 * run]) < run).long()
            taken = torch.cat([torch.zeros(1, dtype=torch.long),
                               torch.cumsum(from_a, 0)])
            steps = split_steps(m, run, tile)[1]
            want += [int(taken[min(t * tile, len(from_a))])
                     for t in range(steps + 1)]
        assert merge_splits(keys, run, tile).tolist() == want


@pytest.mark.parametrize("wk", WIDE)
def test_compact_wide(wk):
    """The rows of nonzero count, or of a true keep byte, in order."""
    keys = _rows(400 + wk, 3000, wk)
    rng = np.random.default_rng(wk)
    cnt = torch.from_numpy(rng.integers(0, 3, 3000))
    keep = torch.from_numpy(rng.random(3000) < 0.4)
    k, c, n = compact(keys, cnt)
    assert n == int((cnt != 0).sum())
    assert torch.equal(k, keys[cnt != 0]) and torch.equal(c, cnt[cnt != 0])
    k, c, n = compact(keys, cnt, keep)
    assert n == int(keep.sum())
    assert torch.equal(k, keys[keep]) and torch.equal(c, cnt[keep])


@pytest.mark.parametrize("wk", WIDE)
def test_sort_rows_blocked_wide(wk):
    """The grain sort's route (block_sort, then merge passes) at the
    width's tiles: the sorted rows, and the stable perm from a row-index
    payload."""
    m = 3 * tile_rows(wk, True) + 101
    keys = _rows(500 + wk, m, wk)
    o = _lsd(keys)
    got, perm = sort_rows_blocked(keys, torch.arange(m))
    assert torch.equal(got, keys[o]) and torch.equal(perm, o)
    assert torch.equal(sort_rows_blocked(keys)[0], keys[o])


def test_tile_geometry_of_every_width():
    """merge_pass tiles: the narrow instances' unchanged; above 7 columns
    5, 3 or 1 rows a thread of 256, else the most even rows that fit, two
    stages of rows at the odd stride wk | 1 (and the payload) in the
    block's 227 KB, at least 2 rows up to MAX_KEY_COLS and fewer past it.
    block_sort tiles: a power of two whose rows, at the odd stride wk | 1
    with the payload and an 8-byte slot for the row number, fit the
    same."""
    assert [pass_tile_rows(wk, True) for wk in range(1, 8)] == [
        4352, 2304, 2304, 2304, 1280, 1280, 1280]
    assert [pass_tile_rows(wk, False) for wk in (8, 13, 16, 32, 56)] == [
        1280, 768, 768, 256, 252]
    for wk in [*range(8, 200), 1000, 4096, MAX_KEY_COLS]:
        for payload in (False, True):
            rows = pass_tile_rows(wk, payload)
            assert rows >= 2 and rows % 2 == 0
            assert _pass_bytes(rows, wk, payload) <= SHARED_BYTES
            assert _pass_bytes(rows, wk, payload) == (
                16 * rows * ((wk | 1) + payload) + 4 * rows)
            if rows < 256:
                assert _pass_bytes(rows + 2, wk, payload) > SHARED_BYTES
            t = tile_rows(wk, payload)
            assert t & (t - 1) == 0
            assert t * 8 * ((wk | 1) + payload + 1) <= SHARED_BYTES
            assert 2 * t * 8 * ((wk | 1) + payload + 1) > SHARED_BYTES
    assert MAX_KEY_COLS == 7261  # k <= 116,176, as the README states
    assert pass_tile_rows(MAX_KEY_COLS + 1, True) < 2
    assert tile_rows(NARROW_KEY_COLS, False) == 1024
    assert [tile_rows(wk, False) for wk in WIDE] == [2048, 2048, 2048,
                                                     1024, 512]


@pytest.mark.parametrize("wk", [8, 13, 64, MAX_KEY_COLS])
def test_wide_division_is_exact(wk):
    """The wide kernels find a word's row as x * ceil(2^32 / wk) >> 32
    (csrc/rows.cuh recip and divide): exact for every word index of a
    tile, which holds at most SHARED_BYTES / 8 words."""
    x = np.arange(SHARED_BYTES // 8 + 1, dtype=np.uint64)
    r = np.uint64(-(-(1 << 32) // wk))
    assert np.array_equal((x * r) >> np.uint64(32), x // np.uint64(wk))


def test_counter_width_limit():
    """MerCounter takes every k up to 16 MAX_KEY_COLS; one more raises a
    ValueError that names the width."""
    k = 16 * MAX_KEY_COLS + 1
    with pytest.raises(ValueError, match=f"k = {k}: keys of "
                                         f"{MAX_KEY_COLS + 1} 32-bit limbs"):
        MerCounter(k, 1 << 20, device="cpu")
