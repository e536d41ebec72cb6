"""The kernels' entries at key widths above 7 columns (k > 112), which run
the wide instances on the card and here, on CPU tensors, their plain
versions: block_sort, merge_pass, merge_splits and compact against a
torch.sort LSD chain written out here, compact, merge_splits and
merge_path also against numpy at the edges of their wide kernels (compact
also against experiments/pallas_compact in interpret mode), and the tile
geometry that the wrappers share with the CUDA sources (csrc/merge_path.cu
pass_rows and merge_rows, csrc/bitonic.cu wide_tile_bytes,
csrc/compact.cu's walk of a tile's words). Exact: integer data."""

import os
import sys

import jax.numpy as jnp
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
    merge_path,
    merge_splits,
    merge_tile_rows,
    pass_tile_rows,
    split_steps,
)
from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked
from jellyfish_tpu_torch.ops.multiword import M32

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))

WIDE = [8, 11, 13, 16, 32]  # k = 127, 176, 200, 256, 512
TILE = 4096  # csrc/compact.cu kTile: the rows a block of the scatter owns


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


def _edge_counts(seed, m):
    """Counts of m rows, a quarter of them nonzero; from 3 tiles on, the
    first tile keeps no row, the second every row and the third 777 (odd,
    so that the next tile's output starts at an odd row); and a keep mask
    of half the rows, which keeps rows of count 0 too, in the same tile
    pattern."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(1, 9, m) * (rng.random(m) < 0.25)
    keep = rng.random(m) < 0.5
    if m > 3 * TILE:
        for x, fill in ((cnt, 3), (keep, True)):
            x[:TILE] = 0
            x[TILE:2 * TILE] = fill
            x[2 * TILE:3 * TILE] = 0
            x[2 * TILE:2 * TILE + 777] = fill
    return cnt, keep


@pytest.mark.parametrize("wk,m", [
    *((wk, m) for wk in (8, 9, 13, 64)
      for m in (1, TILE - 1, TILE, TILE + 1, 3 * TILE + 1234)),
    (MAX_KEY_COLS, 1), (MAX_KEY_COLS, 37)])
def test_compact_wide_edges(wk, m):
    """The rows of nonzero count, or of a true keep byte, in order, at the
    wide scatter's edges (m = 1, a tile less or more one row, tiles that
    keep none, all or an odd number of rows, a ragged last tile), on keys
    at an even and at an odd word offset of their buffer, against numpy."""
    rng = np.random.default_rng(600 + wk + m)
    flat = rng.integers(0, 1 << 32, m * wk + 1, dtype=np.int64)
    cnt, keep = _edge_counts(wk + m, m)
    for off in (0, 1):
        keys = flat[off:off + m * wk].reshape(m, wk)
        tk = torch.from_numpy(flat)[off:off + m * wk].view(m, wk)
        assert tk.is_contiguous()
        tc, tkeep = torch.from_numpy(cnt), torch.from_numpy(keep)
        for mask, rows in ((None, np.flatnonzero(cnt)),
                           (tkeep, np.flatnonzero(keep))):
            k, c, n = compact(tk, tc, mask)
            assert n == len(rows)
            np.testing.assert_array_equal(k.numpy(), keys[rows])
            np.testing.assert_array_equal(c.numpy(), cnt[rows])


@pytest.mark.parametrize("wk", [8, 9, 13])
def test_compact_wide_matches_pallas(wk):
    """compact's plain version against the Pallas compaction it replaces
    (interpret mode) on two of its 32,768-row blocks at wide key widths,
    with the first 4,096-row tile keeping no row and the second every
    row; below the Pallas kernel's fault (its output within one block),
    compared on its live rows."""
    import pallas_compact as pc

    rng = np.random.default_rng(700 + wk)
    m = 2 * pc.BLOCK
    keys = np.sort(rng.integers(0, 1 << 32, (m, wk), dtype=np.uint64)
                   .astype(np.uint32), axis=0)
    cnt = np.where(rng.random(m) < 0.25, rng.integers(1, 1 << 20, m),
                   0).astype(np.uint32)
    cnt[:TILE] = 0
    cnt[TILE:2 * TILE] = 5
    live = cnt != 0
    gk, gc, n = compact(torch.from_numpy(keys.astype(np.int64)),
                        torch.from_numpy(cnt.astype(np.int64)))
    assert n == int(live.sum())
    np.testing.assert_array_equal(gk.numpy().astype(np.uint32), keys[live])
    np.testing.assert_array_equal(gc.numpy().astype(np.uint32), cnt[live])
    pk, pcnt, q = pc.compact_sorted_masked(
        jnp.asarray(keys), jnp.asarray(cnt), interpret=True)
    pk, pcnt = np.asarray(pk), np.asarray(pcnt)
    assert n <= int(q)
    np.testing.assert_array_equal(pk[pcnt != 0], keys[live])
    np.testing.assert_array_equal(pcnt[pcnt != 0], cnt[live])


def _split_rows(kind, seed, m, wk, run):
    """m rows of wk columns in sorted runs of `run` rows: all equal; tied
    in every column but the lowest and the top, 84% of them PAD; sorted
    as a whole (each pair's first run below its second); or that sort's
    whole runs in reverse order (the first run above the second)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 1 << 32, wk, dtype=np.int64)
    x = np.tile(row, (m, 1))
    if kind == "equal":
        return x
    x[:, 0] = rng.integers(0, 4, m)
    x[:, -1] = rng.integers(0, 2, m)
    x[rng.random(m) < 0.84] = M32
    if kind == "pad84":
        for s in range(0, m, run):
            x[s:s + run] = x[s:s + run][np.lexsort(x[s:s + run].T)]
        return x
    x = x[np.lexsort(x.T)]
    if kind == "above":
        whole = m // run * run
        x[:whole] = x[:whole].reshape(-1, run, wk)[::-1].reshape(-1, wk)
    return x


def _splits_oracle(x, run, tile):
    """Per pair and tile boundary d, the first run's rows among the first
    d rows of the pair's stable merge, by numpy's stable lexsort."""
    m = len(x)
    run = min(run, m)
    out = []
    for s in range(0, m, 2 * run):
        pair = x[s:s + 2 * run]
        from_a = np.lexsort(pair.T) < min(run, len(pair))
        taken = np.concatenate([[0], np.cumsum(from_a)])
        steps = -(-min(2 * run, m) // tile)
        out += [int(taken[min(t * tile, len(pair))])
                for t in range(steps + 1)]
    return out


@pytest.mark.parametrize("kind", ["equal", "pad84", "below", "above"])
@pytest.mark.parametrize("wk,run,m", [
    *((wk, run, m) for wk in (8, 13, 64)
      for run, m in ((1, 4), (1, 5), (5, 17), (5, 13), (2048, 6 * 1024 + 77),
                     (2048, 4096 + 1000))),
    *((MAX_KEY_COLS, run, m) for run, m in ((1, 4), (1, 5), (5, 17),
                                            (5, 13)))])
def test_merge_splits_wide_edges(wk, run, m, kind):
    """merge_splits at its wide kernel's edges against numpy: rows all
    equal, PAD rows and rows that tie in all but two columns, pairs whose
    first run lies wholly below or wholly above the second; runs of 1, 5
    and 2,048 with a short last pair or a lone last run; at tiles of one
    row and of the pass's tile (one row at MAX_KEY_COLS, where the plain
    version's chain of stable sorts runs 7,261 sorts a pair)."""
    x = _split_rows(kind, 800 + wk + run + m, m, wk, run)
    keys = torch.from_numpy(x)
    for tile in (1,) if wk == MAX_KEY_COLS else (1, pass_tile_rows(wk, False)):
        assert merge_splits(keys, run, tile).tolist() == _splits_oracle(
            x, run, tile)


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_merge_tile_rows_of_every_width(sms):
    """A wide merge_path's tile (merge_tile_rows; csrc/merge_path.cu
    merge_rows) at every width from 8 to 200 and at 1,000, 4,096 and
    MAX_KEY_COLS: even, its two stages with the counts within the block's
    shared memory, and the smallest of merge_pass' tiles with a payload
    (5, 3 or 1 rows a thread of 256, or the fewer rows that fit), so that
    for merges of 2 rows to 2^24 on cards of `sms` SMs the grid reaches
    two tiles an SM wherever any of those tiles would."""
    sizes = {2, 3, 255, 256, 257, 1 << 15, (1 << 16) + 1, 1 << 20, 1 << 24}
    sizes |= {2 * sms * 256 + d for d in (-1, 0, 1)}
    for wk in [*range(8, 201), 1000, 4096, MAX_KEY_COLS]:
        top = pass_tile_rows(wk, True)
        fits = [256 * i for i in (5, 3, 1) if 256 * i <= top] or [top]
        tile = merge_tile_rows(wk)
        assert tile >= 2 and tile % 2 == 0 and tile == min(fits)
        assert _pass_bytes(tile, wk, True) <= SHARED_BYTES
        for rows in sizes:
            if any(-(-rows // t) >= 2 * sms for t in fits):
                assert -(-rows // tile) >= 2 * sms
    assert [merge_tile_rows(wk) for wk in (8, 13, 16, 32, 64)] == [
        256, 256, 256, 256, 218]


def _two_runs(kind, seed, na, nb, wk):
    """Sorted runs A (na rows) and B (nb rows) of wk columns: all rows
    equal; tied in every column but the lowest and the top, 84% of them
    PAD, dealt at random into A and B; or one sorted whole, A below B or
    above it."""
    rng = np.random.default_rng(seed)
    n = na + nb
    x = np.tile(rng.integers(0, 1 << 32, wk, dtype=np.int64), (n, 1))
    if kind != "equal":
        x[:, 0] = rng.integers(0, 4, n)
        x[:, -1] = rng.integers(0, 2, n)
        x[rng.random(n) < 0.84] = M32
    x = x[np.lexsort(x.T)]
    if kind == "pad84":
        idx = rng.permutation(n)
        return x[np.sort(idx[:na])], x[np.sort(idx[na:])]
    if kind == "above":
        return x[nb:], x[:nb]
    return x[:na], x[na:]


@pytest.mark.parametrize("kind", ["equal", "pad84", "below", "above"])
@pytest.mark.parametrize("wk,na,nb", [
    *((wk, na, nb) for wk in (8, 13, 16, 64)
      for na, nb in ((0, 0), (0, 5), (5, 0), (1, 0), (0, 1), (1, 1),
                     (3, 2000), (2000, 3), (1281, 1280))),
    *((MAX_KEY_COLS, na, nb) for na, nb in ((0, 5), (1, 1), (3, 20),
                                            (21, 2)))])
def test_merge_path_wide_edges(wk, na, nb, kind):
    """merge_path at its wide kernels' edges against numpy's stable
    lexsort of A then B: rows all equal, PAD rows and rows that tie in all
    but two columns, A wholly below or above B; empty runs, one row, runs
    of very different lengths, an odd total. The counts are each row's
    place in A then B, so that a tie out of A-first order shows."""
    a, b = _two_runs(kind, 1800 + wk + na + nb, na, nb, wk)
    got_k, got_c = merge_path(
        torch.from_numpy(a), torch.arange(na), torch.from_numpy(b),
        torch.arange(na, na + nb))
    x = np.concatenate([a, b])
    order = np.lexsort(x.T)
    np.testing.assert_array_equal(got_k.numpy(), x[order])
    np.testing.assert_array_equal(got_c.numpy(), order)


def test_scatter_word_walk_of_every_width():
    """The wide scatter (csrc/compact.cu) walks a tile's output words
    256 threads x kWords words apart (kWords 2 at an even width, else 1)
    and carries each word's kept row and column: for every width up to
    MAX_KEY_COLS the walk gives e // wk and e % wk, and a tile's words
    (4,096 rows) fit its 32-bit indices."""
    assert TILE * MAX_KEY_COLS < 1 << 31
    for words in (1, 2):
        wk = np.arange(8, MAX_KEY_COLS + 1)
        wk = wk[wk % 2 == 0] if words == 2 else wk
        t = np.arange(256)[None, :]
        step = 256 * words
        hop, skip = step // wk[:, None], step % wk[:, None]
        e = t * words
        p, col = e // wk[:, None], e % wk[:, None]
        for _ in range(64):
            assert np.array_equal(p, e // wk[:, None])
            assert np.array_equal(col, e % wk[:, None])
            p, col, e = p + hop, col + skip, e + step
            carry = col >= wk[:, None]
            p, col = p + carry, col - carry * wk[:, None]
