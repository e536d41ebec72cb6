"""K3's plain versions against the Pallas bitonic kernels they replace, and
the port's multi-column sort (K3 block sort + K1 merge passes, on the CPU
through the plain versions) against the LSD chain (exact: integer data).

Rows of the kernel table (PERF.md): 6 experiments/pallas_sort_proto.py
sort_kernel, run in interpret mode; 7 and 8 pallas_probe2._xchg1 and
_xchg3 and 11 pallas_stage_probe.make_kernel (interpret mode), whose u32
[R, 128] tiles are runs of key rows in row-major order here; 12 the flip
of pallas_stage_probe, x[::-1, ::-1]. Rows 7 and 11 also through
exchange_tiles_plain, the card's route (the passes of exchange_plan, each
strided-tile pass laid out as jf_exchange_tiles lays out its blocks). On
CPU tensors the wrappers take the plain path and launch nothing.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from jellyfish_tpu_torch.kernels import sort as ksort
from jellyfish_tpu_torch.kernels.bitonic import (
    Pass,
    block_merge,
    block_merge_plain,
    block_sort,
    block_sort_plain,
    exchange_plan,
    exchange_stages,
    exchange_stages_plain,
    exchange_tiles_plain,
    flip,
    flip_plain,
    pass_block_rows,
    stride_block_rows,
    stride_layouts,
    tile_pass_plain,
    tile_pass_steps,
    tile_rows,
    SMALL_BLOCK_ROWS,
)
from jellyfish_tpu_torch.kernels.merge_path import (
    MAX_KEY_COLS,
    merge_pass,
    merge_pass_plain,
    merge_splits,
    merge_splits_plain,
    pass_tile_rows,
    split_steps,
)
from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.count import sort_rows, sort_rows_plain

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))


@pytest.fixture(scope="module")
def probes():
    """The probe modules; importing them points JAX's compilation cache at
    a directory outside the checkout, which is undone here."""
    prev = jax.config.jax_compilation_cache_dir
    try:
        import pallas_probe2
        import pallas_sort_proto
        import pallas_stage_probe
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return pallas_sort_proto, pallas_probe2, pallas_stage_probe


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _col(x):
    """A u32 tile as one column of key rows, row-major."""
    return torch.from_numpy(x.reshape(-1, 1).astype(np.int64))


def _tile(t, shape):
    return t.numpy().astype(np.uint32).reshape(shape)


def _cycle(r, n):
    """The probes' step distances: R/2, R/4, ..., 1, R/2, ... (n steps)."""
    out, s = [], r // 2
    for _ in range(n):
        out.append(max(s, 1))
        s = s // 2 or r // 2
    return out


def test_block_sort_plain_matches_pallas_sort(probes):
    """Row 6: the whole-tile bitonic sort of 131,072 keys. The Pallas tile
    is column-major: key i sits at (i mod R, i div R). The card sorts that
    tile as the counting path does: K3 on shared-memory tiles, then K1
    merge passes."""
    ps = probes[0]
    rng = np.random.default_rng(600)
    vals = _u32(rng, ps.T)
    vals[:5000] = vals[5000:10000]  # ties
    x = jnp.asarray(vals.reshape(ps.LANES, ps.R).T)
    want = np.asarray(pl.pallas_call(
        ps.sort_kernel,
        out_shape=jax.ShapeDtypeStruct((ps.R, ps.LANES), jnp.uint32),
        interpret=True)(x)).T.reshape(-1)
    np.testing.assert_array_equal(want, np.sort(vals))
    got, _ = block_sort_plain(_col(vals), tile=ps.T)
    np.testing.assert_array_equal(got[:, 0].numpy().astype(np.uint32), want)
    got, _ = sort_rows_blocked(_col(vals))
    np.testing.assert_array_equal(got[:, 0].numpy().astype(np.uint32), want)


def test_exchange_stages_plain_matches_xchg1(probes):
    """Row 7: build_stages(n, arrays=1), one array, steps at tile-row
    distances R/2 ... 1 and around again."""
    p2 = probes[1]
    rng = np.random.default_rng(700)
    x = _u32(rng, (p2.R, p2.C), hi=1000)  # many ties
    ms = _cycle(p2.R, 14)
    want = jnp.asarray(x)
    for m in ms:
        want = p2._xchg1(want, m)
    got, p = exchange_stages_plain(_col(x), distances=[m * p2.C for m in ms])
    assert p is None
    np.testing.assert_array_equal(_tile(got, x.shape), np.asarray(want))


def test_exchange_stages_plain_matches_xchg3(probes):
    """Row 8: build_stages(n, arrays=3), (hi, lo, count) triples compared
    on (hi, lo) with the count carried: keys [M, 2] of (lo, hi) limbs,
    compared from the last column, and the count as the payload."""
    p2 = probes[1]
    rng = np.random.default_rng(800)
    kh = _u32(rng, (p2.R, p2.C), hi=4)       # hi ties decided by lo
    kl = _u32(rng, (p2.R, p2.C), hi=64)      # and some full ties
    cnt = _u32(rng, (p2.R, p2.C))
    ms = _cycle(p2.R, 13)
    want = [jnp.asarray(a) for a in (kh, kl, cnt)]
    for m in ms:
        want = p2._xchg3(*want, m)
    keys = torch.from_numpy(
        np.stack([kl.reshape(-1), kh.reshape(-1)], 1).astype(np.int64))
    got, pay = exchange_stages_plain(keys, _col(cnt)[:, 0].contiguous(),
                                     [m * p2.C for m in ms])
    np.testing.assert_array_equal(_tile(got[:, 1], kh.shape),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(_tile(got[:, 0], kh.shape),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(_tile(pay, kh.shape), np.asarray(want[2]))


@pytest.mark.parametrize("transposes", [0, 1, 2])
def test_exchange_stages_plain_matches_stage_probe(probes, transposes):
    """Row 11: make_kernel(n, t), t transposes of each [128, 128] sub-tile
    and then n row-exchange steps, run in interpret mode."""
    sp = probes[2]
    rng = np.random.default_rng(1100 + transposes)
    x = _u32(rng, (sp.R, sp.C))
    n = 12
    want = np.asarray(pl.pallas_call(
        sp.make_kernel(n, transposes),
        out_shape=jax.ShapeDtypeStruct((sp.R, sp.C), jnp.uint32),
        interpret=True)(jnp.asarray(x)))
    got, _ = exchange_stages_plain(
        _col(x), distances=[m * sp.C for m in _cycle(sp.R, n)],
        transposes=transposes)
    np.testing.assert_array_equal(_tile(got, x.shape), want)


def test_exchange_tiles_plain_matches_xchg1(probes):
    """Row 7 on the card's route: the probe's 14 steps (a run of 12, then
    2) as strided-tile passes, keys only and with a payload carried."""
    p2 = probes[1]
    rng = np.random.default_rng(701)
    x = _u32(rng, (p2.R, p2.C), hi=1000)  # many ties
    ms = _cycle(p2.R, 14)
    want = jnp.asarray(x)
    for m in ms:
        want = p2._xchg1(want, m)
    dist = [m * p2.C for m in ms]
    assert len(exchange_plan(dist, limit=tile_pass_steps(1, False))) == 2
    got, p = exchange_tiles_plain(_col(x), distances=dist)
    assert p is None
    np.testing.assert_array_equal(_tile(got, x.shape), np.asarray(want))
    pay = torch.arange(x.size)
    got, p = exchange_tiles_plain(_col(x), pay, dist)
    np.testing.assert_array_equal(_tile(got, x.shape), np.asarray(want))
    assert torch.equal(p, exchange_stages_plain(_col(x), pay, dist)[1])


@pytest.mark.parametrize("transposes", [0, 1, 2])
def test_exchange_tiles_plain_matches_stage_probe(probes, transposes):
    """Row 11 on the card's route: make_kernel(12, t) in interpret mode,
    the transposed read (odd t) in the first strided-tile pass, with the
    run of 10 steps it starts."""
    sp = probes[2]
    rng = np.random.default_rng(1110 + transposes)
    x = _u32(rng, (sp.R, sp.C))
    n = 12
    want = np.asarray(pl.pallas_call(
        sp.make_kernel(n, transposes),
        out_shape=jax.ShapeDtypeStruct((sp.R, sp.C), jnp.uint32),
        interpret=True)(jnp.asarray(x)))
    dist = [m * sp.C for m in _cycle(sp.R, n)]
    plan = exchange_plan(dist, False, transposes, tile_pass_steps(1, False))
    assert [len(ps.distances) for ps in plan] == [10, 2]
    assert plan[0].transposed == (transposes % 2 == 1)
    got, _ = exchange_tiles_plain(_col(x), distances=dist,
                                  transposes=transposes)
    np.testing.assert_array_equal(_tile(got, x.shape), want)


def test_flip_plain_matches_probe_flip(probes):
    """Row 12: a [1024, 128] tile reversed along both axes."""
    sp = probes[2]
    rng = np.random.default_rng(1200)
    x = _u32(rng, (2, sp.R, sp.C))
    got = flip_plain(_col(x), sp.R * sp.C)
    np.testing.assert_array_equal(_tile(got, x.shape), x[:, ::-1, ::-1])


def _rows(rng, m, wk):
    """m key rows of wk columns as the store holds them: limbs for wk > 1,
    packed over the whole int64 range for wk = 1, with ties (repeated
    rows, rows equal in the top columns only) and all-ones PAD rows."""
    if wk == 1:
        x = rng.integers(-(1 << 63), (1 << 63) - 1, (m, 1), dtype=np.int64)
    else:
        x = rng.integers(0, 1 << 32, (m, wk), dtype=np.int64)
        x[: m // 4, 1:] = x[m // 4: 2 * (m // 4), 1:]  # ties above column 0
    x[m // 2: m // 2 + m // 8] = x[: m // 8]       # whole-row ties
    x[rng.random(m) < 0.05] = mw.pad_key(3 if wk > 1 else 2)
    return torch.from_numpy(x)


@pytest.mark.parametrize("wk", range(1, 8))
def test_sort_route_matches_lsd_chain(wk):
    """sort_rows_blocked with a payload and with keys only, at the default
    tile and at small tiles that leave a ragged last tile, an odd number
    of tiles and a lone last run, against sort_rows_plain. The row-index
    payload comes out as the stable perm."""
    rng = np.random.default_rng(2000 + wk)
    m = 3 * tile_rows(wk, True) + 101 if wk > 3 else 5000
    keys = _rows(rng, m, wk)
    want, want_perm = sort_rows_plain(keys)
    idx = torch.arange(m)
    for tile in (None, 64, 128):
        got, perm = sort_rows_blocked(keys, idx, tile)
        assert torch.equal(got, want) and torch.equal(perm, want_perm)
        got, none = sort_rows_blocked(keys, None, tile)
        assert none is None and torch.equal(got, want)
    assert block_sort.launches == merge_pass.launches == 0


@pytest.mark.parametrize("wk", [3, 4, 7])
def test_sort_rows_takes_the_blocked_route(monkeypatch, wk):
    """For Wk > 1 sort_rows runs K3's block sort and K1's merge passes on
    every device (here their plain versions), keys only."""
    calls = {"block": 0, "pass": 0}

    def spy(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(ksort, "block_sort", spy("block", ksort.block_sort))
    monkeypatch.setattr(ksort, "merge_pass", spy("pass", ksort.merge_pass))
    rng = np.random.default_rng(2100 + wk)
    m = 8 * tile_rows(wk, False) + 7
    keys = _rows(rng, m, wk)
    assert torch.equal(sort_rows(keys), sort_rows_plain(keys)[0])
    assert calls == {"block": 1, "pass": 4}  # ceil(log2(9 tiles))


@pytest.mark.parametrize("wk,run", [(1, 1), (3, 5), (4, 64), (7, 100)])
def test_merge_pass_plain(wk, run):
    """Every adjacent pair of sorted runs merged stably; the short last
    pair and a lone last run included."""
    rng = np.random.default_rng(3000 + wk)
    m = 7 * run + run // 2 + 1  # 3 pairs, a short 4th pair
    keys = _rows(rng, m, wk)
    for s in range(0, m, run):  # sorted runs of `run` rows
        keys[s:s + run] = sort_rows_plain(keys[s:s + run])[0]
    pay = torch.arange(m) * 3
    got, gp = merge_pass_plain(keys, run, pay)
    for s in range(0, m, 2 * run):
        k, perm = sort_rows_plain(keys[s:s + 2 * run])
        assert torch.equal(got[s:s + 2 * run], k)
        assert torch.equal(gp[s:s + 2 * run], pay[s:s + 2 * run][perm])
    k2, p2 = merge_pass(keys, run, pay)
    assert torch.equal(k2, got) and torch.equal(p2, gp)
    k3, none = merge_pass(keys, run)
    assert none is None and torch.equal(k3, got)
    lone = merge_pass_plain(keys[:run], run)[0]  # one run: copied
    assert torch.equal(lone, keys[:run])
    assert merge_pass.launches == 0


def _sorted_runs(keys, run):
    """keys with each run of `run` rows sorted."""
    keys = keys.clone()
    for s in range(0, len(keys), run):
        keys[s:s + run] = sort_rows_plain(keys[s:s + run])[0]
    return keys


def _splits_brute(keys, run, tile):
    """merge_splits by numpy: per pair, a stable lexicographic sort (last
    column first) and the count of first-run rows before each tile
    boundary."""
    x = keys.numpy()
    m = len(x)
    run = min(run, m)
    out = []
    for s in range(0, m, 2 * run):
        pair = x[s:s + 2 * run]
        from_a = np.lexsort(pair.T) < min(run, len(pair))
        steps = -(-min(2 * run, m) // tile)
        out += [int(from_a[:min(t * tile, len(pair))].sum())
                for t in range(steps + 1)]
    return out


@pytest.mark.parametrize("m,run", [
    (4 * 40 + 40 + 9, 40),   # a short last pair
    (4 * 40 + 9, 40),        # a lone last run
    (37, 1),                 # runs of one row
    (50, 64),                # a run longer than the array
    (300, 128),              # few values: ties within and across runs
])
@pytest.mark.parametrize("wk", range(1, 8))
def test_merge_splits_plain_at_every_boundary(wk, m, run):
    """The partition pass's plain twin against a numpy count, at tiles of
    one row (every diagonal a boundary) and at ragged tiles; ties across
    the two runs and whole-row ties come first from A."""
    rng = np.random.default_rng(3100 + 10 * wk + run)
    keys = _rows(rng, m, wk)
    if run == 128:
        keys = torch.from_numpy(rng.integers(0, 3, (m, wk), dtype=np.int64))
    keys = _sorted_runs(keys, run)
    for tile in (1, 3, 64):
        got = merge_splits_plain(keys, run, tile)
        assert got.tolist() == _splits_brute(keys, run, tile)
        pairs, steps = split_steps(m, run, tile)
        assert got.shape == (pairs * (steps + 1),)
        assert torch.equal(merge_splits(keys, run, tile), got)
    assert merge_splits.launches == 0


def test_pass_tile_rows():
    """The pass tiles of csrc/merge_path.cu: 17, 9 or 5 rows a thread of
    256 for rows of up to 2, 5 or 7 columns with the payload."""
    assert [pass_tile_rows(wk, False) for wk in range(1, 8)] == [
        4352, 4352, 2304, 2304, 2304, 1280, 1280]
    assert [pass_tile_rows(wk, True) for wk in range(1, 8)] == [
        4352, 2304, 2304, 2304, 1280, 1280, 1280]
    assert split_steps(0, 5, 4352) == (0, 0)
    assert split_steps(1 << 26, 1 << 22, 2304) == (8, 3641)
    assert split_steps((1 << 20) + 777, 1 << 22, 2304) == (1, 456)
    assert split_steps(1 << 26, 2048, 2304) == (1 << 14, 2)


@pytest.fixture(scope="module")
def merge_probe():
    """experiments/pallas_merge_probe.py in interpret mode (its import
    points JAX's compilation cache outside the checkout, undone here)."""
    os.environ["JF_PALLAS_INTERPRET"] = "1"
    prev = jax.config.jax_compilation_cache_dir
    try:
        import pallas_merge_probe
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    assert pallas_merge_probe.INTERPRET
    return pallas_merge_probe


@pytest.mark.parametrize("w", [1, 3, 7])
def test_merge_pass_plain_matches_pallas(merge_probe, w):
    """merge_pass_plain over two pairs of sorted runs of W-limb keys (store
    key columns: packed for W = 1) with a count, pair by pair against
    build_merge_n (experiments/pallas_merge_probe.py:492), which merges
    (hi, lo) = the top two limbs with the lower limbs and the count as
    payloads. The top two limbs are distinct across each pair: the Pallas
    merge keeps no order among equal keys."""
    rng = np.random.default_rng(3200 + w)
    run = merge_probe.T_OUT // 2
    limbs, cnts = [], []
    for _ in range(2):
        top = rng.choice(1 << (32 if w == 1 else 52), 2 * run,
                         replace=False).astype(np.uint64)
        x = rng.integers(0, 1 << 32, (2 * run, w), dtype=np.uint64)
        if w == 1:
            x[:, 0] = top
        else:
            x[:, w - 1] = top >> np.uint64(20)
            x[:, w - 2] = top & np.uint64((1 << 20) - 1)
        for half in (x[:run], x[run:]):
            half[:] = half[np.argsort(mw.to_ints(half), kind="stable")]
        limbs.append(x)
        cnts.append(rng.integers(1, 1 << 31, 2 * run))
    keys = mw.key_columns(torch.from_numpy(
        np.concatenate(limbs).astype(np.int64))).contiguous()
    cnt = torch.from_numpy(np.concatenate(cnts))
    got_k, got_c = merge_pass_plain(keys, run, cnt)
    got = mw.limbs_of_key_columns(got_k, w).numpy().astype(np.uint32)

    def ops(x, c):
        hi = x[:, -1] if w > 1 else np.zeros(len(x), np.uint32)
        lo = x[:, -2] if w > 1 else x[:, 0]
        return [hi, lo] + [x[:, i] for i in range(w - 2)] + [c]

    f = merge_probe.build_merge_n(1, 2 * run, max(w - 2, 0) + 1)
    for p, (x, c) in enumerate(zip(limbs, cnts)):
        x, c = x.astype(np.uint32), c.astype(np.uint32)
        outs = [np.asarray(o) for o in f(*[
            jnp.asarray(v) for v in ops(x[:run], c[:run])
            + ops(x[run:], c[run:])])]
        rows = slice(2 * p * run, 2 * (p + 1) * run)
        want = ops(got[rows], got_c[rows].numpy().astype(np.uint32))
        for o, v in zip(outs, want, strict=True):
            np.testing.assert_array_equal(o, v)


def test_wrappers_on_cpu_tensors_are_the_plain_versions():
    rng = np.random.default_rng(4000)
    keys = _rows(rng, 1 << 15, 2)
    pay = torch.from_numpy(rng.integers(0, 1 << 40, 1 << 15))
    for tile in (256, tile_rows(2, True)):
        a = block_sort(keys, pay, tile)
        b = block_sort_plain(keys, pay, tile)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = exchange_stages(keys, pay, [1, 64, 2], transposes=1)
    b = exchange_stages_plain(keys, pay, [1, 64, 2], transposes=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(flip(keys, 512), flip_plain(keys, 512))
    assert block_sort.launches == exchange_stages.launches == 0
    assert exchange_stages.passes == flip.launches == 0


def test_wrappers_reject_bad_inputs():
    k = torch.zeros((64, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        block_sort(k, tile=24)                       # not a power of two
    with pytest.raises(ValueError):
        block_sort(k, tile=1 << 14)                  # above shared memory
    with pytest.raises(ValueError):   # wider than the widest instance
        block_sort(torch.zeros((4, MAX_KEY_COLS + 1), dtype=torch.int64))
    with pytest.raises(ValueError):   # the step entries take 1-7 columns
        block_merge(torch.zeros((4, 8), dtype=torch.int64), None, 4)
    with pytest.raises(ValueError):
        exchange_stages(torch.zeros((4, 8), dtype=torch.int64),
                        distances=[1])
    with pytest.raises(ValueError):
        block_sort(k, torch.zeros(63, dtype=torch.int64))
    with pytest.raises(ValueError):
        exchange_stages(k, distances=[64])           # not whole 2d blocks
    with pytest.raises(ValueError):
        exchange_stages(k, distances=[1], transposes=1)  # not whole squares
    with pytest.raises(ValueError):
        exchange_stages(k)                           # no step
    with pytest.raises(ValueError):
        flip(k, 48)
    with pytest.raises(ValueError):
        block_merge(k, None, tile=1 << 14)           # above shared memory
    with pytest.raises(ValueError):
        merge_pass(k.t(), 4)
    with pytest.raises(ValueError):
        merge_pass(k, 0)
    with pytest.raises(ValueError):
        merge_splits(k, 4, 0)


# -- the pair sort (Bloom insert, BitsArray): rows 6, 8 and 12 ------------


@pytest.mark.parametrize("wk,d", [(1, 1), (2, 64), (7, 512)])
def test_mirrored_step_is_flip_then_exchange(wk, d):
    """The mirrored step at distance d (row j of each 2d-row block meets
    row 2d - 1 - j, the smaller key first, the payload carried) equals the
    Pallas design's flip of each block's upper half, a plain step at d,
    and the flip undone."""
    rng = np.random.default_rng(5000 + wk)
    m = 8 * d
    keys = _rows(rng, m, wk)
    pay = torch.from_numpy(rng.integers(0, 1 << 40, m))

    def flip_upper(k, p):
        k = k.view(-1, 2, d, wk).clone()
        p = p.view(-1, 2, d).clone()
        k[:, 1], p[:, 1] = k[:, 1].flip(1), p[:, 1].flip(1)
        return k.reshape(m, wk), p.reshape(m)

    want = flip_upper(*exchange_stages_plain(*flip_upper(keys, pay), [d]))
    got = exchange_stages_plain(keys, pay, [d], mirror=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    more = exchange_stages_plain(keys, pay, [d, d // 2 or 1], mirror=True)
    then = exchange_stages_plain(*got, [d // 2 or 1])
    assert all(torch.equal(a, b) for a, b in zip(more, then))
    got = exchange_stages(keys, pay, [d], mirror=True)  # CPU: the plain one
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert exchange_stages.launches == exchange_stages.mirror_launches == 0


@pytest.mark.parametrize("m", [1 << 13, 5000, 1, 0])
@pytest.mark.parametrize("wk", [1, 2, 7])
def test_pair_sort_matches_plain_sort(wk, m):
    """sort_pairs_bitonic against the LSD chain: the same keys in order,
    and the same multiset of (key, payload) rows; at small tiles (several
    phases of mirrored and plain steps) and at the default tile."""
    rng = np.random.default_rng(6000 + wk + m)
    keys = _rows(rng, m, wk) if m else torch.zeros((0, wk), dtype=torch.int64)
    if wk == 1:
        keys[keys[:, 0] == mw.PAD_PACKED] = 0  # keys sort below the PAD row
    pay = torch.from_numpy(rng.integers(0, 1 << 40, m))
    want = sort_rows_plain(keys)[0]

    def rows(k, p):
        return sorted(zip(map(tuple, k.tolist()), p.tolist()))

    for tile in (16, 256, None):
        got, gp = ksort.sort_pairs_bitonic(keys, pay, tile)
        assert torch.equal(got, want)
        assert rows(got, gp) == rows(keys, pay)
        plain = ksort.sort_pairs_plain(keys, pay, tile)
        assert torch.equal(plain[0], got) and torch.equal(plain[1], gp)
    assert block_sort.launches == exchange_stages.launches == 0


def test_pair_sort_phases(monkeypatch):
    """The route's calls: one block_sort, then per doubling one
    exchange_stages call (the mirrored step at the run length, plain steps
    down to one tile) and one block_merge (the steps inside each tile)."""
    calls = []
    monkeypatch.setattr(ksort, "block_sort",
                        lambda k, p, t: calls.append(("sort", t))
                        or block_sort(k, p, t))
    monkeypatch.setattr(ksort, "block_merge",
                        lambda k, p, t: calls.append(("merge", t))
                        or block_merge(k, p, t))
    monkeypatch.setattr(ksort, "exchange_stages",
                        lambda k, p, d, mirror: calls.append(
                            ("steps", tuple(d), mirror))
                        or exchange_stages(k, p, d, mirror=mirror))
    keys = torch.arange(1000, 0, -1)[:, None].contiguous()
    got, _ = ksort.sort_pairs_bitonic(keys, torch.zeros(1000,
                                                        dtype=torch.int64),
                                      tile=128)
    assert torch.equal(got[:, 0], torch.arange(1, 1001))
    assert calls == [("sort", 128),
                     ("steps", (128,), True), ("merge", 128),
                     ("steps", (256, 128), True), ("merge", 128),
                     ("steps", (512, 256, 128), True), ("merge", 128)]


# -- block_merge: the in-tile steps of the pair sort (row 8's rule) -------


def _pairs(rng, m, wk, payload):
    keys = _rows(rng, m, wk)
    pay = torch.from_numpy(rng.integers(0, 1 << 40, m)) if payload else None
    return keys, pay


@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("wk", [1, 2, 7])
def test_block_merge_plain_is_the_in_tile_steps(wk, payload):
    """block_merge_plain is exchange_stages_plain at distances tile/2,
    ..., 1 (the key compared, the payload carried), on any rows; a tile of
    one row is left as it is."""
    rng = np.random.default_rng(7000 + wk + payload)
    keys, pay = _pairs(rng, 1 << 12, wk, payload)
    for tile in (2, 64, 1024):
        dist = []
        d = tile // 2
        while d:
            dist.append(d)
            d //= 2
        got = block_merge_plain(keys, pay, tile)
        want = exchange_stages_plain(keys, pay, dist)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (not payload)
        assert not payload or torch.equal(got[1], want[1])
    got = block_merge_plain(keys, pay, 1)
    assert torch.equal(got[0], keys)


@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("wk", [1, 2, 7])
def test_block_merge_plain_sorts_bitonic_tiles(wk, payload):
    """Tiles left bitonic by a mirrored step (two sorted halves of each
    2T block met by the mirrored step at T) come out with their keys
    sorted, each tile in order among its neighbours, and the (key,
    payload) rows kept."""
    rng = np.random.default_rng(7100 + wk + payload)
    tile = 256
    keys, pay = _pairs(rng, 8 * tile, wk, payload)
    if pay is None:
        pay = torch.zeros(keys.shape[0], dtype=torch.int64)
    k, p = block_sort_plain(keys, pay, tile)           # sorted tiles
    k, p = exchange_stages_plain(k, p, [tile], mirror=True)
    got, gp = block_merge_plain(k, p if payload else None, tile)
    want = torch.cat([sort_rows_plain(k[s:s + 2 * tile])[0]
                      for s in range(0, k.shape[0], 2 * tile)])
    assert torch.equal(got, want)
    if payload:
        def rows(a, b):
            return sorted(zip(map(tuple, a.tolist()), b.tolist()))
        assert rows(got, gp) == rows(k, p)


def test_block_merge_on_cpu_tensors_is_the_plain_version():
    rng = np.random.default_rng(7200)
    keys, pay = _pairs(rng, 1 << 13, 2, True)
    for tile in (16, 512, tile_rows(2, True)):
        a = block_merge(keys, pay, tile)
        b = block_merge_plain(keys, pay, tile)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        a = block_merge(keys, None, tile)
        assert a[1] is None and torch.equal(a[0], b[0])
    assert block_merge.launches == 0


def test_block_merge_rejects_bad_inputs():
    k = torch.zeros((64, 2), dtype=torch.int64)
    p = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(ValueError):
        block_merge(k, p, 24)                         # not a power of two
    with pytest.raises(ValueError):
        block_merge(k[:48].contiguous(), p[:48], 32)  # not whole tiles
    with pytest.raises(ValueError):
        block_merge(k.int(), p, 16)                   # keys not int64
    with pytest.raises(ValueError):
        block_merge(k, p.int(), 16)                   # payload not int64
    with pytest.raises(ValueError):
        block_merge(k, p[:63], 16)                    # payload of another M
    assert block_merge.launches == 0


@pytest.mark.parametrize("m", [1 << 13, 9999, 1])
def test_pair_sort_matches_lax_sort(m):
    """sort_pairs_bitonic on the Bloom insert's pairs (uint32 positions,
    weights 0-2) against the JAX package's own call,
    jax.lax.sort([pos, wb], num_keys=1, is_stable=False)
    (jellyfish_tpu/bloom.py:137): the same positions in order and, per
    position, the same sum of weights (equal keys may come out in another
    order)."""
    rng = np.random.default_rng(7300 + m)
    pos = rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    pos[: m // 3] = pos[m // 3: 2 * (m // 3)]     # repeated positions
    wb = rng.integers(0, 3, m).astype(np.uint32)
    spos, sw = jax.lax.sort([jnp.asarray(pos), jnp.asarray(wb)], num_keys=1,
                            is_stable=False)
    spos, sw = np.asarray(spos).astype(np.int64), np.asarray(sw)
    for tile in (16, 256, None):
        got, gw = ksort.sort_pairs_bitonic(
            torch.from_numpy(pos.astype(np.int64))[:, None].contiguous(),
            torch.from_numpy(wb.astype(np.int64)), tile)
        np.testing.assert_array_equal(got[:, 0].numpy(), spos)
        starts = np.unique(spos, return_index=True)[1]
        np.testing.assert_array_equal(
            np.add.reduceat(gw.numpy(), starts),
            np.add.reduceat(sw.astype(np.int64), starts))
    assert block_merge.launches == block_sort.launches == 0


@pytest.mark.parametrize("tile,m", [(64, 1 << 13), (64, 6000)])
def test_pair_sort_matches_lax_sort_in_long_phases(tile, m):
    """As above at a tile of 64 rows: 2^13 padded rows make phases of 1-7
    cross-tile steps, so the fused passes' runs of four steps, and the
    lone step after one, sort the insert's pairs."""
    rng = np.random.default_rng(7400 + m)
    pos = rng.integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    pos[: m // 4] = pos[m // 4: 2 * (m // 4)]
    wb = rng.integers(0, 3, m).astype(np.uint32)
    spos, sw = jax.lax.sort([jnp.asarray(pos), jnp.asarray(wb)], num_keys=1,
                            is_stable=False)
    spos, sw = np.asarray(spos).astype(np.int64), np.asarray(sw)
    got, gw = ksort.sort_pairs_bitonic(
        torch.from_numpy(pos.astype(np.int64))[:, None].contiguous(),
        torch.from_numpy(wb.astype(np.int64)), tile)
    np.testing.assert_array_equal(got[:, 0].numpy(), spos)
    starts = np.unique(spos, return_index=True)[1]
    np.testing.assert_array_equal(
        np.add.reduceat(gw.numpy(), starts),
        np.add.reduceat(sw.astype(np.int64), starts))
    assert exchange_stages.launches == exchange_stages.passes == 0


# -- the strided-tile passes of exchange_stages (jf_exchange_tiles) ---------


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("wk", [1, 2, 7])
def test_exchange_group_plain_is_the_steps(wk, payload, g, mirror):
    """One strided-tile pass as the kernel lays out its blocks
    (tile_pass_plain: each block's tiles gathered, the g steps run between
    their rows, scattered back) equals the steps at distances s 2^(g-1),
    ..., s one at a time, keys and payload, at s = 1 (a block across many
    2d-row blocks), s below and above a sector's rows, and s = 128 (the
    probes')."""
    rng = np.random.default_rng(8000 + 100 * wk + 10 * g + payload)
    for s in (1, 2, 16, 128):
        m = 4 * (s << g)
        keys, pay = _pairs(rng, m, wk, payload)
        dist = tuple(s << t for t in range(g - 1, -1, -1))
        for block in (1 << g, max(1 << g, min(m, 128 << g))):
            got = tile_pass_plain(keys, pay, Pass(dist, mirror), block)
            want = exchange_stages_plain(keys, pay, dist, mirror=mirror)
            assert torch.equal(got[0], want[0])
            assert not payload or torch.equal(got[1], want[1])
        block = pass_block_rows(wk, payload, g)
        got = tile_pass_plain(keys, pay, Pass(dist, mirror), block)
        want = exchange_stages_plain(keys, pay, dist, mirror=mirror)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (not payload)
        assert not payload or torch.equal(got[1], want[1])


def _route(phase, tile=4096):
    """The distances of the pair sort's phase at run tile * 2^(phase - 1):
    the mirrored step at the run, then plain steps down to the tile."""
    return [tile << t for t in range(phase - 1, -1, -1)]


def test_exchange_plan_of_the_route():
    """The route's phases of 1-12 steps at its rows (Wk 1 + payload, 11
    steps a strided-tile pass: tile_pass_steps) make one pass each but the
    last, which makes 2 of 6 steps (13 an insert, from 78 steps; 24 with
    four steps a pass before), the mirrored step first in its phase's
    first pass; at Wk 7 + payload also 11 steps a pass (12 steps: 6 + 6),
    at BitsArray's rows (Wk 2 + payload) 10, and `limit` cuts as given."""
    limit = tile_pass_steps(1, True)
    assert limit == 11
    passes = [exchange_plan(_route(k), True, 0, limit)
              for k in range(1, 13)]
    assert [len(p) for p in passes] == [1] * 11 + [2]
    assert sum(map(len, passes)) == 13
    for k, plan in zip(range(1, 13), passes):
        assert [d for ps in plan for d in ps.distances] == _route(k)
        assert [ps.mirrored for ps in plan] == [True] + [False] * (
            len(plan) - 1)
        assert all(len(ps.distances) <= limit for ps in plan)
        assert not any(ps.transposed for ps in plan)
    assert exchange_plan(_route(12), True, 0, limit) == [
        Pass(tuple(_route(12)[:6]), True), Pass(tuple(_route(12)[6:]), False)]
    assert tile_pass_steps(2, True) == 10
    assert [len(exchange_plan(_route(k), True, 0, 10)) for k in
            range(1, 11)] == [1] * 10
    assert exchange_plan(_route(12), True, 0, tile_pass_steps(1, False)) == [
        Pass(tuple(_route(12)), True)]
    assert exchange_plan(_route(5), True, 0, limit) == [
        Pass((1 << 16, 1 << 15, 1 << 14, 1 << 13, 1 << 12), True)]
    assert exchange_plan(_route(1), True) == [Pass((4096,), True)]
    wide = exchange_plan(_route(12, 1024), True, 0, tile_pass_steps(7, True))
    assert [len(ps.distances) for ps in wide] == [6, 6]
    wide = exchange_plan(_route(12, 1024), True, 0, 3)
    assert [len(ps.distances) for ps in wide] == [3, 3, 3, 3]


@pytest.mark.parametrize("dist,mirror,transposes,limit,want", [
    # isolated distances: one pass each
    ([1 << 12, 64, 1], False, 0, 4, [(1 << 12,), (64,), (1,)]),
    # runs longer than the limit, and runs broken by a jump
    ([64, 32, 16, 8, 4, 2, 1], False, 0, 4, [(64, 32, 16, 8), (4, 2, 1)]),
    ([64, 32, 16, 8, 4, 2, 1], True, 0, 3, [(64, 32, 16), (8, 4), (2, 1)]),
    ([8, 4, 16, 8, 8], False, 0, 4, [(8, 4), (16, 8), (8,)]),
    # a transposed read starts the first run; two transposes cancel
    ([512, 256, 128, 64, 32], False, 1, 4, [(512, 256, 128), (64, 32)]),
    ([512, 256, 128, 64, 32], False, 2, 4, [(512, 256, 128), (64, 32)]),
    ([512, 256], True, 1, 4, [(512, 256)]),
    # the limits of shared memory (tile_pass_steps): 12 steps at Wk 1 keys
    # only and Wk 4, 11 at Wk 1 + payload and Wk 7 + payload, 10 at Wk 2 +
    # payload and at a small M; a run of more is cut into equal passes
    ([1 << 15 >> i for i in range(16)], False, 1, 12,
     [tuple(1 << 15 >> i for i in range(8)),
      tuple(1 << 15 >> i for i in range(8, 16))]),
    ([1 << 13 >> i for i in range(12)], True, 0, 11,
     [tuple(1 << 13 >> i for i in range(6)),
      tuple(1 << 13 >> i for i in range(6, 12))]),
    ([1 << 13 >> i for i in range(12)], True, 1, 12,
     [tuple(1 << 13 >> i for i in range(12))]),
    ([1 << 14, 1 << 13, 64, 32, 16, 8, 4, 2, 1], True, 1, 11,
     [(1 << 14, 1 << 13), (64, 32, 16, 8, 4, 2, 1)]),
])
def test_exchange_plan_cuts(dist, mirror, transposes, limit, want):
    """exchange_plan as a pure function: maximal runs of consecutive
    halvings, each cut into the fewest passes of at most `limit` steps, of
    lengths that differ by at most one, the longer first, in order; only
    the first pass can be mirrored or transposed. Run through the plain
    model of a pass (tile_pass_plain, a lone step a pass of tiles of 2
    rows) the plan equals exchange_stages_plain on the whole list."""
    plan = exchange_plan(dist, mirror, transposes, limit)
    assert [ps.distances for ps in plan] == want
    assert [ps.mirrored for ps in plan] == [mirror] + [False] * (
        len(plan) - 1)
    assert [ps.transposed for ps in plan] == (
        [transposes % 2 == 1] + [False] * (len(plan) - 1))
    rng = np.random.default_rng(8100 + len(dist))
    m = max(128 * 128 if transposes else 0, 4 * max(dist))
    keys, pay = _pairs(rng, m, 2, True)
    k, p = keys, pay
    for ps in plan:
        k, p = tile_pass_plain(k, p, ps,
                               pass_block_rows(2, True, len(ps.distances)))
    want_k, want_p = exchange_stages_plain(keys, pay, dist, transposes,
                                           mirror)
    assert torch.equal(k, want_k) and torch.equal(p, want_p)


def test_tile_pass_shape():
    """The strided-tile pass's blocks (csrc/bitonic.cu StrideShape): at
    most 128 KB of rows and 1,024 threads; the steps a pass takes leave
    room for a sector's rows side by side (4 at Wk 1-2, 2 at Wk 3, 1 from
    Wk 4), and at an M that would leave half the streaming multiprocessors
    without a block of such a pass, blocks of at most SMALL_BLOCK_ROWS; a
    pass's block holds whole tiles, at least four warps and a sector's
    rows of residues side by side."""
    assert [stride_block_rows(wk, False) for wk in range(1, 8)] == [
        16384, 8192, 4096, 4096, 2048, 2048, 2048]
    assert [stride_block_rows(wk, True) for wk in range(1, 8)] == [
        8192, 4096, 4096, 2048, 2048, 2048, 2048]
    assert [tile_pass_steps(wk, False) for wk in range(1, 8)] == [
        12, 11, 11, 12, 11, 11, 11]
    assert [tile_pass_steps(wk, True) for wk in range(1, 8)] == [
        11, 10, 11, 11, 11, 11, 11]
    # row 7's probe (2^19 rows: 32 blocks of 16,384) and 2^20 rows take 10
    # steps a pass, 2^21 (128 blocks) 12; row 11's probe 10; the insert's
    # rows 11; a card of 128 multiprocessors has half of them at 2^20 rows
    assert [tile_pass_steps(1, False, 1 << k) for k in (17, 19, 20, 21, 24)
            ] == [10, 10, 10, 12, 12]
    assert tile_pass_steps(1, False, 1 << 20, sms=128) == 12
    assert tile_pass_steps(1, True, 1 << 24) == 11
    assert tile_pass_steps(7, True, 1 << 16) == 11  # blocks of 2,048 rows
    assert SMALL_BLOCK_ROWS == 4096
    for wk in range(1, 8):
        sector = 4 if wk <= 2 else 2 if wk == 3 else 1
        for payload in (False, True):
            cols = wk + payload
            log_e = 4 if cols == 1 else 3 if cols <= 4 else 2
            for g in range(1, tile_pass_steps(wk, payload) + 1):
                block = pass_block_rows(wk, payload, g)
                assert block & (block - 1) == 0 and block >= sector << g
                assert block * cols * 8 <= 128 * 1024
                assert 128 <= block >> log_e <= 1024  # threads
    # the probes' and the 2^24-row shapes: row 7, row 11, row 8's last phase
    assert pass_block_rows(1, False, 12) == 16384
    assert pass_block_rows(1, False, 10) == 4096
    assert pass_block_rows(1, True, 11) == 8192


def _warp_sectors(wk, payload, log_s, g, log_b, j, mirror, transposed):
    """The 32-byte sectors of keys and payload that warp 0's first
    register touches in layout j of a strided-tile pass, counted row by
    row (csrc/bitonic.cu StrideMap: block row r at x_v, a mirrored upper
    half reflected, a transposed read through the 128 x 128 transpose)."""
    log_e = 4 if wk + payload == 1 else 3 if wk + payload <= 4 else 2
    a_lo, log_d = min(log_b - g, log_s), log_s + g - 1
    keys, pays = set(), set()
    for t in range(32):
        r = ((t >> j) << (j + log_e)) | (t & ((1 << j) - 1))
        x = ((r & ((1 << a_lo) - 1)) + (((r >> a_lo) & ((1 << g) - 1))
                                         << log_s)
             + ((r >> (a_lo + g)) << (log_s + g)))
        if mirror and (x >> log_d) & 1:
            x ^= (1 << log_d) - 1
        if transposed:
            x = (x & ~16383) | ((x & 127) << 7) | ((x >> 7) & 127)
        keys.update(range(x * wk * 8 // 32, ((x + 1) * wk * 8 - 1) // 32 + 1))
        pays.add(x * 8 // 32)
    return len(keys) + (len(pays) if payload else 0)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("wk", [1, 2, 4])
def test_stride_layouts(wk, payload, transposed):
    """The layouts a strided-tile pass reads in and writes from: the first
    (last) steps' own, unless the layout of neighbouring block rows makes
    a warp touch fewer 32-byte sectors, mirrored or not, the read through
    the transpose or not, at every s, number of steps and block the
    kernel takes; a staged pass (through shared memory, never with the
    transpose) stays in the steps' layouts. The sectors are counted row by
    row. Rows of 4 key columns touch a sector each in every layout, so
    without a payload the steps' own always win."""
    cols = wk + payload
    log_e = 4 if cols == 1 else 3 if cols <= 4 else 2
    top_b = stride_block_rows(wk, payload).bit_length() - 1
    picks = set()
    for log_s in range(15):
        for g in range(1, tile_pass_steps(wk, payload) + 1):
            for log_b in range(max(g, log_e + 5), top_b + 1):
                a_lo, nat = min(log_b - g, log_s), log_b - log_e
                steps = []  # each group of up to log E steps' layout
                bit = a_lo + g - 1
                while bit >= a_lo:
                    steps.append(min(max(bit - log_e + 1, a_lo), nat))
                    bit = max(steps[-1], a_lo) - 1
                if not transposed:
                    assert stride_layouts(wk, payload, log_s, g, log_b,
                                          False, True) == (steps[0], steps[-1])
                j_in, j_out = stride_layouts(wk, payload, log_s, g, log_b,
                                             transposed)
                for mirror in (False, True):
                    for j, own, read in ((j_in, steps[0], True),
                                         (j_out, steps[-1], False)):
                        count = [_warp_sectors(wk, payload, log_s, g, log_b,
                                               x, mirror, read and transposed)
                                 for x in (own, nat)]
                        assert j == (nat if count[1] < count[0] else own)
                        picks.add(j == nat and nat != own)
    assert picks == ({False, True} if wk < 4 or payload else {False})


@pytest.mark.parametrize("transposes", [0, 1, 2])
@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("wk", [1, 2, 4, 7])
def test_exchange_tiles_plain_is_exchange_stages(wk, payload, transposes):
    """The card's route in plain PyTorch equals exchange_stages_plain for
    every kind of plan: runs longer than a pass (cut in two), runs broken
    by jumps, lone steps, the probes' distances, a mirrored first step or
    not, blocks wider than the array and a last block cut short, on keys
    with ties (so that a payload out of place shows)."""
    rng = np.random.default_rng(9000 + 100 * wk + 10 * transposes + payload)
    square = 128 * 128
    cases = [
        (1 << 15, [1 << 14 >> i for i in range(15)], False),
        (1 << 15, [1 << 14 >> i for i in range(15)], True),
        (1 << 15, [128 << i for i in range(6, -1, -1)], True),
        (1 << 14, [1 << 13, 64, 32, 16, 1], True),
        (1 << 14, [1], True),
        (3 << 13, [4096 >> i for i in range(13)], True),
        (3 << 13, [4096 >> i for i in range(13)], False),
    ]
    if not transposes:
        cases += [(64, [8, 4, 2, 1], True), (8, [2, 1], False),
                  (1 << 12, [4, 2], True)]
    for m, dist, mirror in cases:
        if transposes and m % square:
            m = square
        keys = torch.from_numpy(rng.integers(0, 6, (m, wk)))
        pay = torch.from_numpy(rng.integers(0, 1 << 40, m)) if payload \
            else None
        got = exchange_tiles_plain(keys, pay, dist, transposes, mirror)
        want = exchange_stages_plain(keys, pay, dist, transposes, mirror)
        assert torch.equal(got[0], want[0]), (m, dist, mirror)
        assert (got[1] is None) == (not payload)
        assert not payload or torch.equal(got[1], want[1])
