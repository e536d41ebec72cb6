"""The port's merge_files (device streaming merge, on the CPU through the
kernels' plain versions) against jellyfish_tpu.merge.merge_files on the
same databases: the output bytes are equal.

Inputs are written with the JAX package's writers, in the reference's
(pos, key) order computed by GF2Matrix.times, from numpy seeds. Each key
occurs at most once per input, most keys in several inputs. Windows of a
few dozen rows make every merge run many rounds and rotate every slab.
"""

import io

import numpy as np
import pytest
import torch

import jellyfish_tpu_torch.merge as port_merge
from jellyfish_tpu_torch.io.header import FileHeader
from jellyfish_tpu_torch.kernels.window import roll_lanes, window_rows
from jellyfish_tpu_torch.merge import MergeError, MergeOp, merge_files

torch.set_num_threads(1)

# name: (k, size, identity matrix, with the mer whose sortkey is all ones)
CONFIGS = {
    "k11": (11, 1 << 10, False, False),
    "k21": (21, 1 << 12, False, False),
    "k33-lsize40": (33, 1 << 40, False, False),
    "k63": (63, 1 << 14, False, False),
    "k100": (100, 1 << 16, False, False),
    "k11-identity": (11, 4 ** 11, True, False),
    "k32-allones": (32, 1 << 12, False, True),
    "k48-allones": (48, 1 << 10, False, True),
}
# name: (op, min_count, max_count)
OPS = {
    "sum": ("SUM", 0, None),
    "sum-L2-U6": ("SUM", 2, 6),
    "min": ("MIN", 1, None),
    "min-L0": ("MIN", 0, None),
    "max-U5": ("MAX", 0, 5),
    "jaccard": ("JACCARD", 0, None),
}


def _jax_matrix(k, size, identity, seed):
    from jellyfish_tpu.gf2 import GF2Matrix

    lsize = (size - 1).bit_length()
    if identity:
        return GF2Matrix.identity(2 * k)
    return GF2Matrix.random_invertible(lsize, 2 * k,
                                       np.random.default_rng(seed))


def _all_ones_mer(k, size, matrix):
    """The mer whose sortkey (pos, key >> l) is all ones: every high key
    bit set, and the low bits whose hash is all ones."""
    lsize = (size - 1).bit_length()
    high = ((1 << (2 * k - lsize)) - 1) << lsize
    mask = size - 1
    for low in range(1 << lsize):
        if matrix.times(high | low) & mask == mask:
            return high | low
    raise AssertionError("no mer hashes to all ones")


def write_db(path, k, size, matrix, mers, counts, counter_len=4, text=False):
    """A sorted database of (mer, count) records, written by the JAX
    package."""
    from jellyfish_tpu.io.files import (
        make_count_header,
        write_binary_records,
        write_text_records,
    )

    mask = size - 1
    order = sorted(range(len(mers)),
                   key=lambda i: (matrix.times(int(mers[i])) & mask,
                                  int(mers[i])))
    fmt = FileHeader.FORMAT_TEXT if text else FileHeader.FORMAT_BINARY
    h = make_count_header(k=k, size=size, matrix=matrix, canonical=False,
                          fmt=fmt, counter_len_bytes=counter_len)
    keys = [int(mers[i]) for i in order]
    vals = [int(counts[i]) for i in order]
    with open(path, "wb") as f:
        h.write(f)
        if text:
            write_text_records(f, keys, vals, k)
        else:
            write_binary_records(f, keys, vals, k, counter_len)


def make_inputs(d, name, n_files=4, pool=1500, seed=0, counter_len=4,
                text=False, count_hi=12):
    k, size, identity, all_ones = CONFIGS[name]
    rng = np.random.default_rng(seed + 17 * k)
    matrix = _jax_matrix(k, size, identity, seed + k)
    mers = set()
    while len(mers) < pool:
        v = 0
        for _ in range(0, 2 * k, 30):
            v = (v << 30) | int(rng.integers(0, 1 << 30))
        mers.add(v & ((1 << (2 * k)) - 1))
    mers = sorted(mers)
    if all_ones:
        mers[0] = _all_ones_mer(k, size, matrix)
    paths = []
    for i in range(n_files):
        take = rng.random(pool) < 0.6
        if all_ones:
            take[0] = i % 2 == 0   # the all-ones key in some inputs only
        sel = [m for m, t in zip(mers, take) if t]
        cnt = rng.integers(1, count_hi, len(sel))
        p = str(d / f"{name}-{seed}-{i}.jf")
        write_db(p, k, size, matrix, sel, cnt, counter_len, text)
        paths.append(p)
    return paths


def _jax_merge(paths, out, op, lo, hi):
    from jellyfish_tpu import merge as jm

    jm.merge_files(paths, out, min_count=lo, max_count=hi,
                   op=jm.MergeOp[op])


def _port_merge(paths, out, op, lo, hi):
    return merge_files(paths, out, min_count=lo, max_count=hi,
                       op=MergeOp[op], device="cpu")


def _small_windows(monkeypatch, window, slab):
    """Merges in rounds of `window` rows an input, in slabs of `slab`."""
    monkeypatch.setattr(port_merge, "WINDOW_ROWS", window)
    monkeypatch.setattr(port_merge, "SLAB_ROWS", slab)


def _body(path):
    """(header root without exe_path, record bytes) of a database."""
    with open(path, "rb") as f:
        data = f.read()
    h = FileHeader.read(io.BytesIO(data))
    root = dict(h.root)
    root.pop("exe_path", None)
    return root, data[h.offset:]


def _assert_same(a, b, op):
    if op == "JACCARD":
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        return
    ha, ra = _body(a)
    hb, rb = _body(b)
    assert ra == rb
    assert ha == hb


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("merge_in")
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = make_inputs(d, name, **kw)
        return cache[key]

    return get


@pytest.fixture(autouse=True)
def _epoch(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")


@pytest.mark.parametrize("opname", list(OPS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_merge_matches_jax(inputs, tmp_path, monkeypatch, name, opname):
    """Every op and filter at every key width: the default window (one
    round) and a 48-row window in a 96-row slab (dozens of rounds, every
    slab rotated) give the JAX package's bytes."""
    op, lo, hi = OPS[opname]
    paths = inputs(name)
    want = str(tmp_path / "jax.jf")
    _jax_merge(paths, want, op, lo, hi)
    got = str(tmp_path / "port.jf")
    stats = _port_merge(paths, got, op, lo, hi)
    _assert_same(got, want, op)
    assert stats["rounds"] == 1 and stats["rolls"] == [0] * 4
    window_rows.launches = roll_lanes.launches = 0
    _small_windows(monkeypatch, 48, 96)
    stats = _port_merge(paths, got, op, lo, hi)
    _assert_same(got, want, op)
    assert stats["rounds"] > 20 and min(stats["rolls"]) >= 5
    assert stats["records_in"] > 3000
    assert window_rows.launches == roll_lanes.launches == 0  # CPU: plain


@pytest.mark.parametrize("window,slab", [(1, 1), (7, 7), (64, 1000),
                                         (300, 301)])
def test_merge_window_sizes(inputs, tmp_path, monkeypatch, window, slab):
    """Windows of one row, windows equal to the slab, and odd sizes."""
    paths = inputs("k21")[:3]
    want = str(tmp_path / "jax.jf")
    _jax_merge(paths, want, "SUM", 0, None)
    got = str(tmp_path / "port.jf")
    _small_windows(monkeypatch, window, slab)
    _port_merge(paths, got, "SUM", 0, None)
    _assert_same(got, want, "SUM")


@pytest.mark.parametrize("counter_lens,hi,opname", [
    ((1, 1, 1), 250, "SUM"),        # sums saturate at 255 when written
    ((1, 2, 4), 300, "MAX"),        # out_counter_len is the least one
    ((8, 8, 8), 1 << 63, "SUM"),    # 64-bit sums wrap; -U compares u64
    ((8, 8, 8), 1 << 64, "MIN"),
])
def test_merge_counter_saturation(tmp_path, monkeypatch, counter_lens, hi,
                                  opname):
    k, size = 21, 1 << 12
    matrix = _jax_matrix(k, size, False, 5)
    rng = np.random.default_rng(99)
    pool = rng.choice(1 << 42, 800, replace=False)
    paths = []
    for i, cl in enumerate(counter_lens):
        sel = pool[rng.random(800) < 0.7]
        top = min(1 << (8 * cl), hi)
        cnt = [int(x) for x in rng.integers(top // 2, top, len(sel),
                                            dtype=np.uint64)]
        p = str(tmp_path / f"s{i}.jf")
        write_db(p, k, size, matrix, sel, cnt, cl)
        paths.append(p)
    _small_windows(monkeypatch, 32, 64)
    for lo, up in ((0, None), (hi // 3, (1 << 64) - 2)):
        want, got = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
        _jax_merge(paths, want, opname, lo, up)
        _port_merge(paths, got, opname, lo, up)
        _assert_same(got, want, opname)


@pytest.mark.parametrize("opname", ["sum", "min", "max-U5", "jaccard"])
def test_merge_text_inputs(tmp_path, opname):
    """Text databases take the host heap merge."""
    op, lo, hi = OPS[opname]
    paths = make_inputs(tmp_path, "k21", n_files=3, pool=300, text=True)
    want, got = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
    _jax_merge(paths, want, op, lo, hi)
    assert _port_merge(paths, got, op, lo, hi) is None
    with open(got, "rb") as fa, open(want, "rb") as fb:
        a, b = fa.read(), fb.read()
    if op == "JACCARD":
        assert a == b
    else:
        assert _body(got)[1] == _body(want)[1] and len(a) > 1000


def _header_variant(tmp_path, name, **change):
    """A one-record database like the k21 inputs but for `change`."""
    k, size, matrix = 21, 1 << 12, _jax_matrix(21, 1 << 12, False, 21)
    counter_len, text = 4, False
    if "k" in change:
        k = change["k"]
        matrix = _jax_matrix(k, size, False, 1)
    if "size" in change:
        size = change["size"]
        matrix = _jax_matrix(k, size, False, 1)
    if "seed" in change:
        matrix = _jax_matrix(k, size, False, change["seed"])
    text = change.get("text", False)
    p = str(tmp_path / f"{name}.jf")
    write_db(p, k, size, matrix, [12345], [3], counter_len, text)
    if "reprobes" in change:
        from jellyfish_tpu.io.header import FileHeader as JaxHeader

        with open(p, "rb") as f:
            data = f.read()
        h = JaxHeader.read(io.BytesIO(data))
        h.max_reprobe = h.max_reprobe - 1
        with open(p, "wb") as f:
            h.write(f)
            f.write(data[h.offset:])
    return p


@pytest.mark.parametrize("change", [
    {"text": True}, {"k": 22}, {"reprobes": True}, {"size": 1 << 13},
    {"seed": 77},
], ids=["format", "key_len", "reprobes", "size", "matrix"])
def test_merge_header_mismatch(tmp_path, change):
    """Each header check raises MergeError with the JAX package's message,
    before any device work (device=None on a host without a card)."""
    from jellyfish_tpu import merge as jm

    a = _header_variant(tmp_path, "a")
    b = _header_variant(tmp_path, "b", **change)
    with pytest.raises(jm.MergeError) as want:
        jm.merge_files([a, b], str(tmp_path / "j.jf"))
    with pytest.raises(MergeError) as got:
        merge_files([a, b], str(tmp_path / "t.jf"))
    assert str(got.value) == str(want.value)


def test_merge_without_card_raises(tmp_path, monkeypatch):
    a = _header_variant(tmp_path, "a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        merge_files([a, a], str(tmp_path / "t.jf"))


def test_merge_empty_and_single(tmp_path):
    """An input with no records, and one input alone."""
    k, size = 21, 1 << 12
    matrix = _jax_matrix(k, size, False, 21)
    e = str(tmp_path / "e.jf")
    write_db(e, k, size, matrix, [], [])
    a = _header_variant(tmp_path, "a")
    for paths in ([e, e], [e, a], [a]):
        want, got = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
        _jax_merge(paths, want, "SUM", 0, None)
        _port_merge(paths, got, "SUM", 0, None)
        _assert_same(got, want, "SUM")


def test_merge_skips_used_up_inputs(tmp_path, monkeypatch):
    """An input whose rows are all taken gets no more windows: a short
    input holding the first 10 keys of a long one is windowed in the first
    two rounds only."""
    k, size = 21, 1 << 12
    matrix = _jax_matrix(k, size, False, 3)
    rng = np.random.default_rng(4)
    mers = [int(m) for m in rng.choice(1 << 42, 500, replace=False)]
    mers.sort(key=lambda m: (matrix.times(m) & (size - 1), m))
    paths = [str(tmp_path / "short.jf"), str(tmp_path / "long.jf")]
    write_db(paths[0], k, size, matrix, mers[:10], [2] * 10)
    write_db(paths[1], k, size, matrix, mers, rng.integers(1, 9, 500))
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return window_rows(*a, **kw)

    monkeypatch.setattr(port_merge, "window_rows", counted)
    _small_windows(monkeypatch, 8, 16)
    want, got = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
    _jax_merge(paths, want, "SUM", 0, None)
    stats = _port_merge(paths, got, "SUM", 0, None)
    _assert_same(got, want, "SUM")
    assert stats["rounds"] == 500 // 8 + 1
    assert len(calls) == stats["rounds"] + 2
