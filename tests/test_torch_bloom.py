"""jellyfish_tpu_torch.bloom (device="cpu") against jellyfish_tpu.bloom on
the same matrices and inputs (exact: integer cells and bits).

The JAX Bloom counter runs its device insert as tests/test_bloom.py runs
it (device=True, under JAX on the CPU); the port's insert sorts the probe
pairs through kernels/radix.radix_sort_pairs, here on its plain version."""

import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jellyfish_tpu.bloom as jb
import jellyfish_tpu_torch.bloom as tb
from jellyfish_tpu_torch.io.header import FileHeader

torch.set_num_threads(1)


def _mers(rng, n, k):
    W = (2 * k + 31) // 32
    mers = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64)
    top = 2 * k - 32 * (W - 1)
    mers[:, -1] &= (1 << top) - 1
    return mers.astype(np.uint32)


def _pair(k, m, nb, seed, cls_j, cls_t, **jkw):
    m1, m2 = jb._random_hash_pair(k, np.random.default_rng(seed))
    return (cls_j(m, nb, k, m1, m2, **jkw),
            cls_t(m, nb, k, m1, m2, device="cpu"))


@pytest.mark.parametrize("k", [5, 21, 40])
def test_counter_cells_match_jax(k):
    """m = 2^14 cells, 4 hashes, several batches of weights 0-3 (repeated
    mers within and across batches): the same cells, the same check."""
    rng = np.random.default_rng(100 + k)
    ref, port = _pair(k, 1 << 14, 4, 17 + k, jb.BloomCounter2,
                      tb.BloomCounter2, device=True)
    assert ref._device
    pool = _mers(rng, 900, k)
    for n in (500, 600, 700, 3):
        mers = pool[rng.integers(0, len(pool), n)]
        weights = rng.integers(0, 4, size=n).astype(np.uint32)
        ref.insert_counts(mers, weights)
        port.insert_counts(mers, weights)
        np.testing.assert_array_equal(port.cells.numpy(), ref.cells)
    assert (ref.cells == 2).any() and (ref.cells == 1).any()
    probe = np.concatenate([pool[:100], _mers(rng, 100, k)])
    np.testing.assert_array_equal(port.check(probe).numpy(),
                                  ref.check(probe))
    hit = pool[np.flatnonzero(ref.check(pool) == 2)[0]]
    v = int(sum(int(x) << (32 * w) for w, x in enumerate(hit)))
    assert port.check_int(v) == ref.check_int(v) == 2


@pytest.mark.parametrize("m", [12_345, 100_003])
def test_counter_cells_match_jax_any_m(m):
    """m no power of two (the JAX package's host insert; the port sorts
    position_bits(m) = 14 and 17 bits, two and three radix passes): the
    same cells, the same check."""
    rng = np.random.default_rng(m)
    ref, port = _pair(21, m, 5, 19, jb.BloomCounter2, tb.BloomCounter2)
    assert not ref._device and tb.position_bits(m) == m.bit_length()
    pool = _mers(rng, 1500, 21)
    for n in (900, 1200, 2):
        mers = pool[rng.integers(0, len(pool), n)]
        weights = rng.integers(0, 4, size=n).astype(np.uint32)
        ref.insert_counts(mers, weights)
        port.insert_counts(mers, weights)
        np.testing.assert_array_equal(port.cells.numpy(), ref.cells)
    assert (ref.cells == 2).any() and (ref.cells == 1).any()
    probe = np.concatenate([pool[:100], _mers(rng, 100, 21)])
    np.testing.assert_array_equal(port.check(probe).numpy(),
                                  ref.check(probe))


def test_position_bits():
    """The insert sorts the bits a position into m cells can hold: all 64,
    as signed, above m = 2^63, where positions may be negative patterns."""
    assert [tb.position_bits(m) for m in (1, 2, 3, 1 << 30, (1 << 30) + 1,
                                          1 << 63, (1 << 63) + 1)] == [
        1, 1, 2, 30, 31, 63, 64]


def test_counter_insert_device_tensors_and_zero_weights():
    """Mers and weights as device tensors (the bc path), an all-zero batch
    and an empty one: nothing is added for weight 0."""
    ref, port = _pair(21, 1 << 12, 3, 5, jb.BloomCounter2, tb.BloomCounter2,
                      device=True)
    rng = np.random.default_rng(6)
    mers = _mers(rng, 300, 21)
    w = rng.integers(0, 3, 300).astype(np.uint32)
    port.insert_counts(torch.from_numpy(mers.astype(np.int64)),
                       torch.from_numpy(w.astype(np.int64)))
    port.insert_counts(mers, np.zeros(300, np.uint32))
    port.insert_counts(mers[:0], np.zeros(0, np.uint32))
    ref.insert_counts(mers, w)
    np.testing.assert_array_equal(port.cells.numpy(), ref.cells)


@pytest.mark.parametrize("m", [1 << 14, 12345, 7, 5])
def test_base3_pack_and_unpack(m):
    """5 cells a byte, base 3 (bloom_counter2.hpp:40-43), both ways."""
    rng = np.random.default_rng(m)
    cells = rng.integers(0, 3, m).astype(np.uint8)
    m1, m2 = jb._random_hash_pair(11, rng)
    ref = jb.BloomCounter2(m, 2, 11, m1, m2, cells=cells.copy())
    port = tb.BloomCounter2(m, 2, 11, m1, m2, cells=torch.from_numpy(cells),
                            device="cpu")
    packed = port.packed_bytes()
    assert port.nb_bytes() == ref.nb_bytes() == len(packed)
    np.testing.assert_array_equal(packed, ref.packed_bytes())
    back = tb.BloomCounter2.unpack_bytes(torch.from_numpy(packed), m)
    np.testing.assert_array_equal(back.numpy(), cells)
    np.testing.assert_array_equal(
        back.numpy(), jb.BloomCounter2.unpack_bytes(packed, m))


@pytest.mark.parametrize("k,m", [(21, 1 << 14), (33, 10007)])
def test_bc_file_write_and_read_byte_equal(tmp_path, monkeypatch, k, m):
    """write_bloom_counter writes the JAX package's bytes (header apart
    from exe_path, pwd and cmdline); each package reads the other's
    file."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    rng = np.random.default_rng(k)
    ref, port = _pair(k, m, 3, 40 + k, jb.BloomCounter2, tb.BloomCounter2,
                      canonical=True)
    port.canonical = True
    mers = _mers(rng, 2000, k)
    w = rng.integers(0, 4, 2000).astype(np.uint32)
    ref.insert_counts(mers, w)
    port.insert_counts(mers, w)
    pt, pj = str(tmp_path / "t.bc"), str(tmp_path / "j.bc")
    tb.write_bloom_counter(port, pt, cmdline=["bc"])
    jb.write_bloom_counter(ref, pj, cmdline=["bc"])
    parts = []
    for p in (pt, pj):
        with open(p, "rb") as f:
            data = f.read()
        h = FileHeader.read(io.BytesIO(data))
        for key in ("exe_path", "pwd", "cmdline"):
            h.root.pop(key, None)
        parts.append((h.root, data[h.offset:]))
    assert parts[0] == parts[1]
    back = tb.read_bloom_counter(pj, device="cpu")
    assert (back.m, back.nb_hashes, back.k, back.canonical) == (m, 3, k, True)
    for a, b in ((back.m1, ref.m1), (back.m2, ref.m2)):
        np.testing.assert_array_equal(a.bit_matrix(), b.bit_matrix())
    np.testing.assert_array_equal(back.cells.numpy(), ref.cells)
    np.testing.assert_array_equal(jb.read_bloom_counter(pt).cells, ref.cells)


class _SizeOnly(jb.BloomCounter2):
    """The JAX package's BloomCounter2 without its m cells: only m."""

    def __init__(self, m, nb_hashes, k, m1, m2, canonical=False, cells=None,
                 device=False):
        self.m, self.device = m, device


@pytest.mark.parametrize("fpr,n,rounded", [
    (0.001, 1000, True),
    (0.001, (1 << 32) // 14 - 5, True),   # rounds up to exactly 2^32
    (0.001, (1 << 32) // 14 + 5, False),  # 2^33 would be above: opt_m
    (0.01, 10**9, False),
])
def test_from_fpr_size_across_2_32(fpr, n, rounded):
    """from_fpr's m: the JAX package rounds opt_m up to a power of two
    when that is at most 2^32 and keeps opt_m above (computed here without
    allocating m cells)."""
    want = _SizeOnly.from_fpr(fpr, n, 21, rng=np.random.default_rng(1),
                              device=True).m
    got = tb.BloomCounter2.size_for(fpr, n)
    assert got == want
    if rounded:
        assert got & (got - 1) == 0 and got <= 1 << 32
    else:
        assert got == tb.opt_m(fpr, n) > 1 << 32


@pytest.mark.parametrize("k,m", [(13, 50_000), (21, 1 << 16), (40, 77_777)])
def test_bloom_filter_insert_batch_matches_jax(k, m):
    """Presence before each batch and the bits after it, batches of
    distinct mers that overlap earlier ones."""
    ref, port = _pair(k, m, 7, 60 + k, jb.BloomFilter, tb.BloomFilter)
    rng = np.random.default_rng(k)
    pool = np.unique(_mers(rng, 3000, k), axis=0)
    for lo, hi in ((0, 1000), (500, 2000), (0, 2900), (10, 10)):
        a = pool[lo:hi]
        np.testing.assert_array_equal(port.insert_batch(a).numpy(),
                                      ref.insert_batch(a))
        np.testing.assert_array_equal(port.bits.numpy(), ref.bits)
    assert ref.bits.any()


@pytest.mark.parametrize("m", [12345, 10**9 + 7, (1 << 46) + 3,
                               (1 << 47) - 1, 1 << 33])
def test_probe_positions_of_any_m(m):
    """m not a power of two up to 2^32: h0 % m, h1 % m and (base + i*inc)
    % m through the unsigned reduction (bloom.umod), equal to the JAX
    package's uint64 arithmetic (hashes >= 2^63 included)."""
    ref, port = _pair(21, m, 9, 70, jb._BloomBase, tb._BloomBase)
    mers = _mers(np.random.default_rng(7), 4000, 21)
    got = port.probe_positions(mers).numpy()
    want = ref.probe_positions(mers)
    np.testing.assert_array_equal(got, want)
    h0, _ = ref.hashes_np(mers)
    assert (h0 >= np.uint64(1 << 63)).any()


def test_mod_u64_near_2_46():
    """The reduction alone against numpy's uint64 %, m near 2^46, over
    values spanning all 64 bits."""
    rng = np.random.default_rng(46)
    v = rng.integers(0, 1 << 64, 5000, dtype=np.uint64, endpoint=False)
    v[:4] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    limbs = np.stack([v & np.uint64(0xFFFFFFFF), v >> np.uint64(32)], 1)
    t = torch.from_numpy(limbs.astype(np.int64))
    for m in ((1 << 46) - 1, (1 << 46) + 12345, (1 << 47) - 1, 3):
        np.testing.assert_array_equal(tb.mod_u64(t, m).numpy(),
                                      (v % np.uint64(m)).astype(np.int64))


def test_filters_of_2_47_cells_raise(tmp_path):
    """Bloom structures of m >= 2^47 positions no longer raise: the probe
    positions equal the JAX package's uint64 formula at m = 2^47, 2^47 +
    12345, 2^52 and 2^63 + 5 (sums and products wrapping mod 2^64, and
    positions >= 2^63 cast to int64 alike), on small hash tensors spanning
    all 64 bits; a header-only .bc file of 2^47 cells reads as in the JAX
    package. No filter of that size is allocated."""
    rng = np.random.default_rng(47)
    h = rng.integers(0, 1 << 64, (2, 3000), dtype=np.uint64, endpoint=False)
    h[:, :3] = [[0, (1 << 64) - 1, 1 << 63], [(1 << 64) - 1, 1 << 63, 7]]
    limbs = [torch.from_numpy(np.stack([x & np.uint64(0xFFFFFFFF),
                                        x >> np.uint64(32)], 1)
                              .astype(np.int64)) for x in h]
    for m in (1 << 47, (1 << 47) + 12345, 1 << 52, (1 << 63) + 5):
        ref = SimpleNamespace(m=m, nb_hashes=9,
                              hashes_np=lambda _, h=h: (h[0], h[1]))
        want = jb._BloomBase.probe_positions(ref, None)
        got = tb.probe_positions(*limbs, m, 9).numpy()
        np.testing.assert_array_equal(got, want)
    assert (want < 0).any()  # positions >= 2^63 at m = 2^63 + 5

    m1, m2 = jb._random_hash_pair(21, np.random.default_rng(0))
    hdr = FileHeader()
    hdr.format = FileHeader.FORMAT_BLOOM
    hdr.key_len = 42
    hdr.set_matrix(m1, 1)
    hdr.set_matrix(m2, 2)
    hdr.size = 1 << 47
    hdr.nb_hashes = 3
    path = tmp_path / "huge.bc"
    with open(path, "wb") as f:
        hdr.write(f)

    def outcome(read):
        """What reading the file gives: the exception's type (the read
        asks for m / 5 bytes at once: a MemoryError where the host does
        not overcommit), or the structure's shape and a query's error."""
        try:
            bc = read()
        except MemoryError as e:
            return type(e)
        mer = _mers(np.random.default_rng(1), 1, 21)
        with pytest.raises(IndexError):
            bc.check(mer)
        return bc.m, bc.nb_hashes, bc.k, len(bc.cells)

    want = outcome(lambda: jb.read_bloom_counter(str(path)))
    assert outcome(lambda: tb.read_bloom_counter(str(path),
                                                 device="cpu")) == want
    assert want in (MemoryError, (1 << 47, 3, 21, 0))


@pytest.mark.parametrize("kind", ["bc", "bf"])
def test_count_filters_match_jax(tmp_path, kind):
    """load_count_filter: --bc keeps a count when the check is 2, --bf-size
    drops a mer's first occurrence; rows of count 0 stay 0 and never touch
    the filter."""
    k = 17
    rng = np.random.default_rng(80)
    pool = np.unique(_mers(rng, 4000, k), axis=0)
    kw = dict(k=k, canonical=False)
    if kind == "bc":
        bc = jb.BloomCounter2(1 << 13, 4, k,
                              *jb._random_hash_pair(k, rng), device=True)
        bc.insert_counts(pool[:2000], rng.integers(0, 4, 2000).astype(
            np.uint32))
        path = str(tmp_path / "f.bc")
        jb.write_bloom_counter(bc, path)
        ref = jb.load_count_filter(bc_path=path, **kw)
        port = tb.load_count_filter(bc_path=path, device="cpu", **kw)
    else:
        ref = jb.load_count_filter(bf_size=30_011, bf_fp=0.05,
                                   rng=np.random.default_rng(3), **kw)
        port = tb.load_count_filter(bf_size=30_011, bf_fp=0.05,
                                    rng=np.random.default_rng(3),
                                    device="cpu", **kw)
    for lo in (0, 1500, 500):
        mers = pool[lo:lo + 1500]
        counts = rng.integers(0, 5, len(mers)).astype(np.uint64)
        want = ref(mers, counts)
        got = port(torch.from_numpy(mers.astype(np.int64)),
                   torch.from_numpy(counts.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert (want[counts == 0] == 0).all() and (want > 0).any()
