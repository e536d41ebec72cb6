"""The scripting API of jellyfish_tpu_torch (MerDNA, HashCounter, HashSet,
QueryMerFile, ReadMerFile, string_mers, string_canonicals) against
jellyfish_tpu's: the same calls give the same values. Databases are
written by the port's CLI on the CPU; a Bloom counter is read with
device="cpu"."""

import numpy as np
import pytest
import torch

import jellyfish_tpu as jref
import jellyfish_tpu_torch as jt
from jellyfish_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)


def _dna(rng, n, with_n=False):
    alphabet = "ACGTN" if with_n else "ACGT"
    p = [0.2475] * 4 + [0.01] if with_n else None
    return "".join(rng.choice(list(alphabet), n, p=p))


def _same(a, b):
    assert (type(a).__name__, a.k, a.bits, str(a)) == (
        type(b).__name__, b.k, b.bits, str(b))


@pytest.mark.parametrize("k", [1, 5, 21, 32, 33, 63])
def test_merdna_matches_jax(k):
    rng = np.random.default_rng(k)
    s = _dna(rng, k)
    a, b = jt.MerDNA(s), jref.MerDNA(s)
    _same(a, b)
    for base in "ACGTN":
        assert a.shift_left(base) == b.shift_left(base)
        _same(a, b)
        assert a.shift_right(base) == b.shift_right(base)
        _same(a, b)
    assert a.shift_left(2) == b.shift_left(2)
    _same(a.get_reverse_complement(), b.get_reverse_complement())
    _same(a.get_canonical(), b.get_canonical())
    for op in ("reverse_complement", "canonicalize", "polyA", "polyC",
               "polyG", "polyT"):
        getattr(a, op)()
        getattr(b, op)()
        _same(a, b)
        assert a.is_homopolymer() == b.is_homopolymer()
    a.randomize(np.random.default_rng(9))
    b.randomize(np.random.default_rng(9))
    _same(a, b)
    assert [a[i] for i in range(k)] == [b[i] for i in range(k)]
    a.set_base(0, "G")
    b.set_base(0, "G")
    _same(a, b)
    for start, length in ((0, 2 * k), (1, 3), (k, k)):
        assert a.get_bits(start, length) == b.get_bits(start, length)
        a.set_bits(start, length, 0b1011011)
        b.set_bits(start, length, 0b1011011)
        _same(a, b)
    assert a.to_bytes() == b.to_bytes()
    _same(jt.MerDNA.from_bytes(k, a.to_bytes()),
          jref.MerDNA.from_bytes(k, b.to_bytes()))
    assert (a.nb_words(), a.word(0), a.nb_words(32)) == (
        b.nb_words(), b.word(0), b.nb_words(32))
    c, d = jt.MerDNA(k, a.bits ^ 1), jref.MerDNA(k, b.bits ^ 1)
    assert (a < c, a <= c, a > c, a >= c, a == c, a == a.dup()) == (
        b < d, b <= d, b > d, b >= d, b == d, b == b.dup())
    assert hash(a) == hash(a.dup()) and len({a, a.dup(), c}) == 2
    assert repr(a) == repr(b).replace("jellyfish_tpu.", "")


def test_global_k_and_string_mers():
    rng = np.random.default_rng(5)
    for mod in (jt, jref):
        mod.MerDNA.k(17)
        assert mod.MerDNA.k() == 17 and str(mod.MerDNA()) == "A" * 17
    s = _dna(rng, 300, with_n=True)
    for f in ("string_mers", "string_canonicals"):
        got = [m.bits for m in getattr(jt, f)(s)]
        assert got == [m.bits for m in getattr(jref, f)(s)]
        assert got == [m.bits for m in getattr(jt, f)(s, 17)] and got
    assert [m.bits for m in jt.string_mers(s, 9)] == [
        m.bits for m in jref.string_mers(s, 9)]


def test_hash_counter_and_set_match_jax():
    out = []
    for mod in (jt, jref):
        mod.MerDNA.k(11)
        h, hs = mod.HashCounter(1024, 5), mod.HashSet(256)
        log = [h.size(), h.val_len(), hs.size()]
        mers = [mod.MerDNA(_dna(np.random.default_rng(i), 11))
                for i in range(20)]
        for i, m in enumerate(mers):
            log += [h.get(m), h.update_add(m, 3), hs.get(m), hs[m]]
            if i % 3:
                h.add(m, i)
                hs.add(m)
            log += [h[m], h.update_add(m, 2), h.get(m), hs.get(m)]
        log.append(sorted((m.bits, c) for m, c in h))
        out.append(log)
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    rng = np.random.default_rng(7)
    fa = d / "s.fa"
    fa.write_text("".join(f">r{i}\n{_dna(rng, 500, with_n=True)}\n"
                          for i in range(6)))
    out = {}
    for k in (17, 40):
        out[k] = str(d / f"s{k}.jf")
        assert torch_main(["count", "-m", str(k), "-s", "10k", "-C",
                           "-o", out[k], str(fa)], device="cpu") == 0
    out["bc"] = str(d / "s.bc")
    assert torch_main(["bc", "-m", "17", "-s", "10k", "-C", "-o", out["bc"],
                       str(fa)], device="cpu") == 0
    return out


@pytest.mark.parametrize("k", [17, 40])
def test_read_mer_file_matches_jax(dbs, k):
    got = [(m.bits, c) for m, c in jt.ReadMerFile(dbs[k])]
    assert got == [(m.bits, c) for m, c in jref.ReadMerFile(dbs[k])]
    assert len(got) > 1000 and jt.MerDNA.k() == k
    r = jt.ReadMerFile(dbs[k])
    assert r.next_mer() and (r.mer().bits, r.count()) == got[0]


@pytest.mark.parametrize("db", [17, 40, "bc"])
def test_query_mer_file_matches_jax(dbs, db):
    q, ref = jt.QueryMerFile(dbs[db], device="cpu"), jref.QueryMerFile(
        dbs[db])
    k = jt.MerDNA.k()
    assert q.canonical == ref.canonical
    rng = np.random.default_rng(8)
    mers = [m for m, _ in jt.ReadMerFile(dbs[17 if db == "bc" else db])]
    mers = mers[:200] + [jt.MerDNA(_dna(rng, k)) for _ in range(50)]
    got = [q[m.get_canonical()] for m in mers]
    want = [ref.get(jref.MerDNA(str(m)).get_canonical()) for m in mers]
    assert got == want and sum(v > 0 for v in got) >= 200


def test_query_bloom_counter_without_card_raises(dbs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jt.QueryMerFile(dbs["bc"])
