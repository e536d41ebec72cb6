"""The plain count against a brute-force count, the table arithmetic and
the control at a size a test run holds."""

import collections

import numpy as np
import pytest
import torch

from jfbench.reference import count as ref
from jfbench.traffic import reads

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
SPEC = {"genome_bases": 3000, "read_len": 150, "reverse_share": 0.5,
        "chunk_len": 1024, "chunks_per_job": 6, "batch": 2,
        "error_model": "uniform_substitution", "error_rate": 0.02}


def brute(codes, k):
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = collections.Counter()
    for row in codes.numpy():
        s = ASCII[row].tobytes()
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if b"N" in w:
                continue
            out[min(w, w.translate(comp)[::-1])] += 1
    return out


def as_strings(cols, k):
    out = []
    for row in cols.tolist():
        s = ""
        for (a, e), v in zip(ref.spans(k), row):
            s += "".join("ACGT"[(v >> (2 * (e - a - 1 - j))) & 3]
                         for j in range(e - a))
        out.append(s.encode())
    return out


def tiny_codes(seed=5):
    t = reads.Traffic(SPEC)
    return t, torch.cat([c for _, c in reads.make_codes(t, seed, "cpu")])


@pytest.mark.parametrize("k", [5, 21, 31, 32, 63, 100])
@pytest.mark.parametrize("parts", [1, 4])
def test_count_against_brute_force(k, parts):
    _, codes = tiny_codes()
    r = ref.Reference.count([codes[:3], codes[3:]], k, parts)
    got = {}
    for cols, counts in r.tables:
        got.update(zip(as_strings(cols, k), counts.tolist()))
    assert got == dict(brute(codes, k))
    assert r.mers() == reads.valid_windows(codes, k)


@pytest.mark.parametrize("k", [21, 32, 63, 127])
def test_columns_of_limbs(k):
    g = np.random.default_rng(k)
    vals = [int(x) for x in g.integers(0, 2**62, 40)]
    vals = [(v << 64 | v * 7 + 3) % (1 << 2 * k) for v in vals]
    W = -(-2 * k // 32)
    limbs = torch.tensor([[(v >> 32 * w) & 0xFFFFFFFF for w in range(W)]
                          for v in vals], dtype=torch.int64)
    cols = ref.columns_of_limbs(limbs, k)
    for v, row in zip(vals, cols.tolist()):
        back = 0
        for (a, e), c in zip(ref.spans(k), row):
            back = back << 2 * (e - a) | c
        assert back == v


def test_diff_rows_counts_a_multiset_difference():
    a = torch.tensor([[1], [2], [3], [5]])
    ac = torch.tensor([4, 1, 2, 9])
    b = torch.tensor([[1], [2], [3], [4]])
    bc = torch.tensor([4, 1, 3, 7])
    # 3 differs in count (2 rows), 5 only in A, 4 only in B
    assert ref.diff_rows(a, ac, b, bc) == 4
    assert ref.diff_rows(a, ac, a, ac) == 0
    assert ref.diff_rows(a[:0], ac[:0], b, bc) == 4
    # a key held twice by one side
    assert ref.diff_rows(torch.cat([a, a[:1]]), torch.cat([ac, ac[:1]]),
                         a, ac) == 1


def test_diff_of_tables_by_part():
    _, codes = tiny_codes()
    r = ref.Reference.count([codes], 21, 4)
    cols = torch.cat([c for c, _ in r.tables])
    counts = torch.cat([c for _, c in r.tables])
    g = torch.Generator().manual_seed(1)
    perm = torch.randperm(cols.shape[0], generator=g)
    assert r.diff(cols[perm], counts[perm]) == 0
    bumped = counts.clone()
    bumped[7] += 1
    assert r.diff(cols, bumped) == 2
    assert r.diff(cols[1:], counts[1:]) == 1


def test_control_fails_at_test_size():
    """The control (identity held in a 32-bit fingerprint) at about 2.6M
    windows of 2.1M distinct mers: about 500 colliding pairs expected."""
    t = reads.Traffic(dict(SPEC, genome_bases=1_500_000, chunk_len=65536,
                           chunks_per_job=40, error_rate=0.01))
    r = ref.Reference.count((c for _, c in reads.make_codes(t, 9, "cpu")),
                            21, 2)
    cols, counts = ref.fingerprint_table(r)
    d = r.diff(cols, counts)
    assert d > 100
    assert int(counts.sum()) == r.mers()


def test_fingerprint_of_wide_bits_is_the_count():
    _, codes = tiny_codes()
    r = ref.Reference.count([codes], 21, 2)
    cols, counts = ref.fingerprint_table(r, bits=62)
    assert r.diff(cols, counts) == 0


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["k21.q20"])
def test_control_fails_at_the_cells_size(cuda, cell):
    """The control on three seeds at the cell's own size, on the card."""
    import json

    from jfbench import harness, readings

    bench = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = harness.load_json(harness.BENCH, "configs", entry["config"])
    t = reads.Traffic(harness.load_json(harness.BENCH, "workloads",
                                        entry["traffic"]))
    for seed in (2**31 + 7001, 2**31 + 7002, 2**31 + 7003):
        d, rows = readings.control_diff(t, cfg["k"], seed, cuda,
                                        harness.reference_parts(t))
        assert d > 0.001 * rows
