"""The long-k count through the counter's normal entry, at k = 55 (keys
of four 32-bit limbs: the plain multi-limb pipeline, the grain sort by
K3 block_sort and K1 merge passes, Wk-4 merges and finalize), canonical
and hashed, against the benchmark's plain count (jfbench/reference),
with k = 21 as the control; and the counts of the `store.sort` span and
of `finalize.merge`'s `pads`.

The input is a tiny seeded `k55.q30` traffic (jfbench/workloads): 150-base
Q30 reads of a small genome in chunks of 4,096 bases. The store runs with
a small grain, so that a job makes several grains."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jellyfish_tpu_torch.kernels.sort as sort_mod
from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.kernels.bitonic import tile_rows
from jellyfish_tpu_torch.kernels.sort import merge_passes
from jellyfish_tpu_torch.ops.count import sort_passes
from jfbench import harness
from jfbench.reference.count import Reference
from jfbench.traffic.reads import Traffic, make_codes, make_job

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(json.loads((ROOT / "jfbench/workloads/k55.q30.json").read_text()),
            genome_bases=60_000, chunk_len=4096, chunks_per_job=12, batch=4)
SEED = 2**31 + 5501
GRAIN = 1 << 14  # the store's consolidate_rows: a cold grain of 2,048 rows


def _job(k, counter=None):
    """One job of the tiny traffic -> (counter, table, valid windows,
    the spans of the job, before its reset)."""
    t = Traffic(SPEC)
    pwords, vbits, valid = make_job(t, k, SEED, "cpu")
    if counter is None:
        counter = MerCounter(k, 100_000_000, canonical=True,
                             rng=np.random.default_rng(SEED), device="cpu")
        counter.store.consolidate_rows = GRAIN
    for lo in range(0, t.chunks_per_job, t.batch):
        counter.add_chunks_packed_batch(pwords[lo:lo + t.batch],
                                        vbits[lo:lo + t.batch])
    counter.store.flush()
    table = counter.finalize_np()
    spans = list(counter.trace.spans)
    counter.reset()
    return counter, table, valid, spans


def _reference(k):
    t = Traffic(SPEC)
    return Reference.count((c for _, c in make_codes(t, SEED, "cpu")), k, 2)


@pytest.mark.parametrize("k", [55, 21])
def test_table_equals_the_plain_count(k):
    counter, table, valid, _ = _job(k)
    assert counter._A is not None  # hashed
    assert counter.W == (4 if k == 55 else 2)
    ref = _reference(k)
    diffs, rows, mers, _ = harness.check_tables([table], Traffic(SPEC), k,
                                                SEED, "cpu")
    assert diffs == [0]
    assert len(table[1]) == rows == ref.rows() > 1000
    assert int(table[1].sum()) == mers == ref.mers() == valid


def test_a_second_job_on_the_same_counter_is_exact():
    counter, first, _, _ = _job(55)
    _, second, _, _ = _job(55, counter)
    assert np.array_equal(first[0], second[0])
    assert np.array_equal(first[1], second[1])


@pytest.mark.parametrize("k", [55, 21])
def test_sort_passes_of_each_grain(k, monkeypatch):
    made = []
    orig = sort_mod.merge_pass

    def counting(keys, run, payload=None):
        made.append(run)
        return orig(keys, run, payload)

    monkeypatch.setattr(sort_mod, "merge_pass", counting)
    counter, _, _, spans = _job(k)
    grains = [s for s in spans if s.name == "store.grain"]
    sorts = [s for s in spans if s.name == "store.sort"]
    assert len(sorts) == len(grains) >= 3
    tile = tile_rows(counter.store.key_cols, False)
    for grain, s in zip(grains, sorts):
        assert s.parent is grain
        rows = s.counts["rows"]
        assert rows == grain.counts["rows_in"]
        assert s.counts["cols"] == counter.store.key_cols
        want = 0 if k == 21 else int(np.ceil(np.log2(rows / tile)))
        assert s.counts["passes"] == want
    assert sum(s.counts["passes"] for s in sorts) == len(made)
    if k == 55:
        assert tile == 2048 and all(s.counts["passes"] > 0 for s in sorts)
    job = counter.trace.jobs[-1]
    assert job["store.sort"]["calls"] == len(sorts)
    assert job["store.sort"]["passes"] == len(made)


@pytest.mark.parametrize("m, tile, want", [
    (0, 2048, 0), (1, 2048, 0), (2048, 2048, 0), (2049, 2048, 1),
    (4096, 2048, 1), (4097, 2048, 2), (8_388_480, 2048, 12),
    (1 << 26, 2048, 15), (67_107_840, 2048, 15)])
def test_merge_passes_arithmetic(m, tile, want):
    assert merge_passes(m, 4, tile=tile) == want


def test_sort_passes_follow_the_route():
    assert sort_passes(1 << 26, 1) == 0
    assert sort_passes(1 << 26, 4) == merge_passes(1 << 26, 4) == 15
    assert sort_passes(100, 4) == 0


@pytest.mark.parametrize("k", [55, 21])
def test_pads_are_the_rows_that_are_no_window(k):
    counter, _, valid, _ = _job(k)
    job = counter.trace.jobs[-1]
    assert job["finalize.merge"]["pads"] \
        == job["store.grain"]["rows_in"] - _reference(k).mers()
    assert valid == _reference(k).mers()
    share = job["finalize.merge"]["pads"] / job["store.grain"]["rows_in"]
    # a 150-base read and its N are 151 rows, 150 - k + 1 of them
    # windows: k / 151 PAD, less at a chunk's cut reads
    assert (0.30 < share < 0.42) if k == 55 else (0.10 < share < 0.18)


def test_the_new_counts_are_host_integers():
    counter, _, _, spans = _job(55)
    for s in spans:
        if s.name in ("store.sort", "finalize.merge"):
            assert all(type(v) is int for v in s.counts.values()), s.counts
    job = counter.trace.jobs[-1]
    for name in ("store.sort", "finalize.merge"):
        assert all(type(v) is int for v in job[name].values()), job[name]
    assert set(job["store.sort"]) == {"calls", "host_ns", "rows", "cols",
                                      "passes"}
    assert set(job["finalize.merge"]) == {"calls", "host_ns", "pads"}
