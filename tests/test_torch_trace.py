"""The count path's own spans and counters (jellyfish_tpu_torch/trace.py):
the span tree of a job, one summary per reset, the rows that grains and
merges count, the bytes that finalize copies to the host, and the
profiler ranges, which open only while a profiler records.

The store runs with a tiny grain and branch 2, so that one job makes
several grains, level merges and a final merge."""

import numpy as np
import pytest
import torch

import jellyfish_tpu_torch.store as store_mod
from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.io.parse import pack_chunk
from jellyfish_tpu_torch.parallel.sharded import ShardedMerCounter
from jellyfish_tpu_torch.store import SortedCountStore
from jellyfish_tpu_torch.trace import Trace

torch.set_num_threads(1)

L = 512       # bases per chunk
B = 2         # chunks per batch
GRAIN = 2048  # the store's consolidate_rows


def _chunks(seed, n_chunks=24):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return acgt[rng.choice(5, size=(n_chunks, L),
                           p=[.24, .24, .24, .24, .04])]


def _counter(k=21):
    c = MerCounter(k, 1 << 12, canonical=True,
                   rng=np.random.default_rng(1), device="cpu")
    c.store.consolidate_rows = GRAIN
    c.store.branch = 2
    return c


def _feed(counter, chunks):
    for i in range(0, len(chunks), B):
        packed = [pack_chunk(c) for c in chunks[i:i + B]]
        counter.add_chunks_packed_batch(np.stack([p[0] for p in packed]),
                                        np.stack([p[1] for p in packed]))


def _tree(trace):
    return {(s.name, s.parent.name if s.parent else None)
            for s in trace.spans}


def test_span_tree_of_a_job():
    c = _counter()
    _feed(c, _chunks(5))
    c.store.flush()
    assert _tree(c.trace) == {("pipeline", None), ("store.grain", None),
                              ("store.sort", "store.grain"),
                              ("store.merge", None)}
    _feed(c, _chunks(6, 3))  # a backlog that finalize's flush takes
    c.finalize_np()
    assert _tree(c.trace) == {
        ("pipeline", None), ("store.grain", None), ("store.merge", None),
        ("finalize", None), ("finalize.merge", "finalize"),
        ("store.grain", "finalize.merge"), ("store.sort", "store.grain"),
        ("store.merge", "finalize.merge"),
        ("finalize.recover", "finalize"), ("finalize.to_host", "finalize")}
    for s in c.trace.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns


def test_one_summary_per_reset():
    c = _counter()
    for job in range(3):
        _feed(c, _chunks(10 + job))
        c.finalize_np()
        n_spans = len(c.trace.spans)
        c.reset()
        assert len(c.trace.jobs) == job + 1 and c.trace.spans == []
        summary = c.trace.jobs[-1]
        assert sum(d["calls"] for d in summary.values()) == n_spans
        assert summary["finalize"]["calls"] == 1
        assert summary["pipeline"]["calls"] == len(_chunks(0)) // B
    c.reset()  # a job with no work still ends
    assert c.trace.jobs[-1] == {}


def test_merge_and_grain_rows(monkeypatch):
    c = _counter()
    merged, level0 = [], []
    orig_merge_path = store_mod.merge_path

    def counting_merge_path(ak, ac, bk, bc):
        merged.append(ak.shape[0] + bk.shape[0])
        return orig_merge_path(ak, ac, bk, bc)

    monkeypatch.setattr(store_mod, "merge_path", counting_merge_path)
    orig_maybe_merge = SortedCountStore._maybe_merge

    def noting_maybe_merge(self):
        # packed batches enter level 0 only through a grain's flush
        level0.append(self.levels[0][-1][1].shape[0])
        orig_maybe_merge(self)

    monkeypatch.setattr(SortedCountStore, "_maybe_merge", noting_maybe_merge)
    raw = []
    orig_insert = SortedCountStore.insert_raw

    def noting_insert(self, keys, n_valid):
        raw.append(keys.shape[0])
        orig_insert(self, keys, n_valid)

    monkeypatch.setattr(SortedCountStore, "insert_raw", noting_insert)
    _feed(c, _chunks(7))
    c.finalize_np()
    c.reset()
    job = c.trace.jobs[-1]
    assert len(merged) > job["store.merge"]["calls"] >= 3
    assert job["store.merge"]["rows_in"] == sum(merged)
    assert job["store.grain"]["calls"] == len(level0) >= 3
    assert job["store.grain"]["rows_out"] == sum(level0)
    assert job["store.grain"]["rows_in"] == sum(raw)


@pytest.mark.parametrize("k", [21, 63])
def test_finalize_bytes_to_host(k):
    c = _counter(k)
    _feed(c, _chunks(8))
    mers, counts = c.finalize_np()
    c.reset()
    job = c.trace.jobs[-1]
    # W int64 mer limbs and one int64 count a row; the PAD entry dropped
    # before its copy
    assert len(counts) > 0 and mers.shape[1] == c.W
    assert job["finalize.to_host"]["bytes"] == 8 * (c.W + 1) * len(counts)
    assert job["finalize.to_host"]["calls"] == 2


def test_restricted_finalize_counts_every_copy():
    chunks = _chunks(9)
    plain = _counter()
    _feed(plain, chunks)
    n_table = len(plain.finalize_np()[1])
    c = _counter()
    c.restrict_to(list(_chunks(99, 4)) + [chunks[0]])
    _feed(c, chunks)
    mers, counts = c.finalize_np()
    c.reset()
    n_allowed = len(counts)
    assert 0 < n_allowed and (counts > 0).any() and (counts == 0).any()
    W = c.W
    # the table's counts and limb view; the allowed mers' counts, limb
    # view and mers
    to_host = c.trace.jobs[-1]["finalize.to_host"]
    assert to_host["calls"] == 5
    assert to_host["bytes"] == (8 * (W + 1) * n_table
                                + 8 * (2 * W + 1) * n_allowed)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    orig = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return orig(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    c = _counter()
    _feed(c, _chunks(11))
    c.finalize_np()
    c.reset()
    assert entered == [] and c.trace.jobs[-1]["store.merge"]["calls"] > 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _feed(c, _chunks(11, 4))
        c.finalize_np()
    assert {"pipeline", "store.grain", "finalize", "finalize.to_host"} \
        <= set(entered)


def test_span_names_on_the_profiler_timeline():
    c = _counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _feed(c, _chunks(12))
        c.finalize_np()
    names = {e.name for e in prof.events()}
    assert {"pipeline", "store.grain", "store.merge", "finalize",
            "finalize.merge", "finalize.recover",
            "finalize.to_host"} <= names
    # constant names: no call index, nothing of the benchmark's ranges
    assert not any(n.startswith("jfbench:") or "#" in n
                   for n in names if n.startswith(("store.", "finalize")))


def test_summaries_hold_host_integers_only():
    c = _counter()
    for seed in (13, 14):
        _feed(c, _chunks(seed))
        c.finalize_np()
        c.reset()
    for job in c.trace.jobs:
        for name, d in job.items():
            assert isinstance(name, str) and {"calls", "host_ns"} <= set(d)
            assert all(type(v) is int for v in d.values()), (name, d)


def test_span_add_and_nesting_of_a_bare_trace():
    t = Trace()
    with t.span("a", n=1) as a:
        a.add("n", 2)
        with t.span("b") as b:
            b.add("m", 5)
        with t.span("b"):
            pass
    assert [(s.name, s.parent) for s in t.spans] == [("a", None), ("b", a),
                                                    ("b", a)]
    t.end_job()
    job = t.jobs[0]
    assert job["a"]["n"] == 3 and job["a"]["calls"] == 1
    assert job["b"]["calls"] == 2 and job["b"]["m"] == 5
    assert job["a"]["host_ns"] >= job["b"]["host_ns"] >= 0


def test_a_store_without_an_owner_records_nothing():
    s = SortedCountStore(2, "cpu", branch=2, consolidate_rows=1024)
    c = _counter()
    pw, vb = zip(*[pack_chunk(ch) for ch in _chunks(15, 8)])
    for i in range(0, 8, B):
        s.insert_raw(*c.packed_sortkeys(np.stack(pw[i:i + B]),
                                        np.stack(vb[i:i + B])))
    s.finalize()
    assert [sp.name for sp in c.trace.spans] == ["pipeline"] * 4


def test_shards_keep_their_own_traces():
    c = ShardedMerCounter(21, 1 << 12, mesh=["cpu", "cpu"], canonical=True,
                          rng=np.random.default_rng(1), device="cpu")
    pw, vb = zip(*[pack_chunk(ch) for ch in _chunks(16, 4)])
    for i in range(0, 4, 2):
        c.add_chunks_packed(np.stack(pw[i:i + 2]), np.stack(vb[i:i + 2]))
    mers, counts = c.finalize_np()
    c.reset()
    assert len({id(s.trace) for s in c.shards}) == 2
    rows = 0
    for s in c.shards:
        (job,) = s.trace.jobs
        assert job["pipeline"]["calls"] == 2 and job["finalize"]["calls"] == 1
        rows += job["finalize.to_host"]["bytes"] // (8 * (c.W + 1))
    assert rows == len(counts)
