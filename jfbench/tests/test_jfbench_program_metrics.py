"""The readers of the program's own spans and counters
(metrics/finalize.host_s.py, finalize.host_gib.py,
store.merge_amplification.py): made-up summaries, the snapshot a CPU job
takes when its counting ends, and a program without `counter.trace`, as
the parent commit's is."""

import json
import shutil
import statistics
import time

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.counter import MerCounter
from jfbench import harness
from jfbench.traffic.reads import Traffic, make_job

NAMES = ("finalize.host_s", "finalize.host_gib", "store.merge_amplification")
BENCH = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
TINY = {"config": "k21-C", "genome_bases": 100000, "read_len": 150,
        "reverse_share": 0.5, "chunk_len": 4096, "chunks_per_job": 24,
        "batch": 8, "error_model": "uniform_substitution",
        "error_rate": 0.01}


@pytest.fixture(scope="module")
def mods():
    return {n: harness.load_module(harness.BENCH, "metrics", n)
            for n in NAMES}


def summary(host_ns, nbytes, merged, grains):
    return {"pipeline": {"calls": 128, "host_ns": 10**9},
            "store.grain": {"calls": 9, "host_ns": 10**8, "rows_in": 10**9,
                            "rows_out": grains},
            "store.merge": {"calls": 2, "host_ns": 10**8, "rows_in": merged,
                            "rows_out": grains},
            "finalize.to_host": {"calls": 2, "host_ns": host_ns,
                                 "bytes": nbytes}}


def record(jobs):
    return {"counters": {"program.jobs": jobs}}


def test_the_median_leaves_out_the_warm_up_job(mods):
    jobs = [summary(99 * 10**9, 99 * 2**30, 99, 1),  # the warm-up
            summary(3 * 10**9, 6 * 2**30, 260, 100),
            summary(5 * 10**9, 6 * 2**30, 250, 100),
            summary(4 * 10**9, 7 * 2**30, 300, 100)]
    assert mods["finalize.host_s"].read(record(jobs)) == 4.0
    assert mods["finalize.host_gib"].read(record(jobs)) == 6.0
    assert mods["store.merge_amplification"].read(record(jobs)) == 2.6
    assert mods["finalize.host_s"].read(record(jobs[:2])) == 3.0


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(mods, name):
    read = mods[name].read
    assert read(record([])) is None
    assert read(record([summary(1, 1, 1, 1)])) is None  # the warm-up alone
    assert read(record(None)) is None
    assert read({"counters": {}}) is None
    assert read({"counters": {"store.resting_bytes": 5}}) is None
    assert read(record([{}, {}, {}])) is None  # jobs without the spans


def test_the_readers_share_one_counter(mods):
    assert all(m.SPANS == [] and list(m.COUNTERS) == ["program.jobs"]
               for m in mods.values())


def tiny_counter(seed=2**31 + 17):
    t = Traffic(TINY)
    pwords, vbits, valid = make_job(t, 21, seed, torch.device("cpu"))
    counter = MerCounter(21, 100000000, canonical=True,
                         rng=np.random.default_rng(seed), device="cpu")
    counter.store.consolidate_rows = 1 << 14
    return t, pwords, vbits, counter


def test_a_job_snapshots_the_jobs_before_it(mods):
    t, pwords, vbits, counter = tiny_counter()
    for _ in range(3):
        harness.job(counter, pwords, vbits, t.batch)
    counters = dict(mods["finalize.host_gib"].COUNTERS)
    table = harness.job(counter, pwords, vbits, t.batch, counters)
    snap = counters["program.jobs"]
    assert len(snap) == 3 and len(counter.trace.jobs) == 4
    assert snap == counter.trace.jobs[:3]
    rows = len(table[1])
    W = counter.W
    for m in mods.values():
        assert m.read(record(snap)) > 0
    assert mods["finalize.host_gib"].read(record(snap)) \
        == 8 * (W + 1) * rows / 2**30
    ratio = [j["store.merge"]["rows_in"] / j["store.grain"]["rows_out"]
             for j in snap[1:]]
    assert mods["store.merge_amplification"].read(record(snap)) \
        == statistics.median(ratio) > 1


class ParentCounter:
    """A counter as the parent commit's program has it: MerCounter's
    interface without `trace`."""

    def __init__(self, counter):
        self._counter = counter

    def __getattr__(self, name):
        if name == "trace":
            raise AttributeError(name)
        return getattr(self._counter, name)


def test_a_program_without_a_trace_gives_nothing(mods):
    t, pwords, vbits, counter = tiny_counter()
    parent = ParentCounter(counter)
    assert not hasattr(parent, "trace")
    harness.job(parent, pwords, vbits, t.batch)
    counters = {}
    for m in mods.values():
        counters.update(m.COUNTERS)
    harness.job(parent, pwords, vbits, t.batch, counters)
    assert counters == {"program.jobs": None}
    for m in mods.values():
        assert m.read({"counters": counters}) is None


def test_a_traced_cpu_run_reads_the_three(tmp_path):
    base = tmp_path / "jfbench"
    for kind in ("configs", "workloads", "metrics", "end_to_end"):
        shutil.copytree(harness.BENCH / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (base / "workloads" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny", "config": "k21-C",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    out = harness.run_cell(bench, "tiny", 2**31 + 5, 1.0, True, "cpu",
                           time.perf_counter(), base)
    assert out["correct"]
    m = out["metrics"]
    assert m["finalize.host_s"]["value"] > 0
    assert m["finalize.host_gib"]["value"] > 0
    # one grain a job at the default grain: nothing merged
    assert m["store.merge_amplification"]["value"] == 0
