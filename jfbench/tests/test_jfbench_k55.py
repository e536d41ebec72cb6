"""The k55.q30 cell (configuration k55-C) at a tiny size on the CPU, the
readers of store.sort_passes and store.pad_share, and, on the card, the
control at the cell's own size."""

import json
import shutil
import time

import pytest

from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.kernels.sort import merge_passes
from jfbench import harness
from jfbench.traffic.reads import Traffic, make_job

BENCH = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
NAMES = ("store.sort_passes", "store.pad_share")
SEED = 2**31 + 5502


def tiny(config):
    """The k55.q30 traffic of the given configuration, cut to a CPU test:
    24 chunks of 4,096 bases a job, one grain a job."""
    spec = harness.load_json(harness.BENCH, "workloads", "k55.q30")
    return dict(spec, config=config, genome_bases=100_000, chunk_len=4096,
                chunks_per_job=24)


@pytest.fixture(scope="module")
def mods():
    return {n: harness.load_module(harness.BENCH, "metrics", n)
            for n in NAMES}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The benchmark's data files with a tiny cell of each configuration."""
    base = tmp_path_factory.mktemp("bench") / "jfbench"
    for kind in ("configs", "workloads", "metrics", "end_to_end"):
        shutil.copytree(harness.BENCH / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    for config in ("k55-C", "k21-C"):
        name = f"tiny.{config}"
        (base / "workloads" / f"{name}.json").write_text(
            json.dumps(tiny(config)))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": 1, "why": "x"})
    return base, bench


def test_the_cell_is_in_the_benchmark():
    cell = next(w for w in BENCH["workloads"] if w["name"] == "k55.q30")
    assert cell["config"] == "k55-C" and cell["chips"] == 1
    cfg = harness.load_json(harness.BENCH, "configs", "k55-C")
    assert cfg["k"] == 55 and cfg["canonical"] and cfg["size"] == 10**8
    assert cfg["command"] == "jellyfish count -m 55 -s 100M -C"
    q30 = harness.load_json(harness.BENCH, "workloads", "k21.q30")
    assert tiny("k21-C") == dict(q30, genome_bases=100_000, chunk_len=4096,
                                 chunks_per_job=24)
    per_layer = {m["name"] for m in BENCH["per_layer"]}
    assert set(NAMES) <= per_layer


def rows_and_windows(config):
    """(rows a job's grains sort, valid windows a job) of the tiny cell,
    from the pipeline's shapes and the traffic alone."""
    k = harness.load_json(harness.BENCH, "configs", config)["k"]
    t = Traffic(tiny(config))
    pwords, vbits, valid = make_job(t, k, SEED, "cpu")
    counter = MerCounter(k, 10**8, canonical=True, device="cpu")
    rows = sum(counter.packed_sortkeys(pwords[lo:lo + t.batch],
                                       vbits[lo:lo + t.batch])[0].shape[0]
               for lo in range(0, t.chunks_per_job, t.batch))
    return rows, valid


@pytest.mark.parametrize("config", ["k55-C", "k21-C"])
def test_a_tiny_cell_is_correct_and_reads_both(tree, config):
    base, bench = tree
    cell = f"tiny.{config}"
    out = harness.run_cell(bench, cell, SEED, 0.5, False, "cpu",
                           time.perf_counter(), base)
    assert out["correct"] and out["failed"] == 0
    assert not set(NAMES) & set(out["metrics"])  # read only when traced
    out = harness.run_cell(bench, cell, SEED, 1.0, True, "cpu",
                           time.perf_counter(), base)
    assert out["correct"] and out["attempted"] >= 2
    m = {n: v["value"] for n, v in out["metrics"].items()}
    rows, valid = rows_and_windows(config)
    # one grain a job: the default grain holds the whole tiny job
    passes = merge_passes(rows, 4) if config == "k55-C" else 0
    assert m["store.sort_passes"] == passes
    assert (passes > 0) == (config == "k55-C")
    assert m["store.pad_share"] == pytest.approx(100 * (rows - valid) / rows)
    assert (30 < m["store.pad_share"] < 42 if config == "k55-C"
            else 10 < m["store.pad_share"] < 18)


def summary(passes, sorts, pads, rows_in):
    return {"store.grain": {"calls": sorts, "host_ns": 1, "rows_in": rows_in,
                            "rows_out": rows_in // 2},
            "store.sort": {"calls": sorts, "host_ns": 1, "rows": rows_in,
                           "cols": 4 * sorts, "passes": passes},
            "finalize.merge": {"calls": 1, "host_ns": 1, "pads": pads}}


def record(jobs):
    return {"counters": {"program.jobs": jobs}}


def test_the_median_over_jobs_leaves_out_the_warm_up(mods):
    jobs = [summary(99, 1, 99, 100),  # the warm-up
            summary(252, 17, 364, 1000),
            summary(250, 17, 360, 1000),
            summary(260, 17, 368, 1000)]
    assert mods["store.sort_passes"].read(record(jobs)) == 252 / 17
    assert mods["store.pad_share"].read(record(jobs)) == 36.4
    assert mods["store.sort_passes"].read(record(jobs[:2])) == 252 / 17


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(mods, name):
    read = mods[name].read
    assert read(record([])) is None
    assert read(record([summary(1, 1, 1, 1)])) is None  # the warm-up alone
    assert read(record(None)) is None
    assert read({"counters": {}}) is None
    # a program without the store.sort span or the pads count, as the
    # parent commit's is
    parent = {"store.grain": {"calls": 2, "host_ns": 1, "rows_in": 10,
                              "rows_out": 5},
              "finalize.merge": {"calls": 1, "host_ns": 1}}
    assert read(record([parent, parent, parent])) is None


def test_the_readers_read_the_program_counter(mods):
    assert all(m.SPANS == [] and list(m.COUNTERS) == ["program.jobs"]
               for m in mods.values())


@pytest.mark.chip
def test_control_fails_at_the_cells_size(cuda):
    """The control on three seeds at the k55.q30 cell's own size, on the
    card."""
    from jfbench import readings

    t = Traffic(harness.load_json(harness.BENCH, "workloads", "k55.q30"))
    for seed in (2**31 + 7051, 2**31 + 7052, 2**31 + 7053):
        d, rows = readings.control_diff(t, 55, seed, cuda,
                                        harness.reference_parts(t))
        assert d > 0.001 * rows
