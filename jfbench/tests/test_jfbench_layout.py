"""BENCHMARK.json against the benchmark's contract, and cells and metrics
found by name from added files alone."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from jfbench import harness

ROOT = harness.BENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"genome_bases": 200000, "read_len": 150, "reverse_share": 0.5,
        "chunk_len": 4096, "chunks_per_job": 24, "batch": 8,
        "error_model": "uniform_substitution", "error_rate": 0.01}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["jfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(r) for r in c["reduced"])
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert f["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        spec = harness.load_json(harness.BENCH, "workloads", w["traffic"])
        assert spec["config"] == w["config"]
        used.add(w["config"])
    assert used == names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (harness.BENCH / "end_to_end" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e, p = harness.cell_metrics(BENCH)
    assert {"setup_s"} < {m["name"] for m in e} and p


def fake_tree(tmp_path: Path) -> tuple[Path, dict]:
    """A copy of the benchmark's data files with one cell and one metric
    added as files, and the BENCHMARK.json entries that name them."""
    base = tmp_path / "jfbench"
    for kind in ("configs", "workloads", "metrics", "end_to_end"):
        shutil.copytree(harness.BENCH / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (base / "workloads" / "fake.tiny.json").write_text(
        json.dumps(dict(TINY, config="k21-C")))
    (base / "metrics" / "fake.sort_calls.py").write_text(
        'SPANS = ["sort_rows"]\n'
        "def read(record):\n"
        '    n = sum(c["span"] == "sort_rows" for c in record["calls"])\n'
        "    return n or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "fake.tiny", "config": "k21-C",
                               "traffic": "fake.tiny", "chips": 1,
                               "why": "a tiny cell"})
    bench["per_layer"].append({"name": "fake.sort_calls", "unit": "calls",
                               "better": "lower", "source": "device_trace",
                               "layer": "Kernels", "moves": "count_rate"})
    return base, bench


def test_a_new_cell_and_metric_come_from_added_files(tmp_path):
    base, bench = fake_tree(tmp_path)
    out = harness.run_cell(bench, "fake.tiny", 2**31 + 99, 0.5, False, "cpu",
                           time.perf_counter(), base)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"count_rate", "peak_gib", "setup_s"} - {
        "peak_gib"}  # no device peak on the CPU
    assert list(out)[-1] == "check"
    out = harness.run_cell(bench, "fake.tiny", 2**31 + 99, 0.5, True, "cpu",
                           time.perf_counter(), base)
    assert out["correct"]
    assert out["metrics"]["fake.sort_calls"]["value"] == 1
    assert out["metrics"]["store.resting_gib"]["value"] > 0


def test_a_workload_file_of_another_config_is_refused(tmp_path):
    base, bench = fake_tree(tmp_path)
    cfg = harness.load_json(base, "configs", "k21-C")
    cfg.update(name="fake-k63", k=63)
    (base / "configs" / "fake-k63.json").write_text(json.dumps(cfg))
    bench["workloads"][-1]["config"] = "fake-k63"
    with pytest.raises(ValueError, match="is for k21-C"):
        harness.run_cell(bench, "fake.tiny", 1, 0.5, False, "cpu",
                         time.perf_counter(), base)
