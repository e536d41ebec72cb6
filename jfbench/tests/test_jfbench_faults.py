"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card (run_cell on the CPU, at a tiny size
of the k21.q20 traffic, and of the same traffic at k = 63, whose keys
take four limbs) and breaks the program where the fault would sit. One cell runs on one card, so no exchange between cards
can be left out."""

import json
import time

import numpy as np
import pytest

from jellyfish_tpu_torch.counter import MerCounter
from jfbench import harness

BENCH = json.loads((harness.BENCH.parent / "BENCHMARK.json").read_text())
TINY = {"genome_bases": 100000, "read_len": 150, "reverse_share": 0.5,
        "chunk_len": 4096, "chunks_per_job": 24, "batch": 8,
        "error_model": "uniform_substitution"}


@pytest.fixture(params=[21, 63], ids=["k21", "k63"])
def tiny(request, tmp_path):
    """(bench, base) with one tiny cell of k21-C, or of a copy of it at
    k = request.param."""
    import shutil

    base = tmp_path / "jfbench"
    for kind in ("configs", "workloads", "metrics", "end_to_end"):
        shutil.copytree(harness.BENCH / kind, base / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    config, rate = "k21-C", 0.01
    if request.param != 21:
        cfg = harness.load_json(base, "configs", config)
        config = cfg["name"] = f"tiny-k{request.param}"
        cfg["k"] = request.param
        (base / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (base / "workloads" / "tiny.json").write_text(
        json.dumps(dict(TINY, config=config, error_rate=rate)))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny", "config": config,
                               "traffic": "tiny", "chips": 1, "why": "x"})
    return bench, base


def run(tiny, seconds=0.3):
    bench, base = tiny
    return harness.run_cell(bench, "tiny", 2**31 + 4242, seconds, False,
                            "cpu", time.perf_counter(), base)


def test_sound(tiny):
    out = run(tiny)
    assert out["correct"] and out["failed"] == 0
    assert out["check"]["diff_rows"] == {"value": 0, "limit": 0}


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(MerCounter, "add_chunks_packed_batch",
                        lambda self, pwords, validbits: None)
    out = run(tiny)
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_half_of_each_batch_left_out(tiny, monkeypatch):
    orig = MerCounter.add_chunks_packed_batch

    def half(self, pwords, validbits):
        n = len(pwords) // 2
        return orig(self, pwords[:n], validbits[:n])

    monkeypatch.setattr(MerCounter, "add_chunks_packed_batch", half)
    out = run(tiny)
    assert not out["correct"] and out["check"]["diff_rows"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch):
    orig = MerCounter.finalize_np

    def altered(self):
        mers, counts = orig(self)
        counts = counts.copy()
        counts[len(counts) // 2] += np.uint64(1)
        return mers, counts

    monkeypatch.setattr(MerCounter, "finalize_np", altered)
    out = run(tiny)
    assert not out["correct"] and out["check"]["diff_rows"]["value"] == 2


def test_a_reset_that_keeps_the_last_job(tiny, monkeypatch):
    monkeypatch.setattr(MerCounter, "reset", lambda self: None)
    out = run(tiny, seconds=3.0)
    assert out["attempted"] >= 2
    assert not out["correct"]
