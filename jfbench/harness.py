"""One run of one cell: set-up, the window of whole count jobs, the check
against the plain count, and the result.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name: configs/<config>.json, workloads/<traffic>.json,
end_to_end/<metric>.py and metrics/<metric>.py. A metric module has
`read(record)`, which returns a number or None (nothing to read); a
per-layer one also lists the spans it reads by their names in spans.py
(SPANS) and may give COUNTERS ({name: f(counter)}) read from the program
when counting ends.

The window drives jellyfish_tpu_torch through its counting API, as its
CLI's count does: MerCounter, add_chunks_packed_batch of host-packed
chunks a batch at a time, store.flush, finalize_np, reset. A job is that
sequence over the cell's fixed input. Jobs run back to back; the first
always runs, and no further job starts if the mean so far says that it
would end after the window's seconds. A traced run (--trace 1) runs the
same window, then one more job under the profiler, and reads the
per-layer metrics from the window's CUDA events and that job's trace.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from jfbench import spans as span_table
from jfbench import trace
from jfbench.reference.count import Reference, table_columns
from jfbench.traffic.reads import Traffic, make_codes, make_job

__all__ = ["BENCH", "load_json", "load_module", "cell_metrics", "run_cell",
           "job", "check_tables", "reference_parts", "FORBIDDEN"]

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jellyfish_tpu")
JOB_RANGE = "jfbench.job"


def load_json(base: Path, kind: str, name: str) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(base: Path, kind: str, name: str):
    """The module <base>/<kind>/<name>.py (names may hold dots)."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"jfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict):
    """The (end-to-end, per-layer) metric entries. A metric that finds
    nothing to read in a cell reads None there and is left out."""
    return bench["end_to_end"], bench["per_layer"]


def job(counter, pwords, vbits, batch, counters=None, marks=None):
    """One count job -> (mers [n, W] uint32, counts [n] uint64) on the
    host; `counters` ({name: f(counter)}) are read when counting ends and
    stored back into the dict. `marks`, a list, gets the device's time of
    the job's counting and finalize, from CUDA events that do not wait."""
    cuda = counter.device.type == "cuda" and marks is not None
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    for lo in range(0, pwords.shape[0], batch):
        counter.add_chunks_packed_batch(pwords[lo:lo + batch],
                                        vbits[lo:lo + batch])
    counter.store.flush()
    if cuda:
        ev[1].record()
    if counters is not None:
        for name, f in list(counters.items()):
            counters[name] = f(counter)
    table = counter.finalize_np()
    counter.reset()
    if cuda:
        ev[2].record()
        ev[2].synchronize()
        marks.append([ev[0].elapsed_time(ev[1]) / 1e3,
                      ev[1].elapsed_time(ev[2]) / 1e3])
    return table


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_parts(t: Traffic) -> int:
    """Parts of the plain count: a power of two, at most 2^27 bases a
    part."""
    total = t.chunks_per_job * t.chunk_len
    parts = 1
    while parts * (1 << 27) < total:
        parts *= 2
    return parts


def check_tables(tables, t: Traffic, k: int, seed: int, device):
    """The plain count of the job's reads, and each table's rows that
    differ from it: (diffs, reference rows, reference mers, seconds)."""
    t0 = time.perf_counter()
    ref = Reference.count((c for _, c in make_codes(t, seed, device)), k,
                          reference_parts(t))
    diffs, first = [], None
    for mers, counts in tables:
        if first is not None and (np.array_equal(mers, first[0])
                                  and np.array_equal(counts, first[1])):
            diffs.append(diffs[0])
            continue
        cols, c = table_columns(mers, counts, k, device)
        diffs.append(ref.diff(cols, c))
        del cols, c
        if first is None:
            first = (mers, counts)
    rows, mers_total = ref.rows(), ref.mers()
    del ref
    return diffs, rows, mers_total, time.perf_counter() - t0


def _traced_job(counter, pwords, vbits, batch, metric_modules):
    """One job under the profiler, with the spans and counters that the
    metric modules ask for -> (its table, the record they read)."""
    specs, counters = {}, {}
    for mod in metric_modules:
        specs.update((s, span_table.SPANS[s]) for s in mod.SPANS)
        counters.update(getattr(mod, "COUNTERS", {}))
    wrap = trace.Spans(specs)
    wrap.install()
    try:
        with trace.profile() as prof:
            with torch.profiler.record_function(JOB_RANGE):
                table = job(counter, pwords, vbits, batch, counters)
                _sync(counter.device)
    finally:
        wrap.uninstall()
    record = trace.reduce_trace(trace.trace_events(prof), specs, wrap.calls,
                                JOB_RANGE)
    record.update(jobs=1, counters=counters)
    return table, record


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, base: Path = BENCH):
    """Run one cell once -> the result dict (the last line's object)."""
    from jellyfish_tpu_torch.counter import MerCounter

    device = torch.device(device)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = load_json(base, "configs", entry["config"])
    spec = load_json(base, "workloads", entry["traffic"])
    if spec["config"] != entry["config"]:
        raise ValueError(f"workloads/{entry['traffic']}.json is for "
                         f"{spec['config']}, the cell for {entry['config']}")
    t, k = Traffic(spec), int(cfg["k"])
    e2e, per_layer = cell_metrics(bench)

    phases = {"start_s": time.perf_counter() - t_start}
    pwords, vbits, valid = make_job(t, k, seed, device)
    phases["input_s"] = time.perf_counter() - t_start
    counter = MerCounter(k, int(cfg["size"]), canonical=bool(cfg["canonical"]),
                         rng=np.random.default_rng(seed), device=device)
    job(counter, pwords, vbits, t.batch)  # warm-up: every shape, the allocator
    _sync(device)
    phases["warm_up_s"] = time.perf_counter() - t_start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    marks, tables, job_s = [], [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        ts = time.perf_counter()
        tables.append(job(counter, pwords, vbits, t.batch, marks=marks))
        te = time.perf_counter()
        job_s.append(te - ts)
        if (te - t0) * (len(job_s) + 1) / len(job_s) > seconds:
            break
    window_s = time.perf_counter() - t0
    if traced:
        mods = {m["name"]: load_module(base, "metrics", m["name"])
                for m in per_layer}
        table, record = _traced_job(counter, pwords, vbits, t.batch,
                                    mods.values())
        tables.append(table)
        record.update(mers_per_job=valid, counting_s=[m[0] for m in marks])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # the program's state goes before the reference runs
    del counter, pwords, vbits
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    diffs, ref_rows, ref_mers, check_s = check_tables(tables, t, k, seed,
                                                      device)
    worst = max(diffs)

    metrics = {}
    if traced:
        for m in per_layer:
            v = mods[m["name"]].read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        run = {"jobs": len(job_s), "mers_per_job": valid,
               "window_s": window_s, "job_s": job_s, "setup_s": setup_s,
               "peak_bytes": peak}
        for m in e2e:
            v = load_module(base, "end_to_end", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": worst == 0, "attempted": len(tables),
           "failed": sum(d != 0 for d in diffs), "metrics": metrics,
           "device": dev}
    if traced:
        dev.update(busy_s=record["busy_s"], window_s=record["window_s"])
        out["breakdown"] = {"device_ops": record["device_ops"],
                            "idle_gaps": record["idle_gaps"]}
    # for the reader of a run's output; the driver ignores the key
    out["info"] = {"seed": seed, "jobs_s": job_s, "window_s": window_s,
                   "setup": phases,
                   "count_finalize_s": marks, "mers_per_job": valid,
                   "ref_rows": ref_rows, "ref_mers": ref_mers,
                   "check_s": check_s, "diffs": diffs}
    out["check"] = {"diff_rows": {"value": worst, "limit": 0}}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({n for n in list(sys.modules)
                   if n.partition(".")[0] in FORBIDDEN})
