"""Merge passes a grain sort makes, over a job: the sum of the program's
store.sort passes (kernels/sort.sort_rows_blocked's K1 merge passes after
its K3 block sort, ceil(log2(rows / tile)) a grain; 0 for the one
torch.sort of a packed key column) over its store.sort calls
(jellyfish_tpu_torch/trace.py). Read from the program's own summaries of
the window's untraced jobs (the warm-up job left out), the median over
them; 0 where every grain is one torch.sort (2k <= 64), nothing from a
program without the store.sort span."""

from statistics import median

SPANS = []


def _jobs(counter):
    trace = getattr(counter, "trace", None)
    return None if trace is None else list(trace.jobs)


COUNTERS = {"program.jobs": _jobs}


def read(record):
    jobs = (record.get("counters") or {}).get("program.jobs") or []
    per_job = [j["store.sort"]["passes"] / j["store.sort"]["calls"]
               for j in jobs[1:] if "passes" in j.get("store.sort", {})]
    return median(per_job) if per_job else None
