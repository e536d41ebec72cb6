"""Rows the store's level merges read per row that its grains put into
level 0, over a whole job (counting and the final merge): the sum of the
program's store.merge rows_in (both inputs of every pairwise K1 merge,
all rounds) over the sum of its store.grain rows_out
(jellyfish_tpu_torch/trace.py). Read from the program's own summaries of
the window's untraced jobs (the warm-up job left out), the median over
them; a program without `counter.trace` gives nothing."""

from statistics import median

SPANS = []


def _jobs(counter):
    trace = getattr(counter, "trace", None)
    return None if trace is None else list(trace.jobs)


COUNTERS = {"program.jobs": _jobs}


def read(record):
    jobs = (record.get("counters") or {}).get("program.jobs") or []
    per_job = [j.get("store.merge", {}).get("rows_in", 0)
               / j["store.grain"]["rows_out"] for j in jobs[1:]
               if j.get("store.grain", {}).get("rows_out")]
    return median(per_job) if per_job else None
