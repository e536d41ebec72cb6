"""Percent of the rows a job's grains sort that are PAD rows (windows
that hold an N or cross a read's end, premasked to the PAD key): 100 x
the pad total of the program's finalize.merge span (`pads`, what
SortedCountStore.finalize returns) over the sum of its store.grain
rows_in (jellyfish_tpu_torch/trace.py). Read from the program's own
summaries of the window's untraced jobs (the warm-up job left out), the
median over them; nothing from a program without the `pads` count."""

from statistics import median

SPANS = []


def _jobs(counter):
    trace = getattr(counter, "trace", None)
    return None if trace is None else list(trace.jobs)


COUNTERS = {"program.jobs": _jobs}


def read(record):
    jobs = (record.get("counters") or {}).get("program.jobs") or []
    per_job = [100.0 * j["finalize.merge"]["pads"]
               / j["store.grain"]["rows_in"] for j in jobs[1:]
               if "pads" in j.get("finalize.merge", {})
               and j.get("store.grain", {}).get("rows_in")]
    return median(per_job) if per_job else None
