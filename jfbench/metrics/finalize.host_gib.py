"""GiB a job copies from the device to the host in the program's
finalize.to_host spans (jellyfish_tpu_torch/trace.py): each copied
tensor's numel * element_size, summed, / 2^30; for a whole table, W int64
mer limbs and one int64 count a row. Read from the program's own
summaries of the window's untraced jobs (the warm-up job left out), the
median over them; a program without `counter.trace` gives nothing."""

from statistics import median

SPANS = []


def _jobs(counter):
    trace = getattr(counter, "trace", None)
    return None if trace is None else list(trace.jobs)


COUNTERS = {"program.jobs": _jobs}


def read(record):
    jobs = (record.get("counters") or {}).get("program.jobs") or []
    per_job = [j["finalize.to_host"]["bytes"] / 2**30 for j in jobs[1:]
               if "finalize.to_host" in j]
    return median(per_job) if per_job else None
