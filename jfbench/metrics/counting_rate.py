"""Valid mers of the window's untraced jobs over their counting time: from
each job's start until the device has counted its last window (after
store.flush), by CUDA events that do not make the host wait; the
reference's --timing "Counting". Read from the same window as count_rate,
not under the profiler, and steadier than it: the finalize's copies into
fresh host memory, which vary with the host, are left out."""

SPANS = []


def read(record):
    if not record["counting_s"]:
        return None
    return len(record["counting_s"]) * record["mers_per_job"] / sum(
        record["counting_s"])
