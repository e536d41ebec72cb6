"""The share of the traced job in which no kernel, copy or memset ran on
the device: 1 - (union of their intervals / the job's window)."""

SPANS = []


def read(record):
    if record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
