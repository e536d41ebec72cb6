"""GiB the store holds when counting ends (after the last flush, before
finalize): SortedCountStore.device_bytes(), the program's own count."""

SPANS = []
COUNTERS = {
    "store.resting_bytes": lambda counter: counter.store.device_bytes()}


def read(record):
    b = record["counters"].get("store.resting_bytes")
    return b / 2**30 if b else None
