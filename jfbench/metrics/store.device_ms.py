"""Device ms a job spends in the store while counting:
SortedCountStore.insert_raw and .flush (the grain sort ops/count.sort_rows,
segment counts, K2 compact, the level merges by K1 merge_path). A flush
that finalize makes is finalize's."""

SPANS = ["pipeline", "store.insert_raw", "store.flush", "finalize"]


def read(record):
    ms = record["layers"].get("store")
    return ms / record["jobs"] if ms else None
