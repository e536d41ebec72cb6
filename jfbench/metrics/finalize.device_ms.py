"""Device ms a job spends in MerCounter.finalize_np: the last flush, the
final merge of every run (K1, K2), the PAD correction, the recovery of
mers by the inverse matrix and the copies of the table to the host."""

SPANS = ["finalize"]


def read(record):
    ms = record["layers"].get("finalize")
    return ms / record["jobs"] if ms else None
