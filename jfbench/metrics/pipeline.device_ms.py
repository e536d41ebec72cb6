"""Device ms a job spends in the chunk pipeline: MerCounter.packed_sortkeys
(ops/mers.py window extraction and canonical fold, ops/hashing.py GF(2)
hash, the PAD premask) and the host-to-device copies of the packed
chunks it makes."""

SPANS = ["pipeline"]


def read(record):
    ms = record["layers"].get("pipeline")
    return ms / record["jobs"] if ms else None
