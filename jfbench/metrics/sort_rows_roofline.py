"""The grain sort's share of its bound: ops/count.sort_rows, whatever
implements it (torch.sort of a packed key column; K3 block_sort and K1
merge_pass for limb columns). Bound: each call's keys read once and
written once (roofline.sort_rows_bytes) at the HBM peak; time: all device
time under the calls' ranges."""

from jfbench.roofline import PEAK_BYTES_PER_S

SPANS = ["sort_rows"]


def read(record):
    calls = [c for c in record["calls"] if c["span"] == "sort_rows"]
    ms = sum(c["device_ms"] for c in calls)
    if not calls or ms <= 0:
        return None
    bound_ms = 1e3 * sum(c["bytes"] for c in calls) / PEAK_BYTES_PER_S
    return 100.0 * bound_ms / ms
