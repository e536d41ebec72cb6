"""The port's own CUDA kernels' share of their bound, over every call a
job makes: K1 merge_path and merge_pass (csrc/merge_path.cu), K2 compact
(csrc/compact.cu), K3 block_sort (csrc/bitonic.cu). Bound: the bytes of
PERF.md's kernel table for each call's shapes (roofline.py) at the HBM
peak; time: all device time under the calls' ranges, the wrappers' own
torch operations included."""

from jfbench.roofline import PEAK_BYTES_PER_S

KERNELS = ("merge_path", "merge_pass", "compact", "block_sort")
SPANS = list(KERNELS)


def read(record):
    calls = [c for c in record["calls"] if c["span"] in KERNELS]
    ms = sum(c["device_ms"] for c in calls)
    if not calls or ms <= 0:
        return None
    bound_ms = 1e3 * sum(c["bytes"] for c in calls) / PEAK_BYTES_PER_S
    return 100.0 * bound_ms / ms
