"""The program's entries that the traced run wraps in ranges.

Each span names the attributes to wrap as "module:qualified.name"; a
function imported by name into another module is wrapped there too. A
span with a `layer` sorts the device time of what it launches into that
layer (the outermost such span on the host's stack decides); a span with
`bytes` records each call's bytes (roofline.BYTES) for a roofline share.
A metric module lists the spans it reads by their names here, in its
SPANS; a new span is a new entry of this table. A target that no longer
exists is left out, and the metrics that read it read nothing.
"""

from __future__ import annotations

__all__ = ["SPANS"]

_P = "jellyfish_tpu_torch"

SPANS = {
    "pipeline": {"targets": [f"{_P}.counter:MerCounter.packed_sortkeys"],
                 "layer": "pipeline"},
    "store.insert_raw": {
        "targets": [f"{_P}.store:SortedCountStore.insert_raw"],
        "layer": "store"},
    "store.flush": {"targets": [f"{_P}.store:SortedCountStore.flush"],
                    "layer": "store"},
    "finalize": {"targets": [f"{_P}.counter:MerCounter.finalize_np"],
                 "layer": "finalize"},
    "sort_rows": {"targets": [f"{_P}.ops.count:sort_rows"],
                  "bytes": "sort_rows"},
    "merge_path": {"targets": [f"{_P}.kernels.merge_path:merge_path",
                               f"{_P}.store:merge_path"],
                   "bytes": "merge_path"},
    "merge_pass": {"targets": [f"{_P}.kernels.merge_path:merge_pass",
                               f"{_P}.kernels.sort:merge_pass"],
                   "bytes": "merge_pass"},
    "block_sort": {"targets": [f"{_P}.kernels.bitonic:block_sort",
                               f"{_P}.kernels.sort:block_sort"],
                   "bytes": "block_sort"},
    "compact": {"targets": [f"{_P}.kernels.compact:compact",
                            f"{_P}.store:compact"],
                "bytes": "compact"},
}
