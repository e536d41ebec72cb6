"""Database dumping (a copy of jellyfish_tpu/io/dumpers.py).

The finalized store is already in hash order, so dumping is a linear
write of (recovered key, count) records with optional L/U count filters,
vectorized with numpy."""

from __future__ import annotations

import numpy as np

from jellyfish_tpu_torch.io.files import (
    encode_binary_records_np,
    make_count_header,
    mer_strings_np,
)
from jellyfish_tpu_torch.io.header import FileHeader

__all__ = ["dump_counter"]


def dump_counter(
    counter,
    path: str,
    *,
    text: bool = False,
    counter_len_bytes: int = 4,
    val_len_bits: int = 7,
    max_reprobe: int = 126,
    lower_count: int = 0,
    upper_count: int | None = None,
    cmdline=None,
    header_extra: dict | None = None,
) -> int:
    """Finalize `counter` and write a jellyfish database. Returns #records.
    Reads only counter.finalize_np, k, size, matrix and canonical."""
    mers, counts = counter.finalize_np()
    if lower_count or upper_count is not None:
        hi = (
            np.uint64(upper_count) if upper_count is not None
            else np.iinfo(np.uint64).max
        )
        sel = (counts >= np.uint64(lower_count)) & (counts <= hi)
        mers, counts = mers[sel], counts[sel]

    fmt = FileHeader.FORMAT_TEXT if text else FileHeader.FORMAT_BINARY
    header = make_count_header(
        k=counter.k,
        size=counter.size,
        matrix=counter.matrix,
        canonical=counter.canonical,
        val_len_bits=val_len_bits,
        max_reprobe=max_reprobe,
        fmt=fmt,
        counter_len_bytes=counter_len_bytes,
        cmdline=cmdline,
    )
    if header_extra:
        header.root.update(header_extra)
    with open(path, "wb") as f:
        header.write(f)
        block = 1 << 20
        if text:
            k = counter.k
            for off in range(0, len(counts), block):
                chars = mer_strings_np(mers[off : off + block], k)
                cs = counts[off : off + block]
                f.write(
                    b"".join(
                        b"%s %d\n" % (chars[i].tobytes(), cs[i])
                        for i in range(len(cs))
                    )
                )
        else:
            for off in range(0, len(counts), block):
                f.write(
                    encode_binary_records_np(
                        mers[off : off + block], counts[off : off + block],
                        counter.k, counter_len_bytes,
                    )
                )
    return len(counts)
