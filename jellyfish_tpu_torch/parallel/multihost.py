"""Counting across processes (`count --coordinator`): the process group,
and the dump written as one segment a process (the counterpart of
jellyfish_tpu/parallel/multihost.py).

One process a host (or a card), each driving its local shards. The global
shards are numbered process-major, so rank r owns one contiguous range of
the global hash order (parallel/sharded.py): every process writes ONE
contiguous segment of the final database, and assembling it is the header
plus the segments concatenated in rank order, with no table motion between
processes.

The group runs over NCCL when the process's device is a CUDA device and
over gloo on the CPU. Its rendezvous is a TCP store at the coordinator's
address (rank 0 serves it), and every collective has a finite timeout, so
a peer that never arrives or a rank that died ends the run with an error.
There is no fallback: a group that cannot start raises.
"""

from __future__ import annotations

import datetime
import shutil

import numpy as np
import torch
import torch.distributed as dist

from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.io.files import (
    encode_binary_records_np,
    make_count_header,
    mer_strings_np,
)
from jellyfish_tpu_torch.io.header import FileHeader

__all__ = [
    "init_multihost",
    "shutdown_multihost",
    "write_local_segments",
    "assemble_db",
    "assemble_db_full_parts",
]

# long enough for one rank's local --disk merge or rank 0's assembly while
# the others wait at a barrier
TIMEOUT_S = 1800


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, device=None,
                   timeout_s: float = TIMEOUT_S) -> str:
    """Join the process group of a multi-process run and return its
    backend: "nccl" when `device` (None: the GPU) is a CUDA device, which
    becomes this process's current device, and "gloo" on the CPU.
    coordinator_address is HOST:PORT; rank 0 serves the rendezvous there.
    Raises when the group does not form within timeout_s seconds."""
    dev = resolve_device(device)
    kw = dict(init_method=f"tcp://{coordinator_address}",
              world_size=num_processes, rank=process_id,
              timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        # eager NCCL init: a communicator that cannot form (two ranks on
        # one card, say) fails here
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    else:
        backend = "gloo"
    try:
        dist.init_process_group(backend, **kw)
    except BaseException:
        shutdown_multihost()  # a default group left half made
        raise
    return backend


def shutdown_multihost() -> None:
    """Leave the process group (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _segment_header(counter, *, counter_len_bytes, val_len_bits,
                    max_reprobe, text, cmdline):
    fmt = FileHeader.FORMAT_TEXT if text else FileHeader.FORMAT_BINARY
    return make_count_header(
        k=counter.k, size=counter.size, matrix=counter.matrix,
        canonical=counter.canonical, val_len_bits=val_len_bits,
        counter_len_bytes=counter_len_bytes, max_reprobe=max_reprobe,
        fmt=fmt, cmdline=cmdline,
    )


def write_local_segments(counter, prefix: str,
                         counter_len_bytes: int = 4,
                         val_len_bits: int = 7,
                         max_reprobe: int = 126,
                         cmdline=None,
                         text: bool = False,
                         lower_count: int = 0,
                         upper_count: int | None = None,
                         part_path: str | None = None,
                         embed_header: bool = False) -> int:
    """Write THIS process's contiguous dump segment to
    `{prefix}.part{rank}` (or `part_path`); rank 0 also writes
    `{prefix}.header`, unless embed_header, where EVERY rank prepends
    the header to its own part, making it a standalone database (the
    --disk spills, merged locally). -L/-U apply per segment (count
    filters are per record, dumper.hpp:26-93); --text writes text
    records. Returns the number of records."""
    rank = dist.get_rank()
    parts = counter.finalize_local_np()
    n = 0
    path = part_path if part_path is not None else f"{prefix}.part{rank}"
    hi = (np.uint64(upper_count) if upper_count is not None
          else np.iinfo(np.uint64).max)
    header = _segment_header(
        counter, counter_len_bytes=counter_len_bytes,
        val_len_bits=val_len_bits, max_reprobe=max_reprobe, text=text,
        cmdline=cmdline,
    )
    with open(path, "wb") as f:
        if embed_header:
            header.write(f)
        for _, mers, counts in parts:
            if lower_count or upper_count is not None:
                sel = (counts >= np.uint64(lower_count)) & (counts <= hi)
                mers, counts = mers[sel], counts[sel]
            if text:
                # in blocks: one join of a multi-GB segment would double
                # the host's peak memory
                block = 65536
                for off in range(0, len(counts), block):
                    chars = mer_strings_np(mers[off:off + block], counter.k)
                    cs = counts[off:off + block]
                    f.write(b"".join(
                        b"%s %d\n" % (chars[i].tobytes(), cs[i])
                        for i in range(len(cs))))
            else:
                f.write(encode_binary_records_np(
                    mers, counts, counter.k, counter_len_bytes))
            n += len(counts)
    if rank == 0 and not embed_header:
        with open(f"{prefix}.header", "wb") as f:
            header.write(f)
    return n


def assemble_db(prefix: str, num_processes: int, out_path: str) -> None:
    """Concatenate the header and the per-rank segments (rank order is the
    global hash order) into one database."""
    with open(out_path, "wb") as out:
        with open(f"{prefix}.header", "rb") as f:
            shutil.copyfileobj(f, out)
        for r in range(num_processes):
            with open(f"{prefix}.part{r}", "rb") as f:
                shutil.copyfileobj(f, out)


def assemble_db_full_parts(part_paths, out_path: str) -> None:
    """Assemble standalone per-rank databases (each a header and its shard
    range's records, in rank order) into one database: rank 0's file is
    copied whole, the later ranks give their records only (their headers
    carry the same hash parameters, and are dropped)."""
    with open(out_path, "wb") as out:
        for i, p in enumerate(part_paths):
            with open(p, "rb") as f:
                if i > 0:
                    # parse (and so validate) the duplicate header
                    FileHeader.read(f)
                shutil.copyfileobj(f, out)
