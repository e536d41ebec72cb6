"""Smoke run of jellyfish_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from jellyfish_tpu_torch/csrc (K1 merge_path.cu,
K2 compact.cu, K3 bitonic.cu, rows 9 and 10 window.cu), and beside them
the native host library (jellyfish_tpu_torch/native/chunker.cpp), and
holds each kernel's entry point against its plain PyTorch version at the
shapes its path gives it and at the Pallas kernels' own shapes; row 8's
fused passes of up to four steps (jf_exchange_group) also at Wk 2 and 7
with a payload and Wk 4 keys only, each timed against the same steps one
pass each, and row 9's windows inside and across either end of a run at
odd and even offsets;
K1's merge_pass and its partition pass (merge_splits) at every key width,
keys only and with a payload, in runs of 1, 2,048, 2^16 and 2^22 rows,
and timed at the k = 63 grain's passes. Kernel times are device times
(cuda_ms); K2's keep mask, whose call waits on the host, by the profiler. Runs `count` end to end through
the CLI at k = 21, 33, 63 and 100 with every record checked against a
numpy oracle; merges 4 parts of the k = 63 input in small windows (every
slab rotated) and checks the result against the whole input's count, and
MIN, MAX, JACCARD and -L/-U against a numpy oracle; runs `count --disk` at
k = 21 and 63 against the in-memory count. Counts the 268M windows of the
main configuration through MerCounter twice: at k = 21 (231M valid mers,
packed keys) and at k = 63 (156M valid mers, 4-limb keys that every grain
consolidation sorts with K3's block sort and K1's merge passes; three more
passes there time that sort against the LSD chain of stable argsorts it
replaced). Both runs: canonical, -s 4M, 256 chunks of 1 MiB of 150-base
reads at 8x coverage of a seeded random 33.5 Mbase genome, in batches of
8. Then merges, through the CLI, 4 databases each counted from a quarter
of those chunks at k = 21 (110M records), and holds the result against the
k = 21 count, record for record. The Bloom path: at the CLI k = 21 size,
bc -> count --bc -> query (a .bc and a binary database) against numpy, and
count --chunk-len 1000 (the ASCII path) against the packed path; at full
size, bc -s 64M of the 256 chunks (m = 2^30 cells) against a numpy oracle
after 8 chunks and with no false negative among the k = 21 count's mers,
then count --bc and count --bf-size 512M of the first 64 chunks against
their exact count, and the pair sort of kernels/sort.py (kernel-table rows
6, 8 and 12) held against its plain version and timed beside K1's merge
passes and torch.sort at the insert's shape. count --packed-store at full
size (phase_packed): the k = 21 count with the grain cut to 2^21 rows,
so that runs reach level 2, rest packed and are unpacked by the merges
that take them, and the same count dense at the same cut, both
record-equal to the k = 21 count at the real grain; the k = 63 count
(four limb columns) packed at the same cut, record-equal to the k = 63
count; device bytes, peak memory and bits per entry of each, and pack_run
and unpack_run of each k's resting run timed against their bound and held
exact. count --if at full size (phase_if): the k = 21 count restricted to
the mers of the first 16 chunks and of 1 Mbase of seeded random sequence,
against a numpy join. At the CLI sizes (phase_cli_modes): count
--packed-store at k = 21 and 63, --if and --if --disk at k = 21 and 63,
--text, -g of 4 generator commands with -G 2, and --disk --packed-store,
each against its oracle; and count --disk at k = 21 with the grain cut to
2^18 rows, dense and packed, where the packed store must spill less.
count -d (phase_sharded): ShardedMerCounter counts the 268M windows with
2 and 4 shards sharing the card at k = 21 and with 4 at k = 63, each
record-equal to the single-device table, with the device time of each
layer (pipeline, local dedup, exchange, stores, finalize) from a profiled
pass over the first 64 chunks; at the CLI k = 21 size -d 2's modes
(--if, --bc, seeded --bf-size, --packed-store, --disk -s 1M with 3 or
more partials) through cli/count._run_counting against the single-device
counter, and count -d 1 and -d auto (the plain count's records) and -d
N above the visible devices (dies) through the CLI (phase_sharded_modes).
count --coordinator with one NCCL process: five CLI children (k = 21 and
63 against the plain count, --disk -s 1M with 3 or more spills, --if and
--bc against one device), each reporting the nccl backend
(phase_multihost_cli), and ShardedMerCounter under the group with 2
shards on the card, record-equal to the k = 21 table, with the device
time of its all_gather and all_to_all_single (phase_multihost_api).
count --sam of fastq2sam's SAM, of a BAM of the same reads, and of a CRAM
3.0 and a CRAM 3.1 of them (written here with the port's encoders), the
CRAMs also under -Q 5, against the FASTQ's count, each through the native
library's parsers and decoders (phase_sam). The native host library
(phase_native): loaded from build/jellyfish_tpu_torch/, count of the FASTQ
in a child process with the native chunker and under JF_NO_NATIVE=1,
count -F 4 of the reads in 4 files, and libjfquery's counts of 2,000 mers
against the port's query.
Every new path must launch K1 and K2 (and K3 at k = 63, rows 9 on --disk).
Exits nonzero, with no result line, when there is no GPU or any phase
fails.

The last lines of standard output are the kernels' JSON line, the
script's time, the card's name and power limit as nvidia-smi reports
them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K_FULL, CHUNKS, CHUNK_LEN, BATCH = (21, 63), 256, 1 << 20, 8
BC_SIZE, BF_SIZE = "64M", "512M"  # phase_bloom's bc -s and --bf-size
FILTER_CHUNKS = 64  # phase_bloom's count --bc and --bf-size: a quarter
PACK_GRAIN = 1 << 21  # phase_packed's grain: 128 grains, runs at level 2
DISK_GRAIN = 1 << 18  # the CLI --disk spill pair's grain: one a batch
IF_CHUNKS, IF_RANDOM = 16, 1 << 20  # phase_if's allowed chunks, random bases
# phase_sharded's (k, shards) on the one card, and the chunks of the
# profiled pass of each (the profiler stretches a full pass to 30-45 s)
SHARD_RUNS, SHARD_PROFILE_CHUNKS = ((21, 2), (21, 4), (63, 4)), 64
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def log(*a):
    print(*a, flush=True)


# -- host oracles (numpy, independent of the package) -------------------------

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b | 0x20] = _i


def canonical_words(seq: np.ndarray, k: int) -> np.ndarray:
    """Canonical 2-bit codes of the valid k-windows of an ASCII sequence:
    [n, nw] uint64 words of the 2k-bit value, most significant first."""
    code = _CODE[seq]
    n = max(len(seq) - k + 1, 0)
    csum = np.concatenate([[0], np.cumsum(code > 3, dtype=np.int64)])
    valid = csum[k:] - csum[:n] == 0
    c = (code & 3).astype(np.uint64)
    nw = (2 * k + 63) // 64
    f = np.zeros((nw, n), np.uint64)
    r = np.zeros((nw, n), np.uint64)
    for j in range(k):
        cj = c[j:j + n]
        for val, pos, dst in ((cj, 2 * (k - 1 - j), f), (3 - cj, 2 * j, r)):
            dst[nw - 1 - pos // 64] |= val << np.uint64(pos % 64)
    rc_less = np.zeros(n, bool)
    eq = np.ones(n, bool)
    for w in range(nw):
        rc_less |= eq & (r[w] < f[w])
        eq &= r[w] == f[w]
    return np.ascontiguousarray(np.where(rc_less, r, f)[:, valid].T)


def _row_sorted(x: np.ndarray):
    """x [n, nw] in ascending row order (first column most significant)."""
    return x[np.lexsort(x.T[::-1])]


def unique_rows(x: np.ndarray):
    """(distinct rows ascending, their counts) of x [n, nw]."""
    x = _row_sorted(x)
    new = np.ones(len(x), bool)
    new[1:] = (x[1:] != x[:-1]).any(axis=1)
    idx = np.flatnonzero(new)
    return x[idx], np.diff(np.append(idx, len(x)))


def distinct_count(parts, top_bits: int, buckets: int = 256) -> int:
    """Distinct rows among the [n, nw] uint64 arrays `parts` (first column
    most significant and below 2^top_bits), counted in value-range buckets
    of the first column on 8 threads."""
    shift = np.uint64(max(top_bits - 8, 0))

    def split(a):
        b = (a[:, 0] >> shift).astype(np.int64)
        order = np.argsort(b, kind="stable")
        a, b = a[order], b[order]
        cut = np.searchsorted(b, np.arange(buckets + 1))
        return [a[cut[i]:cut[i + 1]] for i in range(buckets)]

    def count(i):
        x = np.concatenate([p[i] for p in split_parts])
        return len(unique_rows(x)[1]) if len(x) else 0

    with ThreadPoolExecutor(8) as pool:
        split_parts = list(pool.map(split, parts))
        return sum(pool.map(count, range(buckets)))


def read_db(path):
    """(header, keys [n, nw] uint64 words most significant first, counts)
    of a binary/sorted database."""
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(path, "rb") as f:
        h = FileHeader.read(f)
        data = f.read()
    kb = (h.key_len + 7) // 8
    rec = np.frombuffer(data, np.uint8).reshape(-1, kb + h.counter_len)
    nw = (kb + 7) // 8
    key = np.zeros((len(rec), 8 * nw), np.uint8)
    key[:, :kb] = rec[:, :kb]
    cnt = np.zeros((len(rec), 8), np.uint8)
    cnt[:, :h.counter_len] = rec[:, kb:]
    words = np.ascontiguousarray(key.view("<u8")[:, ::-1])
    return h, words, cnt.view("<u8")[:, 0].copy()


def _parity(t):
    for s in (32, 16, 8, 4, 2, 1):
        t = t ^ (t >> np.uint64(s))
    return t & np.uint64(1)


def sortkeys_ascend(h, words) -> bool:
    """Whether the records ascend in (pos, key >> l) order, pos = the
    header matrix applied to the key: the reference's dump order."""
    from jellyfish_tpu_torch.ops.hashing import masks_of_matrix

    k, lsize = h.key_len // 2, (h.size - 1).bit_length()
    W = (2 * k + 31) // 32
    masks = masks_of_matrix(h.matrix(), W).astype(np.uint64)
    lsw = words[:, ::-1]  # least significant word first
    n, nw = lsw.shape
    limbs = [lsw[:, w // 2] >> np.uint64(32 * (w % 2)) & np.uint64(0xFFFFFFFF)
             for w in range(W)]
    pos = np.zeros(n, np.uint64)
    for j in range(masks.shape[0]):
        t = np.zeros(n, np.uint64)
        for w in range(W):
            t ^= limbs[w] & masks[j, w]
        pos |= _parity(t) << np.uint64(j)
    q, r = divmod(lsize, 64)
    zero = np.zeros(n, np.uint64)
    word = lambda i: lsw[:, i] if i < nw else zero  # noqa: E731
    high = [(word(i + q) >> np.uint64(r)) | (word(i + q + 1) << np.uint64(64 - r))
            if r else word(i + q) for i in range(nw)]
    return bool((np.lexsort([*high, pos]) == np.arange(n)).all())


def synth_chunks(n_chunks, L, read_len=150, seed=1234):
    """Chunks of 150-base reads, each followed by one N, sampled from a
    seeded random genome of n_chunks * L / 8 bases (8x coverage)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = acgt[rng.integers(0, 4, size=max(n_chunks * L // 8, 1 << 20))]
    out = np.empty((n_chunks, L), dtype=np.uint8)
    n_reads = (L + read_len) // (read_len + 1)
    for i in range(n_chunks):
        starts = rng.integers(0, len(genome) - read_len, size=n_reads)
        idx = starts[:, None] + np.arange(read_len)[None, :]
        reads = np.concatenate(
            [genome[idx], np.full((n_reads, 1), ord("N"), np.uint8)], axis=1)
        out[i] = reads.reshape(-1)[:L]
    return out


def write_fastq(path, n_bases, genome_len, seed):
    """Seeded FASTQ of 150-base reads, 0.2% N bases; returns the reads
    joined by N (the oracle's input)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = acgt[rng.integers(0, 4, size=genome_len)]
    n = n_bases // 150
    starts = rng.integers(0, genome_len - 150, size=n)
    reads = genome[starts[:, None] + np.arange(150)[None, :]]
    reads[rng.random(reads.shape) < 0.002] = ord("N")
    qual = b"I" * 150
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual)
                         for i, r in enumerate(reads)))
    sep = np.full((n, 1), ord("N"), np.uint8)
    return np.concatenate([reads, sep], axis=1).reshape(-1)


# -- timing --------------------------------------------------------------------


def cuda_ms(fn, reps=5):
    """Device time of one call of fn, ms: the mean of `reps` calls
    between two events. The stream is held by a spinning kernel while the
    calls are enqueued, so that a call whose host side (Python, launches)
    outlasts its device work is timed by its device work, not by the
    host's pace: the events see the calls back to back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()  # its enqueue, or more where it waits for the device
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))  # <= 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(got, want):
    """Largest |g - w| over pairs of outputs of one shape: 0 exactly when
    they are equal (a difference that overflows int64 counts as >= 1)."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"shapes differ: {g.shape} vs {w.shape}")
        if g.numel() and not torch.equal(g, w):
            err = max(err, int((g - w).abs().max()), 1)
    return err


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by name; each counts its calls
    that launched on the card in its `launches` attribute."""
    from jellyfish_tpu_torch.kernels.bitonic import (
        block_merge,
        block_sort,
        exchange_stages,
        flip,
    )
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.merge_path import (
        merge_pass,
        merge_path,
        merge_splits,
    )
    from jellyfish_tpu_torch.kernels.window import roll_lanes, window_rows

    return {"merge_path": merge_path, "merge_pass": merge_pass,
            "merge_splits": merge_splits,
            "compact": compact, "block_sort": block_sort,
            "block_merge": block_merge,
            "exchange_stages": exchange_stages, "flip": flip,
            "window_rows": window_rows, "roll_lanes": roll_lanes}


def kernel_counts() -> dict:
    """Launch counts of every kernel wrapper of the port, and of
    exchange_stages' kernel passes and its calls whose first step is
    mirrored."""
    w = _wrappers()
    counts = {name: fn.launches for name, fn in w.items()}
    counts["exchange_stages.passes"] = w["exchange_stages"].passes
    counts["exchange_stages.mirror"] = w["exchange_stages"].mirror_launches
    return counts


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["exchange_stages"].passes = 0
    _wrappers()["exchange_stages"].mirror_launches = 0


# -- phases --------------------------------------------------------------------


def phase_kernels(dev):
    from jellyfish_tpu_torch.kernels.compact import compact, compact_plain
    from jellyfish_tpu_torch.kernels.merge_path import (
        merge_path,
        merge_path_plain,
    )
    from jellyfish_tpu_torch.ops.count import sort_rows
    from jellyfish_tpu_torch.ops.multiword import M32, PAD_PACKED

    g = torch.Generator(device=dev).manual_seed(7)
    rows = {}

    def sorted_run(n, wk, hi):
        k = torch.randint(0, hi, (n, wk), device=dev, generator=g)
        return sort_rows(k).contiguous()

    def shared_runs(n, wk, share=0.9):
        """Two sorted runs of n rows drawn from one sorted pool of n / share
        rows, as the main path's merges see them: most keys lie in both
        runs, and the pool's largest row, the PAD key (INT64_MAX packed,
        all-ones limbs), lies in each. Packed keys span the whole int64
        range, limbs 0 .. 2^32 - 1."""
        m = int(n / share)
        if wk == 1:
            hi = torch.randint(-(1 << 31), 1 << 31, (m - 1, 1), device=dev,
                               generator=g)
            lo = torch.randint(0, 1 << 32, (m - 1, 1), device=dev,
                               generator=g)
            pool, pad = (hi << 32) | lo, PAD_PACKED
        else:
            pool = torch.randint(0, 1 << 32, (m - 1, wk), device=dev,
                                 generator=g)
            pad = M32
        pool = torch.cat([pool, torch.full((1, wk), pad, device=dev)])
        pool = sort_rows(pool)
        last = torch.tensor([m - 1], device=dev)

        def pick():
            idx = torch.randperm(m - 1, device=dev, generator=g)[:n - 1]
            return pool[torch.cat([idx.sort().values, last])].contiguous()

        return pick(), pick()

    # K1 at the shape of the full-size run's final merge (two runs of 2^24
    # packed keys), plus unpacked cases: Wk 3 is the store's key width for
    # k = 33-48, Wk 2 (not on the path) is the kernel's other instance
    # below it
    err_all = 0
    for wk, n in ((2, 1 << 20), (3, 1 << 18), (1, 1 << 24)):
        na = nb = n
        a, b = shared_runs(n, wk)
        ac = torch.randint(1, 1 << 20, (na,), device=dev, generator=g)
        bc = torch.randint(1, 1 << 20, (nb,), device=dev, generator=g)
        got = merge_path(a, ac, b, bc)
        want = merge_path_plain(a, ac, b, bc)
        err = max_abs_err(got, want)
        ties = int((want[0][1:] == want[0][:-1]).all(-1).sum())
        log(f"K1 merge_path wk={wk} {na}+{nb} rows, keys "
            f"{int(want[0][0, -1])} .. {int(want[0][-1, -1])}, {ties} tied "
            f"pairs: max_abs_err {err}")
        if err:
            raise AssertionError("merge_path disagrees with its plain version")
        err_all = max(err_all, err)
    nbytes = 2 * (na + nb) * (wk + 1) * 8
    cat_c = torch.cat([ac, bc])

    def library():
        s, perm = torch.sort(torch.cat([a, b])[:, 0], stable=True)
        return s, cat_c[perm]

    rows["merge_path"] = dict(
        name="merge_path", route="cuda",
        source="jellyfish_tpu_torch/csrc/merge_path.cu",
        replaces="experiments/pallas_merge_probe.py:492",
        max_abs_err=err_all,
        ms=cuda_ms(lambda: merge_path(a, ac, b, bc)),
        plain_ms=cuda_ms(lambda: merge_path_plain(a, ac, b, bc)),
        bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
        library_ms=cuda_ms(library),
        shape=f"A {na} + B {nb} rows, Wk {wk}",
    )
    del a, b, ac, bc, cat_c, got, want

    # K2 at a full grain: 2^27 sorted packed keys, 25% of rows live
    m = 1 << 27
    keys = sorted_run(m, 1, 1 << 62)
    cnt = torch.randint(1, 9, (m,), device=dev, generator=g)
    cnt *= torch.rand(m, device=dev, generator=g) < 0.25
    got = compact(keys, cnt)
    want = compact_plain(keys, cnt)
    err = max_abs_err(got[:2], want[:2]) + abs(got[2] - want[2])
    n = got[2]
    log(f"K2 compact {m} rows, {n} live: max_abs_err {err}")
    if err:
        raise AssertionError("compact disagrees with its plain version")

    def library2():
        keep = cnt != 0
        return keys[keep], cnt[keep]

    rows["compact"] = dict(
        name="compact", route="cuda",
        source="jellyfish_tpu_torch/csrc/compact.cu",
        replaces="experiments/pallas_compact.py:252",
        max_abs_err=err,
        ms=cuda_ms(lambda: compact(keys, cnt)),
        plain_ms=cuda_ms(lambda: compact_plain(keys, cnt)),
        bound_ms=1e3 * (m * 16 + n * 16) / PEAK_BYTES_PER_S,
        bound_by="bytes",
        library_ms=cuda_ms(library2),
        shape=f"{m} rows, Wk 1, {n} live",
    )
    del keys, cnt, got, want

    # K2 with a keep mask, the instance the merge runs, at its shape: one
    # round's merged takes of 4 inputs (4 x 2^20 rows) in segments of 1-4
    # equal keys, each segment's value on all its rows, some values 0. Kept
    # (as by merge -L 0 -U 5): a segment's first row when its value is at
    # most 5, so kept rows of value 0 and dropped rows of any value
    m = 4 << 20
    for wk in (4, 1):
        pool = sorted_run(m, wk, 1 << 62 if wk == 1 else 1 << 32)
        reps = torch.randint(1, 5, (m,), device=dev, generator=g)
        keys = torch.repeat_interleave(pool, reps, dim=0)[:m].contiguous()
        is_new = torch.ones(m, dtype=torch.bool, device=dev)
        is_new[1:] = (keys[1:] != keys[:-1]).any(dim=1)
        vals = torch.randint(0, 9, (m,), device=dev,
                             generator=g)[torch.cumsum(is_new, 0) - 1]
        keep = is_new & (vals <= 5)
        n = int(keep.sum())
        zeros = int((keep & (vals == 0)).sum())
        dropped = int((~keep & (vals != 0)).sum())
        label = (f"K2 compact with a keep mask, {m} rows, Wk {wk}, {n} kept "
                 f"({zeros} of value 0), {dropped} nonzero dropped")
        if compact(keys, vals, keep)[2] != n or not zeros or not dropped:
            raise AssertionError(f"{label}: wrong kept-row total or input")
        row = hold(label, lambda: compact(keys, vals, keep)[:2],
                   lambda: compact_plain(keys, vals, keep)[:2],
                   m * (wk + 1) * 8 + m + n * (wk + 1) * 8,
                   library=lambda: (keys[keep], vals[keep]))
    # the keep mask's two kernels alone (the row is the full-size merge's
    # width, Wk 1): the call reads its kept count on the host, so it runs
    # at the host's pace, and its kernels' device time comes from the
    # profiler, ten calls in one window, each kernel's mean over the
    # launches the profiler recorded
    prof_rows = profiled(lambda: [compact(keys, vals, keep)
                                  for _ in range(10)])[2]
    kernel_us = sum(us / n for name, us, n in prof_rows if "compact_" in name)
    row = dict(row, call_ms=row["ms"], ms=kernel_us / 1e3)
    log(f"  {label}: kernels {row['ms']:.4f} ms a call (profiler: "
        f"{[(name[:60], us, n) for name, us, n in prof_rows[:4]]}), the "
        f"call {row['call_ms']:.4f} ms")
    rows["compact_keep"] = dict(
        name="compact.keep_mask", route="cuda",
        source="jellyfish_tpu_torch/csrc/compact.cu",
        replaces="experiments/pallas_compact.py:252", **row)
    del pool, reps, keys, is_new, vals, keep
    torch.cuda.empty_cache()
    return rows


def _outs(x):
    """A wrapper's result as a tuple of tensors (None payloads dropped)."""
    return tuple(t for t in (x if isinstance(x, tuple) else (x,))
                 if t is not None)


def hold(label, fn, plain, nbytes=None, library=None, reps=5):
    """Run a kernel entry point and its plain version on the same inputs,
    fail unless they agree exactly; with nbytes, also time both (and the
    library call), `reps` calls each, and return the kernel table's
    numbers."""
    err = max_abs_err(_outs(fn()), _outs(plain()))
    log(f"{label}: max_abs_err {err}")
    if err:
        raise AssertionError(f"{label} disagrees with its plain version")
    if nbytes is None:
        return None
    row = dict(max_abs_err=err, ms=cuda_ms(fn, reps),
               plain_ms=cuda_ms(plain, reps),
               bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
               library_ms=None if library is None else cuda_ms(library,
                                                               reps),
               shape=label)
    log(f"  {label}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f}, "
        f"plain {row['plain_ms']:.4f}, library {row['library_ms']}")
    return row


def _cycle(r, n, lanes=128):
    """The Pallas probes' step distances, as row distances of the [R, 128]
    tile read row-major: tile rows R/2, R/4, ..., 1, R/2, ... (n steps)."""
    out, m = [], r // 2
    for _ in range(n):
        out.append(max(m, 1) * lanes)
        m = m // 2 or r // 2
    return out


def bitonic_tiles(keys, payload, tile):
    """Tiles as the pair sort hands them to block_merge: tiles sorted,
    then the mirrored step at distance `tile`, which leaves each tile a
    bitonic sequence in order among its neighbours (plain versions)."""
    from jellyfish_tpu_torch.kernels.bitonic import (
        block_sort_plain,
        exchange_stages_plain,
    )

    k, p = block_sort_plain(keys, payload, tile)
    return exchange_stages_plain(k, p, [tile], mirror=True)


def ptxas_report(name):
    """Each kernel's registers and spilled bytes (stores + loads) from
    csrc/<name>.cu's ptxas report, the build's lib<name>.log, logged.
    Fails on a spill."""
    from jellyfish_tpu_torch.kernels import _build

    path = _build.BUILD_DIR / f"lib{name}.log"
    if not path.exists():
        log(f"ptxas report of {name}.cu: none (built by an earlier run)")
        return
    kernels, kernel = {}, None
    for line in path.read_text().splitlines():
        if "Function properties for" in line:
            kernel = line.split("Function properties for")[1].strip()
            kernels[kernel] = [None, 0]
        elif kernel and "spill" in line:
            kernels[kernel][1] = sum(map(int, re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line)))
        elif kernel and (used := re.search(r"Used (\d+) registers", line)):
            kernels[kernel][0] = int(used.group(1))
    names = list(kernels)
    if shutil.which("c++filt") and names:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for n, (regs, spill) in zip(names, kernels.values()):
        log(f"  ptxas {name}.cu: {regs} registers, {spill} bytes spilled: "
            f"{n}")
    spills = [n for n, (_, spill) in zip(names, kernels.values()) if spill]
    if not kernels or spills:
        raise AssertionError(f"{name}.cu: no ptxas report, or spills in "
                             f"{spills}")


def phase_k3(dev):
    """K3's entry points and K1's merge_pass against their plain versions:
    at the Pallas kernels' own shapes (kernel table rows 6, 7, 8, 11, 12)
    and at a grain's shape (2^26 rows of 4 limbs, keys only; 2^24 rows of
    7 limbs with a row-index payload), plus a ragged row count;
    block_merge on bitonic tiles at Wk 2 (with and without a payload) and
    Wk 7 + payload, and on unsorted small tiles; merge_pass and
    merge_splits at Wk 1-7 (keys only and with a payload), and merge_pass
    timed at the k = 63 grain's first and last passes and at Wk 1 +
    payload against a stable torch.sort of each pair. Returns the JSON
    rows of block_sort, flip, merge_pass and merge_splits
    (exchange_stages' rows come from phase_bloom, at the Bloom insert's
    shape), and the table's per-row numbers."""
    from jellyfish_tpu_torch.kernels.bitonic import (
        block_merge,
        block_merge_plain,
        block_sort,
        block_sort_plain,
        exchange_stages,
        exchange_stages_plain,
        flip,
        flip_plain,
        tile_rows,
    )
    from jellyfish_tpu_torch.kernels.merge_path import (
        merge_pass,
        merge_pass_plain,
        merge_splits,
        merge_splits_plain,
        pass_tile_rows,
        split_steps,
    )
    from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked
    from jellyfish_tpu_torch.ops.count import sort_rows, sort_rows_plain
    from jellyfish_tpu_torch.ops.multiword import M32

    g = torch.Generator(device=dev).manual_seed(3)
    u32 = lambda *shape: torch.randint(  # noqa: E731
        0, 1 << 32, shape, device=dev, generator=g)
    table = {}

    # row 6, pallas_sort_proto.py: one tile of 131,072 u32 keys sorted, by
    # the counting path's route: K3 on shared-memory tiles, then K1 passes
    t6 = 1 << 17
    x = u32(t6, 1)
    table["6 block_sort"] = hold(
        f"K3 block_sort (tile {tile_rows(1, False)}) + K1 merge_pass, {t6} "
        "keys sorted whole (row 6)",
        lambda: sort_rows_blocked(x), lambda: block_sort_plain(x, tile=t6),
        2 * t6 * 8, library=lambda: torch.sort(x.view(-1, t6), dim=1))
    # row 7, pallas_probe2.py build_stages(arrays=1): u32[4096, 128], one
    # cycle of 12 steps
    d7 = _cycle(4096, 12)
    x = u32(4096 * 128, 1)
    table["7 exchange_stages"] = hold(
        "K3 exchange_stages u32[4096, 128], 12 steps (row 7)",
        lambda: exchange_stages(x, distances=d7),
        lambda: exchange_stages_plain(x, distances=d7), 2 * x.numel() * 8)
    # row 8, build_stages(arrays=3): (hi, lo, count) triples, compared on
    # (hi, lo); few distinct hi values, so lo decides and some rows tie
    keys = torch.stack([u32(4096 * 128) % 64, u32(4096 * 128) % 4], 1)
    cnt = u32(4096 * 128)
    table["8 exchange_stages"] = hold(
        "K3 exchange_stages (hi, lo, count) 3x u32[4096, 128], 12 steps "
        "(row 8)",
        lambda: exchange_stages(keys, cnt, d7),
        lambda: exchange_stages_plain(keys, cnt, d7),
        2 * (keys.numel() + cnt.numel()) * 8)
    # row 11, pallas_stage_probe.py build: u32[1024, 128], transposes of
    # each [128, 128] sub-tile, then 10 steps
    d11 = _cycle(1024, 10)
    x = u32(1024 * 128, 1)
    for t in (0, 2):
        hold(f"K3 exchange_stages u32[1024, 128], {t} transposes + 10 steps "
             "(row 11)",
             lambda: exchange_stages(x, distances=d11, transposes=t),
             lambda: exchange_stages_plain(x, distances=d11, transposes=t))
    table["11 exchange_stages"] = hold(
        "K3 exchange_stages u32[1024, 128], 1 transpose + 10 steps (row 11)",
        lambda: exchange_stages(x, distances=d11, transposes=1),
        lambda: exchange_stages_plain(x, distances=d11, transposes=1),
        2 * x.numel() * 8)
    # row 12, pallas_stage_probe.py flip: u32[1024, 128] reversed
    table["12 flip"] = hold(
        "K3 flip u32[1024, 128] (row 12)",
        lambda: flip(x, x.shape[0]), lambda: flip_plain(x, x.shape[0]),
        2 * x.numel() * 8,
        library=lambda: torch.flip(x.view(-1, x.shape[0], 1), [1]))

    def grain(n, wk, distinct):
        """n rows of wk limbs drawn from `distinct` pooled rows (so rows
        repeat, as k-mers do at 8x coverage), 40% of them the all-ones
        PAD row (invalid windows, as in the full-size run)."""
        pool = u32(distinct, wk)
        x = pool[torch.randint(0, distinct, (n,), device=dev, generator=g)]
        x[torch.rand(n, device=dev, generator=g) < 0.4] = M32
        return x.contiguous()

    # the whole grain sort against the LSD chain at each limb width of the
    # large-key path's grains: 3 limbs (k = 33-48, 2^27 rows), 4 (k = 63)
    # and 7 (k = 100, both 2^26 rows)
    for wk, m in ((3, 1 << 27), (7, 1 << 26)):
        x = grain(m, wk, m >> 2)
        table[f"grain sort_rows wk={wk}"] = hold(
            f"sort_rows (K3 + merge_pass) {m} rows, Wk {wk}, keys only",
            lambda: sort_rows(x), lambda: sort_rows_plain(x)[0],
            2 * m * wk * 8)
        del x
        torch.cuda.empty_cache()
    # a grain of the k = 63 store: 2^26 rows of 4 limbs, keys only
    m = 1 << 26
    x = grain(m, 4, 1 << 24)
    row_bytes = m * 4 * 8
    sort_row = hold(
        f"K3 block_sort {m} rows, Wk 4, keys only, tile 2048 (a k=63 grain)",
        lambda: block_sort(x), lambda: block_sort_plain(x), 2 * row_bytes,
        library=lambda: sort_rows_plain(x))
    hold(f"K3 exchange_stages {m} rows, Wk 4, 3 steps",
         lambda: exchange_stages(x, distances=[1 << 25, 2048, 1]),
         lambda: exchange_stages_plain(x, distances=[1 << 25, 2048, 1]))
    hold(f"K3 flip {m} rows, Wk 4, tile 2048",
         lambda: flip(x, 2048), lambda: flip_plain(x, 2048))
    table["grain sort_rows"] = hold(
        f"sort_rows (K3 + 15 merge_pass) {m} rows, Wk 4, keys only",
        lambda: sort_rows(x), lambda: sort_rows_plain(x)[0], 2 * row_bytes)
    runs = block_sort_plain(x, tile=1 << 22)[0]
    pass_row = hold(
        f"K1 merge_pass {m} rows, Wk 4, keys only, runs of 2^22",
        lambda: merge_pass(runs, 1 << 22),
        lambda: merge_pass_plain(runs, 1 << 22), 2 * row_bytes)
    # its partition pass: the splits of 8 pairs at tiles of 2048 rows; the
    # least bytes a boundary's search reads are the two rows either side
    # of its split
    tile = pass_tile_rows(4, False)
    pairs, steps = split_steps(m, 1 << 22, tile)
    n_splits = pairs * (steps + 1)
    splits_row = hold(
        f"K1 merge_splits {m} rows, Wk 4, runs of 2^22, tiles of {tile}",
        lambda: merge_splits(runs, 1 << 22, tile),
        lambda: merge_splits_plain(runs, 1 << 22, tile),
        n_splits * (8 + 2 * 4 * 8))
    # the grain's first pass: runs of 2048 as block_sort leaves them; the
    # plain version of a pass over 32,768 pairs is the stable sort of each
    # pair (block_sort_plain at tiles of 4096, keys only)
    runs = block_sort(x)[0]
    table["merge_pass first"] = hold(
        f"K1 merge_pass {m} rows, Wk 4, keys only, runs of 2048 (the "
        "grain's first pass)",
        lambda: merge_pass(runs, 2048)[0],
        lambda: block_sort_plain(runs, tile=4096)[0], 2 * row_bytes)
    del x, runs
    # 2^24 rows of 7 limbs (k = 100) with a row-index payload: stable
    m = 1 << 24
    x = grain(m, 7, 1 << 22)
    idx = torch.arange(m, device=dev)
    hold(f"K3 block_sort {m} rows, Wk 7 + payload, tile 1024",
         lambda: block_sort(x, idx), lambda: block_sort_plain(x, idx))
    hold(f"K3 exchange_stages {m} rows, Wk 7 + payload, 1 transpose + 3 "
         "steps",
         lambda: exchange_stages(x, idx, [1 << 23, 64, 1], transposes=1),
         lambda: exchange_stages_plain(x, idx, [1 << 23, 64, 1], 1))
    hold(f"K3 flip {m} rows, Wk 7, tile 1024",
         lambda: flip(x, 1024), lambda: flip_plain(x, 1024))
    bk, bi = bitonic_tiles(x, idx, 1024)
    hold(f"K3 block_merge {m} rows, Wk 7 + payload, bitonic tiles of 1024",
         lambda: block_merge(bk, bi, 1024),
         lambda: block_merge_plain(bk, bi, 1024))
    del bk, bi
    runs, ridx = block_sort_plain(x, idx, tile=1 << 16)
    table["merge_pass wk=7 + payload"] = hold(
        f"K1 merge_pass {m} rows, Wk 7 + payload, runs of 2^16",
        lambda: merge_pass(runs, 1 << 16, ridx),
        lambda: merge_pass_plain(runs, 1 << 16, ridx), 2 * m * 8 * 8)
    hold(f"sort_rows_blocked {m} rows, Wk 7 + row index: the stable perm",
         lambda: sort_rows_blocked(x, idx), lambda: sort_rows_plain(x))
    del x, idx, runs, ridx
    # a ragged row count: a padded last tile, a short last pair, a lone run
    m = (1 << 20) + 777
    x = grain(m, 4, 1 << 18)
    idx = torch.arange(m, device=dev)
    hold(f"K3 block_sort {m} rows, Wk 4 (+ payload)",
         lambda: block_sort(x) + block_sort(x, idx),
         lambda: block_sort_plain(x) + block_sort_plain(x, idx))
    runs = block_sort_plain(x, tile=1 << 17)[0]
    hold(f"K1 merge_pass {m} rows, Wk 4, runs of 2^17",
         lambda: merge_pass(runs, 1 << 17),
         lambda: merge_pass_plain(runs, 1 << 17))
    del x, idx, runs
    # merge_pass and its splits at every key width, keys only and with a
    # row-index payload (so a tie out of order shows): runs of one row
    # (4,097 rows), of 2,048 and 2^16 rows and one longer than the array
    # (2^22) on (1 << 20) + 777 rows: a short last pair, a lone last run
    for wk in range(1, 8):
        for m, run_lens in ((4097, (1,)),
                            ((1 << 20) + 777, (2048, 1 << 16, 1 << 22))):
            x = grain(m, wk, m >> 2)
            idx = torch.arange(m, device=dev)
            for run in run_lens:
                runs = x if run == 1 else block_sort_plain(x, tile=run)[0]
                for pay in (None, idx):
                    tile = pass_tile_rows(wk, pay is not None)
                    hold(f"K1 merge_pass {m} rows, Wk {wk}"
                         f"{' + payload' if pay is not None else ''}, runs "
                         f"of {run}; its splits at tiles of {tile}",
                         lambda: merge_pass(runs, run, pay)
                         + (merge_splits(runs, run, tile),),
                         lambda: merge_pass_plain(runs, run, pay)
                         + (merge_splits_plain(runs, run, tile),))
            del x, idx, runs
    # Wk 1 + payload (the Bloom insert's rows), 2^24 rows in runs of 2^22,
    # against the one PyTorch call that merges them: a stable sort of each
    # pair's keys, and a gather of the payload
    m, run = 1 << 24, 1 << 22
    x = torch.sort(torch.randint(-(1 << 63), (1 << 63) - 1, (m // run, run),
                                 device=dev, generator=g), dim=1)[0]
    x = x.reshape(-1, 1)
    pay = torch.randint(0, 1 << 40, (m,), device=dev, generator=g)

    def library():
        s, perm = torch.sort(x.view(-1, 2 * run), dim=1, stable=True)
        return s, torch.gather(pay.view(-1, 2 * run), 1, perm)

    table["merge_pass wk=1 + payload"] = hold(
        f"K1 merge_pass {m} rows, Wk 1 + payload, runs of 2^22",
        lambda: merge_pass(x, run, pay), lambda: merge_pass_plain(x, run, pay),
        2 * m * 16, library=library)
    del x, pay
    # block_merge at Wk 2 (BitsArray's (seq, id) rows): bitonic tiles of
    # the largest tile and of a small one (several tiles a block), and
    # unsorted tiles
    m = 1 << 22
    x = grain(m, 2, 1 << 20)
    idx = torch.arange(m, device=dev)
    for t in (tile_rows(2, True), 64):
        bk, bi = bitonic_tiles(x, idx, t)
        hold(f"K3 block_merge {m} rows, Wk 2 (+ payload), bitonic tiles "
             f"of {t}",
             lambda: block_merge(bk, None, t) + block_merge(bk, bi, t),
             lambda: block_merge_plain(bk, None, t)
             + block_merge_plain(bk, bi, t))
    hold(f"K3 block_merge {m} rows, Wk 2 + payload, unsorted tiles of 128",
         lambda: block_merge(x, idx, 128),
         lambda: block_merge_plain(x, idx, 128))
    del x, idx, bk, bi
    torch.cuda.empty_cache()

    def json_row(name, row, source, replaces, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, **row, **extra)

    k3_src = "jellyfish_tpu_torch/csrc/bitonic.cu"
    rows = {
        "block_sort": json_row(
            "bitonic.block_sort", sort_row, k3_src,
            "experiments/pallas_sort_proto.py:65",
            library="sort_rows_plain: a chain of 4 stable sorts and "
                    "gathers over the whole grain (no single PyTorch call "
                    "sorts multi-column rows)"),
        "flip": json_row(
            "bitonic.flip", table["12 flip"], k3_src,
            "experiments/pallas_stage_probe.py:112",
            note="on no path (the Bloom path runs row 12's reversal as "
                 "exchange_stages' mirrored step): held against its plain "
                 "version here"),
        "merge_pass": json_row(
            "merge_path.merge_pass", pass_row,
            "jellyfish_tpu_torch/csrc/merge_path.cu",
            "experiments/pallas_merge_probe.py:492",
            note="one call is two kernel launches: merge_splits, then the "
                 "tiles"),
        "merge_splits": json_row(
            "merge_path.merge_splits", splits_row,
            "jellyfish_tpu_torch/csrc/merge_path.cu",
            "experiments/pallas_merge_probe.py:492",
            note="merge_pass's partition pass (the Pallas merge's split "
                 "points, computed there by XLA outside the kernel)"),
    }
    return rows, table


def one_pass_each(keys, payload, dist, mirror):
    """The steps of exchange_stages(keys, payload, dist, mirror) one
    jf_exchange pass each, as before the fused passes: the yardstick the
    fused call is timed against."""
    from jellyfish_tpu_torch.kernels.bitonic import exchange_stages

    for i, d in enumerate(dist):
        keys, payload = exchange_stages(keys, payload, [d],
                                        mirror=mirror and i == 0)
    return keys, payload


def passes_of(fn, label, want):
    """The kernel passes that one call of fn (an exchange_stages call)
    launches, counted by exchange_stages.passes; fails unless there are
    `want`."""
    from jellyfish_tpu_torch.kernels.bitonic import exchange_stages

    before = exchange_stages.passes
    exchange_stages.passes = 0
    fn()
    got = exchange_stages.passes
    exchange_stages.passes = before
    if got != want:
        raise AssertionError(f"{label}: {got} kernel passes, not {want}")
    return got


def phase_exchange(dev):
    """Row 8's fused passes (jf_exchange_group) against
    exchange_stages_plain, exact, beyond the insert's shapes (phase_bloom
    holds those): BitsArray's rows (2^22, Wk 2 + payload, its last phase:
    the mirrored step at 2^21, then plain steps down to its tile of 4096),
    rows of 7 limbs with a payload (2^22 rows, three steps a pass, the
    mirrored step at 2^21 down to 1024), 4 limbs keys only (2^24 rows,
    plain steps 2^23 ... 2^12, and mirrored), runs of 2 and 3 steps, and
    short distances down to 1 (a warp across several 2d-row blocks). The
    first three are timed against the same steps one jf_exchange pass
    each. Where a number of passes is given, the kernel passes that one
    call launches are counted and held to it. Returns the timings."""
    from jellyfish_tpu_torch.kernels.bitonic import (
        exchange_stages,
        exchange_stages_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)

    def rows(m, wk):
        """Limbs with ties: the top column from 16 values (above one
        column), and an eighth of the rows repeated whole."""
        x = torch.randint(0, 1 << 32, (m, wk), device=dev, generator=g)
        if wk > 1:
            x[:, -1] %= 16
        x[m // 2: m // 2 + m // 8] = x[: m // 8]
        return x

    def check(label, keys, pay, dist, mirror, passes=None, timed=False):
        m = keys.shape[0]

        def fn():
            return exchange_stages(keys, pay, dist, mirror=mirror)

        def plain():
            return exchange_stages_plain(keys, pay, dist, mirror=mirror)

        label = (f"K3 exchange_stages {label}, "
                 f"{'mirrored ' if mirror else ''}{len(dist)} steps "
                 f"{dist[0]} ... {dist[-1]}")
        if passes is not None:
            label += f" in {passes_of(fn, label, passes)} passes"
        if not timed:
            return hold(label, fn, plain)
        nbytes = 2 * 8 * (keys.numel() + (0 if pay is None else m))
        row = hold(label, fn, plain, nbytes)
        row["steps_ms"] = cuda_ms(lambda: one_pass_each(keys, pay, dist,
                                                        mirror))
        row["passes"] = passes
        log(f"  the same steps one pass each: {row['steps_ms']:.4f} ms")
        return row

    table = {}
    m = 1 << 22
    keys, pay = rows(m, 2), torch.randint(0, 1 << 32, (m,), device=dev,
                                           generator=g)
    dist = [m >> i for i in range(1, 11)]  # 2^21 ... 4096
    table["wk=2+payload"] = check(f"{m} rows, Wk 2 + payload", keys, pay,
                                  dist, True, passes=3, timed=True)
    keys = rows(m, 7)
    dist = [m >> i for i in range(1, 13)]  # 2^21 ... 1024
    table["wk=7+payload"] = check(f"{m} rows, Wk 7 + payload", keys, pay,
                                  dist, True, passes=4, timed=True)
    del keys, pay
    m = 1 << 24
    keys = rows(m, 4)
    dist = [m >> i for i in range(1, 13)]  # 2^23 ... 4096
    table["wk=4"] = check(f"{m} rows, Wk 4, keys only", keys, None, dist,
                          False, passes=3, timed=True)
    check(f"{m} rows, Wk 4, keys only", keys, None, dist[:7], True,
          passes=2)
    keys = rows(m, 1)
    pay = torch.randint(0, 1 << 32, (m,), device=dev, generator=g)
    check(f"{m} rows, Wk 1 + payload", keys, pay, [1 << 13, 1 << 12], False,
          passes=1)
    check(f"{m} rows, Wk 1 + payload", keys, pay, [1 << 14, 1 << 13, 1 << 12],
          True, passes=1)
    m = 1 << 16
    keys, pay = keys[:m].contiguous(), pay[:m].contiguous()
    for dist, mirror in (([8, 4, 2, 1], True), ([2, 1], True),
                         ([4, 2, 1], False), ([64, 32, 16, 8, 4, 2, 1], True)):
        check(f"{m} rows, Wk 1 + payload", keys, pay, dist, mirror)
    keys = rows(m, 3)
    check(f"{m} rows, Wk 3, keys only", keys, None, [16, 8, 4], False)
    keys = rows(m, 6)
    check(f"{m} rows, Wk 6 + payload", keys, pay, [32, 16, 8, 4, 2], True)
    del keys, pay
    torch.cuda.empty_cache()
    return table


def phase_window(dev):
    """Rows 9 and 10 (csrc/window.cu) against their plain versions, exact:
    at the Pallas probes' shapes, at the merge's shape (2^20-row windows
    of a 2^24-row slab, eight a timed call, at odd offsets, Wk 1 and 4,
    and even ones, Wk 1; the slab's rotation by -cursor) and at the edges
    (windows of several tiles across either end of the run and wholly
    outside it, at odd and even offsets, Wk 1, 3 and 4), with offsets and
    shifts on the host and on the device. Returns the JSON rows, timed at Wk 1 (the
    full-size merge's width), and the other timings."""
    from jellyfish_tpu_torch.kernels.window import (
        roll_lanes,
        roll_lanes_plain,
        window_rows,
        window_rows_plain,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    on = lambda v: torch.tensor(v, device=dev)  # noqa: E731

    # row 9, test_unaligned_dma: u32[65536] as one key column, 4096 rows
    x = torch.randint(0, 1 << 32, (1 << 16, 1), device=dev, generator=g)
    c = torch.randint(0, 1 << 40, (1 << 16,), device=dev, generator=g)
    for off in (0, 128, 131, 7777):
        for o in (off, on(off)):
            hold(f"window_rows u32[65536] off {off} ({type(o).__name__}) "
                 "(row 9)", lambda: window_rows(x, c, o, 4096),
                 lambda: window_rows_plain(x, c, off, 4096))
        if not torch.equal(window_rows(x, c, on(off), 4096)[0],
                           x[off:off + 4096]):
            raise AssertionError("window_rows != x[off:off+4096]")
    # row 10, test_dynamic_roll: u32[8, 128]
    x = torch.randint(0, 1 << 32, (8, 128), device=dev, generator=g)
    for s in (1, 37):
        for v in (s, on(s)):
            hold(f"roll_lanes u32[8, 128] shift {s} ({type(v).__name__}) "
                 "(row 10)", lambda: roll_lanes(x, v),
                 lambda: roll_lanes_plain(x, s))
    # the edges: windows past the end and before the start, shifts 0,
    # negative and larger than the row
    m = 1_000_003
    x = torch.randint(0, 1 << 32, (m, 4), device=dev, generator=g)
    c = torch.randint(0, 1 << 40, (m,), device=dev, generator=g)
    for off, n in ((m - 5, 100), (m + 7, 50), (-30, 100), (0, 0),
                   (12345, 2 * m)):
        hold(f"window_rows edge off {off} n {n}, Wk 4",
             lambda: window_rows(x, c, on(off), n),
             lambda: window_rows_plain(x, c, off, n))
    # windows of several tiles at Wk 1, 3 and 4: inside the run, across
    # its start and its end, wholly past the end and wholly before the
    # start, each at an odd and an even offset (so an odd and an even
    # source word off * wk at Wk 1 and 3; at Wk 4 the counts' offset
    # takes both parities), the offset on the device and on the host
    n = (1 << 17) + 5
    for wk in (1, 3, 4):
        xw = x[:, :wk].contiguous()
        for base in (12_344, -778, m - 5_000, m + 10, -n - 4):
            for off in (base, base + 1):
                for o in (off, on(off)):
                    hold(f"window_rows off {off} n {n} "
                         f"({type(o).__name__}), Wk {wk}",
                         lambda: window_rows(xw, c, o, n),
                         lambda: window_rows_plain(xw, c, off, n))
    del xw
    flat = x.view(1, -1)
    for s in (0, -1, -4 * 777_777, 4 * m + 9, -(13 * 4 * m) - 3, 4 * m):
        hold(f"roll_lanes edge shift {s} of [1, {4 * m}]",
             lambda: roll_lanes(flat, on(s)),
             lambda: roll_lanes_plain(flat, s))
    del x, c, flat

    # the merge's shape: 2^20-row windows of a 2^24-row slab, timed eight
    # windows a call, 1,500,000 rows apart from the offset, so that the
    # rows a call reads (128 MiB at Wk 1) do not stay in the 50 MB L2
    # between calls, as the merge's rounds do not
    rows, table = {}, {}
    slab, n, off, apart = 1 << 24, 1 << 20, 5_000_001, 1_500_000

    def windows(keys, cnt, wk, first):
        offs = [first + i * apart for i in range(8)]
        curs = [on(o) for o in offs]
        row = hold(
            f"window_rows {n} rows at {first} + i * {apart} (i < 8) of a "
            f"{slab}-row slab, Wk {wk}",
            lambda: tuple(t for cu in curs
                          for t in window_rows(keys, cnt, cu, n)),
            lambda: tuple(t for o in offs
                          for t in window_rows_plain(keys, cnt, o, n)),
            8 * 2 * n * (wk + 1) * 8,
            library=lambda: tuple(t for o in offs for t in (
                keys[o:o + n].clone(), cnt[o:o + n].clone())), reps=10)
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            row[key] /= 8  # one window
        log(f"  one window: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f}, "
            f"clone {row['library_ms']:.4f}")
        return row

    for wk in (1, 4):
        keys = torch.randint(0, 1 << 32, (slab, wk), device=dev, generator=g)
        cnt = torch.randint(0, 1 << 40, (slab,), device=dev, generator=g)
        win = windows(keys, cnt, wk, off)
        cur = on(off)
        flat, cflat = keys.view(1, -1), cnt.view(1, -1)
        sk, sc = cur * -wk, -cur
        roll = hold(
            f"roll_lanes of a {slab}-row slab by -{off} rows, Wk {wk} "
            "(keys and counts)",
            lambda: (roll_lanes(flat, sk), roll_lanes(cflat, sc)),
            lambda: (roll_lanes_plain(flat, -off * wk),
                     roll_lanes_plain(cflat, -off)),
            2 * slab * (wk + 1) * 8,
            library=lambda: (torch.roll(flat, -off * wk, 1),
                             torch.roll(cflat, -off, 1)))
        table[f"wk={wk}"] = {"window_rows": win, "roll_lanes": roll}
        if wk == 1:  # even source words: the 16-byte loads
            table["wk=1"]["window_rows_even"] = windows(keys, cnt, wk,
                                                        off - 1)
        del keys, cnt, flat, cflat
    torch.cuda.empty_cache()
    src = "jellyfish_tpu_torch/csrc/window.cu"
    rows["window_rows"] = dict(
        name="window.window_rows", route="cuda", source=src,
        replaces="experiments/pallas_probe2.py:163",
        **table["wk=1"]["window_rows"])
    rows["roll_lanes"] = dict(
        name="window.roll_lanes", route="cuda", source=src,
        replaces="experiments/pallas_probe2.py:194",
        **table["wk=1"]["roll_lanes"])
    return rows, table


def phase_cli(tmp, k, n_bases, genome_len, seed, need):
    """`count -m k -s 4M -C` through the CLI on a seeded FASTQ; every
    record against the numpy oracle, the dump order checked, and each
    kernel in `need` launched at least once. Returns the input's reads
    joined by N."""
    from jellyfish_tpu_torch import cli

    fq, out = os.path.join(tmp, f"r{k}.fq"), os.path.join(tmp, f"o{k}.jf")
    seq = write_fastq(fq, n_bases, genome_len, seed)
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["count", "-m", str(k), "-s", "4M", "-C",
                   "--matrix-seed", "1", "-o", out, fq])
    dt = time.perf_counter() - t0
    launches = kernel_counts()
    if rc != 0:
        raise AssertionError(f"count exited {rc}")
    h, words, counts = read_db(out)
    uniq, ucnt = unique_rows(canonical_words(seq, k))
    order = np.lexsort(words.T[::-1])
    same = (np.array_equal(words[order], uniq)
            and np.array_equal(counts[order], ucnt))
    ascend = sortkeys_ascend(h, words)
    log(f"CLI count k={k} -C: {len(seq)} bases, {len(counts)} records, "
        f"{int(counts.sum())} mers in {dt:.2f} s; records == numpy oracle: "
        f"{same}; sortkey order: {ascend}; launches {launches}")
    if not (same and ascend and len(counts) > 0):
        raise AssertionError(f"count k={k} database is wrong")
    missed = [n for n in need if launches[n] == 0]
    if missed:
        raise AssertionError(f"count k={k} ran without {missed}")
    return seq


def stage_chunks(dev):
    """The full-size input: host chunks and their packed form on the
    device, in batches of BATCH."""
    from jellyfish_tpu_torch.io.parse import pack_chunk

    t0 = time.perf_counter()
    chunks = synth_chunks(CHUNKS, CHUNK_LEN)
    with ThreadPoolExecutor(8) as pool:
        packed = list(pool.map(pack_chunk, chunks))
    staged = []
    for i in range(0, CHUNKS, BATCH):
        group = packed[i:i + BATCH]
        staged.append(tuple(
            torch.from_numpy(np.stack([p[j] for p in group])
                             .astype(np.int64)).to(dev)
            for j in (0, 1)))
    log(f"full size: {CHUNKS} chunks of {CHUNK_LEN} bases staged in "
        f"{time.perf_counter() - t0:.1f} s")
    return chunks, staged


def one_pass(counter, staged, step=BATCH):
    """Feed the staged batches to counter, `step` chunks a call, then
    finalize. Returns (mers, counts, counting s, finalize s, (device
    bytes, PackedRuns made) at the end of counting); every row is
    consolidated inside the counting seconds."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for pw, vb in staged:
        for i in range(0, pw.shape[0], step):
            counter.add_chunks_packed_batch(pw[i:i + step], vb[i:i + step])
    # drain the raw backlog inside the timed region: every row is sorted,
    # counted and compacted before the clock stops
    counter.store.flush()
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t
    held = counter.store.device_bytes(), counter.store.packed
    t = time.perf_counter()
    mers, counts = counter.finalize_np()
    return mers, counts, t_count, time.perf_counter() - t, held


def lsd_chain_sort(keys):
    """Key rows [M, Wk > 1] sorted by a chain of Wk stable argsorts and
    gathers, least significant column first: the grain sort of limb keys
    that K3 and K1's merge passes replaced, for phase_full's A/B."""
    perm = torch.argsort(keys[:, 0], stable=True)
    for w in range(1, keys.shape[1]):
        perm = perm[torch.argsort(keys[perm, w], stable=True)]
    return keys[perm]


def phase_full(k, chunks, staged, need, compare_lsd=False):
    """Count the staged chunks at k through MerCounter: the counting
    region ends when every row is consolidated; then finalize, a profiled
    second pass, and the totals against the host. Each kernel in `need`
    must have launched in the first pass. With compare_lsd, three more
    passes time the grain sort's routes against each other: the LSD
    chain, the kernels, the LSD chain; each must give the first pass's
    totals. Returns (launches, results, the first pass's table (mers,
    counts))."""
    import jellyfish_tpu_torch.ops.count as ops_count
    from jellyfish_tpu_torch.counter import MerCounter

    counter = MerCounter(k, 4 << 20, canonical=True,
                         rng=np.random.default_rng(42))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mers, counts, t_count, t_final, _ = one_pass(counter, staged)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    # where the time goes: the same pass again under the profiler
    counter.reset()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t = time.perf_counter()
    with prof:
        one_pass(counter, staged)
    t_prof = time.perf_counter() - t

    routes = {"kernels": [t_count], "lsd_chain": []}
    kernel_route = ops_count.sort_rows
    for name in ("lsd_chain", "kernels", "lsd_chain") if compare_lsd else ():
        ops_count.sort_rows = (lsd_chain_sort if name == "lsd_chain"
                               else kernel_route)
        try:
            counter.reset()
            _, c, t_c, _, _ = one_pass(counter, staged)
        finally:
            ops_count.sort_rows = kernel_route
        if len(c) != len(counts) or c.sum() != counts.sum():
            raise AssertionError(f"k={k} totals differ by sort route")
        routes[name].append(t_c)
    if compare_lsd:
        log(f"k={k} counting s by grain sort route (kernels, LSD chain, "
            f"kernels, LSD chain in run order): kernels {routes['kernels']}, "
            f"lsd_chain {routes['lsd_chain']}")
    del counter
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler stretches the pass's wall time several-fold: set its
    # device time against the unprofiled pass's wall time instead
    busy = sum(r[1] for r in rows) / 1e6
    busy_share = busy / (t_count + t_final)
    log(f"k={k} profiled pass (count + finalize): {t_prof:.3f} s wall; "
        f"device kernels {busy:.3f} s = {100 * busy_share:.1f}% of the "
        f"unprofiled pass's {t_count + t_final:.3f} s; device kernels by "
        "time:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:15]:
        log(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{n:6d}x  {key[:100]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        words = list(pool.map(lambda c: canonical_words(c, k), chunks))
    t_windows = time.perf_counter() - t0
    n_valid = sum(len(x) for x in words)
    t0 = time.perf_counter()
    distinct = distinct_count(words, 2 * k - 64 * (words[0].shape[1] - 1))
    t_unique = time.perf_counter() - t0
    del words
    total = int(counts.sum(dtype=np.uint64))
    log(f"full size k={k} -C -s 4M: {n_valid} valid mers, counting "
        f"{t_count:.6f} s = {n_valid / t_count:.6g} mers/s, finalize "
        f"{t_final:.6f} s, peak {peak / 2**30:.2f} GiB; sum of counts "
        f"{total} (host {n_valid}), distinct {len(counts)} (host "
        f"{distinct}; host windows {t_windows:.1f} s, unique "
        f"{t_unique:.1f} s); launches {launches}")
    if total != n_valid or len(counts) != distinct:
        raise AssertionError(f"full-size k={k} counts disagree with the host")
    missed = [n for n in need if launches[n] == 0]
    if missed:
        raise AssertionError(f"full-size k={k} ran without {missed}")
    return launches, dict(
        k=k, mers=n_valid, counting_s=t_count, mers_per_s=n_valid / t_count,
        finalize_s=t_final, device_busy_share=busy_share,
        peak_gib=peak / 2**30, distinct=len(counts),
        **({"counting_s_by_route": routes} if compare_lsd else {})), (
            mers, counts)


def records_of(path) -> bytes:
    """The record bytes of a database (what follows its header)."""
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(path, "rb") as f:
        f.seek(FileHeader.read(f).offset)
        return f.read()


def profiled(fn):
    """fn() under torch.profiler: (its result, device seconds, the device
    rows (name, us, calls) by time)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(r[1] for r in rows) / 1e6, sorted(rows,
                                                      key=lambda r: -r[1])


def phase_merge(tmp, staged, table, need):
    """The full-size merge: 4 databases, each counted from a quarter of the
    256 staged chunks (k = 21, -C, -s 4M, the full-size run's matrix),
    merged through the CLI. The merged records must equal those of the
    in-memory count of all 256 chunks (`table`, phase_full's k = 21
    pass); each kernel in `need` must launch. A second merge, profiled,
    gives the device share and the breakdown."""
    from jellyfish_tpu_torch import cli
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.io.dumpers import dump_counter
    from jellyfish_tpu_torch.io.files import encode_binary_records_np
    from jellyfish_tpu_torch.merge import merge_files

    t0 = time.perf_counter()
    paths, n_rec = [], []
    q = len(staged) // 4
    for i in range(4):
        counter = MerCounter(21, 4 << 20, canonical=True,
                             rng=np.random.default_rng(42))
        for pw, vb in staged[i * q:(i + 1) * q]:
            counter.add_chunks_packed_batch(pw, vb)
        paths.append(os.path.join(tmp, f"quarter{i}.jf"))
        n_rec.append(dump_counter(counter, paths[-1]))
        del counter
        torch.cuda.empty_cache()
    sizes = [os.path.getsize(p) for p in paths]
    log(f"merge inputs: 4 quarters written in {time.perf_counter() - t0:.1f}"
        f" s: {n_rec} records, {sizes} bytes")

    out = os.path.join(tmp, "merged.jf")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    rc = cli.main(["merge", "-o", out, *paths])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"merge exited {rc}")
    mers, counts = table
    same = records_of(out) == encode_binary_records_np(mers, counts, 21, 4)
    n_in = sum(n_rec)
    log(f"full-size merge k=21: {n_in} input records -> {len(counts)} in "
        f"{wall:.6f} s = {n_in / wall:.6g} input records/s, peak "
        f"{peak / 2**30:.3f} GiB; records == in-memory count of all "
        f"{CHUNKS} chunks: {same}; launches {launches}")
    if not same:
        raise AssertionError("the full-size merge differs from the count")
    missed = [n for n in need if launches[n] == 0]
    if missed:
        raise AssertionError(f"the full-size merge ran without {missed}")
    os.unlink(out)

    t = time.perf_counter()
    stats, busy, rows = profiled(
        lambda: merge_files(paths, out, device="cuda"))
    t_prof = time.perf_counter() - t
    log(f"profiled merge: {t_prof:.3f} s wall, {stats}; device kernels "
        f"{busy:.3f} s = {100 * busy / wall:.1f}% of the unprofiled "
        f"{wall:.3f} s; device kernels by time:")
    for key, us, n in rows[:12]:
        log(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{n:6d}x  {key[:100]}")
    for p in paths + [out]:
        os.unlink(p)
    return launches, dict(
        k=21, inputs=n_rec, input_bytes=sizes, records_out=len(counts),
        wall_s=wall, input_records_per_s=n_in / wall,
        peak_gib=peak / 2**30, device_busy_share=busy / wall,
        rounds=stats["rounds"], rolls=stats["rolls"],
        host_read_s=stats["read_s"], host_write_s=stats["write_s"])


def split_fastq(path, parts):
    """The reads of a FASTQ dealt into `parts` files, in turn."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    recs = [b"\n".join(lines[i:i + 4]) + b"\n"
            for i in range(0, len(lines) - 3, 4)]
    out = []
    for j in range(parts):
        out.append(f"{path}.{j}")
        with open(out[-1], "wb") as f:
            f.write(b"".join(recs[j::parts]))
    return out


def read_records(path):
    """(keys [n, nw] uint64 words most significant first, counts) of a
    binary database, rows in ascending key order."""
    h, words, counts = read_db(path)
    order = np.lexsort(words.T[::-1])
    return h, words, words[order], counts[order]


def phase_merge_ops(tmp, fq, mem_db, dev, window=1 << 17, slab=1 << 19):
    """k = 63 merges at the CLI phase's size. The 12 Mbase FASTQ dealt into
    4 parts, each counted through the CLI; their merge in windows of
    `window` rows and slabs of `slab` (Wk 4 through rows 9 and 10 and K1,
    several rotations a slab) must equal the whole input's count `mem_db`.
    MIN, MAX, JACCARD and -L/-U through the CLI against a numpy oracle."""
    import contextlib
    import io

    import jellyfish_tpu_torch.merge as merge
    from jellyfish_tpu_torch import cli

    paths = []
    for j, part in enumerate(split_fastq(fq, 4)):
        paths.append(os.path.join(tmp, f"p63_{j}.jf"))
        if cli.main(["count", "-m", "63", "-s", "4M", "-C", "--matrix-seed",
                     "1", "-o", paths[-1], part]) != 0:
            raise AssertionError("count of a part failed")
    out = os.path.join(tmp, "m63.jf")
    reset_counts()
    t = time.perf_counter()
    sizes = merge.WINDOW_ROWS, merge.SLAB_ROWS
    merge.WINDOW_ROWS, merge.SLAB_ROWS = window, slab
    try:
        stats = merge.merge_files(paths, out, device=dev)
    finally:
        merge.WINDOW_ROWS, merge.SLAB_ROWS = sizes
    dt = time.perf_counter() - t
    launches = kernel_counts()
    same = records_of(out) == records_of(mem_db)
    log(f"k=63 merge of 4 parts, windows of {window} in slabs of {slab}: "
        f"{stats} in {dt:.3f} s; records == the whole input's count: "
        f"{same}; launches {launches}")
    if not same or min(stats["rolls"]) < 1:
        raise AssertionError("the k=63 merge is wrong or rotated no slab")
    missed = [n for n in ("window_rows", "roll_lanes", "merge_path",
                          "compact") if launches[n] == 0]
    if missed:
        raise AssertionError(f"the k=63 merge ran without {missed}")

    # the numpy oracle: every (key, input) pair, in key order
    keys, cnts, src = [], [], []
    for i, p in enumerate(paths):
        _, w, c = read_db(p)
        keys.append(w)
        cnts.append(c)
        src.append(np.full(len(c), i))
    keys, cnts = np.concatenate(keys), np.concatenate(cnts)
    order = np.lexsort(keys.T[::-1])
    keys, cnts = keys[order], cnts[order]
    new = np.ones(len(keys), bool)
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    seg_len = np.diff(np.append(starts, len(keys)))
    uk = keys[starts]
    total = np.add.reduceat(cnts, starts)
    least = np.where(seg_len == 4, np.minimum.reduceat(cnts, starts), 0)
    most = np.maximum.reduceat(cnts, starts)
    for flags, vals, lo, hi in (
            (["-m"], least, 1, None), (["-m", "-L", "0"], least, 0, None),
            (["-M", "-U", "3"], most, 0, 3), (["-L", "2", "-U", "4"], total,
                                              2, 4)):
        sel = (vals >= lo) & (vals <= (hi if hi is not None else vals.max()))
        if cli.main(["merge", *flags, "-o", out, *paths]) != 0:
            raise AssertionError(f"merge {flags} failed")
        h, words, sw, sc = read_records(out)
        ok = (np.array_equal(sw, uk[sel]) and np.array_equal(sc, vals[sel])
              and sortkeys_ascend(h, words))
        log(f"k=63 merge {' '.join(flags)}: {len(sc)} records == numpy "
            f"oracle, in sortkey order: {ok}")
        if not ok:
            raise AssertionError(f"merge {flags} differs from the oracle")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        if cli.main(["merge", "-j", "-o", out, *paths]) != 0:
            raise AssertionError("merge -j failed")
    want = (f"Jaccard  {int((least > 0).sum()) / len(uk)}\n"
            f"wJaccard {int(least.sum()) / int(most.sum())}\n")
    log(f"k=63 merge -j: {text.getvalue()!r} == numpy oracle: "
        f"{text.getvalue() == want}")
    if text.getvalue() != want:
        raise AssertionError("merge -j differs from the oracle")
    for p in paths + [out]:
        os.unlink(p)
    return stats


def phase_disk(tmp, fq, k, size, chunk_len, need):
    """`count --disk` through the CLI with -s small enough for at least 3
    spills: the merged records equal the same input's in-memory count, and
    the partials of a --no-merge --no-unlink run merge into it."""
    import glob

    from jellyfish_tpu_torch import cli

    common = ["count", "-m", str(k), "-s", size, "-C", "--matrix-seed", "1",
              "--chunk-len", chunk_len]
    mem, disk, part = (os.path.join(tmp, f"{n}{k}.jf")
                       for n in ("mem", "disk", "part"))
    if cli.main([*common, "-o", mem, fq]) != 0:
        raise AssertionError("in-memory count failed")
    reset_counts()
    t = time.perf_counter()
    if cli.main([*common, "--disk", "-o", disk, fq]) != 0:
        raise AssertionError("count --disk failed")
    dt = time.perf_counter() - t
    launches = kernel_counts()
    if cli.main([*common, "--disk", "--no-merge", "--no-unlink", "-o", part,
                 fq]) != 0:
        raise AssertionError("count --disk --no-merge failed")
    parts = sorted(glob.glob(part + "[0-9]*"))
    merged = os.path.join(tmp, f"merged{k}.jf")
    if cli.main(["merge", "-o", merged, *parts]) != 0:
        raise AssertionError("merge of the partials failed")
    want = records_of(mem)
    same = records_of(disk) == want
    same_parts = records_of(merged) == want and not os.path.exists(part)
    left = glob.glob(disk + "[0-9]*")
    log(f"count --disk k={k} -s {size} --chunk-len {chunk_len}: "
        f"{len(parts)} partials, {dt:.3f} s; records == in-memory count: "
        f"{same}; --no-merge --no-unlink partials merged == it: "
        f"{same_parts}; partials left by --disk: {left}; launches "
        f"{launches}")
    if not (same and same_parts and len(parts) >= 4 and not left):
        raise AssertionError(f"count --disk k={k} is wrong")
    missed = [n for n in need if launches[n] == 0]
    if missed:
        raise AssertionError(f"count --disk k={k} ran without {missed}")
    for p in parts + [mem, disk, merged]:
        os.unlink(p)
    return dict(k=k, size=size, partials=len(parts), wall_s=dt)


# -- count --packed-store, --if, --text and generators ---------------------------


def transient_bytes(fn):
    """Peak device bytes that fn() allocates above what is held before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_packed(staged, tables, grain=PACK_GRAIN):
    """count --packed-store at full size: MerCounter(pack_resting=True)
    with the grain cut to `grain` rows and two chunks a call, so that the
    main configuration's 268M windows make 128 grains and runs reach level
    2, where they rest packed, and merges unpack them. At k = 21 (one
    packed key column) the same count runs dense at the same cut too, in
    turns; at k = 63 (four limb columns) it runs packed once. Every table
    must equal tables[k] (phase_full's count at the real grain). Then
    pack_run and unpack_run of each k's resting run, timed against their
    bound and held exact. Returns (launches by pass, results)."""
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.ops.packed_run import PackedRun

    out, launches = {"packed": [], "dense": [], "packed_k63": []}, {}
    need = {21: ["merge_path", "compact"],
            63: ["merge_path", "compact", "block_sort", "merge_pass"]}
    # k = 21 in turns (dense, packed, packed, dense): one pass of each mode
    # alone was 1.4 s packed against 2.2 s dense, with the dense pass second
    for k, mode in ((21, "dense"), (21, "packed"), (21, "packed"),
                    (21, "dense"), (63, "packed")):
        name = mode if k == 21 else f"{mode}_k{k}"
        counter = MerCounter(k, 4 << 20, canonical=True,
                             rng=np.random.default_rng(42),
                             pack_resting=mode == "packed")
        counter.store.consolidate_rows = grain
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mers, counts, t_count, t_final, (held, made) = one_pass(
            counter, staged, 2)
        launches[name] = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        same = (np.array_equal(mers, tables[k][0])
                and np.array_equal(counts, tables[k][1]))
        row = dict(k=k, counting_s=t_count, finalize_s=t_final,
                   device_bytes_counted=held,
                   device_bytes_resting=counter.store.device_bytes(),
                   packed_runs_counting=made,
                   packed_runs=counter.store.packed, peak_gib=peak / 2**30,
                   records=len(counts), equal=same)
        log(f"full size k={k} --packed-store grain {grain}, {mode}: "
            f"{json.dumps(row)}; launches {launches[name]}")
        missed = [n for n in need[k] if launches[name][n] == 0]
        if not same or missed:
            raise AssertionError(f"{mode} count k={k} differs or ran "
                                 f"without {missed}")
        out[name].append(row)
        timing = "timing" if k == 21 else f"timing_k{k}"
        if mode == "packed" and timing not in out:
            rest = counter.store.levels[-1][0]
            if not (made >= 1 and isinstance(rest, PackedRun)):
                raise AssertionError(f"no run rested packed at level 2 at "
                                     f"k={k}")
            out[timing] = time_packing(rest)
        del counter, mers, counts
        torch.cuda.empty_cache()
    return launches, out


def time_packing(rest):
    """pack_run and unpack_run at the resting run's size: device ms
    (cuda_ms; pack's includes its one host sync, so also the profiler's
    sum of its kernels), peak bytes above what is held, the bound
    (bytes read + written at 3.35 TB/s), and exactness both ways."""
    from jellyfish_tpu_torch.ops.packed_run import pack_run, unpack_run

    n = rest.n
    width = rest.key_bits - rest.p + rest.cbits
    (keys, counts), unpack_peak = transient_bytes(lambda: unpack_run(rest))
    again, pack_peak = transient_bytes(
        lambda: pack_run(keys, counts, rest.key_bits))
    exact = all(torch.equal(getattr(again, f), getattr(rest, f)) for f in (
        "stream", "index", "esc_pos", "esc_lo", "esc_hi", "tail"))
    k2, c2 = unpack_run(again)
    exact = exact and torch.equal(k2, keys) and torch.equal(c2, counts)
    del again, k2, c2
    dense = keys.numel() * 8 + counts.numel() * 8
    bound_ms = 1e3 * (dense + rest.device_bytes()) / PEAK_BYTES_PER_S
    row = dict(
        n=n, p=rest.p, width_bits=width, esc_slots=rest.esc_pos.numel(),
        bits_per_entry=8 * rest.device_bytes() / n,
        packed_bytes=rest.device_bytes(), dense_bytes=dense,
        pack_ms=cuda_ms(lambda: pack_run(keys, counts, rest.key_bits),
                        reps=3),
        pack_kernels_ms=1e3 * profiled(
            lambda: pack_run(keys, counts, rest.key_bits))[1],
        unpack_ms=cuda_ms(lambda: unpack_run(rest), reps=3),
        unpack_kernels_ms=1e3 * profiled(lambda: unpack_run(rest))[1],
        bound_ms=bound_ms, pack_peak_bytes=pack_peak,
        unpack_peak_bytes=unpack_peak, exact=exact)
    log(f"pack/unpack of the resting run k={rest.key_bits // 2}: "
        f"{json.dumps(row)}")
    if not exact:
        raise AssertionError("pack_run/unpack_run do not round trip")
    return row


def phase_if(chunks, staged, table, n_chunks=IF_CHUNKS, n_random=IF_RANDOM):
    """count --if at full size: MerCounter.restrict_to the mers of the
    first n_chunks chunks and of a seeded random sequence of n_random
    bases, then the 256 staged chunks counted. The output must be the
    allowed set, each mer with its count in `table` or 0 (a numpy join),
    and the allowed mers that were counted come in `table`'s hash order.
    Returns (launches, results)."""
    from jellyfish_tpu_torch.counter import MerCounter

    rng = np.random.default_rng(7)
    rand = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_random)]
    allowed = [*chunks[:n_chunks], rand]
    counter = MerCounter(21, 4 << 20, canonical=True,
                         rng=np.random.default_rng(42))
    torch.cuda.synchronize()
    t = time.perf_counter()
    counter.restrict_to(allowed)
    torch.cuda.synchronize()
    t_restrict = time.perf_counter() - t
    reset_counts()
    mers, counts, t_count, t_final, _ = one_pass(counter, staged)
    launches = kernel_counts()
    del counter
    torch.cuda.empty_cache()

    with ThreadPoolExecutor(8) as pool:
        words = list(pool.map(lambda c: canonical_words(c, 21)[:, 0],
                              allowed))
    want = np.unique(np.concatenate(words))
    tkeys = u64_keys(table[0])
    order = np.argsort(tkeys)
    sorted_t = tkeys[order]
    i = np.minimum(np.searchsorted(sorted_t, want), len(sorted_t) - 1)
    hit = sorted_t[i] == want
    want_counts = np.where(hit, table[1][order[i]], 0)
    got = u64_keys(mers)
    o = np.argsort(got)
    same = (np.array_equal(got[o], want)
            and np.array_equal(counts[o], want_counts))
    # hash order: the counted ones keep their order in the full table (the
    # searches above ran on sorted keys: unsorted ones cost 20 s on a host)
    in_order = False
    if same:
        tpos, present = np.empty(len(got), np.int64), np.empty(len(got), bool)
        tpos[o], present[o] = order[i], hit
        in_order = bool((np.diff(tpos[present]) > 0).all())
    res = dict(allowed=len(want), counted=int(hit.sum()),
               zero=int((counts == 0).sum()), restrict_s=t_restrict,
               counting_s=t_count, finalize_s=t_final, equal=same,
               hash_order=in_order)
    log(f"full size k=21 --if ({n_chunks} chunks + {n_random} random "
        f"bases): {json.dumps(res)}; launches {launches}")
    missed = [n for n in ("merge_path", "compact") if launches[n] == 0]
    if not (same and in_order) or missed:
        raise AssertionError(f"the restricted count is wrong or ran without "
                             f"{missed}")
    return launches, res


def rows_view(words):
    """[n, nw] uint64 rows, first column most significant -> [n] values
    in the same order (big-endian bytes)."""
    be = np.ascontiguousarray(words.astype(">u8"))
    return be.view(f"V{8 * words.shape[1]}").ravel()


def text_records(path, k):
    """(keys [n, 1] uint64, counts) of a text database, k <= 32, in file
    order."""
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(path, "rb") as f:
        f.seek(FileHeader.read(f).offset)
        buf = np.frombuffer(f.read(), np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    start = np.concatenate([[0], nl[:-1] + 1])
    key = np.zeros(len(nl), np.uint64)
    for j in range(k):
        key = (key << np.uint64(2)) | _CODE[buf[start + j]].astype(np.uint64)
    digits = nl - start - k - 1
    cnt = np.zeros(len(nl), np.uint64)
    for j in range(int(digits.max())):
        on = j < digits
        d = buf[np.where(on, start + k + 1 + j, 0)].astype(np.uint64) - 48
        cnt = np.where(on, cnt * np.uint64(10) + d, cnt)
    return key[:, None], cnt


def phase_cli_modes(tmp):
    """count --packed-store (k = 21, 63), --if and --if --disk -s 512k (k =
    21, 63), --text (k = 21), -g of 4 generator commands with -G 2 (k =
    21) and --disk --packed-store (k = 21) through the CLI on the CLI
    phases' inputs (r21.fq, r63.fq), against their in-memory counts
    (o21.jf, o63.jf, held to numpy by phase_cli) and a numpy join with the
    allowed set. At these sizes no run reaches level 2, so --packed-store
    packs only the resting run, after the dump has taken the dense one:
    these runs check the flag's file paths. Packing in the spill decision
    is checked by one more pair, --disk at k = 21 with the grain cut,
    dense and packed: the packed store must write fewer partials."""
    from jellyfish_tpu_torch import cli

    out, rows = os.path.join(tmp, "mode.jf"), []
    fq = {k: os.path.join(tmp, f"r{k}.fq") for k in (21, 63)}
    mem = {k: os.path.join(tmp, f"o{k}.jf") for k in (21, 63)}
    need = {21: ["merge_path", "compact"],
            63: ["merge_path", "compact", "block_sort", "merge_pass"]}
    on_disk = ["window_rows", "merge_path", "compact"]

    def run(k, flags, inputs, check, needed, dst=out):
        reset_counts()
        t = time.perf_counter()
        rc = cli.main(["count", "-m", str(k), "-s", "4M", "-C",
                       "--matrix-seed", "1", *flags, "-o", dst, *inputs])
        dt = time.perf_counter() - t
        launches = kernel_counts()
        ok = rc == 0 and check(dst)
        missed = [n for n in needed if launches[n] == 0]
        shown = " ".join(os.path.basename(f) for f in flags)
        log(f"CLI count k={k} {shown}: {dt:.2f} s, == oracle: {ok}; "
            f"launches {launches}")
        if not ok or missed:
            raise AssertionError(f"count {flags} k={k} is wrong or ran "
                                 f"without {missed}")
        rows.append(dict(k=k, flags=shown, wall_s=dt))

    def same_as(path):
        return lambda p: records_of(p) == records_of(path)

    def same_set(path):
        """The records of path in another hash order (another -s)."""
        return lambda p: same_records_any_order(p, path)

    for k in (21, 63):
        run(k, ["--packed-store"], [fq[k]], same_as(mem[k]), need[k])

    for k in (21, 63):
        # allowed: the first 2,000 reads and 100,000 random bases
        with open(fq[k], "rb") as f:
            reads = f.read().split(b"\n")[1:8000:4]
        rand = np.frombuffer(b"ACGT", np.uint8)[
            np.random.default_rng(k).integers(0, 4, 100_000)]
        allow = os.path.join(tmp, f"allow{k}.fa")
        with open(allow, "wb") as f:
            f.write(b"".join(b">a\n%s\n" % r for r in reads)
                    + b">r\n" + rand.tobytes() + b"\n")
        seq = np.frombuffer(b"N".join([*reads, rand.tobytes()]), np.uint8)
        want = unique_rows(canonical_words(seq, k))[0]
        _, mw_, mc = read_db(mem[k])
        mv, wv = rows_view(mw_), rows_view(want)
        order = np.argsort(mv)
        i = np.minimum(np.searchsorted(mv[order], wv), len(mv) - 1)
        hit = mv[order][i] == wv
        want_c = np.where(hit, mc[order[i]], 0)

        def check(p, want=want, want_c=want_c):
            h, words, sw, sc = read_records(p)
            return (np.array_equal(sw, want) and np.array_equal(sc, want_c)
                    and sortkeys_ascend(h, words) and (sc == 0).any())

        run(k, ["--if", allow], [fq[k]], check, need[k])
        run(k, ["--if", allow, "--disk", "-s", "512k"], [fq[k]], check,
            on_disk)
        os.unlink(allow)

    def text_check(p):
        _, words, counts = read_db(mem[21])
        tw, tc = text_records(p, 21)
        return np.array_equal(tw, words) and np.array_equal(tc, counts)

    run(21, ["--text"], [fq[21]], text_check, need[21])
    cmds = os.path.join(tmp, "cmds.txt")
    parts = split_fastq(fq[21], 4)
    with open(cmds, "w") as f:
        f.write("".join(f"cat {q}\n" for q in parts))
    run(21, ["-g", cmds, "-G", "2"], [], same_as(mem[21]), need[21])
    run(21, ["--disk", "--packed-store", "-s", "1M"], [fq[21]],
        same_set(mem[21]), on_disk)

    # the spill points: with the grain cut to 2^18 rows (a batch of 8
    # chunks of 32k), each batch is a level-0 run and the 64th puts a run
    # at level 2, which the packed store holds in about a quarter of the
    # dense bytes. The dense store then grows from 3.9M to 14.7M entries
    # (device_bytes / 16) by the end of the input, the packed one from 1.0M
    # to 11.9M: at -s 6650k (a spill at 13.3M) the dense store spills once
    # and the packed one never
    partials = []

    def spills(p):
        parts = sorted(glob.glob(p + "[0-9]*"))
        partials.append(len(parts))
        if parts:
            if cli.main(["merge", "-o", p, *parts]) != 0:
                return False
            for q in parts:
                os.unlink(q)
        return same_set(mem[21])(p)

    with store_grain(DISK_GRAIN):
        for flags in ([], ["--packed-store"]):
            run(21, ["--disk", "--no-merge", "--no-unlink", "-s", "6650k",
                     "--chunk-len", "32k", *flags], [fq[21]], spills,
                need[21])
    log(f"CLI count k=21 --disk -s 6650k, grain {DISK_GRAIN}: partials "
        f"dense {partials[0]}, packed {partials[1]}")
    if not partials[1] < partials[0]:
        raise AssertionError("the packed store spilled no later than the "
                             "dense one")
    rows[-2]["partials"], rows[-1]["partials"] = partials
    for p in [out, cmds, *parts]:
        os.unlink(p)
    return rows


@contextlib.contextmanager
def store_grain(rows):
    """Every SortedCountStore built inside consolidates `rows` rows a
    grain (the CLI gives no way to cut it)."""
    from jellyfish_tpu_torch.store import SortedCountStore

    init = SortedCountStore.__init__

    def cut(self, *a, **kw):
        init(self, *a, **kw)
        self.consolidate_rows = rows

    SortedCountStore.__init__ = cut
    try:
        yield
    finally:
        SortedCountStore.__init__ = init


# -- the Bloom path ------------------------------------------------------------


def gf2_tables(matrix, c):
    """XOR tables [ceil(c/8), 256] uint64 of an r x c GF(2) matrix: the
    product of a c-bit key is the XOR of one entry per key byte (column j
    pairs with key bit c - 1 - j)."""
    cols = np.asarray(matrix.columns, dtype=np.uint64)
    v = np.arange(256, dtype=np.uint64)
    tables = np.zeros(((c + 7) // 8, 256), np.uint64)
    for b in range(c):
        hit = (v >> np.uint64(b % 8)) & np.uint64(1) == 1
        tables[b // 8, hit] ^= cols[c - 1 - b]
    return tables


def gf2_np(keys, tables):
    h = np.zeros(len(keys), np.uint64)
    for i, t in enumerate(tables):
        h ^= t[(keys >> np.uint64(8 * i)) & np.uint64(255)]
    return h


def bloom_positions_np(keys, m, nb, t1, t2):
    """[nb, n] probe positions of uint64 keys (2k <= 64), m a power of two:
    (h0 + i*h1) mod m."""
    h0, h1 = gf2_np(keys, t1), gf2_np(keys, t2)
    i = np.arange(nb, dtype=np.uint64)[:, None]
    return (h0[None] + i * h1[None]) & np.uint64(m - 1)


def bloom_adds_np(keys, counts, m, nb, t1, t2):
    """One batch of the JAX package's host insert (bloom.py:239-259): the
    touched positions and each one's add, min(sum of min(count, 2), 2)."""
    pos = bloom_positions_np(keys, m, nb, t1, t2)
    w = np.minimum(counts, 2).astype(np.uint8)
    wb = np.broadcast_to(w, pos.shape).ravel()
    order = np.argsort(pos.ravel(), kind="stable")
    spos, sw = pos.ravel()[order], wb[order]
    starts = np.ones(len(spos), dtype=bool)
    starts[1:] = spos[1:] != spos[:-1]
    idx = np.flatnonzero(starts)
    return spos[idx], np.minimum(
        np.add.reduceat(sw.astype(np.int64), idx), 2).astype(np.uint8)


def bloom_apply_np(cells, adds):
    upos, add = adds
    cells[upos] = np.minimum(cells[upos] + add, 2)


def bloom_check_np(cells, keys, m, nb, t1, t2):
    return cells[bloom_positions_np(keys, m, nb, t1, t2)].min(axis=0)


def unpack_cells_np(path):
    """(header, cells uint8 [m]) of a .bc file, unpacked base 3 in numpy."""
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(path, "rb") as f:
        h = FileHeader.read(f)
        raw = np.frombuffer(f.read(), np.uint8)
    pow3 = np.array([1, 3, 9, 27, 81], np.uint8)
    return h, ((raw[:, None] // pow3) % 3).reshape(-1)[:h.size]


def u64_keys(limbs):
    """[n, 2] uint32 limbs -> uint64 keys."""
    limbs = limbs.astype(np.uint64)
    return limbs[:, 0] | (limbs[:, 1] << np.uint64(32))


def check_in_slices(bc, mers, rows=1 << 22):
    """bc.check of host limbs [n, 2] uint32, a slice at a time (each is
    moved to the counter's device by check)."""
    out = []
    for i in range(0, len(mers), rows):
        t = torch.from_numpy(mers[i:i + rows].astype(np.int64))
        out.append(bc.check(t).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def phase_bloom(chunks, staged, table, dev):
    """The Bloom path at the main configuration's size, k = 21, -C: the 256
    chunks as ASCII on the device.

    1. bc -s 64M -f 0.001 (m = 2^30 cells, 10 hashes) of all 256 chunks
       through the port's bc code path (cli.tools.insert_chunks): after 8
       chunks the cells equal the numpy oracle's; after all, every mer of
       exact count >= 2 in the in-memory count (`table`) checks 2. The .bc
       is written and read back as `count --bc` reads it.
    2. count --bc with it (-s 4M) of the first FILTER_CHUNKS chunks: the
       records of their exact count (from `staged`, the packed path)
       whose check is 2, record for record.
    3. count --bf-size 512M --bf-fp 0.01 of the same chunks: each record's
       count is its exact count or one less, and at most 1% keep the
       exact count.
    4. The pair sort at an insert's shape: the route against its plain
       version and timed beside K1's merge passes and torch.sort + gather;
       the cross-tile exchange call and the mirrored step held and timed;
       the route at BitsArray's shape (Wk 2 + payload); one insert
       profiled. Returns (launches of the bc run, the kernel rows, the
       numbers)."""
    from jellyfish_tpu_torch.bloom import (
        BloomCounter2,
        load_count_filter,
        write_bloom_counter,
    )
    from jellyfish_tpu_torch.cli.common import suffix_int
    from jellyfish_tpu_torch.cli.tools import insert_chunks
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.kernels.bitonic import (
        block_merge,
        block_merge_plain,
        block_sort,
        block_sort_plain,
        exchange_stages,
        exchange_stages_plain,
        tile_rows,
    )
    from jellyfish_tpu_torch.kernels.sort import (
        sort_pairs_bitonic,
        sort_pairs_plain,
        sort_rows_blocked,
    )

    k, out = 21, {}
    dchunks = torch.from_numpy(chunks).to(dev)
    bc = BloomCounter2.from_fpr(0.001, suffix_int(BC_SIZE), k,
                                rng=np.random.default_rng(11),
                                canonical=True, device=dev)
    m, nb = bc.m, bc.nb_hashes
    t1, t2 = gf2_tables(bc.m1, 2 * k), gf2_tables(bc.m2, 2 * k)
    if nb != 10 or m & (m - 1) or (BC_SIZE == "64M" and m != 1 << 30):
        raise AssertionError(f"bc -s {BC_SIZE} -f 0.001: m {m}, {nb} "
                             "hashes")

    # 1. bc: 8 chunks, the oracle, then the rest
    def chunk_adds(chunk):
        keys, counts = np.unique(canonical_words(chunk, k)[:, 0],
                                 return_counts=True)
        return bloom_adds_np(keys, counts, m, nb, t1, t2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    insert_chunks(bc, dchunks[:8])
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t
    with ThreadPoolExecutor(8) as pool:
        adds = list(pool.map(chunk_adds, chunks[:8]))
    want = np.zeros(m, np.uint8)
    for a in adds:
        bloom_apply_np(want, a)
    same = np.array_equal(bc.cells.cpu().numpy(), want)
    del want, adds
    log(f"bc k={k} -s {BC_SIZE} -f 0.001 (m {m}, {nb} hashes), 8 chunks: "
        f"{t_first:.3f} s; cells == numpy oracle: {same}")
    if not same:
        raise AssertionError("the Bloom counter's cells differ from numpy")
    t = time.perf_counter()
    insert_chunks(bc, dchunks[8:])
    torch.cuda.synchronize()
    t_bc = t_first + time.perf_counter() - t
    launches = kernel_counts()
    peak_bc = torch.cuda.max_memory_allocated()
    mers, counts = table
    check = check_in_slices(bc, mers)
    missed = int((check[counts >= 2] != 2).sum())
    fp_share = float((check[counts == 1] == 2).mean())
    log(f"bc of {len(chunks)} chunks: {t_bc:.6f} s, peak "
        f"{peak_bc / 2**30:.3f} GiB; mers of exact count >= 2 that check "
        f"< 2: {missed}; count-1 mers that check 2: {100 * fp_share:.4f}%; "
        f"launches {launches}")
    if missed:
        raise AssertionError("the Bloom counter has false negatives")
    for name in ("block_sort", "block_merge", "exchange_stages",
                 "exchange_stages.passes", "exchange_stages.mirror"):
        if not launches[name]:
            raise AssertionError(f"bc ran without {name}")
    # the exact count of the chunks that steps 2 and 3 filter
    exact = MerCounter(k, 4 << 20, canonical=True,
                       rng=np.random.default_rng(42), device=dev)
    for pw, vb in staged[:FILTER_CHUNKS // BATCH]:
        exact.add_chunks_packed_batch(pw, vb)
    mers, counts = exact.finalize_np()
    del exact
    check = check_in_slices(bc, mers)
    fchunks = dchunks[:FILTER_CHUNKS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "full.bc")
        t = time.perf_counter()
        write_bloom_counter(bc, path)
        t_write = time.perf_counter() - t

        # 2. count --bc
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        counter = MerCounter(k, 4 << 20, canonical=True,
                             rng=np.random.default_rng(42), device=dev,
                             mer_filter=load_count_filter(
                                 bc_path=path, k=k, canonical=True,
                                 device=dev))
        for chunk in fchunks:
            counter.add_chunk(chunk)
        got_m, got_c = counter.finalize_np()
        t_count_bc = time.perf_counter() - t
    peak_count_bc = torch.cuda.max_memory_allocated()
    del counter
    keep = check == 2
    same = (np.array_equal(got_m, mers[keep])
            and np.array_equal(got_c, counts[keep]))
    log(f"count --bc of {FILTER_CHUNKS} chunks: {t_count_bc:.6f} s (read "
        f"and unpack the .bc "
        f"included; the write took {t_write:.3f} s), peak "
        f"{peak_count_bc / 2**30:.3f} GiB; {len(got_c)} records == the "
        f"exact count's records that check 2: {same}")
    if not same:
        raise AssertionError("count --bc differs from the filtered count")

    # 3. count --bf-size 512M --bf-fp 0.01
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    counter = MerCounter(k, 4 << 20, canonical=True,
                         rng=np.random.default_rng(42), device=dev,
                         mer_filter=load_count_filter(
                             bf_size=suffix_int(BF_SIZE), bf_fp=0.01, k=k,
                             canonical=True, rng=np.random.default_rng(12),
                             device=dev))
    for chunk in fchunks:
        counter.add_chunk(chunk)
    bf_m, bf_c = counter.finalize_np()
    t_bf = time.perf_counter() - t
    peak_bf = torch.cuda.max_memory_allocated()
    del counter
    keys = u64_keys(mers)
    order = np.argsort(keys)
    at = order[np.minimum(np.searchsorted(keys, u64_keys(bf_m),
                                          sorter=order), len(keys) - 1)]
    exact = counts[at]
    found = np.array_equal(keys[at], u64_keys(bf_m))
    whole = float((bf_c == exact).mean()) if len(bf_c) else 0.0
    ok = found and bool(((bf_c == exact) | (bf_c + 1 == exact)).all())
    log(f"count --bf-size {BF_SIZE} --bf-fp 0.01 of {FILTER_CHUNKS} "
        f"chunks: {t_bf:.6f} s, peak "
        f"{peak_bf / 2**30:.3f} GiB; {len(bf_c)} records, each its exact "
        f"count or one less: {ok}; exact-count share {100 * whole:.4f}% "
        f"(count-1 mers kept by a false positive: "
        f"{int((exact == 1).sum())})")
    if not ok or whole > 0.01:
        raise AssertionError("count --bf-size is wrong")

    # 4. the pair sort at one insert's shape: chunk 0's probe pairs
    _, cm, cc = MerCounter(k, 1 << 16, canonical=True,
                           device=dev).chunk_counts(dchunks[0])
    live = cc > 0
    cm, w = cm[live], cc[live].clamp(max=2)
    pos = bc.probe_positions(cm).reshape(-1, 1)
    wb = w.expand(nb, w.shape[0]).reshape(-1).contiguous()
    n = pos.shape[0]
    size = 1 << (n - 1).bit_length()
    label = f"{n} probe pairs (padded to {size}), Wk 1 + payload"

    def library():
        s, perm = torch.sort(pos[:, 0])
        return s, wb[perm]

    route = hold(f"sort_pairs_bitonic {label}",
                 lambda: sort_pairs_bitonic(pos, wb),
                 lambda: sort_pairs_plain(pos, wb), 2 * n * 16,
                 library=library)
    if not torch.equal(sort_pairs_bitonic(pos, wb)[0], library()[0][:, None]):
        raise AssertionError("sort_pairs_bitonic: keys out of order")
    routes = {"sort_pairs_bitonic": route["ms"],
              "sort_rows_blocked": cuda_ms(lambda: sort_rows_blocked(pos, wb)),
              "torch_sort_gather": route["library_ms"]}
    routes["sort_rows_blocked_again"] = cuda_ms(
        lambda: sort_rows_blocked(pos, wb))
    routes["sort_pairs_bitonic_again"] = cuda_ms(
        lambda: sort_pairs_bitonic(pos, wb))
    log(f"sort routes at the insert's shape ({label}), ms: {routes}")
    padded = torch.cat([pos, pos.new_full((size - n, 1), (1 << 63) - 1)])
    pw = torch.cat([wb, wb.new_zeros(size - n)])
    tile = tile_rows(1, True)
    srow = hold(f"K3 block_sort {size} rows, Wk 1 + payload, tile {tile} "
                "(one of the route's tile sorts)",
                lambda: block_sort(padded, pw, tile),
                lambda: block_sort_plain(padded, pw, tile), 2 * size * 16,
                library=lambda: torch.sort(padded.view(-1, tile), dim=1))
    dist = [size // 2]  # the last phase: the mirrored step, then to a tile
    while dist[-1] > tile:
        dist.append(dist[-1] // 2)
    xrow = hold(f"K3 exchange_stages {size} rows, Wk 1 + payload, mirrored "
                f"step at {dist[0]} + {len(dist) - 1} steps (the last phase)",
                lambda: exchange_stages(padded, pw, dist, mirror=True),
                lambda: exchange_stages_plain(padded, pw, dist, mirror=True),
                2 * size * 16)
    xrow["passes"] = passes_of(
        lambda: exchange_stages(padded, pw, dist, mirror=True),
        "the insert's last phase", 3)
    xrow["steps_ms"] = cuda_ms(lambda: one_pass_each(padded, pw, dist, True))
    log(f"  the last phase in {xrow['passes']} passes; its steps one pass "
        f"each: {xrow['steps_ms']:.4f} ms")
    five = dist[-5:]  # the phase at run 2^16: the mirrored step + 4 steps
    label = (f"K3 exchange_stages {size} rows, Wk 1 + payload, mirrored "
             f"step at {five[0]} + 4 steps (a 5-step phase)")
    hold(label, lambda: exchange_stages(padded, pw, five, mirror=True),
         lambda: exchange_stages_plain(padded, pw, five, mirror=True))
    passes_of(lambda: exchange_stages(padded, pw, five, mirror=True), label,
              2)
    bk, bw = bitonic_tiles(padded, pw, tile)
    merge_row = hold(
        f"K3 block_merge {size} rows, Wk 1 + payload, bitonic tiles of "
        f"{tile} (one of the route's in-tile merges)",
        lambda: block_merge(bk, bw, tile),
        lambda: block_merge_plain(bk, bw, tile), 2 * size * 16,
        library=lambda: torch.sort(bk.view(-1, tile), dim=1))
    del bk, bw
    mrow = hold(f"K3 exchange_stages {size} rows, Wk 1 + payload, one "
                f"mirrored step at {dist[0]}",
                lambda: exchange_stages(padded, pw, dist[:1], mirror=True),
                lambda: exchange_stages_plain(padded, pw, dist[:1],
                                              mirror=True),
                2 * size * 16)
    g = torch.Generator(device=dev).manual_seed(21)
    nb_rows = 1 << 22
    ids = torch.randint(0, 1 << 32, (nb_rows,), device=dev, generator=g)
    ids[: nb_rows // 2] %= 1 << 16  # repeated ids
    bkeys = torch.stack([torch.arange(nb_rows, device=dev), ids], 1)
    bvals = torch.randint(0, 1 << 32, (nb_rows,), device=dev, generator=g)
    brow = hold(f"sort_pairs_bitonic {nb_rows} (seq, id) rows, Wk 2 + "
                "payload (BitsArray's sort)",
                lambda: sort_pairs_bitonic(bkeys, bvals),
                lambda: sort_pairs_plain(bkeys, bvals), 2 * nb_rows * 24)
    del bkeys, bvals, ids, padded, pw
    _, busy, prof_rows = profiled(lambda: bc.insert_counts(cm, w))
    log(f"one profiled insert ({w.shape[0]} mers, {n} pairs): device "
        f"kernels {busy * 1e3:.3f} ms; device kernels by time:")
    for key, us, calls in prof_rows[:12]:
        log(f"  {us / 1e3:10.3f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{calls:6d}x  {key[:100]}")
    row8 = [(us, calls) for key, us, calls in prof_rows
            if "exchange_kernel" in key or "group_kernel" in key]
    row8_ms, row8_launches = (sum(us for us, _ in row8) / 1e3,
                              sum(calls for _, calls in row8))
    log(f"  row 8 (exchange_kernel and group_kernel): {row8_ms:.3f} ms in "
        f"{row8_launches} launches")
    torch.cuda.empty_cache()
    out = dict(k=k, bc_m=m, bc_hashes=nb, bc_s=t_bc,
               bc_peak_gib=peak_bc / 2**30, bc_write_s=t_write,
               filter_chunks=FILTER_CHUNKS, count_bc_s=t_count_bc,
               count_bc_peak_gib=peak_count_bc / 2**30,
               count_bc_records=len(got_c), bf_s=t_bf,
               bf_peak_gib=peak_bf / 2**30, bf_records=len(bf_c),
               bf_exact_share=whole, fp_share_bc=fp_share,
               insert_pairs=n, sort_routes_ms=routes,
               insert_device_ms=busy * 1e3, insert_row8_ms=row8_ms,
               insert_row8_launches=row8_launches, pair_sort=route,
               block_sort=srow, block_merge=merge_row,
               bitsarray_pair_sort=brow)
    k3_src = "jellyfish_tpu_torch/csrc/bitonic.cu"
    rows = {
        "block_sort_bloom": dict(
            name="bitonic.block_sort(bloom)", route="cuda", source=k3_src,
            replaces="experiments/pallas_sort_proto.py:65", **srow),
        "block_merge": dict(
            name="bitonic.block_merge", route="cuda", source=k3_src,
            replaces="experiments/pallas_probe2.py:103", **merge_row),
        "exchange_stages": dict(
            name="bitonic.exchange_stages", route="cuda", source=k3_src,
            replaces="experiments/pallas_probe2.py:103", **xrow),
        "exchange_stages_mirror": dict(
            name="bitonic.exchange_stages(mirror)", route="cuda",
            source=k3_src, replaces="experiments/pallas_stage_probe.py:112",
            **mrow),
    }
    return launches, rows, out


def phase_bloom_cli(tmp, fq, seq, mem_db):
    """bc -> count --bc -> query (bloom and binary) through the CLI at the
    CLI phase's k = 21 size, against numpy: the cells from the .bc's
    matrices and the input's exact counts, count --bc as the in-memory
    count's records that check 2, each query line. And count --chunk-len
    1000 (the ASCII path, no filter) of the first 0.5 Mbases writes the
    packed path's records."""
    from jellyfish_tpu_torch import cli

    k = 21
    bcp, out = os.path.join(tmp, "r21.bc"), os.path.join(tmp, "bc21.jf")
    t = time.perf_counter()
    if cli.main(["bc", "-m", str(k), "-s", "4M", "-C", "-o", bcp, fq]) != 0:
        raise AssertionError("bc failed")
    t_bc = time.perf_counter() - t
    h, cells = unpack_cells_np(bcp)
    m, nb = h.size, h.nb_hashes
    t1, t2 = gf2_tables(h.matrix(1), 2 * k), gf2_tables(h.matrix(2), 2 * k)
    keys, counts = np.unique(canonical_words(seq, k)[:, 0],
                             return_counts=True)
    want = np.zeros(m, np.uint8)
    bloom_apply_np(want, bloom_adds_np(keys, counts, m, nb, t1, t2))
    same_bc = np.array_equal(cells, want)
    t = time.perf_counter()
    if cli.main(["count", "-m", str(k), "-s", "4M", "-C", "--matrix-seed",
                 "1", "--bc", bcp, "-o", out, fq]) != 0:
        raise AssertionError("count --bc failed")
    t_count = time.perf_counter() - t
    _, mw_, mc = read_db(mem_db)
    _, bw, bcnt = read_db(out)
    keep = bloom_check_np(cells, mw_[:, 0], m, nb, t1, t2) == 2
    same_count = np.array_equal(bw, mw_[keep]) and np.array_equal(bcnt,
                                                                  mc[keep])

    # query: the mers of 300 reads, and 3 on the command line
    reads = seq[:300 * 151].reshape(300, 151)[:, :150]
    qfa = os.path.join(tmp, "q.fa")
    with open(qfa, "wb") as f:
        f.write(b"".join(b">q%d\n%s\n" % (i, r.tobytes())
                         for i, r in enumerate(reads)))
    given = [reads[0, :k].tobytes().decode(), reads[1, 5:5 + k].tobytes()
             .decode(), "ACGT" * 5 + "A"]
    order = np.argsort(mw_[:, 0])
    sorted_keys = mw_[order, 0]
    ok_query = {}
    for fmt, db in (("bloom", bcp), ("binary", mem_db)):
        qout = os.path.join(tmp, f"q_{fmt}.txt")
        if cli.main(["query", "-s", qfa, "-o", qout, db, *given]) != 0:
            raise AssertionError(f"query of the {fmt} file failed")
        with open(qout) as f:
            lines = f.read().splitlines()
        strs = [line.split()[0] for line in lines]
        vals = np.array([int(line.split()[1]) for line in lines], np.uint64)
        canon = canonical_words(np.frombuffer(
            "N".join(strs).encode(), np.uint8), k)[:, 0]
        if fmt == "bloom":
            want_v = bloom_check_np(cells, canon, m, nb, t1, t2)
        else:
            i = np.minimum(np.searchsorted(sorted_keys, canon),
                           len(sorted_keys) - 1)
            hit = sorted_keys[i] == canon
            want_v = np.where(hit, mc[order[i]], 0)
        n_want = sum(len(canonical_words(r, k)) for r in reads) + 3
        ok_query[fmt] = (len(lines) == n_want
                         and np.array_equal(vals, want_v.astype(np.uint64)))
    # the ASCII path on the first 0.5 Mbases (a chunk of 1000 bases is
    # about a hundred small launches), against the packed path on them
    sub, ascii_db, packed_db = (os.path.join(tmp, n) for n in (
        "sub21.fq", "ascii21.jf", "packed21.jf"))
    with open(fq, "rb") as f:
        lines = f.read().split(b"\n")
    head = lines[:4 * min(3_333, len(lines) // 4)]
    with open(sub, "wb") as f:
        f.write(b"\n".join(head) + b"\n")
    common = ["count", "-m", str(k), "-s", "4M", "-C", "--matrix-seed", "1"]
    t = time.perf_counter()
    if cli.main([*common, "--chunk-len", "1000", "-o", ascii_db, sub]) != 0:
        raise AssertionError("count --chunk-len 1000 failed")
    t_ascii = time.perf_counter() - t
    if cli.main([*common, "-o", packed_db, sub]) != 0:
        raise AssertionError("count of the first 0.5 Mbases failed")
    same_ascii = records_of(ascii_db) == records_of(packed_db)
    log(f"CLI bloom k={k}: bc -s 4M (m {m}, {nb} hashes) {t_bc:.2f} s, "
        f"cells == numpy: {same_bc}; count --bc {t_count:.2f} s, "
        f"{len(bcnt)} of {len(mc)} records == numpy: {same_count}; query "
        f"== numpy: {ok_query}; count --chunk-len 1000 of 0.5 Mbases "
        f"{t_ascii:.2f} s, records == the packed path's: {same_ascii}")
    if not (same_bc and same_count and all(ok_query.values())
            and same_ascii):
        raise AssertionError("the CLI Bloom path is wrong")
    for p in (bcp, out, ascii_db, packed_db, sub, qfa):
        os.unlink(p)
    return dict(bc_s=t_bc, count_bc_s=t_count, ascii_count_s=t_ascii,
                records=len(bcnt))

# -- count -d: the sharded counter -----------------------------------------------


def sharded_pass(counter, staged, n_chunks=CHUNKS):
    """Feed the first n_chunks staged chunks to a ShardedMerCounter, one a
    shard a step, then finalize: (mers, counts, counting s, finalize s,
    device bytes at the end of counting). The shards' stores take counted
    runs only, so no backlog is left when the last step returns."""
    P = counter.n_shards
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = 0
    for pw, vb in staged:
        for i in range(0, pw.shape[0], P):
            if done < n_chunks:
                counter.add_chunks_packed(pw[i:i + P], vb[i:i + P])
                done += P
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t
    held = counter.store.device_bytes()
    t = time.perf_counter()
    mers, counts = counter.finalize_np()
    return mers, counts, t_count, time.perf_counter() - t, held


@contextlib.contextmanager
def annotated(targets):
    """Every call of each (owner, attribute, label) in `targets` runs
    inside torch.profiler.record_function(label); restored on exit."""
    saved = []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def device_ms_by_range(prof, inner, outer):
    """Device ms of the profiled kernels, copies and memsets, by the
    record_function range their launch fell in on the host: a range
    labelled in `inner`, else one in `outer` (its own work: outer[label]),
    else "other". Launch and kernel meet by their correlation id in the
    exported trace."""
    import bisect

    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g)["traceEvents"]
    spans = {"inner": [], "outer": []}
    launch = {}
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e.get("ph") == "X":
            for kind, labels in (("inner", inner), ("outer", outer)):
                if e["name"] in labels:
                    spans[kind].append((e["ts"], e["ts"] + e["dur"],
                                        labels[e["name"]]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = e["ts"]
    for kind in spans:
        spans[kind].sort()
    starts = {kind: [s[0] for s in v] for kind, v in spans.items()}

    def label_of(t):
        for kind in ("inner", "outer"):
            i = bisect.bisect_right(starts[kind], t) - 1
            if i >= 0 and t <= spans[kind][i][1]:
                return spans[kind][i][2]
        return "other"

    ms = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            t = launch.get((e.get("args") or {}).get("correlation"))
            name = "other" if t is None else label_of(t)
            ms[name] = ms.get(name, 0.0) + e["dur"] / 1e3
    return ms


def exchange_shares(counter, staged, n_chunks=SHARD_PROFILE_CHUNKS,
                    collectives=False):
    """A sharded pass over the first n_chunks chunks, unprofiled for its
    wall time, then profiled: device ms of the chunk pipeline
    (extraction, hashing), the local deduplication (sort, segment counts,
    PAD correction, the sender's K2), the exchange proper (owners, their
    counts, the host read, the cuts and moves), the stores (insert_run:
    K2 and the level merges) and finalize, each as a share of all device
    time. With `collectives` (a counter with a process group) the
    exchange's all_gather and all_to_all_single have ranges of their
    own. "exchange_share" is the deduplication, the exchange and its
    collectives; "device_busy_share" all device time over the unprofiled
    pass's wall."""
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.parallel import sharded
    from jellyfish_tpu_torch.store import SortedCountStore

    counter.reset()
    _, _, t_count, t_final, _ = sharded_pass(counter, staged, n_chunks)
    counter.reset()
    inner = {"pipeline": "pipeline", "dedup": "dedup", "send_k2": "dedup",
             "store": "store"}
    outer = {"step": "exchange", "finalize": "finalize"}
    targets = [
        (MerCounter, "packed_sortkeys", "pipeline"),
        (sharded, "_dedup", "dedup"), (sharded, "compact", "send_k2"),
        (SortedCountStore, "insert_run", "store"),
        (sharded.ShardedMerCounter, "add_chunks_packed", "step"),
        (sharded.ShardedMerCounter, "finalize_np", "finalize")]
    if collectives:
        inner.update(all_gather="all_gather", all_to_all="all_to_all")
        targets += [(sharded.dist, "all_gather", "all_gather"),
                    (sharded.dist, "all_to_all_single", "all_to_all")]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with annotated(targets):
        with prof:
            sharded_pass(counter, staged, n_chunks)
    ms = device_ms_by_range(prof, inner, outer)
    total = sum(ms.values())
    if total == 0:
        log("  the profiler saw no device work: shares not measured")
        return {"profiled_chunks": n_chunks, "device_ms": None}
    exchange = sum(ms.get(n, 0) for n in ("dedup", "exchange", "all_gather",
                                          "all_to_all"))
    return {
        "profiled_chunks": n_chunks, "wall_s": t_count + t_final,
        "device_ms": {n: round(v, 3) for n, v in sorted(ms.items())},
        "shares": {n: round(v / total, 4) for n, v in sorted(ms.items())},
        "exchange_share": round(exchange / total, 4),
        "device_busy_share": round(total / 1e3 / (t_count + t_final), 4)}


def phase_sharded(staged, tables, dev, runs=SHARD_RUNS):
    """count -d at full size through ShardedMerCounter on the one card:
    for each (k, P) of `runs`, P shards that share it (mesh=[cuda] * P),
    fed the 256 staged chunks one a shard a step. Each table must equal
    tables[k] (phase_full's MerCounter count: -s 4M gives both the same
    22 x 2k matrix). Counting s, finalize s, peak GiB, then the device
    time of each layer in a profiled pass over the first chunks
    (exchange_shares). Returns (launches by run, results)."""
    from jellyfish_tpu_torch.parallel import ShardedMerCounter

    out, launches = {}, {}
    for k, P in runs:
        name = f"k{k}_P{P}"
        counter = ShardedMerCounter(k, 4 << 20, mesh=[dev] * P,
                                    canonical=True,
                                    rng=np.random.default_rng(42))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mers, counts, t_count, t_final, held = sharded_pass(counter, staged)
        launches[name] = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        same = (np.array_equal(mers, tables[k][0])
                and np.array_equal(counts, tables[k][1]))
        per_shard = [len(c) for _, _, c in counter.finalize_local_np()]
        n_valid = int(counts.sum(dtype=np.uint64))
        del mers, counts
        t = time.perf_counter()
        shares = exchange_shares(counter, staged)
        t_prof = time.perf_counter() - t
        row = dict(k=k, shards=P, counting_s=t_count,
                   mers_per_s=n_valid / t_count,
                   finalize_s=t_final,
                   peak_gib=peak / 2**30, device_bytes_counted=held,
                   records_by_shard=per_shard, equal=same,
                   profile_s=t_prof, **shares)
        log(f"full size k={k} -d {P} on one card: "
            f"{json.dumps(row)}; launches {launches[name]}")
        need = ["merge_path", "compact"] + (
            ["block_sort", "merge_pass"] if k > 32 else [])
        missed = [n for n in need if launches[name][n] == 0]
        if not same or missed:
            raise AssertionError(f"-d {P} count k={k} differs from the "
                                 f"single-device table or ran without "
                                 f"{missed}")
        out[name] = row
        del counter
        torch.cuda.empty_cache()
    return launches, out


def phase_sharded_modes(tmp, dev):
    """count -d's modes at the CLI k = 21 size (r21.fq), through
    cli/count._run_counting with a 2-shard counter on the one card, each
    against the same run with the single-device MerCounter: --if (the
    first 2,000 reads and 100,000 random bases), --bc (a bc of the
    input), --bf-size 16M (both filters from one seed), --packed-store,
    and --disk -s 1M (3 or more partials, merged). Then the CLI's -d:
    count -d 1 and -d auto write the plain CLI count's records (o21.jf),
    and -d N above the visible devices dies with the JAX package's
    message. Leaves its bc (d21.bc) and allowed set (d21.fa) for
    phase_multihost_cli. Returns (launches of the 2-shard runs,
    results)."""
    from jellyfish_tpu_torch import cli
    from jellyfish_tpu_torch.bloom import load_count_filter
    from jellyfish_tpu_torch.cli import count as cli_count
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.io.parse import SequenceChunker
    from jellyfish_tpu_torch.parallel import ShardedMerCounter

    k, fq = 21, os.path.join(tmp, "r21.fq")
    out = os.path.join(tmp, "shard.jf")
    bcp, allow = os.path.join(tmp, "d21.bc"), os.path.join(tmp, "d21.fa")
    if cli.main(["bc", "-m", "21", "-s", "4M", "-C", "-o", bcp, fq]) != 0:
        raise AssertionError("bc failed")
    with open(fq, "rb") as f:
        reads = f.read().split(b"\n")[1:8000:4]
    rand = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(5).integers(0, 4, 100_000)]
    with open(allow, "wb") as f:
        f.write(b"".join(b">a\n%s\n" % r for r in reads)
                + b">r\n" + rand.tobytes() + b"\n")
    base = ["count", "-m", "21", "-s", "4M", "-C", "--matrix-seed", "1"]
    modes = {"if": ["--if", allow], "bc": ["--bc", bcp],
             "bf_size": ["--bf-size", "16M"],
             "packed_store": ["--packed-store"],
             "disk": ["--disk", "-s", "1M", "--no-unlink"]}
    res, launches = {}, {}
    for mode, flags in modes.items():
        argv = [*base, *flags, "-o", out, fq]
        args = cli.build_parser().parse_args(argv)
        got = {}
        for shards in (1, 2):
            filt = None
            if args.bc or args.bf_size is not None:
                filt = load_count_filter(
                    bc_path=args.bc, bf_size=args.bf_size,
                    bf_fp=args.bf_fp, k=k, canonical=True,
                    rng=np.random.default_rng(5))
            rng = np.random.default_rng(args.matrix_seed)
            if shards == 1:
                counter = MerCounter(k, args.size, canonical=True, rng=rng,
                                     mer_filter=filt,
                                     pack_resting=args.packed_store)
            else:
                counter = ShardedMerCounter(
                    k, args.size, mesh=[dev] * shards, canonical=True,
                    rng=rng, mer_filter=filt,
                    pack_resting=args.packed_store)
            reset_counts()
            t = time.perf_counter()
            with SequenceChunker([fq], k, chunk_len=args.chunk_len) as ch:
                cli_count._run_counting(args, argv, k, counter, ch, t)
            dt = time.perf_counter() - t
            parts = sorted(glob.glob(out + "[0-9]*"))
            for q in parts:
                os.unlink(q)
            got[shards] = (records_of(out), dt, len(parts))
            launches[mode] = kernel_counts()
            del counter
        same = got[1][0] == got[2][0]
        row = dict(wall_s_single=got[1][1], wall_s_2=got[2][1],
                   partials_2=got[2][2], records_bytes=len(got[2][0]),
                   equal=same)
        log(f"-d 2 count {' '.join(os.path.basename(f) for f in flags)} "
            f"at the CLI k=21 size: {json.dumps(row)}; launches "
            f"{launches[mode]}")
        missed = [n for n in ("merge_path", "compact")
                  if launches[mode][n] == 0]
        if not same or missed or (mode == "disk" and got[2][2] < 3):
            raise AssertionError(f"-d 2 {mode} differs from one device, "
                                 f"ran without {missed} or spilled "
                                 f"{got[2][2]} partials")
        res[mode] = row

    want = records_of(os.path.join(tmp, "o21.jf"))
    for d in ("1", "auto"):
        if cli.main([*base, "-d", d, "-o", out, fq]) != 0:
            raise AssertionError(f"count -d {d} failed")
        res[f"cli_d_{d}"] = records_of(out) == want
    n = torch.cuda.device_count() + 1
    err, code = io.StringIO(), 0
    with contextlib.redirect_stderr(err):
        try:
            code = cli.main([*base, "-d", str(n), "-o", out, fq])
        except SystemExit as e:
            code = e.code
    msg = f"count: --devices {n} exceeds the {n - 1} visible devices"
    res[f"cli_d_{n}_dies"] = code not in (0, None) and msg in err.getvalue()
    log(f"CLI count -d 1, -d auto == the plain count, -d {n} dies: "
        f"{res['cli_d_1']}, {res['cli_d_auto']}, {res[f'cli_d_{n}_dies']}")
    if not (res["cli_d_1"] and res["cli_d_auto"]
            and res[f"cli_d_{n}_dies"]):
        raise AssertionError("the CLI's -d is wrong")
    os.unlink(out)  # phase_multihost_cli takes d21.bc and d21.fa
    return launches, res



# -- count --coordinator and count --sam -----------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def coordinator_child(argv, timeout=300):
    """`python -m jellyfish_tpu_torch count --coordinator 127.0.0.1:<free
    port> --num-processes 1 --process-id 0 <argv>` in a child process on
    the card: (exit code, its standard error, wall s). The child is killed
    if it outlives `timeout`."""
    cmd = [sys.executable, "-m", "jellyfish_tpu_torch", "count",
           "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
           "1", "--process-id", "0", *argv]
    t = time.perf_counter()
    # -m finds the package in the working directory, this script's
    p = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        _, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return p.returncode, err, time.perf_counter() - t


def same_records_any_order(path, want_path):
    """The binary databases hold the same (mer, count) records, each in
    its own hash order (another -s), and `path` in ascending sortkey
    order."""
    _, _, want, want_c = read_records(want_path)
    h, words, got, got_c = read_records(path)
    return (np.array_equal(got, want) and np.array_equal(got_c, want_c)
            and sortkeys_ascend(h, words))


def phase_multihost_cli(tmp):
    """count --coordinator through the CLI, one process on the card, each
    run a child process that must report the nccl backend: at k = 21
    (r21.fq) and k = 63 (r63.fq) against the plain CLI count (o21.jf,
    o63.jf); --disk -s 1M --no-unlink at k = 21 (3 or more spills, merged)
    against the in-memory records; --if (d21.fa) and --bc (d21.bc, from
    phase_sharded_modes) at k = 21 against the same runs on one device in
    this process. Three children run at once, beside the one-device runs.
    Returns results."""
    from jellyfish_tpu_torch import cli

    base = ["-m", "21", "-s", "4M", "-C", "--matrix-seed", "1"]
    fq = {k: os.path.join(tmp, f"r{k}.fq") for k in (21, 63)}
    mem = {k: os.path.join(tmp, f"o{k}.jf") for k in (21, 63)}
    bcp, allow = os.path.join(tmp, "d21.bc"), os.path.join(tmp, "d21.fa")
    out = {m: os.path.join(tmp, f"mh_{m}.jf")
           for m in ("k21", "k63", "disk", "if", "bc")}
    ref = {m: os.path.join(tmp, f"one_{m}.jf") for m in ("if", "bc")}
    argv = {
        "k21": [*base, "-o", out["k21"], fq[21]],
        "k63": ["-m", "63", *base[2:], "-o", out["k63"], fq[63]],
        "disk": ["-m", "21", "-s", "1M", "-C", "--matrix-seed", "1",
                 "--disk", "--no-unlink", "-o", out["disk"], fq[21]],
        "if": [*base, "--if", allow, "-o", out["if"], fq[21]],
        "bc": [*base, "--bc", bcp, "-o", out["bc"], fq[21]],
    }
    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futures = {m: pool.submit(coordinator_child, a)
                   for m, a in argv.items()}
        for m, flags in (("if", ["--if", allow]), ("bc", ["--bc", bcp])):
            if cli.main(["count", *base, *flags, "-o", ref[m], fq[21]]) != 0:
                raise AssertionError(f"one-device count {flags} failed")
        runs = {m: f.result() for m, f in futures.items()}
    wall = time.perf_counter() - t
    res = {}
    for m, (rc, err, dt) in runs.items():
        backend = re.findall(r"(\w+) backend", err)
        if rc != 0 or backend != ["nccl"]:
            raise AssertionError(f"count --coordinator {m} exited {rc} "
                                 f"with backend {backend}: {err[-2000:]}")
        res[m] = dict(wall_s=dt, backend=backend[0])
    spills = sorted(glob.glob(out["disk"] + ".mh.spill*.rank0.jf"))
    checks = {
        "k21": records_of(out["k21"]) == records_of(mem[21]),
        "k63": records_of(out["k63"]) == records_of(mem[63]),
        "disk": (same_records_any_order(out["disk"], mem[21])
                 and len(spills) >= 3),
        "if": records_of(out["if"]) == records_of(ref["if"]),
        "bc": records_of(out["bc"]) == records_of(ref["bc"]),
    }
    for m, ok in checks.items():
        res[m]["equal"] = ok
    res["disk"]["spills"] = len(spills)
    log(f"count --coordinator, 1 process on the card ({wall:.1f} s, three "
        f"children at once): {json.dumps(res)}")
    if not all(checks.values()):
        raise AssertionError(f"count --coordinator differs: {checks}")
    for p in [*out.values(), *ref.values(), *spills, bcp, allow,
              out["disk"] + ".mh.rank0.jf"]:
        os.unlink(p)
    return dict(wall_s=wall, runs=res)


# BAM 4-bit codes of "=ACMGRSVTWYHKDBN" by ASCII byte
_BAM_CODE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BAM_CODE[_b] = _i


def fastq_reads(fq, read_len=150):
    """(reads, qualities as phred+33) of a FASTQ of read_len-base reads
    (write_fastq's), each [n, read_len] uint8."""
    with open(fq, "rb") as f:
        lines = f.read().split(b"\n")
    n = len(lines) // 4
    seq = np.frombuffer(b"".join(lines[1:4 * n:4]), np.uint8)
    qual = np.frombuffer(b"".join(lines[3:4 * n:4]), np.uint8)
    return seq.reshape(n, read_len), qual.reshape(n, read_len)


def write_bam(path, fq, read_len=150):
    """The reads of a FASTQ of read_len-base reads (write_fastq's) as a
    BAM file of unmapped records, in BGZF blocks of 60,000 bytes: a small
    writer, built with numpy, so that the reader is held to a file this
    script did not read itself."""
    import struct
    import zlib

    seq, qual = fastq_reads(fq, read_len)
    n = len(seq)
    nib = _BAM_CODE[seq]
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    names = np.frombuffer(b"".join(b"r%09d\0" % i for i in range(n)),
                          np.uint8).reshape(n, 11)
    fixed = struct.pack("<iiBBHHHiiii", -1, -1, 11, 0, 0, 0, 4, read_len,
                        -1, -1, 0)
    rec_len = len(fixed) + 11 + read_len // 2 + read_len
    head = np.frombuffer(struct.pack("<i", rec_len) + fixed, np.uint8)
    recs = np.concatenate([np.broadcast_to(head, (n, len(head))), names,
                           packed, qual - 33], axis=1)
    body = b"BAM\x01" + struct.pack("<ii", 0, 0) + recs.tobytes()
    with open(path, "wb") as f:
        for off in range(0, len(body), 60000):
            data = body[off:off + 60000]
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            payload = co.compress(data) + co.flush()
            f.write(b"\x1f\x8b\x08\x04\0\0\0\0\0\xff"
                    + struct.pack("<H", 6) + b"BC"
                    + struct.pack("<HH", 2, 18 + len(payload) + 8 - 1)
                    + payload
                    + struct.pack("<II", zlib.crc32(data), len(data)))
        f.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))


# -- CRAM files written with the port's encoders --------------------------------

# the series of an unmapped record with a quality array, one external
# block each: (content id, name); RN is BYTE_ARRAY_STOP on NUL
CRAM_SERIES = ((1, "BF"), (2, "CF"), (3, "RL"), (4, "AP"), (5, "RG"),
               (6, "RN"), (7, "TL"), (8, "BA"), (9, "QS"))
CRAM_SLICE_READS = 13_500  # 16 slices of the CLI k = 21 input


def _itf8(v: int) -> bytes:
    from jellyfish_tpu_torch.io.cram import write_itf8

    out = bytearray()
    write_itf8(out, v)
    return bytes(out)


def _ltf8(v: int) -> bytes:
    from jellyfish_tpu_torch.io.cram import write_ltf8

    out = bytearray()
    write_ltf8(out, v)
    return bytes(out)


def _cram_block(method: int, ctype: int, cid: int, raw: bytes,
                comp: bytes) -> bytes:
    import struct
    import zlib

    payload = (bytes([method, ctype]) + _itf8(cid) + _itf8(len(comp))
               + _itf8(len(raw)) + comp)
    return payload + struct.pack("<I", zlib.crc32(payload))


def _cram_container(blocks: bytes, n_blocks: int, n_records=0, counter=0,
                    bases=0, start=0) -> bytes:
    import struct
    import zlib

    head = (_itf8(-1) + _itf8(start) + _itf8(0) + _itf8(n_records)
            + _ltf8(counter) + _ltf8(bases) + _itf8(n_blocks) + _itf8(0))
    raw = struct.pack("<i", len(blocks)) + head
    return raw + struct.pack("<I", zlib.crc32(raw)) + blocks


def _cram_map(entries) -> bytes:
    body = _itf8(len(entries)) + b"".join(entries)
    return _itf8(len(body)) + body


def _cram_compression_header() -> bytes:
    pres = [b"RN\x01", b"AP\x01", b"RR\x01", b"SM" + b"\x1b" * 5]
    enc = []
    for cid, key in CRAM_SERIES:
        codec, params = (5, b"\x00" + _itf8(cid)) if key == "RN" else (
            1, _itf8(cid))
        enc.append(key.encode() + _itf8(codec) + _itf8(len(params)) + params)
    return _cram_map(pres) + _cram_map(enc) + _cram_map([])


def encode_cram_slice(version, first, seq, qual):
    """One slice of unmapped reads (seq and qual [n, L] uint8, qualities
    phred+33) numbered from `first`, with every series in an external
    block: (its blocks, how many). CRAM 3.0 compresses each block with
    rANS 4x8 order 1; CRAM 3.1 the bases with rANS Nx16 order 1, the
    qualities with fqzcomp, the names with tok3 and the rest with rANS
    Nx16 order 0."""
    from jellyfish_tpu_torch.io import fqzcomp, rans, rans16, tok3

    n, L = seq.shape
    data = {
        "BF": b"\x04" * n, "CF": b"\x01" * n, "RL": _itf8(L) * n,
        "AP": b"\x00" * n, "RG": _itf8(-1) * n, "TL": b"\x00" * n,
        "RN": b"".join(b"r%d\0" % i for i in range(first, first + n)),
        "BA": seq.tobytes(), "QS": (qual - 33).tobytes(),
    }
    out = []
    for cid, key in CRAM_SERIES:
        raw = data[key]
        if version == (3, 0):
            method, comp = 4, rans.encode(raw, 1)
        elif key == "QS":
            method, comp = 7, fqzcomp.encode([L] * n, raw)
        elif key == "RN":
            method, comp = 8, tok3.encode(raw)
        else:
            flags = rans16.F_ORDER1 if key == "BA" else 0
            method, comp = 5, rans16.encode(raw, flags)
        out.append(_cram_block(method, 4, cid, raw, comp))
    cids = b"".join(_itf8(cid) for cid, _ in CRAM_SERIES)
    header = (_itf8(-1) + _itf8(0) + _itf8(0) + _itf8(n) + _ltf8(first)
              + _itf8(1 + len(CRAM_SERIES)) + _itf8(len(CRAM_SERIES))
              + cids + _itf8(-1) + b"\0" * 16)
    blocks = (_cram_block(0, 2, 0, header, header)
              + _cram_block(0, 5, 0, b"", b"") + b"".join(out))
    return blocks, 2 + len(CRAM_SERIES)


def write_crams(paths, fq, read_len=150):
    """The reads of `fq` as CRAM files, {version: path}: one container a
    slice of CRAM_SLICE_READS reads, the slices encoded in processes of
    their own (the encoders are pure python). Returns the seconds taken."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from jellyfish_tpu_torch.io.cram import EOF_POSITION

    t = time.perf_counter()
    seq, qual = fastq_reads(fq, read_len)
    starts = range(0, len(seq), CRAM_SLICE_READS)
    workers = min(8, os.cpu_count() or 1)
    comp = _cram_compression_header()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        # the 3.1 slices, the slower to encode, go first
        futures = {v: [pool.submit(encode_cram_slice, v, i,
                                   seq[i:i + CRAM_SLICE_READS],
                                   qual[i:i + CRAM_SLICE_READS])
                       for i in starts]
                   for v in sorted(paths, reverse=True)}
        for v, path in paths.items():
            with open(path, "wb") as f:
                f.write(b"CRAM" + bytes(v) + b"jellyfish_tpu_torch\0")
                text = b"@HD\tVN:1.6\tSO:unsorted\n"
                head = len(text).to_bytes(4, "little") + text
                f.write(_cram_container(_cram_block(0, 0, 0, head, head), 1))
                for i, fut in zip(starts, futures[v]):
                    blocks, n_blocks = fut.result()
                    n = min(CRAM_SLICE_READS, len(seq) - i)
                    body = _cram_block(0, 1, 0, comp, comp) + blocks
                    f.write(_cram_container(body, 1 + n_blocks, n, i,
                                            n * read_len))
                eof = _cram_map([]) * 3  # an empty compression header
                f.write(_cram_container(_cram_block(0, 1, 0, eof, eof), 1,
                                        start=EOF_POSITION))
    return time.perf_counter() - t


# the native library's entry points counted while a phase runs
NATIVE_CALLS = ("jf_chunker_feed", "jf_pack_chunk", "jf_bam_records",
                "jf_cram_slice", "jf_rans_decode", "jf_rans16_decode",
                "jf_arith_decode", "jf_fqz_decode", "jf_tok3_decode")


@contextlib.contextmanager
def native_calls():
    """{entry point: calls} of the port's native library while the block
    runs, from every thread: each entry point is wrapped on the loaded
    library, and restored after."""
    import threading

    from jellyfish_tpu_torch.native import build_error, get_lib

    lib = get_lib()
    if lib is None:
        raise AssertionError(f"the native library did not build: "
                             f"{build_error()}")
    counts = dict.fromkeys(NATIVE_CALLS, 0)
    lock = threading.Lock()
    real = {n: getattr(lib, n) for n in NATIVE_CALLS}

    def wrap(name, fn):
        def call(*args):
            with lock:
                counts[name] += 1
            return fn(*args)
        return call

    for name, fn in real.items():
        setattr(lib, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(lib, name, fn)


def phase_sam(tmp):
    """count --sam at the CLI k = 21 size: fastq2sam of r21.fq, a BAM of
    the same reads (write_bam) and two CRAMs of them (write_crams: 3.0 in
    rANS 4x8 order-1 blocks; 3.1 with rANS Nx16 bases, fqzcomp qualities
    and tok3 names), each counted with count --sam -s 4M -C, and each CRAM
    again with -Q 5, which decodes its qualities: record-equal to the
    FASTQ's count (o21.jf; every quality is I, so -Q 5 masks nothing),
    each launching K1 and K2. The BAM goes through jf_bam_records, each
    CRAM slice through jf_cram_slice, and the quality blocks are decoded
    under -Q only. Returns (launches of the BAM count, results)."""
    from jellyfish_tpu_torch import cli

    fq = os.path.join(tmp, "r21.fq")
    fastq, sam = (os.path.join(tmp, f"s21.{e}") for e in ("fastq", "sam"))
    bam, out = os.path.join(tmp, "s21.bam"), os.path.join(tmp, "sam.jf")
    crams = {v: os.path.join(tmp, f"s21.v{v[0]}{v[1]}.cram")
             for v in ((3, 0), (3, 1))}
    os.symlink(fq, fastq)
    t = time.perf_counter()
    if cli.main(["fastq2sam", fastq]) != 0:
        raise AssertionError("fastq2sam failed")
    t_sam = time.perf_counter() - t
    t = time.perf_counter()
    write_bam(bam, fq)
    t_bam = time.perf_counter() - t
    t_cram = write_crams(crams, fq)
    n_slices = -(-len(fastq_reads(fq)[0]) // CRAM_SLICE_READS)
    want = records_of(os.path.join(tmp, "o21.jf"))
    res = dict(fastq2sam_s=t_sam, write_bam_s=t_bam, write_crams_s=t_cram,
               cram_slices=n_slices)
    log(f"SAM, BAM and CRAM writers, CLI k=21: {json.dumps(res)}")
    runs = [("sam", sam, []), ("bam", bam, [])]
    for v, path in crams.items():
        runs += [(f"cram{v[0]}{v[1]}", path, []),
                 (f"cram{v[0]}{v[1]}_Q5", path, ["-Q", "5"])]
    bam_launches = None
    for name, path, flags in runs:
        reset_counts()
        with native_calls() as calls:
            t = time.perf_counter()
            rc = cli.main(["count", "-m", "21", "-s", "4M", "-C",
                           "--matrix-seed", "1", *flags, "--sam", path,
                           "-o", out])
            dt = time.perf_counter() - t
        launches = kernel_counts()
        same = rc == 0 and records_of(out) == want
        res[name] = dict(wall_s=dt, bytes=os.path.getsize(path), equal=same,
                         native_calls={k: v for k, v in calls.items() if v},
                         launches={n: launches[n]
                                   for n in ("merge_path", "compact")})
        log(f"count --sam {' '.join([os.path.basename(path), *flags])} "
            f"k=21: {json.dumps(res[name])}")
        missed = [n for n in ("merge_path", "compact") if launches[n] == 0]
        if not same or missed:
            raise AssertionError(f"count --sam {name} differs from the "
                                 f"FASTQ's count or ran without {missed}")
        quals = flags != []
        need = {"bam": calls["jf_bam_records"] > 0,
                "cram30": calls["jf_cram_slice"] == n_slices
                and calls["jf_rans_decode"] == (9 if quals else 8) * n_slices,
                "cram31": calls["jf_cram_slice"] == n_slices
                and calls["jf_fqz_decode"] == (n_slices if quals else 0)
                and calls["jf_tok3_decode"] == n_slices}.get(name[:6], True)
        if not need:
            raise AssertionError(f"count --sam {name} took another path "
                                 f"than the native one: {calls}")
        if name == "bam":
            bam_launches = launches
    for p in (fastq, sam, bam, out, *crams.values()):
        os.unlink(p)
    return bam_launches, res


def phase_native(tmp):
    """The native host library at the CLI k = 21 size. It was built into
    build/jellyfish_tpu_torch/ and is the one mapped (nothing under
    jellyfish_tpu/ is); count -m 21 -s 4M -C of r21.fq in a child process
    with the native chunker and again under JF_NO_NATIVE=1, each
    record-equal to o21.jf, with the child's wall time and --timing's
    phases; count -F 4 of r21.fq dealt into 4 files, and -F 1 of those
    files, record-equal to o21.jf; libjfquery built and 1,000 records of
    o21.jf and 1,000 random mers queried through ctypes, each equal to the
    port's query. Returns results."""
    import ctypes
    from pathlib import Path

    from jellyfish_tpu_torch import cli
    from jellyfish_tpu_torch.native import (
        LIB_PATH,
        build_error,
        build_jfquery,
        get_lib,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    lib = get_lib()
    with open("/proc/self/maps") as f:
        maps = {line.split()[-1] for line in f if ".so" in line}
    loaded = (lib is not None and lib._name == str(LIB_PATH)
              and str(LIB_PATH) in maps
              and LIB_PATH.parent == Path(here, "build", "jellyfish_tpu_torch")
              and not any("/jellyfish_tpu/" in m for m in maps))
    log(f"native library: {LIB_PATH} loaded {loaded} ({build_error()})")
    if not loaded:
        raise AssertionError("the port's native library is not the one "
                             "loaded from build/jellyfish_tpu_torch/")
    fq, mem = os.path.join(tmp, "r21.fq"), os.path.join(tmp, "o21.jf")
    want = records_of(mem)
    base = ["count", "-m", "21", "-s", "4M", "-C", "--matrix-seed", "1"]
    res = {}
    for name, env in (("native", {}), ("python", {"JF_NO_NATIVE": "1"})):
        out, timing = (os.path.join(tmp, f"nat_{name}.{e}")
                       for e in ("jf", "txt"))
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "jellyfish_tpu_torch",
                            *base, "--timing", timing, "-o", out, fq],
                           cwd=here, env={**os.environ, **env},
                           capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t
        if r.returncode != 0:
            raise AssertionError(f"count ({name} chunker) exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        with open(timing) as f:
            phases = {k: float(v) for k, v in
                      (line.split() for line in f if line.strip())}
        res[name] = dict(child_wall_s=dt, timing=phases,
                         equal=records_of(out) == want)
        os.unlink(out)
        os.unlink(timing)
    seq, qual = fastq_reads(fq)
    parts = []
    for i in range(4):
        parts.append(os.path.join(tmp, f"nat_part{i}.fq"))
        with open(parts[-1], "wb") as f:
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (j, s.tobytes(),
                                                       q.tobytes())
                             for j, s, q in zip(range(i, len(seq), 4),
                                                seq[i::4], qual[i::4])))
    out = os.path.join(tmp, "nat_F.jf")
    for nb in ("4", "1"):
        reset_counts()
        with native_calls() as calls:
            t = time.perf_counter()
            rc = cli.main([*base, "-F", nb, "-o", out, *parts])
            dt = time.perf_counter() - t
        launches = kernel_counts()
        res[f"F{nb}"] = dict(wall_s=dt, equal=rc == 0
                             and records_of(out) == want,
                             chunker_feeds=calls["jf_chunker_feed"],
                             launches={n: launches[n]
                                       for n in ("merge_path", "compact")})
    for p in (*parts, out):
        os.unlink(p)
    so = build_jfquery()
    if so is None:
        raise AssertionError("libjfquery did not build")
    lq = ctypes.CDLL(so)
    lq.jf_query_open.restype = ctypes.c_void_p
    lq.jf_query_open.argtypes = [ctypes.c_char_p]
    lq.jf_query_close.argtypes = [ctypes.c_void_p]
    lq.jf_query_nb_records.restype = ctypes.c_uint64
    lq.jf_query_nb_records.argtypes = [ctypes.c_void_p]
    lq.jf_query_mer.restype = ctypes.c_int64
    lq.jf_query_mer.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lq.jf_query_record.restype = ctypes.c_int
    lq.jf_query_record.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    _, _, counts = read_db(mem)
    q = lq.jf_query_open(mem.encode())
    try:
        n = lq.jf_query_nb_records(q)
        buf, cnt = ctypes.create_string_buffer(22), ctypes.c_uint64()
        idx = np.linspace(0, n - 1, 1000).astype(np.int64)
        mers, rec_ok = [], n == len(counts)
        for i in idx:
            rec_ok &= bool(lq.jf_query_record(q, int(i), buf,
                                              ctypes.byref(cnt)))
            rec_ok &= cnt.value == counts[i]
            mers.append(buf.value.decode())
        # not seed 21: write_fastq drew r21.fq's genome from it
        rng = np.random.default_rng(1021)
        mers += ["".join("ACGT"[b] for b in rng.integers(0, 4, 21))
                 for _ in range(1000)]
        t = time.perf_counter()
        got = [lq.jf_query_mer(q, m.encode()) for m in mers]
        t_lib = time.perf_counter() - t
    finally:
        lq.jf_query_close(q)
    qout = os.path.join(tmp, "nat_query.txt")
    t = time.perf_counter()
    rc = cli.main(["query", "-o", qout, mem, *mers])
    t_cli = time.perf_counter() - t
    with open(qout) as f:
        port = [line.split() for line in f]
    os.unlink(qout)
    same = (rc == 0 and rec_ok
            and port == [[m, str(c)] for m, c in zip(mers, got)])
    res["jfquery"] = dict(mers=len(mers), present=int(sum(c > 0 for c in got)),
                          equal=same, ctypes_s=t_lib, port_query_s=t_cli)
    log(f"native host library, CLI k=21: {json.dumps(res)}")
    bad = [k for k, v in res.items() if not v["equal"]]
    if bad or res["F4"]["launches"]["compact"] == 0:
        raise AssertionError(f"native phase differs: {bad}")
    return res


def phase_multihost_api(staged, table, dev):
    """ShardedMerCounter under a process group of one process over NCCL,
    2 local shards on the card, counts the 256 staged chunks at k = 21:
    record-equal to phase_full's table (-s 4M, the same 22 x 42 matrix).
    Counting s, finalize s, peak GiB, and a profiled pass over the first
    chunks with the device time of the exchange's all_gather and
    all_to_all_single by their own ranges (exchange_shares). Returns
    (launches, results)."""
    import torch.distributed as dist

    from jellyfish_tpu_torch.parallel import ShardedMerCounter
    from jellyfish_tpu_torch.parallel.multihost import (
        init_multihost,
        shutdown_multihost,
    )

    backend = init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        counter = ShardedMerCounter(21, 4 << 20, mesh=[dev] * 2,
                                    canonical=True,
                                    rng=np.random.default_rng(42),
                                    group=dist.group.WORLD)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mers, counts, t_count, t_final, held = sharded_pass(counter, staged)
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        same = (np.array_equal(mers, table[0])
                and np.array_equal(counts, table[1]))
        n_valid = int(counts.sum(dtype=np.uint64))
        del mers, counts
        shares = exchange_shares(counter, staged, collectives=True)
        del counter
    finally:
        shutdown_multihost()
    torch.cuda.empty_cache()
    row = dict(backend=backend, world=1, shards=2, counting_s=t_count,
               mers_per_s=n_valid / t_count, finalize_s=t_final,
               peak_gib=peak / 2**30, device_bytes_counted=held,
               equal=same, **shares)
    log(f"full size k=21, ShardedMerCounter under a {backend} group of 1 "
        f"process, 2 shards on the card: {json.dumps(row)}; launches "
        f"{launches}")
    missed = [n for n in ("merge_path", "compact") if launches[n] == 0]
    if backend != "nccl" or not same or missed:
        raise AssertionError(f"the {backend} group's count differs from "
                             f"the single-device table or ran without "
                             f"{missed}")
    return launches, row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from jellyfish_tpu_torch import native
        from jellyfish_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: jellyfish_tpu_torch not found ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t_script = time.perf_counter()
    # the native host library (g++) builds beside the kernels (nvcc), so
    # that no CLI phase times its build
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.get_lib)
        _build.build(["merge_path", "compact", "bitonic", "window"])
        if host_lib.result() is None:
            raise AssertionError(f"the native host library did not build: "
                                 f"{native.build_error()}")
    log(f"build: {time.perf_counter() - t_script:.1f} s (kernels and "
        f"{native.LIB_PATH.name})")
    ptxas_report("merge_path")
    ptxas_report("bitonic")
    ptxas_report("window")

    rows = phase_kernels(dev)
    k3_rows, k3_table = phase_k3(dev)
    rows.update(k3_rows)
    k3_table["exchange_groups"] = phase_exchange(dev)
    win_rows, win_table = phase_window(dev)
    rows.update(win_rows)
    with tempfile.TemporaryDirectory() as tmp:
        seq21 = phase_cli(tmp, 21, 32_000_000, 4_000_000, seed=21,
                          need=["compact"])
        phase_cli(tmp, 33, 4_000_000, 1_000_000, seed=33,
                  need=["compact", "block_sort", "merge_pass",
                        "merge_splits"])
        phase_cli(tmp, 63, 12_000_000, 3_000_000, seed=63,
                  need=["compact", "block_sort", "merge_pass",
                        "merge_splits", "merge_path"])
        phase_cli(tmp, 100, 2_000_000, 1_000_000, seed=100,
                  need=["compact", "block_sort", "merge_pass",
                        "merge_splits"])
        merge63 = phase_merge_ops(tmp, os.path.join(tmp, "r63.fq"),
                                  os.path.join(tmp, "o63.jf"), dev)
        on_merge = ["window_rows", "roll_lanes", "merge_path", "compact"]
        disk = [
            phase_disk(tmp, os.path.join(tmp, "r21.fq"), 21, "1M", "1M",
                       need=on_merge[:1] + on_merge[2:]),
            phase_disk(tmp, os.path.join(tmp, "r63.fq"), 63, "512k", "256k",
                       need=on_merge[:1] + on_merge[2:] + ["block_sort"]),
        ]
        bloom_cli = phase_bloom_cli(tmp, os.path.join(tmp, "r21.fq"), seq21,
                                    os.path.join(tmp, "o21.jf"))
        cli_modes = phase_cli_modes(tmp)
        shard_mode_launches, shard_modes = phase_sharded_modes(tmp, dev)
        multihost_cli = phase_multihost_cli(tmp)
        sam_launches, sam = phase_sam(tmp)
        native = phase_native(tmp)
        del seq21
        chunks, staged = stage_chunks(dev)
        # each kernel's launches are read from the full-size run of its
        # path: K1 and K2 the k = 21 count's, K3's block sort and
        # merge_pass the k = 63 count's, block_merge, exchange_stages (row
        # 8: its kernel passes, beside its calls), its mirrored step (row
        # 12's role: one pass a mirrored call) and block_sort at the
        # insert's shape the full-size bc's, window_rows and roll_lanes
        # the full-size merge's. flip lies on no path and reports the
        # bc's 0
        path = {"merge_path": 21, "compact": 21, "block_sort": 63,
                "merge_pass": 63, "merge_splits": 63,
                "block_sort_bloom": "bloom",
                "block_merge": "bloom", "exchange_stages": "bloom",
                "exchange_stages_mirror": "bloom", "flip": "bloom",
                "window_rows": "merge", "roll_lanes": "merge",
                "compact_keep": "merge"}
        # the keep-mask row counts the launches of the compact wrapper
        counter = {"compact_keep": "compact",
                   "block_sort_bloom": "block_sort",
                   "exchange_stages": "exchange_stages.passes",
                   "exchange_stages_mirror": "exchange_stages.mirror"}
        full, launches, tables = {}, {}, {}
        for k in K_FULL:
            need = [n for n, run in path.items()
                    if run in (21, 63) and (k == 63 or run == k)]
            launches[k], full[k], tables[k] = phase_full(
                k, chunks, staged, need, compare_lsd=k == 63)
            torch.cuda.empty_cache()
        table = tables[21]
        mode_launches, modes = {}, {}
        mode_launches["packed_store"], modes["packed_store"] = phase_packed(
            staged, tables)
        mode_launches["sharded"], modes["sharded"] = phase_sharded(
            staged, tables, dev)
        mode_launches["sharded_modes"] = shard_mode_launches
        modes["sharded_modes"] = shard_modes
        mode_launches["multihost"], api = phase_multihost_api(
            staged, tables[21], dev)
        modes["multihost"] = dict(api=api, cli=multihost_cli)
        mode_launches["sam"], modes["sam"] = sam_launches, sam
        modes["native"] = native
        del tables
        mode_launches["restricted"], modes["restricted"] = phase_if(
            chunks, staged, table)
        torch.cuda.empty_cache()
        launches["bloom"], bloom_rows, bloom = phase_bloom(chunks, staged,
                                                           table, dev)
        rows.update(bloom_rows)
        torch.cuda.empty_cache()
        del chunks
        launches["merge"], merge = phase_merge(tmp, staged, table, on_merge)
        del table, staged
    where = {"merge": "full-size merge k=21", "bloom": "full-size bc k=21"}
    for name, row in rows.items():
        row["launches"] = launches[path[name]][counter.get(name, name)]
        row["path"] = where.get(path[name], f"full size k={path[name]}")
    rows["exchange_stages"]["calls"] = launches["bloom"]["exchange_stages"]
    log(json.dumps({"merge": {"full_size": merge, "k63": merge63},
                    "disk": disk}))
    log(json.dumps({"bloom": {"full_size": bloom, "cli": bloom_cli}}))
    log(json.dumps({"count_modes": {**modes, "cli": cli_modes}}))
    log(json.dumps({"count_mode_launches": mode_launches}))
    log(json.dumps({"window_table": win_table}))
    log(json.dumps({"full_size": list(full.values())}))
    log(json.dumps({"k3_table": k3_table}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(f"script: {time.perf_counter() - t_script:.1f} s")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
