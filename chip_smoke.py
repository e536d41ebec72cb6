"""Smoke run of jellyfish_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from jellyfish_tpu_torch/csrc (K1 merge_path.cu,
K2 compact.cu, K3 bitonic.cu, rows 9 and 10 window.cu) and holds each
entry point against its plain PyTorch version at the shapes its path gives
it and at the Pallas kernels' own shapes. Runs `count` end to end through
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
k = 21 count, record for record. Exits nonzero, with no result line, when
there is no GPU or any phase fails.

The last lines of standard output are the kernels' JSON line, the
script's time, the card's name and power limit as nvidia-smi reports
them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

K_FULL, CHUNKS, CHUNK_LEN, BATCH = (21, 63), 256, 1 << 20, 8
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
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
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
        block_sort,
        exchange_stages,
        flip,
    )
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.merge_path import merge_pass, merge_path
    from jellyfish_tpu_torch.kernels.window import roll_lanes, window_rows

    return {"merge_path": merge_path, "merge_pass": merge_pass,
            "compact": compact, "block_sort": block_sort,
            "exchange_stages": exchange_stages, "flip": flip,
            "window_rows": window_rows, "roll_lanes": roll_lanes}


def kernel_counts() -> dict:
    """Launch counts of every kernel wrapper of the port."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


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
    # the row is the full-size merge's width, Wk 1
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


def hold(label, fn, plain, nbytes=None, library=None):
    """Run a kernel entry point and its plain version on the same inputs,
    fail unless they agree exactly; with nbytes, also time both (and the
    library call) and return the kernel table's numbers."""
    err = max_abs_err(_outs(fn()), _outs(plain()))
    log(f"{label}: max_abs_err {err}")
    if err:
        raise AssertionError(f"{label} disagrees with its plain version")
    if nbytes is None:
        return None
    row = dict(max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
               bound_ms=1e3 * nbytes / PEAK_BYTES_PER_S, bound_by="bytes",
               library_ms=None if library is None else cuda_ms(library),
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


def phase_k3(dev):
    """K3's entry points and K1's merge_pass against their plain versions:
    at the Pallas kernels' own shapes (kernel table rows 6, 7, 8, 11, 12)
    and at a grain's shape (2^26 rows of 4 limbs, keys only; 2^24 rows of
    7 limbs with a row-index payload), plus a ragged row count. Returns
    the JSON rows of K3's entry points and merge_pass, and the table's
    per-row numbers."""
    from jellyfish_tpu_torch.kernels.bitonic import (
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
    runs, ridx = block_sort_plain(x, idx, tile=1 << 16)
    hold(f"K1 merge_pass {m} rows, Wk 7 + payload, runs of 2^16",
         lambda: merge_pass(runs, 1 << 16, ridx),
         lambda: merge_pass_plain(runs, 1 << 16, ridx))
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
    torch.cuda.empty_cache()

    def json_row(name, row, source, replaces, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, **row, **extra)

    k3_src = "jellyfish_tpu_torch/csrc/bitonic.cu"
    off_path = ("off the counting path, which runs block_sort only: held "
                "against its plain version here")
    rows = {
        "block_sort": json_row(
            "bitonic.block_sort", sort_row, k3_src,
            "experiments/pallas_sort_proto.py:65",
            library="sort_rows_plain: a chain of 4 stable sorts and "
                    "gathers over the whole grain (no single PyTorch call "
                    "sorts multi-column rows)"),
        "exchange_stages": json_row(
            "bitonic.exchange_stages", table["8 exchange_stages"], k3_src,
            "experiments/pallas_probe2.py:103", note=off_path),
        "flip": json_row(
            "bitonic.flip", table["12 flip"], k3_src,
            "experiments/pallas_stage_probe.py:112", note=off_path),
        "merge_pass": json_row(
            "merge_path.merge_pass", pass_row,
            "jellyfish_tpu_torch/csrc/merge_path.cu",
            "experiments/pallas_merge_probe.py:492"),
    }
    return rows, table


def phase_window(dev):
    """Rows 9 and 10 (csrc/window.cu) against their plain versions, exact:
    at the Pallas probes' shapes, at the merge's shape (a 2^20-row window
    out of a 2^24-row slab at an odd offset, Wk 1 and 4, and the slab's
    rotation by -cursor) and at the edges, with offsets and shifts on the
    host and on the device. Returns the JSON rows, timed at Wk 1 (the
    full-size merge's width), and the Wk 4 timings."""
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
    flat = x.view(1, -1)
    for s in (0, -1, -4 * 777_777, 4 * m + 9, -(13 * 4 * m) - 3, 4 * m):
        hold(f"roll_lanes edge shift {s} of [1, {4 * m}]",
             lambda: roll_lanes(flat, on(s)),
             lambda: roll_lanes_plain(flat, s))
    del x, c, flat

    # the merge's shape
    rows, table = {}, {}
    slab, n, off = 1 << 24, 1 << 20, 5_000_001
    for wk in (1, 4):
        keys = torch.randint(0, 1 << 32, (slab, wk), device=dev, generator=g)
        cnt = torch.randint(0, 1 << 40, (slab,), device=dev, generator=g)
        cur = on(off)
        win = hold(
            f"window_rows {n} rows at {off} of a {slab}-row slab, Wk {wk}",
            lambda: window_rows(keys, cnt, cur, n),
            lambda: window_rows_plain(keys, cnt, off, n),
            2 * n * (wk + 1) * 8,
            library=lambda: (keys[off:off + n].clone(),
                             cnt[off:off + n].clone()))
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
    kernel in `need` launched at least once."""
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


def lsd_chain_sort(keys):
    """Key rows [M, Wk > 1] sorted by a chain of Wk stable argsorts and
    gathers, least significant column first: the grain sort of limb keys
    that K3 and K1's merge passes replaced, for phase_full's A/B."""
    perm = torch.argsort(keys[:, 0], stable=True)
    for w in range(1, keys.shape[1]):
        perm = perm[torch.argsort(keys[perm, w], stable=True)]
    return keys[perm]


def phase_full(k, chunks, staged, need, compare_lsd=False, keep=False):
    """Count the staged chunks at k through MerCounter: the counting
    region ends when every row is consolidated; then finalize, a profiled
    second pass, and the totals against the host. Each kernel in `need`
    must have launched in the first pass. With compare_lsd, three more
    passes time the grain sort's routes against each other: the LSD
    chain, the kernels, the LSD chain; each must give the first pass's
    totals. With keep, the first pass's table (mers, counts) is returned
    too."""
    import jellyfish_tpu_torch.ops.count as ops_count
    from jellyfish_tpu_torch.counter import MerCounter

    def one_pass(counter):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for pw, vb in staged:
            counter.add_chunks_packed_batch(pw, vb)
        # drain the raw backlog inside the timed region: every row is
        # sorted, counted and compacted before the clock stops
        counter.store.flush()
        torch.cuda.synchronize()
        t_count = time.perf_counter() - t
        t = time.perf_counter()
        mers, counts = counter.finalize_np()
        return mers, counts, t_count, time.perf_counter() - t

    counter = MerCounter(k, 4 << 20, canonical=True,
                         rng=np.random.default_rng(42))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mers, counts, t_count, t_final = one_pass(counter)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    # where the time goes: the same pass again under the profiler
    counter.reset()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t = time.perf_counter()
    with prof:
        one_pass(counter)
    t_prof = time.perf_counter() - t

    routes = {"kernels": [t_count], "lsd_chain": []}
    kernel_route = ops_count.sort_rows
    for name in ("lsd_chain", "kernels", "lsd_chain") if compare_lsd else ():
        ops_count.sort_rows = (lsd_chain_sort if name == "lsd_chain"
                               else kernel_route)
        try:
            counter.reset()
            _, c, t_c, _ = one_pass(counter)
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
    result = launches, dict(
        k=k, mers=n_valid, counting_s=t_count, mers_per_s=n_valid / t_count,
        finalize_s=t_final, device_busy_share=busy_share,
        peak_gib=peak / 2**30, distinct=len(counts),
        **({"counting_s_by_route": routes} if compare_lsd else {}))
    return (*result, (mers, counts)) if keep else result


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
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
    _build.build(["merge_path", "compact", "bitonic", "window"])
    log(f"build: {time.perf_counter() - t_script:.1f} s")

    rows = phase_kernels(dev)
    k3_rows, k3_table = phase_k3(dev)
    rows.update(k3_rows)
    win_rows, win_table = phase_window(dev)
    rows.update(win_rows)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp, 21, 32_000_000, 4_000_000, seed=21, need=["compact"])
        phase_cli(tmp, 33, 4_000_000, 1_000_000, seed=33,
                  need=["compact", "block_sort", "merge_pass"])
        phase_cli(tmp, 63, 12_000_000, 3_000_000, seed=63,
                  need=["compact", "block_sort", "merge_pass", "merge_path"])
        phase_cli(tmp, 100, 2_000_000, 1_000_000, seed=100,
                  need=["compact", "block_sort", "merge_pass"])
        merge63 = phase_merge_ops(tmp, os.path.join(tmp, "r63.fq"),
                                  os.path.join(tmp, "o63.jf"), dev)
        on_merge = ["window_rows", "roll_lanes", "merge_path", "compact"]
        disk = [
            phase_disk(tmp, os.path.join(tmp, "r21.fq"), 21, "1M", "1M",
                       need=on_merge[:1] + on_merge[2:]),
            phase_disk(tmp, os.path.join(tmp, "r63.fq"), 63, "512k", "256k",
                       need=on_merge[:1] + on_merge[2:] + ["block_sort"]),
        ]
        chunks, staged = stage_chunks(dev)
        # each kernel's launches are read from the full-size run of its
        # path; exchange_stages and flip lie on no path and report the
        # k = 63 count's, window_rows and roll_lanes the full-size merge's
        path = {"merge_path": 21, "compact": 21, "block_sort": 63,
                "merge_pass": 63, "exchange_stages": 63, "flip": 63,
                "window_rows": "merge", "roll_lanes": "merge",
                "compact_keep": "merge"}
        # the keep-mask row counts the launches of the compact wrapper
        counter = {"compact_keep": "compact"}
        off_path = {"exchange_stages", "flip"}
        full, launches = {}, {}
        for k in K_FULL:
            need = [n for n, run in path.items()
                    if n not in off_path and run != "merge"
                    and (k == 63 or run == k)]
            out = phase_full(k, chunks, staged, need, compare_lsd=k == 63,
                             keep=k == 21)
            launches[k], full[k] = out[:2]
            if k == 21:
                table = out[2]
            torch.cuda.empty_cache()
        del chunks
        launches["merge"], merge = phase_merge(tmp, staged, table, on_merge)
        del table, staged
    for name, row in rows.items():
        row["launches"] = launches[path[name]][counter.get(name, name)]
        row["path"] = (f"full size k={path[name]}" if path[name] != "merge"
                       else "full-size merge k=21")
    log(json.dumps({"merge": {"full_size": merge, "k63": merge63},
                    "disk": disk}))
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
