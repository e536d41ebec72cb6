"""Smoke run of jellyfish_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from jellyfish_tpu_torch/csrc, holds each against
its plain PyTorch version at the shapes the counting path gives it, runs
`count` end to end through the CLI at k = 21 and k = 33 with every record
checked against a numpy oracle, and counts the 268M windows (231M valid
mers) of the main configuration through MerCounter: k = 21, canonical,
-s 4M, 256 chunks of 1 MiB of 150-base reads at 8x coverage of a seeded
random 33.5 Mbase genome, in batches of 8. Exits nonzero, with no result
line, when there is no GPU or any phase fails.

The last lines of standard output are the kernels' JSON line, the card's
name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.
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

K_FULL, CHUNKS, CHUNK_LEN, BATCH = 21, 256, 1 << 20, 8
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet


def log(*a):
    print(*a, flush=True)


# -- host oracles (numpy, independent of the package) -------------------------

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b | 0x20] = _i


def canonical_windows(seq: np.ndarray, k: int):
    """Canonical 2-bit codes of the valid k-windows of an ASCII sequence,
    as (hi, lo) uint64 halves of the 2k-bit value (hi is None for
    k <= 32)."""
    code = _CODE[seq]
    n = max(len(seq) - k + 1, 0)
    csum = np.concatenate([[0], np.cumsum(code > 3, dtype=np.int64)])
    valid = csum[k:] - csum[:n] == 0
    c = (code & 3).astype(np.uint64)
    wide = k > 32
    f_lo, r_lo = np.zeros(n, np.uint64), np.zeros(n, np.uint64)
    f_hi, r_hi = (np.zeros(n, np.uint64), np.zeros(n, np.uint64)) if wide \
        else (None, None)
    for j in range(k):
        cj = c[j:j + n]
        for val, pos, hi, lo in ((cj, 2 * (k - 1 - j), f_hi, f_lo),
                                 (3 - cj, 2 * j, r_hi, r_lo)):
            if pos >= 64:
                hi |= val << np.uint64(pos - 64)
            else:
                lo |= val << np.uint64(pos)
    if not wide:
        return None, np.minimum(f_lo, r_lo)[valid]
    rc_less = (r_hi < f_hi) | ((r_hi == f_hi) & (r_lo < f_lo))
    hi = np.where(rc_less, r_hi, f_hi)[valid]
    lo = np.where(rc_less, r_lo, f_lo)[valid]
    return hi, lo


def distinct_count(arrays, bits: int, buckets: int = 256) -> int:
    """len(np.unique(np.concatenate(arrays))) for uint64 values < 2^bits,
    computed as np.unique of value-range buckets on 8 threads."""
    shift = np.uint64(max(bits - 8, 0))
    edges = np.arange(buckets + 1, dtype=np.uint64) << shift

    def split(a):
        a = np.sort(a)
        cut = np.searchsorted(a, edges)
        return [a[cut[i]:cut[i + 1]] for i in range(buckets)]

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(split, arrays))
        return sum(pool.map(
            lambda i: len(np.unique(np.concatenate([p[i] for p in parts]))),
            range(buckets)))


def _as_void(hi, lo):
    be = np.stack([hi.astype(">u8"), lo.astype(">u8")], axis=1)
    return np.ascontiguousarray(be).view("V16").ravel()


def read_db(path):
    """(header, key hi, key lo, counts) of a binary/sorted database."""
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(path, "rb") as f:
        h = FileHeader.read(f)
        data = f.read()
    kb = (h.key_len + 7) // 8
    rec = np.frombuffer(data, np.uint8).reshape(-1, kb + h.counter_len)
    le = lambda cols: (cols.astype(np.uint64) << (  # noqa: E731
        8 * np.arange(cols.shape[1], dtype=np.uint64))).sum(
            axis=1, dtype=np.uint64)
    lo = le(rec[:, :min(kb, 8)])
    hi = le(rec[:, 8:kb]) if kb > 8 else np.zeros(len(rec), np.uint64)
    return h, hi, lo, le(rec[:, kb:])


def _parity(t):
    for s in (32, 16, 8, 4, 2, 1):
        t = t ^ (t >> np.uint64(s))
    return t & np.uint64(1)


def sortkeys_ascend(h, hi, lo) -> bool:
    """Whether the records ascend in (pos, key >> l) order, pos = the
    header matrix applied to the key: the reference's dump order."""
    from jellyfish_tpu_torch.ops.hashing import masks_of_matrix

    k, lsize = h.key_len // 2, (h.size - 1).bit_length()
    W = (2 * k + 31) // 32
    masks = masks_of_matrix(h.matrix(), W).astype(np.uint64)
    limbs = [lo & np.uint64(0xFFFFFFFF), lo >> np.uint64(32), hi]
    pos = np.zeros(len(lo), np.uint64)
    for j in range(masks.shape[0]):
        t = np.zeros(len(lo), np.uint64)
        for w in range(W):
            t ^= limbs[w] & masks[j, w]
        pos |= _parity(t) << np.uint64(j)
    kh = (hi << np.uint64(64 - lsize)) | (lo >> np.uint64(lsize))
    up = (pos[1:] > pos[:-1]) | ((pos[1:] == pos[:-1]) & (kh[1:] > kh[:-1]))
    return bool(up.all())


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
    return max(int((g - w).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


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
        return sort_rows(k)[0].contiguous()

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
        pool = sort_rows(pool)[0]
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
    torch.cuda.empty_cache()
    return rows


def phase_cli(tmp, k, n_bases, genome_len, seed):
    from jellyfish_tpu_torch import cli
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.merge_path import merge_path

    fq, out = os.path.join(tmp, f"r{k}.fq"), os.path.join(tmp, f"o{k}.jf")
    seq = write_fastq(fq, n_bases, genome_len, seed)
    merge_path.launches = compact.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["count", "-m", str(k), "-s", "4M", "-C",
                   "--matrix-seed", "1", "-o", out, fq])
    dt = time.perf_counter() - t0
    launches = (merge_path.launches, compact.launches)
    if rc != 0:
        raise AssertionError(f"count exited {rc}")
    h, hi, lo, counts = read_db(out)
    whi, wlo = canonical_windows(seq, k)
    if whi is None:
        uniq, ucnt = np.unique(wlo, return_counts=True)
        order = np.argsort(lo, kind="stable")
        same = (np.array_equal(lo[order], uniq) and not hi.any()
                and np.array_equal(counts[order], ucnt))
    else:
        uniq, ucnt = np.unique(_as_void(whi, wlo), return_counts=True)
        got = _as_void(hi, lo)
        order = np.argsort(got, kind="stable")
        same = (np.array_equal(got[order], uniq)
                and np.array_equal(counts[order], ucnt))
    ascend = sortkeys_ascend(h, hi, lo)
    log(f"CLI count k={k} -C: {len(seq)} bases, {len(counts)} records, "
        f"{int(counts.sum())} mers in {dt:.2f} s; records == numpy oracle: "
        f"{same}; sortkey order: {ascend}; launches merge_path "
        f"{launches[0]} compact {launches[1]}")
    if not (same and ascend and len(counts) > 0):
        raise AssertionError(f"count k={k} database is wrong")
    if launches[1] == 0:
        raise AssertionError("count ran without the compaction kernel")


def phase_full(dev):
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.io.parse import pack_chunk
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.merge_path import merge_path

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

    counter = MerCounter(K_FULL, 4 << 20, canonical=True,
                         rng=np.random.default_rng(42))
    torch.cuda.reset_peak_memory_stats()
    merge_path.launches = compact.launches = 0
    mers, counts, t_count, t_final = one_pass(counter)
    launches = {"merge_path": merge_path.launches,
                "compact": compact.launches}
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
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler stretches the pass's wall time several-fold: set its
    # device time against the unprofiled pass's wall time instead
    busy = sum(r[1] for r in rows) / 1e6
    busy_share = busy / (t_count + t_final)
    log(f"profiled pass (count + finalize): {t_prof:.3f} s wall; device "
        f"kernels {busy:.3f} s = {100 * busy_share:.1f}% of the unprofiled "
        f"pass's {t_count + t_final:.3f} s; device kernels by time:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:15]:
        log(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{n:6d}x  {key[:100]}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        lo = list(pool.map(lambda c: canonical_windows(c, K_FULL)[1], chunks))
    t_windows = time.perf_counter() - t0
    n_valid = sum(len(x) for x in lo)
    t0 = time.perf_counter()
    distinct = distinct_count(lo, 2 * K_FULL)
    t_unique = time.perf_counter() - t0
    total = int(counts.sum(dtype=np.uint64))
    log(f"full size k={K_FULL} -C -s 4M: {n_valid} valid mers, counting "
        f"{t_count:.3f} s = {n_valid / t_count:.4g} mers/s, finalize "
        f"{t_final:.3f} s, peak {peak / 2**30:.2f} GiB; sum of counts "
        f"{total} (host {n_valid}), distinct {len(counts)} (host np.unique "
        f"{distinct}; host windows {t_windows:.1f} s, unique "
        f"{t_unique:.1f} s); launches {launches}")
    if total != n_valid or len(counts) != distinct:
        raise AssertionError("full-size counts disagree with the host")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches, dict(
        mers=n_valid, counting_s=t_count, mers_per_s=n_valid / t_count,
        finalize_s=t_final, device_busy_share=busy_share,
        peak_gib=peak / 2**30, distinct=len(counts))


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

    t0 = time.perf_counter()
    _build.build(["merge_path", "compact"])
    log(f"build: {time.perf_counter() - t0:.1f} s")

    rows = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(tmp, 21, 32_000_000, 4_000_000, seed=21)
        phase_cli(tmp, 33, 4_000_000, 1_000_000, seed=33)
    launches, full = phase_full(dev)
    for name, row in rows.items():
        row["launches"] = launches[name]
    log(json.dumps({"full_size": full}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
