"""Device times of the port's kernel wrappers in several checkouts, side by side.

    python3 kernel_ab.py [--only PREFIX] TREE [TREE ...]

Each TREE is a directory that holds a jellyfish_tpu_torch package: a
checkout, or an unpacked `git archive` of one (for the parent commit:
`git archive HEAD~1 jellyfish_tpu_torch | tar -x -C DIR`). Each TREE runs in
a process of its own, in the order given (give A B B A to compare two on one
card), which builds that tree's CUDA kernels into TREE/build and times its
wrappers with this checkout's chip_smoke.cuda_ms (device time, the stream
held while the calls are enqueued) on the same seeded inputs, at the shapes
of PERF.md's kernel table: row 9's windows (eight 2^20-row windows of a
2^24-row slab a call, 1,500,000 rows apart, Wk 1 at odd and even offsets
and Wk 4), row 10's rotation of the slab; exchange_stages and flip (the
"row 7" ... "row 12" cases, step_cases): rows 7, 8 and 11 at the Pallas
probes' shapes (row 11 with 0, 1 and 2 transposes), rows 7 and 11 at 2^24
rows of Wk 1 keys only (row 7's steps also on whole tiles, distances
2048 ... 1), row 8 at the Bloom insert's last phase (2^24 rows, Wk 1 +
payload), row 12's mirrored step there, one BitsArray.set of 2^22 ids,
exchange_stages at 2^26 rows of Wk 4 (steps 2^25, 2048, 1) and at 2^24
rows of Wk 7 + payload (1 transpose, steps 2^23, 64, 1), and flip at the
probe's shape, at 2^24 rows of Wk 1 in tiles of 2^17 and at 2^26 rows of
Wk 4 in tiles of 2048, each beside torch.flip of the same view; each of
these also by its kernels' device time from torch.profiler, and
exchange_stages' kernel passes a call (exchange_stages.passes); K2's keep
mask at the merge's round, K2 at a k = 21 grain (2^27 rows, 25% live;
each K2 case also by its kernels' device time from torch.profiler), at
the Bloom insert's shape block_sort, block_merge and the whole pair
sort; K1's merge_pass at the k = 63 grain (2^26 rows, Wk 4, keys only) in
runs of 2^22 and of 2,048 (its first pass) and at 2^24 rows of Wk 1 +
payload in runs of 2^22, and K1's merge_path at row 1's shape (A 2^24 + B
2^24 rows, Wk 1 with counts, 90% of keys in both). The "bloom" case times
one Bloom-counter insert (BloomCounter2.insert_counts, k = 21, m = 2^30
cells, 10 hashes) of 889,077 seeded mers, 8,890,770 probe pairs as chunk
0 of the full-size bc gives, also by its kernels' device time from
torch.profiler (an insert waits on the host). The "radix" case times the
insert's sort alone, `radix_sort_pairs` of 8,890,770 seeded pairs below
2^30 (a tree whose csrc/ holds only radix.cu serves: a variant of that
kernel). The "pipeline" cases time the count's chunk pipeline,
MerCounter.packed_sortkeys of one batch (8 chunks of 2^20 bases, k = 21
and k = 55, -C, -s 100M), from numpy's words on the host and from int64 words on the
card, each also split by torch.profiler into its kernels. The wide cases (labels
from "wide", keys above 7 columns) time the grain sort of k = 127 (2^26
rows of Wk 8, keys only) at 40% and at 84% PAD rows (the share of a
full-size k = 127 count): K3's block_sort, K1's merge_pass on its first
pass (runs of one block_sort tile) and on runs of 2^22, merge_splits of
the latter, and the whole sort_rows_blocked; block_sort and
sort_rows_blocked of the k = 113 and k = 120 grains (84% PAD) and of the
k = 200 grain (2^25 rows of Wk 13, 80% PAD, as 250-base reads give);
block_sort of a grain whose rows tie on their top three columns; and
merge_pass's first pass at Wk 16 (k = 250, its run-time instance); K2's
wide instance at the k = 127 grain (2^26 rows of Wk 8, 25% live) and its
keep mask at a merge round's 4 x 2^20 rows of Wk 8, each also by its
kernels' device time from torch.profiler; and merge_splits of the first
pass beside that of runs of 2^22, and each sort_rows_blocked also by its
merge_splits launches' device time from torch.profiler; and K1's wide
merge_path (wide_merge_cases: A 2^22 + B 2^22 rows of Wk 8, 90% of keys
in both, also with 84% of each run PAD rows, of Wk 13 and of Wk 16, and
A 2^20 + B 2^20 and A 2^15 + B 2^15 of Wk 8), each call also split by
torch.profiler into its partition pass and tiles. Each
grain's top column holds the bits a count's sortkey leaves there. Needs
a CUDA card; the wrappers' APIs must match across the trees.

Every K2 case also splits its call by the profiler: each device
kernel's (and copy's) mean time a call, and the host gap, the call's
time less the sum of its device rows.

With --only, only the cases whose label starts with PREFIX run (and only
their inputs are made: `--only wide` makes none of the narrow cases',
`--only bloom` and `--only radix` only the insert's, `--only 'row '` only
rows 7-12's, `--only pipeline` only the chunk pipeline's).

Prints one JSON line a run, then the card's name and power limit (nvidia-smi)
and a JSON object of each case's times (ms a call; a window for row 9), one
a run in the order given; writes the same to chiprun_out/kernel_ab.json.
The object also holds exchange_stages' kernel passes a call, by case.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
WINDOWS, SLAB, WINDOW, FIRST, APART = 8, 1 << 24, 1 << 20, 5_000_001, 1_500_000
INSERT_ROWS, INSERT_PAIRS, TILE = 1 << 24, 8_890_770, 4096
INSERT_MERS, INSERT_HASHES = INSERT_PAIRS // 10, 10
# the kernels a case's profiler time sums, by label prefix, and the name
# of the sum: a K2 or Bloom call waits on the host, so its time follows the
# host's pace; a wide grain sort's merge_splits launches are a share of it;
# a wide merge_path call is a partition pass and a tile pass. Where the
# third field is set, the call is also split into each device row
PROFILED = {"K2": ("compact_", "kernels", True),
            "wide K2": ("compact_", "kernels", True),
            "bloom": ("", "kernels", False),
            "wide sort_rows_blocked": ("splits_kernel",
                                       "merge_splits kernels", False),
            "wide K1 merge_path": ("", "kernels", True),
            "row ": ("", "kernels", True),
            "pipeline": ("::", "kernels", True)}


def _smoke():
    """This checkout's chip_smoke module (cuda_ms, _cycle), loaded by path
    so that a TREE's own chip_smoke.py is not the one imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(dev, only=""):
    """(label, fn, calls a timed call makes) for every narrow case, on
    inputs made from fixed seeds; none when `only` selects the wide
    cases."""
    import torch

    from jellyfish_tpu_torch.kernels.bitonic import block_merge, block_sort
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.sort import sort_pairs_bitonic

    if only.startswith("wide"):
        return []
    if only.startswith("bloom"):
        return bloom_cases(dev)
    if only.startswith("radix"):
        return radix_cases(dev)
    if only.startswith("pipeline"):
        return pipeline_cases(dev)
    cycle = _smoke()._cycle
    g = torch.Generator(device=dev).manual_seed(88)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, device=dev, generator=g)

    # rows 7-12's cases, made only where --only can select a "row " label
    out = []
    if only.startswith("row ") or "row ".startswith(only):
        out = window_cases(dev, ints) + step_cases(dev, ints, cycle)
    if only.startswith("row"):
        return out
    m = 4 << 20
    pool = torch.sort(ints(1 << 62, m)).values
    reps = ints(4, m) + 1
    kk = torch.repeat_interleave(pool, reps)[:m].contiguous()[:, None]
    is_new = torch.ones(m, dtype=torch.bool, device=dev)
    is_new[1:] = kk[1:, 0] != kk[:-1, 0]
    vals = ints(9, m)[torch.cumsum(is_new, 0) - 1]
    keep = is_new & (vals <= 5)
    out.append(("K2 compact with a keep mask, 4 x 2^20 rows, Wk 1",
                lambda: compact(kk, vals, keep)[:2], 1))
    ck = torch.sort(ints(1 << 62, 1 << 27)).values[:, None]
    cc = ints(9, 1 << 27) * (ints(4, 1 << 27) == 0)
    out.append(("K2 compact, 2^27 rows, Wk 1, 25% live",
                lambda: compact(ck, cc)[:2], 1))
    pos, pw = ints(1 << 32, INSERT_ROWS, 1), ints(3, INSERT_ROWS)
    out.append(("K3 block_sort, 2^24 rows, Wk 1 + payload, tile 4096",
                lambda: block_sort(pos, pw, TILE), 1))
    out.append(("K3 block_merge, 2^24 rows, Wk 1 + payload, tile 4096",
                lambda: block_merge(pos, pw, TILE), 1))
    pairs, wb = pos[:INSERT_PAIRS].contiguous(), pw[:INSERT_PAIRS].contiguous()
    out.append(("the pair sort, one insert's 8,890,770 pairs",
                lambda: sort_pairs_bitonic(pairs, wb), 1))
    out += merge_cases(dev, g, ints)
    return out + bloom_cases(dev) + radix_cases(dev) + pipeline_cases(dev)


def window_cases(dev, ints):
    """Rows 9 and 10 at a merge's slab of 2^24 rows."""
    import torch

    from jellyfish_tpu_torch.kernels.window import roll_lanes, window_rows

    out = []
    for wk in (1, 4):
        keys, cnt = ints(1 << 32, SLAB, wk), ints(1 << 40, SLAB)
        for first in ((FIRST, FIRST - 1) if wk == 1 else (FIRST,)):
            curs = [torch.tensor(first + i * APART, device=dev)
                    for i in range(WINDOWS)]
            out.append((f"row 9 window_rows, Wk {wk}, "
                        f"{'odd' if first % 2 else 'even'} offsets",
                        lambda k=keys, c=cnt, cs=curs: [
                            window_rows(k, c, cu, WINDOW) for cu in cs],
                        WINDOWS))
        if wk == 1:
            flat, cflat = keys.view(1, -1), cnt.view(1, -1)
            shift = torch.tensor(-FIRST, device=dev)
            out.append(("row 10 roll_lanes, Wk 1, keys and counts",
                        lambda: (roll_lanes(flat, shift),
                                 roll_lanes(cflat, shift)), 1))
    return out


def step_cases(dev, ints, cycle):
    """exchange_stages and flip (rows 7, 8, 11 and 12): at the Pallas
    probes' shapes, at 2^24 rows of Wk 1 (128 MiB, past the L2), at the
    Bloom insert's last phase and its mirrored step (2^24 rows, Wk 1 +
    payload), at 2^26 rows of Wk 4 and 2^24 of Wk 7 + payload; one
    BitsArray.set of 2^22 ids (the route that launches them); flip beside
    torch.flip of the same view."""
    import torch

    from jellyfish_tpu_torch.kernels.bitonic import exchange_stages, flip
    from jellyfish_tpu_torch.ops.bitsarray import BitsArray

    big = 1 << 24
    out = []
    x7 = ints(1 << 32, 4096 * 128, 1)
    d7 = cycle(4096, 12)  # 2^18 ... 2^7
    out.append(("row 7 exchange_stages u32[4096, 128], 12 steps",
                lambda: exchange_stages(x7, distances=d7), 1))
    b1 = ints(1 << 32, big, 1)
    out.append(("row 7 exchange_stages 2^24 rows, Wk 1, keys only, 12 steps "
                "2^18 ... 2^7", lambda: exchange_stages(b1, distances=d7), 1))
    d7c = [2048 >> i for i in range(12)]  # the same steps on whole tiles
    out.append(("row 7 exchange_stages 2^24 rows, Wk 1, keys only, 12 steps "
                "2048 ... 1 (contiguous tiles)",
                lambda: exchange_stages(b1, distances=d7c), 1))
    b4 = ints(1 << 32, 4 * big, 4)
    d4 = [1 << 25, 2048, 1]
    out.append(("row 7 exchange_stages 2^26 rows, Wk 4, keys only, steps "
                "2^25, 2048, 1", lambda: exchange_stages(b4, distances=d4), 1))
    k8 = torch.stack([ints(64, 4096 * 128), ints(4, 4096 * 128)], 1)
    c8 = ints(1 << 32, 4096 * 128)
    out.append(("row 8 exchange_stages 3x u32[4096, 128], 12 steps",
                lambda: exchange_stages(k8, c8, d7), 1))
    pos, pw = ints(1 << 32, INSERT_ROWS, 1), ints(3, INSERT_ROWS)
    last = [INSERT_ROWS >> i for i in range(1, 13)]  # 2^23 ... 4096
    out.append(("row 8 exchange_stages, the insert's last phase",
                lambda: exchange_stages(pos, pw, last, mirror=True), 1))
    ids = ints(1 << 32, 1 << 22)
    ids[: 1 << 21] %= 1 << 16  # repeated ids
    bits = BitsArray(2, 1 << 32, device=dev)
    out.append(("row 8 BitsArray.set of 2^22 ids",
                lambda: bits.set(ids, ids >> 7), 1))
    x11 = ints(1 << 32, 1024 * 128, 1)
    d11 = cycle(1024, 10)  # 2^16 ... 2^7
    for t in (1, 0, 2):
        out.append((f"row 11 exchange_stages u32[1024, 128], {t} "
                    f"transpose{'' if t == 1 else 's'} + 10 steps",
                    lambda t=t: exchange_stages(x11, distances=d11,
                                                transposes=t), 1))
    out.append(("row 11 exchange_stages 2^24 rows, Wk 1, keys only, 1 "
                "transpose + 10 steps 2^16 ... 2^7",
                lambda: exchange_stages(b1, distances=d11, transposes=1), 1))
    b7, p7 = ints(1 << 32, big, 7), ints(1 << 40, big)
    out.append(("row 11 exchange_stages 2^24 rows, Wk 7 + payload, 1 "
                "transpose + steps 2^23, 64, 1",
                lambda: exchange_stages(b7, p7, [1 << 23, 64, 1],
                                        transposes=1), 1))
    out.append(("row 12 mirrored step at 2^23, 2^24 rows",
                lambda: exchange_stages(pos, pw, last[:1], mirror=True), 1))
    for label, x, tile in (("u32[1024, 128]", x11, x11.shape[0]),
                           ("2^24 rows, Wk 1, tiles of 2^17", b1, 1 << 17),
                           ("2^26 rows, Wk 4, tiles of 2048", b4, 2048)):
        out.append((f"row 12 flip {label}", lambda x=x, t=tile: flip(x, t),
                    1))
        out.append((f"row 12 torch.flip {label}",
                    lambda x=x, t=tile: torch.flip(
                        x.view(-1, t, x.shape[1]), [1]), 1))
    return out


def radix_cases(dev):
    """The Bloom insert's sort alone at its shape."""
    import torch

    from jellyfish_tpu_torch.kernels.radix import radix_sort_pairs

    g = torch.Generator(device=dev).manual_seed(16)
    keys = torch.randint(0, 1 << 30, (INSERT_PAIRS, 1), device=dev,
                         generator=g)
    pay = torch.randint(0, 3, (INSERT_PAIRS,), device=dev, generator=g)
    return [(f"radix_sort_pairs, {INSERT_PAIRS:,} pairs below 2^30",
             lambda: radix_sort_pairs(keys, pay, 30), 1)]


def pipeline_cases(dev):
    """The count's chunk pipeline at its batch: MerCounter.packed_sortkeys
    of 8 chunks of 2^20 bases of 150-base reads (k = 21 and k = 55, -C,
    -s 100M), from numpy's uint32 words on the host (the count's input:
    two copies to the card a call) and from int64 words already on the
    card."""
    import numpy as np
    import torch

    from jellyfish_tpu_torch.counter import MerCounter

    chunks = _smoke().synth_chunks(8, 1 << 20, seed=2323)
    t = (chunks >> 1) & 3
    codes = (t ^ (t >> 1)).astype(np.uint32)
    pw = (codes.reshape(8, -1, 16)
          << (2 * (15 - np.arange(16, dtype=np.uint32)))).sum(
              axis=2, dtype=np.uint32)
    ok = np.isin(chunks | 0x20, np.frombuffer(b"acgt", np.uint8))
    vb = (ok.astype(np.uint32).reshape(8, -1, 32)
          << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)
    pw64, vb64 = (torch.from_numpy(x.astype(np.int64)).to(dev)
                  for x in (pw, vb))
    out = []
    for k in (21, 55):
        counter = MerCounter(k, 100_000_000, canonical=True,
                             rng=np.random.default_rng(k), device=dev)
        label = f"pipeline k = {k} -C -s 100M, 8 x 2^20 bases"
        out += [(f"{label}, host words",
                 lambda c=counter: c.packed_sortkeys(pw, vb), 1),
                (f"{label}, int64 words on the card",
                 lambda c=counter: c.packed_sortkeys(pw64, vb64), 1)]
    return out


def bloom_cases(dev):
    """One Bloom-counter insert at the full-size bc's shape: k = 21 mers
    (two 32-bit limbs, 42 bits) drawn from a seed, weights 1 and some 2."""
    import numpy as np
    import torch

    from jellyfish_tpu_torch import bloom

    k = 21
    m1, m2 = bloom._random_hash_pair(k, np.random.default_rng(11))
    bc = bloom.BloomCounter2(1 << 30, INSERT_HASHES, k, m1, m2,
                             canonical=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    mers = torch.randint(0, 1 << 32, (INSERT_MERS, 2), device=dev,
                         generator=g)
    mers[:, 1] >>= 22
    w = 1 + (torch.rand(INSERT_MERS, device=dev, generator=g) < 0.05).long()
    return [(f"bloom insert_counts, {INSERT_MERS:,} mers ({INSERT_PAIRS:,} "
             "probe pairs), m = 2^30, 10 hashes",
             lambda: bc.insert_counts(mers, w), 1)]


def merge_cases(dev, g, ints):
    """K1's cases: merge_pass over sorted runs (each run sorted by the
    plain LSD chain of stable sorts) and merge_path over two sorted runs
    drawn from one pool."""
    import torch

    from jellyfish_tpu_torch.kernels.merge_path import merge_pass, merge_path
    from jellyfish_tpu_torch.ops.count import row_order

    def sorted_runs(m, wk, run):
        x = ints(1 << 32, m // run, run, wk)
        order = row_order(x)
        return torch.gather(x, 1, order[..., None].expand_as(x)).reshape(
            m, wk)

    out = []
    g4 = sorted_runs(1 << 26, 4, 1 << 22)
    out.append(("K1 merge_pass 2^26 rows, Wk 4, keys only, runs of 2^22",
                lambda: merge_pass(g4, 1 << 22), 1))
    f4 = sorted_runs(1 << 26, 4, 2048)
    out.append(("K1 merge_pass 2^26 rows, Wk 4, keys only, runs of 2048",
                lambda: merge_pass(f4, 2048), 1))
    w1 = torch.sort(ints(1 << 62, 4, 1 << 22), dim=1)[0].reshape(-1, 1)
    p1 = ints(1 << 40, 1 << 24)
    out.append(("K1 merge_pass 2^24 rows, Wk 1 + payload, runs of 2^22",
                lambda: merge_pass(w1, 1 << 22, p1), 1))
    n = 1 << 24
    pool = torch.sort(ints(1 << 62, int(n / 0.9)))[0]
    a, b = (pool[torch.sort(torch.randperm(len(pool), device=dev,
                                           generator=g)[:n])[0]]
            .reshape(-1, 1).contiguous() for _ in range(2))
    ac, bc = ints(1 << 20, n), ints(1 << 20, n)
    out.append(("K1 merge_path A 2^24 + B 2^24 rows, Wk 1, 90% of keys in "
                "both (row 1)", lambda: merge_path(a, ac, b, bc), 1))
    return out


def wide_cases(dev, only=""):
    """The wide instances' cases, made one grain at a time (a grain of
    2^26 rows of Wk 8 is 4 GiB) and yielded as they are made, so that a
    grain is freed before the next is drawn. A grain of k's rows comes
    from a pool of 2^24 random rows of 32-bit limbs whose top limb holds
    the 2k - 32 (Wk - 1) bits a count's sortkey leaves there
    (ops/hashing.sortkey_of_mers; few rows repeat), a share of them the
    all-ones PAD row, as in a count's grain."""
    if not ("wide".startswith(only) or only.startswith("wide")):
        return
    import torch

    from jellyfish_tpu_torch.kernels.bitonic import block_sort, tile_rows
    from jellyfish_tpu_torch.kernels.compact import compact
    from jellyfish_tpu_torch.kernels.merge_path import (
        merge_pass,
        merge_splits,
        pass_tile_rows,
    )
    from jellyfish_tpu_torch.kernels.sort import sort_rows_blocked

    g = torch.Generator(device=dev).manual_seed(127)

    def grain(m, k, pad):
        wk = (2 * k + 31) // 32
        pool = torch.randint(0, 1 << 32, (1 << 24, wk), device=dev,
                             generator=g)
        pool[:, -1] >>= 32 * wk - 2 * k
        x = pool[torch.randint(0, 1 << 24, (m,), device=dev, generator=g)]
        x[torch.rand(m, device=dev, generator=g) < pad] = (1 << 32) - 1
        return x

    def runs_of(x, run):
        return torch.cat([sort_rows_blocked(x[s:s + run].contiguous())[0]
                          for s in range(0, len(x), run)])

    def wanted(*labels):
        return any(label.startswith(only) for label in labels)

    m, wk, run = 1 << 26, 8, 1 << 22
    tile = tile_rows(wk, False)
    for pad in (40, 84):
        x = grain(m, 127, pad / 100)
        tag = f"k = 127, 2^26 rows, Wk {wk}, keys only, {pad}% PAD"
        yield f"wide K3 block_sort {tag}", lambda: block_sort(x), 1
        labels = (f"wide K1 merge_pass {tag}, the first pass (runs of one "
                  "block_sort tile)",
                  f"wide K1 merge_splits {tag}, the first pass (runs of "
                  f"{tile}), the pass's tiles")
        if wanted(*labels):
            first = block_sort(x)[0]
            yield labels[0], lambda: merge_pass(first, tile), 1
            yield (labels[1], lambda: merge_splits(
                first, tile, pass_tile_rows(wk, False)), 1)
            del first
        labels = (f"wide K1 merge_pass {tag}, runs of 2^22",
                  f"wide K1 merge_splits {tag}, runs of 2^22, the pass's "
                  "tiles")
        if wanted(*labels):
            long_runs = runs_of(x, run)
            yield labels[0], lambda: merge_pass(long_runs, run), 1
            yield (labels[1], lambda: merge_splits(
                long_runs, run, pass_tile_rows(wk, False)), 1)
            del long_runs
        yield f"wide sort_rows_blocked {tag}", lambda: sort_rows_blocked(x), 1
        del x
        torch.cuda.empty_cache()
    # the other widths of a count's top limb: 2 bits (k = 113), 16 (k =
    # 120 and 200)
    for k, m, pad in ((113, 1 << 26, 84), (120, 1 << 26, 84),
                      (200, 1 << 25, 80)):
        x = grain(m, k, pad / 100)
        tag = (f"k = {k}, 2^{m.bit_length() - 1} rows, Wk {x.shape[1]}, "
               f"keys only, {pad}% PAD")
        yield f"wide K3 block_sort {tag}", lambda: block_sort(x), 1
        yield f"wide sort_rows_blocked {tag}", lambda: sort_rows_blocked(x), 1
        del x
        torch.cuda.empty_cache()
    # rows that tie on their top three columns and differ below (few in a
    # count): every tile's proxies tie out of order
    x = grain(1 << 26, 127, 0)
    x[:, -3:] = torch.randint(0, 4, (1 << 26, 3), device=dev, generator=g)
    x[torch.rand(1 << 26, device=dev, generator=g) < 0.1] = (1 << 32) - 1
    yield ("wide K3 block_sort 2^26 rows, Wk 8, keys only, 10% PAD, top "
           "three columns of 4 values each (ties below them)",
           lambda: block_sort(x), 1)
    del x
    torch.cuda.empty_cache()
    # the pass's run-time instance (no compile-time one at Wk 16)
    x = block_sort(grain(1 << 25, 250, 0.8))[0]
    yield ("wide K1 merge_pass k = 250, 2^25 rows, Wk 16, keys only, 80% "
           f"PAD, the first pass (runs of {tile_rows(16, False)})",
           lambda: merge_pass(x, tile_rows(16, False)), 1)
    del x
    torch.cuda.empty_cache()
    # K2's wide instance, on inputs of their own seed: its count's
    # scatter at the k = 127 grain, its keep mask at a merge round's shape
    gk = torch.Generator(device=dev).manual_seed(2)
    for rows, mask, label in (
            (1 << 26, False, "wide K2 compact, 2^26 rows, Wk 8, 25% live"),
            (4 << 20, True, "wide K2 compact with a keep mask, 4 x 2^20 "
             "rows, Wk 8, 25% kept")):
        if not wanted(label):
            continue
        keys = torch.randint(0, 1 << 32, (rows, 8), device=dev, generator=gk)
        cnt = torch.randint(1, 9, (rows,), device=dev, generator=gk)
        cnt *= torch.rand(rows, device=dev, generator=gk) < 0.25
        keep = cnt != 0 if mask else None
        yield label, lambda: compact(keys, cnt, keep)[:2], 1
        del keys, cnt, keep
        torch.cuda.empty_cache()
    yield from wide_merge_cases(dev, wanted)


def wide_merge_cases(dev, wanted):
    """K1's wide merge_path: two sorted runs of n rows (with counts) drawn
    from one sorted pool of n / 0.9 rows, so that 90% of keys lie in both,
    the pool's rows of a count's top limb (as wide_cases' grains) and the
    PAD row last in each run; at the table's shape (k = 127, 2^22 + 2^22
    rows, Wk 8), with 84% of each run PAD rows (a k = 127 grain's share),
    at Wk 13 (k = 200) and Wk 16 (k = 250, the run-time instance), and at a
    merge round's window (2^20 + 2^20) and the CLI k = 127 merge's (2^15 +
    2^15)."""
    import torch

    from jellyfish_tpu_torch.kernels.merge_path import merge_path
    from jellyfish_tpu_torch.ops.count import sort_rows_plain

    g = torch.Generator(device=dev).manual_seed(18)

    def runs(n, k, pad=0.0):
        wk = (2 * k + 31) // 32
        live = n - round(n * pad)
        m = int(live / 0.9)
        pool = torch.randint(0, 1 << 32, (m, wk), device=dev, generator=g)
        pool[:, -1] >>= 32 * wk - 2 * k
        pool = sort_rows_plain(pool)[0]
        pad_rows = pool.new_full((n - live + 1, wk), (1 << 32) - 1)
        a, b = (torch.cat([pool[torch.randperm(m, device=dev, generator=g)
                                [:live - 1].sort().values], pad_rows])
                .contiguous() for _ in range(2))
        ac, bc = torch.randint(1, 1 << 20, (2, n), device=dev, generator=g)
        return a, ac, b, bc

    for n, k, pad in ((1 << 22, 127, 0.0), (1 << 22, 127, 0.84),
                      (1 << 22, 200, 0.0), (1 << 22, 250, 0.0),
                      (1 << 20, 127, 0.0), (1 << 15, 127, 0.0)):
        e = n.bit_length() - 1
        label = (f"wide K1 merge_path k = {k}, A 2^{e} + B 2^{e} rows, Wk "
                 f"{(2 * k + 31) // 32}, 90% of keys in both"
                 + (f", {round(100 * pad)}% PAD" if pad else ""))
        if not wanted(label):
            continue
        a, ac, b, bc = runs(n, k, pad)
        yield label, lambda: merge_path(a, ac, b, bc), 1
        del a, ac, b, bc
        torch.cuda.empty_cache()


def _short(name: str) -> str:
    """A profiler row's kernel name without its namespace, return type and
    arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.sub(r"\(.*", "", name).strip()[:60]


def run_tree(tree: str, only: str = "") -> dict:
    """Build TREE's kernels and time every case there (this process)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import jellyfish_tpu_torch
    from jellyfish_tpu_torch.kernels import _build

    here = Path(jellyfish_tpu_torch.__file__).resolve()
    if Path(tree).resolve() not in here.parents:
        raise RuntimeError(f"imported {here}, not the package of {tree}")
    _build.build([p.stem for p in _build.CSRC.glob("*.cu")])
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    from jellyfish_tpu_torch.kernels.bitonic import exchange_stages

    ms, passes = {}, {}
    for label, fn, calls in itertools.chain(cases(dev, only),
                                            wide_cases(dev, only)):
        if not label.startswith(only):
            continue
        if label.startswith("row "):  # exchange_stages' passes a call
            before = exchange_stages.passes
            fn()
            if exchange_stages.passes > before:
                passes[label] = exchange_stages.passes - before
        ms[label] = smoke.cuda_ms(fn, reps=10) / calls
        prefix = next((p for p in PROFILED if label.startswith(p)), None)
        if prefix is not None:
            # a call that waits on the host (K2 for its kept total, an
            # insert for its segment ends) is also timed by its kernels'
            # device time, a grain sort by its merge_splits launches': each
            # kernel's mean over 50 calls in one profiler window, summed
            # (each call's output freed before the next, as in cuda_ms)
            prof_rows = smoke.profiled(
                lambda f=fn: [None for _ in range(50) if f() is None])[2]
            part, what, split = PROFILED[prefix]
            ms[f"{label}, {what} (profiler)"] = sum(
                us / 50 for name, us, n in prof_rows if part in name) / 1e3
            if split:
                # the call split: each device row a call, and the host gap
                for name, us, n in prof_rows:
                    key = f"{label}, {_short(name)} (profiler)"
                    ms[key] = ms.get(key, 0) + us / 50 / 1e3
                ms[f"{label}, host gap (the call less its device rows)"] = (
                    ms[label] - sum(us for _, us, _ in prof_rows) / 50 / 1e3)
        torch.cuda.synchronize()
    return {"tree": tree, "ms": ms, "passes": passes}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        print(json.dumps(run_tree(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    trees, only = sys.argv[1:], ""
    if trees[:1] == ["--only"]:
        only, trees = trees[1], trees[2:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in trees:
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--run", tree, only], stdout=subprocess.PIPE,
                           text=True)
        if p.returncode:
            print(p.stdout, end="")
            return p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        text=True).stdout.strip().splitlines()[0]
    # a label one tree lacks (a kernel of its own in a call's split) is null
    labels = dict.fromkeys(label for r in runs for label in r["ms"])
    table = {label: [r["ms"].get(label) for r in runs] for label in labels}
    passes = {label: [r["passes"].get(label) for r in runs]
              for label in dict.fromkeys(x for r in runs for x in r["passes"])}
    result = {"card": card, "trees": trees, "ms": table,
              "exchange_stages passes": passes}
    os.makedirs(HERE / "chiprun_out", exist_ok=True)
    (HERE / "chiprun_out" / "kernel_ab.json").write_text(
        json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
