"""Device-resident store of (sortkey, count) runs.

The counterpart of jellyfish_tpu/store.py, keeping its semantics and
leaving out what existed only to cut TPU sort bytes (the coverage model,
preslice, pad trim, rowsort compaction plans, u16 counts, narrowed top
limbs, pow2 sort groups and the asynchronous resolve):

  - the counter appends RAW runs of PREMASKED sortkeys (invalid windows
    already carry the PAD key), keys only; or, in the filter modes,
    COUNTED runs (`insert_run`: a chunk's sorted keys with their filtered
    counts, masked), which K2 compacts straight into level 0;
  - raw rows accumulate to a grain (`consolidate_rows`, 2^27 rows for
    W <= 3 limbs, 2^26 up to 8, and above 2^29 / W rounded to a power of
    two, at most 4 GiB of keys; the first grain runs at 1/8 of it). The
    grain is sorted (ops/count.sort_rows: torch.sort for a packed key
    column, the K3 block sort and K1 merge passes for limb columns),
    counted by segment length and compacted by kernel K2
    (kernels/compact.py) into a level-0 run;
  - compacted runs collect in a forest of levels, `branch` runs merging
    into one run of the next level. A merge takes at most
    `merge_bytes_budget` bytes of input runs (at least two runs) and
    combines them pairwise, ceil(log2(runs)) rounds, each pair through
    kernel K1 (kernels/merge_path.py), ops/count.fold_adjacent and K2;
  - finalize() merges every run the same way, into the resting run;
  - with pack_resting (`count --packed-store`), a run that a merge puts at
    level >= 2 and the resting run are held bit-packed
    (ops/packed_run.py) and unpacked when a merge or a finalize takes
    them, as in the JAX package;
  - each grain is a `store.grain` span of its owner's trace (rows_in raw
    rows, rows_out rows put into level 0), its sort inside it a
    `store.sort` span (rows, cols the key columns Wk, passes the merge
    passes of the blocked sort, 0 for torch.sort), and each merge of two
    or more runs a `store.merge` span (rows_in the rows of every pairwise
    K1 merge's two inputs, rows_out the merged run's rows); a store made
    without a trace records nothing.

Every run is exact: sorted, each key once, its count beside it, no PAD
rows except the one PAD entry whose count is the number of pad rows
ingested (plus one if a real key equals PAD). The store tracks the exact
pad total; the counter subtracts it from that entry at finalize, as in
the JAX package. Counts are int64.
"""

from __future__ import annotations

import torch

from jellyfish_tpu_torch.kernels.compact import compact
from jellyfish_tpu_torch.kernels.merge_path import merge_path
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops import count as count_ops
from jellyfish_tpu_torch.ops.count import fold_adjacent
from jellyfish_tpu_torch.ops.packed_run import PackedRun, pack_run, unpack_run
from jellyfish_tpu_torch.trace import OFF

__all__ = ["SortedCountStore"]

_LEVELS = 16
_PACK_LEVEL = 2  # with pack_resting, runs from this level up rest packed


def _run_bytes(run) -> int:
    """Dense bytes of a run (a packed one's once unpacked)."""
    if isinstance(run, PackedRun):
        return 8 * run.n * ((1 if mw.packs(run.W) else run.W) + 1)
    keys, counts = run
    return 8 * (keys.numel() + counts.numel())


class SortedCountStore:
    """Grain-consolidating count store (see module docstring).

    W is the limb count of the keys (store key columns as in
    ops/multiword.key_columns). pack_resting needs key_bits (2k). `trace`
    is the owner's trace.Trace (MerCounter.trace)."""

    def __init__(self, W: int, device, branch: int = 8,
                 consolidate_rows: int | None = None,
                 key_bits: int | None = None, pack_resting: bool = False,
                 trace=None):
        if pack_resting and key_bits is None:
            raise ValueError("pack_resting needs key_bits")
        self.W = W
        self.trace = OFF if trace is None else trace
        self.key_bits = key_bits
        self.pack_resting = bool(pack_resting)
        self.packed = 0  # runs packed since construction
        self.key_cols = 1 if mw.packs(W) else W
        self.device = torch.device(device)
        self.branch = int(branch)
        if consolidate_rows is None:
            consolidate_rows = ((1 << 27) if W <= 3 else (1 << 26) if W <= 8
                                else 1 << (29 - (W - 1).bit_length()))
        self.consolidate_rows = int(consolidate_rows)
        # cap on one merge's input bytes; the pairwise merge holds about
        # three times its input live (inputs, merged pair, compacted pair)
        self.merge_bytes_budget = 8_000_000_000
        self.reset()

    def reset(self) -> None:
        self.raw: list = []            # premasked key tensors [M, Wk]
        self.raw_rows = 0
        self.valid_scalars: list = []  # device scalars: valid rows per raw run
        self.raw_rows_ever = 0         # host int: raw rows since finalize
        self.levels: list[list] = [[] for _ in range(_LEVELS)]
        self._cold = True              # no grain consolidated yet
        # pads already baked into the resting run's PAD entry by an earlier
        # finalize, carried so repeated finalizes stay exact
        self.residual_pads = 0

    # -- ingestion ------------------------------------------------------------

    def insert_raw(self, keys, n_valid) -> None:
        """Append a premasked raw run [M, Wk]; n_valid is the (device)
        scalar count of its non-PAD rows."""
        self.raw.append(keys)
        self.raw_rows += keys.shape[0]
        self.raw_rows_ever += keys.shape[0]
        self.valid_scalars.append(n_valid)
        # consolidate before another run of this size would cross the grain
        grain = self._grain()
        if self.raw_rows >= grain or self.raw_rows + keys.shape[0] > grain:
            self.flush()

    def insert_run(self, keys, counts) -> None:
        """Append a counted run: sorted keys [M, Wk] with each key's count
        on one row and 0 on every other row (a masked run; the filters set
        counts to 0 too). K2 drops the rows of count 0, so the run enters
        level 0 exact, and a key that every filter zeroed never reaches
        the output (the JAX package drops them at its compacting merges).
        It adds no pad rows, so the pad total stays exact. (The JAX
        package's total_weight, which decides whether counts need a second
        uint32 limb, has no role here: counts are int64.)"""
        k2, c2, _ = compact(keys.contiguous(), counts.contiguous())
        self.levels[0].append((k2, c2))
        self._maybe_merge()

    def _grain(self) -> int:
        if self._cold:
            return max(self.consolidate_rows >> 3, 1024)
        return self.consolidate_rows

    def flush(self) -> None:
        """Sort the raw backlog, count segments, compact into level 0, so
        that every row ingested so far sits in a compacted run."""
        if not self.raw:
            return
        rows = self.raw_rows
        runs, self.raw, self.raw_rows = self.raw, [], 0
        self._cold = False
        with self.trace.span("store.grain", rows_in=rows) as span:
            keys = runs[0] if len(runs) == 1 else torch.cat(runs)
            del runs
            wk = keys.shape[1]
            with self.trace.span("store.sort", rows=rows, cols=wk,
                                 passes=count_ops.sort_passes(rows, wk)):
                # through the module: a wrapper put on ops.count.sort_rows
                # sees the grain's sort
                s = count_ops.sort_rows(keys)
            del keys
            k2, c2, _ = compact(s, count_ops.segment_counts(s))
            span.add("rows_out", k2.shape[0])
        self.levels[0].append((k2, c2))
        self._maybe_merge()

    def _maybe_merge(self) -> None:
        lvl = 0
        while len(self.levels[lvl]) >= self.branch:
            level = self.levels[lvl]
            take, nbytes = [], 0
            for r in level:
                rb = _run_bytes(r)
                if len(take) >= 2 and nbytes + rb > self.merge_bytes_budget:
                    break
                take.append(r)
                nbytes += rb
            self.levels[lvl] = level[len(take):]
            if lvl + 1 >= _LEVELS:
                raise RuntimeError("store exceeded maximum level count")
            merged = self._merge([self._materialize(r) for r in take])
            self.levels[lvl + 1].append(self._maybe_pack(lvl + 1, merged))
            # a budget-limited partial take can leave this level >= branch:
            # keep merging here before moving up
            if len(self.levels[lvl]) < self.branch:
                lvl += 1

    @staticmethod
    def _materialize(run):
        """A run as (keys, counts): a packed run is unpacked."""
        return unpack_run(run) if isinstance(run, PackedRun) else run

    def _maybe_pack(self, lvl: int, run):
        """Pack a run that rests at level lvl, when pack_resting is on and
        lvl >= 2 (runs that high are rarely merged again)."""
        keys, counts = run
        if not (self.pack_resting and lvl >= _PACK_LEVEL
                and keys.shape[0] > 0):
            return run
        self.packed += 1
        return pack_run(keys, counts, self.key_bits)

    def _merge(self, runs):
        """Merge exact runs pairwise into one exact run."""
        if len(runs) == 1:
            return runs[0]
        with self.trace.span("store.merge") as span:
            while len(runs) > 1:
                nxt = []
                for i in range(0, len(runs) - 1, 2):
                    (ak, ac), (bk, bc) = runs[i], runs[i + 1]
                    span.add("rows_in", ak.shape[0] + bk.shape[0])
                    keys, counts = merge_path(ak, ac, bk, bc)
                    counts = fold_adjacent(keys, counts)
                    k2, c2, _ = compact(keys, counts)
                    nxt.append((k2, c2))
                if len(runs) % 2:
                    nxt.append(runs[-1])
                runs = nxt
            span.add("rows_out", runs[0][0].shape[0])
        return runs[0]

    # -- inspection -----------------------------------------------------------

    def device_bytes(self) -> int:
        """Bytes the store holds, in the JAX package's units
        (jellyfish_tpu/store.py device_bytes): 4 for each 32-bit limb of a
        raw or compacted row and 8 for a count; a packed run's buffers at 4
        bytes an element. `count --disk` spills on it."""
        limbs = 4 * self.W
        total = self.raw_rows * limbs
        for level in self.levels:
            for r in level:
                total += (r.device_bytes() if isinstance(r, PackedRun)
                          else r[1].shape[0] * (limbs + 8))
        return total

    def total_pads(self) -> int:
        """Exact count of PAD rows inserted since the last finalize."""
        if not self.valid_scalars:
            return 0
        valid = int(torch.stack(self.valid_scalars).sum())
        return self.raw_rows_ever - valid

    # -- extraction -----------------------------------------------------------

    def finalize(self):
        """Merge everything. Returns (keys [n, Wk], counts [n], pads): the
        sorted exact run, and the pad total the caller subtracts from the
        trailing PAD entry (dropping it if it reaches zero). With
        pack_resting the store keeps the run packed, and the caller gets
        these dense arrays."""
        self.flush()
        pads = self.residual_pads + self.total_pads()
        runs = [self._materialize(r) for level in self.levels for r in level]
        self.valid_scalars = []
        self.raw_rows_ever = 0
        self.residual_pads = pads
        for level in self.levels:
            level.clear()
        if not runs:
            keys = torch.empty((0, self.key_cols), dtype=torch.int64,
                               device=self.device)
            return keys, torch.empty(0, dtype=torch.int64,
                                     device=self.device), 0
        keys, counts = self._merge(runs)
        del runs  # the unpacked inputs go before the resting run packs
        self.levels[-1].append(self._maybe_pack(_LEVELS - 1, (keys, counts)))
        return keys, counts, pads
