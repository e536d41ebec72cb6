"""The k-mer counting engine on the GPU (the counterpart of
jellyfish_tpu/counter.py).

Per batch of host-packed chunks, or per ASCII chunk:

    2-bit codes + validity bitstream (or ASCII -> codes) -> phase-major
    window extraction -> canonical fold -> GF(2) hash -> hash-order
    sortkeys as store key columns, premasked to PAD

kernels/sortkeys.sortkeys runs a batch of packed chunks and picks its
route: one kernel on the card where it covers the width, plain PyTorch
otherwise (the hash as AND + XOR-fold parity). ASCII chunks run in plain
PyTorch.

No per-batch sort: raw runs accumulate in SortedCountStore, whose grain
consolidations and merges run the hand-written kernels. With a mer filter
(`count --bc`, `--bf-size`) each ASCII chunk is counted on its own
(`chunk_counts`), its distinct mers recovered and filtered, and the
filtered run goes to the store as a counted run (`insert_run`).
finalize_np() yields the whole table in the reference's dump order
(ascending (pos, key)), a filter it is given applied once per mer. With
restrict_to (`count --if`) it yields the allowed mers instead, each with
its count or 0.

The counter records its own spans in `self.trace` (trace.py), which its
stores share: `pipeline` around each batch's (or chunk's) pipeline
(a packed batch's with its `rows` and the kernel's `fused_rows`);
`finalize` around finalize_np, and inside it `finalize.merge` (the
store's last flush and final merge, with the `pads` it returns),
`finalize.recover` (the mers out of their sortkeys) and one
`finalize.to_host` (with its `bytes`) for each copy of an output to the
host together with its conversion. reset() ends a job and appends its
summary to `self.trace.jobs`.
"""

from __future__ import annotations

import numpy as np
import torch

from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.kernels.merge_path import MAX_KEY_COLS
from jellyfish_tpu_torch.kernels.sortkeys import (
    premasked,
    route_tables,
    runs_kernel,
    sortkeys,
)
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.hashing import (
    inverse_masks_of_matrix,
    masks_of_matrix,
    mers_of_sortkeys,
    sortkey_of_mers,
)
from jellyfish_tpu_torch.ops.count import consolidate_premasked
from jellyfish_tpu_torch.ops.mers import encode_codes, extract_mers_phased
from jellyfish_tpu_torch.store import SortedCountStore
from jellyfish_tpu_torch.trace import Trace

__all__ = ["MerCounter", "ceil_log2"]


def ceil_log2(x: int) -> int:
    return max(0, (int(x) - 1).bit_length())


def _chunk_pipeline(chunk_u8, masks, k, lsize, canonical):
    """ASCII chunk [L] uint8 -> (premasked sortkey columns [16*Mp, Wk],
    n_valid scalar)."""
    mers, valid = extract_mers_phased(encode_codes(chunk_u8), k, canonical)
    return premasked(mers, valid, masks, k, lsize)


def _sortkey_order_view(rows: np.ndarray) -> np.ndarray:
    """1-D order-preserving comparable view of sortkey rows [n, W] uint32
    (columns LSW..MSW): u64 for W <= 2, big-endian memcmp bytes beyond."""
    n, W = rows.shape
    if W == 1:
        return rows[:, 0]
    if W == 2:
        return np.ascontiguousarray(rows).view(np.uint64).ravel()
    be = np.ascontiguousarray(rows[:, ::-1]).byteswap()
    return np.ascontiguousarray(be).view(f"V{4 * W}").ravel()


class MerCounter:
    """Accumulates k-mer counts from packed sequence chunks.

    `size` plays the reference's -s role: it fixes lsize =
    ceil(log2(size)) and hence the hash matrix shape and the dump order.
    If size >= 4^k the identity matrix is used
    (large_hash_array.hpp:997-1001). `device` None means the GPU, and
    raises when there is none; pass device="cpu" to run on the CPU.
    `mer_filter` (bloom.load_count_filter) maps each ASCII chunk's
    (distinct mers [n, W], counts [n]) to new counts, the batch
    equivalent of the reference's filter chain (count_main.cc:99-131).
    pack_resting holds the store's resting runs bit-packed
    (`count --packed-store`). Keys of any width run on the kernels, up to
    kernels/merge_path.MAX_KEY_COLS 32-bit limbs (k <= 116,176); a wider k
    raises ValueError.
    """

    def __init__(
        self,
        k: int,
        size: int,
        canonical: bool = False,
        matrix: GF2Matrix | None = None,
        rng: np.random.Generator | None = None,
        device=None,
        mer_filter=None,
        pack_resting: bool = False,
    ):
        self.k = int(k)
        c = 2 * self.k
        self.W = mw.nwords(c)
        if self.W > MAX_KEY_COLS:
            raise ValueError(
                f"k = {self.k}: keys of {self.W} 32-bit limbs, and the "
                f"kernels take at most {MAX_KEY_COLS} (k <= "
                f"{16 * MAX_KEY_COLS})"
            )
        self.device = resolve_device(device)
        # the table size rounds up to a power of two, so the identity
        # regime starts as soon as the ROUNDED size reaches 4^k
        if c <= 64 and ceil_log2(size) >= c:
            self.lsize = c
            self.size = 1 << c
            self.matrix = matrix if matrix is not None else GF2Matrix.identity(c)
            if not self.matrix.is_low_identity():
                raise ValueError("size >= 4^k requires the identity matrix")
        else:
            self.lsize = max(1, min(ceil_log2(size), 64 if c > 64 else c))
            self.size = 1 << self.lsize
            if matrix is not None:
                self.matrix = matrix
                if matrix.r != self.lsize or matrix.c != c:
                    raise ValueError(
                        f"matrix is {matrix.r}x{matrix.c}, need {self.lsize}x{c}"
                    )
            else:
                rng = rng or np.random.default_rng()
                self.matrix = GF2Matrix.random_invertible(self.lsize, c, rng)
        self.canonical = bool(canonical)

        if self.matrix.is_identity() or (
            self.matrix.is_low_identity() and self.lsize == c
        ):
            self._A = None
            self._Ainv = None
        else:
            self._A = masks_of_matrix(self.matrix, self.W)
            self._Ainv = inverse_masks_of_matrix(self.matrix, self.W)
        self._tables = route_tables(self._A, self.k, self.device)
        self._pad = mw.pad_key(self.W)
        self.trace = Trace()
        self.store = SortedCountStore(self.W, self.device, key_bits=c,
                                      pack_resting=pack_resting,
                                      trace=self.trace)
        self.mer_filter = mer_filter
        self._restrict_store: SortedCountStore | None = None

    # -- ingestion ------------------------------------------------------------

    def _words(self, x) -> torch.Tensor:
        """Packed 32-bit words (numpy uint32, or a tensor of int32 bit
        patterns or int64 word values) -> a tensor on the device: numpy's
        words as int32 bit patterns, copied as they are."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(x).to(self.device)

    def packed_sortkeys(self, pwords, validbits):
        """B equal-length host-packed chunks (L >= k) -> (premasked
        sortkey columns [B * 16 * Mp, Wk], n_valid scalar) on the device,
        by kernels/sortkeys.sortkeys on the route it picks. The `pipeline`
        span counts the rows (`rows`) and those the kernel wrote
        (`fused_rows`)."""
        with self.trace.span("pipeline") as span:
            keys, n_valid = sortkeys(
                self._words(pwords), self._words(validbits), self.k,
                self.lsize, self.canonical, self._A, self._tables)
            n = keys.shape[0]
            span.add("rows", n)
            span.add("fused_rows", n if runs_kernel(self.k, keys.device)
                     else 0)
            return keys, n_valid

    def chunk_sortkeys(self, chunk_u8):
        """An ASCII chunk (uint8, host or device; L >= k) -> (premasked
        sortkey columns [16 * Mp, Wk], n_valid scalar) on the device, in
        plain PyTorch."""
        if isinstance(chunk_u8, torch.Tensor):
            chunk = chunk_u8.to(device=self.device, dtype=torch.uint8)
        else:
            chunk = torch.from_numpy(
                np.ascontiguousarray(chunk_u8, dtype=np.uint8)).to(self.device)
        return _chunk_pipeline(chunk, self._A, self.k, self.lsize,
                               self.canonical)

    def masked_run(self, sk, n_valid):
        """Premasked sortkey columns [N, Wk] and their valid count (as
        packed_sortkeys and chunk_sortkeys give them) -> their distinct
        keys with their counts, as a masked run (sorted; each count on its
        segment's last row, 0 on the others). The PAD segment's count is
        corrected by the pad rows, so it holds 0, or the true count when a
        real mer's sortkey is the PAD key."""
        keys, counts = consolidate_premasked(sk)
        # remove the PAD inflation: the last sorted row always ends the
        # final (PAD or maximal) segment, and pads = N - n_valid
        pads = sk.shape[0] - n_valid
        counts[-1] -= pads
        return keys, counts

    def mers_of_keys(self, keys) -> torch.Tensor:
        """Store key columns [n, Wk] -> mer limbs [n, W] on the device."""
        return mers_of_sortkeys(mw.limbs_of_key_columns(keys, self.W),
                                self._Ainv, self.k, self.lsize)

    def add_chunks_packed_batch(self, pwords, validbits) -> None:
        """Count the k-mers of B equal-length host-packed chunks:
        pwords [B, L/16], validbits [B, ceil(L/32)] (see
        SequenceChunker.chunks_packed). Chunks are independent: no window
        crosses from one to the next."""
        if int(pwords.shape[-1]) * 16 < self.k:
            return
        self.store.insert_raw(*self.packed_sortkeys(pwords, validbits))

    def add_chunk_packed(self, pwords, validbits) -> None:
        """One host-packed chunk: pwords [L/16], validbits [ceil(L/32)]."""
        self.add_chunks_packed_batch(self._words(pwords)[None],
                                     self._words(validbits)[None])

    def chunk_counts(self, chunk_u8):
        """An ASCII chunk's distinct mers: (sortkey columns [n, Wk] as a
        masked run, mer limbs [n, W], counts [n]); rows of count 0 are no
        mer (bc inserts them with weight 0, the filters skip them)."""
        keys, counts = self.masked_run(*self.chunk_sortkeys(chunk_u8))
        return keys, self.mers_of_keys(keys), counts

    def add_chunk(self, chunk_u8) -> None:
        """Count the k-mers of a chunk of ASCII sequence (uint8, host or
        device). Reads are separated by non-ACGT bytes; chunks of one
        stream overlap by k-1 bytes (the parser guarantees both)."""
        if len(chunk_u8) < self.k:
            return
        if self.mer_filter is not None:
            with self.trace.span("pipeline"):
                keys, mers, counts = self.chunk_counts(chunk_u8)
            self.store.insert_run(keys, self.mer_filter(mers, counts))
        else:
            with self.trace.span("pipeline"):
                keys, n_valid = self.chunk_sortkeys(chunk_u8)
            self.store.insert_raw(keys, n_valid)

    def add_mers_np(self, mers_int_iterable, value: int = 1) -> None:
        """Add explicit mers (python ints), each with weight `value`: their
        sortkeys, sorted and counted on the device, go to the store as a
        counted run."""
        mers = list(mers_int_iterable)
        if not mers:
            return
        limbs = mw.from_ints(mers, self.W, self.device)
        sk = sortkey_of_mers(limbs, self._A, self.k, self.lsize)
        keys, counts = consolidate_premasked(mw.key_columns(sk).contiguous())
        self.store.insert_run(keys, counts * int(value))

    def restrict_to(self, chunks_iter) -> None:
        """`count --if` (count_main.cc:288-295, PRIME then UPDATE): after
        counting, only the mers of these ASCII chunks appear in the output,
        each with its count, 0 if it was never counted. reset() keeps the
        restriction, so every --disk partial is restricted too."""
        store = self.open_restriction()
        for chunk_u8 in chunks_iter:
            if len(chunk_u8) >= self.k:
                store.insert_raw(*self.chunk_sortkeys(chunk_u8))

    def open_restriction(self) -> SortedCountStore:
        """A new, empty restriction store (raw or counted runs of store
        keys): from now on finalize_np yields only the mers inserted into
        it, each with its count or 0, as restrict_to does."""
        self._restrict_store = SortedCountStore(self.W, self.device,
                                                key_bits=2 * self.k,
                                                trace=self.trace)
        return self._restrict_store

    # -- extraction -----------------------------------------------------------

    def _to_host(self, t, dtype) -> np.ndarray:
        """A finalize output copied to the host and converted to dtype,
        as one `finalize.to_host` span."""
        with self.trace.span("finalize.to_host",
                             bytes=t.numel() * t.element_size()):
            return t.cpu().numpy().astype(dtype)

    def _corrected(self, store):
        """Finalize `store`: (key columns [n, Wk] on the device, counts [n]
        uint64 on the host), the PAD entry's pad rows removed and the entry
        dropped if that leaves it at 0; a dropped entry is not copied."""
        with self.trace.span("finalize.merge") as span:
            keys, counts, pads = store.finalize()
            span.add("pads", pads)
        pad_count = 0
        if pads and len(counts) and bool((keys[-1] == self._pad).all()):
            # the PAD entry holds the pad rows, plus one real mer if one
            # maps to the PAD key (the sortkey is a bijection)
            pad_count = int(counts[-1])
            if pad_count < pads:
                raise AssertionError(
                    "pad accounting mismatch: PAD entry holds "
                    f"{pad_count} < {pads} pads"
                )
            if pad_count == pads:
                keys, counts = keys[:-1], counts[:-1]
        counts = self._to_host(counts, np.uint64)
        if pad_count > pads:
            counts[-1] -= np.uint64(pads)
        return keys, counts

    def _empty(self):
        return (np.zeros((0, self.W), dtype=np.uint32),
                np.zeros(0, dtype=np.uint64))

    def _recovered(self, keys) -> torch.Tensor:
        with self.trace.span("finalize.recover"):
            return self.mers_of_keys(keys)

    def _mers_np(self, keys) -> np.ndarray:
        return self._to_host(self._recovered(keys), np.uint32)

    def finalize_np(self, mer_filter=None):
        """Return (mer limbs [n, W] uint32, counts [n] uint64) in hash
        order (the reference's dump order: ascending (pos, key)).
        `mer_filter` (as the constructor's, on this counter's device), when
        given, maps the table's (mers, counts) to new counts here, once per
        mer: a mer it zeroes is dropped, or dumped at 0 when the
        restriction allows it."""
        with self.trace.span("finalize"):
            keys, counts = self._corrected(self.store)
            if mer_filter is not None and len(counts):
                counts = self._to_host(mer_filter(
                    self._recovered(keys),
                    torch.from_numpy(counts.astype(np.int64)).to(keys.device),
                ), np.uint64)
            if self._restrict_store is not None:
                # before the emptiness check: an empty count still dumps
                # the allowed mers at 0
                return self._apply_restriction(keys, counts)
            if mer_filter is not None:
                keep = counts > 0
                keys = keys[torch.from_numpy(keep).to(keys.device)]
                counts = counts[keep]
            if len(counts) == 0:
                return self._empty()
            return self._mers_np(keys), counts

    def _apply_restriction(self, keys, counts):
        """--if output: the allowed mers in their hash order, each with its
        count in (keys, counts) or 0 (the reference PRIMEs the allowed mers
        at 0 before counting, so unseen ones dump at 0). Both runs are in
        hash order under one matrix: one binary search on the host."""
        akeys, _ = self._corrected(self._restrict_store)
        if akeys.shape[0] == 0:
            return self._empty()
        out = np.zeros(akeys.shape[0], dtype=np.uint64)
        if len(counts):
            def view(cols):
                limbs = mw.limbs_of_key_columns(cols, self.W)
                return _sortkey_order_view(self._to_host(limbs, np.uint32))

            kv, av = view(keys), view(akeys)
            pos = np.minimum(np.searchsorted(kv, av), len(kv) - 1)
            out = np.where(kv[pos] == av, counts[pos], np.uint64(0))
        return self._mers_np(akeys), out

    def finalize(self):
        """Return (mers [n] object ints, counts [n] uint64) in hash order
        (scripting convenience over finalize_np)."""
        mers, counts = self.finalize_np()
        if len(counts) == 0:
            return np.zeros(0, dtype=object), counts
        return mw.to_ints(mers), counts

    def reset(self) -> None:
        """End the job: the store empties and the trace appends the job's
        summary."""
        self.store.reset()
        self.trace.end_job()
