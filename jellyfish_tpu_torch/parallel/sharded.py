"""`count -d N`: the table sharded by hash prefix over several devices of
one process (the counterpart of jellyfish_tpu/parallel/sharded.py).

Shard p of P owns the sortkeys whose top B = min(16, 2k) bits t give
floor(t * P / 2^B) = p (`_owner_of_sortkeys`). The map is monotone in the
sortkey, so shard p holds one contiguous range of the global hash order
for any P, and the dump is the shards' outputs concatenated in shard
order.

A step takes one chunk per shard. On its shard's device each chunk runs
the single-device pipeline (counter.py) and is deduplicated there: sorted
and counted by segment length (ops/count.consolidate_premasked), its PAD
segment corrected by the pad rows, the mer filter applied to its distinct
mers when there is one, and compacted by K2. The sorted run is cut into
one contiguous segment per owner, each segment moves to its owner's
device (`.to()`, no copy when shards share a card) and enters the owner's
store as a counted run (`SortedCountStore.insert_run`). Because the chunk
is deduplicated first, repeats (homopolymers, satellites) cost one row a
distinct mer, however often they occur.

PyTorch has dynamic shapes, so each segment is cut at its exact length:
one host read of the P x P segment lengths a step. The JAX package's
per-destination capacity (`_exchange_cap`), its overflow flag and the
masked replay that recovers from it (`_note_step`,
`_resolve_overflow_ring`, `_masked_step`, `compact_exchange=False`) exist
only because XLA needs static shapes, and have no counterpart here.
Neither have its batched packed runs (each shard's store packs its own
runs) nor its replicated device filters (the port's filters already live
on a device).

Each shard is a MerCounter on its device with the counter's hash matrix;
its store and, with `restrict_to`, its restriction store receive only
counted runs, so they hold no pad rows. With a mer filter (`count --bc`,
`--bf-size`) each chunk's distinct mers are filtered on their sender,
in chunk order (shard 0's chunk, then shard 1's, ...), by the same filter
object the single-device count uses, on the first shard's device: the
chunks reach a stateful `--bf-size` filter in stream order, so `-d
--bf-size` writes the single-device count's records.

Across processes (`count --coordinator`, parallel/multihost.py) the
counter takes a process group. `mesh` is then this process's local
shards, and the shards are numbered process-major: the global P is the
sum of the ranks' local counts, gathered once at construction, and rank r
owns one contiguous range of shard ids, so the ranks' segments in rank
order are the global hash order. lsize and the owner map use the global
P. Every step is then collective, at any world size, a world of 1
included: one all_gather of each rank's [local, P] segment lengths (padded
to the largest local count) gives the P x P matrix, read on the host once
a step; one all_to_all_single moves each sender's rows for each rank,
keys and counts in one [n, Wk + 1] int64 tensor staged on the process's
first shard device (NCCL needs the rank's current device); each received
(sender, owner) segment, in global sender order, goes to its owner's
device by `.to()` and into its store by insert_run, as in one process. A
rank with no input left takes part in a step with empty runs
(`empty_step`), and `--if`'s prime pass runs in lockstep on one int flag a
round (`any_rank`). The store bytes that decide a `--disk` spill are
summed over the ranks, so every rank spills on the same step. With more
than one process a mer filter applies at finalize, once per mer, on its
owner shard: each process's `--bf-size` filter is its own, so only the
owner can filter each mer exactly once. A world of 1 keeps the
in-process placement, on the sender in stream order.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from jellyfish_tpu_torch.counter import (
    MerCounter,
    _chunk_pipeline_dedup,
    _dedup,
    _recover_mers,
    ceil_log2,
)
from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.kernels.compact import compact
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.store import SortedCountStore

__all__ = ["ShardedMerCounter", "make_mesh"]


def make_mesh(n_shards: int | None = None, devices=None) -> tuple:
    """The shards' devices, a tuple of torch.device.

    devices None: the visible CUDA devices (raises when there is none),
    the first n_shards of them. One device (a str or torch.device): that
    device n_shards times (default once); `make_mesh(8, "cpu")` puts 8
    shards on the CPU. A sequence: its devices, the first n_shards of
    them; a device may repeat, and shards then share it."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (1 if n_shards is None else int(n_shards))
    mesh = tuple(resolve_device(d) for d in devices)
    if n_shards is not None:
        if int(n_shards) > len(mesh):
            raise ValueError(f"{n_shards} shards on {len(mesh)} devices")
        mesh = mesh[:int(n_shards)]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _owner_of_sortkeys(keys, k: int, n_shards: int):
    """Owner shard of each row of store key columns [n, Wk]: the top B =
    min(16, 2k) bits t of the 2k-bit sortkey range-mapped onto [0, P) by
    floor(t * P / 2^B), monotone in the sortkey for any P. The key
    columns are turned into limbs first (a packed column is the u64 with
    its top bit flipped). PAD's all-ones limbs exceed 2^B - 1 when 2k is
    not a multiple of 32: clamped, so PAD, like a real all-ones sortkey,
    maps to P - 1. The exchange routes compacted runs, in which a PAD row
    is left only when a real mer's sortkey is the PAD key, so no pad row
    reaches a shard."""
    c = 2 * k
    B = min(16, c)
    limbs = mw.limbs_of_key_columns(keys, mw.nwords(c))
    top = mw.mw_shift_right(limbs, c - B, W_out=1)[:, 0]
    top = torch.clamp(top, max=(1 << B) - 1)
    return (top * n_shards) >> B


class _ShardedStore:
    """The shards' stores, one SortedCountStore on each shard's device:
    `count --disk` spills on the sum of their bytes and resets them all.
    With a process group the sum is over every rank's shards (one
    all_reduce, a collective every rank makes)."""

    def __init__(self, stores, group=None, device=None):
        self.stores = list(stores)
        self.group = group
        self.device = device

    def device_bytes(self) -> int:
        n = sum(s.device_bytes() for s in self.stores)
        if self.group is None:
            return n
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, group=self.group)
        return int(t.item())

    def reset(self) -> None:
        for s in self.stores:
            s.reset()


class ShardedMerCounter:
    """Hash-prefix sharded k-mer counter over a mesh of devices (see the
    module docstring): MerCounter's semantics and dump order, the table
    split across the shards.

    `mesh` is a sequence of devices (make_mesh), repeats allowed; None
    means every visible CUDA device. `device`, when given, puts every
    shard on that device (device="cpu" runs on the CPU, with as many
    shards as `mesh` has, one by default). lsize = max(ceil(log2(P)),
    min(ceil(log2(size)), 2k, 64)), as in the JAX package: when `size`
    is below P this gives another matrix than the single-device count's.
    `mer_filter` (bloom.load_count_filter) runs on the first shard's
    device. `group` (a torch.distributed process group, such as
    dist.group.WORLD once multihost.init_multihost has run) makes this one
    process's part of a counter across processes: `mesh` is then its
    local shards, and every step is a collective of the group."""

    def __init__(
        self,
        k: int,
        size: int,
        mesh=None,
        canonical: bool = False,
        matrix: GF2Matrix | None = None,
        rng: np.random.Generator | None = None,
        mer_filter=None,
        pack_resting: bool = False,
        device=None,
        group=None,
    ):
        if mesh is None:
            self.mesh = make_mesh(devices=device)
        elif device is not None:
            self.mesh = make_mesh(len(mesh), device)
        else:
            self.mesh = make_mesh(devices=mesh)
        self.n_local = len(self.mesh)
        self.device = self.mesh[0]
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
            local_counts = [self.n_local]
        else:
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            n = torch.tensor([self.n_local], dtype=torch.int64,
                             device=self.device)
            got = [torch.empty_like(n) for _ in range(self.world)]
            dist.all_gather(got, n, group=group)
            local_counts = torch.cat(got).tolist()
        # rank r's shards are the global ids first[r] .. first[r + 1] - 1
        self._local_counts = local_counts
        self._first = [0, *itertools.accumulate(local_counts)]
        self.first_shard = self._first[self.rank]
        self.n_shards = self._first[-1]
        self.k = int(k)
        c = 2 * self.k
        self.W = mw.nwords(c)
        self._Wk = 1 if mw.packs(self.W) else self.W
        self.lsize = max(ceil_log2(self.n_shards),
                         min(ceil_log2(size), c if c <= 64 else 64), 1)
        self.size = 1 << self.lsize
        self.canonical = bool(canonical)
        if matrix is not None:
            if matrix.r != self.lsize or matrix.c != c:
                raise ValueError(
                    f"matrix is {matrix.r}x{matrix.c}, need {self.lsize}x{c}"
                )
            self.matrix = matrix
        elif self.lsize == c:
            self.matrix = GF2Matrix.identity(c)
        else:
            rng = rng or np.random.default_rng()
            self.matrix = GF2Matrix.random_invertible(self.lsize, c, rng)
        self.shards = [
            MerCounter(self.k, self.size, canonical=self.canonical,
                       matrix=self.matrix, device=d,
                       pack_resting=pack_resting)
            for d in self.mesh
        ]
        self.store = _ShardedStore((s.store for s in self.shards),
                                   group=group, device=self.device)
        self.mer_filter = mer_filter
        # on the sender in stream order, or at finalize across processes
        self._ingest_filter = mer_filter if self.world == 1 else None

    # -- ingestion ------------------------------------------------------------

    def _check_rows(self, x) -> None:
        if x.ndim != 2 or x.shape[0] != self.n_local:
            raise ValueError(f"expected [{self.n_local}, ...] rows, one "
                             f"chunk per local shard; got {tuple(x.shape)}")

    def add_chunks(self, chunks) -> None:
        """Count [local, L] uint8 ASCII chunks (host or device), one per
        local shard. Chunk semantics are MerCounter.add_chunk's: separator
        bytes between reads, k-1 overlap between consecutive chunks of one
        stream."""
        self._check_rows(chunks)
        runs = self._ascii_runs(chunks) if chunks.shape[1] >= self.k else []
        self._send(runs, self.store.stores, self._ingest_filter)

    def add_chunks_packed(self, pwords, validbits) -> None:
        """Count host-packed chunks, one per local shard: pwords
        [local, L/16] and validbits [local, ceil(L/32)]
        (SequenceChunker.chunks_packed)."""
        self._check_rows(pwords)
        self._check_rows(validbits)
        runs = []
        if int(pwords.shape[1]) * 16 >= self.k:
            runs = [
                _dedup(*s.packed_sortkeys(pwords[p:p + 1],
                                          validbits[p:p + 1]))
                for p, s in enumerate(self.shards)
            ]
        self._send(runs, self.store.stores, self._ingest_filter)

    def empty_step(self) -> None:
        """Take part in one step with no input: a rank that has run out of
        input while others still count (a no-op in one process)."""
        self._send([], self.store.stores, None)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank: one all_reduce of a
        fixed-shape int flag, a collective every rank makes (`flag`
        itself in one process). The lockstep loops agree through it
        whether anyone still has input."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def restrict_to(self, chunks_iter) -> None:
        """`count --if` (count_main.cc:288-295, PRIME then UPDATE): the
        allowed mers of these ASCII chunks, one chunk a local shard a step
        (of any lengths), go through the same exchange into a restriction
        store on each shard, so every allowed mer lands on the shard that
        owns it in the table. Each shard's finalize then dumps its allowed
        mers, each with its count or 0. reset() keeps the restriction.
        Across processes each rank gives its own chunks and the rounds run
        in lockstep (any_rank): the restriction is the union of every
        rank's chunks."""
        stores = []
        for s in self.shards:
            s._restrict_store = SortedCountStore(self.W, s.device,
                                                 key_bits=2 * self.k)
            stores.append(s._restrict_store)
        chunks = (c for c in chunks_iter if len(c) >= self.k)
        while True:
            batch = list(itertools.islice(chunks, self.n_local))
            if not self.any_rank(bool(batch)):
                break
            self._send(self._ascii_runs(batch), stores, None)

    def _ascii_runs(self, chunks):
        """ASCII chunk p deduplicated on shard p's device, for each of the
        (at most local) chunks."""
        return [
            _chunk_pipeline_dedup(self.shards[p]._chunk(c),
                                  self.shards[p]._A, self.k, self.lsize,
                                  self.canonical)
            for p, c in enumerate(chunks)
        ]

    def _send(self, runs, stores, mer_filter) -> None:
        """The exchange. runs[p] is local sender p's deduplicated chunk, a
        masked run on mesh[p]. A mer filter, when given, decides on its
        distinct mers, sender by sender. K2 compacts each run; its segment
        of each owner q is inserted into owner q's store."""
        exact = []
        for p, (keys, counts) in enumerate(runs):
            if mer_filter is not None:
                mers = _recover_mers(keys, self.shards[p]._Ainv, self.k,
                                     self.lsize, self.W)
                counts = mer_filter(
                    mers.to(self.device), counts.to(self.device)
                ).to(keys.device)
            exact.append(compact(keys, counts)[:2])
        if self.group is not None:
            self._exchange(exact, stores)
            return
        if not exact:
            return
        # one host read: the senders' segment lengths, by owner
        lengths = torch.stack([
            torch.bincount(_owner_of_sortkeys(keys, self.k, self.n_shards),
                           minlength=self.n_shards).to(self.device)
            for keys, _ in exact
        ]).tolist()
        for (keys, counts), row in zip(exact, lengths):
            off = 0
            for q, n in enumerate(row):
                if n:
                    dev = self.mesh[q]
                    stores[q].insert_run(keys[off:off + n].to(dev),
                                         counts[off:off + n].to(dev))
                off += n

    def _exchange(self, exact, stores) -> None:
        """The exchange across the group's processes (module docstring):
        exact[p] is local sender p's compacted (keys, counts)."""
        P, dev, Wk = self.n_shards, self.device, self._Wk
        first, r = self._first, self.rank
        lens = torch.zeros((max(self._local_counts), P), dtype=torch.int64,
                           device=dev)
        for p, (keys, _) in enumerate(exact):
            lens[p] = torch.bincount(_owner_of_sortkeys(keys, self.k, P),
                                     minlength=P).to(dev)
        got = [torch.empty_like(lens) for _ in range(self.world)]
        dist.all_gather(got, lens, group=self.group)
        # the step's one host read: lengths[s, p, q], rank s's sender p
        # to owner q
        lengths = torch.stack(got).cpu().numpy()
        # each sender's run is sorted, and owners are ranges of it: its
        # rows for rank d's owners are one contiguous slice
        ends = np.cumsum(lengths[r], axis=1)
        send, in_splits = [], []
        for d in range(self.world):
            lo, hi = first[d], first[d + 1]
            n_d = 0
            for p, (keys, counts) in enumerate(exact):
                a = int(ends[p, lo - 1]) if lo else 0
                b = int(ends[p, hi - 1])
                if b > a:
                    send.append(torch.cat(
                        [keys[a:b], counts[a:b, None]], 1).to(dev))
                n_d += b - a
            in_splits.append(n_d)
        send = (torch.cat(send) if send else
                torch.zeros((0, Wk + 1), dtype=torch.int64, device=dev))
        mine = lengths[:, :, first[r]:first[r + 1]]
        out_splits = [int(mine[s].sum()) for s in range(self.world)]
        recv = torch.empty((sum(out_splits), Wk + 1), dtype=torch.int64,
                           device=dev)
        dist.all_to_all_single(recv, send, out_splits, in_splits,
                               group=self.group)
        # rank s sent, sender by sender, its rows for each of our owners
        off = 0
        for s in range(self.world):
            for p in range(self._local_counts[s]):
                for q, n in enumerate(mine[s, p].tolist()):
                    if n:
                        seg = recv[off:off + n].to(self.mesh[q])
                        stores[q].insert_run(seg[:, :Wk], seg[:, Wk])
                    off += n

    # -- extraction -----------------------------------------------------------

    def _shard_np(self, s):
        """Shard s's (mer limbs [n, W] uint32, counts [n] uint64), the mer
        filter applied here when it was not applied on the senders: once
        per mer, on its owner shard (a mer it zeroes is dropped, or kept
        at 0 when --if allows it, as on one device)."""
        if self.mer_filter is None or self._ingest_filter is not None:
            return s.finalize_np()
        keys, counts = s._corrected(s.store)
        if len(counts):
            mers = _recover_mers(keys, s._Ainv, self.k, self.lsize, self.W)
            counts = self.mer_filter(
                mers.to(self.device),
                torch.from_numpy(counts.astype(np.int64)).to(self.device),
            ).cpu().numpy().astype(np.uint64)
        if s._restrict_store is not None:
            return s._apply_restriction(keys, counts)
        keep = counts > 0
        if not keep.any():
            return s._empty()
        return s._mers_np(keys[torch.from_numpy(keep).to(keys.device)]), \
            counts[keep]

    def finalize_local_np(self):
        """[(global shard id, mer limbs [n, W] uint32, counts [n] uint64),
        ...] for this process's non-empty shards, ascending shard id:
        concatenated in that order over the ranks, they are the global
        hash order."""
        out = []
        for p, s in enumerate(self.shards):
            mers, counts = self._shard_np(s)
            if len(counts):
                out.append((self.first_shard + p, mers, counts))
        return out

    def finalize_np(self):
        """(mer limbs [n, W] uint32, counts [n] uint64) in the global hash
        order (the reference's dump order), as MerCounter.finalize_np.
        Across processes, where other ranks hold shards, this raises: use
        finalize_local_np (multihost.write_local_segments)."""
        if self.world > 1:
            raise RuntimeError(
                "finalize_np needs every shard in this process; use "
                "finalize_local_np per process in a multi-process run")
        parts = self.finalize_local_np()
        if not parts:
            return (np.zeros((0, self.W), dtype=np.uint32),
                    np.zeros(0, dtype=np.uint64))
        return (np.concatenate([m for _, m, _ in parts]),
                np.concatenate([c for _, _, c in parts]))

    def finalize(self):
        """(mers [n] object ints, counts [n] uint64) in hash order
        (scripting convenience over finalize_np)."""
        mers, counts = self.finalize_np()
        if len(counts) == 0:
            return np.zeros(0, dtype=object), counts
        return mw.to_ints(mers), counts

    def reset(self) -> None:
        self.store.reset()
