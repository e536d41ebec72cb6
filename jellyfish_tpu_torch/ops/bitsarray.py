"""Generic n-bits-per-entry device array (atomic_bits_array analogue); the
counterpart of jellyfish_tpu/ops/bitsarray.py.

The reference's `atomic_bits_array` (atomic_bits_array.hpp:83-97) packs
`size` entries of `bits` bits each into machine words (entries never
straddle words: 32 // bits entries a 32-bit word) and mutates them with
per-entry CAS loops. Here a batch of (id, value) pairs is applied at once,
with the result of applying the pairs one after another in batch order:
the last value wins for `set`, `fetch_or` and `fetch_max` are order-free.

Conflicts are resolved as in the JAX package: the pairs are sorted by (id,
position in the batch) with the values carried, which is the pair sort of
kernels/sort.py (kernel-table rows 6, 8 and 12; keys of two columns, the
id most significant), then segment folds and one gather and scatter over
the touched words only, in plain torch. Words are int64 tensors holding
32-bit values; `to_bytes` is the little-endian word dump of the
reference's mmap-backed variant (atomic_bits_array.hpp:146-165).
"""

from __future__ import annotations

import numpy as np
import torch

from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.kernels.sort import sort_pairs_bitonic
from jellyfish_tpu_torch.ops.multiword import M32

__all__ = ["BitsArray"]

_W = 32  # container word bits


def _fold(seg, vals, op):
    """Fold each run of equal `seg` values into the run's last row: log2(n)
    doubling steps, each combining a row with the row d before it when
    both lie in one run."""
    n = seg.shape[0]
    idx = torch.arange(n, device=seg.device)
    d = 1
    while d < n:
        same = (idx >= d) & (seg == seg.roll(d))
        vals = op(vals, torch.where(same, vals.roll(d), 0))
        d *= 2
    return vals


def _is_last(x):
    last = torch.ones_like(x, dtype=torch.bool)
    last[:-1] = x[1:] != x[:-1]
    return last


def _apply_batch(data, ids, vals, bits: int, op: str, size: int):
    """Apply a batch of (id, value) updates to the packed words; op 'set'
    (the batch-order-last value of an id wins), 'or' or 'max'. Ids >= size
    are dropped, letting callers pad batches. Returns the new words."""
    n = ids.shape[0]
    if n == 0:
        return data
    epw = _W // bits
    mask = (1 << bits) - 1
    vals = vals & mask

    # the batch-order-last value of each id lands at its segment's end
    seq = torch.arange(n, device=ids.device)
    skeys, sval = sort_pairs_bitonic(torch.stack([seq, ids], 1), vals)
    sid = skeys[:, 1]
    if op == "or":
        sval = _fold(sid, sval, torch.bitwise_or)
    elif op == "max":
        sval = _fold(sid, sval, torch.maximum)
    live = sid < size
    is_last_id = _is_last(sid) & live

    # per word: after the id fold the fields of distinct ids in one word
    # are disjoint, so the update is (old & ~OR(masks)) | OR(values);
    # dropped ids get a word index past the end of their own
    n_words = data.shape[0]
    q = torch.where(live, sid // epw, n_words)
    off = (sid % epw) * bits
    m_bits = _fold(q, torch.where(is_last_id, mask << off, 0),
                   torch.bitwise_or)
    v_bits = _fold(q, torch.where(is_last_id, sval << off, 0),
                   torch.bitwise_or)
    widx = torch.where(_is_last(q) & live, q, n_words)

    padded = torch.cat([data, data.new_zeros(1)])  # slot n_words: discarded
    old = padded[widx]
    if op == "or":
        new = old | v_bits
    elif op == "max":
        # per-entry max needs entry-aligned comparison: field by field
        new = old
        for e in range(epw):
            fm = mask << (e * bits)
            upd = torch.maximum(old & fm, v_bits & fm)
            new = torch.where((m_bits & fm) != 0, (new & (fm ^ M32)) | upd,
                              new)
    else:
        new = (old & (m_bits ^ M32)) | v_bits
    padded[widx] = new
    return padded[:n_words]


class BitsArray:
    """Packed array of `size` entries of `bits` bits on the device.

    Batched mutators mirror atomic_bits_array's element_proxy semantics:
    `set` = sequential stores (last in batch order wins), `fetch_or` /
    `fetch_max` = the commutative CAS loops the bloom structures use.
    `device` None means the GPU; reads return host numpy arrays.
    """

    def __init__(self, bits: int, size: int, device=None):
        if not 1 <= bits <= _W:
            raise ValueError("bits per entry must be in [1, 32]")
        self.bits = int(bits)
        self.size = int(size)
        self.entries_per_word = _W // self.bits
        self.device = resolve_device(device)
        n_words = (self.size + self.entries_per_word - 1) \
            // self.entries_per_word
        self.data = torch.zeros(n_words, dtype=torch.int64,
                                device=self.device)

    def _col(self, x) -> torch.Tensor:
        """ids or values as int64 32-bit words on the device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x).astype(np.int64))
        return x.to(device=self.device, dtype=torch.int64).reshape(-1) & M32

    def _apply(self, ids, vals, op: str) -> None:
        self.data = _apply_batch(self.data, self._col(ids), self._col(vals),
                                 self.bits, op, self.size)

    def set(self, ids, vals) -> None:
        self._apply(ids, vals, "set")

    def fetch_or(self, ids, vals) -> None:
        self._apply(ids, vals, "or")

    def fetch_max(self, ids, vals) -> None:
        self._apply(ids, vals, "max")

    def get(self, ids) -> np.ndarray:
        """Entries at `ids` (0 past the end), uint32."""
        ids = self._col(ids)
        q = ids // self.entries_per_word
        off = (ids % self.entries_per_word) * self.bits
        padded = torch.cat([self.data, self.data.new_zeros(1)])
        words = padded[q.clamp(max=self.data.shape[0])]
        vals = (words >> off) & ((1 << self.bits) - 1)
        return vals.cpu().numpy().astype(np.uint32)

    def __getitem__(self, pos: int) -> int:
        return int(self.get(np.asarray([pos]))[0])

    def values(self) -> np.ndarray:
        """All entries, host-side (the reference's input iterator)."""
        words = self.data.cpu().numpy().astype(np.uint32)
        offs = (np.arange(self.entries_per_word, dtype=np.uint32)
                * self.bits)[None, :]
        vals = (words[:, None] >> offs) & np.uint32((1 << self.bits) - 1)
        return vals.reshape(-1)[: self.size]

    # -- persistence (mmap-backed variant parity) --------------------------

    def to_bytes(self) -> bytes:
        return self.data.cpu().numpy().astype("<u4").tobytes()

    @classmethod
    def from_bytes(cls, bits: int, size: int, raw: bytes,
                   device=None) -> "BitsArray":
        a = cls(bits, size, device)
        words = np.frombuffer(raw, dtype="<u4").astype(np.int64)
        if words.shape[0] != a.data.shape[0]:
            raise ValueError("byte length does not match bits/size")
        a.data = torch.from_numpy(words).to(a.device)
        return a
