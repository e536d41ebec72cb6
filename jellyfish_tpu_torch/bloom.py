"""Bloom filter and 2-bit Bloom counter on the GPU (`bc`, `count --bc`,
`count --bf-size`, `query` of a .bc file); the counterpart of
jellyfish_tpu/bloom.py.

Reference design (bloom_common.hpp, bloom_filter.hpp, bloom_counter2.hpp):
double hashing with two random 64 x 2k GF(2) matrices (hash_pair,
mer_dna_bloom_counter.hpp:19-34); probe positions (h0 + i*h1) mod m for i
in [0, nb_hashes); sizes m = opt_m(fpr, n), nb_hashes = opt_k(fpr)
(bloom_common.hpp:61-66). The Bloom counter keeps a saturating {0, 1, 2}
cell per position, packed 5 cells a byte base 3 on disk
(bloom_counter2.hpp:40-43); the Bloom filter one bit per position.

On the device: cells are m uint8 bytes and filter bits m bools, packed
only at the file boundary. The hashes are plain torch
(ops/hashing.gf2_apply_masks; the JAX package's MXU bit-matmul
`gf2_times` is no Pallas kernel), and so are the probe expansion, the
segment sums, the cell update and the check's gather and min. The
counter's insert sorts the (position, weight) pairs by position with the
weight carried by the radix sort (kernels/radix.radix_sort_pairs,
csrc/radix.cu) over the bits a position can hold, then adds each
position's clipped sum once.

Probe arithmetic in int64. For m a power of two up to 2^32 the positions
are (h0 + i*h1) & (m - 1) on the hashes' low words, as in the JAX
package's device path. Otherwise the JAX package takes h0 % m, h1 % m and
(base + i*inc) % m in uint64, the sum and the product wrapping mod 2^64.
Here int64 tensors hold the same 64-bit patterns (their sums and products
wrap alike), and `umod` takes the unsigned remainder of a pattern for any
m < 2^64: a position >= 2^63 comes out negative, as the JAX package's
uint64 -> int64 cast leaves it.

Batch-exactness (as in the JAX package): cell updates are increment-only
and saturate at 2, so min(2, cell + sum(increments)) equals any sequential
interleaving of the reference's per-mer inserts (bloom_counter2.hpp:56-107).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jellyfish_tpu_torch.device import resolve_device
from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.io.header import FileHeader
from jellyfish_tpu_torch.kernels.radix import radix_sort_pairs
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.hashing import gf2_apply_masks, masks_of_matrix

__all__ = [
    "opt_m",
    "opt_k",
    "position_bits",
    "probe_positions",
    "BloomCounter2",
    "BloomFilter",
    "load_count_filter",
    "write_bloom_counter",
    "read_bloom_counter",
]

LOG2 = 0.6931471805599453
LOG2_SQ = 0.4804530139182014
_SIGN = -(1 << 63)  # int64 bit pattern of 2^63


def opt_m(fp: float, n: int) -> int:
    """Bits/cells for n keys at false-positive rate fp (bloom_common.hpp:61-63)."""
    return int(n) * int(round(-math.log(fp) / LOG2_SQ))


def opt_k(fp: float) -> int:
    """Number of hash probes (bloom_common.hpp:64-66)."""
    return int(round(-math.log(fp) / LOG2))


def _random_hash_pair(k: int, rng: np.random.Generator):
    """Two random 64 x 2k matrices (hash_pair<mer_dna> ctor)."""
    m1 = GF2Matrix.random(64, 2 * k, rng)
    m2 = GF2Matrix.random(64, 2 * k, rng)
    return m1, m2


def _uge(a, b):
    """Unsigned a >= b of int64 bit patterns (b a tensor or an int)."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def umod(x, m: int):
    """x % m for the unsigned 64-bit values whose bit patterns the int64
    tensor x holds, 1 <= m < 2^64, as bit patterns. For m >= 2^63, x < 2m:
    one conditional subtraction. Otherwise floor(x / 2) < 2^63 reduces as
    a signed value, and 2 (floor(x / 2) % m) + (x & 1) < 2m <= 2^64 takes
    one more."""
    if m >= 1 << 63:
        p = m - (1 << 64)  # m's bit pattern
        return torch.where(_uge(x, p), x - p, x)
    t = (((x >> 1) & ~_SIGN) % m) * 2 + (x & 1)
    return torch.where(_uge(t, m), t - m, t)


def mod_u64(h, m: int):
    """(lo, hi) 32-bit limbs [..., 2] of unsigned 64-bit values -> value %
    m, 1 <= m < 2^64, as int64 bit patterns."""
    return umod(h[..., 0] | (h[..., 1] << 32), m)


def position_bits(m: int) -> int:
    """The bits of a probe position into m cells for the insert's sort:
    positions lie in [0, m) up to m = 2^63; above, umod's patterns may be
    negative, and all 64 bits are sorted as signed."""
    return max(1, (m - 1).bit_length()) if m <= 1 << 63 else 64


def probe_positions(h0, h1, m: int, nb_hashes: int):
    """[nb_hashes, N] int64 probe positions of the hashes h0, h1, (lo, hi)
    limbs [N, 2], into m cells: the JAX package's (h0 % m + i (h1 % m)) %
    m in uint64, as bit patterns (bloom_counter2.hpp:60-66); for m a power
    of two up to 2^32 the same on the low words."""
    i = torch.arange(nb_hashes, device=h0.device)[:, None]
    if m & (m - 1) == 0 and m <= 1 << 32:
        return (h0[None, :, 0] + i * h1[None, :, 0]) & (m - 1)
    base, inc = mod_u64(h0, m), mod_u64(h1, m)
    return umod(base[None, :] + i * inc[None, :], m)


class _BloomBase:
    """The double-hashing machinery over batches of mers [N, W] (int64
    limb tensors, or numpy uint32)."""

    def __init__(self, m: int, nb_hashes: int, k: int, m1: GF2Matrix,
                 m2: GF2Matrix, canonical: bool = False, device=None):
        self.m = int(m)
        self.nb_hashes = int(nb_hashes)
        self.k = int(k)
        self.m1 = m1
        self.m2 = m2
        self.canonical = bool(canonical)
        self.device = resolve_device(device)
        W = mw.nwords(2 * self.k)
        self._masks = (masks_of_matrix(m1, W), masks_of_matrix(m2, W))

    def _mers(self, mers) -> torch.Tensor:
        if isinstance(mers, torch.Tensor):
            return mers.to(device=self.device, dtype=torch.int64)
        x = np.ascontiguousarray(mers, dtype=np.uint32).astype(np.int64)
        return torch.from_numpy(x).to(self.device)

    def probe_positions(self, mers) -> torch.Tensor:
        """[nb_hashes, N] int64 probe positions (bloom_counter2.hpp:60-66)
        from the two matrix products h0, h1, (lo, hi) limbs [N, 2]."""
        mers = self._mers(mers)
        h0, h1 = (gf2_apply_masks(mers, masks, 2) for masks in self._masks)
        return probe_positions(h0, h1, self.m, self.nb_hashes)


class BloomCounter2(_BloomBase):
    """Saturating {0, 1, >=2} counter (bloom_counter2.hpp): `cells`, m
    uint8 on the device."""

    def __init__(self, m, nb_hashes, k, m1, m2, canonical=False, cells=None,
                 device=None):
        super().__init__(m, nb_hashes, k, m1, m2, canonical, device)
        self.cells = (torch.zeros(self.m, dtype=torch.uint8,
                                  device=self.device)
                      if cells is None else cells.to(self.device))

    @staticmethod
    def size_for(fpr: float, n: int) -> int:
        """The JAX package's m for `from_fpr`: opt_m rounded up to a power
        of two when that is at most 2^32 (the false-positive rate only
        improves; the header records m), else opt_m itself."""
        m = opt_m(fpr, n)
        p2 = 1 << max(1, (m - 1).bit_length())
        return p2 if p2 <= 1 << 32 else m

    @classmethod
    def from_fpr(cls, fpr: float, n: int, k: int,
                 rng: np.random.Generator | None = None, canonical=False,
                 device=None):
        rng = rng or np.random.default_rng()
        m1, m2 = _random_hash_pair(k, rng)
        return cls(cls.size_for(fpr, n), opt_k(fpr), k, m1, m2, canonical,
                   device=device)

    def insert_counts(self, mers, weights) -> None:
        """Insert each mer `weights[i]` times (saturating at 2 per cell):
        drop the rows of weight 0, expand the probes, sort the (position,
        min(weight, 2)) pairs by position (the radix sort over
        position_bits(m)), sum each position's run and add min(sum, 2) to
        its cell, clipped at 2."""
        mers = self._mers(mers)
        if not isinstance(weights, torch.Tensor):
            weights = torch.from_numpy(np.asarray(weights).astype(np.int64))
        w = weights.to(device=self.device, dtype=torch.int64)
        keep = w > 0
        mers, w = mers[keep], w[keep].clamp(max=2)
        n = w.shape[0]
        if n == 0:
            return
        pos = self.probe_positions(mers).reshape(-1, 1)
        wb = w.repeat(self.nb_hashes)  # [nb_hashes n], contiguous
        spos, sw = radix_sort_pairs(pos, wb, position_bits(self.m))
        spos = spos[:, 0]
        is_last = torch.ones_like(spos, dtype=torch.bool)
        is_last[:-1] = spos[1:] != spos[:-1]
        ends = torch.nonzero(is_last).squeeze(1)
        seg = torch.diff(torch.cumsum(sw, 0)[ends], prepend=sw.new_zeros(1))
        upos = spos[ends]
        cells = self.cells[upos].to(torch.int64) + seg.clamp(max=2)
        self.cells[upos] = cells.clamp(max=2).to(torch.uint8)

    def check(self, mers) -> torch.Tensor:
        """Min probed cell per mer, 0, 1 or 2 (bloom_counter2.hpp:109-142):
        uint8 [N] on the device."""
        mers = self._mers(mers)
        if mers.shape[0] == 0:
            return torch.zeros(0, dtype=torch.uint8, device=self.device)
        return self.cells[self.probe_positions(mers)].min(dim=0).values

    def check_int(self, mer_bits: int) -> int:
        return int(self.check(mw.from_ints([mer_bits],
                                           mw.nwords(2 * self.k)))[0])

    # -- base-3 packing (5 cells/byte, bloom_counter2.hpp:40-43) --------------

    def nb_bytes(self) -> int:
        return self.m // 5 + (1 if self.m % 5 else 0)

    def packed_bytes(self) -> np.ndarray:
        """The cells packed 5 a byte, base 3, first cell least
        significant; computed in uint8 on the device (at most 242)."""
        pad = (-self.m) % 5
        v = torch.cat([self.cells, self.cells.new_zeros(pad)]).view(-1, 5)
        b = v[:, 4].clone()
        for j in (3, 2, 1, 0):
            b = b * 3 + v[:, j]
        return b.cpu().numpy()

    @staticmethod
    def unpack_bytes(raw: torch.Tensor, m: int) -> torch.Tensor:
        """Packed bytes (uint8 tensor) -> m cells."""
        digits = [raw]
        for _ in range(4):
            digits.append(digits[-1] // 3)
        return torch.stack([d % 3 for d in digits], 1).reshape(-1)[:m]


class BloomFilter(_BloomBase):
    """1-bit Bloom filter for `count --bf-size` (bloom_filter.hpp:42-75):
    `bits`, m bools on the device."""

    def __init__(self, m, nb_hashes, k, m1, m2, canonical=False, bits=None,
                 device=None):
        super().__init__(m, nb_hashes, k, m1, m2, canonical, device)
        self.bits = (torch.zeros(self.m, dtype=torch.bool, device=self.device)
                     if bits is None else bits.to(self.device))

    @classmethod
    def from_size(cls, m: int, fpr: float, k: int,
                  rng: np.random.Generator | None = None, canonical=False,
                  device=None):
        rng = rng or np.random.default_rng()
        m1, m2 = _random_hash_pair(k, rng)
        return cls(m, opt_k(fpr), k, m1, m2, canonical, device=device)

    def insert_batch(self, mers) -> torch.Tensor:
        """Set the bits of a batch of distinct mers; returns whether each
        was present BEFORE the batch (the filter_bf decision,
        count_main.cc:122-130), bool [N]."""
        mers = self._mers(mers)
        if mers.shape[0] == 0:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        pos = self.probe_positions(mers)
        present = self.bits[pos].all(dim=0)
        self.bits[pos.reshape(-1)] = True
        return present


# -- bloomcounter file format (bc_main.cc:110-124, query_main.cc:99-107) ------


def write_bloom_counter(bc: BloomCounter2, path: str, cmdline=None) -> None:
    h = FileHeader()
    h.canonical = bc.canonical
    h.format = FileHeader.FORMAT_BLOOM
    h.key_len = 2 * bc.k
    h.set_matrix(bc.m1, 1)
    h.set_matrix(bc.m2, 2)
    h.size = bc.m
    h.nb_hashes = bc.nb_hashes
    h.fill_standard()
    if cmdline is not None:
        h.set_cmdline(cmdline)
    with open(path, "wb") as f:
        h.write(f)
        f.write(bc.packed_bytes().tobytes())


def read_bloom_counter(path: str, device=None) -> BloomCounter2:
    with open(path, "rb") as f:
        h = FileHeader.read(f)
        if h.format != FileHeader.FORMAT_BLOOM:
            raise ValueError(
                f"invalid format {h.format!r}, expected 'bloomcounter'")
        m = h.size
        raw = np.frombuffer(f.read(m // 5 + (1 if m % 5 else 0)),
                            dtype=np.uint8)
    dev = resolve_device(device)
    cells = BloomCounter2.unpack_bytes(torch.from_numpy(raw.copy()).to(dev),
                                       m)
    return BloomCounter2(m, h.nb_hashes, h.key_len // 2, h.matrix(1),
                         h.matrix(2), h.canonical, cells, device=dev)


def load_count_filter(*, bc_path=None, bf_size=None, bf_fp=0.01, k=21,
                      canonical=False, rng=None, device=None):
    """Build the count-time mer filter (count_main.cc:99-131 filter chain).

    Returns f(mers [N, W], counts [N]) -> filtered counts, tensors on the
    device; rows of count 0 (the PAD entry, a masked run's other rows) are
    skipped and stay 0.
    """
    if bc_path is not None:
        bc = read_bloom_counter(bc_path, device)
        if bc.k != k:
            raise ValueError("Invalid mer length in bloom filter")

        def filt_bc(mers, counts):
            out = torch.zeros_like(counts)
            sel = counts > 0
            c = counts[sel]
            out[sel] = torch.where(bc.check(mers[sel]) > 1, c, 0)
            return out

        return filt_bc

    bf = BloomFilter.from_size(bf_size, bf_fp, k, rng=rng,
                               canonical=canonical, device=device)

    def filt_bf(mers, counts):
        out = torch.zeros_like(counts)
        sel = counts > 0  # PAD entries must never touch the filter
        c = counts[sel]
        # a mer's first occurrence is the filter's (count - 1); a mer seen
        # in an earlier batch keeps its whole batch count
        out[sel] = torch.where(bf.insert_batch(mers[sel]), c, c - 1)
        return out

    return filt_bf
