"""Vectorized mer extraction from chunks -> [N, W] 2-bit mers.

The counterpart of jellyfish_tpu/ops/mers.py. Two inputs: host-packed
chunks (2-bit codes, 16 per 32-bit word, big-endian within the word, and a
per-base validity bitstream; the count path for chunk lengths that are
multiples of 32), and ASCII chunks encoded on the device (`encode_codes`,
`extract_mers_phased`; the filter modes and other chunk lengths). Every
window of the chunk is materialized at once by funnel reads of the packed
stream at static shifts, one strided subproblem per phase (window start
mod 16). Output order is PHASE-MAJOR (windows of phase 0, then phase 1,
...), exactly as in the JAX package: only order-free consumers may use it
(the counter sorts right after).

Conventions (mer_dna.hpp): A=0 C=1 G=2 T=3; a mer is the 2k-bit
big-endian base-4 integer of its window, held as little-endian limbs;
canonical = min(mer, reverse complement).

Tensors may carry leading batch dimensions: every function works on the
last axis (a batch of equal-length chunks is one call).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jellyfish_tpu_torch.ops import multiword as mw

__all__ = [
    "code_table",
    "encode_codes",
    "extract_mers_phased",
    "extract_mers_packed",
    "reverse_complement",
    "canonicalize",
]

M32 = mw.M32
INVALID = 0xFF  # the code of anything but ACGTacgt


@functools.cache
def code_table() -> np.ndarray:
    """256-entry byte -> code table; invalid bases map to 0xFF."""
    t = np.full(256, INVALID, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        t[b] = i
    for i, b in enumerate(b"acgt"):
        t[b] = i
    return t


def encode_codes(chunk_u8):
    """[..., L] uint8 ASCII -> [..., L] uint8 codes (0..3 valid, 0xFF
    invalid), by arithmetic as in the JAX package: t = (ch >> 1) & 3 maps
    A0 C1 G3 T2, t ^ (t >> 1) swaps 2 and 3; validity is case-folded
    membership in {ACGT}."""
    t = (chunk_u8 >> 1) & 3
    code = t ^ (t >> 1)
    lower = chunk_u8 | 0x20
    valid = ((lower == ord("a")) | (lower == ord("c"))
             | (lower == ord("g")) | (lower == ord("t")))
    return torch.where(valid, code, INVALID)


def _rc_word(w):
    """Reverse the 2-bit groups of a 32-bit word and complement them
    (word_reverse_complement, mer_dna.hpp:83-90, on 32-bit words)."""
    w = ((w >> 2) & 0x33333333) | ((w & 0x33333333) << 2)
    w = ((w >> 4) & 0x0F0F0F0F) | ((w & 0x0F0F0F0F) << 4)
    w = ((w >> 8) & 0x00FF00FF) | ((w & 0x00FF00FF) << 8)
    w = (w >> 16) | ((w << 16) & M32)
    return w ^ M32


def reverse_complement(mers, k: int):
    """[..., W] mers -> reverse complements."""
    W = mers.shape[-1]
    rc = torch.stack(
        [_rc_word(mers[..., W - 1 - w]) for w in range(W)], dim=-1
    )
    rc = mw.mw_shift_right(rc, 32 * W - 2 * k)
    return mw.mw_and_mask_top(rc, 2 * k)


def canonicalize(mers, k: int):
    return mw.mw_min(mers, reverse_complement(mers, k))


def _pad_last(x, before: int, after: int):
    """Zero words before/after the last axis."""
    z = x.new_zeros
    return torch.cat(
        [z((*x.shape[:-1], before)), x, z((*x.shape[:-1], after))], dim=-1
    )


def _phased_windows_from_pwords(pw, k: int, Mp: int):
    """Funnel-read the [16][W] phase limb arrays from a packed-code word
    stream (one zero word prepended, guard-padded) -> [..., 16*Mp, W]."""
    W = mw.nwords(2 * k)

    def read32(off_bits: int):
        q, r = divmod(off_bits, 32)
        a = pw[..., q:q + Mp]
        if r == 0:
            return a
        b = pw[..., q + 1:q + 1 + Mp]
        return ((a << r) & M32) | (b >> (32 - r))

    phases = []
    for phi in range(16):
        # little-endian limb w covers BE bits [2k-32(w+1), 2k-32w)
        phases.append(torch.stack(
            [read32(32 + 2 * phi + 2 * k - 32 * (w + 1)) for w in range(W)],
            dim=-1,
        ))
    mers = torch.stack(phases, dim=-3)  # [..., 16, Mp, W]
    mers = mers.reshape(*pw.shape[:-1], 16 * Mp, W)
    return mw.mw_and_mask_top(mers, 2 * k)


def _window_invalid_stream(validbits, k: int):
    """Sliding-window OR of the BAD bitstream: output bit i (little-endian
    within 32-bit words) = some base in [i, i+k) is invalid. log2(k)
    packed passes (overlap-tolerant doubling since OR is idempotent)."""
    nv = validbits.shape[-1]
    guard = (k + 31) // 32 + 1
    A = validbits ^ M32
    cov = 1
    while cov < k:
        d = min(cov, k - cov)
        Apad = _pad_last(A, 0, guard)
        q, r = divmod(d, 32)
        a = Apad[..., q:q + nv]
        if r:
            b = Apad[..., q + 1:q + 1 + nv]
            a = (a >> r) | ((b << (32 - r)) & M32)
        A = A | a
        cov += d
    return A  # bit i set => window i invalid (meaningful for i < N)


def extract_mers_phased(codes, k: int, canonical: bool):
    """Phase-major window extraction from codes [L] uint8 (an ASCII chunk
    through encode_codes): the 16 codes of each word are packed big-endian
    and read as in extract_mers_packed. Validity is positional (no invalid
    code in [i, i + k)), by a cumulative sum, then put in phase-major
    order. Returns (mers [16*Mp, W], valid [16*Mp] bool), Mp = (L-k)//16
    + 1."""
    L = codes.shape[0]
    if L < k:
        raise ValueError("chunk shorter than k")
    N = L - k + 1
    Mp = (L - k) // 16 + 1

    bad = (codes > 3).to(torch.int64)
    csum = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0)])
    valid = csum[k:] - csum[:N] == 0
    # positional -> phase-major: index (phi, m) = 16m + phi
    valid_pm = torch.cat([valid, valid.new_zeros(16 * Mp - N)])
    valid_pm = valid_pm.view(Mp, 16).t().reshape(-1)

    Lp = (L + 15) // 16 * 16
    c2 = torch.cat([codes, codes.new_zeros(Lp - L)]).to(torch.int64) & 3
    shifts = 2 * (15 - torch.arange(16, device=codes.device))
    pw = (c2.view(-1, 16) << shifts).sum(dim=1)
    pw = _pad_last(pw, 1, 2 + (2 * k + 30) // 32)
    mers = _phased_windows_from_pwords(pw, k, Mp)
    if canonical:
        mers = canonicalize(mers, k)
    return mers, valid_pm


def extract_mers_packed(pwords, validbits, k: int, L: int, canonical: bool):
    """Packed-input phase-major extraction.

    pwords [..., L/16], validbits [..., ceil(L/32)]: int64 tensors holding
    32-bit words. Returns (mers [..., 16*Mp, W], valid [..., 16*Mp] bool)
    in phase-major order, Mp = (L-k)//16 + 1."""
    if L < k:
        raise ValueError("chunk shorter than k")
    N = L - k + 1
    Mp = (L - k) // 16 + 1

    pw = _pad_last(pwords, 1, 2 + (2 * k + 30) // 32)
    mers = _phased_windows_from_pwords(pw, k, Mp)

    inv = _window_invalid_stream(validbits, k)
    # phase-major expansion: window (phi, m) = stream bit 16m + phi; word j
    # holds (phi, m=2j) at bit phi and (phi, m=2j+1) at bit phi+16
    nv = inv.shape[-1]
    phi = torch.arange(16, device=inv.device).view(16, 1)
    even = (inv.unsqueeze(-2) >> phi) & 1          # [..., 16, nv]
    odd = (inv.unsqueeze(-2) >> (phi + 16)) & 1
    bits = torch.stack([even, odd], dim=-1).reshape(
        *inv.shape[:-1], 16, 2 * nv
    )[..., :Mp]
    in_range = 16 * torch.arange(Mp, device=inv.device) + phi < N
    valid = ((bits == 0) & in_range).reshape(*inv.shape[:-1], 16 * Mp)

    if canonical:
        mers = canonicalize(mers, k)
    return mers, valid
