"""Batched GF(2) matrix hashing + hash-order sort keys.

The counterpart of jellyfish_tpu/ops/hashing.py (mask formulation). The
table's dump order is ascending (pos, key) with pos = A.key over GF(2)
(sorted_dumper.hpp + mer_heap.hpp:26-30); since pos is a bijection of the
key's low l bits given its high bits (the pseudo-square matrix, gf2.py),
that order is the order of the 2k-bit integer

    sortkey = (pos << (2k - l)) | (key >> l)

itself a bijection of the key. The store keeps sortkeys; mers are
recovered with the inverse matrix at dump time.

pos bit j is the parity of (key AND mask_j): the column-selection XOR of
rectangular_binary_matrix.hpp:224-261 re-expressed per output bit. torch
has no popcount, so the parity is an XOR fold of the masked word.
"""

from __future__ import annotations

import numpy as np
import torch

from jellyfish_tpu_torch.ops import multiword as mw

__all__ = [
    "masks_of_matrix",
    "inverse_masks_of_matrix",
    "gf2_apply_masks",
    "sortkey_of_mers",
    "mers_of_sortkeys",
]


def masks_of_matrix(matrix, W: int) -> np.ndarray:
    """Per-output-bit key masks [r, W] uint32 for gf2_apply_masks.

    masks[j, w] bit b set  <=>  key bit 32w+b participates in pos bit j.
    The same numpy computation as the JAX package's, so both packages
    hash with the same masks for the same GF2Matrix."""
    bm = matrix.bit_matrix()  # [c, r] uint8, little-endian key bit order
    c, r = bm.shape
    masks = np.zeros((r, W), np.uint32)
    ii, jj = np.nonzero(bm)
    np.bitwise_or.at(
        masks, (jj, ii // 32), np.uint32(1) << (ii % 32).astype(np.uint32)
    )
    return masks


def inverse_masks_of_matrix(matrix, W: int) -> np.ndarray:
    return masks_of_matrix(matrix.pseudo_inverse(), W)


def _parity32(t):
    """Parity of each 32-bit word, 0 or 1 (XOR fold)."""
    t = t ^ (t >> 16)
    t = t ^ (t >> 8)
    t = t ^ (t >> 4)
    t = t ^ (t >> 2)
    t = t ^ (t >> 1)
    return t & 1


def gf2_apply_masks(keys, masks: np.ndarray, out_words: int):
    """Batched GF(2) product: keys [..., W] limbs, masks [l, W] (numpy,
    host) -> [..., out_words] limbs. parity(a) ^ parity(b) ==
    parity(a ^ b), so limbs fold with XOR before one parity."""
    l, W = masks.shape
    out = []
    for ow in range(out_words):
        acc = torch.zeros(keys.shape[:-1], dtype=keys.dtype,
                          device=keys.device)
        for j in range(ow * 32, min(l, (ow + 1) * 32)):
            t = None
            for w in range(W):
                m = int(masks[j, w])
                if m == 0:
                    continue
                term = keys[..., w] & m
                t = term if t is None else t ^ term
            if t is not None:
                acc = acc | (_parity32(t) << (j - ow * 32))
        out.append(acc)
    return torch.stack(out, dim=-1)


def sortkey_of_mers(mers, masks, k: int, lsize: int):
    """[..., W] mers -> [..., W] sortkeys = (pos << (2k-l)) | (key >> l).
    masks None is the identity hash (size >= 4^k,
    large_hash_array.hpp:997-1001): the sortkey is the key itself."""
    c = 2 * k
    W = mers.shape[-1]
    if masks is None:
        return mers
    pos = gf2_apply_masks(mers, masks, mw.nwords(lsize))
    pos = mw.mw_and_mask_top(pos, lsize)
    hi = mw.mw_shift_left(pos, c - lsize, W_out=W)
    lo = mw.mw_shift_right(mers, lsize)
    return mw.mw_and_mask_top(mw.mw_or(hi, lo), c)


def mers_of_sortkeys(sortkeys, inv_masks, k: int, lsize: int):
    """Invert sortkey_of_mers (used at dump time).

    key_high = sortkey low (2k-l) bits; pos = sortkey >> (2k-l);
    key_low = Binv . ((key_high << l) | pos)   [l bits]
    (large_hash_iterator.hpp:53,92 + large_hash_array.hpp:847-858)."""
    c = 2 * k
    W = sortkeys.shape[-1]
    if inv_masks is None:
        return sortkeys
    pos = mw.mw_shift_right(sortkeys, c - lsize)
    pos = mw.mw_and_mask_top(pos, lsize)[..., : mw.nwords(lsize)]
    key_high = mw.mw_and_mask_top(sortkeys, c - lsize)
    h = mw.mw_or(mw.mw_shift_left(key_high, lsize, W_out=W), pos)
    key_low = gf2_apply_masks(h, inv_masks, mw.nwords(lsize))
    key_low = mw.mw_and_mask_top(key_low, lsize)
    key = mw.mw_or(mw.mw_shift_left(key_high, lsize, W_out=W), key_low)
    return mw.mw_and_mask_top(key, c)
