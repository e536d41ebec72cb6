"""The chunk pipeline of host-packed chunks in one kernel (csrc/sortkeys.cu):
B chunks -> the premasked sortkey columns of their windows and the valid
count, for keys of one packed column (2k <= 64) and of 3 or 4 limb
columns (64 < 2k <= 128), one kernel for each width.

`sortkeys` takes any k and picks the route: it launches a kernel on CUDA
tensors at 2k <= 128 (`runs_kernel`), and runs `sortkeys_plain` on CPU
tensors and above that width; any other device raises. The plain version is
ops/mers.extract_mers_packed, then `premasked`: windows in phase-major
order (batch b, phase phi, slot m is row b 16 Mp + phi Mp + m, window
start 16m + phi), the canonical fold, the GF(2) hash and the
(pos << (2k - l)) | (key >> l) sortkey as store key columns, invalid or
out-of-range windows the PAD key. Both give the same tensors bit for bit.

The kernels hash by per-byte column tables (`byte_tables`): entry [i, v]
is pos of the key whose only set bits are byte v at byte i, so pos of any
key is the XOR of one entry a key byte. `route_tables` puts them on the
device once per counter where the kernel runs. Above 2k = 64 only tables
are taken (MerCounter always hashes such keys); the identity hash raises
there, on either route.
`sortkeys.launches` counts calls that launched on the card, one kernel
launch each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.hashing import sortkey_of_mers
from jellyfish_tpu_torch.ops.mers import extract_mers_packed

__all__ = ["byte_tables", "hash_tables", "premasked", "route_tables",
           "runs_kernel", "sortkeys", "sortkeys_plain"]

MAX_K = 64  # keys of 2k <= 128 bits: one packed column, or 3-4 limbs
_WORD_DTYPES = (torch.int32, torch.int64)

_P, _N, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "jf_sortkeys": (ctypes.c_int, [_P, _P, _I, _P, _P, _P, _N, _N, _N, _N,
                                   _N, _I, _I, _I, _I, _P]),
}


def byte_tables(masks: np.ndarray, c: int) -> np.ndarray:
    """Masks [l, W] uint32 (hashing.masks_of_matrix) of a c-bit key ->
    [ceil(c / 8), 256] uint64: entry [i, v] is pos (l bits) of the key
    whose bits are v at byte i and 0 elsewhere."""
    l = masks.shape[0]
    bits = np.arange(c)
    # sel[j, b]: key bit b takes part in pos bit j
    sel = (masks[:, bits // 32] >> (bits % 32).astype(np.uint32)) & 1
    cols = np.bitwise_or.reduce(
        sel.astype(np.uint64) << np.arange(l, dtype=np.uint64)[:, None],
        axis=0)  # [c]: the pos of key bit b alone
    v = np.arange(256)
    tab = np.zeros(((c + 7) // 8, 256), np.uint64)
    for b in range(c):
        tab[b // 8] ^= np.where((v >> (b % 8)) & 1, cols[b], np.uint64(0))
    return tab


def hash_tables(masks, k: int, device):
    """The kernel's hash tables on `device`: byte_tables' entries as 32-bit
    words (l <= 32) or pairs of them (low word first), int32; None for the
    identity hash (masks None)."""
    if masks is None:
        return None
    tab = byte_tables(masks, 2 * k)
    tab = tab.astype(np.uint32) if masks.shape[0] <= 32 else tab.view(
        np.uint32)
    return torch.from_numpy(tab.view(np.int32)).to(device)


def runs_kernel(k: int, device) -> bool:
    """Whether `sortkeys` launches its kernel for k-mers on `device`: on a
    CUDA device, for keys of at most 4 limbs (2k <= 128)."""
    return torch.device(device).type == "cuda" and k <= MAX_K


def route_tables(masks, k: int, device):
    """What `sortkeys`' route on `device` takes as `tables`: hash_tables
    where the kernel runs, None where the plain route runs."""
    return hash_tables(masks, k, device) if runs_kernel(k, device) else None


def premasked(mers, valid, masks, k, lsize):
    """Mers [N, W] -> (sortkey columns [N, Wk], invalid windows carrying
    the PAD key; the valid count, a device scalar)."""
    sk = sortkey_of_mers(mers, masks, k, lsize)
    cols = torch.where(valid[:, None], mw.key_columns(sk),
                       mw.pad_key(sk.shape[-1]))
    return cols.contiguous(), valid.sum()


def _words64(w):
    """Word tensor (int32 bit patterns or int64 values) -> int64 values
    0 .. 2^32 - 1."""
    return w if w.dtype == torch.int64 else w.to(torch.int64) & mw.M32


def sortkeys_plain(pwords, validbits, k, lsize, canonical, masks):
    """B host-packed chunks (pwords [B, L/16], validbits [B, ceil(L/32)],
    int32 or int64 words) -> (premasked sortkey columns [B * 16 * Mp, Wk],
    n_valid scalar), in plain torch: any k."""
    pw, vb = _words64(pwords), _words64(validbits)
    L = int(pw.shape[-1]) * 16
    mers, valid = extract_mers_packed(pw, vb, k, L, canonical)
    W = mers.shape[-1]
    return premasked(mers.reshape(-1, W), valid.reshape(-1), masks, k, lsize)


def _checked(pwords, validbits, k, lsize, masks):
    if k < 1:
        raise ValueError(f"sortkeys takes k >= 1, not k = {k}")
    if not mw.packs(mw.nwords(2 * k)) and masks is None:
        raise ValueError(f"sortkeys: k = {k} keys take a hash's tables; the "
                         "identity hash runs only at 2k <= 64")
    if not 1 <= lsize <= min(2 * k, 64) or (masks is not None
                                            and masks.shape[0] != lsize):
        raise ValueError(f"sortkeys: lsize {lsize} not in "
                         f"1..{min(2 * k, 64)}, or not the masks' rows")
    if pwords.dtype not in _WORD_DTYPES or validbits.dtype != pwords.dtype:
        raise ValueError("sortkeys takes int32 or int64 words, both of one "
                         f"dtype; got {pwords.dtype} and {validbits.dtype}")
    if pwords.dim() != 2 or validbits.dim() != 2 \
            or validbits.shape[0] != pwords.shape[0]:
        raise ValueError("sortkeys takes pwords [B, L/16] and validbits "
                         f"[B, ceil(L/32)]; got {tuple(pwords.shape)} and "
                         f"{tuple(validbits.shape)}")
    L = int(pwords.shape[1]) * 16
    if validbits.shape[1] != (L + 31) // 32 or L < k:
        raise ValueError(f"sortkeys: chunks of {L} bases need "
                         f"{(L + 31) // 32} validity words and L >= k = {k}; "
                         f"got {validbits.shape[1]}")
    if pwords.device != validbits.device:
        raise ValueError("sortkeys inputs lie on different devices")
    return L


def sortkeys(pwords, validbits, k, lsize, canonical, masks, tables=None):
    """B host-packed chunks (pwords [B, L/16], validbits [B, ceil(L/32)],
    int32 or int64 words, L a multiple of 16 and >= k) -> (premasked
    sortkey columns [B * 16 * Mp, Wk] int64, n_valid int64 scalar): Wk 1
    at k <= 32, else the nwords(2k) limbs. One kernel launch where
    `runs_kernel`, sortkeys_plain otherwise. `tables` (hash_tables of
    masks, on the card) is made from masks when not given."""
    L = _checked(pwords, validbits, k, lsize, masks)
    dev = pwords.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sortkeys: unsupported device {dev}")
    if not runs_kernel(k, dev):
        return sortkeys_plain(pwords, validbits, k, lsize, canonical, masks)
    if masks is not None and tables is None:
        tables = hash_tables(masks, k, dev)
    if (masks is None) != (tables is None):
        raise ValueError("sortkeys: tables without masks")
    hash_kind = 0 if masks is None else 1 if lsize <= 32 else 2
    words = hash_kind * 256 * ((2 * k + 7) // 8)
    if tables is not None and (tables.device != dev
                               or tables.dtype != torch.int32
                               or tables.numel() != words):
        raise ValueError("sortkeys: tables do not match the masks or device")
    pw, vb = pwords.contiguous(), validbits.contiguous()
    B = int(pw.shape[0])
    Mp = (L - k) // 16 + 1
    lib = _build.load("sortkeys", _SIGNATURES)
    with torch.cuda.device(dev):
        W = mw.nwords(2 * k)
        Wk = 1 if mw.packs(W) else W
        out = torch.empty((B * 16 * Mp, Wk), dtype=torch.int64, device=dev)
        n_valid = torch.empty((), dtype=torch.int64, device=dev)
        _build.check(
            lib.jf_sortkeys(pw.data_ptr(), vb.data_ptr(), pw.element_size(),
                            out.data_ptr(), n_valid.data_ptr(),
                            None if tables is None else tables.data_ptr(),
                            B, pw.shape[1], vb.shape[1], Mp, L - k + 1, k,
                            lsize, int(bool(canonical)), hash_kind,
                            torch.cuda.current_stream(dev).cuda_stream),
            "sortkeys",
        )
    sortkeys.launches += 1
    return out, n_valid


sortkeys.launches = 0
