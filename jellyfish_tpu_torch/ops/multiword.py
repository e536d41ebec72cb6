"""Multi-word (little-endian 32-bit limbs) bit operations on [..., W] tensors.

The counterpart of jellyfish_tpu/ops/multiword.py. Every wide value
(2k-bit mers, hashes, sortkeys) is a little-endian vector of 32-bit limbs
along the trailing axis, held in int64 tensors with values 0 .. 2^32-1:
torch has no usable uint32 shifts on the CPU, and an int64 holds a limb
shifted left by up to 31 bits without overflow. Results are masked back to
32 bits after every shift. Shift amounts are static python ints.

Store key columns: for 2k <= 64 the sortkey travels packed in ONE int64
column as u64 ^ 2^63 (signed order of the packed value equals unsigned
order of u64), so a sort or a merge compares one word. The PAD key is
INT64_MAX, the packed all-ones u64: for W = 2 a real key can equal it
(2k = 64), for W = 1 none can. Unpacked, it is all-ones limbs, the JAX
package's PAD. For 2k > 64 the key columns are the limbs themselves,
compared lexicographically from the last column, and PAD is all-ones.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "M32",
    "PAD_PACKED",
    "nwords",
    "mw_shift_left",
    "mw_shift_right",
    "mw_or",
    "mw_and_mask_top",
    "mw_less",
    "mw_eq",
    "mw_select",
    "mw_min",
    "to_ints",
    "from_ints",
    "packs",
    "key_columns",
    "limbs_of_key_columns",
    "pad_key",
]

M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)          # int64 bit pattern of 2^63
PAD_PACKED = (1 << 63) - 1  # all-ones u64, packed


def nwords(bits: int) -> int:
    return max(1, (bits + 31) // 32)


def _limb(x, i: int):
    """Limb i of x, or zeros if out of range."""
    if 0 <= i < x.shape[-1]:
        return x[..., i]
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def mw_shift_left(x, s: int, W_out: int | None = None):
    """x << s, output with W_out limbs (default: same as input)."""
    W = x.shape[-1] if W_out is None else W_out
    q, r = divmod(s, 32)
    limbs = []
    for w in range(W):
        lo = _limb(x, w - q)
        if r == 0:
            limbs.append(lo)
        else:
            hi = _limb(x, w - q - 1)
            limbs.append(((lo << r) & M32) | (hi >> (32 - r)))
    return torch.stack(limbs, dim=-1)


def mw_shift_right(x, s: int, W_out: int | None = None):
    """x >> s, output with W_out limbs (default: same as input)."""
    W = x.shape[-1] if W_out is None else W_out
    q, r = divmod(s, 32)
    limbs = []
    for w in range(W):
        lo = _limb(x, w + q)
        if r == 0:
            limbs.append(lo)
        else:
            hi = _limb(x, w + q + 1)
            limbs.append((lo >> r) | ((hi << (32 - r)) & M32))
    return torch.stack(limbs, dim=-1)


def mw_or(a, b):
    W = max(a.shape[-1], b.shape[-1])
    return torch.stack([_limb(a, w) | _limb(b, w) for w in range(W)], dim=-1)


def mw_and_mask_top(x, bits: int):
    """Clear all bits >= `bits` (clean_msw analogue, mer_dna.hpp:523)."""
    limbs = []
    for w in range(x.shape[-1]):
        lo_bit = 32 * w
        if lo_bit + 32 <= bits:
            limbs.append(x[..., w])
        elif lo_bit >= bits:
            limbs.append(torch.zeros_like(x[..., w]))
        else:
            limbs.append(x[..., w] & ((1 << (bits - lo_bit)) - 1))
    return torch.stack(limbs, dim=-1)


def mw_less(a, b):
    """a < b as unsigned big integers. Returns a bool tensor."""
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for w in range(a.shape[-1] - 1, -1, -1):
        lt = lt | (eq & (a[..., w] < b[..., w]))
        eq = eq & (a[..., w] == b[..., w])
    return lt


def mw_eq(a, b):
    return (a == b).all(dim=-1)


def mw_select(pred, a, b):
    """where(pred, a, b) broadcasting pred over the limb axis."""
    return torch.where(pred[..., None], a, b)


def mw_min(a, b):
    return mw_select(mw_less(a, b), a, b)


def to_ints(x) -> np.ndarray:
    """[N, W] limbs (tensor or array) -> python-int np.object array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x).astype(np.uint64)
    out = np.zeros(x.shape[:-1], dtype=object)
    for w in range(x.shape[-1]):
        out |= x[..., w].astype(object) << (32 * w)
    return out


def from_ints(vals, W: int, device=None) -> torch.Tensor:
    """Iterable of python ints -> [N, W] int64 limbs."""
    vals = [int(v) for v in vals]
    out = np.zeros((len(vals), W), dtype=np.int64)
    for i, v in enumerate(vals):
        for w in range(W):
            out[i, w] = (v >> (32 * w)) & M32
    return torch.from_numpy(out).to(device)


# -- store key columns ---------------------------------------------------


def packs(W: int) -> bool:
    """Whether W-limb keys travel packed in one int64 column."""
    return W <= 2


def key_columns(limbs):
    """[..., W] limbs -> [..., Wk] store key columns (see module doc)."""
    W = limbs.shape[-1]
    if not packs(W):
        return limbs
    u = limbs[..., 0]
    if W == 2:
        u = u | (limbs[..., 1] << 32)
    return (u ^ _SIGN).unsqueeze(-1)


def limbs_of_key_columns(cols, W: int):
    """Inverse of key_columns: [..., Wk] -> [..., W] limbs. The packed PAD
    (INT64_MAX) unpacks to all-ones limbs, the JAX package's PAD."""
    if not packs(W):
        return cols
    u = cols[..., 0] ^ _SIGN
    limbs = [u & M32]
    if W == 2:
        limbs.append((u >> 32) & M32)
    return torch.stack(limbs, dim=-1)


def pad_key(W: int) -> int:
    """Value of every PAD key column for W-limb keys."""
    return PAD_PACKED if packs(W) else M32
