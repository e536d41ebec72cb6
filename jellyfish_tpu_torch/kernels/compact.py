"""K2: order-preserving removal of the count-0 rows of a masked run, or of
the rows a keep mask drops.

`compact` launches csrc/compact.cu on CUDA tensors and runs
`compact_plain` on CPU tensors; any other device raises. Keys are store
key columns [M, Wk] int64 of any width, counts [M] int64, the optional
keep mask [M] bool. The output holds exactly the n rows with a nonzero
count (or a true keep), in input order: a sorted masked run comes out as
its dense sorted live prefix, with no PAD rows mixed in.

On the card one call is two kernel launches (a count pass and a scatter
pass) around a `torch.cumsum`; `compact.launches` counts calls. The
wrapper synchronises once a call: it reads the kept-row
total after the count pass to allocate outputs of exactly n rows. The
store truncates its runs to that size at this point anyway.
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build

__all__ = ["compact", "compact_plain"]

_P, _N = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "jf_compact_tile": (ctypes.c_int64, []),
    "jf_compact_count": (ctypes.c_int, [_P, _P, _N, _P, _P]),
    "jf_compact_scatter": (ctypes.c_int,
                           [_P, _P, _P, _N, _P, _P, _P, ctypes.c_int, _P]),
}


def compact_plain(keys, cnt, keep=None):
    """Boolean-mask indexing."""
    if keep is None:
        keep = cnt != 0
    n = int(keep.sum())
    return keys[keep], cnt[keep], n


def compact(keys, cnt, keep=None):
    """(keys [M, Wk], cnt [M]) -> (keys [n, Wk], cnt [n], n): the rows
    with cnt != 0, or with keep true when a keep mask [M] is given."""
    if keys.dtype != torch.int64 or cnt.dtype != torch.int64:
        raise ValueError("compact takes int64 tensors")
    if not (keys.is_contiguous() and cnt.is_contiguous()):
        raise ValueError("compact takes contiguous tensors")
    if keys.dim() != 2 or cnt.shape != (keys.shape[0],):
        raise ValueError("compact takes keys [M, Wk] and counts [M]")
    if keys.device != cnt.device:
        raise ValueError("compact inputs lie on different devices")
    if keep is not None and (
            keep.dtype != torch.bool or not keep.is_contiguous()
            or keep.shape != cnt.shape or keep.device != cnt.device):
        raise ValueError("compact: a keep mask is a contiguous bool [M] "
                         "tensor on the counts' device")
    dev = keys.device
    if dev.type == "cpu":
        return compact_plain(keys, cnt, keep)
    if dev.type != "cuda":
        raise ValueError(f"compact: unsupported device {dev}")
    m, wk = keys.shape
    if wk < 1:
        raise ValueError(f"compact: key width {wk}")
    lib = _build.load("compact", _SIGNATURES)
    tile = lib.jf_compact_tile()
    tiles = (m + tile - 1) // tile
    keep_ptr = None if keep is None else keep.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tile_n = torch.empty(tiles, dtype=torch.int64, device=dev)
        _build.check(
            lib.jf_compact_count(cnt.data_ptr(), keep_ptr, m,
                                 tile_n.data_ptr(), stream),
            "compact (count pass)",
        )
        ends = torch.cumsum(tile_n, 0)
        n = int(ends[-1]) if tiles else 0
        tile_off = ends - tile_n
        out_keys = torch.empty((n, wk), dtype=torch.int64, device=dev)
        out_cnt = torch.empty(n, dtype=torch.int64, device=dev)
        _build.check(
            lib.jf_compact_scatter(keys.data_ptr(), cnt.data_ptr(),
                                   keep_ptr, m, tile_off.data_ptr(),
                                   out_keys.data_ptr(),
                                   out_cnt.data_ptr(), wk, stream),
            "compact (scatter pass)",
        )
    compact.launches += 1
    return out_keys, out_cnt, n


compact.launches = 0

