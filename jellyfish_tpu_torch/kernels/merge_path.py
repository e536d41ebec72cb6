"""K1: stable merge of two sorted runs of (key row, count) pairs.

`merge_path` launches csrc/merge_path.cu on CUDA tensors and runs
`merge_path_plain` on CPU tensors; any other device raises. Keys are store
key columns [M, Wk] int64 (ops/multiword.py: one packed column for
2k <= 64, else limbs compared from the last column), counts [M] int64.
On equal keys A's row comes first, so a merge of two deduplicated runs
leaves each shared key on two adjacent rows, A's count first
(ops/count.fold_adjacent sums them).
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.ops.count import sort_rows

__all__ = ["merge_path", "merge_path_plain", "MAX_KEY_COLS"]

MAX_KEY_COLS = 7  # the kernel's WK template instances (k <= 112)

_P, _N = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "jf_merge_path": (ctypes.c_int,
                      [_P, _P, _N, _P, _P, _N, _P, _P, ctypes.c_int, _P]),
}


def merge_path_plain(a_keys, a_cnt, b_keys, b_cnt):
    """Concatenate, stable sort, gather."""
    keys = torch.cat([a_keys, b_keys])
    s, perm = sort_rows(keys)
    return s, torch.cat([a_cnt, b_cnt])[perm]


def _check(a_keys, a_cnt, b_keys, b_cnt):
    for t in (a_keys, a_cnt, b_keys, b_cnt):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError("merge_path takes contiguous int64 tensors")
        if t.device != a_keys.device:
            raise ValueError("merge_path inputs lie on different devices")
    if a_keys.dim() != 2 or b_keys.dim() != 2:
        raise ValueError("merge_path keys must be [M, Wk]")
    wk = a_keys.shape[1]
    if b_keys.shape[1] != wk or not 1 <= wk <= MAX_KEY_COLS:
        raise ValueError(f"merge_path: key widths {wk}, {b_keys.shape[1]}")
    if a_cnt.shape != (a_keys.shape[0],) or b_cnt.shape != (b_keys.shape[0],):
        raise ValueError("merge_path counts must be [M] beside keys [M, Wk]")


def merge_path(a_keys, a_cnt, b_keys, b_cnt):
    """Stable merge of sorted runs A and B -> (keys [Ma+Mb, Wk], cnt)."""
    _check(a_keys, a_cnt, b_keys, b_cnt)
    dev = a_keys.device
    if dev.type == "cpu":
        return merge_path_plain(a_keys, a_cnt, b_keys, b_cnt)
    if dev.type != "cuda":
        raise ValueError(f"merge_path: unsupported device {dev}")
    na, wk = a_keys.shape
    nb = b_keys.shape[0]
    out_keys = torch.empty((na + nb, wk), dtype=torch.int64, device=dev)
    out_cnt = torch.empty(na + nb, dtype=torch.int64, device=dev)
    fn = _build.load("merge_path", _SIGNATURES).jf_merge_path
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a_keys.data_ptr(), a_cnt.data_ptr(), na,
                b_keys.data_ptr(), b_cnt.data_ptr(), nb,
                out_keys.data_ptr(), out_cnt.data_ptr(), wk, stream)
    _build.check(rc, "merge_path")
    merge_path.launches += 1
    return out_keys, out_cnt


merge_path.launches = 0

