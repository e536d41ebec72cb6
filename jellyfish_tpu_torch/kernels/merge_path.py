"""K1: stable merge of sorted runs of key rows, each with a count.

`merge_path` and `merge_pass` launch csrc/merge_path.cu on CUDA tensors
and run `merge_path_plain` and `merge_pass_plain` on CPU tensors; any other
device raises. Keys are store key columns [M, Wk] int64 (ops/multiword.py:
one packed column for 2k <= 64, else limbs compared from the last column),
counts [M] int64. On equal keys A's row comes first, so a merge of two
deduplicated runs leaves each shared key on two adjacent rows, A's count
first (ops/count.fold_adjacent sums them).

`merge_pass` is one pass of a merge sort (kernels/sort.py): every adjacent
pair of sorted runs of L rows merged at once, the payload optional.
`merge_path.launches` and `merge_pass.launches` count calls; each call is
one kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.ops.count import sort_rows_plain

__all__ = ["merge_path", "merge_path_plain", "merge_pass",
           "merge_pass_plain", "MAX_KEY_COLS"]

MAX_KEY_COLS = 7  # the kernel's WK template instances (k <= 112)

_P, _N = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "jf_merge_path": (ctypes.c_int,
                      [_P, _P, _N, _P, _P, _N, _P, _P, ctypes.c_int, _P]),
    "jf_merge_pass": (ctypes.c_int,
                      [_P, _P, _N, _N, _P, _P, ctypes.c_int, _P]),
}


def merge_path_plain(a_keys, a_cnt, b_keys, b_cnt):
    """Concatenate, stable sort, gather."""
    keys = torch.cat([a_keys, b_keys])
    s, perm = sort_rows_plain(keys)
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


def merge_pass_plain(keys, run_len, payload=None):
    """Per pair of runs, the stable sort of the pair (merge_path_plain's
    arithmetic)."""
    out_k = torch.empty_like(keys)
    out_p = None if payload is None else torch.empty_like(payload)
    for s in range(0, keys.shape[0], 2 * run_len):
        k, perm = sort_rows_plain(keys[s:s + 2 * run_len])
        out_k[s:s + len(k)] = k
        if payload is not None:
            out_p[s:s + len(k)] = payload[s:s + 2 * run_len][perm]
    return out_k, out_p


def merge_pass(keys, run_len, payload=None):
    """Merge every adjacent pair of sorted runs of `run_len` rows of keys
    [M, Wk] (the last pair may be short, a lone last run is copied), each
    stably, with the payload [M] if given. Returns (keys, payload or
    None)."""
    if keys.dtype != torch.int64 or not keys.is_contiguous() or keys.dim() != 2:
        raise ValueError("merge_pass takes contiguous int64 keys [M, Wk]")
    m, wk = keys.shape
    if not 1 <= wk <= MAX_KEY_COLS or run_len < 1:
        raise ValueError(f"merge_pass: key width {wk}, run length {run_len}")
    if payload is not None and (
            payload.dtype != torch.int64 or not payload.is_contiguous()
            or payload.shape != (m,) or payload.device != keys.device):
        raise ValueError("merge_pass: a payload is a contiguous int64 [M] "
                         "column on the keys' device")
    dev = keys.device
    if dev.type == "cpu":
        return merge_pass_plain(keys, run_len, payload)
    if dev.type != "cuda":
        raise ValueError(f"merge_pass: unsupported device {dev}")
    out_k = torch.empty_like(keys)
    out_p = None if payload is None else torch.empty_like(payload)
    fn = _build.load("merge_path", _SIGNATURES).jf_merge_pass
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(keys.data_ptr(),
                None if payload is None else payload.data_ptr(), m, run_len,
                out_k.data_ptr(), None if out_p is None else out_p.data_ptr(),
                wk, stream)
    _build.check(rc, "merge_pass")
    merge_pass.launches += 1
    return out_k, out_p


merge_pass.launches = 0
