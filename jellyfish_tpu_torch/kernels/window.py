"""Kernel-table rows 9 and 10: a window of rows at a runtime offset, and a
rotation by a runtime shift (csrc/window.cu), the staging of the streaming
merge of sorted databases (merge.py).

`window_rows` and `roll_lanes` launch csrc/window.cu on CUDA tensors and
run `window_rows_plain` and `roll_lanes_plain` on CPU tensors; any other
device raises. An offset or a shift is a python int or an int64 scalar
tensor; one on the card is read there by the kernel, so a launch never
waits for the host. `window_rows.launches` and `roll_lanes.launches` count
calls; each call is one kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.ops import multiword as mw

__all__ = ["window_rows", "window_rows_plain", "roll_lanes",
           "roll_lanes_plain", "pad_of"]

_P, _N = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "jf_window_rows": (ctypes.c_int, [_P, _P, _N, ctypes.c_int, _P, _N, _N,
                                      _N, _P, _P, _P]),
    "jf_roll_lanes": (ctypes.c_int, [_P, _N, _N, _P, _N, _P, _P]),
}


def pad_of(wk: int) -> int:
    """The PAD value of every key column of a [M, wk] run: the packed
    INT64_MAX for one column, all-ones limbs for more."""
    return mw.PAD_PACKED if wk == 1 else mw.M32


def _scalar(v, dev, what):
    """(device pointer or None, host value) of an offset or a shift: a
    tensor on the kernel's device is read there, anything else is taken
    on the host."""
    if isinstance(v, torch.Tensor):
        if v.dtype != torch.int64 or v.numel() != 1:
            raise ValueError(f"{what} must be an int64 scalar tensor")
        if v.device == dev:
            return v.data_ptr(), 0
        return None, int(v)
    return None, int(v)


def _check_run(keys, counts):
    if keys.dtype != torch.int64 or counts.dtype != torch.int64:
        raise ValueError("window_rows takes int64 tensors")
    if not (keys.is_contiguous() and counts.is_contiguous()):
        raise ValueError("window_rows takes contiguous tensors")
    if keys.dim() != 2 or counts.shape != (keys.shape[0],):
        raise ValueError("window_rows takes keys [M, Wk] and counts [M]")
    if keys.device != counts.device:
        raise ValueError("window_rows inputs lie on different devices")


def window_rows_plain(keys, counts, off, n: int):
    """Slices of the overlap of [off, off + n) with [0, M), into outputs
    filled with PAD rows and count 0."""
    off = int(off)
    m, wk = keys.shape
    out_k = torch.full((n, wk), pad_of(wk), dtype=torch.int64,
                       device=keys.device)
    out_c = torch.zeros(n, dtype=torch.int64, device=keys.device)
    lo, hi = max(off, 0), min(off + n, m)
    if lo < hi:
        out_k[lo - off:hi - off] = keys[lo:hi]
        out_c[lo - off:hi - off] = counts[lo:hi]
    return out_k, out_c


def window_rows(keys, counts, off, n: int):
    """Rows [off, off + n) of the run (keys [M, Wk], counts [M]) as new
    tensors of exactly n rows; rows outside [0, M) get the PAD key and
    count 0. `off` is any row, aligned or not."""
    _check_run(keys, counts)
    n = int(n)
    if n < 0:
        raise ValueError(f"window_rows: n = {n}")
    dev = keys.device
    if dev.type == "cpu":
        return window_rows_plain(keys, counts, off, n)
    if dev.type != "cuda":
        raise ValueError(f"window_rows: unsupported device {dev}")
    off_ptr, off_host = _scalar(off, dev, "window_rows offset")
    m, wk = keys.shape
    out_k = torch.empty((n, wk), dtype=torch.int64, device=dev)
    out_c = torch.empty(n, dtype=torch.int64, device=dev)
    fn = _build.load("window", _SIGNATURES).jf_window_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(keys.data_ptr(), counts.data_ptr(), m, wk, off_ptr, off_host,
                n, pad_of(wk), out_k.data_ptr(), out_c.data_ptr(), stream)
    _build.check(rc, "window_rows")
    window_rows.launches += 1
    return out_k, out_c


window_rows.launches = 0


def roll_lanes_plain(x, shift):
    """torch.roll along the last axis."""
    return torch.roll(x, int(shift), dims=1)


def roll_lanes(x, shift):
    """np.roll(x, shift, axis=1) of a contiguous [R, C] int64 tensor, as a
    new tensor. The shift may be negative or larger than C."""
    if x.dtype != torch.int64 or not x.is_contiguous() or x.dim() != 2:
        raise ValueError("roll_lanes takes a contiguous int64 [R, C] tensor")
    dev = x.device
    if dev.type == "cpu":
        return roll_lanes_plain(x, shift)
    if dev.type != "cuda":
        raise ValueError(f"roll_lanes: unsupported device {dev}")
    s_ptr, s_host = _scalar(shift, dev, "roll_lanes shift")
    rows, c = x.shape
    out = torch.empty_like(x)
    fn = _build.load("window", _SIGNATURES).jf_roll_lanes
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), rows, c, s_ptr, s_host, out.data_ptr(), stream)
    _build.check(rc, "roll_lanes")
    roll_lanes.launches += 1
    return out


roll_lanes.launches = 0
