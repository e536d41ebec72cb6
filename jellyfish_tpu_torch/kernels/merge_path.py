"""K1: stable merge of sorted runs of key rows, each with a count.

`merge_path` and `merge_pass` launch csrc/merge_path.cu on CUDA tensors
and run `merge_path_plain` and `merge_pass_plain` on CPU tensors; any other
device raises. Keys are store key columns [M, Wk] int64 (ops/multiword.py:
one packed column for 2k <= 64, else limbs compared from the last column),
counts [M] int64. On equal keys A's row comes first, so a merge of two
deduplicated runs leaves each shared key on two adjacent rows, A's count
first (ops/count.fold_adjacent sums them).

Keys of 1-7 columns (k <= 112) run the kernel's template instances; wider
keys, up to MAX_KEY_COLS, its wide kernels, which read the width at run
time, with instances at 8 and 13 columns (csrc/merge_path.cu).

`merge_pass` is one pass of a merge sort (kernels/sort.py): every adjacent
pair of sorted runs of L rows merged at once, the payload optional. On the
card a call is two kernel launches: `merge_splits` (the partition pass:
where each output tile of `pass_tile_rows` rows starts in its pair's first
run) and the tile merge that reads those splits. `merge_path.launches`,
`merge_pass.launches` and `merge_splits.launches` count calls; a
`merge_splits` call is one kernel launch, a `merge_pass` call two (its
`merge_splits` call counts there too). A `merge_path` call is one kernel
launch up to 7 columns; above, two: the wide partition pass on its one
pair of runs, at tiles of `merge_tile_rows` rows, then the wide pass's
tiles with the counts as payload (neither counted elsewhere).
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.ops.count import sort_rows_plain

__all__ = ["merge_path", "merge_path_plain", "merge_pass",
           "merge_pass_plain", "merge_splits", "merge_splits_plain",
           "pass_tile_rows", "merge_tile_rows", "split_steps",
           "MAX_KEY_COLS",
           "NARROW_KEY_COLS", "SHARED_BYTES"]

NARROW_KEY_COLS = 7  # csrc/rows.cuh kNarrowCols: the WK template instances
SHARED_BYTES = 232448  # csrc/rows.cuh kSharedBytes: a block's 227 KB

_P, _N = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "jf_merge_path": (ctypes.c_int,
                      [_P, _P, _N, _P, _P, _N, _P, _P, ctypes.c_int, _N, _P,
                       _P]),
    "jf_merge_splits": (ctypes.c_int,
                        [_P, _N, _N, _N, _P, ctypes.c_int, _P]),
    "jf_merge_pass": (ctypes.c_int,
                      [_P, _P, _N, _N, _N, _P, _P, _P, ctypes.c_int, _P]),
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
        raise ValueError(f"merge_path: key widths {wk}, {b_keys.shape[1]} "
                         f"(the kernels take 1 to {MAX_KEY_COLS} columns)")
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
    tile, splits = 0, None
    if wk > NARROW_KEY_COLS:
        tile = merge_tile_rows(wk)
        splits = torch.empty(-(-(na + nb) // tile) + 1, dtype=torch.int64,
                             device=dev)
    fn = _build.load("merge_path", _SIGNATURES).jf_merge_path
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a_keys.data_ptr(), a_cnt.data_ptr(), na,
                b_keys.data_ptr(), b_cnt.data_ptr(), nb,
                out_keys.data_ptr(), out_cnt.data_ptr(), wk, tile,
                None if splits is None else splits.data_ptr(), stream)
    _build.check(rc, "merge_path")
    merge_path.launches += 1
    return out_keys, out_cnt


merge_path.launches = 0


def _pass_bytes(rows: int, wk: int, payload: bool) -> int:
    """Shared memory of a merge_pass tile: two stages of the key and
    payload windows and the source row of each output. Up to 7 columns
    (csrc/merge_path.cu pass_shape) the keys are packed, with slack words
    for the 16-byte copies; above (wide_shape), rows sit at the odd stride
    of wk | 1 words."""
    if wk > NARROW_KEY_COLS:
        return 16 * rows * ((wk | 1) + int(payload)) + 4 * rows
    stage = rows * wk + 4 + (rows + 4 if payload else 0)
    return 16 * stage + 4 * rows


def pass_tile_rows(wk: int, payload: bool) -> int:
    """Output rows of one merge_pass tile (csrc/merge_path.cu pass_rows):
    256 threads of 17, 9 or 5 rows for rows of up to 2, 5 or 7 columns
    (key columns and the payload); wider, of 5, 3 or 1 rows, the most that
    fit two stages in shared memory, else the most even rows below 256
    that fit (fewer than 2 past MAX_KEY_COLS)."""
    cols = wk + int(payload)
    if wk <= NARROW_KEY_COLS:
        return 256 * (17 if cols <= 2 else 9 if cols <= 5 else 5)
    for items in (5, 3, 1):
        if _pass_bytes(256 * items, wk, payload) <= SHARED_BYTES:
            return 256 * items
    return SHARED_BYTES // _pass_bytes(1, wk, payload) & ~1


def merge_tile_rows(wk: int) -> int:
    """Output rows of one tile of a wide merge_path (wk above 7 columns;
    csrc/merge_path.cu merge_rows): one row a thread of 256, the smallest
    of merge_pass' tiles with a payload, or pass_tile_rows' fewer rows
    where 256 do not fit."""
    return min(pass_tile_rows(wk, True), 256)


def _widest_keys() -> int:
    """The most key columns whose merge_pass tile, with a payload, still
    holds two rows (pass_tile_rows falls as rows widen)."""
    lo, hi = NARROW_KEY_COLS, SHARED_BYTES // 8
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if pass_tile_rows(mid, True) >= 2 else (lo, mid - 1)
    return lo


# The widest keys the kernels take: 7,261 columns (k <= 116,176)
MAX_KEY_COLS = _widest_keys()


def split_steps(m: int, run_len: int, tile: int) -> tuple[int, int]:
    """(pairs, steps) of a pass over m rows at tiles of `tile` rows: a run
    past the array is the array; each pair is served by `steps` tiles and
    has steps + 1 splits."""
    if m == 0:
        return 0, 0
    run = min(run_len, m)
    return -(-m // (2 * run)), -(-min(2 * run, m) // tile)


def _check_pass(keys, run_len, tile=1):
    if keys.dtype != torch.int64 or not keys.is_contiguous() or keys.dim() != 2:
        raise ValueError("merge_pass takes contiguous int64 keys [M, Wk]")
    if not 1 <= keys.shape[1] <= MAX_KEY_COLS or run_len < 1 or tile < 1:
        raise ValueError(f"merge_pass: key width {keys.shape[1]} (the "
                         f"kernels take 1 to {MAX_KEY_COLS} columns), run "
                         f"length {run_len}, tile {tile}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_pass: unsupported device {keys.device}")


def merge_splits_plain(keys, run_len, tile):
    """merge_splits by the stable sort of each pair: the A rows among the
    first d rows of the pair's merge are those among the first d of the
    sort's perm that come from the first run."""
    m = keys.shape[0]
    pairs, steps = split_steps(m, run_len, tile)
    out = torch.empty((pairs, steps + 1), dtype=torch.int64,
                      device=keys.device)
    run = min(run_len, m)
    for p in range(pairs):
        pair = keys[2 * p * run:2 * (p + 1) * run]
        from_a = sort_rows_plain(pair)[1] < min(run, len(pair))
        taken = torch.cat([from_a.new_zeros(1, dtype=torch.int64),
                           torch.cumsum(from_a, 0)])
        d = torch.arange(steps + 1, device=keys.device) * tile
        out[p] = taken[d.clamp(max=len(pair))]
    return out.reshape(-1)


def merge_splits(keys, run_len, tile):
    """The splits of a merge pass over sorted runs of `run_len` rows of
    keys [M, Wk] at tiles of `tile` output rows -> int64 [pairs x (steps +
    1)] (split_steps): entry p (steps + 1) + t is the number of rows of
    pair p's first run among the first min(t tile, pair rows) rows of the
    pair's stable merge."""
    _check_pass(keys, run_len, tile)
    if keys.device.type == "cpu":
        return merge_splits_plain(keys, run_len, tile)
    m, wk = keys.shape
    pairs, steps = split_steps(m, run_len, tile)
    splits = torch.empty(pairs * (steps + 1), dtype=torch.int64,
                         device=keys.device)
    fn = _build.load("merge_path", _SIGNATURES).jf_merge_splits
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = fn(keys.data_ptr(), m, run_len, tile, splits.data_ptr(), wk,
                stream)
    _build.check(rc, "merge_splits")
    merge_splits.launches += 1
    return splits


merge_splits.launches = 0


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
    _check_pass(keys, run_len)
    m, wk = keys.shape
    if payload is not None and (
            payload.dtype != torch.int64 or not payload.is_contiguous()
            or payload.shape != (m,) or payload.device != keys.device):
        raise ValueError("merge_pass: a payload is a contiguous int64 [M] "
                         "column on the keys' device")
    dev = keys.device
    if dev.type == "cpu":
        return merge_pass_plain(keys, run_len, payload)
    tile = pass_tile_rows(wk, payload is not None)
    splits = merge_splits(keys, run_len, tile)
    out_k = torch.empty_like(keys)
    out_p = None if payload is None else torch.empty_like(payload)
    fn = _build.load("merge_path", _SIGNATURES).jf_merge_pass
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(keys.data_ptr(),
                None if payload is None else payload.data_ptr(), m, run_len,
                tile, splits.data_ptr(), out_k.data_ptr(),
                None if out_p is None else out_p.data_ptr(), wk, stream)
    _build.check(rc, "merge_pass")
    merge_pass.launches += 1
    return out_k, out_p


merge_pass.launches = 0
