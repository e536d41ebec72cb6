"""K3: the bitonic sorting network on tiles of key rows.

`block_sort`, `block_merge`, `exchange_stages` and `flip` launch
csrc/bitonic.cu on CUDA tensors and run their plain versions
(`block_sort_plain`, `block_merge_plain`, `exchange_stages_plain`,
`flip_plain`) on CPU tensors; any other device raises. Keys are store key
columns [M, Wk] int64 (ops/multiword.py), compared from the last column; a
payload is an optional int64 [M] column that travels with its row.

They port the Pallas bitonic kernels of experiments/ (PERF.md, kernel table
rows 6, 7, 8, 11 and 12). A Pallas u32 tile [R, 128] is a run of key rows
here in row-major order: tile row r, lane c is position 128 r + c, so a
step between tile rows r and r + m is a step at distance 128 m.

An `exchange_stages` call runs its steps in kernel passes over device
memory (`exchange_plan`): each run of up to four consecutive halving steps
(three for rows of more than four columns: jf_exchange_group_limit) is one
pass of jf_exchange_group, the first step of the run plain or mirrored;
any other step (a lone distance, a transposed read, a flip) is one pass of
jf_exchange.

`block_sort.launches`, `block_merge.launches`, `exchange_stages.launches`
and `flip.launches` count the calls that launched each entry point on the
card: a `block_sort`, `block_merge` or `flip` call is one kernel launch;
`exchange_stages.passes` counts `exchange_stages`' kernel launches, one
where each pass launches, and `exchange_stages.mirror_launches` its calls whose first step is
mirrored. The counting path runs
`block_sort` only; the pair sort of kernels/sort.py (BitsArray's batch
updates; the Bloom insert sorts by kernels/radix.py) runs `block_sort`
once, then `exchange_stages` with a mirrored
first step (rows 8 and 12) and `block_merge` (row 8's in-tile steps). `flip`
and the transposes (row 11) lie on no path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from jellyfish_tpu_torch.kernels import _build
from jellyfish_tpu_torch.kernels.merge_path import (
    MAX_KEY_COLS,
    NARROW_KEY_COLS,
    SHARED_BYTES,
)
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops.count import row_order

__all__ = [
    "Pass", "block_merge", "block_merge_plain", "block_sort",
    "block_sort_plain", "exchange_plan", "exchange_stages",
    "exchange_stages_plain", "flip", "flip_plain", "tile_rows",
    "STEP_KEY_COLS",
]

SHARED_TILE_BYTES = 96 * 1024  # a tile's rows; csrc/bitonic.cu kTileBytes
# block_merge, exchange_stages and flip take keys of at most 7 columns (the
# pair sort's rows have 1-2); block_sort takes up to MAX_KEY_COLS
STEP_KEY_COLS = NARROW_KEY_COLS
PAD = (1 << 63) - 1            # INT64_MAX: pad rows sort last
_SQUARE = 128                  # side of the transposed square blocks

_EXCHANGE, _FLIP, _MIRROR = range(3)  # jf_exchange modes

_P, _N, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "jf_block_sort": (_I, [_P, _P, _P, _P, _N, _I, _I, _P]),
    "jf_block_merge": (_I, [_P, _P, _P, _P, _N, _I, _I, _P]),
    "jf_exchange": (_I, [_P, _P, _P, _P, _N, _I, _I, _I, _I, _P]),
    "jf_exchange_group": (_I, [_P, _P, _P, _P, _N, _I, _I, _I, _I, _P]),
    "jf_exchange_group_limit": (_I, [_I, _I]),
}


def tile_rows(wk: int, payload: bool) -> int:
    """The tile entries' largest tile: the largest power of two T with T
    rows of (wk + payload) int64 columns in SHARED_TILE_BYTES; above
    NARROW_KEY_COLS (the wide block sort, csrc/bitonic.cu
    wide_tile_bytes), with the rows at an odd stride of wk | 1 columns,
    the payload and an 8-byte slot for each row's proxy and number, in
    SHARED_BYTES."""
    cols = wk + int(payload)
    if wk <= NARROW_KEY_COLS:
        return 1 << ((SHARED_TILE_BYTES // (8 * cols)).bit_length() - 1)
    row = 8 * ((wk | 1) + int(payload) + 1)
    return 1 << ((SHARED_BYTES // row).bit_length() - 1)


class Pass(NamedTuple):
    """One kernel pass of exchange_stages: steps at `distances`, the
    first in `mode` (the others plain), the first reading its input
    through the 128 x 128 transpose when `transposed`. Several distances
    are one jf_exchange_group pass, one distance a jf_exchange pass."""

    distances: tuple
    mode: int
    transposed: bool = False


def exchange_plan(distances, mirror=False, transposes=0, limit=4):
    """The passes of exchange_stages(distances, transposes, mirror): the
    distances cut, in order, into maximal runs of consecutive halvings of
    at most `limit` steps, each one pass. A mirrored step can only start a
    run. The transposed read of an odd number of transposes (row 11) takes
    its first step alone."""
    plan, i = [], 0
    while i < len(distances):
        mode = _MIRROR if mirror and i == 0 else _EXCHANGE
        transposed = transposes % 2 == 1 and i == 0
        j = i + 1
        if not transposed:
            while (j < len(distances) and j - i < limit
                   and 2 * distances[j] == distances[j - 1]):
                j += 1
        plan.append(Pass(tuple(distances[i:j]), mode, transposed))
        i = j
    return plan


def _log2(x: int, what: str) -> int:
    if x < 1 or x & (x - 1):
        raise ValueError(f"{what} must be a power of two, got {x}")
    return x.bit_length() - 1


def _check(keys, payload=None, max_cols=STEP_KEY_COLS):
    if keys.dtype != torch.int64 or not keys.is_contiguous() or keys.dim() != 2:
        raise ValueError("bitonic kernels take contiguous int64 keys [M, Wk]")
    if not 1 <= keys.shape[1] <= max_cols:
        raise ValueError(f"bitonic kernels: key width {keys.shape[1]} (this "
                         f"entry takes 1 to {max_cols} columns)")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bitonic kernels: unsupported device {keys.device}")
    if payload is not None and (
            payload.dtype != torch.int64 or not payload.is_contiguous()
            or payload.shape != (keys.shape[0],)
            or payload.device != keys.device):
        raise ValueError("a payload is a contiguous int64 [M] column on the "
                         "keys' device")


# -- plain versions --------------------------------------------------------


def block_sort_plain(keys, payload=None, tile=None):
    """A stable per-tile sort: the LSD chain of torch.sort over a
    [M/T, T] view, key columns first and the payload last. A ragged last
    tile is padded with PAD rows, which sort after every real row."""
    m, wk = keys.shape
    tile = tile or tile_rows(wk, payload is not None)
    pad = -m % tile
    k = torch.cat([keys, keys.new_full((pad, wk), PAD)]).view(-1, tile, wk)
    p = None
    if payload is not None:
        p = torch.cat([payload, payload.new_full((pad,), PAD)]).view(-1, tile)
    order = row_order(k, p)
    k = torch.gather(k, 1, order[..., None].expand_as(k)).reshape(-1, wk)[:m]
    if p is not None:
        p = torch.gather(p, 1, order).reshape(-1)[:m]
    return k, p


def block_merge_plain(keys, payload, tile):
    """The plain steps at distances tile/2, ..., 1 on each tile, the key
    compared and the payload carried: exchange_stages_plain's rule. It
    sorts the keys of a tile that is a bitonic sequence."""
    return exchange_stages_plain(
        keys, payload, [tile >> i for i in range(1, tile.bit_length())])


def _transposed_plain(x):
    """Each run of 128 * 128 rows transposed as a square."""
    return (x.reshape(-1, _SQUARE, _SQUARE, *x.shape[1:]).transpose(1, 2)
            .reshape(x.shape))


def exchange_stages_plain(keys, payload=None, distances=(), transposes=0,
                          mirror=False):
    """`transposes` transposes of each 128 x 128 square of rows, then one
    ascending compare-exchange step per distance d in `distances`: row i
    meets row i + d inside each 2d-row block, and the smaller key goes
    first (equal keys stay). With `mirror`, the first step is mirrored:
    row j of each 2d-row block meets row 2d - 1 - j. The payload is
    carried, not compared."""
    k, p = keys, payload
    if transposes % 2:
        k = _transposed_plain(k)
        p = None if p is None else _transposed_plain(p)
    wk = k.shape[1]
    for i, d in enumerate(distances):
        # a mirrored step is a plain step with each block's upper half
        # read, and written back, in reverse
        turn = (lambda x: x.flip(1)) if mirror and i == 0 else (lambda x: x)
        y = k.reshape(-1, 2, d, wk)
        lo, hi = y[:, 0], turn(y[:, 1])
        swap = mw.mw_less(hi, lo)
        k = torch.stack([mw.mw_select(swap, hi, lo),
                         turn(mw.mw_select(swap, lo, hi))], 1).reshape(-1, wk)
        if p is not None:
            yp = p.reshape(-1, 2, d)
            plo, phi = yp[:, 0], turn(yp[:, 1])
            p = torch.stack([torch.where(swap, phi, plo),
                             turn(torch.where(swap, plo, phi))],
                            1).reshape(-1)
    return k.contiguous(), None if p is None else p.contiguous()


def flip_plain(keys, tile):
    """Each tile of `tile` rows reversed."""
    return keys.view(-1, tile, keys.shape[1]).flip(1).reshape(keys.shape)


# -- kernels ---------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


class _Launcher:
    """The K3 library on one device and its current stream; each call
    runs with that device current and checks the returned CUDA error."""

    def __init__(self, dev):
        self.lib = _build.load("bitonic", _SIGNATURES)
        self.dev = dev
        with torch.cuda.device(dev):
            self.stream = torch.cuda.current_stream(dev).cuda_stream

    def tiles(self, entry, src, dst, m, wk, log_t):
        """jf_block_sort or jf_block_merge on tiles of 2^log_t rows."""
        with torch.cuda.device(self.dev):
            rc = getattr(self.lib, f"jf_{entry}")(
                _ptr(src[0]), _ptr(src[1]), _ptr(dst[0]), _ptr(dst[1]), m,
                wk, log_t, self.stream)
        _build.check(rc, f"bitonic {entry}")

    def group_limit(self, wk, payload):
        """The most steps a jf_exchange_group pass runs on these rows."""
        return self.lib.jf_exchange_group_limit(wk, int(payload is not None))

    def passes(self, src, dst, m, wk, plan):
        """Launch the kernel passes of `plan`: the first reads `src` and
        writes `dst`, the others update `dst` in place (each thread reads
        and writes only its own rows). Returns the number launched."""
        launched = 0
        for i, ps in enumerate(plan):
            ik, ip = src if i == 0 else dst
            log_s = _log2(ps.distances[-1], "distance")
            with torch.cuda.device(self.dev):
                if len(ps.distances) > 1:
                    rc = self.lib.jf_exchange_group(
                        _ptr(ik), _ptr(ip), _ptr(dst[0]), _ptr(dst[1]), m,
                        wk, log_s, len(ps.distances),
                        int(ps.mode == _MIRROR), self.stream)
                else:
                    rc = self.lib.jf_exchange(
                        _ptr(ik), _ptr(ip), _ptr(dst[0]), _ptr(dst[1]), m,
                        wk, log_s, ps.mode, int(ps.transposed), self.stream)
            _build.check(rc, "bitonic exchange")
            launched += 1
        return launched


def _empty_like(keys, payload):
    return (torch.empty_like(keys),
            None if payload is None else torch.empty_like(payload))


def _tile_log(what, keys, payload, tile, max_cols):
    """log2 of a tile entry's tile (default and at most tile_rows(Wk,
    payload): one tile on chip)."""
    _check(keys, payload, max_cols)
    cap = tile_rows(keys.shape[1], payload is not None)
    tile = tile or cap
    log_t = _log2(tile, "tile")
    if tile > cap:
        raise ValueError(f"{what}: a tile of {tile} rows exceeds shared "
                         f"memory ({cap} rows)")
    return log_t


def block_sort(keys, payload=None, tile=None):
    """Sort each tile of `tile` rows (a power of two, at most and by
    default tile_rows(Wk, payload)), comparing the key first and then the
    payload, so that a row-index payload gives a stable order. Keys of any
    width up to MAX_KEY_COLS. Returns (keys, payload or None). Longer runs
    are kernels/sort.sort_rows_blocked's work."""
    log_t = _tile_log("block_sort", keys, payload, tile, MAX_KEY_COLS)
    if keys.device.type == "cpu":
        return block_sort_plain(keys, payload, 1 << log_t)
    out = _empty_like(keys, payload)
    _Launcher(keys.device).tiles("block_sort", (keys, payload), out,
                                 *keys.shape, log_t)
    block_sort.launches += 1
    return out


block_sort.launches = 0


def block_merge(keys, payload, tile):
    """block_merge_plain on the card: the plain steps at distances
    tile/2, ..., 1 on each tile of `tile` rows (a power of two, at most
    tile_rows(Wk, payload); M whole tiles), the key compared and the
    payload (or None) carried. Returns (keys, payload or None)."""
    log_t = _tile_log("block_merge", keys, payload, tile, STEP_KEY_COLS)
    if keys.shape[0] % (1 << log_t):
        raise ValueError(f"block_merge: {keys.shape[0]} rows are not whole "
                         f"tiles of {1 << log_t}")
    if keys.device.type == "cpu":
        return block_merge_plain(keys, payload, 1 << log_t)
    out = _empty_like(keys, payload)
    _Launcher(keys.device).tiles("block_merge", (keys, payload), out,
                                 *keys.shape, log_t)
    block_merge.launches += 1
    return out


block_merge.launches = 0


def exchange_stages(keys, payload=None, distances=(), transposes=0,
                    mirror=False):
    """exchange_stages_plain on the card (rows 7, 8 and 11 of the kernel
    table; a mirrored first step takes row 12's place): at least one
    distance, each a power of two, M a multiple of twice each (and of
    128 * 128 for an odd number of transposes). The steps run in the
    passes of exchange_plan, at most jf_exchange_group_limit's a pass.
    Returns (keys, payload or None)."""
    _check(keys, payload)
    m, wk = keys.shape
    if not distances:
        raise ValueError("exchange_stages: no distance")
    if any(m % (2 << _log2(d, "distance")) for d in distances):
        raise ValueError("exchange_stages: M must be whole blocks of 2d rows")
    if transposes % 2 and m % (_SQUARE * _SQUARE):
        raise ValueError("exchange_stages: transposes need whole 128 x 128 "
                         "squares of rows")
    if keys.device.type == "cpu":
        return exchange_stages_plain(keys, payload, distances, transposes,
                                     mirror)
    launcher = _Launcher(keys.device)
    plan = exchange_plan(list(distances), mirror, transposes,
                         launcher.group_limit(wk, payload))
    out = _empty_like(keys, payload)
    exchange_stages.passes += launcher.passes((keys, payload), out, m, wk,
                                              plan)
    exchange_stages.launches += 1
    exchange_stages.mirror_launches += int(mirror)
    return out


exchange_stages.launches = 0
exchange_stages.passes = 0
exchange_stages.mirror_launches = 0


def flip(keys, tile):
    """Each tile of `tile` rows reversed (row 12 of the kernel table);
    `tile` is a power of two >= 2 dividing M."""
    _check(keys)
    m, wk = keys.shape
    log_t = _log2(tile, "tile")
    if log_t == 0 or m % tile:
        raise ValueError(f"flip: {m} rows are not whole tiles of {tile} >= 2")
    if keys.device.type == "cpu":
        return flip_plain(keys, tile)
    out = torch.empty_like(keys)
    _Launcher(keys.device).passes((keys, None), (out, None), m, wk,
                                  [Pass((tile // 2,), _FLIP)])
    flip.launches += 1
    return out


flip.launches = 0
