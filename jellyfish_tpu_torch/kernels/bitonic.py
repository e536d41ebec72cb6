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
memory (`exchange_plan`): each run of consecutive halving steps is cut
into the fewest passes of at most tile_pass_steps (12 at Wk 1 keys only,
11 at Wk 1 + payload; 10 a pass where M rows would leave half the card's
streaming multiprocessors without a block), of equal lengths; a pass is
one launch of jf_exchange_tiles, which holds strided tiles (the rows of
one residue of the pass's last distance s in each 2d-row block,
`_sector_rows` residues side by side) on chip and runs the steps there,
the first one plain or mirrored, read through the 128 x 128 transpose or
not; a lone step is a pass of tiles of 2 rows. `flip` is jf_flip.
`exchange_tiles_plain` is the card's route in plain PyTorch
(`tile_pass_plain`: a pass's index map as the kernel lays out its
blocks).

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
import functools
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
    "exchange_stages_plain", "exchange_tiles_plain", "flip", "flip_plain",
    "pass_block_rows", "stride_block_rows", "stride_layouts",
    "tile_pass_plain",
    "tile_pass_steps", "tile_rows",
    "SMALL_BLOCK_ROWS", "STEP_KEY_COLS",
]

SHARED_TILE_BYTES = 96 * 1024  # a tile's rows; csrc/bitonic.cu kTileBytes
STRIDE_BYTES = 128 * 1024  # a strided-tile block's rows; kStrideBytes
SMALL_BLOCK_ROWS = 4096    # a strided-tile block's rows at a small M
_STRIDE_THREADS = 1024     # csrc/bitonic.cu kStrideThreads
# block_merge, exchange_stages and flip take keys of at most 7 columns (the
# pair sort's rows have 1-2); block_sort takes up to MAX_KEY_COLS
STEP_KEY_COLS = NARROW_KEY_COLS
PAD = (1 << 63) - 1            # INT64_MAX: pad rows sort last
_SQUARE = 128                  # side of the transposed square blocks

_P, _N, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "jf_block_sort": (_I, [_P, _P, _P, _P, _N, _I, _I, _P]),
    "jf_block_merge": (_I, [_P, _P, _P, _P, _N, _I, _I, _P]),
    "jf_exchange_tiles": (_I, [_P, _P, _P, _P, _N, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P]),
    "jf_flip": (_I, [_P, _P, _N, _I, _I, _P]),
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


def _stride_log_e(cols: int) -> int:
    """log2 of the rows a thread holds in the strided-tile pass
    (csrc/bitonic.cu StrideShape): 16 at one column, 8 at 2-4, else 4."""
    return 2 if cols > 4 else 4 if cols == 1 else 3


def stride_block_rows(wk: int, payload: bool) -> int:
    """The strided-tile pass's largest block (csrc/bitonic.cu StrideShape
    kLogMaxB): the largest power of two of rows of (wk + payload) int64
    columns in STRIDE_BYTES, at most 1024 threads' rows."""
    cols = wk + int(payload)
    rows = 1 << ((STRIDE_BYTES // (8 * cols)).bit_length() - 1)
    return min(rows, _STRIDE_THREADS << _stride_log_e(cols))


def _sector_rows(wk: int) -> int:
    """The consecutive rows (residues) a strided-tile block holds side by
    side so that its reads and writes fill 32-byte sectors: 4 at Wk 1 and
    2 (rows a thread reads and writes in registers by 8-byte words, as is
    a payload; at Wk 2 two rows fill a sector, but four measured faster),
    2 at Wk 3 and 1 from Wk 4 (rows staged through shared memory,
    neighbouring threads on neighbouring words)."""
    return 4 if wk <= 2 else 2 if wk == 3 else 1


def _staged(wk: int, transposed: bool) -> bool:
    """Whether a strided-tile pass reads and writes its rows through shared
    memory by words (rows of 3 columns or more, read without the
    transpose; from Wk 4 measured faster than by rows in registers, at Wk 2
    slower) or by rows, straight into and out of registers."""
    return wk > 2 and not transposed


def tile_pass_steps(wk: int, payload: bool, m: int = 0,
                    sms: int = 132) -> int:
    """The most steps one strided-tile pass runs on these rows: T = 2^g
    rows of each residue, the block's _sector_rows(wk) residues side by side
    in stride_block_rows (12 at Wk 1 keys only, 11 at Wk 1 + payload, 10
    at Wk 2 + payload).
    Where M rows would give such passes fewer blocks than half the `sms`
    streaming multiprocessors (an H100 SXM's 132 by default; M 0: no
    such limit), blocks of at most SMALL_BLOCK_ROWS: a lone block of a
    long pass takes longer than its rows in two short passes (PERF.md)."""
    rows = stride_block_rows(wk, payload)
    if m and m // rows < sms // 2:
        rows = min(rows, SMALL_BLOCK_ROWS)
    return (rows // _sector_rows(wk)).bit_length() - 1


def pass_block_rows(wk: int, payload: bool, steps: int) -> int:
    """The block of a strided-tile pass of `steps` steps: tiles of 2^steps
    rows, _sector_rows(wk) residues side by side, at least four warps'
    rows."""
    rows = max(_sector_rows(wk) << steps, 128 << _stride_log_e(wk + payload))
    return min(rows, stride_block_rows(wk, payload))


@functools.lru_cache(maxsize=None)
def stride_layouts(wk, payload, log_s, g, log_b, transposed, staged=False):
    """The layouts (csrc/bitonic.cu stride_kernel) a strided-tile pass of
    g steps at s = 2^log_s, blocks of 2^log_b rows, reads its rows in and
    writes them from: the first (last) steps' own, or the one in which
    neighbouring threads hold neighbouring block rows (`nat`) where a
    warp's rows then touch fewer 32-byte sectors. A warp's 32 rows of one
    register are a cube on five bits of the block row, each a bit of the
    device row (through the transpose for a transposed read), and touch
    2^(those bits at or above a sector's rows) sectors of keys (4 rows at
    Wk 1, 2 at Wk 2, 1 from Wk 3: exact at Wk 1, 2 and 4; at 3, 5, 6 and 7
    every layout ties) and of a payload (4 rows). A `staged` pass goes
    through shared memory instead, its rows read into the first steps'
    layout."""
    log_e = _stride_log_e(wk + int(payload))
    a_lo, nat = min(log_b - g, log_s), log_b - log_e
    layouts = []  # each group of steps' layout, as stride_kernel runs them
    top = a_lo + g - 1
    while top >= a_lo:
        layouts.append(min(max(top - log_e + 1, a_lo), nat))
        top = max(layouts[-1], a_lo) - 1
    first, last = layouts[0], layouts[-1]
    if staged:
        return first, last

    def sectors(j, read):
        keys = pays = 0
        for b in range(5):  # the bits of the block row a warp's threads set
            r = b if b < j else b + log_e
            x = r if r < a_lo else r + log_s - a_lo  # its bit of x_v
            if read and transposed and x < 14:
                x = x + 7 if x < 7 else x - 7
            keys += x >= {1: 2, 2: 1}.get(wk, 0)
            pays += x >= 2
        return (-(-wk // 4) << keys) + ((1 << pays) if payload else 0)

    return (nat if sectors(nat, True) < sectors(first, True) else first,
            nat if sectors(nat, False) < sectors(last, False) else last)


class Pass(NamedTuple):
    """One jf_exchange_tiles pass of exchange_stages: steps at
    `distances`, the first mirrored when `mirrored`, the input read through
    the 128 x 128 transpose when `transposed`."""

    distances: tuple
    mirrored: bool = False
    transposed: bool = False


def exchange_plan(distances, mirror=False, transposes=0, limit=12):
    """The passes of exchange_stages(distances, transposes, mirror): the
    distances cut, in order, into maximal runs of consecutive halvings,
    each run into the fewest passes of at most `limit` steps
    (tile_pass_steps), of lengths that differ by at most one, the longer
    first (a run of 12 at 11 a pass is 6 + 6, which measured faster than
    11 + 1 on an H100 at every width timed, PERF.md). Only the first pass is mirrored, and only it
    reads through the transpose (an odd number of transposes, row 11)."""
    plan, i = [], 0
    while i < len(distances):
        j = i + 1
        while j < len(distances) and 2 * distances[j] == distances[j - 1]:
            j += 1
        run = j - i
        parts = -(-run // limit)
        for k in range(parts):
            n = run // parts + (k < run % parts)
            plan.append(Pass(tuple(distances[i:i + n]), mirror and not plan,
                             transposes % 2 == 1 and not plan))
            i += n
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


def tile_pass_plain(keys, payload, ps, block):
    """One jf_exchange_tiles pass as the kernel lays out its rows: block b
    of `block` rows holds tiles q = b block / T + (0 ... block / T - 1),
    tile q the rows x_v = blk + j + i s (i < T) of residue j = q mod s of
    the 2d-row block q / s; a mirrored pass holds the upper half reversed,
    from residue s - 1 - j: tile row i >= T/2 is x_v ^ (d - 1), so that the
    mirrored step is a plain one at tile distance T/2 and the upper half's
    steps after it descend (equal keys stay); a transposed pass reads
    through the 128 x 128 transpose. Rows past M are pad rows, neither read
    nor written."""
    m, wk = keys.shape
    log_s, log_t = _log2(ps.distances[-1], "distance"), len(ps.distances)
    t_rows, log_d = 1 << log_t, log_s + log_t - 1
    blocks = -(-m // block)
    q = (torch.arange(blocks)[:, None] * (block >> log_t)
         + (torch.arange(block) >> log_t)[None]).reshape(-1)
    i = torch.arange(block).repeat(blocks) & (t_rows - 1)
    xv = (((q >> log_s) << (log_s + log_t)) + (q & ((1 << log_s) - 1))
          + (i << log_s))
    valid = xv < m
    x = xv
    if ps.mirrored:
        x = torch.where((xv >> log_d) & 1 == 1, xv ^ ((1 << log_d) - 1), xv)
    x = x[valid]
    y = x
    if ps.transposed:
        y = (x & ~16383) | ((x & 127) << 7) | ((x >> 7) & 127)
    k = keys.new_full((blocks * block, wk), PAD)
    k[valid] = keys[y]
    p = None
    if payload is not None:
        p = payload.new_full((blocks * block,), PAD)
        p[valid] = payload[y]
    if not ps.mirrored:
        k, p = block_merge_plain(k, p, t_rows)
    else:
        half = t_rows // 2
        k, p = exchange_stages_plain(k, p, [half])
        k, p = k.view(-1, 2, half, wk), None if p is None else p.view(
            -1, 2, half)
        # the upper half descends: reversed, its steps ascend
        lo = block_merge_plain(k[:, 0].reshape(-1, wk), None if p is None
                               else p[:, 0].reshape(-1), half)
        hi = block_merge_plain(k[:, 1].flip(1).reshape(-1, wk), None
                               if p is None else p[:, 1].flip(1).reshape(-1),
                               half)
        k = torch.stack([lo[0].view(-1, half, wk),
                         hi[0].view(-1, half, wk).flip(1)], 1).reshape(-1, wk)
        if p is not None:
            p = torch.stack([lo[1].view(-1, half), hi[1].view(-1, half)
                             .flip(1)], 1).reshape(-1)
    out_k = torch.empty_like(keys)
    out_k[x] = k[valid]
    if p is None:
        return out_k, None
    out_p = torch.empty_like(payload)
    out_p[x] = p[valid]
    return out_k, out_p


def exchange_tiles_plain(keys, payload=None, distances=(), transposes=0,
                         mirror=False, sms=132):
    """exchange_stages on the card's route in plain PyTorch, on a card of
    `sms` streaming multiprocessors: the passes of exchange_plan, each
    gathered, merged and scattered back as jf_exchange_tiles lays out its
    blocks (tile_pass_plain at pass_block_rows). Equals
    exchange_stages_plain."""
    m, wk = keys.shape
    k, p = keys, payload
    for ps in exchange_plan(list(distances), mirror, transposes,
                            tile_pass_steps(wk, payload is not None, m, sms)):
        block = pass_block_rows(wk, payload is not None, len(ps.distances))
        k, p = tile_pass_plain(k, p, ps, block)
    return k, p


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
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tiles(self, entry, src, dst, m, wk, log_t):
        """jf_block_sort or jf_block_merge on tiles of 2^log_t rows."""
        with torch.cuda.device(self.dev):
            rc = getattr(self.lib, f"jf_{entry}")(
                _ptr(src[0]), _ptr(src[1]), _ptr(dst[0]), _ptr(dst[1]), m,
                wk, log_t, self.stream)
        _build.check(rc, f"bitonic {entry}")

    def passes(self, src, dst, m, wk, plan):
        """Launch the jf_exchange_tiles passes of `plan`: the first reads
        `src` and writes `dst`, the others update `dst` in place (each
        block reads and writes only its own rows). Returns the number
        launched."""
        payload = src[1] is not None
        for i, ps in enumerate(plan):
            ik, ip = src if i == 0 else dst
            g = len(ps.distances)
            log_s = _log2(ps.distances[-1], "distance")
            log_b = _log2(pass_block_rows(wk, payload, g), "block")
            staged = _staged(wk, ps.transposed)
            with torch.cuda.device(self.dev):
                rc = self.lib.jf_exchange_tiles(
                    _ptr(ik), _ptr(ip), _ptr(dst[0]), _ptr(dst[1]), m, wk,
                    log_s, g, int(ps.mirrored), int(ps.transposed), log_b,
                    int(staged), *stride_layouts(wk, payload, log_s, g, log_b,
                                                 ps.transposed, staged),
                    self.stream)
            _build.check(rc, "bitonic exchange")
        return len(plan)

    def flip(self, src, dst, m, wk, log_t):
        with torch.cuda.device(self.dev):
            rc = self.lib.jf_flip(_ptr(src), _ptr(dst), m, wk, log_t,
                                  self.stream)
        _build.check(rc, "bitonic flip")


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
    passes of exchange_plan, at most tile_pass_steps(Wk, payload, M, the
    card's streaming multiprocessors) a pass.
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
                         tile_pass_steps(wk, payload is not None, m,
                                         launcher.sms))
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
    """Each tile of `tile` rows reversed (row 12 of the kernel table; one
    jf_flip launch); `tile` is a power of two >= 2 dividing M."""
    _check(keys)
    m, wk = keys.shape
    log_t = _log2(tile, "tile")
    if log_t == 0 or m % tile:
        raise ValueError(f"flip: {m} rows are not whole tiles of {tile} >= 2")
    if keys.device.type == "cpu":
        return flip_plain(keys, tile)
    out = torch.empty_like(keys)
    _Launcher(keys.device).flip(keys, out, m, wk, log_t)
    flip.launches += 1
    return out


flip.launches = 0
