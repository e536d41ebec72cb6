"""Kernel-table rows 9 and 10: the plain versions of kernels/window.py
against the Pallas probes they replace, run in interpret mode, and at the
edges the merge reaches (windows past the end, negative and wrapping
shifts, offsets and shifts held in scalar tensors).

Row 9 is test_unaligned_dma's kernel (experiments/pallas_probe2.py:141-
167): a DMA of x[off : off + 4096] out of u32[65536], `off` a prefetched
scalar. Row 10 is test_dynamic_roll's kernel (:182-198): pltpu.roll of
u32[8, 128] by a prefetched shift. Both kernel bodies are rebuilt here as
the probe builds them; on CPU tensors the wrappers take the plain path and
launch nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jellyfish_tpu_torch.kernels.window import (
    pad_of,
    roll_lanes,
    roll_lanes_plain,
    window_rows,
    window_rows_plain,
)
from jellyfish_tpu_torch.ops import multiword as mw

torch.set_num_threads(1)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _pallas_window(x, off, blk):
    """test_unaligned_dma's kernel, interpret mode."""

    def kernel(off_ref, hbm_ref, o_ref, scratch, sem):
        off = off_ref[0]
        dma = pltpu.make_async_copy(hbm_ref.at[pl.ds(off, blk)], scratch, sem)
        dma.start()
        dma.wait()
        o_ref[:] = scratch[:]

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((blk,), jnp.uint32),
                        pltpu.SemaphoreType.DMA],
    )
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((blk,), jnp.uint32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray([off], dtype=jnp.int32), jnp.asarray(x)))


def _pallas_roll(x, s):
    """test_dynamic_roll's kernel, interpret mode."""

    def kernel(s_ref, x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], shift=s_ref[0], axis=1)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
    )
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray([s], dtype=jnp.int32), jnp.asarray(x)))


@pytest.mark.parametrize("off", [0, 128, 131, 7777])
def test_window_rows_plain_matches_unaligned_dma(off):
    """Row 9 at the probe's shape: u32[65536] as one key column, a window
    of 4096 rows at an aligned and an unaligned runtime offset."""
    rng = np.random.default_rng(900)
    x = _u32(rng, 1 << 16)
    want = _pallas_window(x, off, 4096)
    np.testing.assert_array_equal(want, x[off:off + 4096])
    keys = torch.from_numpy(x.astype(np.int64)).reshape(-1, 1)
    counts = torch.from_numpy(rng.integers(0, 1 << 40, 1 << 16))
    for o in (off, torch.tensor(off)):
        k, c = window_rows(keys, counts, o, 4096)
        np.testing.assert_array_equal(k[:, 0].numpy().astype(np.uint32), want)
        assert torch.equal(c, counts[off:off + 4096])
    assert window_rows.launches == 0


@pytest.mark.parametrize("s", [1, 37])
def test_roll_lanes_plain_matches_dynamic_roll(s):
    """Row 10 at the probe's shape: u32[8, 128] rolled along the lanes by
    a runtime shift."""
    rng = np.random.default_rng(1000 + s)
    x = _u32(rng, (8, 128))
    want = _pallas_roll(x, s)
    np.testing.assert_array_equal(want, np.roll(x, s, axis=1))
    t = torch.from_numpy(x.astype(np.int64))
    for shift in (s, torch.tensor(s)):
        got = roll_lanes(t, shift)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert roll_lanes.launches == 0


@pytest.mark.parametrize("wk", [1, 3, 4, 7])
@pytest.mark.parametrize("off,n", [
    (0, 100), (37, 100), (950, 100), (990, 100), (1000, 5), (5000, 3),
    (-20, 50), (-200, 50), (0, 0), (3, 1500),
])
def test_window_rows_edges(wk, off, n):
    """Windows inside, across and past the end of a 1000-row run (and
    before its start): rows outside [0, M) are PAD rows with count 0."""
    rng = np.random.default_rng(wk * 10_000 + off % 997 + n)
    m = 1000
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (m, wk)))
    counts = torch.from_numpy(rng.integers(1, 1 << 20, m))
    k, c = window_rows(keys, counts, off, n)
    assert k.shape == (n, wk) and c.shape == (n,)
    pad = mw.PAD_PACKED if wk == 1 else mw.M32
    assert pad_of(wk) == pad
    for i in range(n):
        r = off + i
        if 0 <= r < m:
            assert torch.equal(k[i], keys[r]) and int(c[i]) == int(counts[r])
        else:
            assert (k[i] == pad).all() and int(c[i]) == 0
    k2, c2 = window_rows_plain(keys, counts, torch.tensor(off), n)
    assert torch.equal(k, k2) and torch.equal(c, c2)


@pytest.mark.parametrize("shape", [(8, 128), (1, 1000), (3, 7)])
@pytest.mark.parametrize("s", [0, 1, -1, 5, -5, 127, 128, 129, 1000, -1001,
                               3 * 1000 + 17])
def test_roll_lanes_edges(shape, s):
    """Shift 0, negative shifts and shifts larger than the row, against
    np.roll; a slab's rotation by -cursor * Wk keeps its rows whole."""
    rng = np.random.default_rng(abs(s) + shape[1])
    x = rng.integers(-(1 << 62), 1 << 62, shape)
    got = roll_lanes(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.roll(x, s, axis=1))
    assert torch.equal(roll_lanes_plain(torch.from_numpy(x), s), got)


def test_roll_of_a_slab_by_its_cursor():
    """The merge's compaction: the [1, M * Wk] view of a slab's keys
    rolled by -cursor * Wk and its [1, M] counts by -cursor put the unread
    rows first, each row whole."""
    rng = np.random.default_rng(5)
    m, wk, cursor = 300, 4, 217
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (m, wk)))
    counts = torch.from_numpy(rng.integers(0, 1 << 30, m))
    cur = torch.tensor(cursor)
    k = roll_lanes(keys.view(1, -1), cur * -wk).view(-1, wk)
    c = roll_lanes(counts.view(1, -1), -cur).view(-1)
    assert torch.equal(k[:m - cursor], keys[cursor:])
    assert torch.equal(c[:m - cursor], counts[cursor:])
    assert torch.equal(k[m - cursor:], keys[:cursor])


def test_wrappers_check_their_inputs():
    keys = torch.zeros((10, 2), dtype=torch.int64)
    counts = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        window_rows(keys.int(), counts, 0, 4)
    with pytest.raises(ValueError, match=r"\[M, Wk\]"):
        window_rows(keys, counts[:5], 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        window_rows(keys.t(), counts[:2], 0, 4)
    with pytest.raises(ValueError, match="n = -1"):
        window_rows(keys, counts, 0, -1)
    with pytest.raises(ValueError, match="contiguous int64"):
        roll_lanes(keys.t(), 1)
    with pytest.raises(ValueError, match="contiguous int64"):
        roll_lanes(counts, 1)


@pytest.mark.parametrize("wk", [1, 3, 4])
@pytest.mark.parametrize("off", [
    1001, 1000,        # inside the run: an odd and an even off * wk
    -777, -778,        # across its start
    4001, 4000,        # across its end
    5000, 5001,        # wholly past the end (from its last row + 1)
    -3000, -3001,      # wholly before its start
])
def test_window_rows_plain_at_both_parities(wk, off):
    """Windows of 3000 rows of a 5000-row run, several of the card
    kernel's tiles of 2048 words, at an odd and an even first source word
    off * Wk (its 16-byte and 8-byte loads), across either end and wholly
    outside the run: rows outside [0, M) are PAD rows with count 0, the
    others the run's rows, against numpy."""
    rng = np.random.default_rng(9000 + 10 * wk + off % 7)
    m, n = 5000, 3000
    keys = rng.integers(0, 1 << 32, (m, wk))
    counts = rng.integers(1, 1 << 40, m)
    rows = np.arange(off, off + n)
    inside = (rows >= 0) & (rows < m)
    want_k = np.full((n, wk), pad_of(wk), dtype=np.int64)
    want_c = np.zeros(n, dtype=np.int64)
    want_k[inside] = keys[rows[inside]]
    want_c[inside] = counts[rows[inside]]
    for o in (off, torch.tensor(off)):
        for fn in (window_rows_plain, window_rows):
            k, c = fn(torch.from_numpy(keys), torch.from_numpy(counts), o, n)
            np.testing.assert_array_equal(k.numpy(), want_k)
            np.testing.assert_array_equal(c.numpy(), want_c)
    assert window_rows.launches == 0
