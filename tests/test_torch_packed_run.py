"""ops/packed_run.py of jellyfish_tpu_torch against
jellyfish_tpu.ops.packed_run on the same runs (exact: bit patterns).

pack_run's stream, bucket index, p, cbits, escape positions and the used
prefix of the escape counts are bit-equal to the JAX function's (the
slots past n_esc hold arbitrary counts there, so only the prefix is
compared); unpack_run gives the run back. Cases: every key width from one
limb to seven and three wider (k = 127, 128 and 200: 8 and 13 limbs), 2k
at a limb boundary (k = 16, 32), a run ending in the PAD entry (whose
count, the pad total, is an escape), counts of 2^32 and more, escapes
beyond the default capacity (the retry), n = 1, rows past n, slices that
end inside a stream word, and a run that holds both a real all-ones key
and the PAD key, which the port keeps apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jellyfish_tpu.ops import packed_run as jpr
from jellyfish_tpu_torch.ops import multiword as mw
from jellyfish_tpu_torch.ops import packed_run as tpr

torch.set_num_threads(1)


def _run(rng, k, n, pad=False, n_esc=20, extra=0):
    """A finalized run in the JAX layout: (limbs [n + extra, W] uint32
    ascending, counts [n + extra] uint64); rows past n are PAD rows of
    count 0. With pad, the last of the n rows is the PAD entry."""
    key_bits = 2 * k
    W = mw.nwords(key_bits)
    m = n - pad
    limbs = rng.integers(0, 1 << 32, size=(3 * m + 8, W), dtype=np.uint64)
    top = key_bits - 32 * (W - 1)
    limbs[:, -1] &= np.uint64((1 << top) - 1)
    limbs = np.unique(limbs.astype(np.uint32), axis=0)
    # the JAX store holds a real all-ones key as the PAD pattern: leave it
    # out here (test_real_all_ones_key_beside_pad covers the port's)
    ones = np.array([0xFFFFFFFF] * (W - 1) + [(1 << top) - 1], np.uint32)
    limbs = limbs[~(limbs == ones).all(axis=1)]
    limbs = limbs[rng.permutation(len(limbs))[:m]]
    limbs = limbs[np.lexsort(limbs.T)]  # the last limb is the primary key
    assert len(limbs) == m
    counts = rng.geometric(0.3, size=m).astype(np.uint64)
    big = rng.choice(m, size=min(n_esc, m), replace=False)
    counts[big] = rng.integers(127, 1 << 40, size=len(big)).astype(np.uint64)
    if m > 3:
        counts[:3] = [126, 127, 1 << 32]
    ones = np.full((1 + extra if pad else extra, W), 0xFFFFFFFF, np.uint32)
    tail = np.zeros(len(ones), np.uint64)
    if pad:
        tail[0] = 5_000_000
    return (np.concatenate([limbs, ones]), np.concatenate([counts, tail]))


def _port_inputs(limbs, counts):
    cols = mw.key_columns(torch.from_numpy(limbs.astype(np.int64)))
    return cols.contiguous(), torch.from_numpy(counts.astype(np.int64))


def _u32(t):
    return t.numpy().view(np.uint32)


CASES = [  # (k, n, pad, escapes, rows past n)
    (5, 700, True, 10, 0),
    (11, 3000, False, 40, 5),
    (16, 2500, True, 25, 0),
    (21, 5000, True, 90, 3),
    (32, 4000, True, 30, 0),
    (33, 3000, False, 1500, 0),   # escapes overflow 1024 slots: retry
    (63, 2000, True, 15, 2),
    (100, 1500, True, 12, 0),
    (127, 1200, True, 10, 0),     # W = 8 and up: a record of 8-13 pieces
    (128, 900, False, 8, 1),
    (200, 800, True, 9, 0),
    (21, 1, False, 1, 0),
    (63, 1, True, 1, 0),
]


@pytest.mark.parametrize("k,n,pad,n_esc,extra", CASES,
                         ids=[f"k{c[0]}-n{c[1]}{'-pad' if c[2] else ''}"
                              f"-esc{c[3]}" for c in CASES])
def test_pack_matches_jax_and_round_trips(monkeypatch, k, n, pad, n_esc,
                                          extra):
    # slices of 97 rows: records of one stream word fall in two slices
    monkeypatch.setattr(tpr, "_SLICE", 97)
    rng = np.random.default_rng(1000 * k + n)
    limbs, counts = _run(rng, k, n, pad, n_esc, extra)
    key_bits = 2 * k
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    want = jpr.pack_run(jnp.asarray(limbs), jnp.asarray(lo), jnp.asarray(hi),
                        n, key_bits)
    keys, cnt = _port_inputs(limbs, counts)
    got = tpr.pack_run(keys[:n], cnt[:n], key_bits)
    assert (got.p, got.cbits, got.n, got.W) == (want.p, want.cbits, want.n,
                                                 want.W)
    np.testing.assert_array_equal(_u32(got.stream), np.asarray(want.stream))
    np.testing.assert_array_equal(_u32(got.index), np.asarray(want.index))
    np.testing.assert_array_equal(_u32(got.esc_pos), np.asarray(want.esc_pos))
    used = int((counts[:n] >= 127).sum())
    assert used >= min(n_esc, n - pad)
    for a, b in ((got.esc_lo, want.esc_lo), (got.esc_hi, want.esc_hi)):
        np.testing.assert_array_equal(_u32(a)[:used], np.asarray(b)[:used])
    assert got.device_bytes() == want.device_bytes()
    if n_esc > 1024:
        assert got.esc_pos.numel() > 1024

    k2, c2 = tpr.unpack_run(got)
    np.testing.assert_array_equal(k2.numpy(), keys[:n].numpy())
    np.testing.assert_array_equal(c2.numpy(), cnt[:n].numpy())
    jk, jl, jh = jpr.unpack_run(want)
    np.testing.assert_array_equal(
        mw.limbs_of_key_columns(k2, got.W).numpy(),
        np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(
        c2.numpy(), np.asarray(jl).astype(np.int64)
        | (np.asarray(jh).astype(np.int64) << 32))


@pytest.mark.parametrize("k", [5, 21, 32])
def test_real_all_ones_key_beside_pad(k):
    """The port keeps the real all-ones sortkey apart from the PAD key
    (W = 1, and W = 2 below 2k = 64): both pack to the same record, and
    unpack gives both back as they were."""
    rng = np.random.default_rng(k)
    key_bits = 2 * k
    vals = np.unique(rng.integers(0, (1 << key_bits) - 1, 300,
                                  dtype=np.uint64))
    vals = np.append(vals, np.uint64((1 << key_bits) - 1))
    cols = torch.from_numpy((vals ^ np.uint64(1 << 63)).view(np.int64))
    if k < 32:
        cols = torch.cat([cols, torch.tensor([mw.PAD_PACKED])])
    keys = cols.unsqueeze(1)
    cnt = torch.from_numpy(rng.integers(1, 300, len(keys)))
    run = tpr.pack_run(keys, cnt, key_bits)
    k2, c2 = tpr.unpack_run(run)
    assert torch.equal(k2, keys) and torch.equal(c2, cnt)


@pytest.mark.parametrize("n,k,cbits", [
    (1, 21, 7), (1000, 21, 7), (33_554_432, 21, 7), (10**9, 31, 9),
    (123_457, 63, 7), (5, 1, 3),
])
def test_packed_nbytes_matches_jax(n, k, cbits):
    for esc in (0, 17):
        assert (tpr.packed_nbytes(n, 2 * k, cbits=cbits, esc=esc)
                == jpr.packed_nbytes(n, 2 * k, cbits=cbits, esc=esc))
