"""jellyfish_tpu_torch/ops/multiword.py against jellyfish_tpu/ops/multiword.py
on the same random limbs (exact: integer arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jellyfish_tpu.ops import multiword as jmw
from jellyfish_tpu_torch.ops import multiword as tmw
from jellyfish_tpu_torch.ops.count import sort_rows, sort_rows_plain

torch.set_num_threads(1)


def _limbs(rng, n, W):
    return rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    got = got.numpy()
    assert ((got >= 0) & (got <= tmw.M32)).all()
    np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 7])
def test_shifts_or_mask(W):
    rng = np.random.default_rng(100 + W)
    x = _limbs(rng, 64, W)
    y = _limbs(rng, 64, max(1, W - 1))
    for s in (0, 1, 5, 31, 32, 33, 63, 64, 100):
        for W_out in (None, W + 1, max(1, W - 1)):
            _same(tmw.mw_shift_left(_t(x), s, W_out),
                  jmw.mw_shift_left(jnp.asarray(x), s, W_out))
            _same(tmw.mw_shift_right(_t(x), s, W_out),
                  jmw.mw_shift_right(jnp.asarray(x), s, W_out))
    _same(tmw.mw_or(_t(x), _t(y)), jmw.mw_or(jnp.asarray(x), jnp.asarray(y)))
    for bits in (0, 1, 20, 32, 42, 64, 66, 200, 32 * W):
        _same(tmw.mw_and_mask_top(_t(x), bits),
              jmw.mw_and_mask_top(jnp.asarray(x), bits))


@pytest.mark.parametrize("W", [1, 2, 3, 7])
def test_compare_and_min(W):
    rng = np.random.default_rng(200 + W)
    a = _limbs(rng, 200, W)
    b = a.copy()
    # equal rows, rows differing only in a low limb, random rows
    b[50:100, 0] ^= rng.integers(0, 3, 50).astype(np.uint32)
    b[100:] = _limbs(rng, 100, W)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    np.testing.assert_array_equal(tmw.mw_less(ta, tb).numpy(),
                                  np.asarray(jmw.mw_less(ja, jb)))
    np.testing.assert_array_equal(tmw.mw_eq(ta, tb).numpy(),
                                  np.asarray(jmw.mw_eq(ja, jb)))
    _same(tmw.mw_min(ta, tb), jmw.mw_min(ja, jb))


@pytest.mark.parametrize("W", [1, 2, 3, 5])
def test_int_roundtrip(W):
    rng = np.random.default_rng(300 + W)
    x = _limbs(rng, 50, W)
    ints = tmw.to_ints(_t(x))
    assert list(ints) == list(jmw.to_ints(x))
    _same(tmw.from_ints(ints, W), jmw.from_ints(ints, W))


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_key_columns_order_and_roundtrip(W):
    """Store key columns sort like the unsigned integers of their limbs;
    packing round-trips, and the all-ones PAD packs to pad_key."""
    rng = np.random.default_rng(400 + W)
    x = _limbs(rng, 300, W)
    x[:20] = x[20:40]                 # duplicates
    x[40] = 0xFFFFFFFF                # the PAD pattern
    x[41, -1] = 0x80000000            # top bit set (sign of the packed form)
    cols = tmw.key_columns(_t(x))
    assert cols.shape[1] == (1 if W <= 2 else W)
    if W == 2:
        assert int(cols[40, 0]) == tmw.pad_key(W)
    if W == 1:  # no 32-bit key reaches the packed PAD
        assert (cols < tmw.pad_key(W)).all()
    ints = jmw.to_ints(x)
    order = np.array(sorted(range(len(ints)), key=lambda i: (ints[i], i)))
    np.testing.assert_array_equal(sort_rows_plain(cols)[1].numpy(), order)
    assert torch.equal(sort_rows(cols), cols[torch.from_numpy(order)])
    _same(tmw.limbs_of_key_columns(cols, W), x)
