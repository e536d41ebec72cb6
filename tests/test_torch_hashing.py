"""jellyfish_tpu_torch/ops/hashing.py against jellyfish_tpu/ops/hashing.py
(exact: integer arithmetic).

The masks carry the hash matrix from one package to the other: the same
seed gives the same GF2Matrix in both, and `masks_of_matrix` must derive
the same masks from it, or the two would hash differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jellyfish_tpu import gf2 as jgf2
from jellyfish_tpu.ops import hashing as jh
from jellyfish_tpu_torch import gf2 as tgf2
from jellyfish_tpu_torch.ops import hashing as th

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("k,lsize", [
    (2, 3), (15, 10), (16, 32), (21, 22), (21, 40), (31, 20), (32, 64),
    (33, 33), (63, 64), (100, 64), (100, 50),
])
def test_hash_roundtrip_matches_jax(k, lsize):
    c = 2 * k
    W = (c + 31) // 32
    seed = 5000 + k + lsize
    jm = jgf2.GF2Matrix.random_invertible(lsize, c, np.random.default_rng(seed))
    tm = tgf2.GF2Matrix.random_invertible(lsize, c, np.random.default_rng(seed))
    np.testing.assert_array_equal(tm.bit_matrix(), jm.bit_matrix())
    masks = th.masks_of_matrix(tm, W)
    inv = th.inverse_masks_of_matrix(tm, W)
    np.testing.assert_array_equal(masks, jh.masks_of_matrix(jm, W))
    np.testing.assert_array_equal(inv, jh.inverse_masks_of_matrix(jm, W))

    rng = np.random.default_rng(seed + 1)
    mers = rng.integers(0, 1 << 32, (256, W), dtype=np.uint64).astype(np.uint32)
    mers = np.asarray(jh.mw.mw_and_mask_top(jnp.asarray(mers), c))
    jmers = jnp.asarray(mers)

    got = th.gf2_apply_masks(_t(mers), masks, (lsize + 31) // 32)
    np.testing.assert_array_equal(
        _u32(got), np.asarray(jh.gf2_apply_masks(jmers, jnp.asarray(masks),
                                                 (lsize + 31) // 32)))
    sk = th.sortkey_of_mers(_t(mers), masks, k, lsize)
    want_sk = jax.jit(jh.sortkey_of_mers, static_argnums=(2, 3))(
        jmers, jnp.asarray(masks), k, lsize)
    np.testing.assert_array_equal(_u32(sk), np.asarray(want_sk))
    back = th.mers_of_sortkeys(sk, inv, k, lsize)
    np.testing.assert_array_equal(_u32(back), mers)
    want_back = jax.jit(jh.mers_of_sortkeys, static_argnums=(2, 3))(
        want_sk, jnp.asarray(inv), k, lsize)
    np.testing.assert_array_equal(_u32(back), np.asarray(want_back))


@pytest.mark.parametrize("k", [8, 16, 32])
def test_identity_hash(k):
    """masks None: the identity regime (size >= 4^k), sortkey = mer."""
    W = (2 * k + 31) // 32
    rng = np.random.default_rng(6000 + k)
    mers = _t(rng.integers(0, 1 << 32, (50, W), dtype=np.uint64))
    sk = th.sortkey_of_mers(mers, None, k, 2 * k)
    assert torch.equal(sk, mers)
    np.testing.assert_array_equal(
        np.asarray(jh.sortkey_of_mers(jnp.asarray(_u32(mers)), None, k, 2 * k)),
        _u32(sk))
    assert torch.equal(th.mers_of_sortkeys(sk, None, k, 2 * k), mers)
