"""The plain versions of the port's two CUDA kernels against the Pallas
kernels they replace, run in interpret mode (exact: integer data).

K1 merge_path_plain vs experiments/pallas_merge_probe.build_merge_n and a
stable numpy sort; K2 compact_plain vs
experiments/pallas_compact.compact_sorted_masked, whose output is
quantized (PAD rows may sit between tiles): it is compared on its live
rows. On CPU tensors the wrappers take the plain path and launch nothing.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.kernels.compact import compact, compact_plain
from jellyfish_tpu_torch.kernels.merge_path import (
    MAX_KEY_COLS,
    merge_path,
    merge_path_plain,
)
from jellyfish_tpu_torch.ops import multiword as mw

torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))


@pytest.fixture(scope="module")
def probe():
    os.environ["JF_PALLAS_INTERPRET"] = "1"
    import pallas_merge_probe as m
    assert m.INTERPRET
    return m


def _runs(rng, n, wk, shared=0):
    """Two sorted runs of n // 2 rows of [wk] 32-bit limbs. Apart from
    `shared` keys present in both runs, the top two limbs are distinct
    across both runs, so they decide the order (the Pallas merge compares
    two key limbs and keeps no order among equal keys)."""
    h = n // 2
    top = rng.choice(1 << (32 if wk == 1 else 52), 2 * h,
                     replace=False).astype(np.uint64)
    top[h:h + shared] = top[:shared]
    limbs = np.zeros((2 * h, wk), dtype=np.uint64)
    if wk == 1:
        limbs[:, 0] = top
    else:
        limbs[:, wk - 1] = top >> np.uint64(20)
        limbs[:, wk - 2] = top & np.uint64((1 << 20) - 1)
    for w in range(wk - 2):
        limbs[:, w] = rng.integers(0, 1 << 32, 2 * h, dtype=np.uint64)
    out = []
    for part in (limbs[:h], limbs[h:]):
        out.append(part[np.argsort(mw.to_ints(part), kind="stable")])
    return out


def _merge_plain(a, b, ca, cb, wk):
    ta = mw.key_columns(torch.from_numpy(a.astype(np.int64))).contiguous()
    tb = mw.key_columns(torch.from_numpy(b.astype(np.int64))).contiguous()
    ca, cb = torch.from_numpy(ca), torch.from_numpy(cb)
    k, c = merge_path_plain(ta, ca, tb, cb)
    # the wrapper on CPU tensors is the plain version and launches nothing
    k2, c2 = merge_path(ta, ca, tb, cb)
    assert torch.equal(k2, k) and torch.equal(c2, c)
    assert merge_path.launches == 0
    return mw.limbs_of_key_columns(k, wk).numpy().astype(np.uint32), c.numpy()


@pytest.mark.parametrize("wk", [1, 2, 4, 8, 13])
def test_merge_path_plain_matches_pallas(probe, wk):
    rng = np.random.default_rng(7000 + wk)
    n = 2 * probe.T_OUT
    h = n // 2

    # ties across the runs: a stable numpy sort of the concatenation,
    # A's copy of a shared key first
    a, b = _runs(rng, n, wk, shared=50)
    ca, cb = rng.integers(1, 1 << 31, h), rng.integers(1, 1 << 31, h)
    got_limbs, got_c = _merge_plain(a, b, ca, cb, wk)
    allk = np.concatenate([a, b]).astype(np.uint32)
    order = np.argsort(mw.to_ints(allk), kind="stable")
    np.testing.assert_array_equal(got_limbs, allk[order])
    np.testing.assert_array_equal(got_c, np.concatenate([ca, cb])[order])

    # the Pallas merge: top two limbs as (hi, lo) keys, the lower limbs
    # and the count as payloads
    a, b = _runs(rng, n, wk)
    got_limbs, got_c = _merge_plain(a, b, ca, cb, wk)

    def ops(x, c):
        x = x.astype(np.uint32)
        hi = x[:, -1] if wk > 1 else np.zeros(len(x), np.uint32)
        lo = x[:, -2] if wk > 1 else x[:, 0]
        return [hi, lo] + [x[:, w] for w in range(wk - 2)] + [
            c.astype(np.uint32)]

    f = probe.build_merge_n(2, n, max(wk - 2, 0) + 1)
    outs = [np.asarray(x) for x in
            f(*[jnp.asarray(v) for v in ops(a, ca) + ops(b, cb)])]
    want = [got_limbs[:, -1] if wk > 1 else np.zeros(n, np.uint32),
            got_limbs[:, -2] if wk > 1 else got_limbs[:, 0]]
    want += [got_limbs[:, w] for w in range(wk - 2)]
    want.append(got_c.astype(np.uint32))
    for o, w in zip(outs, want, strict=True):
        np.testing.assert_array_equal(o, w)


# densities at which the Pallas output stays within one 32768-row block:
# beyond it (e.g. 50% of 65536 rows) the Pallas kernel loses live rows
@pytest.mark.parametrize("W,density", [(1, 0.25), (2, 0.4), (3, 0.03)])
def test_compact_plain_matches_pallas(W, density):
    import pallas_compact as pc

    rng = np.random.default_rng(8000 + W)
    M = 2 * pc.BLOCK
    keys = np.sort(rng.integers(0, 1 << 32, (M, W), dtype=np.uint64)
                   .astype(np.uint32), axis=0)
    cnt = np.where(rng.random(M) < density,
                   rng.integers(1, 1 << 20, M), 0).astype(np.uint32)
    cnt[0] = 0
    cnt[-1] = 7
    tk = torch.from_numpy(keys.astype(np.int64))
    tc = torch.from_numpy(cnt.astype(np.int64))
    gk, gc, n = compact_plain(tk, tc)
    live = cnt != 0
    assert n == int(live.sum())
    np.testing.assert_array_equal(gk.numpy().astype(np.uint32), keys[live])
    np.testing.assert_array_equal(gc.numpy().astype(np.uint32), cnt[live])

    pk, pcnt, q = pc.compact_sorted_masked(
        jnp.asarray(keys), jnp.asarray(cnt), interpret=True)
    pk, pcnt, q = np.asarray(pk), np.asarray(pcnt), int(q)
    assert n <= q
    keep = pcnt != 0
    np.testing.assert_array_equal(pk[keep], gk.numpy().astype(np.uint32))
    np.testing.assert_array_equal(pcnt[keep], gc.numpy().astype(np.uint32))

    before = compact.launches
    k2, c2, n2 = compact(tk, tc)
    assert torch.equal(k2, gk) and torch.equal(c2, gc) and n2 == n
    assert compact.launches == before == 0


def test_wrappers_reject_bad_inputs():
    k = torch.zeros((4, 1), dtype=torch.int64)
    c = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        merge_path(k, c, k.to(torch.int32), c)
    wide = torch.zeros((4, MAX_KEY_COLS + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match=f"1 to {MAX_KEY_COLS} columns"):
        merge_path(wide, c, wide, c)  # wider than the widest instance
    with pytest.raises(ValueError):
        merge_path(torch.zeros((4, 8), dtype=torch.int64), c,
                   torch.zeros((4, 9), dtype=torch.int64), c)
    with pytest.raises(ValueError):
        compact(k, c[:3])
    with pytest.raises(ValueError):
        compact(k.t(), c)


@pytest.mark.parametrize("wk", [1, 4])
def test_compact_keep_mask(wk):
    """A keep mask picks the rows, whatever their count: rows of value 0
    are kept where the mask says so (merge -m -L 0)."""
    rng = np.random.default_rng(8100 + wk)
    m = 5000
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (m, wk)))
    cnt = torch.from_numpy(rng.integers(0, 3, m))
    keep = torch.from_numpy(rng.random(m) < 0.3)
    k2, c2, n = compact(keys, cnt, keep)
    assert n == int(keep.sum()) and (c2 == 0).any()
    assert torch.equal(k2, keys[keep]) and torch.equal(c2, cnt[keep])
    assert torch.equal(compact_plain(keys, cnt, keep)[0], k2)
    with pytest.raises(ValueError, match="keep mask"):
        compact(keys, cnt, keep.to(torch.int64))
    with pytest.raises(ValueError, match="keep mask"):
        compact(keys, cnt, keep[:10])
