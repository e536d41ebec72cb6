"""jellyfish_tpu_torch.ops.bitsarray.BitsArray (device="cpu") against
jellyfish_tpu.ops.bitsarray.BitsArray: the same words after the same
batches of updates (exact). The port resolves an id's updates with the
pair sort of kernels/sort.py (here on the kernels' plain versions)."""

import numpy as np
import pytest
import torch

from jellyfish_tpu.ops.bitsarray import BitsArray as JaxBits
from jellyfish_tpu_torch.ops.bitsarray import BitsArray

torch.set_num_threads(1)

BITS = [1, 2, 3, 5, 7, 32]
SIZE = 777


def _batch(rng, n, bits):
    """Ids with repeats (half of them from 40 hot ids) and a few past the
    end, which are dropped; values wider than the field, which is masked."""
    ids = rng.integers(0, SIZE + 10, n)
    hot = rng.random(n) < 0.5
    ids[hot] = rng.integers(0, 40, int(hot.sum()))
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return ids.astype(np.uint32), vals.astype(np.uint32)


def _same(port, ref):
    assert port.to_bytes() == ref.to_bytes()
    np.testing.assert_array_equal(port.values(), ref.values())


@pytest.mark.parametrize("op", ["set", "fetch_or", "fetch_max"])
@pytest.mark.parametrize("bits", BITS)
def test_updates_match_jax(bits, op):
    """Three batches of one update kind: the last value of an id in batch
    order wins for set; or and max fold every value of an id."""
    rng = np.random.default_rng(10 * bits + len(op))
    port, ref = BitsArray(bits, SIZE, device="cpu"), JaxBits(bits, SIZE)
    for n in (300, 1, 1000):
        ids, vals = _batch(rng, n, bits)
        getattr(port, op)(ids, vals)
        getattr(ref, op)(ids, vals)
        _same(port, ref)
    assert ref.values().any()


@pytest.mark.parametrize("bits", BITS)
def test_mixed_updates_and_reads_match_jax(bits):
    """set, fetch_or, fetch_max in turn, then get (ids past the end read
    0), item access, and the word dump read back."""
    rng = np.random.default_rng(500 + bits)
    port, ref = BitsArray(bits, SIZE, device="cpu"), JaxBits(bits, SIZE)
    for op in ("set", "fetch_or", "fetch_max", "set", "fetch_max"):
        ids, vals = _batch(rng, 400, bits)
        getattr(port, op)(torch.from_numpy(ids.astype(np.int64)), vals)
        getattr(ref, op)(ids, vals)
    _same(port, ref)
    q = rng.integers(0, SIZE + 50, 200)
    np.testing.assert_array_equal(port.get(q), ref.get(q))
    assert port[5] == ref[5] and port[SIZE - 1] == ref[SIZE - 1]
    back = BitsArray.from_bytes(bits, SIZE, ref.to_bytes(), device="cpu")
    _same(back, ref)
    with pytest.raises(ValueError):
        BitsArray.from_bytes(bits, SIZE + 1000, ref.to_bytes(), device="cpu")


def test_entries_per_word_and_bad_widths():
    a = BitsArray(5, 13, device="cpu")
    assert a.entries_per_word == 6 and a.data.shape == (3,)
    a.set(np.array([]), np.array([]))  # an empty batch
    assert not a.values().any()
    for bad in (0, 33):
        with pytest.raises(ValueError):
            BitsArray(bad, 10, device="cpu")
