"""jellyfish_tpu_torch.kernels.radix (the Bloom insert's pair sort; on CPU
tensors the wrapper runs its plain version) against jax.lax.sort([pos, wb],
num_keys=1), the sort of jellyfish_tpu/bloom.py, and numpy's stable
argsort: the keys equal JAX's exactly, the payloads equal the stable numpy
order exactly and JAX's as a multiset per key."""

import jax
import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.kernels.radix import (
    radix_passes,
    radix_sort_pairs,
    radix_sort_pairs_plain,
)

torch.set_num_threads(1)


def _pairs(rng, m, key_bits, negative=False):
    if negative:  # any int64
        keys = rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64,
                            endpoint=True)
    else:
        keys = rng.integers(0, 1 << key_bits, m, dtype=np.uint64).astype(
            np.int64)
    return keys, rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64,
                              endpoint=True)


def _jax_sort(keys, pay):
    with jax.enable_x64(True):
        k, p = jax.lax.sort([jax.numpy.asarray(keys),
                             jax.numpy.asarray(pay)], num_keys=1)
        return np.asarray(k), np.asarray(p)


def _check(keys, pay, key_bits):
    got_k, got_p = radix_sort_pairs(torch.from_numpy(keys),
                                    torch.from_numpy(pay), key_bits)
    assert got_k.shape == (len(keys), 1) and got_p.shape == (len(keys),)
    got_k, got_p = got_k[:, 0].numpy(), got_p.numpy()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[order])
    np.testing.assert_array_equal(got_p, pay[order])
    jk, jp = _jax_sort(keys, pay)
    np.testing.assert_array_equal(got_k, jk)
    # JAX's order of equal keys is its own: the same multiset per key
    np.testing.assert_array_equal(got_p[np.lexsort((got_p, got_k))],
                                  jp[np.lexsort((jp, jk))])


@pytest.mark.parametrize("case", ["ragged", "one", "ties"])
@pytest.mark.parametrize("key_bits", [1, 30, 31, 33, 47])
def test_matches_jax_and_stable_numpy(key_bits, case):
    """A ragged size (no power of two) with keys spread over all key_bits
    bits, a single pair, and few distinct keys (many ties)."""
    rng = np.random.default_rng(1000 * key_bits + len(case))
    m = {"ragged": 5003, "one": 1, "ties": 3001}[case]
    keys, pay = _pairs(rng, m, key_bits)
    if case == "ties":
        keys = keys[rng.integers(0, 40, m)]  # 40 distinct keys at most
    _check(keys, pay, key_bits)


@pytest.mark.parametrize("case", ["spread", "extremes", "ties"])
def test_64_bits_with_negative_keys(case):
    """key_bits 64: any int64, negative ones and both extremes, sorts as a
    signed value: keys spread over all 64 bits, keys near the extremes and
    zero (digits of all ones and all zeros), and few distinct keys."""
    rng = np.random.default_rng(64 + len(case))
    keys, pay = _pairs(rng, 4099, 64, negative=True)
    if case == "extremes":
        near = np.array([-(1 << 63), -(1 << 63) + 1, -257, -256, -1, 0, 1,
                         255, 256, (1 << 63) - 256, (1 << 63) - 1], np.int64)
        keys = near[rng.integers(0, len(near), len(keys))]
    elif case == "ties":
        keys = keys[rng.integers(0, 40, len(keys))]
    keys[:6] = [-(1 << 63), (1 << 63) - 1, -1, 0, 1, -(1 << 63)]
    assert (keys < 0).any()
    _check(keys, pay, 64)


@pytest.mark.parametrize("m", [0, 1, 2, 4097])
def test_edge_sizes_and_equal_keys(m):
    """M = 0 and 1, and all keys equal: the payload keeps its input
    order."""
    rng = np.random.default_rng(m)
    keys = np.full(m, 12345, np.int64)
    pay = rng.integers(0, 1 << 40, m).astype(np.int64)
    _check(keys, pay, 30)
    got_k, got_p = radix_sort_pairs(torch.from_numpy(keys)[:, None],
                                    torch.from_numpy(pay), 30)
    np.testing.assert_array_equal(got_p.numpy(), pay)


def test_plain_passes_and_key_shapes():
    """The plain version makes ceil(key_bits / 8) stable passes;
    keys [M] and [M, 1] give the same result; the CPU wrapper is the plain
    version and launches nothing."""
    rng = np.random.default_rng(9)
    keys, pay = _pairs(rng, 777, 30)
    k, p = torch.from_numpy(keys), torch.from_numpy(pay)
    calls = []
    sort = torch.sort

    def counting_sort(x, stable=False):
        calls.append(stable)
        return sort(x, stable=stable)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sort", counting_sort)
        flat = radix_sort_pairs_plain(k, p, 30)
    assert calls == [True] * radix_passes(30) == [True] * 4
    col = radix_sort_pairs(k[:, None], p, 30)
    assert torch.equal(flat[0], col[0]) and torch.equal(flat[1], col[1])
    assert radix_passes(64) == 8 and radix_passes(1) == 1
    assert radix_sort_pairs.launches == 0


@pytest.mark.parametrize("bad", [
    lambda k, p: (k.to(torch.int32), p, 30),
    lambda k, p: (k, p.to(torch.int32), 30),
    lambda k, p: (k[:, None].expand(-1, 2).contiguous(), p, 30),
    lambda k, p: (k, p[:-1], 30),
    lambda k, p: (k[::2], p[::2], 30),
    lambda k, p: (k, p, 0),
    lambda k, p: (k, p, 65),
])
def test_wrapper_raises_on_bad_input(bad):
    k = torch.arange(10, dtype=torch.int64)
    p = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError):
        radix_sort_pairs(*bad(k, p))


def test_wrapper_raises_on_digit_width_and_device():
    """The digit is 8 bits, not the caller's to choose; a device other
    than the CPU and CUDA raises."""
    k = torch.arange(10, dtype=torch.int64)
    with pytest.raises(TypeError):
        radix_sort_pairs(k, k.clone(), 30, digit_bits=10)
    with pytest.raises(ValueError):
        radix_sort_pairs(k.to("meta"), k.to("meta"), 30)
