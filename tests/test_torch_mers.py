"""jellyfish_tpu_torch/ops/mers.py against jellyfish_tpu/ops/mers.py on the
same packed chunks (exact: integer arithmetic). Chunks carry N bases,
ragged phase tails and both L % 32 == 0 and L % 32 == 16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jellyfish_tpu.ops import mers as jmers
from jellyfish_tpu_torch.ops import mers as tmers

torch.set_num_threads(1)

KS = [2, 15, 16, 21, 31, 32, 33, 63, 100]


@functools.cache
def _jax_extract(k, L, canonical):
    return jax.jit(functools.partial(
        jmers.extract_mers_packed, k=k, L=L, canonical=canonical
    ))


def _packed_chunk(rng, L, n_prob=0.03):
    """Random codes with N bases -> (pwords [L/16], validbits
    [ceil(L/32)]) uint32, the host packing of native/chunker.cpp."""
    codes = rng.integers(0, 4, L).astype(np.uint32)
    valid = rng.random(L) >= n_prob
    pw = (codes.reshape(-1, 16)
          << (2 * (15 - np.arange(16, dtype=np.uint32)))).sum(
              axis=1, dtype=np.uint32)
    vpad = np.zeros(32 * ((L + 31) // 32), dtype=np.uint32)
    vpad[:L] = valid
    vb = (vpad.reshape(-1, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)
    return pw, vb


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_extract_mers_packed(k, canonical):
    rng = np.random.default_rng(1000 + k + 7 * canonical)
    # L % 32 == 16 for even-indexed k, == 0 otherwise; both leave a
    # ragged last phase
    L = 16 * (2 * ((k + 40) // 32) + 1 + KS.index(k) % 2)
    chunks = [_packed_chunk(rng, L, n_prob=min(0.03, 0.3 / k))
              for _ in range(2)]
    pw = np.stack([c[0] for c in chunks])
    vb = np.stack([c[1] for c in chunks])
    # the port takes a batch of chunks in one call
    got_m, got_v = tmers.extract_mers_packed(_t(pw), _t(vb), k, L, canonical)
    f = _jax_extract(k, L, canonical)
    for b in range(2):
        want_m, want_v = f(jnp.asarray(pw[b]), jnp.asarray(vb[b]))
        np.testing.assert_array_equal(got_v[b].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(
            got_m[b].numpy().astype(np.uint32), np.asarray(want_m))
    assert got_v.any() and not got_v.all()


@pytest.mark.parametrize("k", range(1, 113))
def test_extract_mers_phased_every_k(k):
    """The ASCII path at every k the port takes: encode_codes and
    extract_mers_phased (canonical and not) on a chunk of 2k + 37 bytes,
    never a multiple of 16, with lowercase, N and other bytes."""
    rng = np.random.default_rng(3000 + k)
    alphabet = np.frombuffer(b"ACGTacgtNx", dtype=np.uint8)
    p = np.r_[[0.24] * 4, [0.01] * 4, 0.6 / k, 0.2 / k]
    chunk = rng.choice(alphabet, 2 * k + 37, p=p / p.sum())
    chunk[:k] = rng.choice(alphabet[:8], k)  # window 0 is valid
    codes = tmers.encode_codes(torch.from_numpy(chunk))
    want = jmers.encode_codes(jnp.asarray(chunk))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    for canonical in (False, True):
        want_m, want_v = jmers.extract_mers_phased(want, k, canonical)
        got_m, got_v = tmers.extract_mers_phased(codes, k, canonical)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_m.numpy(),
                                      np.asarray(want_m).astype(np.int64))
        assert got_v.any()


@pytest.mark.parametrize("k", [1, 16, 21, 32, 33, 100])
def test_reverse_complement_and_canonicalize(k):
    rng = np.random.default_rng(2000 + k)
    W = (2 * k + 31) // 32
    mers = rng.integers(0, 1 << 32, (100, W), dtype=np.uint64).astype(np.uint32)
    mers = np.asarray(jax.jit(
        lambda m: jmers.mw.mw_and_mask_top(m, 2 * k))(jnp.asarray(mers)))
    rc = tmers.reverse_complement(_t(mers), k)
    np.testing.assert_array_equal(
        rc.numpy().astype(np.uint32),
        np.asarray(jmers.reverse_complement(jnp.asarray(mers), k)))
    np.testing.assert_array_equal(
        tmers.canonicalize(_t(mers), k).numpy().astype(np.uint32),
        np.asarray(jmers.canonicalize(jnp.asarray(mers), k)))
    # the reverse complement is an involution
    np.testing.assert_array_equal(
        tmers.reverse_complement(rc, k).numpy().astype(np.uint32), mers)
