"""kernels/sortkeys.py, the chunk pipeline of host-packed chunks in one
kernel (2k <= 64: one packed column; 64 < 2k <= 128: 3 or 4 limb
columns): its plain route against the JAX package's
_chunk_pipeline_packed_batch, numpy models of both kernels' arithmetic
(byte tables, funnel read, invalid-window test, canonical fold; 128-bit
for the limb keys) against the plain route, the wrapper's checks, and the
`pipeline` span's counts. Exact: integer arithmetic. The kernels
themselves run only on the card: their tests here skip without one, and
chip_smoke.py's phase_sortkeys holds them bit for bit against the plain
route at the count's batch shape."""

import functools

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.kernels import sortkeys as sk_mod
from jellyfish_tpu_torch.kernels.sortkeys import (
    byte_tables,
    hash_tables,
    sortkeys,
    sortkeys_plain,
)
from jellyfish_tpu_torch.ops import hashing
from jellyfish_tpu_torch.ops import multiword as mw

torch.set_num_threads(1)

KS = [1, 2, 15, 16, 17, 21, 31, 32]
PAD = mw.PAD_PACKED
U64 = np.uint64


def _lsize(k):
    return min(27, 2 * k - 1) if k > 1 else 1


def _matrix(k, lsize, seed):
    return GF2Matrix.random_invertible(lsize, 2 * k,
                                       np.random.default_rng(seed))


def _chunks(rng, B, L, k):
    """B chunks of random codes -> (pwords [B, L/16], validbits [B,
    ceil(L/32)]) uint32, with runs of N at the start, the middle and the
    end of each, and scattered N bases; the codes under an N are random,
    as a packer leaves them."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint32)
    valid = rng.random((B, L)) >= min(0.02, 0.3 / k)
    for b in range(B):
        valid[b, :int(rng.integers(1, 6))] = False
        mid = int(rng.integers(L // 3, L // 2))
        valid[b, mid:mid + int(rng.integers(1, k + 3))] = False
        valid[b, L - int(rng.integers(1, 4)):] = False
    return _pack(codes, valid)


def _pack(codes, valid):
    B, L = codes.shape
    pw = (codes.reshape(B, -1, 16)
          << (2 * (15 - np.arange(16, dtype=np.uint32)))).sum(
              axis=2, dtype=np.uint32)
    vpad = np.zeros((B, 32 * ((L + 31) // 32)), dtype=np.uint32)
    vpad[:, :L] = valid
    vb = (vpad.reshape(B, -1, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)
    return pw, vb


def _splice(pw, vb, mer, k, at):
    """Write the k bases of `mer` (a 2k-bit int) into chunk 0 at base
    `at`, all valid."""
    L = 16 * pw.shape[1]
    codes = ((pw[:1, :, None] >> (2 * (15 - np.arange(16, dtype=np.uint32))))
             & 3).reshape(1, L)
    valid = ((vb[:1, :, None] >> np.arange(32, dtype=np.uint32)) & 1
             ).reshape(1, -1)[:, :L].astype(bool)
    for i in range(k):
        codes[0, at + i] = (mer >> (2 * (k - 1 - i))) & 3
    valid[0, at:at + k] = True
    pw[:1], vb[:1] = _pack(codes, valid)


def _words(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _pad_preimage(k, matrix):
    """The mer whose sortkey is all ones (the PAD key at 2k = 64, and the
    PAD limbs at 2k = 96 and 128)."""
    ones = mw.from_ints([(1 << (2 * k)) - 1], mw.nwords(2 * k))
    if matrix is None:
        return (1 << (2 * k)) - 1
    inv = hashing.inverse_masks_of_matrix(matrix, mw.nwords(2 * k))
    mer = hashing.mers_of_sortkeys(ones, inv, k, matrix.r)
    return int(mw.to_ints(mer)[0])


@functools.cache
def _jax_pipeline():
    from jellyfish_tpu import counter as jc

    return jc._chunk_pipeline_packed_batch


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("hashed", [True, False])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_plain_route_matches_jax(k, canonical, hashed, B):
    """The wrapper's plain route (CPU tensors) against the JAX package: the
    same phase-major rows, each JAX sortkey mapped to its key column, and
    the same valid count. At k = 32 and not canonical, chunk 0 holds the
    mer whose sortkey is the PAD key."""
    import jax.numpy as jnp

    from jellyfish_tpu.gf2 import GF2Matrix as JaxMatrix
    from jellyfish_tpu.ops.hashing import masks_of_matrix as jax_masks

    seed = 7100 + 13 * k + 2 * canonical + hashed + 5 * B
    rng = np.random.default_rng(seed)
    L, c, W = 512, 2 * k, mw.nwords(2 * k)
    lsize = _lsize(k) if hashed else c
    matrix = _matrix(k, lsize, seed) if hashed else None
    masks = hashing.masks_of_matrix(matrix, W) if hashed else None
    pw, vb = _chunks(rng, B, L, k)
    pad_case = k == 32 and not canonical
    if pad_case:
        _splice(pw, vb, _pad_preimage(k, matrix), k, 100)

    keys, n_valid = sortkeys(_words(pw), _words(vb), k, lsize, canonical,
                             masks)

    jax_batch = _jax_pipeline()
    jm = (jax_masks(JaxMatrix.random_invertible(
        lsize, c, np.random.default_rng(seed)), W) if hashed else None)
    if hashed:
        np.testing.assert_array_equal(jm, masks)
    jsk, jnv = jax_batch(jnp.asarray(pw), jnp.asarray(vb), jm, k=k,
                         lsize=lsize, canonical=canonical, L=L)
    # the JAX package's PAD row is all-ones limbs; the port's, the packed
    # PAD key. A real sortkey is all-ones limbs only at 2k = 64, where it
    # packs to the PAD key too, or at 2k = 32 (k = 16: 1 in 2^32 a row)
    jsk = torch.from_numpy(np.asarray(jsk).astype(np.int64))
    want = torch.where((jsk == mw.M32).all(dim=1, keepdim=True), PAD,
                       mw.key_columns(jsk))
    assert keys.dtype == torch.int64 and keys.shape == want.shape
    assert keys.shape[0] == B * 16 * ((L - k) // 16 + 1)
    assert torch.equal(keys, want)
    assert n_valid.dtype == torch.int64 and int(n_valid) == int(jnv)
    if pad_case:  # a real mer on the PAD key, beside the invalid windows
        assert int((keys == PAD).sum()) > keys.shape[0] - int(n_valid)


# -- a numpy model of the kernel's arithmetic ---------------------------------


def _rc_np(key, k):
    """Reverse complement of 2k-bit keys, base by base."""
    rc = np.zeros_like(key)
    for i in range(k):
        base = (key >> U64(2 * i)) & U64(3)
        rc |= (U64(3) - base) << U64(2 * (k - 1 - i))
    return rc


def _table_pos(key, tables):
    pos = np.zeros_like(key)
    for i in range(tables.shape[0]):
        pos ^= tables[i][((key >> U64(8 * i)) & U64(255)).astype(np.int64)]
    return pos


def kernel_model(pw, vb, k, lsize, canonical, tables):
    """csrc/sortkeys.cu's rows, as it computes them: slot m of chunk b reads
    code words m, m + 1, m + 2 and validity words m/2, m/2 + 1 (0 past
    the end), and window phi is cut out of them by shifts."""
    B, npw = pw.shape
    nvb, L, c = vb.shape[1], 16 * npw, 2 * k
    Mp, N = (L - k) // 16 + 1, L - k + 1
    m = np.arange(Mp)

    def at(a, i, n):
        return np.where(i < n, a[:, np.minimum(i, n - 1)], 0).astype(U64)

    x = (at(pw, m, npw) << U64(32)) | at(pw, m + 1, npw)
    x2 = at(pw, m + 2, npw)
    j = m >> 1
    bad = ~(((at(vb, j + 1, nvb) << U64(32)) | at(vb, j, nvb))
            >> (U64(16) * (m & 1).astype(U64)))
    out = np.empty((B, 16, Mp), np.int64)
    valid_total = 0
    for phi in range(16):
        y = x if phi == 0 else ((x << U64(2 * phi))
                                | (x2 >> U64(32 - 2 * phi)))
        key = y >> U64(64 - c)
        if canonical:
            key = np.minimum(key, _rc_np(key, k))
        sk = key
        if tables is not None:
            low = key >> U64(lsize) if lsize < 64 else np.zeros_like(key)
            sk = (_table_pos(key, tables) << U64(c - lsize)) | low
        valid = ((16 * m + phi < N)
                 & (((bad >> U64(phi)) & U64((1 << k) - 1)) == 0))
        valid_total += int(valid.sum())
        col = (sk ^ U64(1 << 63)).view(np.int64)
        out[:, phi] = np.where(valid, col, np.int64(PAD))
    return out.reshape(-1, 1), valid_total


@pytest.mark.parametrize("k,lsize,canonical,L", [
    (1, 1, True, 64), (2, 3, False, 32), (15, 27, True, 512),
    (16, 32, False, 496), (17, 27, True, 1024), (21, 27, True, 2048),
    (21, 40, False, 512), (31, 61, True, 528), (32, 27, True, 512),
    (32, 64, False, 512), (32, 0, False, 512), (21, 0, True, 2048),
])
def test_kernel_model_matches_plain_route(k, lsize, canonical, L):
    """The model of the kernel (tables from masks_of_matrix; lsize 0 is
    the identity hash) against the plain route on random chunks, L a
    multiple of 32 and of 16 only."""
    seed = 8200 + k + lsize + L
    rng = np.random.default_rng(seed)
    c = 2 * k
    matrix = _matrix(k, lsize, seed) if lsize else None
    masks = (hashing.masks_of_matrix(matrix, mw.nwords(c)) if lsize
             else None)
    pw, vb = _chunks(rng, 3, L, k)
    got, n = kernel_model(pw, vb, k, lsize or c, canonical,
                          byte_tables(masks, c) if lsize else None)
    keys, n_valid = sortkeys_plain(_words(pw), _words(vb), k, lsize or c,
                                   canonical, masks)
    np.testing.assert_array_equal(got, keys.numpy())
    assert n == int(n_valid)


# -- a numpy model of the limb-key kernel's arithmetic (64 < 2k <= 128) ------

M64 = U64(0xFFFFFFFFFFFFFFFF)
_REV8 = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)], U64)


def _brev64(x):
    """Reverse the 64 bits of each word (__brevll)."""
    out = np.zeros_like(x)
    for i in range(8):
        out |= _REV8[((x >> U64(8 * i)) & U64(255)).astype(np.int64)] \
            << U64(8 * (7 - i))
    return out


def _shr128(hi, lo, s):
    """(hi, lo) >> s, 0 <= s < 64."""
    if s == 0:
        return hi, lo
    return hi >> U64(s), (lo >> U64(s)) | (hi << U64(64 - s))


def _pair_swap(r):
    low = U64(0x5555555555555555)
    return ((r >> U64(1)) & low) | ((r & low) << U64(1))


def _wide_table_pos(hi, lo, tables):
    pos = np.zeros_like(lo)
    for i in range(tables.shape[0]):
        word = lo if i < 8 else hi
        byte = (word >> U64(8 * (i % 8))) & U64(255)
        pos ^= tables[i][byte.astype(np.int64)]
    return pos


def limb_kernel_model(pw, vb, k, lsize, canonical, tables):
    """csrc/sortkeys.cu's limb-key rows (32 < k <= 64), as it computes them:
    slot m of chunk b reads code words m .. m + 4 and validity words m/2
    .. m/2 + 2 (0 past the end), window phi is cut out of them by 128-bit
    funnel shifts, folded with the 128-bit reverse complement, hashed by
    one table entry a key byte, and written as W = nwords(2k) limbs (all
    M32 when invalid)."""
    B, npw = pw.shape
    nvb, L, c, W = vb.shape[1], 16 * npw, 2 * k, mw.nwords(2 * k)
    Mp, N = (L - k) // 16 + 1, L - k + 1
    s, t = 128 - c, c - lsize
    m = np.arange(Mp)

    def at(a, i, n):
        return np.where(i < n, a[:, np.minimum(i, n - 1)], 0).astype(U64)

    a = (at(pw, m, npw) << U64(32)) | at(pw, m + 1, npw)
    a2 = (at(pw, m + 2, npw) << U64(32)) | at(pw, m + 3, npw)
    a3 = at(pw, m + 4, npw) << U64(32)
    j = m >> 1
    odd = (m & 1).astype(bool)
    v01 = (at(vb, j + 1, nvb) << U64(32)) | at(vb, j, nvb)
    v2 = at(vb, j + 2, nvb)
    bad = ~np.where(odd, (v01 >> U64(16)) | (v2 << U64(48)), v01)
    bad_hi = ~np.where(odd, v2 >> U64(16), v2) & U64(0xFFFFFFFF)
    window_bits = M64 >> U64(64 - k)
    out = np.empty((B, 16, Mp, W), np.int64)
    valid_total = 0
    for phi in range(16):
        d = 2 * phi
        yh = a if d == 0 else (a << U64(d)) | (a2 >> U64(64 - d))
        yl = a2 if d == 0 else (a2 << U64(d)) | (a3 >> U64(64 - d))
        hi, lo = _shr128(yh, yl, s)
        if canonical:
            rh, rl = _shr128(_pair_swap(_brev64(~lo)),
                             _pair_swap(_brev64(~hi)), s)
            less = (rh < hi) | ((rh == hi) & (rl < lo))
            hi, lo = np.where(less, rh, hi), np.where(less, rl, lo)
        pos = _wide_table_pos(hi, lo, tables)
        if t >= 64:
            ph, pl = pos << U64(t - 64), np.zeros_like(pos)
        else:
            ph, pl = (pos >> U64(1)) >> U64(63 - t), pos << U64(t)
        kh, kl = (_shr128(hi, lo, lsize) if lsize < 64
                  else (np.zeros_like(hi), hi))
        sh, sl = ph | kh, pl | kl
        w = bad if phi == 0 else (bad >> U64(phi)) | (bad_hi << U64(64 - phi))
        valid = (16 * m + phi < N) & ((w & window_bits) == 0)
        valid_total += int(valid.sum())
        limbs = [sl & U64(mw.M32), sl >> U64(32), sh & U64(mw.M32),
                 sh >> U64(32)][:W]
        for col, limb in enumerate(limbs):
            out[:, phi, :, col] = np.where(valid, limb.astype(np.int64),
                                           np.int64(mw.M32))
    return out.reshape(-1, W), valid_total


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("lsize", [27, 40])
@pytest.mark.parametrize("k", [33, 48, 49, 55, 63, 64])
def test_limb_kernel_model_matches_plain_route(k, lsize, canonical):
    """The model of the limb-key kernel (byte tables of 9-16 key bytes,
    32-bit entries at lsize 27 and 64-bit at 40) against the plain route
    on random chunks, L a multiple of 32 and (k = 49, 63) of 16 only: the
    same rows of 3 (k <= 48) or 4 limbs, and the same valid count."""
    seed = 8400 + 3 * k + lsize + canonical
    rng = np.random.default_rng(seed)
    c, L = 2 * k, 528 if k in (49, 63) else 512
    masks = hashing.masks_of_matrix(_matrix(k, lsize, seed), mw.nwords(c))
    pw, vb = _chunks(rng, 3, L, k)
    got, n = limb_kernel_model(pw, vb, k, lsize, canonical,
                               byte_tables(masks, c))
    keys, n_valid = sortkeys(_words(pw), _words(vb), k, lsize, canonical,
                             masks)
    assert keys.shape == (3 * 16 * ((L - k) // 16 + 1), mw.nwords(c))
    np.testing.assert_array_equal(got, keys.numpy())
    assert n == int(n_valid)


@pytest.mark.parametrize("k,lsize", [(48, 27), (64, 40)])
def test_limb_key_on_the_pad_pattern_counts(k, lsize):
    """At 2k = 96 and 128 a real window's sortkey can be all-ones limbs,
    the PAD pattern: spliced in twice, both the plain route and the model
    write it as PAD limbs and count it as valid."""
    seed = 8600 + k
    matrix = _matrix(k, lsize, seed)
    masks = hashing.masks_of_matrix(matrix, mw.nwords(2 * k))
    pw, vb = _chunks(np.random.default_rng(seed), 2, 512, k)
    mer = _pad_preimage(k, matrix)
    _splice(pw, vb, mer, k, 100)
    _splice(pw, vb, mer, k, 301)
    keys, n_valid = sortkeys(_words(pw), _words(vb), k, lsize, False, masks)
    got, n = limb_kernel_model(pw, vb, k, lsize, False,
                               byte_tables(masks, 2 * k))
    np.testing.assert_array_equal(got, keys.numpy())
    assert n == int(n_valid)
    pads = int((keys == mw.M32).all(dim=1).sum())
    assert pads == keys.shape[0] - int(n_valid) + 2


@pytest.mark.parametrize("k,lsize", [(1, 2), (4, 5), (16, 32), (17, 33),
                                     (21, 27), (21, 42), (32, 27), (32, 64)])
def test_byte_tables_hash_as_masks_do(k, lsize):
    """pos by one table entry a key byte equals gf2_apply_masks, and the
    sortkey sortkey_of_mers, on random keys (also the all-zero and all-one
    keys); hash_tables lays the entries out as the kernel reads them."""
    c, W = 2 * k, mw.nwords(2 * k)
    rng = np.random.default_rng(9300 + k + lsize)
    matrix = _matrix(k, lsize, 9300 + k)
    masks = hashing.masks_of_matrix(matrix, W)
    halves = rng.integers(0, 1 << 32, (2, 4096), dtype=U64)
    keys = ((halves[0] << U64(32)) | halves[1]) & U64((1 << c) - 1)
    keys[:2] = [0, (1 << c) - 1]
    tables = byte_tables(masks, c)
    assert tables.shape == ((c + 7) // 8, 256)
    limbs = mw.from_ints([int(x) for x in keys], W)
    want_pos = mw.to_ints(hashing.gf2_apply_masks(limbs, masks,
                                                  mw.nwords(lsize)))
    pos = _table_pos(keys, tables)
    assert [int(p) for p in pos] == list(want_pos)
    low = keys >> U64(lsize) if lsize < 64 else np.zeros_like(keys)
    sk = (pos << U64(c - lsize)) | low
    want_sk = mw.to_ints(hashing.sortkey_of_mers(limbs, masks, k, lsize))
    assert [int(s) for s in sk] == list(want_sk)
    words = hash_tables(masks, k, "cpu").numpy().view(np.uint32)
    if lsize <= 32:
        np.testing.assert_array_equal(words, tables.astype(np.uint32))
    else:
        np.testing.assert_array_equal(words.reshape(-1, 2)[:, 0],
                                      tables.ravel() & U64(0xFFFFFFFF))
        np.testing.assert_array_equal(words.reshape(-1, 2)[:, 1],
                                      tables.ravel() >> U64(32))
    assert hash_tables(None, k, "cpu") is None


def test_cpu_route_takes_int32_and_int64_words():
    """numpy's uint32 words as int32 bit patterns and as int64 values give
    the same rows (words of 2^31 and above included)."""
    rng = np.random.default_rng(77)
    pw, vb = _chunks(rng, 2, 256, 21)
    assert (pw >= 1 << 31).any() and (vb >= 1 << 31).any()
    masks = hashing.masks_of_matrix(_matrix(21, 27, 77), 2)
    a = sortkeys(_words(pw), _words(vb), 21, 27, True, masks)
    b = sortkeys(torch.from_numpy(pw.astype(np.int64)),
                 torch.from_numpy(vb.astype(np.int64)), 21, 27, True, masks)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks raise; k = 65, above the kernels' widths, is
    not refused but runs the plain route, bit for bit, with no launch."""
    pw, vb = _chunks(np.random.default_rng(5), 2, 256, 21)
    pw, vb = _words(pw), _words(vb)
    masks = hashing.masks_of_matrix(_matrix(21, 27, 5), 2)
    args = (21, 27, True, masks)
    wide = (65, 27, True, hashing.masks_of_matrix(_matrix(65, 27, 5), 5))
    launches = sortkeys.launches
    got, want = sortkeys(pw, vb, *wide), sortkeys_plain(pw, vb, *wide)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    assert sortkeys.launches == launches
    with pytest.raises(ValueError, match="lsize"):
        sortkeys(pw, vb, 40, 65, True, np.zeros((65, 3), np.uint32))
    with pytest.raises(ValueError, match="dtype"):
        sortkeys(pw.to(torch.int16), vb.to(torch.int16), *args)
    with pytest.raises(ValueError, match="dtype"):
        sortkeys(pw, vb.to(torch.int64), *args)
    with pytest.raises(ValueError, match="pwords"):
        sortkeys(pw[0], vb[0], *args)
    with pytest.raises(ValueError, match="pwords"):
        sortkeys(pw, vb[:1], *args)
    with pytest.raises(ValueError, match="validity words"):
        sortkeys(pw, vb[:, :-1], *args)
    with pytest.raises(ValueError, match="validity words"):
        sortkeys(pw[:, :1], vb[:, :1], *args)  # 16 bases < k
    with pytest.raises(ValueError, match="lsize"):
        sortkeys(pw, vb, 21, 26, True, masks)
    with pytest.raises(ValueError, match="unsupported device"):
        sortkeys(pw.to("meta"), vb.to("meta"), *args)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("k", [33, 64])
def test_wrapper_refuses_the_identity_hash_of_limb_keys(k, device):
    """At 2k > 64 the kernel takes only tables (MerCounter always hashes
    such keys): the identity hash raises in the wrapper's checks, before
    any dispatch by device (a meta tensor would raise otherwise)."""
    pw, vb = _chunks(np.random.default_rng(6), 2, 256, k)
    with pytest.raises(ValueError, match="identity hash"):
        sortkeys(_words(pw).to(device), _words(vb).to(device), k, 2 * k,
                 True, None)


def test_pipeline_span_counts_rows():
    """`rows` counts every row a batch gives and `fused_rows` those the
    kernel wrote: none on the CPU, at any width (one packed column, 3 and
    4 limb columns, and 5 above the kernels' widths)."""
    L, B = 512, 2
    launches = sk_mod.sortkeys.launches
    for k in (21, 33, 55, 65):
        c = MerCounter(k, 1 << 12, canonical=True,
                       rng=np.random.default_rng(k), device="cpu")
        pw, vb = _chunks(np.random.default_rng(k), B, L, k)
        keys, _ = c.packed_sortkeys(pw, vb)
        c.add_chunks_packed_batch(pw, vb)
        c.reset()
        rows = B * 16 * ((L - k) // 16 + 1)
        assert keys.shape == (rows, 1 if k <= 32 else mw.nwords(2 * k))
        assert c.trace.jobs[-1]["pipeline"] == {
            "calls": 2, "host_ns": c.trace.jobs[-1]["pipeline"]["host_ns"],
            "rows": 2 * rows, "fused_rows": 0}
    assert sk_mod.sortkeys.launches == launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("k,lsize,canonical", [
    (21, 27, True), (1, 0, False), (17, 27, False), (32, 0, False),
    (32, 40, True), (55, 27, True), (33, 27, False), (64, 40, True),
    (48, 27, True)])
def test_kernel_matches_plain_route_on_the_card(cuda, k, lsize, canonical):
    rng = np.random.default_rng(600 + k)
    c = 2 * k
    masks = (hashing.masks_of_matrix(_matrix(k, lsize, 600 + k),
                                     mw.nwords(c)) if lsize else None)
    pw, vb = _chunks(rng, 3, 4096, k)
    if not canonical:
        matrix = _matrix(k, lsize, 600 + k) if lsize else None
        _splice(pw, vb, _pad_preimage(k, matrix), k, 100)
    args = (k, lsize or c, canonical, masks)
    before = sortkeys.launches
    got = sortkeys(_words(pw).to(cuda), _words(vb).to(cuda), *args)
    assert sortkeys.launches == before + 1
    want = sortkeys_plain(_words(pw), _words(vb), *args)
    assert torch.equal(got[0].cpu(), want[0])
    assert int(got[1]) == int(want[1])


@pytest.mark.chip
def test_counter_fuses_limb_keys_on_the_card(cuda):
    """MerCounter(55, 100M, canonical) on the card: one batch is one
    launch of the limb-key kernel, `fused_rows` equals `rows`, and the keys
    equal those of the same counter's matrix on the CPU."""
    k, B, L = 55, 2, 4096
    pw, vb = _chunks(np.random.default_rng(655), B, L, k)
    card = MerCounter(k, 100_000_000, canonical=True,
                      rng=np.random.default_rng(55), device=cuda)
    host = MerCounter(k, 100_000_000, canonical=True,
                      rng=np.random.default_rng(55), device="cpu")
    before = sortkeys.launches
    keys, n_valid = card.packed_sortkeys(pw, vb)
    assert sortkeys.launches == before + 1
    card.reset()
    span = card.trace.jobs[-1]["pipeline"]
    assert span["rows"] == keys.shape[0] == B * 16 * ((L - k) // 16 + 1)
    assert span["fused_rows"] == span["rows"]
    want, want_valid = host.packed_sortkeys(pw, vb)
    assert torch.equal(keys.cpu(), want)
    assert int(n_valid) == int(want_valid)
