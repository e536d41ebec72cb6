"""MerCounter(device="cpu") of jellyfish_tpu_torch against jellyfish_tpu's
MerCounter on the same packed chunks and the same hash matrix (exact:
integer counts).

The port's store runs with a small grain and merge budget, so one run
reaches several grains, level merges (branch 8) that take a budget-bounded
part of a level, a final merge of many runs, and the PAD correction; the
JAX store runs at its defaults. Cases also cover a real mer whose sortkey
is the all-ones PAD pattern, the identity-matrix regime (-s >= 4^k) and
repeated finalize."""

import numpy as np
import pytest
import torch

from jellyfish_tpu.counter import MerCounter as JaxCounter
from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.io.parse import pack_chunk
from jellyfish_tpu_torch.ops import hashing, multiword as mw
from jellyfish_tpu_torch.ops.packed_run import PackedRun

torch.set_num_threads(1)

L = 512       # bases per chunk
B = 2         # chunks per batch
GRAIN = 2048  # the port's consolidate_rows


def _chunks(rng, n_chunks, k, motif=None):
    """Reads of 40-150 bases from a 4000-base genome (so mers repeat),
    with N bases, joined by N separators into chunks of L bytes. `motif`
    is spliced into every 5th read."""
    genome = rng.integers(0, 4, 4000)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = np.full((n_chunks, L), ord("N"), dtype=np.uint8)
    for c in range(n_chunks):
        pos = 0
        while pos < L - k:
            n = int(rng.integers(40, 151))
            s = int(rng.integers(0, len(genome) - n))
            read = acgt[genome[s:s + n]].copy()
            read[rng.random(n) < 0.01] = ord("N")
            if motif is not None and rng.random() < 0.2:
                read = np.frombuffer(motif.encode(), dtype=np.uint8)
            n = min(len(read), L - pos)
            out[c, pos:pos + n] = read[:n]
            pos += n + 1
    return out


def _feed(counters, chunks):
    for i in range(0, len(chunks), B):
        packed = [pack_chunk(c) for c in chunks[i:i + B]]
        pw = np.stack([p[0] for p in packed])
        vb = np.stack([p[1] for p in packed])
        for c in counters:
            c.add_chunks_packed_batch(pw, vb)


def _same(port, ref):
    got_m, got_c = port.finalize_np()
    want_m, want_c = ref.finalize_np()
    assert got_m.dtype == np.uint32 and got_c.dtype == np.uint64
    np.testing.assert_array_equal(got_m, np.asarray(want_m))
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    return got_m, got_c


def _all_ones_mer(counter) -> str:
    """The k-mer whose sortkey under counter's matrix is all ones."""
    k = counter.k
    ones = torch.full((1, counter.W), mw.M32, dtype=torch.int64)
    ones = mw.mw_and_mask_top(ones, 2 * k)
    limbs = hashing.mers_of_sortkeys(ones, counter._Ainv, k, counter.lsize)
    v = int(mw.to_ints(limbs)[0])
    return "".join("ACGT"[(v >> (2 * (k - 1 - j))) & 3] for j in range(k))


# (k, canonical, size, motif): size None is a random matrix with -s 4096;
# motif "ones" splices in the mer whose sortkey is the PAD pattern
CASES = [
    (21, True, None, None),
    (31, False, None, None),
    (32, True, None, None),
    (32, False, None, "ones"),
    (33, False, None, None),
    (63, True, None, None),
    (8, False, 4 ** 8, "T" * 60),     # identity: poly-T is the all-ones key
    (16, False, 4 ** 16, "T" * 60),
    (32, False, 1 << 64, "T" * 60),
]


@pytest.mark.parametrize(
    "k,canonical,size,motif", CASES,
    ids=[f"k{k}-{'C' if c else 'F'}-{'identity' if s else 'random'}-{m and m[:4]}"
         for k, c, s, m in CASES],
)
def test_counter_matches_jax(k, canonical, size, motif):
    seed = 9000 + k + 2 * canonical + (size is not None)
    port = MerCounter(k, size or 4096, canonical=canonical,
                      rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, size or 4096, canonical=canonical,
                     rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(port.matrix.bit_matrix(),
                                  ref.matrix.bit_matrix())
    assert (port._A is None) == (size is not None)
    port.store.consolidate_rows = GRAIN
    if motif == "ones":
        motif = _all_ones_mer(port)
    rng = np.random.default_rng(seed)
    chunks = _chunks(rng, 72, k, motif)
    _feed([port, ref], chunks)
    store = port.store
    assert store.levels[1] and store.total_pads() > 0

    m, c = _same(port, ref)
    if motif is not None:
        # the motif's first k-mer has the all-ones sortkey: a real mer,
        # kept as the last record after the PAD correction
        v = sum("ACGT".index(b) << (2 * (k - 1 - j))
                for j, b in enumerate(motif[:k]))
        want = mw.from_ints([v], port.W).numpy().astype(np.uint32)[0]
        np.testing.assert_array_equal(m[-1], want)
        assert c[-1] > 0


@pytest.mark.parametrize("k", [63, 100])
def test_large_keys_sort_through_merge_passes(monkeypatch, k):
    """W = 4 and W = 7 limb keys with a grain of a few block-sort tiles:
    every consolidation sorts through K3's block sort and K1's merge
    passes (their plain versions here), and the grains' runs merge as at
    any key width."""
    from jellyfish_tpu_torch.kernels import sort as ksort

    passes = []
    merge_pass = ksort.merge_pass
    monkeypatch.setattr(ksort, "merge_pass",
                        lambda *a: passes.append(a[1]) or merge_pass(*a))
    seed = 9300 + k
    port = MerCounter(k, 4096, canonical=True,
                      rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 4096, canonical=True, rng=np.random.default_rng(seed))
    assert port.store.key_cols == port.W == (4 if k == 63 else 7)
    port.store.consolidate_rows = 5000
    rng = np.random.default_rng(seed)
    _feed([port, ref], _chunks(rng, 80, k))
    assert len(passes) >= 8  # 1-2 passes a grain
    _same(port, ref)


def test_budget_take_and_repeated_finalize():
    """A merge budget of about three runs: level merges take part of a
    level at a time. Then finalize, ingest more, finalize again: the
    resting run's PAD entry carries the earlier pads."""
    k, seed = 21, 9100
    port = MerCounter(k, 4096, rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 4096, rng=np.random.default_rng(seed))
    port.store.consolidate_rows = GRAIN
    port.store.merge_bytes_budget = 3 * GRAIN * 16
    rng = np.random.default_rng(seed)
    _feed([port, ref], _chunks(rng, 72, k))
    assert len(port.store.levels[1]) >= 2
    _same(port, ref)
    _feed([port, ref], _chunks(rng, 20, k))
    _same(port, ref)
    _same(port, ref)  # nothing new: the same table again
    port.reset()
    ref.reset()
    _feed([port, ref], _chunks(rng, 4, k))
    m, c = _same(port, ref)
    assert len(c) > 0
    mers, counts = port.finalize()
    assert list(mers) == list(mw.to_ints(m)) and (counts == c).all()



def test_flush_mid_stream():
    """flush() between batches consolidates the raw backlog into compacted
    runs without changing what finalize returns."""
    k, seed = 21, 9200
    port = MerCounter(k, 4096, canonical=True,
                      rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 4096, canonical=True, rng=np.random.default_rng(seed))
    port.store.consolidate_rows = GRAIN
    rng = np.random.default_rng(seed)
    for _ in range(3):
        _feed([port, ref], _chunks(rng, 6, k))
        port.store.flush()
        assert not port.store.raw and port.store.raw_rows == 0
        assert port.store.levels[0]
    port.store.flush()  # an empty backlog: nothing to do
    _same(port, ref)


@pytest.mark.parametrize("k", [21, 63])
def test_device_bytes_in_the_jax_units(k):
    """store.device_bytes counts 4 bytes a limb of every raw and compacted
    row and 8 a count, as the JAX package's store does: the raw backlog
    before a flush, the compacted runs after it."""
    port = MerCounter(k, 4096, rng=np.random.default_rng(k), device="cpu")
    W = port.W
    assert port.store.device_bytes() == 0
    _feed([port], _chunks(np.random.default_rng(k), 3, k))
    raw = port.store.raw_rows
    assert raw > 0 and port.store.device_bytes() == raw * 4 * W
    port.store.flush()
    rows = sum(r[1].shape[0] for level in port.store.levels for r in level)
    assert 0 < rows <= raw
    assert port.store.device_bytes() == rows * (4 * W + 8)


# -- the ASCII path (count --chunk-len not a multiple of 32, the filters) ----


def _ascii_chunk(rng, n):
    """n bytes of reads: ACGT in both cases, N runs, other bytes."""
    alphabet = np.frombuffer(b"ACGTacgtNx\xff", dtype=np.uint8)
    p = np.array([0.22, 0.22, 0.22, 0.22, 0.025, 0.025, 0.025, 0.025, 0.02,
                  0.01, 0.01])
    return rng.choice(alphabet, n, p=p / p.sum())


@pytest.mark.parametrize("L", [1000, 4097, 1 << 16])
@pytest.mark.parametrize("k", [1, 21, 32, 33, 63])
def test_ascii_extraction_matches_jax(L, k):
    """encode_codes and extract_mers_phased (canonical and not): the same
    codes, mers and validity, in the same phase-major order."""
    import jax.numpy as jnp

    from jellyfish_tpu.ops import mers as jmers
    from jellyfish_tpu_torch.ops import mers as tmers

    chunk = _ascii_chunk(np.random.default_rng(L + k), L)
    want = np.asarray(jmers.encode_codes(jnp.asarray(chunk)))
    codes = tmers.encode_codes(torch.from_numpy(chunk))
    np.testing.assert_array_equal(codes.numpy(), want)
    np.testing.assert_array_equal(tmers.code_table(), jmers.code_table())
    for canonical in (False, True):
        jm, jv = jmers.extract_mers_phased(jnp.asarray(want), k, canonical)
        tm, tv = tmers.extract_mers_phased(codes, k, canonical)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tm.numpy(),
                                      np.asarray(jm).astype(np.int64))


@pytest.mark.parametrize("L", [1000, 4097, 1 << 16])
@pytest.mark.parametrize("k", [1, 21, 32, 33, 63])
def test_chunk_pipelines_match_jax(L, k):
    """_chunk_pipeline (premasked sortkeys, valid count) and
    _chunk_pipeline_dedup (the chunk's masked counted run, PAD segment
    corrected), and the mers recovered from it."""
    import jax.numpy as jnp

    from jellyfish_tpu import counter as jc
    from jellyfish_tpu_torch import counter as tc

    seed = 9400 + k
    port = MerCounter(k, 1 << 12, canonical=k % 2 == 1,
                      rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 1 << 12, canonical=k % 2 == 1,
                     rng=np.random.default_rng(seed))
    chunk = _ascii_chunk(np.random.default_rng(seed + L), L)
    args = (port.k, port.lsize, port.canonical)
    sk, nv = tc._chunk_pipeline(torch.from_numpy(chunk), port._A, *args)
    jsk, jnv = jc._chunk_pipeline(jnp.asarray(chunk), ref._A, k=k,
                                  lsize=ref.lsize, canonical=ref.canonical)
    assert int(nv) == int(jnv)
    np.testing.assert_array_equal(mw.limbs_of_key_columns(sk, port.W).numpy(),
                                  np.asarray(jsk).astype(np.int64))
    keys, mers, counts = port.chunk_counts(chunk)
    jkeys, jcounts = jc._chunk_pipeline_dedup(
        jnp.asarray(chunk), ref._A, k=k, lsize=ref.lsize,
        canonical=ref.canonical)
    # the counts sit on the same rows; a row of count 0 keeps its key here
    # and holds the PAD key in the JAX package, and no consumer reads it
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jcounts).astype(np.int64))
    live = counts.numpy() > 0
    np.testing.assert_array_equal(
        mw.limbs_of_key_columns(keys, port.W).numpy()[live],
        np.asarray(jkeys).astype(np.int64)[live])
    jm = jc._recover_mers(jkeys, ref._Ainv, k=k, lsize=ref.lsize)
    np.testing.assert_array_equal(mers.numpy()[live],
                                  np.asarray(jm).astype(np.int64)[live])
    assert int(counts.sum()) == int(nv)


@pytest.mark.parametrize("k,motif", [(21, None), (32, "ones"), (33, None)])
def test_filtered_counts_match_jax(k, motif):
    """MerCounter(mer_filter=f).add_chunk: each chunk's distinct mers go
    through the same filter in both packages (here: keep a count when the
    mer's low limb is odd, else 0; drop the all-ones mer, whose sortkey is
    the PAD pattern at k = 32, only in odd chunks), and the filtered runs
    through insert_run and the level merges. Rows the filter zeroed end as
    in the JAX package: not in the table."""
    seed = 9500 + k
    calls = []

    def jfilt(mers, counts):
        keep = (mers[:, 0] & 1) == 1
        calls.append(len(calls))
        return np.where(keep | (len(calls) % 2 == 0), counts, 0)

    def tfilt(mers, counts):
        keep = (mers[:, 0] & 1) == 1
        return torch.where(keep | (len(calls) % 2 == 0), counts, 0)

    port = MerCounter(k, 4096, rng=np.random.default_rng(seed),
                      device="cpu", mer_filter=tfilt)
    ref = JaxCounter(k, 4096, rng=np.random.default_rng(seed),
                     mer_filter=jfilt)
    if motif == "ones":
        motif = _all_ones_mer(port)
    for chunk in _chunks(np.random.default_rng(seed), 24, k, motif):
        chunk = chunk[:L - 7]  # not a multiple of 16
        ref.add_chunk(chunk)
        port.add_chunk(chunk)
    assert port.store.levels[1] and port.store.total_pads() == 0
    m, c = _same(port, ref)
    assert (c > 0).all() and len(c) > 100


# -- count --packed-store, --if, add_mers_np ---------------------------------


@pytest.mark.parametrize("k,canonical,size,motif", [
    (21, True, None, None),
    (32, False, None, "ones"),
    (63, True, None, None),
    (8, False, 4 ** 8, "T" * 60),
], ids=["k21", "k32-ones", "k63", "k8-identity"])
def test_packed_store_matches_dense_and_jax(k, canonical, size, motif):
    """pack_resting=True with a small grain and branch 4: merged runs
    reach level 2 and rest packed, and so does the finalize's run; the
    table equals the dense port's and the JAX package's, packed and
    dense, and the packed store holds fewer bytes. After more input, the
    repeated finalize unpacks the resting run and equals the JAX dense
    store's table. (The JAX packed store differs there at k = 8: its
    unpack turns the real all-ones key of the resting run into the PAD
    key, and its count comes out under a mer that was never counted. The
    port keeps the run's last two keys as they were.)"""
    seed = 9600 + k

    def make(cls, **kw):
        return cls(k, size or 4096, canonical=canonical,
                   rng=np.random.default_rng(seed), **kw)

    packed = make(MerCounter, device="cpu", pack_resting=True)
    dense = make(MerCounter, device="cpu")
    ref, jpacked = make(JaxCounter), make(JaxCounter, pack_resting=True)
    for c in (packed, dense):
        c.store.consolidate_rows = GRAIN
        c.store.branch = 4
    if motif == "ones":
        motif = _all_ones_mer(packed)
    rng = np.random.default_rng(seed)
    _feed([packed, dense, ref, jpacked], _chunks(rng, 72, k, motif))
    assert packed.store.levels[2] and packed.store.packed > 0
    assert all(isinstance(r, PackedRun) for r in packed.store.levels[2])
    assert packed.store.device_bytes() < dense.store.device_bytes()
    m, c = _same(packed, ref)
    for other in (dense, jpacked):
        om, oc = other.finalize_np()
        np.testing.assert_array_equal(m, np.asarray(om))
        np.testing.assert_array_equal(c, np.asarray(oc))
    assert isinstance(packed.store.levels[-1][0], PackedRun)
    assert packed.store.device_bytes() < dense.store.device_bytes()
    _feed([packed, ref], _chunks(rng, 10, k, motif))
    _same(packed, ref)
    _same(packed, ref)


@pytest.mark.parametrize("k", [21, 33])
def test_add_mers_np_matches_jax(k):
    """add_mers_np: explicit mers (repeated, weight 3) as a counted run,
    beside packed chunks."""
    seed = 9700 + k
    port = MerCounter(k, 4096, rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 4096, rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    mers = [int(x) for x in rng.integers(0, 1 << 40, 500)] * 2
    for c in (port, ref):
        c.add_mers_np(mers, 3)
        c.add_mers_np([])
    _feed([port, ref], _chunks(rng, 4, k))
    m, c = _same(port, ref)
    assert (c >= 6).sum() >= 500


def _allowed(rng, k, n):
    """ASCII chunks of allowed reads: pieces of the test genome's reads
    (so many are counted) and random sequence (mostly never counted)."""
    chunks = list(_chunks(rng, n, k))
    chunks.append(_ascii_chunk(rng, 3000))
    return [c[:L - 5] for c in chunks]


@pytest.mark.parametrize("k,canonical", [(21, True), (32, False), (63, True)])
def test_restrict_to_matches_jax(k, canonical):
    """--if: the allowed set in hash order with its counts or 0; after
    reset() (a --disk spill) the restriction still holds; with nothing
    counted the allowed set dumps at 0."""
    seed = 9800 + k
    port = MerCounter(k, 4096, canonical=canonical,
                      rng=np.random.default_rng(seed), device="cpu")
    ref = JaxCounter(k, 4096, canonical=canonical,
                     rng=np.random.default_rng(seed))
    port.store.consolidate_rows = GRAIN
    rng = np.random.default_rng(seed)
    allowed = _allowed(rng, k, 3)
    port.restrict_to(iter(allowed))
    ref.restrict_to(iter(allowed))
    m, c = _same(port, ref)  # nothing counted yet: all at 0
    assert len(c) > 300 and not c.any()
    _feed([port, ref], _chunks(np.random.default_rng(seed), 24, k))
    m, c = _same(port, ref)
    assert 0 < (c > 0).sum() < len(c)
    for x in (port, ref):
        x.reset()
    _feed([port, ref], _chunks(rng, 6, k))
    _same(port, ref)
