"""`count -d N` of jellyfish_tpu_torch (parallel/sharded.py) against
jellyfish_tpu's ShardedMerCounter on conftest's 8 virtual CPU devices, and
against the port's single-device MerCounter with the same hash matrix:
the same records, exactly (tolerance 0, as record bytes). The port's
shards all lie on the CPU here (make_mesh(P, "cpu")).

Also: the global hash order across shards, homopolymers, the all-ones
sortkey beside PAD, more shards than distinct mers, -s below P (the JAX
package's lsize floor), a skewed owner map (the port cuts segments at
their exact lengths, so it has no capacity to overflow), and the CLI's
-d with --if, --disk, --packed-store, --bc and --bf-size, and -d auto, 0
and 1.

`-d --bf-size` follows the single-device semantics: each chunk's
distinct mers reach the one filter in stream order, so the database is
the single-device port's, and the JAX package's single-device one under
a seeded rng. The JAX package's `-d --bf-size` keeps a filter state per
owner shard, rounded up to a power of two, and so differs in its false
positives: it is not the reference here."""

import numpy as np
import pytest
import torch

from jellyfish_tpu.parallel import ShardedMerCounter as JaxSharded
from jellyfish_tpu.parallel import make_mesh as jax_mesh
from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.counter import MerCounter
from jellyfish_tpu_torch.io.header import FileHeader
from jellyfish_tpu_torch.io.parse import pack_chunk
from jellyfish_tpu_torch.ops import hashing, multiword as mw
from jellyfish_tpu_torch.parallel import ShardedMerCounter, make_mesh
from jellyfish_tpu_torch.parallel import sharded
from tests.conftest import oracle_counts

torch.set_num_threads(1)

L = 768  # bytes per chunk


def _jax_main(argv):
    from jellyfish_tpu.cli import main

    return main(argv)


def _reads(rng, n, genome, lo=400, hi=800):
    """n reads of lo-hi bases from `genome`, with 1% N bases."""
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi + 1))
        s = int(rng.integers(0, len(genome) - m))
        read = np.array(list(genome[s:s + m]))
        read[rng.random(m) < 0.01] = "N"
        out.append("".join(read))
    return out


def _chunks(seqs, rows):
    """[n, L] uint8 chunks of whole reads (each cut to L - 1 bases), one
    N after each read, N up to the end of the chunk; chunks of all N up
    to a multiple of `rows`."""
    chunks, cur = [], b""
    for s in seqs:
        b = s.encode()[:L - 1]
        if len(cur) + len(b) + 1 > L:
            chunks.append(cur)
            cur = b""
        cur += b + b"N"
    chunks.append(cur)
    while len(chunks) % rows:
        chunks.append(b"")
    out = np.full((len(chunks), L), ord("N"), dtype=np.uint8)
    for i, c in enumerate(chunks):
        out[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
    return out


def _feed(counter, chunks, packed, rows):
    """Feed [n, L] chunks `rows` at a time through add_chunks, or through
    add_chunks_packed (JAX or port) / add_chunks_packed_batch (port's
    MerCounter)."""
    for i in range(0, len(chunks), rows):
        batch = chunks[i:i + rows]
        if not packed:
            if isinstance(counter, MerCounter):
                for c in batch:
                    counter.add_chunk(c)
            else:
                counter.add_chunks(batch)
            continue
        pk = [pack_chunk(c) for c in batch]
        pw, vb = np.stack([p[0] for p in pk]), np.stack([p[1] for p in pk])
        if isinstance(counter, MerCounter):
            counter.add_chunks_packed_batch(pw, vb)
        else:
            counter.add_chunks_packed(pw, vb)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(2718)
    return "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))


# (P, k, canonical, packed ingest)
CASES = [
    (2, 21, True, True),
    (3, 21, False, False),
    (5, 33, True, True),
    (8, 63, True, False),
]


@pytest.mark.parametrize(
    "P,k,canonical,packed", CASES,
    ids=[f"P{P}-k{k}-{'C' if c else 'F'}-{'packed' if p else 'ascii'}"
         for P, k, c, p in CASES])
def test_sharded_matches_jax_and_single_device(genome, P, k, canonical,
                                               packed):
    rng = np.random.default_rng(100 * P + k)
    chunks = _chunks(_reads(rng, 6 * P, genome), P)
    port = ShardedMerCounter(k, 1 << 12, mesh=make_mesh(P, "cpu"),
                             canonical=canonical, rng=rng)
    ref = JaxSharded(k, 1 << 12, mesh=jax_mesh(P), canonical=canonical,
                     matrix=port.matrix)
    single = MerCounter(k, 1 << 12, canonical=canonical,
                        matrix=port.matrix, device="cpu")
    for c in (port, ref, single):
        _feed(c, chunks, packed, P)
    got = port.finalize_np()
    assert got[0].dtype == np.uint32 and got[1].dtype == np.uint64
    assert len(got[1]) > 1000
    _equal(got, ref.finalize_np())
    _equal(got, single.finalize_np())
    # every shard holds a part of the table
    assert [p for p, _, _ in port.finalize_local_np()] == list(range(P))


@pytest.mark.parametrize("k,P", [(5, 3), (15, 8), (48, 5), (112, 2)])
def test_other_key_widths_match_single_device(genome, k, P):
    """Key widths the JAX cases above leave out: 2k below the 16 owner
    bits, 2k a multiple of 32 at three limbs, and seven limbs."""
    rng = np.random.default_rng(k)
    chunks = _chunks(_reads(rng, 3 * P, genome), P)
    port = ShardedMerCounter(k, 1 << 12, mesh=make_mesh(P, "cpu"), rng=rng)
    single = MerCounter(k, 1 << 12, matrix=port.matrix, device="cpu")
    _feed(port, chunks, True, P)
    _feed(single, chunks, True, P)
    got = port.finalize_np()
    assert len(got[1]) > 100
    _equal(got, single.finalize_np())
    assert len(port.finalize_local_np()) == P


def test_sharded_order_is_global_hash_order(genome):
    """The concatenated shards ascend in (pos, key), the reference's dump
    order, and each shard's part lies above the previous one's."""
    k, P = 15, 5
    rng = np.random.default_rng(15)
    port = ShardedMerCounter(k, 1 << 12, mesh=make_mesh(P, "cpu"), rng=rng)
    _feed(port, _chunks(_reads(rng, 20, genome), P), False, P)
    mers, _ = port.finalize()
    m, mask = port.matrix, port.size - 1
    pairs = [(m.times(int(x)) & mask, int(x)) for x in mers]
    assert pairs == sorted(pairs) and len(set(pairs)) == len(pairs)
    owners = []
    for p, pm, _ in port.finalize_local_np():
        keys = torch.from_numpy(pm.astype(np.int64))
        sk = hashing.sortkey_of_mers(keys, port.shards[p]._A, k, port.lsize)
        owners.append(sharded._owner_of_sortkeys(mw.key_columns(sk), k, P))
        assert (owners[-1] == p).all()
    assert len(owners) == P


def test_homopolymers_and_empty_shards():
    """Homopolymer reads: a chunk collapses to a few distinct mers, and
    with 8 shards most shards own none. Exact against the oracle and the
    single-device count, through both ingest paths."""
    k, P = 21, 8
    seqs = ["A" * 700, "T" * 500, "C" * 300 + "G" * 300, "AC" * 200]
    chunks = _chunks(seqs * 4, P)
    want = oracle_counts(seqs * 4, k, True)
    for packed in (False, True):
        port = ShardedMerCounter(k, 1 << 10, mesh=make_mesh(P, "cpu"),
                                 canonical=True,
                                 rng=np.random.default_rng(1))
        single = MerCounter(k, 1 << 10, canonical=True, matrix=port.matrix,
                            device="cpu")
        _feed(port, chunks, packed, P)
        _feed(single, chunks, packed, P)
        got = port.finalize_np()
        _equal(got, single.finalize_np())
        mers, counts = port.finalize()
        assert dict(zip(map(int, mers), map(int, counts))) == want
        assert 0 < len(port.finalize_local_np()) < P


@pytest.mark.parametrize("k,size", [(16, 1 << 32), (32, 1 << 64)])
def test_all_ones_sortkey_beside_pad(k, size):
    """Under the identity matrix poly-T is the all-ones sortkey (at k = 32
    it is the PAD key itself). Every chunk has pad rows: the mer reaches
    the last shard with its count, and no pad row reaches any shard."""
    P = 3
    seqs = ["T" * 60, "ACGT" * 30, "T" * (k + 4) + "NNA" + "GATC" * 20]
    chunks = _chunks(seqs * 3, P)
    want = oracle_counts(seqs * 3, k, False)
    port = ShardedMerCounter(k, size, mesh=make_mesh(P, "cpu"))
    assert port.matrix.is_identity() and port.lsize == 2 * k
    single = MerCounter(k, size, matrix=port.matrix, device="cpu")
    _feed(port, chunks, True, P)
    _feed(single, chunks, True, P)
    got = port.finalize_np()
    _equal(got, single.finalize_np())
    mers, counts = port.finalize()
    assert dict(zip(map(int, mers), map(int, counts))) == want
    ones = (1 << (2 * k)) - 1
    assert int(mers[-1]) == ones and counts[-1] == want[ones]
    last = port.finalize_local_np()[-1]
    assert last[0] == P - 1
    assert all(s.store.total_pads() == 0 and s.store.residual_pads == 0
               for s in port.shards)


def test_skewed_owner_map_stays_exact(genome, monkeypatch):
    """Every key routed to one shard: segments are cut at their exact
    lengths, so a skewed load needs no capacity and loses nothing (the
    JAX package's overflow replay has no counterpart)."""
    k, P = 21, 4
    monkeypatch.setattr(
        sharded, "_owner_of_sortkeys",
        lambda keys, k, n: torch.full((keys.shape[0],), n - 1,
                                      dtype=torch.int64))
    rng = np.random.default_rng(44)
    chunks = _chunks(_reads(rng, 16, genome), P)
    port = ShardedMerCounter(k, 1 << 12, mesh=make_mesh(P, "cpu"),
                             canonical=True, rng=rng)
    single = MerCounter(k, 1 << 12, canonical=True, matrix=port.matrix,
                        device="cpu")
    _feed(port, chunks, True, P)
    _feed(single, chunks, True, P)
    _equal(port.finalize_np(), single.finalize_np())
    assert [p for p, _, _ in port.finalize_local_np()] == [P - 1]


def test_restrict_to_matches_single_device(genome):
    """restrict_to (--if) through the exchange: the allowed mers, each
    with its count or 0, as the single-device count gives them; chunks of
    several lengths and a short one."""
    k, P = 21, 3
    rng = np.random.default_rng(21)
    chunks = _chunks(_reads(rng, 12, genome), P)
    rand = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 600)]
    allowed = [chunks[0], chunks[3][:500], rand, rand[:10], chunks[5]]
    port = ShardedMerCounter(k, 1 << 12, mesh=make_mesh(P, "cpu"),
                             canonical=True, rng=rng)
    single = MerCounter(k, 1 << 12, canonical=True, matrix=port.matrix,
                        device="cpu")
    for c in (port, single):
        c.restrict_to(iter(allowed))
        _feed(c, chunks, True, P)
    got = port.finalize_np()
    _equal(got, single.finalize_np())
    assert (got[1] == 0).sum() > 300 and (got[1] > 0).sum() > 300


def test_mesh_and_rows_checks():
    assert make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(devices=["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert make_mesh(1, ["cpu", "cpu"]) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="3 shards on 2 devices"):
        make_mesh(3, ["cpu", "cpu"])
    c = ShardedMerCounter(21, 1 << 10, mesh=[None] * 4, device="cpu")
    assert c.n_shards == 4 and c.device == torch.device("cpu")
    with pytest.raises(ValueError, match=r"expected \[4, \.\.\.\] rows"):
        c.add_chunks(np.full((3, L), ord("A"), np.uint8))


def test_mesh_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedMerCounter(21, 1 << 10)


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(genome, tmp_path_factory):
    """FASTQ of 400-800-base reads of the genome, and an --if file: some
    of the reads and random sequence (mers that dump at 0)."""
    d = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(99)
    seqs = _reads(rng, 24, genome)
    fq, allow = d / "r.fq", d / "allow.fa"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                          for i, s in enumerate(seqs)))
    rand = "".join("ACGT"[c] for c in rng.integers(0, 4, 700))
    allow.write_text("".join(f">a{i}\n{seqs[i]}\n" for i in (0, 5, 9))
                     + f">r\n{rand}\n")
    return d, str(fq), str(allow)


def _records(path):
    with open(path, "rb") as f:
        data = f.read()
    return data[FileHeader.read(__import__("io").BytesIO(data)).offset:]


def _port(d, name, argv, fq):
    out = str(d / name)
    assert torch_main([*argv, "-o", out, fq], device="cpu") == 0
    return _records(out)


def _jax(d, name, argv, fq):
    out = str(d / name)
    assert _jax_main([*argv, "-o", out, fq]) == 0
    return _records(out)


@pytest.mark.parametrize("P,extra", [
    (2, ["--chunk-len", "1k", "--disk", "-s", "1k"]),
    (5, ["-C", "--if", "ALLOW"]),
    (4, ["-m", "33", "-s", "2"]),
], ids=lambda v: v if isinstance(v, int) else " ".join(v))
def test_cli_devices_match_jax(files, tmp_path, monkeypatch, P, extra):
    """count -d P: the JAX package's -d P records, and (but for -s below
    P, where the JAX package floors lsize at log2(P)) the port's
    single-device records. --chunk-len 1k takes the ASCII path, whose
    last step is padded with all-N chunks; --disk spills several partials
    and merges them; -s 2 with 4 shards takes a 2 x 66 matrix."""
    d, fq, allow = files
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    extra = [allow if a == "ALLOW" else a for a in extra]
    k = [] if "-m" in extra else ["-m", "21"]
    size = [] if "-s" in extra else ["-s", "10k"]
    argv = ["count", *k, *size, "--matrix-seed", "31", "--chunk-len",
            "1024", *extra]
    dev = ["-d", str(P)]
    got = _port(tmp_path, "t.jf", [*argv, *dev], fq)
    assert len(got) > 1000
    assert got == _jax(tmp_path, "j.jf", [*argv, *dev], fq)
    below_p = extra[-2:] == ["-s", "2"]
    single = _port(tmp_path, "s.jf", argv, fq)
    assert (got == single) != below_p
    assert not list(tmp_path.glob("*.jf[0-9]*"))
    if "--if" in extra:
        dump = tmp_path / "dump.txt"
        assert torch_main(["dump", "-c", "-o", str(dump),
                           str(tmp_path / "t.jf")]) == 0
        counts = [int(x.split()[1]) for x in dump.read_text().splitlines()]
        assert counts.count(0) > 300 and max(counts) > 1
    if below_p:
        with open(tmp_path / "t.jf", "rb") as f:
            h = FileHeader.read(f)
        assert h.size == 4 and h.matrix(1).r == 2


def test_cli_devices_disk_spills(files, tmp_path, monkeypatch):
    """-d 2 --disk -s 1k --no-merge --no-unlink leaves several partials,
    and `merge` of them writes the records of the whole count in
    memory."""
    d, fq, _ = files
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    argv = ["count", "-m", "21", "-s", "1k", "-C", "--matrix-seed", "31",
            "--chunk-len", "1024", "-d", "2", "--disk", "--no-merge",
            "--no-unlink"]
    assert torch_main([*argv, "-o", str(tmp_path / "t.jf"), fq],
                      device="cpu") == 0
    parts = sorted(tmp_path.glob("t.jf[0-9]*"))
    assert len(parts) >= 3
    merged = str(tmp_path / "m.jf")
    assert torch_main(["merge", "-o", merged, *map(str, parts)],
                      device="cpu") == 0
    whole = _port(tmp_path, "w.jf", ["count", "-m", "21", "-s", "1k", "-C",
                                     "--matrix-seed", "31", "--chunk-len",
                                     "1024"], fq)
    assert _records(merged) == whole


def test_cli_devices_packed_store_equals_dense(files, tmp_path):
    """-d 3 --packed-store writes the dense store's records (held to the
    dense store, not to the JAX package, whose unpack turns a real
    all-ones low key into PAD)."""
    _, fq, _ = files
    argv = ["count", "-m", "21", "-s", "10k", "-C", "--matrix-seed", "8",
            "--chunk-len", "1024", "-d", "3"]
    packed = _port(tmp_path, "p.jf", [*argv, "--packed-store"], fq)
    assert packed == _port(tmp_path, "d.jf", argv, fq)
    assert len(packed) > 1000


@pytest.fixture
def seeded(monkeypatch):
    """numpy.random.default_rng() without a seed gives a seeded generator,
    in both packages: bc's and --bf-size's hash matrices match."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(777 if seed is None else seed))
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")


def test_cli_devices_bc_matches_jax(files, seeded, tmp_path):
    """-d 4 --bc: the check is stateless, so the records are the JAX
    package's -d 4 --bc records and the single-device port's."""
    _, fq, _ = files
    bc = str(tmp_path / "r.bc")
    assert torch_main(["bc", "-m", "21", "-s", "20k", "-C", "-o", bc, fq],
                      device="cpu") == 0
    argv = ["count", "-m", "21", "-s", "10k", "-C", "--matrix-seed", "3",
            "--bc", bc, "--chunk-len", "1024"]
    got = _port(tmp_path, "t.jf", [*argv, "-d", "4"], fq)
    assert len(got) > 100
    assert got == _jax(tmp_path, "j.jf", [*argv, "-d", "4"], fq)
    assert got == _port(tmp_path, "s.jf", argv, fq)


def test_cli_devices_bf_size_is_single_device(files, seeded, tmp_path):
    """-d 3 --bf-size: the chunks' distinct mers reach the one filter in
    stream order, so the records are the single-device port's and the JAX
    package's single-device records (the port's choice; see the module
    docstring)."""
    _, fq, _ = files
    argv = ["count", "-m", "21", "-s", "10k", "-C", "--matrix-seed", "5",
            "--bf-size", "20k", "--chunk-len", "1024"]
    got = _port(tmp_path, "t.jf", [*argv, "-d", "3"], fq)
    assert len(got) > 100
    assert got == _port(tmp_path, "s.jf", argv, fq)
    assert got == _jax(tmp_path, "j.jf", argv, fq)


@pytest.mark.parametrize("dev", ["auto", "0", "1"])
def test_cli_devices_one_device(files, tmp_path, dev):
    """-d auto (1 on the CPU), -d 0 and -d 1 count on one device: the
    records of a count without -d."""
    _, fq, _ = files
    argv = ["count", "-m", "21", "-s", "10k", "--matrix-seed", "4",
            "--chunk-len", "1024"]
    assert (_port(tmp_path, "t.jf", [*argv, "-d", dev], fq)
            == _port(tmp_path, "s.jf", argv, fq))


def test_cli_devices_above_visible_dies(files, tmp_path, monkeypatch,
                                        capsys):
    """On the card, -d N above the visible CUDA devices dies with the JAX
    package's message before it builds anything on a device."""
    _, fq, _ = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        torch_main(["count", "-m", "21", "-s", "1M", "-d", "2",
                    "-o", str(tmp_path / "x.jf"), fq])
    assert e.value.code == 1
    assert ("count: --devices 2 exceeds the 1 visible devices"
            in capsys.readouterr().err)
    assert not (tmp_path / "x.jf").exists()
