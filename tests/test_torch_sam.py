"""SAM and BAM input of jellyfish_tpu_torch (`count --sam`, `fastq2sam`)
against the JAX package: the same chunks and counts from SAM and BAM files,
with and without -Q; the BAM reader across the JAX package's 4 MB window
edges; `count --sam` and `fastq2sam` byte for byte, error messages
included; and a truncated CRAM raising the JAX package's error (the CRAM
reader itself is held to the JAX package in test_torch_cram.py)."""

import struct
import zlib

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.io.header import FileHeader

from tests.conftest import random_dna

torch.set_num_threads(1)


def _jax_main(argv):
    from jellyfish_tpu.cli import main

    return main(argv)


def _write_sam(path, seqs, quals=None):
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        f.write("@SQ\tSN:ref\tLN:10000\n")
        for i, s in enumerate(seqs):
            q = quals[i] if quals else "*"
            f.write(f"r{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}\n")
        # a record without SEQ, which is skipped
        f.write("empty\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")


def _bgzf_block(data: bytes) -> bytes:
    """One BGZF block (a gzip member with the BC extra field)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    total = 18 + len(payload) + 8
    head = (b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, total - 1))
    return (head + payload
            + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF))


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_NIB = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate("=ACMGRSVTWYHKDBN"):
    _NIB[ord(_b)] = _i


def _write_bam(path, seqs, quals=None):
    """A BAM file: header, one unmapped record a sequence, BGZF blocks of
    at most 60,000 bytes and the EOF block. quals[i] is a list of raw phred
    values, or None for no quality (0xFF fill)."""
    body = [b"BAM\x01", struct.pack("<ii", 0, 1),
            struct.pack("<i", 4), b"ref\x00", struct.pack("<i", 10000)]
    for i, s in enumerate(seqs):
        name = f"r{i}".encode() + b"\x00"
        nib = _NIB[np.frombuffer(s.encode(), dtype=np.uint8)]
        if len(nib) % 2:
            nib = np.append(nib, 0)
        packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
        q = (bytes(quals[i]) if quals and quals[i] is not None
             else b"\xff" * len(s))
        rec = struct.pack("<iiBBHHHiiii", -1, -1, len(name), 0, 0, 0, 4,
                          len(s), -1, -1, 0) + name + packed + q
        body += [struct.pack("<i", len(rec)), rec]
    data = b"".join(body)
    with open(path, "wb") as f:
        for off in range(0, len(data), 60000):
            f.write(_bgzf_block(data[off:off + 60000]))
        f.write(_BGZF_EOF)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Reads with N bases and with qualities, as SAM and as BAM."""
    d = tmp_path_factory.mktemp("sam")
    rng = np.random.default_rng(271828)
    seqs = [random_dna(rng, int(n), with_n=True)
            for n in rng.integers(20, 400, 40)]
    quals = [None if i % 5 == 0 else
             [int(x) for x in rng.integers(2, 60, len(s))]
             for i, s in enumerate(seqs)]
    sam_quals = ["*" if q is None else "".join(chr(x + 33) for x in q)
                 for q in quals]
    _write_sam(d / "a.sam", seqs, sam_quals)
    _write_bam(d / "a.bam", seqs, quals)
    return d


def _chunks(pkg, path, k, min_qual):
    import importlib

    parse = importlib.import_module(f"{pkg}.io.parse")
    with parse.SequenceChunker([], k, 512, min_qual=min_qual,
                               sam_paths=[str(path)]) as ch:
        return [c.tobytes() for c in ch.chunks()]


@pytest.mark.parametrize("name", ["a.sam", "a.bam"])
@pytest.mark.parametrize("min_qual", [None, 30 + 33], ids=["all", "Q30"])
def test_chunks_and_counts_match_jax(inputs, name, min_qual):
    """The chunker yields the JAX package's chunks from a SAM or a BAM
    file, low-quality bases masked under -Q, and the counter counts them
    as the JAX package does."""
    from jellyfish_tpu.counter import MerCounter as JaxCounter

    from jellyfish_tpu_torch.counter import MerCounter

    k = 15
    got = _chunks("jellyfish_tpu_torch", inputs / name, k, min_qual)
    want = _chunks("jellyfish_tpu", inputs / name, k, min_qual)
    assert got == want
    t = MerCounter(k, 1 << 12, rng=np.random.default_rng(1), device="cpu")
    j = JaxCounter(k, 1 << 12, rng=np.random.default_rng(1))
    for c in got:
        chunk = np.frombuffer(c, dtype=np.uint8).copy()
        t.add_chunk(chunk)
        j.add_chunk(chunk)
    tm, tc = t.finalize_np()
    jm, jc = j.finalize_np()
    assert len(tc) > 100
    assert np.array_equal(tm, np.asarray(jm)) and np.array_equal(tc, jc)


def test_bam_across_window_edges_matches_jax(tmp_path):
    """A BAM larger than the native parser's 4 MB window, with record
    boundaries drifting across its edges: the port's reader yields the JAX
    reader's FASTA/FASTQ bytes."""
    from jellyfish_tpu.io.parse import open_stream as jax_open
    from jellyfish_tpu.io.parse import sam_records_to_fastx as jax_records

    from jellyfish_tpu_torch.io.parse import open_stream, sam_records_to_fastx

    rng = np.random.default_rng(99)
    lens = rng.integers(301, 500, 12000)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [letters[rng.integers(0, 4, n)].tobytes().decode() for n in lens]
    quals = [None if i % 2 else rng.integers(0, 90, len(s)).tolist()
             for i, s in enumerate(seqs)]
    bam = str(tmp_path / "big.bam")
    _write_bam(bam, seqs, quals)
    with open_stream(bam) as f:
        got = b"".join(sam_records_to_fastx(f))
    with jax_open(bam) as f:
        want = b"".join(jax_records(f))
    assert len(got) > (1 << 22) + (1 << 20)
    # a FASTQ record (with quality) is 4 lines, a FASTA record 2
    n_fastq = sum(q is not None for q in quals)
    assert got.count(b"\n") == 4 * n_fastq + 2 * (len(seqs) - n_fastq)
    assert got == want


def _split(path):
    with open(path, "rb") as f:
        h = FileHeader.read(f)
        return h.root, f.read()


@pytest.mark.parametrize("extra", [
    ["--sam", "a.sam"],
    ["--sam", "a.bam", "-Q", "?"],
    ["--sam", "a.sam", "--sam", "a.bam", "x.fa"],
], ids=["sam", "bam-Q", "sam-bam-fasta"])
def test_count_sam_cli_matches_jax(inputs, tmp_path, monkeypatch, extra):
    """count --sam through the CLI: the JAX package's database, records
    byte for byte and the header apart from where and how it was run."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    (inputs / "x.fa").write_text(">x\n" + "ACGTTGCA" * 40 + "\n")
    extra = [str(inputs / a) if a.endswith((".sam", ".bam", ".fa")) else a
             for a in extra]
    common = ["count", "-m", "17", "-s", "10k", "-C", "--matrix-seed", "5",
              "--chunk-len", "1024", *extra]
    out_t, out_j = str(tmp_path / "t.jf"), str(tmp_path / "j.jf")
    assert torch_main([*common, "-o", out_t], device="cpu") == 0
    assert _jax_main([*common, "-o", out_j]) == 0
    ht, rt = _split(out_t)
    hj, rj = _split(out_j)
    assert len(rt) > 1000
    assert rt == rj
    for h in (ht, hj):
        for key in ("exe_path", "pwd", "cmdline"):
            h.pop(key, None)
    assert ht == hj


def test_fastq2sam_matches_jax(tmp_path):
    """fastq2sam writes the JAX package's SAM bytes, and count --sam of it
    counts the FASTQ's mers."""
    rng = np.random.default_rng(4)
    lines = []
    for i in range(50):
        s = random_dna(rng, int(rng.integers(30, 200)), with_n=True)
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, len(s)))
        lines.append(f"@read {i} x\n{s}\n+\n{q}\n")
    for d in ("t", "j"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "r.fastq").write_text("".join(lines))
    assert torch_main(["fastq2sam", str(tmp_path / "t" / "r.fastq")]) == 0
    assert _jax_main(["fastq2sam", str(tmp_path / "j" / "r.fastq")]) == 0
    got = (tmp_path / "t" / "r.sam").read_bytes()
    assert got.count(b"\n") == 50
    assert got == (tmp_path / "j" / "r.sam").read_bytes()
    out_s, out_q = str(tmp_path / "s.jf"), str(tmp_path / "q.jf")
    common = ["count", "-m", "13", "-s", "10k", "--matrix-seed", "2",
              "--chunk-len", "1024"]
    assert torch_main([*common, "--sam", str(tmp_path / "t" / "r.sam"),
                       "-o", out_s], device="cpu") == 0
    assert torch_main([*common, str(tmp_path / "t" / "r.fastq"),
                       "-o", out_q], device="cpu") == 0
    assert _split(out_s)[1] == _split(out_q)[1]


@pytest.mark.parametrize("name,body", [
    ("r.fq", b"@a\nACGT\n+\nIIII\n"),
    ("r.fastq", b"@a\nACGT\n+\nIIII\nXa\nACGT\n+\nIIII\n"),
    ("r.fastq", b"@a\nACGT\n-\nIIII\n"),
    ("missing.fastq", None),
], ids=["extension", "bad-record-start", "no-plus-line", "unreadable"])
def test_fastq2sam_errors_match_jax(tmp_path, capsys, name, body):
    """fastq2sam's error messages and exit status are the JAX package's."""
    got = []
    for pkg, main in (("t", torch_main), ("j", _jax_main)):
        (tmp_path / pkg).mkdir()
        path = tmp_path / pkg / name
        if body is not None:
            path.write_bytes(body)
        with pytest.raises(SystemExit) as e:
            main(["fastq2sam", str(path)])
        err = capsys.readouterr().err.replace(str(tmp_path / pkg), "DIR")
        got.append((e.value.code, err))
    assert got[0][0] not in (0, None)
    assert "fastq2sam: " in got[0][1]
    assert got[0] == got[1]


def test_cram_raises_not_ported(tmp_path):
    """CRAM input is ported: a truncated CRAM file, read directly or
    through count --sam, raises the JAX package's CramError with its
    message."""
    from jellyfish_tpu.io.parse import sam_records_to_fastx as jax_records

    from jellyfish_tpu_torch.io.cram import CramError
    from jellyfish_tpu_torch.io.parse import sam_records_to_fastx

    p = tmp_path / "x.cram"
    p.write_bytes(b"CRAM" + b"\x03\x01" + b"\x00" * 30)
    with open(p, "rb") as f, pytest.raises(CramError) as got:
        list(sam_records_to_fastx(f))
    with open(p, "rb") as f, pytest.raises(ValueError) as want:
        list(jax_records(f))
    assert type(want.value).__name__ == "CramError"
    assert str(got.value) == str(want.value) != ""
    with pytest.raises(CramError, match="truncated CRAM"):
        torch_main(["count", "-m", "15", "-s", "1k", "--sam", str(p),
                    "-o", str(tmp_path / "o.jf")], device="cpu")


@pytest.mark.parametrize("head", [b">r\nACGT\n", b"@r\nACGT\n+\nIIII\n",
                                  b"ACGT\n"], ids=["fasta", "fastq", "bad"])
def test_sniff_format_matches_jax(tmp_path, head):
    import jellyfish_tpu.io.parse as jparse

    import jellyfish_tpu_torch.io.parse as tparse

    p = tmp_path / "x"
    p.write_bytes(head)
    got = []
    for mod in (tparse, jparse):
        with mod.open_stream(str(p)) as f:
            try:
                got.append(mod.sniff_format(f))
            except ValueError as e:
                got.append(str(e))
    assert got[0] == got[1]
