"""`count --disk`, `merge` and the database readers of the port against the
JAX package, on the CPU: `python -m jellyfish_tpu_torch` against `python -m
jellyfish_tpu` in-process, with SOURCE_DATE_EPOCH and --matrix-seed set.

--disk mirrors tests/test_cli.py's spill tests: the merged database equals
the in-memory one, and partials kept by --no-merge --no-unlink merge (by
the JAX package) into it. histo, dump, stats and info print what the JAX
package prints for the same database.
"""

import glob
import io
import os

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.io.header import FileHeader

torch.set_num_threads(1)


def _jax_main(argv):
    from jellyfish_tpu.cli import main

    return main(argv)


def _records(path):
    with open(path, "rb") as f:
        data = f.read()
    return data[FileHeader.read(io.BytesIO(data)).offset:]


@pytest.fixture(autouse=True)
def _epoch(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Seeded FASTA: 400 reads of 200 bases from a 30 kbase genome, some
    with N bases."""
    d = tmp_path_factory.mktemp("dbtools")
    rng = np.random.default_rng(2718)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 30000))
    fa = d / "r.fa"
    with open(fa, "w") as f:
        for i in range(400):
            s = int(rng.integers(0, len(genome) - 200))
            seq = list(genome[s:s + 200])
            if i % 7 == 0:
                seq[int(rng.integers(0, 200))] = "N"
            f.write(f">r{i}\n{''.join(seq)}\n")
    return d, str(fa)


def _count(main, d, name, k, size, *extra, device=True):
    out = str(d / name)
    argv = ["count", "-m", str(k), "-s", size, "-C", "--chunk-len", "4096",
            "--matrix-seed", "7", *extra, "-o", out, str(d / "r.fa")]
    assert (main(argv, device="cpu") if device else main(argv)) == 0
    return out


@pytest.mark.parametrize("k,size,extra", [
    (21, "3k", []),
    (21, "3k", ["-L", "2", "-U", "5"]),
    (63, "2k", []),
])
def test_disk_spill_equals_memory(reads, k, size, extra):
    """The port's --disk database equals its in-memory count, and the JAX
    package's --disk and in-memory databases, record for record."""
    d, _ = reads
    tag = f"{k}{''.join(extra)}"
    mem = _count(torch_main, d, f"mem{tag}.jf", k, size, *extra)
    disk = _count(torch_main, d, f"disk{tag}.jf", k, size, "--disk", *extra)
    assert not glob.glob(disk + "[0-9]*")  # partials unlinked
    jmem = _count(_jax_main, d, f"jmem{tag}.jf", k, size, *extra,
                  device=False)
    jdisk = _count(_jax_main, d, f"jdisk{tag}.jf", k, size, "--disk", *extra,
                   device=False)
    want = _records(jmem)
    assert len(want) > 10_000
    assert _records(mem) == want
    assert _records(disk) == want
    assert _records(jdisk) == want


@pytest.mark.parametrize("k", [21, 63])
def test_disk_no_merge_partials(reads, k):
    """--no-merge --no-unlink leaves at least three partials; the JAX
    package's merge of them, and the port's, equal the in-memory count."""
    d, _ = reads
    pre = _count(torch_main, d, f"part{k}.jf", k, "2k", "--disk",
                 "--no-merge", "--no-unlink")
    assert not os.path.exists(pre)
    parts = sorted(glob.glob(pre + "[0-9]*"))
    assert len(parts) >= 3
    mem = _count(torch_main, d, f"pmem{k}.jf", k, "2k")
    out_j, out_t = str(d / f"pj{k}.jf"), str(d / f"pt{k}.jf")
    assert _jax_main(["merge", "-o", out_j, *parts]) == 0
    assert torch_main(["merge", "-o", out_t, *parts], device="cpu") == 0
    assert _records(out_j) == _records(mem)
    assert _records(out_t) == _records(mem)


def test_disk_no_write_leaves_nothing(reads, tmp_path):
    """With --no-write the port does not spill, so nothing is written. The
    JAX package spills all the same and leaves its partials behind
    (ADVICE.md, cli/count.py:498): a divergence kept on purpose."""
    d, fa = reads
    out = str(tmp_path / "nw.jf")
    argv = ["count", "-m", "21", "-s", "2k", "--disk", "--no-write",
            "--chunk-len", "4096", "-o", out, fa]
    assert torch_main(argv, device="cpu") == 0
    assert os.listdir(tmp_path) == []
    assert _jax_main(argv) == 0
    assert glob.glob(out + "[0-9]*")


@pytest.fixture(scope="module")
def dbs(reads):
    """Two binary databases of the reads (k = 21 and k = 63) and a text one
    (written by the JAX package: the port's count has no --text yet)."""
    d, _ = reads
    return {
        "k21": _count(torch_main, d, "db21.jf", 21, "10k"),
        "k63": _count(torch_main, d, "db63.jf", 63, "10k", "-L", "2"),
        "text": _count(_jax_main, d, "dbtext.jf", 21, "10k", "--text",
                       device=False),
    }


@pytest.mark.parametrize("db", ["k21", "k63", "text"])
@pytest.mark.parametrize("argv", [
    ["histo"], ["histo", "-l", "2", "-h", "5", "-i", "2", "-f"],
    ["dump"], ["dump", "-c", "-t", "-L", "2", "-U", "4"],
    ["stats"], ["stats", "-L", "2"],
    ["info"], ["info", "-c"], ["info", "-j"],
], ids=lambda a: " ".join(a))
def test_readers_print_what_jax_prints(dbs, capsys, db, argv):
    assert torch_main([*argv, dbs[db]]) == 0
    got = capsys.readouterr().out
    assert _jax_main([*argv, dbs[db]]) == 0
    want = capsys.readouterr().out
    assert got == want and got


def test_reader_output_file_and_skip(dbs, tmp_path, capsysbinary):
    """-o writes the same file; info -s prints the raw records."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert torch_main(["dump", "-c", "-o", a, dbs["k21"]]) == 0
    assert _jax_main(["dump", "-c", "-o", b, dbs["k21"]]) == 0
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    assert torch_main(["info", "-s", dbs["k21"]]) == 0
    assert capsysbinary.readouterr().out == _records(dbs["k21"])


@pytest.mark.parametrize("flags", [
    [], ["-m"], ["-m", "-L", "0"], ["-M", "-U", "3"], ["-L", "3", "-U", "9"],
], ids=lambda f: " ".join(f) or "sum")
def test_merge_cli_matches_jax(reads, flags):
    """merge through both CLIs on partials of one --disk run; -m defaults
    -L to 1."""
    d, _ = reads
    pre = _count(torch_main, d, "cli.jf", 21, "2k", "--disk", "--no-merge",
                 "--no-unlink")
    parts = sorted(glob.glob(pre + "[0-9]*"))
    out_j, out_t = str(d / "cj.jf"), str(d / "ct.jf")
    assert _jax_main(["merge", *flags, "-o", out_j, *parts]) == 0
    assert torch_main(["merge", *flags, "-o", out_t, *parts],
                      device="cpu") == 0
    assert _records(out_t) == _records(out_j)


def test_merge_cli_jaccard_and_errors(reads, capsys, tmp_path):
    d, _ = reads
    pre = _count(torch_main, d, "jac.jf", 21, "2k", "--disk", "--no-merge",
                 "--no-unlink")
    parts = sorted(glob.glob(pre + "[0-9]*"))
    assert _jax_main(["merge", "-j", "-o", str(tmp_path / "j"), *parts]) == 0
    want = capsys.readouterr().out
    assert torch_main(["merge", "-j", "-o", str(tmp_path / "t"), *parts],
                      device="cpu") == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("Jaccard ")
    with pytest.raises(SystemExit):
        torch_main(["merge", "-o", str(tmp_path / "x"), parts[0]],
                   device="cpu")
    assert "needs at least 2" in capsys.readouterr().err
    other = _count(torch_main, d, "other.jf", 21, "64k")  # another size
    with pytest.raises(SystemExit):
        torch_main(["merge", "-o", str(tmp_path / "x"), parts[0], other],
                   device="cpu")
    assert "jellyfish: Can't merge" in capsys.readouterr().err


@pytest.mark.parametrize("k", [11, 21, 63])
def test_record_writers_match_jax(k):
    """The copied record writers give the JAX package's bytes, counts
    saturating at the field width."""
    from jellyfish_tpu.io import files as jf

    from jellyfish_tpu_torch.io import files as tf

    rng = np.random.default_rng(k)
    mers = [int(x) for x in rng.integers(0, 1 << min(2 * k, 62), 300)]
    counts = [int(x) for x in rng.integers(0, 1 << 20, 300)]
    for cl in (1, 2, 4):
        a, b = io.BytesIO(), io.BytesIO()
        tf.write_binary_records(a, mers, counts, k, cl)
        jf.write_binary_records(b, mers, counts, k, cl)
        assert a.getvalue() == b.getvalue() and a.getvalue()
    a, b = io.BytesIO(), io.BytesIO()
    tf.write_text_records(a, mers, counts, k)
    jf.write_text_records(b, mers, counts, k)
    assert a.getvalue() == b.getvalue() and a.getvalue()
