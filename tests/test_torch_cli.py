"""`python -m jellyfish_tpu_torch count`, `bc`, `query`, `mem`, `cite` and
`generate` against the same subcommands of `python -m jellyfish_tpu`:
with SOURCE_DATE_EPOCH and --matrix-seed, the databases and .bc files
hold the same records byte for byte (binary or text), and the same header
apart from exe_path, pwd and cmdline; query, mem and cite print the same
text; generate writes the same files. The Bloom hash matrices come from
an unseeded numpy generator in both packages, so these tests seed it in
both. A key width above the kernels' raises NotPortedError."""

import gzip
import io

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch import NotPortedError
from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.io.header import FileHeader

torch.set_num_threads(1)


def _jax_main(argv):
    from jellyfish_tpu.cli import main

    return main(argv)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Seeded FASTQ (150-base reads with N bases and low-quality bases)
    and gzipped multi-line FASTA of the same genome."""
    d = tmp_path_factory.mktemp("torchcli")
    rng = np.random.default_rng(31337)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 6000))
    fq, fa = d / "r.fq", d / "r.fa.gz"
    with open(fq, "w") as f:
        for i in range(160):
            s = int(rng.integers(0, len(genome) - 150))
            seq = list(genome[s:s + 150])
            for j in rng.integers(0, 150, 2):
                seq[j] = "N" if i % 3 == 0 else seq[j]
            qual = "".join(rng.choice(list("#5I"), 150, p=[0.05, 0.15, 0.8]))
            f.write(f"@r{i}\n{''.join(seq)}\n+\n{qual}\n")
    with gzip.open(fa, "wt") as f:
        for i in range(40):
            s = int(rng.integers(0, len(genome) - 300))
            seq = genome[s:s + 300]
            f.write(f">c{i}\n{seq[:120]}\n{seq[120:]}\n")
    return d, str(fq), str(fa)


def _split(path):
    with open(path, "rb") as f:
        data = f.read()
    h = FileHeader.read(io.BytesIO(data))
    return h.root, data[h.offset:]


@pytest.mark.parametrize("k,extra", [
    (21, ["-C"]),
    (21, ["-L", "2", "-U", "6"]),
    (33, []),
    (33, ["-C", "-L", "3", "--out-counter-len", "1", "-Q", "5"]),
    (63, ["-C"]),
    (100, ["-L", "2"]),
])
def test_count_db_matches_jax(reads, monkeypatch, k, extra):
    d, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    common = ["count", "-m", str(k), "-s", "10k", "--chunk-len", "2048",
              "--matrix-seed", "4242", *extra]
    out_t, out_j = str(d / f"t{k}.jf"), str(d / f"j{k}.jf")
    assert torch_main(common + ["-o", out_t, fq, fa], device="cpu") == 0
    assert _jax_main(common + ["-o", out_j, fq, fa]) == 0
    ht, rec_t = _split(out_t)
    hj, rec_j = _split(out_j)
    assert len(rec_t) > 1000
    assert rec_t == rec_j
    for h in (ht, hj):
        for key in ("exe_path", "pwd", "cmdline"):
            h.pop(key, None)
    assert ht == hj


def test_no_write_and_timing(reads, tmp_path):
    d, fq, _ = reads
    out, timing = tmp_path / "x.jf", tmp_path / "t.txt"
    assert torch_main(["count", "-m", "21", "-s", "1M", "--no-write",
                       "--chunk-len", "4096", "--timing", str(timing),
                       "-o", str(out), fq], device="cpu") == 0
    assert not out.exists()
    assert [line.split()[0] for line in timing.read_text().splitlines()] == [
        "Init", "Counting", "Writing"]


@pytest.mark.parametrize("k", [113, 128])
def test_key_width_above_the_kernels_raises(tmp_path, k):
    """k > 112 needs keys of more 32-bit limbs than the kernels' template
    instances take: count refuses before it opens any input."""
    missing = str(tmp_path / "never_read.fq")
    with pytest.raises(NotPortedError, match="k <= 112"):
        torch_main(["count", "-m", str(k), "-s", "1M", "-o",
                    str(tmp_path / "x.jf"), missing], device="cpu")


def test_bc_generator_raises(reads, tmp_path):
    """bc -g: a generator command that exits nonzero after its output was
    read raises, and so does one in count -g, however much it wrote."""
    _, fq, _ = reads
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"cat {fq}\ncat {fq}; exit 3\n")
    with pytest.raises(RuntimeError, match="status 3"):
        torch_main(["bc", "-m", "21", "-s", "1M", "-g", str(cmds),
                    "-o", str(tmp_path / "x.bc")], device="cpu")
    with pytest.raises(RuntimeError, match="status 3"):
        torch_main(["count", "-m", "21", "-s", "1M", "-g", str(cmds),
                    "-o", str(tmp_path / "x.jf")], device="cpu")
    assert not (tmp_path / "x.jf").exists()


@pytest.fixture
def seeded(monkeypatch):
    """numpy.random.default_rng() without a seed gives a seeded generator,
    in both packages: bc's and --bf-size's hash matrices match."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(777 if seed is None else seed))
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")


def _same_files(out_t, out_j):
    ht, rec_t = _split(out_t)
    hj, rec_j = _split(out_j)
    assert rec_t == rec_j
    for h in (ht, hj):
        for key in ("exe_path", "pwd", "cmdline"):
            h.pop(key, None)
    assert ht == hj
    return rec_t


def _both(d, name, argv, inputs):
    """Run argv in both packages with -o d/t<name> and d/j<name>."""
    out_t, out_j = str(d / f"t{name}"), str(d / f"j{name}")
    assert torch_main([*argv, "-o", out_t, *inputs], device="cpu") == 0
    assert _jax_main([*argv, "-o", out_j, *inputs]) == 0
    return out_t, out_j


@pytest.fixture(scope="module")
def bc_files(reads, tmp_path_factory):
    """A .bc of the reads at k = 21 (canonical) and at k = 33, written by
    the JAX package with seeded matrices."""
    _, fq, fa = reads
    d = tmp_path_factory.mktemp("bcfiles")
    mp = pytest.MonkeyPatch()
    real = np.random.default_rng
    mp.setattr(np.random, "default_rng",
               lambda seed=None: real(555 if seed is None else seed))
    try:
        paths = {}
        for k, extra in ((21, ["-C"]), (33, [])):
            paths[k] = str(d / f"r{k}.bc")
            assert _jax_main(["bc", "-m", str(k), "-s", "20k", *extra,
                              "-o", paths[k], fq, fa]) == 0
    finally:
        mp.undo()
    return paths


@pytest.mark.parametrize("k,extra", [
    (21, ["-C"]), (33, []), (15, ["-f", "0.02", "--chunk-len", "777"]),
])
def test_bc_matches_jax(reads, seeded, tmp_path, k, extra):
    """The .bc file: header (m, hashes, both matrices) and packed cells."""
    _, fq, fa = reads
    out_t, out_j = _both(tmp_path, f"{k}.bc",
                         ["bc", "-m", str(k), "-s", "10k", *extra], [fq, fa])
    cells = _same_files(out_t, out_j)
    assert len(cells) > 1000 and any(cells)


@pytest.mark.parametrize("k,extra", [
    (21, ["-C"]), (21, ["-C", "-L", "3", "--chunk-len", "3000"]),
    (33, ["--out-counter-len", "1"]),
])
def test_count_bc_matches_jax(reads, bc_files, tmp_path, monkeypatch, k,
                              extra):
    """count --bc with the same .bc and --matrix-seed: the same records."""
    _, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    argv = ["count", "-m", str(k), "-s", "10k", "--matrix-seed", "99",
            "--bc", bc_files[k], "--chunk-len", "8192", *extra]
    rec = _same_files(*_both(tmp_path, f"{k}.jf", argv, [fq, fa]))
    assert len(rec) > 100


@pytest.mark.parametrize("k,extra", [
    (21, ["-C"]), (21, ["--bf-fp", "0.2", "-U", "5", "--chunk-len", "3001"]),
    (33, ["-C", "--bf-size", "5000"]),
])
def test_count_bf_size_matches_jax(reads, seeded, tmp_path, k, extra):
    """count --bf-size, seeded: every chunk's first occurrences dropped on
    the same chunks, with the same false positives."""
    _, fq, fa = reads
    argv = ["count", "-m", str(k), "-s", "10k", "--matrix-seed", "5",
            "--bf-size", "200k", "--chunk-len", "8192", *extra]
    rec = _same_files(*_both(tmp_path, f"{k}.jf", argv, [fq, fa]))
    assert len(rec) > 100


@pytest.mark.parametrize("k", [21, 33])
def test_count_bc_disk_matches_jax(reads, bc_files, tmp_path, monkeypatch,
                                   k):
    """count --bc --disk: spilled partials of filtered counts, merged."""
    _, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    argv = ["count", "-m", str(k), "-s", "1000", "--matrix-seed", "3",
            "--bc", bc_files[k], "--chunk-len", "4000", "--disk", "-C"]
    rec = _same_files(*_both(tmp_path, f"{k}.jf", argv, [fq, fa]))
    assert len(rec) > 100
    assert not list(tmp_path.glob("*.jf[0-9]*"))


@pytest.mark.parametrize("k,extra", [
    (21, ["-C"]), (33, ["-L", "2"]), (63, ["-C"]),
])
def test_count_ascii_chunks_match_jax(reads, tmp_path, monkeypatch, k,
                                      extra):
    """--chunk-len 1000 (not a multiple of 32): the ASCII path, in both
    packages; the database equals the packed path's too."""
    _, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    argv = ["count", "-m", str(k), "-s", "10k", "--matrix-seed", "8",
            *extra]
    rec = _same_files(*_both(tmp_path, f"{k}.jf",
                             [*argv, "--chunk-len", "1000"], [fq, fa]))
    packed = str(tmp_path / "packed.jf")
    assert torch_main([*argv, "--chunk-len", "1024", "-o", packed, fq, fa],
                      device="cpu") == 0
    assert _split(packed)[1] == rec


def _query_both(tmp_path, argv):
    out_t, out_j = str(tmp_path / "qt.txt"), str(tmp_path / "qj.txt")
    assert torch_main(["query", "-o", out_t, *argv], device="cpu") == 0
    assert _jax_main(["query", "-o", out_j, *argv]) == 0
    with open(out_t) as ft, open(out_j) as fj:
        return ft.read(), fj.read()


@pytest.mark.parametrize("fmt,k", [
    ("bloom", 21), ("bloom", 33), ("binary", 21), ("binary", 33),
])
def test_query_matches_jax(reads, bc_files, tmp_path, monkeypatch, fmt, k):
    """query -s (every mer of a sequence file) and mers on the command
    line (one of the wrong length), on a .bc and on a binary database."""
    _, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    db = bc_files[k]
    if fmt == "binary":
        db = str(tmp_path / "db.jf")
        assert _jax_main(["count", "-m", str(k), "-s", "10k", "-C",
                          "--matrix-seed", "4", "-o", db, fq, fa]) == 0
    seqs = tmp_path / "q.fa"
    with open(fq) as f:
        lines = f.read().splitlines()
    seqs.write_text(">a\n" + lines[1] + "\n>b\nACGTNNACGT\n>c\n"
                    + lines[5][:80] + "\n")
    mers = [lines[9][i:i + k] for i in (0, 7, 40)] + ["ACGT", "A" * k]
    got, want = _query_both(tmp_path, ["-s", str(seqs), db, *mers])
    assert got == want
    assert len(want.splitlines()) > 100
    assert any(not line.endswith(" 0") for line in want.splitlines())


# -- --packed-store, --if, --text, generators, mem, cite, generate ----------


def _allow_file(tmp_path, fq, k):
    """FASTA of some reads of the input (counted mers) and of random
    sequence (mers never counted, which dump at 0)."""
    rng = np.random.default_rng(k)
    with open(fq) as f:
        lines = f.read().splitlines()
    path = tmp_path / "allow.fa"
    rand = "".join("ACGT"[c] for c in rng.integers(0, 4, 900))
    path.write_text("".join(f">a{i}\n{lines[4 * i + 1]}\n"
                            for i in range(0, 60, 3)) + f">r\n{rand}\n")
    return str(path)


@pytest.mark.parametrize("k,extra", [
    (21, ["--packed-store", "-C"]),
    (63, ["--packed-store", "-L", "2"]),
    (21, ["--packed-store", "--disk", "-s", "2000", "-C"]),
    (21, ["--if", "ALLOW", "-C"]),
    (63, ["--if", "ALLOW"]),
    (21, ["--if", "ALLOW", "--disk", "-s", "2000", "-C"]),
    (63, ["--if", "ALLOW", "--disk", "-s", "1000", "--packed-store"]),
    (21, ["--text", "-C", "-U", "5"]),
    (33, ["--text", "--disk", "-s", "2000"]),
], ids=lambda v: v if isinstance(v, int) else " ".join(v))
def test_count_modes_match_jax(reads, tmp_path, monkeypatch, k, extra):
    """count --packed-store, --if (also with --disk: every partial is
    restricted), --text and --text --disk: the same bytes as the JAX
    package's, and no partial left behind."""
    _, fq, fa = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    extra = [_allow_file(tmp_path, fq, k) if a == "ALLOW" else a
             for a in extra]
    size = [] if "-s" in extra else ["-s", "10k"]
    argv = ["count", "-m", str(k), *size, "--matrix-seed", "77",
            "--chunk-len", "2048", *extra]
    rec = _same_files(*_both(tmp_path, f"{k}.jf", argv, [fq, fa]))
    assert len(rec) > 100
    assert not list(tmp_path.glob("*.jf[0-9]*"))
    if "--if" in extra and "--disk" not in extra:
        # the random sequence's mers are in the dump, at count 0
        dump = tmp_path / "dump.txt"
        assert torch_main(["dump", "-c", "-o", str(dump),
                           str(tmp_path / f"t{k}.jf")]) == 0
        counts = [int(line.split()[1])
                  for line in dump.read_text().splitlines()]
        assert counts.count(0) > 500 and max(counts) > 1
    if "--text" in extra:
        assert rec.count(b"\n") > 100 and rec.split()[1].isdigit()


def test_text_db_parses_as_binary(reads, tmp_path):
    """count --text writes the records of the binary database of the same
    run, as text lines (`dump -c` of both is the same)."""
    _, fq, _ = reads
    common = ["count", "-m", "21", "-s", "10k", "-C", "--matrix-seed", "5",
              "--chunk-len", "4096"]
    out = {}
    for name, flags in (("bin", []), ("text", ["--text"])):
        db = str(tmp_path / f"{name}.jf")
        assert torch_main([*common, *flags, "-o", db, fq],
                          device="cpu") == 0
        txt = tmp_path / f"{name}.txt"
        assert torch_main(["dump", "-c", "-o", str(txt), db]) == 0
        out[name] = txt.read_text()
    assert out["bin"] == out["text"] and len(out["bin"]) > 1000


def _quarters(tmp_path, fq):
    with open(fq) as f:
        lines = f.read().splitlines(keepends=True)
    recs = ["".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]
    paths = []
    for j in range(4):
        path = tmp_path / f"q{j}.fq"
        path.write_text("".join(recs[j::4]))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("nb", [1, 2])
def test_count_generators_match_jax(reads, tmp_path, monkeypatch, nb):
    """count -g (a file of `cat` commands, one a quarter of the FASTQ) -G
    nb -S /bin/sh: the JAX package's bytes, and the records of the count
    of the file itself."""
    _, fq, _ = reads
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("".join(f"cat {q}\n" for q in _quarters(tmp_path, fq)))
    argv = ["count", "-m", "21", "-s", "10k", "-C", "--matrix-seed", "6",
            "--chunk-len", "4096"]
    rec = _same_files(*_both(tmp_path, "g.jf", [
        *argv, "-g", str(cmds), "-G", str(nb), "-S", "/bin/sh"], []))
    whole = str(tmp_path / "whole.jf")
    assert torch_main([*argv, "-o", whole, fq], device="cpu") == 0
    assert _split(whole)[1] == rec and len(rec) > 1000


def test_bc_generators_match_jax(reads, seeded, tmp_path):
    """bc -g -G 2: the same .bc as the JAX package's."""
    _, fq, _ = reads
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("".join(f"cat {q}\n" for q in _quarters(tmp_path, fq)))
    cells = _same_files(*_both(tmp_path, "g.bc", [
        "bc", "-m", "21", "-s", "10k", "-C", "-g", str(cmds), "-G", "2"],
        []))
    assert any(cells)


def _stdout_of(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["mem", "-m", "24", "-s", "1G"],
    ["mem", "-m", "31", "--mem", "8g"],
    ["mem", "-m", "21", "-s", "33554432", "--packed"],
    ["mem", "-m", "63", "--mem", "1G", "--packed", "-c", "9"],
    ["mem", "-m", "21", "-s", "4M", "-C", "-o", "x.jf", "--disk", "-t", "4",
     "--if", "a.fa", "r.fq"],
    ["cite"],
    ["cite", "-b"],
], ids=lambda a: " ".join(a))
def test_host_tools_match_jax(capsys, argv):
    got = _stdout_of(capsys, lambda a: torch_main(a, device="cpu"), argv)
    assert got == _stdout_of(capsys, _jax_main, argv) and got


@pytest.mark.parametrize("extra", [
    ["-m", "5000"],
    ["-m", "3000", "-m", "1k", "-r", "150", "-q"],
    ["-m", "2000", "-r", "300", "-s", "9"],
], ids=lambda a: " ".join(a))
def test_generate_matches_jax(tmp_path, extra):
    for name, main in (("t", lambda a: torch_main(a, device="cpu")),
                       ("j", _jax_main)):
        assert main(["generate", *extra, "-o", str(tmp_path / name)]) == 0
    got = sorted(p.name[1:] for p in tmp_path.glob("t*"))
    assert got and got == sorted(p.name[1:] for p in tmp_path.glob("j*"))
    for name in got:
        assert ((tmp_path / f"t{name}").read_bytes()
                == (tmp_path / f"j{name}").read_bytes())


def _children_running(marker):
    """Pids of live processes whose command line holds `marker`."""
    import os

    pids = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if marker.encode() in cmd and state != "Z":
            pids.append(int(pid))
    return pids


def test_sigterm_terminates_generators(tmp_path):
    """A SIGTERM to count while it reads a generator's output ends the run
    and terminates the generator child (count_main.cc:209-216)."""
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    marker = f"{31.5 + (tmp_path.stat().st_ino % 1000) / 1e4:.4f}"
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"exec sleep {marker}\n")
    code = ("from jellyfish_tpu_torch.cli import main\n"
            f"main(['count', '-m', '15', '-s', '1k', '-g', {str(cmds)!r},"
            f" '-o', {str(tmp_path / 'x.jf')!r}], device='cpu')\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root)
    try:
        deadline = time.monotonic() + 60
        while not _children_running(f"sleep {marker}"):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) != 0
        deadline = time.monotonic() + 10
        while _children_running(f"sleep {marker}"):
            assert time.monotonic() < deadline, "generator left running"
            time.sleep(0.1)
    finally:
        proc.kill()
        proc.wait()
    assert not (tmp_path / "x.jf").exists()
