"""`python -m jellyfish_tpu_torch count` against `python -m jellyfish_tpu
count`: with SOURCE_DATE_EPOCH and --matrix-seed, the databases hold the
same records byte for byte, and the same header apart from exe_path, pwd
and cmdline. Flags whose paths are not ported raise NotPortedError."""

import gzip
import io

import numpy as np
import pytest
import torch

from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.cli.count import NotPortedError
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


@pytest.mark.parametrize("flags", [
    ["-d", "2"], ["-d", "auto"], ["--bc", "x.bc"], ["--bf-size", "1M"],
    ["--if", "x.fa"], ["--packed-store"], ["--sam", "x.sam"],
    ["-g", "cmds.txt"], ["--coordinator", "localhost:1234"], ["--text"],
    ["--chunk-len", "1000"],
], ids=lambda f: " ".join(f))
def test_unported_flags_raise(reads, tmp_path, flags):
    _, fq, _ = reads
    with pytest.raises(NotPortedError, match="not yet ported"):
        torch_main(["count", "-m", "21", "-s", "1M", *flags,
                    "-o", str(tmp_path / "x.jf"), fq], device="cpu")


@pytest.mark.parametrize("k", [113, 128])
def test_key_width_above_the_kernels_raises(tmp_path, k):
    """k > 112 needs keys of more 32-bit limbs than the kernels' template
    instances take: count refuses before it opens any input."""
    missing = str(tmp_path / "never_read.fq")
    with pytest.raises(NotPortedError, match="k <= 112"):
        torch_main(["count", "-m", str(k), "-s", "1M", "-o",
                    str(tmp_path / "x.jf"), missing], device="cpu")
