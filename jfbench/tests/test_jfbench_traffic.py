"""The read generator: seeds, substitution rate, strands, the packing."""

import numpy as np
import pytest
import torch

from jfbench.traffic import reads

SPEC = {"genome_bases": 20000, "read_len": 150, "reverse_share": 0.5,
        "chunk_len": 4096, "chunks_per_job": 70, "batch": 8,
        "error_model": "uniform_substitution", "error_rate": 0.01}
ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


def codes_of(spec, seed):
    t = reads.Traffic(spec)
    return torch.cat([c for _, c in reads.make_codes(t, seed, "cpu")])


def test_same_seed_same_reads():
    a = codes_of(SPEC, 2**33 + 5)
    b = codes_of(SPEC, 2**33 + 5)
    c = codes_of(SPEC, 2**33 + 6)
    assert a.shape == (70, 4096)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_layout_of_a_chunk():
    a = codes_of(SPEC, 7)
    # a read of 150 bases, then one N, cut at the chunk's end
    n_pos = torch.nonzero(a[0] == reads.N_CODE).squeeze(1)
    assert torch.equal(n_pos, torch.arange(150, 4096, 151))
    assert int((a < reads.N_CODE).sum()) == 70 * (4096 - 27)


def test_substitution_rate():
    spec = dict(SPEC, chunks_per_job=200)
    clean = codes_of(dict(spec, error_rate=0.0), 11)
    noisy = codes_of(spec, 11)
    bases = clean < reads.N_CODE
    changed = (clean != noisy) & bases
    rate = float(changed.sum()) / float(bases.sum())
    # 200 x 4069 bases: the rate's standard error is about 1.1e-4
    assert abs(rate - 0.01) < 6e-4
    assert torch.equal(clean == reads.N_CODE, noisy == reads.N_CODE)


def test_both_strands():
    spec = dict(SPEC, error_rate=0.0, chunks_per_job=8)
    t = reads.Traffic(spec)
    genome = reads.make_genome(t, 3, "cpu")
    g = ASCII[genome.numpy()].tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    codes = torch.cat([c for _, c in reads.make_codes(t, 3, "cpu", genome)])
    fwd = rev = 0
    for row in codes.numpy():
        for read in ASCII[row].tobytes().split(b"N"):
            if len(read) < 150:
                continue
            if read in g:
                fwd += 1
            else:
                assert read.translate(comp)[::-1] in g
                rev += 1
    n = fwd + rev
    assert n == 8 * 27
    assert abs(fwd / n - 0.5) < 0.12


def test_pack_matches_the_program_chunker():
    from jellyfish_tpu_torch.io.parse import pack_chunk

    codes = codes_of(dict(SPEC, chunks_per_job=3), 19)
    pw, vb = reads.pack(codes)
    for i in range(3):
        epw, evb = pack_chunk(ASCII[codes[i].numpy()])
        assert np.array_equal(pw[i], epw)
        assert np.array_equal(vb[i], evb)


@pytest.mark.parametrize("k", [1, 21, 63, 150, 151])
def test_valid_windows(k):
    codes = codes_of(dict(SPEC, chunks_per_job=2), 23)
    brute = 0
    for row in codes.numpy():
        for read in ASCII[row].tobytes().split(b"N"):
            brute += max(0, len(read) - k + 1)
    assert reads.valid_windows(codes, k) == brute


def test_subseed_takes_large_seeds():
    s = {reads.subseed(seed, 1) for seed in (0, 2**31 + 1, 2**40, 2**63)}
    assert len(s) == 4 and all(0 <= x < 2**63 for x in s)
