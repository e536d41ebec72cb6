"""The read generator: Illumina-like reads of a seeded genome, made on the
device, and their host-packed chunks.

A workload file gives the parameters. One job's input is `chunks_per_job`
chunks of `chunk_len` bases. Each chunk holds whole reads of `read_len`
bases, each followed by one `N`, cut at the chunk's end (as the chunker
fills a chunk; no window crosses from one chunk to the next). A read
starts at a uniform position of the genome, comes from either strand with
equal odds, and carries uniform substitutions at `error_rate`: each base
is replaced, with that probability, by one of the three others.

Codes: A 0, C 1, G 2, T 3, N 4. Every random draw comes from a
torch.Generator on the given device, seeded from (seed, stream) through
numpy's SeedSequence, so any seed up to 2^64 works and any block of
chunks can be made again alone. The same seed gives the same reads on one
kind of device; the CPU and the card draw different streams.

Copied from the idea of the repository's older `bench.py` `synth_chunks`
(one strand, no errors, numpy) and rewritten for the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Traffic", "subseed", "make_genome", "make_codes", "pack",
           "valid_windows", "make_job"]

N_CODE = 4
BLOCK_CHUNKS = 64  # chunks made at once: a block's draws fit in 1 GiB


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream `stream` of run seed `seed`."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


class Traffic:
    """The parameters of one workload file."""

    def __init__(self, spec: dict):
        self.genome_bases = int(spec["genome_bases"])
        self.read_len = int(spec["read_len"])
        self.chunk_len = int(spec["chunk_len"])
        self.chunks_per_job = int(spec["chunks_per_job"])
        self.batch = int(spec["batch"])
        if spec["error_model"] != "uniform_substitution":
            raise ValueError(f"unknown error_model {spec['error_model']!r}")
        self.error_rate = float(spec["error_rate"])
        self.reverse_share = float(spec["reverse_share"])
        if self.chunk_len % 32:
            raise ValueError("chunk_len must be a multiple of 32")
        if self.genome_bases <= self.read_len:
            raise ValueError("genome_bases must exceed read_len")

    @property
    def reads_per_chunk(self) -> int:
        return -(-self.chunk_len // (self.read_len + 1))


def make_genome(t: Traffic, seed: int, device) -> torch.Tensor:
    """The genome as codes [G] uint8 (0-3)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, 0))
    return torch.randint(0, 4, (t.genome_bases,), generator=g,
                         device=device, dtype=torch.uint8)


def _block(t: Traffic, genome, seed: int, index: int, n: int):
    """Chunks [n, chunk_len] uint8 codes of block `index`."""
    dev = genome.device
    g = torch.Generator(device=dev).manual_seed(subseed(seed, 1 + index))
    r, per = t.read_len, t.reads_per_chunk
    starts = torch.randint(0, t.genome_bases - r + 1, (n, per, 1),
                           generator=g, device=dev)
    rev = torch.rand((n, per, 1), generator=g, device=dev) < t.reverse_share
    off = torch.arange(r, device=dev)
    fwd = genome[starts + off]
    rc = 3 - genome[starts + (r - 1) - off]
    bases = torch.where(rev, rc, fwd)
    del fwd, rc
    err = torch.rand((n, per, r), generator=g, device=dev) < t.error_rate
    shift = torch.randint(1, 4, (n, per, r), generator=g, device=dev,
                          dtype=torch.uint8)
    bases = torch.where(err, (bases + shift) & 3, bases)
    del err, shift
    sep = torch.full((n, per, 1), N_CODE, dtype=torch.uint8, device=dev)
    reads = torch.cat([bases, sep], dim=2).reshape(n, -1)
    return reads[:, :t.chunk_len].contiguous()


def make_codes(t: Traffic, seed: int, device, genome=None):
    """Yield (first chunk index, codes [n, chunk_len] uint8) block by
    block over one job's chunks."""
    if genome is None:
        genome = make_genome(t, seed, device)
    for index, lo in enumerate(range(0, t.chunks_per_job, BLOCK_CHUNKS)):
        n = min(BLOCK_CHUNKS, t.chunks_per_job - lo)
        yield lo, _block(t, genome, seed, index, n)


def _to_u32(words: torch.Tensor) -> np.ndarray:
    """int64 values in [0, 2^32) -> numpy uint32 on the host."""
    w = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return w.to(torch.int32).cpu().numpy().view(np.uint32)


def pack(codes: torch.Tensor):
    """Codes [n, L] -> (pwords [n, L/16], validbits [n, L/32]) numpy
    uint32: 16 2-bit codes a word, big-endian within the word, and one
    validity bit a base, little-endian within the word: the words the
    program's host chunker makes of the same bases, an N packed as the
    code 2 as there."""
    n, L = codes.shape
    c = codes.to(torch.int64)
    shifts = 2 * (15 - torch.arange(16, device=codes.device))
    pw = (torch.where(c < N_CODE, c, 2).view(n, L // 16, 16)
          << shifts).sum(dim=2)
    vshifts = torch.arange(32, device=codes.device)
    ok = (c < N_CODE).to(torch.int64).view(n, L // 32, 32)
    vb = (ok << vshifts).sum(dim=2)
    return _to_u32(pw), _to_u32(vb)


def valid_windows(codes: torch.Tensor, k: int) -> int:
    """The number of k-base windows of codes [n, L] that hold no N, each
    chunk on its own."""
    bad = (codes >= N_CODE).to(torch.int32)
    cs = torch.nn.functional.pad(torch.cumsum(bad, dim=1, dtype=torch.int32),
                                 (1, 0))
    return int(((cs[:, k:] - cs[:, :-k]) == 0).sum())


def make_job(t: Traffic, k: int, seed: int, device):
    """One job's input: (pwords [chunks, L/16], validbits [chunks, L/32])
    numpy uint32 on the host, and the number of valid windows."""
    L = t.chunk_len
    pwords = np.empty((t.chunks_per_job, L // 16), dtype=np.uint32)
    vbits = np.empty((t.chunks_per_job, L // 32), dtype=np.uint32)
    valid = 0
    for lo, codes in make_codes(t, seed, device):
        n = codes.shape[0]
        pwords[lo:lo + n], vbits[lo:lo + n] = pack(codes)
        valid += valid_windows(codes, k)
    return pwords, vbits, valid
