"""`jellyfish bc` on the GPU (bc_main.cc:84-161; the counterpart of the `bc`
subcommand in jellyfish_tpu/cli/tools.py): a Bloom counter of the input's
k-mers, written as a .bc file that `count --bc` and `query` read.

Each ASCII chunk is counted on the device (the counting pipeline's
per-chunk dedup), and its distinct mers go into the counter with their
multiplicities in one insert (bloom.BloomCounter2.insert_counts). The hash
matrices come from an unseeded generator, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np

from jellyfish_tpu_torch import NotPortedError

__all__ = ["add_bc_parser", "run_bc", "insert_chunks"]


def add_bc_parser(sub):
    from jellyfish_tpu_torch.cli.common import add_common_input_flags, suffix_int

    p = sub.add_parser("bc", help="Create a bloom counter from the input k-mers")
    p.add_argument("-m", "--mer-len", type=int, required=True,
                   dest="mer_len", help="Length of mer")
    p.add_argument("-s", "--size", type=suffix_int, required=True,
                   help="Expected number of k-mers in input")
    p.add_argument("-f", "--fpr", type=float, default=0.001,
                   help="False positive rate")
    p.add_argument("-C", "--canonical", action="store_true",
                   help="Count both strands, canonical representation")
    p.add_argument("-o", "--output", default="mer_bloom_filter",
                   help="Output file (default mer_bloom_filter)")
    add_common_input_flags(p)
    p.add_argument("file", nargs="*", help="Input sequence files")
    p.set_defaults(func=run_bc)
    return p


def insert_chunks(bc, chunks) -> None:
    """Insert every k-mer of the ASCII chunks (host arrays or device
    tensors) into the Bloom counter `bc`: per chunk, its distinct mers and
    their counts, one insert."""
    from jellyfish_tpu_torch.counter import MerCounter

    counter = MerCounter(bc.k, size=1 << 16, canonical=bc.canonical,
                         device=bc.device)
    for chunk in chunks:
        if len(chunk) < bc.k:
            continue
        _, mers, counts = counter.chunk_counts(chunk)
        bc.insert_counts(mers, counts)


def run_bc(args, argv, device=None):
    from jellyfish_tpu_torch.bloom import BloomCounter2, write_bloom_counter
    from jellyfish_tpu_torch.cli.common import die
    from jellyfish_tpu_torch.io.parse import SequenceChunker

    t0 = time.perf_counter()
    if args.generator is not None:
        raise NotPortedError(
            "bc -g/--generator: not yet ported to jellyfish_tpu_torch "
            "(use python -m jellyfish_tpu bc)")
    if not args.file:
        die("bc: no input files given")
    k = args.mer_len
    bc = BloomCounter2.from_fpr(
        args.fpr, args.size, k, rng=np.random.default_rng(),
        canonical=args.canonical, device=device,
    )
    chunker = SequenceChunker(list(args.file), k, chunk_len=args.chunk_len)
    t_init = time.perf_counter()
    insert_chunks(bc, chunker.chunks())
    t_count = time.perf_counter()
    write_bloom_counter(bc, args.output, cmdline=argv)
    t_write = time.perf_counter()
    if args.timing:
        with open(args.timing, "w") as f:
            f.write(f"Init     {t_init - t0:.4f}\n")
            f.write(f"Counting {t_count - t_init:.4f}\n")
            f.write(f"Writing  {t_write - t_count:.4f}\n")
    return 0
