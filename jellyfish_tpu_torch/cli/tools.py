"""`jellyfish bc`, `mem`, `cite`, `generate` and `fastq2sam` (the
counterparts of jellyfish_tpu/cli/tools.py).

`bc` runs on the GPU (bc_main.cc:84-161): a Bloom counter of the input's
k-mers, written as a .bc file that `count --bc` and `query` read. Each
ASCII chunk is counted on the device (the counting pipeline's per-chunk
dedup), and its distinct mers go into the counter with their
multiplicities in one insert (bloom.BloomCounter2.insert_counts). The hash
matrices come from an unseeded generator, as in the JAX package.

`mem` (the reference's memory model, or with --packed the packed store's),
`cite`, `generate` (seeded random FASTA/FASTQ) and `fastq2sam` (FASTQ to
unaligned SAM, for `count --sam`) run on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["add_bc_parser", "run_bc", "insert_chunks", "add_mem_parser",
           "run_mem", "add_cite_parser", "run_cite",
           "add_generate_parser", "run_generate", "add_fastq2sam_parser",
           "run_fastq2sam"]


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
    from jellyfish_tpu_torch.cli.common import die, load_generator_cmds
    from jellyfish_tpu_torch.io.parse import SequenceChunker

    t0 = time.perf_counter()
    if not args.file and not args.generator:
        die("bc: no input files given")
    k = args.mer_len
    bc = BloomCounter2.from_fpr(
        args.fpr, args.size, k, rng=np.random.default_rng(),
        canonical=args.canonical, device=device,
    )
    gen_cmds = load_generator_cmds(args.generator) if args.generator else None
    with SequenceChunker(list(args.file), k, chunk_len=args.chunk_len,
                         generator_cmds=gen_cmds, shell=args.shell,
                         nb_files=args.nb_files,
                         nb_generators=args.nb_generators) as chunker:
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


# -- mem (mem_main.cc:41-54) --------------------------------------------------


def add_mem_parser(sub):
    from jellyfish_tpu_torch.cli.common import suffix_int

    p = sub.add_parser("mem", help="Estimate memory usage of a hash")
    p.add_argument("-m", "--mer-len", type=int, required=True,
                   dest="mer_len", help="Length of mer")
    p.add_argument("-s", "--size", type=suffix_int, default=None,
                   help="Initial hash size -> memory usage")
    p.add_argument("--packed", action="store_true",
                   help="Model the bit-packed resting store "
                        "(count --packed-store)")
    p.add_argument("--mem", type=suffix_int, default=None,
                   help="Memory available -> max hash size")
    p.add_argument("-c", "--counter-len", type=int, default=7,
                   dest="counter_len", help="Length bits of counting field")
    p.add_argument("-p", "--reprobes", type=int, default=126,
                   help="Maximum number of reprobes")
    # the reference's mem parser takes count's whole flag surface, so a
    # `count` command line replays with the verb swapped to `mem`
    # (mem_main_cmdline.yaggo): the rest is accepted and ignored
    for flags, kw in [
        (("-t", "--threads"), dict(type=int)),
        (("-F", "--Files"), dict(type=int)),
        (("-g", "--generator"), dict()),
        (("-G", "--Generators"), dict(type=int)),
        (("-S", "--shell"), dict()),
        (("-o", "--output"), dict()),
        (("--out-counter-len",), dict(type=int)),
        (("-C", "--canonical"), dict(action="store_true")),
        (("--bc",), dict()),
        (("--bf-size",), dict(type=suffix_int)),
        (("--bf-fp",), dict(type=float)),
        (("--if",), dict(dest="if_")),
        (("-Q", "--min-qual-char"), dict()),
        (("--quality-start",), dict(type=int)),
        (("--min-quality",), dict(type=int)),
        (("--sam",), dict(action="append")),
        (("-d", "--devices"), dict()),
        (("--chunk-len",), dict()),
        (("--text",), dict(action="store_true")),
        (("--disk",), dict(action="store_true")),
        (("--no-merge",), dict(action="store_true")),
        (("--no-unlink",), dict(action="store_true")),
        (("-L", "--lower-count"), dict(type=int)),
        (("-U", "--upper-count"), dict(type=int)),
        (("--timing",), dict()),
        (("--no-write",), dict(action="store_true")),
    ]:
        p.add_argument(*flags, help=argparse.SUPPRESS, **kw)
    p.add_argument("file", nargs="*", help=argparse.SUPPRESS)
    p.set_defaults(func=run_mem)
    return p


def run_mem(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import add_suffix, die
    from jellyfish_tpu_torch.memmodel import UsageInfo
    from jellyfish_tpu_torch.ops.packed_run import packed_nbytes

    key_bits = args.mer_len * 2
    if args.packed:
        # bit-packed resting store: (2k - p + c) bits an entry plus the
        # bucket index (ops/packed_run.packed_nbytes)
        def mem_of(n):
            return packed_nbytes(n, key_bits, cbits=args.counter_len)

        def size_of(limit):
            lo_n, hi_n = 1, 1 << 62
            while lo_n < hi_n:  # packed_nbytes is monotone in n
                mid = (lo_n + hi_n + 1) // 2
                if mem_of(mid) <= limit:
                    lo_n = mid
                else:
                    hi_n = mid - 1
            return lo_n
    else:
        usage = UsageInfo(key_bits, args.counter_len, args.reprobes)
        mem_of, size_of = usage.mem, usage.size
    if args.size is not None:
        val = mem_of(args.size)
        print(f"{val} ({add_suffix(val, 1024)})")
    elif args.mem is not None:
        val = size_of(args.mem)
        print(f"{val} ({add_suffix(val, 1000)})")
    else:
        die("mem: either -s or --mem must be given")
    return 0


# -- cite (cite_main.cc) ------------------------------------------------------

CITE_TEXT = (
    "Guillaume Marcais and Carl Kingsford, A fast, lock-free approach for "
    "efficient parallel counting of occurrences of k-mers. Bioinformatics "
    "(2011) 27(6): 764-770 first published online January 7, 2011 "
    "doi:10.1093/bioinformatics/btr011\n"
)

CITE_URL = (
    "http://www.cbcb.umd.edu/software/jellyfish\n"
    "http://bioinformatics.oxfordjournals.org/content/early/2011/01/07/"
    "bioinformatics.btr011"
)

CITE_BIBTEX = """@article{Jellyfish2010,
         author = {Mar\\c{c}ais, Guillaume and Kingsford, Carl},
         title = {A fast, lock-free approach for efficient parallel counting of occurrences of k-mers},
         volume = {27},
         number = {6},
         pages = {764-770},
         year = {2011},
         doi = {10.1093/bioinformatics/btr011},
         URL = {http://bioinformatics.oxfordjournals.org/content/27/6/764.abstract},
         eprint = {http://bioinformatics.oxfordjournals.org/content/27/6/764.full.pdf+html},
         journal = {Bioinformatics}
}"""


def add_cite_parser(sub):
    p = sub.add_parser("cite", help="How to cite Jellyfish's paper")
    p.add_argument("-b", "--bibtex", action="store_true",
                   help="Bibtex format")
    p.add_argument("-o", "--output", help="Output file")
    p.set_defaults(func=run_cite)
    return p


def run_cite(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import open_output

    out = open_output(args.output)
    if args.bibtex:
        out.write(CITE_BIBTEX + "\n")
    else:
        out.write(
            "This software has been published. If you use it for your "
            "research, cite:\n\n" + CITE_TEXT + "\n" + CITE_URL + "\n"
        )
    if args.output:
        out.close()
    return 0


# -- generate (jellyfish/generate_sequence.cc) --------------------------------


def add_generate_parser(sub):
    from jellyfish_tpu_torch.cli.common import suffix_int

    p = sub.add_parser(
        "generate",
        help="Generate seeded random FASTA/FASTQ test data "
             "(generate_sequence equivalent)",
    )
    p.add_argument("-s", "--seed", type=int, default=42,
                   help="Seed for the pseudo-random generator")
    p.add_argument("-m", "--length", type=suffix_int, action="append",
                   required=True, help="Sequence length (repeatable)")
    p.add_argument("-r", "--read-length", type=suffix_int, default=None,
                   help="Split sequence into reads of this length")
    p.add_argument("-q", "--fastq", action="store_true",
                   help="Generate FASTQ with Illumina-range qualities")
    p.add_argument("-o", "--output", default="seq",
                   help="Output prefix (default seq)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Output information")
    p.set_defaults(func=run_generate)
    return p


def run_generate(args, argv, device=None):
    """Seeded random sequence (numpy default_rng): the same bytes as the
    JAX package's generate for the same flags."""
    rng = np.random.default_rng(args.seed)
    many = len(args.length) > 1
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i, length in enumerate(args.length):
        ext = "fq" if args.fastq else "fa"
        path = f"{args.output}_{i}.{ext}" if many else f"{args.output}.{ext}"
        if args.verbose:
            print(f"Creating {ext} file '{path}'")
        with open(path, "wb") as f:
            if args.fastq:
                read_len = args.read_length or 70
                total = 0
                rid = 0
                while total < length:
                    n = min(read_len, length - total)
                    seq = letters[rng.integers(0, 4, n)].tobytes()
                    # Illumina-range quality chars
                    # (generate_sequence.cc:22-41)
                    qual = (rng.integers(0, 41, n) + 66).astype(
                        np.uint8).tobytes()
                    f.write(b"@read_%d\n%s\n+\n%s\n" % (rid, seq, qual))
                    rid += 1
                    total += n
            else:
                read_len = args.read_length or length
                total = 0
                rid = 1
                f.write(b">read%d\n" % rid)
                read = 0
                while total < length:
                    n = min(70, length - total, read_len - read)
                    f.write(letters[rng.integers(0, 4, n)].tobytes() + b"\n")
                    total += n
                    read += n
                    if read >= read_len and total < length:
                        rid += 1
                        f.write(b">read%d\n" % rid)
                        read = 0
    return 0


# -- fastq2sam (jellyfish/fastq2sam.cc) ---------------------------------------


def add_fastq2sam_parser(sub):
    p = sub.add_parser(
        "fastq2sam",
        help="Convert .fastq files to unaligned .sam "
             "(jellyfish/fastq2sam.cc equivalent)",
    )
    p.add_argument("fastq", nargs="+", help="Input .fastq file(s)")
    p.set_defaults(func=run_fastq2sam)
    return p


def run_fastq2sam(args, argv, device=None):
    """Each INPUT.fastq becomes INPUT.sam of unmapped records (flag 4, no
    reference), as fastq2sam.cc:17-54 writes them:
    'name\\t4\\t*\\t0\\t0\\t*\\t*\\t0\\t0\\tSEQ\\tQUALS'."""
    from jellyfish_tpu_torch.cli.common import die

    for path in args.fastq:
        if not path.endswith(".fastq"):
            die("fastq2sam: Input must have '.fastq' extension")
        out_path = path[: -len(".fastq")] + ".sam"
        try:
            inf = open(path, "rb")
        except OSError:
            die(f"fastq2sam: Failed to open '{path}'")
        with inf, open(out_path, "wb") as out:
            while True:
                at = inf.read(1)
                if not at:
                    break
                if at != b"@":
                    die("fastq2sam: Input fastq file badly formatted. "
                        f"Unexpected characters '{at.decode(errors='replace')}'"
                        f" at position {inf.tell()}")
                name = inf.readline().rstrip(b"\r\n")
                seq = inf.readline().rstrip(b"\r\n")
                plus = inf.read(1)
                if plus != b"+":
                    die("fastq2sam: Input fastq file badly formatted. "
                        f"Unexpected characters at position {inf.tell()}")
                inf.readline()
                quals = inf.readline().rstrip(b"\r\n")
                out.write(name + b"\t4\t*\t0\t0\t*\t*\t0\t0\t" + seq
                          + b"\t" + quals + b"\n")
    return 0
