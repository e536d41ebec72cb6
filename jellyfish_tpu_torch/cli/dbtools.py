"""Database subcommands of the port: merge on the device, query (a Bloom
counter's check on the device, a binary database's lookup on the host),
and the host-only readers histo, dump, stats and info (the counterparts of
jellyfish_tpu/cli/dbtools.py, sub_commands/{histo,dump,stats,merge,info,
query}_main.cc; the readers are copies)."""

from __future__ import annotations

import argparse
import json
import shlex
import sys

import numpy as np

from jellyfish_tpu_torch.cli.common import suffix_int

__all__ = ["add_histo_parser", "add_dump_parser", "add_stats_parser",
           "add_merge_parser", "add_info_parser", "add_query_parser"]

U64MAX = (1 << 64) - 1

_BLOCK = 1 << 20  # records per streamed block (O(block) host memory)


def _stream_counts(r):
    """Yield count arrays in blocks (binary) or one text-parsed array."""
    from jellyfish_tpu_torch.io.header import FileHeader

    if r.fmt == FileHeader.FORMAT_BINARY:
        while True:
            _, counts = r.read_records_np(_BLOCK)
            if len(counts) == 0:
                return
            yield counts
    else:
        yield r.counts_np()


# -- histo (histo_main.cc:33-90) ---------------------------------------------


def add_histo_parser(sub):
    # -h is the reference's "high count" flag: no automatic -h help here
    p = sub.add_parser(
        "histo", help="Create an histogram of k-mer occurrences", add_help=False
    )
    p.add_argument("--help", action="help")
    p.add_argument("-l", "--low", type=int, default=1,
                   help="Low count value of histogram (default 1)")
    p.add_argument("-h", "--high", type=int, default=10000,
                   help="High count value of histogram (default 10000)")
    p.add_argument("-i", "--increment", type=int, default=1,
                   help="Increment value for buckets (default 1)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of threads (accepted for compatibility)")
    p.add_argument("-f", "--full", action="store_true",
                   help="Full histo. Don't skip count 0.")
    p.add_argument("-s", "--buffer-size", type=suffix_int, default=10 << 20,
                   help="Length in bytes of input buffer (accepted for "
                        "compatibility)")
    p.add_argument("-o", "--output", help="Output file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Output information")
    p.add_argument("db", help="Jellyfish database")
    p.set_defaults(func=run_histo)
    return p


def run_histo(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import die, open_output
    from jellyfish_tpu_torch.io.files import DBReader

    if args.high < args.low:
        die("histo: High count value must be >= to low count value")
    base = 0 if args.increment >= args.low else args.low - args.increment
    ceil = args.high + args.increment
    inc = args.increment
    nb = (ceil + inc - base) // inc
    histo = np.zeros(nb, dtype=np.uint64)
    # stream in blocks like the reference's reader loop (histo_main.cc:
    # 33-44): memory stays O(block), not O(database)
    with DBReader(args.db) as r:
        for counts in _stream_counts(r):
            np.add.at(histo, 0, int((counts < base).sum()))
            np.add.at(histo, nb - 1, int((counts > ceil).sum()))
            mid = counts[(counts >= base) & (counts <= ceil)]
            bins = ((mid - np.uint64(base)) // np.uint64(inc)) \
                .astype(np.int64)
            histo += np.bincount(bins, minlength=nb).astype(np.uint64)
    out = open_output(args.output)
    for i in range(nb):
        col = base + i * inc
        if histo[i] > 0 or args.full:
            out.write(f"{col} {histo[i]}\n")
    if args.output:
        out.close()
    return 0


# -- dump (dump_main.cc:35-88) ------------------------------------------------


def add_dump_parser(sub):
    p = sub.add_parser("dump", help="Dump k-mer counts")
    p.add_argument("-c", "--column", action="store_true",
                   help="Column format (mer count) instead of fasta")
    p.add_argument("-t", "--tab", action="store_true", help="Tab separator")
    p.add_argument("-L", "--lower-count", type=int, default=0,
                   help="Don't output mers with count < lower-count")
    p.add_argument("-U", "--upper-count", type=int, default=U64MAX,
                   help="Don't output mers with count > upper-count")
    p.add_argument("-o", "--output", help="Output file")
    p.add_argument("db", help="Jellyfish database")
    p.set_defaults(func=run_dump)
    return p


def run_dump(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import open_output
    from jellyfish_tpu_torch.io.files import DBReader, mer_strings_np
    from jellyfish_tpu_torch.io.header import FileHeader
    from jellyfish_tpu_torch.mer import MerDNA

    out = open_output(args.output)
    sep = "\t" if args.tab else " "
    lo, hi = args.lower_count, args.upper_count
    with DBReader(args.db) as r:
        k = r.k
        if r.fmt == FileHeader.FORMAT_BINARY:
            # streamed blocks + vectorized key->string decoding: memory
            # stays O(block) like the reference's reader loop
            W = (2 * k + 31) // 32
            sepb = sep.encode()
            while True:
                key_bytes, counts = r.read_records_np(_BLOCK)
                n = len(counts)
                if n == 0:
                    break
                kb = np.zeros((n, 4 * W), dtype=np.uint8)
                kb[:, : key_bytes.shape[1]] = key_bytes
                limbs = kb.view("<u4").reshape(n, W)
                sel = (counts >= np.uint64(lo)) & (counts <= np.uint64(hi))
                limbs2, cs = limbs[sel], counts[sel]
                chars = mer_strings_np(limbs2, k)
                if args.column:
                    block = b"".join(
                        b"%s%s%d\n" % (chars[i].tobytes(), sepb, cs[i])
                        for i in range(len(cs))
                    )
                else:
                    block = b"".join(
                        b">%d\n%s\n" % (cs[i], chars[i].tobytes())
                        for i in range(len(cs))
                    )
                out.write(block.decode())
        else:
            buf = []
            for key, val in r:
                if val < lo or val > hi:
                    continue
                if args.column:
                    buf.append(f"{MerDNA(k, key)}{sep}{val}\n")
                else:
                    buf.append(f">{val}\n{MerDNA(k, key)}\n")
                if len(buf) >= 65536:
                    out.write("".join(buf))
                    buf = []
            out.write("".join(buf))
    if args.output:
        out.close()
    return 0


# -- stats (stats_main.cc:32-83) ----------------------------------------------


def add_stats_parser(sub):
    p = sub.add_parser("stats", help="Statistics of a database")
    # hidden vestigial flag: the reference parses it and never reads it
    # (stats_main_cmdline.yaggo:11-13)
    p.add_argument("-r", "--recompute", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-L", "--lower-count", type=int, default=0,
                   help="Don't consider mers with count < lower-count")
    p.add_argument("-U", "--upper-count", type=int, default=U64MAX,
                   help="Don't consider mers with count > upper-count")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Output information")
    p.add_argument("-o", "--output", help="Output file")
    p.add_argument("db", help="Jellyfish database")
    p.set_defaults(func=run_stats)
    return p


def run_stats(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import open_output
    from jellyfish_tpu_torch.io.files import DBReader

    uniq = distinct = total = maxc = 0
    with DBReader(args.db) as r:
        for counts in _stream_counts(r):
            sel = counts[(counts >= args.lower_count)
                         & (counts <= args.upper_count)]
            uniq += int((sel == 1).sum())
            distinct += int(len(sel))
            total += int(sel.sum())
            if len(sel):
                maxc = max(maxc, int(sel.max()))
    out = open_output(args.output)
    out.write(
        f"Unique:    {uniq}\nDistinct:  {distinct}\n"
        f"Total:     {total}\nMax_count: {maxc}\n"
    )
    if args.output:
        out.close()
    return 0


# -- merge (merge_main.cc:24-46) ----------------------------------------------


def add_merge_parser(sub):
    p = sub.add_parser("merge", help="Merge jellyfish databases")
    p.add_argument("-o", "--output", default="mer_counts_merged.jf",
                   help="Output file (default mer_counts_merged.jf)")
    p.add_argument("-m", "--min", action="store_true",
                   help="Compute min count instead of sum")
    p.add_argument("-M", "--max", action="store_true",
                   help="Compute max count instead of sum")
    p.add_argument("-j", "--jaccard", action="store_true",
                   help="Compute jaccard and weighted jaccard similarities")
    p.add_argument("-L", "--lower-count", type=int, default=None,
                   help="Don't output mers with count < lower-count")
    p.add_argument("-U", "--upper-count", type=int, default=None,
                   help="Don't output mers with count > upper-count")
    p.add_argument("input", nargs="+", help="Jellyfish databases (>= 2)")
    p.set_defaults(func=run_merge)
    return p


def run_merge(args, argv, device=None):
    from jellyfish_tpu_torch.cli.common import die
    from jellyfish_tpu_torch.merge import MergeError, MergeOp, merge_files

    if len(args.input) < 2:
        die("merge: needs at least 2 input databases")
    op = MergeOp.SUM
    if args.min:
        op = MergeOp.MIN
    if args.max:
        op = MergeOp.MAX
    if args.jaccard:
        op = MergeOp.JACCARD
    min_c = args.lower_count if args.lower_count is not None else (
        1 if args.min else 0
    )
    max_c = args.upper_count
    try:
        merge_files(
            args.input, args.output, min_count=min_c, max_count=max_c, op=op,
            out_header_extra={"cmdline": list(argv)}, device=device,
        )
    except MergeError as e:
        die(str(e))
    if op is MergeOp.JACCARD:
        with open(args.output) as f:
            sys.stdout.write(f.read())
    return 0


# -- info (info_main.cc:14-54) ------------------------------------------------


def add_info_parser(sub):
    p = sub.add_parser("info", help="Print information about a database header")
    p.add_argument("-c", "--cmd", action="store_true",
                   help="Print the command used to generate the file")
    p.add_argument("-j", "--json", action="store_true", help="Print header as JSON")
    p.add_argument("-s", "--skip", action="store_true",
                   help="Skip the header and print the raw data")
    p.add_argument("file", help="Jellyfish database")
    p.set_defaults(func=run_info)
    return p


def run_info(args, argv, device=None):
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(args.file, "rb") as f:
        header = FileHeader.read(f)
        if args.skip:
            sys.stdout.buffer.write(f.read())
            return 0
    root = header.root
    cmd = str(root.get("exe_path", ""))
    for a in root.get("cmdline", []):
        cmd += " " + shlex.quote(str(a))
    if args.json:
        print(json.dumps(root, indent=2, sort_keys=True))
    elif args.cmd:
        print(cmd)
    else:
        where = shlex.quote(str(root.get("hostname", "")))
        if where:
            where += ":"
        where += shlex.quote(str(root.get("pwd", "")))
        print(f"command: {cmd}")
        print(f"where: {where}")
        print(f"when: {root.get('time', '')}")
        print(f"canonical: {'yes' if header.canonical else 'no'}")
    return 0


# -- query (query_main.cc:44-123) ---------------------------------------------


def add_query_parser(sub):
    p = sub.add_parser("query", help="Query the count of k-mers in a database")
    p.add_argument("-s", "--sequence", action="append", default=[],
                   help="Query all mers of sequence files")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Read mers from stdin")
    p.add_argument("-l", "--load", action="store_true",
                   help="Force pre-loading the database in memory")
    p.add_argument("-L", "--no-load", action="store_true",
                   help="Disable pre-loading")
    p.add_argument("-o", "--output", help="Output file")
    p.add_argument("file", help="Jellyfish database")
    p.add_argument("mers", nargs="*", help="Mers to query")
    p.set_defaults(func=run_query)
    return p


def _limbs(mers: np.ndarray, W: int) -> np.ndarray:
    """Mers (uint64, or python ints in an object array) -> [n, W] uint32
    limbs."""
    if mers.dtype == np.uint64:
        return np.stack([(mers >> np.uint64(32 * w)).astype(np.uint32)
                         for w in range(W)], axis=1).reshape(-1, W)
    return np.array([[(int(v) >> (32 * w)) & 0xFFFFFFFF for w in range(W)]
                     for v in mers], dtype=np.uint32).reshape(-1, W)


def run_query(args, argv, device=None):
    """The JAX package's query, batched: the mers of each sequence file,
    and the mers given on the command line, are looked up at once (a
    Bloom counter's check is one device call; a binary database is
    searched on the host, vectorized for 2k <= 64)."""
    import torch

    from jellyfish_tpu_torch.cli.common import die, open_output
    from jellyfish_tpu_torch.io.files import BinaryQuery, mer_strings_np
    from jellyfish_tpu_torch.io.header import FileHeader
    from jellyfish_tpu_torch.io.parse import iter_reads, open_stream
    from jellyfish_tpu_torch.mer import (
        MerDNA,
        revcomp_np,
        seq_mers_np,
        string_mers,
    )

    with open(args.file, "rb") as f:
        header = FileHeader.read(f)
    k = header.key_len // 2
    W = (2 * k + 31) // 32
    small = 2 * k <= 64

    if header.format == FileHeader.FORMAT_BLOOM:
        from jellyfish_tpu_torch.bloom import read_bloom_counter

        db = read_bloom_counter(args.file, device)

        def lookup(mers):
            limbs = torch.from_numpy(_limbs(mers, W).astype(np.int64))
            return db.check(limbs).cpu().numpy().astype(np.uint64)
    elif header.format == FileHeader.FORMAT_BINARY:
        db = BinaryQuery(args.file)
        # preload on -l, and automatically for bulk queries (sequence
        # files or >100 mers) unless -L, like query_main.cc:109-111
        if not args.no_load and (
            args.load or args.sequence or len(args.mers) > 100
        ):
            db.preload()

        def lookup(mers):
            if small:
                return db.check_batch(mers)
            return np.array([db.check(int(m)) for m in mers],
                            dtype=np.uint64)
    else:
        die(f"Unsupported format '{header.format}'. "
            "Must be a bloom counter or binary list.")

    def canon(mers):
        if not header.canonical:
            return mers
        if small:
            return np.minimum(mers, revcomp_np(mers, k))
        return np.array([MerDNA(k, int(m)).get_canonical().bits
                         for m in mers], dtype=object)

    def as_array(bits):
        return np.array(bits, dtype=np.uint64 if small else object)

    def write(mers):
        if not len(mers):
            return
        vals = lookup(canon(mers))
        chars = mer_strings_np(_limbs(mers, W), k)
        out.write("".join(f"{row.tobytes().decode()} {v}\n"
                          for row, v in zip(chars, vals)))

    out = open_output(args.output)
    for path in args.sequence:
        with open_stream(path) as stream:
            if small:
                reads = [seq_mers_np(seq, k) for seq in iter_reads(stream)]
            else:
                reads = [as_array([m.bits for m in string_mers(
                    seq.decode(), k)]) for seq in iter_reads(stream)]
        write(np.concatenate(reads) if reads else as_array([]))

    def parse(s):
        """A mer's bits, or None (reported) when s is no k-mer."""
        try:
            m = MerDNA(s)
            if m.k == k:
                return m.bits
        except ValueError:
            pass
        print(f"Invalid mer '{s}'", file=sys.stderr)
        return None

    given = [parse(s) for s in args.mers]
    write(as_array([b for b in given if b is not None]))
    if args.interactive:
        for line in sys.stdin:
            bits = parse(line.strip())
            if bits is not None:
                out.write(f"{lookup(canon(as_array([bits])))[0]}\n")
                out.flush()
    if args.output:
        out.close()
    return 0
