"""Database subcommands of the port: merge on the device, and the
host-only readers histo, dump, stats and info (the counterparts of
jellyfish_tpu/cli/dbtools.py, sub_commands/{histo,dump,stats,merge,info}
_main.cc; the readers are copies)."""

from __future__ import annotations

import argparse
import json
import shlex
import sys

import numpy as np

from jellyfish_tpu_torch.cli.common import suffix_int

__all__ = ["add_histo_parser", "add_dump_parser", "add_stats_parser",
           "add_merge_parser", "add_info_parser"]

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
