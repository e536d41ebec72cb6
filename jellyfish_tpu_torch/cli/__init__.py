"""`jellyfish` CLI of the port: `python -m jellyfish_tpu_torch
<count|bc|query|histo|dump|stats|merge|info|mem|cite|generate|fastq2sam>
...`.

`count`, `bc` and `merge` run on the GPU, and so does `query` of a Bloom
counter (a binary database is searched on the host); histo, dump, stats,
info, mem, cite, generate and fastq2sam run on the host. `count` and `bc`
take the JAX package's flags; `count -d N` shards the table over N devices
of one process, and `count --coordinator` over several processes;
`count --sam` reads SAM, BAM and CRAM files.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    from jellyfish_tpu_torch import __version__
    from jellyfish_tpu_torch.cli import count, dbtools, tools

    parser = argparse.ArgumentParser(
        prog="jellyfish",
        description="GPU k-mer counter with Jellyfish capabilities",
    )
    parser.add_argument("--version", action="version",
                        version=f"jellyfish-tpu-torch {__version__}")
    sub = parser.add_subparsers(dest="subcommand", required=True)
    count.add_parser(sub)
    tools.add_bc_parser(sub)
    dbtools.add_query_parser(sub)
    dbtools.add_histo_parser(sub)
    dbtools.add_dump_parser(sub)
    dbtools.add_stats_parser(sub)
    dbtools.add_merge_parser(sub)
    dbtools.add_info_parser(sub)
    tools.add_mem_parser(sub)
    tools.add_cite_parser(sub)
    tools.add_generate_parser(sub)
    tools.add_fastq2sam_parser(sub)
    return parser


def main(argv=None, device=None) -> int:
    """Run one subcommand. `device` None means the GPU (and raises when
    there is none) for count, bc, merge and query of a Bloom counter; the
    tests pass device="cpu"."""
    import signal

    # behave like a unix tool when piped into head & co.
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return args.func(args, argv, device)
