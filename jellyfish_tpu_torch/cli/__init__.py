"""`jellyfish` CLI of the port: `python -m jellyfish_tpu_torch count ...`.

Only `count` is ported so far; it takes the JAX package's flags, and the
ones whose paths are not ported raise NotPortedError.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    from jellyfish_tpu_torch import __version__
    from jellyfish_tpu_torch.cli import count

    parser = argparse.ArgumentParser(
        prog="jellyfish",
        description="GPU k-mer counter with Jellyfish capabilities",
    )
    parser.add_argument("--version", action="version",
                        version=f"jellyfish-tpu-torch {__version__}")
    sub = parser.add_subparsers(dest="subcommand", required=True)
    count.add_parser(sub)
    return parser


def main(argv=None, device=None) -> int:
    """Run one subcommand. `device` None means the GPU (and raises when
    there is none); the tests pass device="cpu"."""
    import signal

    # behave like a unix tool when piped into head & co.
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    return args.func(args, argv, device)
