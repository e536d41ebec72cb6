"""CLI plumbing (a copy of jellyfish_tpu/cli/common.py, with
count's generator-file reader): ISO suffix sizes (10M, 2G, ...), the
shared input flags, output files and fatal errors."""

from __future__ import annotations

import argparse
import sys

__all__ = ["suffix_int", "add_suffix", "open_output",
           "add_common_input_flags", "load_generator_cmds", "die"]

_SUFFIXES = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
}


def suffix_int(s: str) -> int:
    """Parse '10M', '2G', '100k' like yaggo's `suffix` option type."""
    s = s.strip()
    if s and s[-1] in _SUFFIXES:
        return int(float(s[:-1]) * _SUFFIXES[s[-1]])
    if s and s[-1].lower() in ("m", "g", "t", "p", "e", "k"):
        key = "k" if s[-1].lower() == "k" else s[-1].upper()
        return int(float(s[:-1]) * _SUFFIXES[key])
    return int(s)


def add_suffix(val: int, base: int = 1000) -> str:
    """Format a size with an ISO suffix (1024 -> '1k' with base 1024)."""
    suffixes = "kMGTPE"
    x = float(val)
    i = -1
    while x >= base and i < len(suffixes) - 1:
        x /= base
        i += 1
    if i < 0:
        return str(val)
    if x == int(x):
        return f"{int(x)}{suffixes[i]}"
    return f"{x:.6g}{suffixes[i]}"


def open_output(path: str | None, binary: bool = False):
    if path is None:
        return sys.stdout.buffer if binary else sys.stdout
    return open(path, "wb" if binary else "w")


def add_common_input_flags(p: argparse.ArgumentParser):
    """Flags shared by count/bc (count_main_cmdline.yaggo:10-30,52-63)."""
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of threads (accepted for compatibility)")
    p.add_argument("-F", "--Files", type=int, default=1, dest="nb_files",
                   help="Number of files open simultaneously")
    p.add_argument("-g", "--generator", metavar="path",
                   help="File of commands generating fast[aq]")
    p.add_argument("-G", "--Generators", type=int, default=1, dest="nb_generators",
                   help="Number of generators run simultaneously")
    p.add_argument("-S", "--shell", help="Shell for generator commands")
    p.add_argument("--timing", metavar="Timing file",
                   help="Print timing information")
    p.add_argument("--chunk-len", type=suffix_int, default=1 << 20,
                   help="Device chunk length in bytes")


def load_generator_cmds(path: str) -> list:
    """The commands of a -g file: its non-blank lines."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def die(msg: str) -> "NoReturn":
    print(f"jellyfish: {msg}", file=sys.stderr)
    sys.exit(1)
