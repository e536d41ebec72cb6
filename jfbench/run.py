"""Run one cell of the port's benchmark once and print its result.

    python3 jfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The last line
of standard output is one JSON object (correct, attempted, failed,
metrics, device, and with --trace 1 breakdown; check last). The numbers
compared, each beside its limit, are also the last lines of standard
error. The cells and metrics are in BENCHMARK.json; see harness.py.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    import jellyfish_tpu_torch  # noqa: F401  (the program under test)

    from jfbench import harness

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"jfbench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("jfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"jfbench: the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"jfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4
    check = out["check"]
    info = out["info"]
    print(f"jfbench: {args.workload} seed {args.seed}: jobs "
          f"{info['jobs_s']} s, reference {info['ref_rows']} rows, "
          f"{info['ref_mers']} mers, checked in {info['check_s']:.1f} s, "
          f"rows differing by job {info['diffs']}", file=sys.stderr)
    for name, c in check.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
