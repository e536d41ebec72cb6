"""The readings that the limit of `correct` is set from, many seeds in one
process:

    python3 jfbench/readings.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the program's rows that differ from the plain count over
one job of the cell (the timed path: the same input, MerCounter and job
as a run's window), and the control's, the plain count with each mer's
identity held in a 32-bit fingerprint put in the program's place. One
JSON line a seed. The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_diff(t, k: int, seed: int, device, parts: int):
    """(the control's rows that differ from the plain count, the plain
    count's rows)."""
    from jfbench.reference.count import Reference, fingerprint_table
    from jfbench.traffic.reads import make_codes

    ref = Reference.count((c for _, c in make_codes(t, seed, device)), k,
                          parts)
    cols, counts = fingerprint_table(ref)
    return ref.diff(cols, counts), ref.rows()


def readings(bench: dict, cell: str, seed: int, device, base=None):
    """{"seed", "program", "control", "rows"} for one seed."""
    import numpy as np
    import torch

    from jellyfish_tpu_torch.counter import MerCounter
    from jfbench import harness
    from jfbench.traffic.reads import Traffic, make_job

    base = base or harness.BENCH
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = harness.load_json(base, "configs", entry["config"])
    t = Traffic(harness.load_json(base, "workloads", entry["traffic"]))
    k = int(cfg["k"])
    t0 = time.perf_counter()
    pwords, vbits, _ = make_job(t, k, seed, device)
    counter = MerCounter(k, int(cfg["size"]), canonical=bool(cfg["canonical"]),
                         rng=np.random.default_rng(seed), device=device)
    table = harness.job(counter, pwords, vbits, t.batch)
    del counter, pwords, vbits
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    diffs, rows, _, _ = harness.check_tables([table], t, k, seed, device)
    del table
    parts = harness.reference_parts(t)
    ctrl, _ = control_diff(t, k, seed, device, parts)
    return {"cell": cell, "seed": seed, "program": diffs[0],
            "control": ctrl, "rows": rows,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("jfbench: no CUDA device", file=sys.stderr)
        return 3
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in args.seeds:
        print(json.dumps(readings(bench, args.workload, seed, "cuda")),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
