"""The control of the check that decides `correct`: the reference put in
the program's place, breaking one guarantee the configuration states,
read by the same comparison, at the cell's own size, on several seeds.
It needs no card; the benchmark's own runs never run it.

    python3 benchmark/control.py --workload W --seeds S1 S2 S3
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)

from harness import spec  # noqa: E402
from harness.stress import Mix  # noqa: E402


def readings(cell: spec.Cell, seed: int, n: int | None = None) -> dict:
    """The control's reading of each number it can fail (its output is
    cells, not files, so only `cells_wrong`)."""
    ref = cell.reference()
    mix = Mix.of(cell.config, cell.traffic, seed, n=n)
    return {"cells_wrong": ref.cells_wrong(ref.control(mix),
                                           ref.expected(mix))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    limits = cell.reference().LIMITS
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got,
                          "limits": {k: limits[k] for k in got},
                          "fails": any(v > limits[k]
                                       for k, v in got.items()),
                          "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
