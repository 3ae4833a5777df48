#!/usr/bin/env python3
"""Time chip_smoke.py's kernel checks in two checkouts on one card, in
turns (old, new, new, old), so that two versions of a kernel are
compared within one run on one card.

    python3 kernel_ab.py OLD_DIR NEW_DIR

Each turn is a process of its own started in one checkout: it builds
that checkout's kernels into its own build directory (chip_smoke's
phase 2) and runs its chip_smoke checks (each kernel held exactly
against its plain version) at the sizes below: K1-K3 on the synthetic
rounds, K8 on the synthetic mesh steps, and K6, K7 and K10, whose sort
passes the round sort's redesign left as they were, as a control. It
prints one JSON line per (turn, kernel, size): ms, plain ms, library ms
and, where the checkout reports them, the passes run and the plan's
sync. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROUND_SIZES = (1 << 19, 1 << 20, 1 << 22, 1 << 24)
MESH_SIZES = ((2, 8192), (4, 4096), (4, 1 << 20), (4, 1 << 22), (1, 1 << 24))
KEYS = ("ms", "plain_ms", "library_ms", "library_with_key_ms", "passes",
        "sync_ms")


def turn(directory: str, label: str, seed: int) -> None:
    os.chdir(directory)
    sys.path.insert(0, directory)
    import chip_smoke as cs
    cs.phase_card()
    cs.phase_build()
    res: dict = {}
    sizes = {"K1": set(ROUND_SIZES), "K8": set(MESH_SIZES),
             "K6": set(cs.PLANE_PADS), "K10": {cs.ANN_ROWS}}
    cs.phase_kernels(seed, sizes, res)
    for kid in ("K1", "K2", "K3", "K6", "K7", "K8", "K10"):
        for size, r in sorted(res.get(kid, {}).get("shapes", {}).items()):
            print(json.dumps({"turn": label, "kernel": kid,
                              "size": size, **{k: r[k] for k in KEYS
                                               if k in r}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        turn(os.path.abspath(args.old), args.turn, args.seed)
        return 0
    me = os.path.abspath(__file__)
    for label, d in (("old", args.old), ("new", args.new),
                     ("new", args.new), ("old", args.old)):
        rc = subprocess.run([sys.executable, me, os.path.abspath(d), d,
                             "--turn", label, "--seed",
                             str(args.seed)]).returncode
        if rc != 0:
            print(f"kernel_ab: the {label} turn in {d} failed ({rc})",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
