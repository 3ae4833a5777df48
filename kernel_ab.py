#!/usr/bin/env python3
"""Time chip_smoke.py's kernel checks in two checkouts on one card, in
turns (old, new, new, old), so that two versions of a kernel are
compared within one run on one card.

    python3 kernel_ab.py OLD_DIR NEW_DIR

Each turn is a process of its own started in one checkout: it builds
that checkout's kernels into its own build directory (chip_smoke's
phase 2) and runs its chip_smoke checks (each kernel held exactly
against its plain version) at the sizes below: the subjects K6 and K7,
the plane programs, on the synthetic plane rounds at the sizes the
compaction paths launch them (2^19 and 786,432); and as the control
K1-K3 on the synthetic rounds, K8 on the synthetic mesh steps and K10.
It prints one JSON line per (turn, kernel, size): ms, plain ms, library
ms and, where the checkout reports them, the passes run. Then, per
turn:

  empty    K1 on rounds of 2^19 and 2^24 rows whose live rows share one
           key (no byte varies, so the sort runs no pass): CUDA-event ms
           and torch.profiler's device ms by kernel, which give a
           launched pass that finds no work its cost;
  submit   the host ms of one submit, `submit_merge_resident` (K1-K3)
           and `submit_merge` on a K6 round and a K7 round, all of the
           planned round's 491,520 cells (4 runs of bench.py's stcs
           shape, the K7 round with 2% tombstones), on an idle card and
           behind a kernel that keeps the card busy for SLEEP_CYCLES
           (its CUDA-event ms printed beside): a submit that waits for
           the device takes that long.
Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROUND_SIZES = (1 << 19, 1 << 20, 1 << 22, 1 << 24)
MESH_SIZES = ((2, 8192), (4, 4096), (4, 1 << 20), (4, 1 << 22), (1, 1 << 24))
KEYS = ("ms", "plain_ms", "library_ms", "library_with_key_ms", "passes")
EMPTY_SIZES = (1 << 19, 1 << 24)
SUBMIT_RUNS, SUBMIT_RUN_CELLS = 4, 122_880
SLEEP_CYCLES = 1 << 30
SUBMIT_REPS = 3


def empty_sorts(cs, seed: int) -> dict:
    """K1 on a make_round whose live rows all carry row 0's key."""
    import torch

    from cassandra_tpu_torch.ops import merge as dm
    out = {}
    for N in EMPTY_SIZES:
        r = cs.make_round(seed, N // 2, N)
        for k in ("lanes", "ts_h", "ts_l"):
            r[k][:N // 2] = r[k][:1]
        ops = dm.operands_to_device(r, torch.device("cuda"))
        perm = dm.device_sort_perm(ops)
        assert bool((perm.cpu() == torch.arange(N)).all())
        out[N] = {"ms": cs.cuda_ms(lambda: dm.device_sort_perm(ops)),
                  "steps": cs.sort_breakdown(
                      lambda: dm.device_sort_perm(ops))}
    return out


def _runs(cs, deletions: bool) -> list:
    from cassandra_tpu_torch.storage.cellbatch import (FLAG_TOMBSTONE,
                                                       merge_sorted)
    from cassandra_tpu_torch.tools import bulk
    table = cs.mesh_table()
    out = []
    for r in range(SUBMIT_RUNS):
        rng = np.random.default_rng(100 + r)
        n = SUBMIT_RUN_CELLS
        b = bulk.build_int_batch(
            table, rng.integers(0, cs.STCS_PARTITIONS, n),
            rng.integers(1, 10_000, n),
            rng.integers(97, 122, (n, 16), dtype=np.uint8),
            rng.integers(1, 1 << 40, n).astype(np.int64))
        if deletions:
            b.flags[::50] |= FLAG_TOMBSTONE
            out.append(b)
        else:
            out.append(merge_sorted([b]))
    return out


def submit_times(cs) -> dict:
    """Host ms of one submit, idle and behind SLEEP_CYCLES of card
    work, means of SUBMIT_REPS; each round is collected after."""
    import torch

    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.ops import merge as dm
    dev = torch.device("cuda")
    live, dels = _runs(cs, False), _runs(cs, True)
    cases = {"resident": (dw.submit_merge_resident,
                          dw.collect_merge_resident, live),
             "K6": (dm.submit_merge, dm.collect_merge, live),
             "K7": (dm.submit_merge, dm.collect_merge, dels)}
    out = {"sleep_ms": cs.cuda_ms(lambda: torch.cuda._sleep(SLEEP_CYCLES),
                                  reps=3, warm=1)}
    for name, (submit, collect, batches) in cases.items():
        collect(submit(batches, device=dev))          # warm
        row = {}
        for busy in (False, True):
            total = 0.0
            for _ in range(SUBMIT_REPS):
                torch.cuda.synchronize()
                if busy:
                    torch.cuda._sleep(SLEEP_CYCLES)
                t0 = time.perf_counter()
                h = submit(batches, device=dev)
                total += time.perf_counter() - t0
                collect(h)
            row["busy_ms" if busy else "idle_ms"] = \
                total / SUBMIT_REPS * 1e3
        row["mode"] = h.mode
        out[name] = row
    return out


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
    for N, r in empty_sorts(cs, seed).items():
        print(json.dumps({"turn": label, "empty": N, **r}), flush=True)
    print(json.dumps({"turn": label, "submit": submit_times(cs)}),
          flush=True)


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
