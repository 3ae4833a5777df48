#!/usr/bin/env python3
"""Time chip_smoke.py's kernel checks in two checkouts on one card, in
turns (old, new, new, old), so that two versions of a kernel are
compared within one run on one card.

    python3 kernel_ab.py OLD_DIR NEW_DIR [--sections kernels,issue,...]
                                         [--kernels K1,K9,...]

Each turn is a process of its own started in one checkout: it builds
that checkout's kernels into its own build directory (chip_smoke's
phase 2) and runs the sections named (all by default), each with that
checkout's own code:

  kernels  its chip_smoke checks (each kernel held exactly against its
           plain version): K9's mask at a segment's 65,536 keys and at
           a run's cap of 2^20 keys (ms through the profiling hook,
           graph_ms without the host's issue cost), K10 on 1,000,000 x
           128 (every similarity, k = 10 and 100), K6 and K7 on the
           synthetic plane rounds (2^19 and 786,432), K1-K3 on the
           synthetic rounds (2^19 to 2^24; `--kernels K2` picks them
           too), K8 on the synthetic mesh steps, and K4 and K5 on one
           65,536-cell segment. One JSON line per (turn, kernel, size):
           ms, plain ms, library ms and, where the checkout reports
           them, the passes run, K10's cases or the device launches
           and ms by kernel of one call (`steps`; K2 and K5 from this
           tree on);
  issue    the host's cost of issuing K9's mask at 65,536 keys:
           microseconds a call over TIMED_CALLS calls (the host's mean,
           its least of five windows, and the card's mean from CUDA
           events) of the whole call, the call without its profiling
           hook, the bare C entry through ctypes, and each piece around
           it (the output's allocation, two torch timing events, the
           current stream, the launch count, the H2D copy of numpy
           keys, the D2H copy of the mask, `mask_device`), then
           cProfile's costliest functions over TIMED_CALLS calls; and
           K10's device ms by kernel (torch.profiler) at 1,000,000 x
           128, dot, k = 10 and 100;
  read     the scan's Phase A on a small table (READ_PARTITIONS x 10
           rows of scan.events in 4 sstables, as chip_smoke's read
           phase builds it; two mesh lanes, `scan_device_filter` on):
           per query (a) and (b), cold then warm, the wall ms, the
           `scan` ledger's `filter` stage seconds, K9's launches and
           the device segments;
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
SCAN_SIZES = (1 << 16, 1 << 20)     # a segment's keys, a run's cap
TIMED_CALLS = 10_000
READ_PARTITIONS = 200_000           # the small read table: x 10 rows
MESH_SIZES = ((2, 8192), (4, 4096), (4, 1 << 20), (4, 1 << 22), (1, 1 << 24))
KEYS = ("ms", "plain_ms", "library_ms", "library_with_key_ms", "passes",
        "graph_ms", "library_graph_ms", "cases", "steps")
SECTIONS = ("kernels", "issue", "read", "empty", "submit")
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


def _host_us(fn, calls: int) -> list:
    """Microseconds a call of fn: [the host's mean over `calls` calls,
    the host's least mean of five windows of calls / 5, the card's mean
    (CUDA events around all the calls)] (warmed). The host is shared,
    so a window's mean moves with its neighbours; the least is the
    uncontended cost. The card's mean is the time per call that CUDA
    events see: the host's, unless the card takes longer."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    windows = []
    start.record()
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(calls // 5):
            fn()
        windows.append((time.perf_counter_ns() - t0) / (calls // 5) / 1e3)
    end.record()
    end.synchronize()
    card = start.elapsed_time(end) * 1e3 / (5 * (calls // 5))
    return [sum(windows) / 5, min(windows), card]


def k9_issue(cs, seed: int) -> dict:
    """Host us a call of K9's mask at a segment's keys, by part, and
    cProfile's costliest functions over TIMED_CALLS calls."""
    import cProfile
    import pstats

    import torch

    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.ops import device_scan as ds
    dev = torch.device("cuda")
    n = SCAN_SIZES[0]
    keys = cs.scan_keys(seed + 6, n)
    kc = ds.keys_tensor(keys, dev)
    q1 = keys[[n // 3]]
    pred = ds.CompiledPredicate(0, "v", "i64", 4, "=", "eq", q1, True,
                                False)
    lib = cuda_lib.lib()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    q0 = int(q1[0])

    def events():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        b.record()

    parts = {
        "call": lambda: ds.scan_mask(kc, "eq", q1),
        "call_without_hook": lambda: ds.scan_mask.__wrapped__(kc, "eq", q1),
        "ctypes_entry": lambda: lib.ctpu_scan_mask(
            kc.data_ptr(), n, 0, q0, None, 0, out.data_ptr(), stream),
        "alloc_out": lambda: torch.empty(n, dtype=torch.bool, device=dev),
        "two_timing_events": events,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "count_launch": lambda: cuda_lib.count_launch("scan.mask", n),
        "h2d_numpy_keys": lambda: ds.keys_tensor(keys, dev),
        "d2h_mask": lambda: out.cpu().numpy(),
        "mask_device": lambda: ds.mask_device(keys, pred, dev),
    }
    us = {name: _host_us(fn, TIMED_CALLS) for name, fn in parts.items()}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(TIMED_CALLS):
        ds.scan_mask(kc, "eq", q1)
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:15]
    top = [{"fn": f"{os.path.basename(f)}:{line}({name})",
            "calls_per_call": nc / TIMED_CALLS,
            "tottime_us": tt / TIMED_CALLS * 1e6,
            "cumtime_us": ct / TIMED_CALLS * 1e6}
           for (f, line, name), (_cc, nc, tt, ct, _callers) in rows]
    return {"n": n, "host_us": us, "cprofile": top}


def k10_stages(cs, seed: int) -> dict:
    """K10's device ms by kernel (torch.profiler), dot, at each k."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cassandra_tpu_torch.ops import ann
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    m = torch.randn(cs.ANN_ROWS, cs.ANN_DIM, generator=g, device=dev)
    q = torch.randn(cs.ANN_DIM, generator=g, device=dev)
    out = {}
    for k in cs.ANN_KS:
        ann.ann_topk(m, q, k, "dot")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ann.ann_topk(m, q, k, "dot")
            torch.cuda.synchronize()
        out[k] = {e.key: [e.count, e.self_device_time_total / 1e3]
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA}
    return out


def read_filter(cs, seed: int) -> list:
    """Phase A on a small scan.events table: per query, cold then warm,
    wall ms, the `filter` stage's seconds, K9 launches, device
    segments."""
    import tempfile

    import torch

    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.utils import pipeline_ledger
    work = tempfile.mkdtemp(prefix="ab-read-", dir=os.path.join(
        os.getcwd(), "cassandra_tpu_torch", "build"))
    eng = StorageEngine(os.path.join(work, "read"), Schema(),
                        commitlog_sync="batch", device="cuda")
    out = []
    try:
        s = Session(eng)
        s.execute("CREATE KEYSPACE scan WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE scan")
        s.execute("CREATE TABLE events (k int, c int, v int, "
                  "PRIMARY KEY (k, c))")
        rng = np.random.default_rng(seed + 9)
        n = READ_PARTITIONS * cs.SCAN_ROWS
        pk = np.repeat(np.arange(READ_PARTITIONS, dtype=np.int64),
                       cs.SCAN_ROWS)
        ck = np.tile(np.arange(cs.SCAN_ROWS, dtype=np.int64),
                     READ_PARTITIONS)
        v = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        cs.write_int_runs(eng.store("scan", "events"), pk, ck,
                          v.astype(">i4").view(np.uint8).reshape(n, 4),
                          cs.SCAN_RUNS, int(time.time() * 1e6))
        eng.settings.set("scan_device_filter", True)
        eng.settings.set("compaction_mesh_devices", cs.READ_MESH_LANES)
        thr = int(-(1 << 31) + cs.SCAN_SELECTIVITY * (1 << 32))
        queries = {
            "(a)": ("SELECT k, c, v FROM events WHERE v = ? ALLOW "
                    "FILTERING", [int(v[n // 2])]),
            "(b)": ("SELECT count(*), min(v), max(v), sum(v) FROM events "
                    "WHERE v < ? ALLOW FILTERING", [thr])}
        st = pipeline_ledger.ledger("scan").stage("filter")
        for temp in ("cold", "warm"):
            for tag, (q, params) in queries.items():
                torch.cuda.synchronize()
                cuda_lib.reset_launches()
                f0 = st.busy_s
                d0 = METRICS.counter("scan.device_segments")
                t0 = time.perf_counter()
                s.execute(q, params)
                torch.cuda.synchronize()
                out.append({
                    "query": tag, "caches": temp,
                    "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "filter_s": st.busy_s - f0,
                    "k9_launches": cuda_lib.launches()["scan.mask"],
                    "device_segments":
                        METRICS.counter("scan.device_segments") - d0})
    finally:
        eng.close()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    return out


def turn(directory: str, label: str, seed: int, sections: tuple,
         kernels: tuple | None) -> None:
    os.chdir(directory)
    sys.path.insert(0, directory)
    import chip_smoke as cs
    cs.phase_card()
    cs.phase_build()
    if "kernels" in sections:
        res: dict = {}
        sizes = {"K1": set(ROUND_SIZES), "K8": set(MESH_SIZES),
                 "K6": set(cs.PLANE_PADS), "K9": set(SCAN_SIZES),
                 "K10": {cs.ANN_ROWS}, "K4": {cs.SEGMENT},
                 "K5": {cs.SEGMENT}}
        if kernels is not None and "K2" in kernels:
            sizes["K2"] = sizes["K1"]
        sizes = {kid: v for kid, v in sizes.items()
                 if kernels is None or kid in kernels}
        cs.phase_kernels(seed, sizes, res)
        for kid in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9",
                    "K10"):
            for size, r in sorted(res.get(kid, {}).get("shapes", {}).items()):
                print(json.dumps({"turn": label, "kernel": kid,
                                  "size": size, **{k: r[k] for k in KEYS
                                                   if k in r}}), flush=True)
    if "issue" in sections:
        print(json.dumps({"turn": label, "k9_issue": k9_issue(cs, seed)}),
              flush=True)
        print(json.dumps({"turn": label, "k10_stages": k10_stages(cs, seed)}),
              flush=True)
    if "read" in sections:
        for r in read_filter(cs, seed):
            print(json.dumps({"turn": label, "read": r}), flush=True)
    if "empty" in sections:
        for N, r in empty_sorts(cs, seed).items():
            print(json.dumps({"turn": label, "empty": N, **r}), flush=True)
    if "submit" in sections:
        print(json.dumps({"turn": label, "submit": submit_times(cs)}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of " + ", ".join(SECTIONS))
    ap.add_argument("--kernels", help="comma-separated kernels of the "
                    "kernels section (K1 or K2 checks K1-K3, K6 K6 and "
                    "K7; default: K1, K4, K5, K6, K8, K9, K10)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        turn(os.path.abspath(args.old), args.turn, args.seed,
             tuple(args.sections.split(",")),
             tuple(args.kernels.split(",")) if args.kernels else None)
        return 0
    me = os.path.abspath(__file__)
    for label, d in (("old", args.old), ("new", args.new),
                     ("new", args.new), ("old", args.old)):
        rc = subprocess.run([sys.executable, me, os.path.abspath(d), d,
                             "--turn", label, "--seed", str(args.seed),
                             "--sections", args.sections]
                            + (["--kernels", args.kernels] if args.kernels
                               else [])).returncode
        if rc != 0:
            print(f"kernel_ab: the {label} turn in {d} failed ({rc})",
                  file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
