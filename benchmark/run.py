"""Run one cell of the benchmark of cassandra_tpu_torch once.

    python3 benchmark/run.py --workload W --seed S --seconds T --trace 0|1

Set-up makes the cell's sstables from the seed (the configuration's
table under the traffic mix's writes, written by the program's host LZ4
path), loads the CUDA kernels (built by nvcc into the program's build
directory in the checkout on a checkout's first run) and warms the
kernels and the device engine's round shapes on small copies of the
mix. The window runs major compactions back to back, each
`CompactionTask.execute()` on a fresh store of hard links to the
inputs, until T seconds have passed (the one in flight finishes) or the
outputs reach WRITE_CAP_BYTES. `compaction_mib_s` is all input Data.db
bytes over all compaction seconds. Then the configuration's plain
reference reads the first output with its own decoder (CHECK_WORKERS
processes decode its blocks) and compares every cell, block and index
entry with what the mix must give; every other output must be
byte-identical to the first. The last line of standard output is the
result as JSON; the numbers compared, each beside its limit, end both
it and standard error.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import spec as spec_mod  # noqa: E402
from harness import sut  # noqa: E402
from harness.stress import Mix  # noqa: E402

WORK = os.path.join(ROOT, ".benchwork")
# the most compaction output one run writes (its inputs come on top): no
# compaction starts once the window's outputs reach it
WRITE_CAP_BYTES = 2 << 30
# rows of the small copies set-up warms on: with the window's deployment
# a copy that fills two of the device engine's rounds (491,520 cells)
# and part of a third, and in a device-compress cell one full
# 65,536-cell segment and a partial one for K5 and the payload scan
WARM_ROWS = 180_000
WARM_DC_ROWS = 12_000
# processes that decode the checked output's blocks side by side
CHECK_WORKERS = 6
FORBIDDEN = ("jax", "jaxlib", "flax", "cassandra_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def note(line: str) -> None:
    print(f"[bench] {line}", file=sys.stderr, flush=True)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def output_hashes(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        with open(os.path.join(directory, fn), "rb") as f:
            out[fn] = hashlib.file_digest(f, "sha256").hexdigest()
    return out


def dir_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory))


def set_up(cell, mix, seed, work, device, pool):
    """Load the kernels, write the inputs and warm up: (table, the input
    files)."""
    import torch

    cfg = cell.config
    t = time.perf_counter()
    sut.load_kernels(device)
    note(f"kernels loaded in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    table = sut.make_table(cfg, mix, seed)
    inputs = sut.write_inputs(os.path.join(work, "in"), table, mix, pool)
    data = sum(os.path.getsize(f) for f in inputs if f.endswith("Data.db"))
    note(f"inputs: {mix.sstables} sstables, {data} bytes of Data.db, "
         f"in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    # the window's round shapes with host LZ4, then K5 and the payload
    # scan, each on a small copy of the mix written in set-up
    warm = [(WARM_ROWS, False)]
    if cfg["compaction_device_compress"]:
        warm.append((WARM_DC_ROWS, True))
    for i, (rows, dc) in enumerate(warm):
        files = inputs
        if rows // mix.passes < mix.n:
            small = Mix.of(cfg, cell.traffic, seed, n=rows // mix.passes)
            files = sut.write_inputs(os.path.join(work, f"warm-in{i}"),
                                     table, small, pool)
        sut.link_inputs(files, os.path.join(work, f"warm{i}"), table)
        sut.compact(os.path.join(work, f"warm{i}"), table, device, cfg,
                    pool, device_compress=dc)
        shutil.rmtree(os.path.join(work, f"warm-in{i}"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, f"warm{i}"))
    # the inputs' pages reach the disk now, not during the window
    for f in inputs:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    note(f"warm-up in {time.perf_counter() - t:.3f} s")
    return table, inputs


def measure(cell, table, inputs, seconds, work, device, pool) -> dict:
    """The window: major compactions back to back on fresh stores until
    `seconds` have passed or the outputs reach WRITE_CAP_BYTES."""
    w = {"bytes": 0, "seconds": 0.0, "attempted": 0, "failed": 0,
         "profile": {}, "first": None, "unlike": 0}
    written = 0
    first_hashes = None
    t_open = time.perf_counter()
    while w["attempted"] == 0 or (time.perf_counter() - t_open < seconds
                                  and written < WRITE_CAP_BYTES):
        root = os.path.join(work, f"c{w['attempted']}")
        in_bytes = sut.link_inputs(inputs, root, table)
        w["attempted"] += 1
        t0 = time.perf_counter()
        try:
            _stats, prof = sut.compact(root, table, device, cell.config,
                                       pool)
        except Exception as e:   # the run reports it as failed
            note(f"compaction {w['attempted']} failed: "
                 f"{type(e).__name__}: {e}")
            w["failed"] += 1
            break
        dt = time.perf_counter() - t0
        note(f"compaction {w['attempted']}: {dt:.4f} s, "
             f"{in_bytes / 2**20 / dt:.4f} MiB/s; " + ", ".join(
                 f"{k} {v:.3f}" for k, v in sorted(
                     prof.items(), key=lambda kv: -kv[1])[:5]))
        w["seconds"] += dt
        w["bytes"] += in_bytes
        for k, v in prof.items():
            w["profile"][k] = w["profile"].get(k, 0.0) + v
        out_dir = sut.store_dir(root, table)
        written += dir_bytes(out_dir)
        hashes = output_hashes(out_dir)
        if w["first"] is None:
            w["first"], first_hashes = out_dir, hashes
        else:
            w["unlike"] += hashes != first_hashes
            shutil.rmtree(root)
    return w


def since(c0: dict, c1: dict) -> dict:
    """The program's counters over the window (sut.counters deltas)."""
    return {
        "transfers": {d: {k: c1["transfers"][d][k] - c0["transfers"][d][k]
                          for k in ("copies", "bytes")}
                      for d in ("h2d", "d2h")},
        "launch_sizes": {
            k: {s: n - c0["launch_sizes"].get(k, {}).get(s, 0)
                for s, n in v.items()
                if n > c0["launch_sizes"].get(k, {}).get(s, 0)}
            for k, v in c1["launch_sizes"].items()}}


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
             device, setup_clock=process_age_s) -> dict:
    """Set up, measure and check one run of `cell`: the result's fields
    (forbidden modules are main()'s to refuse)."""
    import torch

    mix = Mix.of(cell.config, cell.traffic, seed)
    work = os.path.join(WORK, cell.name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pool = sut.make_pool(int(cell.config["compaction_compressor_threads"]))
    try:
        table, inputs = set_up(cell, mix, seed, work, device, pool)
        c0 = sut.counters()
        setup_s = setup_clock()
        note(f"set-up {setup_s:.3f} s")
        window = None
        if trace:
            from harness.trace import Window
            window = Window().__enter__()
        try:
            w = measure(cell, table, inputs, seconds, work, device, pool)
        finally:
            if window is not None:
                window.__exit__(None, None, None)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        ctx = {"profile": w["profile"], "input_bytes": w["bytes"],
               "lanes": 9 + table.clustering_lanes,
               **since(c0, sut.counters()),
               "trace": window.summary() if window is not None else None}
        if trace:
            metrics = {}
            for m in cell.per_layer:
                v = spec_mod.reader(m["name"])(ctx) if w["bytes"] else None
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = {"setup_s": setup_s,
                   "compaction_mib_s": (w["bytes"] / 2**20 / w["seconds"]
                                        if w["seconds"] > 0 else None)}
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end
                       if e2e.get(m["name"]) is not None}

        # the check, after the window and the memory peak
        ref = cell.reference()
        t = time.perf_counter()
        if w["first"] is None:
            numbers = {k: 1 for k in ref.LIMITS}
        else:
            with ProcessPoolExecutor(
                    CHECK_WORKERS,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                numbers = ref.compare(
                    w["first"], ref.expected(mix),
                    decode=ex.map)
            numbers["outputs_unlike"] = w["unlike"]
        note(f"check in {time.perf_counter() - t:.3f} s")
        checks = {k: {"value": numbers[k], "limit": lim}
                  for k, lim in ref.LIMITS.items()}
        correct = (w["failed"] == 0
                   and all(c["value"] <= c["limit"]
                           for c in checks.values()))
        on_card = device.type == "cuda"
        result = {"correct": correct, "attempted": w["attempted"],
                  "failed": w["failed"], "metrics": metrics,
                  "device": {"platform": "gpu" if on_card else device.type,
                             "kind": (torch.cuda.get_device_name(device)
                                      if on_card else "cpu"),
                             "count": cell.chips,
                             "memory_peak_bytes": int(peak)}}
        if window is not None:
            tr = ctx["trace"]
            result["device"].update(busy_s=tr["busy_s"],
                                    window_s=tr["window_s"])
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
        result["checks"] = checks
        return result
    finally:
        pool.shutdown()
        shutil.rmtree(work, ignore_errors=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec_mod.Cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    note(f"card: {power_limit()}; {os.cpu_count()} cpus")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
