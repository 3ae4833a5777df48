"""Device-engine accounting: how much of the device engine's gap to the
native engine is the host-card link?

  1. measures the WARM link on the card: host-to-card and card-to-host
     bandwidth of pinned tensors shaped like a round's operands, timed
     with CUDA events after a sizable program has run, and the round
     trip of a tiny push + a trivial kernel + a tiny pull;
  2. runs bench.py's `stcs` workload (4 runs of 262,144 cells over
     4,096 partitions, 64 B blobs, LZ4 16 KiB) under both engines;
  3. decomposes the device engine's extra wall time into (a) the
     link-transfer floor implied by the measured bandwidth and the
     bytes the rounds actually moved (counted at the port's transfer
     points in ops/: `cuda_lib.transfers()`), plus the round trip
     each device round pays, and (b) everything else;
  4. prints one JSON line with the fraction of the gap the link floor
     explains, plus the projected throughput with the transfer cost
     removed.

On a card (`cuda`, the default; it raises without one):

    python -m cassandra_tpu_torch.scripts.device_accounting

With `--device cpu` the device engine runs the kernels' plain PyTorch
versions: no byte crosses a link, so the link and its floors are
reported as null.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# bench.py's `stcs` configuration
RUNS = 4
CELLS_PER_RUN = 262_144
N_PARTITIONS = 4096
VALUE_BYTES = 64
# the kernels one device round launches first: the resident round's
# sort, the plane programs of a round off the resident path
ROUND_KERNELS = ("merge.sort_perm", "merge.plane_fast", "merge.plane_v2")


def measure_link(device, n_bytes: int = 8 << 20, reps: int = 5):
    """Warm link characteristics of a card: (push MiB/s, pull MiB/s,
    round-trip seconds). The round trip is a TINY push + a trivial
    kernel + a tiny pull — the fixed cost a round pays regardless of
    volume."""
    import torch

    if device.type != "cuda":
        raise ValueError(f"no link to measure on {device}")
    # warm the card with a real program first (post-program link rates
    # are the ones compaction sees)
    x = torch.ones((2048, 2048), dtype=torch.float32, device=device)
    (x @ x).sum().item()

    host = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, n_bytes, dtype=np.uint8)).pin_memory()
    back = torch.empty_like(host).pin_memory()
    dev = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device)
    push, pull = [], []
    for _ in range(reps):
        t0, t1, t2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        t0.record(stream)
        dev.copy_(host, non_blocking=True)
        t1.record(stream)
        back.copy_(dev, non_blocking=True)
        t2.record(stream)
        t2.synchronize()
        push.append(t0.elapsed_time(t1) / 1e3)
        pull.append(t1.elapsed_time(t2) / 1e3)
    if not torch.equal(back, host):
        raise RuntimeError("the link round trip changed the bytes")

    tiny = torch.ones(1024, dtype=torch.uint8).pin_memory()
    (tiny.to(device) + 1).cpu()                  # first launch
    rtt = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (tiny.to(device, non_blocking=True) + 1).cpu()
        rtt.append(time.perf_counter() - t0)
    mib = n_bytes / 2**20
    return mib / min(push), mib / min(pull), min(rtt)


def _table():
    from cassandra_tpu_torch.ops.codec import CompressionParams
    from cassandra_tpu_torch.schema import TableParams, make_table

    return make_table(
        "bench", "stress", pk=["id"], ck=["c"],
        cols={"id": "int", "c": "int", "v": "blob"},
        params=TableParams(
            compression=CompressionParams("LZ4Compressor",
                                          chunk_length=16 * 1024),
            gc_grace_seconds=864000))


def build_inputs(data_dir: str, table, seed: int,
                 cells_per_run: int) -> None:
    """bench.py build_inputs for `stcs`: RUNS sorted runs over the same
    partition space, random rows."""
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    from cassandra_tpu_torch.tools import bulk

    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    for gen in range(1, RUNS + 1):
        n = cells_per_run
        pk = rng.integers(0, N_PARTITIONS, n)
        ck = rng.integers(1, 10_000, n)
        vals = rng.integers(0, 256, (n, VALUE_BYTES), dtype=np.uint8)
        ts = rng.integers(1, 1 << 40, n).astype(np.int64)
        merged = cb.merge_sorted([bulk.build_int_batch(table, pk, ck,
                                                       vals, ts)])
        w = SSTableWriter(Descriptor(data_dir, gen), table,
                          estimated_partitions=N_PARTITIONS)
        w.append(merged)
        w.finish()


def _compact(base_dir: str, table, engine: str, device, seed: int,
             cells_per_run: int) -> dict:
    """Build the inputs under a store at base_dir and compact them."""
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    cfs = ColumnFamilyStore(table, base_dir, commitlog=None)
    build_inputs(cfs.directory, table, seed, cells_per_run)
    cfs.reload_sstables()
    task = CompactionTask(cfs, cfs.tracker.view(), engine=engine,
                          device=device)
    t0 = time.perf_counter()
    stats = task.execute()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    stats["wall"] = time.perf_counter() - t0
    stats["profile"] = {k: round(v, 3)
                        for k, v in sorted(task.profile.items())}
    for r in cfs.live_sstables():
        r.close()
    return stats


def run_bench(engine: str, device, cells_per_run: int,
              after_warm=None) -> dict:
    """One warm-up compaction, then the better of two timed ones (each
    on fresh inputs), as bench.py runs the `stcs` workload."""
    table = _table()
    base = tempfile.mkdtemp(prefix=f"ctpu-acct-{engine}-")
    try:
        runs = []
        for i, tag in enumerate(("warm", "t1", "t2")):
            d = os.path.join(base, tag)
            runs.append(_compact(d, table, engine, device,
                                 1 if i == 0 else 2, cells_per_run))
            shutil.rmtree(d, ignore_errors=True)
            if i == 0 and after_warm is not None:
                after_warm()
        return min(runs[1:], key=lambda s: s["wall"])
    finally:
        shutil.rmtree(base, ignore_errors=True)


def account(device=None, cells_per_run: int = CELLS_PER_RUN) -> dict:
    """The accounting as one dict (what main prints)."""
    from cassandra_tpu_torch import device as devmod
    from cassandra_tpu_torch.ops import cuda_lib

    dev = devmod.resolve(device)
    link = measure_link(dev) if dev.type == "cuda" else None

    def reset():
        cuda_lib.reset_transfers()
        cuda_lib.reset_launches()

    # counters reset after the warm run; they then hold both timed
    # runs, so they are halved to describe one compaction
    dstats = run_bench("device", dev, cells_per_run, after_warm=reset)
    moved = cuda_lib.transfers()
    launched = cuda_lib.launches()
    n_rounds = sum(launched[k] for k in ROUND_KERNELS) // 2
    b_pushed = moved["h2d"]["bytes"] // 2
    b_pulled = moved["d2h"]["bytes"] // 2
    nstats = run_bench("native", dev, cells_per_run)

    mib_read = dstats["bytes_read"] / 2**20
    d_wall, n_wall = dstats["wall"], nstats["wall"]
    gap = d_wall - n_wall
    dphase = dstats["profile"]
    dev_wait = dphase.get("device", 0.0)
    result = {
        "metric": "device-vs-native accounting (STCS major)",
        "device": str(dev),
        "cells_per_run": cells_per_run,
        "native_mib_s": round(mib_read / n_wall, 1),
        "device_mib_s": round(mib_read / d_wall, 1),
        "gap_seconds": round(gap, 3),
        "link": None,
        "device_phases": dphase,
        "device_wait_seconds": dev_wait,
        "device_wait_explained_by_link": None,
        "gap_explained_by_link": None,
        "projected_mib_s_without_link": None,
    }
    if link is not None:
        push_mibs, pull_mibs, rtt = link
        # the link floor per compaction: bandwidth cost of the bytes
        # moved PLUS the fixed round trip each of the device rounds
        # pays
        bw_floor = (b_pushed / 2**20) / push_mibs + \
            (b_pulled / 2**20) / pull_mibs
        lat_floor = n_rounds * rtt
        link_floor = bw_floor + lat_floor
        result["link"] = {
            "push_mib_s": round(push_mibs, 1),
            "pull_mib_s": round(pull_mibs, 1),
            "round_trip_ms": round(rtt * 1e3, 3),
            "rounds": n_rounds,
            "bytes_pushed": b_pushed,
            "bytes_pulled": b_pulled,
            "copies_pushed": moved["h2d"]["copies"] // 2,
            "copies_pulled": moved["d2h"]["copies"] // 2,
            "bandwidth_floor_seconds": round(bw_floor, 4),
            "latency_floor_seconds": round(lat_floor, 4),
            "transfer_floor_seconds": round(link_floor, 4),
        }
        result["device_wait_explained_by_link"] = round(
            min(link_floor / dev_wait, 1.0) if dev_wait else 1.0, 3)
        result["gap_explained_by_link"] = round(
            min(link_floor / gap, 1.0) if gap > 0 else 1.0, 3)
        result["projected_mib_s_without_link"] = round(
            mib_read / max(d_wall - link_floor, 1e-9), 1)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.device_accounting")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device engine (default cuda)")
    p.add_argument("--cells-per-run", type=int, default=CELLS_PER_RUN,
                   help=f"cells in each of the {RUNS} input runs "
                        f"(default {CELLS_PER_RUN:,}, bench.py's stcs)")
    args = p.parse_args(argv)
    print(json.dumps(account(args.device, args.cells_per_run)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
