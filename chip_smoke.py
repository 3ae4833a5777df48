#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cassandra_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--cells-per-run N] [--seed S]

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. card     the card's name and power limit (nvidia-smi), the CUDA
              version of torch and the device count; fails without a card.
  2. build    the kernel library from cassandra_tpu_torch/csrc with nvcc
              (one process per source, in parallel); prints the
              `-Xptxas -v` summary.
  3. kernels  each kernel (K1 sort, K2 reconcile, K3 kept-first gather,
              K4 META serialize) against its plain PyTorch version on the
              card, at the main path's planned shapes (a round of 491,520
              cells padded to 524,288 with K = 13 lanes, holding every
              K2 mask bit; a 65,536-cell segment), exact equality
              required; warm times from CUDA events.
  4. e2e      the main path: input sstables in bench.py's `stcs` shape
              (4 runs, 4,096 partitions, clustering 1..9,999, 64 B random
              blob values, ts in [1, 2^40), LZ4 16 KiB), compacted by
              CompactionTask(engine="native") and by
              CompactionTask(engine="device", device_compress=False) on
              `cuda`. The launch counters (reset just before the device
              leg, read just after) must show every kernel; the output
              sstables' component sha256s must be equal; the output is
              read back and its cell count checked. The counters also
              split the launches by size (padded round N, segment cells).
  5. shapes   phase 3 again at every size the main path launched that
              phase 3 did not cover (a round extended past 2^19 cells to
              its partition's end pads to 2^20).

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel: route, source, the JAX function it replaces, launches on the
main path, max_abs_err, warm ms, plain ms, bound ms and what bounds it,
and the time of one PyTorch call that computes the same function where
there is one, at the size launched most, then the same per launched
size under "shapes") and the card's name and power limit. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
ROUND_CELLS = (1 << 19) - (1 << 15)  # CompactionTask.ROUND_CELLS_DEVICE
ROUND_PAD = 1 << 19                  # merge._bucket(ROUND_CELLS)
LANES = 13                           # int pk + int ck table
SEGMENT = 65_536                     # storage/sstable/format.py
STCS_RUNS = 4
STCS_CELLS_PER_RUN = 2_500_000       # BASELINE.json config 1: n = 10M
STCS_PARTITIONS = 4096
VALUE_BYTES = 64
DEVICE = "cuda"
COMPONENTS = ("Data.db", "Index.db", "Partitions.db", "Filter.db",
              "Statistics.db", "Digest.crc32")


class SmokeError(Exception):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------- 1. card --

def phase_card() -> dict:
    need(torch.cuda.is_available(), "no CUDA device: this smoke needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    info = {"smi": smi.splitlines()[0] if smi else "",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"card: {info['smi']} | torch {info['torch']} cuda "
          f"{info['cuda']} | devices {info['count']}", flush=True)
    return info


# ------------------------------------------------------------ 2. build --

def phase_build() -> None:
    from cassandra_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    log = cuda_lib.build(force=True)
    cuda_lib.lib()
    print(f"build: {len(cuda_lib.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or line.startswith("---")):
            print("  " + line.strip())


# ---------------------------------------------------------- 3. kernels --

def make_round(seed: int, n: int, N: int, K: int = LANES,
               partitions: int = STCS_PARTITIONS) -> dict:
    """Operands of one padded round (merge.build_resident_operands
    layout, numpy) with partition / row / complex deletions, TTL,
    equal-ts duplicates, purge stamps and padding rows."""
    rng = np.random.default_rng(seed)
    lanes = np.full((N, K), 0xFFFFFFFF, dtype=np.uint32)
    part = rng.integers(0, partitions, n).astype(np.uint64)
    for k in range(4):
        lanes[:n, k] = ((part * np.uint64(2654435761 + 40503 * k))
                        >> np.uint64(7)).astype(np.uint32)
    lanes[:n, 4] = rng.integers(0, 16, n)          # clustering prefix
    lanes[:n, 5:K - 3] = 0
    lanes[:n, K - 3] = rng.choice(np.array([0, 1, 8, 9], np.uint32), n,
                                  p=[0.02, 0.03, 0.75, 0.20])
    lanes[:n, K - 2] = rng.integers(0, 2, n)       # cell path
    lanes[:n, K - 1] = 0
    ts = rng.integers(0, 1 << 20, n).astype(np.int64)
    ties = rng.random(n) < 0.3                     # equal-ts duplicates
    ts[ties] = rng.integers(1000, 1004, int(ties.sum()))
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    now = 1_700_000_000

    def col(vals, dtype=np.uint32, fill=0):
        a = np.full(N, fill, dtype=dtype)
        a[:n] = vals
        return a

    return {
        "lanes": lanes,
        "valid": col(0, fill=1),
        "ts_h": col((uts >> np.uint64(32)).astype(np.uint32)),
        "ts_l": col((uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        "death": col(rng.random(n) < 0.1),
        "cdel": col(rng.random(n) < 0.02),
        "ldt": col(now + rng.integers(-1000, 1000, n), np.int32),
        "expiring": col(rng.random(n) < 0.2),
        "purge_h": col(np.where(rng.random(n) < 0.5, 0x80000000, 0xFFFFFFFF)
                       .astype(np.uint32), fill=0xFFFFFFFF),
        "purge_l": col(rng.integers(0, 1 << 20, n), fill=0xFFFFFFFF),
        "now": np.int32(now), "gc_before": np.int32(now - 500),
        "flags8": col(rng.integers(0, 256, n), np.uint8),
        "ttl": col(rng.integers(0, 1 << 20, n), np.int32),
        "fl": col(rng.integers(20, 200, n)),
        "vr": col(rng.integers(5, 20, n)),
    }


def make_segment(seed: int, n: int) -> tuple:
    """One full segment's columns with the extreme timestamps of
    tests/test_device_resident.py (i64 min and max, -1, 0)."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    ts[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    cols = ((uts >> np.uint64(32)).astype(np.uint32),
            (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            rng.integers(0, 1 << 20, n).astype(np.int32),
            rng.integers(0, 256, n).astype(np.uint8),
            rng.integers(0, 1 << 16, n).astype(np.uint32),
            rng.integers(0, 1 << 12, n).astype(np.uint32))
    return ts, cols


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Warm mean milliseconds per call from CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def packed_sort_key(ops: dict) -> torch.Tensor | None:
    """An int64 key whose stable sort equals K1's permutation on this
    round: the dense lexicographic rank of (valid, lanes) over the
    round's distinct rows, then the rank of ~ts. None when the ranks do
    not fit 63 bits."""
    from cassandra_tpu_torch.ops.merge import _wide
    ident = torch.cat([_wide(ops["valid"])[:, None], _wide(ops["lanes"])],
                      dim=1)
    _, r_id = torch.unique(ident, dim=0, return_inverse=True)
    # the signed timestamp orders like the unsigned biased (hi, lo) pair
    ts = (_wide(ops["ts_h"]) - (1 << 31)) * (1 << 32) + _wide(ops["ts_l"])
    uniq, r_ts = torch.unique(ts, return_inverse=True)
    r_ts = uniq.numel() - 1 - r_ts                      # ~ts: descending
    if int(r_id.max()) >= 1 << 31 or uniq.numel() > 1 << 32:
        return None
    return (r_id << 32) | r_ts


def round_cells_for(N: int) -> int:
    """Live cells of the synthetic round checked at padded size N: the
    planned round (ROUND_CELLS in ROUND_PAD) at that size, else a round
    just past N's lower power-of-two edge, as a round extended to its
    partition's end pads to the next size up."""
    return ROUND_CELLS if N == ROUND_PAD else N // 2 + N // 512


def _entry(res: dict, kid: str, name: str, size: int, **kw) -> None:
    res.setdefault(kid, {"name": name, "shapes": {}})["shapes"][size] = kw


def check_round(seed: int, N: int, res: dict) -> None:
    """K1-K3 against their plain versions on one synthetic round padded
    to N cells; exact equality; warm times."""
    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.ops import merge as dm

    n, K = round_cells_for(N), LANES
    ops = dm.operands_to_device(make_round(seed, n, N, K), torch.device(DEVICE))

    # K1 sort
    perm = dm.device_sort_perm(ops)
    perm_p = dm.sort_perm_plain(ops)
    torch.cuda.synchronize()
    err = max_abs_err(perm, perm_p)
    need(err == 0, f"K1 sort at N={N}: kernel != plain (max abs err {err})")
    key = packed_sort_key(ops)
    lib_ms = None
    if key is not None:
        lib_perm = torch.sort(key, stable=True).indices
        need(bool((lib_perm.to(torch.int32) == perm).all()),
             "K1: torch.sort of the packed key disagrees")
        lib_ms = cuda_ms(lambda: torch.sort(key, stable=True))
    _entry(res, "K1", "merge.sort_perm", N, err=err,
           ms=cuda_ms(lambda: dm.device_sort_perm(ops)),
           plain_ms=cuda_ms(lambda: dm.sort_perm_plain(ops), reps=3),
           library_ms=lib_ms, bytes=N * ((K + 3) * 4 + 4))

    # K2 reconcile
    packed = dm.reconcile_kernel(ops, perm)
    packed_p = dm.reconcile_plain(ops, perm)
    torch.cuda.synchronize()
    err = max_abs_err(packed, packed_p)
    need(err == 0, f"K2 reconcile at N={N}: kernel != plain "
                   f"(max abs err {err})")
    bits = packed[:n].to(torch.int64)     # live cells sort before padding
    masks = {m: int(((bits >> b) & 1).sum()) for b, m in
             enumerate(("keep", "ambiguous", "expired", "shadowed"))}
    print(f"  round: {n} cells padded to {N}, K={K}: " + ", ".join(
        f"{m} {c}" for m, c in masks.items()), flush=True)
    for m, c in masks.items():
        need(c > 0, f"the round at N={N} has no {m} cell: K2's {m} bit "
                    "is not exercised")
    _entry(res, "K2", "merge.reconcile", N, err=err, masks=masks,
           ms=cuda_ms(lambda: dm.reconcile_kernel(ops, perm)),
           plain_ms=cuda_ms(lambda: dm.reconcile_plain(ops, perm), reps=3),
           library_ms=None, bytes=N * (4 * K + 4 * 9 + 4 + 1))

    # K3 kept-first compaction + gather
    counts, perm_out, cols = dw.compact_gather(ops, perm, packed)
    counts_p, perm_out_p, cols_p = dw.compact_gather_plain(ops, perm, packed)
    torch.cuda.synchronize()
    err = max(max_abs_err(counts, counts_p), max_abs_err(perm_out, perm_out_p),
              *(max_abs_err(cols[k], cols_p[k]) for k in dw.RESIDENT_COLS))
    need(err == 0, f"K3 compact_gather at N={N}: kernel != plain "
                   f"(max abs err {err})")

    def library_k3():
        keep = (packed & 1) != 0
        order = torch.cat([torch.nonzero(keep).flatten(),
                           torch.nonzero(~keep).flatten()])
        p = perm.index_select(0, order).to(torch.int64)
        return [ops[k].index_select(0, p) for k in dw.RESIDENT_COLS]

    _entry(res, "K3", "write.compact_gather", N, err=err,
           ms=cuda_ms(lambda: dw.compact_gather(ops, perm, packed)),
           plain_ms=cuda_ms(
               lambda: dw.compact_gather_plain(ops, perm, packed), reps=3),
           library_ms=cuda_ms(library_k3, reps=3),
           bytes=N * (4 + 1 + 2 * (4 * K + 6 * 4 + 1) + 4) + 12)


def check_segment(seed: int, seg_n: int, res: dict) -> None:
    """K4 against its plain version and the host build_meta_block on one
    segment of seg_n cells with extreme timestamps; exact equality."""
    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.storage.cellbatch import DEATH_FLAGS
    from cassandra_tpu_torch.storage.sstable.writer import build_meta_block

    dev = torch.device(DEVICE)
    ts, seg_np = make_segment(seed + 1, seg_n)
    seg = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev) for a in seg_np]
    meta, st = dw.meta_block_kernel(*seg)
    meta_p, st_p = dw.meta_block_plain(*seg)
    torch.cuda.synchronize()
    err = max(max_abs_err(meta, meta_p), max_abs_err(st, st_p))
    need(err == 0, f"K4 meta_block at n={seg_n}: kernel != plain "
                   f"(max abs err {err})")
    host = build_meta_block(ts, seg_np[2], seg_np[3], seg_np[4],
                            seg_np[5].astype("<u4"), seg_np[6].astype("<u4"))
    need(bytes(meta.cpu().numpy()) == bytes(host),
         "K4 meta_block: kernel != host build_meta_block")
    stats = dw.meta_stats(st)
    need(stats == (int(ts.min()), int(ts.max()), int(seg_np[2].min()),
                   int(seg_np[2].max()),
                   int(((seg_np[4] & DEATH_FLAGS) != 0).sum())),
         f"K4 meta_block: stats {stats} disagree with the host")
    _entry(res, "K4", "write.meta_block", seg_n, err=err,
           ms=cuda_ms(lambda: dw.meta_block_kernel(*seg)),
           plain_ms=cuda_ms(lambda: dw.meta_block_plain(*seg), reps=3),
           library_ms=None, bytes=seg_n * 50 + 40)


ROUND_KERNELS = ("K1", "K2", "K3")
KERNEL_NAMES = {"K1": "merge.sort_perm", "K2": "merge.reconcile",
                "K3": "write.compact_gather", "K4": "write.meta_block"}


def print_checks(res: dict, sizes: dict) -> None:
    for kid in sorted(res):
        for size in sorted(sizes[kid]):
            r = res[kid]["shapes"][size]
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"  {kid} {res[kid]['name']} at {size}: match (max abs "
                  f"err {r['err']}), kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
                  f"{bound_ms(r['bytes']):.4f} ms", flush=True)


def phase_kernels(seed: int, sizes: dict, res: dict) -> None:
    """Check every (kernel, size) of `sizes` ({"K1": {N, ...}, ...})
    not yet in `res`. K1-K3 share a round, so one size checks all three."""
    todo = {kid: {s for s in sizes.get(kid, ())
                  if s not in res.get(kid, {}).get("shapes", {})}
            for kid in KERNEL_NAMES}
    for N in sorted(set().union(*(todo[k] for k in ROUND_KERNELS))):
        check_round(seed, N, res)
    for seg_n in sorted(todo["K4"]):
        check_segment(seed, seg_n, res)
    print_checks(res, todo)


# -------------------------------------------------------------- 4. e2e --

def stcs_table():
    from cassandra_tpu_torch.ops.codec import CompressionParams
    from cassandra_tpu_torch.schema import TableParams, make_table
    return make_table(
        "bench", "stress", pk=["id"], ck=["c"],
        cols={"id": "int", "c": "int", "v": "blob"},
        params=TableParams(
            compression=CompressionParams("LZ4Compressor",
                                          chunk_length=16 * 1024),
            gc_grace_seconds=864000))


def build_stcs_inputs(directory: str, table, seed: int,
                      cells_per_run: int) -> None:
    """bench.py build_inputs for the `stcs` config: STCS_RUNS sorted
    runs over the same partition space, random rows."""
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    from cassandra_tpu_torch.tools import bulk

    rng = np.random.default_rng(seed)
    for gen in range(1, STCS_RUNS + 1):
        n = cells_per_run
        pk = rng.integers(0, STCS_PARTITIONS, n)
        ck = rng.integers(1, 10_000, n)
        vals = rng.integers(0, 256, (n, VALUE_BYTES), dtype=np.uint8)
        ts = rng.integers(1, 1 << 40, n).astype(np.int64)
        merged = cb.merge_sorted([bulk.build_int_batch(table, pk, ck,
                                                       vals, ts)])
        w = SSTableWriter(Descriptor(directory, gen), table,
                          estimated_partitions=STCS_PARTITIONS)
        w.append(merged)
        w.finish()


def component_hashes(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        p = os.path.join(directory, fn)
        if os.path.isfile(p) and any(fn.endswith(c) for c in COMPONENTS):
            with open(p, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def _kernel_device_s() -> dict:
    from cassandra_tpu_torch.service.profiling import GLOBAL
    return {k: v["device_s"] for k, v in GLOBAL.snapshot()["kernels"].items()}


def compact_leg(root: str, table, **task_kw) -> dict:
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    cfs = ColumnFamilyStore(table, root, commitlog=None)
    cfs.reload_sstables()
    task = CompactionTask(cfs, cfs.tracker.view(), **task_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev0 = _kernel_device_s()
    t0 = time.perf_counter()
    stats = task.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dev1 = _kernel_device_s()
    kernel_s = {k: v - dev0.get(k, 0.0) for k, v in dev1.items()
                if v - dev0.get(k, 0.0) > 0}
    cells = 0
    for r in cfs.live_sstables():
        cells += sum(len(b) for b in r.scanner())
    need(cells == stats["cells_written"],
         f"read back {cells} cells, task wrote {stats['cells_written']}")
    hashes = component_hashes(cfs.directory)
    for r in cfs.live_sstables():
        r.close()
    return {"stats": stats, "wall": wall, "peak": peak, "hashes": hashes,
            "read_back": cells, "profile": dict(task.profile),
            "kernel_s": kernel_s}


def phase_e2e(seed: int, cells_per_run: int, work: str) -> dict:
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    if cells_per_run != STCS_CELLS_PER_RUN:
        print(json.dumps({"reduced": {
            "cells_per_run": cells_per_run,
            "published": STCS_CELLS_PER_RUN, "runs": STCS_RUNS}}))
    table = stcs_table()
    pristine = os.path.join(work, "pristine")
    cfs = ColumnFamilyStore(table, pristine, commitlog=None)
    t0 = time.perf_counter()
    build_stcs_inputs(cfs.directory, table, seed, cells_per_run)
    print(f"e2e: built {STCS_RUNS} x {cells_per_run} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    legs = {}
    for leg, kw in (("native", {"engine": "native"}),
                    ("device", {"engine": "device", "device": DEVICE,
                                "device_compress": False})):
        root = os.path.join(work, leg)
        shutil.copytree(pristine, root)
        if leg == "device":
            cuda_lib.reset_launches()
        legs[leg] = compact_leg(root, table, **kw)
        if leg == "device":
            legs[leg]["launches"] = cuda_lib.launches()
            legs[leg]["sizes"] = cuda_lib.launch_sizes()
        shutil.rmtree(root, ignore_errors=True)
        s = legs[leg]
        mib = s["stats"]["bytes_read"] / 2**20
        print(f"  {leg}: {s['stats']['cells_read']} -> "
              f"{s['stats']['cells_written']} cells, wall {s['wall']:.3f} s, "
              f"{mib / s['wall']:.2f} MiB/s, peak device memory "
              f"{s['peak'] / 2**20:.1f} MiB", flush=True)
        busy = sum(s["kernel_s"].values())
        print(f"    phases (s, summed over threads): " + json.dumps(
            {k: round(v, 4) for k, v in sorted(s["profile"].items())}))
        print(f"    kernel device time {busy:.4f} s = "
              f"{100 * busy / s['wall']:.2f}% of the wall: "
              + json.dumps({k: round(v, 5)
                            for k, v in sorted(s["kernel_s"].items())}),
              flush=True)
    launches = legs["device"]["launches"]
    print(f"  launches on the main path: {launches}; by size: "
          f"{legs['device']['sizes']}", flush=True)
    for name, count in launches.items():
        need(count > 0, f"kernel {name} was not launched on the main path")
    need(legs["native"]["hashes"] == legs["device"]["hashes"],
         "device engine output differs from the native engine's")
    need(len(legs["device"]["hashes"]) >= len(COMPONENTS),
         "no output sstable components found")
    print(f"  sha256 equal over {len(legs['device']['hashes'])} components",
          flush=True)
    return {"launches": launches, "sizes": legs["device"]["sizes"],
            "legs": legs}


# -------------------------------------------------------------- report --

SOURCES = {
    "K1": ("cassandra_tpu_torch/csrc/sort.cu",
           "cassandra_tpu/ops/merge.py:71"),
    "K2": ("cassandra_tpu_torch/csrc/reconcile.cu",
           "cassandra_tpu/ops/merge.py:124"),
    "K3": ("cassandra_tpu_torch/csrc/compact.cu",
           "cassandra_tpu/ops/device_write.py:94"),
    "K4": ("cassandra_tpu_torch/csrc/meta.cu",
           "cassandra_tpu/ops/device_write.py:122"),
}


LIBRARY_CALLS = {
    "K1": "torch.sort(stable=True) of an int64 key packed from the "
          "round's dense ranks (packing untimed)",
    "K3": "torch.nonzero + index_select (several calls)",
}


def kernels_line(res: dict, sizes: dict) -> dict:
    """Per kernel: the numbers at the size the main path launched most,
    max_abs_err over every size checked, and each launched size's own
    numbers under "shapes"."""
    out = []
    for kid, r in sorted(res.items()):
        src, replaces = SOURCES[kid]
        seen = sizes[r["name"]]
        shapes = []
        for size in sorted(seen):
            s = r["shapes"][size]
            shapes.append({
                "size": size, "launches": seen[size],
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": bound_ms(s["bytes"]),
                "library_ms": s["library_ms"],
                **({"masks": s["masks"]} if "masks" in s else {})})
        top = max(shapes, key=lambda e: (e["launches"], e["size"]))
        out.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(seen.values()),
            "max_abs_err": max(s["err"] for s in r["shapes"].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"],
            "library_call": LIBRARY_CALLS.get(kid), "size": top["size"],
            "shapes": shapes})
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells-per-run", type=int, default=STCS_CELLS_PER_RUN)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    info = phase_card()
    phase_build()
    res: dict = {}
    planned = {kid: {ROUND_PAD} for kid in ROUND_KERNELS}
    planned["K4"] = {SEGMENT}
    phase_kernels(args.seed, planned, res)
    build_root = os.path.join(REPO, "cassandra_tpu_torch", "build")
    os.makedirs(build_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=build_root)
    try:
        e2e = phase_e2e(args.seed, args.cells_per_run, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # 5. the kernels at every other size the main path launched
    seen = {kid: set(e2e["sizes"][name])
            for kid, name in KERNEL_NAMES.items()}
    print("shapes: the main path launched " + json.dumps(
        {kid: sorted(v) for kid, v in seen.items()}), flush=True)
    phase_kernels(args.seed, seen, res)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line(res, e2e["sizes"])))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
