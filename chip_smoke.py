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
  3. kernels  each kernel against its plain PyTorch version on the card,
              exact equality, warm times from CUDA events, at the main
              paths' planned shapes: K1 sort, K2 reconcile, K3 kept-first
              gather on a round of 491,520 cells padded to 524,288 with
              K = 13 lanes (holding every K2 mask bit); K4 META serialize
              and K5 LZ4 match scan on a 65,536-cell segment (K5 also on
              an unsorted copy, whose order check must fail; its LZ4
              blocks must equal the native encoder's; its D2H and the
              host emission are timed on their own); K6 and K7, the plane
              programs, on synthetic v3 / v2 rounds padded to 524,288 and
              786,432 (the K7 round holds partition, row and complex
              deletions, equal stamps and padding, and must give keep,
              ambiguous and shadowed rows); K9, the scan mask (eight ops)
              and fold, on 65,536 u64 keys with the edge keys; K10, vector
              search, on a 1,000,000 x 128 gaussian matrix for the three
              similarities and k = 10 and 100 (equal indices, scores
              within ANN_TOL); K8, the mesh step, on [4, 2^20]
              synthetic shards (a full and an empty shard, two full
              shards of one hot cell side by side). K1 and K8 also
              print the round sort's passes run (of the 4 (K + 3) key
              bytes; equal to sort_plan_plain's), its plan's host sync
              on an idle card, its device ms by step (torch.profiler)
              and the library call's time with its key built.
  4. e2e      the compaction paths, on input sstables in bench.py's
              `stcs` shape (4 runs, 4,096 partitions, clustering
              1..9,999, 64 B random blob values, ts in [1, 2^40), LZ4
              16 KiB): the native engine, then
              CompactionTask(engine="device") on `cuda` with
              device_compress=False (K1-K4), with the knob at its default
              (K1-K5, one K5 per full segment; on its own input of 4 runs
              of a COMPRESS_LEG_CUT-th of the cells, beside that input's
              native leg) and with device_resident=False (K6 per round),
              the mesh mode with two
              lanes on the one card (K6), and, beside its own native leg,
              device_resident=False on the same runs plus a fifth run of
              deletions (2% cell tombstones, row and partition deletions;
              K7 on every round holding a deletion). The launch counters
              are reset just before each leg and read just after; each
              device leg's output sstables must be sha256-equal to its
              input's native leg over every component, and every output
              is read back and its cell count checked. The counters also
              split the launches by size (padded round N, segment cells).
  5. read     the CQL read path: Session over StorageEngine(device=
              "cuda"). scan.events (k int, c int, v int, PRIMARY KEY
              (k, c)): 500,000 partitions (a READ_PARTITIONS_CUT-th of
              1,000,000) x 10 rows, v uniform over
              the int range, bulk-written as 4 sstables; (a) SELECT k,
              c, v ... WHERE v = ? and (b) SELECT count(*), min(v),
              max(v), sum(v) ... WHERE v < ? (1% of the cells), ALLOW
              FILTERING, with two mesh lanes and `scan_device_filter` on
              (K9 must launch, `scan.fallback` must not move), off (no
              K9 launch) and on again (the first leg reads cold caches;
              the third adds (b'), the same aggregate over 0.1% of the
              cells), then at the engine's default of no mesh lanes with
              the knob on: (a) and (b'). The counters are reset before
              each query and read after it; every query must equal a
              numpy oracle over the generated data. emb (id int, c int,
              v vector<float, 128>) with a SAI index: 1,000,000 gaussian
              rows; ORDER BY v ANN OF [...] LIMIT 10 and 100 through CQL
              (cosine) and VectorIndex.ann for dot, euclidean and
              cosine: ids equal to a float64 numpy oracle, scores within
              ANN_TOL, the oracle's k-th and (k+1)-th scores further
              apart than it. Wall ms per query and the launches are
              printed.
  6. mesh     the token-range-sharded compaction step
              (parallel/mesh.py), the counterpart of the JAX package's
              dryrun_multichip, on S shards sharing the card
              (Mesh([cuda:0] * S)): the uniform 8k case at S = 2 and 4,
              the skewed 1M round (2 x 524,288 cells, 4,096
              partitions, 40% in two) at S = 4, and phase 4's 10M-cell
              inputs read back, at S = 4 and on make_mesh(device
              count). Each case: the sharded merge equals the host
              merge (lanes, ts, payload), one sstable per non-empty
              shard reads back to its cell count, shard imbalance <=
              1.2, and the one-program step (K8 over shard_batch) gives
              the per-device path's perm and keep. The counters are
              reset before the cases and read after; then K8 is timed
              on each case's own operands.
  7. shapes   phase 3 again at every size the main paths launched that
              phase 3 did not cover (a round extended past 2^19 cells to
              its partition's end pads to 2^20; the scan mask's segment
              remainders and the fold's candidate count; K8's [S, N]).

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel: route, source, the JAX function it replaces, launches over the
main paths and per leg, max_abs_err, warm ms, plain ms, bound ms and
what bounds it, and the time of one PyTorch call that computes the same
function where there is one, at the size launched most, then the same
per launched size under "shapes", where K1 and K8 add passes,
key_bytes, sync_ms, steps and library_with_key_ms) and the card's name
and power limit.
The last line is
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
OPS_PER_S = 67e12                  # H100 SXM non-tensor rate (data sheet)
ROUND_CELLS = (1 << 19) - (1 << 15)  # CompactionTask.ROUND_CELLS_DEVICE
ROUND_PAD = 1 << 19                  # merge._bucket(ROUND_CELLS)
LANES = 13                           # int pk + int ck table
SEGMENT = 65_536                     # storage/sstable/format.py
# merge._plane_pad of a device round: 2^19, or 3 x 2^18 past it
PLANE_PADS = (1 << 19, 3 << 18)
STCS_RUNS = 4
STCS_CELLS_PER_RUN = 2_500_000       # BASELINE.json config 1: n = 10M
STCS_PARTITIONS = 4096
VALUE_BYTES = 64
# the default-configuration leg (K5) runs on its own cut input: its
# host payload scans take seconds per segment (PERF.md section 5); an
# eighth since the mesh phase joined, to keep the smoke under 600 s
COMPRESS_LEG_CUT = 8
# the read cells: scan.events (10 rows per partition) and emb
# the engine's mesh lanes (`compaction_mesh_devices`) in the read phase's
# first three legs: with none (the default, the fourth leg), Phase B
# merges each candidate partition on its own (PERF.md section 5)
READ_MESH_LANES = 2
SCAN_PARTITIONS = 1_000_000
# the read phase runs on half the partitions since the mesh phase
# joined, to keep the smoke under 600 s (printed as `reduced`)
READ_PARTITIONS_CUT = 2
SCAN_ROWS = 10
SCAN_RUNS = 4
SCAN_SELECTIVITY = 0.01
# the aggregate of the default-lanes leg: a tenth of (b)'s cells
NARROW_SELECTIVITY = 0.001
ANN_ROWS = 1_000_000
ANN_DIM = 128
ANN_KS = (10, 100)
# |kernel score - oracle score| allowed, per similarity: float32 sums of
# 128 products in another order differ by about 1e-5 (dot, euclidean,
# scores of tens) and 1e-7 (cosine, scores below 1)
ANN_TOL = {"cosine": 1e-5, "dot": 1e-3, "euclidean": 1e-3}
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


def make_lanes(seed: int, n: int, K: int = LANES,
               partitions: int = STCS_PARTITIONS) -> np.ndarray:
    """A sorted, stcs-like slice of n lane rows (u32[n, K]): partitions
    in token order, clustering 1..9,999 ascending inside each, one
    regular column; the zero lanes and the zero high bytes of the
    clustering lane make whole constant byte planes (K5's long runs)."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, partitions, n)
    ck = rng.integers(1, 10_000, n)
    order = np.lexsort((ck, part))
    part, ck = part[order].astype(np.uint64), ck[order]
    lanes = np.zeros((n, K), dtype=np.uint32)
    lanes[:, 0] = (part * np.uint64(1_000_003)).astype(np.uint32)
    for k in range(1, 4):
        lanes[:, k] = ((part * np.uint64(2654435761 + 40503 * k))
                       >> np.uint64(7)).astype(np.uint32)
    lanes[:, 4] = ck
    lanes[:, K - 3] = 8
    return lanes


def make_scan_segment(seed: int, n: int) -> tuple:
    """K5's inputs for one full segment of n cells: the META block of
    make_segment's columns (host build_meta_block, which K4 equals) and
    make_lanes' sorted lane rows."""
    from cassandra_tpu_torch.storage.sstable.writer import build_meta_block
    ts, c = make_segment(seed, n)
    meta = build_meta_block(ts, c[2], c[3], c[4], c[5].astype("<u4"),
                            c[6].astype("<u4"))
    return np.asarray(meta, dtype=np.uint8), make_lanes(seed, n)


def make_fast_round(seed: int, n: int, N: int, k: int = 4,
                    partitions: int = STCS_PARTITIONS) -> tuple:
    """A v3 (K6) round of n cells padded to N, as the host packer lays it
    out: planes rank u16 (padding 0xFFFF), a u16 clustering lane, a u8
    path lane and one u32 truncated-stamp plane, then the int32 offsets
    of k runs. Few clustering values and tied stamps make duplicate
    identities (ambiguous rows). Returns (buf u8, cfg)."""
    rng = np.random.default_rng(seed)

    def plane(vals, dtype, fill):
        a = np.full(N, fill, dtype=dtype)
        a[:n] = vals
        return a

    q = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ties = rng.random(n) < 0.3
    q[ties] = rng.integers(0, 4, int(ties.sum()))
    parts = [plane(rng.integers(0, partitions, n), np.uint16, 0xFFFF),
             plane(rng.integers(0, 64, n), np.uint16, 0),
             plane(rng.integers(0, 2, n), np.uint8, 0),
             plane(q.astype(np.uint32), np.uint32, 0)]
    cuts = np.sort(rng.integers(0, n + 1, k - 1))
    offs = np.concatenate([[0], cuts, [n]]).astype("<i4")
    buf = np.concatenate([p.view(np.uint8) for p in parts]
                         + [offs.view(np.uint8)])
    return buf, ("uint16", ("uint16", "uint8"), ("uint32",), k)


def make_v2_round(seed: int, n: int, N: int,
                  partitions: int = STCS_PARTITIONS) -> tuple:
    """A v2 (K7) round of n cells padded to N, as the host packer lays it
    out: rank u32, a row lane and the column lane (0 = partition
    deletion, 1 = row deletion, else a regular column), ts_lo u32 and
    ts_mid u16 with equal-stamp duplicates, complex-deletion flags, and
    padding rows (rank and lanes 0xFFFFFFFF, stamps 0). Returns
    (planes, cfg)."""
    rng = np.random.default_rng(seed)

    def plane(vals, dtype, fill):
        a = np.full(N, fill, dtype=dtype)
        a[:n] = vals
        return a

    col = rng.choice(np.array([0, 1, 8, 9], np.uint32), n,
                     p=[0.02, 0.03, 0.75, 0.20])
    row = rng.integers(0, 16, n).astype(np.uint32)
    row[col == 0] = 0                 # a partition deletion has no row
    ts = rng.integers(0, 1 << 20, n)
    ties = rng.random(n) < 0.3
    ts[ties] = rng.integers(1000, 1004, int(ties.sum()))
    planes = {
        "rank": plane(rng.integers(0, partitions, n), np.uint32, 0xFFFFFFFF),
        "lane0": plane(row, np.uint32, 0xFFFFFFFF),
        "lane1": plane(col, np.uint32, 0xFFFFFFFF),
        "ts_lo": plane(ts, np.uint32, 0),
        "ts_mid": plane(rng.integers(0, 2, n), np.uint16, 0),
        "cdel": plane(rng.random(n) < 0.02, np.uint8, 0),
        "hi_const": np.uint32(0x8000), "col_const": np.uint32(0)}
    return planes, (1, 1, 0, False, True)


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call without the host's cost of issuing
    it: `calls` calls captured in one CUDA graph, the graph replayed
    `reps` times between CUDA events. For kernels whose wrapper takes
    longer to issue a launch than the card takes to run it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(nbytes: float, ops: float = 0.0) -> float:
    """The least time for the work: bytes moved once at the memory rate
    or operations at the non-tensor rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


def bound_by(r: dict) -> str:
    return ("operations" if r.get("ops", 0.0) / OPS_PER_S
            > r["bytes"] / HBM_BYTES_PER_S else "bytes")


def host_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds per call (fn synchronizes itself)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def lex_rank_key(cols: list) -> torch.Tensor:
    """An int64 key whose stable sort equals the LSD chain over `cols`
    (most significant first): the tuple's dense lexicographic rank."""
    return torch.unique(torch.stack(cols, dim=1), dim=0,
                        return_inverse=True)[1]


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


SORT_STEPS = ("plan_hist", "plan_bases", "split_pack", "round_pass",
              "scan_tiles", "add_back", "rec_bounds", "rec_final",
              "shard_stats", "sum_stats", "Memcpy", "Memset")


def sort_breakdown(fn) -> dict | None:
    """Device ms of one call of fn (a round sort or the mesh step) by
    kernel, from torch.profiler: {step: [launches, ms]} over SORT_STEPS
    (K2's kernels are rec_*; the scans serve the sort's split and K2);
    None when the profiler saw no device time or missed the plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        step = next((k for k in SORT_STEPS if k in e.key), "other")
        c = out.setdefault(step, [0, 0.0])
        c[0] += e.count
        c[1] += e.self_device_time_total / 1e3
    return out if "plan_hist" in out else None


def _timed_sort(name: str, fn) -> tuple:
    """One call of fn after the card is idle: (its result, the passes it
    ran, its plan's host sync ms, which then holds only the plan)."""
    from cassandra_tpu_torch.ops import cuda_lib
    torch.cuda.synchronize()
    out = fn()
    run = cuda_lib.last_sort(name)
    return out, run["passes"], run["sync_ms"]


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
    # about one identity per cell, so a small round holds duplicates
    # (the ambiguous bit) as the planned round does
    parts = min(STCS_PARTITIONS, max(8, n // 64))
    ops = dm.operands_to_device(make_round(seed, n, N, K, parts),
                                torch.device(DEVICE))

    # K1 sort
    perm, passes, sync_ms = _timed_sort(
        "merge.sort_perm", lambda: dm.device_sort_perm(ops))
    perm_p = dm.sort_perm_plain(ops)
    torch.cuda.synchronize()
    err = max_abs_err(perm, perm_p)
    need(err == 0, f"K1 sort at N={N}: kernel != plain (max abs err {err})")
    plan = dm.sort_plan_plain(ops)
    need(passes == plan["passes"], f"K1 at N={N}: {passes} passes run, "
                                   f"the plan has {plan['passes']}")
    lib_ms = lib_key_ms = None
    key = packed_sort_key(ops)
    if key is not None:
        lib_perm = torch.sort(key, stable=True).indices
        need(bool((lib_perm.to(torch.int32) == perm).all()),
             "K1: torch.sort of the packed key disagrees")
        lib_ms = cuda_ms(lambda: torch.sort(key, stable=True))
        lib_key_ms = cuda_ms(
            lambda: torch.sort(packed_sort_key(ops), stable=True), reps=3)
    ms = cuda_ms(lambda: dm.device_sort_perm(ops))
    _entry(res, "K1", "merge.sort_perm", N, err=err, ms=ms,
           plain_ms=cuda_ms(lambda: dm.sort_perm_plain(ops), reps=3),
           library_ms=lib_ms, library_with_key_ms=lib_key_ms,
           passes=passes, key_bytes=plan["key_bytes"], sync_ms=sync_ms,
           steps=sort_breakdown(lambda: dm.device_sort_perm(ops)),
           bytes=N * ((K + 3) * 4 + 4))

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


def check_scan(seed: int, seg_n: int, res: dict) -> None:
    """K5 against its plain version on one full segment (make_segment's
    META block, a sorted stcs-like lane slice) and on an unsorted copy,
    exact equality; the emitted LZ4 blocks against the native encoder;
    the D2H of the results and the host emission timed on their own."""
    from cassandra_tpu_torch.ops import device_compress as dc
    from cassandra_tpu_torch.ops.codec import get_compressor
    from cassandra_tpu_torch.ops.device_write import _pull

    dev = torch.device(DEVICE)
    meta_np, lanes_np = make_scan_segment(seed + 2, seg_n)
    meta = torch.from_numpy(meta_np).to(dev)
    err = 0
    for rows, ok in ((lanes_np, True), (lanes_np[
            [0, seg_n // 2] + list(range(2, seg_n // 2)) + [1]
            + list(range(seg_n // 2 + 1, seg_n))], False)):
        lanes = torch.from_numpy(np.ascontiguousarray(rows).view(
            np.int32)).to(dev)
        out = dc.segment_scan(meta, lanes)
        ref = dc.segment_scan_plain(meta, lanes)
        torch.cuda.synchronize()
        err = max(err, *(max_abs_err(a, b) for a, b in zip(out[:5],
                                                          ref[:5])))
        need(bool(out[5]) is ok and bool(ref[5]) is ok,
             f"K5 order check: want order_ok={ok}")
    need(err == 0, f"K5 segment_scan at n={seg_n}: kernel != plain "
                   f"(max abs err {err})")
    lanes = torch.from_numpy(lanes_np.view(np.int32)).to(dev)
    out = dc.segment_scan(meta, lanes)
    pulled = lambda: _pull([out[5].reshape(1), *out[:5]])  # noqa: E731
    _ok, planes, mbl, mbd, lbl, lbd = pulled()
    longest = int(lbl.max())
    need(longest >= 4 * seg_n, f"K5: the constant planes gave no long run "
                               f"(longest {longest})")
    t0 = time.perf_counter()
    blocks = [dc.emit_block(b, bl, bd, b.size + b.size // 255 + 16)
              for b, bl, bd in ((meta_np, mbl, mbd), (planes, lbl, lbd))]
    emit_ms = (time.perf_counter() - t0) * 1e3
    native = get_compressor("LZ4Compressor")
    for blk, got in zip((meta_np, planes), blocks):
        need(got == native.compress(blk.tobytes()),
             "K5: emitted LZ4 block != the native encoder's")
    n_scan = meta_np.size + planes.size
    _entry(res, "K5", "write.segment_scan", seg_n, err=err,
           ms=cuda_ms(lambda: dc.segment_scan(meta, lanes), reps=5),
           plain_ms=cuda_ms(lambda: dc.segment_scan_plain(meta, lanes),
                            reps=2, warm=1),
           library_ms=None, d2h_ms=host_ms(pulled), emit_ms=emit_ms,
           longest_run=longest,
           sizes_lz4=[len(b) for b in blocks],
           # read META + lanes, write planes + four int32 arrays; four
           # operations per (position, distance): compare, min, run, max
           bytes=meta_np.size + 2 * planes.size + 8 * n_scan,
           ops=4 * len(dc.DISTANCES) * n_scan)


def plane_cells_for(N: int) -> int:
    """Live cells of the synthetic plane rounds checked at padded N."""
    return N - N // 16


def check_planes(seed: int, N: int, res: dict) -> None:
    """K6 and K7 against their plain versions on synthetic rounds padded
    to N, exact equality; the K7 round must hold keep, ambiguous and
    shadowed rows."""
    from cassandra_tpu_torch.ops import merge as dm

    dev = torch.device(DEVICE)
    n = plane_cells_for(N)
    log_n = int(np.ceil(np.log2(N)))
    buf, cfg = make_fast_round(seed + 3, n, N)
    b = dm.planes_to_device(buf, dev)
    out = dm.plane_program_fast(b, cfg)
    ref = dm.plane_program_fast_plain(b, cfg)
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    need(err == 0, f"K6 plane_fast at N={N}: kernel != plain "
                   f"(max abs err {err})")
    bits = out[:n].to(torch.int64)
    masks = {"keep": int(((bits >> 4) & 1).sum()),
             "ambiguous": int(((bits >> 5) & 1).sum())}
    for m, c in masks.items():
        need(c > 0, f"the K6 round at N={N} has no {m} row")
    w = [(0, 2), (2 * N, 2), (4 * N, 1), (5 * N, 4)]
    cols = [torch.from_numpy(buf[o:o + N * k].view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[k]).astype(np.int64))
        .to(dev) for o, k in w]
    key = lex_rank_key(cols)
    _entry(res, "K6", "merge.plane_fast", N, err=err, masks=masks,
           ms=cuda_ms(lambda: dm.plane_program_fast(b, cfg)),
           plain_ms=cuda_ms(lambda: dm.plane_program_fast_plain(b, cfg),
                            reps=3),
           library_ms=cuda_ms(lambda: torch.sort(key, stable=True)),
           bytes=buf.size + N, ops=N * log_n * (1 + 2 + 1))

    planes, cfg2 = make_v2_round(seed + 4, n, N)
    p = dm.planes_to_device(planes, dev)
    out2 = dm.plane_program(p, cfg2)
    ref2 = dm.plane_program_plain(p, cfg2)
    torch.cuda.synchronize()
    err2 = max_abs_err(out2, ref2)
    need(err2 == 0, f"K7 plane_v2 at N={N}: kernel != plain "
                    f"(max abs err {err2})")
    m = out2[:n].to(torch.int64) >> 24
    masks2 = {"keep": int((m & 1).sum()), "ambiguous": int((m >> 1 & 1).sum()),
              "shadowed": int((m >> 3 & 1).sum())}
    print(f"  plane rounds: {n} cells padded to {N}: K6 {masks}, "
          f"K7 {masks2}", flush=True)
    for k, c in masks2.items():
        need(c > 0, f"the K7 round at N={N} has no {k} row")
    i64 = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)  # noqa
    key2 = lex_rank_key([i64(planes["rank"]), i64(planes["lane0"]),
                         i64(planes["lane1"]), 0xFFFF - i64(planes["ts_mid"]),
                         0xFFFFFFFF - i64(planes["ts_lo"])])
    need(bool((torch.sort(key2, stable=True).indices.to(torch.int32)
               == (out2 & 0xFFFFFF)).all()),
         "K7: torch.sort of the packed key disagrees")
    _entry(res, "K7", "merge.plane_v2", N, err=err2, masks=masks2,
           ms=cuda_ms(lambda: dm.plane_program(p, cfg2)),
           plain_ms=cuda_ms(lambda: dm.plane_program_plain(p, cfg2),
                            reps=3),
           library_ms=cuda_ms(lambda: torch.sort(key2, stable=True)),
           bytes=sum(np.asarray(v).nbytes for v in planes.values()) + 4 * N,
           ops=N * log_n * 5)


def scan_keys(seed: int, n: int) -> np.ndarray:
    """n u64 scan keys over the whole range, from the seed, with the
    edge keys 0, 2^63 - 1, 2^63 and 2^64 - 1 first."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    edges = np.array([0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)
    keys[:min(n, 4)] = edges[:min(n, 4)]
    return keys


def check_scanmask(seed: int, n: int, res: dict) -> None:
    """K9's mask against its plain version on n keys for the eight ops
    (IN with eight keys), exact; warm times per op. The numbers kept
    at the top are the eq op's, which one torch call also computes."""
    from cassandra_tpu_torch.ops import device_scan as ds

    dev = torch.device(DEVICE)
    keys = scan_keys(seed + 6, n)
    kc = ds.keys_tensor(keys, dev)
    q1 = keys[[n // 3]] if n else np.zeros(1, np.uint64)
    qin = keys[::max(1, n // 8)][:8]
    err, ops_ms, hits = 0, {}, {}
    for op in ds.SCAN_OPS:
        qk = qin if op == "in" else (q1[:0] if op == "all" else q1)
        m = ds.scan_mask(kc, op, qk)
        mp = ds.scan_mask_plain(kc, op, qk)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(m, mp))
        hits[op] = int(m.sum())
        ops_ms[op] = cuda_ms(lambda: ds.scan_mask(kc, op, qk))
    need(err == 0, f"K9 scan_mask at n={n}: kernel != plain")
    q_i64 = int(q1.view(np.int64)[0])
    need(torch.equal(ds.scan_mask(kc, "eq", q1), kc == q_i64),
         "K9 scan_mask: torch.eq disagrees")
    # the wrapper without its profiling hook (which reads events, and no
    # event may be read while a graph is captured)
    raw = ds.scan_mask.__wrapped__
    _entry(res, "K9", "scan.mask", n, err=err, ms=ops_ms["eq"],
           plain_ms=cuda_ms(lambda: ds.scan_mask_plain(kc, "eq", q1),
                            reps=3),
           library_ms=cuda_ms(lambda: torch.eq(kc, q_i64)),
           graph_ms=graph_ms(lambda: raw(kc, "eq", q1)),
           library_graph_ms=graph_ms(lambda: torch.eq(kc, q_i64)),
           ops_ms=ops_ms, hits=hits, bytes=9 * n)


def check_scanfold(seed: int, n: int, res: dict) -> None:
    """K9's fold against its plain version on n keys under a 1% mask
    (the aggregate's), an empty and a full mask, exact."""
    from cassandra_tpu_torch.ops import device_scan as ds

    dev = torch.device(DEVICE)
    keys = scan_keys(seed + 7, n)
    kc = ds.keys_tensor(keys, dev)
    lt = ds.scan_mask(kc, "lt", np.array([(1 << 64) // 100], np.uint64))
    err = 0
    for mask in (lt, torch.zeros_like(lt), torch.ones_like(lt)):
        got = ds.scan_fold(kc, mask)
        want = ds.scan_fold_plain(kc, mask)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
    need(err == 0, f"K9 scan_fold at n={n}: kernel != plain")
    raw = ds.scan_fold.__wrapped__
    _entry(res, "K9f", "scan.fold", n, err=err,
           ms=cuda_ms(lambda: ds.scan_fold(kc, lt)),
           graph_ms=graph_ms(lambda: raw(kc, lt)),
           plain_ms=cuda_ms(lambda: ds.scan_fold_plain(kc, lt), reps=3),
           library_ms=None, selected=int(lt.sum()), bytes=9 * n + 24)


def ann_bytes(n: int, d: int, k: int) -> int:
    """K10 reads the matrix and the query once, writes k scores and
    indices."""
    return 4 * n * d + 4 * d + 8 * k


def ann_ops(n: int, d: int, sim: str) -> int:
    """Floating-point operations: a multiply and an add per element
    (cosine another two for the norm; euclidean a subtract, multiply
    and add)."""
    return {"cosine": 4, "dot": 2, "euclidean": 3}[sim] * n * d


def check_ann(seed: int, n: int, res: dict, d: int = ANN_DIM) -> None:
    """K10 against its plain version on an n x d gaussian matrix on the
    card for the three similarities and k = 10 and 100: equal indices,
    scores within ANN_TOL, and the plain version's k-th and (k+1)-th
    scores further apart than the tolerance (else the top k is not
    decided at float32 precision). The numbers kept at the top are
    dot at k = 10, which torch.topk(m @ q, k) also computes."""
    from cassandra_tpu_torch.ops import ann

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    m = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(d, generator=g, device=dev)
    qn = q / q.norm().clamp_min(1e-9)
    cases, err = {}, 0.0
    for sim in ann.SIMILARITIES:
        qq = qn if sim == "cosine" else q
        full = ann.scores_plain(m, qq, sim)
        srt = torch.sort(full, descending=True).values
        for k in ANN_KS:
            s, i = ann.ann_topk(m, qq, k, sim)
            sp, ip = ann.ann_topk_plain(m, qq, k, sim)
            torch.cuda.synchronize()
            gap = float(srt[k - 1] - srt[k])
            need(gap > ANN_TOL[sim], f"K10 {sim} k={k}: the k-th and "
                 f"(k+1)-th scores are {gap} apart, within the tolerance")
            need(torch.equal(i, ip), f"K10 {sim} k={k}: kernel indices "
                                     "!= plain")
            e = float((s - sp).abs().max())
            need(e <= ANN_TOL[sim], f"K10 {sim} k={k}: scores differ by "
                                    f"{e} > {ANN_TOL[sim]}")
            err = max(err, e)
            lib = None
            if sim == "dot":
                li = torch.topk(m @ qq, k).indices.to(torch.int32)
                need(torch.equal(li, i), "K10: torch.topk disagrees")
                lib = cuda_ms(lambda: torch.topk(m @ qq, k), reps=5)
            cases[f"{sim}/k={k}"] = {
                "ms": cuda_ms(lambda: ann.ann_topk(m, qq, k, sim), reps=5),
                "plain_ms": cuda_ms(
                    lambda: ann.ann_topk_plain(m, qq, k, sim), reps=2),
                "library_ms": lib, "max_abs_err": e,
                "bound_ms": bound_ms(ann_bytes(n, d, k), ann_ops(n, d, sim)),
                "kth_gap": gap}
    top = cases[f"dot/k={ANN_KS[0]}"]
    _entry(res, "K10", "index.ann", n, err=err, ms=top["ms"],
           plain_ms=top["plain_ms"], library_ms=top["library_ms"],
           cases=cases, bytes=ann_bytes(n, d, ANN_KS[0]),
           ops=ann_ops(n, d, "dot"))


def mesh_shard_kinds(S: int) -> list:
    """The shards of a synthetic K8 step: a full shard (count == N) and
    an empty one at every S > 1, and from S = 3 on two full shards of
    one hot cell each (equal lanes across the shard edge, with no pad
    row between them) before the empty, full and partial ones."""
    if S == 1:
        return ["full"]
    if S == 2:
        return ["full", "empty"]
    head = ["hot", "hot", "empty", "full"]
    return (head + ["partial"] * S)[:S]


def make_mesh_operands(seed: int, S: int, N: int) -> dict:
    """[S, N] operands of the mesh step (shard_batch's layout, numpy):
    each shard a make_round of its kind's cell count padded to N."""
    shards = []
    for s, kind in enumerate(mesh_shard_kinds(S)):
        n = {"empty": 0, "partial": N // 2 + 7 * s + 1}.get(kind, N)
        r = make_round(seed + (0 if kind == "hot" else s), n, N)
        if kind == "hot":
            r["lanes"][:] = r["lanes"][0]
        shards.append(r)
    cols = ("lanes", "valid", "ts_h", "ts_l", "death", "cdel", "ldt",
            "expiring", "purge_h", "purge_l")
    ops = {k: np.stack([r[k] for r in shards]) for k in cols}
    ops["now"], ops["gc_before"] = shards[0]["now"], shards[0]["gc_before"]
    return ops


def mesh_step_bytes(S: int, N: int, K: int = LANES) -> int:
    """K8's bytes moved once: the operands read (lanes, nine u32/i32
    columns) and perm and packed written, plus the stats."""
    return S * N * (4 * K + 9 * 4 + 4 + 1) + 16 * (S + 1)


def check_mesh(seed: int, size: tuple, res: dict) -> None:
    """K8 against its plain version on a synthetic [S, N] step with a
    full and an empty shard; exact perm, packed and stats; warm times;
    the library time of torch.sort(key, dim=1, stable=True) over a
    packed [S, N] rank key."""
    from cassandra_tpu_torch.ops import merge as dm
    from cassandra_tpu_torch.parallel import mesh as pm

    S, N = size
    ops = dm.operands_to_device(make_mesh_operands(seed, S, N),
                                torch.device(DEVICE))
    (perm, packed, stats), passes, sync_ms = _timed_sort(
        "mesh.sharded_step", lambda: pm.sharded_step(ops))
    perm_p, packed_p, stats_p = pm.sharded_step_plain(ops)
    torch.cuda.synchronize()
    err = max(max_abs_err(perm, perm_p), max_abs_err(packed, packed_p),
              max_abs_err(stats, stats_p))
    need(err == 0, f"K8 mesh step at {size}: kernel != plain "
                   f"(max abs err {err})")
    kept = int((packed & 1).sum())
    live = int((ops["valid"] == 0).sum())
    need(stats.tolist() == [kept, live - kept],
         f"K8 at {size}: stats {stats.tolist()} != ({kept}, "
         f"{live - kept})")
    plan = dm.sort_plan_plain(ops)
    need(passes == plan["passes"], f"K8 at {size}: {passes} passes run, "
                                   f"the plan has {plan['passes']}")

    def flat_key():
        return packed_sort_key({
            "lanes": ops["lanes"].reshape(S * N, -1),
            **{k: ops[k].reshape(-1) for k in ("valid", "ts_h", "ts_l")}})

    lib_ms = lib_key_ms = None
    key = flat_key()
    if key is not None:
        key = key.view(S, N)
        lib_perm = torch.sort(key, dim=1, stable=True).indices
        need(bool((lib_perm.to(torch.int32) == perm).all()),
             "K8: torch.sort of the packed key disagrees")
        lib_ms = cuda_ms(lambda: torch.sort(key, dim=1, stable=True),
                         reps=3)
        lib_key_ms = cuda_ms(lambda: torch.sort(
            flat_key().view(S, N), dim=1, stable=True), reps=3)
    print(f"  mesh step {S} x {N}: shards "
          f"{mesh_shard_kinds(S)}, kept {kept}, dropped {live - kept}",
          flush=True)
    _entry(res, "K8", "mesh.sharded_step", size, err=err,
           ms=cuda_ms(lambda: pm.sharded_step(ops), reps=3),
           plain_ms=cuda_ms(lambda: pm.sharded_step_plain(ops), reps=1,
                            warm=1),
           library_ms=lib_ms, library_with_key_ms=lib_key_ms,
           passes=passes, key_bytes=plan["key_bytes"], sync_ms=sync_ms,
           steps=sort_breakdown(lambda: pm.sharded_step(ops)),
           bytes=mesh_step_bytes(S, N))


ROUND_KERNELS = ("K1", "K2", "K3")
PLANE_KERNELS = ("K6", "K7")
KERNEL_NAMES = {"K1": "merge.sort_perm", "K2": "merge.reconcile",
                "K3": "write.compact_gather", "K4": "write.meta_block",
                "K5": "write.segment_scan", "K6": "merge.plane_fast",
                "K7": "merge.plane_v2", "K8": "mesh.sharded_step",
                "K9": "scan.mask", "K9f": "scan.fold", "K10": "index.ann"}


def kid_order(kid: str) -> tuple:
    """K1 < K2 < ... < K9 < K9f < K10."""
    return (int(kid[1:].rstrip("f")), kid)


def print_checks(res: dict, sizes: dict) -> None:
    for kid in sorted(res, key=kid_order):
        for size in sorted(sizes.get(kid, ())):
            r = res[kid]["shapes"][size]
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"  {kid} {res[kid]['name']} at {size}: match (max abs "
                  f"err {r['err']}), kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
                  f"{bound_ms(r['bytes'], r.get('ops', 0)):.4f} ms "
                  f"({bound_by(r)})", flush=True)
            if "passes" in r:
                lk = r["library_with_key_ms"]
                print(f"  {kid} sort passes run {r['passes']} of "
                      f"{r['key_bytes']}, plan sync {r['sync_ms']:.4f} ms "
                      "(an idle card's), library with its key built "
                      + ("n/a" if lk is None else f"{lk:.4f} ms")
                      + "; device [launches, ms] by step: "
                      + ("not measured" if r["steps"] is None else
                         json.dumps({k: [c, round(t, 4)] for k, (c, t)
                                     in sorted(r["steps"].items())})),
                      flush=True)
            if kid == "K5":
                print(f"  K5 D2H of planes + scans (pinned) "
                      f"{r['d2h_ms']:.4f} ms, host emit_block of META + "
                      f"planes {r['emit_ms']:.4f} ms, longest run "
                      f"{r['longest_run']}, LZ4 bytes {r['sizes_lz4']}",
                      flush=True)
            if kid == "K9":
                print("  K9 kernel ms per op: " + json.dumps(
                    {k: round(v, 4) for k, v in r["ops_ms"].items()})
                    + f"; hits {r['hits']}", flush=True)
            if "graph_ms" in r:
                lib = r.get("library_graph_ms")
                print(f"  {kid} device ms per launch in a CUDA graph (no "
                      f"host issue cost): kernel {r['graph_ms']:.4f}"
                      + ("" if lib is None else f", library {lib:.4f}"),
                      flush=True)
            if kid == "K10":
                for case, c in r["cases"].items():
                    lib = ("n/a" if c["library_ms"] is None
                           else f"{c['library_ms']:.4f}")
                    print(f"  K10 {case}: kernel {c['ms']:.4f} ms, plain "
                          f"{c['plain_ms']:.4f} ms, library {lib} ms, "
                          f"bound {c['bound_ms']:.4f} ms, max abs err "
                          f"{c['max_abs_err']:.3g}, k-th gap "
                          f"{c['kth_gap']:.4g}", flush=True)


def phase_kernels(seed: int, sizes: dict, res: dict) -> None:
    """Check every (kernel, size) of `sizes` ({"K1": {N, ...}, ...})
    not yet in `res`. K1-K3 share a round, so one size checks all three;
    K6 and K7 are checked together."""
    todo = {kid: {s for s in sizes.get(kid, ())
                  if s not in res.get(kid, {}).get("shapes", {})}
            for kid in KERNEL_NAMES}
    for N in sorted(set().union(*(todo[k] for k in ROUND_KERNELS))):
        check_round(seed, N, res)
    for seg_n in sorted(todo["K4"]):
        check_segment(seed, seg_n, res)
    for seg_n in sorted(todo["K5"]):
        check_scan(seed, seg_n, res)
    for N in sorted(set().union(*(todo[k] for k in PLANE_KERNELS))):
        check_planes(seed, N, res)
    for size in sorted(todo["K8"]):
        check_mesh(seed, size, res)
    for n in sorted(todo["K9"]):
        check_scanmask(seed, n, res)
    for n in sorted(todo["K9f"]):
        check_scanfold(seed, n, res)
    for n in sorted(todo["K10"]):
        check_ann(seed, n, res)
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
    from cassandra_tpu_torch.storage.sstable.compress_pool import get_pool
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
        # the compress pool writes the same bytes as a serial writer
        w = SSTableWriter(Descriptor(directory, gen), table,
                          estimated_partitions=STCS_PARTITIONS,
                          threaded_io=True, compress_pool=get_pool())
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


def _pack_counts() -> dict:
    """The writer's device_pack counters: blocks tried and compressed,
    per stream (meta, lanes, payload)."""
    from cassandra_tpu_torch.service.metrics import GLOBAL
    pre = "compaction.device_pack."
    return {k[len(pre):]: v for k, v in GLOBAL.snapshot().items()
            if k.startswith(pre)}


def compact_leg(root: str, table, **task_kw) -> dict:
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    cfs = ColumnFamilyStore(table, root, commitlog=None)
    cfs.reload_sstables()
    task = CompactionTask(cfs, cfs.tracker.view(), **task_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dev0 = _kernel_device_s()
    c0 = _pack_counts()
    t0 = time.perf_counter()
    stats = task.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = _pack_counts()
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
            "kernel_s": kernel_s,
            "pack_counts": {k: v - c0.get(k, 0) for k, v in c1.items()
                            if v - c0.get(k, 0)}}


def build_deletion_run(directory: str, table, seed: int, gen: int,
                       cells: int) -> None:
    """A run of deletions over the stcs partitions: `cells` cell
    tombstones, a tenth as many row deletions and a few partition
    deletions, stamped across the inputs' ts range (so they shadow some
    cells and not others), written as generation `gen`."""
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)

    rng = np.random.default_rng(seed + 5)
    col = table.columns["v"].column_id
    ldt = int(time.time())
    pk = [table.serialize_partition_key([p])
          for p in range(STCS_PARTITIONS)]
    b = cb.CellBatchBuilder(table)
    for p, c, ts in zip(rng.integers(0, STCS_PARTITIONS, cells).tolist(),
                        rng.integers(1, 10_000, cells).tolist(),
                        rng.integers(1, 1 << 40, cells).tolist()):
        b.add_tombstone(pk[p], table.serialize_clustering([c]), col, ts, ldt)
    for p, c, ts in zip(rng.integers(0, STCS_PARTITIONS,
                                     cells // 10).tolist(),
                        rng.integers(1, 10_000, cells // 10).tolist(),
                        rng.integers(1, 1 << 40, cells // 10).tolist()):
        b.add_row_deletion(pk[p], table.serialize_clustering([c]), ts, ldt)
    for p in rng.choice(STCS_PARTITIONS, 16, replace=False).tolist():
        b.add_partition_deletion(pk[p], int(rng.integers(1, 1 << 40)), ldt)
    w = SSTableWriter(Descriptor(directory, gen), table,
                      estimated_partitions=STCS_PARTITIONS)
    w.append(cb.merge_sorted([b.seal()]))
    w.finish()


class RoundLog:
    """Records, per non-resident round, whether it held a deletion and
    which program `merge.submit_merge` chose (fast = K6, v2 = K7)."""

    def __init__(self):
        from cassandra_tpu_torch.ops import merge as dm
        from cassandra_tpu_torch.storage.cellbatch import DEATH_FLAGS
        self.rounds: list = []
        self._dm, self._orig = dm, dm.submit_merge

        def submit(batches, *a, **kw):
            h = self._orig(batches, *a, **kw)
            dead = any(bool((x.flags & DEATH_FLAGS).any()) for x in batches)
            self.rounds.append((dead, h.mode))
            return h

        dm.submit_merge = submit

    def close(self) -> None:
        self._dm.submit_merge = self._orig


# leg: (name, inputs, task options, kernels that must launch, kernels
# that must not). "stcs" is the 4-run input, "stcs+del" that plus a run
# of deletions, "stcs-cut" the 4-run input at a COMPRESS_LEG_CUT-th of
# the cells. Every device leg is sha256-compared with its input's
# native leg.
LEGS = (
    ("native", "stcs", {"engine": "native"}, (), ()),
    ("device", "stcs", {"engine": "device", "device_compress": False},
     ("K1", "K2", "K3", "K4"), ("K5", "K6", "K7")),
    ("native", "stcs-cut", {"engine": "native"}, (), ()),
    ("device-compress", "stcs-cut", {"engine": "device"},
     ("K1", "K2", "K3", "K4", "K5"), ("K6", "K7")),
    ("non-resident", "stcs", {"engine": "device", "device_resident": False},
     ("K6",), ("K1", "K4", "K5", "K7")),
    ("mesh2", "stcs", {"engine": "device", "mesh_devices": 2},
     ("K6",), ("K1", "K4", "K5", "K7")),
    ("native", "stcs+del", {"engine": "native"}, (), ()),
    ("non-resident", "stcs+del", {"engine": "device",
                                  "device_resident": False},
     ("K7",), ("K1", "K4", "K5")),
)


def print_leg(label: str, s: dict) -> None:
    mib = s["stats"]["bytes_read"] / 2**20
    print(f"  {label}: {s['stats']['cells_read']} -> "
          f"{s['stats']['cells_written']} cells, wall {s['wall']:.3f} s, "
          f"{mib / s['wall']:.2f} MiB/s, peak device memory "
          f"{s['peak'] / 2**20:.1f} MiB", flush=True)
    prof = s["profile"]
    print("    phases (s, summed over threads): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(prof.items())}))
    if "scan_d2h" in prof or "device_pack" in prof:
        print(f"    K5 wait + D2H {prof.get('scan_d2h', 0.0):.4f} s; "
              f"device_pack {prof.get('device_pack', 0.0):.4f} s = LZ4 "
              f"emission {prof.get('device_pack.emit', 0.0):.4f} s + "
              f"host payload scans "
              f"{prof.get('device_pack.payload_scan', 0.0):.4f} s "
              f"(+ the rest)", flush=True)
        c = s["pack_counts"]
        print("    blocks tried / compressed per stream: " + ", ".join(
            f"{b} {c.get('tried.' + b, 0)} / {c.get('compressed.' + b, 0)}"
            for b in ("meta", "lanes", "payload")), flush=True)
    busy = sum(s["kernel_s"].values())
    print(f"    kernel device time {busy:.4f} s = "
          f"{100 * busy / s['wall']:.2f}% of the wall: "
          + json.dumps({k: round(v, 5)
                        for k, v in sorted(s["kernel_s"].items())}),
          flush=True)
    if s.get("launches"):
        print(f"    launches: {s['launches']}; by size: {s['sizes']}",
              flush=True)
    if s.get("passes"):
        print("    round sort passes run: " + ", ".join(
            f"{k} {p} over {s['launches'][k]} launches"
            for k, p in s["passes"].items()), flush=True)


def phase_e2e(seed: int, cells_per_run: int, work: str) -> dict:
    """Every leg of LEGS on fresh copies of its inputs; launch counters
    reset just before each device leg and read just after."""
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    if cells_per_run != STCS_CELLS_PER_RUN:
        print(json.dumps({"reduced": {
            "cells_per_run": cells_per_run,
            "published": STCS_CELLS_PER_RUN, "runs": STCS_RUNS}}))
    table = stcs_table()
    inputs = {"stcs": os.path.join(work, "stcs")}
    cfs = ColumnFamilyStore(table, inputs["stcs"], commitlog=None)
    t0 = time.perf_counter()
    build_stcs_inputs(cfs.directory, table, seed, cells_per_run)
    print(f"e2e: built stcs, {STCS_RUNS} x {cells_per_run} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    inputs["stcs-cut"] = os.path.join(work, "stcs-cut")
    ccfs = ColumnFamilyStore(table, inputs["stcs-cut"], commitlog=None)
    t0 = time.perf_counter()
    cut = cells_per_run // COMPRESS_LEG_CUT
    build_stcs_inputs(ccfs.directory, table, seed + 1, cut)
    print(json.dumps({"reduced": {
        "leg": "device-compress", "cells_per_run": cut,
        "published": STCS_CELLS_PER_RUN, "runs": STCS_RUNS}}))
    print(f"e2e: built stcs-cut, {STCS_RUNS} x {cut} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    inputs["stcs+del"] = os.path.join(work, "stcs+del")
    shutil.copytree(inputs["stcs"], inputs["stcs+del"])
    dcfs = ColumnFamilyStore(table, inputs["stcs+del"], commitlog=None)
    t0 = time.perf_counter()
    n_del = STCS_RUNS * cells_per_run // 50
    build_deletion_run(dcfs.directory, table, seed, STCS_RUNS + 1, n_del)
    print(f"e2e: built a deletion run ({n_del} cell tombstones, "
          f"{n_del // 10} row and 16 partition deletions) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    ids = {name: kid for kid, name in KERNEL_NAMES.items()}
    legs, native = [], {}
    for i, (name, src, kw, must, must_not) in enumerate(LEGS):
        label = f"{name} [{src}]"
        # a directory of its own: the chunk cache keys on (directory,
        # generation, segment), and a reused path would serve an earlier
        # leg's output for an input of the same generation
        root = os.path.join(work, f"leg{i}")
        shutil.copytree(inputs[src], root)
        if kw["engine"] == "device":
            kw = dict(kw, device=DEVICE)
        log = RoundLog() if src.endswith("+del") else None
        cuda_lib.reset_launches()
        try:
            leg = compact_leg(root, table, **kw)
        finally:
            if log is not None:
                log.close()
        shutil.rmtree(root, ignore_errors=True)
        launches = {ids[k]: v for k, v in cuda_lib.launches().items()
                    if k in ids}
        if kw["engine"] == "device":
            leg["launches"] = launches
            leg["sizes"] = {ids[k]: v for k, v in
                            cuda_lib.launch_sizes().items() if k in ids and v}
            leg["passes"] = {ids[k]: v for k, v in
                             cuda_lib.passes().items() if k in ids and v}
        leg.update(name=name, src=src)
        print_leg(label, leg)
        for kid in must:
            need(launches[kid] > 0, f"{label}: {kid} ({KERNEL_NAMES[kid]}) "
                                    "was not launched")
        for kid in must_not:
            need(launches[kid] == 0, f"{label}: {kid} launched "
                                     f"{launches[kid]} times")
        if name == "native":
            native[src] = leg["hashes"]
            need(len(leg["hashes"]) >= len(COMPONENTS),
                 "no output sstable components found")
        else:
            need(leg["hashes"] == native[src],
                 f"{label}: output differs from the native engine's")
            print(f"    sha256 equal to native over {len(leg['hashes'])} "
                  f"components", flush=True)
        if name == "device-compress":
            need(launches["K5"] == launches["K4"],
                 f"K5 launched {launches['K5']} times for "
                 f"{launches['K4']} full segments")
        if name == "mesh2":
            need("mesh_plan" in leg["profile"], "the mesh mode did not run")
        if log is not None and name != "native":
            dead = sum(d for d, _m in log.rounds)
            need(all(m == "v2" for d, m in log.rounds if d),
                 f"{label}: a round holding a deletion did not run K7")
            need(launches["K7"] == dead and
                 launches["K6"] == len(log.rounds) - dead,
                 f"{label}: launches {launches} for {len(log.rounds)} "
                 f"rounds, {dead} with deletions")
            print(f"    rounds: {len(log.rounds)}, {dead} holding a "
                  f"deletion; K6 launches {launches['K6']}, K7 launches "
                  f"{launches['K7']}", flush=True)
        legs.append(leg)
    sizes: dict = {}
    for leg in legs:
        for kid, by in leg.get("sizes", {}).items():
            for size, c in by.items():
                sizes.setdefault(kid, {})
                sizes[kid][size] = sizes[kid].get(size, 0) + c
    return {"sizes": sizes, "legs": legs, "table": table}


# ------------------------------------------------------------- 5. read --

def write_int_runs(cfs, pk: np.ndarray, ck: np.ndarray, values: np.ndarray,
                   runs: int, ts: int) -> None:
    """Bulk-write rows (int pk, int ck, one column of fixed-width
    values) into `cfs` as `runs` sstables over consecutive partition
    ranges (tools/bulk.build_int_batch + the threaded writer), then
    load them into the store."""
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    from cassandra_tpu_torch.storage.sstable.compress_pool import get_pool
    from cassandra_tpu_torch.tools import bulk

    table = cfs.table
    col = table.regular_columns[0].column_id
    cuts = np.linspace(0, len(pk), runs + 1).astype(np.int64)
    for r in range(runs):
        sl = slice(cuts[r], cuts[r + 1])
        n = cuts[r + 1] - cuts[r]
        merged = cb.merge_sorted([bulk.build_int_batch(
            table, pk[sl], ck[sl], values[sl], np.full(n, ts, np.int64),
            column_id=col)])
        w = SSTableWriter(Descriptor(cfs.directory, cfs.next_generation()),
                          table, estimated_partitions=len(np.unique(pk[sl])),
                          threaded_io=True, compress_pool=get_pool())
        w.append(merged)
        w.finish()
    cfs.reload_sstables()


def ann_oracle(m64: np.ndarray, q: np.ndarray, k: int, sim: str):
    """Brute force in float64 (numpy): (indices, scores) of the top k,
    and the (k+1)-th score."""
    q64 = q.astype(np.float64)
    if sim == "euclidean":
        s = -((m64 - q64) ** 2).sum(axis=1)
    else:
        s = m64 @ q64
        if sim == "cosine":
            s = s / np.maximum(np.linalg.norm(m64, axis=1), 1e-9) \
                / max(float(np.linalg.norm(q64)), 1e-9)
    order = np.argsort(-s, kind="stable")[:k + 1]
    return order[:k], s[order[:k]], s[order[k]]


def phase_read(seed: int, partitions: int, ann_rows: int, work: str) -> dict:
    """The CQL read path through the port's Session over
    StorageEngine(device=DEVICE): filtered selects and their aggregate
    on scan.events with `scan_device_filter` on (K9), off (numpy masks)
    and on again, then ANN queries on emb (K10), each against a numpy
    oracle over the generated data. Launch counters are reset just
    before each leg and read just after."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.storage.engine import StorageEngine

    if (partitions, ann_rows) != (SCAN_PARTITIONS, ANN_ROWS):
        print(json.dumps({"reduced": {
            "scan_partitions": partitions, "published": SCAN_PARTITIONS,
            "ann_rows": ann_rows, "published_ann_rows": ANN_ROWS}}))
    ids = {name: kid for kid, name in KERNEL_NAMES.items()}
    eng = StorageEngine(os.path.join(work, "read"), Schema(),
                        commitlog_sync="batch", device=DEVICE)
    try:
        s = Session(eng)
        s.execute("CREATE KEYSPACE scan WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE scan")
        s.execute("CREATE TABLE events (k int, c int, v int, "
                  "PRIMARY KEY (k, c))")
        s.execute(f"CREATE TABLE emb (id int, c int, v vector<float, "
                  f"{ANN_DIM}>, PRIMARY KEY (id, c))")
        s.execute("CREATE CUSTOM INDEX ON emb (v) USING 'SAI'")
        rng = np.random.default_rng(seed + 9)
        ts = int(time.time() * 1e6)

        # scan.events: partitions x SCAN_ROWS cells, v uniform int32
        t0 = time.perf_counter()
        n = partitions * SCAN_ROWS
        pk = np.repeat(np.arange(partitions, dtype=np.int64), SCAN_ROWS)
        ck = np.tile(np.arange(SCAN_ROWS, dtype=np.int64), partitions)
        v = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
        write_int_runs(eng.store("scan", "events"), pk, ck,
                       v.astype(">i4").view(np.uint8).reshape(n, 4),
                       SCAN_RUNS, ts)
        print(f"read: built scan.events, {partitions} partitions x "
              f"{SCAN_ROWS} rows = {n} cells in {SCAN_RUNS} sstables in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        v_eq = int(v[n // 2])
        hit = v == v_eq
        want_a = sorted(zip(pk[hit].tolist(), ck[hit].tolist(),
                            v[hit].tolist()))
        qa = "SELECT k, c, v FROM events WHERE v = ? ALLOW FILTERING"
        qb = ("SELECT count(*), min(v), max(v), sum(v) FROM events "
              "WHERE v < ? ALLOW FILTERING")
        queries = {"(a)": (qa, [v_eq], want_a)}
        for tag, frac in (("(b)", SCAN_SELECTIVITY),
                          ("(b')", NARROW_SELECTIVITY)):
            thr = int(-(1 << 31) + frac * (1 << 32))
            low = v[v < thr].astype(np.int64)
            queries[tag] = (qb, [thr], [(len(low), int(low.min()),
                                         int(low.max()), int(low.sum()))])
        default_lanes = int(eng.settings.get("compaction_mesh_devices"))
        legs, sizes, out = [], {}, {}
        # (knob, mesh lanes, queries): on (cold: the first reads fill the
        # chunk and key caches), off, on again (warm, as the off leg
        # ran), then the engine's default lanes, which merge each
        # candidate partition of Phase B on its own: there the narrower
        # aggregate (b') stands in for (b)
        plan = ((True, READ_MESH_LANES, ("(a)", "(b)")),
                (False, READ_MESH_LANES, ("(a)", "(b)")),
                (True, READ_MESH_LANES, ("(a)", "(b)", "(b')")),
                (True, default_lanes, ("(a)", "(b')")))
        for i, (on, lanes, tags) in enumerate(plan):
            eng.settings.set("scan_device_filter", on)
            eng.settings.set("compaction_mesh_devices", lanes)
            name = (f"scan_device_filter={'on' if on else 'off'}, "
                    f"{lanes} mesh lanes" + (" (cold)" if i == 0 else ""))
            for tag in tags:
                q, params, want = queries[tag]
                f0 = METRICS.counter("scan.fallback")
                torch.cuda.synchronize()
                cuda_lib.reset_launches()
                t0 = time.perf_counter()
                rows = s.execute(q, params).rows
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches = {ids[k]: c for k, c in
                            cuda_lib.launches().items() if k in ids}
                by_size = {ids[k]: v2 for k, v2 in
                           cuda_lib.launch_sizes().items()
                           if k in ids and v2}
                shown = (f"{len(rows)} rows" if tag == "(a)"
                         else str(rows))
                print(f"  read [{name}] {tag}: {shown} in {ms:.1f} ms; K9 "
                      f"launches: mask {launches['K9']}, fold "
                      f"{launches['K9f']}; by size {by_size}", flush=True)
                need(sorted(rows) == want,
                     f"read [{name}] {tag}: {len(rows)} rows "
                     f"{rows[:3]}, the oracle {len(want)} {want[:3]}")
                need(METRICS.counter("scan.fallback") == f0,
                     f"read [{name}] {tag}: scan.fallback moved")
                if on:
                    need(launches["K9"] > 0 and (
                        tag == "(a)" or launches["K9f"] > 0),
                        f"read [{name}] {tag}: K9 was not launched: "
                        f"{launches}")
                    for kid, by in by_size.items():
                        sizes.setdefault(kid, {})
                        for sz, c in by.items():
                            sizes[kid][sz] = sizes[kid].get(sz, 0) + c
                else:
                    need(launches["K9"] == launches["K9f"] == 0,
                         f"read [{name}] {tag}: K9 launched with the knob "
                         f"off")
                out.setdefault(tag, set()).add(repr(sorted(rows)))
                legs.append({"name": "read", "src": f"{name} {tag}",
                             "launches": launches, "ms": ms})
        need(all(len(r) == 1 for r in out.values()),
             "read: the legs returned different results")
        eng.settings.set("scan_device_filter", True)

        # emb: ann_rows gaussian vectors, one row per partition
        t0 = time.perf_counter()
        m = rng.standard_normal((ann_rows, ANN_DIM)).astype(np.float32)
        ecfs = eng.store("scan", "emb")
        write_int_runs(ecfs, np.arange(ann_rows, dtype=np.int64),
                       np.zeros(ann_rows, np.int64),
                       m.astype(">f4").view(np.uint8).reshape(ann_rows, -1),
                       SCAN_RUNS, ts)
        idx = eng.indexes.get("scan", "emb", "v")
        for r in ecfs.live_sstables():
            idx.ensure_component(r)
        print(f"read: built emb, {ann_rows} x {ANN_DIM} float32 in "
              f"{SCAN_RUNS} sstables with their vector components in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        m64 = m.astype(np.float64)
        queries = rng.standard_normal((3, ANN_DIM)).astype(np.float32)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        ann_ms = {}
        t0 = time.perf_counter()
        idx._gather()
        ann_ms["gather"] = (time.perf_counter() - t0) * 1e3
        checks = {}
        for k in ANN_KS:
            q = queries[0]
            lit = "[" + ", ".join(repr(float(x)) for x in q) + "]"
            t0 = time.perf_counter()
            rows = s.execute(f"SELECT id FROM emb ORDER BY v ANN OF {lit} "
                             f"LIMIT {k}").rows
            ann_ms[f"cql cosine k={k}"] = (time.perf_counter() - t0) * 1e3
            o_idx, _o_s, _nxt = ann_oracle(m64, q, k, "cosine")
            need([r[0] for r in rows] == o_idx.tolist(),
                 f"read: ANN cosine k={k} ids differ from the oracle")
        for qi, sim in ((1, "dot"), (2, "euclidean"), (0, "cosine")):
            for k in ANN_KS:
                q = queries[qi]
                t0 = time.perf_counter()
                hits = idx.ann(q, k, sim)
                ann_ms[f"direct {sim} k={k}"] = \
                    (time.perf_counter() - t0) * 1e3
                o_idx, o_s, nxt = ann_oracle(m64, q, k, sim)
                got = [int.from_bytes(h[0], "big", signed=True)
                       for h in hits]
                tol = ANN_TOL[sim]
                need(float(o_s[-1] - nxt) > tol,
                     f"read: oracle {sim} k={k}: k-th and (k+1)-th scores "
                     f"{o_s[-1]} and {nxt} within the tolerance {tol}")
                need(got == o_idx.tolist(),
                     f"read: ANN {sim} k={k} ids differ from the oracle")
                e = float(np.abs(np.array([h[2] for h in hits]) - o_s).max())
                need(e <= tol, f"read: ANN {sim} k={k}: scores {e} from "
                               f"the oracle > {tol}")
                checks[f"{sim} k={k}"] = e
        torch.cuda.synchronize()
        launches = {ids[k]: c for k, c in cuda_lib.launches().items()
                    if k in ids}
        by_size = {ids[k]: v2 for k, v2 in cuda_lib.launch_sizes().items()
                   if k in ids and v2}
        need(launches["K10"] == 2 + 3 * len(ANN_KS),
             f"read: ANN launches {launches}")
        for kid, by in by_size.items():
            sizes.setdefault(kid, {})
            for sz, c in by.items():
                sizes[kid][sz] = sizes[kid].get(sz, 0) + c
        print("  read [ann]: wall ms " + json.dumps(
            {k2: round(v2, 1) for k2, v2 in ann_ms.items()})
            + f"; K10 launches {launches['K10']}; ids equal to the "
            f"float64 oracle for all {len(ann_ms) - 1} queries; max score "
            "error of the direct ones " + json.dumps(checks), flush=True)
        legs.append({"name": "read", "src": "ann", "launches": launches,
                     "ms": ann_ms})
        return {"sizes": sizes, "legs": legs}
    finally:
        eng.close()


# ------------------------------------------------------------- 6. mesh --

MESH_SHARDS = 4
MESH_UNIFORM = (4096, 64, (2, 4))     # cells per batch, partitions, S
MESH_SKEWED = (524_288, 4096)         # cells per batch, partitions
MESH_IMBALANCE = 1.2


def mesh_table():
    from cassandra_tpu_torch.schema import make_table
    return make_table("bench", "t", pk=["id"], ck=["c"],
                      cols={"id": "int", "c": "int", "v": "blob"})


def uniform_batch(table, n_cells: int, n_parts: int, seed: int):
    """The JAX dryrun's uniform batch (__graft_entry__._example_operands)."""
    from cassandra_tpu_torch.tools import bulk
    rng = np.random.default_rng(seed)
    return bulk.build_int_batch(
        table, rng.integers(0, n_parts, n_cells),
        rng.integers(1, 50, n_cells),
        rng.integers(97, 122, (n_cells, 16), dtype=np.uint8),
        rng.integers(1, 1000, n_cells).astype(np.int64))


def skewed_batch(table, n_cells: int, n_parts: int, seed: int):
    """The JAX dryrun's skewed batch (__graft_entry__._skewed_batch):
    about 40% of the cells in 2 hot partitions."""
    from cassandra_tpu_torch.tools import bulk
    rng = np.random.default_rng(seed)
    hot = rng.random(n_cells) < 0.4
    pk = np.where(hot, rng.integers(0, 2, n_cells),
                  rng.integers(2, n_parts, n_cells))
    return bulk.build_int_batch(
        table, pk, rng.integers(1, 10_000, n_cells),
        rng.integers(97, 122, (n_cells, 16), dtype=np.uint8),
        rng.integers(1, 1 << 40, n_cells).astype(np.int64))


def mesh_case(label: str, table, mesh, batches: list, work: str,
              ref=None, warm: bool = True) -> dict:
    """The JAX dryrun's four checks on one mesh: the sharded merge equals
    the host merge (lanes, ts, payload), one sstable per non-empty shard
    reads back to the same cell count, shard imbalance <= 1.2, and the
    one-program step (K8) over shard_batch gives the per-device path's
    perm and, after the same host tie-break, its keep."""
    from cassandra_tpu_torch.ops.merge import host_tiebreak, unpack_masks
    from cassandra_tpu_torch.parallel import mesh as pm
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.sstable.reader import SSTableReader

    S = mesh.devices.size
    cat = cb.CellBatch.concat(batches)
    if warm:
        pm.materialize_sharded_merge(cat, mesh)
    walls: list = []
    disp: list = []
    t0 = time.perf_counter()
    shards = pm.materialize_sharded_merge(cat, mesh, walls_out=walls,
                                          dispatch_out=disp)
    t_merge = time.perf_counter() - t0
    t0 = time.perf_counter()
    if ref is None:
        ref = cb.merge_sorted(batches)
    t_host = time.perf_counter() - t0
    merged = cb.CellBatch.concat([x for x in shards if len(x)])
    need(len(merged) == len(ref),
         f"{label}: sharded merge kept {len(merged)}, host {len(ref)}")
    for f in ("lanes", "ts", "payload"):
        need(np.array_equal(getattr(merged, f), getattr(ref, f)),
             f"{label}: sharded merge {f} != host merge")
    del merged
    sizes = [len(x) for x in shards]
    imb = pm.shard_imbalance(sizes)
    need(imb <= MESH_IMBALANCE, f"{label}: shard imbalance {imb} "
                                f"(sizes {sizes})")
    d = os.path.join(work, f"mesh-{label}")
    os.makedirs(d)
    t0 = time.perf_counter()
    results = pm.sharded_compact_to_sstables(batches, table, mesh, d,
                                             shards=shards)
    t_write = time.perf_counter() - t0
    del shards
    need(len(results) == sum(1 for n in sizes if n),
         f"{label}: {len(results)} sstables for shards {sizes}")
    total = 0
    for desc, _stats in results:
        r = SSTableReader(desc)
        total += sum(len(seg) for seg in r.scanner())
        r.close()
    need(total == len(ref), f"{label}: read back {total} cells of "
                            f"{len(ref)}")
    shutil.rmtree(d)

    ops, _shard_of, _pos, members = pm.shard_batch(cat, S)
    perm, packed, stats = pm.sharded_merge_step(mesh)(ops)
    perm, packed = perm.cpu().numpy(), packed.cpu().numpy()
    keep_d, perm_d, stats_d, _, _ = pm.run_sharded_merge(cat, mesh)
    raw_kept = amb_cells = 0
    for s in range(S):
        c = len(members[s])
        need(np.array_equal(perm[s, :c], perm_d[s, :c]),
             f"{label}: step perm != per-device perm in shard {s}")
        need(not (packed[s, c:] & 1).any(), f"{label}: a pad row kept")
        keep, amb, expired, shadowed = unpack_masks(packed[s, :c])
        raw_kept += int(keep.sum())
        amb_cells += int(amb.sum())
        if amb.any():
            host_tiebreak(cat, members[s][perm[s, :c]], keep, amb,
                          shadowed, expired, 0, None)
        need(np.array_equal(keep, keep_d[s, :c]),
             f"{label}: step keep != per-device keep in shard {s}")
    need(stats.tolist() == [raw_kept, len(cat) - raw_kept],
         f"{label}: step stats {stats.tolist()}, masks {raw_kept}")
    need(stats_d.tolist() == [len(ref), len(cat) - len(ref)],
         f"{label}: sharded stats {stats_d.tolist()}, host {len(ref)}")

    # overlap: each live shard's merge alone, over the concurrent wall
    devices = pm._mesh_devices(mesh)
    solo = []
    for s in range(S):
        if len(members[s]):
            o = pm._pack_shard_operands(cat, members[s], 0, 0)
            t0 = time.perf_counter()
            pm._merge_on(o, devices[s])
            solo.append(time.perf_counter() - t0)
    return {"case": label, "shards": S, "cells_in": len(cat),
            "cells_kept": len(ref), "shard_sizes": sizes,
            "imbalance_max_mean": imb, "sstables": len(results),
            "merge_wall_s": t_merge, "host_merge_s": t_host,
            "write_s": t_write, "device_walls_s": walls,
            "dispatch_s": disp[0], "solo_walls_s": solo,
            "overlap_factor": sum(solo) / disp[0] if disp[0] else 1.0,
            "step": [S, int(ops["valid"].shape[1])],
            "step_stats": stats.tolist(), "sharded_stats": stats_d.tolist(),
            "ambiguous": amb_cells, "_ops": ops, "_ref": ref}


def read_runs(directory: str, table) -> list:
    """The cells of every sstable under `directory`, one batch per run."""
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    cfs = ColumnFamilyStore(table, directory, commitlog=None)
    cfs.reload_sstables()
    out = []
    for r in sorted(cfs.live_sstables(), key=lambda r: r.desc.generation):
        out.append(cb.CellBatch.concat(list(r.scanner())))
        r.close()
    return out


def phase_mesh(seed: int, work: str, stcs_tbl,
               skewed_cells: int = MESH_SKEWED[0]) -> dict:
    """The sharded compaction step (parallel/mesh.py), the counterpart of
    __graft_entry__.dryrun_multichip, on meshes of shards that share the
    card (Mesh([cuda:0] * S)): the uniform 8k case at S = 2 and 4, the
    skewed-1M round at S = 4, then the stcs-10M inputs of phase 4 read
    back (`stcs_tbl`, phase 4's table), at S = 4 and on
    make_mesh(device_count). The launch counters
    are reset before the cases and read after them; K8's time on each
    case's own operands is taken after that."""
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.ops import merge as dm
    from cassandra_tpu_torch.parallel import mesh as pm

    one = torch.device(DEVICE)
    table = mesh_table()
    ids = {name: kid for kid, name in KERNEL_NAMES.items()}
    if skewed_cells != MESH_SKEWED[0]:
        print(json.dumps({"reduced": {"case": "skewed", "cells_per_batch":
                                      skewed_cells,
                                      "published": MESH_SKEWED[0]}}))
    n_u, p_u, widths = MESH_UNIFORM
    uni = [uniform_batch(table, n_u, p_u, 0), uniform_batch(table, n_u, p_u, 1)]
    skew = [skewed_batch(table, skewed_cells, MESH_SKEWED[1], sd)
            for sd in (2, 3)]
    t0 = time.perf_counter()
    stcs = read_runs(os.path.join(work, "stcs"), stcs_tbl)
    print(f"mesh: read back stcs, {[len(b) for b in stcs]} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cases = [(f"uniform-8k-{S}", table, pm.Mesh([one] * S), uni, {})
             for S in widths]
    cases.append((f"skewed-1M-{MESH_SHARDS}", table,
                  pm.Mesh([one] * MESH_SHARDS), skew, {}))
    cases.append((f"stcs-10M-{MESH_SHARDS}", stcs_tbl,
                  pm.Mesh([one] * MESH_SHARDS), stcs, {"warm": False}))
    mesh_all = pm.make_mesh(torch.cuda.device_count(), device=DEVICE)
    cases.append((f"stcs-10M-make_mesh({mesh_all.devices.size})",
                  stcs_tbl, mesh_all, stcs, {"warm": False}))
    reports, legs, sizes = [], [], {}
    ref10 = None
    cuda_lib.reset_launches()
    for label, tbl, mesh, batches, kw in cases:
        before = cuda_lib.launches()
        passes0 = cuda_lib.passes()
        sizes0 = cuda_lib.launch_sizes()
        t0 = time.perf_counter()
        rep = mesh_case(label, tbl, mesh, batches, work,
                        ref=ref10 if batches is stcs else None, **kw)
        rep["case_s"] = time.perf_counter() - t0
        ref = rep.pop("_ref")
        if batches is stcs:
            ref10 = ref
        after = cuda_lib.launches()
        sizes1 = cuda_lib.launch_sizes()
        launches = {ids[k]: after[k] - before[k] for k in after
                    if k in ids and after[k] > before[k]}
        rep["launches"] = launches
        rep["passes"] = {ids[k]: v - passes0[k]
                         for k, v in cuda_lib.passes().items()
                         if k in ids and v > passes0[k]}
        print("  " + json.dumps({k: v for k, v in rep.items()
                                 if not k.startswith("_")}), flush=True)
        reports.append(rep)
        legs.append({"name": "mesh", "src": label, "launches": launches})
        for k, by in sizes1.items():
            if k in ids:
                for size, c in by.items():
                    d = c - sizes0[k].get(size, 0)
                    if d:
                        sizes.setdefault(ids[k], {})
                        sizes[ids[k]][size] = sizes[ids[k]].get(size, 0) + d
    total = cuda_lib.launches()
    for kid in ("K1", "K2", "K8"):
        need(total[KERNEL_NAMES[kid]] > 0, f"mesh: {kid} was not launched")
    for kid in ("K3", "K4", "K5", "K6", "K7", "K9", "K9f", "K10"):
        need(total[KERNEL_NAMES[kid]] == 0,
             f"mesh: {kid} launched {total[KERNEL_NAMES[kid]]} times")
    # after the counts: K8 on each case's own operands, CUDA events
    for rep, (_label, _t, mesh, _b, _kw) in zip(reports, cases):
        ops = rep.pop("_ops")
        if len(set(mesh.devices.flat)) == 1:
            dev_ops = dm.operands_to_device(ops, mesh.devices.flat[0])
            rep["k8_ms"] = cuda_ms(lambda: pm.sharded_step(dev_ops), reps=3)
            rep["k8_sync_ms"] = _timed_sort(
                "mesh.sharded_step", lambda: pm.sharded_step(dev_ops))[2]
            del dev_ops
        else:
            rep["k8_ms"] = None
        print(f"  {rep['case']}: merge wall {rep['merge_wall_s']:.4f} s, "
              f"device walls {[round(w, 4) for w in rep['device_walls_s']]}"
              f" s, dispatch {rep['dispatch_s']:.4f} s, overlap "
              f"{rep['overlap_factor']:.2f}, K8 at {rep['step']} "
              + ("not measured" if rep["k8_ms"] is None
                 else f"{rep['k8_ms']:.4f} ms (plan sync "
                      f"{rep['k8_sync_ms']:.4f} ms)")
              + f", K8 launches {rep['launches'].get('K8', 0)}, sort "
              f"passes {rep['passes']}", flush=True)
    return {"sizes": sizes, "legs": legs, "reports": reports}


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
    "K5": ("cassandra_tpu_torch/csrc/lzscan.cu",
           "cassandra_tpu/ops/device_compress.py:74"),
    "K6": ("cassandra_tpu_torch/csrc/planes.cu",
           "cassandra_tpu/ops/merge.py:607"),
    "K7": ("cassandra_tpu_torch/csrc/planes.cu",
           "cassandra_tpu/ops/merge.py:475"),
    "K8": ("cassandra_tpu_torch/csrc/mesh.cu",
           "cassandra_tpu/parallel/mesh.py:147"),
    "K9": ("cassandra_tpu_torch/csrc/scanmask.cu",
           "cassandra_tpu/ops/device_scan.py:339"),
    "K9f": ("cassandra_tpu_torch/csrc/scanmask.cu",
            "cassandra_tpu/ops/device_scan.py:366"),
    "K10": ("cassandra_tpu_torch/csrc/ann.cu",
            "cassandra_tpu/index/manager.py:284"),
}


LIBRARY_CALLS = {
    "K1": "torch.sort(stable=True) of an int64 key packed from the "
          "round's dense ranks (packing untimed; library_with_key_ms "
          "times the packing too)",
    "K3": "torch.nonzero + index_select (several calls)",
    "K6": "torch.sort(stable=True) of an int64 key packed from the "
          "round's dense lexicographic ranks (the sort part only; "
          "packing untimed)",
    "K7": "torch.sort(stable=True) of an int64 key packed from the "
          "round's dense lexicographic ranks (the sort part only; "
          "packing untimed)",
    "K8": "torch.sort(key, dim=1, stable=True) of an int64 [S, N] key "
          "packed from the shards' dense ranks (packing untimed; "
          "library_with_key_ms times the packing too)",
    "K9": "torch.eq(keys, q) (the eq op; every op's kernel time under "
          "ops_ms)",
    "K10": "torch.topk(m @ q, k) (dot, k = 10; every case under cases)",
}


def kernels_line(res: dict, e2e: dict) -> dict:
    """Per kernel: the numbers at the size the main paths launched most,
    max_abs_err over every size checked, each launched size's own
    numbers under "shapes", and the launches of each leg."""
    out = []
    for kid, r in sorted(res.items(), key=lambda kv: kid_order(kv[0])):
        src, replaces = SOURCES[kid]
        seen = e2e["sizes"].get(kid) or dict.fromkeys(r["shapes"], 0)
        shapes = []
        for size in sorted(seen):
            s = r["shapes"][size]
            extra = {k: s[k] for k in ("masks", "d2h_ms", "emit_ms",
                                       "ops_ms", "cases", "selected",
                                       "graph_ms", "library_graph_ms",
                                       "library_with_key_ms", "passes",
                                       "key_bytes", "sync_ms", "steps")
                     if k in s}
            shapes.append({
                "size": size, "launches": seen[size],
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"],
                "bound_ms": bound_ms(s["bytes"], s.get("ops", 0.0)),
                "bound_by": bound_by(s), "library_ms": s["library_ms"],
                **extra})
        top = max(shapes, key=lambda e: (e["launches"], e["size"]))
        out.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(seen.values()),
            "max_abs_err": max(s["err"] for s in r["shapes"].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library_call": LIBRARY_CALLS.get(kid), "size": top["size"],
            "legs": {f"{g['name']} [{g['src']}]": g["launches"][kid]
                     for g in e2e["legs"] if g.get("launches", {}).get(kid)},
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
    planned["K4"] = planned["K5"] = {SEGMENT}
    planned["K6"] = planned["K7"] = set(PLANE_PADS)
    planned["K9"] = planned["K9f"] = {SEGMENT}
    planned["K10"] = {ANN_ROWS}
    planned["K8"] = {(MESH_SHARDS, 1 << 20)}       # the skewed-1M step
    phase_kernels(args.seed, planned, res)
    build_root = os.path.join(REPO, "cassandra_tpu_torch", "build")
    os.makedirs(build_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=build_root)
    try:
        e2e = phase_e2e(args.seed, args.cells_per_run, work)
        t0 = time.perf_counter()
        read = phase_read(args.seed, SCAN_PARTITIONS // READ_PARTITIONS_CUT,
                          ANN_ROWS, work)
        print(f"read: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mesh = phase_mesh(args.seed, work, e2e["table"])
        print(f"mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for kid, by in read["sizes"].items():
        e2e["sizes"][kid] = by
    for kid, by in mesh["sizes"].items():
        for size, c in by.items():
            e2e["sizes"].setdefault(kid, {})
            e2e["sizes"][kid][size] = e2e["sizes"][kid].get(size, 0) + c
    e2e["legs"] += read["legs"] + mesh["legs"]
    # 7. the kernels at every other size the main paths launched
    seen = {kid: set(e2e["sizes"].get(kid, ())) for kid in KERNEL_NAMES}
    print("shapes: the main path launched " + json.dumps(
        {kid: sorted(v) for kid, v in seen.items()}), flush=True)
    phase_kernels(args.seed, seen, res)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line(res, e2e)))
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
