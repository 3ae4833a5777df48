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
              K = 13 lanes (holding every K2 mask bit; K2 and K3 also
              against the plain mirrors of their tiles, K2 on
              make_edge_round's round with a deletion at every tile
              edge); K4 META serialize (also against the mirror of its
              tiles, its stats decoded from its one buffer) and K5 LZ4
              match scan on a 65,536-cell segment
              (K5 also against the mirror of its word compares, and on
              an unsorted copy, whose order check must fail; its LZ4
              blocks must equal the native encoder's; its D2H and the
              host emission are timed on their own; K2, K4 and K5 each
              make at most two device launches a call and K3 at most
              three, counted as the nodes of a CUDA graph captured from
              one call, and K3 and K4 are also
              timed in a CUDA graph, without the host's issue cost);
              K6 and K7, the plane
              programs, on synthetic v3 / v2 rounds padded to 524,288 and
              786,432 (the K7 round holds partition, row and complex
              deletions, equal stamps and padding, and must give keep,
              ambiguous and shadowed rows); K9, the scan mask (eight ops,
              at a segment's 65,536 u64 keys and at a run's cap of 2^20,
              timed over SCAN_REPS calls) and fold, on keys with the edge
              keys; K10, vector search, on a 1,000,000 x 128 gaussian
              matrix for the three similarities at k = 10 and 100 (the
              fused path; its output equal to the select path's bit for
              bit) and at the first k above K_FUSED whose top k is
              decided (the select path): equal indices, scores within
              ANN_TOL; K8, the mesh step, on [4, 2^20]
              synthetic shards (a full and an empty shard, two full
              shards of one hot cell side by side; its reconcile also
              against K2's mirror over equal segments). K1, K6, K7 and K8
              also print the round sort's passes run (of their key
              bytes, the passes launched; equal to sort_plan_plain's)
              and its device ms by step (torch.profiler); K1 and K8 the
              library call's time with its key built.
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
  5. read     a process of its own (chip_smoke.py --tools-part read,
              started with phase 8's after phase 3, beside phase 4; its
              data is its own), its sizes and legs back as JSON: the
              CQL read path: Session over StorageEngine(device=
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
              numpy oracle over the generated data. Per query it prints
              the `scan` ledger's `filter` stage seconds and Phase A's K9
              launches (one per run of segments), which must be at most
              the runs that the cap and the gate allow. emb (id int, c int,
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
  8. tools    two processes of their own (chip_smoke.py --tools-part),
              started after phase 3 and run beside phases 4 and 6 (the
              tools are host-bound Python), then waited for before
              phase 7, which covers their sizes; their output is printed
              after phase 6. The single-node tools on card engines, each
              part in a directory of its own. stress: (a) stress.write
              of STRESS_ROWS_RUN rows into stress.standard1 (a key and
              four 34 B blobs; cassandra-stress's `write n=1000000`, cut
              to 200,000, printed as `reduced`) with a flush threshold
              giving at least 4 sstables, stress.read of STRESS_READS_RUN
              keys (every read must hit; a twentieth of the rows, cut
              from a tenth and printed as `reduced`), then the table's
              major
              compaction, compact_leg on a copy through
              CompactionTask(engine="device") with device compress off
              (K1-K4 must launch, K5 not) beside compact_leg on another
              copy with the native engine: sha256-equal over every
              component; (b) cqlsh.repl's COPY TO a CSV from an engine
              reopened over the device leg's output, COPY FROM it into a
              fresh card engine, flush, COPY TO again: byte-equal, n
              rows; (c) sstabletools over that output: verify passes,
              metadata's cells sum to the cells read back, the dump of a
              partition equals its SELECT. harry: (d) HARRY_OPS ops of
              OpGenerator(seed, 2,048 partitions, 64 rows) with TTLs on
              a virtual clock and every kind of deletion but range
              deletions (a round holding a range tombstone's bound
              merges on the host, as in the JAX package), through a
              Session, a flush every HARRY_FLUSH_EVERY ops; every
              partition equal to the model, then the major compaction in
              the default configuration (K1-K5 must launch) beside a
              native one, sha256-equal, then every partition again on
              the device leg's output. Launch counters are reset just
              before each device compaction and read just after (each
              process has its own); each part prints its wall seconds
              and the compactions their launches by kernel.
  9. cluster  a third process of its own beside phases 4 and 6, like
              phase 8's parts: the in-process cluster (LocalCluster: 3 nodes,
              RF 3, every node's engine on the card, autocompaction
              off). (a) stress.write of CLUSTER_ROWS rows (cut from
              cassandra-stress's `write n=1000000 cl=QUORUM -schema
              replication(factor=3)`, printed as `reduced`) through
              node 1 at QUORUM, every live replica drained and flushed
              after each quarter; node 3 is down, with hinted handoff
              off, for the last quarter and then restarted; (b) a full
              repair from node 1 (Merkle trees of depth 6, cut from 10
              and printed as `reduced`), after which node 3's own store
              holds every row and a preview repair finds no mismatch;
              (c) per node, compact_leg on copies of its sstables with
              the native engine and through
              CompactionTask(engine="device"), sha256-equal (node 1 in
              the default configuration, K1-K5 must launch; nodes 2 and
              3 with device compress off, K1-K4 must and K5 must not),
              then the same device compaction of the node's live store,
              equal to its copy's; (d) 2,000 keys at QUORUM through
              node 2 and 500 at ALL through node 3, each the row as
              written. Launch counters are reset just before each
              device compaction and read just after; it prints each
              part's wall seconds, writes/s, reads/s and the launches
              of each node's compactions.
 10. net      a process of its own (--tools-part net), started with
              phase 8's, beside phases 4 and 6: three daemons (python -m
              cassandra_tpu_torch.tools.noded, each a process of its own
              with its engine on the card), a static ring (even_tokens(3,
              vnodes=4)) over the TCP transport, RF 3 with explicit
              table ids, each with a native port and an admin port;
              nodes 2 and 3 with compaction_device_compress off;
              autocompaction off through the admin port. (a) NET_ROWS
              stress.standard1 rows (cut from phase 9's source, printed
              as `reduced`) written through client.Cluster at QUORUM
              with prepared statements from NET_CONNECTIONS
              connections, every replica drained, then `nodetool flush`
              on every node; (b) NET_VECTORS rows of phase 5's emb
              table written offline by this process's engine on the
              card and streamed to every replica by `nodetool
              bulkload`; (c) per node, compact_leg on copies of its
              stress sstables with the native engine and through
              CompactionTask(engine="device") (node 1 K1-K5, nodes 2
              and 3 K1-K4 and not K5), then `nodetool compact` on the
              daemon (its own native compaction): all three outputs
              sha256-equal; (d) NET_QUORUM_READS keys at QUORUM over the
              wire, each the row as written, and ANN queries at ALL
              through node 1 (NET_ANN: k and count), ids equal to the
              float64 oracle and the rows' vectors as loaded (the
              server returns no scores; phase 7 holds K10 to its plain
              version at the daemons' sizes); each daemon's launches of
              K10 on its card (`nodetool profiler status` over its admin
              port, beside the wrapper's `calls` in
              system_views.device_programs, read over the wire), before
              and after, must rise by at least the number of queries
              (every replica served its share on its card). Every
              daemon is stopped when the phase ends, and dies with its
              process if that is killed (die_with_parent).
 11. gates    in phase 8's harry process, after harry: the port's
              tier-2 A/B gates and drills (cassandra_tpu_torch.scripts)
              on the card, each in a directory of its own under the
              smoke's work: check_compaction_ab (eleven compaction legs
              at the gate's 3 x 200,000 cells and the flush A/B; its
              resident device legs must launch K1-K4, device_compress
              and device_compress_pool2 K5 too, and every device leg
              must launch a kernel), check_scan_ab (the pushdown legs,
              device and mesh2, must launch K9), check_readpath_ab,
              check_writepath_ab, check_profiler, chaos_storage and
              stress --smoke. Each must report zero divergence or exit
              0; the launch counters are reset before each gate and read
              after it; it prints each gate's wall seconds and its
              launches by kernel, and its launch sizes join phase 7's.
  7. shapes   phase 3 again at every size the main paths launched that
              phase 3 did not cover (a round extended past 2^19 cells to
              its partition's end pads to 2^20; the scan mask's runs of
              segments and the fold's candidate count; K8's [S, N]).

Before the last line it prints one JSON object {"kernels": [...]} (per
kernel: route, source, the JAX function it replaces, launches over the
main paths and per leg, max_abs_err, warm ms, plain ms, bound ms and
what bounds it, and the time of one PyTorch call that computes the same
function where there is one, at the size launched most, then the same
per launched size under "shapes", where K1, K6, K7 and K8 add passes,
key_bytes and steps, K1 and K8 library_with_key_ms) and the card's name
and power limit. Bytes and operations come from
cassandra_tpu_torch/ops/costs.py, as system_views.device_programs
reports them.
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
RUN_KEYS = 1 << 20                   # ops/device_scan.py: K9's keys a run
# calls per CUDA-event window of K9's mask and torch.eq: a call takes
# tens of microseconds of the host, so a short window measures noise
SCAN_REPS = 200
# merge._plane_pad of a device round: 2^19, or 3 x 2^18 past it
PLANE_PADS = (1 << 19, 3 << 18)
STCS_RUNS = 4
STCS_CELLS_PER_RUN = 2_500_000       # BASELINE.json config 1: n = 10M
STCS_PARTITIONS = 4096
VALUE_BYTES = 64
# the default-configuration leg (K5) runs on its own cut input: its
# host payload scans take seconds per segment (PERF.md section 5); a
# thirty-second since the tools phase joined, to keep the smoke under
# 600 s (printed as `reduced`)
COMPRESS_LEG_CUT = 32
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
          f"{info['cuda']} | devices {info['count']} | host cpus "
          f"{os.cpu_count()}", flush=True)
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


def make_edge_round(seed: int, n: int, N: int, tile: int = 1024,
                    K: int = LANES) -> tuple:
    """A round (make_round's layout, numpy) laid out in sorted order
    and stored under a random permutation, with its segment starts
    placed by hand for K2's tiles of `tile` positions: partitions that
    span several tiles, and at each tile's last, first and second
    position the start of a partition with a partition deletion, of a
    row with a row deletion or of a column with a complex deletion, in
    turn; equal-ts cells; padding after n (whole tiles of it when N - n
    allows). Returns (operands, perm): perm[i] is the stored row of
    sorted position i."""
    rng = np.random.default_rng(seed)
    r = rng.random(n)
    # the level each sorted row starts: 0 partition, 1 row, 2 column,
    # 3 cell, 4 none (it continues the cell before)
    lvl = np.select([r < 1 / (3 * tile), r < 1 / 40, r < 1 / 4, r < 1 / 2],
                    [0, 1, 2, 3], 4).astype(np.int8)
    dele = (rng.random(n) < 0.3) & (lvl <= 2)     # a deletion of its level
    edges = [e for t in range(1, n // tile + 1)
             for e in (t * tile - 1, t * tile, t * tile + 1) if e < n]
    for j, e in enumerate(edges):
        lvl[e], dele[e] = j % 3, True
    lvl[:1] = 0
    part, row = np.cumsum(lvl == 0), np.cumsum(lvl <= 1)
    colid, cell = np.cumsum(lvl <= 2), np.cumsum(lvl <= 3)
    S = {"lanes": np.full((N, K), 0xFFFFFFFF, dtype=np.uint32)}
    lanes = S["lanes"]
    for k in range(4):
        lanes[:n, k] = ((part.astype(np.uint64) * np.uint64(2654435761
                                                            + 40503 * k))
                        >> np.uint64(7)).astype(np.uint32)
    lanes[:n, 4] = row
    lanes[:n, 5:K - 3] = 0
    # a column's lane: 0 under a partition deletion, 1 under a row
    # deletion, else 8 or 9 by turns, so that neighbours differ
    start = np.flatnonzero(lvl <= 2)
    cval = 8 + colid[start] % 2
    cval[dele[start] & (lvl[start] == 0)] = 0
    cval[dele[start] & (lvl[start] == 1)] = 1
    lanes[:n, K - 3] = cval[colid - 1]
    lanes[:n, K - 2] = cell
    lanes[:n, K - 1] = 0
    ts = rng.integers(0, 1 << 20, n).astype(np.int64)
    # a continued cell's row repeats the ts of the row before
    dup = (lvl == 4) & (rng.random(n) < 0.4)
    ts = ts[np.maximum.accumulate(np.where(dup, 0, np.arange(n)))]
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    now = 1_700_000_000

    def col(vals, dtype=np.uint32, fill=0):
        a = np.full(N, fill, dtype=dtype)
        a[:n] = vals
        return a

    S.update({
        "valid": col(0, fill=1),
        "ts_h": col((uts >> np.uint64(32)).astype(np.uint32)),
        "ts_l": col((uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        "death": col(rng.random(n) < 0.1),
        "cdel": col(dele & (lvl == 2)),
        "ldt": col(now + rng.integers(-1000, 1000, n), np.int32),
        "expiring": col(rng.random(n) < 0.2),
        "purge_h": col(np.where(rng.random(n) < 0.5, 0x80000000, 0xFFFFFFFF)
                       .astype(np.uint32), fill=0xFFFFFFFF),
        "purge_l": col(rng.integers(0, 1 << 20, n), fill=0xFFFFFFFF)})
    perm = rng.permutation(N).astype(np.int32)
    ops = {}
    for k, v in S.items():
        ops[k] = np.empty_like(v)
        ops[k][perm] = v
    ops["now"], ops["gc_before"] = np.int32(now), np.int32(now - 500)
    return ops, perm


def make_keep_round(seed: int, n: int, N: int, run: int,
                    K: int = LANES) -> tuple:
    """A round (make_round's layout, numpy) whose sorted rows form
    partitions of `run` rows, stored under a random permutation: every
    other partition opens with a purged partition deletion that shadows
    all its rows (all dropped), the rest are kept whole, some of their
    cells expired (kept expired-TTL), and one kept partition in four
    ends on an equal-(identity, ts) duplicate (ambiguous, dropped);
    padding after n. With run >= 2 tiles it gives all-kept and
    all-dropped tiles. Returns (operands, perm): perm[i] is the stored
    row of sorted position i."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    part, pos = i // run, i % run
    dead = part % 2 == 1
    lanes = np.full((N, K), 0xFFFFFFFF, dtype=np.uint32)
    for k in range(4):
        lanes[:n, k] = part.astype(np.uint32) if k == 3 else 0
    lanes[:n, 4:K - 3] = 0
    lanes[:n, K - 3] = np.where(dead & (pos == 0), 0, 8)
    lanes[:n, K - 2] = pos
    lanes[:n, K - 1] = 0
    ts = rng.integers(1, 1 << 40, n).astype(np.int64)
    ts[dead & (pos == 0)] = 1 << 41          # the deletion shadows its rows
    # ... sorted by ts descending within an identity: the duplicate
    # repeats the cell and the stamp of the row before it
    dup = (part % 4 == 2) & (pos == run - 1) & (pos > 0)
    lanes[:n][dup, K - 2] = pos[dup] - 1
    ts[dup] = ts[np.flatnonzero(dup) - 1]
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    now = 1_700_000_000
    expiring = ~dead & (rng.random(n) < 0.1)

    def col(vals, dtype=np.uint32, fill=0):
        a = np.full(N, fill, dtype=dtype)
        a[:n] = vals
        return a

    S = {"lanes": lanes,
         "valid": col(0, fill=1),
         "ts_h": col((uts >> np.uint64(32)).astype(np.uint32)),
         "ts_l": col((uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
         "death": col(dead & (pos == 0)),
         "cdel": col(0),
         "ldt": col(np.where(dead & (pos == 0), 0,
                             np.where(expiring, now - 100, now + 1000)),
                    np.int32),
         "expiring": col(expiring),
         "purge_h": col(0xFFFFFFFF, fill=0xFFFFFFFF),
         "purge_l": col(0xFFFFFFFF, fill=0xFFFFFFFF),
         "flags8": col(rng.integers(0, 256, n), np.uint8),
         "ttl": col(rng.integers(0, 1 << 20, n), np.int32),
         "fl": col(rng.integers(20, 200, n)),
         "vr": col(rng.integers(5, 20, n))}
    perm = rng.permutation(N).astype(np.int32)
    ops = {}
    for k, v in S.items():
        ops[k] = np.empty_like(v)
        ops[k][perm] = v
    ops["now"], ops["gc_before"] = np.int32(now), np.int32(now - 500)
    return ops, perm


def make_segment(seed: int, n: int) -> tuple:
    """One full segment's columns with the extreme timestamps of
    tests/test_device_resident.py (i64 min and max, -1, 0) and the
    extreme ldt (i32 min and max), as far as n allows."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    ts[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0][:n]
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    ldt = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    ldt[4:6] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max][:max(0, n - 4)]
    cols = ((uts >> np.uint64(32)).astype(np.uint32),
            (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            ldt,
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


def work(kind: str, *args) -> dict:
    """The bytes and operations of kernel work `kind` on args, from
    cassandra_tpu_torch/ops/costs.py, as an entry's keys."""
    from cassandra_tpu_torch.ops import costs
    nbytes, ops = getattr(costs, kind)(*args)
    return {"bytes": nbytes, "ops": ops}


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


SORT_STEPS = ("plan_hist", "plan_bases", "plan_table", "split_pack",
              "round_pass", "scan_tiles", "add_back", "rec_tiles",
              "cmp_partition", "cmp_gather", "meta_tiles",
              "lz_segment", "shard_stats", "sum_stats", "fast_tail",
              "v2_bounds", "v2_final", "Memcpy", "Memset")


def sort_breakdown(fn, first: str = "plan_hist") -> dict | None:
    """Device ms of one call of fn (a round sort, a plane program, the
    mesh step, K2-K5) by kernel, from torch.profiler: {step:
    [launches, ms]} over SORT_STEPS (K2's kernel is rec_tiles, K3's
    cmp_partition and cmp_gather, K4's meta_tiles, K5's lz_segment,
    K6's tail fast_tail, K7's v2_*; the scans serve the sort's split and
    K7); None when the profiler saw no device time or missed the step
    `first`. On the H100 machines the profiler's device timestamps stop
    agreeing with the host's clock some tens of seconds into a process,
    and it then drops most windows' device events (PERF.md section 7),
    so a step breakdown is often not measured; `graph_launches` counts
    launches without it."""
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
    return out if first in out else None


# cuda.h CUgraphNodeType: kernel, memcpy, memset
GRAPH_DEVICE_NODES = (0, 1, 2)


def graph_launches(fn) -> int:
    """Device launches (kernels, memsets and copies) of one call of fn,
    counted as the nodes of a CUDA graph captured from the call. fn must
    not wait for the device (the wrappers' `__wrapped__`, without the
    profiling hook's events)."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    need(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
         "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    need(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
         "cuGraphGetNodes failed")
    count = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        need(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) == 0,
             "cuGraphNodeGetType failed")
        count += kind.value in GRAPH_DEVICE_NODES
    g.reset()
    return count


def launch_limit(what: str, fn, most: int) -> int:
    """Hold one call of fn to at most `most` device launches
    (graph_launches); returns the count."""
    per_call = graph_launches(fn)
    need(per_call <= most, f"{what}: {per_call} device launches a call, "
                           f"want at most {most}")
    return per_call


def _sorted(name: str, fn) -> tuple:
    """One call of fn: (its result, the passes its round sort ran)."""
    from cassandra_tpu_torch.ops import cuda_lib
    out = fn()
    return out, cuda_lib.last_sort(name)["passes"]


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
    to N cells; exact equality; warm times; K2 and K3 held to their
    device launches a call (`launch_limit`)."""
    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.ops import merge as dm

    n, K = round_cells_for(N), LANES
    # about one identity per cell, so a small round holds duplicates
    # (the ambiguous bit) as the planned round does
    parts = min(STCS_PARTITIONS, max(8, n // 64))
    ops = dm.operands_to_device(make_round(seed, n, N, K, parts),
                                torch.device(DEVICE))

    # K1 sort
    perm, passes = _sorted("merge.sort_perm",
                           lambda: dm.device_sort_perm(ops))
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
           passes=passes, key_bytes=plan["key_bytes"],
           steps=sort_breakdown(lambda: dm.device_sort_perm(ops)),
           **work("sort_perm", N, K))

    # K2 reconcile: against the plain version and the mirror of its
    # tiles, here and on a round with a deletion at every tile's edges
    packed = dm.reconcile_kernel(ops, perm)
    packed_p = dm.reconcile_plain(ops, perm)
    torch.cuda.synchronize()
    err = max(max_abs_err(packed, packed_p),
              max_abs_err(dm.reconcile_tiled_plain(ops, perm), packed_p))
    edge_np, edge_perm = make_edge_round(seed + N, n, N)
    edge = dm.operands_to_device(edge_np, torch.device(DEVICE))
    edge_perm = torch.from_numpy(edge_perm).to(DEVICE)
    edge_p = dm.reconcile_plain(edge, edge_perm)
    err = max(err, max_abs_err(dm.reconcile_kernel(edge, edge_perm), edge_p),
              max_abs_err(dm.reconcile_tiled_plain(edge, edge_perm), edge_p))
    del edge
    need(err == 0, f"K2 reconcile at N={N}: kernel != plain "
                   f"(max abs err {err})")
    k2_steps = sort_breakdown(lambda: dm.reconcile_kernel(ops, perm),
                              "rec_tiles")
    k2_launches = launch_limit(
        f"K2 at N={N}", lambda: dm.reconcile_kernel.__wrapped__(ops, perm), 2)
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
           library_ms=None, steps=k2_steps, launches_a_call=k2_launches,
           **work("reconcile", N, K))

    # K3 kept-first compaction + gather: against the plain version and
    # the mirror of its tiles
    counts, perm_out, cols = dw.compact_gather(ops, perm, packed)
    err = 0
    for ref in (dw.compact_gather_plain(ops, perm, packed),
                dw.compact_gather_tiled_plain(ops, perm, packed)):
        err = max(err, max_abs_err(counts, ref[0]),
                  max_abs_err(perm_out, ref[1]),
                  *(max_abs_err(cols[k], ref[2][k])
                    for k in dw.RESIDENT_COLS))
    need(err == 0, f"K3 compact_gather at N={N}: kernel != plain "
                   f"(max abs err {err})")
    k3_steps = sort_breakdown(lambda: dw.compact_gather(ops, perm, packed),
                              "cmp_partition")
    raw = dw.compact_gather.__wrapped__
    k3_launches = launch_limit(f"K3 at N={N}",
                               lambda: raw(ops, perm, packed), 3)

    def library_k3():
        keep = (packed & 1) != 0
        order = torch.cat([torch.nonzero(keep).flatten(),
                           torch.nonzero(~keep).flatten()])
        p = perm.index_select(0, order).to(torch.int64)
        return [ops[k].index_select(0, p) for k in dw.RESIDENT_COLS]

    _entry(res, "K3", "write.compact_gather", N, err=err,
           ms=cuda_ms(lambda: dw.compact_gather(ops, perm, packed)),
           graph_ms=graph_ms(lambda: raw(ops, perm, packed),
                             calls=20 if N <= 1 << 20 else 4),
           plain_ms=cuda_ms(
               lambda: dw.compact_gather_plain(ops, perm, packed), reps=3),
           library_ms=cuda_ms(library_k3, reps=3), steps=k3_steps,
           launches_a_call=k3_launches,
           **work("compact_gather", N, K))


def check_segment(seed: int, seg_n: int, res: dict) -> None:
    """K4 against its plain version and the host build_meta_block on one
    segment of seg_n cells with extreme timestamps; exact equality; at
    most two device launches a call."""
    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.storage.cellbatch import DEATH_FLAGS
    from cassandra_tpu_torch.storage.sstable.writer import build_meta_block

    dev = torch.device(DEVICE)
    ts, seg_np = make_segment(seed + 1, seg_n)
    seg = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev) for a in seg_np]
    meta, st = dw.meta_block_kernel(*seg)
    err = 0
    for ref in (dw.meta_block_plain(*seg), dw.meta_block_tiled_plain(*seg)):
        err = max(err, max_abs_err(meta, ref[0]), max_abs_err(st, ref[1]))
    need(err == 0, f"K4 meta_block at n={seg_n}: kernel != plain "
                   f"(max abs err {err})")
    host = build_meta_block(ts, seg_np[2], seg_np[3], seg_np[4],
                            seg_np[5].astype("<u4"), seg_np[6].astype("<u4"))
    block = dw.meta_block_buffer(*seg).cpu().numpy()
    need(bytes(block[:25 * seg_n]) == bytes(host),
         "K4 meta_block: kernel != host build_meta_block")
    stats = dw.stats_of_block(block, seg_n)
    need(stats == (int(ts.min()), int(ts.max()), int(seg_np[2].min()),
                   int(seg_np[2].max()),
                   int(((seg_np[4] & DEATH_FLAGS) != 0).sum())),
         f"K4 meta_block: stats {stats} disagree with the host")
    k4_steps = sort_breakdown(lambda: dw.meta_block_kernel(*seg),
                              "meta_tiles")
    raw = dw.meta_block_buffer.__wrapped__
    k4_launches = launch_limit(f"K4 at n={seg_n}", lambda: raw(*seg), 2)
    _entry(res, "K4", "write.meta_block", seg_n, err=err,
           ms=cuda_ms(lambda: dw.meta_block_buffer(*seg), reps=50),
           graph_ms=graph_ms(lambda: raw(*seg)),
           plain_ms=cuda_ms(lambda: dw.meta_block_plain(*seg), reps=3),
           library_ms=None, steps=k4_steps, launches_a_call=k4_launches,
           **work("meta_block", seg_n))


def check_scan(seed: int, seg_n: int, res: dict) -> None:
    """K5 against its plain version on one full segment (make_segment's
    META block, a sorted stcs-like lane slice) and on an unsorted copy,
    exact equality; the emitted LZ4 blocks against the native encoder;
    the D2H of the results and the host emission timed on their own; at
    most two device launches a call."""
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
    lanes = torch.from_numpy(lanes_np.view(np.int32)).to(dev)
    out = dc.segment_scan(meta, lanes)
    # the mirror of the kernel's tiles and word compares
    for src, bl, bd in ((meta, out[1], out[2]), (out[0], out[3], out[4])):
        tl, td = dc.policy_scan_tiled_plain(src)
        err = max(err, max_abs_err(bl, tl), max_abs_err(bd, td))
    need(err == 0, f"K5 segment_scan at n={seg_n}: kernel != plain "
                   f"(max abs err {err})")
    k5_steps = sort_breakdown(lambda: dc.segment_scan(meta, lanes),
                              "lz_segment")
    k5_launches = launch_limit(
        f"K5 at n={seg_n}",
        lambda: dc.segment_scan.__wrapped__(meta, lanes), 2)
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
    _entry(res, "K5", "write.segment_scan", seg_n, err=err,
           ms=cuda_ms(lambda: dc.segment_scan(meta, lanes), reps=5),
           plain_ms=cuda_ms(lambda: dc.segment_scan_plain(meta, lanes),
                            reps=2, warm=1),
           library_ms=None, d2h_ms=host_ms(pulled), emit_ms=emit_ms,
           longest_run=longest, steps=k5_steps,
           launches_a_call=k5_launches,
           sizes_lz4=[len(b) for b in blocks],
           **work("segment_scan", meta_np.size, planes.size,
                  len(dc.DISTANCES)))


def plane_cells_for(N: int) -> int:
    """Live cells of the synthetic plane rounds checked at padded N."""
    return N - N // 16


def check_planes(seed: int, N: int, res: dict) -> None:
    """K6 and K7 against their plain versions on synthetic rounds padded
    to N, exact equality, with the passes their round sorts ran equal
    to the plan's; the K7 round must hold keep, ambiguous and shadowed
    rows."""
    from cassandra_tpu_torch.ops import merge as dm

    dev = torch.device(DEVICE)
    n = plane_cells_for(N)
    buf, cfg = make_fast_round(seed + 3, n, N)
    b = dm.planes_to_device(buf, dev)
    out, passes = _sorted("merge.plane_fast",
                          lambda: dm.plane_program_fast(b, cfg))
    ref = dm.plane_program_fast_plain(b, cfg)
    torch.cuda.synchronize()
    err = max_abs_err(out, ref)
    need(err == 0, f"K6 plane_fast at N={N}: kernel != plain "
                   f"(max abs err {err})")
    plan = dm.sort_plan_plain(dm.fast_sort_key(b, cfg))
    need(passes == plan["passes"], f"K6 at N={N}: {passes} passes run, "
                                   f"the plan has {plan['passes']}")
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
           passes=passes, key_bytes=plan["key_bytes"],
           steps=sort_breakdown(lambda: dm.plane_program_fast(b, cfg)),
           **work("plane_fast", buf.size, N))

    planes, cfg2 = make_v2_round(seed + 4, n, N)
    p = dm.planes_to_device(planes, dev)
    out2, passes2 = _sorted("merge.plane_v2",
                            lambda: dm.plane_program(p, cfg2))
    ref2 = dm.plane_program_plain(p, cfg2)
    torch.cuda.synchronize()
    err2 = max_abs_err(out2, ref2)
    need(err2 == 0, f"K7 plane_v2 at N={N}: kernel != plain "
                    f"(max abs err {err2})")
    plan2 = dm.sort_plan_plain(dm.v2_sort_key(p, cfg2))
    need(passes2 == plan2["passes"], f"K7 at N={N}: {passes2} passes run, "
                                     f"the plan has {plan2['passes']}")
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
           passes=passes2, key_bytes=plan2["key_bytes"],
           steps=sort_breakdown(lambda: dm.plane_program(p, cfg2)),
           **work("plane_v2", sum(np.asarray(v).nbytes
                                  for v in planes.values()), N))


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
        ops_ms[op] = cuda_ms(lambda: ds.scan_mask(kc, op, qk),
                             reps=SCAN_REPS)
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
           library_ms=cuda_ms(lambda: torch.eq(kc, q_i64), reps=SCAN_REPS),
           graph_ms=graph_ms(lambda: raw(kc, "eq", q1)),
           library_graph_ms=graph_ms(lambda: torch.eq(kc, q_i64)),
           ops_ms=ops_ms, hits=hits, **work("scan_mask", n))


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
           library_ms=None, selected=int(lt.sum()),
           **work("scan_fold", n))


def select_k(srt: dict) -> int:
    """The k above the fused path's K_FUSED checked on the select path:
    the first from K_FUSED + 1 whose k-th and (k+1)-th scores are
    further apart than the tolerance for every similarity (`srt`: each
    similarity's scores, sorted descending), so that the top k is
    decided at float32 precision."""
    from cassandra_tpu_torch.ops import ann
    for k in range(ann.K_FUSED + 1, ann.K_FUSED + 65):
        if all(float(v[k - 1] - v[k]) > ANN_TOL[sim]
               for sim, v in srt.items()):
            return k
    raise SmokeError("K10: no k in K_FUSED + 1..64 whose top k is decided")


def check_ann(seed: int, n: int, res: dict, d: int = ANN_DIM) -> None:
    """K10 against its plain version on an n x d gaussian matrix on the
    card for the three similarities, at k = 10 and 100 (the fused path)
    and at one k above K_FUSED (the select path): equal indices, scores
    within ANN_TOL, and the plain version's k-th and (k+1)-th scores
    further apart than the tolerance (else the top k is not decided at
    float32 precision); at k = 10 and 100 the fused path's output also
    equals the select path's bit for bit on the same inputs (both
    timed). The numbers kept at the top are dot at k = 10, which
    torch.topk(m @ q, k) also computes."""
    from cassandra_tpu_torch.ops import ann, cuda_lib

    dev = torch.device(DEVICE)
    need(cuda_lib.lib().ctpu_ann_k_fused() == ann.K_FUSED,
         "K10: the kernel's K_FUSED differs from ops/ann.py's")
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    m = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(d, generator=g, device=dev)
    qn = q / q.norm().clamp_min(1e-9)
    queries = {sim: qn if sim == "cosine" else q for sim in ann.SIMILARITIES}
    srt = {sim: torch.sort(ann.scores_plain(m, qq, sim),
                           descending=True).values
           for sim, qq in queries.items()}
    ks = ANN_KS + (select_k(srt),)
    cases, err = {}, 0.0
    for sim, qq in queries.items():
        for k in ks:
            s, i = ann.ann_topk(m, qq, k, sim)
            sp, ip = ann.ann_topk_plain(m, qq, k, sim)
            torch.cuda.synchronize()
            gap = float(srt[sim][k - 1] - srt[sim][k])
            need(gap > ANN_TOL[sim], f"K10 {sim} k={k}: the k-th and "
                 f"(k+1)-th scores are {gap} apart, within the tolerance")
            need(torch.equal(i, ip), f"K10 {sim} k={k}: kernel indices "
                                     "!= plain")
            e = float((s - sp).abs().max())
            need(e <= ANN_TOL[sim], f"K10 {sim} k={k}: scores differ by "
                                    f"{e} > {ANN_TOL[sim]}")
            err = max(err, e)
            fused = k <= ann.K_FUSED
            select_ms = None
            if fused:
                ss, si = ann.ann_topk_select_cuda(m, qq, k, sim)
                need(torch.equal(si, i) and torch.equal(
                    ss.view(torch.int32), s.view(torch.int32)),
                    f"K10 {sim} k={k}: the fused path != the select path")
                select_ms = cuda_ms(
                    lambda: ann.ann_topk_select_cuda(m, qq, k, sim), reps=5)
            lib = None
            if sim == "dot":
                li = torch.topk(m @ qq, k).indices.to(torch.int32)
                need(torch.equal(li, i), "K10: torch.topk disagrees")
                lib = cuda_ms(lambda: torch.topk(m @ qq, k), reps=5)
            cases[f"{sim}/k={k}"] = {
                "path": "fused" if fused else "select",
                "ms": cuda_ms(lambda: ann.ann_topk(m, qq, k, sim), reps=5),
                "select_ms": select_ms,
                "plain_ms": cuda_ms(
                    lambda: ann.ann_topk_plain(m, qq, k, sim), reps=2),
                "library_ms": lib, "max_abs_err": e,
                "bound_ms": bound_ms(*work("ann", n, d, k, sim).values()),
                "kth_gap": gap}
    top = cases[f"dot/k={ANN_KS[0]}"]
    _entry(res, "K10", "index.ann", n, err=err, ms=top["ms"],
           plain_ms=top["plain_ms"], library_ms=top["library_ms"],
           cases=cases, **work("ann", n, d, ANN_KS[0], "dot"))


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
    (perm, packed, stats), passes = _sorted(
        "mesh.sharded_step", lambda: pm.sharded_step(ops))
    perm_p, packed_p, stats_p = pm.sharded_step_plain(ops)
    torch.cuda.synchronize()
    err = max(max_abs_err(perm, perm_p), max_abs_err(packed, packed_p),
              max_abs_err(stats, stats_p))
    flat = {k: (v.reshape(S * N, -1) if k == "lanes" else v.reshape(-1))
            if torch.is_tensor(v) else v for k, v in ops.items()}
    gperm = (perm + torch.arange(S, device=perm.device,
                                 dtype=perm.dtype)[:, None] * N).reshape(-1)
    err = max(err, max_abs_err(
        dm.reconcile_tiled_plain(flat, gperm, seg_len=N), packed.reshape(-1)))
    del flat, gperm
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
           passes=passes, key_bytes=plan["key_bytes"],
           steps=sort_breakdown(lambda: pm.sharded_step(ops)),
           **work("mesh_step", S, N, LANES))


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
                lk = r.get("library_with_key_ms")
                print(f"  {kid} sort passes run {r['passes']} of "
                      f"{r['key_bytes']} launched, library with its key "
                      "built " + ("n/a" if lk is None else f"{lk:.4f} ms")
                      + "; device [launches, ms] by step: "
                      + ("not measured" if r["steps"] is None else
                         json.dumps({k: [c, round(t, 4)] for k, (c, t)
                                     in sorted(r["steps"].items())})),
                      flush=True)
            elif kid in ("K2", "K3", "K4", "K5"):
                print(f"  {kid} device launches a call (CUDA graph nodes) "
                      f"{r['launches_a_call']}; [launches, ms] by step "
                      "(torch.profiler): "
                      + ("not measured" if r.get("steps") is None else
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
                    sel = ("" if c["select_ms"] is None else
                           f", the select path {c['select_ms']:.4f} ms "
                           "(bit-equal)")
                    print(f"  K10 {case} ({c['path']} path): kernel "
                          f"{c['ms']:.4f} ms{sel}, plain "
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
    from cassandra_tpu_torch.ops import device_scan as ds
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.utils import pipeline_ledger

    need(ds.RUN_KEYS == RUN_KEYS, "read: device_scan.RUN_KEYS moved")
    st_filter = pipeline_ledger.ledger("scan").stage("filter")
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
                d0 = METRICS.counter("scan.device_segments")
                b0, i0 = st_filter.busy_s, st_filter.items
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
                # Phase A's masks: the K9 launches beside the aggregate
                # fold's (one mask per fold); at most one run per (lane,
                # source) and one more per half cap of device keys (two
                # neighbouring runs hold more than the cap)
                dev_segs = METRICS.counter("scan.device_segments") - d0
                phase_a = launches["K9"] - launches["K9f"]
                runs_max = min(dev_segs, max(lanes, 1) * SCAN_RUNS + 2 * (
                    st_filter.items - i0) // ds.RUN_KEYS)
                filter_s = st_filter.busy_s - b0
                print(f"  read [{name}] {tag}: {shown} in {ms:.1f} ms; K9 "
                      f"launches: mask {launches['K9']} (Phase A "
                      f"{phase_a}, at most {runs_max} runs over "
                      f"{dev_segs} device segments), fold "
                      f"{launches['K9f']}; filter stage {filter_s:.4f} s; "
                      f"by size {by_size}", flush=True)
                if on:
                    need(0 < phase_a <= runs_max,
                         f"read [{name}] {tag}: {phase_a} Phase A masks, "
                         f"more than the {runs_max} runs the cap allows")
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
                             "launches": launches, "ms": ms,
                             "filter_s": filter_s})
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
            del dev_ops
        else:
            rep["k8_ms"] = None
        print(f"  {rep['case']}: merge wall {rep['merge_wall_s']:.4f} s, "
              f"device walls {[round(w, 4) for w in rep['device_walls_s']]}"
              f" s, dispatch {rep['dispatch_s']:.4f} s, overlap "
              f"{rep['overlap_factor']:.2f}, K8 at {rep['step']} "
              + ("not measured" if rep["k8_ms"] is None
                 else f"{rep['k8_ms']:.4f} ms")
              + f", K8 launches {rep['launches'].get('K8', 0)}, sort "
              f"passes {rep['passes']}", flush=True)
    return {"sizes": sizes, "legs": legs, "reports": reports}


# ------------------------------------------------------------ 8. tools --

# cassandra-stress's documented `write n=1000000` (the tool's docstring)
STRESS_ROWS = 1_000_000
# the smoke's stress rows, a cut of STRESS_ROWS (printed as `reduced`)
# to the floor of 200,000: the tools are host-bound Python (on the
# H100's host, about 2,200 writes/s and 134 reads/s, PERF.md section
# 5), so (a) and (b) take about 410 s, and phase 8 runs beside phases
# 4 and 6 in processes of its own
STRESS_ROWS_RUN = 200_000
# stress.read's keys: a tenth of the rows before phase 5 left the main
# process; the stress process is then the smoke's longest (its 20,000
# reads took 152.0 s of its 397.4 s beside five other processes on the
# H100's 8-core host, PERF.md section 5), so a twentieth (`reduced`)
STRESS_READS = STRESS_ROWS_RUN // 10
STRESS_READS_RUN = STRESS_ROWS_RUN // 20
# at least this many sstables before the major compaction
STRESS_SSTABLES = 4
# memtable bytes a stress.standard1 row holds (key and four 34 B blobs,
# measured on the port's memtable): sizes the flush threshold
STRESS_ROW_BYTES = 324
# harry: OpGenerator's mix without range deletions (a round holding a
# range tombstone's bound merges on the host, as in the JAX package),
# on enough partitions that the compaction writes a full segment (K4,
# K5): over 1,024 partitions of 64 rows the partition deletions hold
# the output below one segment at 100,000 and 200,000 ops
HARRY_OPS = 150_000
HARRY_PKS = 2048
HARRY_CKS = 64
HARRY_FLUSH_EVERY = 15_000
HARRY_SKIP = ("del_range",)
HARRY_DDL = ("CREATE TABLE t (k int, c int, v text, w int, st text static, "
             "m map<text,int>, PRIMARY KEY (k, c))")
# the processes started after phase 3, each run beside phases 4 and 6:
# phase 8's two (harry's runs phase 11 after it), phase 9's, phase 10's
# and phase 5's
TOOLS_PARTS = ("stress", "harry", "cluster", "net", "read")
# seconds after the smoke's start by which those processes must end
TOOLS_DEADLINE_S = 1000


def _kernel_launches(ids: dict) -> dict:
    from cassandra_tpu_torch.ops import cuda_lib
    return {ids[k]: v for k, v in cuda_lib.launches().items() if k in ids}


def _launch_sizes(ids: dict) -> dict:
    from cassandra_tpu_torch.ops import cuda_lib
    return {ids[k]: v for k, v in cuda_lib.launch_sizes().items()
            if k in ids and v}


def tools_compaction(label: str, data_dir: str, table, work: str,
                     ids: dict, must: tuple, **task_kw) -> dict:
    """A major compaction of `table` in the closed engine directory
    data_dir (every row flushed; its commit log is not copied):
    compact_leg on one copy with the native engine and on another
    through CompactionTask(engine="device") on the card, launch
    counters reset just before the device leg and read just after. The
    outputs must be sha256-equal and every kernel in `must` must
    launch. Returns the device leg; its `root` holds the compacted
    engine directory."""
    from cassandra_tpu_torch.ops import cuda_lib

    roots = {}
    for leg in ("native", "device"):
        roots[leg] = os.path.join(work, f"{label}-{leg}")
        shutil.copytree(data_dir, roots[leg],
                        ignore=shutil.ignore_patterns("commitlog"))
    native = compact_leg(roots["native"], table, engine="native")
    shutil.rmtree(roots["native"], ignore_errors=True)
    cuda_lib.reset_launches()
    leg = compact_leg(roots["device"], table, engine="device",
                      device=DEVICE, **task_kw)
    leg.update(name=label, src="tools", root=roots["device"],
               native_wall=native["wall"],
               launches=_kernel_launches(ids), sizes=_launch_sizes(ids))
    print_leg(f"{label} (native {native['wall']:.3f} s)", leg)
    need(leg["hashes"] == native["hashes"],
         f"{label}: the device compaction differs from the native one")
    print(f"    sha256 equal to native over {len(leg['hashes'])} "
          f"components", flush=True)
    for kid in must:
        need(leg["launches"][kid] > 0, f"{label}: {kid} was not launched")
    return leg


def _repl(session, stmts: str) -> str:
    import io

    from cassandra_tpu_torch.tools import cqlsh
    out = io.StringIO()
    cqlsh.repl(session, stdin=io.StringIO(stmts + "\nEXIT\n"), stdout=out)
    return out.getvalue()


def tools_copy(s, n: int, work: str) -> dict:
    """(b) cqlsh COPY TO a CSV from the compacted table, COPY FROM it
    into a fresh card engine, flush, COPY TO again: the CSVs must be
    byte-equal and hold n rows."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.tools import stress

    first = os.path.join(work, "copy-1.csv")
    second = os.path.join(work, "copy-2.csv")
    t0 = time.perf_counter()
    out = _repl(s, f"COPY stress.standard1 TO '{first}';")
    need(f"Exported {n} rows to {first}" in out, f"copy: {out[-300:]}")
    t_to = time.perf_counter() - t0
    eng = StorageEngine(os.path.join(work, "tools-copy"), Schema(),
                        device=DEVICE)
    try:
        s2 = Session(eng)
        stress.setup(s2)
        need("standard1" in eng.schema.keyspaces["stress"].tables,
             "copy: setup() made no stress.standard1")
        t0 = time.perf_counter()
        out = _repl(s2, f"COPY stress.standard1 FROM '{first}';")
        need(f"Imported {n} rows from {first}" in out, f"copy: {out[-300:]}")
        t_from = time.perf_counter() - t0
        eng.store("stress", "standard1").flush()
        t0 = time.perf_counter()
        out = _repl(s2, f"COPY stress.standard1 TO '{second}';")
        need(f"Exported {n} rows to {second}" in out, f"copy: {out[-300:]}")
        t_again = time.perf_counter() - t0
    finally:
        eng.close()
    with open(first, "rb") as f1, open(second, "rb") as f2:
        a, b = f1.read(), f2.read()
    need(a == b, "copy: the second export differs from the first")
    need(a.count(b"\n") == n + 1, "copy: the CSV does not hold n rows")
    print(f"  copy: COPY TO {t_to:.3f} s, COPY FROM {t_from:.3f} s, COPY "
          f"TO again {t_again:.3f} s; {n} rows, {len(a)} bytes, "
          f"byte-equal", flush=True)
    return {"to_s": t_to, "from_s": t_from, "again_s": t_again,
            "bytes": len(a)}


def tools_sstabletools(eng, s, cells: int, key: int) -> dict:
    """(c) sstabletools over the engine's compacted sstables (`cells`
    read back from them): verify passes, the metadata's cell counts
    sum to the cells read back, and the dump of a partition equals a
    SELECT of it."""
    from cassandra_tpu_torch.tools import sstabletools as sst

    ver = sst.verify(eng.data_dir, "stress", "standard1")
    need(ver and all(v["status"] == "ok" for v in ver),
         f"sstabletools: verify {ver}")
    meta = sst.metadata(eng.data_dir, "stress", "standard1")
    need(sum(m["cells"] for m in meta) == cells,
         f"sstabletools: metadata counts {[m['cells'] for m in meta]}, "
         f"read back {cells}")
    dumped = sst.dump(eng.data_dir, "stress", "standard1",
                      generation=meta[-1]["generation"])
    rows = [r for r in dumped[0]["rows"] if r["key"] == key]
    rs = s.execute("SELECT * FROM stress.standard1 WHERE key = ?", [key])
    want = [dict(zip(rs.column_names, r)) for r in rs.rows]
    need(len(rows) == 1 and rows == want,
         f"sstabletools: dump of key {key} {rows} != SELECT {want}")
    print(f"  sstabletools: verify ok on {len(ver)} sstables, metadata "
          f"{cells} cells, dump of key {key} equal to its SELECT",
          flush=True)
    return {"verified": len(ver), "cells": cells}


def tools_stress(work: str, n: int, ids: dict) -> dict:
    """(a) stress.write of n rows into stress.standard1, stress.read
    of STRESS_READS_RUN keys a STRESS_ROWS_RUN rows (all must hit),
    then the table's major compaction with
    device compress off (K1-K4 through the resident program) beside a
    native one; (b) COPY and (c) sstabletools on an engine reopened
    over the device leg's output. Each part's wall seconds."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.tools import stress

    secs = {}
    t0 = time.perf_counter()
    data = os.path.join(work, "tools-stress")
    # flush after a fifth of the rows: at least STRESS_SSTABLES sstables
    eng = StorageEngine(data, Schema(), device=DEVICE,
                        flush_threshold=n * STRESS_ROW_BYTES // 5)
    try:
        s = Session(eng)
        stress.setup(s)
        # setup() swallows its CREATE TABLE's failure: check for the table
        need("standard1" in eng.schema.keyspaces["stress"].tables,
             "stress: setup() made no stress.standard1")
        w = stress.write(s, n)
        cfs = eng.store("stress", "standard1")
        cfs.flush()
        n_sst = len(cfs.live_sstables())
        need(n_sst >= STRESS_SSTABLES,
             f"stress: {n_sst} sstables, fewer than {STRESS_SSTABLES}")
        reads = n * STRESS_READS_RUN // STRESS_ROWS_RUN
        r = stress.read(s, reads, keys=n)
        need(r["hits"] == reads,
             f"stress: {r['hits']} of {reads} reads hit")
        table = cfs.table
    finally:
        eng.close()
    print(f"  stress: write {json.dumps(w)}, {n_sst} sstables; read "
          f"{json.dumps(r)}", flush=True)
    # device compress off: that leg scans the payload on the host, at
    # about 72 s a million cells (PERF.md section 5)
    comp = tools_compaction("stress-compaction", data, table, work, ids,
                            ("K1", "K2", "K3", "K4"), device_compress=False)
    need(comp["launches"]["K5"] == 0,
         "stress: K5 ran with device compress off")
    secs["stress"] = time.perf_counter() - t0
    eng = StorageEngine(comp["root"], Schema(), device=DEVICE)
    try:
        s = Session(eng)
        t0 = time.perf_counter()
        cp = tools_copy(s, n, work)
        secs["copy"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools_sstabletools(eng, s, comp["read_back"], n // 3)
        secs["sstabletools"] = time.perf_counter() - t0
    finally:
        eng.close()
    return {"seconds": secs, "legs": [comp], "write": w, "read": r,
            "sstables": n_sst, "copy": cp}


def tools_harry(seed: int, work: str, ids: dict, ops: int | None = None,
                flush_every: int | None = None,
                must: tuple = ("K1", "K2", "K3", "K4", "K5")) -> dict:
    """(d) harry: `ops` generated ops (TTLs, cell, row, partition and
    collection deletions, statics; the kinds in HARRY_SKIP left out of
    the engine and the model alike) through a Session on the card, a
    flush every `flush_every` ops; every partition against the model,
    then a device major compaction in the default configuration beside
    a native one (tools_compaction; `must`: the kernels it must
    launch), then every partition again on an engine reopened over the
    device leg's output. One virtual clock (`advance` ops move it)
    drives the engines (timeutil.CLOCK) and the model."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.tools import harry
    from cassandra_tpu_torch.utils import timeutil

    ops = HARRY_OPS if ops is None else ops
    flush_every = HARRY_FLUSH_EVERY if flush_every is None else flush_every
    clock = {"now": int(time.time())}
    real_clock = timeutil.CLOCK
    timeutil.CLOCK = lambda: clock["now"]
    model = harry.Model()

    def check(s) -> float:
        t = time.perf_counter()
        for pk in range(HARRY_PKS):
            try:
                harry.check_partition(s, model, "t", pk, seed, ops,
                                      now=clock["now"])
            except AssertionError as e:
                raise SmokeError(f"harry: {e}") from None
        return time.perf_counter() - t

    secs = {}
    data = os.path.join(work, "tools-harry")
    t_all = t0 = time.perf_counter()
    try:
        eng = StorageEngine(data, Schema(), device=DEVICE)
        try:
            s = Session(eng)
            s.execute("CREATE KEYSPACE fz WITH replication = "
                      "{'class': 'SimpleStrategy', 'replication_factor': 1}")
            s.execute("USE fz")
            s.execute(HARRY_DDL)
            cfs = eng.store("fz", "t")
            gen = harry.OpGenerator(seed, n_pks=HARRY_PKS, n_cks=HARRY_CKS)
            kinds: dict = {}
            for op in gen:
                if op.index >= ops:
                    break
                if op.kind not in HARRY_SKIP:
                    kinds[op.kind] = kinds.get(op.kind, 0) + 1
                    if op.kind == "advance":
                        clock["now"] += op.seconds
                    elif op.kind not in ("flush", "compact"):
                        s.execute(op.cql("t"))
                    model.apply(op, now_s=clock["now"])
                if (op.index + 1) % flush_every == 0:
                    cfs.flush()
            secs["ops"] = time.perf_counter() - t0
            n_sst = len(cfs.live_sstables())
            need(n_sst == ops // flush_every, f"harry: {n_sst} sstables")
            secs["check"] = check(s)
            table = cfs.table
        finally:
            eng.close()
        comp = tools_compaction("harry-compaction", data, table, work, ids,
                                must)
        eng = StorageEngine(comp["root"], Schema(), device=DEVICE)
        try:
            s = Session(eng)
            s.execute("USE fz")
            secs["check_after"] = check(s)
        finally:
            eng.close()
    finally:
        timeutil.CLOCK = real_clock
    print(f"  harry: {ops} ops in {secs['ops']:.3f} s ({json.dumps(kinds)})"
          f", {n_sst} sstables; {HARRY_PKS} partitions equal to the model "
          f"before ({secs['check']:.3f} s) and after "
          f"({secs['check_after']:.3f} s) the compaction", flush=True)
    return {"seconds": {"harry": time.perf_counter() - t_all},
            "legs": [comp], "harry": secs, "kinds": kinds}


# ---------------------------------------------------------- 9. cluster --

# cassandra-stress's `write n=1000000 cl=QUORUM -schema
# replication(factor=3)` against a three-node cluster
CLUSTER_PUBLISHED = 1_000_000
# the cluster phase's rows, a cut of CLUSTER_PUBLISHED (printed as
# `reduced`): each node's commit log fsyncs every write (Node's
# commitlog_sync="batch"), about 300-400 QUORUM writes/s from one host
# process. Not below 15,000: under that a node's compaction input (five
# cells a row) holds less than one 65,536-cell segment, and K4 would
# not launch
CLUSTER_ROWS = 20_000
# the depth of the full repair's Merkle trees, a cut of RepairService's
# default of 10 (printed as `reduced`): the repair syncs each mismatched
# leaf on its own, fetching that leaf's range from each replica with a
# scan of the whole table, so its time grows as leaves x rows (at depth
# 10, 1,000 rows missing from one of three replicas took 61 s on one
# host core). Node 3 misses rows in every leaf, so depth 6 syncs about
# 2 x 2^6 leaves in place of 2 x 2^10
CLUSTER_TREE_DEPTH = 6
CLUSTER_TREE_DEPTH_DEFAULT = 10
CLUSTER_NODES = 3
CLUSTER_QUORUM_READS = 2_000
CLUSTER_ALL_READS = 500
# seconds a replica may take to apply what its coordinator acknowledged
CLUSTER_WAIT_S = 120.0


class QuarterHook:
    """The Session that stress.write drives, calling at(i) before the
    i-th INSERT: phase 9 flushes the replicas, and stops a node, between
    the quarters of one stress.write."""

    def __init__(self, session, at):
        self._session, self._at, self._i = session, at, 0

    def __getattr__(self, name):
        return getattr(self._session, name)

    def execute_prepared(self, qid, values):
        self._at(self._i)
        self._i += 1
        return self._session.execute_prepared(qid, values)


def stress_values(n: int, seed: int = 1, value_bytes: int = 34) -> list:
    """The four blobs stress.write(session, n, value_bytes, seed) writes
    for each key, drawn from the same generator in the same order."""
    import random
    rng = random.Random(seed)
    return [[rng.randbytes(value_bytes) for _ in range(4)]
            for _ in range(n)]


def cluster_rows(node) -> int:
    """The stress.standard1 rows node's own store holds (memtable and
    sstables), read from its engine, not through a coordinator."""
    batch = node.engine.store("stress", "standard1").scan_all()
    if len(batch) == 0:
        return 0
    # a row's identity: every lane before the column's (the last three
    # are the column id and the cell's path)
    return len(np.unique(np.asarray(batch.lanes)[:, :batch.n_lanes - 3],
                         axis=0))


def cluster_drain(nodes, rows: int) -> None:
    """Waits until every node in `nodes` holds `rows` rows: a QUORUM
    write's third replica may apply it after the coordinator returned."""
    for nd in nodes:
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while (have := cluster_rows(nd)) != rows:
            need(time.monotonic() < deadline,
                 f"cluster: {nd.endpoint.name} holds {have} of {rows} rows")
            time.sleep(0.05)


def cluster_flush(nodes) -> None:
    for nd in nodes:
        nd.engine.store("stress", "standard1").flush()


def cluster_reads(cluster, i: int, cl: str, n: int, rows: int,
                  values: list, seed: int) -> dict:
    """n random keys read through node i at `cl`; every key must return
    the row stress.write wrote for it."""
    import random

    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    nd = cluster.node(i)
    nd.default_cl = getattr(ConsistencyLevel, cl)
    s = nd.session()
    qid = s.prepare("SELECT * FROM stress.standard1 WHERE key = ?")
    keys = random.Random(seed).sample(range(rows), n)
    t0 = time.perf_counter()
    for k in keys:
        rs = s.execute_prepared(qid, (k,))
        got = [dict(zip(rs.column_names, r)) for r in rs.rows]
        want = {"key": k, **{f"c{j}": values[k][j] for j in range(4)}}
        need(got == [want], f"cluster: key {k} at {cl} through node{i}: "
                            f"{got!r:.200}")
    dt = time.perf_counter() - t0
    print(f"  cluster reads: {n} keys at {cl} through node{i}, every row "
          f"as written, {dt:.3f} s ({n / dt:.1f} reads/s)", flush=True)
    return {"n": n, "seconds": dt, "ops_s": n / dt}


def tools_cluster(seed: int, work: str, ids: dict,
                  rows: int | None = None) -> dict:
    """Phase 9: LocalCluster(3, rf=3) with every node's engine on the
    card, autocompaction off. (a) stress.write of `rows` rows through
    node 1 at QUORUM, every live replica drained and flushed after each
    quarter; node 3 is down, with hinted handoff off, for the last
    quarter, then restarted. (b) a full repair from node 1 (Merkle trees
    of CLUSTER_TREE_DEPTH, and streaming); node 3's own store then holds
    every row, and a preview repair finds no mismatched range. (c) per
    node, a major compaction of copies of its sstables with the native
    engine and through CompactionTask(engine="device"), sha256-equal
    (node 1 in the default configuration, K1-K5; nodes 2 and 3 with
    device compress off, K1-K4 and no K5), then the same device
    compaction of its live store, equal to the copy's. (d) reads at
    QUORUM through node 2 and at ALL through node 3 return the rows as
    written. The launch counters are reset just before each device
    compaction and read just after."""
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.tools import nodetool, stress

    rows = CLUSTER_ROWS if rows is None else rows
    if rows != CLUSTER_PUBLISHED:
        print(json.dumps({"reduced": {"phase": "cluster", "rows": rows,
                                      "published": CLUSTER_PUBLISHED}}),
              flush=True)
    print(json.dumps({"reduced": {
        "phase": "cluster", "merkle_depth": CLUSTER_TREE_DEPTH,
        "default": CLUSTER_TREE_DEPTH_DEFAULT}}), flush=True)
    secs: dict = {}
    t_all = t0 = time.perf_counter()
    c = LocalCluster(CLUSTER_NODES, os.path.join(work, "cluster"), rf=3,
                     device=DEVICE)
    try:
        kinds = sorted({nd.engine.device.type for nd in c.nodes})
        need(kinds == [torch.device(DEVICE).type],
             f"cluster: the nodes' engines run on {kinds}")
        for nd in c.nodes:
            nodetool.disableautocompaction(nd.engine)
        s = c.session(1)
        # before stress.setup, which would make it at RF 1
        s.execute("CREATE KEYSPACE stress WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        for nd in c.nodes:
            nd.default_cl = ConsistencyLevel.QUORUM
        quarter = rows // 4

        def at(i: int) -> None:
            if i == 0 or i % quarter:
                return
            live = c.nodes if i <= 2 * quarter else c.nodes[:2]
            cluster_drain(live, i)
            cluster_flush(live)
            if i == 3 * quarter:
                for nd in c.nodes:
                    nodetool.disablehandoff(nd)
                c.stop_node(3)

        w = stress.write(QuarterHook(s, at), rows)
        cluster_drain(c.nodes[:2], rows)
        cluster_flush(c.nodes[:2])
        behind = cluster_rows(c.node(3))
        need(behind == 3 * quarter,
             f"cluster: node3 holds {behind} rows while it was down")
        c.restart_node(3)
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while not all(a.is_alive(b.endpoint) for a in c.nodes
                      for b in c.nodes if a is not b):
            need(time.monotonic() < deadline,
                 "cluster: the nodes do not see each other after the "
                 "restart")
            time.sleep(0.05)
        secs["write"] = time.perf_counter() - t0
        print(f"  cluster write: {json.dumps(w)}; node3 down for the last "
              f"{rows - 3 * quarter} rows (acknowledged by two replicas)",
              flush=True)

        t0 = time.perf_counter()
        # nodetool repair --full, at the cut tree depth
        rep = c.node(1).repair.repair_table(
            "stress", "standard1", depth=CLUSTER_TREE_DEPTH)
        need(rep["ranges_synced"] > 0, f"cluster: the repair synced {rep}")
        cluster_drain([c.node(3)], rows)
        prev = c.node(1).repair.repair_table(
            "stress", "standard1", depth=CLUSTER_TREE_DEPTH, preview=True)
        need(prev["ranges_mismatched"] == 0,
             f"cluster: the preview after the repair found {prev}")
        secs["repair"] = time.perf_counter() - t0
        print(f"  cluster repair: {json.dumps(rep)}; node3 holds {rows} "
              f"rows; preview {json.dumps(prev)}; {secs['repair']:.3f} s",
              flush=True)

        t0 = time.perf_counter()
        cluster_flush(c.nodes)
        legs = []
        for i, nd in enumerate(c.nodes, 1):
            kw = {} if i == 1 else {"device_compress": False}
            must = ("K1", "K2", "K3", "K4") + (("K5",) if i == 1 else ())
            cfs = nd.engine.store("stress", "standard1")
            comp = tools_compaction(f"cluster-node{i}", nd.engine.data_dir,
                                    cfs.table, work, ids, must, **kw)
            comp["src"] = "cluster"
            shutil.rmtree(comp.pop("root"), ignore_errors=True)
            if i > 1:
                need(comp["launches"]["K5"] == 0,
                     f"cluster: K5 ran on node{i} with device compress off")
            legs.append(comp)
            with nd.engine.compactions.cfs_lock(cfs):
                task = CompactionTask(cfs, cfs.live_sstables(),
                                      engine="device", **kw)
                cuda_lib.reset_launches()
                t1 = time.perf_counter()
                stats = task.execute()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                live = _kernel_launches(ids)
                sizes = _launch_sizes(ids)
            hashes = component_hashes(cfs.directory)
            need(hashes == comp["hashes"],
                 f"cluster: node{i}'s live compaction differs from its "
                 f"copy's")
            need(all(live[k] > 0 for k in must),
                 f"cluster: node{i}'s live compaction launched {live}")
            print(f"  cluster node{i} live store: {stats['cells_read']} -> "
                  f"{stats['cells_written']} cells in {wall:.3f} s, equal "
                  f"to its copy's; launches {live}", flush=True)
            legs.append({"name": f"cluster-node{i}-live", "src": "cluster",
                         "launches": live, "sizes": sizes, "wall": wall})
        secs["compaction"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        values = stress_values(rows)
        reads = {"QUORUM": cluster_reads(c, 2, "QUORUM",
                                         CLUSTER_QUORUM_READS, rows, values,
                                         seed),
                 "ALL": cluster_reads(c, 3, "ALL", CLUSTER_ALL_READS, rows,
                                      values, seed + 1)}
        secs["read"] = time.perf_counter() - t0
    finally:
        c.shutdown()
    secs["cluster"] = time.perf_counter() - t_all
    print("  cluster: launches by node's compaction " + json.dumps(
        {g["name"]: {k: v for k, v in g["launches"].items() if v}
         for g in legs}), flush=True)
    return {"seconds": secs, "legs": legs, "write": w, "repair": rep,
            "reads": reads}


# ------------------------------------------------------------- 10. net --

# phase 9's deployment (cassandra-stress's `write n=1000000 cl=QUORUM
# -schema replication(factor=3)`) as three daemons over sockets. The
# rows written over the wire, a cut of CLUSTER_PUBLISHED (printed as
# `reduced`); not below 13,108: a node's compaction input (five cells a
# row) must hold a full 65,536-cell segment, or K4 and K5 do not launch
NET_ROWS = 14_000
NET_CONNECTIONS = 4
# the emb rows bulkloaded, a cut of phase 5's ANN_ROWS (printed as
# `reduced`): each replica applies them through its commit log, which
# fsyncs every mutation. At 100,000 the load took 194.9 s alone on the
# card's host (513 rows/s), past the room phase 9's process has beside
# phases 4 and 6, so it runs at its floor
NET_VECTORS = 20_000
NET_QUORUM_READS = 1_000
NET_ANN = ((10, 20), (100, 2))            # (k, queries) at ALL
NET_READY_S = 120.0
PR_SET_PDEATHSIG = 1                      # <linux/prctl.h>
NET_BULKLOAD_TIMEOUT_S = 600.0
NET_KS = "stress"
NET_IDS = {"standard1": "5d3c9a60-0000-4000-8000-00000000a001",
           "emb": "5d3c9a60-0000-4000-8000-00000000a002"}
NET_DDL = [
    f"CREATE KEYSPACE {NET_KS} WITH replication = {{'class': "
    "'SimpleStrategy', 'replication_factor': 3}",
    f"CREATE TABLE {NET_KS}.standard1 (key int PRIMARY KEY, c0 blob, "
    f"c1 blob, c2 blob, c3 blob) WITH id = {NET_IDS['standard1']}",
    f"CREATE TABLE {NET_KS}.emb (id int, c int, v vector<float, "
    f"{ANN_DIM}>, PRIMARY KEY (id, c)) WITH id = {NET_IDS['emb']}",
    f"CREATE CUSTOM INDEX ON {NET_KS}.emb (v) USING 'SAI'",
]


def free_ports(n: int) -> list:
    import socket
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


def die_with_parent():
    """A `preexec_fn` for the smoke's child processes (phases 8-10's and
    the daemons): the child asks the kernel for SIGKILL when the thread
    that started it ends (Linux's PR_SET_PDEATHSIG), so that none
    outlives a smoke or a tools process killed past its `finally`. A
    child whose parent ended before the call exits at once. Start the
    children from the thread that lives longest: the main one."""
    import ctypes
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    parent = os.getpid()

    def preexec() -> None:
        if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL) != 0 \
                or os.getppid() != parent:
            os._exit(1)
    return preexec


class Daemon:
    """One `python -m cassandra_tpu_torch.tools.noded cfg.json` process,
    its output in a log file; `ready()` waits for its READY line. It
    dies with the process that started it (die_with_parent)."""

    def __init__(self, name: str, cfg: dict, work: str):
        self.name, self.cfg = name, cfg
        path = os.path.join(work, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        self.log_path = os.path.join(work, f"{name}.log")
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cassandra_tpu_torch.tools.noded", path],
            cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT,
            preexec_fn=die_with_parent())
        self.native = self.admin = None

    def tail(self, n: int = 3) -> str:
        with open(self.log_path) as f:
            return " | ".join(f.read().strip().splitlines()[-n:])

    def ready(self, deadline: float) -> None:
        while True:
            with open(self.log_path) as f:
                line = next((ln for ln in f if ln.startswith("READY")), None)
            if line is not None:
                w = line.split()
                self.native = int(w[w.index("NATIVE") + 1])
                self.admin = int(w[w.index("ADMIN") + 1])
                return
            need(self.proc.poll() is None,
                 f"net: {self.name} exited with {self.proc.returncode}: "
                 f"{self.tail()}")
            need(time.monotonic() < deadline,
                 f"net: {self.name} printed no READY line: {self.tail()}")
            time.sleep(0.1)

    def call(self, cmd: str, args: dict | None = None,
             timeout: float = 30.0):
        from cassandra_tpu_torch.service.admin import admin_call
        return admin_call("127.0.0.1", self.admin, cmd, args,
                          timeout=timeout)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def start_daemons(work: str, n: int = CLUSTER_NODES) -> list:
    """n daemons on a static ring over TCP, RF 3 by their DDL; node 1
    in the default configuration, the others with device compress
    off. Their engines run on DEVICE (no `device` key: `cuda`)."""
    from cassandra_tpu_torch.cluster.ring import even_tokens

    ports = free_ports(n)
    tokens = even_tokens(n, vnodes=4)
    names = [f"node{i + 1}" for i in range(n)]

    def peer(i):
        return {"name": names[i], "host": "127.0.0.1", "port": ports[i],
                "tokens": tokens[i]}
    daemons = []
    for i in range(n):
        cfg = {**peer(i), "data_dir": os.path.join(work, "net", names[i]),
               "peers": [peer(j) for j in range(n) if j != i],
               "seeds": [names[0]], "gossip_interval": 0.2,
               "native_port": 0, "admin_port": 0, "ddl": NET_DDL}
        # a daemon coordinates at its configured level (the level a
        # request declares only tags its metrics): node 1, the ANN
        # coordinator, at ALL, nodes 2 and 3, which take the wire's
        # writes and reads, at QUORUM
        cfg["consistency"] = "ALL" if i == 0 else "QUORUM"
        if i > 0:
            cfg["config"] = {"compaction_device_compress": False}
        if DEVICE != "cuda":
            cfg["device"] = DEVICE
        daemons.append(Daemon(names[i], cfg, work))
    return daemons


def net_table_dir(daemon: Daemon, table: str) -> str:
    return os.path.join(daemon.cfg["data_dir"], NET_KS,
                        f"{table}-{NET_IDS[table].replace('-', '')[:8]}")


def net_drain(daemons: list, table: str, writes: int) -> None:
    """Waits until every daemon's table has applied `writes` mutations
    (tablestats `writes`): a QUORUM write's third replica may apply it
    after the coordinator answered."""
    for d in daemons:
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while (have := d.call("tablestats", {"keyspace": NET_KS})[
                f"{NET_KS}.{table}"]["writes"]) < writes:
            need(time.monotonic() < deadline,
                 f"net: {d.name} applied {have} of {writes} writes")
            time.sleep(0.1)


def net_k10(daemons: list) -> dict:
    """Each daemon's K10 counts: the wrapper's `calls` (the profiling
    registry, read over its native port from
    system_views.device_programs) and the kernel's launches on its card,
    in all and by matrix rows (cuda_lib's counters, read over its admin
    port through `nodetool profiler status`)."""
    from cassandra_tpu_torch.client import Cluster
    name = KERNEL_NAMES["K10"]
    out = {}
    for d in daemons:
        s = Cluster("127.0.0.1", d.native).connect()
        try:
            rows = s.execute("SELECT name, calls FROM "
                             "system_views.device_programs").rows
        finally:
            s.close()
        st = d.call("profiler", {"action": "status"})
        out[d.name] = {
            "calls": dict(rows).get(name, 0),
            "launches": st["launches"][name],
            "sizes": {int(n): c
                      for n, c in st["launch_sizes"][name].items()}}
    return out


def net_write(daemons: list, table, rows: int) -> dict:
    """stress.write's rows (stress_values) through NET_CONNECTIONS
    client connections, spread over the daemons coordinating at QUORUM
    (nodes 2 and 3), with a prepared INSERT; each connection writes
    every NET_CONNECTIONS-th key."""
    import threading

    from cassandra_tpu_torch.client import Cluster, serialize_params
    values = stress_values(rows)
    cols = ["key", "c0", "c1", "c2", "c3"]
    errors: list = []

    def one(c: int) -> None:
        try:
            d = daemons[1 + c % (len(daemons) - 1)]
            s = Cluster("127.0.0.1", d.native).connect()
            try:
                qid = s.prepare(f"INSERT INTO {NET_KS}.standard1 "
                                "(key, c0, c1, c2, c3) VALUES "
                                "(?, ?, ?, ?, ?)")
                for k in range(c, rows, NET_CONNECTIONS):
                    s.execute_prepared(qid, serialize_params(
                        table, cols, [k, *values[k]]), consistency="QUORUM")
            finally:
                s.close()
        except Exception as e:       # raised below, in the smoke's thread
            errors.append(f"connection {c}: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=one, args=(c,))
               for c in range(NET_CONNECTIONS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    need(not errors, f"net: the wire writes failed: {errors[:2]}")
    return {"n": rows, "seconds": dt, "ops_s": rows / dt,
            "connections": NET_CONNECTIONS}


def net_reads(daemon: Daemon, table, rows: int, n: int, seed: int) -> dict:
    """n random keys at QUORUM through `daemon`'s native port with a
    prepared SELECT: each must return the row as written."""
    import random

    from cassandra_tpu_torch.client import Cluster, serialize_params
    values = stress_values(rows)
    keys = random.Random(seed).sample(range(rows), n)
    s = Cluster("127.0.0.1", daemon.native).connect()
    try:
        qid = s.prepare(f"SELECT key, c0, c1, c2, c3 FROM {NET_KS}."
                        "standard1 WHERE key = ?")
        t0 = time.perf_counter()
        for k in keys:
            got = s.execute_prepared(qid, serialize_params(
                table, ["key"], [k]), consistency="QUORUM").rows
            need(got == [(k, *values[k])],
                 f"net: key {k} at QUORUM through {daemon.name}: "
                 f"{got!r:.200}")
        dt = time.perf_counter() - t0
    finally:
        s.close()
    return {"n": n, "seconds": dt, "ops_s": n / dt}


def net_bulkload(daemons: list, eng, seed: int) -> tuple:
    """NET_VECTORS gaussian emb rows written offline by `eng`, an engine
    of this process on DEVICE holding the daemons' tables, as SCAN_RUNS
    sstables, then streamed to every replica by `nodetool bulkload`
    through node 1's admin port. Returns (the float32 matrix, the load's
    answer, seconds)."""
    rng = np.random.default_rng(seed + 10)
    m = rng.standard_normal((NET_VECTORS, ANN_DIM)).astype(np.float32)
    t0 = time.perf_counter()
    cfs = eng.store(NET_KS, "emb")
    write_int_runs(cfs, np.arange(NET_VECTORS, dtype=np.int64),
                   np.zeros(NET_VECTORS, np.int64),
                   m.astype(">f4").view(np.uint8).reshape(NET_VECTORS, -1),
                   SCAN_RUNS, 1_000)
    directory = cfs.directory
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = daemons[0].call("bulkload", {"directory": directory,
                                       "keyspace": NET_KS, "table": "emb"},
                          timeout=NET_BULKLOAD_TIMEOUT_S)
    t_load = time.perf_counter() - t0
    need(out["sstables"] == SCAN_RUNS and out["partitions"] == NET_VECTORS,
         f"net: bulkload answered {out}")
    return m, out, {"offline_write": t_write, "bulkload": t_load}


def net_ann(daemon: Daemon, m: np.ndarray, seed: int) -> dict:
    """NET_ANN's queries at ALL through `daemon`: ids equal to the float64
    oracle, whose k-th and (k+1)-th scores lie further apart than
    ANN_TOL, and each returned row's vector, as it came over the wire,
    the loaded one. The server returns no scores, so over CQL the ids
    are K10's check, as in phase 5's CQL path."""
    from cassandra_tpu_torch.client import Cluster
    m64 = m.astype(np.float64)
    rng = np.random.default_rng(seed + 11)
    tol = ANN_TOL["cosine"]
    ms = []
    s = Cluster("127.0.0.1", daemon.native).connect()
    try:
        for k, count in NET_ANN:
            for _ in range(count):
                q = rng.standard_normal(ANN_DIM).astype(np.float32)
                lit = "[" + ", ".join(repr(float(x)) for x in q) + "]"
                t0 = time.perf_counter()
                rows = s.execute(f"SELECT id, v FROM {NET_KS}.emb ORDER BY "
                                 f"v ANN OF {lit} LIMIT {k}",
                                 consistency="ALL").rows
                ms.append((time.perf_counter() - t0) * 1e3)
                o_idx, o_s, nxt = ann_oracle(m64, q, k, "cosine")
                need(float(o_s[-1] - nxt) > tol,
                     f"net: ANN k={k}: the oracle's k-th and (k+1)-th "
                     f"scores {o_s[-1]} and {nxt} lie within {tol}")
                need([r[0] for r in rows] == o_idx.tolist(),
                     f"net: ANN k={k} ids differ from the oracle")
                # the server sends a vector as the text of its floats
                got = np.array([json.loads(r[1]) for r in rows],
                               dtype=np.float64)
                need(np.array_equal(got, m64[o_idx]),
                     f"net: ANN k={k}: a row's vector differs from the "
                     "loaded one")
    finally:
        s.close()
    return {"ms": ms, "queries": len(ms)}


def tools_net(seed: int, work: str, ids: dict,
              rows: int = NET_ROWS) -> dict:
    """Phase 10 (in phase 9's process, after it)."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine

    print(json.dumps({"reduced": {"phase": "net", "rows": rows,
                                  "published": CLUSTER_PUBLISHED}}),
          flush=True)
    print(json.dumps({"reduced": {"phase": "net", "vectors": NET_VECTORS,
                                  "published": ANN_ROWS}}), flush=True)
    secs: dict = {}
    legs: list = []
    t_all = t0 = time.perf_counter()
    # this process's engine: the daemons' tables (their DDL, their ids)
    # for the client's bind values and the compactions of the copies,
    # and the bulkload's offline writer
    eng = StorageEngine(os.path.join(work, "net-offline"), Schema(),
                        device=DEVICE)
    daemons: list = []
    try:
        s = Session(eng)
        for q in NET_DDL[:3]:
            s.execute(q)
        table = eng.schema.get_table(NET_KS, "standard1")
        daemons = start_daemons(work)
        deadline = time.monotonic() + NET_READY_S
        for d in daemons:
            d.ready(deadline)
        for d in daemons:
            d.call("disableautocompaction")
        while not all(e["status"] == "UN" for d in daemons
                      for e in d.call("status")):
            need(time.monotonic() < deadline,
                 "net: the daemons do not see each other alive")
            time.sleep(0.1)
        secs["net_start"] = time.perf_counter() - t0
        print(f"  net start: {len(daemons)} daemons ready and alive to "
              f"each other in {secs['net_start']:.3f} s (native ports "
              f"{[d.native for d in daemons]}, admin ports "
              f"{[d.admin for d in daemons]})", flush=True)

        t0 = time.perf_counter()
        w = net_write(daemons, table, rows)
        net_drain(daemons, "standard1", rows)
        flushed = [d.call("flush", {"keyspace": NET_KS,
                                    "table": "standard1"})
                   for d in daemons]
        secs["net_write"] = time.perf_counter() - t0
        print(f"  net write: {rows} rows at QUORUM over {NET_CONNECTIONS} "
              f"connections in {w['seconds']:.3f} s ({w['ops_s']:.1f} "
              f"writes/s); every replica drained and flushed "
              f"({flushed}) in {secs['net_write']:.3f} s", flush=True)

        t0 = time.perf_counter()
        m, load, ls = net_bulkload(daemons, eng, seed)
        for d in daemons:
            d.call("flush", {"keyspace": NET_KS, "table": "emb"})
        secs["net_bulkload"] = time.perf_counter() - t0
        print(f"  net bulkload: {NET_VECTORS} x {ANN_DIM} float32 written "
              f"offline in {ls['offline_write']:.3f} s, streamed to every "
              f"replica in {ls['bulkload']:.3f} s ({json.dumps(load)}), "
              f"flushed; {secs['net_bulkload']:.3f} s", flush=True)

        t0 = time.perf_counter()
        for i, d in enumerate(daemons, 1):
            kw = {} if i == 1 else {"device_compress": False}
            must = ("K1", "K2", "K3", "K4") + (("K5",) if i == 1 else ())
            stage = os.path.join(work, f"net-node{i}-src")
            src = net_table_dir(d, "standard1")
            shutil.copytree(src, os.path.join(
                stage, NET_KS, os.path.basename(src)))
            comp = tools_compaction(f"net-node{i}", stage, table, work, ids,
                                    must, **kw)
            comp["src"] = "net"
            shutil.rmtree(comp.pop("root"), ignore_errors=True)
            shutil.rmtree(stage, ignore_errors=True)
            if i > 1:
                need(comp["launches"]["K5"] == 0,
                     f"net: K5 ran on node{i}'s copy with device compress "
                     "off")
            legs.append(comp)
            t1 = time.perf_counter()
            got = d.call("compact", {"keyspace": NET_KS,
                                     "table": "standard1"},
                         timeout=CLUSTER_WAIT_S)
            wall = time.perf_counter() - t1
            hashes = component_hashes(src)
            need(hashes == comp["hashes"],
                 f"net: node{i}'s own compaction differs from the copies' "
                 f"({sorted(hashes)} against {sorted(comp['hashes'])})")
            print(f"  net node{i} `nodetool compact`: "
                  f"{got[0]['cells_read']} -> {got[0]['cells_written']} "
                  f"cells in {wall:.3f} s, sha256 equal to the copies' "
                  f"native and device outputs", flush=True)
        secs["net_compaction"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        r = net_reads(daemons[1], table, rows, NET_QUORUM_READS, seed)
        secs["net_read"] = time.perf_counter() - t0
        print(f"  net reads: {r['n']} keys at QUORUM through node2's "
              f"native port, every row as written, {r['seconds']:.3f} s "
              f"({r['ops_s']:.1f} reads/s)", flush=True)

        t0 = time.perf_counter()
        before = net_k10(daemons)
        ann = net_ann(daemons[0], m, seed)
        after = net_k10(daemons)
        secs["net_ann"] = time.perf_counter() - t0
        calls = {n: after[n]["calls"] - before[n]["calls"] for n in after}
        launched = {n: after[n]["launches"] - before[n]["launches"]
                    for n in after}
        sizes: dict = {}
        for n, a in after.items():
            for size, c in a["sizes"].items():
                c -= before[n]["sizes"].get(size, 0)
                if c:
                    sizes[size] = sizes.get(size, 0) + c
        need(all(c >= ann["queries"] for c in launched.values()),
             f"net: K10 launches rose by {launched} (calls by {calls}) "
             f"for {ann['queries']} queries: a replica did not serve its "
             "share on its card")
        print(f"  net ann: {ann['queries']} queries at ALL through node1 "
              f"({json.dumps(dict(NET_ANN))} by k), ids equal to the "
              f"float64 oracle; ms a query: first {ann['ms'][0]:.1f}, "
              f"rest {json.dumps([round(x, 1) for x in ann['ms'][1:]])}; "
              f"each daemon's K10 launches rose by {json.dumps(launched)} "
              f"(wrapper calls by {json.dumps(calls)}), by matrix rows "
              f"{json.dumps(sizes)}", flush=True)
        legs.append({"name": "net-ann", "src": "net daemons",
                     "launches": {"K10": sum(launched.values())},
                     "sizes": {"K10": sizes},
                     "calls": calls, "launched": launched})
    finally:
        for d in daemons:
            d.stop()
        eng.close()
    secs["net"] = time.perf_counter() - t_all
    print("  net: launches by leg " + json.dumps(
        {g["name"]: {k: v for k, v in g["launches"].items() if v}
         for g in legs}), flush=True)
    return {"seconds": secs, "legs": legs, "write": w, "reads": r,
            "ann": ann, "bulkload": load}


# ----------------------------------------------------------- 11. gates --

# the port's tier-2 gates phase 11 runs, in this order
GATES = ("check_compaction_ab", "check_scan_ab", "check_readpath_ab",
         "check_writepath_ab", "check_profiler", "chaos_storage",
         "stress_smoke")
# the compaction gate's legs through the device-resident lane, and
# those with device compression on (its mesh legs drain through the
# host writer: the plane programs, no resident round and no K5)
GATE_RESIDENT_LEGS = ("device", "device_compress", "device_compress_pool2")
GATE_COMPRESS_LEGS = ("device_compress", "device_compress_pool2")
GATE_DEVICE_LEGS = GATE_RESIDENT_LEGS + ("device_mesh2",
                                         "device_compress_mesh2")


def _gate_run(name: str, base: str, launches: dict) -> list:
    """One gate on DEVICE in its own directory: its divergences or
    violations (an empty list is a pass); the A/B gates that report
    their legs' launches put them in `launches`."""
    import importlib

    if name == "stress_smoke":
        from cassandra_tpu_torch.scripts import stress
        rc = stress.smoke(DEVICE, base_dir=base)
        return [] if rc == 0 else [f"stress --smoke exit code {rc}"]
    mod = importlib.import_module(f"cassandra_tpu_torch.scripts.{name}")
    if name == "chaos_storage":
        return mod.run_drill(base, device=DEVICE)
    if name in ("check_compaction_ab", "check_scan_ab"):
        return mod.run_check(base, device=DEVICE, launches=launches)
    return mod.run_check(base, device=DEVICE)


def _by_kid(ids: dict, launches: dict) -> dict:
    return {ids[k]: v for k, v in launches.items() if k in ids and v}


def tools_gates(work: str, ids: dict) -> dict:
    """Phase 11: the port's gates (GATES) on the card, each in a
    directory of its own under work/gates, the launch counters reset
    before each and read after it."""
    from cassandra_tpu_torch.ops import cuda_lib

    secs, legs = {}, []
    t_all = time.perf_counter()
    for name in GATES:
        base = os.path.join(work, "gates", name)
        os.makedirs(base)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        leg_launches: dict = {}
        errs = _gate_run(name, base, leg_launches)
        torch.cuda.synchronize()
        secs[f"gate_{name}"] = time.perf_counter() - t0
        launches = _kernel_launches(ids)
        sizes = _launch_sizes(ids)
        shutil.rmtree(base, ignore_errors=True)
        need(errs == [], f"gates: {name}: " + " | ".join(errs[:3]))
        print(f"  gate {name}: zero divergence in "
              f"{secs[f'gate_{name}']:.3f} s; launches "
              + json.dumps({k: v for k, v in launches.items() if v}),
              flush=True)
        if name == "check_compaction_ab":
            per_leg = {tag: _by_kid(ids, n)
                       for tag, n in leg_launches.items()}
            print("    launches by leg " + json.dumps(per_leg), flush=True)
            for tag in GATE_RESIDENT_LEGS:
                for kid in ("K1", "K2", "K3", "K4"):
                    need(per_leg[tag].get(kid, 0) > 0,
                         f"gates: compaction leg {tag}: {kid} was not "
                         "launched")
            for tag in GATE_COMPRESS_LEGS:
                need(per_leg[tag].get("K5", 0) > 0,
                     f"gates: compaction leg {tag}: K5 was not launched")
            for tag in GATE_DEVICE_LEGS:
                need(sum(per_leg[tag].values()) > 0,
                     f"gates: compaction leg {tag} launched no kernel")
        elif name == "check_scan_ab":
            per_leg = {leg: _by_kid(ids, n)
                       for leg, n in leg_launches.items()}
            print("    launches by leg " + json.dumps(per_leg), flush=True)
            for leg in ("device", "mesh2"):
                need(per_leg[leg].get("K9", 0) > 0,
                     f"gates: scan leg {leg}: K9 was not launched")
            for leg in ("naive", "host"):
                need(not per_leg[leg].get("K9"),
                     f"gates: scan leg {leg} launched K9")
        legs.append({"name": name, "src": "gates", "launches": launches,
                     "sizes": sizes})
    secs["gates"] = time.perf_counter() - t_all
    print("  gates: seconds " + json.dumps(
        {k: round(v, 3) for k, v in secs.items()}), flush=True)
    return {"seconds": secs, "legs": legs}


def tools_child(part: str, seed: int, work: str) -> int:
    """One process started after phase 3 (`part` of TOOLS_PARTS): phase
    8's stress or harry (harry's then runs phase 11), phase 9, phase 10
    or phase 5, on the kernels phase 2 built: its lines on stdout, its
    result as JSON in work/tools-<part>.json, with its wall seconds."""
    from cassandra_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    cuda_lib.lib()
    ids = {name: kid for kid, name in KERNEL_NAMES.items()}
    if part == "stress":
        out = tools_stress(work, STRESS_ROWS_RUN, ids)
    elif part == "net":
        out = tools_net(seed, work, ids)
    elif part == "cluster":
        out = tools_cluster(seed, work, ids)
    elif part == "read":
        t0 = time.perf_counter()
        out = phase_read(seed, SCAN_PARTITIONS // READ_PARTITIONS_CUT,
                         ANN_ROWS, work)
        out["seconds"] = {"read": time.perf_counter() - t0}
    else:
        out = tools_harry(seed, work, ids)
        gates = tools_gates(work, ids)
        out["seconds"].update(gates["seconds"])
        out["legs"] += gates["legs"]
    out["wall"] = time.perf_counter() - t_start
    print(f"tools [{part}]: wall {out['wall']:.1f} s; seconds "
          + json.dumps({k: round(v, 3) for k, v in out["seconds"].items()}),
          flush=True)
    with open(os.path.join(work, f"tools-{part}.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


def start_tools(seed: int, work: str) -> dict:
    """The processes of phases 5 and 8-11 (TOOLS_PARTS), each a
    chip_smoke.py of its own with its output in work/tools-<part>.log:
    they run beside phases 4 and 6, so their host-bound Python shares
    the host's cores and not the smoke's time. Each process keeps its
    own launch counters."""
    if STRESS_ROWS_RUN != STRESS_ROWS:
        print(json.dumps({"reduced": {
            "phase": "tools", "stress_rows": STRESS_ROWS_RUN,
            "published": STRESS_ROWS}}))
    if STRESS_READS_RUN != STRESS_READS:
        print(json.dumps({"reduced": {
            "phase": "tools", "stress_reads": STRESS_READS_RUN,
            "before": STRESS_READS}}))
    procs = {}
    for part in TOOLS_PARTS:
        log = open(os.path.join(work, f"tools-{part}.log"), "w")
        cmd = [sys.executable, os.path.abspath(__file__), "--tools-part",
               part, "--work", work, "--seed", str(seed)]
        procs[part] = (subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=die_with_parent()), log)
    return procs


def _add_sizes(into: dict, sizes: dict) -> None:
    """Adds {kid: {size: launches}} to `into` (a size JSON gave back
    as a string becomes its int again)."""
    for kid, by in sizes.items():
        into.setdefault(kid, {})
        for size, c in by.items():
            if isinstance(size, str):
                size = int(size)
            into[kid][size] = into[kid].get(size, 0) + c


def finish_tools(procs: dict, deadline: float) -> dict:
    """Waits for the processes of TOOLS_PARTS (until `deadline` on the
    perf_counter clock), prints their output, and fails where one
    failed; merges their legs, launch sizes, seconds and walls."""
    out: dict = {"sizes": {}, "legs": [], "seconds": {}, "walls": {}}
    for part, (proc, log) in procs.items():
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=max(1.0, deadline - t0))
        except subprocess.TimeoutExpired:
            rc = None
        log.flush()
        with open(log.name) as f:
            text = f.read()
        print(f"tools [{part}]: waited {time.perf_counter() - t0:.1f} s "
              f"after phase 6; exit code {rc}; its output:", flush=True)
        sys.stdout.write(text)
        need(rc == 0, f"tools [{part}]: exit code {rc}: "
                      + " | ".join(text.strip().splitlines()[-3:]))
        with open(os.path.join(os.path.dirname(log.name),
                               f"tools-{part}.json")) as f:
            res = json.load(f)
        out["seconds"].update(res["seconds"])
        out["walls"][part] = res["wall"]
        # phase 5 returns its sizes whole, the others by leg
        _add_sizes(out["sizes"], res.get("sizes", {}))
        for leg in res["legs"]:
            if "sizes" in leg:
                leg["sizes"] = {kid: {int(n): c for n, c in by.items()}
                                for kid, by in leg["sizes"].items()}
                _add_sizes(out["sizes"], leg["sizes"])
            out["legs"].append(leg)
    print("tools: seconds by part " + json.dumps(
        {k: round(v, 3) for k, v in out["seconds"].items()}), flush=True)
    print("tools: launches by leg " + json.dumps(
        {g["name"]: {k: v for k, v in g["launches"].items() if v}
         for g in out["legs"]}), flush=True)
    return out


def stop_tools(procs: dict) -> None:
    """Ends the processes of TOOLS_PARTS that still run; phase 10's
    daemons die with theirs (die_with_parent)."""
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()


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
                                       "key_bytes", "steps")
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
    # the processes of phases 8 and 9 (start_tools)
    ap.add_argument("--tools-part", choices=TOOLS_PARTS + ("net",),
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.tools_part:
        return tools_child(args.tools_part, args.seed, args.work)
    t_start = time.perf_counter()
    info = phase_card()
    phase_build()
    res: dict = {}
    planned = {kid: {ROUND_PAD} for kid in ROUND_KERNELS}
    planned["K4"] = planned["K5"] = {SEGMENT}
    planned["K6"] = planned["K7"] = set(PLANE_PADS)
    planned["K9"] = {SEGMENT, RUN_KEYS}
    planned["K9f"] = {SEGMENT}
    planned["K10"] = {ANN_ROWS}
    planned["K8"] = {(MESH_SHARDS, 1 << 20)}       # the skewed-1M step
    t0 = time.perf_counter()
    phase_kernels(args.seed, planned, res)
    print(f"kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    build_root = os.path.join(REPO, "cassandra_tpu_torch", "build")
    os.makedirs(build_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=build_root)
    procs: dict = {}
    try:
        t_tools = time.perf_counter()
        procs = start_tools(args.seed, work)
        t0 = time.perf_counter()
        e2e = phase_e2e(args.seed, args.cells_per_run, work)
        print(f"e2e: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mesh = phase_mesh(args.seed, work, e2e["table"])
        print(f"mesh: {time.perf_counter() - t0:.1f} s", flush=True)
        main_wall = time.perf_counter() - t_tools
        tools = finish_tools(procs, t_start + TOOLS_DEADLINE_S)
        print(f"tools: {time.perf_counter() - t_tools:.1f} s from its "
              f"start", flush=True)
    finally:
        stop_tools(procs)
        shutil.rmtree(work, ignore_errors=True)
    walls = {"main (4, 6)": round(main_wall, 1),
             **{part: round(w, 1) for part, w in tools["walls"].items()}}
    print(f"processes: {os.cpu_count()} cpus; wall s " + json.dumps(walls),
          flush=True)
    _add_sizes(e2e["sizes"], mesh["sizes"])
    _add_sizes(e2e["sizes"], tools["sizes"])
    e2e["legs"] += mesh["legs"] + tools["legs"]
    # 7. the kernels at every other size the main paths launched
    seen = {kid: set(e2e["sizes"].get(kid, ())) for kid in KERNEL_NAMES}
    print("shapes: the main path launched " + json.dumps(
        {kid: sorted(v) for kid, v in seen.items()}), flush=True)
    t0 = time.perf_counter()
    phase_kernels(args.seed, seen, res)
    print(f"shapes: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s; "
          f"{os.cpu_count()} cpus; process walls s " + json.dumps(walls),
          flush=True)
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
