"""CI check: write-path fast lane A/B — the same deterministic mutation
stream ingested with CTPU_WRITE_FASTPATH=0 (per-mutation inline fsync,
single-shard memtable, serial flush) and =1 (group-commit commitlog,
sharded memtable, pipelined flush) must produce IDENTICAL storage state.

The workload deliberately exercises every case the fast lane must not
change: plain writes across many partitions, overwrites, cell/row/
partition deletions, a range tombstone, TTL cells (explicit ldt so both
legs agree to the second), batched mutations through apply_batch,
mid-stream flushes (so sstables capture pipeline output), and a
simulated crash + commitlog replay (the data directory is copied while
the engine is live — exactly what a crash leaves — and recovered by a
fresh engine).

Compared per leg:
  - per-table content_digest of the fully merged view (scan_all) after
    flush_all — covers every reconcile-significant lane;
  - per-partition read_partition digests (the read path over the
    written state);
  - the same two digests again on the crash-replayed engine.

The engines run on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.check_writepath_ab [--device cpu]

Exit 0 on zero divergence, 1 with a line per divergence.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile


N_PKS = 48
FIXED_NOW = 1_700_000_000          # merge clock (seconds), both legs
LDT = FIXED_NOW                    # deletion local-deletion-time


def _mutation_stream(t):
    """Deterministic list of (kind, payload) ops; kind 'm' = single
    mutation, 'b' = batch of mutations, 'f' = flush."""
    from cassandra_tpu_torch.schema import (COL_PARTITION_DEL, COL_RANGE_TOMB,
                                      COL_ROW_DEL, COL_ROW_LIVENESS)
    from cassandra_tpu_torch.storage.cellbatch import (FLAG_EXPIRING,
                                                 FLAG_PARTITION_DEL,
                                                 FLAG_RANGE_BOUND,
                                                 FLAG_ROW_DEL,
                                                 FLAG_ROW_LIVENESS,
                                                 FLAG_TOMBSTONE)
    from cassandra_tpu_torch.storage.mutation import Mutation
    from cassandra_tpu_torch.storage.rangetomb import Slice

    vcol = t.columns["v"].column_id
    ts0 = 1_000_000

    def write(pk_i, c, val, ts):
        m = Mutation(t.id, t.serialize_partition_key([pk_i]))
        ck = t.serialize_clustering([c])
        m.add(ck, COL_ROW_LIVENESS, b"", b"", ts, flags=FLAG_ROW_LIVENESS)
        m.add(ck, vcol, b"", val, ts)
        return m

    ops = []
    # round 0: base rows everywhere
    for k in range(N_PKS):
        for c in range(4):
            ops.append(("m", write(k, c, b"r0-%d-%d" % (k, c),
                                   ts0 + k * 10 + c)))
    ops.append(("f", None))
    # round 1: overwrites + deletions at every scope
    for k in range(0, N_PKS, 3):
        ops.append(("m", write(k, 1, b"r1-%d-1" % k, ts0 + 10_000 + k)))
    pd = Mutation(t.id, t.serialize_partition_key([2]))
    pd.add(b"", COL_PARTITION_DEL, b"", b"", ts0 + 20_000, ldt=LDT,
           flags=FLAG_PARTITION_DEL)
    ops.append(("m", pd))
    rd = Mutation(t.id, t.serialize_partition_key([3]))
    rd.add(t.serialize_clustering([1]), COL_ROW_DEL, b"", b"",
           ts0 + 20_001, ldt=LDT, flags=FLAG_ROW_DEL)
    ops.append(("m", rd))
    cd = Mutation(t.id, t.serialize_partition_key([4]))
    cd.add(t.serialize_clustering([2]), vcol, b"", b"", ts0 + 20_002,
           ldt=LDT, flags=FLAG_TOMBSTONE)
    ops.append(("m", cd))
    # range tombstone: pk 5, c > 1
    slc = Slice(t.clustering_bytecomp([1]), False, b"", False,
                ts0 + 20_003, LDT)
    rt = Mutation(t.id, t.serialize_partition_key([5]))
    rt.add(slc.start, COL_RANGE_TOMB, slc.encode_path(), b"",
           ts0 + 20_003, ldt=LDT,
           flags=FLAG_RANGE_BOUND | FLAG_TOMBSTONE)
    ops.append(("m", rt))
    ops.append(("f", None))
    # round 2: re-insert over the deleted partition + TTL cells with a
    # FIXED expiry second (no wall clock: legs must agree bit-for-bit)
    for c in range(2):
        ops.append(("m", write(2, c, b"r2-2-%d" % c, ts0 + 30_000 + c)))
    ttl_m = Mutation(t.id, t.serialize_partition_key([6]))
    ttl_m.add(t.serialize_clustering([9]), vcol, b"", b"ttl-live",
              ts0 + 30_010, ldt=FIXED_NOW + 3600, ttl=3600,
              flags=FLAG_EXPIRING)
    ttl_exp = Mutation(t.id, t.serialize_partition_key([6]))
    ttl_exp.add(t.serialize_clustering([10]), vcol, b"", b"ttl-dead",
                ts0 + 30_011, ldt=FIXED_NOW - 10, ttl=60,
                flags=FLAG_EXPIRING)
    ops.append(("b", [ttl_m, ttl_exp]))
    # batched writes (apply_batch: one commitlog barrier, one shard pass)
    batch = [write(k, 7, b"r2-%d-7" % k, ts0 + 40_000 + k)
             for k in range(0, N_PKS, 2)]
    ops.append(("b", batch))
    ops.append(("f", None))
    # memtable-only tail: lives only in the commitlog at "crash" time
    for k in range(8, 16):
        ops.append(("m", write(k, 8, b"tail-%d" % k, ts0 + 50_000 + k)))
    rd2 = Mutation(t.id, t.serialize_partition_key([9]))
    rd2.add(t.serialize_clustering([0]), COL_ROW_DEL, b"", b"",
            ts0 + 50_100, ldt=LDT, flags=FLAG_ROW_DEL)
    ops.append(("m", rd2))
    return ops


def _digests(engine, t) -> list[tuple[str, bytes]]:
    from cassandra_tpu_torch.storage.cellbatch import content_digest
    cfs = engine.store("ab", "t")
    out = [("scan_all", content_digest(cfs.scan_all(now=FIXED_NOW)))]
    for k in range(N_PKS):
        pk = t.serialize_partition_key([k])
        out.append((f"pk={k}",
                    content_digest(cfs.read_partition(pk,
                                                      now=FIXED_NOW))))
    return out


def _run_leg(base_dir: str, fastpath: bool, device=None):
    """Ingest the stream, then return (live digests, sstable cell
    counts, crash-replayed digests)."""
    from cassandra_tpu_torch.schema import Schema, make_table
    from cassandra_tpu_torch.storage.engine import StorageEngine

    os.environ["CTPU_WRITE_FASTPATH"] = "1" if fastpath else "0"
    d = os.path.join(base_dir, "fast" if fastpath else "naive")
    schema = Schema()
    schema.create_keyspace("ab")
    t = make_table("ab", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "blob"})
    schema.add_table(t)
    engine = StorageEngine(d, schema, commitlog_sync="group",
                           device=device)
    engine._save_schema()
    cfs = engine.store("ab", "t")
    for kind, payload in _mutation_stream(t):
        if kind == "m":
            engine.apply(payload)
        elif kind == "b":
            engine.apply_batch(payload)
        else:
            cfs.flush()
    # crash snapshot BEFORE close: group/batch mode acked ⇒ durable, so
    # a byte-copy of the live directory is what a crash leaves behind
    crash = d + "-crash"
    shutil.copytree(d, crash)
    live = _digests(engine, t)
    cells = sorted((s.desc.generation, s.n_cells)
                   for s in cfs.live_sstables())
    engine.close()

    replayed = StorageEngine(crash, Schema(), commitlog_sync="group",
                             device=device)
    rep = _digests(replayed, t)
    replayed.flush_all()
    rep_flushed = _digests(replayed, t)
    replayed.close()
    return live, cells, rep, rep_flushed


def run_check(base_dir: str, device=None) -> list[str]:
    """Run both legs over `base_dir`, return human-readable divergences
    (empty = pass)."""
    prev = os.environ.get("CTPU_WRITE_FASTPATH")
    try:
        naive = _run_leg(base_dir, fastpath=False, device=device)
        fast = _run_leg(base_dir, fastpath=True, device=device)
    finally:
        if prev is None:
            os.environ.pop("CTPU_WRITE_FASTPATH", None)
        else:
            os.environ["CTPU_WRITE_FASTPATH"] = prev
    diverged = []
    names = ("live state", "sstable cell counts", "crash replay",
             "crash replay + flush")
    for name, a, b in zip(names, naive, fast):
        if a != b:
            diverged.append(f"writepath fast lane diverged on {name}:\n"
                            f"  naive:    {a}\n  fastpath: {b}")
    return diverged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_writepath_ab")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ctpu-writepath-ab-") as d:
        diverged = run_check(d, device=args.device)
    for msg in diverged:
        print(msg, file=sys.stderr)
    if diverged:
        print(f"FAIL: {len(diverged)} divergence(s)", file=sys.stderr)
        return 1
    print("writepath A/B: identical state (fastpath == naive), "
          "crash replay included")
    return 0


if __name__ == "__main__":
    sys.exit(main())
